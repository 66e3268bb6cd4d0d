"""Convolutions' epilogues the model ran per forward over the traced
window: the program's ``conv_epilogue.launches`` (each launch of the
epilogue kernel, eager calls and graph replays alike; the CPU launches
none) over the forwards, ``predict.slots`` over the cell's batch size. 45
an SSD-ResNet34 forward, 29 an SSD300 one when every convolution takes the
kernel; a convolution left on PyTorch's ops reads as a lower number. None
where the program counts no such launches or the window served nothing."""


def read(run):
    from perfbench import program

    counts = program.counts(run)
    launches, slots = counts.get("conv_epilogue.launches"), counts.get("predict.slots")
    if launches is None or not slots:
        return None
    return launches / (slots / run.cell["batch_size"])
