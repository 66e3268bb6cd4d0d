"""NMS lanes the decoder ran per batch slot over the traced window: the
program's ``decode.lanes`` (each (image, class) pair of a batch is a lane,
eager calls and graph replays alike) over ``predict.slots`` (chunks x the
batch size), so a padded slot counts as the lanes it costs. None where the
program counts no lanes."""


def read(run):
    from perfbench import program

    counts = program.counts(run)
    lanes, slots = counts.get("decode.lanes"), counts.get("predict.slots")
    return lanes / slots if lanes and slots else None
