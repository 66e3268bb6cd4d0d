"""``serve.fused_epilogues_per_forward`` on synthetic counts: the epilogue
kernel's launches over the forwards (slots over the cell's batch size), at
b8 and b1; 0 where the program counts launches but none was made; None
where the window served nothing or the program counts no launches (the
parent of the kernel)."""

import types

import pytest

from perfbench import harness, program

READ = harness.load_module("metrics", "serve.fused_epilogues_per_forward").read


def _run(batch_size):
    return types.SimpleNamespace(cell={"batch_size": batch_size})


@pytest.mark.parametrize("batch_size, per_forward, forwards, padded",
                         [(8, 45, 10, 0), (8, 29, 7, 3), (1, 29, 13, 0)])
def test_reads_launches_per_forward(monkeypatch, batch_size, per_forward, forwards, padded):
    # A padded slot is part of its forward: slots count whole batches.
    counts = {"conv_epilogue.launches": per_forward * forwards,
              "predict.slots": batch_size * forwards, "predict.images": batch_size * forwards
              - padded}
    monkeypatch.setattr(program, "counts", lambda run: counts)
    assert READ(_run(batch_size)) == per_forward


def test_reads_zero_where_no_convolution_took_the_kernel(monkeypatch):
    # A replayed graph that holds no epilogue still counts its 0 launches.
    monkeypatch.setattr(program, "counts",
                        lambda run: {"conv_epilogue.launches": 0, "predict.slots": 16})
    assert READ(_run(8)) == 0


def test_reads_nothing_without_a_served_window(monkeypatch):
    monkeypatch.setattr(program, "counts", lambda run: {})
    assert READ(_run(8)) is None
    monkeypatch.setattr(program, "counts", lambda run: {"conv_epilogue.launches": 45})
    assert READ(_run(8)) is None


def test_reads_nothing_from_a_program_without_the_kernel(monkeypatch):
    monkeypatch.setattr(program, "counts",
                        lambda run: {"predict.slots": 8, "decode.lanes": 160})
    assert READ(_run(8)) is None
