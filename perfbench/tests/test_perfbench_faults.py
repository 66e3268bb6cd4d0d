"""The check fails a run whose timed path is broken: an answer altered
where it is produced, half of a batch left out, a step that leaves the
state unchanged. Each drives a whole cell at a tiny size on the CPU with
the fault planted in the program, and sees ``correct`` come out false; the
same run without the fault is correct. (No cell spans chips, so no
exchange between chips can be left out.)"""

import numpy as np
import pytest
import torch

SEED = 3000000017


def test_a_sound_serving_run_is_correct(tiny_run):
    run = tiny_run("ssd300_voc.serve_open", SEED)
    assert run.correct, run.checks
    assert run.attempted == len(run.spans["predict"]) and "request_p95_ms" in run.e2e


def test_an_overloaded_serving_run_closes_at_its_seconds_and_is_correct(tiny_run):
    run = tiny_run("ssd300_voc.serve_overload", SEED)
    assert run.correct, run.checks
    # The backlog is left unserved at the close: fewer begun than were due.
    assert 0 < run.attempted < int(round(40.0 * 1.5))
    assert run.e2e["served_img_per_s"] == run.values["images"] / run.values["window_s"]


@pytest.mark.parametrize("cell", ["ssd300_voc.serve_open", "ssd300_voc.serve_overload"])
@pytest.mark.parametrize("fault", ["class_altered", "boxes_shifted", "half_the_batch"])
def test_a_broken_serving_path_is_not_correct(tiny_run, monkeypatch, fault, cell):
    from ssd_keras_torch import predictor

    read = predictor.SSDPredictor._read

    def broken(out):
        dets = read(out)
        if fault == "class_altered":
            dets[..., 0] = np.where(dets[..., 0] != 0, dets[..., 0] % 20 + 1, 0)
        elif fault == "boxes_shifted":
            dets[..., 2:6] += 60.0
        else:  # every other image of the (padded) batch, the first real one among them
            dets[0::2] = 0
        return dets

    monkeypatch.setattr(predictor.SSDPredictor, "_read", staticmethod(broken))
    run = tiny_run(cell, SEED)
    assert not run.correct, run.checks


def test_a_sound_evaluation_run_is_correct(tiny_run):
    run = tiny_run("ssd512_voc.eval_voc07", SEED, seconds=0.1)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", ["class_altered", "half_the_batch"])
def test_a_broken_evaluation_path_is_not_correct(tiny_run, monkeypatch, fault):
    from ssd_keras_torch.eval import evaluator

    host_copy = evaluator.HostCopy.numpy

    def broken(self):
        y = host_copy(self).copy()
        if fault == "class_altered":
            y[..., 0] = np.where(y[..., 0] != 0, y[..., 0] % 20 + 1, 0)
        else:
            y[len(y) // 2:] = 0
        return y

    monkeypatch.setattr(evaluator.HostCopy, "numpy", broken)
    run = tiny_run("ssd512_voc.eval_voc07", SEED, seconds=0.1)
    assert not run.correct, run.checks


def test_a_sound_training_run_is_correct(tiny_run):
    run = tiny_run("ssd300_voc.train_device_aug", SEED, seconds=0.1)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "update_doubled"])
def test_a_broken_training_path_is_not_correct(tiny_run, monkeypatch, fault):
    from ssd_keras_torch import train

    if fault == "state_unchanged":
        monkeypatch.setattr(train.SGD, "step", lambda self, closure=None: None)
    elif fault == "half_the_batch":
        make = train.make_train_step

        def half(*args, **kwargs):
            step = make(*args, **kwargs)
            return lambda images, y_true: step(images[: len(images) // 2],
                                               y_true[: len(y_true) // 2])

        monkeypatch.setattr(train, "make_train_step", half)
    else:  # the step's answer, the new state, altered where it is produced
        step = train.SGD.step

        @torch.no_grad()
        def doubled(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            before = [p.clone() for p in params]
            out = step(self, closure)
            for p, b in zip(params, before):
                p.add_(p - b)
            return out

        monkeypatch.setattr(train.SGD, "step", doubled)
    run = tiny_run("ssd300_voc.train_device_aug", SEED, seconds=0.1)
    assert not run.correct, run.checks
