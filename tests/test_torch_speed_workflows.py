"""The four speed and profiling workflows of the port against the JAX
package's scripts and decoder, on the CPU.

* The decoder's stages (``compact_candidates``, ``_per_class_topk``,
  ``_nms_lanes``, ``_global_topk``), composed as ``profile_breakdown``
  times them, give ``decode_detections_fixed``'s detections bit for bit;
  each stage equals its JAX counterpart on the same numpy inputs:
  ``decode_offsets`` within rtol 1e-5 (atol 1e-4 px, an ulp of ``exp``
  near a coordinate of 0), ``_topk_lanes(..., "exact_fast")`` values
  within 1e-6 with equal indices, ``_nms_lanes(..., "fixpoint")`` keep
  masks equal.
* ``profile_breakdown``'s and ``serving_trunk_bench``'s records hold every
  key of the JAX records (``docs/benchmarks/profile.md``,
  ``serving_trunk.md``); ``serving_trunk_bench``'s block arithmetic gives
  the JAX record's GFLOP and, at the JAX script's TPU constants and
  measured times, its rows (floors to the record's 3 decimals; TFLOP/s
  and shares within rel 1e-3 / abs 0.1, the record's ms being rounded to
  3 decimals), and raises on a reading over 100% of peak.
* ``streaming_bench.synth_batches`` equals the JAX script's bit for bit;
  its ``main`` gives the JAX record's keys and a finite loss.
* ``coco_decode_bench`` sweeps every ``compact_pool`` with the JAX keys.

Timings here are the CPU's host clock at batch 1 with one iteration: the
tests check shapes, keys and arithmetic, never speed.
"""

import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu import decoder as jax_decoder
from ssd_keras_torch import decoder as D
from ssd_keras_torch.examples import (coco_decode_bench, profile_breakdown, serving_trunk_bench,
                                      streaming_bench)
from ssd_keras_torch.ops.boxes import border_delta

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECORDS = REPO / "docs" / "benchmarks"
K_POOL, TOP_K = 64, 50


def jax_example(name):
    """A JAX package example script as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_speed_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_blocks(name):
    """The JSON blocks of a JAX record in ``docs/benchmarks``."""
    text = (RECORDS / name).read_text()
    return [json.loads(b) for b in re.findall(r"```json\n(.*?)\n```", text, re.S)]


def _y_pred(n_classes, seed=0, batch=2, n=600):
    """(B, N, C + 12) f32: softmax scores, offsets, random centroid anchors
    and the SSD variances."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, n, n_classes).astype(np.float32) * 2.5
    e = np.exp(logits - logits.max(-1, keepdims=True))
    confs = e / e.sum(-1, keepdims=True)
    offsets = rng.randn(batch, n, 4) * 0.5
    anchors = np.stack([rng.uniform(0.05, 0.95, n), rng.uniform(0.05, 0.95, n),
                        rng.uniform(0.05, 0.4, n), rng.uniform(0.05, 0.4, n)], -1)
    variances = np.array([0.1, 0.1, 0.2, 0.2])
    return np.concatenate(
        [confs, offsets, np.broadcast_to(anchors, (batch, n, 4)),
         np.broadcast_to(variances, (batch, n, 4))], -1).astype(np.float32)


def _bit_equal(a, b):
    return a.shape == b.shape and np.array_equal(a.numpy().view(np.int32),
                                                 b.numpy().view(np.int32))


@pytest.mark.parametrize("compact_pool", [0, 512, "auto"])
@pytest.mark.parametrize("n_classes", [5, 21])
def test_stages_compose_to_the_decoder_bit_for_bit(n_classes, compact_pool):
    y = torch.from_numpy(_y_pred(n_classes))
    calls, out = profile_breakdown.decode_stages(y, 300, 300, compact_pool, K_POOL, TOP_K)
    assert [key for key, _ in calls] == list(profile_breakdown.STAGE_KEYS)
    expected = D.decode_detections_fixed(y, img_height=300, img_width=300, top_k=TOP_K,
                                          nms_max_output_size=K_POOL, compact_pool=compact_pool)
    assert _bit_equal(out, expected)
    assert (expected[..., 1] > 0).sum() > 0
    # Each call of a stage recomputes its output from the previous stage's.
    assert _bit_equal(calls[-1][1](), expected)


@pytest.mark.parametrize("n_classes", [5, 21])
def test_each_stage_equals_its_jax_counterpart(n_classes):
    y_np = _y_pred(n_classes, seed=1)
    y = torch.from_numpy(y_np)
    thresh = D._f32(0.01)
    bd = border_delta("half")

    corners = D.decode_offsets(y, "centroids", True, 300, 300)
    jax_corners = jax_decoder.decode_offsets(jnp.asarray(y_np), "centroids", True, 300, 300,
                                             xp=jnp)
    np.testing.assert_allclose(corners.numpy(), np.asarray(jax_corners), rtol=1e-5, atol=1e-4)

    scores, corners_m = D.compact_candidates(y[..., :-12], corners, 512)
    masked = torch.where(scores > thresh, scores, -1.0)
    vals, idx = D._topk_lanes(masked, K_POOL)
    jax_vals, jax_idx = jax_decoder._topk_lanes(jnp.asarray(masked.numpy()), K_POOL,
                                                "exact_fast")
    np.testing.assert_allclose(vals.numpy(), np.asarray(jax_vals), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_idx))

    cand_scores, cand_boxes, valid = D._per_class_topk(scores, corners_m, K_POOL, thresh)
    np.testing.assert_array_equal(cand_scores.numpy(), vals.numpy())
    np.testing.assert_array_equal(
        cand_boxes.numpy(), np.take_along_axis(corners_m.numpy()[:, None],
                                               np.asarray(jax_idx)[..., None], axis=2))
    lanes = cand_boxes.shape[0] * cand_boxes.shape[1]
    keep = D._nms_lanes(cand_boxes, valid, 0.45, bd, K_POOL)
    jax_keep = jax_decoder._nms_lanes(jnp.asarray(cand_boxes.numpy().reshape(lanes, K_POOL, 4)),
                                      jnp.asarray(valid.numpy().reshape(lanes, K_POOL)),
                                      0.45, "fixpoint", bd)
    np.testing.assert_array_equal(keep.numpy().reshape(lanes, K_POOL), np.asarray(jax_keep))
    assert 0 < keep.sum() < valid.sum()  # NMS suppressed some, kept some


def test_nms_stage_caps_the_survivors_of_a_lane():
    y = torch.from_numpy(_y_pred(5, seed=2))
    corners = D.decode_offsets(y, "centroids", True, 300, 300)
    scores, corners_m = D.compact_candidates(y[..., :-12], corners, 0)
    _, cand_boxes, valid = D._per_class_topk(scores, corners_m, K_POOL, D._f32(0.01))
    uncapped = D._nms_lanes(cand_boxes, valid, 0.45, 0.0, K_POOL)
    capped = D._nms_lanes(cand_boxes, valid, 0.45, 0.0, 5)
    assert uncapped.sum(-1).max() > 5 and capped.sum(-1).max() == 5
    assert torch.equal(capped, uncapped & (torch.cumsum(uncapped, -1) <= 5))


def test_profile_breakdown_records_hold_the_jax_keys():
    jax_ssd300, jax_ssd7 = json_blocks("profile.md")
    row = profile_breakdown.ssd300_breakdown(1, "cpu", fps_iters=1, iters_forward=1,
                                             iters_stage=1, repeats=1)
    assert set(jax_ssd300[0]) <= set(row)
    assert set(profile_breakdown.STAGE_KEYS) <= set(row)
    assert np.isfinite(row["decode_stage_sum_ms"]) and row["decode_stage_sum_ms"] > 0
    assert row["decode_stage_sum_ms"] == pytest.approx(
        sum(row[k] for k in profile_breakdown.STAGE_KEYS))
    assert row["nms_impl"] == "plain" and row["stages_equal_decoder"]
    assert row["nms_lanes"] == [20, 400] and row["stage_timer"]["timer"] == "host clock (cpu)"
    assert row["decode_in_e2e_device_ms"] == pytest.approx(
        row["e2e_device_ms"] - row["trunk_device_ms"])

    row7 = profile_breakdown.ssd7_dispatch_vs_compute(1, "cpu", fps_iters=1, iters=1, repeats=1)
    assert set(jax_ssd7[0]) <= set(row7)
    assert row7["decode_ms"] == pytest.approx(row7["on_device_chained_ms"] - row7["trunk_ms"])


def test_profile_breakdown_writes_both_sections(tmp_path):
    record = {"card": "cpu", "ssd300": [{"batch": 8}], "ssd7": [{"batch": 1}]}
    profile_breakdown.write_record(tmp_path / "p.md", record)
    text = (tmp_path / "p.md").read_text()
    assert "## SSD300" in text and "## SSD7 dispatch vs compute" in text
    assert "(cpu, bf16)" in text and "TPU" not in text


def test_block_arithmetic_gives_the_jax_records_gflops_and_h100_floors():
    (jax_record,) = json_blocks("serving_trunk.md")
    rows = [serving_trunk_bench.block_row(*stage[:5], 8, 10.0)
            for stage in serving_trunk_bench.STAGES]
    assert [r["gflops"] for r in rows] == [55.6, 79.6, 132.7, 136.3, 40.9, 33.3]
    assert [r["gflops"] for r in rows] == [r["gflops"] for r in jax_record["blocks"]]
    assert [r["stage"] for r in rows] == [r["stage"] for r in jax_record["blocks"]]
    assert serving_trunk_bench.PEAK_BF16_TFLOPS == 989.0
    assert serving_trunk_bench.HBM_GBPS == 3350.0
    assert round(sum(r["floor_ms"] for r in rows), 3) == 0.484
    conv1 = rows[0]
    flops = 2 * 8 * 300 * 300 * (3 * 64 * 9 + 64 * 64 * 9)
    assert conv1["mxu_floor_ms"] == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    act = 8 * 300 * 300 * (3 + 2 * 64) * 2
    weights = (9 * 3 * 64 + 9 * 64 * 64) * 2
    assert conv1["hbm_floor_ms"] == pytest.approx((act + weights) / 3350e9 * 1e3, rel=1e-12)


def test_block_arithmetic_reproduces_the_jax_rows_at_its_constants(monkeypatch):
    """At the JAX script's TPU constants and measured times, the rows are
    the JAX record's, and its conv3 reading (103.6% of its peak) raises."""
    (jax_record,) = json_blocks("serving_trunk.md")
    monkeypatch.setattr(serving_trunk_bench, "PEAK_BF16_TFLOPS", 197.0)
    monkeypatch.setattr(serving_trunk_bench, "HBM_GBPS", 819.0)
    for stage, want in zip(serving_trunk_bench.STAGES, jax_record["blocks"]):
        if want["pct_of_peak"] > 100:
            with pytest.raises(AssertionError, match="impossible reading"):
                serving_trunk_bench.block_row(*stage[:5], 8, want["ms"])
            continue
        got = serving_trunk_bench.block_row(*stage[:5], 8, want["ms"])
        # The record's ms is rounded to 3 decimals (0.6 of 0.5996 ms, say);
        # its TFLOP/s came from the unrounded time.
        for key in ("achieved_tflops", "pct_of_peak"):
            assert got[key] == pytest.approx(want[key], rel=1e-3, abs=0.1), key
        for key in ("mxu_floor_ms", "hbm_floor_ms", "floor_ms"):
            assert round(got[key], 3) == want[key], key


@pytest.mark.parametrize("ms", [0.05, 0.02])
def test_impossible_block_reading_raises(ms):
    """conv1 at batch 8: 0.05 ms is over 100% of the bf16 peak; 0.02 ms is
    also under its floor."""
    with pytest.raises(AssertionError, match="impossible reading"):
        serving_trunk_bench.block_row(*serving_trunk_bench.STAGES[0][:5], 8, ms)


def test_serving_trunk_parts_run_on_the_cpu():
    (jax_record,) = json_blocks("serving_trunk.md")
    pre = serving_trunk_bench.measure_preprocessing("cpu", batch=1, iters=1, repeats=1)
    assert set(jax_record["preprocessing"]) <= set(pre)
    assert pre["fold_f32_within_test_tolerance"]
    assert pre["fold_max_abs_diff_f32"] <= 1e-4
    assert pre["fold_max_abs_diff"] <= 2 * pre["bf16_rounding_max_abs_diff"]
    blocks = serving_trunk_bench.measure_blocks("cpu", batch=1, iters=1, repeats=1)
    assert [b["stage"] for b in blocks] == [r["stage"] for r in jax_record["blocks"]]
    assert all(set(want) <= set(b) for b, want in zip(blocks, jax_record["blocks"]))


def test_flag_sweep_runs_each_setting_in_its_own_process():
    results = serving_trunk_bench.flag_sweep("cpu", batch=1, n_iters=1, n_repeats=1)
    assert list(results) == ["default", "cudnn_benchmark"]
    assert [r["cudnn_benchmark"] for r in results.values()] == [False, True]
    for r in results.values():
        assert {"dispatched_img_per_s", "chained_ms", "chained_img_per_s", "wall_s",
                "max_abs_diff_vs_default"} <= set(r)
    # The same weights, input and CPU kernels in both processes.
    assert results["cudnn_benchmark"]["max_abs_diff_vs_default"] == 0.0


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_batches_equal_the_jax_scripts(seed):
    jax_store = jax_example("streaming_bench").synth_batches(3, 4, seed)
    store = streaming_bench.synth_batches(3, 4, seed)
    assert len(store) == len(jax_store) == 3
    for got, want in zip(store, jax_store):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_streaming_bench_main_gives_the_jax_keys_and_a_finite_loss(tmp_path):
    (jax_record,) = json_blocks("streaming_pipeline.md")
    out = tmp_path / "stream.md"
    record = streaming_bench.main(["--rounds", "1", "--batches", "1", "--batch", "2",
                                   "--store", "1", "--device", "cpu", "--out", str(out)])
    assert set(jax_record) - {"pcie_host_ceiling_img_per_s_at_10GBps"} <= set(record)
    assert set(jax_record["rounds"][0]) <= set(record["rounds"][0])
    assert np.isfinite(record["final_loss"]) and record["batch"] == 2
    assert record["bound_by"]["stream"] in ("link", "augment + encode")
    assert "```json" in out.read_text()


def test_stream_bounds_name_what_sets_the_pace():
    assert streaming_bench.stream_bounds(0.98, 900.0, 3000.0) == ("link", "train step")
    assert streaming_bench.stream_bounds(0.05, 2900.0, 3000.0) == (
        "augment + encode", "augment + encode")


def test_coco_decode_sweep_rows_at_every_compact_pool():
    rows = coco_decode_bench.sweep("cpu", batch=1, n_iters=1, n_repeats=1, warmup=0)
    assert [(r["model"], r["compact_pool"]) for r in rows] == [
        (tag, m) for tag in ("coco81", "voc21") for m in (0, 512, 1024, 2048, "auto")]
    for r in rows:
        # The JAX script's keys (examples/coco_decode_bench.py), and the launches.
        assert {"model", "compact_pool", "ms_per_batch", "img_per_s", "nms_launches",
                "device_ms"} <= set(r)
        assert np.isfinite(r["ms_per_batch"]) and r["img_per_s"] > 0 and r["device_ms"] > 0
        assert r["nms_launches"] == 0  # the plain NMS on the CPU
