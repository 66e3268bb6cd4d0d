"""Data parallelism of the port: two gloo ranks on the CPU against one
process and against the JAX package's global batch.

The fixture is ``tests/test_sharding.py``'s: SSD7 at 64x64 with 3 classes,
a global batch of 8 with a different positive count per item. The ranks
are spawned once (``parallel.launch.run_ranks``, with a time limit) and
run ``parallel.dryrun.dp_check_rank``: one SGD step (clipnorm 1, which
binds, so the clip must see the summed gradient), the hard-negative mask,
the resident-gather exchange and the per-rank decode.

Tolerances:

* the data-parallel loss against the JAX package's jitted step on the
  global batch within ``LOSS_RTOL`` = 1e-5 (XLA and PyTorch sum the
  convolutions and BatchNorm in other orders: tests/test_torch_train.py);
* the step against the port's one-process step within rtol ``STEP_RTOL``
  = 1e-4 and atol ``STEP_ATOL`` = 1e-6, BatchNorm running statistics
  included: the same operations, with the batch sums split in two and
  added;
* the mining mask, the positive count and the exchanged rows exactly;
* the gathered per-rank decode against JAX ``decode_detections_fixed``
  within ``DECODE_TOL`` = 1e-5, on the well-separated predictions of
  ``tests/test_sharding.py:test_sharded_decode_matches_unsharded``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_keras_tpu import train as jax_train
from ssd_keras_tpu.config import SSDConfig as JaxSSDConfig
from ssd_keras_tpu.decoder import decode_detections_fixed as jax_decode
from ssd_keras_tpu.loss import SSDLoss as JaxSSDLoss
from ssd_keras_tpu.models import ssd_7 as jax_ssd_7
from ssd_keras_torch import train as T
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.loss import SSDLoss, hard_negative_mask
from ssd_keras_torch.models import ssd_7
from ssd_keras_torch.parallel import sharding as sh
from ssd_keras_torch.parallel.dryrun import dp_check_rank, dryrun_multichip
from ssd_keras_torch.parallel.launch import run_ranks
from ssd_keras_torch.weights_io import from_flax_params

torch.set_num_threads(2)

KW = dict(n_classes=3, img_height=64, img_width=64)
LR, L2, CLIPNORM = 1e-2, 5e-4, 1.0
LOSS_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
DECODE_TOL = 1e-5
DECODE_KW = dict(confidence_thresh=0.02, top_k=200, img_height=64, img_width=64)
RANKS_TIMEOUT = 120.0


def _batch():
    """tests/test_sharding.py's setup fixture: images and y_true."""
    cfg = JaxSSDConfig.ssd7(**KW)
    rng = np.random.RandomState(0)
    batch, n, c = 8, 340, cfg.n_classes_with_background
    images = rng.rand(batch, 64, 64, 3).astype(np.float32) * 255
    y_true = np.zeros((batch, n, c + 12), np.float32)
    y_true[:, :, 0] = 1.0
    for b in range(batch):
        for j in range(b + 1):  # different positive counts per item
            y_true[b, 7 * j, 0] = 0.0
            y_true[b, 7 * j, 1 + j % 3] = 1.0
            y_true[b, 7 * j, c:c + 4] = rng.randn(4) * 0.1
    return images, y_true


def _y_pred():
    """tests/test_sharding.py's well-separated predictions."""
    rng = np.random.RandomState(3)
    batch, n, c = 8, 340, 4
    y_pred = np.zeros((batch, n, c + 12), np.float32)
    conf = rng.rand(batch, n, c).astype(np.float32)
    y_pred[..., :c] = conf / conf.sum(-1, keepdims=True)
    y_pred[..., c:c + 4] = rng.randn(batch, n, 4).astype(np.float32) * 0.1
    cx, cy = rng.rand(2, n).astype(np.float32)
    wh = (rng.rand(2, n) * 0.2 + 0.05).astype(np.float32)
    y_pred[..., -8] = cx
    y_pred[..., -7] = cy
    y_pred[..., -6:-4] = wh.T
    y_pred[..., -4:] = [0.1, 0.1, 0.2, 0.2]
    return y_pred


def _mining_inputs():
    """Tie-free negative losses (0 at the positives) and per-item counts."""
    rng = np.random.RandomState(5)
    neg = rng.permutation(8 * 340).reshape(8, 340).astype(np.float32) / 1000.0 + 1e-3
    pos = rng.rand(8, 340) < 0.01
    neg[pos] = 0.0
    return neg, pos.sum(axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """(the JAX step's metrics, the port's one-process run, the two ranks'
    results, the initial state)."""
    images, y_true = _batch()
    jax_model, _ = jax_ssd_7(JaxSSDConfig.ssd7(**KW), s2d_trunk=False)
    state = jax_train.create_train_state(jax_model, jax.random.PRNGKey(0), images,
                                         jax_train.sgd_with_momentum(LR))
    init = from_flax_params(jax.tree_util.tree_map(np.asarray, dict(state.params)),
                            jax.tree_util.tree_map(np.asarray, dict(state.batch_stats)))
    _, jax_metrics = jax_train.make_train_step(jax_model, JaxSSDLoss(), l2_reg=L2, donate=False)(
        state, jnp.asarray(images), jnp.asarray(y_true))

    model, _ = ssd_7(SSDConfig.ssd7(**KW), device="cpu")
    model.load_state_dict(init)
    opt = T.sgd_with_momentum(model.parameters(), LR, 0.9, clipnorm=CLIPNORM)
    one = T.make_train_step(model, opt, SSDLoss(), l2_reg=L2)(
        torch.from_numpy(images), torch.from_numpy(y_true))
    one = dict(loss=float(one["loss"]), data_loss=float(one["data_loss"]),
               state={k: v.numpy() for k, v in model.state_dict().items()})

    neg, n_pos = _mining_inputs()
    spec = dict(arch="ssd7", config=KW, device="cpu",
                state={k: v.numpy() for k, v in init.items()},
                images=images, y_true=y_true, lr=LR, l2=L2, clipnorm=CLIPNORM,
                decode="y_pred", y_pred=_y_pred(), decode_kw=DECODE_KW,
                neg_losses=neg, n_positive=n_pos,
                dataset=np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
                index=np.random.RandomState(7).permutation(16)[:8])
    ranks = run_ranks(dp_check_rank, 2, (spec,), timeout=RANKS_TIMEOUT)
    return jax_metrics, one, ranks, init, spec


def test_dp_loss_equals_jax_global_batch(runs):
    jax_metrics, one, ranks, _, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jax_metrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["data_loss"], float(jax_metrics["data_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", ["params", "batchnorm_statistics"])
def test_dp_step_equals_one_rank_step(runs, kind):
    _, one, ranks, init, _ = runs
    stats = ("running_mean", "running_var")
    keys = [k for k in init if k.endswith(stats) == (kind == "batchnorm_statistics")]
    moved = [k for k in keys if not np.array_equal(one["state"][k], init[k].numpy())]
    assert len(moved) > len(keys) // 2, moved
    for r in ranks:
        for k in keys:
            np.testing.assert_allclose(r["state"][k], one["state"][k], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=k)


def test_ranks_hold_equal_state(runs):
    _, _, (r0, r1), _, _ = runs
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)


def test_gathered_mining_mask_equals_one_rank(runs):
    _, _, ranks, _, _ = runs
    neg, n_pos = _mining_inputs()
    keep, n_positive = hard_negative_mask(torch.from_numpy(neg), torch.from_numpy(n_pos).sum())
    assert 0 < int(keep.sum()) < (neg > 0).sum()  # k binds
    for r in ranks:
        np.testing.assert_array_equal(r["keep"], keep.numpy())
        assert r["n_positive"] == float(n_positive)


def test_resident_gather_exchange_returns_the_global_rows(runs):
    _, _, ranks, _, spec = runs
    owners = spec["index"] // 8
    assert set(owners[:4]) == {0, 1} and set(owners[4:]) == {0, 1}  # rows cross ranks
    for r in ranks:
        np.testing.assert_array_equal(r["rows"], spec["dataset"][spec["index"]])


def test_per_rank_decode_gathered_equals_jax(runs):
    _, _, ranks, _, spec = runs
    expected = np.asarray(jax_decode(jnp.asarray(spec["y_pred"]), **DECODE_KW))
    assert (expected[..., 1] > 0).sum() > 8
    for r in ranks:
        assert r["detections"].shape == (8, 200, 6)
        np.testing.assert_allclose(r["detections"], expected, rtol=DECODE_TOL, atol=DECODE_TOL)
        assert r["nms_launches"] == 0  # CPU tensors take the plain version


def test_dryrun_multichip_two_ranks():
    reports = dryrun_multichip(2, timeout=RANKS_TIMEOUT)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["n_streamed"] == 3 and r["detections"] == (2 * 2, 200, 6)  # two rows per rank
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_resident", "loss_streamed"))


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 failed:(.|\n)*KeyError"):
        run_ranks(dp_check_rank, 2, ({"device": "cpu", "arch": "no such model"},),
                  timeout=RANKS_TIMEOUT)


def test_initialize_distributed_rejects_a_bad_launch():
    with pytest.raises(ValueError, match="outside a world"):
        sh.initialize_distributed("gloo", world_size=2, rank=2)
    with pytest.raises(RuntimeError, match="initialized process group"):
        sh.make_mesh("cpu")


class _Mesh:
    """The two methods the row helpers read, of rank ``rank`` of two."""

    def __init__(self, rank):
        self.rank = rank

    def get_local_rank(self, dim=None):
        return self.rank

    def size(self):
        return 2


def test_shard_rows_must_divide():
    assert sh.shard_rows(8, _Mesh(1)) == slice(4, 8)
    with pytest.raises(ValueError, match="do not divide"):
        sh.shard_rows(7, _Mesh(1))


@pytest.mark.parametrize("rank", [0, 1])
def test_upload_sharded_in_chunks_returns_the_rank_rows(rank):
    per_rank = 2 * sh.UPLOAD_CHUNK_ROWS + 37  # two whole chunks and a part
    host = np.random.RandomState(rank).randint(0, 256, (2 * per_rank, 5, 3)).astype(np.uint8)
    got = sh.upload_sharded(host, _Mesh(rank), "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), host[rank * per_rank:(rank + 1) * per_rank])


def test_batch_statistics_stay_local_outside_the_dp_step(tmp_path):
    """The data-parallel step's BatchNorm takes its statistics over the
    group only inside its forward pass: after the step, and after the
    group is gone, a forward in training mode uses the module's own rows."""
    cfg = SSDConfig.ssd7(**KW)
    images, y_true = (torch.from_numpy(a[:4]) for a in _batch())
    model, _ = ssd_7(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    plain, _ = ssd_7(cfg, device="cpu")
    plain.load_state_dict(model.state_dict())
    sh.initialize_distributed("gloo", 1, 0,
                              store=torch.distributed.FileStore(str(tmp_path / "store"), 1))
    try:
        step = T.make_train_step(model, T.sgd_with_momentum(model.parameters(), LR),
                                 SSDLoss(), l2_reg=L2, mesh=sh.make_mesh("cpu"))
        dp = step(images, y_true)
    finally:
        torch.distributed.destroy_process_group()
    one = T.make_train_step(plain, T.sgd_with_momentum(plain.parameters(), LR),
                            SSDLoss(), l2_reg=L2)(images, y_true)
    np.testing.assert_allclose(float(dp["loss"]), float(one["loss"]), rtol=LOSS_RTOL)
    model.train()
    plain.train()
    with torch.no_grad():
        torch.testing.assert_close(model(images), plain(images), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_trainer_off_rank_0_writes_no_checkpoint_and_no_log(tmp_path):
    class Rank1:  # a 1-D mesh's rank query, rank 1
        def get_local_rank(self, dim=None):
            return 1

    model, _ = ssd_7(SSDConfig.ssd7(**KW), device="cpu")
    opt = T.sgd_with_momentum(model.parameters(), LR)
    trainer = T.Trainer(model, opt, train_step=None, mesh=Rank1())
    assert not trainer.is_writer
    path = trainer.save_checkpoint(tmp_path / "ckpt", step=0)
    assert path.endswith("ckpt_0.pt") and not (tmp_path / "ckpt").exists()
    T.CSVLogger(str(tmp_path / "log.csv")).on_epoch_end(0, {"loss": 1.0}, trainer)
    assert not (tmp_path / "log.csv").exists()
    assert T.Trainer(model, opt, train_step=None).is_writer
