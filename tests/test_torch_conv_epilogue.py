"""The convolutions' epilogue and its pooled variant
(``kernels/conv_epilogue.py``, their plain versions ``ops/conv_epilogue.py``,
the dispatch ``models/layers.py:conv2d_epilogue``) on the CPU.

The plain version against PyTorch's own ``add_`` / ``add_`` / ``relu_``
sequence bit for bit (dtypes, layouts, channel counts, ragged sizes, NaN
and -0.0); the plain pooled version against the epilogue then
``F.max_pool2d`` and against the kernel's window-order reduction (dtypes,
the pools' geometries, odd and ragged sizes, NaN, +-0.0 and +-inf); the
wrappers' checks and results; each model's no-grad forward (the epilogues)
against its grad-enabled forward (PyTorch's ops) and the number of
epilogues, pooled ones among them, a forward makes; a training forward
never enters either. The kernels themselves are held to the plain versions
on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
from torch import nn

from chip_smoke import ENTRY_BF16_REL_L2

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.kernels import conv_epilogue as epilogue_kernel
from ssd_keras_torch.models import ssd_7, ssd_300, ssd_512, ssd_r34
from ssd_keras_torch.models import layers
from ssd_keras_torch.ops import conv_epilogue as plain
from ssd_keras_torch.ops.conv_epilogue import MaxPool
from ssd_keras_torch.utils import profiling

torch.set_num_threads(2)

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
# (N, H, W): a batch of maps, and a ragged one (3 pixels).
SIZES = [(2, 5, 7), (1, 3, 1)]
# The stem's 3, the trunk's 64, the 81-class conf heads' 324 and 486.
CHANNELS = [3, 64, 324, 486]
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def _map(shape, dtype, channels_last, seed):
    """A map of ``shape`` with special values planted: NaN, +-0.0, +-inf,
    and values around the working type's rounding."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=gen) * 3
    flat = y.view(-1)
    for k, value in enumerate([float("nan"), -0.0, 0.0, float("inf"), float("-inf")]):
        if k < flat.numel():
            flat[(k * 7919) % flat.numel()] = value
    y = y.to(dtype)
    return y.contiguous(memory_format=torch.channels_last) if channels_last else y


def _bits(t):
    return t.contiguous().view(_BITS[t.dtype])


def _same(got, want):
    """Bit for bit, but for a NaN's payload: PyTorch's own CPU paths write
    bf16 NaNs with other payloads (its vectorized conversion 0xffff, its
    add 0x7fc0), so a NaN only has to be one."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(_bits(got)[~nan],
                                                              _bits(want)[~nan])


def _pytorch_sequence(y, bias, residual, relu):
    ref = y.clone()
    ref.add_(bias.view(1, -1, 1, 1))
    if residual is not None:
        ref.add_(residual)
    return ref.relu_() if relu else ref


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_pytorchs_add_add_relu_bit_for_bit(dtype, channels, channels_last,
                                                        with_residual, relu):
    for k, (n, h, w) in enumerate(SIZES):
        shape = (n, channels, h, w)
        y = _map(shape, dtype, channels_last, seed=k)
        bias = torch.randn(channels, generator=torch.Generator().manual_seed(9)).to(dtype)
        bias[0] = -0.0
        residual = _map(shape, dtype, channels_last, seed=k + 10) if with_residual else None
        want = _pytorch_sequence(y, bias, residual, relu)
        got = plain.conv_epilogue(y.clone(memory_format=torch.preserve_format), bias, residual,
                                  relu)
        assert _same(got, want)


def test_wrapper_works_in_place_and_takes_the_plain_version_on_the_cpu():
    y = _map((2, 64, 4, 6), torch.bfloat16, True, seed=1)
    bias = torch.randn(64).bfloat16()
    residual = _map((2, 64, 4, 6), torch.bfloat16, True, seed=2)
    want = _pytorch_sequence(y, bias, residual, True)
    ptr, before = y.data_ptr(), profiling.counters().get("conv_epilogue.launches", 0)
    got = epilogue_kernel.conv_epilogue(y, bias, residual, relu=True)
    assert got is y and y.data_ptr() == ptr
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _same(y, want)
    # The CPU launches nothing.
    assert profiling.counters().get("conv_epilogue.launches", 0) == before


def _bad_calls():
    y = torch.zeros(2, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(8)
    return {
        "dtype": (y.double(), bias.double(), None, TypeError),
        "integer dtype": (y.int(), bias.int(), None, TypeError),
        "bias shape": (y, torch.zeros(4), None, ValueError),
        "bias dtype": (y, bias.bfloat16(), None, ValueError),
        "bias not contiguous": (y, torch.zeros(8, 2)[:, 0], None, ValueError),
        "one dimension": (torch.zeros(8), bias, None, ValueError),
        "residual shape": (y, bias, torch.zeros(2, 8, 3, 4), ValueError),
        "residual dtype": (y, bias, y.bfloat16(), ValueError),
        "residual strides": (y, bias, y.contiguous(), ValueError),
        "layout": (y.transpose(2, 3), bias, None, ValueError),
        "bias device": (y, bias.to("meta"), None, ValueError),
        "residual device": (y, bias, y.to("meta"), ValueError),
        "device": (y.to("meta"), bias.to("meta"), None, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    y, bias, residual, error = _bad_calls()[case]
    with pytest.raises(error):
        epilogue_kernel.conv_epilogue(y, bias, residual)


def test_wrapper_takes_contiguous_and_one_pixel_maps():
    for shape, fmt in [((2, 5, 3, 4), torch.contiguous_format), ((2, 5, 1, 1), torch.channels_last),
                       ((3, 1, 2, 2), torch.channels_last), ((4, 6), torch.contiguous_format)]:
        y = torch.randn(shape).contiguous(memory_format=fmt) if len(shape) == 4 else torch.randn(
            shape)
        bias = torch.randn(shape[1])
        want = y + bias.view((1, -1) + (1,) * (y.dim() - 2))
        assert torch.equal(epilogue_kernel.conv_epilogue(y, bias), want)


# ---------------------------------------------------------------------------
# The pooled epilogue
# ---------------------------------------------------------------------------

# The models' pools (SSD300/512's pool1-3, pool5, SSD-ResNet34's stem) and
# the rest of what the kernel takes (ceil on 3x3/2, padded and not).
POOLS = {
    "2x2/2 ceil": MaxPool(2, 2, 0, True),
    "3x3/1 pad 1": MaxPool(3, 1, 1),
    "3x3/2 pad 1": MaxPool(3, 2, 1),
    "3x3/2 pad 1 ceil": MaxPool(3, 2, 1, True),
    "3x3/2 ceil": MaxPool(3, 2, 0, True),
}
# (N, H, W): 75 -> 38 under ceil, a ragged map, a tiny one.
POOL_SIZES = [(1, 75, 75), (2, 7, 5), (1, 2, 3)]


def _window_order_pool(t, pool):
    """``pool`` of ``t`` as the kernel reduces: each window's elements in
    order, rows then columns, from -inf, an element taken where it is
    greater or NaN, elements outside the map skipped."""
    n, c, h, w = t.shape
    oh, ow = pool.output_size(h), pool.output_size(w)
    best = torch.full((n, c, oh, ow), float("-inf"), dtype=t.dtype)
    for i in range(pool.window):
        rows = torch.arange(oh) * pool.stride - pool.padding + i
        for j in range(pool.window):
            cols = torch.arange(ow) * pool.stride - pool.padding + j
            inside = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
            v = t[:, :, rows.clamp(0, h - 1)][:, :, :, cols.clamp(0, w - 1)]
            best = torch.where(inside & ((v > best) | torch.isnan(v)), v, best)
    return best


@pytest.mark.parametrize("channels", [3, 64])
@pytest.mark.parametrize("geometry", sorted(POOLS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_pool_equals_the_epilogue_then_max_pool_bit_for_bit(dtype, geometry, channels):
    pool = POOLS[geometry]
    for k, (n, h, w) in enumerate(POOL_SIZES):
        y = _map((n, channels, h, w), dtype, True, seed=20 + k)
        bias = torch.randn(channels, generator=torch.Generator().manual_seed(8)).to(dtype)
        bias[0] = -0.0
        before = y.clone()
        got = plain.conv_epilogue_pool(y, bias, pool)
        assert torch.equal(_bits(y), _bits(before))  # y is left as it is
        assert got.is_contiguous(memory_format=torch.channels_last)
        epilogue = _pytorch_sequence(y, bias, None, True)
        assert _same(got, torch.nn.functional.max_pool2d(
            epilogue, pool.window, pool.stride, pool.padding, ceil_mode=pool.ceil_mode))
        assert _same(got, _window_order_pool(epilogue, pool))
        # The kernel's order: the rounded sums' max along each window row,
        # then over the rows, the ReLU last.
        assert _same(got, _relu_of_row_maxima(_pytorch_sequence(y, bias, None, False), pool))


def _relu_of_row_maxima(t, pool):
    """``pool`` of ``relu(t)`` as the kernel takes it: the max of ``t``
    along each window row, then over the rows' maxima (a NaN over
    anything), elements outside the map skipped, then the ReLU."""
    n, c, h, w = t.shape
    oh, ow = pool.output_size(h), pool.output_size(w)
    cols = [torch.arange(ow) * pool.stride - pool.padding + j for j in range(pool.window)]
    best = None
    for i in range(pool.window):
        rows = torch.arange(oh) * pool.stride - pool.padding + i
        row_best = None
        for j in range(pool.window):
            inside = ((rows >= 0) & (rows < h))[:, None] & ((cols[j] >= 0) & (cols[j] < w))[None, :]
            v = t[:, :, rows.clamp(0, h - 1)][:, :, :, cols[j].clamp(0, w - 1)]
            v = torch.where(inside, v, torch.full_like(v, float("-inf")))
            row_best = v if row_best is None else torch.where(
                torch.isnan(v) | torch.isnan(row_best), torch.full_like(v, float("nan")),
                torch.maximum(row_best, v))
        best = row_best if best is None else torch.where(
            torch.isnan(row_best) | torch.isnan(best), torch.full_like(best, float("nan")),
            torch.maximum(best, row_best))
    return torch.relu(best)


def test_pool_output_size_is_pytorchs():
    for pool in POOLS.values():
        for size in range(2, 40):
            want = torch.nn.functional.max_pool2d(torch.zeros(1, 1, size, size), pool.window,
                                                  pool.stride, pool.padding,
                                                  ceil_mode=pool.ceil_mode).shape[-1]
            assert pool.output_size(size) == want, (pool, size)


def test_pool_wrapper_takes_the_plain_version_on_the_cpu():
    y = _map((2, 64, 75, 75), torch.bfloat16, True, seed=3)
    bias = torch.randn(64).bfloat16()
    pool = POOLS["2x2/2 ceil"]
    before = profiling.counters()
    got = epilogue_kernel.conv_epilogue_pool(y, bias, pool)
    assert got.shape == (2, 64, 38, 38) and got.is_contiguous(memory_format=torch.channels_last)
    assert _same(got, plain.conv_epilogue_pool(y, bias, pool))
    # The CPU launches nothing.
    after = profiling.counters()
    for name in ("conv_epilogue.launches", "conv_epilogue.pooled"):
        assert after.get(name, 0) == before.get(name, 0)


def _bad_pool_calls():
    y = torch.zeros(2, 8, 5, 5).contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(8)
    pool = MaxPool(2, 2, 0, True)
    return {
        "dtype": (y.double(), bias.double(), pool, TypeError),
        "bias shape": (y, torch.zeros(4), pool, ValueError),
        "layout": (y.contiguous(), bias, pool, ValueError),
        "three dimensions": (torch.zeros(8, 5, 5), bias, pool, ValueError),
        "window": (y, bias, MaxPool(4, 2), ValueError),
        "stride": (y, bias, MaxPool(2, 3), ValueError),
        "2x2 at stride 1": (y, bias, MaxPool(2, 1), ValueError),
        "padding on a 2x2 window": (y, bias, MaxPool(2, 2, 1), ValueError),
        "padding": (y, bias, MaxPool(3, 2, 2), ValueError),
        "nothing left": (torch.zeros(2, 8, 1, 1).contiguous(memory_format=torch.channels_last),
                         bias, MaxPool(2, 2), ValueError),
        "device": (y.to("meta"), bias.to("meta"), pool, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_pool_calls()))
def test_pool_wrapper_raises_on_what_the_kernel_does_not_take(case):
    y, bias, pool, error = _bad_pool_calls()[case]
    with pytest.raises(error):
        epilogue_kernel.conv_epilogue_pool(y, bias, pool)


# ---------------------------------------------------------------------------
# The models: the epilogue without autograd, PyTorch's ops with it
# ---------------------------------------------------------------------------

# The no-grad forward against the grad-enabled one, on the raw prediction
# tensor. float32: the same sums but for the bias's place in them (oneDNN
# adds it inside the convolution), within the float32 heads' 1e-5 of
# ``test_torch_models.py``. bf16: oneDNN rounds once after conv + bias,
# the epilogue after the conv and again after the bias (as cuDNN and
# PyTorch's add on the card do), which over some 20 layers moves the
# outputs by 0.4-3.8% (relative L2); held, for scores and offsets, to the
# bf16 limits the graft entry's tests hold bf16 against float32 to
# (``chip_smoke.ENTRY_BF16_REL_L2``).
F32_TOL = 1e-5


def _randomize(model, seed):
    """Non-zero biases and BatchNorm statistics in place of the init's zeros
    and identities, so that the epilogue has a bias to add."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            if isinstance(m, layers.BatchNorm):
                n = m.weight.shape
                m.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.7)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 1.0)
    return model


def _build(name, dtype):
    gen = torch.Generator().manual_seed(3)
    if name == "ssd300":
        model, _ = ssd_300(mode="training", compute_dtype=dtype, device="cpu", generator=gen)
        size = 300
    elif name == "ssd512":
        model, _ = ssd_512(mode="training", compute_dtype=dtype, device="cpu", generator=gen)
        size = 512
    elif name == "ssd7":
        model, _ = ssd_7(SSDConfig.ssd7(n_classes=3, img_height=64, img_width=64),
                         mode="training", compute_dtype=dtype, device="cpu", generator=gen)
        model.eval()
        size = 64
    else:
        model, _ = ssd_r34(mode="inference", compute_dtype=dtype, device="cpu", generator=gen,
                           img_height=400, img_width=400)
        size = 400
    if name in ("ssd300", "ssd512"):
        with torch.no_grad():
            model.conv1_1.weight.mul_(0.01)  # scores off the softmax's saturation
    return _randomize(model, 4), size


def _raw(model, x):
    return model.predictions(x) if hasattr(model, "predictions") else model(x)


# Epilogues a forward makes: each convolution with a bias (BatchNorms
# folded), the conf and loc heads of a source as one. Of them pooled: the
# VGG SSDs' conv1_2, conv2_2, conv3_3 and conv5_3, SSD-ResNet34's conv1.
EPILOGUES = {"ssd300": 23 + 6, "ssd512": 25 + 7, "ssd7": 7 + 4, "ssd_r34": 29 + 10 + 6}
POOLED = {"ssd300": 4, "ssd512": 4, "ssd7": 0, "ssd_r34": 1}


def _counted_epilogues(monkeypatch):
    """Patches both epilogues to their plain versions; returns the list of
    the calls' kinds ("epilogue" or "pooled")."""
    calls = []

    def epilogue(*args, **kwargs):
        calls.append("epilogue")
        return plain.conv_epilogue(*args, **kwargs)

    def pooled(*args, **kwargs):
        calls.append("pooled")
        return plain.conv_epilogue_pool(*args, **kwargs)

    monkeypatch.setattr(epilogue_kernel, "conv_epilogue", epilogue)
    monkeypatch.setattr(epilogue_kernel, "conv_epilogue_pool", pooled)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_no_grad_forward_equals_the_grad_enabled_forward(name, dtype, monkeypatch):
    model, size = _build(name, dtype)
    x = torch.rand((1, size, size, 3), generator=torch.Generator().manual_seed(5)) * 255
    calls = _counted_epilogues(monkeypatch)
    with torch.no_grad():
        fused = _raw(model, x)
    assert len(calls) == EPILOGUES[name] and calls.count("pooled") == POOLED[name]
    with torch.enable_grad():
        unfused = _raw(model, x)
    assert len(calls) == EPILOGUES[name]  # the grad-enabled forward made none
    if dtype == torch.float32:
        torch.testing.assert_close(fused, unfused.detach(), rtol=F32_TOL, atol=F32_TOL)
        return
    n_classes = model.config.n_classes_with_background
    for part, cols in (("probs", slice(0, n_classes)), ("boxes", slice(n_classes, n_classes + 4))):
        a, b = fused[..., cols].double(), unfused[..., cols].detach().double()
        assert float((a - b).norm() / b.norm()) < ENTRY_BF16_REL_L2[part]
    torch.testing.assert_close(fused[..., n_classes + 4:], unfused[..., n_classes + 4:].detach(),
                               rtol=0, atol=0)  # the anchors


@pytest.mark.parametrize("name", ["ssd7", "ssd300"])
def test_a_training_forward_never_enters_the_epilogue(name, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("the epilogue under autograd")

    monkeypatch.setattr(epilogue_kernel, "conv_epilogue", refused)
    monkeypatch.setattr(epilogue_kernel, "conv_epilogue_pool", refused)
    model, size = _build(name, torch.float32)
    model.train()
    x = torch.rand((2 if name == "ssd7" else 1, size, size, 3),
                   generator=torch.Generator().manual_seed(6)) * 255
    y = model(x)
    y.sum().backward()
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
    with pytest.raises(AssertionError, match="under autograd"), torch.no_grad():
        model.eval()
        model(x)


def test_conv2d_epilogue_with_grad_runs_pytorchs_ops():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, 6, 6, generator=gen, requires_grad=True)
    w = torch.randn(8, 4, 3, 3, generator=gen, requires_grad=True)
    b = torch.randn(8, generator=gen, requires_grad=True)
    r = torch.randn(2, 8, 6, 6, generator=gen)
    got = layers.conv2d_epilogue(x, w, b, 1, 1, relu=True, residual=r)
    want = torch.relu(torch.nn.functional.conv2d(x, w, b, 1, 1) + r)
    assert torch.equal(got, want) and got.grad_fn is not None
    got.sum().backward()
    assert x.grad is not None and w.grad is not None and b.grad is not None


def test_conv2d_epilogue_with_grad_and_a_pool_runs_pytorchs_ops():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, 7, 7, generator=gen).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    w = torch.randn(8, 4, 3, 3, generator=gen, requires_grad=True)
    b = torch.randn(8, generator=gen, requires_grad=True)
    pool = MaxPool(3, 2, 1)
    got = layers.conv2d_epilogue(x, w, b, 1, 1, relu=True, pool=pool)
    want = torch.nn.functional.max_pool2d(
        torch.relu(torch.nn.functional.conv2d(x, w, b, 1, 1)), 3, 2, 1)
    assert torch.equal(got, want) and got.grad_fn is not None
    got.sum().backward()
    assert x.grad is not None and w.grad is not None and b.grad is not None
    with torch.no_grad():
        pooled = layers.conv2d_epilogue(x, w, b, 1, 1, relu=True, pool=pool)
    torch.testing.assert_close(pooled, want.detach(), rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="no residual"):
        layers.conv2d_epilogue(x, w, b, 1, 1, relu=True, residual=torch.zeros(2, 8, 7, 7),
                               pool=pool)
    with pytest.raises(ValueError, match="takes the ReLU"):
        layers.conv2d_epilogue(x, w, b, 1, 1, pool=pool)
