"""Shared SSD head assembly and the model-output contract (PyTorch).

Port of ``ssd_keras_tpu/models/common.py``. The prediction tensor layout is
the cross-module contract (identical to the reference):

``(batch, total_boxes, n_classes + 4 + 8)`` =
``[softmaxed class confidences | 4 box offsets | 4 anchor coords | 4 variances]``

with boxes ordered as the C-order flatten of each predictor layer's
``(fh, fw, n_boxes_per_cell)`` grid (NHWC), layers concatenated in order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ssd_keras_torch import decoder as decoder_mod
from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.models.layers import (MaxPool, conv2d_epilogue, fuse_head_params,
                                           fused_prediction_heads)

__all__ = [
    "SSDModule",
    "assemble_predictions",
    "apply_mode",
    "init_weights",
    "same_pool_size",
    "valid_size",
    "validate_mode",
]


class SSDModule(nn.Module):
    """What the SSD models share: the config, the mode, the compute dtype
    and the per-device constants.

    Parameters stay f32 in every mode, as flax keeps them (``param_dtype``
    f32); ``forward`` casts each weight to ``compute_dtype`` where it is
    used, so an optimizer updates f32 master weights under bf16 compute.
    """

    def __init__(self, config: SSDConfig, mode: str, compute_dtype: torch.dtype,
                 predictor_sizes):
        super().__init__()
        self.config = config
        self.mode = validate_mode(mode)
        self.compute_dtype = compute_dtype
        self.anchors8 = config.anchor_tensor(predictor_sizes)  # (N, 8) float64 numpy
        self._constants_by_device: Dict[torch.device, Dict[str, Optional[torch.Tensor]]] = {}
        # key -> (the f32 parameters, their (_version, data_ptr), the cast result)
        self._cast_cache: Dict[tuple, tuple] = {}

    def _constants(self, device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
        """The anchors (f32) and preprocessing constants on ``device``,
        uploaded once: a copy from the host in every forward would make the
        host wait for the device each call."""
        consts = self._constants_by_device.get(device)
        if consts is None:
            cfg = self.config

            def upload(value, dtype):
                return None if value is None else torch.tensor(value, dtype=dtype, device=device)

            consts = dict(
                anchors=upload(self.anchors8, torch.float32),
                subtract_mean=upload(cfg.subtract_mean, torch.float32),
                divide_by_stddev=upload(cfg.divide_by_stddev, torch.float32),
                swap_channels=upload(cfg.swap_channels, torch.int64),
            )
            self._constants_by_device[device] = consts
        return consts

    def graph_inputs(self, device: torch.device) -> List[torch.Tensor]:
        """Every tensor the no-grad forward on ``device`` reads and keeps
        across calls: the parameters and buffers, the kept casts of the
        weights (``cast_params``) and the device constants. A CUDA graph of
        the forward reads them by raw pointer and must keep them alive."""
        kept = [t for entry in self._cast_cache.values() for t in entry[2]]
        consts = [t for t in self._constants(device).values() if t is not None]
        return [*self.parameters(), *self.buffers(), *kept, *consts]

    def cast_params(self, key: tuple, params: Sequence[torch.Tensor], build: Callable):
        """``build(*params)``: f32 parameters in the compute dtype.

        While autograd records, ``build`` runs at every call and its cast is
        part of the graph, as flax's ``.astype(dtype)`` is. While it does not
        (``no_grad``, ``inference_mode``: serving, evaluation), the result is
        kept under ``key`` and reused until one of ``params`` is replaced or
        changed in place: an optimizer step, ``load_state_dict`` or
        ``init_weights`` moves a parameter's ``_version``, ``module.to`` its
        ``data_ptr``. A write through ``param.data`` moves neither and is not
        seen.
        """
        if torch.is_grad_enabled():
            return build(*params)
        stamp = tuple((p._version, p.data_ptr()) for p in params)
        hit = self._cast_cache.get(key)
        if hit is not None and hit[1] == stamp and all(a is b for a, b in zip(hit[0], params)):
            return hit[2]
        out = build(*params)
        self._cast_cache[key] = (tuple(params), stamp, out)
        return out

    def conv(self, x: torch.Tensor, name: str, relu: bool = False,
             residual: Optional[torch.Tensor] = None,
             pool: Optional[MaxPool] = None) -> torch.Tensor:
        """The named ``nn.Conv2d`` (a dotted path for a nested one) on ``x``,
        its f32 weight and bias cast to ``x``'s dtype at use (flax's
        ``.astype(dtype)``), then ``residual`` added, the ReLU and the max
        pool, if asked (``layers.conv2d_epilogue``)."""
        m = self.get_submodule(name)
        weight, bias = self.cast_params(
            (name, x.dtype), (m.weight, m.bias), lambda w, b: (w.to(x.dtype), b.to(x.dtype)))
        return conv2d_epilogue(x, weight, bias, m.stride, m.padding, m.dilation, relu=relu,
                               residual=residual, pool=pool)

    def heads(self, feat: torch.Tensor, conf_name: str, loc_name: str):
        """The named conf and loc heads on ``feat`` as one convolution
        (``fused_prediction_heads``) at the conf head's stride and padding,
        which the loc head shares; their weights are fused and cast as
        ``conv`` casts. Returns the two NHWC maps."""
        conf, loc = getattr(self, conf_name), getattr(self, loc_name)
        weight, bias = self.cast_params(
            (conf_name, loc_name, feat.dtype), (conf.weight, loc.weight, conf.bias, loc.bias),
            lambda cw, lw, cb, lb: fuse_head_params(cw, lw, cb, lb, feat.dtype))
        return fused_prediction_heads(feat, weight, bias, conf.out_channels, conf.stride,
                                      conf.padding)


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """He-normal conv kernels, zero biases (flax ``he_normal``: a normal
    truncated at 2 std, std = sqrt(2 / fan_in) / 0.8796...), drawn from
    ``generator``. L2Normalization keeps its gamma of 20, BatchNorm its unit
    scale and zero shift; a conv without a bias has none to zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


def same_pool_size(s: int) -> int:
    """Output size of a stride-2 'SAME' pool."""
    return -(-s // 2)


def valid_size(s: int, kernel: int, stride: int = 1, pad: int = 0) -> int:
    """Output size of a VALID conv with optional symmetric zero padding."""
    return (s + 2 * pad - kernel) // stride + 1


def assemble_predictions(
    conf_maps: List[torch.Tensor],
    loc_maps: List[torch.Tensor],
    anchors8: torch.Tensor,
    n_classes_with_bg: int,
) -> torch.Tensor:
    """Reshape + concatenate head outputs and append the anchor constants.

    ``conf_maps[i]``: (B, fh, fw, n_boxes*C) NHWC; ``loc_maps[i]``:
    (B, fh, fw, n_boxes*4); ``anchors8``: (N, 8) f32 on the maps' device.
    Output is float32 regardless of compute dtype (softmax in f32).
    """
    b = conf_maps[0].shape[0]
    conf = torch.cat([m.reshape(b, -1, n_classes_with_bg) for m in conf_maps], dim=1)
    loc = torch.cat([m.reshape(b, -1, 4) for m in loc_maps], dim=1)
    conf = torch.softmax(conf.float(), dim=-1)
    anchors = anchors8.expand(b, *anchors8.shape)
    return torch.cat([conf, loc.float(), anchors], dim=2)


def validate_mode(mode: str) -> str:
    """Reject unknown modes at build time, like the reference builders do."""
    if mode not in ("training", "inference", "inference_fast"):
        raise ValueError(
            f"`mode` must be 'training', 'inference' or 'inference_fast', "
            f"got {mode!r}."
        )
    return mode


def apply_mode(predictions: torch.Tensor, mode: str, config: SSDConfig) -> torch.Tensor:
    """Append the decode stage for 'inference' / 'inference_fast' modes."""
    if mode == "training":
        return predictions
    kwargs = dict(
        confidence_thresh=config.confidence_thresh,
        iou_threshold=config.iou_threshold,
        top_k=config.top_k,
        nms_max_output_size=config.nms_max_output_size,
        input_coords=config.coords,
        normalize_coords=config.normalize_coords,
        img_height=config.img_height,
        img_width=config.img_width,
    )
    if mode == "inference":
        return decoder_mod.decode_detections_fixed(predictions, **kwargs)
    if mode == "inference_fast":
        return decoder_mod.decode_detections_fast_fixed(predictions, **kwargs)
    raise ValueError(
        f"`mode` must be 'training', 'inference' or 'inference_fast', got {mode!r}."
    )
