"""Inference-graph optimizations: host-side parameter transforms (PyTorch).

Port of ``ssd_keras_tpu/optimize.py`` on a ``state_dict``, the port's
counterpart of flax ``variables``: conv weights are OIHW here (HWIO there),
so the output-channel axis is 0 and the input-channel axis 1. The
arithmetic is float64, and each result is cast back to the original dtype.

Folding math (per output channel c, Keras BN semantics):

    scale_c   = gamma_c / sqrt(var_c + eps)
    kernel'_c = kernel_c * scale_c
    bias'_c   = beta_c + (bias_c - mean_c) * scale_c

which makes ``conv'(x) == bn(conv(x))`` exactly (up to float rounding).
A conv without a bias (torchvision's ResNet convolutions) folds with
``bias_c = 0`` and gains one. Serve the folded parameters with
``ssd_7(..., fold_bn=True)``; SSD-ResNet34 folds its own
(``models/ssd_r34.py``, at torchvision's epsilon 1e-5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["fold_batchnorm", "fold_preprocessing"]

StateDict = Dict[str, torch.Tensor]


def _bn_layers(state_dict: StateDict) -> List[str]:
    """The BatchNorm layers of ``state_dict``: those with running statistics."""
    suffix = ".running_mean"
    return [k[: -len(suffix)] for k in state_dict if k.endswith(suffix)]


def _detect_pairs(state_dict: StateDict, bn_names: List[str]) -> List[Tuple[str, str]]:
    """Match each BN layer to its producing conv by the shared name suffix
    (``conv{i}`` -> ``bn{i}``, SSD7's naming). Raises if a BN layer has no
    matching conv: silent partial folding would corrupt the model."""
    pairs = []
    for bn_name in bn_names:
        if not bn_name.startswith("bn"):
            raise ValueError(
                f"Cannot auto-match batch_stats entry {bn_name!r} to a conv; "
                "pass explicit (conv_name, bn_name) pairs."
            )
        conv_name = "conv" + bn_name[len("bn"):]
        if f"{conv_name}.weight" not in state_dict:
            raise ValueError(
                f"BN layer {bn_name!r} has no matching conv {conv_name!r}; "
                "pass explicit (conv_name, bn_name) pairs."
            )
        pairs.append((conv_name, bn_name))
    return pairs


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _like(value: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(value).to(dtype=ref.dtype, device=ref.device)


def fold_batchnorm(
    state_dict: StateDict,
    pairs: Optional[List[Tuple[str, str]]] = None,
    epsilon: float = 1e-3,
) -> StateDict:
    """Fold every BatchNorm into its preceding conv; return a new state_dict.

    Args:
      state_dict: a model's ``state_dict`` with BatchNorm layers (``weight``
        and ``bias`` = gamma/beta, ``running_mean``/``running_var``).
      pairs: explicit ``(conv_name, bn_name)`` pairs; auto-detected from the
        ``conv{i}``/``bn{i}`` naming convention when omitted.
      epsilon: the BN epsilon the model was built with (Keras default 1e-3,
        as in models/ssd7.py; torchvision's is 1e-5).

    Returns:
      the state_dict with each conv folded (a conv with no ``bias`` entry
      gets one) and every BN entry removed; load it into a model built
      with ``fold_bn=True``.
    """
    bn_names = _bn_layers(state_dict)
    if not bn_names:
        raise ValueError("state_dict has no batch_stats (BatchNorm running statistics); "
                         "nothing to fold.")
    if pairs is None:
        pairs = _detect_pairs(state_dict, bn_names)
    out = dict(state_dict)
    for conv_name, bn_name in pairs:
        kernel_t = state_dict[f"{conv_name}.weight"]
        gamma = _f64(state_dict[f"{bn_name}.weight"])
        beta = _f64(state_dict[f"{bn_name}.bias"])
        mean = _f64(state_dict[f"{bn_name}.running_mean"])
        var = _f64(state_dict[f"{bn_name}.running_var"])
        scale = gamma / np.sqrt(var + epsilon)
        kernel = _f64(kernel_t) * scale[:, None, None, None]  # OIHW: out channels first
        conv_bias = state_dict.get(f"{conv_name}.bias")
        bias = beta + ((0.0 if conv_bias is None else _f64(conv_bias)) - mean) * scale
        out[f"{conv_name}.weight"] = _like(kernel, kernel_t)
        out[f"{conv_name}.bias"] = _like(bias, kernel_t)
        for key in ("weight", "bias", "running_mean", "running_var"):
            del out[f"{bn_name}.{key}"]
    return out


def fold_preprocessing(state_dict: StateDict, config, conv_name: str = "conv1_1"):
    """Fold the channel swap + stddev division into the first conv's kernel.

    Mean-sub -> stddev-div -> channel-swap: the last two are a per-channel
    linear map that fixes 0, so they commute with the conv's zero padding
    and fold exactly into the first conv's input-channel axis (axis 1 of an
    OIHW kernel):

        kernel'[o, j, h, w] = kernel[o, inv_swap[j], h, w] / stddev[j]

    Mean subtraction stays in the graph: it does not fix 0, so folding it
    would change what the border padding taps see. The returned config keeps
    ``subtract_mean`` and clears ``swap_channels`` and ``divide_by_stddev``.

    Returns ``(state_dict', config')``: rebuild the model from ``config'``
    and load ``state_dict'``; outputs match the original to float rounding.
    """
    swap = config.swap_channels
    std = config.divide_by_stddev
    if not swap and std is None:
        raise ValueError(
            "Neither swap_channels nor divide_by_stddev is set; nothing to fold."
        )
    kernel_t = state_dict[f"{conv_name}.weight"]
    kernel = _f64(kernel_t)
    cin = kernel.shape[1]
    if swap:
        if sorted(swap) != list(range(cin)):
            raise ValueError(f"swap_channels {swap} is not a permutation "
                             f"of {cin} input channels.")
        kernel = kernel[:, np.argsort(np.asarray(swap)), :, :]
    if std is not None:
        kernel = kernel / np.asarray(std, np.float64)[None, :, None, None]
    out = dict(state_dict)
    out[f"{conv_name}.weight"] = _like(np.ascontiguousarray(kernel), kernel_t)
    return out, dataclasses.replace(config, swap_channels=None, divide_by_stddev=None)
