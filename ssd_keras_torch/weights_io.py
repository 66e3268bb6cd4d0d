"""Weight conversion and Keras ``.h5`` import for the PyTorch models.

* :func:`from_flax_params` / :func:`to_flax_params` convert between the JAX
  package's flax trees (``params`` ``{layer: {"kernel", "bias" | "gamma" |
  "scale"}}`` and ``batch_stats`` ``{layer: {"mean", "var"}}``) and a
  PyTorch ``state_dict``. Both sides use the reference's layer names; the
  fused prediction heads keep theirs (``{src}_mbox_conf`` and
  ``{src}_mbox_loc``, SSD7's ``classes{i}`` and ``boxes{i}``), so every
  layer maps one to one. Conv kernels are HWIO in flax and Keras, OIHW in
  PyTorch. A BatchNorm's ``scale`` is its ``weight``, its ``mean`` and
  ``var`` its ``running_mean`` and ``running_var``.
* :func:`load_keras_h5_weights` loads a reference Keras ``.h5`` weight file
  into a module by layer name, with the name rules of
  ``ssd_keras_tpu/weights_io.py`` (BatchNorm's ``gamma``, ``beta``,
  ``moving_mean`` and ``moving_variance`` included). ``h5py`` is imported
  only there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax_params", "to_flax_params", "load_keras_h5_weights"]

Tree = Dict[str, Dict[str, np.ndarray]]

# flax name -> PyTorch name, per layer (``scale`` only on BatchNorm layers).
_FLAX_TO_TORCH = {"kernel": "weight", "bias": "bias", "gamma": "gamma", "scale": "weight"}
_STATS_TO_TORCH = {"mean": "running_mean", "var": "running_var"}
_TORCH_TO_STATS = {v: k for k, v in _STATS_TO_TORCH.items()}

# Keras h5 weight name -> flax name (ssd_keras_tpu/weights_io.py).
_KERAS_TO_FLAX = {"kernel": "kernel", "bias": "bias", "gamma": "gamma",
                  "beta": "beta", "moving_mean": "mean", "moving_variance": "var"}
# BatchNorm statistics live in flax's `batch_stats` tree, not `params`.
_BN_STATS = {"moving_mean", "moving_variance"}
# Keras BatchNormalization's affine names vs flax.linen.BatchNorm's.
_KERAS_BN_TO_FLAX = {"gamma": "scale", "beta": "bias"}


def from_flax_params(params: Tree, batch_stats: Optional[Tree] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (and ``batch_stats``), as numpy arrays -> PyTorch
    ``state_dict`` (CPU)."""
    state = {}
    for layer, tensors in params.items():
        for key, value in tensors.items():
            if key not in _FLAX_TO_TORCH:
                raise KeyError(f"unsupported flax parameter {layer}/{key}")
            value = np.asarray(value)
            if key == "kernel":
                if value.ndim != 4:
                    raise ValueError(f"{layer}/kernel: expected HWIO, got {value.shape}")
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            state[f"{layer}.{_FLAX_TO_TORCH[key]}"] = torch.tensor(value)
    for layer, tensors in (batch_stats or {}).items():
        for key, value in tensors.items():
            if key not in _STATS_TO_TORCH:
                raise KeyError(f"unsupported flax batch statistic {layer}/{key}")
            state[f"{layer}.{_STATS_TO_TORCH[key]}"] = torch.tensor(np.asarray(value))
    return state


def to_flax_params(state_dict: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """PyTorch ``state_dict`` -> flax ``(params, batch_stats)`` trees of f32
    numpy arrays; ``batch_stats`` is empty for a model without BatchNorm."""
    params: Tree = {}
    stats: Tree = {}
    for name, tensor in state_dict.items():
        layer, _, key = name.rpartition(".")
        value = np.ascontiguousarray(tensor.detach().to("cpu", torch.float32).numpy())
        is_bn = f"{layer}.running_mean" in state_dict
        if key in _TORCH_TO_STATS and is_bn:
            stats.setdefault(layer, {})[_TORCH_TO_STATS[key]] = value
            continue
        if not layer or key not in ("weight", "bias", "gamma"):
            raise KeyError(f"unsupported parameter {name}")
        if key == "weight" and is_bn:
            flax_key = "scale"
        elif key == "weight":
            flax_key = "kernel"
            value = np.ascontiguousarray(value.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        else:
            flax_key = key
        params.setdefault(layer, {})[flax_key] = value
    return params, stats


def _layer_groups(f):
    """Yield (layer_name, {dataset_name: array}) for every layer with weights."""
    import h5py

    root = f["model_weights"] if "model_weights" in f else f
    for name in root:
        g = root[name]
        if not isinstance(g, h5py.Group):
            continue
        # Keras nests the weights one level deeper under the layer name again.
        inner = g[name] if name in g else g
        datasets = {}

        def collect(prefix, obj):
            if hasattr(obj, "shape"):
                datasets[prefix] = np.array(obj)

        inner.visititems(collect)
        if datasets:
            yield name, datasets


def _weight_key(ds_name: str, layer_name: str) -> str:
    """Keras dataset name -> weight key: ``'{layer}/kernel:0'`` -> ``kernel``,
    and L2Normalization's ``'{layer}_gamma:0'`` -> ``gamma``."""
    key = ds_name.split("/")[-1].split(":")[0]
    if key in _KERAS_TO_FLAX:
        return key
    if key.startswith(layer_name + "_"):
        stripped = key[len(layer_name) + 1:]
        if stripped in _KERAS_TO_FLAX:
            return stripped
    for known in _KERAS_TO_FLAX:
        if key.endswith("_" + known):
            return known
    return key


def load_keras_h5_weights(
    h5_path: str, model: nn.Module, on_unconsumed: str = "warn"
) -> List[str]:
    """Load a Keras ``.h5`` weight file into ``model`` in place, by layer name.

    Layers in the file but not in the model are skipped (Keras
    ``load_weights(by_name=True)``), and vice versa. BatchNorm layers take
    ``gamma``, ``beta``, ``moving_mean`` and ``moving_variance``. A dataset of
    a matched layer that maps onto no parameter is almost always a porting
    bug, so it warns by default (``on_unconsumed`` in {'warn', 'raise',
    'ignore'}); a shape mismatch raises. Returns the names of the layers
    loaded.
    """
    import h5py

    params, stats = to_flax_params(model.state_dict())
    loaded, unconsumed = [], []
    with h5py.File(h5_path, "r") as f:
        for name, datasets in _layer_groups(f):
            target_p, target_s = params.get(name), stats.get(name)
            if target_p is None and target_s is None:
                continue
            for ds_name, value in datasets.items():
                key = _weight_key(ds_name, name)
                flax_key = _KERAS_TO_FLAX.get(key, key)
                dest = target_s if key in _BN_STATS else target_p
                if target_s is not None and key in _KERAS_BN_TO_FLAX:
                    # A BatchNorm's gamma/beta; L2Normalization keeps 'gamma'.
                    flax_key = _KERAS_BN_TO_FLAX[key]
                if dest is None or flax_key not in dest:
                    unconsumed.append(f"{name}/{ds_name}")
                    continue
                if dest[flax_key].shape != value.shape:
                    raise ValueError(
                        f"Shape mismatch for {name}/{flax_key}: "
                        f"checkpoint {value.shape} vs model {dest[flax_key].shape}."
                    )
                dest[flax_key] = value.astype(dest[flax_key].dtype)
            loaded.append(name)
    if unconsumed and on_unconsumed != "ignore":
        msg = (
            f"{h5_path}: {len(unconsumed)} dataset(s) in matched layers were "
            f"not mapped onto any model parameter: {unconsumed}. The "
            "corresponding model weights keep their current values."
        )
        if on_unconsumed == "raise":
            raise ValueError(msg)
        import warnings

        warnings.warn(msg, stacklevel=2)
    model.load_state_dict(from_flax_params(params, stats))
    return loaded
