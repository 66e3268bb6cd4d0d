"""Weight conversion and Keras ``.h5`` import for the PyTorch models.

* :func:`from_flax_params` / :func:`to_flax_params` convert between the JAX
  package's flax parameter tree ``{layer: {"kernel", "bias" | "gamma"}}``
  and a PyTorch ``state_dict``. Both sides use the reference's layer names;
  the fused prediction heads keep theirs (``{src}_mbox_conf`` and
  ``{src}_mbox_loc``), so every layer maps one to one. Conv kernels are HWIO
  in flax and Keras, OIHW in PyTorch.
* :func:`load_keras_h5_weights` loads a reference Keras ``.h5`` weight file
  into a module by layer name, with the name rules of
  ``ssd_keras_tpu/weights_io.py``. ``h5py`` is imported only there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax_params", "to_flax_params", "load_keras_h5_weights"]

# flax parameter name -> PyTorch parameter name, per layer.
_FLAX_TO_TORCH = {"kernel": "weight", "bias": "bias", "gamma": "gamma"}
_TORCH_TO_FLAX = {v: k for k, v in _FLAX_TO_TORCH.items()}

# Keras h5 weight name -> flax parameter name (ssd_keras_tpu/weights_io.py).
_KERAS_TO_FLAX = {"kernel": "kernel", "bias": "bias", "gamma": "gamma"}


def from_flax_params(params: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """flax ``params`` (as numpy arrays) -> PyTorch ``state_dict`` (CPU)."""
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
    return state


def to_flax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """PyTorch ``state_dict`` -> flax ``params`` tree of f32 numpy arrays."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, tensor in state_dict.items():
        layer, _, key = name.rpartition(".")
        if key not in _TORCH_TO_FLAX or not layer:
            raise KeyError(f"unsupported parameter {name}")
        value = tensor.detach().to("cpu", torch.float32).numpy()
        if key == "weight":
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        params.setdefault(layer, {})[_TORCH_TO_FLAX[key]] = np.ascontiguousarray(value)
    return params


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
    ``load_weights(by_name=True)``), and vice versa. A dataset of a matched
    layer that maps onto no parameter is almost always a porting bug, so it
    warns by default (``on_unconsumed`` in {'warn', 'raise', 'ignore'}); a
    shape mismatch raises. Returns the names of the layers loaded.
    """
    import h5py

    params = to_flax_params(model.state_dict())
    loaded, unconsumed = [], []
    with h5py.File(h5_path, "r") as f:
        for name, datasets in _layer_groups(f):
            dest = params.get(name)
            if dest is None:
                continue
            for ds_name, value in datasets.items():
                key = _weight_key(ds_name, name)
                if key not in dest:
                    unconsumed.append(f"{name}/{ds_name}")
                    continue
                if dest[key].shape != value.shape:
                    raise ValueError(
                        f"Shape mismatch for {name}/{key}: "
                        f"checkpoint {value.shape} vs model {dest[key].shape}."
                    )
                dest[key] = value.astype(dest[key].dtype)
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
    model.load_state_dict(from_flax_params(params))
    return loaded
