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
* :func:`save_keras_h5_weights` writes a module's weights as a Keras-format
  ``.h5`` file by the same layer names (OIHW back to HWIO), as the JAX
  package's writer does; :func:`load_keras_h5_weights` here or there reads
  it back.
* :func:`sample_tensors` and :func:`sample_classifier_weights` (vendored
  NumPy) sub- or up-sample predictor-head weights across class counts, on
  arrays in the Keras/flax HWIO layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "from_flax_params",
    "to_flax_params",
    "load_keras_h5_weights",
    "save_keras_h5_weights",
    "sample_tensors",
    "sample_classifier_weights",
]

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
_FLAX_BN_TO_KERAS = {v: k for k, v in _KERAS_BN_TO_FLAX.items()}


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


def save_keras_h5_weights(h5_path: str, model: nn.Module) -> None:
    """Write ``model``'s weights as a genuine Keras-format ``.h5`` weight file.

    The layout of Keras 2.x ``save_weights`` for the reference models, as
    ``ssd_keras_tpu/weights_io.py:save_keras_h5_weights`` writes it from a
    flax tree:

    * root attrs ``layer_names`` / ``backend`` / ``keras_version``,
    * per-layer-group ``weight_names`` attr listing the variable names,
    * Conv/BN variables under a nested ``{layer}/{weight}:0`` path (kernels
      HWIO; a BatchNorm's ``gamma``, ``beta``, ``moving_mean`` and
      ``moving_variance``),
    * L2Normalization's gamma as a flat ``{layer}_gamma:0`` dataset.
    """
    import h5py

    params, batch_stats = to_flax_params(model.state_dict())
    inv = {v: k for k, v in _KERAS_TO_FLAX.items()}

    def _bytes_attr(names):
        # NumPy sizes the fixed-width bytes dtype to the longest name.
        return np.array([n.encode("utf8") for n in names])

    with h5py.File(h5_path, "w") as f:
        f.attrs["backend"] = np.asarray(b"tensorflow")
        f.attrs["keras_version"] = np.asarray(b"2.2.4")
        layer_names = list(params)
        f.attrs["layer_names"] = _bytes_attr(layer_names)
        for name in layer_names:
            tensors = dict(params[name])
            stats = dict(batch_stats.get(name, {}))
            g = f.create_group(name)
            weight_names = []
            if set(tensors) == {"gamma"} and not stats:
                # L2Normalization-style layer: flat '{layer}_gamma:0' dataset.
                wname = f"{name}_gamma:0"
                g.create_dataset(wname, data=tensors["gamma"])
                weight_names.append(wname)
            else:
                inner = g.create_group(name)
                is_batchnorm = "scale" in tensors
                for key in list(tensors) + list(stats):
                    value = tensors[key] if key in tensors else stats[key]
                    if is_batchnorm and key in _FLAX_BN_TO_KERAS:
                        keras_key = _FLAX_BN_TO_KERAS[key]
                    else:
                        keras_key = inv.get(key, key)
                    inner.create_dataset(f"{keras_key}:0", data=value)
                    weight_names.append(f"{name}/{keras_key}:0")
            g.attrs["weight_names"] = _bytes_attr(weight_names)


# --------------------------------------------------------------------------- #
# Weight sub-/up-sampling (transfer a head across class counts), vendored from
# ssd_keras_tpu/weights_io.py (NumPy; draws from the global np.random state)
# --------------------------------------------------------------------------- #


def sample_tensors(
    weights_list: List[np.ndarray],
    sampling_instructions: Sequence,
    axes: Optional[List] = None,
    init=None,
    mean: float = 0.0,
    stddev: float = 0.005,
):
    """Sub-sample or up-sample weight tensors consistently along given axes.

    ``sampling_instructions``: per axis of the first tensor, either an int
    (target size: random sub-sample keeping index order, or gaussian/zeros
    up-fill) or a list of explicit indices to keep. Trailing tensors (e.g.
    biases) are sampled along their matching last axes via ``axes``.
    Capability parity with tensor_sampling_utils.py:21-177.
    """
    first = weights_list[0]
    if len(sampling_instructions) != first.ndim:
        raise ValueError(
            "One sampling instruction per axis of the first tensor is required."
        )
    init = init or ["gaussian"] * len(sampling_instructions)

    # Resolve each axis' kept-index list (sub-sampling) or target size (up).
    out_indices: List[Optional[np.ndarray]] = []
    out_sizes: List[int] = []
    for ax, instr in enumerate(sampling_instructions):
        size = first.shape[ax]
        if isinstance(instr, (list, tuple, np.ndarray)):
            idx = np.asarray(instr, dtype=np.int64)
            if idx.max() >= size:
                raise ValueError(
                    f"Axis {ax}: explicit indices exceed source size {size}."
                )
            out_indices.append(np.sort(idx))
            out_sizes.append(len(idx))
        elif int(instr) <= size:
            idx = np.sort(np.random.choice(size, int(instr), replace=False))
            out_indices.append(idx)
            out_sizes.append(int(instr))
        else:
            out_indices.append(None)  # up-sample
            out_sizes.append(int(instr))

    def sample_one(tensor: np.ndarray, tensor_axes: Sequence[int]):
        # `tensor_axes` maps this tensor's axes onto the instruction axes.
        out = tensor
        for t_ax, i_ax in enumerate(tensor_axes):
            idx = out_indices[i_ax]
            target = out_sizes[i_ax]
            if idx is not None:
                out = np.take(out, idx, axis=t_ax)
            elif target > out.shape[t_ax]:
                shape = list(out.shape)
                shape[t_ax] = target
                if init[i_ax] == "zeros":
                    filled = np.zeros(shape, dtype=out.dtype)
                else:
                    filled = np.random.normal(mean, stddev, shape).astype(out.dtype)
                sl = [slice(None)] * out.ndim
                sl[t_ax] = slice(0, out.shape[t_ax])
                filled[tuple(sl)] = out
                out = filled
        return out

    results = [sample_one(first, list(range(first.ndim)))]
    for i, tensor in enumerate(weights_list[1:]):
        if axes is None or i >= len(axes):
            # Default: sample trailing tensors along the *last* instruction
            # axis (the classifier-output axis), as for kernel+bias pairs.
            tensor_axes = [first.ndim - 1] * tensor.ndim
        else:
            tensor_axes = list(axes[i])
        results.append(sample_one(tensor, tensor_axes))
    return results


def sample_classifier_weights(
    kernel: np.ndarray,
    bias: np.ndarray,
    n_classes_source: int,
    classes_of_interest: Sequence[int],
    n_boxes: int,
):
    """Port a conf head (HWIO ``kernel``) from ``n_classes_source`` to
    ``len(classes_of_interest)`` classes.

    Expands the per-box class indices (class 0 / background always kept first
    if included in ``classes_of_interest``) exactly like the weight-sampling
    tutorial's index arithmetic (weight_sampling_tutorial.ipynb cell 14).
    """
    idx = []
    for b in range(n_boxes):
        idx.extend(int(c) + b * n_classes_source for c in classes_of_interest)
    return sample_tensors(
        [kernel, bias],
        sampling_instructions=list(kernel.shape[:-1]) + [idx],
        axes=[[kernel.ndim - 1]],
    )
