"""ssd_keras_torch: the SSD detection framework in PyTorch, for NVIDIA Hopper.

A port of ``ssd_keras_tpu`` (JAX on a TPU), which stays the reference: the
same configuration, layer names and prediction-tensor contract, tested
against it output by output. The hand-written Pallas kernel of the JAX
package (greedy NMS) is a hand-written CUDA kernel here (``csrc/nms.cu``),
built with nvcc at first use. Imports torch and numpy only.

This slice covers SSD300 serving: ``ssd_300`` in the 'training',
'inference' and 'inference_fast' modes, the fixed-shape decoders, the
predictor and weight conversion.
"""

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.decoder import decode_detections_fast_fixed, decode_detections_fixed
from ssd_keras_torch.models import ssd_300
from ssd_keras_torch.predictor import SSDPredictor
from ssd_keras_torch.weights_io import (
    from_flax_params,
    load_keras_h5_weights,
    to_flax_params,
)

__version__ = "0.1.0"

__all__ = [
    "SSDConfig",
    "ssd_300",
    "SSDPredictor",
    "decode_detections_fixed",
    "decode_detections_fast_fixed",
    "from_flax_params",
    "to_flax_params",
    "load_keras_h5_weights",
]
