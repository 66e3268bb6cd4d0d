"""ssd_keras_torch: the SSD detection framework in PyTorch, for NVIDIA Hopper.

A port of ``ssd_keras_tpu`` (JAX on a TPU), which stays the reference: the
same configuration, layer names and prediction-tensor contract, tested
against it output by output. The hand-written Pallas kernel of the JAX
package (greedy NMS) is a hand-written CUDA kernel here (``csrc/nms.cu``),
built with nvcc at first use. Imports torch and numpy only.

The port covers SSD300, SSD512 and SSD7 in the 'training', 'inference' and
'inference_fast' modes, the fixed-shape and the host decoders, the
predictor, weight conversion and ``.h5`` import and export (BatchNorm
included), BatchNorm and preprocessing folding (``optimize``), training (the
target encoder, the SSD loss, optimizers, the train step, callbacks and the
``Trainer``; ``train``), data-parallel training (``parallel``), and
evaluation: the ``DataGenerator``, the VOC ``Evaluator`` and the COCO tools
(``eval``), with the host C++ of ``native`` built by g++ at first use.
Parameters stay f32; ``compute_dtype`` sets the precision of the compute.
"""

from ssd_keras_torch.config import SSDConfig
from ssd_keras_torch.decoder import (
    decode_detections,
    decode_detections_fast,
    decode_detections_fast_fixed,
    decode_detections_fixed,
)
from ssd_keras_torch.encoder import DegenerateBoxError, SSDInputEncoder
from ssd_keras_torch.loss import SSDLoss
from ssd_keras_torch.models import ssd_7, ssd_300, ssd_512
from ssd_keras_torch.optimize import fold_batchnorm, fold_preprocessing
from ssd_keras_torch.predictor import SSDPredictor
from ssd_keras_torch.weights_io import (
    from_flax_params,
    load_keras_h5_weights,
    save_keras_h5_weights,
    to_flax_params,
)

__version__ = "0.1.0"

__all__ = [
    "SSDConfig",
    "ssd_300",
    "ssd_512",
    "ssd_7",
    "SSDInputEncoder",
    "DegenerateBoxError",
    "SSDLoss",
    "SSDPredictor",
    "decode_detections_fixed",
    "decode_detections_fast_fixed",
    "decode_detections",
    "decode_detections_fast",
    "fold_batchnorm",
    "fold_preprocessing",
    "from_flax_params",
    "to_flax_params",
    "load_keras_h5_weights",
    "save_keras_h5_weights",
]
