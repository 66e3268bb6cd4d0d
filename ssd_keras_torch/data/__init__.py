from ssd_keras_torch.data import chains, device_aug, geometric, patch_sampling, photometric
from ssd_keras_torch.data.chains import (
    DataAugmentationConstantInputSize,
    DataAugmentationSatellite,
    DataAugmentationVariableInputSize,
    SSDDataAugmentation,
)
from ssd_keras_torch.data.datasets import DataGenerator, DatasetError, DegenerateBatchError
from ssd_keras_torch.data.device_aug import DeviceSSDAugmentation
from ssd_keras_torch.data.geometric import Resize
from ssd_keras_torch.data.misc import apply_inverse_transforms
from ssd_keras_torch.data.photometric import ConvertTo3Channels
# As in the JAX package, ``prefetch`` here is the function: the submodule
# stays importable by its full name (``from ssd_keras_torch.data.prefetch
# import ...``).
from ssd_keras_torch.data.prefetch import PrefetchGenerator, prefetch
from ssd_keras_torch.data.streaming import StreamingDeviceInput, host_decode_batches
from ssd_keras_torch.data.synthvoc import SYNTHVOC_CLASS_NAMES, SynthVOC
from ssd_keras_torch.data.validation import BoundGenerator, BoxFilter, ImageValidator

__all__ = [
    "SynthVOC", "SYNTHVOC_CLASS_NAMES", "DataGenerator", "DatasetError", "DegenerateBatchError",
    "Resize", "ConvertTo3Channels", "apply_inverse_transforms",
    "BoundGenerator", "BoxFilter", "ImageValidator",
    "SSDDataAugmentation", "DataAugmentationConstantInputSize",
    "DataAugmentationVariableInputSize", "DataAugmentationSatellite",
    "DeviceSSDAugmentation", "PrefetchGenerator", "prefetch", "StreamingDeviceInput",
    "host_decode_batches", "chains", "device_aug", "geometric", "patch_sampling", "photometric",
]
