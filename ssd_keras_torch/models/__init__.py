from ssd_keras_torch.models.common import init_weights
from ssd_keras_torch.models.layers import BatchNorm, L2Normalization
from ssd_keras_torch.models.ssd7 import SSD7, build_model, ssd7_predictor_sizes, ssd_7
from ssd_keras_torch.models.ssd300 import SSD300, ssd300_predictor_sizes, ssd_300
from ssd_keras_torch.models.ssd512 import SSD512, ssd512_predictor_sizes, ssd_512
from ssd_keras_torch.models.ssd_r34 import SSDR34, ssd_r34, ssd_r34_mlperf, ssd_r34_predictor_sizes

__all__ = [
    "SSD300", "ssd_300", "ssd300_predictor_sizes",
    "SSD512", "ssd_512", "ssd512_predictor_sizes",
    "SSDR34", "ssd_r34", "ssd_r34_mlperf", "ssd_r34_predictor_sizes",
    "SSD7", "ssd_7", "build_model", "ssd7_predictor_sizes",
    "init_weights", "BatchNorm", "L2Normalization",
]
