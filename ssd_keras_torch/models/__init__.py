from ssd_keras_torch.models.layers import L2Normalization
from ssd_keras_torch.models.ssd300 import SSD300, init_weights, ssd300_predictor_sizes, ssd_300

__all__ = ["SSD300", "ssd_300", "ssd300_predictor_sizes", "init_weights", "L2Normalization"]
