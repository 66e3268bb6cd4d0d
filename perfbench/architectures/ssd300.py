"""SSD300 (arXiv:1512.02325, ssd_keras ``keras_ssd300.py``): VGG-16 to
conv7_2, then conv8 and conv9 unpadded, six predictor layers."""

from perfbench.architectures import _vgg

PORT_BUILDER = "ssd_keras_torch.models:ssd_300"
EXTRAS = [("conv8_1", 256, 128, 1, 1, 0, 1), ("conv8_2", 128, 256, 3, 1, 0, 1),
          ("conv9_1", 256, 128, 1, 1, 0, 1), ("conv9_2", 128, 256, 3, 1, 0, 1)]
# (feature, its channels) of each predictor layer.
SOURCES = [("conv4_3_norm", 512), ("fc7", 1024), ("conv6_2", 512), ("conv7_2", 256),
           ("conv8_2", 256), ("conv9_2", 256)]


def conv_table(config):
    return _vgg.conv_table(config, EXTRAS, SOURCES)


def feature_sizes(config):
    return _vgg.feature_sizes(config, EXTRAS, SOURCES)


def sources(config):
    return list(SOURCES)


def parameters(config):
    return _vgg.parameters(config, EXTRAS, SOURCES)


def forward(config, params, images, quantize=None):
    return _vgg.forward(config, params, images, EXTRAS, SOURCES, quantize)
