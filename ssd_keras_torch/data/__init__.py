from ssd_keras_torch.data.synthvoc import SYNTHVOC_CLASS_NAMES, SynthVOC

__all__ = ["SynthVOC", "SYNTHVOC_CLASS_NAMES"]
