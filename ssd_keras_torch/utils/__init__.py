from ssd_keras_torch.utils.profiling import benchmark_fps, device_sync, trace
from ssd_keras_torch.utils.visualization import DEFAULT_PALETTE, draw_detections

__all__ = ["benchmark_fps", "device_sync", "trace", "draw_detections", "DEFAULT_PALETTE"]
