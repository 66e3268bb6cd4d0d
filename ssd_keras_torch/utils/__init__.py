from ssd_keras_torch.utils.visualization import DEFAULT_PALETTE, draw_detections

__all__ = ["draw_detections", "DEFAULT_PALETTE"]
