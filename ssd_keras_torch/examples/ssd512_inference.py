"""Run SSD512 inference on images and print the detections.

Port of the JAX package's ``examples/ssd512_inference.py``; the code path
is ``ssd300_inference``'s at 512x512.

Usage:
  python -m ssd_keras_torch.examples.ssd512_inference --weights trained512.h5 image1.jpg
"""

from __future__ import annotations

from ssd_keras_torch.examples.ssd300_inference import run


def main(argv=None):
    return run(argv, "ssd512")


if __name__ == "__main__":
    main()
