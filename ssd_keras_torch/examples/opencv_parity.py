"""The host image ops against OpenCV, cell by cell: the max |difference|
of ``data.geometric.warp_affine`` and ``resize_image`` and of
``data.photometric.cvt_color`` from ``cv2``, for every image type OpenCV
takes, at 1-4 channels, with IPP on (``cv2`` as its wheels ship it, the JAX
package's reference) and off (OpenCV's own code).

    python -m ssd_keras_torch.examples.opencv_parity [--tree DIR] [--out FILE]

Needs OpenCV, which the port itself never imports. ``--tree`` measures the
``ssd_keras_torch`` of another checkout (a ``git archive`` of a parent, for
a before-and-after), in a child process. Prints markdown tables, then
``RESULT {json}``; the tables also go to ``--out`` (default under the temp
dir). A cell reads ``raises X`` where the port raises. Inputs: seeded noise
over each integer type's range, floats over [-20, 280); the warp on a 37x53
image to 60x45 and 50x41 with a shift, a rotation and a scale and a zero and
a coloured border; the resizes up, down, 2x, 3x, 4x, non-integer, to and
from one pixel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

TYPES = ("uint8", "uint16", "int16", "float32", "float64")
CHANNELS = (1, 2, 3, 4)
MODES = {"nearest": 0, "linear": 1, "cubic": 2, "area": 3, "lanczos4": 4}
RESIZES = (((37, 53), (90, 120)), ((120, 90), (41, 17)), ((45, 60), (45, 128)),
           ((64, 64), (32, 32)), ((60, 63), (20, 21)), ((48, 40), (12, 10)),
           ((128, 96), (43, 32)), ((1, 1), (5, 7)), ((9, 11), (1, 1)), ((33, 47), (47, 33)))
BORDERS = (0, (10, 200, 30))
NEAREST_ONLY = ("int8", "uint32", "int32", "int64", "uint64", "bool")


def noise(rng, shape, dtype):
    """Seeded test images: integer types over their whole range, bool 0/1,
    floats over [-20, 280)."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.randint(0, 2, shape).astype(bool)
    if dtype.kind in "ui":
        info = np.iinfo(dtype)
        if info.bits == 64:
            return rng.randint(info.min, info.max, shape, dtype=dtype)
        return rng.randint(info.min, info.max + 1, shape, dtype=np.int64).astype(dtype)
    return (rng.rand(*shape) * 300 - 20).astype(dtype)


def _maps(cv2):
    return (np.array([[1, 0, 3.3], [0, 1, -2.6]]), cv2.getRotationMatrix2D((20.3, 15.7), 17, 1.1),
            np.array([[0.77, 0, 1.9], [0, 1.31, -0.4]]))


def _diff(fn, want):
    """max |fn() - want|, or the exception fn raises."""
    try:
        got = fn()
    except Exception as e:  # a cell the port does not take
        return f"raises {type(e).__name__}"
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.dtype}{list(got.shape)} vs {want.dtype}{list(want.shape)}"
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())


def _worst(values):
    errors = [v for v in values if isinstance(v, str)]
    return errors[0] if errors else max(values)


def measure() -> dict:
    """Every cell, with IPP on and off: {"warp": {...}, "resize": {...},
    "nearest": {...}, "gray_uint16": {...}}, keys "dtype x channels"
    (and "mode" for the resizes)."""
    import cv2

    from ssd_keras_torch.data import geometric, photometric

    before = cv2.ipp.useIPP()
    out = {"warp": {}, "resize": {}, "nearest": {}, "gray_uint16": {}}
    try:
        for ipp in (True, False):
            cv2.ipp.setUseIPP(ipp)
            tag = "ipp" if ipp else "no_ipp"
            for dtype in TYPES:
                for c in CHANNELS:
                    image = noise(np.random.RandomState(c), (37, 53, c), dtype)
                    cells = []
                    for m in _maps(cv2):
                        for border in BORDERS:
                            for dsize in ((60, 45), (50, 41)):
                                want = cv2.warpAffine(image, m, dsize, borderValue=border)
                                cells.append(_diff(lambda: geometric.warp_affine(
                                    image, m, dsize, border), want))
                    out["warp"].setdefault(f"{dtype} x{c}", {})[tag] = _worst(cells)
                    for mode, flag in MODES.items():
                        cells = []
                        for k, (src, dst) in enumerate(RESIZES):
                            image = noise(np.random.RandomState(k + c), (*src, c), dtype)
                            want = cv2.resize(image, dst[::-1], interpolation=flag)
                            cells.append(_diff(lambda: geometric.resize_image(
                                image, *dst, flag), want))
                        out["resize"].setdefault(f"{dtype} x{c} {mode}", {})[tag] = _worst(cells)
            for dtype in NEAREST_ONLY:
                cells = []
                for k, (src, dst) in enumerate(RESIZES):
                    image = noise(np.random.RandomState(k), (*src, 3), dtype)
                    want = cv2.resize(image, dst[::-1], interpolation=cv2.INTER_NEAREST)
                    cells.append(_diff(lambda: geometric.resize_image(
                        image, *dst, geometric.INTER_NEAREST), want))
                out["nearest"].setdefault(dtype, {})[tag] = _worst(cells)
            cells = []
            for width in (31, 32, 33, 65, 256):
                image = noise(np.random.RandomState(width), (7, width, 3), np.uint16)
                cells.append(_diff(lambda: photometric.cvt_color(image, "RGB", "GRAY"),
                                   cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)))
            out["gray_uint16"]["RGB->GRAY"] = dict(out["gray_uint16"].get("RGB->GRAY", {}),
                                                   **{tag: _worst(cells)})
    finally:
        cv2.ipp.setUseIPP(before)
    return out


def _cell(v):
    return v if isinstance(v, str) else f"{v:.3g}"


def markdown(result: dict, title: str) -> str:
    lines = [f"# {title}", ""]
    for table, rows in result.items():
        lines += [f"## {table}", "", "| cell | cv2 (IPP) | cv2 (no IPP) |", "|---|---|---|"]
        lines += [f"| {k} | {_cell(v['ipp'])} | {_cell(v['no_ipp'])} |" for k, v in rows.items()]
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="a checkout whose ssd_keras_torch to measure (default: this one)")
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "ssd_keras_torch_opencv_parity.md"))
    parser.add_argument("--json-only", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tree:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.tree))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--json-only"],
                              env=env, cwd=os.path.abspath(args.tree), capture_output=True,
                              text=True, check=True)
        result = json.loads(proc.stdout.strip().splitlines()[-1])
    else:
        result = measure()
    if args.json_only:
        print(json.dumps(result))
        return result
    text = markdown(result, f"The host image ops against OpenCV ({args.tree or 'this tree'})")
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print("RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
