#!/usr/bin/env python3
"""Time this tree's JPEG colour kernel against the one it replaced, on one card, in one process.

    mkdir -p _archive/parent
    git archive 21c3014 ssd_keras_torch/csrc/jpeg_color.cu | tar -x -C _archive/parent
    python3 jpeg_color_ab.py _archive/parent/ssd_keras_torch/csrc/jpeg_color.cu

The other source (the replaced kernel, one thread a pixel over a flat index,
``ssd_jpeg_ycc_to_rgb(planes, layout, out, n, max_pixels, stream)``) is
built alone with ``kernels/build.py``'s nvcc command into a temporary
directory, and once more with its per-pixel division taken out (a loop over
rows, then over a row's columns: ``NO_DIVISION``), both bound through
ctypes. This tree's kernel is built by ``kernels/build.py`` as the package
builds it; its register and shared-memory use (``nvcc -Xptxas -v``) is
printed first.

Every kernel is first held to the plain version (``ops/jpeg_color.py``) bit
for bit on ``chip_smoke.py``'s edge cases and on nvJPEG's planes of its
fixtures and of its 32 VOC-size 4:2:0 files. Then, on those 32 files'
planes, in ROUNDS rounds of parent, parent without division, change, change,
parent without division, parent: each kernel's device time per call from
CUDA events around calls with the card held (``utils.profiling.time_calls``)
and from its span in ``torch.profiler`` (a session that records no kernel
counts as not measured), the kernels called through their
C entries with the layout (and this tree's tiles) already on the card; and
whole calls that upload it from pinned memory each time, as each wrapper
does. Prints the card, one JSON line per round, a summary against the bytes
bound, and last ``{"ok": true, ...}``.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from ssd_keras_torch.kernels import build
from ssd_keras_torch.kernels import jpeg_color as color_kernel
from ssd_keras_torch.native import jpeg
from ssd_keras_torch.ops import jpeg_color
from ssd_keras_torch.utils.profiling import time_calls

ROUNDS = 5
ITERS = 50
# The replaced kernel's pixel loop, and the same loop without the division: one row at a
# time a block, a row's columns across its threads.
DIVISION_LOOP = """  const int64_t pixels = static_cast<int64_t>(h) * w;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < pixels;
       p += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(p / w);
    const int c = static_cast<int>(p - static_cast<int64_t>(r) * w);
"""
NO_DIVISION = """  for (int r = blockIdx.x; r < h; r += gridDim.x)
  for (int c = threadIdx.x; c < w; c += kThreads) {
    const int64_t p = static_cast<int64_t>(r) * w + c;
"""


def ptxas_report(source):
    """nvcc -Xptxas -v's lines for ``source``: registers, shared memory,
    spills of each kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = build.nvcc_command(build.find_nvcc(), [source], Path(tmp) / "x.o",
                                 compile_only=True) + ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines() if "ptxas info" in line]


def build_parent(source, tmp, name, text):
    """The replaced kernel from ``text``, built alone into ``tmp``."""
    src = Path(tmp) / f"{name}.cu"
    src.write_text(text)
    lib = Path(tmp) / f"lib{name}.so"
    build._run([build.nvcc_command(build.find_nvcc(), [src], lib)], lib)
    dll = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    dll.ssd_jpeg_ycc_to_rgb.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, p]
    dll.ssd_jpeg_ycc_to_rgb.restype = ctypes.c_int
    return dll


def parent_call(dll, planes, layout, out_bytes, device_layout=None):
    """A call of the replaced kernel, as its wrapper made it (the layout uploaded
    from pinned memory) or on a layout already on the card."""
    rows = layout.numpy()
    out = torch.empty(out_bytes, dtype=torch.uint8, device=planes.device)
    if device_layout is None:
        device_layout = layout.pin_memory().to(planes.device, non_blocking=True)
    status = dll.ssd_jpeg_ycc_to_rgb(
        planes.data_ptr(), device_layout.data_ptr(), out.data_ptr(), len(rows),
        int((rows[:, 5] * rows[:, 6]).max()), torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"the replaced kernel failed to launch: CUDA error {status}")
    return out


def change_kernel_only(planes, layout, out_bytes):
    """This tree's kernel through ``kernels/jpeg_color.py:launch``, the
    layout and tiles already on the card."""
    rows = layout.numpy()
    table, n_tiles = color_kernel.tile_table(rows)
    device_table = torch.from_numpy(table).to(planes.device)
    out = torch.empty(out_bytes, dtype=torch.uint8, device=planes.device)
    return lambda: color_kernel.launch(planes, device_table, len(rows), n_tiles, out)


def check(name, got, want, layout):
    where = cs.first_difference(got, want, layout)
    if where:
        raise AssertionError(f"{name} != plain: {where}")


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("jpeg_color_ab.py needs a CUDA device")
    if len(argv) != 2:
        raise SystemExit(__doc__)
    parent_source = Path(argv[1])
    text = parent_source.read_text()
    if DIVISION_LOOP not in text:
        raise SystemExit(f"{parent_source} is not the replaced kernel: its pixel loop is missing")
    card = cs.card_info()
    print(card, flush=True)
    torch.set_grad_enabled(False)
    source = build.CSRC_DIR / "jpeg_color.cu"
    print(json.dumps(dict(metric="ptxas", source=str(source), lines=ptxas_report(source))),
          flush=True)
    build.load_library()

    scenes = [cs.jpeg_scene(cs.SEED + 100 + k, *cs.JPEG_SIZES[0]) for k in range(cs.JPEG_BATCH)]
    voc = [cs.encode_jpeg(img, quality=cs.JPEG_QUALITY, subsampling=2) for img, _ in scenes]
    inputs = {case: cs.jpeg_color_case(case) for case in cs.JPEG_COLOR_CASES}
    inputs = {k: (p.cuda(), layout, n) for k, (p, layout, n) in inputs.items()}
    inputs["fixtures"] = jpeg.decode_planes(list(cs.jpeg_fixtures().values()))[:3]
    inputs["voc32_420"] = jpeg.decode_planes(voc)[:3]

    with tempfile.TemporaryDirectory() as tmp:
        parents = {"parent": build_parent(parent_source, tmp, "parent", text),
                   "parent_no_division": build_parent(parent_source, tmp, "parent_no_division",
                                                      text.replace(DIVISION_LOOP, NO_DIVISION))}
        for name, (planes, layout, out_bytes) in inputs.items():
            want = jpeg_color.ycc_to_rgb(planes, layout, out_bytes)
            check(f"this tree's kernel on {name}",
                  color_kernel.ycc_to_rgb(planes, layout, out_bytes), want, layout)
            for parent, dll in parents.items():
                check(f"{parent} on {name}", parent_call(dll, planes, layout, out_bytes), want,
                      layout)
        print(json.dumps(dict(metric="bit_equal", inputs=list(inputs),
                              kernels=["change", *parents])), flush=True)

        planes, layout, out_bytes = inputs["voc32_420"]
        device_layout = layout.to(planes.device)
        kernel_only = {
            **{name: (lambda dll=dll: parent_call(dll, planes, layout, out_bytes, device_layout))
               for name, dll in parents.items()},
            "change": change_kernel_only(planes, layout, out_bytes)}
        whole_call = {
            "parent": lambda: parent_call(parents["parent"], planes, layout, out_bytes),
            "change": lambda: color_kernel.ycc_to_rgb(planes, layout, out_bytes)}
        order = ["parent", "parent_no_division", "change", "change", "parent_no_division",
                 "parent"]
        results = {name: dict(span_us=[], events_us=[], call_us=[]) for name in kernel_only}
        for k in range(ROUNDS):
            line = dict(metric="jpeg_color_ab_round", round=k)
            for name in order:
                span_ms = cs.kernel_span_ms(kernel_only[name], "ycc_to_rgb")
                span = None if span_ms is None else 1e3 * span_ms  # None: not measured
                events = 1e3 * time_calls(kernel_only[name], "cuda", iters=ITERS)["median"]
                if span is not None:
                    results[name]["span_us"].append(span)
                results[name]["events_us"].append(events)
                if name in whole_call:
                    call = 1e3 * time_calls(whole_call[name], "cuda", iters=ITERS)["median"]
                    results[name]["call_us"].append(call)
                line.setdefault(name, []).append(dict(span_us=span, events_us=events))
            print(json.dumps(line), flush=True)

    rows = layout.numpy()
    nbytes = planes.numel() + layout.numel() * 8 + out_bytes
    bound_us = 1e6 * nbytes / cs.HBM_BYTES_PER_S
    summary = dict(metric="jpeg_color_ab", shape="voc32_420", images=len(rows),
                   pixels=int((rows[:, 5] * rows[:, 6]).sum()), bytes=nbytes, bound_us=bound_us,
                   rounds=ROUNDS, iters=ITERS, card=card)
    for name, r in results.items():
        spans, events = r["span_us"] or [float("nan")], statistics.median(r["events_us"])
        summary[name] = dict(
            span_us_median=statistics.median(spans), span_us_min=min(spans),
            span_us_max=max(spans), spans_measured=len(r["span_us"]), events_us_median=events,
            call_us_median=statistics.median(r["call_us"]) if r["call_us"] else None,
            share_of_bound=bound_us / events)
    summary["speedup_events"] = (summary["parent"]["events_us_median"]
                                 / summary["change"]["events_us_median"])
    summary["speedup_span"] = (summary["parent"]["span_us_median"]
                               / summary["change"]["span_us_median"])
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
