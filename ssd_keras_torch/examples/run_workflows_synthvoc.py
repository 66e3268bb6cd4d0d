"""Run every workflow of ``ssd_keras_torch.examples`` end to end on a
SynthVOC export.

Port of the JAX package's ``examples/run_workflows_synthvoc.py``. It exports
SynthVOC in genuine Pascal-VOC (07 + 12), MS-COCO and CSV layouts, with the
VOC class names so the unmodified VOC workflows read it, then runs each
workflow as a subprocess (``python -m ssd_keras_torch.examples.<name>``):

1. ``ssd300_training``      (callbacks, checkpoints; the host chain at quick
                             scale, the device pipeline at full scale)
2. ``h5_export``            (``export_h5``: the checkpoint as a Keras ``.h5``)
3. ``ssd300_evaluation``    (XML parser, evaluator, VOC results txt)
4. ``ssd300_evaluation_coco`` (JSON parser, COCO results bridge)
5. ``weight_sampling``      (classifier heads 21 -> 4 classes), then
   ``sampled_weights_load`` (the sampled ``.h5`` into a 3-class SSD300)
6. ``ssd300_inference`` (and at full scale ``ssd512_inference``)
7. ``ssd7_training``        (CSV parser, constant-size chain)

Weights pass between the rows as the port's ``.pt`` checkpoint. The rows of
step 2 and 5 need h5py; where it does not import they are recorded as
``not run: no h5py`` (neither ``ok`` nor dropped). A row fails on a non-zero
exit, on ``loss=nan`` or ``loss=inf`` in its output, on a timeout (recorded,
not raised) and, at full scale, on the output floors: training loss down to
0.8x, VOC mAP >= 0.2, COCO AP >= 0.08, printed boxes finite and in frame.
Each row also records the NMS kernel launches its process reports.

Writes a status table to ``--out`` (default: under the system temp dir).

Usage:
  python -m ssd_keras_torch.examples.run_workflows_synthvoc --scale quick
  python -m ssd_keras_torch.examples.run_workflows_synthvoc --scale full
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from ssd_keras_torch.devices import target_device
from ssd_keras_torch.examples.common import VOC_CLASSES, checkpoint_step

PACKAGE = "ssd_keras_torch.examples"
# The directory that holds the ssd_keras_torch package: the subprocesses'
# working directory, so ``-m`` finds it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NOT_RUN_H5 = "not run: no h5py"

# (train 07, train 12, val images), (steps a epoch, epochs, batch)
SCALES = {"quick": ((24, 8, 16), (6, 1, 4)), "full": ((1200, 400, 320), (4000, 2, 32))}

# The JAX driver's name for the checkpoint sort key.
checkpoint_epoch = checkpoint_step


def check_eval_map(floor):
    """Full-scale floor: the printed VOC mAP must clear ``floor`` -- a
    broken model (bad weights, bad decode, bad data) scores ~0 here."""

    def check(full):
        m = re.search(r"^mAP\s+([0-9.]+)", full, re.M)
        if not m:
            return "no mAP line in output"
        if float(m.group(1)) < floor:
            return f"mAP {m.group(1)} below floor {floor}"
        return None

    return check


def check_coco_ap(floor):
    """Full-scale floor on the executed COCO metric (vendored or real)."""

    def check(full):
        m = re.search(r"COCO AP=([0-9.]+)", full)
        if m is None:
            # pycocotools prints its standard summary block instead.
            m = re.search(r"Average Precision.*IoU=0.50:0.95.*area=\s*all.*"
                          r"=\s*([0-9.-]+)", full)
        if not m:
            return "no COCO AP in output"
        if float(m.group(1)) < floor:
            return f"COCO AP {m.group(1)} below floor {floor}"
        return None

    return check


def check_inference_boxes(frame_w=300, frame_h=300, margin=30):
    """Full-scale sanity: printed detections must exist, be finite, be
    non-degenerate, and lie in the image frame."""

    def check(full):
        rows = re.findall(
            r"^\s{3}\S+\s+[0-9.]+\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)"
            r"\s+(-?[\d.]+)\s*$", full, re.M)
        if not rows:
            return "no detections printed"
        for row in rows:
            try:
                x0, y0, x1, y1 = (float(v) for v in row)
            except ValueError:
                return f"non-numeric box row: {row}"
            if not all(np.isfinite([x0, y0, x1, y1])):
                return f"non-finite box: {row}"
            if x0 >= x1 or y0 >= y1:
                return f"degenerate box: {row}"
            if (min(x0, y0) < -margin or x1 > frame_w + margin
                    or y1 > frame_h + margin):
                return f"box outside frame: {row}"
        return None

    return check


def check_training_loss_decreased(csv_path, factor=0.8):
    """Full-scale floor: the CSV log's last-epoch loss must be below
    ``factor`` x its first-epoch loss."""

    def check(full):
        if not os.path.exists(csv_path):
            return f"no CSV log at {csv_path}"
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        if not rows:
            return "empty CSV log"
        try:
            first, last = float(rows[0]["loss"]), float(rows[-1]["loss"])
        except (KeyError, TypeError, ValueError) as e:
            return f"unparseable CSV log ({type(e).__name__}: {e})"
        if not (np.isfinite(first) and np.isfinite(last)):
            return f"non-finite loss in CSV log ({first}, {last})"
        if last > first * factor:
            return f"loss did not decrease: {first:.3f} -> {last:.3f}"
        return None

    return check


def _record(results, name, ok, seconds, tail, status=None, launches=None):
    results.append({"workflow": name, "ok": ok, "status": status or ("ok" if ok else "FAILED"),
                    "seconds": round(seconds, 1), "tail": tail, "nms_launches": launches})


def run(name, cmd, results, timeout=1800, check=None):
    """Run ``python cmd...`` and record one row; returns whether it passed."""
    print(f"\n=== {name}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    launches = None
    try:
        proc = subprocess.run([sys.executable] + cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=ROOT)
        full = proc.stdout + proc.stderr
        tail = "\n".join(full.strip().splitlines()[-12:])
        # Training exits non-zero on TerminateOnNaN; the substring check over
        # the whole output backs it up for any path that still exits 0 after
        # printing a non-finite loss.
        ok = proc.returncode == 0 and "loss=nan" not in full and "loss=inf" not in full
        if ok and check is not None:
            # Output floors (full scale): an exit code of 0 cannot catch a
            # model that runs but produces garbage.
            err = check(full)
            if err:
                ok = False
                tail += f"\nFLOOR CHECK FAILED: {err}"
                print(f"FLOOR CHECK FAILED: {err}", flush=True)
        found = re.findall(r"^NMS kernel launches: (\d+)$", proc.stdout, re.M)
        launches = int(found[-1]) if found else None
    except subprocess.TimeoutExpired:
        # A hung workflow must not discard the report for the ones that ran.
        tail = f"timed out after {timeout}s"
        ok = False
    dt = time.time() - t0
    _record(results, name, ok, dt, tail, launches=launches)
    print(tail, flush=True)
    print(f"=== {name}: {'OK' if ok else 'FAILED'} ({dt:.0f}s)", flush=True)
    return ok


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def run_h5(name, cmd, results, **kwargs):
    """``run`` for a row that needs h5py: without it, the row is recorded
    as not run."""
    if not have_h5py():
        _record(results, name, False, 0.0, "h5py does not import here", status=NOT_RUN_H5)
        print(f"=== {name}: {NOT_RUN_H5}", flush=True)
        return False
    return run(name, cmd, results, **kwargs)


def failed(results):
    return [r["workflow"] for r in results if r["status"] not in ("ok", NOT_RUN_H5)]


def export_synthvoc(root, n_train, n_train12, n_val):
    """The driver's dataset: VOC2007 trainval (``n_train``) and test
    (``n_val``), VOC2012 trainval (``n_train12``), the val split as COCO, and
    the 07 train split's labels as a CSV. Returns the paths."""
    from ssd_keras_torch.data.synthvoc import SynthVOC

    voc_root = os.path.join(root, "VOCdevkit")
    os.makedirs(root, exist_ok=True)
    tr07 = SynthVOC(n_train, 300, split="train", seed=0)
    im07, lb07 = tr07.materialize()
    tr07.export_voc(os.path.join(voc_root, "VOC2007"), im07, lb07,
                    image_set="trainval", class_names=VOC_CLASSES)
    tr12 = SynthVOC(n_train12, 300, split="train", seed=7)
    tr12.export_voc(os.path.join(voc_root, "VOC2012"), *tr12.materialize(),
                    image_set="trainval", class_names=VOC_CLASSES)
    val = SynthVOC(n_val, 300, split="val", seed=0)
    val_imgs, val_labels = val.materialize()
    val.export_voc(os.path.join(voc_root, "VOC2007"), val_imgs, val_labels,
                   image_set="test", class_names=VOC_CLASSES)
    val.export_coco(os.path.join(root, "coco"), val_imgs, val_labels)

    # CSV labels for the SSD7 workflow (the reference's Udacity-style format).
    csv_path = os.path.join(root, "ssd7_labels.csv")
    with open(csv_path, "w") as f:
        f.write("frame,xmin,xmax,ymin,ymax,class_id\n")
        for i, lab in enumerate(lb07):
            for cls, x0, y0, x1, y1 in np.asarray(lab):
                f.write(f"train_{i:06d}.jpg,{int(x0)},{int(x1)},"
                        f"{int(y0)},{int(y1)},{int(cls)}\n")
    return dict(voc_root=voc_root, img_dir07=os.path.join(voc_root, "VOC2007", "JPEGImages"),
                coco=os.path.join(root, "coco"), csv=csv_path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="every port workflow on a SynthVOC export")
    p.add_argument("--scale", choices=sorted(SCALES), default="quick")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "ssd_keras_torch_workflows"))
    p.add_argument("--out", default=None,
                   help="the report (default: workflows_run.md in --root)")
    p.add_argument("--device", default="cuda", help="passed to every workflow")
    p.add_argument("--ssd512_checkpoint", default=None,
                   help="a trained SSD512 port checkpoint (synthvoc_benchmark --model "
                        "ssd512); enables trained-model box floors on ssd512_inference")
    return p.parse_args(argv)


def run_workflows(args):
    """Export, run every row, write the report; returns the rows."""
    target_device(args.device)  # no card raises here, not in every row
    quick = args.scale == "quick"
    # Full scale is the JAX driver's: 2 x 4000 steps at batch 32 with the
    # warmup recipe, so that a working model clears the floors with margin.
    (n_train, n_train12, n_val), (steps, epochs, batch) = SCALES[args.scale]
    root = args.root
    out = args.out or os.path.join(root, "workflows_run.md")
    dev = ["--device", args.device]

    print(f"Exporting SynthVOC ({args.scale}) to {root} ...", flush=True)
    paths = export_synthvoc(root, n_train, n_train12, n_val)
    voc_root = paths["voc_root"]

    results = []
    h5_path = os.path.join(root, "ssd300_trained.h5")
    ckpt_dir = os.path.join(root, "ckpt300")
    # A re-run against an existing --root must not inherit per-run outputs: a
    # stale checkpoint would mask a failed training, a stale CSV log would
    # poison the loss floor.
    for stale in (ckpt_dir, os.path.join(root, "ckpt7")):
        shutil.rmtree(stale, ignore_errors=True)
    for stale in (h5_path, os.path.join(root, "ssd300_log.csv"),
                  os.path.join(root, "ssd7_log.csv")):
        if os.path.exists(stale):
            os.remove(stale)

    # 1. SSD300 training. From random init the canonical lr 1e-3 diverges
    # (the reference starts from pretrained VGG): quick scale trains at lr
    # 1e-4 with clipping on the host chain, full scale warms up to 1e-3 on
    # the device pipeline.
    train_cmd = [
        "-m", f"{PACKAGE}.ssd300_training",
        "--voc_root", voc_root, "--epochs", str(epochs),
        "--steps_per_epoch", str(steps), "--batch_size", str(batch),
        "--clipnorm", "5", "--checkpoint_dir", ckpt_dir,
        "--csv_log", os.path.join(root, "ssd300_log.csv"), *dev,
    ]
    if quick:
        train_cmd += ["--base_lr", "1e-4"]
    else:
        train_cmd += ["--base_lr", "1e-3", "--warmup", "1000", "--device_pipeline"]
    run("ssd300_training", train_cmd, results, timeout=5400,
        check=None if quick else check_training_loss_decreased(
            os.path.join(root, "ssd300_log.csv")))
    # Each workflow below loads the newest checkpoint of the directory.
    checkpoint = ckpt_dir

    # 2. The checkpoint as a Keras-layout .h5.
    run_h5("h5_export", ["-m", f"{PACKAGE}.export_h5", "--model", "ssd300",
                         "--checkpoint", checkpoint, "--out", h5_path], results)

    # 3. VOC evaluation (mAP and the VOC results txt files).
    run("ssd300_evaluation", [
        "-m", f"{PACKAGE}.ssd300_evaluation", "--voc_root", voc_root,
        "--checkpoint", checkpoint, "--mode", "training" if quick else "inference",
        "--batch_size", str(batch), "--write_results", os.path.join(root, "voc_results_"), *dev,
    ], results, check=None if quick else check_eval_map(0.2))

    # 4. COCO evaluation (the results JSON through the category-map bridge).
    run("ssd300_evaluation_coco", [
        "-m", f"{PACKAGE}.ssd300_evaluation_coco",
        "--images_dir", os.path.join(paths["coco"], "images"),
        "--annotations", os.path.join(paths["coco"], "annotations.json"),
        "--checkpoint", checkpoint, "--n_classes", "20", "--batch_size", str(batch),
        "--out_file", os.path.join(root, "coco_results.json"), *dev,
    ], results, check=None if quick else check_coco_ap(0.08))

    # 5. Weight sampling: 21 -> 4 class heads, then a load check.
    sampled = os.path.join(root, "ssd300_3classes.h5")
    if run_h5("weight_sampling", [
        "-m", f"{PACKAGE}.weight_sampling", "--source", h5_path, "--dest", sampled,
        "--classes_of_interest", "0", "7", "15", "2", "--n_classes_source", "21",
    ], results):
        run_h5("sampled_weights_load", [
            "-c", "import sys; from ssd_keras_torch import ssd_300, load_keras_h5_weights; "
                  "m, _ = ssd_300(n_classes=3, device='cpu'); "
                  "n = len(load_keras_h5_weights(sys.argv[1], m, on_unconsumed='raise')); "
                  "print(f'sampled weights load into n_classes=3 SSD300: {n} layers')",
            sampled,
        ], results)
    elif not have_h5py():
        _record(results, "sampled_weights_load", False, 0.0, "h5py does not import here",
                status=NOT_RUN_H5)

    # 6. Inference.
    sample_imgs = sorted(os.path.join(paths["img_dir07"], f)
                         for f in os.listdir(paths["img_dir07"]))[:2]
    run("ssd300_inference", [
        "-m", f"{PACKAGE}.ssd300_inference", *sample_imgs,
        "--checkpoint", checkpoint, "--confidence", "0.25", *dev,
    ], results, check=None if quick else check_inference_boxes())
    if not quick:
        cmd512 = ["-m", f"{PACKAGE}.ssd512_inference", "--n_classes", "20", *dev]
        if args.ssd512_checkpoint:
            # A model trained on 512x512 renders sees its own resolution.
            from PIL import Image

            from ssd_keras_torch.data.synthvoc import SynthVOC

            ds512 = SynthVOC(2, 512, split="val", seed=0)
            imgs512 = []
            for i in range(2):
                img, _ = ds512.render(i)
                path = os.path.join(root, f"ssd512_val_{i}.jpg")
                Image.fromarray(img).save(path, quality=95)
                imgs512.append(path)
            run("ssd512_inference", [*cmd512, *imgs512, "--checkpoint", args.ssd512_checkpoint,
                                     "--confidence", "0.25"],
                results, check=check_inference_boxes(frame_w=512, frame_h=512))
        else:
            run("ssd512_inference (random-init smoke)",
                [*cmd512, sample_imgs[0], "--confidence", "0.99"], results)

    # 7. SSD7 training on the host chain. At full scale its steps are what
    # the host chain sustains; the floor checks that the loss moved.
    steps7 = steps if quick else 250
    run("ssd7_training", [
        "-m", f"{PACKAGE}.ssd7_training",
        "--images_dir", paths["img_dir07"], "--train_labels", paths["csv"],
        "--img_height", "300", "--img_width", "300", "--n_classes", "20",
        "--epochs", str(epochs), "--steps_per_epoch", str(steps7),
        "--batch_size", str(min(batch, 8)),
        "--checkpoint_dir", os.path.join(root, "ckpt7"),
        "--csv_log", os.path.join(root, "ssd7_log.csv"), *dev,
    ], results, check=None if quick else check_training_loss_decreased(
        os.path.join(root, "ssd7_log.csv")))

    write_report(out, args, results, (n_train, n_train12, n_val), (steps, epochs, batch))
    return results


def write_report(out, args, results, sizes, schedule):
    (n_train, n_train12, n_val), (steps, epochs, batch) = sizes, schedule
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_not_run = sum(r["status"] == NOT_RUN_H5 for r in results)
    with open(out, "w") as f:
        f.write("# Workflow execution record (SynthVOC, ssd_keras_torch)\n\n")
        f.write(f"- scale: `{args.scale}` (train {n_train}+{n_train12} / "
                f"val {n_val} images, {epochs}x{steps} steps batch {batch}), "
                f"device `{args.device}`\n")
        f.write(f"- command: `python -m {PACKAGE}.run_workflows_synthvoc "
                f"--scale {args.scale}`\n")
        f.write(f"- result: **{n_ok}/{len(results)} workflows passed, "
                f"{n_not_run} not run**\n\n")
        f.write("| workflow | status | seconds | NMS kernel launches |\n|---|---|---|---|\n")
        for r in results:
            launches = "" if r["nms_launches"] is None else r["nms_launches"]
            f.write(f"| {r['workflow']} | {r['status']} | {r['seconds']} | {launches} |\n")
        f.write("\n## Output tails\n")
        for r in results:
            f.write(f"\n### {r['workflow']}\n\n```\n{r['tail']}\n```\n")
    print(f"\n{n_ok}/{len(results)} workflows passed, {n_not_run} not run -> {out}", flush=True)


def main(argv=None) -> int:
    return 1 if failed(run_workflows(parse_args(argv))) else 0


if __name__ == "__main__":
    sys.exit(main())
