"""Port a trained SSD's classifier heads to another class count.

Port of the JAX package's ``examples/weight_sampling.py``
(weight_sampling_tutorial.ipynb): copy a source ``.h5`` weight file and
sub-sample (or up-sample) the per-box class channels of every confidence
head, so that a model with fewer or more classes loads it; each box block
keeps its background channel. Needs h5py.

Usage (21 VOC classes -> background + car/person/bicycle):
  python -m ssd_keras_torch.examples.weight_sampling \
      --source VGG_VOC0712_SSD_300x300_iter_120000.h5 \
      --dest   ssd300_3classes.h5 \
      --classes_of_interest 0 7 15 2 \
      --n_classes_source 21
"""

from __future__ import annotations

import argparse
import shutil

import numpy as np

from ssd_keras_torch.weights_io import sample_classifier_weights

# Boxes per cell of the 6 SSD300 conf heads: aspect ratios [1, 2, 1/2] (and
# the second ar=1 box) on conv4_3/conv8_2/conv9_2, [1, 2, 1/2, 3, 1/3] on
# fc7/conv6_2/conv7_2 (keras_ssd300.py:39-44 defaults).
SSD300_CONF_HEADS = {
    "conv4_3_norm_mbox_conf": 4,
    "fc7_mbox_conf": 6,
    "conv6_2_mbox_conf": 6,
    "conv7_2_mbox_conf": 6,
    "conv8_2_mbox_conf": 4,
    "conv9_2_mbox_conf": 4,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="sub-sample a .h5's class heads")
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--n_classes_source", type=int, default=21,
                   help="class count (incl. background) in the source heads")
    p.add_argument("--classes_of_interest", type=int, nargs="+", required=True,
                   help="class ids to keep (include 0 for background)")
    p.add_argument("--heads", nargs="+", default=None,
                   help="conf head layer names (default: the 6 SSD300 heads)")
    args = p.parse_args(argv)

    import h5py

    heads = args.heads or list(SSD300_CONF_HEADS)
    shutil.copy(args.source, args.dest)

    with h5py.File(args.dest, "r+") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in heads:
            n_boxes = SSD300_CONF_HEADS.get(name)
            group = root[name][name] if name in root[name] else root[name]
            kernel_key = [k for k in group if k.startswith("kernel")][0]
            bias_key = [k for k in group if k.startswith("bias")][0]
            kernel = np.array(group[kernel_key])
            bias = np.array(group[bias_key])
            if n_boxes is None:
                n_boxes = kernel.shape[-1] // args.n_classes_source
            new_kernel, new_bias = sample_classifier_weights(
                kernel, bias, args.n_classes_source, args.classes_of_interest, n_boxes)
            del group[kernel_key], group[bias_key]
            group.create_dataset(kernel_key, data=new_kernel)
            group.create_dataset(bias_key, data=new_bias)
            print(f"{name}: {kernel.shape} -> {new_kernel.shape}")

    print(f"wrote {args.dest}; load it into a model built with "
          f"n_classes={len(args.classes_of_interest) - 1}.")


if __name__ == "__main__":
    main()
