#!/usr/bin/env python
"""Generate a Colour-MNIST dataset tree (images.npy + parents.npy per split)
from MNIST IDX files: the port's twin of ``tools/make_cmnist.py``, reading
IDX through ``causal_gen_tpu_torch/data/idx.py``. Each digit is tinted with
one of 10 colours, drawn uniformly and independently of the digit (the two
root nodes of ColourMNISTPGM). The palette and the draws are the JAX tool's,
so a seed gives the same tree, byte for byte.

Usage:
  python tools/make_cmnist_torch.py --mnist_dir DIR --out_dir OUT [--seed 0]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# 10 distinct RGB tints
PALETTE = np.array([
    [255, 60, 60], [60, 255, 60], [80, 80, 255], [255, 255, 70],
    [255, 70, 255], [70, 255, 255], [255, 150, 60], [150, 60, 255],
    [60, 150, 120], [200, 200, 200],
], np.float32) / 255.0


def colorize(images: np.ndarray, colours: np.ndarray) -> np.ndarray:
    """(N, 28, 28) uint8 grey + (N,) colour ids -> (N, 28, 28, 3) uint8."""
    tint = PALETTE[colours][:, None, None, :]  # (N,1,1,3)
    out = images[..., None].astype(np.float32) * tint
    return np.clip(out, 0, 255).astype(np.uint8)


def main(argv=None) -> None:
    from causal_gen_tpu_torch.data.idx import load_idx

    p = argparse.ArgumentParser()
    p.add_argument("--mnist_dir", required=True,
                   help="holds t10k-images-idx3-ubyte.gz and t10k-labels-idx1-ubyte.gz")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    for split, prefix in [("train", "t10k"), ("test", "t10k")]:
        # both splits from t10k, as the JAX tool does
        images = load_idx(os.path.join(args.mnist_dir, f"{prefix}-images-idx3-ubyte.gz"))
        labels = load_idx(os.path.join(args.mnist_dir, f"{prefix}-labels-idx1-ubyte.gz"))
        colours = rng.integers(0, 10, len(images))
        out = os.path.join(args.out_dir, split)
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "images.npy"), colorize(images, colours))
        np.save(
            os.path.join(out, "parents.npy"),
            np.array({"digit": labels.astype(np.int64), "colour": colours}, dtype=object),
        )
        print(f"{split}: {len(images)} images -> {out}")


if __name__ == "__main__":
    main()
