#!/usr/bin/env python
"""Export an eval copy of a port checkpoint: the EMA weights and the config
only. The port's twin of ``tools/export_eval_ckpt.py``.

A training checkpoint (``causal_gen_tpu_torch/train/checkpoint.py``) holds
the parameters, the EMA, AdamW's moments and the schedule: about 4x the
model. Everything downstream of training (``cli.evaluate``, the DSCM merge
in ``cli.train_cf`` and the demos) reads only the EMA, so this writes a copy
in the same layout with every other entry an empty dict, and the same
``.meta.json`` with ``extra.eval_grade`` set. Such a copy cannot resume a
run.

Usage:
  python tools/export_eval_ckpt_torch.py SRC_CKPT DST_DIR [--kind vae|cf]
  # -> DST_DIR/checkpoint (+ .meta.json)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# entries kept, and entries emptied, of a VAE payload (train/checkpoint.py::
# state_payload, cli/main.py) and of a CF payload (pgm/train_cf.py::cf_state_payload)
KEEP = {"vae": ("ema_params", "step", "ema_updates", "skipped"),
        "cf": ("ema_vae", "ema_lmbda", "step", "ema_updates", "skipped")}
EMPTY = {"vae": ("params", "opt_state", "scheduler"),
         "cf": ("vae", "lmbda", "opt_state", "lagrange_opt_state")}


def export(src: str, dst_dir: str, kind: str = "vae") -> str:
    """Write ``dst_dir/checkpoint`` (+ ``.meta.json``), the EMA copy of the
    checkpoint at ``src``; returns its path."""
    import torch

    from causal_gen_tpu_torch.train.checkpoint import write_payload

    src = os.path.abspath(src)
    payload = torch.load(src, map_location="cpu", weights_only=True)
    missing = [k for k in KEEP[kind] + EMPTY[kind] if k not in payload]
    if missing:
        raise ValueError(f"{src} is not a {kind} checkpoint: it lacks {missing}")
    slim = {k: (payload[k] if k in KEEP[kind] else {}) for k in KEEP[kind] + EMPTY[kind]}
    with open(src + ".meta.json") as f:
        meta = json.load(f)
    meta.setdefault("extra", {})["eval_grade"] = True
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(os.path.abspath(dst_dir), "checkpoint")
    write_payload(dst, slim, meta)
    return dst


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("src", help="checkpoint path (a step_<n>.pt file or the checkpoint link)")
    p.add_argument("dst", help="output dir; writes dst/checkpoint")
    p.add_argument("--kind", choices=sorted(KEEP), default="vae",
                   help="vae: a cli.main checkpoint; cf: a cli.train_cf checkpoint")
    args = p.parse_args()
    print(json.dumps({"exported": export(args.src, args.dst, args.kind), "kind": args.kind}))


if __name__ == "__main__":
    main()
