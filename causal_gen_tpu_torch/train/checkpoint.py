"""Checkpoints of the port's trainer, in PyTorch's format.

Counterpart of ``causal_gen_tpu/train/checkpoint.py`` (reference
trainer.py:156-168). Each save is ``<dir>/step_<n>.pt`` (``torch.save`` of the
parameters, the EMA parameters, AdamW's and the schedule's state and the three
counters) beside ``step_<n>.pt.meta.json`` (the config and extras, as JSON;
the stored config is authoritative on reload). The writer keeps the newest
``max_to_keep`` saves plus the best one (lowest metric, which
``update_metric`` may set after the save), and points the
``<dir>/checkpoint`` links at the best. It writes synchronously: a save at
the end of an evaluation costs little next to the epoch. It does not read
Orbax checkpoints of the JAX package.

A tensor-parallel model (``parallel/tensor.py``) saves whole tensors:
``state_payload`` gathers its shards and their AdamW moments (every rank
calls it; one writes), and ``restore_train_state`` cuts a whole payload to
the shards of the model it is given. So a checkpoint of a sharded run loads
into one process, and one process's into a sharded run.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from causal_gen_tpu_torch.config import Config
from causal_gen_tpu_torch.parallel.tensor import (
    gather_optimizer_state,
    gather_state,
    shard_optimizer_state,
    shard_state,
)
from causal_gen_tpu_torch.train.state import TrainState, init_train_state


def state_payload(state: TrainState) -> Dict[str, Any]:
    """TrainState -> checkpoint payload of tensors and ints (on the CPU),
    every tensor whole."""
    return {
        "params": gather_state(state.model),
        "ema_params": gather_state(state.ema),
        "opt_state": gather_optimizer_state(state.optimizer, state.model),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "ema_updates": state.ema_updates,
        "skipped": state.skipped,
    }


def write_payload(path: str, payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


class CheckpointWriter:
    """Rotating checkpoint writer with best-metric retention and a
    ``checkpoint`` link to the best save (lower metric is better)."""

    def __init__(self, directory: str, max_to_keep: int = 3, link_name: str = "checkpoint"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.link_name = link_name
        self._entries: List[Dict[str, Any]] = []  # {"path", "step", "metric"} in save order

    def _best(self) -> Optional[Dict[str, Any]]:
        scored = [e for e in self._entries if e["metric"] is not None]
        if scored:
            return min(scored, key=lambda e: e["metric"])
        return self._entries[-1] if self._entries else None

    def _gc(self) -> None:
        """Delete the oldest saves beyond max_to_keep; the best one stays."""
        best = self._best()
        keep = {best["path"]} if best is not None else set()
        for e in reversed(self._entries):
            if len(keep) >= self.max_to_keep:
                break
            keep.add(e["path"])
        for e in list(self._entries):
            if e["path"] not in keep:
                for p in (e["path"], e["path"] + ".meta.json"):
                    if os.path.exists(p):
                        os.remove(p)
                self._entries.remove(e)

    def _update_link(self) -> None:
        best = self._best()
        if best is None:
            return
        link = os.path.join(self.directory, self.link_name)
        target = os.path.basename(best["path"])  # relative: the directory may move
        for suffix in ("", ".meta.json"):
            tmp = link + suffix + ".tmp"
            if os.path.lexists(tmp):
                os.remove(tmp)
            os.symlink(target + suffix, tmp)
            os.replace(tmp, link + suffix)

    def save(self, payload: Dict[str, Any], meta: Dict[str, Any], step: int,
             metric: Optional[float] = None) -> str:
        path = os.path.join(self.directory, f"step_{int(step):010d}.pt")
        write_payload(path, payload, meta)
        self._entries = [e for e in self._entries if e["path"] != path]
        self._entries.append({"path": path, "step": int(step),
                              "metric": None if metric is None else float(metric)})
        self._gc()
        self._update_link()
        self._write_index()
        return path

    def update_metric(self, metric: float, path: Optional[str] = None) -> None:
        """Set the metric of a save made before its metric existed (the
        newest, or the one at ``path``) and point the links at the best
        again: the CF trainer saves before its long valid sweeps, then
        feeds back the sweep's loss, so that the best save is kept by it
        (causal_gen_tpu/train/checkpoint.py:127)."""
        target = self._entries[-1] if path is None else next(
            (e for e in self._entries if e["path"] == path), None)
        if target is None:
            return
        target["metric"] = float(metric)
        self._write_index()
        self._update_link()

    def _write_index(self) -> None:
        with open(os.path.join(self.directory, "index.json"), "w") as f:
            json.dump({"entries": self._entries}, f, indent=2)


def load_checkpoint(path: str) -> Tuple[Config, Dict[str, Any], Dict[str, Any]]:
    """(config stored with the checkpoint, payload on the CPU, extras)."""
    path = os.path.abspath(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return Config.from_dict(meta["config"]), payload, meta.get("extra", {})


def restore_train_state(cfg: Config, model: torch.nn.Module, payload: Dict[str, Any]
                        ) -> TrainState:
    """A TrainState around ``model`` (on its device) with the payload's
    parameters, EMA, optimizer and schedule state and counters (cut to
    ``model``'s shards where it is tensor-parallel)."""
    model.load_state_dict(shard_state(model, payload["params"]))
    state = init_train_state(cfg, model)
    state.ema.load_state_dict(shard_state(state.ema, payload["ema_params"]))
    state.optimizer.load_state_dict(
        shard_optimizer_state(state.optimizer, model, payload["opt_state"]))
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    state.ema_updates = int(payload["ema_updates"])
    state.skipped = int(payload["skipped"])
    return state
