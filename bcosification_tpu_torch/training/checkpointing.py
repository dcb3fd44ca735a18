"""Checkpoints of the training state, with the JAX package's layout and
selection rules (counterpart of ``bcosification_tpu/training/checkpointing.py``).

Layout: ``<save_dir>/checkpoints/epoch_<N>/state.pt`` (``torch.save`` of
``TrainState.state_dict()``) and ``checkpoints/index.json`` with each
epoch's metrics. Pruning keeps the last checkpoint plus the top-k by the
monitored metric and the top-k by its EMA twin. The index is written
atomically, and pruned before any directory is removed: a crash between the
two leaves a stray directory, never an index entry without its files.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager", "is_clip_kd", "monitor_for"]

_FILE = "state.pt"


def is_clip_kd(config: Dict[str, Any]) -> bool:
    """A CLIP knowledge-distillation config (``model.bcosify_args.clip_kd``)."""
    bargs = (config.get("model", {}) or {}).get("bcosify_args", {}) or {}
    return bool(bargs.get("clip_kd", False))


def monitor_for(config: Dict[str, Any]) -> Tuple[str, str]:
    """(metric, mode) that ranks the checkpoints of ``config``: the
    validation loss (min) for CLIP KD, the top-1 accuracy (max) otherwise."""
    return ("val_loss", "min") if is_clip_kd(config) else ("val_acc1", "max")


class CheckpointManager:
    def __init__(self, save_dir: str, monitor: str = "val_acc1", mode: str = "max",
                 top_k: int = 3):
        self.save_dir = Path(save_dir)
        self.ckpt_dir = self.save_dir / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.monitor, self.mode, self.top_k = monitor, mode, top_k
        self._index_path = self.ckpt_dir / "index.json"

    # -- index ---------------------------------------------------------------
    def _load_index(self) -> Dict[str, Any]:
        if self._index_path.exists():
            with open(self._index_path) as f:
                return json.load(f)
        return {"epochs": {}}

    def _save_index(self, index):
        tmp = self._index_path.with_name(f"{self._index_path.name}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, self._index_path)

    # -- save ----------------------------------------------------------------
    def save(self, state: Dict[str, Any], epoch: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Write ``state`` (a state dict) as epoch ``epoch``, record its
        metrics, and prune."""
        path = self.ckpt_dir / f"epoch_{epoch}"
        path.mkdir(exist_ok=True)
        tmp = path / f"{_FILE}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path / _FILE)
        index = self._load_index()
        index["epochs"][str(epoch)] = {
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        index["last"] = epoch
        self._prune(index)

    def _score(self, entry, monitor):
        v = entry["metrics"].get(monitor)
        if v is None:
            return None
        return v if self.mode == "max" else -v

    def _prune(self, index):
        epochs = index["epochs"]
        keep = {index.get("last")}
        for mon in (self.monitor, f"{self.monitor}_ema"):
            scored = sorted(((s, int(ep)) for ep, e in epochs.items()
                             if (s := self._score(e, mon)) is not None), reverse=True)
            keep.update(ep for _, ep in scored[: self.top_k])
        doomed = [ep for ep in list(epochs) if int(ep) not in keep]
        for ep in doomed:
            del epochs[ep]
        self._save_index(index)  # before the rmtree (see the module docstring)
        for ep in doomed:
            p = self.ckpt_dir / f"epoch_{ep}"
            if p.exists():
                shutil.rmtree(p)

    # -- load ----------------------------------------------------------------
    def available_checkpoints(self) -> List[int]:
        return sorted(int(e) for e in self._load_index()["epochs"])

    def resolve(self, reload: str = "last") -> Optional[int]:
        """last | best | best_any | epoch_N -> epoch number (None if nothing)."""
        index = self._load_index()
        epochs = index["epochs"]
        if not epochs:
            return None
        if reload == "last":
            return index.get("last", max(int(e) for e in epochs))
        if reload.startswith("epoch_"):
            n = int(reload.split("_", 1)[1])
            return n if str(n) in epochs else None
        if reload in ("best", "best_any"):
            monitors = [self.monitor] + ([f"{self.monitor}_ema"] if reload == "best_any" else [])
            best = None
            for mon in monitors:
                for ep, e in epochs.items():
                    s = self._score(e, mon)
                    if s is not None and (best is None or s > best[0]):
                        best = (s, int(ep))
            return best[1] if best else index.get("last")
        raise ValueError(f"unknown reload spec {reload!r}")

    def restore(self, reload: str = "last",
                map_location=None) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
        """(state dict, epoch), or (None, None) if no checkpoint exists."""
        epoch = self.resolve(reload)
        if epoch is None:
            return None, None
        state = torch.load(self.ckpt_dir / f"epoch_{epoch}" / _FILE,
                           map_location=map_location, weights_only=True)
        return state, epoch
