"""What ``Trainer.fit`` records: the metrics history (``metrics.csv`` and
``metrics/metrics.json.gz``) and the run's configuration (``hparams.json``).

The port's own copy of the record keeping of ``bcosification_tpu``'s
``Trainer._log_metrics`` and of the ``hparams.json`` its logger back ends
write. The event-stream back ends (TensorBoard, Weights & Biases) are not
ported yet; ``setup_loggers`` raises when one is asked for.
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["MetricsLogger", "setup_loggers"]


def setup_loggers(args: Dict[str, Any]) -> None:
    for key in ("tensorboard_logger", "wandb_logger"):
        if args.get(key):
            raise NotImplementedError(
                f"{key}: the event-stream logger back ends are not ported yet "
                "(port slice 6d); metrics.csv and metrics.json.gz are always written"
            )


class MetricsLogger:
    """Per-epoch metrics under ``save_dir``.

    ``metrics.json.gz`` holds {metric: [[epoch, value], ...]}, every row
    included. ``metrics.csv`` has the header ``epoch,<sorted keys>`` fixed by
    its first row (a later, larger key set rewrites it with the union);
    one-off rows (``csv=False``: the initial validation at epoch -1) stay out
    of it. A resumed run adopts both files before its first write; rows of an
    epoch that is run again are dropped from the history.
    """

    def __init__(self, save_dir):
        self.save_dir = Path(save_dir)
        self.history: Dict[str, List[tuple]] = {}
        self._csv_keys: Optional[List[str]] = None
        self._adopted = False

    def log_hparams(self, config: Dict[str, Any]) -> None:
        (self.save_dir / "hparams.json").write_text(json.dumps(config, default=repr, indent=1))

    def _adopt(self):
        self._adopted = True
        prev = self.save_dir / "metrics" / "metrics.json.gz"
        if not self.history and prev.exists():
            with gzip.open(prev, "rt") as f:
                self.history = {k: [(int(e), float(v)) for e, v in rows]
                                for k, rows in json.load(f).items()}
        csv_path = self.save_dir / "metrics.csv"
        if self._csv_keys is None and csv_path.exists():
            with open(csv_path) as f:
                self._csv_keys = f.readline().strip().split(",")[1:]

    def log(self, epoch: int, metrics: Dict[str, float], csv: bool = True) -> None:
        if not self._adopted:
            self._adopt()
        for k, v in metrics.items():
            hist = self.history.setdefault(k, [])
            while hist and hist[-1][0] >= epoch:
                hist.pop()
            hist.append((epoch, float(v)))
        mdir = self.save_dir / "metrics"
        mdir.mkdir(exist_ok=True)
        with gzip.open(mdir / "metrics.json.gz", "wt") as f:
            json.dump(self.history, f)
        if csv:
            self._write_csv(epoch, metrics)

    def _write_csv(self, epoch, metrics):
        csv_path = self.save_dir / "metrics.csv"
        keys = sorted(metrics)
        if self._csv_keys is None:
            self._csv_keys = keys
            csv_path.write_text("epoch," + ",".join(keys) + "\n")
        elif any(k not in self._csv_keys for k in keys):
            old_keys = self._csv_keys
            old_rows = [line.split(",") for line in csv_path.read_text().splitlines()[1:]]
            self._csv_keys = sorted(set(old_keys) | set(keys))
            lines = ["epoch," + ",".join(self._csv_keys)]
            for row in old_rows:
                d = dict(zip(old_keys, row[1:]))
                lines.append(row[0] + "," + ",".join(d.get(k, "") for k in self._csv_keys))
            csv_path.write_text("\n".join(lines) + "\n")
        with open(csv_path, "a") as f:
            f.write(f"{epoch}," + ",".join(f"{metrics[k]:.6f}" if k in metrics else ""
                                           for k in self._csv_keys) + "\n")
