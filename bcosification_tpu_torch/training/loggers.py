"""What ``Trainer.fit`` records: the metrics history (``metrics.csv`` and
``metrics/metrics.json.gz``), the run's configuration (``hparams.json``)
and the optional event-stream back ends.

The port's own copy of the record keeping of ``bcosification_tpu``'s
``Trainer._log_metrics`` and of its ``training/loggers.py``:

- ``TensorBoardLogger`` writes standard ``events.out.tfevents.*`` files with
  its own protobuf and TFRecord encoder (scalars and PNG image summaries,
  records framed with masked CRC32C), so no tensorboard package is needed;
  ``read_events`` reads such a file back and checks every CRC.
- ``WandbLogger`` is import-guarded: without ``wandb`` it is a no-op that
  says so. A stable ``run_id`` lets a resumed job continue its run.
- ``setup_loggers(args, save_dir)`` builds the ones the train command's
  flags ask for (``tensorboard_logger`` under ``<save_dir>/tb``,
  ``wandb_logger``).

Under a process group (``parallel/dp.py``) only rank 0 writes: the
``MetricsLogger`` of another rank keeps its history in memory and writes
no file, and the Trainer builds no event logger there.
"""
from __future__ import annotations

import gzip
import io
import json
import os
import socket
import struct
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from bcosification_tpu_torch.parallel import dp

__all__ = ["MetricsLogger", "TensorBoardLogger", "WandbLogger", "read_events",
           "setup_loggers"]


# CRC32C (Castagnoli, reflected polynomial 0x82F63B78): the TFRecord framing
def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# the protobuf wire encoding of the few messages an event file holds
def _varint(value: int) -> bytes:
    if value < 0:  # Python's >> never reaches 0 for a negative value
        raise ValueError(f"varint requires a non-negative value, got {value}")
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1; simple_value = 2 }
    return _field_bytes(1, tag.encode()) + _field_float(2, value)


def _summary_value_image(tag: str, png: bytes, h: int, w: int, channels: int) -> bytes:
    # Summary.Image { height = 1; width = 2; colorspace = 3; encoded_image_string = 4 }
    img = _field_varint(1, h) + _field_varint(2, w) + _field_varint(3, channels) + _field_bytes(
        4, png)
    # Summary.Value { tag = 1; image = 4 }
    return _field_bytes(1, tag.encode()) + _field_bytes(4, img)


def _event(step: Optional[int] = None, summary_values: Optional[List[bytes]] = None,
           file_version: Optional[str] = None) -> bytes:
    # Event { wall_time = 1 (double); step = 2; file_version = 3; summary = 5 }
    ev = _field_double(1, time.time())
    if step is not None:
        ev += _field_varint(2, int(step))
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if summary_values:
        ev += _field_bytes(5, b"".join(_field_bytes(1, v) for v in summary_values))
    return ev


def _read_varint(buf: bytes, i: int):
    shift = value = 0
    while True:
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, i


def _fields(buf: bytes) -> List[tuple]:
    """[(field number, wire type, value)] of one protobuf message."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
        elif wire == 5:
            value, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((num, wire, value))
    return out


def read_events(path) -> List[Dict[str, Any]]:
    """The events of a TFRecord event file, each {"wall_time", "step",
    "file_version", "scalars": {tag: value}, "images": {tag: (h, w, c, png)}}.
    Raises ValueError on a record whose length or data CRC does not match."""
    data = Path(path).read_bytes()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        record = data[i + 12:i + 12 + length]
        (dcrc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if hcrc != _masked_crc(header) or dcrc != _masked_crc(record) or len(record) != length:
            raise ValueError(f"{path}: corrupt record at byte {i}")
        i += 16 + length
        ev = {"wall_time": None, "step": None, "file_version": None, "scalars": {},
              "images": {}}
        for num, _, value in _fields(record):
            if num == 1:
                ev["wall_time"] = value
            elif num == 2:
                ev["step"] = value
            elif num == 3:
                ev["file_version"] = value.decode()
            elif num == 5:
                for _, _, sv in _fields(value):
                    f = {n: v for n, _, v in _fields(sv)}
                    tag = f[1].decode()
                    if 2 in f:
                        ev["scalars"][tag] = f[2]
                    else:
                        img = {n: v for n, _, v in _fields(f[4])}
                        ev["images"][tag] = (img[1], img[2], img[3], img[4])
        events.append(ev)
    return events


class TensorBoardLogger:
    """A standard event file under ``logdir`` (scalars and images), written
    by this module's own encoder."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self.path = self.logdir / fname
        self._f = open(self.path, "ab")
        self._write_record(_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        values = [_summary_value_scalar(k, float(v)) for k, v in metrics.items()
                  if np.isfinite(v)]
        if values:
            self._write_record(_event(step=step, summary_values=values))

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """``image``: [H, W, C] uint8 (C in 1, 3, 4) or float in [0, 1]."""
        from PIL import Image

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[-1]]
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        h, w = arr.shape[:2]
        self._write_record(_event(step=step, summary_values=[
            _summary_value_image(tag, buf.getvalue(), h, w, np.asarray(image).shape[-1])]))

    def log_hparams(self, config: Dict) -> None:
        """The configuration as JSON beside the events."""
        from bcosification_tpu_torch.experiments.utils.config_utils import sanitize_config

        (self.logdir / "hparams.json").write_text(json.dumps(sanitize_config(config),
                                                             default=repr))

    def finalize(self) -> None:
        # flush only: a Trainer keeps its loggers across fits; the file
        # closes with the process
        self._f.flush()


class WandbLogger:
    """Weights & Biases metrics and images; a no-op, said once, without
    ``wandb``. Pass a stable ``run_id`` so a resumed job continues its run."""

    def __init__(self, save_dir, project: Optional[str] = None, run_id: Optional[str] = None,
                 config: Optional[Dict] = None, name: Optional[str] = None):
        self._atexit_registered = False
        try:
            import wandb
        except ImportError:
            print("wandb not installed: WandbLogger is a no-op")
            self._run = None
            return
        from bcosification_tpu_torch.experiments.utils.config_utils import sanitize_config

        self._run = wandb.init(
            project=project or os.getenv("WANDB_PROJECT", "bcosification_tpu"),
            id=run_id, resume="allow" if run_id else None, dir=str(save_dir), name=name,
            config=sanitize_config(config) if config else None)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log(dict(metrics), step=step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        if self._run is not None:
            import wandb

            self._run.log({tag: wandb.Image(np.asarray(image))}, step=step)

    def log_hparams(self, config: Dict) -> None:
        if self._run is not None:
            from bcosification_tpu_torch.experiments.utils.config_utils import sanitize_config

            self._run.config.update(sanitize_config(config), allow_val_change=True)

    def finalize(self) -> None:
        # a finished run drops later logs, and a Trainer keeps its loggers
        # across fits: the run is finished once, at interpreter exit
        if self._run is not None and not self._atexit_registered:
            import atexit

            atexit.register(self._run.finish)
            self._atexit_registered = True


def setup_loggers(args: Dict[str, Any], save_dir) -> List:
    """The event-stream loggers the train command's flags ask for
    (``metrics.csv`` and ``metrics.json.gz`` are always written)."""
    loggers: List = []
    if args.get("tensorboard_logger"):
        loggers.append(TensorBoardLogger(Path(save_dir) / "tb"))
    if args.get("wandb_logger"):
        loggers.append(WandbLogger(save_dir, project=args.get("wandb_project"),
                                   run_id=args.get("wandb_id"), name=args.get("wandb_name")))
    return loggers


class MetricsLogger:
    """Per-epoch metrics under ``save_dir``.

    ``metrics.json.gz`` holds {metric: [[epoch, value], ...]}, every row
    included. ``metrics.csv`` has the header ``epoch,<sorted keys>`` fixed by
    its first row (a later, larger key set rewrites it with the union);
    one-off rows (``csv=False``: the initial validation at epoch -1) stay out
    of it. A resumed run adopts both files before its first write; rows of an
    epoch that is run again are dropped from the history.
    """

    def __init__(self, save_dir, loggers=()):
        self.save_dir = Path(save_dir)
        self.loggers = list(loggers)
        self.history: Dict[str, List[tuple]] = {}
        self._csv_keys: Optional[List[str]] = None
        self._adopted = False

    def log_hparams(self, config: Dict[str, Any]) -> None:
        if dp.is_main_process():
            (self.save_dir / "hparams.json").write_text(
                json.dumps(config, default=repr, indent=1))

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

    def log(self, epoch: int, metrics: Dict[str, float], csv: bool = True,
            logger_step: Optional[int] = None) -> None:
        """Record ``metrics`` of ``epoch``; the event-stream loggers get
        every row at ``logger_step`` (default the epoch; clamped to 0), which
        must share the per-step events' step domain."""
        if not self._adopted and dp.is_main_process():
            self._adopt()
        for k, v in metrics.items():
            hist = self.history.setdefault(k, [])
            while hist and hist[-1][0] >= epoch:
                hist.pop()
            hist.append((epoch, float(v)))
        if not dp.is_main_process():
            return
        mdir = self.save_dir / "metrics"
        mdir.mkdir(exist_ok=True)
        with gzip.open(mdir / "metrics.json.gz", "wt") as f:
            json.dump(self.history, f)
        step = epoch if logger_step is None else logger_step
        for lg in self.loggers:
            lg.log_metrics(metrics, step=max(int(step), 0))
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
