"""The port's event loggers, explanation logging, profiling and parameter
hash against the JAX package on the CPU: the TensorBoard event file byte
for byte (the wall time and file name fixed), its CRCs read back, the
explanation npz of the JAX ``Trainer._log_explanations`` on the same
weights and images, the ``torch.profiler`` trace file, and the
``--debug`` hash equal to the JAX one and stable on a frozen model."""
import json
import socket
import time
import types

import numpy as np
import pytest
import torch

import jax

from torch_port_helpers import small_pair

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _write(module, logdir):
    lg = module.TensorBoardLogger(logdir)
    lg.log_metrics({"train_loss_step": 0.25, "lr": 1e-3, "skipped": float("nan")}, step=3)
    lg.log_metrics({"val_acc1": 0.5}, step=2 ** 40)
    grid = np.random.default_rng(0).random((6, 10, 4)).astype(np.float32)
    lg.log_image("explanations", grid, step=1)
    lg.log_image("gray", (grid[..., :1] * 255).astype(np.uint8), step=2)
    lg.log_hparams({"lr": 1e-3, "name": "resnet_50", "nested": {"b": 2}})
    lg.finalize()
    (path,) = list(logdir.glob("events.out.tfevents.*"))
    return path


def test_tensorboard_events_match_jax(tmp_path, monkeypatch):
    """Scalars (a non-finite one left out), a large step, an RGBA and a
    grey image and the hparams: the same bytes and the same file name as
    the JAX writer's at one wall time; ``read_events`` reads them back and
    rejects a flipped byte."""
    from bcosification_tpu.training import loggers as jloggers
    from bcosification_tpu_torch.training import loggers as tloggers

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    want = _write(jloggers, tmp_path / "jax")
    got = _write(tloggers, tmp_path / "port")
    assert got.name == want.name == (f"events.out.tfevents.1700000000."
                                     f"{socket.gethostname()}.{__import__('os').getpid()}")
    assert got.read_bytes() == want.read_bytes()
    assert (json.loads((tmp_path / "port" / "hparams.json").read_text())
            == json.loads((tmp_path / "jax" / "hparams.json").read_text()))
    events = tloggers.read_events(got)
    assert [e["step"] for e in events] == [None, 3, 2 ** 40, 1, 2]
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["scalars"] == {"train_loss_step": 0.25, "lr": np.float32(1e-3)}
    assert events[3]["images"]["explanations"][:3] == (6, 10, 4)
    assert events[4]["images"]["gray"][:3] == (6, 10, 1)
    assert all(e["wall_time"] == 1_700_000_000.25 for e in events)
    data = bytearray(got.read_bytes())
    data[40] ^= 0xFF
    got.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt record"):
        tloggers.read_events(got)


def test_setup_loggers(tmp_path, capsys):
    """The flags pick the back ends; W&B without ``wandb`` is a no-op that
    says so."""
    from bcosification_tpu_torch.training.loggers import (TensorBoardLogger, WandbLogger,
                                                          setup_loggers)

    assert setup_loggers({}, tmp_path) == []
    tb, wb = setup_loggers({"tensorboard_logger": True, "wandb_logger": True}, tmp_path)
    assert isinstance(tb, TensorBoardLogger) and tb.logdir == tmp_path / "tb"
    assert isinstance(wb, WandbLogger)
    if wb._run is None:
        assert "no-op" in capsys.readouterr().out
        wb.log_metrics({"a": 1.0}, step=0)
        wb.finalize()


class _Val:
    """A data module whose validation loader yields one batch."""

    def __init__(self, x, label):
        self.batch = {"image": x, "label": label}

    def val_dataloader(self):
        return iter([self.batch])


def test_explanation_logging_matches_jax(tmp_path):
    """The JAX ``Trainer._log_explanations`` and the port's on the small
    flagship's weights and the same 8 validation images (of 10): the
    predictions equal, the contribution maps and the RGBA explanations
    within 1e-5 relative (the explanation API's parity), the PNG grids of
    the same size and within one 8-bit level on 99.9 % of the values."""
    from PIL import Image

    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.optim import OptimizerFactory
    from bcosification_tpu_torch.training import steps as tsteps
    from bcosification_tpu_torch.training.trainer import Trainer

    net, variables, tnet, _ = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    rng = np.random.default_rng(5)
    x = rng.random((10, 32, 32, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    dm = _Val(x, np.zeros(10, np.int32))

    fake = types.SimpleNamespace(_host_state=jax.device_get, _io_process=True, loggers=[],
                                 save_dir=tmp_path / "jax")
    fake.save_dir.mkdir()
    JaxTrainer._log_explanations(fake, net, types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]), dm, 0)

    exp = types.SimpleNamespace(config={"optimizer": OptimizerFactory("Adam", 1e-3)},
                                save_dir=tmp_path / "port")
    trainer = Trainer(exp, device="cpu")
    state = tsteps.create_train_state(tnet, exp.config["optimizer"].create)
    trainer._log_explanations(state, dm, 0)

    with np.load(tmp_path / "jax" / "explanations" / "epoch_0.npz") as w, \
            np.load(tmp_path / "port" / "explanations" / "epoch_0.npz") as g:
        assert sorted(g.files) == sorted(w.files)
        np.testing.assert_array_equal(g["prediction"], w["prediction"])
        assert g["explanation"].shape == w["explanation"].shape == (8, 32, 32, 4)
        assert _rel(g["contribution_map"], w["contribution_map"]) <= 1e-5
        assert _rel(g["explanation"], w["explanation"]) <= 1e-5
    pngs = [np.asarray(Image.open(tmp_path / d / "explanations" / "epoch_0.png"))
            for d in ("jax", "port")]
    assert pngs[0].shape == pngs[1].shape == (64, 128, 4)
    off = np.abs(pngs[0].astype(int) - pngs[1].astype(int))
    assert off.max() <= 1 and (off > 0).mean() <= 1e-3


def test_profile_trace_is_written(tmp_path):
    """``utils.profiling.trace`` on the CPU writes a Chrome trace whose
    events name the ops run inside it; ``StepTimer`` leaves out its
    warm-up."""
    from bcosification_tpu_torch.utils.profiling import StepTimer, trace

    with trace(tmp_path / "prof", device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    timer = StepTimer(warmup_steps=2)
    for _ in range(4):
        timer.step(8)
    assert timer.summary()["steps"] == 4 and timer.throughput() > 0


def test_param_hash_matches_jax_and_holds_on_a_frozen_model():
    """``param_hash`` of the port's flagship equals the JAX Trainer's
    ``param_hash`` of the same variables; a train step changes the
    student's and leaves a frozen copy's."""
    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu_torch.optim import OptimizerFactory
    from bcosification_tpu_torch.training import steps as tsteps
    from bcosification_tpu_torch.training.trainer import param_hash

    _, variables, tnet, x = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    assert param_hash(tnet) == JaxTrainer.param_hash(variables["params"])
    teacher = tsteps.create_train_state(tnet, OptimizerFactory("sgd", 1e-3).create).model
    teacher.requires_grad_(False)
    frozen = param_hash(teacher)
    state = tsteps.create_train_state(tnet, OptimizerFactory("adam", 1e-3).create)
    step = tsteps.make_train_step(UniformOffLabelsBCEWithLogitsLoss())
    before = param_hash(state.model)
    step(state, {"image": torch.from_numpy(x), "label": torch.tensor([1, 2])})
    assert param_hash(state.model) != before == frozen == param_hash(teacher)
