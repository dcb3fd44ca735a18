"""The port's Trainer on the CPU: fit, metrics, checkpoints and resume on
a tiny synthetic set (as tests/test_trainer_e2e.py), the same fit against
the JAX Trainer on the same weights, with and without the training
options no grid config sets, the checkpoint selection rules, the event
loggers, and the options that raise until their slice is ported."""
import gzip
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


class SynthDataModule:
    """32 images of 8x8x6 whose channel means encode one of 4 labels."""

    def __init__(self, n=32, batch_size=8):
        rng = np.random.default_rng(0)
        self.batch_size = batch_size
        self.labels = rng.integers(0, 4, n).astype(np.int32)
        self.images = rng.random((n, 8, 8, 6)).astype(np.float32) * 0.1
        for i, label in enumerate(self.labels):
            self.images[i, ..., label % 4] += 0.8

    def setup(self, stage=None):
        pass

    def _batches(self):
        for s in range(0, len(self.labels), self.batch_size):
            yield {"image": self.images[s:s + self.batch_size],
                   "label": self.labels[s:s + self.batch_size]}

    def train_dataloader(self, seed=0):
        dm = self

        class Loader:
            def __iter__(self):
                return dm._batches()

            def __len__(self):
                return len(dm.labels) // dm.batch_size

            def set_epoch(self, epoch):
                pass

        return Loader()

    def val_dataloader(self):
        return self._batches()


class TinyNet(nn.Module):
    """The port's twin of tests/test_trainer_e2e.py::TinyNet: a 3x3 B-cos
    conv, a bias-free uncentered BN, a 1x1 B-cos conv (K3's path) and the
    spatial mean."""

    def __init__(self):
        super().__init__()
        from bcosification_tpu_torch.modules import (BatchNormUncentered2d, BcosConv2d,
                                                     NoBias)

        self.conv_a = BcosConv2d(6, 8, 3, padding=1)
        self.bn = NoBias(BatchNormUncentered2d)(8)
        self.conv_b = BcosConv2d(8, 4, 1)

    def forward(self, x, *, train=False, explain=False):
        f = dict(train=train, explain=explain)
        return self.conv_b(self.bn(self.conv_a(x, **f), **f), **f).mean(dim=(1, 2))


def _jax_tiny():
    """The JAX TinyNet, its variables, and the port's TinyNet with the same
    weights."""
    from test_trainer_e2e import TinyNet as JaxTinyNet

    model = JaxTinyNet()
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(SynthDataModule().images[:1]), train=True))
    p = variables["params"]
    tiny = TinyNet()
    with torch.no_grad():
        for mod, leaf in ((tiny.conv_a, "BcosConv2d_0"), (tiny.conv_b, "BcosConv2d_1")):
            mod.weight.copy_(torch.from_numpy(p[leaf]["weight"].transpose(3, 2, 0, 1).copy()))
        tiny.bn.weight.copy_(torch.from_numpy(p["BatchNormUncentered2d_0"]["weight"].copy()))
    return model, variables, tiny


def _experiment(tmp_path, port=True, ema=False):
    if port:
        from bcosification_tpu_torch.losses import (BinaryCrossEntropyLoss,
                                                    UniformOffLabelsBCEWithLogitsLoss)
        from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    else:
        from bcosification_tpu.losses import (BinaryCrossEntropyLoss,
                                              UniformOffLabelsBCEWithLogitsLoss)
        from bcosification_tpu.optim import LRSchedulerFactory, OptimizerFactory
    exp = types.SimpleNamespace()
    exp.config = dict(
        criterion=UniformOffLabelsBCEWithLogitsLoss(),
        test_criterion=BinaryCrossEntropyLoss(),
        optimizer=OptimizerFactory(name="Adam", lr=5e-3),
        lr_scheduler=LRSchedulerFactory(name="cosineannealinglr", epochs=3),
        trainer=dict(max_epochs=2),
        use_agc=True,
        model=dict(),
    )
    if ema:
        exp.config["ema"] = {"decay": 0.99, "steps": 2}
    exp.save_dir = Path(tmp_path) / "exp"
    return exp


def _history(exp):
    with gzip.open(exp.save_dir / "metrics" / "metrics.json.gz", "rt") as f:
        return json.load(f)


def test_fit_checkpoint_and_resume(tmp_path):
    from bcosification_tpu_torch.training.trainer import Trainer

    dm, tiny = SynthDataModule(), TinyNet()
    before = {k: v.clone() for k, v in tiny.state_dict().items()}
    exp = _experiment(tmp_path)
    trainer = Trainer(exp, device="cpu")
    state = trainer.fit(tiny, dm, max_epochs=2)
    assert state.step == 2 * 4  # 2 epochs x 4 batches
    assert all(torch.equal(v, before[k]) for k, v in tiny.state_dict().items())
    assert (exp.save_dir / "hparams.json").exists()
    assert trainer.ckpt.available_checkpoints() == [0, 1]
    # the conversion-quality validation: epoch -1, in the history, not in the csv
    assert trainer.metrics.history["initial_val_acc1"][0][0] == -1
    with open(exp.save_dir / "metrics.csv") as f:
        header = f.readline().strip().split(",")
        rows = f.read().splitlines()
    assert header == ["epoch", "epoch_time_s", "lr", "train_acc1", "train_loss", "val_acc1",
                      "val_acc5", "val_loss"]
    assert [r.split(",")[0] for r in rows] == ["0", "1"]

    # resume continues after epoch 1 -> runs only epoch 2, from the saved state
    state2 = Trainer(exp, device="cpu").fit(tiny, dm, max_epochs=3)
    assert state2.step == 3 * 4
    hist = _history(exp)
    assert [e for e, _ in hist["train_loss"]] == [0, 1, 2]
    assert [e for e, _ in hist["initial_val_acc1"]] == [-1]

    # resume=False starts from the caller's weights even though checkpoints exist
    state3 = Trainer(exp, device="cpu").fit(tiny, dm, max_epochs=1, resume=False)
    assert state3.step == 4
    assert hist["val_acc1"][-1][1] > 0.3  # learned something: above chance

    # fast_dev_run: one step, no initial validation, one checkpoint
    exp_f = _experiment(tmp_path / "fast")
    trainer_f = Trainer(exp_f, device="cpu")
    assert trainer_f.fit(tiny, dm, fast_dev_run=True).step == 1
    assert "initial_val_acc1" not in trainer_f.metrics.history


def test_fit_matches_jax_trainer(tmp_path):
    """Two epochs of Adam + cosine + AGC + EMA from the same weights: the
    port's per-epoch train loss and validation metrics against the JAX
    Trainer's, within 1e-4 relative."""
    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.training.trainer import Trainer

    model, variables, tiny = _jax_tiny()
    dm = SynthDataModule()
    jexp = _experiment(tmp_path / "jax", port=False, ema=True)
    JaxTrainer(jexp).fit(model, jax.tree_util.tree_map(jnp.asarray, variables), dm,
                         max_epochs=2)
    texp = _experiment(tmp_path / "port", ema=True)
    Trainer(texp, device="cpu").fit(tiny, dm, max_epochs=2)
    want, got = _history(jexp), _history(texp)
    for key in ("train_loss", "train_acc1", "val_acc1", "val_loss", "val_loss_ema", "lr",
                "initial_val_loss"):
        np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in want[key]],
                                   rtol=1e-4, atol=1e-7, err_msg=key)


def test_checkpoint_selection_and_pruning(tmp_path):
    from bcosification_tpu_torch.training.checkpointing import CheckpointManager

    ckpt = CheckpointManager(str(tmp_path), monitor="val_acc1", mode="max", top_k=2)
    scores = [0.1, 0.5, 0.3, 0.4, 0.2]
    for epoch, acc in enumerate(scores):
        ckpt.save({"step": torch.tensor(epoch)}, epoch,
                  {"val_acc1": acc, "val_acc1_ema": 0.6 if epoch == 0 else 0.0})
    # kept: the last (4), the top 2 by val_acc1 (1, 3), the top 2 by the EMA twin (0, +1)
    assert ckpt.available_checkpoints() == [0, 1, 3, 4]
    dirs = sorted(p.name for p in (tmp_path / "checkpoints").iterdir() if p.is_dir())
    assert dirs == ["epoch_0", "epoch_1", "epoch_3", "epoch_4"]
    assert ckpt.resolve("last") == 4 and ckpt.resolve("best") == 1
    assert ckpt.resolve("best_any") == 0 and ckpt.resolve("epoch_3") == 3
    assert ckpt.resolve("epoch_2") is None
    state, epoch = ckpt.restore("best")
    assert epoch == 1 and int(state["step"]) == 1
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))
    with pytest.raises(ValueError):
        ckpt.resolve("worst")
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)


UNPORTED = {
    # KD is ported; its per-process split of the CC3M train shards is not
    "kd": ({"clip_kd": True, "data": {"split_shards_by_process": True}}, "slice 8"),
    "pipeline_parallel": ({"trainer": {"pipeline_parallel": 2}}, "slice 8"),
    "model_parallel": ({"trainer": {"model_parallel": 2}}, "slice 8"),
    "fsdp": ({"trainer": {"fsdp": True}}, "slice 8"),
    "split_by_process": ({"data": {"split_by_process": True}}, "slice 8"),
}
# options that raised until the training options were ported
PORTED = {
    "accumulate": {"trainer": {"max_epochs": 2, "accumulate_grad_batches": 2}},
    "linear_b": {"model": {"bcosify_args": {"linear_b": True}}},
    "b_interpolation": {"model": {"bcosify_args": {"b_interpolation": True}}},
    "manual_optim": {"model": {"bcosify_args": {"manual_optim": True}}},
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(tmp_path, case):
    from bcosification_tpu_torch.training.trainer import Trainer

    extra, where = UNPORTED[case]
    exp = _experiment(tmp_path)
    exp.config.update(extra)
    with pytest.raises(NotImplementedError, match=where):
        Trainer(exp, device="cpu").fit(TinyNet(), SynthDataModule(), max_epochs=1)


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_options_match_jax_trainer(tmp_path, case):
    """The options as the JAX Trainer runs them, from the same weights, with
    EMA: two epochs' train loss, validation metrics and lr within 1e-4
    relative (TinyNet has no learnable b: linear_b, b_interpolation and
    manual_optim leave its training as it is, in both packages)."""
    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.training.trainer import Trainer

    model, variables, tiny = _jax_tiny()
    dm = SynthDataModule()
    histories = []
    for port in (False, True):
        exp = _experiment(tmp_path / str(port), port=port, ema=True)
        exp.config.update(PORTED[case])
        if port:
            Trainer(exp, device="cpu").fit(tiny, dm, max_epochs=2)
        else:
            JaxTrainer(exp).fit(model, jax.tree_util.tree_map(jnp.asarray, variables), dm,
                                max_epochs=2)
        histories.append(_history(exp))
    want, got = histories
    for key in ("train_loss", "val_acc1", "val_loss", "val_loss_ema", "lr"):
        np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in want[key]],
                                   rtol=1e-4, atol=1e-7, err_msg=key)


def test_trainer_device_and_loggers(tmp_path):
    from bcosification_tpu_torch.training.loggers import TensorBoardLogger, read_events
    from bcosification_tpu_torch.training.trainer import Trainer

    exp = _experiment(tmp_path)
    trainer = Trainer(exp, {"tensorboard_logger": True, "log_every_n_steps": 2}, device="cpu")
    (logger,) = trainer.loggers
    assert isinstance(logger, TensorBoardLogger) and logger.logdir == exp.save_dir / "tb"
    trainer.fit(TinyNet(), SynthDataModule(), max_epochs=1)
    events = read_events(logger.path)
    steps = [(e["step"], sorted(e["scalars"])) for e in events[1:]]
    assert events[0]["file_version"] == "brain.Event:2"
    assert steps[:2] == [(0, ["initial_val_acc1", "initial_val_acc5", "initial_val_loss"]),
                         (2, ["lr", "train_loss_step"])]
    assert steps[-1][0] == 4 and "val_acc1" in steps[-1][1]
    if not torch.cuda.is_available():  # the entry point runs on the card by default
        with pytest.raises(RuntimeError, match="GPU"):
            Trainer(exp)
