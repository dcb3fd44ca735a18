"""The supervised training loop (counterpart of the supervised branch of
``bcosification_tpu/training/trainer.py::Trainer``).

``run_training(args)`` is the ``train`` command's assembly: the
experiment, its model and data module, and one ``fit``.

``Trainer(experiment, args, device).fit(model, datamodule)`` trains a copy of
``model`` and returns the final ``TrainState``. ``experiment`` carries
``.config`` (criterion, test_criterion, optimizer, lr_scheduler, trainer,
use_agc, ema, model) and ``.save_dir``; ``datamodule`` has ``setup``,
``batch_size``, ``train_dataloader(seed=)`` (with ``len`` and
``set_epoch``) and ``val_dataloader()``, whose batches are dicts of
"image" (NHWC) and "label", numpy arrays or tensors.

A fit validates the converted model first (epoch -1, recorded in the
history but not in ``metrics.csv``), then runs epochs of train steps, each
followed by validation (and EMA validation), a ``metrics.csv`` row and a
checkpoint. With ``resume`` it restarts after the last checkpoint.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.training import steps as steps_lib
from bcosification_tpu_torch.training.checkpointing import CheckpointManager
from bcosification_tpu_torch.training.ema import adjusted_ema_decay
from bcosification_tpu_torch.training.loggers import MetricsLogger, setup_loggers

__all__ = ["Trainer", "run_training"]

_SLICE_5 = "port slice 5 (CLIP and knowledge distillation)"
_SLICE_6 = "port slice 6 (the rest of training)"
_SLICE_8 = "port slice 8 (distribution)"
_SLICE_6D = "port slice 6d (loggers and the explanation logger)"
# flags of the train command whose features are not ported: (flag, the
# argparse dest, its value when off, the slice that brings it)
UNPORTED_FLAGS = (
    ("--tensorboard_logger", "tensorboard_logger", False, _SLICE_6D),
    ("--wandb_logger", "wandb_logger", False, _SLICE_6D),
    ("--explanation_logging", "explanation_logging", False, _SLICE_6D),
    ("--profile_dir", "profile_dir", None, _SLICE_6D),
    ("--fsdp", "fsdp", False, _SLICE_8),
    ("--model_parallel", "model_parallel", 1, _SLICE_8),
    ("--pipeline_parallel", "pipeline_parallel", 1, _SLICE_8),
)


def _check_ported(config: Dict[str, Any]) -> None:
    """Raise NotImplementedError, naming the later slice, for the options of
    the JAX trainer that the port does not have yet."""
    tcfg = config.get("trainer", {}) or {}
    bargs = (config.get("model", {}) or {}).get("bcosify_args", {}) or {}
    unported = [
        (config.get("clip_kd", False) or bargs.get("clip_kd", False), "clip_kd (fit_kd)", _SLICE_5),
        (int(tcfg.get("pipeline_parallel", 1) or 1) > 1, "trainer.pipeline_parallel", _SLICE_8),
        (int(tcfg.get("model_parallel", 1) or 1) > 1, "trainer.model_parallel", _SLICE_8),
        (tcfg.get("fsdp", False), "trainer.fsdp", _SLICE_8),
        ((config.get("data", {}) or {}).get("split_by_process", False),
         "data.split_by_process", _SLICE_8),
        (int(tcfg.get("accumulate_grad_batches", 1) or 1) > 1,
         "trainer.accumulate_grad_batches > 1", _SLICE_6),
        (bargs.get("linear_b", False), "bcosify_args.linear_b (learnable b)", _SLICE_6),
        (bargs.get("b_interpolation", False), "bcosify_args.b_interpolation", _SLICE_6),
        (bargs.get("manual_optim", False), "bcosify_args.manual_optim (learnable b)", _SLICE_6),
    ]
    for asked, what, where in unported:
        if asked:
            raise NotImplementedError(f"Trainer: {what} is not ported yet; it comes in {where}")


class Trainer:
    def __init__(self, experiment, args: Optional[Dict[str, Any]] = None, device=None):
        self.experiment = experiment
        self.config = experiment.config
        self.args = args or {}
        self.device = resolve_device(device)
        setup_loggers(self.args)
        self.save_dir = Path(experiment.save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(str(self.save_dir), monitor="val_acc1", mode="max")
        self.metrics = MetricsLogger(self.save_dir)
        self.metrics.log_hparams(self.config)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def fit(self, model, datamodule, max_epochs: Optional[int] = None,
            fast_dev_run: bool = False, resume: bool = True) -> steps_lib.TrainState:
        config = self.config
        _check_ported(config)
        tcfg = config.get("trainer", {}) or {}
        max_epochs = max_epochs or tcfg.get("max_epochs", 90)
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader(seed=config.get("seed", 0) or 0)
        steps_per_epoch = max(len(train_loader), 1)

        opt_factory = config["optimizer"]
        sched_factory = config.get("lr_scheduler")
        schedule = (sched_factory.create(opt_factory.lr, steps_per_epoch)
                    if sched_factory is not None else opt_factory.lr)
        ema_config = config.get("ema", None)
        ema_decay, ema_steps = None, 32
        if ema_config is not None:
            ema_steps = ema_config.get("steps", 32)
            ema_decay = adjusted_ema_decay(ema_config["decay"], world_size=1,
                                           batch_size=datamodule.batch_size,
                                           max_epochs=max_epochs, ema_steps=ema_steps)
        train_step = steps_lib.make_train_step(
            config["criterion"], schedule, use_agc=config.get("use_agc", False),
            gradient_clip_val=tcfg.get("gradient_clip_val"), ema_decay=ema_decay,
            ema_steps=ema_steps, amp=bool(self.args.get("amp", False)),
        )
        eval_step = steps_lib.make_eval_step(config.get("test_criterion"))
        eval_step_ema = (steps_lib.make_eval_step(config.get("test_criterion"), use_ema=True)
                         if ema_config is not None else None)
        state = steps_lib.create_train_state(model, opt_factory.create,
                                             with_ema=ema_config is not None,
                                             device=self.device)

        start_epoch = 0
        if resume:
            restored, last_epoch = self.ckpt.restore("last", map_location=self.device)
            if restored is not None:
                state.load_state_dict(restored)
                start_epoch = last_epoch + 1
                print(f"Resuming from epoch {last_epoch}")
        if start_epoch == 0 and not fast_dev_run:
            # the conversion-quality metric: the model as converted, before training
            init_metrics = self.validate(eval_step, state, datamodule)
            print("initial (pre-training) validation: "
                  + ", ".join(f"{k}={v:.4f}" for k, v in init_metrics.items()))
            self.metrics.log(-1, {f"initial_{k}": v for k, v in init_metrics.items()},
                             csv=False)

        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            train_loader.set_epoch(epoch)
            losses, accs = [], []
            for batch in train_loader:
                state, metrics = train_step(state, self._to_device(batch))
                losses.append(metrics["loss"])
                accs.append(metrics["acc1"])
                if fast_dev_run:
                    break
            if not losses:
                print("WARNING: the train loader yielded no batches (dataset smaller than "
                      "batch_size with drop_last?); this epoch's train metrics are NaN")
            nan = float("nan")
            train_loss = float(torch.stack(losses).mean()) if losses else nan
            train_acc = float(torch.stack(accs).mean()) if accs else nan
            val_metrics = self.validate(eval_step, state, datamodule)
            epoch_metrics = {
                "train_loss": train_loss,
                "train_acc1": train_acc,
                "epoch_time_s": time.time() - t0,
                "lr": float(schedule(state.step)) if callable(schedule) else schedule,
                **val_metrics,
            }
            if eval_step_ema is not None:
                ema_metrics = self.validate(eval_step_ema, state, datamodule)
                epoch_metrics.update({f"{k}_ema": v for k, v in ema_metrics.items()})
            self.metrics.log(epoch, epoch_metrics)
            self.ckpt.save(state.state_dict(), epoch, epoch_metrics)
            print(f"epoch {epoch}: loss {train_loss:.4f} acc {train_acc:.4f} "
                  f"val_acc1 {val_metrics['val_acc1']:.4f} "
                  f"({epoch_metrics['epoch_time_s']:.1f}s)")
            if fast_dev_run:
                break
        return state

    def validate(self, eval_step, state, datamodule) -> Dict[str, float]:
        totals: Dict[str, Any] = {}
        for batch in datamodule.val_dataloader():
            for k, v in eval_step(state, self._to_device(batch)).items():
                totals[k] = totals.get(k, 0.0) + v
        totals = {k: float(v) for k, v in totals.items()}
        count = max(totals.pop("count", 1.0), 1.0)
        out = {"val_acc1": totals.get("correct1", 0.0) / count,
               "val_acc5": totals.get("correct5", 0.0) / count}
        if "loss" in totals:
            out["val_loss"] = totals["loss"] / count
        return out


def check_flags(args) -> None:
    """Raise NotImplementedError, naming the flag and its slice, for a flag
    of the train command whose feature is not ported; none is ignored."""
    for flag, dest, off, where in UNPORTED_FLAGS:
        value = getattr(args, dest, off)
        if value not in (off, None):
            raise NotImplementedError(f"{flag}={value} is not ported yet; it comes in {where}")


def run_training(args, device=None) -> steps_lib.TrainState:
    """The train command: the Experiment of (dataset, base_network,
    experiment_name), numpy and torch seeded from its config's seed (42
    when it has none), its model and data module, and ``Trainer.fit`` on
    ``device`` (default the GPU; the CPU only when asked for)."""
    from bcosification_tpu_torch import settings
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    check_flags(args)
    dev = resolve_device(device)
    if getattr(args, "base_directory", None):
        settings.EXPERIMENT_ROOT = args.base_directory
    experiment = Experiment(args.dataset, args.base_network, args.experiment_name)
    seed = experiment.config.get("seed", 42)
    seed = 42 if seed is None else seed  # 0 is a legitimate seed
    np.random.seed(seed)
    torch.manual_seed(seed)
    model = experiment.get_model(device=dev)
    datamodule = experiment.get_datamodule(cache_dataset=getattr(args, "cache_dataset", None))
    trainer = Trainer(experiment, vars(args), device=dev)
    return trainer.fit(model, datamodule, fast_dev_run=getattr(args, "fast_dev_run", False),
                       resume=getattr(args, "resume", True))
