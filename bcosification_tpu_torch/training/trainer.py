"""The training loops (counterpart of
``bcosification_tpu/training/trainer.py::Trainer``): supervised training and
CLIP knowledge distillation.

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

A config with ``clip_kd`` goes to ``fit_kd``: the student learns from the
frozen CLIP teacher of its model name (``clip/load.py``) with the SigLIP
loss (``training/kd.py``) on the image batches of its data module (a
loader without a length runs ``steps_per_epoch`` steps, 5000 by default).
Each epoch logs ``train_loss``, ``val_loss`` (fixed logit scale 10 and bias
-10, at most ``max_val_batches`` batches), ``epoch_time_s`` and, when
``DATA_ROOT`` or ``IMAGENET_PATH`` is set, the zero-shot top-1 of each
dataset found there. KD checkpoints are ranked by ``val_loss``
(``checkpointing.monitor_for``).

The options of the JAX trainer that no grid config sets:

- ``trainer.accumulate_grad_batches`` k: the mean gradient of k
  micro-batches per optimizer step (``optax.MultiSteps``; ``_make_optimizers``):
  the LR schedule advances once per optimizer step (built over
  ``steps_per_epoch // k`` steps), the logged lr is indexed by micro-step,
  the EMA is updated every ``ema.steps * k`` micro-steps, and AGC or the
  clip act on each micro-batch before it is accumulated.
- learnable b (bcosify_args): ``linear_b`` (without ``b_loss``) writes
  ``make_linear_b_schedule``'s b before every step, ``b_interpolation``
  1 + clip(step / total, 0, 1); ``manual_optim`` trains the b parameters
  with their own optimizer (``b_optimizer``, default the main one as SGD).
- args (the train command's flags): ``tensorboard_logger`` and
  ``wandb_logger`` (``training/loggers.py``; per-step ``train_loss_step``
  and ``lr`` every ``log_every_n_steps`` steps, default 50),
  ``profile_dir`` (a ``torch.profiler`` trace of train steps 3-8 of the
  first epoch, clamped to a short one; ``utils/profiling.py``), ``debug``
  (a hash of the parameters after each epoch, ``param_hash``), and
  ``fit(explanation_logging=True)`` (the explanations of 8 validation
  images every ``explanation_logging_every_n_epochs`` epochs, an npz and a
  PNG grid under ``explanations/``).
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.training import steps as steps_lib
from bcosification_tpu_torch.training.checkpointing import CheckpointManager, monitor_for
from bcosification_tpu_torch.training.ema import adjusted_ema_decay
from bcosification_tpu_torch.training.loggers import MetricsLogger, setup_loggers

__all__ = ["Trainer", "run_training"]

_SLICE_8 = "port slice 8 (distribution)"
# flags of the train command whose features are not ported: (flag, the
# argparse dest, its value when off, the slice that brings it)
UNPORTED_FLAGS = (
    ("--fsdp", "fsdp", False, _SLICE_8),
    ("--model_parallel", "model_parallel", 1, _SLICE_8),
    ("--pipeline_parallel", "pipeline_parallel", 1, _SLICE_8),
)


def _check_ported(config: Dict[str, Any]) -> None:
    """Raise NotImplementedError, naming the later slice, for the options of
    the JAX trainer that the port does not have yet."""
    tcfg = config.get("trainer", {}) or {}
    data = config.get("data", {}) or {}
    unported = [
        (int(tcfg.get("pipeline_parallel", 1) or 1) > 1, "trainer.pipeline_parallel"),
        (int(tcfg.get("model_parallel", 1) or 1) > 1, "trainer.model_parallel"),
        (tcfg.get("fsdp", False), "trainer.fsdp"),
        (data.get("split_by_process", False), "data.split_by_process"),
        (data.get("split_shards_by_process", False), "data.split_shards_by_process"),
    ]
    for asked, what in unported:
        if asked:
            raise NotImplementedError(f"Trainer: {what} is not ported yet; it comes in "
                                      f"{_SLICE_8}")


def _accumulation(config: Dict[str, Any]) -> int:
    return int((config.get("trainer", {}) or {}).get("accumulate_grad_batches", 1) or 1)


def _make_optimizers(config: Dict[str, Any], steps_per_epoch: int):
    """(optimizer factory, b optimizer factory or None, schedule or
    constant lr indexed by micro-step) of the config (JAX
    ``trainer.py::_make_optimizers``). Under accumulation k the schedule is
    built over ``steps_per_epoch // k`` optimizer steps and read at
    ``step // k``. ``manual_optim``: the b optimizer, the config's
    ``b_optimizer`` or the main one as SGD, over the b parameters only."""
    opt_factory, sched_factory = config["optimizer"], config.get("lr_scheduler")
    accum = _accumulation(config)
    schedule = (sched_factory.create(opt_factory.lr, max(steps_per_epoch // accum, 1))
                if sched_factory is not None else opt_factory.lr)
    bargs = (config.get("model", {}) or {}).get("bcosify_args", {}) or {}
    b_factory = None
    if bargs.get("manual_optim", False):
        b_factory = config.get("b_optimizer", opt_factory.with_name("sgd")).with_args(
            bcosify=True, b_opt=True)
    if accum > 1 and callable(schedule):
        def micro_schedule(step, _schedule=schedule):
            return _schedule(step // accum)
        return opt_factory, b_factory, micro_schedule
    return opt_factory, b_factory, schedule


def _b_schedule(config: Dict[str, Any], batch_size: int, total_steps: int):
    """The b schedule of bcosify_args (JAX ``Trainer.fit``): ``linear_b``
    without ``b_loss`` is ``make_linear_b_schedule`` over the batch,
    ``b_interpolation`` 1 + clip(step / total_steps, 0, 1) in f32."""
    bargs = (config.get("model", {}) or {}).get("bcosify_args", {}) or {}
    if bargs.get("linear_b", False) and not bargs.get("b_loss", False):
        return steps_lib.make_linear_b_schedule(
            b_at_start=bargs.get("b_at_start", 1), b_at_end=bargs.get("b_at_end", 2),
            b_lr=bargs.get("b_lr", 0.0001), world_size=1, batch_size=batch_size)
    if bargs.get("b_interpolation", False):
        def b_schedule(step):
            frac = np.clip(np.float32(step) / np.float32(total_steps), np.float32(0.0),
                           np.float32(1.0))
            return np.float32(1.0) + frac
        return b_schedule
    return None


def param_hash(model: torch.nn.Module) -> str:
    """A short content hash of ``model``'s parameters: sha256 over the JAX
    layout of every leaf (``to_jax_variables``) in the JAX tree order (keys
    sorted), so one set of weights hashes alike in both packages. ``--debug``
    prints it after each epoch: the student changes, a frozen teacher not."""
    import hashlib

    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables

    h = hashlib.sha256()

    def walk(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                walk(tree[key])
            else:
                h.update(np.ascontiguousarray(tree[key]).tobytes())

    walk(to_jax_variables(model)["params"])
    return h.hexdigest()[:16]


class _ProfileWindow:
    """``--profile_dir``: a ``torch.profiler`` trace from train step
    ``first`` to step ``last`` (0-based, both included) of one epoch,
    written to the directory when the window closes."""

    def __init__(self, profile_dir, window, device):
        self.profile_dir, self.window, self.device = profile_dir, window, device
        self._prof = None

    def before(self, n_steps: int) -> None:
        if self.window is not None and n_steps == self.window[0]:
            from bcosification_tpu_torch.utils.profiling import start_trace

            self._prof = start_trace(self.device)

    def after(self, n_steps: int) -> None:
        """After step ``n_steps`` (0-based) of the epoch."""
        if self._prof is not None and n_steps == self.window[1]:
            self.close()

    def close(self) -> None:
        """End of the epoch: close a window the epoch ended inside."""
        if self._prof is not None:
            from bcosification_tpu_torch.utils.profiling import stop_trace

            path = stop_trace(self._prof, self.profile_dir)
            print(f"profiler trace written to {path}")
        self._prof, self.window = None, None


class Trainer:
    def __init__(self, experiment, args: Optional[Dict[str, Any]] = None, device=None):
        self.experiment = experiment
        self.config = experiment.config
        self.args = args or {}
        self.device = resolve_device(device)
        self.save_dir = Path(experiment.save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        monitor, mode = monitor_for(self.config)
        self.ckpt = CheckpointManager(str(self.save_dir), monitor=monitor, mode=mode)
        self.loggers = setup_loggers(self.args, self.save_dir)
        for lg in self.loggers:
            lg.log_hparams(self.config)
        self.metrics = MetricsLogger(self.save_dir, self.loggers)
        self.metrics.log_hparams(self.config)
        # per-step event logging every n steps (0 or less: none)
        n = self.args.get("log_every_n_steps", 50)
        self._log_every_n_steps = int(n) if n is not None and int(n) > 0 else 0

    def _profile_window(self, window) -> Optional[_ProfileWindow]:
        profile_dir = self.args.get("profile_dir")
        return _ProfileWindow(profile_dir, window, self.device) if profile_dir else None

    def _log_step(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step=step)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _resume(self, state: steps_lib.TrainState) -> int:
        """Load the last checkpoint into ``state``; the epoch to start at."""
        restored, last_epoch = self.ckpt.restore("last", map_location=self.device)
        if restored is None:
            return 0
        state.load_state_dict(restored)
        print(f"Resuming from epoch {last_epoch}")
        return last_epoch + 1

    def fit(self, model, datamodule, max_epochs: Optional[int] = None,
            fast_dev_run: bool = False, resume: bool = True,
            explanation_logging: bool = False,
            explanation_logging_every_n_epochs: int = 1) -> steps_lib.TrainState:
        config = self.config
        _check_ported(config)
        if config.get("clip_kd", False):
            return self.fit_kd(model, datamodule, max_epochs=max_epochs,
                               fast_dev_run=fast_dev_run, resume=resume)
        tcfg = config.get("trainer", {}) or {}
        max_epochs = max_epochs or tcfg.get("max_epochs", 90)
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader(seed=config.get("seed", 0) or 0)
        steps_per_epoch = max(len(train_loader), 1)

        accum = _accumulation(config)
        opt_factory, b_factory, schedule = _make_optimizers(config, steps_per_epoch)
        ema_config = config.get("ema", None)
        ema_decay, ema_steps = None, 32
        if ema_config is not None:
            ema_steps = ema_config.get("steps", 32)
            ema_decay = adjusted_ema_decay(ema_config["decay"], world_size=1,
                                           batch_size=datamodule.batch_size,
                                           max_epochs=max_epochs, ema_steps=ema_steps,
                                           accumulate_grad_batches=accum)
        train_step = steps_lib.make_train_step(
            config["criterion"], schedule, use_agc=config.get("use_agc", False),
            gradient_clip_val=tcfg.get("gradient_clip_val"), ema_decay=ema_decay,
            # the EMA follows optimizer steps: every ema_steps of them
            ema_steps=ema_steps * accum,
            b_schedule=_b_schedule(config, datamodule.batch_size,
                                   max_epochs * steps_per_epoch),
            accumulate=accum, amp=bool(self.args.get("amp", False)),
        )
        eval_step = steps_lib.make_eval_step(config.get("test_criterion"))
        eval_step_ema = (steps_lib.make_eval_step(config.get("test_criterion"), use_ema=True)
                         if ema_config is not None else None)
        state = steps_lib.create_train_state(
            model, opt_factory.create, with_ema=ema_config is not None, device=self.device,
            make_b_optimizer=None if b_factory is None else b_factory.create)

        start_epoch = self._resume(state) if resume else 0
        if start_epoch == 0 and not fast_dev_run:
            # the conversion-quality metric: the model as converted, before training
            init_metrics = self.validate(eval_step, state, datamodule)
            print("initial (pre-training) validation: "
                  + ", ".join(f"{k}={v:.4f}" for k, v in init_metrics.items()))
            self.metrics.log(-1, {f"initial_{k}": v for k, v in init_metrics.items()},
                             csv=False)

        last = 0 if fast_dev_run else max(steps_per_epoch - 1, 0)
        profile = self._profile_window((min(3, last), min(8, last)))
        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            train_loader.set_epoch(epoch)
            losses, accs = [], []
            for batch in train_loader:
                n_steps = len(losses)
                if profile is not None:
                    profile.before(n_steps)
                state, metrics = train_step(state, self._to_device(batch))
                if profile is not None:
                    profile.after(n_steps)
                losses.append(metrics["loss"])
                accs.append(metrics["acc1"])
                # the float() waits for the card: only every n steps
                if self.loggers and self._log_every_n_steps and (
                        (n_steps + 1) % self._log_every_n_steps == 0):
                    self._log_step({
                        "train_loss_step": float(metrics["loss"]),
                        "lr": float(schedule(state.step)) if callable(schedule) else schedule,
                    }, step=epoch * steps_per_epoch + n_steps + 1)
                if fast_dev_run:
                    break
            if profile is not None:
                profile.close()
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
            self.metrics.log(epoch, epoch_metrics, logger_step=(epoch + 1) * steps_per_epoch)
            self.ckpt.save(state.state_dict(), epoch, epoch_metrics)
            print(f"epoch {epoch}: loss {train_loss:.4f} acc {train_acc:.4f} "
                  f"val_acc1 {val_metrics['val_acc1']:.4f} "
                  f"({epoch_metrics['epoch_time_s']:.1f}s)")
            if self.args.get("debug"):
                print(f"  params hash: {param_hash(state.model)}")
            if explanation_logging and epoch % explanation_logging_every_n_epochs == 0:
                self._log_explanations(state, datamodule, epoch)
            if fast_dev_run:
                break
        for lg in self.loggers:
            lg.finalize()
        return state

    def fit_kd(self, model, datamodule, max_epochs: Optional[int] = None,
               fast_dev_run: bool = False, resume: bool = True) -> steps_lib.TrainState:
        """SigLIP knowledge distillation of the student ``model`` from the
        frozen CLIP teacher (see the module docstring). There is no initial
        validation and no EMA, as in the JAX trainer's KD loop."""
        from bcosification_tpu_torch.clip.load import MODEL_CONFIG_CLIP_NAMES
        from bcosification_tpu_torch.clip.load import load as clip_load
        from bcosification_tpu_torch.training import kd as kd_lib

        config = self.config
        mcfg = config.get("model", {}) or {}
        max_epochs = max_epochs or (config.get("trainer", {}) or {}).get("max_epochs", 90)
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader(seed=config.get("seed", 0) or 0)
        if getattr(train_loader, "mode", None) == "pair":
            train_loader.mode = "image"  # the captions are not used: skip tokenizing them
        try:
            steps_per_epoch = max(len(train_loader), 1)
        except TypeError:  # a tar-shard stream has no length
            steps_per_epoch = config.get("steps_per_epoch", 5000)

        clip_name = MODEL_CONFIG_CLIP_NAMES.get(mcfg.get("name", "resnet50clip"), "RN50")
        teacher, text_model, _, _ = clip_load(clip_name, device=self.device)
        kd_cos_power = int(mcfg.get("cos_power", 1)) if mcfg.get("attn_unpool") else 0
        opt_factory, _, schedule = _make_optimizers(config, steps_per_epoch)
        train_step = kd_lib.make_kd_train_step(
            teacher, schedule,
            logit_scale=float(mcfg.get("logit_scale_value", 10)),
            logit_bias=float(mcfg.get("logit_bias_value", -10)), cos_power=kd_cos_power,
            use_agc=config.get("use_agc", True), accumulate=_accumulation(config),
            amp=bool(self.args.get("amp", False)))
        state = steps_lib.create_train_state(model, opt_factory.create, device=self.device)
        start_epoch = self._resume(state) if resume else 0

        @torch.no_grad()
        def val_loss(images):
            t_feat, s_out = kd_lib.kd_forward_features(state.model, teacher, images)
            return kd_lib.kd_loss(s_out, t_feat, 10.0, -10.0, kd_cos_power)

        max_val_batches = config.get("max_val_batches", 200)
        profile = self._profile_window((0, 0) if fast_dev_run else (3, 8))
        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            losses = []
            for batch in train_loader:
                n_steps = len(losses)
                if profile is not None:
                    profile.before(n_steps)
                state, metrics = train_step(state, self._to_device({"image": batch["image"]}))
                if profile is not None:
                    profile.after(n_steps)
                losses.append(metrics["loss"])
                # per-step events matter most here: CC3M KD epochs are hours
                if self.loggers and self._log_every_n_steps and (
                        len(losses) % self._log_every_n_steps == 0):
                    self._log_step({"train_loss_step": float(metrics["loss"])},
                                   step=int(state.step))
                if fast_dev_run:
                    break
            if profile is not None:
                profile.close()
            val_losses = []
            for batch in datamodule.val_dataloader():
                images = torch.as_tensor(batch["image"]).to(self.device)
                val_losses.append(float(val_loss(images)))
                if fast_dev_run or len(val_losses) >= max_val_batches:
                    break
            nan = float("nan")
            epoch_metrics = {
                "train_loss": float(torch.stack(losses).mean()) if losses else nan,
                "val_loss": float(np.mean(val_losses)) if val_losses else nan,
                "epoch_time_s": time.time() - t0,
            }
            epoch_metrics.update(self._maybe_zeroshot(state.model, text_model, kd_cos_power))
            self.metrics.log(epoch, epoch_metrics, logger_step=int(state.step))
            self.ckpt.save(state.state_dict(), epoch, epoch_metrics)
            print(f"epoch {epoch}: kd loss {epoch_metrics['train_loss']:.4f} val "
                  f"{epoch_metrics['val_loss']:.4f} ({epoch_metrics['epoch_time_s']:.1f}s)")
            if self.args.get("debug"):
                # the student must change, the frozen teacher must not
                print(f"  student params hash: {param_hash(state.model)}")
            if fast_dev_run:
                break
        for lg in self.loggers:
            lg.finalize()
        return state

    def _maybe_zeroshot(self, model, text_model, cos_power: int) -> Dict[str, float]:
        """The zero-shot top-1 of the student (``zeroshot_{name}_acc1``; an
        attn-unpool student's locations weighted with ``cos_power``) on each
        dataset found: CIFAR10/100, FashionMNIST and STL10 under DATA_ROOT,
        ImageNet at IMAGENET_PATH (its classifier from
        IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH when that is set, else from the
        text tower). Only missing data is skipped."""
        from bcosification_tpu_torch import settings
        from bcosification_tpu_torch.data.datamodules import ClassificationDataModule
        from bcosification_tpu_torch.data.imagenet import imagenet_templates
        from bcosification_tpu_torch.data.presets import CLIPBcosImageNetClassificationPresetEval
        from bcosification_tpu_torch.training import zeroshot as zs_lib

        results: Dict[str, float] = {}
        if not settings.DATA_ROOT and not settings.IMAGENET_PATH:
            return results
        registry = ClassificationDataModule.registry()
        specs = []
        if settings.DATA_ROOT:
            for name, subdir in (("CIFAR10", "cifar-10-batches-py"),
                                 ("CIFAR100", "cifar-100-python"),
                                 ("FashionMNIST", "FashionMNIST"), ("STL10", "stl10_binary")):
                if os.path.isdir(os.path.join(settings.DATA_ROOT, subdir)):
                    specs.append((name, registry[name]))
        if settings.IMAGENET_PATH:
            specs.append(("ImageNet", registry["ImageNet"]))

        def encode(images):
            return model(torch.cat([images, 1.0 - images], dim=-1), train=False)

        try:
            for name, cls in specs:
                dm = cls({"batch_size": 64, "num_workers": 8, "train_transform": None,
                          "test_transform": CLIPBcosImageNetClassificationPresetEval(
                              crop_size=224)})
                dm.setup("test")
                if name == "ImageNet" and settings.IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH:
                    w = zs_lib.load_zeroshot_weights(
                        settings.IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH).to(self.device)
                else:
                    w = zs_lib.zeroshot_classifier(text_model, dm.CATEGORIES,
                                                   imagenet_templates)
                acc = zs_lib.zeroshot_evaluate(encode, dm.test_dataloader(), w,
                                               cos_power=cos_power)
                results[f"zeroshot_{name}_acc1"] = acc["acc1"]
        except (FileNotFoundError, NotADirectoryError) as e:
            print(f"zeroshot eval skipped (data not present): {e}")
        return results

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


    def _log_explanations(self, state, datamodule, epoch: int, n_images: int = 8) -> None:
        """The explanations of the first ``n_images`` validation images by
        the model being trained (``explain.core.make_explain_fn``; the
        ResNets through their hand-scheduled pass): the RGBA explanation,
        the contribution map and the prediction in
        ``explanations/epoch_{epoch}.npz``, the explanations as a PNG grid
        of at most 4 columns (``epoch_{epoch}.png``), also logged as an
        image."""
        from bcosification_tpu_torch.explain.core import make_explain_fn

        batch = next(iter(datamodule.val_dataloader()), None)
        if batch is None:
            return
        x = torch.as_tensor(batch["image"][:n_images])
        res = make_explain_fn(state.model)(x, device=self.device)
        outdir = self.save_dir / "explanations"
        outdir.mkdir(exist_ok=True)
        expl = res["explanation"].detach().cpu().numpy()  # [N, H, W, 4] in [0, 1]
        np.savez_compressed(
            outdir / f"epoch_{epoch}.npz", explanation=expl,
            contribution_map=res["contribution_map"].detach().cpu().numpy(),
            prediction=res["prediction"].cpu().numpy())
        from PIL import Image

        n, h, w, _ = expl.shape
        cols = min(n, 4)
        grid = np.zeros((-(-n // cols) * h, cols * w, 4), np.float32)
        for i in range(n):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = expl[i]
        Image.fromarray((grid * 255).astype(np.uint8), "RGBA").save(outdir / f"epoch_{epoch}.png")
        for lg in self.loggers:
            lg.log_image("explanations", grid, step=epoch)


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
                       resume=getattr(args, "resume", True),
                       explanation_logging=getattr(args, "explanation_logging", False),
                       explanation_logging_every_n_epochs=getattr(
                           args, "explanation_logging_every_n_epochs", 1))
