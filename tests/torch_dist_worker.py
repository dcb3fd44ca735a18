"""Spawned gloo groups for the port's data-parallel tests, with no JAX: the
workers import torch and ``bcosification_tpu_torch`` only, so a test file
pays neither JAX's import nor its 8 virtual devices per worker.

``run_group(jobs, world, workdir)`` starts ``world`` processes of this file
with the launcher's env contract (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), each joins the gloo group through
``run_distributed.initialize_distributed(device="cpu")``, runs every job
of ``jobs`` (a list of (name, kwargs)) in order and writes its results;
``run_group`` returns them as ``results[job][rank]``. The job functions are
plain functions of this module, so a test also calls them in its own
process (no group: world 1) for the one-process reference.
"""
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch
from torch import nn

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# --------------------------------------------------------------------------
# the group
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(jobs, world, workdir, timeout=240):
    """Run ``jobs`` on a gloo group of ``world`` fresh processes; returns
    [[result of job j on rank r for r in ranks] for j in jobs]."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.pt"
    torch.save({"jobs": jobs}, spec)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    procs = []
    for r in range(world):
        env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__)), str(spec),
                                        str(workdir)], env=env_r, stdout=log,
                                       stderr=subprocess.STDOUT, cwd=str(ROOT)), log))
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((r, rc, (workdir / f"rank{r}.log").read_text()[-3000:]))
    if failed:
        raise RuntimeError("gloo group failed: " + "\n".join(
            f"rank {r} rc {rc}:\n{tail}" for r, rc, tail in failed))
    per_rank = [torch.load(workdir / f"result{r}.pt", weights_only=False)
                for r in range(world)]
    return [[per_rank[r][j] for r in range(world)] for j in range(len(jobs))]


def _main(spec_path, workdir):
    torch.set_num_threads(1)
    from bcosification_tpu_torch.parallel import dp
    from bcosification_tpu_torch.run_distributed import initialize_distributed

    assert initialize_distributed(argv=[], device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    results = [JOBS[name](**kwargs) for name, kwargs in spec["jobs"]]
    torch.save(results, Path(workdir) / f"result{dp.rank()}.pt")
    dp.barrier()
    dp.destroy_process_group()
    assert "jax" not in sys.modules, "a gloo worker imported JAX"


def _mine(t):
    """This rank's block of a global tensor's first axis."""
    from bcosification_tpu_torch.parallel import dp

    s = dp.rows(len(t))
    return t if s is None else t[s]


def _local(t, dim=0):
    from bcosification_tpu_torch.parallel import dp

    n = t.shape[dim] // dp.world_size()
    return t.narrow(dim, dp.rank() * n, n)


# --------------------------------------------------------------------------
# the collectives of losses.py: each rank's loss and its inputs' gradients
# --------------------------------------------------------------------------
def _grads(loss, *leaves):
    loss.backward()
    return {"loss": loss.detach(), "grads": [leaf.grad for leaf in leaves]}


def job_gather(img, txt, c_img, c_txt):
    """L_r = <C_r, gathered img> + <D_r, gathered txt>, C_r this rank's block
    of c_img (shape of the gathered features)."""
    from bcosification_tpu_torch import losses

    i, t = (_local(a).clone().requires_grad_(True) for a in (img, txt))
    all_i, all_t = losses.gather_features(i, t)
    out = _grads((all_i * _local(c_img)).sum() + (all_t * _local(c_txt)).sum(), i, t)
    out["gathered"] = [all_i.detach(), all_t.detach()]
    return out


def job_exchange(x, c, direction):
    from bcosification_tpu_torch import losses

    xi = _local(x).clone().requires_grad_(True)
    y = losses.neighbour_exchange(xi, direction)
    out = _grads((y * _local(c)).sum(), xi)
    out["out"] = [y.detach()]
    return out


def job_exchange_bidir(a, b, ca, cb):
    from bcosification_tpu_torch import losses

    ai, bi = (_local(t).clone().requires_grad_(True) for t in (a, b))
    from_right, from_left = losses.neighbour_exchange_bidir(ai, bi)
    out = _grads((from_right * _local(ca)).sum() + (from_left * _local(cb)).sum(), ai, bi)
    out["out"] = [from_right.detach(), from_left.detach()]
    return out


def job_clip(img, txt, scale, local_loss, distill=None):
    """ClipLoss (or, with ``distill`` = (teacher img, teacher txt, teacher
    scale), DistillClipLoss: the sum of its two terms) of this rank's rows."""
    from bcosification_tpu_torch import losses
    from bcosification_tpu_torch.parallel import dp

    i, t = (_local(a).clone().requires_grad_(True) for a in (img, txt))
    if distill is None:
        loss = losses.ClipLoss(local_loss=local_loss, world_size=dp.world_size())(i, t, scale)
    else:
        di, dt, dscale = distill
        c, d = losses.DistillClipLoss(local_loss=local_loss, world_size=dp.world_size())(
            i, t, scale, _local(di), _local(dt), dscale)
        loss = c + d
    return _grads(loss, i, t)


def job_siglip(img, txt, bidir, cos_scaling):
    """SigLipLoss's ring on this rank's rows; an attn-unpool [HW, B, D] image
    batch is split on its axis 1."""
    from bcosification_tpu_torch import losses
    from bcosification_tpu_torch.parallel import dp

    i = _local(img, dim=1 if cos_scaling else 0).clone().requires_grad_(True)
    t = _local(txt).clone().requires_grad_(True)
    loss = losses.SigLipLoss(bidir=bidir, world_size=dp.world_size())(
        i, t, 10.0, -10.0, cos_scaling=cos_scaling)
    return _grads(loss, i, t)


# --------------------------------------------------------------------------
# the train steps
# --------------------------------------------------------------------------
def recipe():
    """The recipe of the port's train-step tests: UniformOffLabels BCE, Adam
    1e-3 with the linear warm-up cosine."""
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

    schedule = LRSchedulerFactory(name="cosineannealinglr", epochs=4, warmup_epochs=1,
                                  warmup_method="linear", interval="step").create(
        1e-3, steps_per_epoch=10)
    return UniformOffLabelsBCEWithLogitsLoss(), OptimizerFactory("Adam", 1e-3), schedule


def job_train_steps(model, batches, use_agc=True, ema=True, accumulate=1):
    """The supervised step on this rank's rows of each global batch; per
    step its metrics, then the model's and the EMA's state."""
    from bcosification_tpu_torch.parallel import dp
    from bcosification_tpu_torch.training import steps

    criterion, factory, schedule = recipe()
    step = steps.make_train_step(criterion, schedule, use_agc=use_agc,
                                 ema_decay=0.9 if ema else None, ema_steps=1,
                                 accumulate=accumulate)
    state = steps.create_train_state(model, factory.create, with_ema=ema, device="cpu")
    metrics = []
    for batch in batches:
        state, m = step(state, dp.shard_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "model": state.model.state_dict(),
            "ema": None if state.ema is None else state.ema.state_dict()}


def job_kd_step(student, teacher, images, cos_power, loss_mode, use_agc=True):
    """One KD step of the recipe (Adam 1e-4 with the cosine) on this rank's
    rows: the loss, the parameters, Adam's first moment and the state."""
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    from bcosification_tpu_torch.parallel import dp
    from bcosification_tpu_torch.training import kd, steps

    opt = OptimizerFactory(name="Adam", lr=1e-4, bcosify=True, b_opt=False)
    sched = LRSchedulerFactory(name="cosineannealinglr", epochs=90).create(1e-4, 10)
    state = steps.create_train_state(student, opt.create, device="cpu")
    step = kd.make_kd_train_step(teacher, sched, cos_power=cos_power, use_agc=use_agc,
                                 loss_mode=loss_mode)
    state, m = step(state, {"image": dp.shard_batch({"image": images})["image"]})
    params = dict(state.model.named_parameters())
    return {"loss": float(m["loss"]), "model": state.model.state_dict(),
            "mu": {n: state.optimizer.state[p]["exp_avg"].clone() for n, p in params.items()}}


# --------------------------------------------------------------------------
# Trainer.fit under the group, with the tiny net of the Trainer tests
# --------------------------------------------------------------------------
class SynthDataModule:
    """32 images of 8x8x6 whose channel means encode one of 4 labels
    (tests/test_torch_trainer.py's)."""

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
    """A 3x3 B-cos conv, a bias-free uncentered BN, a 1x1 B-cos conv and the
    spatial mean (tests/test_torch_trainer.py's)."""

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


def experiment(save_dir):
    from bcosification_tpu_torch.losses import (BinaryCrossEntropyLoss,
                                                UniformOffLabelsBCEWithLogitsLoss)
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

    exp = types.SimpleNamespace(save_dir=Path(save_dir))
    exp.config = dict(
        criterion=UniformOffLabelsBCEWithLogitsLoss(), test_criterion=BinaryCrossEntropyLoss(),
        optimizer=OptimizerFactory(name="Adam", lr=5e-3),
        lr_scheduler=LRSchedulerFactory(name="cosineannealinglr", epochs=3),
        trainer=dict(max_epochs=3), use_agc=True, model=dict(),
        ema={"decay": 0.99, "steps": 2})
    return exp


def job_fit(model, save_dir, max_epochs, resume, per_rank_dir=False, n_val=32):
    """Trainer.fit of the tiny net; with ``per_rank_dir`` rank r writes under
    ``save_dir/rank{r}`` (so only rank 0's directory may appear). Returns the
    metrics history, the model's state and the files under the save dir."""
    from bcosification_tpu_torch.parallel import dp
    from bcosification_tpu_torch.training.trainer import Trainer

    path = Path(save_dir) / (f"rank{dp.rank()}" if per_rank_dir else "")
    trainer = Trainer(experiment(path), device="cpu")
    state = trainer.fit(model, SynthDataModule(n=n_val), max_epochs=max_epochs, resume=resume)
    return {"history": trainer.metrics.history, "model": state.model.state_dict(),
            "exists": path.exists()}


def job_dryrun(save_dir, model):
    from bcosification_tpu_torch.parallel.dryrun import dryrun_dp

    return dryrun_dp(save_dir, model)


JOBS = {name[len("job_"):]: fn for name, fn in dict(globals()).items()
        if name.startswith("job_")}

if __name__ == "__main__":
    _main(*sys.argv[1:3])
