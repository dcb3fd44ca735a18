"""The data-parallel dry run of the port: the data-parallel half of the JAX
``__graft_entry__.dryrun_multichip``, run by every rank of a process group
(``parallel/dp.py``; on the CPU a gloo group, on cards an NCCL one).

``dryrun_dp`` drives, on the small flagship (the B-cosified ResNet-50
layout at 32x32, inplanes 8, one bottleneck per stage, 10 classes):

1. the supervised train step of the CNN recipe (UniformOffLabels BCE,
   Adam with the warm-up cosine, AGC, EMA every 2 steps) on this rank's
   rows of a seeded global batch;
2. a checkpoint save on rank 0, a restore on every rank, and one more step
   from the live and from the restored state, whose losses must agree;
3. the explanation step: each rank explains its rows
   (``explain.core.make_explain_fn``) and the ranks' W are gathered;
4. the SigLIP ring: each rank's ``SigLipLoss(world_size=W)`` on its rows of
   seeded features, averaged over the ranks.

It returns what a caller holds against one process: the first step's loss,
the parameters after the resumed step, the gathered W and the SigLIP loss.
The JAX dry run's wall-clock "DP scaling band" is not ported: it times
devices of one host and means nothing on a CPU group.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bcosification_tpu_torch.parallel import dp

__all__ = ["FLAGSHIP_CONFIG", "small_flagship", "dryrun_dp", "global_batch"]

FLAGSHIP_CONFIG = {
    "name": "resnet50",
    "bcosify_args": {"fix_b": True, "use_bias": False, "norm_layer": "BnUncV2", "gap": True,
                     "act_layer": True},
    "bcos_args": {"b": 2},
}
NUM_CLASSES, SIZE = 10, 32


def small_flagship(device="cpu", seed: int = 0):
    """The dry run's net: random init from ``seed``."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    return build_bcosified_resnet(FLAGSHIP_CONFIG, num_classes=NUM_CLASSES, inplanes=8,
                                  layers=("bottleneck", (1, 1)), device=device, seed=seed)


def global_batch(n: int, seed: int = 1) -> Dict[str, torch.Tensor]:
    """A seeded AddInverse batch of ``n`` images and labels, the same on
    every rank."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, SIZE, SIZE, 3)).astype(np.float32)
    return {"image": torch.from_numpy(np.concatenate([x, 1.0 - x], axis=-1)),
            "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, n).astype(np.int64))}


def _recipe():
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

    schedule = LRSchedulerFactory(name="cosineannealinglr", epochs=4, warmup_epochs=1,
                                  warmup_method="linear").create(1e-4, steps_per_epoch=10)
    return UniformOffLabelsBCEWithLogitsLoss(), OptimizerFactory(name="Adam", lr=1e-4), schedule


def dryrun_dp(save_dir: str, model: Optional[torch.nn.Module] = None, device="cpu",
              per_rank: int = 2) -> Dict[str, Any]:
    """Run the four parts on this rank (see the module docstring) with the
    checkpoint under ``save_dir`` (shared by the ranks) and ``model`` (default
    ``small_flagship``); raises if a part's check fails."""
    from bcosification_tpu_torch.explain.core import make_explain_fn
    from bcosification_tpu_torch.losses import SigLipLoss
    from bcosification_tpu_torch.training import steps as steps_lib
    from bcosification_tpu_torch.training.checkpointing import CheckpointManager

    dev = torch.device(device)
    world = dp.world_size()
    model = small_flagship(dev) if model is None else model.to(dev)

    # 1. the supervised train step on this rank's rows of the global batch
    criterion, opt, schedule = _recipe()
    train_step = steps_lib.make_train_step(criterion, schedule, use_agc=True, ema_decay=0.99,
                                           ema_steps=2)
    state = steps_lib.create_train_state(model, opt.create, with_ema=True, device=dev)
    dp.replicate(state.model)
    dp.replicate(state.ema)
    batch = {k: v.to(dev) for k, v in dp.shard_batch(global_batch(per_rank * world)).items()}
    state, metrics = train_step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss

    # 2. save on rank 0, restore on every rank, step from both
    ckpt = CheckpointManager(save_dir, monitor="val_loss", mode="min")
    ckpt.save(state.state_dict(), epoch=0, metrics={"val_loss": loss})
    dp.barrier()
    restored_dict, epoch = ckpt.restore("last", map_location=dev)
    assert epoch == 0, f"checkpoint restore resolved epoch {epoch}"
    restored = steps_lib.create_train_state(model, opt.create, with_ema=True, device=dev)
    restored.load_state_dict(restored_dict)
    state, m_live = train_step(state, batch)
    restored, m_restored = train_step(restored, batch)
    resume_delta = abs(float(m_live["loss"]) - float(m_restored["loss"]))
    assert resume_delta < 1e-6, (float(m_live["loss"]), float(m_restored["loss"]))

    # 3. each rank explains its rows; the ranks' W gathered in rank order
    x = dp.shard_batch(global_batch(per_rank * world, seed=2))["image"].to(dev)
    w = make_explain_fn(state.model, with_image=False)(x, device=dev)["dynamic_linear_weights"]
    w_all = dp.all_gather(w.detach())
    assert w_all.shape[0] == per_rank * world and bool(torch.isfinite(w_all).all())

    # 4. the SigLIP ring on this rank's rows of seeded features
    rng = np.random.default_rng(3)
    img, txt = (torch.from_numpy(rng.standard_normal((per_rank * world, 16)).astype(np.float32))
                for _ in range(2))
    rows = dp.rows(per_rank * world)
    siglip = SigLipLoss(world_size=world)(img[rows].to(dev), txt[rows].to(dev), 10.0, -10.0)
    siglip = siglip.detach().reshape(1)
    dp.reduce_sum_(siglip)
    siglip = float(siglip) / world
    assert np.isfinite(siglip), siglip
    return {"loss": loss, "resume_delta": resume_delta,
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "w": w_all.cpu(), "siglip": siglip}
