"""Multi-process launcher of the port: one process per card, joined into one
process group, each running the port's ``train`` command (the counterpart
of the JAX package's root ``run_distributed.py``).

Usage, on one machine with N cards (torchrun sets the env contract)::

    torchrun --nproc_per_node=N -m bcosification_tpu_torch.run_distributed \\
        --dataset ImageNet --base_network bcosification --experiment_name resnet_50

or by hand, for each rank r of W: ``MASTER_ADDR=<host> MASTER_PORT=<port>
WORLD_SIZE=W RANK=r LOCAL_RANK=<card> python -m
bcosification_tpu_torch.run_distributed ...``. Every rank trains its rows of
each global batch (``training/trainer.py``); only rank 0 writes checkpoints,
metrics and logs, and every rank resumes from the shared experiment
directory, so a restarted job continues where it stopped.

The env contract is all three of ``MASTER_ADDR``, ``WORLD_SIZE`` and
``RANK``; a partial contract is ignored, with a message. A failed join
(no contract, malformed numbers, an unreachable master) is fatal: a
mis-configured job silently training on one card is the worst failure.
``--single-host-ok`` allows the one-process fallback explicitly, for local
and debug runs.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional

from bcosification_tpu_torch.parallel import dp

__all__ = ["initialize_distributed", "main"]


def initialize_distributed(argv: Optional[List[str]] = None,
                           _initialize: Optional[Callable] = None, device=None) -> bool:
    """Join the process group of the env contract on ``device`` (default the
    card of ``LOCAL_RANK``, NCCL; ``"cpu"``: gloo); True if a group of more
    than one rank is live. Consumes ``--single-host-ok`` from ``argv``
    (default ``sys.argv``), so the train command's parser never sees it.
    Raises RuntimeError when the join fails, unless that flag was passed;
    and when the joined group's size is not ``WORLD_SIZE``. ``_initialize``
    replaces ``dp.init_process_group`` (tests)."""
    argv = sys.argv if argv is None else argv
    single_host_ok = "--single-host-ok" in argv
    if single_host_ok:
        argv.remove("--single-host-ok")
    init = _initialize or dp.init_process_group
    contract = {k: os.environ.get(k) for k in dp.ENV_CONTRACT}
    kwargs, error = None, None
    if all(contract.values()):
        try:
            kwargs = dict(rank=int(contract["RANK"]), world_size=int(contract["WORLD_SIZE"]))
        except ValueError as e:  # malformed numbers: the path of a failed join
            error = RuntimeError(f"malformed WORLD_SIZE/RANK env contract ({e})")
    else:
        if any(contract.values()):
            print("ignoring partial MASTER_ADDR/WORLD_SIZE/RANK env contract "
                  f"({ {k: v for k, v in contract.items() if v} }); set all three to "
                  "configure the process group")
        error = RuntimeError("no MASTER_ADDR/WORLD_SIZE/RANK env contract to join a "
                             "process group with")
    if error is None:
        try:
            init(device, **kwargs)
        except Exception as e:  # noqa: BLE001 - every failed join takes one path
            error = e
    if error is not None:
        if single_host_ok:
            print(f"single-process run (--single-host-ok; no process group: {error})")
            return False
        raise RuntimeError(
            "joining the process group failed; refusing to fall back silently to a "
            "one-process run of what may be a mis-configured job. Pass --single-host-ok "
            f"to allow it for local or debug runs. Original error: {error}") from error
    if dp.world_size() != kwargs["world_size"]:
        raise RuntimeError(f"joined a group of {dp.world_size()} ranks, but WORLD_SIZE is "
                           f"{kwargs['world_size']}")
    print(f"process group: rank {dp.rank()} of {dp.world_size()}")
    return dp.world_size() > 1


def main() -> None:
    initialize_distributed()
    from bcosification_tpu_torch.train import main as train_main

    try:
        train_main()
    finally:
        dp.destroy_process_group()


if __name__ == "__main__":
    main()
