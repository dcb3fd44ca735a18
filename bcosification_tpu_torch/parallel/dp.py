"""Data parallelism across processes: the data-parallel half of
``bcosification_tpu/parallel/mesh.py``.

In the JAX package one jitted program runs over a mesh whose 'data' axis
shards the batch, and XLA's partitioner makes it compute exactly what one
device computes on the global batch. In the port one process drives one
card, so the mesh's data axis becomes the process group (``torch.distributed``:
NCCL between cards, gloo on the CPU), and the global-batch semantics are
kept by hand:

- ``shard_batch``: every rank draws the identical global batch and takes its
  own block of rows (the JAX default path); ``shard_batch_local``: on the
  split paths (``data.split_by_process``, ``data.split_shards_by_process``)
  the loader's batch is already this rank's slice;
- ``all_reduce_sum``: a differentiable sum over the ranks, which the
  batch-statistics norms use for their moments (``modules/norms.py``), so
  train-mode statistics are those of the global batch;
- ``average_gradients``: the mean of the ranks' gradients, one all-reduce
  per dtype over a flat buffer (``training/steps.py``): with equal rows per
  rank it is the gradient of the global batch's mean loss;
- ``all_gather`` (its backward the reduce-scatter that the JAX
  ``all_gather``'s VJP is) and ``ring_exchange`` / ``ring_exchange_bidir``
  (point-to-point hops whose backward sends the gradient back the other
  way, as the transpose of JAX's ``ppermute`` does), which the contrastive
  losses use (``losses.py``).

Without a group every function is the one-process identity: rank 0 of
world 1, the batch whole, the sums and gathers the tensor itself. In a
group of one (``torchrun --nproc_per_node=1``) the collectives run, each
the identity, so one card exercises the data-parallel path.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from bcosification_tpu_torch.device import resolve_device

__all__ = [
    "ENV_CONTRACT",
    "init_process_group",
    "destroy_process_group",
    "is_initialized",
    "rank",
    "world_size",
    "is_main_process",
    "barrier",
    "rows",
    "shard_batch",
    "shard_batch_local",
    "replicate",
    "all_reduce_sum",
    "reduce_sum_",
    "all_gather",
    "average_gradients",
    "ring_exchange",
    "ring_exchange_bidir",
]

# the torchrun env contract (MASTER_PORT defaults to 29500, LOCAL_RANK to RANK)
ENV_CONTRACT = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
DEFAULT_PORT = "29500"


def init_process_group(device=None, *, rank: Optional[int] = None,
                       world_size: Optional[int] = None, init_method: Optional[str] = None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank``, ``world_size`` and ``init_method`` default to the env contract:
    ``RANK``, ``WORLD_SIZE`` and ``tcp://MASTER_ADDR:MASTER_PORT``. A CUDA
    ``device`` (the default) takes NCCL and ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
    defaults to the rank), made current; ``"cpu"`` takes gloo."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(env.get("LOCAL_RANK", rank))
        dev = resolve_device(torch.device("cuda", index))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return dev


def destroy_process_group() -> None:
    """Leave the group, if any (a later group may then be started)."""
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """True on the rank that owns all file output: checkpoints, metrics,
    event logs, explanation logs (JAX ``mesh.is_main_process``)."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def rows(n: int) -> Optional[slice]:
    """This rank's block of a batch axis of length ``n`` (block r of W equal
    blocks, as the JAX data sharding places it), or None when W does not
    divide ``n`` (the leaf stays whole on every rank)."""
    w = world_size()
    if n % w:
        return None
    per = n // w
    return slice(rank() * per, (rank() + 1) * per)


def shard_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of each leaf of the global batch ``batch``; a leaf
    whose batch axis W does not divide (the ragged last evaluation batch)
    stays whole, as JAX places it replicated."""
    if world_size() == 1:
        return batch
    out = {}
    for k, v in batch.items():
        s = rows(len(v)) if getattr(v, "ndim", 0) else None
        out[k] = v if s is None else v[s]
    return out


def shard_batch_local(batch: Dict[str, Any]) -> Dict[str, Any]:
    """On the split paths the loader's batch already is this rank's slice
    of the global batch (JAX ``shard_batch_local``): nothing to take."""
    return batch


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if is_initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the same sum: its gradient is the sum of theirs
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (the backward sums the
    ranks' cotangents); ``x`` itself without a group."""
    return _AllReduceSum.apply(x) if is_initialized() else x


@torch.no_grad()
def reduce_sum_(*tensors: torch.Tensor) -> None:
    """In-place sums over the ranks of metric tensors (no gradient), one
    all-reduce for all of them."""
    if not is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(flat)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        x = x.contiguous()
        ctx.dim, ctx.n = dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # the reduce-scatter: the ranks' cotangents summed, this rank's block kept
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g.narrow(ctx.dim, dist.get_rank() * ctx.n, ctx.n), None


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX
    ``all_gather(tiled=True)``), differentiable: the backward sums the
    ranks' cotangents and keeps this rank's block."""
    return _AllGather.apply(x, dim) if is_initialized() else x


@torch.no_grad()
def average_gradients(grads: Iterable[Optional[torch.Tensor]]) -> None:
    """Replace each gradient (None skipped) by its mean over the ranks, in
    place: one all-reduce per dtype over a flat buffer. Every rank must pass
    the same gradients in the same order (the same model on the same batch
    structure)."""
    if not is_initialized():
        return
    w = world_size()
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat.div_(w)
        i = 0
        for g in group:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


# --------------------------------------------------------------------------
# the ring: one hop to a neighbour, and its transpose
# --------------------------------------------------------------------------
_RIGHT, _LEFT = 0, 1  # message tags: gloo matches them; NCCL keeps the order


def _neighbours() -> Tuple[int, int]:
    r, w = dist.get_rank(), dist.get_world_size()
    return (r - 1) % w, (r + 1) % w


def _hop(to_left: Optional[torch.Tensor], to_right: Optional[torch.Tensor]):
    """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1 (either may
    be None); returns (from the right, from the left), the tensors the
    neighbours sent this way (None where they sent none). The sends go out
    before the receives are posted, in one batch, leftward first, so a ring
    of two (left == right) still matches each message with its receive."""
    left, right = _neighbours()
    ops, from_right, from_left = [], None, None
    if to_left is not None:
        ops.append(dist.P2POp(dist.isend, to_left.contiguous(), left, tag=_LEFT))
    if to_right is not None:
        ops.append(dist.P2POp(dist.isend, to_right.contiguous(), right, tag=_RIGHT))
    if to_left is not None:  # the right neighbour sends its to_left to us
        from_right = torch.empty_like(to_left)
        ops.append(dist.P2POp(dist.irecv, from_right, right, tag=_LEFT))
    if to_right is not None:
        from_left = torch.empty_like(to_right)
        ops.append(dist.P2POp(dist.irecv, from_left, left, tag=_RIGHT))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_right, from_left


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, right: bool):
        ctx.right = right
        from_right, from_left = _hop(None if right else x, x if right else None)
        return from_left if right else from_right

    @staticmethod
    def backward(ctx, g):
        # the transpose sends the cotangent back to the rank it came from
        g = g.contiguous()
        from_right, from_left = _hop(g if ctx.right else None, None if ctx.right else g)
        return (from_right if ctx.right else from_left), None


class _RingExchangeBidir(torch.autograd.Function):
    @staticmethod
    def forward(ctx, to_left, to_right):
        return _hop(to_left, to_right)

    @staticmethod
    def backward(ctx, g_from_right, g_from_left):
        g_from_right = _zeros_if_none(g_from_right, g_from_left)
        g_from_left = _zeros_if_none(g_from_left, g_from_right)
        # each cotangent goes back to the rank its tensor came from; our
        # to_left became the left neighbour's from_right, so its cotangent
        # comes back from the left, and our to_right's from the right
        g_to_right, g_to_left = _hop(g_from_left.contiguous(), g_from_right.contiguous())
        return g_to_left, g_to_right


def ring_exchange(x: torch.Tensor, direction: str = "right") -> torch.Tensor:
    """One hop around the ring of ranks: "right" sends ``x`` to rank + 1, so
    each rank receives its left neighbour's tensor ("left": the other way).
    Differentiable: the backward sends the cotangent the opposite way."""
    if direction not in ("right", "left"):
        raise ValueError(f"direction must be 'right' or 'left', got {direction!r}")
    return _RingExchange.apply(x, direction == "right")


def ring_exchange_bidir(to_left: torch.Tensor, to_right: torch.Tensor):
    """Both hops at once: ``to_left`` to rank - 1, ``to_right`` to rank + 1;
    returns (from the right, from the left). Differentiable."""
    return _RingExchangeBidir.apply(to_left, to_right)
