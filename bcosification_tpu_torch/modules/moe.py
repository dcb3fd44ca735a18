"""B-cos mixture of experts with top-k capacity-factor routing (counterpart
of ``bcosification_tpu/modules/moe.py``).

Beyond the reference, which has no MoE: the layer replaces a B-cos linear
whose output feeds a residual add, as the ViT feed-forward's projection
(``models/vit.MoEFeedForward``), and scales the parameter count with the
number of experts at a constant cost per token. It must be the last layer
before the residual: a token over capacity gets an exact-zero row, and a
B-cos linear or a LayerNorm reading it would take the inf sqrt-VJP of
||x|| = 0 (0 * inf = NaN).

Routing: the router [d, E] runs in f32, then the softmax and the top k
(ties to the lower expert, as ``jax.lax.top_k``); with k > 1 the gates are
renormalised over the chosen k (``renormalize_gates``). Under ``explain``
the gates are detached, like the B-cos dynamic scale and attention's q and
k: the layer is then the fixed linear map gate * W_e(x), with the values of
the plain forward. Assignments are ordered choice-major (GShard priority:
every first choice claims a slot before any second choice), and each
expert takes at most C = ceil(k * tokens / experts * capacity_factor) of
them in that order; the rest are dropped.

The JAX package forms the dense one-hot dispatch [assignments, E, C] and
combines by einsum. Here the slot of each assignment comes from a running
count per expert (``slot_tables``), the tokens are gathered into each
expert's [C, d] buffer and the outputs gathered back per assignment, with
the same slots. An empty slot is filled with ones, not zeros, so that its
norm's VJP stays finite. Each expert is ``ops.bcos_linear`` on its buffer
with its weight cast to the activation's dtype, so a bias-free b = 2
expert runs on the B-cos matmul kernel (K3, the linear norm). The gates are
cast to that dtype, and each token's at most k products are summed in f32
and cast once.

``record_intermediates(model)`` records what the JAX module sows (the
router's probabilities, the first choice and, with k > 1, every choice),
for ``load_balancing_loss``; outside it a BcosMoE records nothing.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple

import torch
from torch import Tensor, nn

from bcosification_tpu_torch.ops import bcos as ops

__all__ = ["BcosMoE", "Routing", "load_balancing_loss", "record_intermediates",
           "slot_tables"]


def load_balancing_loss(router_probs: Tensor, expert_idx: Tensor) -> Tensor:
    """The switch transformer's auxiliary loss E * sum_e f_e * P_e: f_e the
    share of tokens whose first choice is e, P_e the mean probability of e.
    1 at perfect balance. router_probs [N, E], expert_idx [N]."""
    num_experts = router_probs.shape[-1]
    chosen = expert_idx[:, None] == torch.arange(num_experts, device=expert_idx.device)
    f = chosen.to(router_probs.dtype).mean(0)
    return num_experts * (f * router_probs.mean(0)).sum()


class Routing(NamedTuple):
    """One call's routing. M = k * N assignments, choice-major (assignment
    j * N + n is token n's choice j); E * C slots, expert-major."""

    gates: Tensor          # [N, k] f32, renormalised for k > 1, detached under explain
    top_idx: Tensor        # [N, k] the chosen experts, most probable first
    pos_in_expert: Tensor  # [M] each assignment's place in its expert's queue
    keep: Tensor           # [M] bool: the place is below the capacity
    dest: Tensor           # [M] the slot e * C + place of a kept assignment, E * C if dropped
    slot_assign: Tensor    # [E * C] the assignment in each slot, M if the slot is empty
    capacity: int


def slot_tables(top_idx: Tensor, num_experts: int, capacity: int):
    """(pos_in_expert, keep, dest, slot_assign) of ``Routing`` for the
    choices top_idx [N, k]: each expert hands out its slots to its
    assignments in choice-major order, the JAX module's cumsum of the
    one-hot assignments."""
    n, k = top_idx.shape
    m = k * n
    idx_m = top_idx.t().reshape(m)
    # [E, M]: the running count along the contiguous axis (a scan down the
    # E columns of [M, E] runs one thread per column on the card)
    onehot = (idx_m[None, :] == torch.arange(num_experts, device=idx_m.device)[:, None]).long()
    pos_in_expert = (torch.cumsum(onehot, 1) * onehot).sum(0) - 1
    keep = pos_in_expert < capacity
    trash = num_experts * capacity
    dest = torch.where(keep, idx_m * capacity + pos_in_expert, trash)
    slot_assign = torch.full((trash + 1,), m, dtype=torch.long, device=idx_m.device)
    # each kept assignment owns its slot; every dropped one lands on the
    # trash slot, which is cut off
    slot_assign = slot_assign.scatter(0, dest, torch.arange(m, device=idx_m.device))
    return pos_in_expert, keep, dest, slot_assign[:trash]


class BcosMoE(nn.Module):
    """Top-k-routed B-cos linear experts over the last axis: router [d, E]
    (f32, N(0, 0.02)) and experts [E, d, F] (truncated normal of fan-in E *
    d, the JAX initializer's), both in the (in, out) layout of the JAX
    package. ``top_k=1`` is switch routing with the raw gate; ``top_k > 1``
    renormalises the gates unless ``renormalize_gates=False``."""

    # AGC's unit is the output axis, last in this layout (training/agc.py)
    param_unit_axes = {"router": -1, "experts": -1}

    def __init__(self, num_experts: int, in_features: int, features: int, *, b: float = 2.0,
                 capacity_factor: float = 1.25, normalize_weights: bool = True, top_k: int = 1,
                 renormalize_gates: bool = True, device=None, generator=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], got {top_k}")
        self.num_experts, self.in_features, self.features = num_experts, in_features, features
        self.b, self.capacity_factor, self.top_k = b, capacity_factor, top_k
        self.normalize_weights, self.renormalize_gates = normalize_weights, renormalize_gates
        self.router = nn.Parameter(torch.empty((in_features, num_experts), device=device))
        self.experts = nn.Parameter(torch.empty((num_experts, in_features, features),
                                                device=device))
        std = math.sqrt(1.0 / (num_experts * in_features)) / 0.87962566103423978
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=generator)
            nn.init.trunc_normal_(self.experts, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
        self.record = None  # a dict of lists while record_intermediates runs

    def capacity(self, tokens) -> int:
        """Slots per expert for ``tokens`` tokens: the JAX module's
        ceil(k * tokens / E * capacity_factor) in float, as trunc and a
        compare, which a serialized program can hold for a symbolic batch
        (math.ceil it cannot)."""
        v = self.top_k * tokens / self.num_experts * self.capacity_factor
        c = math.trunc(v)
        return torch.sym_ite(c < v, c + 1, c)

    def choose(self, probs: Tensor):
        """(gates, top_idx) [N, k]: the k most probable experts per token, the
        lower expert first on a tie; the gates renormalised for k > 1."""
        gates, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, top_idx = gates[:, :self.top_k], top_idx[:, :self.top_k]
        if self.top_k > 1 and self.renormalize_gates:
            gates = gates / gates.sum(-1, keepdim=True)
        return gates, top_idx

    def route(self, xt: Tensor, explain: bool) -> Routing:
        """The routing of the tokens xt [N, d]."""
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        gates, top_idx = self.choose(probs)
        if explain:
            gates = gates.detach()
        if self.record is not None:
            self.record.setdefault("router_probs", []).append(probs)
            self.record.setdefault("expert_idx", []).append(top_idx[:, 0])
            if self.top_k > 1:
                self.record.setdefault("top_idx", []).append(top_idx)
        capacity = self.capacity(xt.shape[0])
        return Routing(gates, top_idx, *slot_tables(top_idx, self.num_experts, capacity),
                       capacity)

    def expert_inputs(self, xt: Tensor, r: Routing) -> Tensor:
        """[E * C, d]: each slot's token, ones in an empty slot."""
        n, m = xt.shape[0], r.dest.shape[0]
        occupied = (r.slot_assign < m)[:, None]
        return torch.where(occupied, xt.index_select(0, r.slot_assign % n), xt.new_ones(()))

    def expert_inputs_t(self, ct: Tensor, r: Routing) -> Tensor:
        """The transpose of ``expert_inputs``: [N, d] from the slots'
        cotangent [E * C, d], each token's kept slots gathered and added
        (an empty slot's dropped)."""
        k, n = r.gates.shape[1], r.gates.shape[0]
        flat = torch.cat([ct, ct.new_zeros((1, ct.shape[-1]))])
        return flat.index_select(0, r.dest).view(k, n, -1).sum(0)

    def per_expert(self, t: Tensor, r: Routing):
        """The E expert blocks [C, ...] of a slot-major t [E * C, ...]."""
        c = r.capacity
        return [t[e * c:(e + 1) * c] for e in range(self.num_experts)]

    def combine(self, ye: Tensor, r: Routing) -> Tensor:
        """[N, F] in ye's dtype from the slots' outputs ye [E * C, F]: per
        token the sum over its kept choices of gate * its slot's output, the
        products in f32, cast once."""
        k, n = r.gates.shape[1], r.gates.shape[0]
        flat = torch.cat([ye, ye.new_zeros((1, ye.shape[-1]))])
        y = flat.index_select(0, r.dest).view(k, n, -1)
        g = r.gates.t().to(ye.dtype).float()
        return (g[..., None] * y.float()).sum(0).to(ye.dtype)

    def combine_t(self, ct: Tensor, r: Routing) -> Tensor:
        """The transpose of ``combine`` in the gates (detached): the slots'
        cotangent [E * C, F] from the tokens' ct [N, F]; a slot no kept
        assignment holds gets none."""
        m = r.dest.shape[0]
        g = r.gates.t().to(ct.dtype).float()
        per = (g[..., None] * ct.float()[None]).to(ct.dtype).reshape(m, -1)
        per = torch.cat([per, per.new_zeros((1, per.shape[-1]))])
        return per.index_select(0, r.slot_assign)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        lead, d = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, d)
        r = self.route(xt, explain)
        xe = self.expert_inputs(xt, r)
        w = self.experts.to(x.dtype)  # the JAX module's cast
        ye = torch.cat([ops.bcos_linear(x_e, w_e, b=self.b,
                                        normalize_weights=self.normalize_weights,
                                        explain=explain)
                        for x_e, w_e in zip(self.per_expert(xe, r), w)])
        return self.combine(ye, r).reshape(*lead, self.features)


@contextlib.contextmanager
def record_intermediates(model: nn.Module):
    """While it runs, every BcosMoE of ``model`` records per call what the
    JAX module sows: {module name: {"router_probs": [[N, E]], "expert_idx":
    [[N]] (the first choice) and, with top_k > 1, "top_idx": [[N, k]]}}. The
    records keep their graph (the auxiliary loss trains the router) until
    the context ends."""
    store: Dict[str, Dict[str, List[Tensor]]] = {}
    moes = [(name, mod) for name, mod in model.named_modules() if isinstance(mod, BcosMoE)]
    for name, mod in moes:
        mod.record = store.setdefault(name, {})
    try:
        yield store
    finally:
        for _, mod in moes:
            mod.record = None
