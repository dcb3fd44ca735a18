"""Hand-scheduled explanation pass for the B-cosified SimpleViT, the ViT's
counterpart of ``explain/fast_densenet.py``.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model: every dynamic scale, LayerNorm variance, GELU gate
and attention matrix detached) with an explicitly written linear backward
and no autograd, so that ``torch.export`` traces it
(``serving.export_explain``): an exported program cannot hold an
``autograd.grad`` call.

The forward is the module's, op for op. Each bias-free b=2 B-cos linear
(the patch embedding, to_out, linear1, linear2 and the head) runs on K3
(``bcos_matmul_fwd``, the linear norm: ``eps_outside``) and its backward on
K2 (``conv1x1_bwd_explain``) with the bare cotangent (mult 1, no mask), as
K3's explanation backward does; a BcosLinear's on its unit-normalised
weight. A biased one (``useBias``) takes the plain route both ways,
dx = (g |u + b| / n) @ w^T. The rest of the backward:

- LayerNorm, its variance detached: dx = c - mean(c), c = g w / std;
- GELU, its gate detached: g * gate;
- attention, q and k detached: dv = A^T dout per head, then through the v
  columns of to_qkv (the q and k columns get no cotangent);
- the residuals add their cotangents; the token mean spreads its cotangent
  evenly over the tokens (with ``gap_reorder`` the head runs on every token
  first); the positional embedding (where the net adds it) is a constant;
  the patches go back to the image by the inverse of the patchify, then
  through the Normalize (BcosifyNetwork's; a bare SimpleViT has none). The
  wrapper's logit layer divides the cotangent by its temperature; the
  SimpleViT's has none.

A switch-MoE feed-forward (``ff.moe2``, ``modules/moe.py``) runs the
module's routing (its gates detached) and K3 per expert on the expert's
[C, d] buffer; its transpose sends each token's cotangent times its gate to
the slots that hold it, runs K2 per expert with the bare cotangent (mult 1,
no mask) and adds the slots' cotangents back to their tokens. An empty or
a dropped slot gets no cotangent, the router none.

The ViT-C conv stem goes back segment by segment: the activation's
detached gate (GELU) or nothing (Identity); the group norm with its
variance detached, c - mean(c) over (H, W, the group's channels) with
c = g * weight / std; the 3x3 B-cos conv with its scale detached,
``conv_transpose2d`` of g * |u| / n, as ``fast_densenet`` does for its 3x3s.

Scope (``supports``): a SimpleViT, bare or in a BcosifyNetwork, with B-cos
linears (BcosifyLinear or BcosLinear, b=2, max_out 1) or b=2 switch-MoE
projections, but a plain bias-free to_qkv, the detachable LayerNorm and
GELU (or Identity), and a conv stem,
if any, of bias-free b=2 B-cos 3x3 convs with the group norm: every config
of ImageNet/vit_bcosification that builds and the ``bcos_*`` configs of
ImageNet/vit_final. The standard baselines (plain linears, the plain
LayerNorm and GELU) have no hand-written pass.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _bcos_linear,
    _conv_t,
    _Linear,
    _norm_bwd,
    _normalize,
    _selected_cotangent,
    logit_layers,
    parts,
)
from bcosification_tpu_torch.models.vit import _patchify, _unpatchify, pos_emb_sincos_2d
from bcosification_tpu_torch.modules import (
    BcosConv2d,
    DetachableGELU,
    DetachableLayerNorm,
    Identity,
)
from bcosification_tpu_torch.modules.bcos_layers import fixed_b2
from bcosification_tpu_torch.modules.norms import DetachableGroupNorm2d
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd

__all__ = ["supports", "fast_dynamic_linear_weights"]


def supports(net) -> bool:
    """True if ``net`` is a SimpleViT (bare or in a BcosifyNetwork) this
    pass handles."""
    from bcosification_tpu_torch.models.vit import SimpleViT

    m, _ = parts(net)
    if not isinstance(m, SimpleViT):
        return False
    stem = m.stem()
    for conv, norm, act in zip(stem[::3], stem[1::3], stem[2::3]):
        if not (isinstance(conv, BcosConv2d) and fixed_b2(conv) and conv.max_out == 1
                and conv.groups == 1 and conv.bias is None and conv.dilation == (1, 1)
                and type(norm) is DetachableGroupNorm2d and _detached_act(act)):
            return False
    for enc in m.encoders():
        moe = getattr(enc.ff, "moe2", None)
        linears = (enc.attn.to_out, enc.ff.linear1) + ((enc.ff.linear2,) if moe is None else ())
        if not (all(_bcos_linear(lin) for lin in linears)
                and (moe is None or fixed_b2(moe))
                and all(type(n) is DetachableLayerNorm and n.detachable
                        for n in (enc.attn.norm, enc.ff.norm))
                and _detached_act(enc.ff.act)):
            return False
    return (_bcos_linear(m.to_patch_embedding_linear) and _bcos_linear(m.linear_head_linear)
            and type(m.linear_head_norm) is DetachableLayerNorm
            and m.linear_head_norm.detachable)


def _detached_act(act) -> bool:
    return type(act) is Identity or (type(act) is DetachableGELU and act.detachable)


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, C]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast ViT explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


class _StemSegment:
    """One segment of the ViT-C stem (3x3 B-cos conv, group norm,
    activation): its explanation-mode forward and the transpose of its map."""

    def __init__(self, conv: BcosConv2d, norm: DetachableGroupNorm2d, act, x):
        self.norm, self.x_shape, self.dtype = norm, x.shape, x.dtype
        self.stride, self.padding = conv.stride, conv.padding
        self.w = conv.effective_weight().to(x.dtype)
        u = ops.conv2d(x, self.w, self.stride, self.padding)
        n = ops.patch_norms(x, conv.kernel_size, stride=self.stride,
                            padding=self.padding).to(u.dtype)
        self.scale = u.abs() / n  # the detached dynamic scale
        h, self.std = norm.normalize(self.scale * u, explain=True)
        self.gate = act.gate(h) if isinstance(act, DetachableGELU) else None
        self.out = h if self.gate is None else self.gate * h

    def backward(self, ct):
        if self.gate is not None:
            ct = ct * self.gate
        n, h, w, c = ct.shape
        g = self.norm.num_groups
        cg = ct.float()
        if self.norm.weight is not None:
            cg = cg * self.norm.weight
        cg = cg.reshape(n, h, w, g, c // g) / self.std
        cg = (cg - cg.mean(dim=(1, 2, 4), keepdim=True)).reshape(n, h, w, c)
        ct_u = cg.to(self.dtype) * self.scale
        return _conv_t(ct_u, self.w, self.x_shape, self.stride[0], self.padding[0])


class _Encoder:
    """One encoder's explanation-mode forward and the transpose of its map."""

    def __init__(self, enc, x):
        self.enc, self.dtype = enc, x.dtype
        attn, ff = enc.attn, enc.ff
        n1, self.std1 = attn.norm.normalize(x, explain=True)
        w_qkv = attn.to_qkv.weight.to(x.dtype)
        self.w_v = w_qkv[:, 2 * attn.heads * attn.dim_head:]
        q, k, v = (attn.split_heads(t) for t in (n1 @ w_qkv).chunk(3, dim=-1))
        self.attn = attn.attend(q, k)
        o = torch.matmul(self.attn, v)
        b, h, n, d = o.shape
        self.to_out = _Linear(attn.to_out, o.transpose(1, 2).reshape(b, n, h * d))
        x = self.to_out.forward() + x
        n2, self.std2 = ff.norm.normalize(x, explain=True)
        self.linear1 = _Linear(ff.linear1, n2)
        h1 = self.linear1.forward()
        self.gate = ff.act.gate(h1) if isinstance(ff.act, DetachableGELU) else None
        a = h1 if self.gate is None else self.gate * h1
        self.linear2 = _MoE(ff.moe2, a) if hasattr(ff, "moe2") else _Linear(ff.linear2, a)
        self.out = self.linear2.forward() + x

    def backward(self, ct):
        attn = self.enc.attn
        ct_a = self.linear2.backward(ct)
        if self.gate is not None:
            ct_a = ct_a * self.gate
        ct_x1 = ct + _norm_bwd(self.linear1.backward(ct_a), self.enc.ff.norm, self.std2,
                               self.dtype)
        ct_o = self.to_out.backward(ct_x1)
        ct_v = torch.matmul(self.attn.transpose(-1, -2), attn.split_heads(ct_o))
        b, h, n, d = ct_v.shape
        ct_n1 = ct_v.transpose(1, 2).reshape(b, n, h * d) @ self.w_v.t()
        return ct_x1 + _norm_bwd(ct_n1, attn.norm, self.std1, self.dtype)


class _MoE:
    """A switch MoE's explanation-mode forward and transpose (the
    ``_Linear`` interface): the module's routing, gates detached; K3 forward
    and K2 backward per expert on its slots."""

    def __init__(self, moe, a):
        self.moe, self.lead = moe, a.shape[:-1]
        xt = a.reshape(-1, a.shape[-1])
        self.routing = moe.route(xt, explain=True)
        self.xe = moe.expert_inputs(xt, self.routing)
        w = moe.experts.to(a.dtype)  # cast, then normalised, as the module does
        self.wt = [(ops.normed_linear_weight(w_e) if moe.normalize_weights else w_e)
                   .t().contiguous() for w_e in w]

    def forward(self) -> torch.Tensor:
        ye = torch.cat([
            bcos_matmul_fwd(x_e, wt, eps=ops.LINEAR_NORM_EPS, eps_outside=True).to(x_e.dtype)
            for x_e, wt in zip(self.moe.per_expert(self.xe, self.routing), self.wt)])
        return self.moe.combine(ye, self.routing).view(*self.lead, -1)

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        ct_slots = self.moe.combine_t(ct.reshape(-1, ct.shape[-1]).to(self.xe.dtype),
                                      self.routing)
        per_expert = self.moe.per_expert
        dx = torch.cat([
            conv1x1_bwd_explain(x_e, wt, ct_e.contiguous(), None, None, relu=False,
                                eps=ops.LINEAR_NORM_EPS, eps_outside=True)
            for x_e, wt, ct_e in zip(per_expert(self.xe, self.routing), self.wt,
                                     per_expert(ct_slots, self.routing))])
        return self.moe.expert_inputs_t(dx, self.routing).view(*self.lead, -1)


def _fast(net, x, idx):
    m, wrapper = parts(net)

    # ---------------- forward (explanation-mode values) ----------------
    x, std_in = _normalize(wrapper, x)
    stem = m.stem()
    segments = []
    for conv, norm, act in zip(stem[::3], stem[1::3], stem[2::3]):
        segments.append(_StemSegment(conv, norm, act, x))
        x = segments[-1].out
    p1, p2 = m.patch_size
    patch = _Linear(m.to_patch_embedding_linear, _patchify(x, p1, p2))
    t = patch.forward()
    nb, h, w, d = t.shape
    t = t.reshape(nb, h * w, d)
    if m.pos_embedding:
        t = t + pos_emb_sincos_2d(h, w, d, dtype=t.dtype, device=t.device)
    encoders = []
    for enc in m.encoders():
        encoders.append(_Encoder(enc, t))
        t = encoders[-1].out
    hn = t if m.gap_reorder else t.mean(dim=1)
    t_dtype = t.dtype  # x's, or f32 after a biased patch embedding
    hn, std_h = m.linear_head_norm.normalize(hn, explain=True)
    head = _Linear(m.linear_head_linear, hn)
    logits = head.forward()
    if m.gap_reorder:
        logits = logits.mean(dim=1)
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit linear transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    n_tok = h * w
    if m.gap_reorder:  # the mean over the head's tokens
        ct = (ct / n_tok)[:, None, :].expand(nb, n_tok, ct.shape[-1])
    ct = _norm_bwd(head.backward(ct), m.linear_head_norm, std_h, t_dtype)
    if not m.gap_reorder:  # the token mean before the head
        ct = (ct / n_tok)[:, None, :].expand(nb, n_tok, d)
    for enc in reversed(encoders):
        ct = enc.backward(ct)
    w_in = _unpatchify(patch.backward(ct.reshape(nb, h, w, d)), p1, p2)
    for segment in reversed(segments):
        w_in = segment.backward(w_in)
    return logits, sel, (w_in if std_in is None else w_in / std_in)
