"""Hand-scheduled explanation pass for the standard (non-B-cos) SimpleViT
baselines: the 8 ``standard_*`` entries of ``models.pretrained.load_model``
and the ``vitc_*`` / ``simple_vit_*`` baselines of ImageNet/vit_final.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module's explanation-mode forward: the logits and W(x) = d logit[selected]
/ d x, with an explicitly written backward and no autograd, so that
``torch.export`` traces it (``serving.export_explain``). These nets have no
dynamic scale, so W is the plain input gradient of the selected logit,
except where the module itself detaches under ``explain``: the attention's
q and k, and the variance of the ViT-C stem's group norm. The backward of
each layer:

- a plain linear, with or without its bias: dx = g @ w^T, in the dtype of
  the linear's input (a biased linear promotes a bf16 input to f32 at its
  output, as the module does, so the cotangent goes back to bf16 first);
- the plain LayerNorm, undetached: dx = (c - mean(c) - y mean(c y)) / std
  with c = g * weight and y the normalised input, in f32;
- the plain GELU (erf form, ``nn.GELU``'s): g * (Phi(h) + h phi(h));
- the attention, q and k detached: dv = A^T dout per head, then through the
  v columns of to_qkv (the q and k columns get no cotangent);
- the residuals add their cotangents, the token mean spreads its cotangent
  evenly over the tokens (with ``gap_reorder`` the head runs on every token
  first), the positional embedding is a constant, the patches go back to
  the image by the inverse of the patchify;
- the ViT-C stem, segment by segment: the GELU as above, the group norm
  with its variance detached (c - mean(c) over (H, W, the group's channels),
  c = g * weight / std) and the plain biased 3x3 conv by
  ``conv_transpose2d``.

No product here is a B-cos layer, so nothing runs on a hand-written
kernel: the products stay ``torch.matmul`` and cuDNN, as the JAX package
computes them outside any Pallas kernel.

Scope (``supports``): a SimpleViT, bare or in a BcosifyNetwork, whose
linears are ``PlainLinear``, whose norms are the plain LayerNorm
(``PlainLayerNorm``), whose activation is the plain erf GELU or Identity,
with no MoE, and whose conv stem, if any, is ``PlainConv2d`` with the group
norm. ``explain/fast_vit.py`` takes the B-cos ViTs; no net is taken by
both.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _conv_t,
    _normalize,
    _selected_cotangent,
    logit_layers,
    parts,
)
from bcosification_tpu_torch.models.vit import _patchify, _unpatchify, pos_emb_sincos_2d
from bcosification_tpu_torch.modules import DetachableGELU, DetachableLayerNorm, Identity
from bcosification_tpu_torch.modules.bcos_layers import PlainConv2d, PlainLinear
from bcosification_tpu_torch.modules.norms import DetachableGroupNorm2d

__all__ = ["supports", "fast_dynamic_linear_weights"]


def _plain_linear(lin) -> bool:
    return type(lin) is PlainLinear


def _plain_norm(norm) -> bool:
    return type(norm) is DetachableLayerNorm and not norm.detachable


def _plain_act(act) -> bool:
    return type(act) is Identity or (type(act) is DetachableGELU and not act.detachable
                                     and not act.approximate)


def supports(net) -> bool:
    """True if ``net`` is a standard SimpleViT (bare or in a
    BcosifyNetwork) this pass handles."""
    from bcosification_tpu_torch.models.vit import SimpleViT

    m, _ = parts(net)
    if not isinstance(m, SimpleViT):
        return False
    stem = m.stem()
    for conv, norm, act in zip(stem[::3], stem[1::3], stem[2::3]):
        if not (type(conv) is PlainConv2d and conv.groups == 1 and conv.max_out == 1
                and conv.dilation == (1, 1) and type(norm) is DetachableGroupNorm2d
                and _plain_act(act)):
            return False
    for enc in m.encoders():
        if hasattr(enc.ff, "moe2"):
            return False
        if not (all(_plain_linear(lin) for lin in (enc.attn.to_out, enc.ff.linear1,
                                                     enc.ff.linear2))
                and all(_plain_norm(n) for n in (enc.attn.norm, enc.ff.norm))
                and _plain_act(enc.ff.act)):
            return False
    return (_plain_linear(m.to_patch_embedding_linear) and _plain_linear(m.linear_head_linear)
            and _plain_norm(m.linear_head_norm))


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, C]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast standard-ViT explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


class _Linear:
    """A plain linear (optional bias) and its transpose."""

    def __init__(self, lin, a: torch.Tensor):
        self.lin, self.a, self.dtype = lin, a, a.dtype
        self.w = lin.weight.to(a.dtype)

    def forward(self) -> torch.Tensor:
        return self.lin(self.a)

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        return ct.to(self.dtype) @ self.w.t()


class _LayerNorm:
    """The plain LayerNorm over the last axis and its full (undetached)
    transpose, in f32, back in the input's dtype."""

    def __init__(self, norm, x: torch.Tensor):
        self.norm, self.dtype = norm, x.dtype
        self.out, self.std = norm.normalize(x)
        xf = x.float()
        self.y = (xf - xf.mean(-1, keepdim=True)) / self.std

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        c = ct.float()
        if self.norm.weight is not None:
            c = c * self.norm.weight
        y = self.y
        dx = (c - c.mean(-1, keepdim=True) - y * (c * y).mean(-1, keepdim=True)) / self.std
        return dx.to(self.dtype)


def _gelu_grad(act, h: torch.Tensor):
    """d act(h) / dh of the plain erf GELU (None for Identity)."""
    if type(act) is Identity:
        return None
    return 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0))) + h * torch.exp(-0.5 * h * h) / math.sqrt(
        2.0 * math.pi)


class _StemSegment:
    """One segment of the standard ViT-C stem (plain biased 3x3 conv, group
    norm with its variance detached, activation) and its transpose."""

    def __init__(self, conv, norm: DetachableGroupNorm2d, act, x):
        self.norm, self.x_shape, self.x_dtype = norm, x.shape, x.dtype
        self.stride, self.padding = conv.stride[0], conv.padding[0]
        self.w = conv.weight.to(x.dtype)
        u = conv(x, explain=True)
        self.u_dtype = u.dtype
        h, self.std = norm.normalize(u, explain=True)
        self.dgate = _gelu_grad(act, h)
        self.out = act(h, explain=True)

    def backward(self, ct):
        if self.dgate is not None:
            ct = ct * self.dgate
        n, h, w, c = ct.shape
        g = self.norm.num_groups
        cg = ct.float()
        if self.norm.weight is not None:
            cg = cg * self.norm.weight
        cg = cg.reshape(n, h, w, g, c // g) / self.std
        cg = (cg - cg.mean(dim=(1, 2, 4), keepdim=True)).reshape(n, h, w, c)
        return _conv_t(cg.to(self.x_dtype), self.w, self.x_shape, self.stride, self.padding)


class _Encoder:
    """One encoder's explanation-mode forward and its transpose."""

    def __init__(self, enc, x):
        attn, ff = enc.attn, enc.ff
        self.attn_mod = attn
        self.norm1 = _LayerNorm(attn.norm, x)
        n1 = self.norm1.out
        self.n1_dtype = n1.dtype
        w_qkv = attn.to_qkv.weight.to(n1.dtype)
        self.w_v = w_qkv[:, 2 * attn.heads * attn.dim_head:]
        q, k, v = (attn.split_heads(t) for t in (n1 @ w_qkv).chunk(3, dim=-1))
        self.attn = attn.attend(q, k)
        o = torch.matmul(self.attn, v)
        b, h, n, d = o.shape
        self.to_out = _Linear(attn.to_out, o.transpose(1, 2).reshape(b, n, h * d))
        x = self.to_out.forward() + x
        self.norm2 = _LayerNorm(ff.norm, x)
        self.linear1 = _Linear(ff.linear1, self.norm2.out)
        h1 = self.linear1.forward()
        self.dgate = _gelu_grad(ff.act, h1)
        self.linear2 = _Linear(ff.linear2, ff.act(h1, explain=True))
        self.out = self.linear2.forward() + x

    def backward(self, ct):
        ct_a = self.linear2.backward(ct)
        if self.dgate is not None:
            ct_a = ct_a * self.dgate
        ct_x1 = ct + self.norm2.backward(self.linear1.backward(ct_a))
        ct_o = self.to_out.backward(ct_x1)
        ct_v = torch.matmul(self.attn.transpose(-1, -2),
                            self.attn_mod.split_heads(ct_o.to(self.attn.dtype)))
        b, h, n, d = ct_v.shape
        ct_n1 = ct_v.transpose(1, 2).reshape(b, n, h * d).to(self.n1_dtype) @ self.w_v.t()
        return ct_x1 + self.norm1.backward(ct_n1)


def _fast(net, x, idx):
    m, wrapper = parts(net)

    # ---------------- forward (explanation-mode values) ----------------
    x, std_in = _normalize(wrapper, x)
    x_dtype = x.dtype
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
    head_norm = _LayerNorm(m.linear_head_norm, t if m.gap_reorder else t.mean(dim=1))
    head = _Linear(m.linear_head_linear, head_norm.out)
    logits = head.forward()
    if m.gap_reorder:
        logits = logits.mean(dim=1)
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    n_tok = h * w
    if m.gap_reorder:  # the mean over the head's tokens
        ct = (ct / n_tok)[:, None, :].expand(nb, n_tok, ct.shape[-1])
    ct = head_norm.backward(head.backward(ct))
    if not m.gap_reorder:  # the token mean before the head
        ct = (ct / n_tok)[:, None, :].expand(nb, n_tok, d)
    for enc in reversed(encoders):
        ct = enc.backward(ct)
    w_in = _unpatchify(patch.backward(ct.reshape(nb, h, w, d)), p1, p2)
    for segment in reversed(segments):
        w_in = segment.backward(w_in)
    w_in = w_in.to(x_dtype)
    return logits, sel, (w_in if std_in is None else w_in / std_in)
