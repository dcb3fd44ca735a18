"""Hand-scheduled explanation pass for the B-cosified CLIP ViT image tower
(``BcosifyNetwork(CLIPVisionTransformer)``, the ViT student of
ImageNet/clip_bcosification): the text-grounded explanation with the
contract of ``explain/fast_clip.py``, written out without autograd, since
``torch.export`` cannot hold ``torch.autograd.grad`` (fault C3).

The forward is the module's, op for op, in explanation mode. Each b=2 B-cos
linear (out_proj, c_fc and c_proj of every block) runs on K3
(``bcos_matmul_fwd``, the linear norm: ``eps_outside``) and its backward on
K2 (``conv1x1_bwd_explain``) with the bare cotangent, through the step
``_Linear`` that ``fast_vit`` uses. The rest of the backward:

- QuickGELU, its gate detached: g * gate;
- each CLIPLayerNorm with its variance detached: c - mean(c), c = g w / std
  (``_norm_bwd``);
- attention, q and k detached: dv = A^T dout per head, then through the v
  columns of the plain ``attn_in_proj`` (q and k get no cotangent);
- the head: the class token's ln_post and ``proj``, or with ``unpool`` every
  other token's, divided by the detached norm of its feature;
- the class token and the positional embedding are constants; the patch
  tokens go back through the patchify conv's transpose with its dynamic
  scale detached (``_Conv``), then through the Normalize.

A bf16 batch stays bf16 only up to the first q/k/v projection: its bias (the
student's is zeroed, not removed) promotes the residual stream to f32, as in
the JAX package and the module path, so every B-cos linear then takes K3's
and K2's fp32 route.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from bcosification_tpu_torch.clip.model import _promoted
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _bcos_linear,
    _Conv,
    _Linear,
    _norm_bwd,
    _normalize,
    parts,
)
from bcosification_tpu_torch.explain.fast_clip import text_scores_and_w

__all__ = ["supports", "fast_encode_and_vjp", "fast_text_dlw"]


def supports(net) -> bool:
    """True for BcosifyNetwork(CLIPVisionTransformer) in the CLIP ViT recipe:
    a bias-free b=2 B-cos patchify conv, b=2 B-cos out_proj / c_fc / c_proj,
    the gate-detaching QuickGELU and the plain q/k/v projection, with no
    logit layer."""
    from bcosification_tpu_torch.clip.model import CLIPVisionTransformer, QuickGELU
    from bcosification_tpu_torch.modules import BcosConv2d, PlainLinear
    from bcosification_tpu_torch.modules.bcos_layers import fixed_b2

    m, wrapper = parts(net)
    if (wrapper is None or wrapper.with_logit_layer
            or not isinstance(m, CLIPVisionTransformer)):
        return False
    conv = m.conv1
    if not (isinstance(conv, BcosConv2d) and fixed_b2(conv) and conv.max_out == 1
            and conv.groups == 1 and conv.bias is None and conv.dilation == (1, 1)):
        return False
    return all(
        not blk.causal and isinstance(blk.attn_in_proj, PlainLinear)
        and all(_bcos_linear(lin) for lin in (blk.attn_out_proj, blk.mlp_c_fc, blk.mlp_c_proj))
        and type(blk.mlp_gelu) is QuickGELU and blk.mlp_gelu.detach_gate
        for blk in m.blocks())


class _Block:
    """One residual block's explanation-mode forward and the transpose of
    its map."""

    def __init__(self, blk, x):
        self.blk, self.dtype = blk, x.dtype
        n1, self.std1 = blk.ln_1.normalize(x, explain=True)
        d = x.shape[-1]
        q, k, v = blk.attn_in_proj(n1).split(d, dim=-1)
        self.n1_dtype = n1.dtype
        self.w_v = blk.attn_in_proj.weight[:, 2 * d:].to(n1.dtype)
        self.attn = blk.attend(q, k)
        self.out_proj = _Linear(blk.attn_out_proj, blk.mix(self.attn, v))
        x = x + self.out_proj.forward()
        self.x1_dtype = x.dtype
        n2, self.std2 = blk.ln_2.normalize(x, explain=True)
        self.c_fc = _Linear(blk.mlp_c_fc, n2)
        h = self.c_fc.forward()
        self.gate = blk.mlp_gelu.gate(h)
        self.c_proj = _Linear(blk.mlp_c_proj, h * self.gate)
        self.out = x + self.c_proj.forward()

    def backward(self, ct):
        blk = self.blk
        ct_h = self.c_proj.backward(ct) * self.gate
        ct_x1 = ct + _norm_bwd(self.c_fc.backward(ct_h), blk.ln_2, self.std2, self.x1_dtype)
        ct_o = self.out_proj.backward(ct_x1)
        ct_v = blk.mix(self.attn.transpose(-1, -2), ct_o.to(self.attn.dtype))
        ct_n1 = ct_v.to(self.n1_dtype) @ self.w_v.t()
        return ct_x1 + _norm_bwd(ct_n1, blk.ln_1, self.std1, self.dtype)


def _encode(net, x):
    m, wrapper = parts(net)
    x, std_in = _normalize(wrapper, x)
    patch = _Conv(m.conv1, x)
    u = patch.forward()
    nb, h, w, c = u.shape
    tok = u.reshape(nb, h * w, c)
    cls = m.class_embedding.to(tok.dtype).expand(nb, 1, c)
    t = torch.cat([cls, tok], dim=1) + m.positional_embedding.to(tok.dtype)
    tok_dtype = t.dtype
    t, std_pre = m.ln_pre.normalize(t, explain=True)
    blocks = []
    for blk in m.blocks():
        blocks.append(_Block(blk, t))
        t = blocks[-1].out
    x_dtype = t.dtype
    rows = t[:, 1:] if m.unpool else t[:, :1]
    rows, std_post = m.ln_post.normalize(rows, explain=True)
    proj = m.proj
    out = _promoted(rows, proj) @ proj
    if m.unpool:
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        feats = out / norm
    else:
        feats = out[:, 0]

    def vjp(ct_feats: torch.Tensor) -> torch.Tensor:
        ct = ct_feats.to(feats.dtype)
        ct = ct / norm if m.unpool else ct[:, None]
        ct_rows = (ct @ proj.t()).to(rows.dtype)
        ct_rows = _norm_bwd(ct_rows, m.ln_post, std_post, x_dtype)
        rest = ct_rows.new_zeros((nb, 1 if m.unpool else h * w, c))
        ct_t = torch.cat([rest, ct_rows] if m.unpool else [ct_rows, rest], dim=1)
        for block in reversed(blocks):
            ct_t = block.backward(ct_t)
        ct_t = _norm_bwd(ct_t, m.ln_pre, std_pre, tok_dtype)
        ct_u = ct_t[:, 1:].reshape(nb, h, w, c)
        ct_x = patch.backward(ct_u)
        return ct_x if std_in is None else ct_x / std_in

    return feats, vjp


def _resolve(net, x, device):
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast CLIP ViT explain pass: unsupported model (see supports())")
    return x.to(dev)


def fast_encode_and_vjp(net, x: torch.Tensor, *, device=None
                        ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """(features, vjp) with features the explain-mode encode of x
    [N, S, S, 6] ([N, D] pooled, [N, HW, D] unpooled) and vjp(ct) =
    d(features . ct) / dx, the backward written out. Runs on ``device``
    (default the GPU; raises without one unless device="cpu")."""
    x = _resolve(net, x, device)
    with torch.no_grad():
        feats, vjp = _encode(net, x)

    def grad_free_vjp(ct_feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return vjp(ct_feats)

    return feats, grad_free_vjp


def fast_text_dlw(net, x: torch.Tensor, t: torch.Tensor, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [N], W like x): scores = ``fast_clip.text_score_head`` of the
    explain-mode features of x and the text embedding t, W = d scores / dx
    (the rows are independent: one backward gives each image's W)."""
    x = _resolve(net, x, device)
    with torch.no_grad():  # one grad-free region: torch.export keeps it whole
        return text_scores_and_w(*_encode(net, x), t)
