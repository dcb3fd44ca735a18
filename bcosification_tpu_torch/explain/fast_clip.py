"""Hand-scheduled explanation pass for the B-cosified CLIP-RN50 image tower
(counterpart of ``bcosification_tpu/explain/fast_clip.py``): the
text-grounded explanation of the text-localisation workload.

It computes the explanation-mode features of the tower and their linear
backward, written out without autograd (``torch.export`` cannot hold
``torch.autograd.grad``, fault C3), in the style of ``fast_resnet``:

- the trunk: the three 3x3 stem segments on cuDNN with the patch norms of
  ``ops/bcos.py``, the 2x2 avg-pool, then the anti-aliased bottlenecks.
  Every 1x1 conv of a bottleneck has stride 1 (conv1, conv3 after the
  avg-pool, the downsample after its avg-pool), so each 1x1 + BN (+ ReLU)
  segment runs on K1 (``bcos_conv1x1_fwd``) forward and on K2
  (``bcos_conv1x1_bwd_explain``, which recomputes u) backward. The 3x3
  segments' backward rebuilds the dynamic scale from the segment output,
  as ``fast_resnet`` does; the avg-pools' transpose spreads each
  cotangent over its window.
- the head, differentiated by hand. Pooled (``BcosAttentionPool2d``): q and
  k are detached in explanation mode, so the attention weights are
  constants and the head is linear in the tokens through v_proj and the
  plain, weight-only c_proj. ``attn_unpool``: v_proj, the B-cos c_proj
  (K3 forward and K2 backward with the linear norm, ``eps_outside``),
  then the division by the detached norm of each location's feature.
- ``text_score_head``: the cosine of the features (per location, then the
  mean over locations, for attn-unpool features) with a text embedding t;
  its normalisation is differentiated, not detached.

The values are those of the explain-mode module forward up to rounding
(the module runs each 1x1 conv on K3 and its BN apart), and W is
d score / d x: ``tests/test_torch_clip.py`` holds both against the JAX
pass and the port's autograd.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _BN,
    _conv_t,
    _flat,
    _seg_bwd,
    _seg_fwd,
    _weight,
    _wt,
    plain_b2_layers,
)
from bcosification_tpu_torch.modules.bcosattnpool import _attention, _heads
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain, conv1x1_fwd

__all__ = ["supports", "fast_encode_and_vjp", "text_score_head", "fast_text_dlw"]


def supports(net) -> bool:
    """True for BcosifyNetwork(ModifiedResNet) in the CLIP recipe: a b=2
    BcosifyConv2d trunk without conv biases, uncentered BNs, ReLUs and the
    B-cos attention pool (pooled or attn-unpool) with a b=2 BcosifyLinear
    c_proj."""
    from bcosification_tpu_torch.clip.model import ModifiedResNet
    from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork
    from bcosification_tpu_torch.modules import BcosifyConv2d, BcosifyLinear, PlainReLU

    if not isinstance(net, BcosifyNetwork) or not isinstance(net.model, ModifiedResNet):
        return False
    m = net.model
    if m.attnpool_kind not in ("bcos", "bcos_unpool") or net.with_logit_layer:
        return False
    if plain_b2_layers(m) != 0 or not isinstance(m.conv1, BcosifyConv2d):
        return False
    c_proj = m.attnpool.c_proj
    return (isinstance(m.relu1, PlainReLU) and isinstance(c_proj, BcosifyLinear)
            and c_proj.b == 2 and c_proj.max_out == 1)


def _pool_t(ct: torch.Tensor, shape, k: int) -> torch.Tensor:
    """Transpose of the k x k, stride-k avg-pool of an input of ``shape``:
    each cotangent spread over its window, divided by k^2; the rows and
    columns that the pool's floor leaves out get zeros."""
    n, h, w, c = ct.shape
    up = ct[:, :, None, :, None, :].expand(n, h, k, w, k, c).reshape(n, h * k, w * k, c)
    up = up / (k * k)
    if (h * k, w * k) != tuple(shape[1:3]):
        up = F.pad(up, (0, 0, 0, shape[2] - w * k, 0, shape[1] - h * k))
    return up


def _block_fwd(blk, a, dtype):
    """One anti-aliased bottleneck in explanation mode: (out, the record the
    backward needs)."""
    stride, nb, h, w_ = blk.stride, *a.shape[:3]
    rec = {"in": a, "stride": stride, "has_ds": blk.has_downsample,
           "wt1": _wt(blk.conv1, dtype), "bn1": _BN(blk.bn1),
           "w2": _weight(blk.conv2, dtype), "bn2": _BN(blk.bn2),
           "wt3": _wt(blk.conv3, dtype), "bn3": _BN(blk.bn3)}
    c1 = conv1x1_fwd(_flat(a), rec["wt1"], rec["bn1"].mult, rec["bn1"].add, relu=True)
    c1 = c1.view(nb, h, w_, -1)
    rec["n2"] = ops.patch_norms(c1, 3, stride=1, padding=1).to(dtype)
    c2 = _seg_fwd(ops.conv2d(c1, rec["w2"], 1, 1), rec["n2"], rec["bn2"], True)
    c2p = pooling.avg_pool2d(c2, stride, stride) if stride > 1 else c2.contiguous()
    y3 = conv1x1_fwd(_flat(c2p), rec["wt3"], rec["bn3"].mult, rec["bn3"].add, relu=False)
    y3 = y3.view(c2p.shape[:3] + (-1,))
    identity = a
    if blk.has_downsample:
        idp = pooling.avg_pool2d(a, stride, stride) if stride > 1 else a
        rec.update(idp=idp, wt_ds=_wt(blk.downsample_conv, dtype),
                   bn_ds=_BN(blk.downsample_norm))
        identity = conv1x1_fwd(_flat(idp), rec["wt_ds"], rec["bn_ds"].mult, rec["bn_ds"].add,
                               relu=False).view(y3.shape)
    out = torch.relu(y3 + identity)
    rec.update(c1=c1, c2=c2, c2p=c2p, out=out)
    return out, rec


def _block_bwd(rec, ct_a):
    """Cotangent of a block's input from that of its output."""
    stride, a_in, c1, c2, c2p = rec["stride"], rec["in"], rec["c1"], rec["c2"], rec["c2p"]
    ct_m = torch.where(rec["out"] > 0, ct_a, torch.zeros_like(ct_a))
    ct_m2 = _flat(ct_m)
    ct_c2 = conv1x1_bwd_explain(_flat(c2p), rec["wt3"], ct_m2, None, rec["bn3"].mult,
                                relu=False).view(c2p.shape)
    if stride > 1:
        ct_c2 = _pool_t(ct_c2, c2.shape, stride)
    ct_u2 = _seg_bwd(ct_c2, c2, rec["n2"], rec["bn2"], True)
    ct_c1 = _conv_t(ct_u2, rec["w2"], c1.shape, 1, 1)
    ct_in = conv1x1_bwd_explain(_flat(a_in), rec["wt1"], _flat(ct_c1), _flat(c1),
                                rec["bn1"].mult, relu=True).view(a_in.shape)
    if not rec["has_ds"]:
        return ct_in + ct_m
    idp = rec["idp"]
    ct_idp = conv1x1_bwd_explain(_flat(idp), rec["wt_ds"], ct_m2, None, rec["bn_ds"].mult,
                                 relu=False).view(idp.shape)
    return ct_in + (_pool_t(ct_idp, a_in.shape, stride) if stride > 1 else ct_idp)


def _head(pool, a):
    """The B-cos attention pool in explanation mode: (features, its linear
    backward ct_features -> ct_a)."""
    nb, h, w_, c = a.shape
    dtype = a.dtype
    seq = a.reshape(nb, h * w_, c)
    wv = pool.v_proj.weight.to(dtype)
    if pool.attn_unpool:
        v = pool.v_proj(seq)
        y = pool.c_proj(v, explain=True)
        norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        c_proj = pool.c_proj
        wc = c_proj.weight

        def head_bwd(ct_feats):
            ct_y = _flat(ct_feats / norm)
            v2 = _flat(v)
            if c_proj.bias is None:  # K2 with the linear norm (K3 ran forward)
                wt = wc.t().to(dtype).contiguous()
                ct_v = conv1x1_bwd_explain(v2, wt, ct_y.to(dtype), None, None, relu=False,
                                           eps=ops.LINEAR_NORM_EPS, eps_outside=True)
            else:  # the plain B-cos linear's scale |u| / n, u with the bias
                u = v2 @ wc.to(dtype) + c_proj.bias
                vf = v2.float()
                n = (torch.sqrt((vf * vf).sum(-1, keepdim=True))
                     + ops.LINEAR_NORM_EPS).to(u.dtype)
                ct_v = ((ct_y * (u.abs() / n)).to(dtype) @ wc.to(dtype).t())
            return (ct_v @ wv.t()).view(a.shape)

        return y / norm, head_bwd

    seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
    q = pool.q_proj(seq[:, :1], weight_only=True)
    k = pool.k_proj(seq, weight_only=True)
    v = pool.v_proj(seq, weight_only=True)
    heads = pool.num_heads
    attn = _attention(q, k, heads)  # [B, heads, 1, HW + 1], constant in explanation mode
    o = torch.einsum("bhnm,bhmd->bhnd", attn, _heads(v, heads)).transpose(1, 2)
    wc = pool.c_proj.weight.to(dtype)
    feats = (o.reshape(nb, 1, c) @ wc)[:, 0]

    def head_bwd(ct_feats):
        ct_o = _heads((ct_feats @ wc.t())[:, None, :], heads)  # [B, heads, 1, dh]
        ct_v = torch.einsum("bhnm,bhnd->bhmd", attn, ct_o).transpose(1, 2).reshape(nb, -1, c)
        ct_seq = ct_v @ wv.t()
        return (ct_seq[:, 1:] + ct_seq[:, :1] / (h * w_)).reshape(a.shape)

    return feats, head_bwd


def _resolve(net, x, device):
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast CLIP explain pass: unsupported model (see supports())")
    return x.to(dev)


def fast_encode_and_vjp(net, x: torch.Tensor, *, device=None
                        ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """(features, vjp) with features the explain-mode encode of x
    [N, S, S, 6] ([N, D] pooled, [N, HW, D] attn-unpool) and vjp(ct) =
    d(features . ct) / dx, the backward written out. Runs on ``device``
    (default the GPU; raises without one unless device="cpu")."""
    x = _resolve(net, x, device)
    with torch.no_grad():
        feats, vjp = _encode(net, x)

    def grad_free_vjp(ct_feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return vjp(ct_feats)

    return feats, grad_free_vjp


def _encode(net, x):
    m = net.model
    dtype = x.dtype
    mean = torch.tensor(net.mean, dtype=dtype, device=x.device)
    std_in = torch.tensor(net.std, dtype=dtype, device=x.device)
    a = (x - mean) / std_in
    stem = []
    for conv, bn, _, stride in m.stem():
        rec = {"in": a, "w": _weight(conv, dtype), "bn": _BN(bn), "stride": stride,
               "n": ops.patch_norms(a, 3, stride=stride, padding=1).to(dtype)}
        a = _seg_fwd(ops.conv2d(a, rec["w"], stride, 1), rec["n"], rec["bn"], True)
        rec["z"] = a
        stem.append(rec)
    z_stem = a
    a = pooling.avg_pool2d(a, 2, 2)
    recs = []
    for blk in m.blocks():
        a, rec = _block_fwd(blk, a, dtype)
        recs.append(rec)
    feats, head_bwd = _head(m.attnpool, a)

    def vjp(ct_feats: torch.Tensor) -> torch.Tensor:
        ct = head_bwd(ct_feats.to(feats.dtype))
        for rec in reversed(recs):
            ct = _block_bwd(rec, ct)
        ct = _pool_t(ct, z_stem.shape, 2)
        for rec in reversed(stem):
            ct_u = _seg_bwd(ct, rec["z"], rec["n"], rec["bn"], True)
            ct = _conv_t(ct_u, rec["w"], rec["in"].shape, rec["stride"], 1)
        return ct / std_in

    return feats, vjp


def _cosine(feats: torch.Tensor, t: torch.Tensor):
    """(feats / ||feats||, ||feats||, the per-sample score)."""
    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    f = feats / norm
    s = f @ t.to(feats.dtype)
    return f, norm, (s.mean(dim=-1) if feats.dim() == 3 else s)


def text_score_head(feats: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample text-grounded score (the reference's default,
    pool_cosine=1): the cosine of the features with t, per location for
    attn-unpool features [B, HW, D] and then their mean over locations. The
    normalisation is part of the function, so its gradient flows through
    it."""
    return _cosine(feats, t)[2]


def fast_text_dlw(net, x: torch.Tensor, t: torch.Tensor, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [N], W like x): scores = text_score_head(features(x), t) in
    explanation mode and W = d scores / dx (the batch rows are independent,
    so one backward of a ones cotangent gives each image's W)."""
    x = _resolve(net, x, device)
    with torch.no_grad():  # one grad-free region: torch.export keeps it whole
        feats, vjp = _encode(net, x)
        f, norm, scores = _cosine(feats, t.to(feats.device))
        ct_f = t.to(feats.device, feats.dtype).expand_as(f)
        if f.dim() == 3:
            ct_f = ct_f / f.shape[1]
        # d(g / ||g||): (ct - f (f . ct)) / ||g||
        ct_feats = (ct_f - f * (f * ct_f).sum(-1, keepdim=True)) / norm
        return scores, vjp(ct_feats)
