"""Hand-scheduled explanation pass for B-cos ResNets (counterpart of
``bcosification_tpu/explain/fast_resnet.py``), the main path's explanation.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model) with an explicitly written linear backward and no
autograd, so that ``torch.export`` traces it (``serving.export_explain``).

**Uncentered-BN nets** (the B-cosified ResNets, and a zoo ResNet rebuilt
with the released BN flavour). Every 1x1 segment runs the hand-written
kernels:

- forward: K1 (``bcos_conv1x1_fwd``) for conv1, conv3 and the downsample of
  each bottleneck, K3 (``bcos_matmul_fwd``) for the GAP-reorder classifier;
- backward: K2 (``bcos_conv1x1_bwd_explain``), which recomputes u, for the
  same segments. The cotangent of conv3 and the downsample is pre-masked by
  the block output's ReLU; conv1's mask is the kernel's own (a = c1); the
  classifier's mult is 1.

The 7x7 stem and the 3x3 convs stay on cuDNN. Their backward rebuilds each
dynamic scale from the segment's output, as the JAX pass does:
|u|/n = sqrt(|z - beta| / (|m| n)) with m = gamma/std, so no
activation-sized residual is kept. Their transposes are
``F.conv_transpose2d`` with the output padding that the forward's input
size fixes.

**Position-norm nets** (the from-scratch B-cos zoo: ``DetachablePositionNorm2d``
after every conv, Identity activations, the logit layer inside). Every
stride-1 1x1 conv (conv1 and conv3 of each bottleneck, a stride-1
downsample, the classifier) runs K3 forward and K2 backward with the bare
cotangent (mult 1, no mask), as K3's explanation backward does; the other
convs (the stem, the 3x3s, grouped in ResNeXt, a stride-2 downsample) run
on cuDNN and keep their dynamic scale for the backward. The norm is a
LayerNorm over each pixel's channels with its variance detached, so its
backward is linear: c - mean_C(c) with c = g * weight / std.

Scope (``supports``): a BcosResNet, bare or in a BcosifyNetwork, with b=2,
max_out 1, bias-free undilated convs of one type and the GAP-reorder
classifier; either uncentered BN after each conv but the classifier, ReLU or
Identity, ungrouped convs and the avg-pool stem (the flagship, its resnet18
sibling, the BN-flavoured zoo nets), or the position norm, Identity, and an
avg-pool or no stem pool (every ResNet entry of the zoo).
"""
from __future__ import annotations

from typing import Tuple

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _BN,
    _Conv,
    _ConvNorm,
    _conv_t,
    _flat,
    _normalize,
    _pool_t,
    _seg_bwd,
    _seg_fwd,
    _selected_cotangent,
    _weight,
    _wt,
    logit_layers,
    parts,
    plain_b2_layers,
    position_norm_layers,
)
from bcosification_tpu_torch.modules import ReLU
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain, conv1x1_fwd
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd

__all__ = ["supports", "fast_dynamic_linear_weights"]



def supports(net) -> bool:
    """True if ``net`` is a BcosResNet (bare or in a BcosifyNetwork) this
    pass handles."""
    from bcosification_tpu_torch.models.resnet import BcosResNet

    m, _ = parts(net)
    if not isinstance(m, BcosResNet) or not m.gap_reorder:
        return False
    if position_norm_layers(m):
        return m.small_inputs or m.stem_pool != "max"
    if m.small_inputs or m.stem_pool != "avg" or m.groups != 1:
        return False
    return plain_b2_layers(m) == -1  # one BN per conv but the fc


def _block_fwd(blk, a, stride, has_ds, bottleneck, relu, dtype):
    """One residual block's explanation-mode forward; returns (out, record
    of what the backward needs)."""
    nb, h, w_, _ = a.shape
    rec = {"in": a, "stride": stride, "has_ds": has_ds, "bottleneck": bottleneck}
    if has_ds:
        rec.update(x_ds=_flat(a[:, ::stride, ::stride]), wt_ds=_wt(blk.downsample_conv, dtype),
                   bn_ds=_BN(blk.downsample_norm))
        identity = conv1x1_fwd(rec["x_ds"], rec["wt_ds"], rec["bn_ds"].mult,
                               rec["bn_ds"].add, relu=False)
        identity = identity.view(a[:, ::stride, ::stride].shape[:3] + (-1,))
    else:
        identity = a
    rec["identity"] = identity

    if bottleneck:
        rec.update(wt1=_wt(blk.conv1, dtype), bn1=_BN(blk.bn1))
        c1 = conv1x1_fwd(_flat(a), rec["wt1"], rec["bn1"].mult, rec["bn1"].add, relu=relu)
        c1 = c1.view(nb, h, w_, -1)
        rec.update(w2=_weight(blk.conv2, dtype), bn2=_BN(blk.bn2))
        rec["n2"] = ops.patch_norms(c1, 3, stride=stride, padding=1).to(dtype)
        c2 = _seg_fwd(ops.conv2d(c1, rec["w2"], stride, 1), rec["n2"], rec["bn2"], relu)
        c2 = c2.contiguous()
        rec.update(wt3=_wt(blk.conv3, dtype), bn3=_BN(blk.bn3))
        y = conv1x1_fwd(_flat(c2), rec["wt3"], rec["bn3"].mult, rec["bn3"].add, relu=False)
        y = y.view(c2.shape[:3] + (-1,))
        rec["c2"] = c2
    else:
        rec.update(w1=_weight(blk.conv1, dtype), bn1=_BN(blk.bn1))
        rec["n1"] = ops.patch_norms(a, 3, stride=stride, padding=1).to(dtype)
        c1 = _seg_fwd(ops.conv2d(a, rec["w1"], stride, 1), rec["n1"], rec["bn1"], relu)
        rec.update(w2=_weight(blk.conv2, dtype), bn2=_BN(blk.bn2))
        rec["n2"] = ops.patch_norms(c1, 3, stride=1, padding=1).to(dtype)
        y = _seg_fwd(ops.conv2d(c1, rec["w2"], 1, 1), rec["n2"], rec["bn2"], False)
    out = y + identity
    if relu:
        out = torch.relu(out)
    rec.update(c1=c1, out=out.contiguous())
    return rec["out"], rec


def _block_bwd(rec, ct_a, relu):
    """Cotangent of a block's input from that of its output."""
    stride, a_in, c1 = rec["stride"], rec["in"], rec["c1"]
    ct_m = torch.where(rec["out"] > 0, ct_a, torch.zeros_like(ct_a)) if relu else ct_a
    ct_m2 = _flat(ct_m)
    if rec["bottleneck"]:
        c2 = rec["c2"]
        ct_c2 = conv1x1_bwd_explain(_flat(c2), rec["wt3"], ct_m2, None, rec["bn3"].mult,
                                    relu=False).view(c2.shape)
        ct_u2 = _seg_bwd(ct_c2, c2, rec["n2"], rec["bn2"], relu)
        ct_c1 = _conv_t(ct_u2, rec["w2"], c1.shape, stride, 1)
        ct_in = conv1x1_bwd_explain(_flat(a_in), rec["wt1"], _flat(ct_c1), _flat(c1),
                                    rec["bn1"].mult, relu=relu).view(a_in.shape)
    else:
        # the conv2 segment's scale is rebuilt from out - identity
        ct_u2 = _seg_bwd(ct_m, rec["out"], rec["n2"], rec["bn2"], False,
                         identity=rec["identity"])
        ct_c1 = _conv_t(ct_u2, rec["w2"], c1.shape, 1, 1)
        ct_u1 = _seg_bwd(ct_c1, c1, rec["n1"], rec["bn1"], relu)
        ct_in = _conv_t(ct_u1, rec["w1"], a_in.shape, stride, 1)
    if rec["has_ds"]:
        ct_ds = conv1x1_bwd_explain(rec["x_ds"], rec["wt_ds"], ct_m2, None, rec["bn_ds"].mult,
                                    relu=False)
        ct_in[:, ::stride, ::stride] += ct_ds.view(ct_m.shape[:3] + (a_in.shape[-1],))
    else:
        ct_in += ct_m
    return ct_in


def _pn_block_fwd(blk, a: torch.Tensor):
    """One residual block of a position-norm net: (out, its segments in
    forward order, the downsample's segment or None)."""
    names = ((1, 2, 3) if hasattr(blk, "conv3") else (1, 2))
    segs, h = [], a
    for k in names:
        segs.append(_ConvNorm(getattr(blk, f"conv{k}"), getattr(blk, f"bn{k}"), h))
        h = segs[-1].out
    ds = (_ConvNorm(blk.downsample_conv, blk.downsample_norm, a)
          if hasattr(blk, "downsample_conv") else None)
    return h + (a if ds is None else ds.out), segs, ds


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, C]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast explain pass: unsupported model (see supports())")
    with torch.no_grad():
        m, _ = parts(net)
        fast = _fast_pn if position_norm_layers(m) else _fast
        return fast(net, x.to(dev), idx)


def _fast_pn(net, x, idx):
    """The pass of a position-norm net (see the module's docstring)."""
    m, wrapper = parts(net)
    xn, std_in = _normalize(wrapper, x)

    # ---------------- forward (explanation-mode values) ----------------
    stem = _ConvNorm(m.conv1, m.bn1, xn)
    a = stem.out
    pooled = not m.small_inputs and m.stem_pool == "avg"
    if pooled:
        a = pooling.avg_pool2d(a, 3, 2, 1)
    blocks = []
    for blk in m.blocks():
        a, segs, ds = _pn_block_fwd(blk, a)
        blocks.append((segs, ds))
    fc = _Conv(m.fc, a)
    logits = pooling.global_avg_pool(fc.forward())
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit linear transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    nb, h, w_, _ = a.shape
    ct = fc.backward((ct / (h * w_)).to(x.dtype)[:, None, None, :].expand(nb, h, w_, -1))
    for segs, ds in reversed(blocks):
        ct_h = ct
        for seg in reversed(segs):
            ct_h = seg.backward(ct_h)
        ct = ct_h + (ct if ds is None else ds.backward(ct))
    if pooled:
        ct = _pool_t(ct, stem.out.shape, 3, 2, 1)
    w = stem.backward(ct)
    return logits, sel, (w if std_in is None else w / std_in)


def _fast(net, x, idx):
    """The pass of an uncentered-BN net (see the module's docstring)."""
    m, wrapper = parts(net)
    dtype = x.dtype
    relu = isinstance(m.act, ReLU)

    # ---------------- forward (explanation-mode values) ----------------
    xn, std_in = _normalize(wrapper, x)

    w_stem = _weight(m.conv1, dtype)
    bn_stem = _BN(m.bn1)
    n_stem = ops.patch_norms(xn, 7, stride=2, padding=3).to(dtype)
    z_stem = _seg_fwd(ops.conv2d(xn, w_stem, 2, 3), n_stem, bn_stem, relu)
    a = pooling.avg_pool2d(z_stem, 3, 2, 1).contiguous()

    recs = []
    for (_, _, _, stride, has_ds), blk in zip(m.block_cfgs(), m.blocks()):
        a, rec = _block_fwd(blk, a, stride, has_ds, m.block == "bottleneck", relu, dtype)
        recs.append(rec)

    # classifier: 1x1 B-cos conv before the global average pool
    wt_fc = _wt(m.fc, dtype)
    y_fc = bcos_matmul_fwd(_flat(a), wt_fc, eps=ops.CONV_NORM_EPS, eps_outside=False)
    nb, h, w_, _ = a.shape
    logits = y_fc.view(nb, h * w_, -1).mean(1).to(dtype)
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit linear transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    ct_fc = (ct / (h * w_)).to(dtype)[:, None, :].expand(nb, h * w_, ct.shape[-1])
    ct_a = conv1x1_bwd_explain(_flat(a), wt_fc, _flat(ct_fc), None, None, relu=False)
    ct_a = ct_a.view(a.shape)

    for rec in reversed(recs):
        ct_a = _block_bwd(rec, ct_a, relu)

    # stem: avg-pool transpose, stem segment, 7x7 conv transpose, normalise
    ct_zstem = _pool_t(ct_a, z_stem.shape, 3, 2, 1)
    ct_u0 = _seg_bwd(ct_zstem, z_stem, n_stem, bn_stem, relu)
    w = _conv_t(ct_u0, w_stem, xn.shape, 2, 3)
    return logits, sel, (w if std_in is None else w / std_in)
