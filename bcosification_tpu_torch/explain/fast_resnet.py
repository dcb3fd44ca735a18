"""Hand-scheduled explanation pass for B-cosified ResNets (counterpart of
``bcosification_tpu/explain/fast_resnet.py``), the main path's explanation.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model) with an explicitly written linear backward and no
autograd. Every 1x1 segment runs the hand-written kernels:

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

Scope (``supports``): BcosifyNetwork(BcosResNet) with b=2, max_out=1,
bias-free convs, uncentered BN, ReLU or Identity, avg stem pool and
GAP-reorder classifier, bottleneck or basic blocks: the flagship and its
resnet18 sibling. Basic blocks have no 1x1 convs but the downsample.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.modules import PlainReLU, ReLU
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain, conv1x1_fwd
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd

__all__ = ["supports", "fast_dynamic_linear_weights"]


def supports(net) -> bool:
    """True if ``net`` is a BcosifyNetwork(BcosResNet) this pass handles."""
    from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork
    from bcosification_tpu_torch.models.resnet import BcosResNet

    if not isinstance(net, BcosifyNetwork) or not isinstance(net.model, BcosResNet):
        return False
    m = net.model
    if m.stem_pool != "avg" or not m.gap_reorder or m.with_logit_layer:
        return False
    return plain_b2_layers(m) == -1  # one BN per conv but the fc


def plain_b2_layers(m):
    """The number of uncentered BNs of ``m`` minus that of its B-cos convs,
    or None unless every conv is of one type, b=2, max_out 1, ungrouped,
    undilated and bias-free, and every activation is of one type (ReLU, the
    CLIP towers' PlainReLU or Identity): the layers the hand-scheduled
    passes are written for."""
    from bcosification_tpu_torch.modules import BatchNormUncentered2d, BcosConv2d, Identity

    convs = [mod for mod in m.modules() if isinstance(mod, BcosConv2d)]
    if len({(type(c), c.normalize_weights) for c in convs}) != 1:
        return None
    for c in convs:
        if c.b != 2 or c.max_out != 1 or c.groups != 1 or c.bias is not None:
            return None
        if c.dilation != (1, 1):
            return None
    acts = [mod for mod in m.modules() if isinstance(mod, (ReLU, PlainReLU, Identity))]
    if len({type(a) for a in acts}) != 1:
        return None
    norms = [mod for mod in m.modules() if isinstance(mod, BatchNormUncentered2d)]
    return len(norms) - len(convs)


def _weight(conv, dtype) -> torch.Tensor:
    return conv.effective_weight().to(dtype)


def _wt(conv, dtype) -> torch.Tensor:
    """A 1x1 conv's weight as the kernels' wt [Cout, Cin]."""
    w = _weight(conv, dtype)
    return w.reshape(w.shape[0], w.shape[1]).contiguous()


class _BN:
    """One eval BN's terms: std, gamma, beta, the folded mult = gamma/std and
    the backward factor sm = sign(m) sqrt|m|."""

    def __init__(self, bn):
        self.std = bn.std()
        self.gamma, self.beta = bn.weight, bn.bias
        self.mult = (self.gamma / self.std if self.gamma is not None else 1.0 / self.std)
        self.mult = self.mult.float().contiguous()
        self.add = None if self.beta is None else self.beta.float().contiguous()
        self.sm = torch.sign(self.mult) * torch.sqrt(self.mult.abs())


def _seg_fwd(u, n, bn: _BN, relu: bool):
    """Value path op for op like the modules: dynamic scale and the divide
    by std in u's dtype, the affine in f32, one cast."""
    r = ((u.abs() / n) * u) / bn.std.to(u.dtype)
    if bn.gamma is not None:
        r = r * bn.gamma
    if bn.beta is not None:
        r = r + bn.beta
    z = r.to(u.dtype)
    return torch.relu(z) if relu else z


def _seg_bwd(ct, z, n, bn: _BN, relu: bool, identity=None):
    """ct_u from the segment output z (minus the skip branch, if any), the
    scale rebuilt from it."""
    if relu:
        ct = torch.where(z > 0, ct, torch.zeros_like(ct))
    zz = z if identity is None else z - identity
    if bn.beta is not None:
        zz = (zz.float() - bn.beta).to(z.dtype)
    return ct * bn.sm.to(z.dtype) * torch.sqrt(zz.abs() / n)


def _conv_t(ct, w, x_shape, stride: int, padding: int, groups: int = 1):
    """Transpose of a conv (NHWC ct, OIHW w) back to an input of x_shape."""
    kh, kw = w.shape[2], w.shape[3]
    hc, wc = ct.shape[1], ct.shape[2]
    out_pad = (x_shape[1] - ((hc - 1) * stride - 2 * padding + kh),
               x_shape[2] - ((wc - 1) * stride - 2 * padding + kw))
    y = F.conv_transpose2d(ops.nchw(ct), w, stride=stride, padding=padding,
                           output_padding=out_pad, groups=groups)
    return ops.nhwc(y)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


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


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, 6]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


def _fast(net, x, idx):
    m = net.model
    dtype = x.dtype
    relu = isinstance(m.act, ReLU)

    # ---------------- forward (explanation-mode values) ----------------
    mean = torch.tensor(net.mean, dtype=dtype, device=x.device)
    std_in = torch.tensor(net.std, dtype=dtype, device=x.device)
    xn = (x - mean) / std_in

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
    if net.logit_temperature is not None:
        logits = logits / net.logit_temperature
    logits = logits + net.logit_bias

    # ---------------- backward (explicit linear transpose) ----------------
    if idx is None:
        sel = logits.argmax(dim=1)
    else:
        sel = torch.as_tensor(idx, device=x.device).expand(nb)
    ct = F.one_hot(sel, logits.shape[-1]).to(logits.dtype)
    if net.logit_temperature is not None:
        ct = ct / net.logit_temperature
    ct_fc = (ct / (h * w_)).to(dtype)[:, None, :].expand(nb, h * w_, ct.shape[-1])
    ct_a = conv1x1_bwd_explain(_flat(a), wt_fc, _flat(ct_fc), None, None, relu=False)
    ct_a = ct_a.view(a.shape)

    for rec in reversed(recs):
        ct_a = _block_bwd(rec, ct_a, relu)

    # stem: avg-pool transpose, stem segment, 7x7 conv transpose, normalise
    c = z_stem.shape[-1]
    pool_w = torch.full((c, 1, 3, 3), 1.0 / 9.0, dtype=dtype, device=x.device)
    ct_zstem = _conv_t(ct_a, pool_w, z_stem.shape, 2, 1, groups=c)
    ct_u0 = _seg_bwd(ct_zstem, z_stem, n_stem, bn_stem, relu)
    w = _conv_t(ct_u0, w_stem, xn.shape, 2, 3) / std_in
    return logits, sel, w
