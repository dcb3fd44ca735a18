"""Hand-scheduled explanation pass for the B-cosified DenseNet, the
DenseNet's counterpart of ``explain/fast_resnet.py``.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model, every dynamic scale and BN std detached) with an
explicitly written linear backward and no autograd, so that
``torch.export`` traces it (``serving.export_explain``): an exported
program cannot hold an ``autograd.grad`` call.

Every 1x1 conv (each dense layer's conv1, the transitions' convs and the
GAP-reorder classifier) runs on the hand-written kernels: K3
(``bcos_matmul_fwd``) forward, K2 (``bcos_conv1x1_bwd_explain``), which
recomputes u, backward. The classifier's and each transition's K2 take the
bare cotangent (mult 1, no mask), as K3's explanation backward does; each
conv1's K2 folds the layer's norm2 (mult = gamma2/std2) and act2 (the mask
of its output) into the same launch. The 3x3 convs and the 7x7 stem stay on
cuDNN, each transposed by ``F.conv_transpose2d``.

The backward runs over the net in reverse: the classifier, GAP, norm5 and
act5; in each block the dense layers newest first, the concat's cotangent
split into the part of the layer's input and that of its new features,
which goes back through conv2, act2, norm2, conv1, act1 and norm1 and is
added to the first; each transition's avg-pool, conv, act and norm; the
stem. A dense layer keeps its 3x3 conv's dynamic scale and the output of
its act2 for the backward; its input is a channel prefix of its block's
output, so only the block outputs are kept, and act1's output is
recomputed from them.

Scope (``supports``): BcosifyNetwork(BcosDenseNet) with b=2, max_out=1,
bias-free convs, uncentered BN, ReLU or Identity, the avg-pool stem and the
GAP-reorder classifier: the densenet recipes of ImageNet/bcosification.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain.fast_resnet import (
    _BN,
    _conv_t,
    _flat,
    _seg_bwd,
    _seg_fwd,
    _weight,
    _wt,
    plain_b2_layers,
)
from bcosification_tpu_torch.modules import ReLU
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd

__all__ = ["supports", "fast_dynamic_linear_weights"]


def supports(net) -> bool:
    """True if ``net`` is a BcosifyNetwork(BcosDenseNet) this pass handles."""
    from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork
    from bcosification_tpu_torch.models.densenet import BcosDenseNet

    if not isinstance(net, BcosifyNetwork) or not isinstance(net.model, BcosDenseNet):
        return False
    m = net.model
    if m.small_inputs or m.stem_pool != "avg" or not m.gap_reorder or m.with_logit_layer:
        return False
    return plain_b2_layers(m) == 0  # one BN before each conv but conv0, plus norm5


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, 6]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast DenseNet explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


def _bn_act(a, bn: _BN, relu: bool):
    """An eval BN and the activation, op for op as the modules compute them."""
    r = a / bn.std.to(a.dtype)
    if bn.gamma is not None:
        r = r * bn.gamma
    if bn.beta is not None:
        r = r + bn.beta
    r = r.to(a.dtype)
    return torch.relu(r) if relu else r


def _bn_act_bwd(ct, out, bn: _BN, relu: bool):
    """Cotangent of a BN + activation's input from that of its output ``out``."""
    if relu:
        ct = torch.where(out > 0, ct, torch.zeros_like(ct))
    return ct * bn.mult.to(ct.dtype)


def _matmul(a, wt):
    """K3 on an NHWC activation, cast back to its dtype as ``bcos_conv2d`` does."""
    y = bcos_matmul_fwd(_flat(a), wt, eps=ops.CONV_NORM_EPS, eps_outside=False)
    return y.view(a.shape[:3] + (-1,)).to(a.dtype)


def _layer_fwd(layer, a, relu, dtype):
    """One dense layer's explanation-mode new features, and its record."""
    rec = {"c_in": a.shape[-1], "bn1": _BN(layer.norm1), "wt1": _wt(layer.conv1, dtype),
           "bn2": _BN(layer.norm2), "w2": _weight(layer.conv2, dtype)}
    h1 = _bn_act(a, rec["bn1"], relu)
    rec["h2"] = _bn_act(_matmul(h1, rec["wt1"]), rec["bn2"], relu)
    u2 = ops.conv2d(rec["h2"], rec["w2"], 1, 1)
    n2 = ops.patch_norms(rec["h2"], 3, stride=1, padding=1).to(dtype)
    rec["s2"] = u2.abs() / n2  # the detached dynamic scale
    return rec["s2"] * u2, rec


def _layer_bwd(rec, a, ct, relu):
    """Cotangent of a dense layer's input ``a`` from ``ct``, that of its
    output cat([a, new])."""
    c_in = rec["c_in"]
    ct_u2 = ct[..., c_in:] * rec["s2"]
    h2 = rec["h2"]
    ct_h2 = _conv_t(ct_u2, rec["w2"], h2.shape, 1, 1)
    h1 = _bn_act(a, rec["bn1"], relu)
    ct_h1 = conv1x1_bwd_explain(_flat(h1), rec["wt1"], _flat(ct_h2),
                                _flat(h2) if relu else None, rec["bn2"].mult, relu=relu)
    return ct[..., :c_in] + _bn_act_bwd(ct_h1.view(h1.shape), h1, rec["bn1"], relu)


def _pool_t(ct, shape, k: int, s: int, p: int):
    """Transpose of avg_pool2d(k, s, p) (count_include_pad) back to ``shape``."""
    c = ct.shape[-1]
    w = torch.full((c, 1, k, k), 1.0 / (k * k), dtype=ct.dtype, device=ct.device)
    return _conv_t(ct, w, shape, s, p, groups=c)


def _fast(net, x, idx):
    m = net.model
    dtype = x.dtype
    relu = isinstance(m.act0, ReLU)

    # ---------------- forward (explanation-mode values) ----------------
    mean = torch.tensor(net.mean, dtype=dtype, device=x.device)
    std_in = torch.tensor(net.std, dtype=dtype, device=x.device)
    xn = (x - mean) / std_in

    w_stem = _weight(m.conv0, dtype)
    bn_stem = _BN(m.norm0)
    n_stem = ops.patch_norms(xn, 7, stride=2, padding=3).to(dtype)
    z_stem = _seg_fwd(ops.conv2d(xn, w_stem, 2, 3), n_stem, bn_stem, relu)
    a = pooling.avg_pool2d(z_stem, 3, 2, 1).contiguous()

    blocks = []  # per block: (its output, the layers' records, the transition's)
    for i in range(len(m.block_config)):
        recs = []
        for layer in m.dense_layers(i):
            new, rec = _layer_fwd(layer, a, relu, dtype)
            a = torch.cat([a, new], dim=-1)
            recs.append(rec)
        trans, tr = m.transition(i), None
        if trans is not None:
            tr = {"bn": _BN(trans.norm), "wt": _wt(trans.conv, dtype)}
            y = _matmul(_bn_act(a, tr["bn"], relu), tr["wt"])
            tr["y_shape"] = y.shape
        blocks.append((a, recs, tr))
        if tr is not None:
            a = pooling.avg_pool2d(y, 2, 2)

    # norm5, act5 and the classifier: a 1x1 B-cos conv before the global average pool
    bn5 = _BN(m.norm5)
    a5 = _bn_act(a, bn5, relu)
    wt_fc = _wt(m.classifier, dtype)
    y_fc = bcos_matmul_fwd(_flat(a5), wt_fc, eps=ops.CONV_NORM_EPS, eps_outside=False)
    nb, h, w_, _ = a5.shape
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
    ct_a5 = conv1x1_bwd_explain(_flat(a5), wt_fc, _flat(ct_fc), None, None, relu=False)
    ct = _bn_act_bwd(ct_a5.view(a5.shape), a5, bn5, relu)

    for out, recs, tr in reversed(blocks):
        if tr is not None:  # ct is that of the pooled transition output
            h_t = _bn_act(out, tr["bn"], relu)
            ct_y = _pool_t(ct, tr["y_shape"], 2, 2, 0)
            ct_h = conv1x1_bwd_explain(_flat(h_t), tr["wt"], _flat(ct_y), None, None,
                                       relu=False)
            ct = _bn_act_bwd(ct_h.view(h_t.shape), h_t, tr["bn"], relu)
        for rec in reversed(recs):  # each layer's input is a prefix of the block output
            ct = _layer_bwd(rec, out[..., :rec["c_in"]], ct, relu)

    # stem: avg-pool transpose, stem segment, 7x7 conv transpose, normalise
    ct_zstem = _pool_t(ct, z_stem.shape, 3, 2, 1)
    ct_u0 = _seg_bwd(ct_zstem, z_stem, n_stem, bn_stem, relu)
    w = _conv_t(ct_u0, w_stem, xn.shape, 2, 3) / std_in
    return logits, sel, w
