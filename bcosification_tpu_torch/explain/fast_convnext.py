"""Hand-scheduled explanation pass for the zoo's B-cos ConvNeXt, the
ConvNeXt's counterpart of ``explain/fast_resnet.py``.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model, every dynamic scale and norm statistic detached)
with an explicitly written linear backward and no autograd, so that
``torch.export`` traces it (``serving.export_explain``).

Per block the forward keeps four steps: the depthwise 7x7 B-cos conv on
cuDNN (``_shared._Conv`` with one patch norm per channel; it keeps its
dynamic scale), the norm (``_shared._Norm``: the position norm, or the
uncentered BN of the ``_bnu`` nets), and the two 1x1 convs on K3
(``bcos_matmul_fwd``), which keep only their inputs. The backward of a
block takes its output's cotangent ct and returns ct plus the branch's:
ct times ``layer_scale`` in the activation's dtype (op for op as the
module's autograd), block_3's K2 (``bcos_conv1x1_bwd_explain``) and
block_2's K2 with the bare cotangent, the norm's transpose, the
depthwise conv's (``F.conv_transpose2d`` with groups = channels). The
stem (4x4 stride 4), the downsampling (norm, 2x2 stride 2) and the head
(norm, the 1x1 classifier on K3 / K2, the global average pool) are
transposed in the same way. Stochastic depth is the identity in eval.

Scope (``supports``): a BcosConvNeXt, bare or in a BcosifyNetwork, whose
layers are those ``_shared.zoo_layers`` names: every ConvNeXt entry
of the zoo, the ``_bnu`` ones included.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _Conv,
    _ConvNorm,
    _Norm,
    _normalize,
    _selected_cotangent,
    logit_layers,
    parts,
    zoo_layers,
)
from bcosification_tpu_torch.ops import pooling

__all__ = ["supports", "fast_dynamic_linear_weights"]


def supports(net) -> bool:
    """True if ``net`` is a BcosConvNeXt this pass handles (see above)."""
    from bcosification_tpu_torch.models.convnext import BcosConvNeXt

    m, _ = parts(net)
    return isinstance(m, BcosConvNeXt) and zoo_layers(m)


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, C]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast ConvNeXt explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


class _Block:
    """One CNBlock's explanation-mode forward and the transpose of its map."""

    def __init__(self, blk, x: torch.Tensor):
        self.dw = _Conv(blk.block_0, x)
        self.norm = _Norm(blk.block_1, self.dw.forward())
        self.expand = _Conv(blk.block_2, self.norm.out)
        self.project = _Conv(blk.block_3, self.expand.forward())
        # in the activation's dtype, as CNBlock.forward multiplies by it
        self.scale = blk.layer_scale.to(x.dtype)
        self.out = self.project.forward() * self.scale + x

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        g = self.project.backward(ct * self.scale)
        return ct + self.dw.backward(self.norm.backward(self.expand.backward(g)))


def _fast(net, x, idx):
    m, wrapper = parts(net)
    xn, std_in = _normalize(wrapper, x)

    # ---------------- forward (explanation-mode values) ----------------
    stem = _ConvNorm(m.stem_conv, m.stem_norm, xn)
    a, stages = stem.out, []  # per stage: its blocks, its downsampling or None
    for si in range(len(m.block_setting)):
        blocks = []
        for blk in m.blocks(si):
            blocks.append(_Block(blk, a))
            a = blocks[-1].out
        down = m.downsample(si)
        if down is not None:
            norm = _Norm(down[0], a)
            down = norm, _Conv(down[1], norm.out)
            a = down[1].forward()
        stages.append((blocks, down))
    head = _Norm(m.classifier_norm, a)
    fc = _Conv(m.classifier_conv, head.out)
    y = fc.forward()
    logits = pooling.global_avg_pool(y)
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit linear transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    nb, h, w_, _ = y.shape
    ct = fc.backward((ct / (h * w_)).to(x.dtype)[:, None, None, :].expand(nb, h, w_, -1))
    ct = head.backward(ct)
    for blocks, down in reversed(stages):
        if down is not None:
            ct = down[0].backward(down[1].backward(ct))
        for blk in reversed(blocks):
            ct = blk.backward(ct)
    w = stem.backward(ct)
    return logits, sel, (w if std_in is None else w / std_in)
