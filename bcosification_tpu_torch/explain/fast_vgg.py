"""Hand-scheduled explanation pass for the zoo's B-cos VGG, the VGG's
counterpart of ``explain/fast_resnet.py``.

It computes what ``explain.core.dynamic_linear_weights`` computes on the
module forward (logits and W(x) = d logit[selected] / d x of the
explanation-mode model, every dynamic scale and norm statistic detached)
with an explicitly written linear backward and no autograd, so that
``torch.export`` traces it (``serving.export_explain``).

The forward runs the net's plan in order: each 3x3 B-cos conv on cuDNN
(``_shared._Conv``, which keeps its dynamic scale), each norm
(``_shared._Norm``: the uncentered BN of the ``_bnu`` nets, an affine;
or the position norm), each avg-pool; then the classifier: the 7x7 conv
on cuDNN and the two 1x1 convs on K3 (``bcos_matmul_fwd``), the global
average pool and the logit layer. The backward goes back through the
same list: the 1x1s on K2 (``bcos_conv1x1_bwd_explain``, the bare
cotangent), each cuDNN conv by ``F.conv_transpose2d``, each pool by its
transpose (``_shared._pool_t``).

Scope (``supports``): a BcosVGG, bare or in a BcosifyNetwork, whose layers
are those ``_shared.zoo_layers`` names: every VGG entry of the zoo,
with or without norms, also with ``no_pool``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain._shared import (
    _Conv,
    _Norm,
    _normalize,
    _pool_t,
    _selected_cotangent,
    logit_layers,
    parts,
    zoo_layers,
)
from bcosification_tpu_torch.modules import BcosConv2d
from bcosification_tpu_torch.ops import pooling

__all__ = ["supports", "fast_dynamic_linear_weights"]


def supports(net) -> bool:
    """True if ``net`` is a BcosVGG this pass handles (see above)."""
    from bcosification_tpu_torch.models.vgg import BcosVGG

    m, _ = parts(net)
    return isinstance(m, BcosVGG) and zoo_layers(m)


def fast_dynamic_linear_weights(
    net, x: torch.Tensor, idx=None, *, device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, selected_idx, W) for x [N, H, W, C]: what
    ``dynamic_linear_weights(lambda t: net(t, explain=True), x, idx)``
    gives, when ``supports(net)``. Runs on ``device`` (default the GPU;
    raises without one unless device="cpu")."""
    dev = resolve_device(device)
    if not supports(net):
        raise ValueError("fast VGG explain pass: unsupported model (see supports())")
    with torch.no_grad():
        return _fast(net, x.to(dev), idx)


def _fast(net, x, idx):
    m, wrapper = parts(net)
    xn, std_in = _normalize(wrapper, x)

    # ---------------- forward (explanation-mode values) ----------------
    a, steps = xn, []  # per step: a _Conv, a _Norm, or the pool's input shape
    for name in m.plan + ["classifier_0", "classifier_1", "classifier_2"]:
        if name == "M":
            steps.append(a.shape)
            a = pooling.avg_pool2d(a, 2, 2)
            continue
        mod = getattr(m, name)
        if isinstance(mod, BcosConv2d):
            step = _Conv(mod, a)
            a = step.forward()
        else:
            step = _Norm(mod, a)
            a = step.out
        steps.append(step)
    logits = pooling.global_avg_pool(a)
    for layer in logit_layers(net):
        logits = layer(logits)

    # ---------------- backward (explicit linear transpose) ----------------
    sel, ct = _selected_cotangent(net, logits, idx)
    nb, h, w_, _ = a.shape
    ct = (ct / (h * w_)).to(x.dtype)[:, None, None, :].expand(nb, h, w_, -1)
    for step in reversed(steps):
        if isinstance(step, torch.Size):
            ct = _pool_t(ct, step, 2, 2, 0)
        else:
            ct = step.backward(ct)
    return logits, sel, (ct if std_in is None else ct / std_in)
