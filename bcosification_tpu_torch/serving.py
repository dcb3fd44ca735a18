"""Serving export: a model's forward, or its forward + explanation, as a
``torch.export`` program with the weights baked in (counterpart of
``bcosification_tpu/serving.py``).

The artifact is bytes (``torch.export.save``); ``load_serialized(blob)``
returns an object whose ``.call(x)`` runs the program, with no model code
needed at load time. The batch is a symbolic dimension, so one artifact
serves any batch size; the input size, channels, dtype and device are fixed
at export. The hand-written kernels appear in the program as the
``bcos_torch`` custom ops, so a loaded program launches them (and counts
the launches) as the eager model does. ``export_text_explain`` packages
the text-grounded explanation of a B-cosified CLIP image tower: (x, t) ->
(scores, W) through ``explain/fast_clip.py`` (CLIP-RN50) or
``explain/fast_clip_vit.py`` (the CLIP ViTs).
"""
from __future__ import annotations

import io

import torch
from torch import nn

# registers the bcos_torch custom ops, which torch.export.load resolves
import bcosification_tpu_torch.ops.cuda  # noqa: F401
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain import (
    fast_clip,
    fast_convnext,
    fast_densenet,
    fast_resnet,
    fast_vgg,
    fast_vit,
    fast_vit_standard,
)

__all__ = ["export_forward", "export_explain", "export_text_explain", "load_serialized"]

# the hand-scheduled explanation passes, which torch.export traces (a
# program cannot hold the generic pass's autograd.grad)
_FAST_PASSES = (fast_resnet, fast_densenet, fast_vgg, fast_convnext, fast_vit,
                fast_vit_standard)


class _Explain(nn.Module):
    def __init__(self, net, fast):
        super().__init__()
        self.net, self.fast = net, fast

    def forward(self, x):
        return self.fast.fast_dynamic_linear_weights(self.net, x, device=x.device)


class _TextExplain(nn.Module):
    def __init__(self, net, fast):
        super().__init__()
        self.net, self.fast = net, fast

    def forward(self, x, t):
        return self.fast.fast_text_dlw(self.net, x, t, device=x.device)


def _export(module: nn.Module, input_size: int, channels: int, dtype, device,
            extra=()) -> bytes:
    """The program of module(x, *extra) with a symbolic batch in x [batch?,
    S, S, C]; ``extra`` are (shape, dtype) of further fixed-shape inputs."""
    dev = resolve_device(device)
    example = torch.zeros((2, input_size, input_size, channels), dtype=dtype, device=dev)
    others = tuple(torch.zeros(shape, dtype=dt, device=dev) for shape, dt in extra)
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(module.eval(), (example, *others),
                                  dynamic_shapes=({0: batch},) + (None,) * len(others),
                                  strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_forward(net, *, input_size: int = 224, channels: int = 6,
                   dtype=torch.float32, device=None) -> bytes:
    """Serialized program of ``net(x)`` (eval mode) for x [batch?, S, S, C]
    on ``device`` (default the GPU, where net must lie): the logits of a
    classifier, the features of a CLIP image tower."""
    return _export(net, input_size, channels, dtype, device)


def export_explain(net, *, input_size: int = 224, channels: int = 6,
                   dtype=torch.float32, device=None) -> bytes:
    """Serialized program of the fused forward + explanation: x ->
    (logits, selected_idx, W), W(x) the dynamic-linear weights of the
    predicted class, from the hand-scheduled pass of the model's family
    (``explain/fast_resnet.py``, ``explain/fast_densenet.py``,
    ``explain/fast_vgg.py``, ``explain/fast_convnext.py``,
    ``explain/fast_vit.py``; the standard ViT baselines, whose W is their
    plain input gradient, ``explain/fast_vit_standard.py``). Raises for a
    model that no pass supports."""
    for fast in _FAST_PASSES:
        if fast.supports(net):
            return _export(_Explain(net, fast), input_size, channels, dtype, device)
    raise ValueError("export_explain: the model is not supported by any hand-scheduled "
                     "explanation pass (see the supports() of explain.fast_resnet, "
                     "fast_densenet, fast_vgg, fast_convnext, fast_vit and "
                     "fast_vit_standard)")


def export_text_explain(net, *, embed_dim: int, input_size: int = 224, channels: int = 6,
                        dtype=torch.float32, device=None) -> bytes:
    """Serialized program of the text-grounded explanation of a B-cosified
    CLIP image tower: (x [batch?, S, S, C], t [embed_dim]) -> (scores
    [batch?], W like x), score_b the cosine of the tower's explain-mode
    features with t (per location and averaged for attn-unpool towers) and
    W = d score / dx, through the hand-scheduled pass of the tower
    (``explain/fast_clip.py``, ``explain/fast_clip_vit.py``). Raises for a
    tower that neither supports."""
    fast = fast_clip.text_pass_for(net)
    if fast is not None:
        return _export(_TextExplain(net, fast), input_size, channels, dtype, device,
                       extra=(((embed_dim,), dtype),))
    raise ValueError("export_text_explain: the model is not supported by a hand-scheduled "
                     "CLIP pass (see explain.fast_clip.supports, fast_clip_vit.supports)")


class Serialized:
    """A loaded artifact: ``.call(x)`` (``.call(x, t)`` for the text-grounded
    explanation) runs the program."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, *inputs: torch.Tensor):
        return self._module(*inputs)


def load_serialized(blob: bytes) -> Serialized:
    """Rehydrate an artifact of ``export_forward``, ``export_explain`` or
    ``export_text_explain``."""
    return Serialized(torch.export.load(io.BytesIO(blob)))
