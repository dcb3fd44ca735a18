"""Serving export: a model's forward, or its forward + explanation, as a
``torch.export`` program with the weights baked in (counterpart of
``bcosification_tpu/serving.py``).

The artifact is bytes (``torch.export.save``); ``load_serialized(blob)``
returns an object whose ``.call(x)`` runs the program, with no model code
needed at load time. The batch is a symbolic dimension, so one artifact
serves any batch size; the input size, channels, dtype and device are fixed
at export. The hand-written kernels appear in the program as the
``bcos_torch`` custom ops, so a loaded program launches them (and counts
the launches) as the eager model does.
"""
from __future__ import annotations

import io

import torch
from torch import nn

# registers the bcos_torch custom ops, which torch.export.load resolves
import bcosification_tpu_torch.ops.cuda  # noqa: F401
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.explain import fast_resnet

__all__ = ["export_forward", "export_explain", "load_serialized"]


class _Explain(nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return fast_resnet.fast_dynamic_linear_weights(self.net, x, device=x.device)


def _export(module: nn.Module, input_size: int, channels: int, dtype, device) -> bytes:
    dev = resolve_device(device)
    example = torch.zeros((2, input_size, input_size, channels), dtype=dtype, device=dev)
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(module.eval(), (example,), dynamic_shapes=({0: batch},),
                                  strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_forward(net, *, input_size: int = 224, channels: int = 6,
                   dtype=torch.float32, device=None) -> bytes:
    """Serialized program of ``net(x)`` (eval mode) for x [batch?, S, S, C]
    on ``device`` (default the GPU, where net must lie)."""
    return _export(net, input_size, channels, dtype, device)


def export_explain(net, *, input_size: int = 224, channels: int = 6,
                   dtype=torch.float32, device=None) -> bytes:
    """Serialized program of the fused forward + explanation: x ->
    (logits, selected_idx, W), W(x) the dynamic-linear weights of the
    predicted class, from the hand-scheduled pass
    (``explain/fast_resnet.py``). Raises for a model that pass does not
    support."""
    if not fast_resnet.supports(net):
        raise ValueError("export_explain: the model is not supported by the fast "
                         "explanation pass (see explain.fast_resnet.supports)")
    return _export(_Explain(net), input_size, channels, dtype, device)


class Serialized:
    """A loaded artifact: ``.call(x)`` runs the program."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, x: torch.Tensor):
        return self._module(x)


def load_serialized(blob: bytes) -> Serialized:
    """Rehydrate an artifact of ``export_forward`` or ``export_explain``."""
    return Serialized(torch.export.load(io.BytesIO(blob)))
