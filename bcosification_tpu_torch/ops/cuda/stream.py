"""The streaming add, out = a + b [+ c [+ d]] in bf16: the Hopper kernel K4.

Counterpart of the Pallas kernel of ``scripts/perf_probe9.py`` (``make``,
``nin`` inputs). It carries no model semantics: it is the probe that
measures the streaming rate of the card's memory
(``probes/stream_bandwidth.py``), against which the bounds of K1-K3 are
stated. K4 (``csrc/stream_add.cu``) moves 16 bytes per thread and input per
step in a grid-stride loop and adds in f32, rounding to bf16 after each
add, so it equals the plain ``(a + b) + c`` in bf16 bit for bit.

``stream_add`` checks its operands and calls the custom op
``torch.ops.bcos_torch.stream_add``: on the CPU the plain version, on a
CUDA device the kernel, counted in ``stream_add.launches``.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch
from torch import Tensor

from bcosification_tpu_torch.ops.cuda import _build
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import check_device

__all__ = ["stream_add", "stream_add_plain"]

_P = ctypes.c_void_p
_ARGS = (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong, _P)


def stream_add_plain(*inputs: Tensor) -> Tensor:
    """Plain version of K4: PyTorch's adds in order, each rounded to bf16."""
    out = inputs[0] + inputs[1]
    for t in inputs[2:]:
        out = out + t
    return out


def stream_add(*inputs: Tensor) -> Tensor:
    """K4: the sum of 2 to 4 contiguous bf16 tensors of one shape, added in
    order, in a new tensor."""
    if not 2 <= len(inputs) <= 4:
        raise ValueError(f"stream_add: takes 2 to 4 inputs, got {len(inputs)}")
    first = inputs[0]
    for i, t in enumerate(inputs):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"stream_add: input {i} is {t.dtype}, not bfloat16")
        if t.device != first.device:
            raise ValueError(f"stream_add: input {i} on {t.device}, input 0 on {first.device}")
        if t.shape != first.shape:
            raise ValueError(f"stream_add: input {i} has shape {tuple(t.shape)}, "
                             f"input 0 {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"stream_add: input {i} must be contiguous")
    check_device("stream_add", first)
    return torch.ops.bcos_torch.stream_add(list(inputs))


@torch.library.custom_op("bcos_torch::stream_add", mutates_args=(), device_types="cuda")
def _stream_add_op(inputs: List[Tensor]) -> Tensor:
    first = inputs[0]
    out = torch.empty_like(first)
    if first.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in inputs] + [None] * (4 - len(inputs))
    fn = _build.function("stream_add", _ARGS)
    with torch.cuda.device(first.device):
        code = fn(len(inputs), *ptrs, out.data_ptr(), first.numel(),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("stream_add", code)
    stream_add.launches += 1
    return out


@_stream_add_op.register_kernel("cpu")
def _stream_add_cpu(inputs):
    return stream_add_plain(*inputs)


@_stream_add_op.register_fake
def _stream_add_fake(inputs):
    return torch.empty_like(inputs[0])


stream_add.launches = 0
