"""Pooling ops with torch semantics on NHWC tensors (counterpart of
``bcosification_tpu/ops/pooling.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.ops.bcos import IntOrPair, _pair, nchw, nhwc

__all__ = ["avg_pool2d", "max_pool2d", "adaptive_avg_pool2d", "global_avg_pool"]


def avg_pool2d(x: torch.Tensor, kernel_size: IntOrPair, stride: IntOrPair = None,
               padding: IntOrPair = 0, count_include_pad: bool = True) -> torch.Tensor:
    """F.avg_pool2d on NHWC; by default the divisor counts the zero padding."""
    stride = kernel_size if stride is None else stride
    # A contiguous NCHW copy, not the channels_last view: PyTorch's CUDA
    # avg_pool2d returns wrong input gradients for channels_last inputs
    # (torch 2.11 on an H100: relative error ~1 against the CPU; PERF.md).
    y = F.avg_pool2d(nchw(x).contiguous(), _pair(kernel_size), _pair(stride),
                     _pair(padding), count_include_pad=count_include_pad)
    return nhwc(y).contiguous()


def max_pool2d(x: torch.Tensor, kernel_size: IntOrPair, stride: IntOrPair = None,
               padding: IntOrPair = 0) -> torch.Tensor:
    """F.max_pool2d on NHWC (the padding never wins: -inf)."""
    stride = kernel_size if stride is None else stride
    y = F.max_pool2d(nchw(x).contiguous(), _pair(kernel_size), _pair(stride), _pair(padding))
    return nhwc(y).contiguous()


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntOrPair = 1) -> torch.Tensor:
    """F.adaptive_avg_pool2d on NHWC, only for output sizes that divide the
    input's: the mean of each (H / oh) x (W / ow) tile."""
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    assert h % oh == 0 and w % ow == 0, (tuple(x.shape), output_size)
    return x.reshape(n, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))


def global_avg_pool(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return x.mean(dim=(1, 2), keepdim=keepdim)
