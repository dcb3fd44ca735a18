"""The B-cos matmul (b=2): the Hopper kernel K3 and its autograd.

Counterpart of ``bcosification_tpu/ops/pallas/bcos_matmul.py``:

    u = x @ w;  n = sqrt(ssq + eps)  or, with eps_outside, sqrt(ssq) + eps
    y = u * (|u| / n)           -> f32

with ssq the row sum of squares of x. K3 (``csrc/bcos_matmul_fwd.cu``) sums
ssq from the same tiles that feed the product and scales in the epilogue.
On the main path it carries the GAP-reorder classifier (a 1x1, stride-1,
bias-free b=2 conv, dispatched from ``ops.bcos.bcos_conv2d``). In bf16 it
runs on the TMA + wgmma engine of ``csrc/bcos_engine.cuh``, whose tile
loads need rows of whole 16-byte units: bf16 K must be a multiple of 8 and
x and wt 16-byte aligned, or the wrapper raises.

In explanation mode the scale is detached, so the backward is K2 of
``bcos_conv1x1`` with mult = 1 and no ReLU mask: dx = (g * |u|/n) @ w^T,
the explain branch of the JAX ``_bwd``. dw is not needed for W(x) and is
not computed; training gradients come with the training port.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from bcosification_tpu_torch.ops.cuda import _build
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import (
    _DTYPE_CODE,
    check_device,
    check_int32,
    check_operands,
    check_tma,
    conv1x1_bwd_explain,
)

__all__ = ["bcos_matmul", "bcos_matmul_fwd", "bcos_matmul_fwd_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_I, _P, _P, _P, _I, _I, _I, _F, _I, _P)


def bcos_matmul_fwd_plain(x, wt, *, eps: float, eps_outside: bool):
    """Plain version of K3 (f32 accumulation and epilogue, f32 out)."""
    xf = x.float()
    u = xf @ wt.float().t()
    ssq = (xf * xf).sum(-1, keepdim=True)
    n = torch.sqrt(ssq) + eps if eps_outside else torch.sqrt(ssq + eps)
    return u * (u.abs() / n)


def bcos_matmul_fwd(x, wt, *, eps: float, eps_outside: bool):
    """K3 on x [M, K], wt [N, K] (same dtype) -> f32 [M, N], through the
    custom op ``torch.ops.bcos_torch.bcos_matmul_fwd`` (CPU: the plain
    version; CUDA: the kernel, counted in ``bcos_matmul_fwd.launches``)."""
    check_operands("bcos_matmul_fwd", x, wt)
    check_device("bcos_matmul_fwd", x)
    return torch.ops.bcos_torch.bcos_matmul_fwd(x, wt, eps, eps_outside)


@torch.library.custom_op("bcos_torch::bcos_matmul_fwd", mutates_args=(), device_types="cuda")
def _bcos_matmul_fwd_op(x: Tensor, wt: Tensor, eps: float, eps_outside: bool) -> Tensor:
    m, k = x.shape
    n = wt.shape[0]
    check_int32("bcos_matmul_fwd", x.numel(), wt.numel(), m * n)
    check_tma("bcos_matmul_fwd", x, wt)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("bcos_matmul_fwd", _ARGS)
    with torch.cuda.device(x.device):
        code = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), wt.data_ptr(), y.data_ptr(), m, k, n,
                  eps, int(eps_outside), torch.cuda.current_stream().cuda_stream)
    _build.check("bcos_matmul_fwd", code)
    bcos_matmul_fwd.launches += 1
    return y


@_bcos_matmul_fwd_op.register_kernel("cpu")
def _bcos_matmul_fwd_cpu(x, wt, eps, eps_outside):
    return bcos_matmul_fwd_plain(x, wt, eps=eps, eps_outside=eps_outside)


@_bcos_matmul_fwd_op.register_fake
def _bcos_matmul_fwd_fake(x, wt, eps, eps_outside):
    return x.new_empty((x.shape[0], wt.shape[0]), dtype=torch.float32)


bcos_matmul_fwd.launches = 0


class _BcosMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wt, eps: float, eps_outside: bool, explain: bool):
        ctx.save_for_backward(x, wt)
        ctx.eps, ctx.eps_outside, ctx.explain = eps, eps_outside, explain
        return bcos_matmul_fwd(x, wt, eps=eps, eps_outside=eps_outside)

    @staticmethod
    def backward(ctx, gy):
        if not ctx.explain:
            raise NotImplementedError(
                "bcos_matmul: only the explanation-mode backward (explain=True) "
                "is implemented; training gradients are not ported yet"
            )
        x, wt = ctx.saved_tensors
        dx = conv1x1_bwd_explain(x, wt, gy.to(x.dtype).contiguous(), None, None,
                                 relu=False, eps=ctx.eps, eps_outside=ctx.eps_outside)
        return dx, None, None, None, None


def bcos_matmul(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                eps_outside: bool = False, explain: bool = False) -> torch.Tensor:
    """y = (|x@w| / n(x)) * (x@w) for x [M, K], w [K, N] -> f32 [M, N].

    eps_outside=False: n = sqrt(ssq + eps) (conv patch-norm semantics);
    True: n = sqrt(ssq) + eps (linear semantics). w is cast to x's dtype.
    """
    wt = w.t().to(x.dtype).contiguous()
    return _BcosMatmul.apply(x.contiguous(), wt, eps, eps_outside, explain)
