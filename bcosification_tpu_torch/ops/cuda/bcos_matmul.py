"""The B-cos matmul (b=2): the Hopper kernel K3 and its autograd.

Counterpart of ``bcosification_tpu/ops/pallas/bcos_matmul.py``:

    u = x @ w;  n = sqrt(ssq + eps)  or, with eps_outside, sqrt(ssq) + eps
    y = u * (|u| / n)           -> f32

with ssq the row sum of squares of x. K3 (``csrc/bcos_matmul_fwd.cu``) sums
ssq from the same tiles that feed the product and scales in the epilogue.
It carries every bias-free, stride-1 1x1 b=2 conv that ``ops.bcos.bcos_conv2d``
dispatches to it: in eval mode the GAP-reorder classifier, in training (where
the batch-statistics BN has no affine to fold into K1) also conv1 and conv3
of every bottleneck and the stride-1 downsample. In bf16 it
runs on the TMA + wgmma engine of ``csrc/bcos_engine.cuh``, in fp32 (every
encode of the clip_benchmark harness) on the 3xTF32 route of
``csrc/bcos_tf32.cuh`` over the same engine, with wt split into tf32 hi and
lo in a scratch the wrapper allocates (``fwd_scratch``). The tile loads
need rows of whole 16-byte units and 16-byte aligned data: a K off the grid
(8 bf16, 4 fp32) is zero-padded in x and wt, and a misaligned operand
copied, before the launch (``bcos_conv1x1.tma_operands``).

The backward is the JAX ``_bwd`` (``bcos_matmul.py:123-146``), which the
JAX package computes in XLA outside any Pallas kernel:

- explain (the scale detached): dx = (g * |u|/n) @ w^T is K2 of
  ``bcos_conv1x1`` with mult = 1 and no ReLU mask; dw = x^T @ (g * |u|/n),
  only when w needs a gradient (``_BcosMatmul.backward``);
- training: dy/du = 2|u|/n, plus the row term through n,
  dx = (g * 2|u|/n) @ w^T + (sum_j g * -|u|u/n^2) * dn/dx and
  dw = x^T @ (g * 2|u|/n) (``bcos_matmul_bwd``).

Both recompute u. Its three products run on ``torch.matmul`` in x's dtype
(bf16: f32 accumulation, rounded to bf16 once each), every other term in
f32. A fused backward kernel is later work.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import (
    _DTYPE_CODE,
    check_device,
    check_int32,
    check_operands,
    conv1x1_bwd_explain,
    eager_cuda,
    fwd_scratch,
    launch,
    sm_count,
    tf32_splits,
    tma_operands,
)

__all__ = ["bcos_matmul", "bcos_matmul_bwd", "bcos_matmul_fwd", "bcos_matmul_fwd_plain",
           "tf32_split"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_I, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P)


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
    version; CUDA: the kernel, counted in ``bcos_matmul_fwd.launches``,
    called directly outside tracing: ``bcos_conv1x1.eager_cuda``)."""
    check_operands("bcos_matmul_fwd", x, wt)
    check_device("bcos_matmul_fwd", x)
    if eager_cuda(x):
        return _bcos_matmul_fwd_cuda(x, wt, eps, eps_outside)
    return torch.ops.bcos_torch.bcos_matmul_fwd(x, wt, eps, eps_outside)


def _bcos_matmul_fwd_cuda(x: Tensor, wt: Tensor, eps: float, eps_outside: bool) -> Tensor:
    m, k = x.shape
    n = wt.shape[0]
    check_int32("bcos_matmul_fwd", x.numel(), wt.numel(), m * n)
    x, wt = tma_operands(x, wt)
    k = x.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = tf32_splits(m, k, n, sm_count(x.device)) if x.dtype == torch.float32 else 1
    scratch = fwd_scratch(m, k, n, x.dtype, x.device, splits)
    launch("bcos_matmul_fwd", _ARGS, x.device, _DTYPE_CODE[x.dtype], x.data_ptr(),
           wt.data_ptr(), y.data_ptr(), None if scratch is None else scratch.data_ptr(), m, k, n,
           eps, int(eps_outside), splits)
    bcos_matmul_fwd.launches += 1
    return y


_bcos_matmul_fwd_op = torch.library.custom_op("bcos_torch::bcos_matmul_fwd", mutates_args=(),
                                              device_types="cuda")(_bcos_matmul_fwd_cuda)


def tf32_split(a: Tensor):
    """(hi, lo) of an f32 tensor as the fp32 route splits its operands
    (``split_weight`` and the consumers' registers in ``csrc/bcos_tf32.cuh``):
    hi = a rounded to the nearest tf32, ties away from zero (cvt.rna: the low
    13 mantissa bits clear), lo = a - hi rounded the same way. The plain
    version of the split: hi + lo is a within ~2^-22 |a|, and the three
    products hi hi + hi lo + lo hi carry about fp32's accuracy."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        finite = (bits & 0x7F800000) != 0x7F800000
        # the magnitude bits rounded half away from zero; the sign bit stays
        rounded = (bits + 0x1000) & ~0x1FFF
        return torch.where(finite, rounded, bits).view(torch.float32)

    a = a.float()
    hi = rna(a)
    return hi, rna(a - hi)


@_bcos_matmul_fwd_op.register_kernel("cpu")
def _bcos_matmul_fwd_cpu(x, wt, eps, eps_outside):
    return bcos_matmul_fwd_plain(x, wt, eps=eps, eps_outside=eps_outside)


@_bcos_matmul_fwd_op.register_fake
def _bcos_matmul_fwd_fake(x, wt, eps, eps_outside):
    return x.new_empty((x.shape[0], wt.shape[0]), dtype=torch.float32)


bcos_matmul_fwd.launches = 0


def _forward_terms(x, wt, eps: float, eps_outside: bool):
    """(x in f32, u = x @ wt^T recomputed in x's dtype and taken to f32, the
    row ssq, n) of the forward."""
    xf = x.float()
    u = (x @ wt.t()).float()
    ssq = (xf * xf).sum(-1, keepdim=True)
    n = (torch.sqrt(ssq) + eps) if eps_outside else torch.sqrt(ssq + eps)
    return xf, u, ssq, n


def bcos_matmul_bwd(x, wt, gy, *, eps: float, eps_outside: bool, need_dx: bool = True,
                    need_dw: bool = True):
    """(dx, dwt) of y = bcos_matmul_fwd(x, wt) in training for the f32
    cotangent gy [M, N]: the JAX ``_bwd`` with wt = w^T. dx comes back in
    x's dtype, dwt in wt's; either is None when not asked for."""
    xf, u, ssq, n = _forward_terms(x, wt, eps, eps_outside)
    g = gy.float()
    gu = (g * (2.0 * u.abs() / n)).to(x.dtype)
    dx = dwt = None
    if need_dx:
        gn = (g * (-u.abs() * u / n.square())).sum(-1, keepdim=True)
        if eps_outside:
            dn_dx = xf / torch.clamp(torch.sqrt(ssq), min=1e-20)
        else:
            dn_dx = xf / torch.sqrt(ssq + eps)
        dx = ((gu @ wt).float() + gn * dn_dx).to(x.dtype)
    if need_dw:
        dwt = (gu.t() @ x).to(wt.dtype)
    return dx, dwt


class _BcosMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wt, eps: float, eps_outside: bool, explain: bool):
        ctx.save_for_backward(x, wt)
        ctx.eps, ctx.eps_outside, ctx.explain = eps, eps_outside, explain
        return bcos_matmul_fwd(x, wt, eps=eps, eps_outside=eps_outside)

    @staticmethod
    def backward(ctx, gy):
        x, wt = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        kw = dict(eps=ctx.eps, eps_outside=ctx.eps_outside)
        if not ctx.explain:
            dx, dwt = bcos_matmul_bwd(x, wt, gy, need_dx=need_dx, need_dw=need_dw, **kw)
            return dx, dwt, None, None, None
        dx = dwt = None
        if need_dx:
            dx = conv1x1_bwd_explain(x, wt, gy.to(x.dtype).contiguous(), None, None,
                                     relu=False, **kw)
        if need_dw:  # x^T (g |u|/n): the scale is detached
            _, u, _, n = _forward_terms(x, wt, **kw)
            dwt = ((gy.float() * (u.abs() / n)).to(x.dtype).t() @ x).to(wt.dtype)
        return dx, dwt, None, None, None


def bcos_matmul(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                eps_outside: bool = False, explain: bool = False) -> torch.Tensor:
    """y = (|x@w| / n(x)) * (x@w) for x [M, K], w [K, N] -> f32 [M, N].

    eps_outside=False: n = sqrt(ssq + eps) (conv patch-norm semantics);
    True: n = sqrt(ssq) + eps (linear semantics). w is cast to x's dtype.
    """
    wt = w.t().to(x.dtype).contiguous()
    return _BcosMatmul.apply(x.contiguous(), wt, eps, eps_outside, explain)
