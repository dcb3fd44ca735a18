"""The int8 x int8 -> int32 product of the dynamic-int8 serving route
(``ops/bcos.py``'s ``conv_int8_dynamic``, ``BCOS_INT8=1``).

The JAX package runs this product as an XLA conv with int32 accumulation,
not as a Pallas kernel, so the port runs it on a library matmul,
``torch._int_mm`` (cuBLASLt's int8 GEMM on the card, a CPU kernel
elsewhere): a 1x1 ungrouped conv is one [N * Ho * Wo, Cin] x [Cin, Cout]
product of the (strided) pixels, any other conv an im2col of the int8
values and one product per group. On the card ``_int_mm`` wants more than
16 rows and both inner sizes multiples of 8: the operands are zero-padded
to that, which integer arithmetic makes exact, and the result cut back.
``int8_product_plain`` is the exact plain version, a float64 conv of the
same integers (every partial sum is an integer below 2^53).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

__all__ = ["int_mm", "int8_product", "int8_product_plain"]

IntOrPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def int_mm(a: Tensor, b: Tensor) -> Tensor:
    """int32 [M, N] = a [M, K] @ b [K, N], both int8, on ``torch._int_mm``,
    zero-padded to M > 16 and K and N multiples of 8 (the card's rules)."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    bt = b.t()  # [N, K]: _int_mm takes b column-major
    if pk or pn:
        bt = F.pad(bt, (0, pk, 0, pn))
    y = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return y[:m, :n] if (pm or pn) else y


def _out_size(size: int, k: int, s: int, p: int, d: int) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def int8_product(xq: Tensor, wq: Tensor, stride: IntOrPair = 1, padding: IntOrPair = 0,
                 dilation: IntOrPair = 1, groups: int = 1) -> Tensor:
    """int32 NHWC conv of the int8 NHWC xq with the int8 OIHW wq (zero
    padding), on ``int_mm``."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    n, h, w, c = xq.shape
    o, cg, kh, kw = wq.shape
    ho, wo = _out_size(h, kh, sh, ph, dh), _out_size(w, kw, sw, pw, dw)
    og = o // groups
    if (kh, kw) == (1, 1) and (ph, pw) == (0, 0) and groups == 1:
        cols = xq[:, ::sh, ::sw].reshape(1, n * ho * wo, c)
    else:
        xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
        taps = [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh, j * dw:j * dw + (wo - 1) * sw + 1:sw]
                for i in range(kh) for j in range(kw)]
        # [N, Ho, Wo, kh * kw, groups, Cin / groups] -> [groups, M, kh * kw * Cin / groups]
        cols = torch.stack(taps, dim=3).view(n * ho * wo, kh * kw, groups, cg)
        cols = cols.permute(2, 0, 1, 3).reshape(groups, n * ho * wo, kh * kw * cg)
    # [groups, kh * kw * Cin / groups, Cout / groups], rows in the columns' (tap, channel) order
    wcols = wq.view(groups, og, cg, kh, kw).permute(0, 3, 4, 2, 1).reshape(groups, -1, og)
    ys = [int_mm(cols[g], wcols[g]) for g in range(groups)]
    return (ys[0] if groups == 1 else torch.cat(ys, dim=-1)).view(n, ho, wo, o)


def int8_product_plain(xq: Tensor, wq: Tensor, stride: IntOrPair = 1, padding: IntOrPair = 0,
                       dilation: IntOrPair = 1, groups: int = 1) -> Tensor:
    """The plain version of ``int8_product``: the same conv in float64,
    exact for int8 operands, as int32."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=_pair(stride),
                 padding=_pair(padding), dilation=_pair(dilation), groups=groups)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)
