"""Core B-cos transform ops, NHWC, on PyTorch.

Counterpart of ``bcosification_tpu/ops/bcos.py``. The B-cos transform is

    out = |cos(x_patch, w_hat)|^(B-1) * (w_hat . x_patch)

Activations are NHWC tensors, as in the JAX package; internally a conv
runs on the channels-last NCHW view of the same storage (``nchw``), so a
1x1 conv is an [N*H*W, C] GEMM with no copy. Conv weights are OIHW, the
PyTorch layout, and map onto the JAX HWIO arrays by a transpose
(``bcosify/from_jax.py``).

``explain`` is the reference's ``detach`` flag: it detaches the dynamic
scale and the patch norm so the layer is linear in x, and W(x) is one
backward pass. The k x k convs stay on ``F.conv2d`` (cuDNN on the GPU); the
patch norm is the windowed sum of the per-pixel channel sum of squares,
``F.avg_pool2d(..., divisor_override=1)``. The 1x1, stride-1, bias-free b=2
conv is a B-cos matmul and goes to the hand-written kernel
(``ops/cuda/bcos_matmul.py``), and so does the bias-free b=2 linear, with
the linear norm sqrt(||x||^2) + 1e-12 (``eps_outside``): the JAX package
computes that one in XLA, the port on the same kernel as the 1x1 convs.

Dynamic-int8 serving (``BCOS_INT8=1``, off by default): a conv whose call
site allows it (``allow_int8``: the modules pass ``not explain and not
train``; ``bcos_conv2d`` defaults to ``not explain``) runs on int8
operands when x is bf16 and its input and output channels per group are
both at least ``BCOS_INT8_MIN_CH`` (default 128): a per-sample activation
scale (the max |x| over H, W and C over 127, at least 1e-12, or the fixed
``BCOS_INT8_SCALE``), a per-output-channel scale of the bf16 weight, round
half to even, clip to +-127, an int32 product (``ops/int8.py``:
``torch._int_mm``), then (y * (sx * sw)) in f32 cast to bf16. The round has
no gradient, so a backward through such a conv raises. The flag is read
when the conv runs: an exported program keeps the route it was traced
with. A 1x1 conv the gate takes does not go to K3.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.ops import int8

__all__ = [
    "CONV_NORM_EPS",
    "LINEAR_NORM_EPS",
    "COS_EPS",
    "nchw",
    "nhwc",
    "conv2d",
    "normed_conv_weight",
    "normed_linear_weight",
    "channel_sumsq",
    "patch_norms",
    "dynamic_scale",
    "bcos_conv2d",
    "bcos_linear",
    "normed_conv2d",
    "normed_linear",
    "int8_serving_enabled",
    "int8_route",
    "conv_int8_dynamic",
]

# Exact values matter for parity with the reference: conv patch norms add
# 1e-6 inside the sqrt, linear norms add 1e-12 after it, and the |cos| power
# path adds 1e-6 to |cos|.
CONV_NORM_EPS = 1e-6
LINEAR_NORM_EPS = 1e-12
COS_EPS = 1e-6

IntOrPair = Union[int, Tuple[int, int], Sequence[int]]
Number = Union[int, float]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 2, f"expected pair, got {v}"
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last strides when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(y: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view (contiguous when y is channels_last)."""
    return y.permute(0, 2, 3, 1)


def int8_serving_enabled() -> bool:
    """The opt-in dynamic-int8 serving flag, ``BCOS_INT8=1`` (default off)."""
    return os.getenv("BCOS_INT8", "0") == "1"


def int8_route(x: torch.Tensor, w: torch.Tensor, groups: int, allow_int8: bool) -> bool:
    """Whether a conv of x with the OIHW weight w runs on int8: its call
    site allows it, BCOS_INT8=1, x is bf16, and its per-group input and
    output channels are both at least BCOS_INT8_MIN_CH (default 128; 0
    quantizes every such conv)."""
    return bool(
        allow_int8 and int8_serving_enabled() and x.dtype == torch.bfloat16
        and min(w.shape[1], w.shape[0] // max(groups, 1))
        >= int(os.getenv("BCOS_INT8_MIN_CH", "128")))


class _Int8Conv(torch.autograd.Function):
    """``conv_int8_dynamic``'s value; differentiating it raises (the
    quantizer's round has no gradient, so a train step or an autograd
    explanation through it would be silently wrong)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        # every division by a tensor on x's device: PyTorch's CUDA divide by a
        # Python number multiplies by its reciprocal, which is not the IEEE
        # quotient the JAX package takes; the max of |x| is exact in x's dtype
        d127 = torch.full((), 127.0, device=x.device)
        fixed = os.getenv("BCOS_INT8_SCALE")
        if fixed is not None:  # one fixed activation scale (a measurement knob)
            sx = torch.full((x.shape[0], 1, 1, 1), float(fixed), device=x.device)
        else:  # per sample, so an image's result does not depend on its batch
            amax = x.abs().amax(dim=(1, 2, 3), keepdim=True).float()
            sx = torch.clamp_min(amax / d127, 1e-12)
        sw = torch.clamp_min(w.float().abs().amax(dim=(1, 2, 3)) / d127, 1e-12)
        xq = (x / sx).round_().clamp_(-127, 127).to(torch.int8)  # x / sx in f32
        wq = (w.float() / sw.view(-1, 1, 1, 1)).round_().clamp_(-127, 127).to(torch.int8)
        y = int8.int8_product(xq, wq, stride, padding, dilation, groups)
        return (y * (sx * sw)).to(x.dtype)  # float(y) * scale in f32, one cast

    @staticmethod
    def backward(ctx, ct):
        raise RuntimeError(
            "BCOS_INT8 quantized conv was differentiated. The dynamic-int8 serving path "
            "(BCOS_INT8=1) has zero gradients through its round() quantizer: training or "
            "autograd explanations under this flag would be silently broken. Unset BCOS_INT8 "
            "for training; it is a serving-only flag.")


def conv_int8_dynamic(x, w, stride: IntOrPair = 1, padding: IntOrPair = 0,
                      dilation: IntOrPair = 1, groups: int = 1) -> torch.Tensor:
    """The dynamically quantized conv of the bf16 NHWC x with the OIHW w
    (cast to x's dtype first, as the JAX package quantizes it), bf16 out.
    torch.export traces the forward only: an exported program has no
    backward to guard."""
    return _Int8Conv.apply(x, w.to(x.dtype), stride, padding, dilation, groups)


def conv2d(x, w, stride: IntOrPair = 1, padding: IntOrPair = 0,
           dilation: IntOrPair = 1, groups: int = 1, allow_int8: bool = False) -> torch.Tensor:
    """Plain conv of an NHWC input with an OIHW weight (cast to x's dtype);
    on int8 where ``int8_route`` takes it."""
    if int8_route(x, w, groups, allow_int8):
        return conv_int8_dynamic(x, w, stride, padding, dilation, groups)
    y = F.conv2d(nchw(x), w.to(x.dtype), stride=_pair(stride), padding=_pair(padding),
                 dilation=_pair(dilation), groups=groups)
    return nhwc(y)


def normed_conv_weight(w: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalise an OIHW conv weight per output channel (w / ||w||),
    optionally times a per-output-channel ``scale``."""
    w = w / torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True))
    if scale is not None:
        w = w * scale.reshape(-1, 1, 1, 1)
    return w


def normed_linear_weight(w: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalise an (in, out) linear weight per output feature (the JAX
    layout, x @ w), optionally times a per-output ``scale``."""
    w = w / torch.sqrt((w * w).sum(dim=0, keepdim=True))
    if scale is not None:
        w = w * scale.reshape(1, -1)
    return w


def channel_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel channel sum of squares, [N, H, W, 1] f32."""
    xf = x.float()
    return (xf * xf).sum(-1, keepdim=True)


def patch_norms(
    x: torch.Tensor,
    kernel_size: IntOrPair,
    *,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
    groups: int = 1,
    eps: float = CONV_NORM_EPS,
    x_sumsq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-patch L2 norms sqrt(||x_patch||^2 + eps) of an NHWC input,
    [N, Ho, Wo, groups] f32: the sum of squares over each group's channels,
    summed over each conv window (zero padding); a grouped conv's output
    channel takes its group's norm. ``x_sumsq`` is an optional
    ``channel_sumsq(x)`` (groups == 1 only)."""
    if groups == 1:
        ssq = channel_sumsq(x) if x_sumsq is None else x_sumsq.float()
    elif x_sumsq is not None:
        raise ValueError("patch_norms: the x_sumsq hint is for ungrouped convs only")
    else:
        xf = x.float()
        ssq = (xf * xf).reshape(*x.shape[:3], groups, x.shape[-1] // groups).sum(-1)
    kh, kw = _pair(kernel_size)
    ph, pw = _pair(padding)
    # [N, G, H, W] with contiguous strides, not the permuted view: PyTorch
    # takes that view for channels_last (with G = 1 it even counts as
    # contiguous, hence the reshape), and its CUDA avg_pool2d backward is
    # wrong for channels_last inputs (ops/pooling.py, PERF.md)
    n, h, w_, g = ssq.shape
    s = ssq.reshape(n, 1, h, w_) if g == 1 else nchw(ssq).contiguous()
    if _pair(dilation) == (1, 1) and 2 * ph <= kh and 2 * pw <= kw:
        s = F.avg_pool2d(s, (kh, kw), _pair(stride), (ph, pw), divisor_override=1)
    else:
        ones = torch.ones((groups, 1, kh, kw), dtype=s.dtype, device=s.device)
        s = F.conv2d(s, ones, stride=_pair(stride), padding=(ph, pw),
                     dilation=_pair(dilation), groups=groups)
    return torch.sqrt(nhwc(s) + eps)


def _per_group(out: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., O] -> [..., groups, O / groups]: each group's output channels."""
    return out.reshape(*out.shape[:-1], groups, out.shape[-1] // groups)


def dynamic_scale(out: torch.Tensor, norm: torch.Tensor, b, *, explain: bool = False):
    """The |cos|^(B-1) factor. ``explain`` detaches out and norm. A Python
    b == 2 takes the fast path |out|/norm; any other b (also a tensor) the
    stabilised power path (|out/norm| + 1e-6)^(b-1). A tensor b (learnable)
    promotes the factor to its dtype, as JAX promotes a bf16 activation
    with an f32 parameter."""
    if explain:
        out, norm = out.detach(), norm.detach()
    if isinstance(b, (int, float)) and b == 2:
        return out.abs() / norm
    abs_cos = (out / norm).abs() + COS_EPS
    if isinstance(b, torch.Tensor):
        abs_cos = abs_cos.to(torch.promote_types(abs_cos.dtype, b.dtype))
    return torch.pow(abs_cos, b - 1)


def _is_bcos_matmul(w, b, stride, padding, groups, max_out, bias) -> bool:
    return (
        isinstance(b, (int, float)) and b == 2
        and max_out == 1 and groups == 1 and bias is None
        and tuple(w.shape[2:]) == (1, 1)
        and _pair(stride) == (1, 1) and _pair(padding) == (0, 0)
    )


def bcos_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    b: Union[Number, torch.Tensor] = 2.0,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
    groups: int = 1,
    max_out: int = 1,
    normalize_weights: bool = True,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    explain: bool = False,
    x_sumsq: Optional[torch.Tensor] = None,
    allow_int8: Optional[bool] = None,
) -> torch.Tensor:
    """B-cos 2D convolution of an NHWC input with an OIHW weight.

    ``normalize_weights=True`` is ``BcosConv2d`` (unit-norm weights);
    ``False`` is ``BcosifyConv2d`` (raw weights, optional ``bias`` added to
    the linear output before the dynamic scale). A 1x1, stride-1, bias-free
    b=2 conv runs as the B-cos matmul kernel, unless the int8 route takes
    it. ``allow_int8`` (default ``not explain``): whether BCOS_INT8 may
    quantize this conv.
    """
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    out_channels = w.shape[0] // max_out
    wn = normed_conv_weight(w, scale) if normalize_weights else w
    allow_int8 = (not explain) if allow_int8 is None else allow_int8

    if (_is_bcos_matmul(w, b, stride, padding, groups, max_out, bias)
            and not int8_route(x, w, groups, allow_int8)):
        from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul

        n, h, w_, c = x.shape
        y = bcos_matmul(x.reshape(n * h * w_, c), wn.reshape(wn.shape[0], c).t(),
                        CONV_NORM_EPS, False, explain)
        return y.view(n, h, w_, -1).to(x.dtype)

    out = conv2d(x, wn, stride, padding, dilation, groups, allow_int8)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if max_out > 1:
        out = out.reshape(*out.shape[:-1], out_channels, max_out).amax(-1)
    if isinstance(b, (int, float)) and b == 1:
        return out
    norm = patch_norms(x, w.shape[2:], stride=stride, padding=padding, dilation=dilation,
                       groups=groups, x_sumsq=x_sumsq).to(out.dtype)
    if groups > 1:  # each group's norm over that group's output channels
        grouped = _per_group(out, groups)
        y = dynamic_scale(grouped, norm[..., None], b, explain=explain) * grouped
        return y.reshape(out.shape)
    return dynamic_scale(out, norm, b, explain=explain) * out


def bcos_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    b: Union[Number, torch.Tensor] = 2.0,
    max_out: int = 1,
    normalize_weights: bool = True,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    explain: bool = False,
) -> torch.Tensor:
    """B-cos linear transform over the last axis of x; w is (in, out * max_out).

    ``normalize_weights=True`` is ``BcosLinear``, ``False`` ``BcosifyLinear``
    (raw weights, optional ``bias`` before the dynamic scale). The norm is
    sqrt(||x||^2) + 1e-12. A bias-free b=2 linear without max-out runs as
    the B-cos matmul kernel (K3, ``eps_outside``); its result is cast to
    x's dtype.
    """
    out_features = w.shape[-1] // max_out
    wn = normed_linear_weight(w, scale) if normalize_weights else w
    if isinstance(b, (int, float)) and b == 2 and max_out == 1 and bias is None:
        from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul

        lead = x.shape[:-1]
        y = bcos_matmul(x.reshape(-1, x.shape[-1]), wn, LINEAR_NORM_EPS, True, explain)
        return y.view(*lead, y.shape[-1]).to(x.dtype)
    out = x @ wn.to(x.dtype)
    if bias is not None:
        out = out + bias
    if max_out > 1:
        out = out.reshape(*out.shape[:-1], out_features, max_out).amax(-1)
    if isinstance(b, (int, float)) and b == 1:
        return out
    xf = x.float()
    norm = (torch.sqrt((xf * xf).sum(-1, keepdim=True)) + LINEAR_NORM_EPS).to(out.dtype)
    return dynamic_scale(out, norm, b, explain=explain) * out


def normed_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: IntOrPair = 1,
                  padding: IntOrPair = 0, dilation: IntOrPair = 1, groups: int = 1,
                  scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                  use_weight_norm: bool = True, allow_int8: bool = False) -> torch.Tensor:
    """Plain conv of an NHWC input with unit-norm weights (``NormedConv2d``),
    optionally times a per-output-channel ``scale``; ``use_weight_norm=False``
    takes the raw weight. The bias is cast to the output's dtype."""
    wn = normed_conv_weight(w, scale) if use_weight_norm else w
    out = conv2d(x, wn, stride, padding, dilation, groups, allow_int8)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def normed_linear(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  use_weight_norm: bool = True) -> torch.Tensor:
    """Plain linear with unit-norm (in, out) weight columns (``NormedLinear``),
    optionally times a per-output ``scale``; the bias is added as it is."""
    wn = normed_linear_weight(w, scale) if use_weight_norm else w
    out = x @ wn.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out
