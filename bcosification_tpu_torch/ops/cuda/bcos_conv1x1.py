"""Fused 1x1 B-cos conv (b=2) + folded uncentered-BN affine + ReLU: the
Hopper kernels K1 (forward) and K2 (explanation backward).

Counterpart of ``bcosification_tpu/ops/pallas/bcos_conv1x1.py``. About two
thirds of a B-cosified ResNet's trunk are 1x1 B-cos convs followed by an
eval-mode uncentered BN (a per-channel multiply, plus a bias when kept) and
usually a ReLU. On pixels-by-channels matrices:

    u = x @ w;  n = sqrt(sum_c x^2 + eps);  z = (|u|/n) * u * mult + add
    a = relu(z)  (optional)

K1 (``csrc/bcos_conv1x1_fwd.cu``) computes a in one pass over x, with the
row norm summed from the same tiles and u kept on chip. K2
(``csrc/bcos_conv1x1_bwd.cu``) is the explanation-mode input cotangent,
with the dynamic scale |u|/n detached and u recomputed:

    dx = ((ct * mult * [a > 0]) * |x @ w| / n) @ w^T

In bf16 both run on the TMA + wgmma engine of ``csrc/bcos_engine.cuh``;
in fp32 both run the 3xTF32 route of ``csrc/bcos_tf32.cuh`` on the same
engine, with w split into tf32 hi and lo in a scratch that the wrapper
allocates (``fwd_scratch``, ``bwd_scratch``) and, at small M, K split
(``tf32_splits``). TMA tile loads need rows of whole 16-byte units and
16-byte aligned data: a Cin off the grid (8 bf16, 4 fp32) is zero-padded
in x and w (and K2's dx sliced back), and a misaligned operand gets an
aligned copy, before the launch (``tma_operands``, counted in
``tma_operands.padded``). K2 in bf16 with Cout above ``FUSED_MAX_COUT``,
and in fp32 always, writes g to a scratch and runs dx = g @ w as a second
launch (one op call, one count).

Each kernel has a wrapper that checks its operands and a plain PyTorch
version with the same signature. The wrapper calls a ``torch.library``
custom op (``torch.ops.bcos_torch.conv1x1_fwd`` and ``.conv1x1_bwd_explain``)
whose CPU implementation is the plain version and whose CUDA
implementation launches the kernel and counts the launch
(``conv1x1_fwd.launches``, ``conv1x1_bwd_explain.launches``); a CUDA
tensor reaches the kernel or an exception. Each op has a shape function
(``register_fake``), so ``torch.export`` traces through it. Outside
tracing, a wrapper given a CUDA tensor calls its op's CUDA implementation
directly (``eager_cuda``): the dispatcher's Python layers cost about as
much host time as the rest of a small call. Operands are
[M, Cin] activations (NHWC flattened), the weight as wt [Cout, Cin] (a 1x1
OIHW weight viewed as a matrix), and f32 mult/add.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from bcosification_tpu_torch.ops.cuda import _build

__all__ = [
    "CONV_NORM_EPS",
    "bcos_conv1x1_bn_act",
    "conv1x1_fwd",
    "conv1x1_fwd_plain",
    "conv1x1_bwd_explain",
    "conv1x1_bwd_explain_plain",
]

CONV_NORM_EPS = 1e-6
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P)
_BWD_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P)
_INT32_MAX = 2**31 - 1
# bf16 K2 keeps g [rows, Cout] in shared memory up to this Cout; beyond it,
# g goes through a scratch [M, round_up(Cout, 8)] (csrc/bcos_conv1x1_bwd.cu)
FUSED_MAX_COUT = 1024


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def eager_cuda(x: Tensor) -> bool:
    """Whether x is a plain CUDA tensor outside tracing (torch.export,
    torch.compile): then a wrapper calls its op's CUDA implementation
    itself and skips the custom op's autograd and backend layers in
    Python. Under tracing the op stays in the graph; on the CPU it runs the
    plain version."""
    return type(x) is Tensor and x.is_cuda and not torch.compiler.is_compiling()


def launch(name: str, argtypes, device: torch.device, *args) -> None:
    """Call the C launcher ``name`` with ``args`` and the raw handle of
    ``device``'s current stream, with ``device`` current, and raise on the
    CUDA error code it returns."""
    with torch.cuda._DeviceGuard(device.index):
        code = _build.function(name, argtypes)(
            *args, torch._C._cuda_getCurrentRawStream(device.index))
    _build.check(name, code)


def check_int32(name: str, *sizes) -> None:
    """Raise if a size the kernel indexes with 32-bit ints is beyond them
    (checked at launch, where the sizes are concrete)."""
    if max(sizes) > _INT32_MAX:
        raise ValueError(f"{name}: operands beyond 32-bit sizes")


def check_operands(name: str, x2: torch.Tensor, wt: torch.Tensor, *,
                   mn=(), vec=()) -> None:
    """Raise unless x2 [M, K] and wt [N, K] share a supported dtype and
    device, every [M, N] tensor in ``mn`` has their dtype, every vector in
    ``vec`` is f32 [N], and all are contiguous (None entries are skipped)."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x2.dtype} not supported (float32, bfloat16)")
    if x2.dim() != 2 or wt.dim() != 2 or wt.shape[1] != x2.shape[1]:
        raise ValueError(f"{name}: need x [M, K] and wt [N, K], got "
                         f"{tuple(x2.shape)} and {tuple(wt.shape)}")
    m, n = x2.shape[0], wt.shape[0]
    tensors = [("x", x2, x2.dtype, x2.shape), ("wt", wt, x2.dtype, wt.shape)]
    tensors += [(k, t, x2.dtype, (m, n)) for k, t in mn]
    tensors += [(k, t, torch.float32, (n,)) for k, t in vec]
    for key, t, dtype, shape in tensors:
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x2.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} must be {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def tma_operands(x2: torch.Tensor, wt: torch.Tensor):
    """(x2, wt) as the kernels' TMA loads need them: rows of whole 16-byte
    units (a multiple of 8 bf16 or 4 fp32 elements) and 16-byte aligned
    data. Every K1, K2 and K3 launch loads by TMA in both dtypes (fp32 on
    the 3xTF32 route). A Cin off that grid is zero-padded in both (zeros
    change neither x2 @ wt^T nor the row sum of squares); a misaligned
    operand gets an aligned contiguous copy. The shape and the pointers
    decide, before any launch; each call that changes an operand adds one
    to ``tma_operands.padded``."""
    pad = -x2.shape[1] % (16 // x2.element_size())
    x_new, wt_new = x2, wt
    if pad:
        x_new = torch.nn.functional.pad(x2, (0, pad))
        wt_new = torch.nn.functional.pad(wt, (0, pad))
    if x_new.data_ptr() % 16:
        x_new = x_new.clone(memory_format=torch.contiguous_format)
    if wt_new.data_ptr() % 16:
        wt_new = wt_new.clone(memory_format=torch.contiguous_format)
    if x_new is not x2 or wt_new is not wt:
        tma_operands.padded += 1
    return x_new, wt_new


tma_operands.padded = 0


# the fp32 route's tiles (csrc/bcos_tf32.cuh): 128 x 128 outputs, 32-deep stages
TF32_TILE, TF32_DEPTH = 128, 32
MIN_SPLIT_STAGES, MAX_SPLITS = 4, 16


def tf32_splits(m: int, k: int, n: int, sms: int) -> int:
    """K splits of one fp32-route GEMM ([m, n] out of a k-deep contraction)
    on a card of ``sms`` SMs: 1 where its 128 x 128 tiles fill at least half
    the SMs, else as many as fill them with at least MIN_SPLIT_STAGES
    stages each (at most MAX_SPLITS). At one 224^2 image (M = 49 to 196) a
    128 x 128 tiling leaves most SMs idle while each block walks a 64-stage
    chain (PERF.md)."""
    tiles = -(-m // TF32_TILE) * -(-n // TF32_TILE)
    stages = -(-k // TF32_DEPTH)
    if 2 * tiles > sms:
        return 1
    splits = min(stages // MIN_SPLIT_STAGES, sms // tiles, MAX_SPLITS)
    if splits < 2:
        return 1
    chunk = -(-stages // splits)
    return -(-stages // chunk)  # no split left without stages


def fwd_scratch(m: int, k: int, n: int, dtype: torch.dtype, device, splits: int = 1):
    """K1's and K3's scratch for x [m, k] and wt [n, k]: fp32, wt's tf32 hi
    and lo (2 n k floats) and the partial sums of ``splits`` K splits
    (``csrc/bcos_conv1x1_fwd.cu``, ``csrc/bcos_matmul_fwd.cu``); bf16 needs
    none."""
    if dtype == torch.float32:
        return torch.empty(2 * n * k + split_floats(m, n, splits), dtype=dtype, device=device)
    return None


def split_floats(m: int, n: int, splits: int) -> int:
    """Floats of split-K's partial sums ([splits, round_up(m, 128),
    round_up(n, 4)]) and row squares ([splits, round_up(m, 128)])."""
    if splits == 1:
        return 0
    return splits * -(-m // TF32_TILE) * TF32_TILE * ((n + 3) // 4 * 4 + 1)


_SMS = {}


def sm_count(device) -> int:
    """The SMs of a CUDA device (cached)."""
    index = torch.device(device).index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def check_device(name: str, x: torch.Tensor) -> None:
    """Raise unless x lies on the CPU (the op runs the plain version) or on a
    CUDA device (the op launches the kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {x.device} are not supported")


def _row_norm(xf: torch.Tensor, eps: float, eps_outside: bool) -> torch.Tensor:
    ssq = (xf * xf).sum(-1, keepdim=True)
    return torch.sqrt(ssq) + eps if eps_outside else torch.sqrt(ssq + eps)


# --------------------------------------------------------------------------
# K1: forward
# --------------------------------------------------------------------------
def conv1x1_fwd_plain(x2, wt, mult, add, *, relu: bool, eps: float = CONV_NORM_EPS):
    """Plain version of K1: f32 accumulation and epilogue, one cast."""
    xf = x2.float()
    u = xf @ wt.float().t()
    z = (u.abs() / _row_norm(xf, eps, False)) * u * mult
    if add is not None:
        z = z + add
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x2.dtype)


def conv1x1_fwd(x2, wt, mult, add, *, relu: bool, eps: float = CONV_NORM_EPS):
    """K1 on x2 [M, Cin], wt [Cout, Cin], mult/add f32 [Cout] (add may be
    None) -> [M, Cout] in x2's dtype."""
    check_operands("conv1x1_fwd", x2, wt, vec=(("mult", mult), ("add", add)))
    if mult is None:
        raise ValueError("conv1x1_fwd: mult is required")
    check_device("conv1x1_fwd", x2)
    if eager_cuda(x2):
        return _conv1x1_fwd_cuda(x2, wt, mult, add, relu, eps)
    return torch.ops.bcos_torch.conv1x1_fwd(x2, wt, mult, add, relu, eps)


def _conv1x1_fwd_cuda(x2: Tensor, wt: Tensor, mult: Tensor, add: Optional[Tensor], relu: bool,
                      eps: float) -> Tensor:
    m, k = x2.shape
    n = wt.shape[0]
    check_int32("conv1x1_fwd", x2.numel(), wt.numel(), m * n)
    x2, wt = tma_operands(x2, wt)
    k = x2.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    splits = tf32_splits(m, k, n, sm_count(x2.device)) if x2.dtype == torch.float32 else 1
    scratch = fwd_scratch(m, k, n, x2.dtype, x2.device, splits)
    launch("bcos_conv1x1_fwd", _FWD_ARGS, x2.device, _DTYPE_CODE[x2.dtype], _ptr(x2),
           _ptr(wt), _ptr(mult), _ptr(add), _ptr(out), _ptr(scratch), m, k, n, eps, int(relu),
           splits)
    conv1x1_fwd.launches += 1
    return out


_conv1x1_fwd_op = torch.library.custom_op("bcos_torch::conv1x1_fwd", mutates_args=(),
                                          device_types="cuda")(_conv1x1_fwd_cuda)


@_conv1x1_fwd_op.register_kernel("cpu")
def _conv1x1_fwd_cpu(x2, wt, mult, add, relu, eps):
    return conv1x1_fwd_plain(x2, wt, mult, add, relu=relu, eps=eps)


@_conv1x1_fwd_op.register_fake
def _conv1x1_fwd_fake(x2, wt, mult, add, relu, eps):
    return x2.new_empty((x2.shape[0], wt.shape[0]))


conv1x1_fwd.launches = 0


# --------------------------------------------------------------------------
# K2: explanation-mode backward
# --------------------------------------------------------------------------
def conv1x1_bwd_explain_plain(x2, wt, ct, a, mult, *, relu: bool,
                              eps: float = CONV_NORM_EPS, eps_outside: bool = False):
    """Plain version of K2: g in f32, rounded to x's dtype, f32 contraction."""
    xf, wf = x2.float(), wt.float()
    u = xf @ wf.t()
    g = ct.float()
    if mult is not None:
        g = g * mult
    if relu:
        g = torch.where(a.float() > 0, g, torch.zeros_like(g))
    g = (g * (u.abs() / _row_norm(xf, eps, eps_outside))).to(x2.dtype)
    return (g.float() @ wf).to(x2.dtype)


def conv1x1_bwd_explain(x2, wt, ct, a, mult, *, relu: bool,
                        eps: float = CONV_NORM_EPS, eps_outside: bool = False):
    """K2: dx [M, Cin] from x2 [M, Cin], wt [Cout, Cin], ct [M, Cout], the
    layer output a [M, Cout] (read only when relu) and f32 mult [Cout]
    (None means 1)."""
    check_operands("conv1x1_bwd_explain", x2, wt,
                   mn=(("ct", ct), ("a", a)), vec=(("mult", mult),))
    if ct is None or (relu and a is None):
        raise ValueError("conv1x1_bwd_explain: ct, and a when relu, are required")
    check_device("conv1x1_bwd_explain", x2)
    args = (x2, wt, ct, a if relu else None, mult, relu, eps, eps_outside)
    if eager_cuda(x2):
        return _conv1x1_bwd_cuda(*args)
    return torch.ops.bcos_torch.conv1x1_bwd_explain(*args)


def _conv1x1_bwd_cuda(x2: Tensor, wt: Tensor, ct: Tensor, a: Optional[Tensor],
                      mult: Optional[Tensor], relu: bool, eps: float,
                      eps_outside: bool) -> Tensor:
    m, k = x2.shape
    n = wt.shape[0]
    check_int32("conv1x1_bwd_explain", x2.numel(), wt.numel(), m * n)
    cin = k
    x2, wt = tma_operands(x2, wt)
    k = x2.shape[1]
    dx = torch.empty((m, k), dtype=x2.dtype, device=x2.device)
    splits = (1, 1)
    if x2.dtype == torch.float32:
        sms = sm_count(x2.device)
        splits = (tf32_splits(m, k, n, sms), tf32_splits(m, n, k, sms))
    g = bwd_scratch(m, k, n, x2.dtype, x2.device, splits)
    launch("bcos_conv1x1_bwd_explain", _BWD_ARGS, x2.device, _DTYPE_CODE[x2.dtype], _ptr(x2),
           _ptr(wt), _ptr(ct), _ptr(a), _ptr(mult), _ptr(dx), _ptr(g), m, k, n, eps,
           int(eps_outside), int(relu), *splits)
    conv1x1_bwd_explain.launches += 1
    return dx if k == cin else dx[:, :cin].contiguous()


_conv1x1_bwd_op = torch.library.custom_op("bcos_torch::conv1x1_bwd_explain", mutates_args=(),
                                          device_types="cuda")(_conv1x1_bwd_cuda)


def bwd_scratch(m: int, k: int, n: int, dtype: torch.dtype, device,
                splits=(1, 1)) -> Optional[Tensor]:
    """K2's scratch for x [m, k] (k on the TMA grid) and Cout n: bf16 above
    FUSED_MAX_COUT, g [m, round_up(n, 8)]; fp32 always, g [m, np], wt's tf32
    hi and lo as [n, k] and transposed [k, np] (np = round_up(n, 4)), and
    the partial sums of the g and dx GEMMs in ``splits`` K splits
    (``csrc/bcos_conv1x1_bwd.cu``); else None."""
    if dtype == torch.float32:
        np_ = (n + 3) // 4 * 4
        part = max(split_floats(m, n, splits[0]), split_floats(m, k, splits[1]))
        return torch.empty(m * np_ + 2 * n * k + 2 * k * np_ + part, dtype=dtype,
                           device=device)
    if n > FUSED_MAX_COUT:
        return torch.empty((m, (n + 7) // 8 * 8), dtype=dtype, device=device)
    return None


@_conv1x1_bwd_op.register_kernel("cpu")
def _conv1x1_bwd_cpu(x2, wt, ct, a, mult, relu, eps, eps_outside):
    return conv1x1_bwd_explain_plain(x2, wt, ct, a, mult, relu=relu, eps=eps,
                                     eps_outside=eps_outside)


@_conv1x1_bwd_op.register_fake
def _conv1x1_bwd_fake(x2, wt, ct, a, mult, relu, eps, eps_outside):
    return torch.empty_like(x2)


conv1x1_bwd_explain.launches = 0


# --------------------------------------------------------------------------
# autograd + the public NHWC entry
# --------------------------------------------------------------------------
class _Conv1x1BnAct(torch.autograd.Function):
    """K1 forward; K2 as the explanation-mode backward. Only x gets a
    gradient: in explanation mode the weights, the norm and the affine are
    constants. The train step never reaches K1 (its BN uses batch
    statistics, which fold into no affine), so there is no other backward."""

    @staticmethod
    def forward(ctx, x2, wt, mult, add, relu: bool, explain: bool):
        out = conv1x1_fwd(x2, wt, mult, add, relu=relu)
        ctx.save_for_backward(x2, wt, mult, out)
        ctx.relu, ctx.explain = relu, explain
        return out

    @staticmethod
    def backward(ctx, ct):
        if not ctx.explain:
            raise NotImplementedError(
                "bcos_conv1x1_bn_act: only the explanation-mode backward "
                "(explain=True) is implemented; a train step (train=True) runs the "
                "unfused conv and BN instead"
            )
        x2, wt, mult, out = ctx.saved_tensors
        dx = conv1x1_bwd_explain(x2, wt, ct.contiguous(), out if ctx.relu else None,
                                 mult, relu=ctx.relu)
        return dx, None, None, None, None, None


def bcos_conv1x1_bn_act(
    x4: torch.Tensor,
    w: torch.Tensor,
    mult: torch.Tensor,
    add: Optional[torch.Tensor],
    *,
    relu: bool,
    explain: bool,
    stride: int = 1,
) -> torch.Tensor:
    """Fused b=2 B-cos 1x1 conv + per-channel affine + optional ReLU.

    x4 NHWC; w [Cin, Cout] (the JAX layout; a transposed view of the OIHW
    weight is fine); mult/add per channel (BN eval: weight/std, bias or
    None). ``stride`` > 1 takes ``x4[:, ::stride, ::stride]`` first (a 1x1
    conv without padding only reads those pixels). The weight is cast to
    x's dtype, as the JAX package does.
    """
    if stride != 1:
        x4 = x4[:, ::stride, ::stride]
    n, h, w_, c = x4.shape
    x2 = x4.reshape(n * h * w_, c).contiguous()
    wt = w.t().to(x2.dtype).contiguous()
    mult = mult.to(torch.float32).contiguous()
    if add is not None:
        add = add.to(torch.float32).contiguous()
    out = _Conv1x1BnAct.apply(x2, wt, mult, add, relu, explain)
    return out.view(n, h, w_, -1)
