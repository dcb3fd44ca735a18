"""The port's CUDA sources, run on the CPU through a stand-in for the CUDA
runtime (tests/cuda_emu/): each kernel against its plain version on ragged
shapes, both dtypes. This checks the kernels' tiling, index and masking
logic without a GPU; the real compiler and hardware are checked by
chip_smoke.py and the `cuda` tests on a GPU machine.

The launches are rewritten into calls of the stand-in's launcher, the
headers of tests/cuda_emu/ take the place of the real ones of the same name
(hopper.cuh: TMA, mbarriers and wgmma as C++, so the bf16 engine of K1, K2
and K3 runs with its real descriptors and swizzles, f32 tiles included), and
the sources are
compiled with the host's g++ (C++20, for std::barrier).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from bcosification_tpu_torch.ops.cuda import _build
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3

torch.set_num_threads(1)
EMU = Path(__file__).resolve().parent / "cuda_emu"
# (M, Cin, Cout), ragged; bf16 Cin is a multiple of 8 (TMA's 16-byte rows);
# bf16 K3 stores y from the registers at all three (Cout % 4 != 0)
SHAPES = {torch.float32: [(37, 24, 10), (130, 200, 70), (5, 300, 129)],
          torch.bfloat16: [(37, 24, 10), (130, 200, 70), (5, 296, 129)]}
TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5}  # max |diff| / max |ref|
EMU_SMS = 2  # the stand-in's SM count (cuda_runtime.h), which the fp32 route's K splits read


def compile_emulated(sources, work: Path, defines=()) -> ctypes.CDLL:
    """The CUDA ``sources`` rewritten for the stand-in, compiled with g++ into
    one library under ``work`` (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA stand-in")
    def rewritten(path):
        text = re.sub(r"(\w+(?:<[\w:]+>)?)<<<(.*?)>>>\(",
                      lambda m: f"emu_launch({m.group(2)}, {m.group(1)}, ",
                      path.read_text(), flags=re.S)
        return re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
                      "unsigned char* smem = g_dyn_smem;", text)

    for header in _build.CSRC.glob("*.cuh"):
        (work / header.name).write_text(rewritten(header))
    for header in EMU.glob("*.cuh"):  # the stand-ins last
        shutil.copy(header, work / header.name)
    outs = []
    for src in sources:
        out = work / (src.stem + ".cpp")
        out.write_text(rewritten(src))
        outs.append(str(out))
    lib = work / "libbcos_kernels_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
           "-include", "cuda_runtime.h", "-include", "cuda_bf16.h",
           *(f"-D{d}" for d in defines), "-o", str(lib), *outs]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cdll = compile_emulated(sorted(_build.CSRC.glob("bcos_*.cu")),
                            tmp_path_factory.mktemp("cuda_emu"))
    cdll.bcos_conv1x1_fwd.argtypes = k12._FWD_ARGS
    cdll.bcos_conv1x1_bwd_explain.argtypes = k12._BWD_ARGS
    cdll.bcos_matmul_fwd.argtypes = k3._ARGS
    return cdll


def _ptr(t):
    return None if t is None else t.data_ptr()


def _operands(m, k, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(dtype)
    wt = (torch.randn(n, k, generator=g) / k ** 0.5).to(dtype)
    mult = torch.rand(n, generator=g) + 0.5
    add = torch.randn(n, generator=g)
    ct = torch.randn(m, n, generator=g).to(dtype)
    return x, wt, mult, add, ct


def _assert_close(got, want, dtype, tol=None):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (TOL[dtype] if tol is None else tol), err


CASES = [pytest.param(m, k, n, dtype, id=f"{m}-{k}-{n}-{name}")
         for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))
         for m, k, n in SHAPES[dtype]]


def _k2(emulated, x, wt, ct, a, mult, relu, eps_outside):
    """dx from the emulated K2, with the operands padded and the scratch
    allocated as the wrapper does (``tma_operands``, ``bwd_scratch``; the
    scratch filled with NaN, so a read of what no launch wrote shows)."""
    cin = x.shape[1]
    x, wt = k12.tma_operands(x, wt)
    m, k = x.shape
    n = wt.shape[0]
    dx = torch.empty(m, k, dtype=x.dtype)
    splits = (k12.tf32_splits(m, k, n, EMU_SMS), k12.tf32_splits(m, n, k, EMU_SMS))
    g = k12.bwd_scratch(m, k, n, x.dtype, x.device, splits)
    if g is not None:
        g.fill_(float("nan"))
    code = emulated.bcos_conv1x1_bwd_explain(
        k12._DTYPE_CODE[x.dtype], _ptr(x), _ptr(wt), _ptr(ct), _ptr(a) if relu else None,
        _ptr(mult), _ptr(dx), _ptr(g), m, k, n, 1e-6, eps_outside, relu, *splits, None)
    assert code == 0
    return dx[:, :cin]


def _k3(emulated, x, wt, eps_outside):
    """y from the emulated K3, the operands padded and the scratch allocated
    as the wrapper does (``tma_operands``, ``fwd_scratch``)."""
    x, wt = k12.tma_operands(x, wt)
    m, k = x.shape
    n = wt.shape[0]
    y = torch.empty(m, n)
    splits = k12.tf32_splits(m, k, n, EMU_SMS)
    scratch = k3.fwd_scratch(m, k, n, x.dtype, x.device, splits)
    if scratch is not None:
        scratch.fill_(float("nan"))
    code = emulated.bcos_matmul_fwd(k12._DTYPE_CODE[x.dtype], _ptr(x), _ptr(wt), _ptr(y),
                                    _ptr(scratch), m, k, n, 1e-6, eps_outside, splits, None)
    assert code == 0
    return y


@pytest.mark.parametrize("m,k,n,dtype", CASES)
def test_k1_forward(emulated, dtype, m, k, n):
    x, wt, mult, add, _ = _operands(m, k, n, dtype, 0)
    for relu, a in ((1, add), (0, None)):
        out = torch.empty(m, n, dtype=dtype)
        code = emulated.bcos_conv1x1_fwd(k12._DTYPE_CODE[dtype], _ptr(x), _ptr(wt), _ptr(mult),
                                         _ptr(a), _ptr(out), m, k, n, 1e-6, relu, None)
        assert code == 0
        _assert_close(out, k12.conv1x1_fwd_plain(x, wt, mult, a, relu=bool(relu)), dtype)


def _check_k2(emulated, dtype, m, k, n, tol=None):
    x, wt, mult, add, ct = _operands(m, k, n, dtype, 1)
    a = k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True)
    for relu, mu, eps_outside in ((1, mult, 0), (0, None, 1)):
        dx = _k2(emulated, x, wt, ct, a, mu, relu, eps_outside)
        want = k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mu, relu=bool(relu),
                                             eps_outside=bool(eps_outside))
        _assert_close(dx, want, dtype, tol)


@pytest.mark.parametrize("m,k,n,dtype", CASES)
def test_k2_explain_backward(emulated, dtype, m, k, n):
    _check_k2(emulated, dtype, m, k, n)


# The bf16 K2's paths, each through a real shape: Cout > 1024 (g through
# the scratch, two launches), Cout <= 1024 with 64-row blocks (16 slabs of
# g resident), 256 < Cout <= 512 at an M with 128-row blocks, and partial
# TMA boxes in Cin and Cout (small Cout: 64-row blocks, two per SM). The
# kernel sums u in another order than the plain version, which can move a
# g across a bf16 rounding boundary (one ulp, 2^-8 relative); over ~1000
# output channels such flips reach ~1e-3 of max |dx| (7.5e-4 at
# fused-64-rows, in 10 of 4480 elements), while a tiling or swizzle fault
# is of the order of max |dx| itself.
@pytest.mark.parametrize("m,k,n", [(37, 24, 1032), (70, 64, 1000), (33797, 8, 264),
                                   (130, 72, 136)],
                         ids=["split", "fused-64-rows", "fused-128-rows", "partial-boxes"])
def test_k2_bf16_paths(emulated, m, k, n):
    _check_k2(emulated, torch.bfloat16, m, k, n, tol=4e-3)


# K2 at a DenseNet conv1's width, Cout = 128 (one wgmma tile) and Cin 224
# (several TMA boxes): as K3's explanation backward (no mult, no mask, the
# conv's eps) and with the folded norm2 + act2 of the hand-scheduled pass
# (mult and mask), in both dtypes. bf16 is held to test_k2_bf16_paths'
# bound: a g that the kernel's summation order moves across a bf16
# rounding boundary (4.8e-4 of max |dx| here)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_at_the_densenet_width(emulated, dtype):
    tol = 4e-3 if dtype == torch.bfloat16 else None
    x, wt, mult, add, ct = _operands(200, 224, 128, dtype, 2)
    dx = _k2(emulated, x, wt, ct, None, None, 0, 0)
    _assert_close(dx, k12.conv1x1_bwd_explain_plain(x, wt, ct, None, None, relu=False), dtype,
                  tol)
    a = k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True)
    dx = _k2(emulated, x, wt, ct, a, mult, 1, 0)
    _assert_close(dx, k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, relu=True), dtype, tol)


# bf16 K1 stages z and stores it by TMA where Cout is a multiple of 8 (the
# shapes of CASES store from the registers): ragged M, partial boxes in Cin
# and Cout, several tiles per block
def test_k1_bf16_tma_store(emulated):
    test_k1_forward(emulated, torch.bfloat16, 130, 72, 264)


@pytest.mark.parametrize("m,k,n,dtype", CASES)
def test_k3_bcos_matmul(emulated, dtype, m, k, n):
    x, wt, _, _, _ = _operands(m, k, n, dtype, 2)
    for eps_outside in (0, 1):
        y = _k3(emulated, x, wt, eps_outside)
        _assert_close(y, k3.bcos_matmul_fwd_plain(x, wt, eps=1e-6,
                                                  eps_outside=bool(eps_outside)), dtype)


# bf16 K3 on the engine, each with both eps_outside values: N a multiple of
# 4 with a ragged last 128-column chunk (y staged in f32 and stored by TMA,
# clipped at N; rows of wt beyond N read as zeros), N % 4 != 0 (y from the
# registers), and an M that gives each of the stand-in's two blocks 8
# tiles (the one staging buffer refilled while the last store may still
# read it) with one partial K box; rows beyond M in a 128-row block; and the
# train step's layer1 conv1 (N = 64: half of one 128-column chunk, two of its
# four f32 boxes stored; K = 64: one K step)
@pytest.mark.parametrize("m,k,n", [(70, 512, 1000), (37, 72, 130), (1000, 16, 132),
                                   (300, 64, 64)],
                         ids=["ragged-chunk", "register-store", "many-tiles", "train-n64-k64"])
def test_k3_bf16_engine(emulated, m, k, n):
    test_k3_bcos_matmul(emulated, torch.bfloat16, m, k, n)


# The fp32 route of K3 and K2 (3xTF32 wgmma, csrc/bcos_tf32.cuh) at ragged
# shapes: M = 49 (layer4 of one 224^2 image) and 3136 + 13 (layer1 + a
# ragged row block), N = 1000 (y by TMA) and N % 4 != 0 (y from the
# registers; g's scratch rows padded to 4), K % 4 != 0 (zero-padded by
# tma_operands) and a deep K (64 stages); K3 with both eps_outside values,
# K2 with the mask and mult and without (``_check_k2``). The stand-in reads
# tf32 as the tensor cores do, so a single tf32 pass would miss these
# bounds by ~100x (tests/test_torch_kernels.py holds the scheme itself).
# On the stand-in's two SMs a launch of one 128 x 128 tile runs split-K:
# K3 and K2's g at m49-k2046-n61 (2 splits of 32 stages), K2's dx at
# m49-k100-n1030 (2 splits over Cout = 1030).
FP32_ROUTE_SHAPES = [(49, 30, 1000), (3149, 64, 130), (49, 2046, 61), (49, 100, 1030)]
FP32_ROUTE_IDS = ["m49-k30-n1000", "m3149-k64-n130", "m49-k2046-n61", "m49-k100-n1030"]


@pytest.mark.parametrize("m,k,n", FP32_ROUTE_SHAPES, ids=FP32_ROUTE_IDS)
def test_k3_fp32_route(emulated, m, k, n):
    test_k3_bcos_matmul(emulated, torch.float32, m, k, n)


@pytest.mark.parametrize("m,k,n", FP32_ROUTE_SHAPES, ids=FP32_ROUTE_IDS)
def test_k2_fp32_route(emulated, m, k, n):
    _check_k2(emulated, torch.float32, m, k, n)
