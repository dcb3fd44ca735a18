"""What the emulation tests of the port's CUDA sources share
(``tests/test_torch_cuda_emulation_k1.py``, ``_k2.py``, ``_k3.py``, one file
per kernel, so that the test runner's workers take them apart): the
sources run on the CPU through a stand-in for the CUDA runtime
(tests/cuda_emu/), each kernel against its plain version on ragged shapes,
both dtypes. This checks the kernels' tiling, index and masking logic
without a GPU; the real compiler and hardware are checked by chip_smoke.py
and the `cuda` tests on a GPU machine.

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
        # K2's 128-row blocks need two row blocks per SM: 132 SMs on the H100,
        # the stand-in's EMU_SMS here
        if path.name == "bcos_conv1x1_bwd.cu":
            assert "kRows128MinM = 2 * 132 * 128" in text, "K2's 128-row threshold was reworded"
        text = text.replace("kRows128MinM = 2 * 132 * 128", f"kRows128MinM = 2 * {EMU_SMS} * 128")
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


def emulated_library(tmp_path_factory, source: str) -> ctypes.CDLL:
    """The kernel source ``csrc/<source>`` compiled for the stand-in, its
    entry point typed as the wrapper types it."""
    cdll = compile_emulated([_build.CSRC / source], tmp_path_factory.mktemp("cuda_emu"))
    for name, args in (("bcos_conv1x1_fwd", k12._FWD_ARGS),
                       ("bcos_conv1x1_bwd_explain", k12._BWD_ARGS),
                       ("bcos_matmul_fwd", k3._ARGS)):
        if hasattr(cdll, name):
            getattr(cdll, name).argtypes = args
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


def _k1(emulated, x, wt, mult, add, relu):
    """z from the emulated K1, the operands padded and the scratch allocated
    as the wrapper does (``tma_operands``, ``fwd_scratch``, ``tf32_splits``;
    the scratch filled with NaN, so a read of what no launch wrote shows)."""
    x, wt = k12.tma_operands(x, wt)
    m, k = x.shape
    n = wt.shape[0]
    out = torch.empty(m, n, dtype=x.dtype)
    splits = k12.tf32_splits(m, k, n, EMU_SMS) if x.dtype == torch.float32 else 1
    scratch = k12.fwd_scratch(m, k, n, x.dtype, x.device, splits)
    if scratch is not None:
        scratch.fill_(float("nan"))
    code = emulated.bcos_conv1x1_fwd(k12._DTYPE_CODE[x.dtype], _ptr(x), _ptr(wt), _ptr(mult),
                                     _ptr(add), _ptr(out), _ptr(scratch), m, k, n, 1e-6, relu,
                                     splits, None)
    assert code == 0
    return out


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


# The fp32 route of K1, K2 and K3 (3xTF32 wgmma, csrc/bcos_tf32.cuh) at ragged
# shapes: M = 49 (layer4 of one 224^2 image) and 3 * 128 + 13 (whole row
# blocks and a ragged one, as layer1's 3136 + 13), N = 1000 (y by TMA) and N % 4 != 0 (y from the
# registers; g's scratch rows padded to 4), K % 4 != 0 (zero-padded by
# tma_operands) and a deep K (32 stages); K1 with the ReLU on and off, the
# add present and None; K3 with both eps_outside values, K2 with the mask
# and mult and without (``_check_k2``). The stand-in reads
# tf32 as the tensor cores do, so a single tf32 pass would miss these
# bounds by ~100x (tests/test_torch_kernels.py holds the scheme itself).
# On the stand-in's two SMs a launch of one 128 x 128 tile runs split-K:
# K1, K3 and K2's g at K = 1022 (2 splits of 16 stages; one accumulator
# over each split's chain, without the per-stage promotion, misses K1's
# bound 5x there), K2's dx at Cout = 266 (2 splits of 9 stages). The ids
# keep the names of the cases these shapes replaced, at which the stand-in
# took ~4x as long for the same tiles, masks and splits: M = 3149, K = 2046
# and N = 1030.
FP32_ROUTE_SHAPES = [(49, 30, 1000), (397, 64, 130), (49, 1022, 61), (49, 100, 266)]
FP32_ROUTE_IDS = ["m49-k30-n1000", "m3149-k64-n130", "m49-k2046-n61", "m49-k100-n1030"]


def _check_k2(emulated, dtype, m, k, n, tol=None):
    x, wt, mult, add, ct = _operands(m, k, n, dtype, 1)
    a = k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True)
    for relu, mu, eps_outside in ((1, mult, 0), (0, None, 1)):
        dx = _k2(emulated, x, wt, ct, a, mu, relu, eps_outside)
        want = k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mu, relu=bool(relu),
                                             eps_outside=bool(eps_outside))
        _assert_close(dx, want, dtype, tol)
