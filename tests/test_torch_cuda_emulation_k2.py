"""K2 (``csrc/bcos_conv1x1_bwd.cu``) run on the CPU through the CUDA stand-in
(``tests/torch_cuda_emulation.py``) against its plain version: ragged
shapes in both dtypes, each bf16 path, the DenseNet width and the fp32
3xTF32 route.
"""
import pytest
import torch

from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from torch_cuda_emulation import (
    CASES, FP32_ROUTE_IDS, FP32_ROUTE_SHAPES, _assert_close, _check_k2, _k2, _operands,
    emulated_library,
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulated_library(tmp_path_factory, "bcos_conv1x1_bwd.cu")


@pytest.mark.parametrize("m,k,n,dtype", CASES)
def test_k2_explain_backward(emulated, dtype, m, k, n):
    _check_k2(emulated, dtype, m, k, n)


# The bf16 K2's paths, each through a real shape: Cout > 1024 (g through
# the scratch, two launches), Cout <= 1024 with 64-row blocks (16 slabs of
# g resident), 256 < Cout <= 512 at an M with 128-row blocks (two row
# blocks per SM: M >= 2 * 2 * 128 on the stand-in's 2 SMs, as M >= 33792
# on the H100's 132; a ragged last block), and partial
# TMA boxes in Cin and Cout (small Cout: 64-row blocks, two per SM). The
# kernel sums u in another order than the plain version, which can move a
# g across a bf16 rounding boundary (one ulp, 2^-8 relative); over ~1000
# output channels such flips reach ~1e-3 of max |dx| (7.5e-4 at
# fused-64-rows, in 10 of 4480 elements), while a tiling or swizzle fault
# is of the order of max |dx| itself.
@pytest.mark.parametrize("m,k,n", [(37, 24, 1032), (70, 64, 1000), (517, 8, 264),
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


@pytest.mark.parametrize("m,k,n", FP32_ROUTE_SHAPES, ids=FP32_ROUTE_IDS)
def test_k2_fp32_route(emulated, m, k, n):
    _check_k2(emulated, torch.float32, m, k, n)
