"""K1 (``csrc/bcos_conv1x1_fwd.cu``) run on the CPU through the CUDA stand-in
(``tests/torch_cuda_emulation.py``) against its plain version: ragged
shapes in both dtypes, the bf16 TMA store, the fp32 3xTF32 route and an
fp32 operand off the TMA grid.
"""
import pytest
import torch

from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from torch_cuda_emulation import (
    CASES, FP32_ROUTE_IDS, FP32_ROUTE_SHAPES, _assert_close, _k1, _operands, emulated_library,
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulated_library(tmp_path_factory, "bcos_conv1x1_fwd.cu")


@pytest.mark.parametrize("m,k,n,dtype", CASES)
def test_k1_forward(emulated, dtype, m, k, n):
    x, wt, mult, add, _ = _operands(m, k, n, dtype, 0)
    for relu, a in ((1, add), (0, None)):
        out = _k1(emulated, x, wt, mult, a, relu)
        _assert_close(out, k12.conv1x1_fwd_plain(x, wt, mult, a, relu=bool(relu)), dtype)


# bf16 K1 stages z and stores it by TMA where Cout is a multiple of 8 (the
# shapes of CASES store from the registers): ragged M, partial boxes in Cin
# and Cout, several tiles per block
def test_k1_bf16_tma_store(emulated):
    test_k1_forward(emulated, torch.bfloat16, 130, 72, 264)


@pytest.mark.parametrize("m,k,n", FP32_ROUTE_SHAPES, ids=FP32_ROUTE_IDS)
def test_k1_fp32_route(emulated, m, k, n):
    x, wt, mult, add, _ = _operands(m, k, n, torch.float32, 3)
    for relu, a in ((1, add), (0, None), (1, None), (0, add)):
        out = _k1(emulated, x, wt, mult, a, relu)
        _assert_close(out, k12.conv1x1_fwd_plain(x, wt, mult, a, relu=bool(relu)),
                      torch.float32)


# K1 in fp32 on operands the TMA cannot take as they are: Cin = 22 (not a
# multiple of 4) on an x 4 bytes off the 16-byte grid. The wrapper's
# tma_operands zero-pads x and wt to Cin = 24 in aligned storage, counted
# once, and the result equals the plain version on the unpadded operands.
def test_k1_fp32_cin_off_the_tma_grid(emulated):
    m, k, n = 37, 22, 10
    x, wt, mult, add, _ = _operands(m, k, n, torch.float32, 4)
    x = torch.empty(m * k + 1)[1:].view(m, k).copy_(x)
    assert x.data_ptr() % 16
    before = k12.tma_operands.padded
    out = _k1(emulated, x, wt, mult, add, 1)
    assert k12.tma_operands.padded == before + 1
    _assert_close(out, k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True), torch.float32)
