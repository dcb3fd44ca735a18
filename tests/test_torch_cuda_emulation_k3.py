"""K3 (``csrc/bcos_matmul_fwd.cu``) run on the CPU through the CUDA stand-in
(``tests/torch_cuda_emulation.py``) against its plain version: ragged
shapes in both dtypes with both eps_outside values, the bf16 engine and
the fp32 3xTF32 route.
"""
import pytest
import torch

from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3
from torch_cuda_emulation import (
    CASES, FP32_ROUTE_IDS, FP32_ROUTE_SHAPES, _assert_close, _k3, _operands, emulated_library,
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulated_library(tmp_path_factory, "bcos_matmul_fwd.cu")


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


@pytest.mark.parametrize("m,k,n", FP32_ROUTE_SHAPES, ids=FP32_ROUTE_IDS)
def test_k3_fp32_route(emulated, m, k, n):
    test_k3_bcos_matmul(emulated, torch.float32, m, k, n)
