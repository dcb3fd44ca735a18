"""The PyTorch port on a GPU: each hand-written kernel against its plain
version, the launch counters, the small flagship on the GPU against the
same net on the CPU, and an exported explanation program against the eager
call. Every test here needs a GPU and skips without one.

This file imports torch, numpy and the port only, so it also runs on a GPU
machine without JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""
import copy

import pytest
import torch

from bcosification_tpu_torch.ops import pooling
from bcosification_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3
from bcosification_tpu_torch.ops.cuda import stream as k4

pytestmark = pytest.mark.cuda
# (M, Cin, Cout): ragged small shapes, the classifier, K2's split path
# (Cout > 1024), one K tile at layer1's width, and a ragged M with 128-row
# bf16 K2 blocks (256 < Cout <= 512, M >= 33792)
SHAPES = [(37, 24, 10), (300, 200, 130), (1000, 64, 256), (96, 2048, 1000),
          (6272, 1024, 2048), (401408 // 8, 64, 256), (33797, 72, 264)]


@pytest.fixture
def gpu():
    """Decided at run time: skip without a GPU; fp32 checks run without TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only there")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,cin,cout", SHAPES)
def test_kernels_match_plain(gpu, dtype, m, cin, cout):
    g = torch.Generator(device=gpu).manual_seed(0)
    x = torch.randn(m, cin, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5).to(dtype)
    mult = torch.rand(cout, device=gpu, generator=g) + 0.5
    add = torch.randn(cout, device=gpu, generator=g)
    ct = torch.randn(m, cout, device=gpu, generator=g).to(dtype)
    # bf16: against the plain version in fp32 on the same rounded inputs
    # (the kernels round g, and their outputs, to bf16 once each)
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
    assert _rel(a, k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=True)) <= tol
    for relu, mu, eps_outside in ((True, mult, False), (False, None, True)):
        dx = k12.conv1x1_bwd_explain(x, wt, ct, a, mu, relu=relu, eps_outside=eps_outside)
        want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), ref(a), mu, relu=relu,
                                             eps_outside=eps_outside)
        assert _rel(dx, want) <= tol
    for eps_outside in (False, True):
        y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside)
        want = k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=eps_outside)
        assert _rel(y, want) <= tol
    torch.cuda.synchronize()


def test_each_launch_is_counted(gpu):
    reset_launch_counts()
    x = torch.randn(64, 32, device=gpu)
    k12.conv1x1_fwd(x, torch.randn(16, 32, device=gpu), torch.ones(16, device=gpu), None,
                    relu=False)
    assert launch_counts() == {"bcos_conv1x1_fwd": 1, "bcos_conv1x1_bwd_explain": 0,
                               "bcos_matmul_fwd": 0, "stream_add": 0}


def test_bf16_cin_off_the_tma_grid_raises(gpu):
    """TMA reads rows of whole 16-byte units: bf16 Cin must be a multiple of 8."""
    x = torch.randn(64, 20, device=gpu).to(torch.bfloat16)
    wt = torch.randn(16, 20, device=gpu).to(torch.bfloat16)
    ct = torch.randn(64, 16, device=gpu).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        k12.conv1x1_fwd(x, wt, torch.ones(16, device=gpu), None, relu=False)
    with pytest.raises(ValueError, match="multiple of 8"):
        k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False)


def test_bf16_k3_k_off_the_tma_grid_raises(gpu):
    """bf16 K3 loads x and wt by TMA too: K must be a multiple of 8."""
    x = torch.randn(64, 20, device=gpu).to(torch.bfloat16)
    wt = torch.randn(16, 20, device=gpu).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False)


@pytest.mark.parametrize("eps_outside", [False, True], ids=["conv", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_at_the_classifier_shape(gpu, dtype, eps_outside):
    """K3 at the flagship classifier's full shape (batch 128): 49 x 8 tiles
    of y (128 rows each), the last column chunk 104 wide, y stored by TMA in
    f32."""
    m, k, n = 6272, 2048, 1000
    g = torch.Generator(device=gpu).manual_seed(3)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside)
    want = k3.bcos_matmul_fwd_plain(x.float(), wt.float(), eps=1e-6, eps_outside=eps_outside)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_wrapper_rejects_a_cpu_operand(gpu):
    x = torch.randn(64, 32, device=gpu)
    with pytest.raises(ValueError, match="cpu"):
        k12.conv1x1_fwd(x, torch.randn(16, 32), torch.ones(16, device=gpu), None, relu=False)


def test_avg_pool2d_gradient_matches_cpu(gpu):
    """PyTorch's CUDA avg_pool2d mis-computes input gradients for a
    channels_last input; the port pools a contiguous NCHW copy instead."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 32, 32, 8, generator=g)
    ct = torch.randn(2, 16, 16, 8, generator=g)
    grads = []
    for dev in ("cpu", gpu):
        xx = x.to(dev).requires_grad_(True)
        (grad,) = torch.autograd.grad(pooling.avg_pool2d(xx, 3, 2, 1), xx, ct.to(dev))
        grads.append(grad)
    assert _rel(grads[1], grads[0]) <= 1e-6


@pytest.mark.parametrize("layers", [("bottleneck", (1, 1)), ("basic", (1, 1))],
                         ids=["rn50", "rn18"])
def test_small_flagship_gpu_matches_cpu(gpu, layers):
    from chip_smoke import FLAGSHIP, calibrate
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

    arch = "resnet50" if layers[0] == "bottleneck" else "resnet18"
    net = build_bcosified_resnet({**FLAGSHIP, "name": arch}, num_classes=10, inplanes=8,
                                 layers=layers)
    g = torch.Generator(device=gpu).manual_seed(0)
    x = torch.rand(2, 64, 64, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    cpu = copy.deepcopy(net).to("cpu")
    reset_launch_counts()
    logits, sel, w = fast_dynamic_linear_weights(net, x)
    counts = launch_counts()
    assert counts["bcos_matmul_fwd"] == 1 and counts["bcos_conv1x1_bwd_explain"] >= 1
    lc, sc, wc = fast_dynamic_linear_weights(cpu, x.cpu(), device="cpu")
    _, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    assert torch.equal(sel.cpu(), sc) and torch.equal(sm, sel)
    # two blocks deep: fp32 summation order moves W by ~1e-6, far below this
    assert _rel(w, wc) <= 1e-5
    assert _rel(wm, w) <= 1e-5
    bias = net.logit_bias
    assert _rel(logits.double() - bias, lc.double() - bias) <= 1e-5


@pytest.mark.parametrize("nin", [2, 3, 4])
@pytest.mark.parametrize("shape", [(4096, 256), (1001, 7), (3,)], ids=["main", "ragged", "tiny"])
def test_stream_add_matches_plain_bit_for_bit(gpu, nin, shape):
    g = torch.Generator(device=gpu).manual_seed(nin)
    xs = [torch.randn(shape, device=gpu, generator=g).to(torch.bfloat16) for _ in range(nin)]
    reset_launch_counts()
    assert torch.equal(k4.stream_add(*xs), k4.stream_add_plain(*xs))
    # operands off the 16-byte grid take the scalar loop
    flat = [torch.randn(1 + 4096, device=gpu, generator=g).to(torch.bfloat16)[1:]
            for _ in range(nin)]
    assert torch.equal(k4.stream_add(*flat), k4.stream_add_plain(*flat))
    assert launch_counts()["stream_add"] == 2


def test_exported_explain_matches_eager(gpu):
    from chip_smoke import FLAGSHIP, calibrate
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

    net = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10, inplanes=8,
                                 layers=("bottleneck", (1, 1)))
    g = torch.Generator(device=gpu).manual_seed(1)
    x = torch.rand(3, 64, 64, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    program = serving.load_serialized(serving.export_explain(net, input_size=64))
    reset_launch_counts()
    logits, sel, w = program.call(x)
    counts = launch_counts()
    lw, sw, ww = fast_dynamic_linear_weights(net, x)
    # the same ATen ops and kernels on the same inputs
    assert torch.equal(sel, sw)
    assert _rel(w, ww) <= 1e-6 and _rel(logits, lw) <= 1e-6
    assert counts["bcos_conv1x1_bwd_explain"] >= 1 and counts["bcos_matmul_fwd"] == 1
