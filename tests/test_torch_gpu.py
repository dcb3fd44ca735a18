"""The PyTorch port on a GPU: each hand-written kernel against its plain
version, the launch counters, the small flagship, the small DenseNet and
the small CLIP-RN50 tower on the GPU against the same net on the CPU
(explanation and one train step; the CLIP tower's text-grounded
explanation and one KD step), K3's training backward against the CPU (also
with the linear norm at the KD c_proj's shape), K3's launches per KD step,
the small SimpleViT on the GPU against the CPU (forward, W of the module
path and of fast_vit, launch counts), K3 and K2 at a ViT-B linear1 shape,
exported explanation programs against the eager calls, K3 at the shapes of
a ViT-B/16 train step and a ViT-C B forward, the ViT-C stem's B-cos conv
and group norm, the small vit_final ViTs (one train step and the
explanation) on the GPU against the CPU, the guided and DeepLIFT ReLU
gradients and the explainers on a small-flagship 3x3 grid against the CPU
with their launches, K3 in fp32 at every shape of one clip_benchmark encode
of the full-width CLIP-RN50 at batch 64, one harness bundle encode's
launches, K2 in fp32 at every shape of one text localisation, K1 in fp32
at every shape of one text localisation and of one ResNet-50 eval batch,
the fp32 route of K1, K2 and K3 at ragged shapes (Cin off the TMA
grid, a misaligned operand), the model zoo's position norm, grouped convs,
shapes and small nets, K3 and K2 at the VGG and ConvNeXt shapes, the small
VGG and ConvNeXts against the CPU, and the K1 gate (a per-channel mult
only). Every test here needs a GPU and skips without one.

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


def test_eager_and_dispatcher_routes_agree(gpu):
    """Outside tracing the wrappers call each op's CUDA implementation
    themselves (bcos_conv1x1.eager_cuda); torch.ops reaches the same
    implementation through the dispatcher, as a traced program does. Both
    launch and count the kernel and give the same bits (fp32, split-K)."""
    g = torch.Generator(device=gpu).manual_seed(3)
    m, cin, cout = 196, 1024, 256
    x = torch.randn(m, cin, device=gpu, generator=g)
    wt = torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5
    mult = torch.rand(cout, device=gpu, generator=g) + 0.5
    add = torch.randn(cout, device=gpu, generator=g)
    ct = torch.randn(m, cout, device=gpu, generator=g)
    ops = torch.ops.bcos_torch
    reset_launch_counts()
    a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
    assert torch.equal(a, ops.conv1x1_fwd(x, wt, mult, add, True, 1e-6))
    dx = k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=True)
    assert torch.equal(dx, ops.conv1x1_bwd_explain(x, wt, ct, a, mult, True, 1e-6, False))
    y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False)
    assert torch.equal(y, ops.bcos_matmul_fwd(x, wt, 1e-6, False))
    assert launch_counts() == {"bcos_conv1x1_fwd": 2, "bcos_conv1x1_bwd_explain": 2,
                               "bcos_matmul_fwd": 2, "stream_add": 0}


def _off_grid_operands(gpu, offset):
    """bf16 x [200, 300], wt [40, 300], ct [200, 40]; with ``offset`` x is a
    view one element (2 bytes) off the 16-byte grid."""
    g = torch.Generator(device=gpu).manual_seed(8)
    m, cin, cout = 200, 300, 40
    base = torch.randn(m * cin + offset, device=gpu, generator=g).to(torch.bfloat16)
    x = base[offset:].view(m, cin)
    wt = (torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5).to(torch.bfloat16)
    ct = torch.randn(m, cout, device=gpu, generator=g).to(torch.bfloat16)
    return x, wt, ct, torch.rand(cout, device=gpu, generator=g) + 0.5


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-view"])
def test_bf16_cin_off_the_tma_grid_matches_plain(gpu, offset):
    """bf16 Cin = 300 (not a multiple of 8): K1 and K2 run on zero-padded
    operands (an offset view also gets an aligned copy) and agree with their
    plain versions within phase 3's bf16 bound; each call is counted."""
    x, wt, ct, mult = _off_grid_operands(gpu, offset)
    reset_launch_counts()
    before = k12.tma_operands.padded
    a = k12.conv1x1_fwd(x, wt, mult, None, relu=True)
    dx = k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=True)
    assert k12.tma_operands.padded - before == 2
    assert launch_counts()["bcos_conv1x1_fwd"] == 1
    assert launch_counts()["bcos_conv1x1_bwd_explain"] == 1
    assert dx.shape == x.shape and dx.is_contiguous()
    assert _rel(a, k12.conv1x1_fwd_plain(x.float(), wt.float(), mult, None, relu=True)) <= 1e-2
    want = k12.conv1x1_bwd_explain_plain(x.float(), wt.float(), ct.float(), a.float(), mult,
                                         relu=True)
    assert _rel(dx, want) <= 1e-2


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-view"])
def test_bf16_k3_k_off_the_tma_grid_matches_plain(gpu, offset):
    """bf16 K3 at K = 300 and on an offset view: padded, counted, and equal
    to its plain version within the bf16 bound; an aligned K = 304 is not
    padded."""
    x, wt, _, _ = _off_grid_operands(gpu, offset)
    before = k12.tma_operands.padded
    for eps_outside in (False, True):
        y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside)
        want = k3.bcos_matmul_fwd_plain(x.float(), wt.float(), eps=1e-6, eps_outside=eps_outside)
        assert _rel(y, want) <= 1e-2
    assert k12.tma_operands.padded - before == 2
    x8 = torch.zeros(64, 304, device=gpu, dtype=torch.bfloat16)
    k3.bcos_matmul_fwd(x8, torch.ones(8, 304, device=gpu, dtype=torch.bfloat16), eps=1e-6,
                       eps_outside=False)
    assert k12.tma_operands.padded - before == 2


def test_eval_gradient_without_explain_matches_cpu(gpu):
    """The eval-mode, non-explain gradient of the small flagship in x and
    every weight, GPU against CPU (fp32): the eligible 1x1 convs run
    unfused (K3 at stride 1, cuDNN at stride 2), never K1."""
    from chip_smoke import FLAGSHIP, calibrate, eval_gradients
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.models import resnet

    net = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10, inplanes=8,
                                 layers=("bottleneck", (1, 1)))
    g = torch.Generator(device=gpu).manual_seed(9)
    x = torch.rand(2, 32, 32, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    before = resnet._conv_bn_act.grad_route
    reset_launch_counts()
    got = eval_gradients(net, x, weights=True)
    counts = launch_counts()
    assert resnet._conv_bn_act.grad_route - before == 6
    # conv1 and conv3 of both blocks, the stride-1 downsample, the classifier
    assert counts == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                      "bcos_matmul_fwd": 6, "stream_add": 0}
    want = eval_gradients(copy.deepcopy(net).to("cpu"), x.cpu(), weights=True)
    assert sorted(got) == sorted(want)
    for name in want:
        assert _rel(got[name], want[name]) <= 1e-4, name


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


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, 1), (3, 2, 1), (7, 2, 3), (1, 2, 0)])
def test_patch_norms_gradient_matches_cpu(gpu, kernel, stride, padding):
    """The patch norm's input gradient (a train step differentiates it): its
    [N, 1, H, W] sum of squares pooled on the GPU against the CPU. Pooled
    as the NHWC view, which PyTorch takes for channels_last when C = 1, the
    CUDA backward put the small flagship's gradients 1.9 away from the CPU."""
    from bcosification_tpu_torch.ops import bcos as ops

    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 17, 17, 8, generator=g)
    grads = []
    for dev in ("cpu", gpu):
        xx = x.to(dev).clone().requires_grad_(True)
        n = ops.patch_norms(xx, kernel, stride=stride, padding=padding)
        (grad,) = torch.autograd.grad(n, xx, torch.ones_like(n))
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


@pytest.mark.parametrize("eps_outside", [False, True], ids=["conv", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_at_the_layer1_train_shape(gpu, dtype, eps_outside):
    """K3 at layer1 conv1's train-step shape (a quarter of batch 64's M):
    N = 64 fills half of one 128-wide tile (the rows of wt beyond N load as
    zeros, the f32 store boxes are clipped at N) and K = 64 is one K step."""
    m, k, n = 200704 // 4, 64, 64
    g = torch.Generator(device=gpu).manual_seed(4)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside)
    want = k3.bcos_matmul_fwd_plain(x.float(), wt.float(), eps=1e-6, eps_outside=eps_outside)
    assert y.shape == (m, n) and bool(torch.isfinite(y).all())
    assert _rel(y, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("eps_outside", [False, True], ids=["conv", "linear"])
@pytest.mark.parametrize("explain", [False, True], ids=["train", "explain"])
def test_bcos_matmul_backward_matches_cpu(gpu, explain, eps_outside):
    """fp32 forward (K3) and backward (torch.matmul products; K2 for the
    explain dx) on the GPU against the CPU: 1e-5 relative."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1000, 64, generator=g)
    w = torch.randn(64, 200, generator=g) / 8
    ct = torch.randn(1000, 200, generator=g)
    grads = []
    for dev in ("cpu", gpu):
        xx = x.to(dev).clone().requires_grad_(True)
        ww = w.to(dev).clone().requires_grad_(True)
        reset_launch_counts()
        k3.bcos_matmul(xx, ww, 1e-6, eps_outside, explain).backward(ct.to(dev))
        grads.append((xx.grad, ww.grad, launch_counts()))
    (dx_c, dw_c, _), (dx_g, dw_g, counts) = grads
    assert counts["bcos_matmul_fwd"] == 1
    assert counts["bcos_conv1x1_bwd_explain"] == (1 if explain else 0)
    assert _rel(dx_g, dx_c) <= 1e-5 and _rel(dw_g, dw_c) <= 1e-5


def test_small_flagship_train_step_matches_cpu(gpu):
    """One fp32 train step of the recipe on the GPU against the CPU, and the
    bf16 amp gradient on the GPU against the fp32 one on the CPU (the same
    checks as chip_smoke.py phase 8, with its bounds)."""
    from chip_smoke import FLAGSHIP, calibrate, train_k3_launches, train_step_parity
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    net = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10, inplanes=8,
                                 layers=("bottleneck", (1, 1)))
    g = torch.Generator(device=gpu).manual_seed(6)
    x = torch.rand(4, 32, 32, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    reset_launch_counts()
    checks = train_step_parity(net, {"image": x, "label": torch.tensor([1, 3, 5, 7],
                                                                       device=gpu)})
    # three forwards on the GPU (the fp32 and the bf16 raw gradients, the step)
    assert launch_counts()["bcos_matmul_fwd"] == 3 * len(train_k3_launches(net.model, 4, 32))
    for key, (val, bound) in checks.items():
        assert val <= bound, (key, val, bound)


# --------------------------------------------------------------------------
# the DenseNet (slice 7): K3 and K2 at its shapes, the small DenseNet on the
# GPU against the CPU, and its exported explanation
# --------------------------------------------------------------------------
DENSENET_SMALL = dict(growth_rate=8, block_config=(2, 2), num_init_features=16, bn_size=2)


def _small_densenet(gpu, seed, n, size):
    from chip_smoke import FLAGSHIP, calibrate
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_densenet

    net = build_bcosified_densenet({**FLAGSHIP, "name": "densenet121"}, num_classes=10,
                                   arch_cfg=DENSENET_SMALL)
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.rand(n, size, size, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    return net, x


# (M, Cin, Cout): a block-1 conv1 at 1/8 of batch 128, block 3's deepest conv1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,cin,cout", [(401408 // 8, 224, 128), (25088, 992, 128)])
def test_k3_and_k2_at_densenet_shapes(gpu, dtype, m, cin, cout):
    """As the DenseNet pass calls them: K3; K2 as K3's explanation backward
    (no mult, no mask) and with a conv1's folded norm2 + act2."""
    g = torch.Generator(device=gpu).manual_seed(m + cin)
    x = torch.randn(m, cin, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5).to(dtype)
    mult = torch.rand(cout, device=gpu, generator=g) + 0.5
    ct = torch.randn(m, cout, device=gpu, generator=g).to(dtype)
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False)
    assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=False)) <= tol
    a = k12.conv1x1_fwd_plain(x, wt, mult, None, relu=True)
    for relu, mu, aa in ((False, None, None), (True, mult, a)):
        dx = k12.conv1x1_bwd_explain(x, wt, ct, aa, mu, relu=relu)
        want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct),
                                             None if aa is None else ref(aa), mu, relu=relu)
        assert _rel(dx, want) <= tol
    torch.cuda.synchronize()


def test_small_densenet_gpu_matches_cpu(gpu):
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_densenet import fast_dynamic_linear_weights

    net, x = _small_densenet(gpu, 0, 2, 64)
    n_1x1 = sum(DENSENET_SMALL["block_config"]) + len(DENSENET_SMALL["block_config"])
    cpu = copy.deepcopy(net).to("cpu")
    reset_launch_counts()
    logits, sel, w = fast_dynamic_linear_weights(net, x)
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n_1x1,
                               "bcos_matmul_fwd": n_1x1, "stream_add": 0}
    reset_launch_counts()
    with torch.no_grad():
        out = net(x)
    assert launch_counts()["bcos_matmul_fwd"] == n_1x1
    lc, sc, wc = fast_dynamic_linear_weights(cpu, x.cpu(), device="cpu")
    _, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    with torch.no_grad():
        outc = cpu(x.cpu())
    assert torch.equal(sel.cpu(), sc) and torch.equal(sm, sel)
    # five layers deep: fp32 summation order moves W by ~1e-6, far below this
    assert _rel(w, wc) <= 1e-5
    assert _rel(wm, w) <= 1e-5
    bias = net.logit_bias
    assert _rel(logits.double() - bias, lc.double() - bias) <= 1e-5
    assert _rel(out.double() - bias, outc.double() - bias) <= 1e-5


def test_small_densenet_train_step_matches_cpu(gpu):
    """One fp32 train step of the recipe on the GPU against the CPU (chip_smoke
    phase 8's fp32 checks and bounds): loss, every gradient leaf, the BN
    running_var. The bf16 bounds of phase 8 were set on the ResNet; the
    DenseNet's bf16 training is held by phase 10's falling loss."""
    from chip_smoke import train_k3_launches, train_step_parity

    net, x = _small_densenet(gpu, 6, 4, 32)
    reset_launch_counts()
    checks = train_step_parity(net, {"image": x, "label": torch.tensor([1, 3, 5, 7],
                                                                       device=gpu)})
    # three forwards on the GPU (the fp32 and the bf16 raw gradients, the step)
    assert launch_counts()["bcos_matmul_fwd"] == 3 * len(train_k3_launches(net.model, 4, 32))
    for key in ("loss", "gradient", "running_var"):
        val, bound = checks[key]
        assert val <= bound, (key, val, bound)


def test_exported_densenet_explain_matches_eager(gpu):
    """Fault C3 on the card: the DenseNet's explanation program, loaded from
    bytes, equals the eager pass and launches the same kernels."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.fast_densenet import fast_dynamic_linear_weights

    net, x = _small_densenet(gpu, 1, 3, 64)
    program = serving.load_serialized(serving.export_explain(net, input_size=64))
    reset_launch_counts()
    logits, sel, w = program.call(x)
    counts = launch_counts()
    reset_launch_counts()
    lw, sw, ww = fast_dynamic_linear_weights(net, x)
    assert counts == launch_counts() and counts["bcos_conv1x1_fwd"] == 0
    assert torch.equal(sel, sw)
    assert _rel(w, ww) <= 1e-6 and _rel(logits, lw) <= 1e-6


@pytest.mark.parametrize("case", ["stem", "conv2"])
def test_cudnn_convs_match_cpu_per_op(gpu, case):
    """Each fp32 cuDNN conv of the DenseNet's explanation, alone, agrees with
    the CPU's (f64) to 1e-6: the 3x3 conv2 and its transpose, the 7x7/s2
    stem and its transpose. (Through the 120 layers' ReLU masks, cuDNN's
    convs still move the full-width W far more than PyTorch's own CUDA
    convs do; chip_smoke.py phase 10.)"""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    if case == "stem":
        fwd = lambda x, w: F.conv2d(x, w, stride=2, padding=3)
        bwd = lambda x, w: F.conv_transpose2d(x, w, stride=2, padding=3, output_padding=1)
        x, w, ct = (torch.randn(2, 6, 224, 224, generator=g), torch.randn(64, 6, 7, 7, generator=g),
                    torch.randn(2, 64, 112, 112, generator=g))
    else:
        fwd = lambda x, w: F.conv2d(x, w, padding=1)
        bwd = lambda x, w: F.conv_transpose2d(x, w, padding=1)
        x, w, ct = (torch.randn(8, 128, 56, 56, generator=g),
                    torch.randn(32, 128, 3, 3, generator=g), torch.randn(8, 32, 56, 56, generator=g))
    for fn, inp in ((fwd, x), (bwd, ct)):
        want = fn(inp.double(), w.double())
        got = fn(inp.to(gpu).contiguous(memory_format=torch.channels_last), w.to(gpu))
        assert _rel(got, want) <= 1e-6


# the small CLIP-RN50 student of tests/test_torch_clip.py at 64x64
CLIP_SMALL = {"vision_layers": (1, 1, 1, 1), "vision_width": 16, "embed_dim": 32,
              "image_resolution": 64}


def _small_clip(gpu, unpool, seed=0):
    """The small CLIP student on the GPU, gamma-calibrated as chip_smoke.py
    does, and a batch of 2 images."""
    from chip_smoke import calibrate
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual

    config = {"bcosify_args": {"use_bias": False}, "attn_unpool": unpool}
    net = build_bcosified_clip_visual(config, None, dict(CLIP_SMALL), seed=seed)
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.rand(2, 64, 64, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:1])
    t = torch.randn(CLIP_SMALL["embed_dim"], device=gpu, generator=g)
    return net, x, t / t.norm()


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_small_clip_text_explain_gpu_matches_cpu(gpu, unpool):
    """The text-grounded explanation (explain/fast_clip.py) on the GPU: K1 and
    K2 at the 12 1x1 convs, the unpooled c_proj on K3 and K2 with the linear
    norm; scores and W against the CPU (1e-5) and the module's autograd on
    the GPU (1e-5); the encode on K3."""
    from bcosification_tpu_torch.explain import fast_clip

    net, x, t = _small_clip(gpu, unpool)
    reset_launch_counts()
    s, w = fast_clip.fast_text_dlw(net, x, t)
    assert launch_counts() == {"bcos_conv1x1_fwd": 12, "bcos_conv1x1_bwd_explain": 12 + unpool,
                               "bcos_matmul_fwd": int(unpool), "stream_add": 0}
    reset_launch_counts()
    with torch.no_grad():
        net(x)
    assert launch_counts()["bcos_matmul_fwd"] == 12 + unpool
    sc, wc = fast_clip.fast_text_dlw(copy.deepcopy(net).to("cpu"), x.cpu(), t.cpu(),
                                     device="cpu")
    xx = x.clone().requires_grad_(True)
    sm = fast_clip.text_score_head(net(xx, explain=True), t)
    (wm,) = torch.autograd.grad(sm.sum(), xx)
    # five segments deep: fp32 summation order moves W by ~1e-6, far below this
    assert _rel(s, sc) <= 1e-5 and _rel(w, wc) <= 1e-5
    assert _rel(sm.detach(), s) <= 1e-5 and _rel(wm, w) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_and_k2_at_the_clip_c_proj_shape(gpu, dtype):
    """The attn-unpool c_proj at batch 128 (M = 128 x 49, K 2048, N 1024): K3
    forward and K2 backward with the linear norm (sqrt(ssq) + 1e-12,
    eps_outside) and no mult, against their plain versions."""
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    m, k, n = 6272, 2048, 1024
    g = torch.Generator(device=gpu).manual_seed(9)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    ct = torch.randn(m, n, device=gpu, generator=g).to(dtype)
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    y = k3.bcos_matmul_fwd(x, wt, **kw)
    assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)) <= tol
    dx = k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw)
    want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None, relu=False, **kw)
    assert _rel(dx, want) <= tol
    torch.cuda.synchronize()


def test_exported_text_explain_matches_eager(gpu):
    """The attn-unpool tower's text-grounded explanation program, loaded from
    bytes, equals the eager pass and launches the same kernels."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain import fast_clip

    net, x, t = _small_clip(gpu, True, seed=1)
    program = serving.load_serialized(serving.export_text_explain(
        net, embed_dim=CLIP_SMALL["embed_dim"], input_size=64))
    reset_launch_counts()
    s, w = program.call(x, t)
    counts = launch_counts()
    reset_launch_counts()
    es, ew = fast_clip.fast_text_dlw(net, x, t)
    assert counts == launch_counts() and counts["bcos_conv1x1_fwd"] == 12
    assert _rel(s, es) <= 1e-6 and _rel(w, ew) <= 1e-6


# --------------------------------------------------------------------------
# CLIP knowledge distillation (slice 9): the small student and teacher
# --------------------------------------------------------------------------
def _small_kd(gpu, unpool):
    """The small calibrated student (``_small_clip``), the small CLIP teacher
    at 64x64 (random init) and 3 raw images: 4 locations unpooled, HW != B."""
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual

    net, _, _ = _small_clip(gpu, unpool)
    teacher = build_clip_teacher_visual(None, dict(CLIP_SMALL, vision_patch_size=None), seed=3)
    g = torch.Generator(device=gpu).manual_seed(12)
    return net, teacher, torch.rand(3, 64, 64, 3, device=gpu, generator=g)


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_small_kd_step_gpu_matches_cpu(gpu, unpool):
    """One fp32 KD loss and backward (train mode) on the GPU against the
    CPU, with chip_smoke.kd_step_parity's checks and bounds: the loss 1e-5,
    every gradient within ten times the CPU's own spread under 1e-7
    relative input noise, the BN running_var within ten times the CPU's
    spread in it under that noise or the batch reversed."""
    from chip_smoke import kd_step_parity

    net, teacher, images = _small_kd(gpu, unpool)
    checks = kd_step_parity(net, teacher, images, 2 if unpool else 0)
    for key, (val, bound) in checks.items():
        assert val <= bound, (key, val, bound)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_kd_train_step_launches(gpu, unpool, amp):
    """One KD train step: K3 at the student's 12 1x1 convs (13 with the
    unpooled c_proj), K1 and K2 never; a finite loss."""
    from bcosification_tpu_torch.optim import OptimizerFactory
    from bcosification_tpu_torch.training import kd, steps

    net, teacher, images = _small_kd(gpu, unpool)
    opt = OptimizerFactory("Adam", 1e-4, bcosify=True, b_opt=False)
    state = steps.create_train_state(net, opt.create)
    step = kd.make_kd_train_step(teacher, 1e-4, cos_power=2 if unpool else 0, amp=amp)
    reset_launch_counts()
    state, metrics = step(state, {"image": images})
    torch.cuda.synchronize()
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                               "bcos_matmul_fwd": 12 + unpool, "stream_add": 0}
    assert torch.isfinite(metrics["loss"]) and state.step == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_eps_outside_training_backward_at_the_kd_c_proj_shape(gpu, dtype):
    """K3 with the linear norm (sqrt(ssq) + 1e-12, eps_outside) and its
    training backward at the attn-unpool c_proj of a KD step at batch 64
    (M = 64 x 49, K 2048, N 1024): y, dx and dw on the GPU against the CPU
    in fp32 (1e-5; bf16 on the GPU within 1e-2)."""
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    m, k, n = 3136, 2048, 1024
    g = torch.Generator().manual_seed(13)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g) / k ** 0.5
    ct = torch.randn(m, n, generator=g)
    results = []
    for dev, dt in (("cpu", torch.float32), (gpu, dtype)):
        xx = x.to(dev, dt, copy=True).requires_grad_(True)
        ww = w.to(dev, dt, copy=True).requires_grad_(True)
        reset_launch_counts()
        y = k3.bcos_matmul(xx, ww, LINEAR_NORM_EPS, True, False)
        y.backward(ct.to(dev))
        results.append((y.detach(), xx.grad, ww.grad, launch_counts()))
    (y_c, dx_c, dw_c, _), (y_g, dx_g, dw_g, counts) = results
    assert counts["bcos_matmul_fwd"] == 1 and counts["bcos_conv1x1_bwd_explain"] == 0
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in ((y_g, y_c), (dx_g, dx_c), (dw_g, dw_c)):
        assert _rel(got, want) <= tol


# --------------------------------------------------------------------------
# The B-cosified SimpleViT (slice 10)
# --------------------------------------------------------------------------
VIT_SMALL = dict(dim=32, heads=2, mlp_dim=64, depth=2, patch_size=8, image_size=32)


def _small_vit(gpu, bias="noBias", gap="noGapReorder", n=2, seed=0):
    """The vit_bcosification recipe's net at VIT_SMALL (random init from
    ``seed``, 10 classes) on the GPU, and AddInverse images [n, 32, 32, 6]."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_vit

    config = {"name": "simple_vit_b_patch16_224", "act_layer": True, "logit_layer": True,
              "bcos_args": {"b": 2}, "bcosify_args": {"use_bias": bias == "useBias"},
              "args": {"gap_reorder": gap == "gapReorder"}}
    net = build_bcosified_vit(config, num_classes=10, arch_cfg=VIT_SMALL, seed=seed)
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.rand(n, 32, 32, 3, device=gpu, generator=g)
    return net, torch.cat([x, 1.0 - x], dim=-1)


@pytest.mark.parametrize("bias,gap", [("noBias", "noGapReorder"), ("useBias", "gapReorder")])
def test_small_vit_gpu_matches_cpu(gpu, bias, gap):
    """fp32: the forward and W (fast_vit and the module path) on the GPU
    against the CPU, fast_vit against the module path, and the launches:
    K3 and K2 at every bias-free B-cos linear (3 per encoder + the patch
    embedding and the head; with useBias to_out alone), K1 never."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_vit import fast_dynamic_linear_weights

    net, x = _small_vit(gpu, bias, gap)
    n = VIT_SMALL["depth"] if bias == "useBias" else 3 * VIT_SMALL["depth"] + 2
    cpu = copy.deepcopy(net).to("cpu")
    reset_launch_counts()
    logits, sel, w = fast_dynamic_linear_weights(net, x)
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n,
                               "bcos_matmul_fwd": n, "stream_add": 0}
    reset_launch_counts()
    _, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n,
                               "bcos_matmul_fwd": n, "stream_add": 0}
    reset_launch_counts()
    with torch.no_grad():
        out = net(x)
    assert launch_counts()["bcos_matmul_fwd"] == n
    lc, sc, wc = fast_dynamic_linear_weights(cpu, x.cpu(), device="cpu")
    _, smc, wmc = dynamic_linear_weights(lambda t: cpu(t, explain=True), x.cpu(), device="cpu")
    with torch.no_grad():
        outc = cpu(x.cpu())
    assert torch.equal(sel.cpu(), sc) and torch.equal(sm, sel) and torch.equal(smc, sc)
    assert _rel(w, wc) <= 1e-5 and _rel(wm, wmc) <= 1e-5
    assert _rel(wm, w) <= 1e-5
    bias_ = net.logit_bias
    assert _rel(logits.double() - bias_, lc.double() - bias_) <= 1e-5
    assert _rel(out.double() - bias_, outc.double() - bias_) <= 1e-5


def test_exported_vit_explain_matches_eager(gpu):
    """The ViT's explanation and forward programs, loaded from bytes, equal
    the eager calls and launch the same kernels."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.fast_vit import fast_dynamic_linear_weights

    net, x = _small_vit(gpu, n=3, seed=1)
    program = serving.load_serialized(serving.export_explain(net, input_size=32))
    forward = serving.load_serialized(serving.export_forward(net, input_size=32))
    reset_launch_counts()
    logits, sel, w = program.call(x)
    counts = launch_counts()
    reset_launch_counts()
    lw, sw, ww = fast_dynamic_linear_weights(net, x)
    assert counts == launch_counts() and counts["bcos_conv1x1_bwd_explain"] == 8
    assert torch.equal(sel, sw)
    assert _rel(w, ww) <= 1e-6 and _rel(logits, lw) <= 1e-6
    with torch.no_grad():
        assert _rel(forward.call(x), net(x)) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cout", [768, 3072], ids=["fused", "scratch"])
def test_k3_and_k2_at_a_vit_linear_shape(gpu, dtype, cout):
    """A ViT-B token matmul at 1/8 of batch 128 (M = 16 x 196, K 768): K3
    forward and K2 backward with the linear norm (eps_outside), bare
    cotangent; Cout 3072 (linear1) takes K2's bf16 scratch route, Cout 768
    its fused one."""
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    m, k = 16 * 196, 768
    g = torch.Generator(device=gpu).manual_seed(cout)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(cout, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    ct = torch.randn(m, cout, device=gpu, generator=g).to(dtype)
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    y = k3.bcos_matmul_fwd(x, wt, **kw)
    assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)) <= tol
    dx = k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw)
    want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None, relu=False, **kw)
    assert _rel(dx, want) <= tol
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# ViT training and the from-scratch ViTs of vit_final (slice 11)
# --------------------------------------------------------------------------
VIT_FINAL_SMALL = dict(dim=32, heads=2, mlp_dim=64, depth=2)


def _small_vit_final(gpu, name, seed=0):
    """The vit_final config ``name`` at VIT_FINAL_SMALL (a ViT-C stem of
    widths (8, 16), or patch 8; 10 classes; random init from ``seed``) on the
    GPU, and a batch of 2 images of 32x32 (6 AddInverse channels for a B-cos
    config, 3 for a standard one) with labels."""
    from bcosification_tpu_torch.experiments.ImageNet.vit_final import experiment_parameters
    from bcosification_tpu_torch.experiments.ImageNet.vit_final import model

    config = experiment_parameters.CONFIGS[name]
    model_config = copy.deepcopy(config["model"])
    model_config["args"]["num_classes"], model_config["seed"] = 10, seed
    arch = dict(VIT_FINAL_SMALL, **({"conv_stem": (8, 16)} if "vitc" in name
                                    else {"patch_size": 8}))
    net = model.get_model(model_config, device=gpu, **arch)
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.rand(2, 32, 32, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1) if name.startswith("bcos_") else (x - 0.45) / 0.225
    return net, config, {"image": x, "label": torch.tensor([1, 3], device=gpu)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k3_at_the_vit_train_and_vitc_shapes(gpu, dtype):
    """K3 with the linear norm (eps_outside) against its plain version at
    every distinct shape of a ViT-B/16 train step at batch 64 (12 544 token
    rows; the head at 64) and of the ViT-C B forward's patch embedding at
    batch 128 (K 512)."""
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    shapes = [(12544, 1536, 768), (12544, 768, 768), (12544, 768, 3072), (12544, 3072, 768),
              (64, 768, 1000), (25088, 512, 768)]
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    for m, k, n in shapes:
        g = torch.Generator(device=gpu).manual_seed(m + k + n)
        x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
        wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
        reset_launch_counts()
        y = k3.bcos_matmul_fwd(x, wt, **kw)
        assert launch_counts()["bcos_matmul_fwd"] == 1
        assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)) <= tol, (m, k, n)
    torch.cuda.synchronize()


@pytest.mark.parametrize("explain", [False, True], ids=["train", "explain"])
@pytest.mark.parametrize("cin,cout,stride", [(6, 8, 2), (8, 16, 2), (16, 16, 1)])
def test_stem_conv_patch_norm_gradient_matches_cpu(gpu, explain, cin, cout, stride):
    """The ViT-C stem's 3x3 B-cos conv (padding 1; stride 2 where the width
    grows) on an NHWC input: the output and the input and weight gradients
    on the GPU against the CPU (1e-5), the patch norm's windowed sum
    (avg_pool2d on a contiguous copy) included; then its group norm."""
    from bcosification_tpu_torch.modules import BcosConv2d, DetachableGNLayerNorm2d

    g = torch.Generator().manual_seed(cin + cout)
    conv = BcosConv2d(cin, cout, 3, stride=stride, padding=1, generator=g)
    norm = DetachableGNLayerNorm2d(cout)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
    x = torch.randn(2, 32, 32, cin, generator=g)
    ct = torch.randn(2, 32 // stride, 32 // stride, cout, generator=g)
    results = []
    for dev in ("cpu", gpu):
        c, nm = copy.deepcopy(conv).to(dev), copy.deepcopy(norm).to(dev)
        xx = x.to(dev).clone().requires_grad_(True)
        y = nm(c(xx, explain=explain), explain=explain)
        y.backward(ct.to(dev))
        results.append((y.detach(), xx.grad, c.weight.grad, nm.weight.grad))
    for got, want in zip(results[1], results[0]):
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", ["bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14",
                                  "bcos_simple_vit_ti_patch16_224"])
def test_small_vit_final_train_step_matches_cpu(gpu, name):
    """One fp32 step of the config's recipe on the GPU against the CPU, by
    chip_smoke.py phase 14's checks (the loss; Adam's first moment within
    ten times the CPU's spread under 1e-7 relative input noise), and the
    launches of one step: K3 at each bias-free B-cos linear (3 per encoder,
    the patch embedding, the head), none in the standard ViT."""
    from chip_smoke import recipe_step, vit_step_parity

    net, config, batch = _small_vit_final(gpu, name)
    checks = vit_step_parity(net, config, batch)
    for key, (val, bound) in checks.items():
        assert val <= bound, (key, val, bound)
    state, step = recipe_step(net, config, amp=True)
    reset_launch_counts()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    k3_launches = 3 * VIT_FINAL_SMALL["depth"] + 2 if name.startswith("bcos_") else 0
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                               "bcos_matmul_fwd": k3_launches, "stream_add": 0}
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("name", ["bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14",
                                  "bcos_simple_vit_ti_patch16_224"])
def test_small_vit_final_explanation_matches_cpu(gpu, name):
    """fp32: the logits and W of the module path (autograd) on the GPU
    against the CPU (1e-5), and for the B-cos ViT and ViT-C the
    hand-scheduled pass (BcosLinear, the logit layer inside the SimpleViT,
    the ViT-C stem's transpose) against both."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, _, batch = _small_vit_final(gpu, name, seed=1)
    x = batch["image"]
    cpu = copy.deepcopy(net).to("cpu")
    lg, sg, wg = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    lc, sc, wc = dynamic_linear_weights(lambda t: cpu(t, explain=True), x.cpu(), device="cpu")
    assert torch.equal(sg.cpu(), sc)
    assert _rel(wg, wc) <= 1e-5 and _rel(lg, lc) <= 1e-5
    assert fast_vit.supports(net) == name.startswith("bcos_")
    if fast_vit.supports(net):
        reset_launch_counts()
        lf, sf, wf = fast_vit.fast_dynamic_linear_weights(net, x)
        n = 3 * VIT_FINAL_SMALL["depth"] + 2
        assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n,
                                   "bcos_matmul_fwd": n, "stream_add": 0}
        assert torch.equal(sf, sg) and _rel(wf, wg) <= 1e-5 and _rel(wf, wc) <= 1e-5


@pytest.mark.parametrize("mode", ["guided", "deeplift"])
def test_guided_relu_gradients_match_cpu(gpu, mode):
    """ops.guided.relu's guided and DeepLIFT (paired batch, near pairs
    included) gradients on the card equal the CPU's."""
    from bcosification_tpu_torch.ops import guided

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2 * 64, 33, generator=g)
    x[64:80] = x[:16] + 1e-8  # pairs closer than 1e-7: the ordinary mask
    ct = torch.randn(x.shape, generator=g)
    ctx = guided.guided_backprop if mode == "guided" else guided.deeplift
    grads = []
    for dev in ("cpu", gpu):
        xx = x.clone().to(dev).requires_grad_(True)
        with ctx():
            y = guided.relu(xx)
        y.backward(ct.to(dev))
        grads.append(xx.grad)
    assert torch.equal(grads[1].cpu(), grads[0])
    assert bool((grads[0] != ct * (x > 0)).any())  # not the plain ReLU's gradient


def test_explainers_on_a_small_flagship_grid_match_cpu(gpu):
    """fp32, a 3x3 grid of 64x64 images on the calibrated small flagship:
    Ours (K1 at each fused 1x1 forward, K2 there and at the classifier
    backward), GB and DeepLIFT in explanation mode (no K1) on the GPU
    against the CPU (1e-5)."""
    from chip_smoke import FLAGSHIP, calibrate
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer

    net = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10, inplanes=8,
                                 layers=("bottleneck", (1, 1)))
    g = torch.Generator(device=gpu).manual_seed(0)
    x = torch.rand(1, 192, 192, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    calibrate(net, x[:, :64, :64])
    cpu = copy.deepcopy(net).to("cpu")
    targets = list(range(9))
    for name, kw, k1, k2 in (("Ours", {}, 6, 7), ("GB", {}, 0, 0),
                             ("DeepLIFT", {"explanation_mode": True}, 0, None)):
        reset_launch_counts()
        got = get_explainer(net, name, **kw).attribute_selection(x, targets)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = get_explainer(cpu, name, device="cpu", **kw).attribute_selection(x.cpu(), targets)
        assert counts["bcos_conv1x1_fwd"] == k1, (name, counts)
        assert k2 is None or counts["bcos_conv1x1_bwd_explain"] == k2, (name, counts)
        assert got.shape == (9, 192, 192, 6) and _rel(got, want) <= 1e-5, name


# (M, K, N, eps_outside) of every distinct K3 launch of one clip_benchmark
# encode of the full-width CLIP-RN50 at batch 64, 224x224, pooled and
# attn-unpool (M = 64 x 56^2, 28^2, 14^2, 7^2; the unpooled c_proj at 7^2)
HARNESS_SHAPES = [
    (200704, 64, 64, False), (200704, 64, 256, False), (200704, 256, 64, False),
    (200704, 256, 128, False), (50176, 128, 512, False), (50176, 256, 512, False),
    (50176, 512, 128, False), (50176, 512, 256, False), (12544, 256, 1024, False),
    (12544, 512, 1024, False), (12544, 1024, 256, False), (12544, 1024, 512, False),
    (3136, 512, 2048, False), (3136, 1024, 2048, False), (3136, 2048, 512, False),
    (3136, 2048, 1024, True),
]


@pytest.mark.parametrize("m,k,n,eps_outside", HARNESS_SHAPES)
def test_k3_fp32_at_the_harness_encode_shapes(gpu, m, k, n, eps_outside):
    """The harness feeds float32 images, so every encode runs K3's fp32
    route: against its plain version at each shape (phase 3's fp32 bound:
    max |diff| <= 1e-5 max |ref|)."""
    g = torch.Generator(device=gpu).manual_seed(m + k + n)
    x = torch.randn(m, k, device=gpu, generator=g)
    wt = torch.randn(n, k, device=gpu, generator=g) / k ** 0.5
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    eps = LINEAR_NORM_EPS if eps_outside else 1e-6
    reset_launch_counts()
    got = k3.bcos_matmul_fwd(x, wt, eps=eps, eps_outside=eps_outside)
    assert launch_counts()["bcos_matmul_fwd"] == 1 and got.dtype == torch.float32
    want = k3.bcos_matmul_fwd_plain(x, wt, eps=eps, eps_outside=eps_outside)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_harness_bundle_encode_launches(gpu, unpool, tmp_path, monkeypatch):
    """One encode of a bcos_clip bundle (the full-width CLIP-RN50 of the
    clip_bcosification experiment at its conversion-time init, fp32 images)
    launches K3 at each of the 36 bias-free 1x1 convs, and at the unpooled
    c_proj: 36 pooled, 37 attn-unpool; K1, K2 none."""
    import warnings

    import numpy as np

    from bcosification_tpu_torch import settings
    from bcosification_tpu_torch.clip_benchmark.models import load_clip

    monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path))
    name = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no CLIP checkpoint here: random init
        bundle, transform, _ = load_clip("bcos_clip", name + ("_attnUnpool" if unpool else ""),
                                         "", device=gpu)
    images = np.random.default_rng(0).random((2, 224, 224, 6)).astype(np.float32)
    reset_launch_counts()
    feats = bundle.encode_image(bundle.images(images))
    torch.cuda.synchronize()
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                               "bcos_matmul_fwd": 36 + unpool, "stream_add": 0}
    assert feats.dtype == torch.float32 and feats.shape[0] == 2



# (M, Cin, Cout, relu, eps_outside) of every distinct K2 call of one text
# localisation of the full-width attn-unpool CLIP-RN50 student at one 224^2
# image (fp32): conv1s with the BN's mult and the ReLU mask, conv3s and
# downsamples with the mult, the c_proj with the linear norm
TEXT_LOC_SHAPES = [
    (3136, 64, 64, True, False), (3136, 64, 256, False, False), (3136, 256, 64, True, False),
    (3136, 256, 128, True, False), (784, 128, 512, False, False),
    (784, 256, 512, False, False), (784, 512, 128, True, False), (784, 512, 256, True, False),
    (196, 256, 1024, False, False), (196, 512, 1024, False, False),
    (196, 1024, 256, True, False), (196, 1024, 512, True, False), (49, 512, 2048, False, False),
    (49, 1024, 2048, False, False), (49, 2048, 512, True, False), (49, 2048, 1024, False, True),
]


@pytest.mark.parametrize("m,cin,cout,relu,eps_outside", TEXT_LOC_SHAPES)
def test_k2_fp32_at_the_text_localisation_shapes(gpu, m, cin, cout, relu, eps_outside):
    """Text localisation runs K2's fp32 route (3xTF32 on the tensor cores):
    against its plain version at each shape (phase 3's fp32 bound), one
    counted call each."""
    from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS

    g = torch.Generator(device=gpu).manual_seed(m + cin + cout)
    x = torch.randn(m, cin, device=gpu, generator=g)
    wt = torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5
    mult = None if eps_outside else torch.rand(cout, device=gpu, generator=g) + 0.5
    ct = torch.randn(m, cout, device=gpu, generator=g)
    a = k12.conv1x1_fwd(x, wt, mult, None, relu=True) if relu else None
    kw = dict(relu=relu, eps=LINEAR_NORM_EPS if eps_outside else 1e-6, eps_outside=eps_outside)
    reset_launch_counts()
    got = k12.conv1x1_bwd_explain(x, wt, ct, a, mult, **kw)
    assert launch_counts()["bcos_conv1x1_bwd_explain"] == 1
    want = k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, **kw)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# (M, Cin, Cout, relu) of every distinct K1 call of one ResNet-50 eval batch
# (64 images of 224^2; evaluate and every validation batch run it in fp32)
EVAL_BATCH_SHAPES = [
    (3136, 512, 2048, False), (3136, 1024, 2048, False), (3136, 2048, 512, True),
    (12544, 256, 1024, False), (12544, 512, 1024, False), (12544, 1024, 256, True),
    (12544, 1024, 512, True), (50176, 128, 512, False), (50176, 256, 512, False),
    (50176, 512, 128, True), (50176, 512, 256, True), (200704, 64, 64, True),
    (200704, 64, 256, False), (200704, 256, 64, True), (200704, 256, 128, True),
]


@pytest.mark.parametrize("m,cin,cout,relu", [shape[:4] for shape in TEXT_LOC_SHAPES
                                              if not shape[4]] + EVAL_BATCH_SHAPES)
def test_k1_fp32_at_the_text_localisation_and_eval_shapes(gpu, m, cin, cout, relu):
    """K1's fp32 route (3xTF32 on the tensor cores; split-K at one image's
    small M) against its plain version within phase 3's bound, with the
    BN's add and without: one counted call each, no operand padded."""
    g = torch.Generator(device=gpu).manual_seed(m + cin + cout)
    x = torch.randn(m, cin, device=gpu, generator=g)
    wt = torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5
    mult = torch.rand(cout, device=gpu, generator=g) + 0.5
    add = 0.1 * torch.randn(cout, device=gpu, generator=g)
    before = k12.tma_operands.padded
    for a in (add, None):
        reset_launch_counts()
        got = k12.conv1x1_fwd(x, wt, mult, a, relu=relu)
        assert launch_counts()["bcos_conv1x1_fwd"] == 1 and got.dtype == torch.float32
        want = k12.conv1x1_fwd_plain(x, wt, mult, a, relu=relu)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert k12.tma_operands.padded == before


# fp32 shapes off the TMA grid and the tiles (M, Cin, Cout, misaligned x):
# M = 49 and 3136 + 13, Cout = 1000 and Cout % 4 != 0, Cin % 4 != 0 and a
# deep Cin, one x 4 bytes off the 16-byte grid
FP32_RAGGED_SHAPES = [(49, 30, 1000, False), (3149, 64, 130, False), (49, 2046, 61, False),
                      (3149, 1022, 1001, False), (49, 64, 1000, True)]


@pytest.mark.parametrize("m,cin,cout,misaligned", FP32_RAGGED_SHAPES)
def test_fp32_route_at_ragged_shapes(gpu, m, cin, cout, misaligned):
    """K1, K2 (mult and mask, and the bare linear) and K3 (both
    eps_outside) in fp32 against their plain versions within phase 3's
    bound; tma_operands pads or realigns the operands of all five calls
    where Cin is off the grid of 4 or x misaligned (K1's 3xTF32 route loads
    by TMA too)."""
    g = torch.Generator(device=gpu).manual_seed(m + cin + cout)
    x = torch.randn(m, cin, device=gpu, generator=g)
    if misaligned:
        x = torch.empty(m * cin + 1, device=gpu)[1:].view(m, cin).copy_(x)
    wt = torch.randn(cout, cin, device=gpu, generator=g) / cin ** 0.5
    mult = torch.rand(cout, device=gpu, generator=g) + 0.5
    ct = torch.randn(m, cout, device=gpu, generator=g)

    def close(got, want):
        return float((got - want).abs().max() / want.abs().max()) <= 1e-5

    before = k12.tma_operands.padded
    a = k12.conv1x1_fwd(x, wt, mult, None, relu=True)
    assert close(a, k12.conv1x1_fwd_plain(x, wt, mult, None, relu=True))
    for relu, mu, eps_outside in ((True, mult, False), (False, None, True)):
        dx = k12.conv1x1_bwd_explain(x, wt, ct, a, mu, relu=relu, eps_outside=eps_outside)
        assert dx.shape == x.shape and dx.is_contiguous()
        assert close(dx, k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mu, relu=relu,
                                                       eps_outside=eps_outside))
    for eps_outside in (False, True):
        y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside)
        assert close(y, k3.bcos_matmul_fwd_plain(x, wt, eps=1e-6, eps_outside=eps_outside))
    torch.cuda.synchronize()
    assert k12.tma_operands.padded - before == (5 if cin % 4 or misaligned else 0)


# --------------------------------------------------------------------------
# the B-cos v2 model zoo (models/pretrained.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
def test_position_norm_gpu_matches_cpu(gpu, explain):
    """DetachablePositionNorm2d on the card against the CPU: fp32 forward and
    input gradient (1e-5); under bf16 inputs its statistics stay in f32 (the
    output is the f32 norm of the bf16 input, rounded once)."""
    from bcosification_tpu_torch.modules import DetachablePositionNorm2d, NoBias

    g = torch.Generator(device=gpu).manual_seed(3)
    x = 3 * torch.randn(4, 14, 14, 96, device=gpu, generator=g) + 1
    ct = torch.randn(x.shape, device=gpu, generator=g)
    norm = NoBias(DetachablePositionNorm2d)(96, device=gpu)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(96, device=gpu, generator=g))
    cpu = copy.deepcopy(norm).to("cpu")
    outs = []
    for mod, t, c in ((norm, x, ct), (cpu, x.cpu(), ct.cpu())):
        t = t.clone().requires_grad_(True)
        y = mod(t, explain=explain)
        (gx,) = torch.autograd.grad(y, t, c)
        outs.append((y.detach(), gx))
    (yg, gg), (yc, gc) = outs
    assert _rel(yg, yc) <= 1e-5 and _rel(gg, gc) <= 1e-5
    xb = x.to(torch.bfloat16)
    yb = norm(xb, explain=explain)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, norm(xb.float(), explain=explain).to(torch.bfloat16))


@pytest.mark.parametrize("groups,stride", [(4, 1), (32, 2)])
def test_grouped_bcos_conv_gpu_matches_cpu(gpu, groups, stride):
    """Grouped patch norms and the grouped 3x3 B-cos conv (ResNeXt's) on the
    card against the CPU, forward and input gradient with and without
    explain (1e-5)."""
    from bcosification_tpu_torch.ops import bcos as ops

    g = torch.Generator(device=gpu).manual_seed(groups)
    x = torch.randn(2, 28, 28, 128, device=gpu, generator=g)
    w = torch.randn(128, 128 // groups, 3, 3, device=gpu, generator=g)
    n_g = ops.patch_norms(x, 3, stride=stride, padding=1, groups=groups)
    n_c = ops.patch_norms(x.cpu(), 3, stride=stride, padding=1, groups=groups)
    assert n_g.shape[-1] == groups and _rel(n_g, n_c) <= 1e-5
    for explain in (False, True):
        outs = []
        for t, wt in ((x, w), (x.cpu(), w.cpu())):
            t = t.clone().requires_grad_(True)
            y = ops.bcos_conv2d(t, wt, stride=stride, padding=1, groups=groups,
                                explain=explain)
            (gx,) = torch.autograd.grad(y, t, torch.ones_like(y))
            outs.append((y.detach(), gx))
        (yg, gg), (yc, gc) = outs
        assert _rel(yg, yc) <= 1e-5 and _rel(gg, gc) <= 1e-5


# (M, K, N, eps_outside) at 1/8 of batch 128: the zoo ResNet-50's layer1
# conv1 and conv3 (K3 forward, K2 with the bare cotangent: the position
# norm's backward runs before it), ViT-L/16's linear1 and linear2
ZOO_SHAPES = [(401408 // 8, 256, 64, False), (401408 // 8, 64, 256, False),
              (25088 // 8, 1024, 4096, True), (25088 // 8, 4096, 1024, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n,eps_outside", ZOO_SHAPES)
def test_k3_and_k2_at_the_zoo_shapes(gpu, dtype, m, k, n, eps_outside):
    from bcosification_tpu_torch.ops.bcos import CONV_NORM_EPS, LINEAR_NORM_EPS

    g = torch.Generator(device=gpu).manual_seed(m + k + n)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    ct = torch.randn(m, n, device=gpu, generator=g).to(dtype)
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    kw = dict(eps=LINEAR_NORM_EPS if eps_outside else CONV_NORM_EPS, eps_outside=eps_outside)
    y = k3.bcos_matmul_fwd(x, wt, **kw)
    assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)) <= tol
    dx = k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw)
    want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None, relu=False, **kw)
    assert _rel(dx, want) <= tol
    torch.cuda.synchronize()


def test_meta_build_of_vit_l_allocates_nothing(gpu):
    """load_model of the ViT-L/16 under abstract_init: every tensor on the
    meta device, no byte of the card allocated; the converted model then
    lands on the card."""
    from bcosification_tpu_torch.models.pretrained import load_model
    from bcosification_tpu_torch.utils.init_mode import abstract_init

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with abstract_init():
        net = load_model("simple_vit_l_patch16_224", pretrained=False, device=gpu)
    assert torch.cuda.memory_allocated() == before
    assert all(t.device.type == "meta" for t in net.state_dict().values())
    assert sum(t.numel() for t in net.state_dict().values()) > 1.7e8


@pytest.mark.parametrize("name", ["resnext50_32x4d", "densenet121"])
def test_small_zoo_gpu_matches_cpu(gpu, name):
    """A small zoo net (its class and presets) in fp32: the fast pass on the
    card (K3 and K2 at every stride-1 1x1, no K1) against the CPU and
    against the generic autograd W (1e-5), and the forward's launches."""
    from bcosification_tpu_torch.explain import fast_densenet, fast_resnet
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.models import densenet, pretrained, resnet

    if name == "densenet121":
        build = pretrained._cnn(densenet.BcosDenseNet, growth_rate=8, block_config=(2, 2),
                                num_init_features=16, bn_size=2, num_classes=10,
                                with_logit_layer=True, stem_pool="avg")
        fast = fast_densenet
    else:
        build = pretrained._cnn(resnet.BcosResNet, block="bottleneck", layers=(1, 1),
                                inplanes=16, groups=8, width_per_group=16, num_classes=10)
        fast = fast_resnet
    net, cpu = build(device=gpu), build(device="cpu")
    n_1x1 = sum(1 for mod in net.modules() if getattr(mod, "kernel_size", None) == (1, 1)
                and getattr(mod, "stride", None) == (1, 1))
    g = torch.Generator(device=gpu).manual_seed(1)
    x = torch.rand(2, 64, 64, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    reset_launch_counts()
    logits, sel, w = fast.fast_dynamic_linear_weights(net, x)
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n_1x1,
                               "bcos_matmul_fwd": n_1x1, "stream_add": 0}
    reset_launch_counts()
    with torch.no_grad():
        out = net(x)
    assert launch_counts()["bcos_matmul_fwd"] == n_1x1
    lc, sc, wc = fast.fast_dynamic_linear_weights(cpu, x.cpu(), device="cpu")
    _, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    assert torch.equal(sel.cpu(), sc) and torch.equal(sm, sel)
    assert _rel(w, wc) <= 1e-5 and _rel(wm, w) <= 1e-5
    assert _rel(logits, lc) <= 1e-5 and _rel(out, lc) <= 1e-5


# --------------------------------------------------------------------------
# the zoo's VGG and ConvNeXt entries (models/vgg.py, models/convnext.py)
# --------------------------------------------------------------------------
# (M, K, N) at 1/8 of batch 128: ConvNeXt-atto's first stage (K and N of 40
# and 160: one TMA box past K and N filled with zeros), ConvNeXt-T's first
# stage, VGG-16's two 1x1 classifier convs
VGG_CONVNEXT_SHAPES = [(401408 // 8, 40, 160), (401408 // 8, 160, 40), (401408 // 8, 96, 384),
                       (401408 // 8, 384, 96), (6272 // 8, 4096, 4096), (6272 // 8, 4096, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", VGG_CONVNEXT_SHAPES)
def test_k3_and_k2_at_the_vgg_convnext_shapes(gpu, dtype, m, k, n):
    """K3 and K2 (the bare cotangent, and a per-channel mult) against
    their plain versions, with no operand padded."""
    g = torch.Generator(device=gpu).manual_seed(m + k + n)
    x = torch.randn(m, k, device=gpu, generator=g).to(dtype)
    wt = (torch.randn(n, k, device=gpu, generator=g) / k ** 0.5).to(dtype)
    ct = torch.randn(m, n, device=gpu, generator=g).to(dtype)
    mult = torch.rand(n, device=gpu, generator=g) + 0.1
    ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    before = k12.tma_operands.padded
    y = k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False)
    assert _rel(y, k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=False)) <= tol
    for mlt in (None, mult):
        dx = k12.conv1x1_bwd_explain(x, wt, ct, None, mlt, relu=False)
        want = k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, mlt, relu=False)
        assert _rel(dx, want) <= tol
    torch.cuda.synchronize()
    assert k12.tma_operands.padded == before


def _small_vgg_convnext(name, device, monkeypatch):
    """(net, the same net on the CPU) of a small VGG or ConvNeXt of the
    zoo's layers, every layer_scale O(1) and every running_var the mean
    square of its norm's input on a probe (so no layer vanishes); logit
    bias 0, so the logits are the pre-logits (VGG's classifier contracts
    them ~3e4-fold, below the bias's rounding)."""
    from bcosification_tpu_torch.models import convnext, pretrained, vgg
    from bcosification_tpu_torch.modules import BatchNormUncentered2d, NoBias

    if name == "vgg_bnu":
        monkeypatch.setitem(vgg.CFGS, "T", [16, "M", 32, "M", 64, 64, "M", 64, "M"])
        net = pretrained._cnn(vgg.BcosVGG, cfg="T", num_classes=10,
                              logit_bias=0.0)(device=device)
    else:
        extra = (dict(norm_layer=NoBias(BatchNormUncentered2d)) if name == "convnext_bnu"
                 else {})
        blocks = [convnext.CNBlockConfig(16, 32, 2), convnext.CNBlockConfig(32, None, 2)]
        net = pretrained._cnn(convnext.BcosConvNeXt, block_setting=blocks, num_classes=10,
                              logit_bias=0.0, **extra)(device=device)
    g = torch.Generator(device=device).manual_seed(5)
    probe = torch.rand(1, 32, 32, 6, device=device, generator=g)

    def pre(mod, args):
        mod.running_var.copy_(args[0].float().square().mean(dim=(0, 1, 2)))

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, convnext.CNBlock):
                mod.layer_scale.copy_(torch.rand(mod.layer_scale.shape, device=device,
                                                 generator=g) - 0.5)
        hooks = [m.register_forward_pre_hook(pre) for m in net.modules()
                 if isinstance(m, BatchNormUncentered2d)]
        net(probe)
        for h in hooks:
            h.remove()
    return net, copy.deepcopy(net).to("cpu")


@pytest.mark.parametrize("name", ["vgg_bnu", "convnext_pn", "convnext_bnu"])
def test_small_vgg_convnext_gpu_matches_cpu(gpu, name, monkeypatch):
    """A small VGG or ConvNeXt in fp32: the fast pass on the card (K3 and K2
    at every stride-1 1x1, no K1) against the CPU and against the generic
    autograd W (1e-5), and the forward's launches."""
    from bcosification_tpu_torch.explain import fast_convnext, fast_vgg
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, cpu = _small_vgg_convnext(name, gpu, monkeypatch)
    fast = fast_vgg if name.startswith("vgg") else fast_convnext
    n_1x1 = sum(1 for mod in net.modules() if getattr(mod, "kernel_size", None) == (1, 1)
                and getattr(mod, "stride", None) == (1, 1))
    assert n_1x1 == (2 if name.startswith("vgg") else 9)
    g = torch.Generator(device=gpu).manual_seed(1)
    x = torch.rand(2, 32, 32, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    reset_launch_counts()
    logits, sel, w = fast.fast_dynamic_linear_weights(net, x)
    assert launch_counts() == {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n_1x1,
                               "bcos_matmul_fwd": n_1x1, "stream_add": 0}
    reset_launch_counts()
    with torch.no_grad():
        out = net(x)
    assert launch_counts()["bcos_matmul_fwd"] == n_1x1
    lc, sc, wc = fast.fast_dynamic_linear_weights(cpu, x.cpu(), device="cpu")
    _, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x)
    assert torch.equal(sel.cpu(), sc) and torch.equal(sm, sel)
    assert _rel(w, wc) <= 1e-5 and _rel(wm, w) <= 1e-5
    assert _rel(logits, lc) <= 1e-5 and _rel(out, lc) <= 1e-5


@pytest.mark.parametrize("norm", ["AllNormUncentered2d", "BatchNormUncentered2d"])
def test_k1_gate_takes_a_per_channel_mult_only(gpu, norm):
    """A small ResNet of B-cos convs and ReLUs with the bias-free uncentered
    AllNorm (a (1,) mult) or BN (a mult per output channel), same weights:
    the eval forward folds every 1x1's norm into its epilogue; K1 takes the
    BN's, the AllNorm's stay off it (the stride-1 1x1s on K3); both equal
    the CPU (1e-5; logit bias 0: the logits are the pre-logits)."""
    from bcosification_tpu_torch.models import pretrained, resnet
    from bcosification_tpu_torch.modules import NoBias, ReLU, norms

    build = pretrained._cnn(resnet.BcosResNet, block="bottleneck", layers=(1, 1), inplanes=16,
                            num_classes=10, norm_layer=NoBias(getattr(norms, norm)),
                            act_layer=ReLU, logit_bias=0.0)
    net, cpu = build(device=gpu), build(device="cpu")
    convs = [m for m in net.modules() if getattr(m, "kernel_size", None) == (1, 1)]
    n_1x1, n_fc = len(convs) - 1, 1  # the classifier has no norm
    n_stride1 = sum(1 for m in convs if m.stride == (1, 1))
    g = torch.Generator(device=gpu).manual_seed(2)
    x = torch.rand(2, 64, 64, 3, device=gpu, generator=g)
    x = torch.cat([x, 1.0 - x], dim=-1)
    reset_launch_counts()
    with torch.no_grad():
        out = net(x)
    counts = launch_counts()
    if norm == "AllNormUncentered2d":
        assert counts["bcos_conv1x1_fwd"] == 0 and counts["bcos_matmul_fwd"] == n_stride1
    else:
        assert counts["bcos_conv1x1_fwd"] == n_1x1 and counts["bcos_matmul_fwd"] == n_fc
    with torch.no_grad():
        want = cpu(x.cpu())
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_slot_tables_and_experts_match_cpu(gpu, top_k):
    """The switch MoE (modules/moe.py) on the card against the CPU, fp32,
    300 tokens under capacity pressure: the same choices, slots and kept
    assignments; the output and the input gradient of explain mode within
    1e-5; K3 once per expert per forward; a fully dropped token's row
    exactly zero."""
    from bcosification_tpu_torch.modules.moe import BcosMoE

    g = torch.Generator().manual_seed(top_k)
    cpu = BcosMoE(4, 64, 32, top_k=top_k, capacity_factor=0.9, generator=g)
    with torch.no_grad():
        cpu.router.mul_(25.0)  # well separated choices
    moe = copy.deepcopy(cpu).to(gpu)
    x = torch.randn(3, 100, 64, generator=g)
    r_cpu = cpu.route(x.reshape(-1, 64), explain=True)
    reset_launch_counts()
    r_gpu = moe.route(x.reshape(-1, 64).to(gpu), explain=True)
    for name in ("top_idx", "pos_in_expert", "keep", "dest", "slot_assign"):
        assert torch.equal(getattr(r_gpu, name).cpu(), getattr(r_cpu, name)), name
    assert r_gpu.capacity == r_cpu.capacity
    xg = x.to(gpu).requires_grad_()
    xc = x.clone().requires_grad_()
    reset_launch_counts()
    yg = moe(xg, explain=True)
    assert launch_counts()["bcos_matmul_fwd"] == 4
    yc = cpu(xc, explain=True)
    assert _rel(yg, yc) <= 1e-5
    ct = torch.randn(yc.shape, generator=g)
    (gg,) = torch.autograd.grad(yg, xg, ct.to(gpu))
    (gc,) = torch.autograd.grad(yc, xc, ct)
    assert _rel(gg, gc) <= 1e-5
    dropped = ~r_cpu.keep.reshape(top_k, -1).any(0)
    assert (~r_cpu.keep).any() and not yg.reshape(-1, 32)[dropped.to(gpu)].abs().sum()


# (M, K, N) off torch._int_mm's CUDA rules (M > 16; K and N multiples of 8)
INT_MM_SHAPES = [(5, 24, 16), (16, 64, 128), (40, 13, 16), (40, 24, 7), (1, 1, 1),
                 (3136, 1152, 128)]


@pytest.mark.parametrize("m,k,n", INT_MM_SHAPES)
def test_int_mm_route_pads_exactly_on_the_card(gpu, m, k, n):
    """ops/int8.int_mm zero-pads what cuBLASLt's int8 GEMM refuses: the
    int32 product equals the CPU's int64 one exactly; int8_product's conv
    routes (1x1, strided, 3x3 grouped and dilated) equal the plain float64
    conv, on the card."""
    from bcosification_tpu_torch.ops import int8 as i8

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    assert torch.equal(i8.int_mm(a.to(gpu), b.to(gpu)).cpu(), (a.long() @ b.long()).int())
    xq = torch.randint(-127, 128, (2, 9, 9, 16), generator=gen, dtype=torch.int8).to(gpu)
    for wshape, args in (((24, 16, 1, 1), (2, 0, 1, 1)), ((32, 8, 3, 3), (1, 2, 2, 2)),
                         ((16, 16, 3, 3), (2, 1, 1, 1))):
        wq = torch.randint(-127, 128, wshape, generator=gen, dtype=torch.int8).to(gpu)
        assert torch.equal(i8.int8_product(xq, wq, *args), i8.int8_product_plain(xq, wq, *args))


def test_int8_conv_gpu_matches_cpu(gpu):
    """conv_int8_dynamic on the card equals the CPU's bit for bit: the same
    scales, rounded operands and int32 products, one cast."""
    from bcosification_tpu_torch.ops import bcos as ops

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 14, 14, 128, generator=gen).to(torch.bfloat16)
    w = torch.randn(256, 128, 3, 3, generator=gen) * 0.05
    for args in ((1, 1, 1, 1), (2, 1, 1, 2)):
        wa = w[:, :128 // args[3]]
        got = ops.conv_int8_dynamic(x.to(gpu), wa.to(gpu), *args)
        assert torch.equal(got.cpu(), ops.conv_int8_dynamic(x, wa, *args))
