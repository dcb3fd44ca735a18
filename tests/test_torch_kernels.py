"""The plain versions of the port's three Hopper kernels against their JAX
counterparts on the CPU (fp32, ragged shapes, a stride-2 1x1). On a GPU
each kernel is held against its plain version by tests/test_torch_gpu.py.

K1 bcos_conv1x1_fwd      <- ops/pallas/bcos_conv1x1.py (jnp path of bcos_conv1x1_bn_act)
K2 bcos_conv1x1_bwd_explain <- jax.vjp of that call with explain=True
K3 bcos_matmul_fwd       <- ops/pallas/bcos_matmul.py::_reference_forward
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.ops import bcos as jops
from bcosification_tpu.ops.pallas import bcos_conv1x1 as jconv
from bcosification_tpu.ops.pallas import bcos_matmul as jmm
from bcosification_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launch_counts
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as tconv
from bcosification_tpu_torch.ops.cuda import bcos_matmul as tmm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
M, CIN, COUT = 37, 24, 10  # ragged against every tile size


def _inputs(seed, shape=(1, M, 1, CIN), cout=COUT):
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], cout)) / np.sqrt(shape[-1])).astype(np.float32)
    mult = (rng.random(cout) + 0.5).astype(np.float32)
    add = rng.standard_normal(cout).astype(np.float32)
    return x4, w, mult, add


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_add", [True, False])
def test_k1_plain_matches_jax(relu, with_add):
    x4, w, mult, add = _inputs(0)
    add = add if with_add else None
    want = jconv.bcos_conv1x1_bn_act(jnp.asarray(x4), jnp.asarray(w), None, jnp.asarray(mult),
                                     None if add is None else jnp.asarray(add), relu=relu,
                                     explain=True)
    got = tconv.conv1x1_fwd_plain(_t(x4.reshape(M, CIN)), _t(w.T), _t(mult), _t(add), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(M, COUT), **TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_k2_plain_matches_jax_vjp(relu):
    x4, w, mult, add = _inputs(1)
    ct = np.random.default_rng(11).standard_normal((1, M, 1, COUT)).astype(np.float32)

    def f(xx):
        return jconv.bcos_conv1x1_bn_act(xx, jnp.asarray(w), None, jnp.asarray(mult),
                                         jnp.asarray(add), relu=relu, explain=True)

    out, vjp = jax.vjp(f, jnp.asarray(x4))
    (want,) = vjp(jnp.asarray(ct))
    x2 = _t(x4.reshape(M, CIN))
    a = _t(np.asarray(out).reshape(M, COUT))
    got = tconv.conv1x1_bwd_explain_plain(x2, _t(w.T), _t(ct.reshape(M, COUT)), a, _t(mult),
                                          relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(M, CIN), **TOL)

    # the public entry's autograd backward is the same function
    x4t = _t(x4).requires_grad_(True)
    z = tconv.bcos_conv1x1_bn_act(x4t, _t(w), _t(mult), _t(add), relu=relu, explain=True)
    (g,) = torch.autograd.grad(z, x4t, grad_outputs=_t(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_stride2_1x1_matches_jax_conv():
    x4, w, mult, add = _inputs(2, shape=(2, 7, 5, CIN))
    ct = np.random.default_rng(12).standard_normal((2, 4, 3, COUT)).astype(np.float32)

    def f(xx):
        y = jops.bcos_conv2d(xx, jnp.asarray(w).reshape(1, 1, CIN, COUT), stride=2,
                             normalize_weights=False, explain=True)
        return jnp.maximum(y * jnp.asarray(mult) + jnp.asarray(add), 0.0)

    want, vjp = jax.vjp(f, jnp.asarray(x4))
    (want_dx,) = vjp(jnp.asarray(ct))
    x4t = _t(x4).requires_grad_(True)
    z = tconv.bcos_conv1x1_bn_act(x4t, _t(w), _t(mult), _t(add), relu=True, explain=True,
                                  stride=2)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want), **TOL)
    (g,) = torch.autograd.grad(z, x4t, grad_outputs=_t(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_dx), **TOL)


def test_eval_gradient_without_explain_matches_jax():
    """An eval-mode forward without explain, differentiated in x and every
    weight (what IxG, Grad and GB explainers need): the port routes the
    1x1 convs that would reach K1 unfused, as the JAX package's jnp path
    does, and matches jax.grad of apply(train=False, explain=False)."""
    from bcosification_tpu_torch.models import resnet
    from torch_port_helpers import small_pair

    net, variables, tnet, x = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    ct = np.random.default_rng(21).standard_normal((2, 10)).astype(np.float32)

    def f(params, xx):
        out = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                        train=False, explain=False)
        return jnp.sum(out * jnp.asarray(ct))

    want_p, want_x = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        arr = np.asarray(leaf)
        flat[".".join(k.key for k in path)] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr

    tnet.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    before = resnet._conv_bn_act.grad_route
    (tnet(xt, train=False) * _t(ct)).sum().backward()
    # conv1, conv3 and the downsample of both bottlenecks
    assert resnet._conv_bn_act.grad_route - before == 6

    def rel(got, ref):
        return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))

    assert rel(xt.grad.numpy(), np.asarray(want_x)) <= 1e-5
    params = dict(tnet.named_parameters())
    assert sorted(params) == sorted(flat)
    for name, p in params.items():
        assert rel(p.grad.numpy(), flat[name]) <= 1e-5, name
    # without a gradient the eval forward keeps the fused kernel's route
    with torch.no_grad():
        tnet(xt, train=False)
    assert resnet._conv_bn_act.grad_route - before == 6


@pytest.mark.parametrize("eps_outside", [False, True])
def test_k3_plain_matches_jax(eps_outside):
    x4, w, _, _ = _inputs(4)
    x = x4.reshape(M, CIN)
    eps = 1e-12 if eps_outside else 1e-6
    want = jmm._reference_forward(jnp.asarray(x), jnp.asarray(w), eps, eps_outside)
    got = tmm.bcos_matmul_fwd_plain(_t(x), _t(w.T), eps=eps, eps_outside=eps_outside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # explanation-mode gradient: the explain branch of the JAX custom VJP
    ct = np.random.default_rng(14).standard_normal((M, COUT)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jmm.bcos_matmul(xx, jnp.asarray(w), eps, eps_outside, True),
                     jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_(True)
    y = tmm.bcos_matmul(xt, _t(w), eps, eps_outside, True)
    (g,) = torch.autograd.grad(y, xt, grad_outputs=_t(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_dx), **TOL)


def test_wrappers_reject_bad_operands():
    x2 = torch.randn(M, CIN)
    wt = torch.randn(COUT, CIN)
    mult = torch.ones(COUT)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv1x1_fwd(x2, torch.randn(CIN, COUT).t(), mult, None, relu=True)
    with pytest.raises(ValueError):
        tconv.conv1x1_fwd(x2, torch.randn(COUT, CIN + 1), mult, None, relu=True)
    with pytest.raises(ValueError):
        tconv.conv1x1_fwd(x2, wt, mult.double(), None, relu=True)
    with pytest.raises(TypeError):
        tmm.bcos_matmul_fwd(x2.half(), wt.half(), eps=1e-6, eps_outside=False)
    with pytest.raises(ValueError):
        tconv.conv1x1_bwd_explain(x2, wt, torch.randn(M, COUT), None, mult, relu=True)


def test_cpu_tensors_never_count_as_launches():
    reset_launch_counts()
    x4, w, mult, add = _inputs(5)
    tconv.bcos_conv1x1_bn_act(_t(x4), _t(w), _t(mult), _t(add), relu=True, explain=True)
    assert launch_counts() == {name: 0 for name in KERNELS}


@pytest.mark.parametrize("cin", [300, 24])
def test_tma_operands_pad_and_realign(cin):
    """bf16 operands off the TMA grid: Cin zero-padded to a multiple of 8,
    a misaligned view copied to aligned storage, each such call counted;
    the padded operands give the same K1, K2 and K3 results."""
    g = torch.Generator().manual_seed(cin)
    m, cout = 70, 36
    base = torch.randn(m * cin + 1, generator=g).to(torch.bfloat16)
    x = base[1:].view(m, cin)  # offset by one element: 2 bytes off the 16-byte grid
    assert x.is_contiguous() and x.data_ptr() % 16
    wt = torch.randn(cout, cin, generator=g).to(torch.bfloat16)
    before = tconv.tma_operands.padded
    xp, wtp = tconv.tma_operands(x, wt)
    assert tconv.tma_operands.padded == before + 1
    assert xp.shape[1] % 8 == 0 and xp.data_ptr() % 16 == 0 and wtp.data_ptr() % 16 == 0
    assert xp.shape[1] - cin == (-cin) % 8
    assert torch.equal(xp[:, :cin], x) and not xp[:, cin:].any() and not wtp[:, cin:].any()
    mult, add = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g)
    ct = torch.randn(m, cout, generator=g).to(torch.bfloat16)
    a = tconv.conv1x1_fwd_plain(x, wt, mult, add, relu=True)
    assert torch.equal(tconv.conv1x1_fwd_plain(xp, wtp, mult, add, relu=True), a)
    dx = tconv.conv1x1_bwd_explain_plain(xp, wtp, ct, a, mult, relu=True)[:, :cin]
    assert torch.equal(dx, tconv.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, relu=True))
    y = tmm.bcos_matmul_fwd_plain(xp, wtp, eps=1e-6, eps_outside=False)
    torch.testing.assert_close(y, tmm.bcos_matmul_fwd_plain(x, wt, eps=1e-6, eps_outside=False),
                               rtol=1e-6, atol=0)
    # an fp32 K1 operand off the grid of 4 (Cin + 1, K1's 3xTF32 route loads
    # by TMA too): zero-padded, counted, and K1's result unchanged by it
    xf1 = torch.randn(m, cin + 1, generator=g)
    wf1 = torch.randn(cout, cin + 1, generator=g) / cin ** 0.5
    before = tconv.tma_operands.padded
    xp, wtp = tconv.tma_operands(xf1, wf1)
    assert tconv.tma_operands.padded == before + 1
    assert xp.shape[1] == cin + 4 and wtp.shape[1] == cin + 4
    assert torch.equal(xp[:, :cin + 1], xf1) and not xp[:, cin + 1:].any()
    torch.testing.assert_close(tconv.conv1x1_fwd_plain(xp, wtp, mult, add, relu=True),
                               tconv.conv1x1_fwd_plain(xf1, wf1, mult, add, relu=True),
                               rtol=1e-6, atol=1e-7)
    # aligned operands on the grid (bf16, and fp32 with Cin a multiple of 4)
    # pass unchanged and uncounted
    before = tconv.tma_operands.padded
    x8 = torch.randn(m, 64).to(torch.bfloat16)
    w8 = torch.randn(cout, 64).to(torch.bfloat16)
    assert all(a is b for a, b in zip(tconv.tma_operands(x8, w8), (x8, w8)))
    xf = x.float()
    assert tconv.tma_operands(xf, wt.float())[0] is xf
    assert tconv.tma_operands.padded == before


@pytest.mark.parametrize("cin,misaligned", [(30, False), (64, True), (30, True)],
                         ids=["pad", "realign", "pad-misaligned"])
def test_tma_operands_fp32(cin, misaligned):
    """fp32 operands of K2's and K3's 3xTF32 route: Cin off the grid of 4
    zero-padded, a view 4 bytes off the 16-byte grid copied to aligned
    storage, each such call counted once; the plain versions give the same
    results on the padded operands."""
    g = torch.Generator().manual_seed(cin)
    m, cout = 49, 36
    base = torch.randn(m * cin + 1, generator=g)
    x = base[1:].view(m, cin) if misaligned else base[:-1].view(m, cin).clone()
    assert x.is_contiguous() and bool(x.data_ptr() % 16) == misaligned
    wt = torch.randn(cout, cin, generator=g) / cin ** 0.5
    before = tconv.tma_operands.padded
    xp, wtp = tconv.tma_operands(x, wt)
    assert tconv.tma_operands.padded == before + 1
    assert xp.shape[1] == cin + (-cin) % 4 and wtp.shape[1] == xp.shape[1]
    assert xp.data_ptr() % 16 == 0 and wtp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, :cin], x) and not xp[:, cin:].any() and not wtp[:, cin:].any()
    mult, ct = torch.rand(cout, generator=g) + 0.5, torch.randn(m, cout, generator=g)
    a = tconv.conv1x1_fwd_plain(x, wt, mult, None, relu=True)
    dx = tconv.conv1x1_bwd_explain_plain(xp, wtp, ct, a, mult, relu=True)[:, :cin]
    torch.testing.assert_close(dx, tconv.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, relu=True),
                               rtol=1e-6, atol=1e-7)
    y = tmm.bcos_matmul_fwd_plain(xp, wtp, eps=1e-6, eps_outside=True)
    torch.testing.assert_close(y, tmm.bcos_matmul_fwd_plain(x, wt, eps=1e-6, eps_outside=True),
                               rtol=1e-6, atol=1e-7)
    # the wrappers' scratch: K3 the split weight, K2 also g and the transposes
    k = xp.shape[1]
    assert tmm.fwd_scratch(m, k, cout, torch.float32, "cpu").numel() == 2 * cout * k
    assert tconv.bwd_scratch(m, k, cout, torch.float32, "cpu").numel() == \
        m * 36 + 2 * cout * k + 2 * k * 36
    assert tmm.fwd_scratch(m, k, cout, torch.bfloat16, "cpu") is None
    # split-K adds [splits, 128, round_up(cout, 4) + 1] (K2: the larger launch's)
    assert tmm.fwd_scratch(m, k, cout, torch.float32, "cpu", 3).numel() == \
        2 * cout * k + 3 * 128 * 37
    assert tconv.bwd_scratch(m, k, cout, torch.float32, "cpu", (2, 3)).numel() == \
        m * 36 + 2 * cout * k + 2 * k * 36 + max(2 * 128 * 37, 3 * 128 * (k + 1))


@pytest.mark.parametrize("m,k,n,want", [
    (49, 2048, 512, 16),     # text localisation, layer4 (4 tiles, 64 stages)
    (49, 2048, 1024, 16),    # the c_proj (8 tiles)
    (196, 1024, 256, 8),     # layer3 (4 tiles, 32 stages)
    (196, 256, 1024, 2),     # 16 tiles, 8 stages: 2 splits of 4
    (784, 512, 128, 4),      # 7 tiles, 16 stages
    (3136, 64, 256, 1),      # 50 tiles, 2 stages
    (200704, 256, 128, 1),   # a harness encode's layer1 (1568 tiles)
    (49, 100, 61, 1),        # 4 stages: too short to split
])
def test_tf32_splits_on_an_h100(m, k, n, want):
    """The fp32 route splits K only where the 128 x 128 tiles fill less
    than half of the H100's 132 SMs, into at least 4 stages per split."""
    splits = tconv.tf32_splits(m, k, n, 132)
    assert splits == want
    stages = -(-k // 32)
    chunk = -(-stages // splits)
    assert (splits - 1) * chunk < stages  # every split has stages


def test_tf32_split():
    """hi keeps the top 19 bits (the low 13 mantissa bits clear), rounded to
    nearest with ties away from zero as cvt.rna; lo is the rest, rounded
    alike; hi + lo is a within 2^-21 |a| across the exponent range."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    a[:3] = [0.0, -0.0, 1.0]
    at = torch.from_numpy(a)
    hi, lo = tmm.tf32_split(at)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (at.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * at.double().abs()).all())
    assert bool(((at - hi).abs() <= 2.0 ** -11 * at.abs()).all())
    # ties: half a tf32 ulp rounds away from zero, in both signs
    tie = torch.tensor([0x3F801000, 0x3F800FFF], dtype=torch.int32).view(torch.float32)
    want = torch.tensor([0x3F802000, 0x3F800000], dtype=torch.int32).view(torch.float32)
    assert torch.equal(tmm.tf32_split(tie)[0], want)
    assert torch.equal(tmm.tf32_split(-tie)[0], -want)


def _tf32_truncated(a):
    """a as the tensor cores read an f32 as tf32: the low 13 bits dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in the fp32 route's arithmetic: hi hi + hi lo + lo hi, the
    small terms first, each product exact and summed in f32."""
    ah, al = tmm.tf32_split(a)
    bh, bl = tmm.tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32_truncated(a) @ _tf32_truncated(b)


# The fp32 route's scheme against the JAX package's fp32 functions at the
# depths the port runs (K = 64, 512, 2048; x normal, w scaled by 1/sqrt(K)):
# 3xTF32 lies within 1e-5 of max |ref| (phase 3's fp32 bound on the card),
# one tf32 pass, which the tensor cores would run on unsplit f32, far
# outside it, so the bound can tell the two apart.
@pytest.mark.parametrize("k", [64, 512, 2048])
def test_3xtf32_scheme_matches_jax(k):
    rng = np.random.default_rng(k)
    m, n = 128, 96
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    mult = (rng.random(n) + 0.5).astype(np.float32)
    ct = rng.standard_normal((m, n)).astype(np.float32)
    xt, wt = _t(x), _t(w.T)
    n_x = torch.sqrt((xt * xt).sum(-1, keepdim=True) + 1e-6)

    def rel(got, want):
        want = np.asarray(want)
        return float(np.abs(got.numpy() - want).max() / np.abs(want).max())

    # K3: y = u |u| / n
    want = jmm._reference_forward(jnp.asarray(x), jnp.asarray(w), 1e-6, False)
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        u = mm(xt, wt.t())
        errs[name] = rel(u * (u.abs() / n_x), want)
    assert errs["3xtf32"] <= 1e-5 < errs["1xtf32"], errs

    # K2: dx = (ct mult [a > 0] |u| / n) w^T, both products in the scheme
    def f(xx):
        return jconv.bcos_conv1x1_bn_act(xx, jnp.asarray(w), None, jnp.asarray(mult), None,
                                         relu=True, explain=True)

    out, vjp = jax.vjp(f, jnp.asarray(x.reshape(1, m, 1, k)))
    (want_dx,) = vjp(jnp.asarray(ct.reshape(1, m, 1, n)))
    live = _t(np.asarray(out).reshape(m, n)) > 0
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        u = mm(xt, wt.t())
        g = torch.where(live, _t(ct) * _t(mult), 0.0) * (u.abs() / n_x)
        errs[name] = rel(mm(g, wt), np.asarray(want_dx).reshape(m, k))
    assert errs["3xtf32"] <= 1e-5 < errs["1xtf32"], errs


# K1's fp32 route in the same scheme: z = (|u| / n) u mult + add, then the
# ReLU, against the JAX fused conv (explain=False, its jnp path in f32) at
# the same depths, with the BN's mult and add as chip_smoke.py draws them
@pytest.mark.parametrize("k", [64, 512, 2048])
def test_3xtf32_k1_scheme_matches_jax(k):
    rng = np.random.default_rng(k + 1)
    m, n = 128, 96
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    mult = (rng.random(n) + 0.5).astype(np.float32)
    add = (0.1 * rng.standard_normal(n)).astype(np.float32)
    want = jconv.bcos_conv1x1_bn_act(jnp.asarray(x.reshape(1, m, 1, k)), jnp.asarray(w), None,
                                     jnp.asarray(mult), jnp.asarray(add), relu=True,
                                     explain=False)
    want = np.asarray(want).reshape(m, n)
    xt, wt = _t(x), _t(w.T)
    n_x = torch.sqrt((xt * xt).sum(-1, keepdim=True) + 1e-6)
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        u = mm(xt, wt.t())
        z = torch.clamp_min((u.abs() / n_x) * u * _t(mult) + _t(add), 0.0)
        errs[name] = float(np.abs(z.numpy() - want).max() / np.abs(want).max())
    assert errs["3xtf32"] <= 1e-5 < errs["1xtf32"], errs
