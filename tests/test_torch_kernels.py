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
    # aligned operands on the grid, and fp32 operands, pass unchanged and uncounted
    before = tconv.tma_operands.padded
    x8 = torch.randn(m, 64).to(torch.bfloat16)
    w8 = torch.randn(cout, 64).to(torch.bfloat16)
    assert all(a is b for a, b in zip(tconv.tma_operands(x8, w8), (x8, w8)))
    xf = x.float()
    assert tconv.tma_operands(xf, wt.float())[0] is xf
    assert tconv.tma_operands.padded == before
