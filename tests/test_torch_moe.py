"""The PyTorch port's switch MoE (``modules/moe.py``, ``models/vit.py``'s
``MoEFeedForward``, the MoE in ``explain/fast_vit.py``) against the JAX
package's ``modules/moe.py`` and ``models/vit.py``, on the CPU, in fp32,
on weights drawn with numpy from a seed and carried across by
``bcosify/from_jax.py`` (tolerance 1e-5):

- BcosMoE (4 experts, 16 -> 24, 16 tokens) at top-1 and top-2, with ample
  capacity and under capacity pressure, with raw and renormalised gates:
  the output, the router's probabilities and choices as JAX sows them (the
  port's ``record_intermediates``), every assignment's place in its
  expert's queue and whether it is kept equal to the JAX formula's, a
  fully dropped token's row exactly zero; ``load_balancing_loss``;
- explain mode: the values identical to the plain forward, x . dy/dx = y
  (completeness), the input gradient against JAX's VJP, finite parameter
  gradients in both modes (the ones-filled empty slots);
- a tiny MoE SimpleViT (dim 32, depth 2, 4 heads, mlp 48, 4 experts, patch
  4, 16x16) at top-2: the forward, W through autograd and
  through ``fast_vit`` against JAX's W, the export round trip of the
  explanation, one train step's gradients against ``jax.grad``, the sown
  choices; without the positional embedding, the forward against JAX's and
  the completeness of the whole net's W;
- MoEFeedForward's b from the linear factory and its refusal of a biased
  one.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.models import vit as jvit
from bcosification_tpu.modules import bcos_layers as jlayers
from bcosification_tpu.modules import moe as jmoe
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
from bcosification_tpu_torch.explain import fast_vit
from bcosification_tpu_torch.explain.core import dynamic_linear_weights
from bcosification_tpu_torch.models import vit as tvit
from bcosification_tpu_torch.modules import BcosLinear
from bcosification_tpu_torch.modules import moe as tmoe
from test_torch_vit import images

torch.set_num_threads(1)
E, D, F = 4, 16, 24


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _moe_pair(seed=0, **kw):
    """(JAX BcosMoE, its params drawn from ``seed``, the port's BcosMoE
    holding them, x [2, 8, D])."""
    rng = np.random.default_rng(seed)
    params = {"router": (0.5 * rng.standard_normal((D, E))).astype(np.float32),
              "experts": rng.uniform(-0.25, 0.25, (E, D, F)).astype(np.float32)}
    tm = tmoe.BcosMoE(E, D, F, **kw)
    load_jax_variables(tm, {"params": params})
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    return jmoe.BcosMoE(num_experts=E, features=F, **kw), params, tm, x


def _jax_slots(top_idx, capacity):
    """pos_in_expert and keep as the JAX module computes them
    (``modules/moe.py``: the cumsum of the choice-major one-hots)."""
    n, k = top_idx.shape
    idx_m = jnp.asarray(top_idx).T.reshape(k * n)
    onehot = jax.nn.one_hot(idx_m, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) * onehot - 1
    pos_in_expert = jnp.sum(pos * onehot, axis=-1)
    keep = (pos_in_expert >= 0) & (pos_in_expert < capacity)
    return np.asarray(pos_in_expert), np.asarray(keep)


MOE_CASES = [  # (label, BcosMoE options, capacity pressure)
    ("top1", dict(capacity_factor=8.0), False),
    ("top1 pressure", dict(capacity_factor=0.25), True),
    ("top2", dict(capacity_factor=8.0, top_k=2), False),
    ("top2 pressure", dict(capacity_factor=0.6, top_k=2), True),
    ("top2 raw gates", dict(capacity_factor=8.0, top_k=2, renormalize_gates=False), False),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_matches_jax(case):
    _, kw, pressure = case
    jm, params, tm, x = _moe_pair(**kw)
    yj, inter = jax.jit(lambda p, t: jm.apply({"params": p}, t, mutable=["intermediates"]))(
        params, jnp.asarray(x))
    inter = inter["intermediates"]
    with tmoe.record_intermediates(tm) as rec, torch.no_grad():
        yt = tm(torch.from_numpy(x))
        routing = tm.route(torch.from_numpy(x).reshape(-1, D), explain=False)
    rec = rec[""]
    _close(yt, yj)
    _close(rec["router_probs"][0], inter["router_probs"][0], 1e-6)
    np.testing.assert_array_equal(rec["expert_idx"][0], inter["expert_idx"][0])
    k = kw.get("top_k", 1)
    if k > 1:
        np.testing.assert_array_equal(rec["top_idx"][0], inter["top_idx"][0])
    else:
        assert "top_idx" not in rec and "top_idx" not in inter
    top_idx = np.asarray(inter["top_idx"][0] if k > 1 else inter["expert_idx"][0][:, None])
    capacity = int(np.ceil(k * 16 / E * kw["capacity_factor"]))
    assert routing.capacity == capacity
    pos, keep = _jax_slots(top_idx, capacity)
    np.testing.assert_array_equal(routing.pos_in_expert.numpy(), pos)
    np.testing.assert_array_equal(routing.keep.numpy(), keep)
    assert bool((~keep).any()) == pressure
    dropped = ~keep.reshape(k, 16).any(0)  # tokens that lost every choice
    assert bool(dropped.any()) == pressure
    assert float(yt.reshape(16, F)[torch.from_numpy(dropped)].abs().sum()) == 0.0
    _close(tmoe.load_balancing_loss(rec["router_probs"][0], rec["expert_idx"][0]),
           jmoe.load_balancing_loss(inter["router_probs"][0], inter["expert_idx"][0]), 1e-6)


def test_load_balancing_loss_matches_jax():
    """1 at perfect balance, about E under collapse, as in JAX."""
    n = 16
    idx = np.arange(n) % E
    probs = np.full((n, E), 1.0 / E, np.float32)
    collapsed = np.asarray(jax.nn.one_hot(jnp.zeros(n, jnp.int32), E)) * 0.97 + 0.01
    for p, i in ((probs, idx), (collapsed.astype(np.float32), np.zeros(n, np.int64))):
        got = tmoe.load_balancing_loss(torch.from_numpy(p), torch.from_numpy(i))
        _close(got, jmoe.load_balancing_loss(jnp.asarray(p), jnp.asarray(i)), 1e-6)
    assert abs(float(tmoe.load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(idx)))
               - 1.0) < 1e-6


@pytest.mark.parametrize("case", [MOE_CASES[1], MOE_CASES[3]], ids=["top1", "top2"])
def test_explain_values_identical_complete_and_finite(case):
    """Under capacity pressure: explain mode gives the plain values; its
    input gradient equals JAX's VJP and x . dx = ct . y; the parameter
    gradients are finite in both modes."""
    _, kw, _ = case
    jm, params, tm, x = _moe_pair(seed=1, **kw)
    xt = torch.from_numpy(x).requires_grad_()
    ct = np.random.default_rng(2).standard_normal((2, 8, F)).astype(np.float32)
    y = tm(xt, explain=True)
    with torch.no_grad():
        assert torch.equal(y, tm(xt))
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    vjp = jax.jit(lambda t, c: jax.vjp(lambda u: jm.apply({"params": params}, u, explain=True),
                                       t)[1](c)[0])
    _close(g, vjp(jnp.asarray(x), jnp.asarray(ct)))
    _close((xt * g).sum().detach(), (torch.from_numpy(ct) * y).sum().detach())
    for explain in (False, True):
        tm.zero_grad()
        tm(xt, explain=explain).square().sum().backward()
        # under explain the router's gates are detached: no gradient
        assert tm.router.grad is None if explain else torch.isfinite(tm.router.grad).all()
        assert torch.isfinite(tm.experts.grad).all()


def _randomized(variables, seed):
    """The JAX ViT's variables redrawn from ``seed``: linear weights and
    experts U(-1/sqrt(in), 1/sqrt(in)), routers 0.5 N (well separated
    choices), norm weights 1 + 0.2 N, biases 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a, key = np.asarray(a), path[-1].key
        if key == "router":
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        if (key == "weight" and a.ndim == 2) or key == "experts":
            bound = 1.0 / np.sqrt(a.shape[-2])
            return rng.uniform(-bound, bound, a.shape).astype(np.float32)
        if key == "weight":
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


TINY = dict(image_size=16, patch_size=4, num_classes=5, dim=32, depth=2, heads=4, mlp_dim=48,
            moe_experts=4)


@pytest.fixture(scope="module")
def vit_pair():
    """(JAX MoE SimpleViT at top-2, variables, the port's, x [2, 16, 16, 6])."""
    net = jvit.SimpleViT(**TINY, moe_top_k=2)
    x = images(2, 3, size=16)
    variables = _randomized(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    tnet = tvit.SimpleViT(**TINY, moe_top_k=2, device="cpu")
    load_jax_variables(tnet, jax.tree_util.tree_map(np.asarray, variables))
    return net, variables, tnet, x


def test_vit_forward_and_w_match_jax(vit_pair):
    net, variables, tnet, x = vit_pair
    assert tnet.encoder_0.ff.moe2.experts.shape == (4, 48, 32)
    yj, inter = jax.jit(lambda v, t: net.apply(v, t, mutable=["intermediates"]))(
        variables, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with tmoe.record_intermediates(tnet) as rec, torch.no_grad():
        yt = tnet(xt)
    _close(yt, yj)
    key = "top_idx" if tnet.encoder_0.ff.moe2.top_k > 1 else "expert_idx"
    for i in range(2):
        np.testing.assert_array_equal(rec[f"encoder_{i}.ff.moe2"][key][0],
                                      inter["intermediates"][f"encoder_{i}"]["ff"]["moe2"][key][0])
    from bcosification_tpu.explain.core import dynamic_linear_weights as jax_dlw

    lj, sj, wj = jax.jit(lambda v, t: jax_dlw(
        lambda u: net.apply(v, u, train=False, explain=True), t))(variables, jnp.asarray(x))
    assert fast_vit.supports(tnet)
    for fn in (lambda: dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu"),
               lambda: fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")):
        lt, st, wt = fn()
        _close(lt, lj)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        _close(wt, wj)


def test_vit_train_step_gradients_match_jax(vit_pair):
    """One train step's gradients (train=True, the loss sum(logits^2)):
    every leaf, the routers' through their gates, against ``jax.grad``."""
    net, variables, tnet, x = vit_pair
    gj = jax.jit(jax.grad(lambda p: jnp.sum(net.apply({"params": p}, jnp.asarray(x),
                                                      train=True) ** 2)))(variables["params"])
    tnet.zero_grad()
    tnet(torch.from_numpy(x), train=True).square().sum().backward()
    flat = {".".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]}
    got = dict(tnet.named_parameters())
    assert sorted(flat) == sorted(got)
    assert np.abs(flat["encoder_0.ff.moe2.router"]).max() > 0
    for name, g in flat.items():
        _close(got[name].grad, g)


def test_vit_agc_matches_jax(vit_pair):
    """AGC on every leaf of the MoE ViT, the routers [d, E] and experts
    [E, d, F] clipped per output unit (their last axis, as the JAX layout),
    against the JAX transform, with gradients large enough that every leaf
    is clipped."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu_torch.training import agc

    _, variables, tnet, _ = vit_pair
    rng = np.random.default_rng(9)
    params = dict(tnet.named_parameters())
    grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in params.items()}
    flat = {".".join(k.key for k in path): np.asarray(p)
            for path, p in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    want = jax.jit(jagc.adaptive_clip_grads)(flat, grads)
    for n, p in params.items():
        p.grad = torch.from_numpy(grads[n].copy())
    agc.adaptive_clip_grads_(tnet)
    assert "encoder_0.ff.moe2.router" in want and "encoder_0.ff.moe2.experts" in want
    for n, g in want.items():
        got, g = params[n].grad.numpy().astype(np.float64), np.asarray(g, np.float64)
        assert np.linalg.norm(got - g) <= 1e-6 * np.linalg.norm(g), n
        assert np.linalg.norm(g - grads[n]) > 1e-3 * np.linalg.norm(g), n  # clipped
    tnet.zero_grad(set_to_none=True)


def test_vit_export_round_trip():
    """``serving.export_explain`` of a depth-1 top-2 MoE ViT, loaded from
    bytes: the fast pass's values at two batch sizes (the capacity follows
    the batch)."""
    from bcosification_tpu_torch import serving

    tnet = tvit.SimpleViT(**{**TINY, "depth": 1}, moe_top_k=2, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    program = serving.load_serialized(serving.export_explain(tnet, input_size=16,
                                                             device="cpu"))
    for n in (1, 3):
        x = torch.from_numpy(images(n, 4 + n, size=16))
        got = program.call(x)
        want = fast_vit.fast_dynamic_linear_weights(tnet, x, device="cpu")
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_vit_without_pos_embedding(vit_pair):
    """``pos_embedding=False`` against the JAX flag; the net is then linear
    in x under explain (its norms' biases are its only other constants,
    zeroed here), so x . W equals the selected logit."""
    net, variables, tnet, x = vit_pair
    net = net.clone(pos_embedding=False)
    tnet.pos_embedding = False
    saved = {}
    try:
        yj = jax.jit(net.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            _close(tnet(torch.from_numpy(x)), yj)
            saved = {n: p.clone() for n, p in tnet.named_parameters() if n.endswith("norm.bias")}
            for name in saved:
                tnet.get_parameter(name).zero_()
        logits, sel, w = fast_vit.fast_dynamic_linear_weights(tnet, torch.from_numpy(x),
                                                             device="cpu")
        _close((torch.from_numpy(x) * w).sum((1, 2, 3)), logits.gather(1, sel[:, None])[:, 0])
    finally:
        tnet.pos_embedding = True
        with torch.no_grad():
            for name, value in saved.items():
                tnet.get_parameter(name).copy_(value)


def test_moe_ff_takes_b_from_the_factory_and_refuses_a_bias():
    """MoEFeedForward's experts at the factory's b (2 and 1) equal JAX's on
    the same weights; a biased linear factory raises ValueError, as the JAX
    module does (tests/test_moe.py)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    variables = None
    outs = []
    for b in (2.0, 1.0):
        jff = jvit.MoEFeedForward(4, 24, 16, linear_layer=functools.partial(jlayers.BcosLinear,
                                                                             b=b))
        if variables is None:  # one draw for both: b is no parameter
            variables = _randomized(jax.jit(jff.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
        tff = tvit.MoEFeedForward(16, 24, 4, linear_layer=functools.partial(BcosLinear, b=b),
                                  norm_layer=tvit.DetachableLayerNorm, act_layer=tvit.Identity)
        load_jax_variables(tff, jax.tree_util.tree_map(np.asarray, variables))
        assert tff.moe2.b == b
        with torch.no_grad():
            outs.append(tff(torch.from_numpy(x)))
        _close(outs[-1], jax.jit(jff.apply)(variables, jnp.asarray(x)))
    assert not torch.allclose(outs[0], outs[1])
    with pytest.raises(ValueError, match="bias-free"):
        tvit.MoEFeedForward(16, 24, 4, linear_layer=functools.partial(BcosLinear, use_bias=True),
                            norm_layer=tvit.DetachableLayerNorm, act_layer=tvit.Identity)
