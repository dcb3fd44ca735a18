"""The port's B-cosified CLIP-RN50 image tower against the JAX package, on the
CPU, in fp32, on the same weights: the small tower of
tests/test_fast_clip_explain.py (layers (1, 1, 1, 1), width 16, embed_dim
32, 32x32), its JAX variables randomised as that test does and carried
across by bcosify/from_jax.py.

- ``ops.bcos_linear``, ``BcosifyLinear`` and ``PlainLinear`` (with
  ``weight_only``) against JAX (1e-5);
- the tower's forward, pooled and attn-unpool, with and without explain
  (features, 1e-5);
- the hand-scheduled text-grounded explanation (``explain/fast_clip.py``):
  scores and W against the JAX ``fast_text_dlw`` (1e-5), and against the
  port's own autograd W (1e-5); the launch route of both passes;
- the generic explanation core on the pooled tower against JAX (1e-5);
- ``serving.export_text_explain`` and ``export_forward`` round trips equal
  to the eager calls.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TINY_CFG = {
    "vision_layers": (1, 1, 1, 1),
    "vision_width": 16,
    "embed_dim": 32,
    "image_resolution": 32,
}
SIZE = 32


def _model_config(attn_unpool, use_bias=False):
    return {"name": "resnet50clip", "bcosify_args": {"clip_kd": True, "use_bias": use_bias},
            "bcos_args": {"b": 2}, "attn_unpool": attn_unpool}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def clip_pair(attn_unpool, seed=7, use_bias=False):
    """(jax net, jax variables, port net, x [2, 32, 32, 6]): the JAX student
    with its variables randomised as tests/test_fast_clip_explain.py does,
    and the port's student on the CPU with the same weights."""
    from bcosification_tpu.bcosify.clip_import import build_bcosified_clip_visual as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

    net, variables = jbuild(_model_config(attn_unpool, use_bias), None, dict(TINY_CFG))
    rng = np.random.default_rng(seed)

    def rand_stats(path, leaf):
        name = str(path[-1].key if hasattr(path[-1], "key") else path[-1])
        if name == "running_var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        return np.asarray(leaf)

    variables = {
        "params": jax.tree_util.tree_map(
            lambda leaf: (rng.standard_normal(leaf.shape) * 0.5).astype(np.float32),
            variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(rand_stats, variables["batch_stats"]),
    }
    tnet = build_bcosified_clip_visual(_model_config(attn_unpool, use_bias), None,
                                       dict(TINY_CFG), device="cpu")
    load_jax_variables(tnet, variables)
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)  # AddInverse, NHWC
    return net, jax.tree_util.tree_map(jnp.asarray, variables), tnet, x


@pytest.fixture(scope="module")
def pooled_pair():
    return clip_pair(False)


@pytest.fixture(scope="module", params=[False, True], ids=["pooled", "unpool"])
def pair(request):
    return request.getfixturevalue("pooled_pair") if not request.param else clip_pair(True)


@pytest.fixture(scope="module")
def text_dir():
    t = np.random.default_rng(3).standard_normal(TINY_CFG["embed_dim"]).astype(np.float32)
    return t / np.linalg.norm(t)


# --------------------------------------------------------------------------
# linear layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
@pytest.mark.parametrize("route", ["kernel", "bias", "max_out", "normed", "b1"])
def test_bcos_linear_matches_jax(route, explain):
    """The bias-free b=2 linear (K3's plain version, eps_outside) and the
    plain routes: value and input gradient against jax.vjp (1e-5)."""
    from bcosification_tpu.ops import bcos as jops
    from bcosification_tpu_torch.ops import bcos as tops

    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    kw = dict(b=1.0 if route == "b1" else 2.0, max_out=2 if route == "max_out" else 1,
              normalize_weights=route == "normed", explain=explain)
    w = rng.standard_normal((12, 8 * kw["max_out"])).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32) if route == "bias" else None
    ct = rng.standard_normal((3, 5, 8)).astype(np.float32)

    def jf(xx):
        return jops.bcos_linear(xx, jnp.asarray(w), bias=None if bias is None
                                else jnp.asarray(bias), **kw)

    want, vjp = jax.vjp(jf, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tops.bcos_linear(xt, torch.from_numpy(w), bias=None if bias is None
                           else torch.from_numpy(bias), **kw)
    got.backward(torch.from_numpy(ct))
    assert _rel(got.detach().numpy(), want) <= 1e-5
    assert _rel(xt.grad.numpy(), want_dx) <= 1e-5


@pytest.mark.parametrize("layer", ["BcosifyLinear", "PlainLinear"])
@pytest.mark.parametrize("weight_only", [False, True])
def test_linear_modules_match_jax(layer, weight_only):
    import bcosification_tpu.modules as jmod
    from bcosification_tpu.models.vit import PlainLinear as JPlainLinear
    from bcosification_tpu_torch import modules as tmod
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    jlayer = (jmod.BcosifyLinear(6, b=2.0, use_bias=True) if layer == "BcosifyLinear"
              else JPlainLinear(6))
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = jlayer.apply(variables, jnp.asarray(x), weight_only=weight_only)
    tlayer = (tmod.BcosifyLinear(10, 6, b=2.0, use_bias=True) if layer == "BcosifyLinear"
              else tmod.PlainLinear(10, 6))
    load_jax_variables(tlayer, variables)
    got = tlayer(torch.from_numpy(x), weight_only=weight_only).detach().numpy()
    assert _rel(got, want) <= 1e-5


# --------------------------------------------------------------------------
# the tower
# --------------------------------------------------------------------------
@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
def test_tower_forward_matches_jax(pair, explain):
    net, variables, tnet, x = pair
    want = np.asarray(jax.jit(lambda v, t: net.apply(v, t, train=False, explain=explain))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), explain=explain).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 1e-3  # the randomised tower carries signal
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_fast_text_dlw_matches_jax(pair, text_dir):
    from bcosification_tpu.explain import fast_clip as jfast
    from bcosification_tpu_torch.explain import fast_clip

    net, variables, tnet, x = pair
    js, jw = jax.jit(lambda v, inp: jfast.fast_text_dlw(net, v, inp, jnp.asarray(text_dir)))(
        variables, jnp.asarray(x))
    assert fast_clip.supports(tnet)
    s, w = fast_clip.fast_text_dlw(tnet, torch.from_numpy(x), torch.from_numpy(text_dir),
                                   device="cpu")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    assert _rel(w.numpy(), jw) <= 1e-5
    assert w.shape == x.shape


def test_fast_text_dlw_with_biases_matches_jax(text_dir):
    """use_bias keeps the BN, v_proj and c_proj biases: c_proj leaves K3 for
    the plain B-cos linear, in the module and in the fast pass (1e-5)."""
    from bcosification_tpu.explain import fast_clip as jfast
    from bcosification_tpu_torch.explain import fast_clip

    net, variables, tnet, x = clip_pair(True, use_bias=True)
    assert tnet.model.attnpool.c_proj.bias is not None
    js, jw = jax.jit(lambda v, inp: jfast.fast_text_dlw(net, v, inp, jnp.asarray(text_dir)))(
        variables, jnp.asarray(x))
    s, w = fast_clip.fast_text_dlw(tnet, torch.from_numpy(x), torch.from_numpy(text_dir),
                                   device="cpu")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    assert _rel(w.numpy(), jw) <= 1e-5


def test_fast_pass_matches_autograd(pair, text_dir):
    """The features equal the explain-mode module forward, and W the port's
    autograd through the module (1e-5)."""
    from bcosification_tpu_torch.explain import fast_clip

    _, _, tnet, x = pair
    xt, t = torch.from_numpy(x), torch.from_numpy(text_dir)
    feats, _ = fast_clip.fast_encode_and_vjp(tnet, xt, device="cpu")
    xx = xt.clone().requires_grad_(True)
    module_feats = tnet(xx, explain=True)
    scores = fast_clip.text_score_head(module_feats, t)
    scores.sum().backward()
    s, w = fast_clip.fast_text_dlw(tnet, xt, t, device="cpu")
    assert _rel(feats.numpy(), module_feats.detach().numpy()) <= 1e-5
    np.testing.assert_allclose(s.numpy(), scores.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert _rel(w.numpy(), xx.grad.numpy()) <= 1e-5


def test_explain_mode_changes_the_gradient(pair, text_dir):
    """The pass takes the explanation-mode gradient (detached scales): the
    gradient without explain differs."""
    from bcosification_tpu_torch.explain import fast_clip

    _, _, tnet, x = pair
    xx = torch.from_numpy(x).requires_grad_(True)
    fast_clip.text_score_head(tnet(xx), torch.from_numpy(text_dir)).sum().backward()
    _, w = fast_clip.fast_text_dlw(tnet, torch.from_numpy(x), torch.from_numpy(text_dir),
                                   device="cpu")
    assert float((xx.grad - w).abs().max()) > 1e-6


def test_kernel_routes(pair, monkeypatch):
    """The module forward sends the tower's 1x1 convs (all at stride 1) to
    K3's op, as the JAX module sends them to its Pallas kernel; the fast
    pass runs them on K1 and K2; the attn-unpool c_proj is one more K3
    forward (and K2 backward) with the linear norm."""
    from bcosification_tpu_torch.explain import fast_clip
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
    from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3

    _, _, tnet, x = pair
    calls = {"k1": 0, "k2": [], "k3": []}

    def count(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1 if key == "k1" else [kw.get("eps_outside", False)]
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(k12, "conv1x1_fwd_plain", count("k1", k12.conv1x1_fwd_plain))
    monkeypatch.setattr(k12, "conv1x1_bwd_explain_plain",
                        count("k2", k12.conv1x1_bwd_explain_plain))
    monkeypatch.setattr(k3, "bcos_matmul_fwd_plain", count("k3", k3.bcos_matmul_fwd_plain))
    xt = torch.from_numpy(x)
    unpool = tnet.model.attnpool.attn_unpool
    n1x1 = 4 * 2 + 4  # conv1 and conv3 of 4 blocks, 4 downsamples
    with torch.no_grad():
        tnet(xt)
    assert calls == {"k1": 0, "k2": [], "k3": [False] * n1x1 + [True] * unpool}
    calls.update(k1=0, k2=[], k3=[])
    fast_clip.fast_text_dlw(tnet, xt, torch.ones(TINY_CFG["embed_dim"]), device="cpu")
    assert calls == {"k1": n1x1, "k2": [True] * unpool + [False] * n1x1,
                     "k3": [True] * unpool}


def test_generic_explain_matches_jax(pooled_pair):
    """``dynamic_linear_weights`` / ``make_explain_fn`` take the pooled tower
    ([B, D] features; the core explains [B, classes] outputs) through
    autograd, as the JAX explain core does."""
    from bcosification_tpu.explain.core import dynamic_linear_weights as jdlw
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights, make_explain_fn

    net, variables, tnet, x = pooled_pair
    jl, js, jw = jax.jit(lambda v, t: jdlw(
        lambda inp: net.apply(v, inp, train=False, explain=True), t))(variables, jnp.asarray(x))
    out, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True), torch.from_numpy(x),
                                         device="cpu")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(out.numpy(), jl) <= 1e-5
    assert _rel(w.numpy(), jw) <= 1e-5
    res = make_explain_fn(tnet, with_image=False)(torch.from_numpy(x), device="cpu")
    assert _rel(res["dynamic_linear_weights"].numpy(), jw) <= 1e-5


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def test_export_text_explain_round_trip(pair, text_dir):
    """The loaded program equals the eager pass (1e-6) at another batch than
    the example's, and the JAX artifact (1e-5); the exported forward equals
    the module's features."""
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain import fast_clip

    net, variables, tnet, _ = pair
    d = TINY_CFG["embed_dim"]
    x = np.random.default_rng(5).random((3, SIZE, SIZE, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    xt, t = torch.from_numpy(x), torch.from_numpy(text_dir)
    program = serving.load_serialized(serving.export_text_explain(
        tnet, embed_dim=d, input_size=SIZE, device="cpu"))
    s, w = program.call(xt, t)
    es, ew = fast_clip.fast_text_dlw(tnet, xt, t, device="cpu")
    assert _rel(s.numpy(), es.numpy()) <= 1e-6 and _rel(w.numpy(), ew.numpy()) <= 1e-6
    blob = jserving.export_text_explain(net, variables, embed_dim=d, input_size=SIZE)
    js, jw = jserving.load_serialized(blob).call(jnp.asarray(x), jnp.asarray(text_dir))
    assert _rel(s.numpy(), js) <= 1e-5 and _rel(w.numpy(), jw) <= 1e-5
    forward = serving.load_serialized(serving.export_forward(tnet, input_size=SIZE,
                                                             device="cpu"))
    with torch.no_grad():
        assert _rel(forward.call(xt).numpy(), tnet(xt).numpy()) <= 1e-6


def test_export_text_explain_refuses_the_teacher():
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual

    teacher = build_clip_teacher_visual(None, {**TINY_CFG, "vision_patch_size": None},
                                        device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        serving.export_text_explain(teacher, embed_dim=32, input_size=SIZE, device="cpu")
