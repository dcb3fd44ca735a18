"""The PyTorch port's B-cosified SimpleViT (ImageNet/vit_bcosification)
against the JAX package, on the CPU, in fp32, on the same weights: a small
ViT (dim 32, depth 2, 2 heads, mlp 64, patch 8, 32x32, 10 classes) built
by both packages' model factories (``VIT_CONFIGS`` set to it for the call),
its JAX variables drawn with numpy from a seed and carried across by
bcosify/from_jax.py, JAX at the highest matmul precision.

- the forward's pre-logits (1e-5) and W through autograd (``explain.core``)
  and through the hand-scheduled pass ``explain/fast_vit.py``, for each of
  gelu/noGelu x useBias/noBias x gapReorder/noGapReorder. W is held to
  1e-5: on this net 1e-7 relative input noise moves it by at most 4.0e-7
  (``test_w_is_well_conditioned`` measures it), under the 1e-6 above which
  it would be held to ten such spreads;
- bf16: the port's distance from its fp32 result within twice the JAX
  package's own;
- the JAX variables' round trip through from_jax; each bias-free B-cos
  linear on K3 forward and K2 backward, the export round trip, the patchify and its channel doubling, the sin-cos
  positional embedding;
- each GELU and LayerNorm factory (the erf and tanh gates, MyGELU,
  PlainGELU, PlainLayerNorm, NoBias, Unaffine) in its forward and its VJP
  with and without ``explain`` (1e-5);
- the hub's standard SimpleViT state dict (made from a seed, in the
  reference's key layout) through both imports, strict; the model factory
  reading it from $BCOS_HUB_PATH;
- the grid equal to the JAX package's ``CONFIGS``; the ViT-C KeyError and
  the MoE feed-forward that ``moe_experts`` builds, the ViT-C stem, the
  BcosLinear default and the Trainer taking a ViT config; ``evaluate`` against JAX ``evaluate.evaluate``.
"""
import contextlib
import copy
import itertools
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.experiments.ImageNet.vit_bcosification import (
    experiment_parameters as jparams,
)
from bcosification_tpu.experiments.ImageNet.vit_bcosification import model as jmodel
from bcosification_tpu.models import vit as jvit
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
from bcosification_tpu_torch.experiments.ImageNet.vit_bcosification import (
    experiment_parameters as tparams,
)
from bcosification_tpu_torch.experiments.ImageNet.vit_bcosification import model as tmodel
from bcosification_tpu_torch.models import vit as tvit
from test_torch_training import _rel

torch.set_num_threads(1)
ARCH = "simple_vit_b_patch16_224"
BASE = "bcosifyv2_bcos_simple_vit_b_patch16_224"
SMALL = dict(dim=32, heads=2, mlp_dim=64, depth=2, patch_size=8, image_size=32)
SIZE, NUM_CLASSES = 32, 10
VARIANTS = list(itertools.product(("gelu", "noGelu"), ("noBias", "useBias"),
                                  ("noGapReorder", "gapReorder")))
IDS = ["-".join(v) for v in VARIANTS]


def config_name(gelu="gelu", bias="noBias", gap="noGapReorder"):
    return (BASE + ("_useBias" if bias == "useBias" else "")
            + ("_noGelu" if gelu == "noGelu" else "")
            + ("_gapReorder" if gap == "gapReorder" else ""))


def model_config(configs, name, num_classes=NUM_CLASSES):
    cfg = copy.deepcopy(configs[name]["model"])
    cfg["args"]["num_classes"] = num_classes
    return cfg


@contextlib.contextmanager
def small_arch():
    """VIT_CONFIGS[ARCH] of both packages set to SMALL for the call."""
    old = jvit.VIT_CONFIGS[ARCH], tvit.VIT_CONFIGS[ARCH]
    jvit.VIT_CONFIGS[ARCH] = tvit.VIT_CONFIGS[ARCH] = dict(SMALL)
    try:
        yield
    finally:
        jvit.VIT_CONFIGS[ARCH], tvit.VIT_CONFIGS[ARCH] = old


def randomized(variables, seed):
    """The JAX variables with every leaf drawn from ``seed``: linear weights
    U(-1/sqrt(in), 1/sqrt(in)), norm weights 1 + 0.2 N, biases 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key == "weight" and a.ndim == 2:
            bound = 1.0 / math.sqrt(a.shape[0])
            return rng.uniform(-bound, bound, a.shape).astype(np.float32)
        if path[-1].key == "weight":
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def images(n, seed, size=SIZE):
    x = np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1)  # AddInverse, NHWC


def vit_pair(name, seed=0, num_classes=NUM_CLASSES):
    """(jax net, jax variables, port net) of config ``name`` at SMALL, on
    the same weights drawn from ``seed``; the port runs on the CPU."""
    with small_arch(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no hub checkpoint: random init
        net, variables = jmodel.get_model(model_config(jparams.CONFIGS, name, num_classes))
        tnet = tmodel.get_model(model_config(tparams.CONFIGS, name, num_classes), device="cpu")
    variables_np = randomized(variables, seed)
    load_jax_variables(tnet, variables_np)
    return net, jax.tree_util.tree_map(jnp.asarray, variables_np), tnet


@pytest.fixture(scope="module")
def pairs():
    return {v: vit_pair(config_name(*v)) for v in VARIANTS}


def _jax_forward(net, variables, x, explain=False):
    with jax.default_matmul_precision("highest"):
        return np.asarray(net.apply(variables, jnp.asarray(x), train=False, explain=explain),
                          np.float64)


def _jax_explain(net, variables, x, idx=None):
    from bcosification_tpu.explain.core import dynamic_linear_weights

    def f(inp):
        return net.apply(variables, inp, train=False, explain=True)

    with jax.default_matmul_precision("highest"):
        return dynamic_linear_weights(f, jnp.asarray(x), idx)


def _pre(logits, tnet):
    return np.asarray(logits, np.float64) - tnet.logit_bias


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_forward_matches_jax(pairs, variant):
    net, variables, tnet = pairs[variant]
    x = images(2, 1)
    want = _jax_forward(net, variables, x)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
        got_explain = tnet(torch.from_numpy(x), explain=True).numpy()
    np.testing.assert_allclose(_pre(got, tnet), _pre(want, tnet), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, got_explain)
    assert np.abs(_pre(want, tnet)).max() > 1e-2  # the comparison has signal


def test_jax_variables_round_trip(pairs):
    """from_jax carries the JAX ViT variables in under their scope names and
    ``to_jax_variables`` gives them back exactly."""
    _, variables, tnet = pairs[("gelu", "useBias", "noGapReorder")]
    assert "model.encoder_1.attn.to_qkv.weight" in tnet.state_dict()
    assert "model.encoder_1.ff.linear1.bias" in tnet.state_dict()
    want = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_variables(tnet))[0])
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(leaf), err_msg=str(key))


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_explanation_matches_jax(pairs, variant):
    """W through the port's autograd (``explain.core``) and through
    ``fast_vit`` against the JAX package's autograd."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[variant]
    x = images(2, 2)
    jl, js, jw = _jax_explain(net, variables, x)
    xt = torch.from_numpy(x)
    ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
    assert fast_vit.supports(tnet)
    fl, fs, fw = fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")
    for logits, sel, w in ((ml, ms, mw), (fl, fs, fw)):
        np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
        assert _rel(w.numpy(), jw) <= 1e-5
        np.testing.assert_allclose(_pre(logits.numpy(), tnet), _pre(jl, tnet), rtol=1e-5,
                                   atol=1e-6)
    assert _rel(fw.numpy(), mw.numpy()) <= 1e-5


def test_w_is_well_conditioned(pairs):
    """1e-7 relative input noise moves W by less than 1e-6 on the small net
    (measured: 3.6e-7 to 4.0e-7), so W is held to 1e-5 above."""
    from bcosification_tpu_torch.explain import fast_vit

    x = torch.from_numpy(images(2, 2))
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape).astype(np.float32))
    for variant, (_, _, tnet) in pairs.items():
        _, _, w = fast_vit.fast_dynamic_linear_weights(tnet, x, device="cpu")
        _, _, wn = fast_vit.fast_dynamic_linear_weights(tnet, x * (1 + 1e-7 * noise), device="cpu")
        assert _rel(wn.numpy(), w.numpy()) < 1e-6, variant


def test_fast_vit_explains_a_given_class(pairs):
    from bcosification_tpu_torch.explain import fast_vit

    net, variables, tnet = pairs[("gelu", "noBias", "noGapReorder")]
    x = images(2, 4)
    jl, js, jw = _jax_explain(net, variables, x, jnp.asarray(3))
    fl, fs, fw = fast_vit.fast_dynamic_linear_weights(tnet, torch.from_numpy(x), 3, device="cpu")
    assert fs.tolist() == [3, 3] and np.asarray(js).tolist() == [3, 3]
    assert _rel(fw.numpy(), jw) <= 1e-5


@pytest.mark.parametrize("variant", [("gelu", "noBias", "noGapReorder"),
                                     ("noGelu", "useBias", "gapReorder")], ids=["default", "other"])
def test_bf16_distance_within_twice_jax(pairs, variant):
    """bf16 against fp32 on the same (bf16-rounded) images: the port's
    pre-logits and W lie within twice the JAX package's own distance."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[variant]
    x = np.asarray(jnp.asarray(images(2, 5)).astype(jnp.bfloat16).astype(jnp.float32))
    jl32, _, jw32 = _jax_explain(net, variables, x)
    jl16, _, jw16 = _jax_explain(net, variables, jnp.asarray(x).astype(jnp.bfloat16))
    xt = torch.from_numpy(x)
    tl32, _, tw32 = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
    for fn in (lambda t: dynamic_linear_weights(lambda u: tnet(u, explain=True), t,
                                                device="cpu"),
               lambda t: fast_vit.fast_dynamic_linear_weights(tnet, t, device="cpu")):
        tl16, _, tw16 = fn(xt.to(torch.bfloat16))
        assert tw16.dtype == torch.bfloat16
        jax_pre = _rel(_pre(np.asarray(jl16, np.float32), tnet), _pre(jl32, tnet))
        jax_w = _rel(np.asarray(jw16, np.float32), jw32)
        assert 0 < jax_w
        assert _rel(_pre(tl16.float().numpy(), tnet), _pre(tl32.numpy(), tnet)) <= 2 * jax_pre
        assert _rel(tw16.float().numpy(), tw32.numpy()) <= 2 * jax_w


@pytest.mark.parametrize("path", ["fast", "module"])
@pytest.mark.parametrize("bias", ["noBias", "useBias"])
def test_each_bias_free_linear_goes_through_the_kernels(pairs, path, bias, monkeypatch):
    """On the CPU the wrappers call the kernels' plain versions: count those
    calls. Each bias-free B-cos linear (the patch embedding, to_out, linear1,
    linear2 per encoder and the head; with useBias to_out alone) is one K3
    forward and one K2 backward; K1 never runs."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    _, _, tnet = pairs[("gelu", bias, "noGapReorder")]
    calls = {"fwd": 0, "bwd": 0, "matmul": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(bcos_conv1x1, "conv1x1_fwd_plain",
                        counting("fwd", bcos_conv1x1.conv1x1_fwd_plain))
    monkeypatch.setattr(bcos_conv1x1, "conv1x1_bwd_explain_plain",
                        counting("bwd", bcos_conv1x1.conv1x1_bwd_explain_plain))
    monkeypatch.setattr(bcos_matmul, "bcos_matmul_fwd_plain",
                        counting("matmul", bcos_matmul.bcos_matmul_fwd_plain))
    xt = torch.from_numpy(images(2, 6))
    if path == "fast":
        fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")
    else:
        dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
    n = SMALL["depth"] if bias == "useBias" else 3 * SMALL["depth"] + 2
    assert calls == {"fwd": 0, "bwd": n, "matmul": n}


def test_explain_api_takes_the_vit_through_autograd(pairs):
    from bcosification_tpu_torch.explain import fast_resnet
    from bcosification_tpu_torch.explain.core import make_explain_fn

    net, variables, tnet = pairs[("gelu", "noBias", "gapReorder")]
    x = images(2, 7)
    assert not fast_resnet.supports(tnet)
    _, js, jw = _jax_explain(net, variables, x)
    out = make_explain_fn(tnet, smooth=3)(torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(out["explained_class_idx"].numpy(), np.asarray(js))
    assert _rel(out["dynamic_linear_weights"].numpy(), jw) <= 1e-5
    assert out["explanation"].shape == (2, SIZE, SIZE, 4)


@pytest.fixture(scope="module")
def artifacts(pairs):
    from bcosification_tpu_torch import serving

    _, _, tnet = pairs[("gelu", "useBias", "gapReorder")]
    _, _, plain = pairs[("gelu", "noBias", "noGapReorder")]
    return {"explain": serving.export_explain(plain, input_size=SIZE, device="cpu"),
            "explain bias": serving.export_explain(tnet, input_size=SIZE, device="cpu"),
            "forward": serving.export_forward(plain, input_size=SIZE, device="cpu")}


@pytest.mark.parametrize("batch", [1, 3])
def test_export_round_trip(pairs, artifacts, batch):
    """export_explain returns a program for the ViT (through fast_vit); the
    loaded programs equal the eager calls (1e-6) at any batch."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.fast_vit import fast_dynamic_linear_weights

    xt = torch.from_numpy(images(batch, 8 + batch))
    for key, variant in (("explain", ("gelu", "noBias", "noGapReorder")),
                         ("explain bias", ("gelu", "useBias", "gapReorder"))):
        tnet = pairs[variant][2]
        logits, sel, w = serving.load_serialized(artifacts[key]).call(xt)
        el, es, ew = fast_dynamic_linear_weights(tnet, xt, device="cpu")
        np.testing.assert_array_equal(sel.numpy(), es.numpy())
        assert _rel(w.numpy(), ew.numpy()) <= 1e-6
        assert _rel(_pre(logits.numpy(), tnet), _pre(el.numpy(), tnet)) <= 1e-6
    tnet = pairs[("gelu", "noBias", "noGapReorder")][2]
    forward = serving.load_serialized(artifacts["forward"]).call(xt).numpy()
    with torch.no_grad():
        eager = tnet(xt).numpy()
    assert _rel(_pre(forward, tnet), _pre(eager, tnet)) <= 1e-6


def test_exported_explain_calls_the_kernel_ops(artifacts):
    from bcosification_tpu_torch import serving

    graph = serving.load_serialized(artifacts["explain"]).program.graph_module
    targets = {str(n.target) for m in graph.modules() for n in getattr(m, "graph", ()).nodes
               if n.op == "call_function" and "bcos_torch" in str(n.target)}
    assert targets == {"bcos_torch.bcos_matmul_fwd.default",
                       "bcos_torch.conv1x1_bwd_explain.default"}


def test_patchify_and_its_channel_doubling_are_exact():
    """The port's patchify is the JAX package's, and the doubled patch
    weight maps the normalised AddInverse patches exactly as the original
    weight maps the normalised RGB ones."""
    from bcosification_tpu.bcosify import params as jP
    from bcosification_tpu_torch.bcosify import params as P
    from bcosification_tpu_torch.models.bcosify_net import (
        IMAGENET_MEAN_ADDINVERSE,
        IMAGENET_STD_ADDINVERSE,
    )

    x = images(2, 9)
    np.testing.assert_array_equal(tvit._patchify(torch.from_numpy(x), 8, 8).numpy(),
                                  np.asarray(jvit._patchify(jnp.asarray(x), 8, 8)))
    np.testing.assert_array_equal(
        tvit._unpatchify(tvit._patchify(torch.from_numpy(x), 8, 8), 8, 8).numpy(), x)
    w = np.random.default_rng(10).standard_normal((16, 3 * 8 * 8)).astype(np.float32)
    doubled = P.vit_patchify_linear_add_channels(w)
    np.testing.assert_array_equal(doubled.T, jP.vit_patchify_linear_add_channels(w.T, w.shape[1]))
    mean, std = np.array(IMAGENET_MEAN_ADDINVERSE), np.array(IMAGENET_STD_ADDINVERSE)
    xn = torch.from_numpy(((x - mean) / std).astype(np.float32))
    got = tvit._patchify(xn, 8, 8) @ torch.from_numpy(doubled.T)
    want = tvit._patchify(xn[..., :3].contiguous(), 8, 8) @ torch.from_numpy(w.T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("h,w,dim", [(14, 14, 768), (4, 4, 32), (3, 5, 16)])
def test_pos_emb_sincos_2d_matches_jax(h, w, dim):
    got = tvit.pos_emb_sincos_2d(h, w, dim).numpy()
    np.testing.assert_allclose(got, np.asarray(jvit.pos_emb_sincos_2d(h, w, dim)),
                               rtol=1e-6, atol=1e-6)


def _factories():
    """(id, JAX factory, port factory, features): the GELU and LayerNorm
    factories of modules/activations.py and modules/norms.py; features None
    for an activation."""
    from bcosification_tpu.modules import activations as jact, norms as jnorms
    from bcosification_tpu_torch.modules import activations as tact, norms as tnorms

    d = 16
    return [
        ("DetachableGELU-erf", jact.DetachableGELU, tact.DetachableGELU, None),
        ("DetachableGELU-tanh", lambda: jact.DetachableGELU(approximate=True),
         lambda: tact.DetachableGELU(approximate=True), None),
        ("MyGELU", jact.MyGELU, tact.MyGELU, None),
        ("PlainGELU", jact.PlainGELU, tact.PlainGELU, None),
        ("PlainGELU-tanh", lambda: jact.PlainGELU(approximate=True),
         lambda: tact.PlainGELU(approximate=True), None),
        ("DetachableLayerNorm", lambda: jnorms.DetachableLayerNorm(features=d),
         lambda: tnorms.DetachableLayerNorm(d), d),
        ("PlainLayerNorm", lambda: jnorms.PlainLayerNorm(d), lambda: tnorms.PlainLayerNorm(d), d),
        ("NoBias-DetachableLayerNorm", lambda: jnorms.NoBias(jnorms.DetachableLayerNorm)(
            features=d), lambda: tnorms.NoBias(tnorms.DetachableLayerNorm)(d), d),
        ("Unaffine-DetachableLayerNorm", lambda: jnorms.Unaffine(jnorms.DetachableLayerNorm)(
            features=d), lambda: tnorms.Unaffine(tnorms.DetachableLayerNorm)(d), d),
        ("Unaffine-PlainLayerNorm", lambda: jnorms.Unaffine(jnorms.PlainLayerNorm)(d),
         lambda: tnorms.Unaffine(tnorms.PlainLayerNorm)(d), d),
    ]


@pytest.mark.parametrize("case", _factories(), ids=lambda c: c[0])
def test_gelu_and_layernorm_factories_match_jax(case):
    """Each factory's forward, and its input VJP with and without
    ``explain``, against the JAX one on the same inputs and parameters
    (1e-5): the tanh gate, ``detachable=False`` (no detach under explain:
    the same VJP in both modes), the detached gate or variance (a different
    one), and Unaffine's and NoBias's missing weight and bias."""
    _, jfactory, tfactory, features = case
    rng = np.random.default_rng(7)
    shape = (3, 5, features or 16)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    jm, tm = jfactory(), tfactory()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = dict(variables.get("params", {}))
    assert sorted(params) == sorted(k for k in ("weight", "bias")
                                    if getattr(tm, k, None) is not None)
    for k in params:  # away from the init's ones and zeros
        params[k] = (params[k] + 0.3 * rng.standard_normal(params[k].shape)).astype(np.float32)
        getattr(tm, k).data = torch.from_numpy(np.array(params[k]))
    variables = {"params": params} if params else {}
    vjps = {}
    for explain in (False, True):
        want, vjp = jax.vjp(lambda t: jm.apply(variables, t, explain=explain), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = tm(xt, explain=explain)
        (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
        assert _rel(got.detach(), want) < 1e-5, explain
        (want_grad,) = vjp(jnp.asarray(ct))
        assert _rel(grad, want_grad) < 1e-5, explain
        vjps[explain] = grad
    detaches = getattr(tm, "detachable", False)
    assert (_rel(vjps[True], vjps[False]) > 1e-3) == detaches


def standard_state_dict(seed=0):
    """The hub's standard SimpleViT at SMALL's widths (3 channels, 10
    classes), in the reference's key layout and torch shapes ((out, in)
    linears), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    d, mlp, p = SMALL["dim"], SMALL["mlp_dim"], SMALL["patch_size"]
    sd = {}

    def linear(key, n_in, n_out, bias=True):
        sd[f"{key}.weight"] = rng.uniform(-1, 1, (n_out, n_in)).astype(np.float32) / math.sqrt(n_in)
        if bias:
            sd[f"{key}.bias"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)

    def norm(key):
        sd[f"{key}.weight"] = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)

    linear("to_patch_embedding.linear", 3 * p * p, d)
    for i in range(SMALL["depth"]):
        t = f"transformer.encoder_{i}"
        norm(f"{t}.attn.norm")
        linear(f"{t}.attn.to_qkv", d, 3 * d, bias=False)
        linear(f"{t}.attn.to_out", d, d, bias=False)
        norm(f"{t}.ff.net.norm")
        linear(f"{t}.ff.net.linear1", d, mlp)
        linear(f"{t}.ff.net.linear2", mlp, d)
    norm("linear_head.norm")
    linear("linear_head.linear", d, NUM_CLASSES)
    return sd


@pytest.mark.parametrize("bias", ["noBias", "useBias"])
def test_hub_import_matches_jax(bias):
    from bcosification_tpu.bcosify.torch_import import simple_vit_torch_to_variables
    from bcosification_tpu_torch.bcosify.torch_import import simple_vit_state_dict

    net, variables, tnet = vit_pair(config_name(bias=bias))
    sd = standard_state_dict(1)
    want = simple_vit_torch_to_variables(variables, sd, SMALL["depth"], add_channels=True,
                                         use_bias=bias == "useBias")
    tnet.load_state_dict(simple_vit_state_dict(sd, tnet, use_bias=bias == "useBias"))
    got = to_jax_variables(tnet)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for key, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], np.asarray(leaf), err_msg=str(key))
    x = images(2, 11)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_pre(out, tnet), _pre(_jax_forward(net, want, x), tnet),
                               rtol=1e-5, atol=1e-6)


def test_hub_import_is_strict():
    from bcosification_tpu_torch.bcosify.torch_import import simple_vit_state_dict

    _, _, tnet = vit_pair(config_name())
    sd = standard_state_dict(2)
    simple_vit_state_dict(sd, tnet)  # the biases are dropped, not unused
    with pytest.raises(KeyError, match="map onto nothing"):
        extra = {**sd, "transformer.encoder_0.attn.extra": sd["linear_head.norm.weight"]}
        simple_vit_state_dict(extra, tnet)
    with pytest.raises(KeyError, match="missing"):
        simple_vit_state_dict({k: v for k, v in sd.items()
                               if k != "transformer.encoder_1.ff.net.linear2.weight"}, tnet)
    _, _, biased = vit_pair(config_name(bias="useBias"))
    with pytest.raises(KeyError, match="map onto nothing"):  # to_qkv is bias-free
        simple_vit_state_dict({**sd, "transformer.encoder_0.attn.to_qkv.bias": np.zeros(96)},
                              biased, use_bias=True)


def test_model_factory_reads_the_hub_checkpoint(tmp_path, monkeypatch):
    """Both factories read $BCOS_HUB_PATH/standard_<arch>.npz and build the
    same net; without the variable they warn and initialise at random."""
    np.savez(tmp_path / f"standard_{ARCH}.npz", **standard_state_dict(3))
    monkeypatch.setenv("BCOS_HUB_PATH", str(tmp_path))
    name = config_name(gap="gapReorder")
    with small_arch():
        net, variables = jmodel.get_model(model_config(jparams.CONFIGS, name))
        tnet = tmodel.get_model(model_config(tparams.CONFIGS, name), device="cpu")
    x = images(2, 12)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_pre(got, tnet), _pre(_jax_forward(net, variables, x), tnet),
                               rtol=1e-5, atol=1e-6)
    monkeypatch.delenv("BCOS_HUB_PATH")
    with small_arch(), pytest.warns(UserWarning, match="BCOS_HUB_PATH not set"):
        tmodel.get_model(model_config(tparams.CONFIGS, name), device="cpu")


def test_the_grid_equals_jax():
    from bcosification_tpu.experiments.utils import config_utils as jcu
    from bcosification_tpu_torch.experiments.utils import config_utils as tcu
    from test_torch_experiments import _without_class_paths

    assert sorted(tparams.CONFIGS) == sorted(jparams.CONFIGS)
    # 8 archs x (1 + 2 x 2 x 4 x 2 x 2 x 2), each with 3 seed copies
    assert len(tparams.CONFIGS) == 8 * 129 * 4
    for name in jparams.CONFIGS:
        assert (_without_class_paths(tcu.sanitize_config(tparams.CONFIGS[name]))
                == _without_class_paths(jcu.sanitize_config(jparams.CONFIGS[name]))), name


def test_refusals_name_their_slices():
    """The ViT-C configs of vit_bcosification fail as in the JAX package (no
    VIT_CONFIGS entry). What later slices brought no longer raises: the
    ViT-C entries build with their stem, ``moe_experts`` builds the switch
    MoE's ``ff.moe2`` in every encoder, SimpleViT() defaults to BcosLinear,
    and the Trainer takes a ViT config."""
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.modules import (
        BcosConv2d,
        BcosifyLinear,
        BcosLinear,
        DetachableGNLayerNorm2d,
    )
    from bcosification_tpu_torch.training.trainer import _check_ported

    with pytest.raises(KeyError, match="vitc_b_patch1_14"):
        jmodel.get_model(model_config(jparams.CONFIGS, "bcos_vitc_b_patch1_14"))
    with pytest.raises(KeyError, match="vitc_b_patch1_14"):
        tmodel.get_model(model_config(tparams.CONFIGS, "bcos_vitc_b_patch1_14"), device="cpu")
    vitc = tvit.vitc_ti_patch1_14(linear_layer=BcosifyLinear, conv2d_layer=BcosConv2d,
                                  norm2d_layer=DetachableGNLayerNorm2d, num_classes=NUM_CLASSES)
    assert [type(layer).__name__ for layer in vitc.stem()[:2]] == ["BcosConv2d",
                                                                  "DetachableGroupNorm2d"]
    with torch.no_grad():
        assert vitc(torch.from_numpy(images(1, 13))).shape == (1, NUM_CLASSES)
    moe_vit = tvit.SimpleViT(linear_layer=BcosifyLinear, moe_experts=2, **SMALL)
    assert all(type(enc.ff) is tvit.MoEFeedForward and enc.ff.moe2.num_experts == 2
               and not hasattr(enc.ff, "linear2") for enc in moe_vit.encoders())
    assert type(tvit.SimpleViT(**SMALL).to_patch_embedding_linear) is BcosLinear
    exp = Experiment("ImageNet", "vit_bcosification", BASE)
    assert _check_ported(exp.config) is None


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    """``evaluate --base_network vit_bcosification --weights F.npz`` (10
    classes, the labels of 3, the recipe's eval preset: 224x224 crops, 784 tokens of the
    small net) against JAX ``evaluate.evaluate`` on the same weights and
    folder; ``--reload fresh`` runs the random init."""
    import evaluate as jevaluate
    from bcosification_tpu import settings as jsettings
    from bcosification_tpu.data import datamodules as jdm
    from bcosification_tpu.parallel import mesh as mesh_lib
    from bcosification_tpu_torch import evaluate as tevaluate
    from bcosification_tpu_torch import settings as tsettings
    from bcosification_tpu_torch.data.synthetic import write_imagenet_tree

    root = tmp_path / "imagenet"
    write_imagenet_tree(root, 3, 4, 10, sizes=((256, 240), (240, 300)), seed=1)
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", str(root))
    monkeypatch.setattr(jsettings, "IMAGENET_PATH", str(root))
    name = config_name()
    for configs in (jparams.CONFIGS, tparams.CONFIGS):
        cfg = copy.deepcopy(configs[name])
        cfg["model"]["args"]["num_classes"] = NUM_CLASSES
        monkeypatch.setitem(configs, name, cfg)
    net, variables, tnet = vit_pair(name, seed=4)
    flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray,
                                                                           variables))[0]}
    npz = tmp_path / "weights.npz"
    np.savez(npz, **flat)
    base = ["--base_network", "vit_bcosification", "--experiment_name", name]
    with small_arch(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        top1, top5, (c1, c5, n) = tevaluate.run_evaluation(
            tevaluate.get_parser().parse_args([*base, "--weights", str(npz)]), device="cpu")
        fresh = tevaluate.run_evaluation(
            tevaluate.get_parser().parse_args([*base, "--reload", "fresh", "--batch_size", "4"]),
            device="cpu")
    assert n == 10 and fresh[2][2] == 10
    data = jdm.ImageNetDataModule(jparams.CONFIGS[name]["data"])
    data.setup("test")
    with jax.default_matmul_precision("highest"):
        want1, want5 = jevaluate.evaluate(net, variables, data.test_dataloader(),
                                          mesh_lib.make_mesh())
    assert (c1, c5) == (round(want1 * n), round(want5 * n))
    assert 0 < c5 < n  # the comparison has signal
