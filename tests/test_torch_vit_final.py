"""The port's from-scratch SimpleViTs (ImageNet/vit_final) against the JAX
package on the CPU, in fp32, on the same weights: the grid's archs cut to
dim 32, depth 2, 2 heads, mlp 64 (the ViT-C stem to widths (8, 16), the
plain ViT to patch 8), 10 classes, 32x32 images, built by both packages'
model factories with the arch entries set to the small nets for the call,
the JAX variables drawn with numpy from a seed and carried across by
bcosify/from_jax.py, JAX at the highest matmul precision.

- the forward of each small net (the B-cos ViT-C and ViT, 6 channels; the
  standard ViT-C and ViT, 3 channels) and W through autograd, within 1e-5
  relative (1e-7 relative input noise moves W by less than 1e-6 here:
  ``test_w_is_well_conditioned``); the hand-scheduled pass
  ``explain/fast_vit.py`` on the B-cos ViT (BcosLinear, the logit layer
  inside the SimpleViT) and on the B-cos ViT-C (its conv stem's transpose)
  against both; ``export_explain`` serving both B-cos nets and raising for
  the standard baselines;
- the group norms of the stem (``DetachableGNLayerNorm2d`` and its
  relatives) and ``BcosLinear``, each in its forward and its VJP with and
  without ``explain`` (1e-5); the standard stem's ``PlainConv2d``;
- the grid equal to the JAX package's ``CONFIGS``.
"""
import contextlib
import copy
import functools
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.experiments.ImageNet.vit_final import experiment_parameters as jparams
from bcosification_tpu.experiments.ImageNet.vit_final import model as jmodel
from bcosification_tpu.models import vit as jvit
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
from bcosification_tpu_torch.experiments.ImageNet.vit_final import (
    experiment_parameters as tparams,
)
from bcosification_tpu_torch.experiments.ImageNet.vit_final import model as tmodel
from bcosification_tpu_torch.models import vit as tvit
from test_torch_training import _rel

torch.set_num_threads(1)
NUM_CLASSES, SIZE = 10, 32
SMALL = dict(dim=32, heads=2, mlp_dim=64, depth=2)
# the archs of the grid cut to size: the ViT-C's two stride-2 stem convs
# give 8x8 tokens at 32x32, the plain ViT's patch 8 4x4
ARCHS = {"vitc_ti_patch1_14": dict(image_size=14, patch_size=1, conv_stem=(8, 16), **SMALL),
         "simple_vit_ti_patch16_224": dict(image_size=32, patch_size=8, **SMALL)}
NAMES = ["bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14", "bcos_simple_vit_ti_patch16_224",
         "simple_vit_ti_patch16_224"]


@contextlib.contextmanager
def small_archs():
    """Both packages' arch entries of ARCHS set to the small nets for the
    call."""
    saved = {name: (getattr(jvit, name), getattr(tvit, name)) for name in ARCHS}
    for name, kw in ARCHS.items():
        setattr(jvit, name, functools.partial(jvit.SimpleViT, **kw))
        setattr(tvit, name, functools.partial(tvit.SimpleViT, **kw))
    try:
        yield
    finally:
        for name, (jfactory, tfactory) in saved.items():
            setattr(jvit, name, jfactory)
            setattr(tvit, name, tfactory)


def model_config(configs, name):
    cfg = copy.deepcopy(configs[name]["model"])
    cfg["args"]["num_classes"] = NUM_CLASSES
    return cfg


def randomized(variables, seed):
    """The JAX variables with every leaf drawn from ``seed``: linear and conv
    weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norm weights 1 + 0.2 N,
    biases 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):  # an array or a shape (jax.eval_shape): only the shape is read
        shape = tuple(a.shape)
        if path[-1].key == "weight" and len(shape) >= 2:
            bound = 1.0 / math.sqrt(int(np.prod(shape[:-1])))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if path[-1].key == "weight":
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def final_pair(name, seed=0):
    """(jax net, jax variables, port net) of config ``name`` at the small
    size, on the same weights drawn from ``seed``; the port on the CPU."""
    from bcosification_tpu.utils.init_mode import abstract_init

    # every leaf is redrawn: the JAX model's shapes suffice, no init to compile
    with small_archs(), warnings.catch_warnings(), abstract_init():
        warnings.simplefilter("ignore")
        net, variables = jmodel.get_model(model_config(jparams.CONFIGS, name))
        tnet = tmodel.get_model(model_config(tparams.CONFIGS, name), device="cpu")
    variables_np = randomized(variables, seed)
    load_jax_variables(tnet, variables_np)
    return net, jax.tree_util.tree_map(jnp.asarray, variables_np), tnet


def images(name, n, seed, size=SIZE):
    """AddInverse images [n, size, size, 6] for a B-cos config, normalised
    RGB [n, size, size, 3] for a standard one."""
    x = np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)
    if name.startswith("bcos_"):
        return np.concatenate([x, 1.0 - x], axis=-1)
    return ((x - 0.45) / 0.225).astype(np.float32)


def bias_of(tnet):
    return tnet.logit_layer.logit_bias if tnet.with_logit_layer else 0.0


@pytest.fixture(scope="module")
def pairs():
    return {name: final_pair(name) for name in NAMES}


def _jax_explain(net, variables, x, idx=None):
    from bcosification_tpu.explain.core import dynamic_linear_weights

    def f(inp):
        return net.apply(variables, inp, train=False, explain=True)

    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda inp: dynamic_linear_weights(f, inp, idx))(jnp.asarray(x))


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_w_match_jax(pairs, name):
    """The forward (pre-logits) and W of the module path (autograd) within
    1e-5 relative of the JAX package's; the same argmax."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[name]
    x = images(name, 2, 1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda inp: net.apply(variables, inp, train=False))(
            jnp.asarray(x)), np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    bias = bias_of(tnet)
    assert _rel(got - bias, want - bias) <= 1e-5
    assert np.abs(want - bias).max() > 1e-2  # the comparison has signal
    jl, js, jw = _jax_explain(net, variables, x)
    logits, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                            torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), jw) <= 1e-5
    assert _rel(logits.double().numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5


def test_w_is_well_conditioned(pairs):
    """1e-7 relative input noise moves W by less than 1e-6 on each small net,
    so W is held to 1e-5 above."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    for name, (_, _, tnet) in pairs.items():
        x = torch.from_numpy(images(name, 2, 1))
        noise = torch.from_numpy(
            np.random.default_rng(3).standard_normal(x.shape).astype(np.float32))
        _, _, w = dynamic_linear_weights(lambda t: tnet(t, explain=True), x, device="cpu")
        _, _, wn = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                          x * (1 + 1e-7 * noise), device="cpu")
        assert _rel(wn.numpy(), w.numpy()) < 1e-6, name


def test_fast_vit_on_bcos_linear_equals_the_module_path(pairs):
    """The hand-scheduled pass on the B-cos ViT of vit_final (BcosLinear,
    the logit layer inside the SimpleViT, no Normalize): the logits and W of
    the module path and of JAX (1e-5), for the predicted and a given class;
    each bias-free B-cos linear one K3 and one K2 call (the plain versions
    on the CPU)."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    name = "bcos_simple_vit_ti_patch16_224"
    net, variables, tnet = pairs[name]
    assert fast_vit.supports(tnet)
    x = images(name, 2, 4)
    xt = torch.from_numpy(x)
    bias = bias_of(tnet)
    for idx in (None, 3):
        jl, js, jw = _jax_explain(net, variables, x, None if idx is None else jnp.asarray(idx))
        ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, idx,
                                            device="cpu")
        fl, fs, fw = fast_vit.fast_dynamic_linear_weights(tnet, xt, idx, device="cpu")
        np.testing.assert_array_equal(fs.numpy(), np.asarray(js))
        np.testing.assert_array_equal(fs.numpy(), ms.numpy())
        assert _rel(fw.numpy(), mw.numpy()) <= 1e-5 and _rel(fw.numpy(), jw) <= 1e-5
        assert _rel(fl.double().numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5
        assert _rel(fl.double().numpy() - bias, ml.double().numpy() - bias) <= 1e-5
    calls = {"matmul": 0, "bwd": 0}
    plain_fwd, plain_bwd = bcos_matmul.bcos_matmul_fwd_plain, bcos_conv1x1.conv1x1_bwd_explain_plain

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bcos_matmul, "bcos_matmul_fwd_plain", counting("matmul", plain_fwd))
        mp.setattr(bcos_conv1x1, "conv1x1_bwd_explain_plain", counting("bwd", plain_bwd))
        fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")
    n = 3 * SMALL["depth"] + 2
    assert calls == {"matmul": n, "bwd": n}


def test_fast_vit_on_the_vitc_stem_equals_the_module_path(pairs):
    """The hand-scheduled pass on the B-cos ViT-C (the conv stem's 3x3 B-cos
    convs, group norms and activations transposed by hand): the logits and W
    of the module path and of JAX (1e-5), for the predicted and a given
    class; the stem's convs take no kernel (3x3), each bias-free B-cos
    linear one K3 and one K2 call."""
    from bcosification_tpu_torch.explain import fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    name = "bcos_vitc_ti_patch1_14"
    net, variables, tnet = pairs[name]
    assert fast_vit.supports(tnet) and len(tnet.stem()) == 3 * len(ARCHS[name[5:]]["conv_stem"])
    x = images(name, 2, 6)
    xt = torch.from_numpy(x)
    bias = bias_of(tnet)
    for idx in (None, 3):
        jl, js, jw = _jax_explain(net, variables, x, None if idx is None else jnp.asarray(idx))
        ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, idx,
                                            device="cpu")
        fl, fs, fw = fast_vit.fast_dynamic_linear_weights(tnet, xt, idx, device="cpu")
        np.testing.assert_array_equal(fs.numpy(), np.asarray(js))
        np.testing.assert_array_equal(fs.numpy(), ms.numpy())
        assert _rel(fw.numpy(), mw.numpy()) <= 1e-5 and _rel(fw.numpy(), jw) <= 1e-5
        assert _rel(fl.double().numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5
        assert _rel(fl.double().numpy() - bias, ml.double().numpy() - bias) <= 1e-5
    calls = {"matmul": 0, "bwd": 0}
    plain_fwd, plain_bwd = bcos_matmul.bcos_matmul_fwd_plain, bcos_conv1x1.conv1x1_bwd_explain_plain

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bcos_matmul, "bcos_matmul_fwd_plain", counting("matmul", plain_fwd))
        mp.setattr(bcos_conv1x1, "conv1x1_bwd_explain_plain", counting("bwd", plain_bwd))
        fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")
    n = 3 * SMALL["depth"] + 2
    assert calls == {"matmul": n, "bwd": n}


def test_export_explain_serves_the_bcos_vits_and_refuses_the_baselines(pairs):
    """export_explain serves the B-cos ViT and the B-cos ViT-C of vit_final
    (each loaded program equal to the eager pass and to the module path's W,
    1e-6), and the standard baselines, which fast_vit refuses, through
    fast_vit_standard: the loaded program's W equal to the JAX package's
    generic W on the same weights (1e-5) and the same selected class."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain import fast_vit, fast_vit_standard
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    for name in ("bcos_simple_vit_ti_patch16_224", "bcos_vitc_ti_patch1_14"):
        tnet = pairs[name][2]
        program = serving.load_serialized(serving.export_explain(tnet, input_size=SIZE,
                                                                 device="cpu"))
        xt = torch.from_numpy(images(name, 3, 5))
        logits, sel, w = program.call(xt)
        el, es, ew = fast_vit.fast_dynamic_linear_weights(tnet, xt, device="cpu")
        ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
        np.testing.assert_array_equal(sel.numpy(), es.numpy())
        np.testing.assert_array_equal(sel.numpy(), ms.numpy())
        assert _rel(w.numpy(), ew.numpy()) <= 1e-6, name
        assert _rel(w.numpy(), mw.numpy()) <= 1e-6, name
        assert _rel(logits.double() - bias_of(tnet), el.double() - bias_of(tnet)) <= 1e-6
    for other in ("vitc_ti_patch1_14", "simple_vit_ti_patch16_224"):
        net, variables, tnet = pairs[other]
        assert not fast_vit.supports(tnet) and fast_vit_standard.supports(tnet)
        program = serving.load_serialized(serving.export_explain(tnet, input_size=SIZE,
                                                                 channels=3, device="cpu"))
        x = images(other, 3, 5)
        logits, sel, w = program.call(torch.from_numpy(x))
        jl, js, jw = _jax_explain(net, variables, x)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
        assert _rel(w.numpy(), np.asarray(jw)) <= 1e-5, other
        assert _rel(logits.double().numpy(), np.asarray(jl, np.float64)) <= 1e-5, other


def _module_cases():
    """(id, JAX module factory, port module factory, input shape): the stem's
    group norms, BcosLinear and the standard stem's plain biased conv (JAX
    NormedConv2d without the weight norm, the port's PlainConv2d)."""
    from bcosification_tpu.modules import BcosLinear as JBcosLinear
    from bcosification_tpu.modules import NormedConv2d as JNormedConv2d
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.modules import BcosLinear, PlainConv2d
    from bcosification_tpu_torch.modules import norms as tnorms

    c = 8
    return [
        ("GNLayerNorm2d", lambda: jnorms.DetachableGNLayerNorm2d(c),
         lambda: tnorms.DetachableGNLayerNorm2d(c), (2, 5, 6, c)),
        ("NoBias-GNLayerNorm2d", lambda: jnorms.NoBias(jnorms.DetachableGNLayerNorm2d)(c),
         lambda: tnorms.NoBias(tnorms.DetachableGNLayerNorm2d)(c), (2, 5, 6, c)),
        ("GNInstanceNorm2d", lambda: jnorms.DetachableGNInstanceNorm2d(c),
         lambda: tnorms.DetachableGNInstanceNorm2d(c), (2, 5, 6, c)),
        ("GroupNorm2d-4", lambda: jnorms.DetachableGroupNorm2d(c, num_groups=4),
         lambda: tnorms.DetachableGroupNorm2d(c, num_groups=4), (2, 5, 6, c)),
        ("BcosLinear", lambda: JBcosLinear(12), lambda: BcosLinear(c, 12), (3, 5, c)),
        ("BcosLinear-bias", lambda: JBcosLinear(12, use_bias=True),
         lambda: BcosLinear(c, 12, use_bias=True), (3, 5, c)),
        ("BcosLinear-maxout", lambda: JBcosLinear(6, max_out=2),
         lambda: BcosLinear(c, 6, max_out=2), (3, 5, c)),
        ("NormedConv2d-plain", lambda: JNormedConv2d(12, kernel_size=3, stride=2, padding=1,
                                                     use_weight_norm=False, use_bias=True),
         lambda: PlainConv2d(c, 12, 3, stride=2, padding=1), (2, 7, 6, c)),
        ("NormedConv2d-plain-stride1",
         lambda: JNormedConv2d(8, kernel_size=3, padding=1, use_weight_norm=False,
                               use_bias=True),
         lambda: PlainConv2d(c, 8, 3, padding=1), (2, 7, 6, c)),
    ]


@pytest.mark.parametrize("case", _module_cases(), ids=lambda c: c[0])
def test_stem_norms_and_linears_match_jax(case):
    """Each module's forward and its input and parameter VJPs, with and
    without ``explain``, against the JAX module on the same inputs and
    parameters (1e-5); a norm's VJP changes under explain (its variance
    detached) and a BcosLinear's too (its scale detached)."""
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

    _, jfactory, tfactory, shape = case
    rng = np.random.default_rng(8)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    jm, tm = jfactory(), tfactory()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {k: (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
              for k, v in variables["params"].items()}
    load_jax_variables(tm, {"params": params})
    out_shape = jax.eval_shape(lambda t: jm.apply({"params": params}, t), jnp.asarray(x)).shape
    ct = rng.standard_normal(out_shape).astype(np.float32)
    vjps = {}
    for explain in (False, True):
        def forward_and_vjp(p, t, c, explain=explain):  # one jit: eager flax is slow
            y, vjp = jax.vjp(lambda pp, tt: jm.apply({"params": pp}, tt, explain=explain), p, t)
            return y, vjp(c)

        want, (want_p, want_x) = jax.jit(forward_and_vjp)(params, jnp.asarray(x),
                                                          jnp.asarray(ct))
        xt = torch.from_numpy(x).requires_grad_(True)
        tm.zero_grad()
        got = tm.requires_grad_(True)(xt, explain=explain)
        got.backward(torch.from_numpy(ct))
        assert _rel(got.detach(), want) < 1e-5, explain
        assert _rel(xt.grad, want_x) < 1e-5, explain
        for k, g in want_p.items():
            got_g = getattr(tm, k).grad.numpy()
            got_g = got_g.transpose(2, 3, 1, 0) if got_g.ndim == 4 else got_g
            assert _rel(got_g, g) < 1e-5, (k, explain)
        vjps[explain] = xt.grad
    detaches = not case[0].startswith("NormedConv2d")
    assert (_rel(vjps[True], vjps[False]) > 1e-3) == detaches


@pytest.mark.parametrize("name", ["GNLayerNorm2d", "NoBias-GNLayerNorm2d"])
def test_gn_layernorm_in_f32_on_bf16(name):
    """The stem's norm on a bf16 input: the statistics in f32, the output in
    bf16, within bf16's rounding of the JAX package's."""
    case = next(c for c in _module_cases() if c[0] == name)
    _, jfactory, tfactory, shape = case
    rng = np.random.default_rng(9)
    x = (1.5 * rng.standard_normal(shape) + 4.0).astype(np.float32)
    jm, tm = jfactory(), tfactory()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {k: (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
              for k, v in variables["params"].items()}
    for k, v in params.items():
        getattr(tm, k).data = torch.from_numpy(v)
    want = jm.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():  # got32: f32 on the same rounded input
        got, got32 = tm(xb), tm(xb.float())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 4e-3
    assert _rel(got.float(), got32) <= 4e-3


def test_the_grid_equals_jax():
    """The 16 configs (8 archs, each standard and B-cos), field by field."""
    from bcosification_tpu.experiments.utils import config_utils as jcu
    from bcosification_tpu_torch.experiments.utils import config_utils as tcu
    from test_torch_experiments import _without_class_paths

    assert sorted(tparams.CONFIGS) == sorted(jparams.CONFIGS)
    assert len(tparams.CONFIGS) == 16
    for name in jparams.CONFIGS:
        assert (_without_class_paths(tcu.sanitize_config(tparams.CONFIGS[name]))
                == _without_class_paths(jcu.sanitize_config(jparams.CONFIGS[name]))), name


# --------------------------------------------------------------------------
# training: one step of each recipe, bf16 amp, AGC over the whole tree
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,target", [("bcos_vitc_ti_patch1_14", "indices"),
                                         ("vitc_ti_patch1_14", "indices"),
                                         ("vitc_ti_patch1_14", "probabilities")])
def test_train_step_matches_jax(pairs, name, target):
    """One fp32 step of the config's recipe against the JAX step
    (``test_torch_vit_train.step_parity``): the B-cos ViT-C (Adam, AGC,
    UniformOffLabels BCE; the stem's BcosConv2d and bias-free group norm),
    the standard ViT-C (AdamW with weight decay 1e-4, the global-norm clip
    at 1.0, softmax cross-entropy; the plain biased stem conv), also on
    mixup's class probabilities. The clip is active (gradient norm > 1)."""
    from test_torch_vit_train import LABEL, SOFT, step_parity

    net, variables, tnet = pairs[name]
    label = LABEL if target == "indices" else SOFT
    grad_norm = step_parity(net, variables, tnet, jparams.CONFIGS[name],
                            tparams.CONFIGS[name], images(name, 2, 21), label)
    if not name.startswith("bcos_"):
        assert grad_norm > tparams.CONFIGS[name]["trainer"]["gradient_clip_val"]


@pytest.mark.parametrize("name", ["bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14"])
def test_amp_gradients_within_twice_jax(pairs, name):
    """bf16 amp of each ViT-C recipe (``test_torch_vit_train.amp_parity``):
    the stem's conv in bf16, its group norm's statistics in f32."""
    from test_torch_vit_train import LABEL, amp_parity

    net, variables, tnet = pairs[name]
    amp_parity(net, variables, tnet, jparams.CONFIGS[name], tparams.CONFIGS[name],
               images(name, 2, 22), LABEL)


@pytest.mark.parametrize("name", ["bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14"])
def test_agc_over_the_vitc_tree_matches_jax(pairs, name):
    """AGC over every leaf of the small ViT-C: the OIHW stem convs clipped
    per output channel (the first axis), the (in, out) BcosLinear and
    PlainLinear weights per output column (the last), biases and the 1-D
    norm affines by their full norm, as the JAX package clips its HWIO /
    (in, out) tree."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu_torch.training import agc

    _, variables, tnet = pairs[name]
    tnet = copy.deepcopy(tnet)
    rng = np.random.default_rng(14)
    params = {n: np.asarray(v, np.float32) for n, v in _flat(variables["params"]).items()}
    grads = {n: (rng.standard_normal(p.shape) * np.where(rng.random(p.shape) < 0.5, 1.0, 1e-4)
                 * 0.1).astype(np.float32) for n, p in params.items()}
    for n, p in tnet.named_parameters():
        g = grads[n.replace(".", "/")]
        p.grad = torch.from_numpy(g.transpose(3, 2, 0, 1).copy() if g.ndim == 4 else g.copy())
    want = _flat(jagc.adaptive_clip_grads({k: jnp.asarray(v) for k, v in params.items()},
                                          {k: jnp.asarray(v) for k, v in grads.items()}))
    agc.adaptive_clip_grads_(tnet)
    clipped = 0
    for n, p in tnet.named_parameters():
        key = n.replace(".", "/")
        got = p.grad.numpy()
        got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
        np.testing.assert_allclose(got, want[key], rtol=1e-6, atol=1e-9, err_msg=key)
        clipped += not np.array_equal(got, grads[key])
    assert clipped >= len(grads) // 2  # most leaves clipped somewhere


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out
