"""The port's from-scratch B-cos CNN zoo against the JAX package on the CPU,
in fp32, on the same weights (JAX variables drawn with numpy from a seed,
carried across by bcosify/from_jax.py):

- the new modules at 1e-5 relative: ``DetachablePositionNorm2d`` (forward and
  its input gradient with and without ``explain``), grouped ``patch_norms``
  and the grouped B-cos conv, ``max_pool2d``; ``StochasticDepth`` in eval
  mode and its train-mode drop rate;
- one net per code path of the zoo's entries at small width and depth (the
  entries' classes and presets: basic and bottleneck blocks, ResNeXt's
  grouped 3x3s, the wide ResNet, the DenseNet with its logit layer; 32x32,
  10 classes): the logits and the generic W (autograd) within 1e-5 of JAX,
  the hand-scheduled passes (``explain/fast_resnet.py``,
  ``explain/fast_densenet.py``) equal to the generic W within 1e-5, and
  their ``export_explain`` round trips;
- every CNN entry of the registry at full width by shapes only: the port's
  meta-device build against the JAX package's ``abstract_init`` tree.
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.models import densenet as jdensenet
from bcosification_tpu.models import pretrained as jpretrained
from bcosification_tpu.models import resnet as jresnet
from bcosification_tpu.utils.init_mode import abstract_init as jax_abstract_init
from bcosification_tpu.utils.init_mode import initialize
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
from bcosification_tpu_torch.explain import fast_densenet, fast_resnet
from bcosification_tpu_torch.models import densenet as tdensenet
from bcosification_tpu_torch.models import pretrained
from bcosification_tpu_torch.models import resnet as tresnet
from bcosification_tpu_torch.utils.init_mode import abstract_init
from test_torch_training import _rel
from test_torch_vit_final import randomized

torch.set_num_threads(1)
NUM_CLASSES, SIZE = 10, 32
# (JAX class, port class, the entry's presets cut to size) per code path
SMALL = {
    "resnet18": ("BcosResNet", dict(block="basic", layers=(1, 1), inplanes=8)),
    "resnet50": ("BcosResNet", dict(block="bottleneck", layers=(1, 1), inplanes=8)),
    "resnext50_32x4d": ("BcosResNet", dict(block="bottleneck", layers=(1, 1), inplanes=16,
                                           groups=8, width_per_group=16)),
    "wide_resnet50_2": ("BcosResNet", dict(block="bottleneck", layers=(1, 1), inplanes=8,
                                           width_per_group=128)),
    "densenet121": ("BcosDenseNet", dict(growth_rate=8, block_config=(2, 2),
                                         num_init_features=16, bn_size=2,
                                         with_logit_layer=True, stem_pool="avg")),
}
CNN_NAMES = [n for n in pretrained.list_available()
             if n.startswith(("resnet", "resnext", "wide_resnet", "densenet"))]


def images(n, seed, size=SIZE):
    x = np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1)


def small_pair(cls, kw, seed=0):
    """(jax net, jax variables, port net on the CPU) of class ``cls`` ("BcosResNet"
    or "BcosDenseNet") built with ``kw``, on the same weights drawn from ``seed``."""
    jmod = jresnet if cls == "BcosResNet" else jdensenet
    tmod = tresnet if cls == "BcosResNet" else tdensenet
    net = getattr(jmod, cls)(num_classes=NUM_CLASSES, **kw)
    variables = initialize(net, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 6)))
    variables_np = randomized(variables, seed)
    tnet = pretrained._cnn(getattr(tmod, cls), num_classes=NUM_CLASSES, **kw)(device="cpu")
    load_jax_variables(tnet, variables_np)
    return net, jax.tree_util.tree_map(jnp.asarray, variables_np), tnet


@pytest.fixture(scope="module")
def pairs():
    return {name: small_pair(*SMALL[name], seed=i) for i, name in enumerate(SMALL)}


def _jax_explain(net, variables, x, idx=None):
    from bcosification_tpu.explain.core import dynamic_linear_weights

    def f(inp):
        return net.apply(variables, inp, train=False, explain=True)

    return jax.jit(lambda inp: dynamic_linear_weights(f, inp, idx))(jnp.asarray(x))


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
def test_position_norm_matches_jax(explain, dtype):
    """Forward and input gradient (VJP of a random cotangent) of the bias-free
    DetachablePositionNorm2d with a random weight, against JAX's; under bf16
    inputs the statistics stay in f32 (the outputs equal the f32 norm of the
    bf16 input, rounded once)."""
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.modules import norms as tnorms

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 4, 12)) * 3 + 1).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    weight = (1 + 0.2 * rng.standard_normal(12)).astype(np.float32)
    jnorm = jnorms.NoBias(jnorms.DetachablePositionNorm2d)(12)
    variables = {"params": {"weight": jnp.asarray(weight)}}
    y, vjp = jax.vjp(lambda t: jnorm.apply(variables, t, explain=explain), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(ct))
    tnorm = tnorms.NoBias(tnorms.DetachablePositionNorm2d)(12)
    with torch.no_grad():
        tnorm.weight.copy_(torch.from_numpy(weight))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    yt = tnorm(xt, explain=explain)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct).to(dtype))
    assert yt.dtype == dtype and tnorm.bias is None
    if dtype == torch.float32:
        assert _rel(yt.detach().numpy(), y) <= 1e-5
        assert _rel(gt.numpy(), gx) <= 1e-5
    else:
        ref = tnorm(xt.detach().float(), explain=explain)  # the f32 norm of the bf16 input
        assert torch.equal(yt.detach(), ref.to(dtype))


@pytest.mark.parametrize("groups,kernel,stride,padding",
                         [(1, 3, 1, 1), (4, 3, 2, 1), (8, 3, 1, 1), (2, 1, 2, 0)])
def test_grouped_patch_norms_and_conv_match_jax(groups, kernel, stride, padding):
    """Grouped patch norms (one per group, [N, Ho, Wo, groups], broadcast
    over the group's output channels) and the grouped B-cos conv (forward
    and W with ``explain``) against the JAX ops at 1e-5."""
    from bcosification_tpu.ops import bcos as jops
    from bcosification_tpu_torch.ops import bcos as tops

    rng = np.random.default_rng(groups)
    c, o = 16, 24
    x = rng.standard_normal((2, 9, 9, c)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, c // groups, o)).astype(np.float32)  # HWIO
    want = jops.patch_norms(jnp.asarray(x), kernel, stride=stride, padding=padding,
                            groups=groups, out_channels=o)
    got = tops.patch_norms(torch.from_numpy(x), kernel, stride=stride, padding=padding,
                           groups=groups)
    assert got.shape[-1] == groups
    got = torch.repeat_interleave(got, o // groups, dim=-1)
    assert _rel(got.numpy(), want) <= 1e-5
    for explain in (False, True):
        y, vjp = jax.vjp(lambda t: jops.bcos_conv2d(t, jnp.asarray(w), stride=stride,
                                                     padding=padding, groups=groups,
                                                     explain=explain), jnp.asarray(x))
        ct = rng.standard_normal(y.shape).astype(np.float32)
        (gx,) = vjp(jnp.asarray(ct))
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = tops.bcos_conv2d(xt, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                              stride=stride, padding=padding, groups=groups, explain=explain)
        (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct))
        assert _rel(yt.detach().numpy(), y) <= 1e-5
        assert _rel(gt.numpy(), gx) <= 1e-5
    with pytest.raises(ValueError, match="ungrouped"):
        tops.patch_norms(torch.from_numpy(x), kernel, groups=2,
                         x_sumsq=tops.channel_sumsq(torch.from_numpy(x)))


def test_max_pool2d_matches_jax():
    from bcosification_tpu.ops import pooling as jpool
    from bcosification_tpu_torch.ops import pooling as tpool

    x = np.random.default_rng(2).standard_normal((2, 11, 10, 5)).astype(np.float32) - 2.0
    for args in ((3, 2, 1), (2, 2, 0), (3, 1, 1)):
        want = np.asarray(jpool.max_pool2d(jnp.asarray(x), *args))
        got = tpool.max_pool2d(torch.from_numpy(x), *args).numpy()
        assert got.shape == want.shape and _rel(got, want) <= 1e-5


def test_stochastic_depth():
    """Eval mode (and p = 0) is the identity, as in JAX; train mode keeps
    each row with probability 1 - p, scaled by 1 / (1 - p) ("row"), or the
    whole batch ("batch"), drawn from the generator given."""
    from bcosification_tpu.modules.stochastic_depth import StochasticDepth as JSD
    from bcosification_tpu_torch.modules.stochastic_depth import (
        StochasticDepth,
        stochastic_depth,
    )

    x = np.random.default_rng(3).standard_normal((4000, 2, 2, 3)).astype(np.float32) + 5.0
    xt = torch.from_numpy(x)
    want = np.array(JSD(0.3).apply({}, jnp.asarray(x), train=False))
    assert torch.equal(StochasticDepth(0.3)(xt), torch.from_numpy(want))
    assert torch.equal(StochasticDepth(0.0)(xt, train=True), xt)
    gen = torch.Generator().manual_seed(0)
    y = stochastic_depth(xt, 0.3, "row", True, gen)
    kept = (y != 0).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all())
    assert abs(float(kept.float().mean()) - 0.7) < 0.03  # 4000 rows: 4.3 sigma
    torch.testing.assert_close(y[kept], xt[kept] / 0.7)
    again = stochastic_depth(xt, 0.3, "row", True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    b = stochastic_depth(xt, 0.5, "batch", True, gen)
    assert torch.equal(b, xt / 0.5) or not bool(b.any())
    for p, mode in ((1.5, "row"), (0.2, "col")):
        with pytest.raises(ValueError):
            stochastic_depth(xt, p, mode, True)


# --------------------------------------------------------------------------
# the zoo's code paths at small size
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SMALL))
def test_forward_and_w_match_jax(pairs, name):
    """Logits and the generic W (autograd of the explanation-mode module)
    within 1e-5 relative of JAX's; the same argmax; the PositionNorm nets
    need no calibration (the outputs are O(1))."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[name]
    x = images(2, 5)
    want = np.asarray(jax.jit(lambda t: net.apply(variables, t, train=False))(jnp.asarray(x)),
                      np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    bias = -math.log(NUM_CLASSES - 1)
    assert np.abs(want - bias).max() > 1e-2  # the comparison has signal
    assert _rel(got - bias, want - bias) <= 1e-5
    jl, js, jw = _jax_explain(net, variables, x)
    logits, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                            torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), jw) <= 1e-5
    assert _rel(logits.double().numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5


@pytest.mark.parametrize("name", list(SMALL))
def test_fast_pass_equals_the_generic_w(pairs, name):
    """The hand-scheduled pass of the net's family (the position-norm
    schedule) against the module path's autograd W and logits at 1e-5, for
    the predicted and a given class; with one K3 and one K2 call per
    stride-1 1x1 conv (the plain versions count on the CPU), no K1."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights, make_explain_fn
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    _, _, tnet = pairs[name]
    fast = fast_densenet if name.startswith("densenet") else fast_resnet
    assert fast.supports(tnet) and fast_resnet.position_norm_layers(tnet)
    assert fast_resnet.supports(tnet) == (fast is fast_resnet)
    xt = torch.from_numpy(images(2, 6))
    calls = {"fwd": 0, "bwd": 0, "matmul": 0}
    real = (bcos_conv1x1.conv1x1_fwd_plain, bcos_conv1x1.conv1x1_bwd_explain_plain,
            bcos_matmul.bcos_matmul_fwd_plain)

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for idx in (None, 3):
        ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, idx,
                                            device="cpu")
        calls.update(fwd=0, bwd=0, matmul=0)
        bcos_conv1x1.conv1x1_fwd_plain = counting("fwd", real[0])
        bcos_conv1x1.conv1x1_bwd_explain_plain = counting("bwd", real[1])
        bcos_matmul.bcos_matmul_fwd_plain = counting("matmul", real[2])
        try:
            fl, fs, fw = fast.fast_dynamic_linear_weights(tnet, xt, idx, device="cpu")
        finally:
            (bcos_conv1x1.conv1x1_fwd_plain, bcos_conv1x1.conv1x1_bwd_explain_plain,
             bcos_matmul.bcos_matmul_fwd_plain) = real
        np.testing.assert_array_equal(fs.numpy(), ms.numpy())
        assert _rel(fw.numpy(), mw.numpy()) <= 1e-5
        assert _rel(fl.numpy(), ml.numpy()) <= 1e-5
        k1x1 = sum(1 for mod in tnet.modules() if isinstance(mod, torch.nn.Module)
                   and getattr(mod, "kernel_size", None) == (1, 1)
                   and getattr(mod, "stride", None) == (1, 1))
        assert calls == {"fwd": 0, "bwd": k1x1, "matmul": k1x1}
        if fast is fast_resnet and idx is None:  # explain() takes the pass for the ResNets
            calls.update(fwd=0, bwd=0, matmul=0)
            bcos_conv1x1.conv1x1_bwd_explain_plain = counting("bwd", real[1])
            try:
                out = make_explain_fn(tnet, with_image=False)(xt, device="cpu")
            finally:
                bcos_conv1x1.conv1x1_bwd_explain_plain = real[1]
            assert calls["bwd"] == k1x1
            assert torch.equal(out["dynamic_linear_weights"], fw)


@pytest.mark.parametrize("name", ["resnet50", "densenet121"])
def test_export_explain_round_trip(pairs, name):
    """``export_explain`` serves the small zoo ResNet and DenseNet: the
    program loaded from bytes gives the eager pass's logits and W."""
    from bcosification_tpu_torch import serving

    _, _, tnet = pairs[name]
    fast = fast_densenet if name.startswith("densenet") else fast_resnet
    program = serving.load_serialized(serving.export_explain(tnet, input_size=SIZE,
                                                             device="cpu"))
    xt = torch.from_numpy(images(3, 7))
    logits, sel, w = program.call(xt)
    el, es, ew = fast.fast_dynamic_linear_weights(tnet, xt, device="cpu")
    assert torch.equal(sel, es)
    assert _rel(w.numpy(), ew.numpy()) <= 1e-6 and _rel(logits.numpy(), el.numpy()) <= 1e-6


def test_small_inputs_and_stem_pools(pairs):
    """The ResNet's small_inputs stem (3x3, no pool), "max" stem pool and
    stochastic depth (eval: the identity), and the DenseNet's small_inputs,
    in the forward against JAX at 1e-5; the fast passes take small_inputs
    and refuse the max pool."""
    x = images(2, 8)
    cases = [("BcosResNet", dict(block="basic", layers=(1, 1), inplanes=8, small_inputs=True)),
             ("BcosResNet", dict(block="basic", layers=(1, 1), inplanes=8, stem_pool="max")),
             ("BcosResNet", dict(block="bottleneck", layers=(1, 1), inplanes=8,
                                 stochastic_depth_prob=0.2)),
             ("BcosDenseNet", dict(growth_rate=8, block_config=(2,), num_init_features=8,
                                   bn_size=2, with_logit_layer=True, small_inputs=True))]
    for i, (cls, kw) in enumerate(cases):
        net, variables, tnet = small_pair(cls, kw, seed=10 + i)
        want = np.asarray(jax.jit(lambda t: net.apply(variables, t, train=False))(
            jnp.asarray(x)), np.float64)
        with torch.no_grad():
            got = tnet(torch.from_numpy(x)).double().numpy()
        assert _rel(got, want) <= 1e-5
        fast = fast_resnet if cls == "BcosResNet" else fast_densenet
        assert fast.supports(tnet) == (kw.get("stem_pool") != "max")


# --------------------------------------------------------------------------
# the registry's CNNs at full width, by shapes only
# --------------------------------------------------------------------------
def _jax_shapes(name):
    """{port state-dict key: shape} of the JAX abstract tree of ``name``
    (conv kernels HWIO -> OIHW)."""
    with jax_abstract_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, tree = jpretrained.load_model(name, pretrained=False)
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        shape = tuple(leaf.shape)
        shapes[".".join(p.key for p in path[1:])] = (
            tuple(shape[i] for i in (3, 2, 0, 1)) if len(shape) == 4 else shape)
    return shapes


@pytest.mark.parametrize("name", CNN_NAMES)
def test_meta_build_shapes_match_jax(name):
    """``load_model(name)`` under abstract_init builds on the meta device
    (no memory, no init) with the state-dict shapes of the JAX tree."""
    with abstract_init():
        net = pretrained.load_model(name, pretrained=False)
    state = net.state_dict()
    assert all(t.device.type == "meta" for t in state.values())
    assert {k: tuple(t.shape) for k, t in state.items()} == _jax_shapes(name)
