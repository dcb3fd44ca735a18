"""The port's B-cos VGG and ConvNeXt entries, and the norms and layers no zoo
entry used before them, against the JAX package on the CPU, in fp32, on the
same weights (JAX variables drawn with numpy from a seed, running variances
drawn positive, carried across by bcosify/from_jax.py):

- each new norm (the uncentered AllNorm, group norms and position norm, the
  centered BatchNorm2d and AllNorm2d) at 1e-5 relative: forward and input
  gradient with and without ``explain``, eval and train, the running
  statistics after a train step, the centered norms' refusal of
  ``explain`` in train mode;
- each new layer (``NormedConv2d``, ``NormedLinear``, ``BcosConv2dWithScale``)
  and ``adaptive_avg_pool2d``;
- the K1 gate: a small ResNet with the bias-free uncentered AllNorm (a (1,)
  mult) equals JAX in eval and explain, its 1x1s off K1;
- one net per code path at small size (VGG plain and ``_bnu`` at a tiny
  letter config, 16x16 input, the classifier at 1x1; ConvNeXt with the
  position norm and with the uncentered BN, two blocks per stage, dims 8/16,
  32x32): logits and the generic W within 1e-5 of JAX, the hand-scheduled
  passes (``explain/fast_vgg.py``, ``explain/fast_convnext.py``) equal to the
  generic W within 1e-5 with one K3 and one K2 per stride-1 1x1, and their
  ``export_explain`` round trips; in bf16 the passes and their programs
  equal to the module path bit for bit;
- every VGG and ConvNeXt entry of the registry at full width by shapes
  only: the port's meta-device build against the JAX ``abstract_init`` tree.
"""
import contextlib
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.models import convnext as jconvnext
from bcosification_tpu.models import resnet as jresnet
from bcosification_tpu.models import vgg as jvgg
from bcosification_tpu.utils.init_mode import initialize
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
from bcosification_tpu_torch.explain import fast_convnext, fast_resnet, fast_vgg
from bcosification_tpu_torch.models import convnext as tconvnext
from bcosification_tpu_torch.models import pretrained
from bcosification_tpu_torch.models import resnet as tresnet
from bcosification_tpu_torch.models import vgg as tvgg
from test_torch_training import _rel
from test_torch_vit_final import randomized
from test_torch_zoo_cnn import _jax_shapes, images

torch.set_num_threads(1)
NUM_CLASSES = 10
# a letter config cut to size: 16x16 in, four pools, the classifier at 1x1
TINY_CFG = [8, "M", 16, "M", 32, 32, "M", 64, "M"]
TINY = "T"
CONVNEXT = [(8, 16, 2), (16, None, 2)]
VGG_CONVNEXT_NAMES = [n for n in pretrained.list_available() if n.startswith(("vgg", "convnext"))]


@contextlib.contextmanager
def tiny_cfg():
    """CFGS[TINY] set in both packages for the block."""
    for cfgs in (jvgg.CFGS, tvgg.CFGS):
        cfgs[TINY] = TINY_CFG
    try:
        yield
    finally:
        for cfgs in (jvgg.CFGS, tvgg.CFGS):
            cfgs.pop(TINY, None)


def calibrate_norms(tnet, x):
    """Every uncentered BN's (or AllNorm's) running_var set to the mean
    square of its input (per channel, or over the whole tensor) on ``x``, in
    forward order, in one eval pass with an input gradient wanted (so no
    norm folds into a conv); then the last norm's weight scaled so that the
    pre-logits have RMS 1 (a b=2 net is homogeneous of degree 1 in the
    input of its norm-free head; VGG's classifier contracts ~3e4-fold).
    The calibrated nets neither vanish nor blow up: the parity has signal."""
    from bcosification_tpu_torch.modules.norms import _RunningVarNorm

    def pre(mod, args):
        dims = (0, 1, 2) if mod.per_channel else (0, 1, 2, 3)
        with torch.no_grad():
            ms = args[0].detach().float().square().mean(dim=dims)
            mod.running_var.copy_(ms.reshape(mod.running_var.shape) - mod.eps)

    norms = [m for m in tnet.modules() if isinstance(m, _RunningVarNorm)]
    order = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: order.append(mod) or pre(mod, args))
             for m in norms]
    try:
        with torch.enable_grad():
            tnet(x.clone().requires_grad_(True))
    finally:
        for h in hooks:
            h.remove()
    if not order:
        return
    with torch.no_grad():
        pre_logits = tnet(x).double() - tnet.logit_layer.logit_bias
        order[-1].weight.div_(float(pre_logits.square().mean().sqrt()))


def positive_running_var(variables_np, seed):
    """``randomized``'s variables with every running_var drawn U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "running_var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables_np)


def jax_net(name, **kw):
    bnu = jconvnext.norms.NoBias(jconvnext.norms.BatchNormUncentered2d)
    if name.startswith("vgg"):
        return jvgg.BcosVGG(cfg=TINY, with_norm=name == "vgg_bnu", num_classes=NUM_CLASSES, **kw)
    blocks = [jconvnext.CNBlockConfig(*c) for c in CONVNEXT]
    extra = dict(norm_layer=bnu) if name == "convnext_bnu" else {}
    return jconvnext.BcosConvNeXt(tuple(blocks), stochastic_depth_prob=0.1,
                                  num_classes=NUM_CLASSES, **extra, **kw)


def port_net(name, **kw):
    from bcosification_tpu_torch.modules import BatchNormUncentered2d, NoBias

    if name.startswith("vgg"):
        return pretrained._cnn(tvgg.BcosVGG, cfg=TINY, with_norm=name == "vgg_bnu",
                               num_classes=NUM_CLASSES, **kw)(device="cpu")
    blocks = [tconvnext.CNBlockConfig(*c) for c in CONVNEXT]
    extra = dict(norm_layer=NoBias(BatchNormUncentered2d)) if name == "convnext_bnu" else {}
    return pretrained._cnn(tconvnext.BcosConvNeXt, block_setting=blocks,
                           stochastic_depth_prob=0.1, num_classes=NUM_CLASSES, **extra,
                           **kw)(device="cpu")


# the plain VGG contracts ~1/sqrt(9 Cin) per conv, and once a patch's
# squares fall under the patch norm's eps (1e-6) ~x^2 per layer: its
# pre-logits (~1e-28, normal f32 numbers) vanish under the logit bias, so it
# runs with bias 0 and the logits are the pre-logits themselves. Its parity
# checks the arithmetic, not the dynamic scales (eps sets its late patch
# norms); the calibrated _bnu net carries the meaningful one
SIZES = {"vgg_plain": 16, "vgg_bnu": 16, "convnext_pn": 32, "convnext_bnu": 32}
KW = {"vgg_plain": dict(logit_bias=0.0)}


def small_pair(name, seed):
    """(jax net, jax variables, port net) of ``name`` on the same weights;
    the uncentered BNs calibrated on a probe image."""
    size = SIZES[name]
    net = jax_net(name, **KW.get(name, {}))
    variables = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 6)))
    variables_np = positive_running_var(randomized(variables, seed), seed + 100)
    tnet = port_net(name, **KW.get(name, {}))
    load_jax_variables(tnet, variables_np)
    calibrate_norms(tnet, torch.from_numpy(images(1, seed + 200, size)))
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tnet))
    if "batch_stats" in variables and not variables["batch_stats"]:
        del variables["batch_stats"]
    return net, variables, tnet


@pytest.fixture(scope="module")
def pairs():
    with tiny_cfg():
        yield {name: small_pair(name, seed=i) for i, name in enumerate(SIZES)}


def jax_forward(net, variables, x):
    """The JAX net's eval logits, the variables passed to jit as arguments
    (as constants XLA would fold the 4096-wide classifier for minutes)."""
    run = jax.jit(lambda v, t: net.apply(v, t, train=False))
    return np.asarray(run(variables, jnp.asarray(x)), np.float64)


def jax_explain(net, variables, x, idx=None):
    """(logits, selected, W) of JAX's generic explanation pass."""
    from bcosification_tpu.explain.core import dynamic_linear_weights

    def run(v, inp):
        return dynamic_linear_weights(lambda t: net.apply(v, t, train=False, explain=True),
                                      inp, idx)

    return jax.jit(run)(variables, jnp.asarray(x))


FAST = {"vgg_plain": fast_vgg, "vgg_bnu": fast_vgg, "convnext_pn": fast_convnext,
        "convnext_bnu": fast_convnext}


# --------------------------------------------------------------------------
# norms, layers, pooling
# --------------------------------------------------------------------------
NORMS = ["AllNormUncentered2d", "GroupNormUncentered2d", "GNInstanceNormUncentered2d",
         "GNLayerNormUncentered2d", "PositionNormUncentered2d", "BatchNorm2d", "AllNorm2d"]
RUNNING = {"AllNormUncentered2d", "BatchNorm2d", "AllNorm2d"}
CENTERED = {"BatchNorm2d", "AllNorm2d"}


def _norm_pair(name, c, rng):
    """(jax module, its variables, port module) with random affine and
    positive running statistics."""
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.modules import norms as tnorms

    kw = dict(num_groups=4) if name == "GroupNormUncentered2d" else {}
    jmod = getattr(jnorms, name)(c, **kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((2, 5, 4, c)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    leaves = {}
    for path, a in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = path[-1].key
        if key == "running_var":
            v = rng.uniform(0.5, 1.5, a.shape)
        elif key == "running_mean":
            v = rng.standard_normal(a.shape)
        elif key == "weight":
            v = 1 + 0.2 * rng.standard_normal(a.shape)
        elif key == "bias":
            v = 0.3 * rng.standard_normal(a.shape)
        else:
            v = a
        leaves[key] = np.asarray(v, a.dtype)
    variables = jax.tree_util.tree_map_with_path(lambda p, a: leaves[p[-1].key], variables)
    tmod = getattr(tnorms, name)(c, **kw)
    load_jax_variables(tmod, variables)
    return jmod, variables, tmod


@pytest.mark.parametrize("mode", ["eval", "explain", "train", "train_explain"])
@pytest.mark.parametrize("name", NORMS)
def test_norm_matches_jax(name, mode):
    """Forward and input gradient (VJP of a random cotangent) against JAX's
    at 1e-5; after a train step the running statistics and the batch count
    as JAX's mutated batch_stats; the centered norms refuse ``explain`` in
    train mode, as JAX's do."""
    train, explain = mode.startswith("train"), mode.endswith("explain")
    rng = np.random.default_rng(NORMS.index(name))
    c = 8
    jmod, variables, tmod = _norm_pair(name, c, rng)
    x = (rng.standard_normal((2, 5, 4, c)) * 2 + 0.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    if train and explain and name in CENTERED:
        with pytest.raises(ValueError, match="explanation mode in eval"):
            tmod(xt, train=True, explain=True)
        with pytest.raises(ValueError, match="explanation mode in eval"):
            jmod.apply(variables, jnp.asarray(x), train=True, explain=True,
                       mutable=["batch_stats"])
        return
    mutable = ["batch_stats"] if train and name in RUNNING else False

    def f(t):
        if mutable:
            return jmod.apply(variables, t, train=train, explain=explain, mutable=mutable)
        return jmod.apply(variables, t, train=train, explain=explain), {}

    def forward_and_vjp(t, c):  # one jit: eager flax is slow
        y, vjp, updated = jax.vjp(f, t, has_aux=True)
        return y, vjp(c), updated

    y, (gx,), updated = jax.jit(forward_and_vjp)(jnp.asarray(x), jnp.asarray(ct))
    yt = tmod(xt, train=train, explain=explain)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct))
    assert _rel(yt.detach().numpy(), y) <= 1e-5
    assert _rel(gt.numpy(), gx) <= 1e-5
    if mutable:
        for key, want in jax.tree_util.tree_map(np.asarray, updated["batch_stats"]).items():
            got = getattr(tmod, key).numpy()
            if key == "num_batches_tracked":
                assert int(got) == int(want) == 1
            else:
                assert _rel(got, want) <= 1e-6, key
    if name in RUNNING and not train:  # eval reads the running statistics
        assert int(tmod.num_batches_tracked) == 0


def test_norm_affines_and_flags():
    """AllNormUncentered2d's fusion hook gives a (1,) mult; NoBias/Unaffine
    drop the affine terms; a group count that does not divide raises."""
    from bcosification_tpu_torch.modules import norms as tnorms

    mod = tnorms.AllNormUncentered2d(8)
    with torch.no_grad():
        mod.running_var.fill_(4.0)
        mod.weight.fill_(3.0)
    mult, add = mod(None, return_affine=True)
    assert mult.shape == (1,) and add.shape == (1,)
    torch.testing.assert_close(mult, torch.tensor([3.0 / math.sqrt(4.0 + 1e-5)]))
    assert tnorms.NoBias(tnorms.PositionNormUncentered2d)(8).bias is None
    unaffine = tnorms.Unaffine(tnorms.BatchNorm2d)(8)
    assert unaffine.weight is None and unaffine.bias is None
    with pytest.raises(ValueError, match="groups"):
        tnorms.GroupNormUncentered2d(10, num_groups=4)


def _layer_cases():
    from bcosification_tpu.modules import BcosConv2dWithScale as JWithScale
    from bcosification_tpu.modules import NormedConv2d as JNormedConv2d
    from bcosification_tpu.modules import NormedLinear as JNormedLinear
    from bcosification_tpu_torch.modules import BcosConv2dWithScale, NormedConv2d, NormedLinear

    c = 6
    return {
        "NormedConv2d": (lambda: JNormedConv2d(12, kernel_size=3, padding=1),
                         lambda: NormedConv2d(c, 12, 3, padding=1), (2, 7, 6, c)),
        "NormedConv2d-scale-bias-grouped": (
            lambda: JNormedConv2d(12, kernel_size=3, stride=2, padding=1, groups=2,
                                  learned_scale=True, use_bias=True),
            lambda: NormedConv2d(c, 12, 3, stride=2, padding=1, groups=2, learned_scale=True,
                                 use_bias=True), (2, 7, 6, c)),
        "NormedConv2d-raw-scale-ignored": (
            lambda: JNormedConv2d(8, kernel_size=1, use_weight_norm=False, learned_scale=True),
            lambda: NormedConv2d(c, 8, 1, use_weight_norm=False, learned_scale=True),
            (2, 5, 5, c)),
        "NormedLinear": (lambda: JNormedLinear(9), lambda: NormedLinear(c, 9), (3, 4, c)),
        "NormedLinear-scale-nobias": (
            lambda: JNormedLinear(9, use_bias=False, learned_scale=True),
            lambda: NormedLinear(c, 9, use_bias=False, learned_scale=True), (3, c)),
        "NormedLinear-raw": (lambda: JNormedLinear(9, use_weight_norm=False),
                             lambda: NormedLinear(c, 9, use_weight_norm=False), (3, c)),
        "BcosConv2dWithScale": (lambda: JWithScale(10, kernel_size=3, padding=1),
                                lambda: BcosConv2dWithScale(c, 10, 3, padding=1),
                                (2, 6, 6, c)),
        "BcosConv2dWithScale-given-1x1": (lambda: JWithScale(10, kernel_size=1, scale=0.5),
                                          lambda: BcosConv2dWithScale(c, 10, 1, scale=0.5),
                                          (2, 6, 6, c)),
    }


@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
@pytest.mark.parametrize("case", list(_layer_cases()))
def test_layer_matches_jax(case, explain):
    """Forward and input gradient against JAX's at 1e-5, the JAX variables
    (weights, biases, scales drawn from a seed) carried across."""
    make_jax, make_port, shape = _layer_cases()[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    variables = randomized(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                           len(case))
    tmod = make_port()
    load_jax_variables(tmod, variables)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def forward_and_vjp(v, t, c):  # one jit: eager flax is slow
        y, vjp = jax.vjp(lambda tt: jmod.apply(v, tt, explain=explain), t)
        return y, vjp(c)

    shape = jax.eval_shape(lambda v, t: jmod.apply(v, t, explain=explain), jvars,
                           jnp.asarray(x)).shape
    ct = rng.standard_normal(shape).astype(np.float32)
    y, (gx,) = jax.jit(forward_and_vjp)(jvars, jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tmod(xt, explain=explain)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct))
    assert _rel(yt.detach().numpy(), y) <= 1e-5
    assert _rel(gt.numpy(), gx) <= 1e-5


def test_adaptive_avg_pool2d_matches_jax():
    from bcosification_tpu.ops import pooling as jpool
    from bcosification_tpu_torch.ops import pooling as tpool

    x = np.random.default_rng(4).standard_normal((2, 12, 6, 5)).astype(np.float32)
    for size in (1, 2, (3, 2), (12, 6)):
        want = np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), size))
        got = tpool.adaptive_avg_pool2d(torch.from_numpy(x), size).numpy()
        assert got.shape == want.shape and _rel(got, want) <= 1e-6
        torch.testing.assert_close(
            torch.from_numpy(got),
            torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                    size).permute(0, 2, 3, 1))
    with pytest.raises(AssertionError):
        tpool.adaptive_avg_pool2d(torch.from_numpy(x), 5)


def test_allnorm_resnet_matches_jax_off_k1():
    """A small ResNet of B-cos convs, ReLUs and the bias-free uncentered
    AllNorm: its norms fold into the 1x1 convs' epilogue as a (1,) mult,
    which K1 does not take: logits and W equal JAX's at 1e-5, K1 never
    called (its plain version counts on the CPU), the stride-1 1x1s on K3;
    the hand-scheduled pass refuses the net."""
    from bcosification_tpu.modules import ReLU as JReLU
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.modules import AllNormUncentered2d, NoBias, ReLU
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    kw = dict(block="bottleneck", layers=(1, 1), inplanes=8, num_classes=NUM_CLASSES)
    net = jresnet.BcosResNet(**kw, norm_layer=jnorms.NoBias(jnorms.AllNormUncentered2d),
                             act_layer=JReLU)
    variables = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 6)))
    tnet = pretrained._cnn(tresnet.BcosResNet, **kw, norm_layer=NoBias(AllNormUncentered2d),
                           act_layer=ReLU)(device="cpu")
    load_jax_variables(tnet, positive_running_var(randomized(variables, 7), 8))
    calibrate_norms(tnet, torch.from_numpy(images(1, 9)))
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tnet))
    x = images(2, 10)
    calls = {"k1": 0, "k3": 0}
    real = (bcos_conv1x1.conv1x1_fwd_plain, bcos_matmul.bcos_matmul_fwd_plain)

    def count(key, fn):
        return lambda *a, **k: calls.__setitem__(key, calls[key] + 1) or fn(*a, **k)

    bcos_conv1x1.conv1x1_fwd_plain = count("k1", real[0])
    bcos_matmul.bcos_matmul_fwd_plain = count("k3", real[1])
    try:
        with torch.no_grad():
            got = tnet(torch.from_numpy(x)).double().numpy()
        logits, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                                torch.from_numpy(x), device="cpu")
    finally:
        bcos_conv1x1.conv1x1_fwd_plain, bcos_matmul.bcos_matmul_fwd_plain = real
    stride1 = sum(1 for m in tnet.modules() if getattr(m, "kernel_size", None) == (1, 1)
                  and m.stride == (1, 1))
    assert calls == {"k1": 0, "k3": 2 * stride1}
    bias = -math.log(NUM_CLASSES - 1)
    want = jax_forward(net, variables, x)
    assert np.abs(want - bias).max() > 1e-2
    assert _rel(got - bias, want - bias) <= 1e-5
    jl, js, jw = jax_explain(net, variables, x)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), jw) <= 1e-5
    assert not fast_resnet.supports(tnet)


# --------------------------------------------------------------------------
# the VGG and ConvNeXt code paths at small size
# --------------------------------------------------------------------------
def _bias(tnet):
    return tnet.logit_layer.logit_bias


@pytest.mark.parametrize("name", list(SIZES))
def test_forward_and_w_match_jax(pairs, name):
    """Logits (their part above the logit bias) and the generic W (autograd
    of the explanation-mode module) within 1e-5 relative of JAX's, the same
    argmax; the comparison has signal (pre-logits well above rounding)."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[name]
    x = images(2, 20, SIZES[name])
    with tiny_cfg():
        want = jax_forward(net, variables, x)
        jl, js, jw = jax_explain(net, variables, x)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    bias = _bias(tnet)
    assert np.abs(want - bias).max() > (1e-32 if name == "vgg_plain" else 1e-2)
    assert _rel(got - bias, want - bias) <= 1e-5
    logits, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                            torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), jw) <= 1e-5
    assert _rel(logits.double().numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5


@pytest.mark.parametrize("name", list(SIZES))
def test_fast_pass_equals_the_generic_w(pairs, name):
    """The family's hand-scheduled pass against the module path's autograd W
    and logits at 1e-5, for the predicted and a given class; one K3 and one
    K2 call per stride-1 1x1 conv (the plain versions count on the CPU), no
    K1; no other pass takes the net."""
    from bcosification_tpu_torch.explain import fast_densenet, fast_vit
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    _, _, tnet = pairs[name]
    fast = FAST[name]
    others = [p for p in (fast_resnet, fast_densenet, fast_vgg, fast_convnext, fast_vit)
              if p is not fast]
    assert fast.supports(tnet) and not any(p.supports(tnet) for p in others)
    xt = torch.from_numpy(images(2, 21, SIZES[name]))
    calls = {"fwd": 0, "bwd": 0, "matmul": 0}
    real = (bcos_conv1x1.conv1x1_fwd_plain, bcos_conv1x1.conv1x1_bwd_explain_plain,
            bcos_matmul.bcos_matmul_fwd_plain)

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    k1x1 = sum(1 for mod in tnet.modules() if getattr(mod, "kernel_size", None) == (1, 1)
               and mod.stride == (1, 1))
    assert k1x1 == (2 if name.startswith("vgg") else 9)
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
        bias = _bias(tnet)
        assert _rel(fl.double().numpy() - bias, ml.double().numpy() - bias) <= 1e-5
        assert calls == {"fwd": 0, "bwd": k1x1, "matmul": k1x1}


@pytest.mark.parametrize("name", list(SIZES))
def test_export_explain_round_trip(pairs, name):
    """``export_explain`` serves the small VGG and ConvNeXt: the program
    loaded from bytes gives the eager pass's logits and W."""
    from bcosification_tpu_torch import serving

    _, _, tnet = pairs[name]
    program = serving.load_serialized(serving.export_explain(tnet, input_size=SIZES[name],
                                                             device="cpu"))
    xt = torch.from_numpy(images(3, 22, SIZES[name]))
    logits, sel, w = program.call(xt)
    el, es, ew = FAST[name].fast_dynamic_linear_weights(tnet, xt, device="cpu")
    assert torch.equal(sel, es)
    assert _rel(w.numpy(), ew.numpy()) <= 1e-6 and _rel(logits.numpy(), el.numpy()) <= 1e-6


@pytest.mark.parametrize("name", list(SIZES))
def test_bf16_fast_pass_and_export_equal_the_module_path(pairs, name):
    """In bf16 the hand-scheduled pass and its exported program give the
    module path's autograd W and logits bit for bit: ConvNeXt's layer_scale
    and the uncentered BN's affine are applied to the cotangent in the
    dtypes the modules use (a K2 mult in f32 rounds differently)."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    _, _, tnet = pairs[name]
    xt = torch.from_numpy(images(2, 23, SIZES[name])).to(torch.bfloat16)
    ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
    program = serving.load_serialized(serving.export_explain(
        tnet, input_size=SIZES[name], dtype=torch.bfloat16, device="cpu"))
    for logits, sel, w in (FAST[name].fast_dynamic_linear_weights(tnet, xt, device="cpu"),
                           program.call(xt)):
        assert w.dtype == mw.dtype == torch.bfloat16
        assert torch.equal(sel, ms) and torch.equal(w, mw) and torch.equal(logits, ml)


def test_no_pool_and_layer_scale_init():
    """VGG's no_pool (each pool folded into the previous conv's stride) and a
    ConvNeXt at its init (layer_scale 1e-6: every block the identity to
    1e-6) in the forward against JAX at 1e-5; the fast VGG pass takes
    no_pool."""
    with tiny_cfg():
        net = jvgg.BcosVGG(cfg=TINY, num_classes=NUM_CLASSES, no_pool=True)
        variables = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)))
        tnet = port_net("vgg_bnu", no_pool=True)
        load_jax_variables(tnet, positive_running_var(randomized(variables, 30), 31))
        calibrate_norms(tnet, torch.from_numpy(images(1, 32, 16)))
        variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tnet))
        x = images(2, 33, 16)
        want = jax_forward(net, variables, x)
    assert [m.stride for m in tnet.modules() if getattr(m, "kernel_size", None) == (3, 3)] \
        == [(2, 2), (2, 2), (1, 1), (2, 2), (2, 2)]
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    bias = _bias(tnet)
    assert np.abs(want - bias).max() > 1e-2 and _rel(got - bias, want - bias) <= 1e-5
    assert fast_vgg.supports(tnet)
    net = jax_net("convnext_pn")
    variables = initialize(net, jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 6)))
    tnet = port_net("convnext_pn")
    assert all(float(b.layer_scale.abs().max()) == pytest.approx(1e-6)
               for b in tnet.blocks(0) + tnet.blocks(1))
    load_jax_variables(tnet, jax.tree_util.tree_map(np.asarray, variables))
    x = images(2, 34)
    want = jax_forward(net, variables, x)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    assert _rel(got - bias, want - bias) <= 1e-5


# --------------------------------------------------------------------------
# the registry's VGGs and ConvNeXts at full width, by shapes only
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", VGG_CONVNEXT_NAMES)
def test_meta_build_shapes_match_jax(name):
    """``load_model(name)`` under abstract_init builds on the meta device (no
    memory, no init) with the state-dict shapes of the JAX tree (conv
    kernels as OIHW); the registry holds all 15 names."""
    from bcosification_tpu_torch.utils.init_mode import abstract_init

    assert len(VGG_CONVNEXT_NAMES) == 15
    with abstract_init():
        net = pretrained.load_model(name, pretrained=False)
    state = net.state_dict()
    assert all(t.device.type == "meta" for t in state.values())
    assert {k: tuple(t.shape) for k, t in state.items()} == _jax_shapes(name)
