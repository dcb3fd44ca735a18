"""Training of the port's ViTs against the JAX package on the CPU, on the
same weights and batches (numpy, from a seed): the small ViT of
tests/test_torch_vit.py (dim 32, depth 2, 2 heads, mlp 64, patch 8, 32x32,
10 classes) under the vit_bcosification recipe, the softmax cross-entropy
of the standard baselines, and the train and evaluate commands over a
synthetic JPEG folder for one config of each ViT grid.

Each module that trains in the vit_bcosification trunk is held to the JAX
module in train mode (forward, input and parameter VJPs, 1e-5; bf16 within
its rounding). A step is held to the JAX ``make_train_step`` through the
loss (1e-5 relative) and Adam's first moment, 0.1 times the (clipped)
gradient, leaf by leaf within 1e-5 of its own norm: on these nets 1e-7 relative input
noise moves a leaf's first moment by at most 1.1e-6 of its norm (measured
on the four variants here and the four vit_final nets), and the port lies
at most 1.6e-6 from JAX. Adam's first update is lr * g / (|g| + 1e-8),
lr times the sign of g, at the schedule's step-0 lr (1e-4 for these
vit_bcosification configs, 1e-5 after vit_final's warm-up decay): every
element whose first moment exceeds 1e-3 of its leaf's largest takes JAX's
step within 2e-3 lr plus one fp32 spacing of the parameter (the two
packages round the updated parameter apart by at most that), and no
element moves by more than 1.01 lr (an element whose gradient is rounding
noise steps either way; tests/test_torch_kd.py's method). AdamW's
decoupled decay, lr * wd * p = 1e-9 p for the standard baselines, lies
under the rounding of one fp32 step, so it is held apart in float64: one
port optimizer step of zero gradients at the schedule's step-0 lr against
the JAX transform's update of zero gradients, leaf by leaf within 1e-6
(both zero for Adam). The bf16 amp gradients are held by the method of
tests/test_torch_training.py: per leaf, the port's distance from the JAX
fp32 gradient at most twice the JAX amp gradient's own, and the amp step's
loss within 1e-2 of JAX's.

``step_parity`` and ``amp_parity`` are shared with
tests/test_torch_vit_final.py.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_training import _rel
from test_torch_vit import BASE, config_name, images, small_arch, vit_pair
from test_torch_vit import jparams as jvb_params
from test_torch_vit import tparams as tvb_params

torch.set_num_threads(1)
LABEL = np.array([1, 3], np.int32)
# mixup's targets: class probabilities
SOFT = np.zeros((2, 10), np.float32)
SOFT[0, [1, 4]] = (0.7, 0.3)
SOFT[1, [3, 8]] = (0.4, 0.6)
VARIANTS = [("gelu", "noBias"), ("gelu", "useBias"), ("noGelu", "noBias"),
            ("noGelu", "useBias")]


def flat(tree, prefix=()):
    """{leaf path "a/b/c": float64 array} of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float64)
    return out


def _first_moment(opt_state):
    """The flat Adam first moment inside an optax state."""
    if hasattr(opt_state, "mu"):
        return flat(opt_state.mu)
    children = (opt_state.values() if isinstance(opt_state, dict)
                else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for child in children:
        found = _first_moment(child)
        if found is not None:
            return found
    return None


def _jax_layout(t):
    a = t.detach().double().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _recipe(config):
    """(criterion, optimizer factory, schedule, use_agc, gradient_clip_val)
    of an experiment config, the schedule at 10 steps per epoch."""
    opt = config["optimizer"]
    return (config["criterion"], opt, config["lr_scheduler"].create(opt.lr, 10),
            config.get("use_agc", False), (config.get("trainer") or {}).get("gradient_clip_val"))


def _port_step(tnet, config, x, label, amp=False):
    """(loss, grad_norm, {leaf path: Adam's first moment}, {leaf path:
    updated parameter}) of one port step of the config's recipe on a copy of
    ``tnet``."""
    from bcosification_tpu_torch.training import steps

    criterion, opt, schedule, use_agc, clip = _recipe(config)
    state = steps.create_train_state(tnet, opt.create, device="cpu")
    step = steps.make_train_step(criterion, schedule, use_agc=use_agc, gradient_clip_val=clip,
                                 amp=amp)
    state, metrics = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(label)})
    assert state.step == 1
    params = {n.replace(".", "/"): p for n, p in state.model.named_parameters()}
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            {k: _jax_layout(state.optimizer.state[p]["exp_avg"]) for k, p in params.items()},
            {k: _jax_layout(p) for k, p in params.items()})


def _decay_parity(tnet, jconfig, tconfig, params):
    """AdamW's decoupled decay (see the module docstring): the port's
    float64 optimizer step of zero gradients at the step-0 lr against the
    JAX transform's update of zero gradients."""
    from bcosification_tpu_torch.optim.optimizer_factory import set_lr
    from bcosification_tpu_torch.training import steps

    _, jopt, jschedule, _, _ = _recipe(jconfig)
    tx = jopt.create(jschedule, params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    want, _ = tx.update(zeros, tx.init(params), params)
    _, topt, tschedule, _, _ = _recipe(tconfig)
    state = steps.create_train_state(copy.deepcopy(tnet).double(), topt.create,
                                     device="cpu")
    before = {n.replace(".", "/"): _jax_layout(p).copy()  # not a view of p
              for n, p in state.model.named_parameters()}
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    set_lr(state.optimizer, tschedule(0))
    state.optimizer.step()
    got = {n.replace(".", "/"): _jax_layout(p) - before[n.replace(".", "/")]
           for n, p in state.model.named_parameters()}
    want = flat(want)
    assert sorted(got) == sorted(want)
    decays = jconfig["optimizer"].name.lower() == "adamw"
    for name, u in want.items():
        assert (np.linalg.norm(u) > 0) == decays, name
        assert np.linalg.norm(got[name] - u) <= 1e-6 * np.linalg.norm(u), name


def step_parity(net, variables, tnet, jconfig, tconfig, x, label):
    """One fp32 step of the recipe, JAX ``make_train_step`` against the
    port's, and the optimizer's decay (see the module docstring); returns
    the step's gradient norm."""
    from bcosification_tpu.training import steps as jsteps

    criterion, opt, schedule, use_agc, clip = _recipe(jconfig)
    tx = opt.create(schedule, variables["params"])
    jstep = jsteps.make_train_step(net, criterion, tx, use_agc=use_agc, gradient_clip_val=clip,
                                   donate=False)
    jstate, jm = jstep(jsteps.create_train_state(variables, tx),
                       {"image": jnp.asarray(x), "label": jnp.asarray(label)})
    loss, grad_norm, mu, params = _port_step(tnet, tconfig, x, label)
    assert abs(loss - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(grad_norm - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    want = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in _first_moment(jstate.opt_state).items()}
    before, want_p = flat(variables["params"]), flat(jstate.params)
    assert sorted(mu) == sorted(want) == sorted(want_p)
    lr = float(schedule(0))
    assert lr > 0
    for name, m in want.items():
        assert np.linalg.norm(m) > 0, name
        assert _rel(mu[name], m) <= 1e-5, name
        du_want, du_got = want_p[name] - before[name], params[name] - before[name]
        spacing = np.spacing(np.abs(want_p[name]).astype(np.float32)).astype(np.float64)
        signal = np.abs(m) > 1e-3 * np.abs(m).max()
        assert np.all((np.abs(du_got - du_want) <= 2e-3 * lr + spacing)[signal]), name
        assert np.all(np.abs(du_got) <= 1.01 * lr + spacing), name
    _decay_parity(tnet, jconfig, tconfig, variables["params"])
    return grad_norm


def _jax_grads(net, variables, criterion, x, label, amp):
    """(loss, {leaf path: gradient}) of one train-mode forward of the JAX
    net (the image in bf16 under amp, as the JAX step casts it)."""
    def loss_fn(params):
        image = jnp.asarray(x).astype(jnp.bfloat16) if amp else jnp.asarray(x)
        out = net.apply({**variables, "params": params}, image, train=True)
        return criterion(out.astype(jnp.float32), jnp.asarray(label))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), flat(grads)


def amp_parity(net, variables, tnet, jconfig, tconfig, x, label):
    """The bf16 amp gradients leaf by leaf and the amp step's loss (see the
    module docstring) on images rounded to bf16."""
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jloss, want_amp = _jax_grads(net, variables, jconfig["criterion"], x, label, amp=True)
    _, want_fp32 = _jax_grads(net, variables, jconfig["criterion"], x, label, amp=False)
    m = copy.deepcopy(tnet).requires_grad_(True)
    out = m(torch.from_numpy(x).to(torch.bfloat16), train=True).float()
    tconfig["criterion"](out, torch.from_numpy(label)).backward()
    got = {n.replace(".", "/"): _jax_layout(p.grad) for n, p in m.named_parameters()}
    assert sorted(got) == sorted(want_amp)
    for name in want_amp:
        jax_spread = _rel(want_amp[name], want_fp32[name])
        assert 0 < jax_spread, name
        assert _rel(got[name], want_fp32[name]) <= 2 * jax_spread, name
    loss = _port_step(tnet, tconfig, x, label, amp=True)[0]
    assert abs(loss - jloss) <= 1e-2 * abs(jloss)


@pytest.fixture(scope="module")
def pairs():
    return {v: vit_pair(config_name(*v)) for v in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS, ids=["-".join(v) for v in VARIANTS])
def test_train_step_matches_jax(pairs, variant):
    """One fp32 step of the vit_bcosification recipe (Adam, the cosine with
    no warm-up, AGC, UniformOffLabels BCE) on each gelu/noGelu x
    useBias/noBias variant: to_qkv plain, the f32 LayerNorm, the GELU gate,
    a biased B-cos linear on the plain path, a bias-free one on K3 forward
    and ``bcos_matmul_bwd`` backward."""
    name = config_name(*variant)
    net, variables, tnet = pairs[variant]
    step_parity(net, variables, tnet, jvb_params.CONFIGS[name], tvb_params.CONFIGS[name],
                images(2, 20), LABEL)


@pytest.mark.parametrize("variant", [("gelu", "noBias"), ("noGelu", "useBias")],
                         ids=["default", "useBias-noGelu"])
def test_amp_gradients_within_twice_jax(pairs, variant):
    """bf16 amp; with useBias the biased patch embedding promotes the trunk to
    f32 in both packages."""
    name = config_name(*variant)
    net, variables, tnet = pairs[variant]
    amp_parity(net, variables, tnet, jvb_params.CONFIGS[name], tvb_params.CONFIGS[name],
               images(2, 21), LABEL)


def _train_mode_cases():
    """(id, JAX module, port module, input shape): the vit_bcosification
    trunk's modules that train: the f32 LayerNorm, the GELU gate, a biased
    BcosifyLinear (useBias: the plain path) and a bias-free one (K3 forward,
    ``bcos_matmul_bwd`` backward), each at (in 16, out 24)."""
    from bcosification_tpu.modules import BcosifyLinear as JBcosifyLinear
    from bcosification_tpu.modules import activations as jact
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.modules import BcosifyLinear, activations, norms

    shape = (3, 7, 16)
    return [
        ("DetachableLayerNorm", jnorms.DetachableLayerNorm(features=16),
         norms.DetachableLayerNorm(16), shape),
        ("DetachableGELU", jact.DetachableGELU(), activations.DetachableGELU(), shape),
        ("BcosifyLinear-useBias", JBcosifyLinear(24, use_bias=True),
         BcosifyLinear(16, 24, use_bias=True), shape),
        ("BcosifyLinear-noBias", JBcosifyLinear(24), BcosifyLinear(16, 24), shape),
    ]


@pytest.mark.parametrize("case", _train_mode_cases(), ids=lambda c: c[0])
def test_train_mode_modules_match_jax(case):
    """Each module in train mode (``train=True``, no explain): the forward
    and the input and parameter VJPs against the JAX module on the same
    inputs and parameters (1e-5); and in bf16 the forward and input VJP
    within bf16's rounding (2e-2 relative) of JAX's."""
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

    _, jm, tm, shape = case
    rng = np.random.default_rng(15)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {k: (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
              for k, v in variables.get("params", {}).items()}
    load_jax_variables(tm, {"params": params})
    tm.requires_grad_(True)
    out_shape = jm.apply({"params": params}, jnp.asarray(x)).shape
    ct = rng.standard_normal(out_shape).astype(np.float32)
    for dtype, tol in ((np.float32, 1e-5), (jnp.bfloat16, 2e-2)):
        xj = jnp.asarray(x).astype(dtype)
        want, vjp = jax.vjp(lambda p, t: jm.apply({"params": p}, t, train=True), params, xj)
        want_p, want_x = vjp(jnp.asarray(ct).astype(want.dtype))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32).requires_grad_(True)
        tm.zero_grad()
        got = tm(xt, train=True)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        got.backward(torch.from_numpy(ct).to(got.dtype))
        assert _rel(got.detach().float(), np.asarray(want, np.float32)) <= tol
        assert _rel(xt.grad.float(), np.asarray(want_x, np.float32)) <= tol
        if dtype is np.float32:
            for k, g in want_p.items():
                assert _rel(getattr(tm, k).grad, g) <= 1e-5, k


# --------------------------------------------------------------------------
# the softmax cross-entropy of the standard baselines
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("target", ["indices", "probabilities"])
def test_cross_entropy_loss_matches_jax(target, smoothing):
    """``CrossEntropyLoss`` with integer labels and with mixup's class
    probabilities, with and without label smoothing: the loss and its
    gradient (1e-6), and the sum and per-sample reductions."""
    from bcosification_tpu.losses import CrossEntropyLoss as JCE
    from bcosification_tpu_torch.losses import CrossEntropyLoss as TCE

    rng = np.random.default_rng(12)
    x = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    if target == "indices":
        t = rng.integers(0, 10, 6).astype(np.int32)
    else:
        t = rng.dirichlet(np.full(10, 0.3), 6).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        jloss = JCE(label_smoothing=smoothing, reduction=reduction)
        tloss = TCE(label_smoothing=smoothing, reduction=reduction)
        want = np.asarray(jloss(jnp.asarray(x), jnp.asarray(t)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = tloss(xt, torch.from_numpy(t))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
        if reduction == "mean":
            got.backward()
            want_g = jax.grad(lambda v: jloss(v, jnp.asarray(t)))(jnp.asarray(x))
            np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                                       atol=1e-7)
    assert TCE().__to_config__() == JCE().__to_config__()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_function_matches_jax(reduction):
    """The integer-label cross-entropy (CrossEntropyLoss's label branch)."""
    from bcosification_tpu.losses import cross_entropy as jce
    from bcosification_tpu_torch.losses import cross_entropy as tce

    rng = np.random.default_rng(13)
    x = (3 * rng.standard_normal((7, 5))).astype(np.float32)
    labels = np.array([0, 2, 4, 2, 1, 3, 2], np.int32)
    want = np.asarray(jce(jnp.asarray(x), jnp.asarray(labels), reduction))
    got = tce(torch.from_numpy(x), torch.from_numpy(labels), reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the train and evaluate commands
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from bcosification_tpu_torch.data.synthetic import write_imagenet_tree

    root = tmp_path_factory.mktemp("imagenet")
    write_imagenet_tree(root, 3, 16, 10, sizes=((56, 48), (48, 60)), seed=1)
    return str(root)


def _small_data(config, is_bcos):
    """The config with its data at 32x32 crops, batch 8 and 2 workers."""
    from bcosification_tpu_torch.data import presets
    from bcosification_tpu_torch.experiments.utils.config_utils import update_config

    return update_config(config, {"data": dict(
        train_transform=presets.ImageNetClassificationPresetTrain(crop_size=32,
                                                                  is_bcos=is_bcos),
        test_transform=presets.ImageNetClassificationPresetEval(crop_size=32, resize_size=36,
                                                                is_bcos=is_bcos),
        batch_size=8, num_workers=2)})


@pytest.mark.parametrize("grid,name", [("vit_bcosification", BASE),
                                       ("vit_final", "bcos_vitc_ti_patch1_14"),
                                       ("vit_final", "vitc_ti_patch1_14")])
def test_train_fast_dev_run_and_evaluate(tree, tmp_path, monkeypatch, grid, name):
    """``train --fast_dev_run`` (``run_training`` on the CPU) of a config of
    each ViT grid at the small size over a synthetic JPEG folder (3 classes,
    16 train and 10 val images): one step, the metrics and a checkpoint;
    then ``evaluate --reload last`` reproduces the logged accuracies."""
    import test_torch_vit_final as final

    from bcosification_tpu_torch import evaluate as tevaluate
    from bcosification_tpu_torch import settings as tsettings
    from bcosification_tpu_torch import train as ttrain
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.training.trainer import run_training

    configs = tvb_params.CONFIGS if grid == "vit_bcosification" else final.tparams.CONFIGS
    monkeypatch.setitem(configs, name, _small_data(configs[name], "vitc_" not in name
                                                   or name.startswith("bcos_")))
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", tree)
    base = ["--base_network", grid, "--experiment_name", name, "--base_directory",
            str(tmp_path)]
    small = small_arch() if grid == "vit_bcosification" else final.small_archs()
    with small, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no hub checkpoint: random init
        state = run_training(ttrain.get_parser().parse_args(
            ["--dataset", "ImageNet", *base, "--fast_dev_run"]), device="cpu")
        top1, top5, (_, _, n) = tevaluate.run_evaluation(
            tevaluate.get_parser().parse_args([*base, "--reload", "last"]), device="cpu")
    assert state.step == 1
    exp = Experiment("ImageNet", grid, name)
    assert exp.available_checkpoints() == [0]
    logged = exp.load_metrics()
    assert np.isfinite(logged["train_loss"][-1][1])
    assert n == 10 and (top1, top5) == (logged["val_acc1"][-1][1], logged["val_acc5"][-1][1])
