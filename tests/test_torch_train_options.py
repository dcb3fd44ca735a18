"""The training options that no grid config sets, the port against the JAX
package on the CPU in fp32, on the same weights and inputs (numpy, from a
seed): gradient accumulation (``optax.MultiSteps`` in the JAX trainer's
``_make_optimizers``) on the small flagship, the learnable-b variants of
the Bcosify layers (``b_loss``, ``clamping`` with the manual-optim b
optimizer, the ``linear_b`` and ``b_interpolation`` schedules) through the
JAX train step, the b schedules themselves, the bcosified nets' input
normalisation under ``clip_kd``, ``linearprobe_clip`` and
``bfy_mean_zero``, and the learnable ``b`` leaves carried between the
packages."""
import types

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen

from torch_port_helpers import FLAGSHIP_CONFIG, NUM_CLASSES, small_pair

torch.set_num_threads(1)
LAYERS = ("bottleneck", (1, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the calls into the kernels' wrappers (K1's fused conv, K3's
    matmul) by the modules; on the CPU a wrapper runs its plain version."""
    from bcosification_tpu_torch.modules import bcos_layers
    from bcosification_tpu_torch.ops.cuda import bcos_matmul

    calls = {"k1": 0, "k3": 0}

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(bcos_layers, "bcos_conv1x1_bn_act",
                        counting("k1", bcos_layers.bcos_conv1x1_bn_act))
    monkeypatch.setattr(bcos_matmul, "bcos_matmul", counting("k3", bcos_matmul.bcos_matmul))
    return calls


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _assert_state(tstate, jstate, atol=1e-5, ema=False):
    """The port's parameters (and EMA) against the JAX state's: params
    within ``atol`` absolute, batch statistics 1e-5 relative."""
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables

    pairs = [(tstate.model, jstate.params, jstate.batch_stats)]
    if ema:
        pairs.append((tstate.ema, jstate.ema_params, jstate.ema_batch_stats))
    for model, params, stats in pairs:
        got = to_jax_variables(model)
        for coll, tree in (("params", params), ("batch_stats", stats)):
            want = dict(_leaves(jax.tree_util.tree_map(np.asarray, tree)))
            mine = dict(_leaves(got[coll]))
            assert set(mine) == set(want)
            for name, arr in mine.items():
                if coll == "params":
                    np.testing.assert_allclose(arr, want[name], rtol=0, atol=atol, err_msg=name)
                else:
                    np.testing.assert_allclose(arr, want[name], rtol=1e-5, err_msg=name)


# --------------------------------------------------------------------------
# gradient accumulation on the small flagship
# --------------------------------------------------------------------------
def _config(port, **extra):
    if port:
        from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    else:
        from bcosification_tpu.optim import LRSchedulerFactory, OptimizerFactory
    config = dict(optimizer=OptimizerFactory("Adam", 1e-3),
                  lr_scheduler=LRSchedulerFactory(name="cosineannealinglr", epochs=4,
                                                  warmup_epochs=1, warmup_method="linear",
                                                  interval="step"),
                  trainer={}, model={})
    config.update(extra)
    return config


def _micro_batch(size, seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1), rng.integers(0, NUM_CLASSES, n).astype(np.int32)


def test_accumulated_steps_match_multisteps():
    """accumulate_grad_batches=2 over 4 micro-batches of the small flagship
    (Adam + cosine with warmup, AGC, EMA): the JAX trainer's
    ``_make_optimizers`` (``optax.MultiSteps``) and train step against the
    port's. After each micro-step the parameters, batch statistics and EMA
    agree within 1e-5 (absolute for parameters, as the single-step parity);
    the first micro-step leaves the parameters as they were, the optimizer
    steps once per 2, and the logged schedule is the optimizer step's,
    indexed by micro-step (1e-6: the port's schedule is f64, JAX's f32)."""
    from bcosification_tpu.losses import UniformOffLabelsBCEWithLogitsLoss as JL
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu.training import trainer as jtrainer
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss as TL
    from bcosification_tpu_torch.training import steps as tsteps
    from bcosification_tpu_torch.training import trainer as ttrainer

    net, variables, tnet, _ = small_pair("resnet50", LAYERS, 32)
    accum, steps_per_epoch = 2, 8
    jcfg = _config(False, trainer={"accumulate_grad_batches": accum})
    tx, b_tx, jsched = jtrainer._make_optimizers(types.SimpleNamespace(config=jcfg),
                                                 variables["params"], steps_per_epoch)
    assert b_tx is None
    tcfg = _config(True, trainer={"accumulate_grad_batches": accum})
    factory, b_factory, tsched = ttrainer._make_optimizers(tcfg, steps_per_epoch)
    assert b_factory is None
    # the port's schedule is f64, the JAX one f32: 1e-6 relative
    np.testing.assert_allclose([tsched(s) for s in range(2 * steps_per_epoch)],
                               [float(jsched(s)) for s in range(2 * steps_per_epoch)], rtol=1e-6)

    jstep = jsteps.make_train_step(net, JL(), tx, use_agc=True, ema_decay=0.9,
                                   ema_steps=accum, donate=False)
    jstate = jsteps.create_train_state(variables, tx, with_ema=True)
    tstep = tsteps.make_train_step(TL(), tsched, use_agc=True, ema_decay=0.9, ema_steps=accum,
                                   accumulate=accum)
    tstate = tsteps.create_train_state(tnet, factory.create, with_ema=True)
    before = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    for i in range(4):
        x, label = _micro_batch(32, seed=20 + i)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(label)})
        tstate, tm = tstep(tstate, {"image": _t(x), "label": _t(label)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        _assert_state(tstate, jstate, ema=True)
        opt_steps = {int(s["step"]) for s in tstate.optimizer.state.values()}
        assert tstate.mini_step == (i + 1) % accum
        assert opt_steps == ({(i + 1) // accum} if i + 1 >= accum else set())
        if i == 0:
            assert all(torch.equal(p, before[n]) for n, p in tstate.model.named_parameters())
    assert tstate.step == int(jstate.step) == 4


# --------------------------------------------------------------------------
# learnable b through the train step
# --------------------------------------------------------------------------
class JaxTinyB(linen.Module):
    """A 3x3 and a 1x1 BcosifyConv2d around a bias-free uncentered BN, the
    learnable-b variant of ``kw``, on the spatial mean."""

    kw: dict

    @linen.compact
    def __call__(self, x, *, train=False, explain=False):
        from bcosification_tpu.modules import BcosifyConv2d, norms

        f = dict(train=train, explain=explain)
        x = BcosifyConv2d(features=8, kernel_size=3, padding=1, name="conv_a", **self.kw)(x, **f)
        x = norms.NoBias(norms.BatchNormUncentered2d)(features=8, name="bn")(x, **f)
        x = BcosifyConv2d(features=4, kernel_size=1, name="conv_b", **self.kw)(x, **f)
        return x.mean(axis=(1, 2))


class TinyB(nn.Module):
    """The port's twin of ``JaxTinyB``."""

    def __init__(self, **kw):
        super().__init__()
        from bcosification_tpu_torch.modules import (BatchNormUncentered2d, BcosifyConv2d,
                                                     NoBias)

        self.conv_a = BcosifyConv2d(6, 8, 3, padding=1, **kw)
        self.bn = NoBias(BatchNormUncentered2d)(8)
        self.conv_b = BcosifyConv2d(8, 4, 1, **kw)

    def forward(self, x, *, train=False, explain=False):
        f = dict(train=train, explain=explain)
        return self.conv_b(self.bn(self.conv_a(x, **f), **f), **f).mean(dim=(1, 2))


def _tiny_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    x = rng.random((n, 8, 8, 6)).astype(np.float32) * 0.1
    x[np.arange(n), :, :, labels] += 0.8
    return x, labels


B_CASES = {
    # (layer variant, bcosify_args, extra config); Adam without the b split
    # trains b with the main optimizer
    "learn_b": ({"b_loss": True}, {}, {}),
    "clamping_manual_optim": ({"clamping": True}, {"manual_optim": True}, {"bcosify": True}),
    "linear_b": ({"clamping": True}, {"linear_b": True, "b_lr": 0.01}, {"bcosify": True}),
    "b_interpolation": ({"clamping": True}, {"b_interpolation": True}, {"bcosify": True}),
}


@pytest.mark.parametrize("case", sorted(B_CASES))
def test_learnable_b_steps_match_jax(case, kernel_calls):
    """Three train steps (AGC, the recipe's BCE) of the tiny learnable-b
    net from the same weights, the JAX trainer's optimizers and b schedule
    against the port's: loss 1e-5 relative, parameters 1e-5 absolute, and
    at each step the b gradients against JAX's on the port's weights of
    that step, 1e-4 relative: JAX's f32 b gradient is the less accurate of
    the two (at b = 2 on the first batch it is 7.6e-5 from its own f64
    value, the port's f32 one 2.5e-6); a scheduled b equals the schedule
    bit for bit. No hand-written kernel runs on a tensor b."""
    from bcosification_tpu.losses import UniformOffLabelsBCEWithLogitsLoss as JL
    from bcosification_tpu.optim import OptimizerFactory as JOF
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu.training import trainer as jtrainer
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss as TL
    from bcosification_tpu_torch.optim import OptimizerFactory as TOF
    from bcosification_tpu_torch.training import steps as tsteps
    from bcosification_tpu_torch.training import trainer as ttrainer

    kw, bargs, opt_args = B_CASES[case]
    x0, _ = _tiny_batch(0)
    jnet = JaxTinyB(kw)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0),
                                                             jnp.asarray(x0), train=True))
    assert "b" in variables["params"]["conv_a"]
    tnet = TinyB(**kw)
    load_jax_variables(tnet, variables)
    assert tnet.conv_a.b.shape == () and tnet.conv_a.b.dtype == torch.float32

    total, batch = 10, 8
    model = {"bcosify_args": bargs}
    jcfg = dict(optimizer=JOF("Adam", 5e-3, **opt_args), model=model, trainer={},
                b_optimizer=JOF("SGD", 0.5))
    tcfg = dict(optimizer=TOF("Adam", 5e-3, **opt_args), model=model, trainer={},
                b_optimizer=TOF("SGD", 0.5))
    tx, b_tx, jsched = jtrainer._make_optimizers(types.SimpleNamespace(config=jcfg),
                                                 variables["params"], 4)
    factory, b_factory, tsched = ttrainer._make_optimizers(tcfg, 4)
    assert (b_tx is None) == (b_factory is None) == (case != "clamping_manual_optim")
    jb = None
    if bargs.get("linear_b"):
        jb = jsteps.make_linear_b_schedule(b_lr=0.01, batch_size=batch)
    elif bargs.get("b_interpolation"):
        def jb(step):
            return 1.0 + jnp.clip(step / total, 0.0, 1.0)
    tb = ttrainer._b_schedule(tcfg, batch, total)
    assert (jb is None) == (tb is None)
    if tb is not None:
        for s in range(total + 3):
            assert np.float32(tb(s)) == np.float32(jb(jnp.int32(s))), s

    jstep = jsteps.make_train_step(jnet, JL(), tx, b_tx, use_agc=True, b_schedule=jb,
                                   donate=False)
    jstate = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx, b_tx)
    tstep = tsteps.make_train_step(TL(), tsched, use_agc=True, b_schedule=tb)
    tstate = tsteps.create_train_state(
        tnet, factory.create, make_b_optimizer=None if b_factory is None else b_factory.create)
    assert (tstate.b_optimizer is None) == (b_factory is None)

    def jloss(params, stats, xx, ll):
        out, _ = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(xx),
                            train=True, mutable=["batch_stats"])
        return JL()(out.astype(jnp.float32), jnp.asarray(ll))

    for i in range(3):
        x, label = _tiny_batch(10 + i)
        # the JAX gradient on the port's weights of this step
        carried = to_jax_variables(tstate.model)
        params = carried["params"] if jb is None else jsteps.set_b_params(
            carried["params"], jb(jnp.int32(i)))
        jgrad = jax.grad(jloss)(params, carried["batch_stats"], x, label)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(label)})
        tstate, tm = tstep(tstate, {"image": _t(x), "label": _t(label)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        if tstate.b_optimizer is None:  # .grad holds what the main optimizer took
            jgrad = jagc.adaptive_clip_grads(params, jgrad)
        for conv in ("conv_a", "conv_b"):
            # with the b optimizer, .grad of b is the raw gradient it took
            got = float(getattr(tstate.model, conv).b.grad)
            want = float(jgrad[conv]["b"])
            assert abs(got - want) <= 1e-4 * abs(want) + 1e-9, (conv, got, want)
        _assert_state(tstate, jstate)
        if tb is not None:
            assert tstate.model.conv_a.b.item() == np.float32(tb(i + 1))
    assert kernel_calls == {"k1": 0, "k3": 0}


@pytest.mark.parametrize("start,end,b_lr,world,batch,steps", [
    (1, 2, 1e-4, 1, 64, 40), (1, 2, 1e-4, 4, 16, 40), (1, 2, 0.01, 4, 2, 20),
    (1.5, 2.5, 0.02, 1, 8, 15), (2, 2, 0.1, 1, 8, 5)])
def test_linear_b_schedule_matches_jax(start, end, b_lr, world, batch, steps):
    """The closed form in f32 against the JAX one, bit for bit, before,
    across and after the freeze (the cases of test_b_schedule_parity.py and
    a start already at the end)."""
    from bcosification_tpu.training.steps import make_linear_b_schedule as jax_sched
    from bcosification_tpu_torch.training.steps import make_linear_b_schedule

    want = jax_sched(start, end, b_lr, world, batch)
    got = make_linear_b_schedule(start, end, b_lr, world, batch)
    for k in range(steps + 5):
        assert np.float32(got(k)) == np.asarray(want(jnp.int32(k))), k


# --------------------------------------------------------------------------
# the engine: learnable b and the input normalisation
# --------------------------------------------------------------------------
NORMS = {
    "clip_kd": ({"clip_kd": True}, {}),
    "clip_kd_mean_zero": ({"clip_kd": True}, {"bfy_mean_zero": True}),
    "linearprobe_clip": ({"linearprobe_clip": True}, {}),
    "imagenet": ({}, {"bfy_mean_zero": True}),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_normalization_of_the_bcosified_nets(case):
    """build_bcosified_resnet and build_bcosified_densenet take their
    Normalize constants from the flags as the JAX engine reads them."""
    from bcosification_tpu.models.bcosify_net import normalization_for
    from bcosification_tpu_torch.bcosify.engine import (build_bcosified_densenet,
                                                        build_bcosified_resnet)

    bargs, top = NORMS[case]
    config = {**FLAGSHIP_CONFIG, "name": "resnet50",
              "bcosify_args": {**FLAGSHIP_CONFIG["bcosify_args"], **bargs}, **top}
    want = normalization_for(clip_kd=bool(bargs.get("clip_kd", False)),
                             linearprobe_clip=bool(bargs.get("linearprobe_clip", False)),
                             bfy_mean_zero=bool(top.get("bfy_mean_zero", False)))
    net = build_bcosified_resnet(config, num_classes=NUM_CLASSES, inplanes=8, layers=LAYERS,
                                 device="cpu")
    dense = build_bcosified_densenet(
        {**config, "name": "densenet121"}, num_classes=NUM_CLASSES, device="cpu",
        arch_cfg=dict(growth_rate=8, block_config=(1, 1), num_init_features=8, bn_size=2))
    for m in (net, dense):
        assert (m.mean, m.std) == want
        assert (m.bcosifynormalize.mean, m.bcosifynormalize.std) == want


def test_learnable_b_flagship_matches_jax(kernel_calls):
    """The bcosified small flagship with ``clamping`` and ``clip_kd`` from
    the JAX engine and from the port's, on the port's calibrated weights:
    its variables (the 10 ``b`` leaves among them) round-trip through
    from_jax, the CLIP normalisation is in both, and the fp32 train-mode
    loss agrees within 1e-5 relative and its gradients within 1e-4 (the
    other leaves as the single-step parity; the b leaves for the reason
    test_learnable_b_steps_match_jax gives: here up to 2.2e-5); the fast
    explanation pass refuses the net and its module path launches no
    kernel."""
    from bcosification_tpu.bcosify import engine as jengine
    from bcosification_tpu.losses import UniformOffLabelsBCEWithLogitsLoss as JL
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
    from bcosification_tpu_torch.explain import fast_resnet
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss as TL
    from chip_smoke import calibrate

    config = {**FLAGSHIP_CONFIG, "name": "resnet50",
              "bcosify_args": {**FLAGSHIP_CONFIG["bcosify_args"], "clamping": True,
                               "clip_kd": True}}
    old = jengine.RESNET_LAYERS["resnet50"]
    jengine.RESNET_LAYERS["resnet50"] = LAYERS
    try:
        jnet, jvars = jengine.build_bcosified_resnet(config, None, input_size=32,
                                                     num_classes=NUM_CLASSES, inplanes=8)
    finally:
        jengine.RESNET_LAYERS["resnet50"] = old
    tnet = build_bcosified_resnet(config, num_classes=NUM_CLASSES, inplanes=8, layers=LAYERS,
                                  device="cpu")
    load_jax_variables(tnet, jax.tree_util.tree_map(np.asarray, jvars))
    rng = np.random.default_rng(3)
    calibrate(tnet, _t(rng.random((1, 32, 32, 6)).astype(np.float32)))
    with torch.no_grad():  # move the b leaves off their init
        for i, p in enumerate(p for n, p in tnet.named_parameters() if n.endswith(".b")):
            p.fill_(1.5 + 0.03 * i)
    variables = to_jax_variables(tnet)
    b_leaves = [n for n, _ in _leaves(variables["params"]) if n.endswith(".b")]
    assert len(b_leaves) == 10  # the stem, 4 convs per block and the classifier
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jvars))
    other = build_bcosified_resnet(config, num_classes=NUM_CLASSES, inplanes=8, layers=LAYERS,
                                   device="cpu")
    load_jax_variables(other, variables)
    assert all(torch.equal(a, b) for a, b in zip(tnet.state_dict().values(),
                                                  other.state_dict().values()))
    assert jnet.mean == tnet.mean and jnet.mean[0] == pytest.approx(0.48145466)

    x, label = _micro_batch(32, seed=4)

    def jloss(params):
        out, _ = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JL()(out.astype(jnp.float32), jnp.asarray(label))

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    tnet.requires_grad_(True)
    tl = TL()(tnet(_t(x), train=True).float(), _t(label))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrad)))
    for name, p in tnet.named_parameters():
        g = p.grad.numpy()
        g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        rel = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
        assert rel <= 1e-4, (name, rel)
    assert not fast_resnet.supports(tnet)
    from bcosification_tpu_torch.explain.core import make_explain_fn

    res = make_explain_fn(tnet.eval())(_t(x[:2]), device="cpu")
    assert torch.isfinite(res["dynamic_linear_weights"]).all()
    assert kernel_calls == {"k1": 0, "k3": 0}
