"""The port's training pieces against the JAX package on the CPU, in fp32
unless a test says otherwise, on the same inputs (numpy, from a seed): the
train-mode BN, K3's training backward, the train path of the B-cos ops, the
losses, AGC, the LR schedules, EMA, the optimizers, and one whole train
step of the small flagship."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import small_pair

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# BN in train mode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("explain", [False, True], ids=["train", "train_explain"])
def test_bn_train_matches_jax(explain):
    """Forward, input and weight gradients, and the running-var update.
    fp32, one-pass variance on both sides: 1e-5 relative."""
    from bcosification_tpu.modules import norms as jnorms
    from bcosification_tpu_torch.modules.norms import BatchNormUncentered2d, NoBias

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 8)) * 2 + 0.5).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    weight = (rng.random(8) + 0.5).astype(np.float32)
    rv = (rng.random(8) + 0.5).astype(np.float32)
    jbn = jnorms.NoBias(jnorms.BatchNormUncentered2d)(features=8)

    def f(xx, w):
        return jbn.apply({"params": {"weight": w},
                          "batch_stats": {"running_var": rv, "num_batches_tracked": np.int32(3)}},
                         xx, train=True, explain=explain, mutable=["batch_stats"])

    y, vjp, mutated = jax.vjp(f, x, weight, has_aux=True)
    dx, dw = vjp(jnp.asarray(ct))

    bn = NoBias(BatchNormUncentered2d)(8)
    with torch.no_grad():
        bn.weight.copy_(_t(weight))
        bn.running_var.copy_(_t(rv))
        bn.num_batches_tracked.fill_(3)
    xt = _t(x).requires_grad_(True)
    yt = bn(xt, train=True, explain=explain)
    yt.backward(_t(ct))
    assert _rel(yt.detach(), y) <= 1e-5
    assert _rel(xt.grad, dx) <= 1e-5
    assert _rel(bn.weight.grad, dw) <= 1e-5
    assert _rel(bn.running_var, mutated["batch_stats"]["running_var"]) <= 1e-6
    assert int(bn.num_batches_tracked) == int(mutated["batch_stats"]["num_batches_tracked"]) == 4
    with pytest.raises(ValueError, match="eval-only"):
        bn(None, train=True, return_affine=True)


# --------------------------------------------------------------------------
# K3's training backward
# --------------------------------------------------------------------------
def _matmul_inputs(m=37, k=24, n=10, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[5] = 0.0  # a zero row: n = eps, and eps_outside's clip(sqrt(ssq), 1e-20)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("eps_outside", [False, True], ids=["conv", "linear"])
@pytest.mark.parametrize("explain", [False, True], ids=["train", "explain"])
def test_bcos_matmul_backward_matches_jax(explain, eps_outside):
    """The port's bcos_matmul (its plain path on the CPU) against the JAX
    custom VJP: dx and dw in fp32 within 1e-5 relative."""
    from bcosification_tpu.ops.pallas.bcos_matmul import bcos_matmul as jax_bcos_matmul
    from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul

    x, w, g = _matmul_inputs()
    y, vjp = jax.vjp(lambda a, b: jax_bcos_matmul(a, b, 1e-6, eps_outside, explain), x, w)
    dx, dw = vjp(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    yt = bcos_matmul(xt, wt, 1e-6, eps_outside, explain)
    yt.backward(_t(g))
    assert _rel(yt.detach(), y) <= 1e-6
    assert _rel(xt.grad, dx) <= 1e-5
    assert _rel(wt.grad, dw) <= 1e-5


@pytest.mark.parametrize("explain", [False, True], ids=["train", "explain"])
def test_bcos_matmul_backward_bf16(explain):
    """bf16: the three products in bf16 (f32 accumulation), the rest in f32,
    against the fp32 backward on the same bf16-rounded x and w: within 1e-2
    relative (gu and the products round to bf16 once each, ~4e-3)."""
    from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul

    x, w, g = _matmul_inputs(m=64, k=32, n=16, seed=2)
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    grads = []
    for xx, ww in ((xb, wb), (xb.float(), wb.float())):
        xx, ww = xx.clone().requires_grad_(True), ww.clone().requires_grad_(True)
        bcos_matmul(xx, ww, 1e-6, False, explain).backward(_t(g))
        grads.append((xx.grad, ww.grad))
    (dxb, dwb), (dxf, dwf) = grads
    assert dxb.dtype == torch.bfloat16 and dwb.dtype == torch.bfloat16
    assert _rel(dxb.float(), dxf) <= 1e-2
    assert _rel(dwb.float(), dwf) <= 1e-2


# --------------------------------------------------------------------------
# the train path of the B-cos ops (autograd outside K3)
# --------------------------------------------------------------------------
CONV_CASES = {  # name: (kernel, stride, padding, b, normalize_weights, hint)
    "3x3": (3, 1, 1, 2.0, False, False),
    "3x3_hint": (3, 1, 1, 2.0, False, True),
    "3x3_s2_normed": (3, 2, 1, 2.0, True, True),
    "7x7_s2_stem": (7, 2, 3, 2.0, False, False),
    "1x1_s2_downsample": (1, 2, 0, 2.0, False, False),
    "1x1_s1_k3": (1, 1, 0, 2.0, False, False),
    "3x3_b2.5_power": (3, 1, 1, 2.5, True, False),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_bcos_conv2d_gradients_match_jax(case):
    """x and w gradients of bcos_conv2d (explain=False: the dynamic scale and
    the patch norm are differentiated) against the JAX op: 1e-5 relative."""
    from bcosification_tpu.ops import bcos as jops
    from bcosification_tpu_torch.ops import bcos as tops

    k, stride, pad, b, normed, hint = CONV_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 12)).astype(np.float32)  # HWIO
    kw = dict(b=b, stride=stride, padding=pad, normalize_weights=normed)

    def jf(xx, ww):
        return jops.bcos_conv2d(xx, ww, x_sumsq=jops.channel_sumsq(xx) if hint else None, **kw)

    y, vjp = jax.vjp(jf, x, w)
    ct = rng.normal(size=y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_(True)
    wt = _t(w.transpose(3, 2, 0, 1)).requires_grad_(True)
    yt = tops.bcos_conv2d(xt, wt, x_sumsq=tops.channel_sumsq(xt) if hint else None, **kw)
    yt.backward(_t(ct))
    assert _rel(yt.detach(), y) <= 1e-5
    assert _rel(xt.grad, dx) <= 1e-5
    assert _rel(wt.grad, np.asarray(dw).transpose(3, 2, 0, 1)) <= 1e-5


def test_avg_pool2d_gradient_matches_jax():
    from bcosification_tpu.ops import pooling as jpool
    from bcosification_tpu_torch.ops import pooling as tpool

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jpool.avg_pool2d(a, 3, 2, 1), x)
    ct = rng.normal(size=y.shape).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    tpool.avg_pool2d(xt, 3, 2, 1).backward(_t(ct))
    assert _rel(xt.grad, vjp(jnp.asarray(ct))[0]) <= 1e-6


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
LOSSES = {
    "bce": ("BinaryCrossEntropyLoss", {}),
    "bce_smooth_threshold": ("BinaryCrossEntropyLoss", {"smoothing": 0.1,
                                                         "target_threshold": 0.05}),
    "bce_sum": ("BinaryCrossEntropyLoss", {"reduction": "sum"}),
    "uniform_off": ("UniformOffLabelsBCEWithLogitsLoss", {}),
    "uniform_off_0.2": ("UniformOffLabelsBCEWithLogitsLoss", {"off_label": 0.2}),
}


@pytest.mark.parametrize("dense", [False, True], ids=["indices", "one_hot"])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_match_jax(case, dense):
    """Value and logit gradient, fp32: 1e-6 relative."""
    from bcosification_tpu import losses as jlosses
    from bcosification_tpu_torch import losses as tlosses

    name, kw = LOSSES[case]
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 7)) * 3).astype(np.float32)
    label = rng.integers(0, 7, size=6).astype(np.int32)
    target = np.eye(7, dtype=np.float32)[label] if dense else label
    jloss = getattr(jlosses, name)(**kw)
    val, grad = jax.value_and_grad(lambda a: jloss(a, jnp.asarray(target)))(x)
    xt = _t(x).requires_grad_(True)
    got = getattr(tlosses, name)(**kw)(xt, _t(target))
    got.backward()
    assert abs(float(got.detach()) - float(val)) <= 1e-6 * abs(float(val))
    assert _rel(xt.grad, grad) <= 1e-6


def test_bce_weights_match_jax():
    from bcosification_tpu import losses as jlosses
    from bcosification_tpu_torch import losses as tlosses

    rng = np.random.default_rng(6)
    x, t, w, pw = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(4))
    t = np.abs(t) / np.abs(t).max()
    want = jlosses.binary_cross_entropy_with_logits(x, t, weight=w, pos_weight=pw,
                                                    reduction="none")
    got = tlosses.binary_cross_entropy_with_logits(_t(x), _t(t), weight=_t(w),
                                                   pos_weight=_t(pw), reduction="none")
    assert _rel(got, want) <= 1e-6


# --------------------------------------------------------------------------
# AGC, schedules, EMA, optimizers
# --------------------------------------------------------------------------
def test_agc_oihw_matches_jax_hwio():
    """Unit-wise clipping on the port's layouts (unit = first axis) against
    the JAX package's (unit = last axis) after transposition."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu_torch.training import agc as tagc

    rng = np.random.default_rng(7)
    shapes = {"conv": (8, 4, 3, 3), "conv1x1": (16, 8, 1, 1), "conv_in1": (8, 1, 1, 1),
              "linear": (10, 16), "vector": (8,), "scalar": ()}

    def to_jax(a):  # OIHW -> HWIO, [out, in] -> [in, out]
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else (a.T if a.ndim == 2 else a)

    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # half the units far above the clip (0.01 of the unit's norm), half below
    grads = {k: (rng.normal(size=s) * np.where(rng.random(s) < 0.5, 1.0, 1e-4)).astype(np.float32)
             for k, s in shapes.items()}
    want = jagc.adaptive_clip_grads({k: to_jax(v) for k, v in params.items()},
                                    {k: to_jax(v) for k, v in grads.items()}, clip_factor=0.01)
    ps = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    for k, p in ps.items():
        p.grad = _t(grads[k])
    tagc.adaptive_clip_grads_(ps.values(), clip_factor=0.01)
    clipped = 0
    for k, p in ps.items():
        np.testing.assert_allclose(to_jax(p.grad.numpy()), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        clipped += int(not np.array_equal(p.grad.numpy(), grads[k]))
    assert clipped >= 4  # the test has signal: most parameters were clipped


SCHEDULES = {
    "cosine_epoch": dict(name="cosineannealinglr", epochs=5),
    "cosine_step_linear_warmup": dict(name="cosineannealinglr", epochs=4, interval="step",
                                      warmup_epochs=1, warmup_method="linear"),
    "cosine_step_warmup_steps": dict(name="cosineannealinglr", epochs=4, interval="step",
                                     warmup_steps=7, lr_min=1e-5),
    "steplr_epoch_const_warmup": dict(name="steplr", step_size=2, gamma=0.5, warmup_epochs=1),
    "steplr_step": dict(name="steplr", step_size=1, gamma=0.3, interval="step"),
    "exponential": dict(name="exponentiallr", gamma=0.9, warmup_epochs=2,
                        warmup_method="linear"),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedules_match_jax(case):
    from bcosification_tpu.optim.lr_scheduler_factory import LRSchedulerFactory as J
    from bcosification_tpu_torch.optim.lr_scheduler_factory import LRSchedulerFactory as T

    jsched, tsched = (F(**SCHEDULES[case]).create(0.1, steps_per_epoch=10) for F in (J, T))
    for step in (0, 1, 5, 9, 10, 11, 19, 20, 25, 39, 40, 41, 60):
        # JAX computes in f32: 1e-6 relative, or f32 rounding of the base lr 0.1
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6, atol=1e-8,
                                   err_msg=f"step {step}")


def test_lr_scheduler_rejects_what_jax_rejects():
    from bcosification_tpu_torch.optim.lr_scheduler_factory import LRSchedulerFactory

    for kw in (dict(name="cosineannealinglr"), dict(name="steplr", warmup_steps=3),
               dict(name="nope"), dict(name="steplr", warmup_steps=1, warmup_epochs=1,
                                       interval="step")):
        with pytest.raises(ValueError):
            LRSchedulerFactory(**kw)


def test_ema_matches_jax():
    from bcosification_tpu.training import ema as jema
    from bcosification_tpu_torch.modules.norms import BatchNormUncentered2d
    from bcosification_tpu_torch.training import ema as tema

    assert tema.adjusted_ema_decay(0.9998, 2, 64, 90, 32, 2) == jema.adjusted_ema_decay(
        0.9998, 2, 64, 90, 32, 2)
    rng = np.random.default_rng(8)
    ema, new = BatchNormUncentered2d(6), BatchNormUncentered2d(6)
    with torch.no_grad():
        for mod in (ema, new):
            for t in (mod.weight, mod.bias, mod.running_var):
                t.copy_(_t(rng.normal(size=6).astype(np.float32)))
        new.num_batches_tracked.fill_(7)

    def tree(mod):
        return {k: v.numpy().copy() for k, v in mod.state_dict().items()}

    decay = 0.75
    want = jema.ema_update(tree(ema), tree(new), decay)
    tema.maybe_ema_update(ema, new, decay, step=5, ema_steps=4)  # not a multiple: no update
    assert _rel(ema.weight.detach(), tree(ema)["weight"]) == 0.0
    before = tree(ema)
    tema.maybe_ema_update(ema, new, decay, step=8, ema_steps=4)
    assert not np.array_equal(tree(ema)["weight"], before["weight"])
    for k, v in tree(ema).items():
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=1e-6, err_msg=k)
    assert int(ema.num_batches_tracked) == 7


OPTIMIZERS = {  # name: (optimizer, kwargs, lr rises over the steps)
    "adam": ("Adam", dict(), True),
    "adam_l2": ("Adam", dict(weight_decay=0.05, betas=(0.8, 0.99)), True),
    "adamw": ("AdamW", dict(weight_decay=0.05), True),
    "sgd_nesterov": ("SGD", dict(momentum=0.9, nesterov=True, weight_decay=1e-3), True),
    # optax scales by the lr BEFORE the momentum trace: under a rising lr this
    # differs from torch.optim.RMSprop, which scales after it
    "rmsprop": ("RMSprop", dict(momentum=0.9), True),
    "rmsprop_l2_constant_lr": ("RMSprop", dict(momentum=0.9, weight_decay=1e-2), False),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizers_match_optax(case):
    """Three steps of the port's torch.optim optimizer against the JAX
    factory's optax transform: params within 1e-6 absolute against steps of
    1e-2 (Adam's first moment cancels across the random gradients, which
    magnifies f32 rounding to a few 1e-7)."""
    import optax

    from bcosification_tpu.optim.optimizer_factory import OptimizerFactory as J
    from bcosification_tpu_torch.optim.optimizer_factory import OptimizerFactory as T
    from bcosification_tpu_torch.optim.optimizer_factory import set_lr

    name, kw, rising = OPTIMIZERS[case]
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]

    def schedule(step):
        return 0.01 * (1.0 + step) if rising else 0.01

    tx = J(name, 0.01, **kw).create(schedule)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(_t(p0))
    opt = T(name, 0.01, **kw).create(model)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        model.w.grad = _t(g)
        set_lr(opt, schedule(step))
        opt.step()
    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(params), rtol=0,
                               atol=1e-6)


def test_optimizer_factory_b_params():
    from bcosification_tpu_torch.optim.optimizer_factory import OptimizerFactory

    model = torch.nn.Module()
    model.weight = torch.nn.Parameter(torch.ones(3))
    model.b = torch.nn.Parameter(torch.ones(()))
    assert len(OptimizerFactory("adam", 1e-3).create(model).param_groups[0]["params"]) == 2
    kept = OptimizerFactory("adam", 1e-3, bcosify=True).create(model).param_groups[0]["params"]
    assert len(kept) == 1 and kept[0] is model.weight
    b_opt = OptimizerFactory("adam", 1e-3, bcosify=True, weight_decay=0.1).with_name(
        "sgd").with_args(b_opt=True).create(model)
    assert isinstance(b_opt, torch.optim.SGD) and b_opt.param_groups[0]["params"] == [model.b]
    assert b_opt.param_groups[0]["weight_decay"] == 0.1
    with pytest.raises(ValueError):
        OptimizerFactory("lamb", 1e-3)


# --------------------------------------------------------------------------
# one whole train step of the small flagship
# --------------------------------------------------------------------------
def _flagship_batch(size, n=4, seed=10):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    return x, rng.integers(0, 10, size=n).astype(np.int32)


def _jax_recipe(amp):
    """The recipe of scripts/bench_train.py on the JAX side: Adam + cosine
    with linear warmup, AGC, UniformOffLabels BCE, EMA every step."""
    from bcosification_tpu.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu.optim.lr_scheduler_factory import LRSchedulerFactory
    from bcosification_tpu.optim.optimizer_factory import OptimizerFactory

    schedule = LRSchedulerFactory(name="cosineannealinglr", epochs=4, warmup_epochs=1,
                                  warmup_method="linear", interval="step").create(
        1e-3, steps_per_epoch=10)
    return UniformOffLabelsBCEWithLogitsLoss(), OptimizerFactory("Adam", 1e-3).create(schedule)


def _port_recipe():
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

    schedule = LRSchedulerFactory(name="cosineannealinglr", epochs=4, warmup_epochs=1,
                                  warmup_method="linear", interval="step").create(
        1e-3, steps_per_epoch=10)
    return UniformOffLabelsBCEWithLogitsLoss(), OptimizerFactory("Adam", 1e-3), schedule


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def flagship():
    net, variables, tnet, _ = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    return net, variables, tnet


def test_to_jax_variables_round_trip(flagship):
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables

    net, variables, tnet = flagship
    out = to_jax_variables(tnet)
    for path, arr in _leaves(jax.tree_util.tree_map(np.asarray, variables)):
        got = out
        for key in path:
            got = got[key]
        np.testing.assert_array_equal(got, arr, err_msg="/".join(path))
    other = copy.deepcopy(tnet)
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    load_jax_variables(other, out)
    for (k, a), b in zip(tnet.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_step_matches_jax(flagship):
    """Two steps of the recipe (fp32), JAX make_train_step against the
    port's from the same variables and batch. Loss 1e-5 and every raw
    gradient leaf 1e-4 relative (‖Δ‖/‖ref‖; two blocks of fp32 convs summed in
    another order), and so the AGC-clipped gradients of the first step; the
    parameters and EMA after each step within 1e-5 (absolute, against Adam
    steps of ~1e-3); batch_stats 1e-5 relative."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import steps as tsteps

    net, variables, tnet = flagship
    x, label = _flagship_batch(32)
    criterion, tx = _jax_recipe(amp=False)
    jstep = jsteps.make_train_step(net, criterion, tx, use_agc=True, ema_decay=0.9,
                                   ema_steps=1, donate=False)
    jstate = jsteps.create_train_state(variables, tx, with_ema=True)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(label)}

    def loss_fn(params):
        out, mut = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             batch["image"], train=True, mutable=["batch_stats"])
        return criterion(out.astype(jnp.float32), batch["label"])

    jgrads = jax.grad(loss_fn)(variables["params"])
    jclipped = jagc.adaptive_clip_grads(variables["params"], jgrads)

    tcrit, tfactory, schedule = _port_recipe()
    tstep = tsteps.make_train_step(tcrit, schedule, use_agc=True, ema_decay=0.9, ema_steps=1)
    tstate = tsteps.create_train_state(tnet, tfactory.create, with_ema=True)
    tbatch = {"image": _t(x), "label": _t(label)}

    # raw gradients: one forward/backward of a copy of the state's model
    m = copy.deepcopy(tstate.model)
    tcrit(m(tbatch["image"], train=True).float(), tbatch["label"]).backward()
    tgrads = {n: p.grad for n, p in m.named_parameters()}

    def by_port_name(tree):
        return {".".join(path): arr for path, arr in _leaves(tree)}

    def as_jax(name, t):
        a = t.detach().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    want_grads = by_port_name(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want_grads) == set(tgrads)
    worst = max(_rel(as_jax(n, g), want_grads[n]) for n, g in tgrads.items())
    assert worst <= 1e-4, worst

    for i in range(2):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, tbatch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(
            jm["grad_norm"])
        if i == 0:
            want_clipped = by_port_name(jax.tree_util.tree_map(np.asarray, jclipped))
            worst = max(_rel(as_jax(n, p.grad), want_clipped[n])
                        for n, p in tstate.model.named_parameters())
            assert worst <= 1e-4, worst
        got = to_jax_variables(tstate.model)
        got_ema = to_jax_variables(tstate.ema)
        for coll, jtree, jema in (("params", jstate.params, jstate.ema_params),
                                  ("batch_stats", jstate.batch_stats, jstate.ema_batch_stats)):
            want, want_ema = (by_port_name(jax.tree_util.tree_map(np.asarray, t))
                              for t in (jtree, jema))
            for name, arr in by_port_name(got[coll]).items():
                if coll == "params":
                    np.testing.assert_allclose(arr, want[name], rtol=0, atol=1e-5, err_msg=name)
                else:
                    np.testing.assert_allclose(arr, want[name], rtol=1e-5, err_msg=name)
            for name, arr in by_port_name(got_ema[coll]).items():
                np.testing.assert_allclose(arr, want_ema[name], rtol=1e-5, atol=1e-5,
                                           err_msg=name)
    assert tstate.step == int(jstate.step) == 2
    # the caller's model is untouched: the state trains a copy
    assert all(p.grad is None for p in tnet.parameters())


def _jax_grads(net, variables, criterion, x, label, amp):
    """{port name: leaf} of the JAX gradient of the loss of one train-mode
    forward (the image in bf16 under amp, as the JAX step casts it)."""
    def loss_fn(params):
        image = jnp.asarray(x).astype(jnp.bfloat16) if amp else jnp.asarray(x)
        out, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, image,
                           train=True, mutable=["batch_stats"])
        return criterion(out.astype(jnp.float32), jnp.asarray(label))

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(variables["params"]))
    return {".".join(path): arr for path, arr in _leaves(grads)}


def test_amp_train_step(flagship):
    """--amp: bf16 activations, f32 parameters, gradients and Adam moments,
    against the JAX amp step. bf16 rounds at other places in the two
    frameworks, and this net's gradients are sensitive to it: the JAX amp
    gradient itself lies 0.32 (worst leaf, ||d||/||ref||) from the JAX fp32
    one. Held, with the readings of planted bf16-only faults (K3's dw halved,
    K3's dx without its row term or its factor 2, the BN std detached):
    - the loss within 1e-2 relative;
    - every raw gradient leaf within 0.3 of the JAX amp leaf (measured 0.21;
      the faults read 0.51 to 3.2);
    - per leaf, the port's distance from the JAX fp32 gradient at most twice
      the JAX amp gradient's own (measured 1.16x; the faults read 18x to 35x);
    - the update of two steps, params after minus before, within 0.35 of the
      JAX amp step's over all leaves and 0.6 on the worst leaf (measured 0.22
      and 0.37, the JAX fp32 update reads 0.24 from the JAX amp one; the
      faults read 0.67 to 0.76 and 1.07 to 1.41, bar the halved dw, which
      Adam's normalisation hides and the gradient bounds catch)."""
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import steps as tsteps

    net, variables, tnet = flagship
    x, label = _flagship_batch(32)
    criterion, tx = _jax_recipe(amp=True)
    want_amp = _jax_grads(net, variables, criterion, x, label, amp=True)
    want_fp32 = _jax_grads(net, variables, criterion, x, label, amp=False)
    jstep = jsteps.make_train_step(net, criterion, tx, use_agc=True, donate=False, amp=True)
    jstate = jsteps.create_train_state(variables, tx)
    tcrit, tfactory, schedule = _port_recipe()
    tstate = tsteps.create_train_state(tnet, tfactory.create)
    tstep = tsteps.make_train_step(tcrit, schedule, use_agc=True, amp=True)
    tbatch = {"image": _t(x), "label": _t(label)}

    m = copy.deepcopy(tstate.model)
    tcrit(m(tbatch["image"].to(torch.bfloat16), train=True).float(), tbatch["label"]).backward()
    got = {n: p.grad.numpy().transpose(2, 3, 1, 0) if p.ndim == 4 else p.grad.numpy()
           for n, p in m.named_parameters()}
    assert set(got) == set(want_amp)
    worst = max(_rel(got[n], want_amp[n]) for n in want_amp)
    assert worst <= 0.3, worst
    ratio = max(_rel(got[n], want_fp32[n]) / _rel(want_amp[n], want_fp32[n]) for n in want_amp)
    assert ratio <= 2.0, ratio

    for _ in range(2):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(label)})
        tstate, tm = tstep(tstate, tbatch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))
    before = {".".join(path): arr for path, arr in _leaves(
        jax.tree_util.tree_map(np.asarray, variables["params"]))}
    after = {".".join(path): arr for path, arr in _leaves(
        jax.tree_util.tree_map(np.asarray, jstate.params))}
    got_after = {".".join(path): arr for path, arr in _leaves(
        to_jax_variables(tstate.model)["params"])}
    d_got = np.concatenate([(got_after[n] - before[n]).ravel() for n in before])
    d_want = np.concatenate([(after[n] - before[n]).ravel() for n in before])
    assert _rel(d_got, d_want) <= 0.35, _rel(d_got, d_want)
    worst = max(_rel(got_after[n] - before[n], after[n] - before[n]) for n in before)
    assert worst <= 0.6, worst
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tstate.model.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in tstate.optimizer.state.values())


def test_train_step_guards():
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss
    from bcosification_tpu_torch.training import steps as tsteps

    crit = UniformOffLabelsBCEWithLogitsLoss()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsteps.make_train_step(crit, use_agc=True, gradient_clip_val=1.0)
    with pytest.raises(ValueError, match="positive increment"):
        tsteps.make_linear_b_schedule(b_lr=0.0)


def test_gradient_clip_matches_jax(flagship):
    """gradient_clip_val: the global-norm clip (no AGC), one step of plain
    SGD so the update is the clipped gradient itself: 1e-6 absolute."""
    import optax

    from bcosification_tpu.losses import UniformOffLabelsBCEWithLogitsLoss as JL
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.losses import UniformOffLabelsBCEWithLogitsLoss as TL
    from bcosification_tpu_torch.optim import OptimizerFactory
    from bcosification_tpu_torch.training import steps as tsteps

    net, variables, tnet = flagship
    x, label = _flagship_batch(32, seed=11)
    tx = optax.sgd(1.0)
    jstate, jm = jsteps.make_train_step(net, JL(), tx, gradient_clip_val=1e-3, donate=False)(
        jsteps.create_train_state(variables, tx),
        {"image": jnp.asarray(x), "label": jnp.asarray(label)})
    tstate, tm = tsteps.make_train_step(TL(), gradient_clip_val=1e-3)(
        tsteps.create_train_state(tnet, OptimizerFactory("sgd", 1.0).create),
        {"image": _t(x), "label": _t(label)})
    assert float(jm["grad_norm"]) > 1e-3  # the clip is active
    got = to_jax_variables(tstate.model)["params"]
    for path, arr in _leaves(jax.tree_util.tree_map(np.asarray, jstate.params)):
        g = got
        for key in path:
            g = g[key]
        np.testing.assert_allclose(g, arr, rtol=0, atol=1e-6, err_msg="/".join(path))
