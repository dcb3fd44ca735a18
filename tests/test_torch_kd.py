"""CLIP knowledge distillation in the port (``training/kd.py`` and
``Trainer.fit_kd``) against the JAX package, on the CPU, in fp32, on the same
weights: a small CLIP-RN50 teacher (layers (1, 1, 1, 1), width 16,
embed_dim 32, 64x64, its BN statistics randomised) and the B-cosified
student of the same size, pooled and attn-unpool (cos_power 2), its JAX
variables randomised as tests/test_torch_clip.py does and its BN gammas
calibrated (``chip_smoke.calibrate``) before they are carried back to JAX.
Three images of 64x64 give the attn-unpool student 4 locations, so HW != B.

- ``kd_forward_features``: teacher features, the student's train-mode
  output and its updated BN statistics (1e-5 relative);
- the KD loss (1e-5) and every student gradient against ``jax.grad`` of
  the JAX composition (kd_forward_features, _l2, SigLipLoss), each leaf
  within ten times the port's own spread under 1e-7 relative input noise,
  over the largest leaf's norm; the c_proj's B-cos linear
  (``eps_outside``) dx and dw against ``jax.grad`` (1e-5);
- one step of ``make_kd_train_step`` against the JAX step (the recipe's
  Adam 1e-4 with the cosine, AGC on and off);
- the bf16 amp loss against JAX's, within twice JAX's own amp-to-fp32
  distance;
- ``SigLipLoss`` in bf16 against JAX's;
- ``Trainer.fit_kd`` against the JAX ``fit_kd`` for 2 epochs on a synthetic
  data module (``clip.load.load`` patched in both packages to return the
  small teacher), its metrics, checkpoints and resume, and ``run_training``
  of a CC3M KD config routed to it; the per-epoch zero-shot against the
  JAX Trainer's on a small synthetic ImageNet tree;
- AGC on the (in, out) linears of the attention pool (fault C4).
"""
import copy
import gzip
import io
import json
import os
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CFG = {"vision_layers": (1, 1, 1, 1), "vision_width": 16, "embed_dim": 32,
       "image_resolution": 64, "vision_patch_size": None, "context_length": 77,
       "vocab_size": 49408, "transformer_width": 32, "transformer_heads": 2,
       "transformer_layers": 1}
SIZE, BATCH = 64, 3


def _model_config(attn_unpool):
    return {"name": "resnet50clip", "bcosify_args": {"clip_kd": True, "use_bias": False},
            "bcos_args": {"b": 2}, "attn_unpool": attn_unpool, "cos_power": 2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def teacher_pair(seed=2):
    """(jax teacher, its variables, the port's teacher on the CPU): random
    init in JAX, the BN statistics randomised, the same weights carried
    across."""
    from bcosification_tpu.bcosify.clip_import import build_clip_teacher_visual as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables

    jt, tvars = jbuild(None, dict(CFG))
    rng = np.random.default_rng(seed)
    tvars = {"params": jax.tree_util.tree_map(np.asarray, tvars["params"]),
             "batch_stats": jax.tree_util.tree_map(
                 lambda leaf: (rng.random(leaf.shape) + 0.5).astype(np.float32),
                 tvars["batch_stats"])}
    teacher = build_clip_teacher_visual(None, dict(CFG), device="cpu")
    load_jax_variables(teacher, tvars)
    return jt, _jnp(tvars), teacher


def student_pair(attn_unpool, seed=7, cfg=CFG):
    """(jax student, its variables, the port's student on the CPU) with the
    same weights: randomised as tests/test_torch_clip.py does, BN gammas
    calibrated in the port, carried back to JAX."""
    from chip_smoke import calibrate
    from bcosification_tpu.bcosify.clip_import import build_bcosified_clip_visual as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables

    net, variables = jbuild(_model_config(attn_unpool), None, dict(cfg))
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
    student = build_bcosified_clip_visual(_model_config(attn_unpool), None, dict(cfg),
                                          device="cpu")
    load_jax_variables(student, variables)
    size = cfg["image_resolution"]
    probe = np.random.default_rng(seed + 1).random((1, size, size, 3)).astype(np.float32)
    calibrate(student, torch.from_numpy(np.concatenate([probe, 1.0 - probe], axis=-1)))
    return net, _jnp(to_jax_variables(student)), student


def images(n=BATCH, seed=0):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def teachers():
    return teacher_pair()


@pytest.fixture(scope="module")
def pooled_student():
    """The pooled student pair, built once for the module (``towers`` and the
    fits read it; nothing mutates it)."""
    return student_pair(False)


@pytest.fixture(scope="module", params=[False, True], ids=["pooled", "unpool"])
def towers(request, teachers):
    students = request.getfixturevalue("pooled_student") if not request.param else (
        student_pair(True))
    return (request.param, *teachers, *students)


def _jax_loss_fn(jt, tvars, js, x, cos_power):
    """make_kd_train_step's loss_fn: the JAX composition."""
    from bcosification_tpu.losses import SigLipLoss
    from bcosification_tpu.training import kd as jkd

    def loss_fn(params, batch_stats):
        t_feat, s_out, new_bs = jkd.kd_forward_features(
            js, jt, {"params": params, "batch_stats": batch_stats}, tvars, x, train=True)
        s_feat, t_feat = jkd._l2(s_out), jkd._l2(t_feat)
        if s_feat.ndim == 3:
            s_feat = jnp.swapaxes(s_feat, 0, 1)
        return SigLipLoss()(s_feat, t_feat, 10.0, -10.0, cos_scaling=cos_power), new_bs

    return loss_fn


# --------------------------------------------------------------------------
# the forward and the loss
# --------------------------------------------------------------------------
def test_kd_forward_features_matches_jax(towers):
    from bcosification_tpu.training import kd as jkd
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import kd

    unpool, jt, tvars, teacher, js, svars, student = towers
    x = images()

    def forward(train):  # eager flax takes minutes on this net: one jit per mode
        return jax.jit(lambda sv, tv, xx: jkd.kd_forward_features(js, jt, sv, tv, xx,
                                                                  train=train))

    want_t, want_s, want_bs = forward(True)(svars, tvars, jnp.asarray(x))
    s = copy.deepcopy(student)
    with torch.no_grad():
        got_t, got_s = kd.kd_forward_features(s, teacher, torch.from_numpy(x), train=True)
    assert got_s.shape == ((BATCH, 4, 32) if unpool else (BATCH, 32))
    assert np.abs(np.asarray(want_t)).max() > 1e-2 and np.abs(np.asarray(want_s)).max() > 1e-2
    assert _rel(got_t.numpy(), want_t) <= 1e-5
    assert _rel(got_s.numpy(), want_s) <= 1e-5
    got_bs, want_flat = _flat(to_jax_variables(s)["batch_stats"]), _flat(want_bs)
    assert sorted(got_bs) == sorted(want_flat)
    for name, leaf in want_flat.items():
        assert _rel(got_bs[name], leaf) <= 1e-5, name
    # the eval forward reads the running statistics and leaves them alone
    before = _flat(to_jax_variables(student)["batch_stats"])
    with torch.no_grad():
        _, got_eval = kd.kd_forward_features(student, teacher, torch.from_numpy(x))
    _, want_eval, none = forward(False)(svars, tvars, jnp.asarray(x))
    assert none is None and _rel(got_eval.numpy(), want_eval) <= 1e-5
    after = _flat(to_jax_variables(student)["batch_stats"])
    assert all(np.array_equal(after[k], v) for k, v in before.items())


def _port_loss_and_grads(student, teacher, x, cos_power):
    """(loss, {JAX leaf path: gradient}) of one train-mode KD loss of a copy
    of ``student``."""
    from bcosification_tpu_torch.training import kd

    s = copy.deepcopy(student).requires_grad_(True)
    t_feat, s_out = kd.kd_forward_features(s, teacher, torch.from_numpy(x), train=True)
    loss = kd.kd_loss(s_out, t_feat, 10.0, -10.0, cos_power)
    loss.backward()
    grads = {}
    for name, p in s.named_parameters():
        g = p.grad.numpy()
        grads["/".join(name.split("."))] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return float(loss.detach()), grads


def test_kd_loss_and_gradients_match_jax(towers):
    """The loss (1e-5) and every student gradient against jax.grad of the
    JAX composition, each leaf's distance over the largest leaf's norm.
    That distance is held to ten times the port's own spread under 1e-7
    relative input noise (as chip_smoke.py holds W at full width): this
    net's gradients move by 1.9e-5 of the largest leaf under that noise
    alone (pooled), so the 1e-5 of the forward cannot hold for them; a
    fault in a backward (a missing factor, a dropped term) moves a leaf by
    O(1). The attn-unpool c_proj, the B-cos linear with eps_outside, is
    held on its own scale too."""
    unpool, jt, tvars, teacher, js, svars, student = towers
    cos_power = 2 if unpool else 0
    x = images()
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jt, tvars, js, jnp.asarray(x), cos_power), has_aux=True))(
            svars["params"], svars["batch_stats"])
    want = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in _flat(want).items()}
    loss, got = _port_loss_and_grads(student, teacher, x, cos_power)
    noise = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    _, moved = _port_loss_and_grads(student, teacher, (x * (1 + 1e-7 * noise)).astype(
        np.float32), cos_power)
    assert np.isfinite(loss) and abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert sorted(got) == sorted(want)
    top = max(float(np.linalg.norm(g)) for g in want.values())
    spread = max(float(np.linalg.norm(moved[k] - g)) for k, g in got.items()) / top
    assert 0 < spread <= 1e-4  # the comparison stays meaningful
    for name, g in want.items():
        assert float(np.linalg.norm(got[name] - g)) <= 10 * spread * top, name
    if unpool:
        c_proj = "model/attnpool/c_proj/weight"
        spread_c = _rel(moved[c_proj], got[c_proj])
        assert _rel(got[c_proj], want[c_proj]) <= max(1e-5, 10 * spread_c)


def test_c_proj_eps_outside_gradients_match_jax():
    """K3's training backward with the linear norm (sqrt(ssq) + 1e-12) at a
    c_proj-like shape: the value, dx and dw against jax.grad (1e-5)."""
    from bcosification_tpu.ops import bcos as jops
    from bcosification_tpu_torch.ops import bcos as tops

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    ct = rng.standard_normal((3, 4, 32)).astype(np.float32)

    def f(xx, ww):
        return jops.bcos_linear(xx, ww, b=2.0)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tops.bcos_linear(xt, wt, b=2.0)
    got.backward(torch.from_numpy(ct))
    assert _rel(got.detach().numpy(), want) <= 1e-5
    assert _rel(xt.grad.numpy(), want_dx) <= 1e-5
    assert _rel(wt.grad.numpy(), want_dw) <= 1e-5


@pytest.mark.parametrize("cos_scaling", [0, 2])
@pytest.mark.parametrize("explain", [False, True], ids=["train", "explain"])
def test_siglip_loss_bf16_matches_jax(cos_scaling, explain):
    """SigLipLoss on bf16 features (the amp step's dtype): value and the
    image-feature gradient against JAX in bf16, within 1e-2 relative (bf16
    rounds to 2^-8)."""
    from bcosification_tpu.losses import SigLipLoss as JSigLip
    from bcosification_tpu_torch.losses import SigLipLoss

    rng = np.random.default_rng(4)
    shape = (5, 4, 16) if cos_scaling else (4, 16)
    img = rng.standard_normal(shape).astype(np.float32) / 4
    txt = rng.standard_normal((4, 16)).astype(np.float32) / 4

    def jf(i):
        return JSigLip()(i, jnp.asarray(txt, jnp.bfloat16), 10.0, -10.0,
                         cos_scaling=cos_scaling, explain=explain)

    want, vjp = jax.vjp(jf, jnp.asarray(img, jnp.bfloat16))
    (want_g,) = vjp(jnp.ones((), want.dtype))
    it = torch.from_numpy(img).to(torch.bfloat16).requires_grad_(True)
    got = SigLipLoss()(it, torch.from_numpy(txt).to(torch.bfloat16), 10.0, -10.0,
                       cos_scaling=cos_scaling, explain=explain)
    got.backward()
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert abs(float(got) - float(want)) <= 1e-2 * abs(float(want))
    assert _rel(it.grad.float().numpy(), np.asarray(want_g, np.float32)) <= 1e-2


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
def _recipe(port=True):
    if port:
        from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    else:
        from bcosification_tpu.optim import LRSchedulerFactory, OptimizerFactory
    opt = OptimizerFactory(name="Adam", lr=1e-4, bcosify=True, b_opt=False)
    return opt, LRSchedulerFactory(name="cosineannealinglr", epochs=90).create(1e-4, 10)


def _first_moment(opt_state):
    """The flat {leaf path: mu} of the Adam state inside an optax state."""
    if hasattr(opt_state, "mu"):
        return _flat(opt_state.mu)
    children = (opt_state.values() if isinstance(opt_state, dict)
                else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for child in children:
        found = _first_moment(child)
        if found is not None:
            return found
    return None


def _port_step(student, teacher, x, cos_power, use_agc):
    """(loss, {leaf path: updated parameter}, {leaf path: Adam's first
    moment}, {leaf path: BN statistic}) of one port step of the recipe on a
    copy of ``student``."""
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import kd, steps

    opt, sched = _recipe()
    state = steps.create_train_state(student, opt.create, device="cpu")
    step = kd.make_kd_train_step(teacher, sched, cos_power=cos_power, use_agc=use_agc)
    state, metrics = step(state, {"image": torch.from_numpy(x)})
    assert state.step == 1

    def jax_layout(t):
        a = t.detach().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    params = {"/".join(n.split(".")): p for n, p in state.model.named_parameters()}
    return (float(metrics["loss"]), {k: jax_layout(p) for k, p in params.items()},
            {k: jax_layout(state.optimizer.state[p]["exp_avg"]) for k, p in params.items()},
            _flat(to_jax_variables(state.model)["batch_stats"]))


@pytest.fixture(scope="module")
def jax_steps():
    """(head, use_agc) -> (JAX state, metrics) of one recipe step, for the
    module: the train-step test and the amp test's fp32 loss share it."""
    return {}


def _jax_step(jax_steps, towers, use_agc):
    """One step of the JAX recipe (Adam 1e-4 with the cosine) on the towers'
    weights and ``images()``: (state, metrics), computed once per head and
    AGC setting (``jax_steps``)."""
    from bcosification_tpu.training import kd as jkd
    from bcosification_tpu.training import steps as jsteps

    unpool, jt, tvars, _, js, svars, _ = towers
    key = (unpool, use_agc)
    if key not in jax_steps:
        jopt, jsched = _recipe(port=False)
        tx = jopt.create(jsched, svars["params"])
        jstep = jkd.make_kd_train_step(js, jt, tvars, tx, cos_power=2 if unpool else 0,
                                       use_agc=use_agc, donate=False)
        jax_steps[key] = jstep(jsteps.create_train_state(svars, tx),
                               {"image": jnp.asarray(images())})
    return jax_steps[key]


@pytest.mark.parametrize("use_agc", [True, False], ids=["agc", "no_agc"])
def test_kd_train_step_matches_jax(towers, jax_steps, use_agc):
    """One step of the recipe (Adam 1e-4 with the cosine; AGC on and off)
    against the JAX step: the loss (1e-5); Adam's first moment, which is
    the (clipped) gradient times 0.1, leaf by leaf within ten times the
    port's own spread under 1e-7 relative input noise, over the largest
    leaf's norm (as the gradient test); the BN statistics (1e-5). Adam's
    first update is lr * g / (|g| + 1e-8), lr times the sign of g: every
    element whose first moment exceeds 1e-3 of its leaf's largest takes
    JAX's step within 2e-3 lr (fp32 rounds a parameter near 0.5 to 6e-4 lr);
    an element below that, whose gradient is rounding noise, takes a step
    of at most lr (plus the rounding) either way."""
    unpool, jt, tvars, teacher, js, svars, student = towers
    cos_power = 2 if unpool else 0
    x = images()
    jstate, jmetrics = _jax_step(jax_steps, towers, use_agc)
    loss, params, mu, got_bs = _port_step(student, teacher, x, cos_power, use_agc)
    noise = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    _, _, mu_moved, _ = _port_step(student, teacher, (x * (1 + 1e-7 * noise)).astype(np.float32),
                                cos_power, use_agc)
    assert abs(loss - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    want_mu, before, want_p = (_first_moment(jstate.opt_state), _flat(svars["params"]),
                               _flat(jstate.params))
    want_mu = {k[len("params/"):] if k.startswith("params/") else k: v
               for k, v in want_mu.items()}
    assert sorted(mu) == sorted(want_mu) == sorted(want_p)
    top = max(float(np.linalg.norm(m)) for m in want_mu.values())
    spread = max(float(np.linalg.norm(mu_moved[k] - m)) for k, m in mu.items()) / top
    assert 0 < spread <= 1e-4
    lr = 1e-4
    for name, m in want_mu.items():
        assert float(np.linalg.norm(mu[name] - m)) <= 10 * spread * top, name
        du_want, du_got = want_p[name] - before[name], params[name] - before[name]
        signal = np.abs(m) > 1e-3 * np.abs(m).max()
        assert np.abs(du_got - du_want)[signal].max() <= 2e-3 * lr, name
        assert np.abs(du_got).max() <= 1.01 * lr, name  # + the rounding of |p| <= 10
    for name, w in _flat(jstate.batch_stats).items():
        assert _rel(got_bs[name], w) <= 1e-5, name


def test_amp_kd_loss_within_jax_amp_distance(towers, jax_steps):
    """The bf16 amp step's loss (both towers in bf16 over f32 parameters)
    against the JAX amp step's: within twice the JAX amp loss's distance
    from the JAX fp32 loss (and 1e-3 relative, bf16's rounding at the
    feature level, when that distance happens to be smaller)."""
    from bcosification_tpu.training import kd as jkd
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.training import kd, steps

    unpool, jt, tvars, teacher, js, svars, student = towers
    cos_power = 2 if unpool else 0
    x = images()
    jopt, _ = _recipe(port=False)
    tx = jopt.create(1e-4, svars["params"])
    # the fp32 loss is the recipe step's (the loss comes before the update)
    losses = {False: float(_jax_step(jax_steps, towers, False)[1]["loss"])}
    jstep = jkd.make_kd_train_step(js, jt, tvars, tx, cos_power=cos_power, donate=False,
                                   amp=True)
    _, m = jstep(jsteps.create_train_state(svars, tx), {"image": jnp.asarray(x)})
    losses[True] = float(m["loss"])
    opt, _ = _recipe()
    state = steps.create_train_state(student, opt.create, device="cpu")
    _, metrics = kd.make_kd_train_step(teacher, 1e-4, cos_power=cos_power, amp=True)(
        state, {"image": torch.from_numpy(x)})
    got = float(metrics["loss"])
    assert metrics["loss"].dtype == torch.float32 and np.isfinite(got)
    jax_spread = abs(losses[True] - losses[False])
    assert abs(got - losses[True]) <= max(2 * jax_spread, 1e-3 * abs(losses[False])), (
        got, losses)


def test_agc_unit_axis_of_in_out_linears_matches_jax():
    """AGC on the port's (in, out) linears (the attention pool's q/k/v and
    the B-cos c_proj) clips each OUTPUT unit, the last axis, as the JAX
    package does on its (in, out) leaves, and so does the plain attention
    pool's [HW + 1, C] positional embedding; a conv's OIHW weight keeps the
    first axis."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu_torch.modules import BcosConv2d
    from bcosification_tpu_torch.modules.bcosattnpool import AttentionPool2d
    from bcosification_tpu_torch.modules.bcos_layers import BcosifyLinear, PlainLinear
    from bcosification_tpu_torch.training import agc

    net = torch.nn.ModuleDict({"q": PlainLinear(16, 8, use_bias=True),
                               "c_proj": BcosifyLinear(16, 12, b=2.0, use_bias=False),
                               "conv": BcosConv2d(6, 8, 3),
                               "pool": AttentionPool2d(16, 2, 8, spacial_dim=2)})
    rng = np.random.default_rng(3)
    params, grads = {}, {}
    for name, p in net.named_parameters():
        g = rng.standard_normal(p.shape) * np.where(rng.random(p.shape) < 0.5, 1.0, 1e-4)
        p.grad = torch.from_numpy(g.astype(np.float32))
        jax_layout = (lambda a: a.transpose(2, 3, 1, 0)) if p.ndim == 4 else (lambda a: a)
        params[name] = jnp.asarray(np.array(jax_layout(p.detach().numpy())))
        grads[name] = np.array(jax_layout(p.grad.numpy()))  # a copy: clipping is in place
    want = jagc.adaptive_clip_grads(params, {k: jnp.asarray(g) for k, g in grads.items()},
                                    clip_factor=0.01)
    agc.adaptive_clip_grads_(net, clip_factor=0.01)
    for name, p in net.named_parameters():
        got = p.grad.numpy()
        got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
        np.testing.assert_allclose(got, np.asarray(want[name]), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        if name.endswith(("weight", "positional_embedding")):
            assert not np.array_equal(got, grads[name]), name  # it clipped


# --------------------------------------------------------------------------
# Trainer.fit_kd
# --------------------------------------------------------------------------
class KDData:
    """16 images of 64x64 in 2 train batches of 8 (the JAX Trainer splits a
    batch over its 8 CPU devices), with keys as the CC3M pipeline gives
    them; validation sees the first batch."""

    batch_size = 8

    def __init__(self):
        self.images = images(16, seed=5)

    def setup(self, stage=None):
        pass

    def _batches(self):
        for s in (0, 8):
            yield {"image": self.images[s:s + 8], "key": [f"{i:05d}" for i in range(s, s + 8)]}

    def train_dataloader(self, seed=0):
        data = self

        class Loader:
            def __iter__(self):
                return data._batches()

            def __len__(self):
                return 2

            def set_epoch(self, epoch):
                pass

        return Loader()

    def val_dataloader(self):
        return [next(self._batches())]


def _kd_experiment(save_dir, port=True, attn_unpool=False):
    if port:
        from bcosification_tpu_torch.losses import SigLipLoss
        from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    else:
        from bcosification_tpu.losses import SigLipLoss
        from bcosification_tpu.optim import LRSchedulerFactory, OptimizerFactory
    config = dict(
        clip_kd=True, model=_model_config(attn_unpool), criterion=SigLipLoss(),
        test_criterion=SigLipLoss(),
        optimizer=OptimizerFactory(name="Adam", lr=1e-3, bcosify=True, b_opt=False),
        lr_scheduler=LRSchedulerFactory(name="cosineannealinglr", epochs=3),
        trainer=dict(max_epochs=2), use_agc=True)
    return types.SimpleNamespace(config=config, save_dir=Path(save_dir))


def _patch_clip_load(monkeypatch, jax_teacher, teacher):
    """clip.load.load of both packages returns the small teacher (and no
    text tower); no zero-shot data is configured."""
    import importlib

    import bcosification_tpu.settings as jsettings
    import bcosification_tpu_torch.settings as tsettings

    # the packages' clip/__init__ export the function load over the module
    jload = importlib.import_module("bcosification_tpu.clip.load")
    tload = importlib.import_module("bcosification_tpu_torch.clip.load")

    jt, tvars = jax_teacher
    monkeypatch.setattr(jload, "load", lambda name="RN50", pretrained=True: (
        jt, tvars, None, None, 100.0, dict(CFG)))
    monkeypatch.setattr(tload, "load", lambda name="RN50", pretrained=True, *, device=None: (
        teacher, None, 100.0, dict(CFG)))
    for settings in (jsettings, tsettings):
        monkeypatch.setattr(settings, "DATA_ROOT", None)
        monkeypatch.setattr(settings, "IMAGENET_PATH", None)


def _history(save_dir):
    with gzip.open(Path(save_dir) / "metrics" / "metrics.json.gz", "rt") as f:
        return json.load(f)


def test_fit_kd_matches_jax(teachers, pooled_student, tmp_path, monkeypatch):
    """Two epochs of fit_kd (Adam 1e-3 with the cosine, AGC) from the same
    student and teacher: per-epoch train_loss and val_loss against the JAX
    fit_kd (1e-4 relative, as the supervised fit is held); metrics.csv;
    the checkpoints ranked by val_loss (min); a resume that runs only the
    third epoch; the teacher untouched; the caller's student untouched."""
    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.training.trainer import Trainer

    jt, tvars, teacher = teachers
    js, svars, student = pooled_student
    _patch_clip_load(monkeypatch, (jt, tvars), teacher)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    student_before = {k: v.clone() for k, v in student.state_dict().items()}
    data = KDData()
    JaxTrainer(_kd_experiment(tmp_path / "jax", port=False)).fit(js, svars, data, max_epochs=2)
    exp = _kd_experiment(tmp_path / "port")
    trainer = Trainer(exp, device="cpu")
    state = trainer.fit(student, data, max_epochs=2)
    assert state.step == 4 and state.ema is None
    want, got = _history(tmp_path / "jax"), _history(exp.save_dir)
    for key in ("train_loss", "val_loss"):
        assert [e for e, _ in got[key]] == [0, 1]
        np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in want[key]],
                                   rtol=1e-4, err_msg=key)
    assert got["train_loss"][1][1] < got["train_loss"][0][1]  # it learns
    with open(exp.save_dir / "metrics.csv") as f:
        assert f.readline().strip().split(",") == ["epoch", "epoch_time_s", "train_loss",
                                                   "val_loss"]
    assert (trainer.ckpt.monitor, trainer.ckpt.mode) == ("val_loss", "min")
    val = {e: v for e, v in got["val_loss"]}
    assert trainer.ckpt.resolve("best") == min(val, key=val.get)
    assert all(torch.equal(v, teacher_before[k]) for k, v in teacher.state_dict().items())
    assert all(torch.equal(v, student_before[k]) for k, v in student.state_dict().items())

    resumed = Trainer(exp, device="cpu").fit(student, data, max_epochs=3)
    assert resumed.step == 6
    assert [e for e, _ in _history(exp.save_dir)["val_loss"]] == [0, 1, 2]
    assert trainer.ckpt.available_checkpoints() == [0, 1, 2]


def _write_shard(path, n, rng):
    from PIL import Image

    with tarfile.open(path, "w") as tf:
        for i in range(n):
            arr = (rng.random((72, 80, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            for ext, data in (("jpg", buf.getvalue()), ("txt", f"caption {i}".encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_run_training_routes_cc3m_kd_to_fit_kd(teachers, pooled_student, tmp_path,
                                              monkeypatch):
    """``run_training`` of the CC3M KD config (its model factory patched to
    the small student, its transforms to 64x64 crops, batch 4) over a CC3M
    tree whose 332 train shards are links to one: Trainer.fit goes to
    fit_kd, one step (--fast_dev_run), a val_loss-ranked checkpoint."""
    import bcosification_tpu_torch.experiments.CC3M.clip_bcosification.model as cc3m_model
    from bcosification_tpu_torch.data.presets import (
        CLIPBcosImageNetClassificationPresetEval,
        CLIPBcosImageNetClassificationPresetTrain,
    )
    from bcosification_tpu_torch.experiments.CC3M.clip_bcosification import (
        experiment_parameters as params,
    )
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.training.trainer import run_training
    import bcosification_tpu_torch.settings as tsettings

    jt, tvars, teacher = teachers
    student = copy.deepcopy(pooled_student[2])
    _patch_clip_load(monkeypatch, (jt, tvars), teacher)
    root = tmp_path / "cc3m"
    (root / "training").mkdir(parents=True)
    (root / "validation").mkdir()
    rng = np.random.default_rng(0)
    _write_shard(root / "training" / "00000.tar", 4, rng)
    for i in range(1, 332):
        os.symlink("00000.tar", root / "training" / f"{i:05d}.tar")
    _write_shard(root / "validation" / "00000.tar", 4, rng)
    os.symlink("00000.tar", root / "validation" / "00001.tar")
    monkeypatch.setattr(tsettings, "CC3M_PATH", str(root))
    name = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_kd_CC3M_bcosification"
    data = params.CONFIGS[name]["data"]
    monkeypatch.setitem(data, "train_transform",
                        CLIPBcosImageNetClassificationPresetTrain(crop_size=SIZE))
    monkeypatch.setitem(data, "test_transform",
                        CLIPBcosImageNetClassificationPresetEval(crop_size=SIZE, resize_size=72))
    monkeypatch.setitem(data, "batch_size", 4)
    monkeypatch.setattr(cc3m_model, "get_model", lambda config, device=None: student)
    args = types.SimpleNamespace(dataset="CC3M", base_network="clip_bcosification",
                                 experiment_name=name, fast_dev_run=True, resume=True,
                                 base_directory=str(tmp_path / "exp"), amp=False)
    state = run_training(args, device="cpu")
    assert state.step == 1
    exp = Experiment("CC3M", "clip_bcosification", name)
    history = exp.load_metrics()
    assert sorted(history) == ["epoch_time_s", "train_loss", "val_loss"]
    assert all(np.isfinite(history[k][0][1]) for k in ("train_loss", "val_loss"))
    assert exp.available_checkpoints() == [0]
    assert exp._ckpt_manager().monitor == "val_loss"


def test_maybe_zeroshot_matches_jax(tmp_path, monkeypatch):
    """fit_kd's per-epoch zero-shot: with IMAGENET_PATH at a small synthetic
    tree (2 classes, 6 val JPEGs) and IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH at
    a classifier whose two classes' columns are their mean student features,
    the port's zeroshot_ImageNet_acc1 equals the JAX Trainer's on the same
    student (pooled, 224x224, the eval preset); missing data is skipped,
    only that."""
    from PIL import Image

    from bcosification_tpu.training.trainer import Trainer as JaxTrainer
    from bcosification_tpu_torch.data.presets import CLIPBcosImageNetClassificationPresetEval
    from bcosification_tpu_torch.data.synthetic import write_imagenet_tree
    from bcosification_tpu_torch.training.trainer import Trainer
    import bcosification_tpu.settings as jsettings
    import bcosification_tpu_torch.settings as tsettings

    js, svars, student = student_pair(False, cfg=dict(CFG, image_resolution=224))
    root = tmp_path / "imagenet"
    write_imagenet_tree(root, n_classes=2, n_train=0, n_val=6, sizes=((80, 60),))
    preset = CLIPBcosImageNetClassificationPresetEval(crop_size=224)
    val = sorted((root / "val").rglob("*.JPEG"))
    images = np.stack([np.asarray(preset(Image.open(p).convert("RGB")), np.float32)
                       for p in val])
    with torch.no_grad():
        feats = student(torch.from_numpy(np.concatenate([images, 1 - images], -1))).numpy()
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    w = np.random.default_rng(1).standard_normal((32, 1000)).astype(np.float32) * 0.01
    for c, wnid in enumerate(sorted(d.name for d in (root / "val").iterdir())):
        w[:, c] = feats[[i for i, p in enumerate(val) if p.parent.name == wnid]].mean(0)
    np.save(tmp_path / "w.npy", w)
    for settings in (jsettings, tsettings):
        monkeypatch.setattr(settings, "IMAGENET_PATH", str(root))
        monkeypatch.setattr(settings, "DATA_ROOT", None)
        monkeypatch.setattr(settings, "IMAGENET_RN50_ZEROSHOT_WEIGHTS_PATH",
                            str(tmp_path / "w.npy"))
    trainer = Trainer(_kd_experiment(tmp_path / "port"), device="cpu")
    got = trainer._maybe_zeroshot(student, None, 0)
    want = JaxTrainer._maybe_zeroshot(
        types.SimpleNamespace(config={"model": {}}, _io_process=True), js,
        types.SimpleNamespace(params=svars["params"], batch_stats=svars["batch_stats"]),
        None, None)
    assert sorted(got) == ["zeroshot_ImageNet_acc1"] and got == want
    assert got["zeroshot_ImageNet_acc1"] > 0.5  # the classifier carries signal
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", str(tmp_path / "missing"))
    assert trainer._maybe_zeroshot(student, None, 0) == {}
