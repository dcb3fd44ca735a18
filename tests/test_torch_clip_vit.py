"""The CLIP ViT towers of the port (``clip/model.py::CLIPVisionTransformer``,
the ViT half of ``bcosify/clip_import.py``, ``explain/fast_clip_vit.py``,
the vit*clip configs, their text localisation and their KD) against the JAX
package, on the CPU, in fp32, on the same weights (the harness's
``standard_clip`` ViTs: ``tests/test_torch_clip_benchmark.py``).

The tower is the tiny one of ``tests/test_clip_vit_bcosify.py`` (width 64,
2 blocks, 1 head, patch 8, 32x32: 16 patch tokens and the class token,
embed_dim 16) in OpenAI's key layout (``vit_state_dict``; LayerNorm weights
and biases drawn too, so every term carries signal), with a 1-block text
tower of width 64. The JAX towers are built from it by the JAX importer,
and their variables carried into the port's towers by ``from_jax``; the
port's own importer is held to the JAX one leaf for leaf.
"""
import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

W, L, P, R, E = 64, 2, 8, 32, 16
TEXT_WIDTH = 64
STUDENT = {"bcosify_args": {"use_bias": False}, "bcos_args": {"b": 2}}
UNPOOL = {**STUDENT, "attn_unpool": True, "cos_power": 2}
CONFIGS = [f"vit_{tag}_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification{suffix}"
           for tag in ("b_32", "b_16", "l_14") for suffix in ("", "_attnUnpool")]


def vit_state_dict(seed=0):
    """A random CLIP-ViT checkpoint (the visual tower at W, L, P, R, E and a
    1-block text tower of width TEXT_WIDTH) in OpenAI's key layout and
    torch shapes ((out, in) linears, OIHW convs)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, scale=0.05):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(key, d):
        sd[f"{key}.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        put(f"{key}.bias", d, scale=0.05)

    def blocks(prefix, d, layers):
        for i in range(layers):
            p = f"{prefix}.{i}"
            put(f"{p}.attn.in_proj_weight", 3 * d, d, scale=d ** -0.5)
            put(f"{p}.attn.in_proj_bias", 3 * d, scale=0.05)
            put(f"{p}.attn.out_proj.weight", d, d, scale=d ** -0.5)
            put(f"{p}.attn.out_proj.bias", d, scale=0.05)
            put(f"{p}.mlp.c_fc.weight", 4 * d, d, scale=d ** -0.5)
            put(f"{p}.mlp.c_fc.bias", 4 * d, scale=0.05)
            put(f"{p}.mlp.c_proj.weight", d, 4 * d, scale=(4 * d) ** -0.5)
            put(f"{p}.mlp.c_proj.bias", d, scale=0.05)
            ln(f"{p}.ln_1", d)
            ln(f"{p}.ln_2", d)

    put("visual.conv1.weight", W, 3, P, P, scale=(3 * P * P) ** -0.5)
    put("visual.class_embedding", W, scale=W ** -0.5)
    put("visual.positional_embedding", (R // P) ** 2 + 1, W, scale=W ** -0.5)
    put("visual.proj", W, E, scale=W ** -0.5)
    ln("visual.ln_pre", W)
    ln("visual.ln_post", W)
    blocks("visual.transformer.resblocks", W, L)
    d = TEXT_WIDTH
    put("token_embedding.weight", 49408, d, scale=0.02)
    put("positional_embedding", 77, d, scale=0.01)
    blocks("transformer.resblocks", d, 1)
    ln("ln_final", d)
    put("text_projection", d, E, scale=d ** -0.5)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


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


def _images(n=2, seed=0, channels=6):
    x = np.random.default_rng(seed).random((n, R, R, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1) if channels == 6 else x


@pytest.fixture(scope="module")
def sd():
    return vit_state_dict()


def _jax_student(sd, model_config):
    from bcosification_tpu.bcosify.clip_import import build_bcosified_clip_vit_visual
    from bcosification_tpu.clip import model as jclip

    return build_bcosified_clip_vit_visual(model_config, sd, jclip.config_from_state_dict(sd))


def _port_twin(build, jax_variables, sd, model_config=None):
    """The port's tower of ``sd``'s configuration, built at random init and
    filled with the JAX variables through ``from_jax``."""
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.clip import model as clip_model

    cfg = clip_model.config_from_state_dict(sd)
    net = (build(None, cfg, device="cpu", seed=5) if model_config is None
           else build(model_config, None, cfg, device="cpu", seed=5))
    load_jax_variables(net, jax.tree_util.tree_map(np.asarray, jax_variables))
    return net


@pytest.fixture(scope="module")
def teachers(sd):
    from bcosification_tpu.bcosify.clip_import import build_clip_teacher_visual as jbuild
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual

    jt, tvars = jbuild(sd, jclip.config_from_state_dict(sd))
    return jt, tvars, _port_twin(build_clip_teacher_visual, tvars, sd)


@pytest.fixture(scope="module", params=[False, True], ids=["pooled", "unpool"])
def students(request, sd):
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_vit_visual

    mc = UNPOOL if request.param else STUDENT
    js, svars = _jax_student(sd, mc)
    return request.param, js, svars, _port_twin(build_bcosified_clip_vit_visual, svars, sd, mc)


# --------------------------------------------------------------------------
# configurations and the import
# --------------------------------------------------------------------------
class _Shaped:
    def __init__(self, *shape):
        self.shape = shape


def _openai_shapes(name):
    """{key: object with .shape} of the OpenAI checkpoint of the published
    ViT ``name``: the entries the config readers look at."""
    width, layers, patch, embed = {"ViT-B/32": (768, 12, 32, 512), "ViT-B/16": (768, 12, 16, 512),
                                   "ViT-L/14": (1024, 24, 14, 768)}[name]
    text = 512 if "B/" in name else 768
    sd = {"visual.conv1.weight": _Shaped(width, 3, patch, patch),
          "visual.positional_embedding": _Shaped((224 // patch) ** 2 + 1, width),
          "visual.proj": _Shaped(width, embed), "text_projection": _Shaped(text, embed),
          "positional_embedding": _Shaped(77, text),
          "token_embedding.weight": _Shaped(49408, text), "ln_final.weight": _Shaped(text)}
    sd.update({f"visual.transformer.resblocks.{i}.attn.in_proj_weight": _Shaped(3 * width, width)
               for i in range(layers)})
    sd.update({f"transformer.resblocks.{i}.ln_1.weight": _Shaped(text) for i in range(12)})
    return sd


@pytest.mark.parametrize("name", ["ViT-B/32", "ViT-B/16", "ViT-L/14"])
def test_configs_match_jax(name, sd):
    """clip_vit_config and config_from_state_dict (the published shapes and
    the tiny checkpoint) equal the JAX package's; the published checkpoint's
    shapes read back as the published config."""
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu_torch.clip import model as clip_model

    assert clip_model.clip_vit_config(name) == jclip.clip_vit_config(name)
    shapes = _openai_shapes(name)
    assert clip_model.config_from_state_dict(shapes) == jclip.config_from_state_dict(shapes)
    assert clip_model.config_from_state_dict(shapes) == clip_model.clip_vit_config(name)
    got = clip_model.config_from_state_dict(sd)
    assert got == jclip.config_from_state_dict(sd)
    assert (got["vision_layers"], got["vision_patch_size"], got["image_resolution"],
            got["embed_dim"]) == (L, P, R, E)


@pytest.mark.parametrize("tower", ["teacher", "student", "student_useBias"])
def test_import_matches_jax(tower, sd):
    """The port's imports of the checkpoint (``_visual_vit_entries``) equal
    the JAX imports leaf for leaf: the teacher as it is; the student with
    its patchify conv doubled to [w, -w] / 2, the q/k/v bias zeroed and the
    other biases dropped (kept with use_bias)."""
    from bcosification_tpu.bcosify.clip_import import build_clip_teacher_visual as jteacher
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_bcosified_clip_vit_visual,
        build_clip_teacher_visual,
    )
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables

    cfg = jclip.config_from_state_dict(sd)
    if tower == "teacher":
        _, want = jteacher(sd, cfg)
        net = build_clip_teacher_visual(sd, device="cpu")
    else:
        mc = {**STUDENT, "bcosify_args": {"use_bias": tower.endswith("useBias")}}
        _, want = _jax_student(sd, mc)
        net = build_bcosified_clip_vit_visual(mc, sd, device="cpu")
    got, want = _flat(to_jax_variables(net)["params"]), _flat(want["params"])
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape and np.array_equal(got[name], leaf), name
    if tower == "student":
        in_bias = [k for k in got if k.endswith("attn_in_proj/bias")]
        assert in_bias and all(not got[k].any() for k in in_bias)
        assert not any(k.endswith(("mlp_c_fc/bias", "attn_out_proj/bias")) for k in got)


def test_import_is_strict(sd):
    """A missing entry or one that maps onto nothing raises."""
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_vit_visual

    broken = dict(sd)
    del broken["visual.ln_pre.bias"]
    with pytest.raises(KeyError, match="ln_pre"):
        build_bcosified_clip_vit_visual(STUDENT, broken, device="cpu")
    extra = {**sd, "visual.unknown": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="unknown"):
        build_bcosified_clip_vit_visual(STUDENT, extra, device="cpu")


# --------------------------------------------------------------------------
# the towers
# --------------------------------------------------------------------------
def test_teacher_forward_matches_jax(teachers):
    jt, tvars, teacher = teachers
    x = _images(channels=3)
    want = np.asarray(jax.jit(jt.apply)(tvars, jnp.asarray(x)))
    with torch.no_grad():
        got = teacher(torch.from_numpy(x)).numpy()
    assert got.shape == (2, E) and np.abs(want).max() > 1e-2
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("explain", [False, True], ids=["forward", "explain"])
def test_student_features_match_jax(students, explain):
    """Pooled [B, E] and unpooled [B, HW, E] features, explanation mode off
    and on (the same values), against the JAX tower (1e-5)."""
    unpool, js, svars, student = students
    x = _images()
    apply = jax.jit(lambda v, inp: js.apply(v, inp, train=False, explain=explain))
    want = np.asarray(apply(svars, jnp.asarray(x)))
    with torch.no_grad():
        got = student(torch.from_numpy(x), explain=explain).numpy()
    assert got.shape == ((2, (R // P) ** 2, E) if unpool else (2, E))
    assert np.abs(want).max() > 1e-2  # not a contracted, vacuous output
    assert _rel(got, want) <= 1e-5
    if unpool:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_b1_conversion_oracle(sd):
    """b=1 with the biases kept: the student equals the teacher on the
    Normalize's [z, -z] encoding (2e-6), as the JAX oracle holds it."""
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_bcosified_clip_vit_visual,
        build_clip_teacher_visual,
    )
    from bcosification_tpu_torch.models.bcosify_net import normalization_for

    teacher = build_clip_teacher_visual(sd, device="cpu")
    student = build_bcosified_clip_vit_visual(
        {"bcosify_args": {"use_bias": True}, "bcos_args": {"b": 1}}, sd, device="cpu")
    mean, std = normalization_for(clip_kd=True, bfy_mean_zero=False)
    raw = _images(channels=3, seed=4)
    z = (raw - np.asarray(mean)[:3]) / np.asarray(std)[:3]
    with torch.no_grad():
        t_out = teacher(torch.from_numpy(z.astype(np.float32))).numpy()
        s_out = student(torch.from_numpy(np.concatenate([raw, 1.0 - raw], -1))).numpy()
    np.testing.assert_allclose(s_out, t_out, atol=2e-6)


def _jax_text_w(js, svars, x, t):
    from bcosification_tpu.explain import fast_clip as jfast

    def score(inp, v, tt):
        scores = jfast.text_score_head(js.apply(v, inp, train=False, explain=True), tt)
        return scores.sum(), scores

    (_, scores), w = jax.jit(jax.value_and_grad(score, has_aux=True))(jnp.asarray(x), svars, t)
    return np.asarray(scores), np.asarray(w)


@pytest.fixture(scope="module")
def text_direction():
    return np.random.default_rng(3).standard_normal(E).astype(np.float32)


def test_fast_text_dlw_matches_jax(students, text_direction):
    """fast_clip_vit.fast_text_dlw (the autograd-free pass) against JAX's
    value_and_grad of the explain-mode tower through text_score_head:
    scores and W within 1e-5; the port's module path through autograd
    within 1e-5 too."""
    from bcosification_tpu_torch.explain import fast_clip, fast_clip_vit

    unpool, js, svars, student = students
    x = _images(seed=2)
    want_s, want_w = _jax_text_w(js, svars, x, jnp.asarray(text_direction))
    t = torch.from_numpy(text_direction)
    assert fast_clip_vit.supports(student) and not fast_clip.supports(student)
    scores, w = fast_clip_vit.fast_text_dlw(student, torch.from_numpy(x), t, device="cpu")
    assert np.abs(want_w).max() > 1e-4
    assert _rel(scores.numpy(), want_s) <= 1e-5 and _rel(w.numpy(), want_w) <= 1e-5
    xt = torch.from_numpy(x).requires_grad_(True)
    module_scores = fast_clip.text_score_head(student(xt, explain=True), t)
    (module_w,) = torch.autograd.grad(module_scores.sum(), xt)
    assert _rel(module_w.numpy(), want_w) <= 1e-5


def test_export_text_explain_round_trip(sd, text_direction):
    """serving.export_text_explain of the unpooled ViT student: the loaded
    program equals the eager pass (the same ops on the same inputs), at a
    batch other than the example's."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_vit_visual
    from bcosification_tpu_torch.explain import fast_clip_vit

    student = build_bcosified_clip_vit_visual(UNPOOL, sd, device="cpu")
    blob = serving.export_text_explain(student, embed_dim=E, input_size=R, device="cpu")
    x, t = torch.from_numpy(_images(n=3, seed=5)), torch.from_numpy(text_direction)
    got_s, got_w = serving.load_serialized(blob).call(x, t)
    want_s, want_w = fast_clip_vit.fast_text_dlw(student, x, t, device="cpu")
    assert torch.equal(got_s, want_s) and torch.equal(got_w, want_w)


class _JittedApply:
    """A JAX tower whose ``apply`` is compiled once by jax.jit rather than
    op by op (the same function; no JAX fast pass takes it, as none takes
    the ViT)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("train", "explain"))


def test_text_localisation_matches_jax(sd, text_direction):
    """compute_attributions of the unpooled student: the port takes the
    hand-scheduled pass, the JAX package autograd; score and W within 1e-5,
    on the 4x4 token grid."""
    from bcosification_tpu.interpretability.analyses import text_localisation as jtl
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_vit_visual
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as tl

    js, svars = _jax_student(sd, UNPOOL)
    student = _port_twin(build_bcosified_clip_vit_visual, svars, sd, UNPOOL)
    image = _images(n=1, seed=6)
    want = jtl.compute_attributions(_JittedApply(js), svars, jnp.asarray(text_direction),
                                    jnp.asarray(image), pool_cosine=2)
    got = tl.compute_attributions(student, torch.from_numpy(text_direction),
                                  torch.from_numpy(image), pool_cosine=2, device="cpu")
    assert abs(got["score"] - want["score"]) <= 1e-5 * abs(want["score"])
    assert _rel(got["dynamic_linear_weights"].numpy(), want["dynamic_linear_weights"]) <= 1e-5


# --------------------------------------------------------------------------
# KD and AGC
# --------------------------------------------------------------------------
def test_agc_unit_axes_match_jax(students):
    """AGC on every leaf of the ViT student, its raw (width, out) proj and
    positional embedding among them (the unit on the last axis, as the JAX
    layout), against the JAX transform, with gradients large enough that
    every leaf is clipped."""
    from bcosification_tpu.training import agc as jagc
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import agc

    _, _, _, student = students
    net = copy.deepcopy(student).requires_grad_(True)
    as_grads = copy.deepcopy(student)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for p, g in zip(net.parameters(), as_grads.parameters()):
            p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            g.copy_(p.grad)
    params, grads = to_jax_variables(net)["params"], to_jax_variables(as_grads)["params"]
    want = _flat(jax.jit(jagc.adaptive_clip_grads)(params, grads))
    agc.adaptive_clip_grads_(net)
    with torch.no_grad():
        for p, g in zip(net.parameters(), as_grads.parameters()):
            g.copy_(p.grad)
    got, raw = _flat(to_jax_variables(as_grads)["params"]), _flat(grads)
    assert "model/proj" in got and "model/positional_embedding" in got
    for name, g in want.items():
        assert _rel(got[name], g) <= 1e-6, name
        assert _rel(g, raw[name]) > 1e-3, name  # clipped


def test_kd_train_step_matches_jax(sd, teachers, students):
    """One step of the KD recipe (Adam 1e-4 with the cosine, AGC; SigLIP,
    cos_power 2 for the unpooled student) against the JAX step: the loss
    (1e-5) and Adam's first moment leaf by leaf within ten times the port's
    spread under 1e-7 relative input noise, as tests/test_torch_kd.py holds
    the CLIP-RN50 step."""
    from test_torch_kd import _first_moment, _recipe

    from bcosification_tpu.training import kd as jkd
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.training import kd, steps

    jt, tvars, teacher = teachers
    unpool, js, svars, student = students
    cos_power = 2 if unpool else 0
    x = _images(n=3, seed=7, channels=3)
    jopt, jsched = _recipe(port=False)
    tx = jopt.create(jsched, svars["params"])
    jstep = jkd.make_kd_train_step(js, jt, tvars, tx, cos_power=cos_power, use_agc=True,
                                   donate=False)
    jstate, jmetrics = jstep(jsteps.create_train_state(svars, tx), {"image": jnp.asarray(x)})

    def port_step(images):
        opt, sched = _recipe()
        state = steps.create_train_state(student, opt.create, device="cpu")
        step = kd.make_kd_train_step(teacher, sched, cos_power=cos_power, use_agc=True)
        state, metrics = step(state, {"image": torch.from_numpy(images)})
        mu = {}
        for name, p in state.model.named_parameters():
            m = state.optimizer.state[p]["exp_avg"].numpy()
            mu["/".join(name.split("."))] = m.transpose(2, 3, 1, 0) if m.ndim == 4 else m
        return float(metrics["loss"]), mu

    loss, mu = port_step(x)
    noise = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    _, mu_moved = port_step((x * (1 + 1e-7 * noise)).astype(np.float32))
    assert abs(loss - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    want = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in _first_moment(jstate.opt_state).items()}
    assert sorted(mu) == sorted(want)
    top = max(float(np.linalg.norm(m)) for m in want.values())
    spread = max(float(np.linalg.norm(mu_moved[k] - m)) for k, m in mu.items()) / top
    assert 0 < spread <= 1e-4
    for name, m in want.items():
        assert float(np.linalg.norm(mu[name] - m)) <= 10 * spread * top, name


# --------------------------------------------------------------------------
# the experiments, clip.load and the harness
# --------------------------------------------------------------------------
@pytest.mark.parametrize("config", CONFIGS)
def test_experiment_get_model_matches_jax(config, monkeypatch):
    """Experiment("ImageNet", "clip_bcosification", <vit config>).get_model
    builds the same tower as the JAX package's (the published configs cut
    to width 64 and one block in both; the JAX one traced by jax.eval_shape,
    so its init is not compiled): the same leaves and shapes, and the pooled
    or unpooled head on the config's token grid at 224^2 (the features
    themselves are held to JAX by the tests above)."""
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu.experiments.utils import Experiment as JExperiment
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.clip import model as clip_model
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    monkeypatch.setenv("CLIP_WEIGHTS_DIR", "/nonexistent")
    published = clip_model.clip_vit_config

    def tiny(name):
        return {**published(name), "vision_width": 64, "vision_layers": 1, "embed_dim": 16}

    for module in (jclip, clip_model):
        monkeypatch.setattr(module, "clip_vit_config", tiny)
    svars = jax.eval_shape(
        lambda: JExperiment("ImageNet", "clip_bcosification", config).get_model()[1])
    want = {"/".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(svars["params"])[0]}
    net = Experiment("ImageNet", "clip_bcosification", config).get_model(device="cpu")
    got = {k: v.shape for k, v in _flat(to_jax_variables(net)["params"]).items()}
    assert got == want
    assert net.model.unpool == config.endswith("_attnUnpool")
    x = np.random.default_rng(0).random((1, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(np.concatenate([x, 1.0 - x], axis=-1)))
    patch = {"b_32": 32, "b_16": 16, "l_14": 14}[config.split("_clip")[0][len("vit_"):]]
    assert out.shape == (((1, (224 // patch) ** 2, 16) if net.model.unpool else (1, 16)))
    assert torch.isfinite(out).all()


def test_clip_load_builds_the_vit_towers(sd, tmp_path, monkeypatch):
    """clip.load of a ViT name from a local checkpoint: the teacher and the
    text tower equal the JAX package's (1e-5); the ViT-B/16 tower's config
    (the published towers are built by
    tests/test_torch_clip_import.py::test_load_builds_the_towers_and_refuses_vit
    and, as students, by tests/test_torch_clip_zeroshot.py)."""
    from bcosification_tpu_torch.clip import model as clip_model

    jload = importlib.import_module("bcosification_tpu.clip.load")
    tload = importlib.import_module("bcosification_tpu_torch.clip.load")
    np.savez(tmp_path / "ViT-B-16.npz", **sd)
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path))
    jv, jvars, jt, jtvars, jscale, jcfg = jload.load("ViT-B/16")
    visual, text, scale, cfg = tload.load("ViT-B/16", device="cpu")
    assert cfg == jcfg and scale == pytest.approx(jscale)
    x = _images(channels=3, seed=8)
    tokens = np.asarray(tload.tokenize(["a photo of a dog", "a cat"]))
    with torch.no_grad():
        got_img = visual(torch.from_numpy(x)).numpy()
        got_txt = text(torch.from_numpy(tokens)).numpy()
    assert _rel(got_img, jax.jit(jv.apply)(jvars, jnp.asarray(x))) <= 1e-5
    assert _rel(got_txt, jax.jit(jt.apply)(jtvars, jnp.asarray(tokens))) <= 1e-5
    assert isinstance(visual, clip_model.CLIPVisionTransformer)
    assert clip_model.clip_vit_config("ViT-B/16") == jload.clip_model.clip_vit_config("ViT-B/16")
    assert clip_model.clip_vit_config("ViT-B/16")["transformer_width"] == 512


def test_text_localisation_main_on_a_vit_experiment(tmp_path, monkeypatch):
    """text_localisation.main on the attn-unpool ViT-B/16 experiment (the
    tower cut to width 64 and one block, at 224^2: its per-location logits
    on the 14x14 token grid) with --random_img_path: the result equals
    compute_attributions on the loaded image through the hand-scheduled
    pass, and the .npz and .png are written."""
    from PIL import Image

    from bcosification_tpu_torch import settings
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_bcosified_clip_vit_visual,
        build_clip_text,
    )
    from bcosification_tpu_torch.clip.model import clip_vit_config
    from bcosification_tpu_torch.data.imagenet import imagenet_templates
    from bcosification_tpu_torch.experiments.utils import experiment_utils
    from bcosification_tpu_torch.explain import fast_clip_vit
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as ttl

    cfg = {**clip_vit_config("ViT-B/16"), "vision_width": 64, "vision_layers": 1,
           "embed_dim": E, "transformer_width": 64, "transformer_heads": 1,
           "transformer_layers": 1}
    student = build_bcosified_clip_vit_visual(UNPOOL, None, cfg, device="cpu", seed=3)
    text = build_clip_text(None, cfg, device="cpu", seed=4)
    clip_load_module = importlib.import_module("bcosification_tpu_torch.clip.load")
    monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path / "exp"))
    monkeypatch.setattr(experiment_utils.Experiment, "get_model",
                        lambda self, device=None: student)
    loaded = []
    monkeypatch.setattr(clip_load_module, "load", lambda name, pretrained=True, device=None: (
        loaded.append(name) or (None, text, 1.0, cfg)))
    img_path = tmp_path / "dog.jpg"
    Image.fromarray((np.random.default_rng(4).random((250, 300, 3)) * 255).astype(np.uint8)
                    ).save(img_path, quality=90)
    name = CONFIGS[3]  # vit_b_16_..._attnUnpool
    args = ttl.argument_parser().parse_args(
        ["--exp_name", name, "--text_to_localize", "a dog", "--random_img_path", str(img_path),
         "--save_path", str(tmp_path / "out")])
    res = ttl.main(args, device="cpu")["a dog"]
    assert loaded == ["ViT-B/16"] and args.pool_cosine == 2
    image = ttl._load_image(str(img_path))
    emb = ttl.embed_phrase(text, "a dog", imagenet_templates)
    feats, _ = fast_clip_vit.fast_encode_and_vjp(student, torch.from_numpy(image), device="cpu")
    assert feats.shape == (1, 14 * 14, E)
    direct = ttl.compute_attributions(student, emb, image, pool_cosine=2, device="cpu")
    assert res["score"] == direct["score"]
    torch.testing.assert_close(res["dynamic_linear_weights"], direct["dynamic_linear_weights"])
    assert res["dynamic_linear_weights"].shape == (1, 224, 224, 6)
    out = tmp_path / "out" / "textloc_expl" / "dog" / "smooth0_attn_unpool"
    saved = np.load(out / "Text_a_dog.npz")
    assert float(saved["score"]) == res["score"] and (out / "Text_a_dog.png").exists()
