"""The port's CLIP serving pieces beside the tower, against the JAX package on
the CPU:

- the tokenizer: ids identical to the JAX ``tokenize`` over a seeded fuzz
  set, truncation and the EOT token included;
- zero-shot: ``zeroshot_classifier`` over a small text tower (1e-5),
  ``zeroshot_predict_logits`` 2-D and 3-D with cos_power 2 (1e-5),
  ``zeroshot_evaluate`` (equal accuracies), the saved classifier;
- ``SigLipLoss`` in one process: value and gradient (1e-6); the ring raises;
- the ImageNet/clip_bcosification grid: the JAX names and sanitized
  configs, every ResNet config built through ``Experiment`` on the CPU at
  full width, the ViT configs raising; checkpoints ranked by val_loss.
"""
import random
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------------------
# tokenizer
# --------------------------------------------------------------------------
WORDS = ("a the dog cat photo of big small running beautiful person tree skyline "
         "explanation zebra xylophone quantum 42 2024 covid-19 e-mail naïve café über "
         "señor Zürich東京 émigré don't it's we're I'll").split()
PUNCT = list(".,!?;:()[]'\"-/@#$%&*") + ["...", "!!", "--"]
EXTRA = ["🙂", "🚀", "&amp;", "&lt;3", "   ", "\t", "\n"]


def _fuzz_texts(n=150, seed=0):
    rng = random.Random(seed)
    texts = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(1, 40)):
            r = rng.random()
            parts.append(rng.choice(WORDS) if r < 0.7 else rng.choice(PUNCT) if r < 0.9
                         else rng.choice(EXTRA))
        texts.append((" " if rng.random() < 0.7 else "").join(parts))
    return texts


@pytest.mark.parametrize("truncate", [True, False])
def test_tokenizer_ids_match_jax(truncate):
    from bcosification_tpu.clip.tokenizer import tokenize as jtokenize
    from bcosification_tpu_torch.clip.tokenizer import tokenize

    texts = _fuzz_texts()
    if truncate:
        texts.append("a very long prompt " * 40)  # beyond 77 tokens: truncated, EOT kept
        got, want = tokenize(texts), jtokenize(texts)
        assert got[-1, -1] == want[-1, -1] == 49407
    else:
        texts = [t for t in texts if len(jtokenize(t)[0].nonzero()[0]) < 77]
        got, want = tokenize(texts, truncate=False), jtokenize(texts, truncate=False)
        with pytest.raises(RuntimeError, match="too long"):
            tokenize("word " * 100, truncate=False)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# zero-shot
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def text_pair():
    from bcosification_tpu.clip.model import TextTransformer as JText
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.clip.model import TextTransformer

    kw = dict(vocab_size=49408, context_length=77, width=64, heads=4, layers=2, embed_dim=32)
    jtext = JText(**kw)
    variables = jtext.init(jax.random.PRNGKey(3), jnp.zeros((1, 77), jnp.int32))
    text = TextTransformer(**kw)
    load_jax_variables(text, jax.tree_util.tree_map(np.asarray, variables))
    return jtext, variables, text.eval()


def test_zeroshot_classifier_matches_jax(text_pair):
    from bcosification_tpu.training import zeroshot as jzs
    from bcosification_tpu_torch.data.imagenet import imagenet_classes, imagenet_templates
    from bcosification_tpu_torch.training import zeroshot as tzs

    jtext, variables, text = text_pair
    classes = imagenet_classes[:5]
    templates = imagenet_templates[:4] + ["a {c} in the wild."]
    want = np.asarray(jzs.zeroshot_classifier(jtext, variables, classes, templates,
                                              batch_classes=2))
    got = tzs.zeroshot_classifier(text, classes, templates, batch_classes=2).numpy()
    assert got.shape == (32, 5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-6)
    assert _rel(got, want) <= 1e-5


def test_prompts_are_the_jax_prompts():
    from bcosification_tpu.data import imagenet as jimagenet
    from bcosification_tpu_torch.data import imagenet

    assert imagenet.imagenet_templates == jimagenet.imagenet_templates
    assert imagenet.imagenet_classes == jimagenet.imagenet_classes
    assert len(imagenet.imagenet_templates) == 80 and len(imagenet.imagenet_classes) == 1000


@pytest.mark.parametrize("shape,cos_power", [((4, 16), 0), ((4, 9, 16), 2), ((4, 9, 16), 0)],
                         ids=["pooled", "unpool-cos2", "unpool-cos1"])
def test_zeroshot_predict_logits_matches_jax(shape, cos_power):
    from bcosification_tpu.training import zeroshot as jzs
    from bcosification_tpu_torch.training import zeroshot as tzs

    rng = np.random.default_rng(4)
    feats = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((16, 7)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)
    want = np.asarray(jzs.zeroshot_predict_logits(jnp.asarray(feats), jnp.asarray(w),
                                                  cos_power))
    got = tzs.zeroshot_predict_logits(torch.from_numpy(feats), torch.from_numpy(w), cos_power)
    assert got.shape == (4, 7)
    assert _rel(got.numpy(), want) <= 1e-5


def test_zeroshot_evaluate_matches_jax():
    from bcosification_tpu.training import zeroshot as jzs
    from bcosification_tpu_torch.training import zeroshot as tzs

    rng = np.random.default_rng(5)
    proj = rng.standard_normal((12, 16)).astype(np.float32)
    w = rng.standard_normal((16, 10)).astype(np.float32)
    batches = [{"image": rng.standard_normal((6, 12)).astype(np.float32),
                "label": rng.integers(0, 10, 6)} for _ in range(3)]
    want = jzs.zeroshot_evaluate(lambda im: im @ jnp.asarray(proj), batches, jnp.asarray(w))
    got = tzs.zeroshot_evaluate(lambda im: im @ torch.from_numpy(proj), batches,
                                torch.from_numpy(w))
    assert got == want
    assert 0 < got["acc5"] <= 1


@pytest.mark.parametrize("ext", [".npy", ".pt"])
def test_saved_zeroshot_weights_load_in_both(tmp_path, ext):
    from bcosification_tpu.training import zeroshot as jzs
    from bcosification_tpu_torch.training import zeroshot as tzs

    w = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 3)).astype(np.float32))
    path = str(tmp_path / f"zs{ext}")
    if ext == ".npy":
        tzs.save_zeroshot_weights(path, w)
    else:
        torch.save(w, path)
    assert torch.equal(tzs.load_zeroshot_weights(path), w)
    np.testing.assert_array_equal(np.asarray(jzs.load_zeroshot_weights(path)), w.numpy())


# --------------------------------------------------------------------------
# SigLIP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cos_scaling,explain", [(0, False), (2, False), (2, True)])
def test_siglip_loss_matches_jax(cos_scaling, explain):
    from bcosification_tpu.losses import SigLipLoss as JSigLip
    from bcosification_tpu_torch.losses import SigLipLoss

    rng = np.random.default_rng(7)
    shape = (5, 6, 8) if cos_scaling else (6, 8)
    img = rng.standard_normal(shape).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt = rng.standard_normal((6, 8)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)

    def jloss(i, t):
        return JSigLip()(i, t, 10.0, -10.0, cos_scaling=cos_scaling, explain=explain)

    want, (jgi, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(img),
                                                                 jnp.asarray(txt))
    ti = torch.from_numpy(img).requires_grad_(True)
    tt = torch.from_numpy(txt).requires_grad_(True)
    got = SigLipLoss()(ti, tt, 10.0, -10.0, cos_scaling=cos_scaling, explain=explain)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert _rel(ti.grad.numpy(), jgi) <= 1e-6
    assert _rel(tt.grad.numpy(), jgt) <= 1e-6
    assert SigLipLoss().__to_config__() == JSigLip().__to_config__()


def test_siglip_ring_raises_naming_its_slice():
    from bcosification_tpu_torch.losses import SigLipLoss

    x = torch.ones(2, 4)
    with pytest.raises(NotImplementedError, match="slice 8"):
        SigLipLoss(world_size=2)(x, x, 10.0, -10.0)


# --------------------------------------------------------------------------
# the experiment grid
# --------------------------------------------------------------------------
_OBJECT_AT = re.compile(r"<([\w.]+\.)?(\w+) object at 0x[0-9a-f]+>")


def _without_class_paths(value):
    if isinstance(value, dict):
        return {k: _without_class_paths(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_without_class_paths(v) for v in value]
    if isinstance(value, str):
        return _OBJECT_AT.sub(r"<\2>", value)
    return value


def _grids():
    from bcosification_tpu.experiments.ImageNet.clip_bcosification import (
        experiment_parameters as jparams,
    )
    from bcosification_tpu_torch.experiments.ImageNet.clip_bcosification import (
        experiment_parameters as tparams,
    )

    return jparams.CONFIGS, tparams.CONFIGS


def test_the_grid_has_the_jax_names_and_configs():
    from bcosification_tpu.experiments.utils import config_utils as jcu
    from bcosification_tpu_torch.experiments.utils import config_utils as tcu

    jconfigs, tconfigs = _grids()
    assert sorted(tconfigs) == sorted(jconfigs)
    # RN50 with 2 schedules, their unpool, 3 ViTs, their unpool, 2 seeds x 2
    assert len(tconfigs) == 14
    for name in jconfigs:
        assert (_without_class_paths(tcu.sanitize_config(tconfigs[name]))
                == _without_class_paths(jcu.sanitize_config(jconfigs[name]))), name


RESNET_NAMES = sorted(n for n in _grids()[1] if n.startswith("resnet"))
VIT_NAMES = sorted(n for n in _grids()[1] if n.startswith("vit"))


_JAX_SHAPES = {}


def _jax_student_shapes(model_config):
    """{port state-dict name: shape} of the JAX student of ``model_config``
    at full width (CLIP-RN50, 224), from its abstract variables (the JAX
    builder's modules, initialised by jax.eval_shape only)."""
    from functools import partial

    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu.models.bcosify_net import BcosifyNetwork
    from bcosification_tpu.models.vit import PlainLinear
    from bcosification_tpu.modules import BcosifyConv2d, BcosifyLinear, norms
    from bcosification_tpu_torch.bcosify.from_jax import flatten_variables

    unpool = bool(model_config.get("attn_unpool", False))
    if unpool not in _JAX_SHAPES:
        visual = jclip.ModifiedResNet(
            layers=(3, 4, 6, 3), output_dim=1024, heads=32, input_resolution=224, width=64,
            conv_layer=partial(BcosifyConv2d, b=2.0),
            norm_layer=norms.NoBias(norms.BatchNormUncentered2d),
            attnpool="bcos_unpool" if unpool else "bcos",
            attnpool_linear_layer=partial(PlainLinear, use_bias=False),
            attnpool_c_proj_layer=partial(BcosifyLinear, b=2.0, use_bias=False), name="model")
        net = BcosifyNetwork(model=visual, with_logit_layer=False)
        abstract = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 224, 224, 6))))
        flat = flatten_variables(jax.tree_util.tree_map(lambda a: np.zeros(0), abstract))
        shapes = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
            name = ".".join(p.key for p in path[1:])
            shape = tuple(leaf.shape)
            shapes[name] = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert set(shapes) == set(flat)
        _JAX_SHAPES[unpool] = shapes
    return _JAX_SHAPES[unpool]


@pytest.mark.parametrize("name", RESNET_NAMES)
def test_resnet_configs_build_on_the_cpu(name, monkeypatch, tmp_path):
    """Each ResNet config builds the full-width CLIP-RN50 student at random
    init (no checkpoint here), with the JAX warning, with the JAX student's
    leaves and shapes; the fast text-grounded pass supports it."""
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.explain import fast_clip

    for var in ("CLIP_WEIGHTS_PATH", "CLIP_WEIGHTS_DIR", "BCOS_ALLOW_DOWNLOAD"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    exp = Experiment("ImageNet", "clip_bcosification", name)
    with pytest.warns(UserWarning, match="random init"):
        net = exp.get_model(device="cpu")
    m = net.model
    assert m.layers == (3, 4, 6, 3) and m.width == 64 and m.heads == 32
    assert m.attnpool_kind == ("bcos_unpool" if "attnUnpool" in name else "bcos")
    assert net.mean[0] == pytest.approx(0.48145466) and not net.with_logit_layer
    assert fast_clip.supports(net)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == _jax_student_shapes(exp.model_config)


def _jax_vit_student_shapes(model_config):
    """{port state-dict name: shape} of the JAX ViT student of
    ``model_config`` at its published size, from its abstract variables (the
    modules of the JAX builder, initialised by jax.eval_shape only)."""
    from functools import partial

    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu.clip.load import MODEL_CONFIG_CLIP_NAMES
    from bcosification_tpu.models.bcosify_net import BcosifyNetwork
    from bcosification_tpu.modules import BcosifyConv2d, BcosifyLinear

    cfg = jclip.clip_vit_config(MODEL_CONFIG_CLIP_NAMES[model_config["name"]])
    visual = jclip.CLIPVisionTransformer(
        input_resolution=224, patch_size=cfg["vision_patch_size"], width=cfg["vision_width"],
        layers=cfg["vision_layers"], heads=cfg["vision_width"] // 64,
        output_dim=cfg["embed_dim"], conv_layer=partial(BcosifyConv2d, b=2.0, use_bias=False),
        linear_layer=partial(BcosifyLinear, b=2.0, use_bias=False),
        act_layer=partial(jclip.QuickGELU, detach_gate=True),
        unpool=bool(model_config.get("attn_unpool", False)), name="model")
    net = BcosifyNetwork(model=visual, with_logit_layer=False)
    abstract = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 224, 224, 6))))
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        shape = tuple(leaf.shape)
        shapes[".".join(p.key for p in path[1:])] = (
            (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape)
    return shapes


@pytest.mark.parametrize("name", VIT_NAMES)
def test_vit_configs_raise_naming_their_slice(name, monkeypatch, tmp_path):
    """Each CLIP ViT config builds its published student (random init: no
    checkpoint here, with the JAX warning), with the JAX student's leaves and
    shapes; the CLIP ViT text-grounded pass supports it. (The ViT configs
    were once refused; the test keeps its name so that its id stays the
    same.)"""
    from bcosification_tpu_torch.clip.model import CLIPVisionTransformer
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.explain import fast_clip_vit

    for var in ("CLIP_WEIGHTS_PATH", "CLIP_WEIGHTS_DIR", "BCOS_ALLOW_DOWNLOAD"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    exp = Experiment("ImageNet", "clip_bcosification", name)
    with pytest.warns(UserWarning, match="random init"):
        net = exp.get_model(device="cpu")
    assert isinstance(net.model, CLIPVisionTransformer) and not net.with_logit_layer
    assert net.model.unpool == ("attnUnpool" in name) and fast_clip_vit.supports(net)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == _jax_vit_student_shapes(exp.model_config)


def test_clip_kd_checkpoints_rank_by_val_loss(monkeypatch, tmp_path):
    """The JAX Experiment ranks a CLIP-KD config's checkpoints by val_loss
    (min), the others by val_acc1 (max)."""
    from bcosification_tpu_torch import settings
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path))
    clip = Experiment("ImageNet", "clip_bcosification", RESNET_NAMES[0])._ckpt_manager()
    assert (clip.monitor, clip.mode) == ("val_loss", "min")
    resnet = Experiment("ImageNet", "bcosification", "resnet_50")._ckpt_manager()
    assert (resnet.monitor, resnet.mode) == ("val_acc1", "max")
