"""The port's CLIP text tower, teacher tower and checkpoint imports against the
JAX package, on the CPU, in fp32 (1e-5):

- the text tower (2 layers, width 64, 4 heads, the real vocabulary and
  context 77), the teacher image tower (the small config of
  tests/test_torch_clip.py) and ``CLIP``'s logits, the JAX variables
  carried across by from_jax;
- a random state dict in OpenAI's key layout through the JAX import and the
  port's (text, teacher, student pooled / attn-unpool / with biases), and a
  trained student checkpoint in the reference's layout; a missing and an
  extra key each raise;
- ``clip/load.py``: the local files it reads, the warning without one, the
  raise where the JAX package would download, the ViT towers' raise.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

VISION = {"vision_layers": (1, 1, 1, 1), "vision_width": 16, "embed_dim": 32,
          "image_resolution": 32, "vision_patch_size": None}
TEXT = {"vocab_size": 49408, "context_length": 77, "transformer_width": 64,
        "transformer_heads": 4, "transformer_layers": 2}
CFG = {**VISION, **TEXT}
PROMPTS = ["a photo of a dog.", "a bad photo of the goldfish", "itap of a {}.",
           "a sculpture of a great white shark with a long caption " * 3]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def openai_state_dict(seed=0):
    """A random CLIP-RN50-layout checkpoint at CFG's sizes, in OpenAI's key
    layout and torch shapes ((out, in) linears, OIHW convs)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, scale=0.5):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn(prefix, c):
        put(f"{prefix}.weight", c)
        put(f"{prefix}.bias", c)
        put(f"{prefix}.running_mean", c, scale=0.3)
        sd[f"{prefix}.running_var"] = (rng.random(c) + 0.5).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7, np.int64)

    w = VISION["vision_width"]
    for k, (cin, cout) in enumerate([(3, w // 2), (w // 2, w // 2), (w // 2, w)], start=1):
        put(f"visual.conv{k}.weight", cout, cin, 3, 3)
        bn(f"visual.bn{k}", cout)
    inplanes = w
    for stage, n_blocks in enumerate(VISION["vision_layers"]):
        planes = w * 2 ** stage
        for j in range(n_blocks):
            p = f"visual.layer{stage + 1}.{j}"
            put(f"{p}.conv1.weight", planes, inplanes, 1, 1)
            put(f"{p}.conv2.weight", planes, planes, 3, 3)
            put(f"{p}.conv3.weight", planes * 4, planes, 1, 1)
            for k, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{p}.bn{k}", c)
            if j == 0:
                put(f"{p}.downsample.0.weight", planes * 4, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    e = w * 32
    put("visual.attnpool.positional_embedding", (VISION["image_resolution"] // 32) ** 2 + 1, e)
    for name, out in (("q_proj", e), ("k_proj", e), ("v_proj", e),
                      ("c_proj", VISION["embed_dim"])):
        put(f"visual.attnpool.{name}.weight", out, e, scale=e ** -0.5)
        put(f"visual.attnpool.{name}.bias", out, scale=0.1)
    d = TEXT["transformer_width"]
    put("token_embedding.weight", TEXT["vocab_size"], d, scale=0.02)
    put("positional_embedding", TEXT["context_length"], d, scale=0.01)
    for i in range(TEXT["transformer_layers"]):
        p = f"transformer.resblocks.{i}"
        put(f"{p}.attn.in_proj_weight", 3 * d, d, scale=d ** -0.5)
        put(f"{p}.attn.in_proj_bias", 3 * d, scale=0.1)
        put(f"{p}.attn.out_proj.weight", d, d, scale=d ** -0.5)
        put(f"{p}.attn.out_proj.bias", d, scale=0.1)
        put(f"{p}.mlp.c_fc.weight", 4 * d, d, scale=d ** -0.5)
        put(f"{p}.mlp.c_fc.bias", 4 * d, scale=0.1)
        put(f"{p}.mlp.c_proj.weight", d, 4 * d, scale=(4 * d) ** -0.5)
        put(f"{p}.mlp.c_proj.bias", d, scale=0.1)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
            put(f"{p}.{ln}.bias", d, scale=0.1)
    sd["ln_final.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    put("ln_final.bias", d, scale=0.1)
    put("text_projection", d, VISION["embed_dim"], scale=d ** -0.5)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


@pytest.fixture(scope="module")
def sd():
    return openai_state_dict()


def _images(n=2, channels=6, seed=0):
    x = np.random.default_rng(seed).random((n, 32, 32, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1) if channels == 6 else x


def _tokens():
    from bcosification_tpu_torch.clip.tokenizer import tokenize

    return tokenize(PROMPTS)


# --------------------------------------------------------------------------
# towers from the JAX variables
# --------------------------------------------------------------------------
def test_text_tower_matches_jax():
    from bcosification_tpu.clip.model import TextTransformer as JText
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.clip.model import TextTransformer

    kw = dict(vocab_size=TEXT["vocab_size"], context_length=TEXT["context_length"],
              width=TEXT["transformer_width"], heads=TEXT["transformer_heads"],
              layers=TEXT["transformer_layers"], embed_dim=VISION["embed_dim"])
    tokens = _tokens()
    jtext = JText(**kw)
    variables = jtext.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    want = np.asarray(jtext.apply(variables, jnp.asarray(tokens)))
    text = TextTransformer(**kw)
    load_jax_variables(text, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = text(tokens).numpy()
    assert got.shape == (len(PROMPTS), VISION["embed_dim"])
    assert _rel(got, want) <= 1e-5


def test_teacher_tower_matches_jax():
    from bcosification_tpu.clip.model import ModifiedResNet as JResNet
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.clip.model import ModifiedResNet

    kw = dict(layers=VISION["vision_layers"], output_dim=VISION["embed_dim"], heads=8,
              input_resolution=32, width=VISION["vision_width"])
    x = _images(channels=3)
    jnet = JResNet(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(2), x))
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda leaf: (rng.random(leaf.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = ModifiedResNet(**kw)
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-3
    assert _rel(got, want) <= 1e-5


def test_clip_logits_match_jax():
    """``CLIP`` (the teacher tower, the text tower, the learned logit scale):
    logits per image and per text (1e-5)."""
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.clip import model as tclip

    vkw = dict(layers=VISION["vision_layers"], output_dim=VISION["embed_dim"], heads=8,
               input_resolution=32, width=VISION["vision_width"])
    tkw = dict(vocab_size=TEXT["vocab_size"], context_length=TEXT["context_length"],
               width=TEXT["transformer_width"], heads=TEXT["transformer_heads"],
               layers=TEXT["transformer_layers"], embed_dim=VISION["embed_dim"])
    x, tokens = _images(channels=3), _tokens()
    jnet = jclip.CLIP(visual=jclip.ModifiedResNet(**vkw), text=jclip.TextTransformer(**tkw))
    variables = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(tokens)))
    want = jnet.apply(variables, jnp.asarray(x), jnp.asarray(tokens))
    net = tclip.CLIP(tclip.ModifiedResNet(**vkw), tclip.TextTransformer(**tkw))
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x), tokens)
    assert got[0].shape == (2, len(PROMPTS))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5


# --------------------------------------------------------------------------
# the OpenAI checkpoint import
# --------------------------------------------------------------------------
def test_config_from_state_dict_matches_jax(sd):
    from bcosification_tpu.clip.model import config_from_state_dict as jcfg
    from bcosification_tpu_torch.clip.model import config_from_state_dict

    got = config_from_state_dict(sd)
    assert got == jcfg(sd)
    assert got["vision_layers"] == (1, 1, 1, 1) and got["image_resolution"] == 32


def test_text_import_matches_jax(sd):
    from bcosification_tpu.bcosify.clip_import import build_clip_text as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_text

    tokens = _tokens()
    jtext, jvars = jbuild(sd, dict(CFG))
    want = np.asarray(jtext.apply(jvars, jnp.asarray(tokens)))
    with torch.no_grad():
        got = build_clip_text(sd, dict(CFG), device="cpu")(tokens).numpy()
    assert _rel(got, want) <= 1e-5


def test_teacher_import_matches_jax(sd):
    from bcosification_tpu.bcosify.clip_import import build_clip_teacher_visual as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual

    x = _images(channels=3)
    jnet, jvars = jbuild(sd, dict(CFG))
    want = np.asarray(jnet.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = build_clip_teacher_visual(sd, dict(CFG), device="cpu")(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("unpool,use_bias", [(False, False), (True, False), (True, True)],
                         ids=["pooled", "unpool", "unpool-bias"])
def test_student_import_matches_jax(sd, unpool, use_bias):
    """The B-cosified student from the checkpoint: features with and without
    explain (1e-5)."""
    from bcosification_tpu.bcosify.clip_import import build_bcosified_clip_visual as jbuild
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual

    config = {"name": "resnet50clip", "bcosify_args": {"clip_kd": True, "use_bias": use_bias},
              "bcos_args": {"b": 2}, "attn_unpool": unpool}
    x = _images()
    jnet, jvars = jbuild(config, sd, dict(CFG))
    net = build_bcosified_clip_visual(config, sd, dict(CFG), device="cpu")
    for explain in (False, True):
        want = np.asarray(jnet.apply(jvars, jnp.asarray(x), explain=explain))
        with torch.no_grad():
            got = net(torch.from_numpy(x), explain=explain).numpy()
        assert np.abs(want).max() > 1e-6
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("tower", ["text", "teacher", "student"])
@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_import_is_strict(sd, tower, fault):
    from bcosification_tpu_torch.bcosify import clip_import

    bad = dict(sd)
    if fault == "missing":
        key = {"text": "transformer.resblocks.1.mlp.c_fc.bias",
               "teacher": "visual.layer2.0.bn3.running_mean",
               "student": "visual.layer3.0.downsample.0.weight"}[tower]
        del bad[key]
    else:
        key = "transformer.resblocks.2.ln_1.weight" if tower == "text" else "visual.fc.weight"
        bad[key] = np.zeros(4, np.float32)
    build = {"text": lambda: clip_import.build_clip_text(bad, dict(CFG), device="cpu"),
             "teacher": lambda: clip_import.build_clip_teacher_visual(bad, dict(CFG),
                                                                      device="cpu"),
             "student": lambda: clip_import.build_bcosified_clip_visual(
                 {"bcosify_args": {"use_bias": False}}, bad, dict(CFG), device="cpu")}[tower]
    with pytest.raises(KeyError, match=key.rsplit(".", 1)[0]):
        build()


def trained_student_checkpoint(net, seed=1):
    """The reference's trained BcosifyNetwork(ModifiedResNet) checkpoint of
    the port's student ``net`` (B-cos layers with .linear.weight, the
    downsample as 0 pool / 1 conv / 2 norm, uncentered BNs keeping their
    running_mean), with random values."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in net.state_dict().items():
        parts = name.split(".")
        path = []
        for p in parts[:-1]:
            if p.startswith("layer") and "_" in p:
                path += p.split("_")
            else:
                path += {"downsample_conv": ["downsample", "1"],
                         "downsample_norm": ["downsample", "2"]}.get(p, [p])
        leaf = parts[-1]
        prefix = ".".join(path)
        if leaf == "weight" and (t.dim() == 4 or path[-1] == "c_proj"):
            prefix += ".linear"
        shape = tuple(t.shape)[::-1] if t.dim() == 2 else tuple(t.shape)
        if leaf == "num_batches_tracked":
            out[f"{prefix}.{leaf}"] = np.array(3, np.int64)
            continue
        value = rng.standard_normal(shape).astype(np.float32) * 0.5
        if leaf == "running_var":
            value = (rng.random(shape) + 0.5).astype(np.float32)
            out[f"{prefix}.running_mean"] = np.zeros(shape, np.float32)
        out[f"{prefix}.{leaf}"] = value
    return out


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_trained_student_import_matches_jax(unpool):
    from bcosification_tpu.bcosify.clip_import import (
        build_bcosified_clip_visual as jbuild,
        clip_trained_student_to_variables as jfill,
        infer_clip_student_config as jinfer,
    )
    from bcosification_tpu_torch.bcosify.clip_import import (
        build_bcosified_clip_visual,
        clip_trained_student_to_variables,
        infer_clip_student_config,
    )

    config = {"bcosify_args": {"use_bias": False}, "attn_unpool": unpool}
    net = build_bcosified_clip_visual(config, None, dict(CFG), device="cpu")
    ckpt = trained_student_checkpoint(net)
    inferred = infer_clip_student_config(ckpt)
    assert inferred == jinfer(ckpt)
    assert inferred["attn_unpool"] == unpool and inferred["vision_width"] == 16
    jnet, jvars = jbuild(config, None, dict(CFG))
    jvars = jfill(jvars, ckpt)
    net.load_state_dict(clip_trained_student_to_variables(net, ckpt))
    x = _images()
    want = np.asarray(jnet.apply(jvars, jnp.asarray(x), explain=True))
    with torch.no_grad():
        got = net(torch.from_numpy(x), explain=True).numpy()
    assert _rel(got, want) <= 1e-5
    extra = dict(ckpt, **{"model.attnpool.extra.weight": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="model.attnpool.extra"):
        clip_trained_student_to_variables(net, extra)


# --------------------------------------------------------------------------
# clip/load.py
# --------------------------------------------------------------------------
@pytest.fixture
def clean_env(tmp_path, monkeypatch):
    for var in ("CLIP_WEIGHTS_PATH", "CLIP_WEIGHTS_DIR", "BCOS_ALLOW_DOWNLOAD"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path


@pytest.mark.parametrize("ext", [".npz", ".pth"])
def test_load_state_dict_file_reads_local_files(sd, clean_env, monkeypatch, ext):
    from bcosification_tpu.clip.load import load_state_dict_file as jload
    from bcosification_tpu_torch.clip.load import load_state_dict_file

    path = clean_env / f"RN50{ext}"
    if ext == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(clean_env))
    got, want = load_state_dict_file("RN50"), jload("RN50")
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def test_load_state_dict_file_without_a_file(clean_env, monkeypatch):
    from bcosification_tpu_torch.clip.load import load_state_dict_file

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert load_state_dict_file("RN50") is None
    assert any("random init" in str(w.message) for w in caught)
    monkeypatch.setenv("BCOS_ALLOW_DOWNLOAD", "1")
    with pytest.raises(RuntimeError, match="RN50.pt"):
        load_state_dict_file("RN50")


def test_load_builds_the_towers_and_refuses_vit(sd, clean_env, monkeypatch):
    """clip.load of RN50 from a local checkpoint, and of the published
    ViT-B/32 and ViT-L/14 unpretrained: every tower builds, the ViTs with
    the JAX package's published config. (The ViT towers were once refused;
    the test keeps its name so that its id stays the same.)"""
    from bcosification_tpu_torch.clip.load import load
    from bcosification_tpu_torch.clip.model import TextTransformer

    np.savez(clean_env / "RN50.npz", **sd)
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(clean_env))
    visual, text, scale, cfg = load("RN50", device="cpu")
    assert isinstance(text, TextTransformer) and cfg["embed_dim"] == 32
    assert scale == pytest.approx(1 / 0.07, rel=1e-5)
    with torch.no_grad():
        assert visual(torch.from_numpy(_images(channels=3))).shape == (2, 32)
    from bcosification_tpu.clip import model as jclip
    from bcosification_tpu_torch.clip.model import CLIPVisionTransformer

    for name in ("ViT-B/32", "ViT-L/14"):  # the published towers at random init
        visual, text, scale, cfg = load(name, pretrained=False, device="cpu")
        assert cfg == jclip.clip_vit_config(name) and scale == pytest.approx(1 / 0.07)
        assert isinstance(visual, CLIPVisionTransformer) and isinstance(text, TextTransformer)
        assert len(visual.blocks()) == cfg["vision_layers"] and visual.patch_size == cfg[
            "vision_patch_size"]
        assert tuple(visual.proj.shape) == (cfg["vision_width"], cfg["embed_dim"])
        assert tuple(text.text_projection.shape) == (cfg["transformer_width"], cfg["embed_dim"])
        del visual, text


@pytest.mark.parametrize("clip_kd", [False, True])
@pytest.mark.parametrize("linearprobe_clip", [False, True])
@pytest.mark.parametrize("bfy_mean_zero", [False, True])
def test_normalization_for_matches_jax(clip_kd, linearprobe_clip, bfy_mean_zero):
    from bcosification_tpu.models import bcosify_net as jnet
    from bcosification_tpu_torch.models import bcosify_net as tnet

    kw = dict(clip_kd=clip_kd, linearprobe_clip=linearprobe_clip, bfy_mean_zero=bfy_mean_zero)
    assert tnet.normalization_for(**kw) == jnet.normalization_for(**kw)
    for name in ("CLIP_MEAN_ADDINVERSE", "CLIP_MEAN_ZERO", "CLIP_STD_ADDINVERSE"):
        assert getattr(tnet, name) == getattr(jnet, name)
