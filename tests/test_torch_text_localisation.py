"""The port's text-grounded localisation against the JAX package on the CPU,
in fp32, on the same weights: the small CLIP student of
tests/test_torch_clip.py (layers (1, 1, 1, 1), width 16, embed_dim 32,
32x32; pooled and attn-unpool) and the 2-layer width-64 text tower of
tests/test_torch_clip_zeroshot.py.

- ``embed_phrase`` against JAX's (1e-5);
- ``compute_attributions``, through the hand-scheduled trunk
  (``explain/fast_clip.py``, K1 forward and K2 backward at its 1x1 convs)
  and through autograd on the module: score and W within 1e-5 of JAX's,
  (the score, a mean of cosines, within 1e-5 absolute) for the pooled
  tower and for the attn-unpool tower with pool_cosine 0, 1 and 2 and
  norm_max_cosine; the contribution maps (1e-5) and the explanation (1e-4:
  its colours divide by small sums of W);
  the raise for pool_cosine=0 with norm_max_cosine;
- GB equal to Grad on the CLIP tower (its ReLU is plain), as in JAX;
- ``main`` on a synthetic JPEG (--random_img_path), its .npz and .png.
"""
import argparse
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcosification_tpu.interpretability.analyses import text_localisation as jtl
from bcosification_tpu_torch.interpretability.analyses import text_localisation as ttl
from test_torch_clip import clip_pair
from test_torch_clip_zeroshot import text_pair  # noqa: F401  (fixture)
from test_torch_training import _rel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    return {"pooled": clip_pair(False), "unpool": clip_pair(True)}


@pytest.fixture(scope="module", params=["pooled", "unpool"])
def pair(request, pairs):
    return pairs[request.param]


@pytest.fixture(scope="module")
def phrase_embedding():
    t = np.random.default_rng(8).standard_normal(32).astype(np.float32)
    return t / np.linalg.norm(t)


def test_embed_phrase_matches_jax(text_pair):
    jtext, variables, text = text_pair
    templates = ("a photo of a {}.", "a bad photo of the {}.", "{} in the wild")
    want = np.asarray(jtl.embed_phrase(jtext, variables, "a dog", templates))
    got = ttl.embed_phrase(text, "a dog", templates).numpy()
    assert got.shape == (32,) and abs(np.linalg.norm(got) - 1.0) < 1e-6
    assert _rel(got, want) <= 1e-5


# (head, pool_cosine, norm_max_cosine): the pooled head has no pooling options
CASES = [("pooled", 1, False), ("unpool", 1, False), ("unpool", 0, False), ("unpool", 2, False),
         ("unpool", 1, True), ("unpool", 2, True)]


@pytest.mark.parametrize("route", ["fast", "autograd"])
@pytest.mark.parametrize("head,pool_cosine,norm_max", CASES,
                         ids=[f"{h}-p{p}-nm{int(n)}" for h, p, n in CASES])
def test_compute_attributions_matches_jax(pairs, phrase_embedding, head, pool_cosine, norm_max,
                                          route, monkeypatch):
    """Score and W (1e-5), the contribution maps and the explanation of the
    port against JAX's compute_attributions."""
    from bcosification_tpu_torch.explain import fast_clip

    net, variables, tnet, x = pairs[head]
    assert fast_clip.supports(tnet)
    if route == "autograd":
        monkeypatch.setattr(fast_clip, "supports", lambda net: False)
    kw = dict(pool_cosine=pool_cosine, norm_max_cosine=norm_max, smooth=3)
    image = x[:1]
    want = jtl.compute_attributions(net, variables, jnp.asarray(phrase_embedding),
                                    jnp.asarray(image), **kw)
    got = ttl.compute_attributions(tnet, torch.from_numpy(phrase_embedding), image,
                                   device="cpu", **kw)
    # a mean of cosines, whose scale is 1 however small the mean
    assert abs(got["score"] - want["score"]) <= 1e-5
    w = got["dynamic_linear_weights"].numpy()
    assert w.shape == image.shape and np.abs(w).max() > 0
    assert _rel(w, np.asarray(want["dynamic_linear_weights"])) <= 1e-5
    for key in ("contribution_map", "contribution_map_clipped"):
        assert _rel(got[key].numpy(), np.asarray(want[key])) <= 1e-5, key
    # the range is one element of the map (its 99.5th percentile magnitude)
    scale = np.abs(np.asarray(want["contribution_map"])).max()
    assert abs(got["vrange"] - want["vrange"]) <= 1e-5 * scale
    expl = got["explanation"].numpy()
    assert expl.shape == (32, 32, 4) and np.isfinite(expl).all()
    # the colours pos / (pos + inv) are ill-conditioned where W is small
    assert _rel(expl, np.asarray(want["explanation"])) <= 1e-4


def test_pool_cosine_zero_with_norm_max_raises(pair, phrase_embedding):
    net, variables, tnet, x = pair
    kw = dict(pool_cosine=0, norm_max_cosine=True)
    with pytest.raises(ValueError, match="NaN"):
        jtl.compute_attributions(net, variables, jnp.asarray(phrase_embedding),
                                 jnp.asarray(x[:1]), **kw)
    with pytest.raises(ValueError, match="NaN"):
        ttl.compute_attributions(tnet, torch.from_numpy(phrase_embedding), x[:1],
                                 device="cpu", **kw)


def test_gb_equals_grad_on_the_clip_tower(pairs):
    """The CLIP towers' ReLU ignores guided backprop in both packages, so GB
    equals Grad there (the pooled tower's features as the explained
    outputs); both equal JAX's."""
    from bcosification_tpu.interpretability.explanation_methods import get_explainer as jget
    from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer

    net, variables, tnet, x = pairs["pooled"]
    targets = [0, 5, 17]
    gb = get_explainer(tnet, "GB", device="cpu").attribute_selection(x[:1], targets)
    grad = get_explainer(tnet, "Grad", device="cpu").attribute_selection(x[:1], targets)
    torch.testing.assert_close(gb, grad, rtol=0, atol=0)
    want = np.asarray(jget(net, variables, "GB").attribute_selection(
        jnp.asarray(x[:1]), jnp.asarray(targets)))
    assert np.abs(want).max() > 0 and _rel(gb.numpy(), want) <= 1e-5


def test_main_on_a_synthetic_image(pair, text_pair, tmp_path, monkeypatch):
    """main(config, device="cpu") with --random_img_path: the experiment
    without a checkpoint falls back to its conversion-time model (here the
    small tower) and the text tower to clip.load's (here the small one); the
    result equals compute_attributions on the loaded image and the .npz and
    .png are written."""
    from PIL import Image

    from bcosification_tpu_torch import settings
    clip_load_module = importlib.import_module("bcosification_tpu_torch.clip.load")
    from bcosification_tpu_torch.experiments.utils import experiment_utils

    net, variables, tnet, x = pair
    text = text_pair[2]
    img_path = tmp_path / "dog.jpg"
    Image.fromarray((np.random.default_rng(4).random((250, 300, 3)) * 255).astype(np.uint8)
                    ).save(img_path, quality=90)
    monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path / "exp"))
    monkeypatch.setattr(experiment_utils.Experiment, "get_model",
                        lambda self, device=None: tnet)
    monkeypatch.setattr(clip_load_module, "load",
                        lambda name, pretrained=True, device=None: (None, text, 1.0, {}))
    unpool = tnet.model.attnpool.attn_unpool
    name = ("resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
            + ("_attnUnpool" if unpool else ""))
    args = ttl.argument_parser().parse_args(
        ["--exp_name", name, "--text_to_localize", "a dog", "--random_img_path", str(img_path),
         "--save_path", str(tmp_path / "out")] + (["--use_attn_unpool"] if unpool else []))
    results = ttl.main(args, device="cpu")
    res = results["a dog"]
    image = ttl._load_image(str(img_path))
    assert image.shape == (1, 224, 224, 6)
    emb = ttl.embed_phrase(text, "a dog", _templates())
    direct = ttl.compute_attributions(tnet, emb, image, pool_cosine=args.pool_cosine,
                                      device="cpu")
    assert res["score"] == direct["score"]
    torch.testing.assert_close(res["dynamic_linear_weights"], direct["dynamic_linear_weights"])
    out = tmp_path / "out" / "textloc_expl" / "dog" / ("smooth0" + ("_attn_unpool" if unpool
                                                                    else ""))
    saved = np.load(out / "Text_a_dog.npz")
    np.testing.assert_array_equal(saved["contribution_map_raw"],
                                  res["contribution_map"].numpy())
    assert float(saved["score"]) == res["score"] and (out / "Text_a_dog.png").exists()


def _templates():
    from bcosification_tpu_torch.data.imagenet import imagenet_templates

    return imagenet_templates


def test_use_attn_unpool_on_a_pooled_experiment_raises(pairs, text_pair, tmp_path,
                                                       monkeypatch):
    from bcosification_tpu_torch.experiments.utils import experiment_utils

    clip_load_module = importlib.import_module("bcosification_tpu_torch.clip.load")
    tnet = pairs["pooled"][2]
    monkeypatch.setattr(experiment_utils.Experiment, "get_model",
                        lambda self, device=None: tnet)
    monkeypatch.setattr(clip_load_module, "load",
                        lambda name, pretrained=True, device=None: (None, text_pair[2], 1.0, {}))
    args = argparse.Namespace(
        exp_name="resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification",
        reload="best_any", use_attn_unpool=True, pool_cosine=1, norm_max_cosine=False,
        smooth=0, random_img_path=None, use_class_name=True, text_to_localize=None,
        save_path=str(tmp_path), image_index=0, exp_name_data=None)
    with pytest.raises(ValueError, match="attn_unpool"):
        ttl.main(args, device="cpu")
