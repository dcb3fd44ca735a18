"""Released B-cos v2 checkpoints into the port (``bcosify/release_import.py``)
against the JAX package's importer, on the CPU, in fp32.

The registry entries resnet50, densenet121, vgg11, vgg11_bnu, the
convnext_tiny pair and the two B-cos ViTs are pointed, in both packages for
the test, at small nets of their classes (ResNet-50's bottleneck at layers
(1, 1), width 8; the DenseNet of growth 8, blocks (2, 2); VGG-11's letter
config cut to four convs of width 8-64; ConvNeXt at two blocks per stage,
dims 8/16; the ViTs of test_torch_vit_final), so that both
``convert_release_checkpoint``s run as they do for the name. A seeded
state dict in the reference's layout (``release_state_dict`` of a port
model whose weights are drawn with numpy; B-cos layers under
``.linear.weight``, the ViTs under BcosSequential's ``0.``) converts in
both packages to the same outputs (1e-5), and back to the same weights;
the import is strict both ways; a checkpoint with running statistics
rebuilds the ResNet with uncentered BN, which folds into K1, and the
ConvNeXt with uncentered BN (a position-norm checkpoint under
convnext_tiny_bnu the other way round).
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.bcosify import release_import as jrelease
from bcosification_tpu.models import convnext as jconvnext
from bcosification_tpu.models import densenet as jdensenet
from bcosification_tpu.models import pretrained as jpretrained
from bcosification_tpu.models import resnet as jresnet
from bcosification_tpu.models import vgg as jvgg
from bcosification_tpu.modules import norms as jnorms
from bcosification_tpu_torch.bcosify import release_import as trelease
from bcosification_tpu_torch.models import convnext as tconvnext
from bcosification_tpu_torch.models import densenet as tdensenet
from bcosification_tpu_torch.models import pretrained
from bcosification_tpu_torch.models import resnet as tresnet
from bcosification_tpu_torch.models import vgg as tvgg
from bcosification_tpu_torch.modules import BatchNormUncentered2d, NoBias
from test_torch_training import _rel
from test_torch_vit_final import NUM_CLASSES, images, small_archs

torch.set_num_threads(1)
SIZE = 32
SMALL = {
    "resnet50": (jresnet.BcosResNet, tresnet.BcosResNet,
                 dict(block="bottleneck", layers=(1, 1), inplanes=8)),
    "densenet121": (jdensenet.BcosDenseNet, tdensenet.BcosDenseNet,
                    dict(growth_rate=8, block_config=(2, 2), num_init_features=16, bn_size=2,
                         with_logit_layer=True, stem_pool="avg")),
}
_BLOCKS = [(8, 16, 2), (16, None, 2)]
# name -> (JAX class, port class, JAX kwargs, port kwargs)
SMALL_VGG_CONVNEXT = {
    "vgg11": (jvgg.BcosVGG, tvgg.BcosVGG, dict(cfg="A", with_norm=False),
              dict(cfg="A", with_norm=False)),
    "vgg11_bnu": (jvgg.BcosVGG, tvgg.BcosVGG, dict(cfg="A"), dict(cfg="A")),
    "convnext_tiny": (
        jconvnext.BcosConvNeXt, tconvnext.BcosConvNeXt,
        dict(block_setting=tuple(jconvnext.CNBlockConfig(*c) for c in _BLOCKS),
             stochastic_depth_prob=0.1),
        dict(block_setting=[tconvnext.CNBlockConfig(*c) for c in _BLOCKS],
             stochastic_depth_prob=0.1)),
}
SMALL_VGG_CONVNEXT["convnext_tiny_bnu"] = (
    *SMALL_VGG_CONVNEXT["convnext_tiny"][:2],
    dict(SMALL_VGG_CONVNEXT["convnext_tiny"][2],
         norm_layer=jnorms.NoBias(jnorms.BatchNormUncentered2d)),
    dict(SMALL_VGG_CONVNEXT["convnext_tiny"][3], norm_layer=NoBias(BatchNormUncentered2d)))
TINY_A = [8, "M", 16, "M", 32, 32, "M", 64, "M"]  # VGG-11's letter, cut to size
NAMES = ["resnet50", "densenet121", "simple_vit_ti_patch16_224", "vitc_ti_patch1_14",
         "vgg11", "vgg11_bnu", "convnext_tiny"]


@pytest.fixture
def small_zoo(monkeypatch):
    """Both registries' CNN entries of SMALL built small, and the ViT archs
    cut (small_archs), for the test."""
    for name, (jcls, tcls, kw) in SMALL.items():
        def jbuild(jcls=jcls, kw=kw, **extra):
            return jpretrained._init(jcls(num_classes=NUM_CLASSES, **kw, **extra),
                                     (SIZE, SIZE, 6))

        monkeypatch.setitem(jpretrained._REGISTRY, name, jbuild)
        monkeypatch.setitem(pretrained._REGISTRY, name,
                            pretrained._cnn(tcls, num_classes=NUM_CLASSES, **kw))
    for name, (jcls, tcls, jkw, tkw) in SMALL_VGG_CONVNEXT.items():
        def jbuild_kw(jcls=jcls, jkw=jkw, **extra):
            return jpretrained._init(jcls(num_classes=NUM_CLASSES, **{**jkw, **extra}),
                                     (SIZE, SIZE, 6))

        monkeypatch.setitem(jpretrained._REGISTRY, name, jbuild_kw)
        monkeypatch.setitem(pretrained._REGISTRY, name,
                            pretrained._cnn(tcls, num_classes=NUM_CLASSES, **tkw))
    monkeypatch.setitem(jvgg.CFGS, "A", TINY_A)
    monkeypatch.setitem(tvgg.CFGS, "A", TINY_A)
    with small_archs(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _kw(name):
    return {} if name in SMALL or name in SMALL_VGG_CONVNEXT else {"num_classes": NUM_CLASSES}


def seeded_model(name, seed, **kw):
    """The port's small ``name`` on the CPU with every weight drawn with
    numpy from ``seed`` (norm weights 1 + 0.2 N, running_var U(0.5, 1.5))."""
    net = pretrained.load_model(name, pretrained=False, device="cpu", **_kw(name), **kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in net.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            if key.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif t.dim() >= 2:
                v = rng.uniform(-1, 1, t.shape) / math.sqrt(t[0].numel() if t.dim() == 4
                                                            else t.shape[0])
            else:
                v = 1.0 + 0.2 * rng.standard_normal(t.shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


def _x(name, n=2, seed=5):
    return images(f"bcos_{name}", n, seed)


def _jax_forward(name, sd, x, **kw):
    model, variables = jrelease.convert_release_checkpoint(
        name, {k: v.numpy() for k, v in sd.items()}, return_model=True, **_kw(name), **kw)
    return np.asarray(jax.jit(lambda v, t: model.apply(v, t, train=False))(
        variables, jnp.asarray(x)), np.float64)


@pytest.mark.parametrize("name", NAMES)
def test_conversion_matches_jax(small_zoo, name):
    """A seeded reference-layout checkpoint: the port's converted model gives
    JAX's converted model's logits (1e-5) and the weights it came from."""
    net = seeded_model(name, seed=1)
    sd = trelease.release_state_dict(net, name)
    if name.startswith(("simple_vit", "vitc")):
        assert all(k.startswith("0.") for k in sd)
        assert "0.to_patch_embedding.linear.linear.weight" in sd
    else:
        assert any(k.endswith(".linear.weight") for k in sd)
    model, state = trelease.convert_release_checkpoint(name, sd, return_model=True,
                                                       device="cpu", **_kw(name))
    for key, t in net.state_dict().items():
        assert torch.equal(state[key], t), key
    x = _x(name)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).double().numpy()
    want = _jax_forward(name, sd, x)
    assert np.abs(want).max() > 1e-2
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", ["missing", "extra", "misshapen"])
def test_conversion_is_strict(small_zoo, case):
    sd = trelease.release_state_dict(seeded_model("resnet50", seed=2), "resnet50")
    if case == "missing":
        del sd["layer1.0.conv2.linear.weight"]
        error, match = KeyError, "found in the checkpoint"
    elif case == "extra":
        sd["layer1.0.conv4.linear.weight"] = torch.zeros(8, 8, 1, 1)
        error, match = KeyError, "not consumed"
    else:
        sd["layer2.0.conv3.linear.weight"] = sd["layer2.0.conv3.linear.weight"][:, :-1]
        error, match = ValueError, "shape mismatch"
    with pytest.raises(error, match=match):
        trelease.convert_release_checkpoint("resnet50", sd)
    with pytest.raises(error):  # as in JAX
        jrelease.convert_release_checkpoint("resnet50", {k: v.numpy() for k, v in sd.items()})


def test_bnu_checkpoint_rebuilds_with_uncentered_bn(small_zoo, tmp_path):
    """A checkpoint with running statistics (and the reference's unused
    running_mean and num_batches_tracked) read from a ``.pth`` rebuilds the
    ResNet with the bias-free BatchNormUncentered2d: JAX's outputs (1e-5),
    its 1x1 convs folded into K1 in the forward (the plain version counts
    on the CPU), the fast pass equal to the generic W; without the rebuild
    the conversion raises."""
    from bcosification_tpu_torch.explain import fast_resnet
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.modules import NoBias
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1

    net = seeded_model("resnet50", seed=3, norm_layer=NoBias(BatchNormUncentered2d))
    sd = trelease.release_state_dict(net, "resnet50")
    rng = np.random.default_rng(4)
    for key in [k for k in sd if k.endswith("running_var")]:
        sd[key[:-len("var")] + "mean"] = torch.from_numpy(
            rng.standard_normal(sd[key].shape).astype(np.float32))
        sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(11)
    path = tmp_path / "resnet_50-bnu.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    assert trelease.load_torch_state_dict(path).keys() == sd.keys()
    model, _ = trelease.convert_release_checkpoint("resnet50", path, return_model=True,
                                                   device="cpu")
    assert isinstance(model.bn1, BatchNormUncentered2d) and model.bn1.bias is None
    x = _x("resnet50")
    calls = []
    real = bcos_conv1x1.conv1x1_fwd_plain
    bcos_conv1x1.conv1x1_fwd_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(x)).double().numpy()
    finally:
        bcos_conv1x1.conv1x1_fwd_plain = real
    assert len(calls) == 6  # conv1, conv3 and the downsample (stride 1, 2) of each block
    assert _rel(got, _jax_forward("resnet50", sd, x)) <= 1e-5
    assert fast_resnet.supports(model)
    gl, gs, gw = dynamic_linear_weights(lambda t: model(t, explain=True),
                                        torch.from_numpy(x), device="cpu")
    fl, fs, fw = fast_resnet.fast_dynamic_linear_weights(model, torch.from_numpy(x),
                                                         device="cpu")
    assert torch.equal(fs, gs) and _rel(fw.numpy(), gw.numpy()) <= 1e-5
    with pytest.raises(KeyError):
        trelease.convert_release_checkpoint("resnet50", path, rebuild_norm=False)


@pytest.mark.parametrize("name", list(SMALL_VGG_CONVNEXT))
def test_conversion_matches_jax_variables(small_zoo, name):
    """The VGG and ConvNeXt translators against JAX's leaf for leaf: the
    variables JAX converts a seeded reference-layout checkpoint to are the
    port's converted state (conv kernels HWIO -> OIHW, ConvNeXt's
    (C, 1, 1) layer scales -> (C,)); the norm-free VGG's keys skip the
    reference's Identity slots."""
    from bcosification_tpu_torch.bcosify.from_jax import flatten_variables

    net = seeded_model(name, seed=6)
    sd = trelease.release_state_dict(net, name)
    if name.startswith("convnext"):
        assert sd["features.2.0.layer_scale"].shape == (8, 1, 1)
        assert "features.3.1.linear.weight" in sd  # stage 0's downsampling conv
    else:
        assert "classifier.2.linear.weight" in sd
        assert ("features.1.weight" in sd) == name.endswith("_bnu")
        assert "features.3.linear.weight" in sd  # the second conv, after a pool
    state = trelease.convert_release_checkpoint(name, sd, **_kw(name))
    variables = jrelease.convert_release_checkpoint(name, {k: v.numpy() for k, v in sd.items()},
                                                    **_kw(name))
    flat = flatten_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert set(flat) == set(state)
    for key, want in flat.items():
        got = state[key].numpy()
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case", ["missing", "extra", "misshapen"])
@pytest.mark.parametrize("name", ["vgg11_bnu", "convnext_tiny"])
def test_conversion_is_strict_vgg_convnext(small_zoo, name, case):
    sd = trelease.release_state_dict(seeded_model(name, seed=7), name)
    key = ("features.6.linear.weight" if name.startswith("vgg")
           else "features.2.1.layer_scale")
    if case == "missing":
        del sd[key]
        error, match = KeyError, "found in the checkpoint"
    elif case == "extra":
        sd["classifier.3.linear.weight"] = torch.zeros(8, 8, 1, 1)
        error, match = KeyError, "not consumed"
    else:
        sd[key] = sd[key][:-1]
        error, match = ValueError, "shape mismatch"
    with pytest.raises(error, match=match):
        trelease.convert_release_checkpoint(name, sd)
    with pytest.raises(error):  # as in JAX
        jrelease.convert_release_checkpoint(name, {k: v.numpy() for k, v in sd.items()})


def test_convnext_checkpoints_rebuild_the_norm(small_zoo, tmp_path):
    """A ConvNeXt checkpoint with running statistics (and the reference's
    unused running_mean and num_batches_tracked) read from a ``.pth``
    rebuilds convnext_tiny with the bias-free BatchNormUncentered2d, and a
    position-norm one rebuilds convnext_tiny_bnu with the position norm, as
    in JAX: the logits above the logit bias equal JAX's (1e-5), the fast
    pass equals the generic W; without the rebuild the conversion raises."""
    from bcosification_tpu_torch.explain import fast_convnext
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.modules import DetachablePositionNorm2d

    bnu = seeded_model("convnext_tiny", seed=8, norm_layer=NoBias(BatchNormUncentered2d))
    sd = trelease.release_state_dict(bnu, "convnext_tiny")
    rng = np.random.default_rng(9)
    for key in [k for k in sd if k.endswith("running_var")]:
        sd[key[:-len("var")] + "mean"] = torch.from_numpy(
            rng.standard_normal(sd[key].shape).astype(np.float32))
        sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(11)
    path = tmp_path / "convnext_tiny-bnu.pth"
    torch.save({"state_dict": sd}, path)
    pn_sd = trelease.release_state_dict(seeded_model("convnext_tiny", seed=10), "convnext_tiny")
    x = _x("convnext_tiny")
    bias = -math.log(NUM_CLASSES - 1)
    for name, source, norm in (("convnext_tiny", path, BatchNormUncentered2d),
                               ("convnext_tiny_bnu", pn_sd, DetachablePositionNorm2d)):
        model, _ = trelease.convert_release_checkpoint(name, source, return_model=True,
                                                       device="cpu")
        assert type(model.stem_norm) is norm and model.stem_norm.bias is None
        with torch.no_grad():
            got = model(torch.from_numpy(x)).double().numpy()
        raw = trelease.load_torch_state_dict(source)
        want = _jax_forward(name, {k: torch.from_numpy(v) for k, v in raw.items()}, x)
        assert np.abs(want - bias).max() > 1e-3
        assert _rel(got - bias, want - bias) <= 1e-5
        assert fast_convnext.supports(model)
        gl, gs, gw = dynamic_linear_weights(lambda t: model(t, explain=True),
                                            torch.from_numpy(x), device="cpu")
        fl, fs, fw = fast_convnext.fast_dynamic_linear_weights(model, torch.from_numpy(x),
                                                               device="cpu")
        assert torch.equal(fs, gs) and _rel(fw.numpy(), gw.numpy()) <= 1e-5
        with pytest.raises(KeyError):
            trelease.convert_release_checkpoint(name, source, rebuild_norm=False)


def test_families_and_loading(tmp_path):
    """family_of as in JAX; an empty VGG or ConvNeXt checkpoint refused (the
    conversion is strict); a .pth needing full unpickling refused."""
    import argparse
    import pickle
    for name in pretrained.list_available():
        assert trelease.family_of(name) == jrelease.family_of(name)
    with pytest.raises(KeyError, match="found in the checkpoint"):
        trelease.convert_release_checkpoint("vgg11_bnu", {})
    with pytest.raises(KeyError, match="found in the checkpoint"):
        trelease.convert_release_checkpoint("convnext_atto", {})
    with pytest.raises(ValueError, match="no released-checkpoint family"):
        trelease.family_of("alexnet")
    sd = trelease.load_torch_state_dict({"model": {"module.a": torch.ones(2, dtype=torch.float64)}})
    assert list(sd) == ["a"] and sd["a"].dtype == np.float32
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": {"a": torch.ones(2)}, "args": argparse.Namespace(lr=1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        trelease.load_torch_state_dict(path)
