"""Released B-cos v2 checkpoints into the port (``bcosify/release_import.py``)
against the JAX package's importer, on the CPU, in fp32.

The registry entries resnet50, densenet121 and the two B-cos ViTs are
pointed, in both packages for the test, at small nets of their classes
(ResNet-50's bottleneck at layers (1, 1), width 8; the DenseNet of growth
8, blocks (2, 2); the ViTs of test_torch_vit_final), so that both
``convert_release_checkpoint``s run as they do for the name. A seeded
state dict in the reference's layout (``release_state_dict`` of a port
model whose weights are drawn with numpy; B-cos layers under
``.linear.weight``, the ViTs under BcosSequential's ``0.``) converts in
both packages to the same outputs (1e-5), and back to the same weights;
the import is strict both ways; a checkpoint with running statistics
rebuilds the ResNet with uncentered BN, which folds into K1.
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.bcosify import release_import as jrelease
from bcosification_tpu.models import densenet as jdensenet
from bcosification_tpu.models import pretrained as jpretrained
from bcosification_tpu.models import resnet as jresnet
from bcosification_tpu_torch.bcosify import release_import as trelease
from bcosification_tpu_torch.models import densenet as tdensenet
from bcosification_tpu_torch.models import pretrained
from bcosification_tpu_torch.models import resnet as tresnet
from bcosification_tpu_torch.modules import BatchNormUncentered2d
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
NAMES = ["resnet50", "densenet121", "simple_vit_ti_patch16_224", "vitc_ti_patch1_14"]


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
    with small_archs(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _kw(name):
    return {} if name in SMALL else {"num_classes": NUM_CLASSES}


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
    return np.asarray(jax.jit(lambda t: model.apply(variables, t, train=False))(
        jnp.asarray(x)), np.float64)


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


def test_families_and_loading(tmp_path):
    """family_of as in JAX; VGG and ConvNeXt refused naming A4b; a .pth
    needing full unpickling refused."""
    import argparse
    import pickle
    for name in pretrained.list_available() + list(pretrained.NOT_PORTED):
        assert trelease.family_of(name) == jrelease.family_of(name)
    with pytest.raises(NotImplementedError, match="A4b"):
        trelease.convert_release_checkpoint("vgg11_bnu", {})
    with pytest.raises(NotImplementedError, match="A4b"):
        trelease.convert_release_checkpoint("convnext_tiny", {})
    with pytest.raises(ValueError, match="no released-checkpoint family"):
        trelease.family_of("alexnet")
    sd = trelease.load_torch_state_dict({"model": {"module.a": torch.ones(2, dtype=torch.float64)}})
    assert list(sd) == ["a"] and sd["a"].dtype == np.float32
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": {"a": torch.ones(2)}, "args": argparse.Namespace(lr=1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        trelease.load_torch_state_dict(path)
