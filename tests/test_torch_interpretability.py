"""The port's explanation methods and grid pointing game against the JAX
package on the CPU, in fp32, on the same weights: the small flagship
(``_flagship(input_size=32, inplanes=8, layers=("bottleneck", (1, 1)))``,
BN-calibrated, carried across by bcosify/from_jax.py) on a 3x3 multi-image
of 32x32 images made from a seed.

- every explainer of ``explainer_map`` (Ours, OursRelative, IxG, Grad, GB,
  DeepLIFT with a zero and a non-zero baseline, IntGrad, GradCam with a
  feature/classifier split, Occlusion, RISE, LIME) against the JAX
  explainer, within 1e-5 relative; LIME within 2e-5 (measured 8.2e-6: its
  ridge solve is ill-conditioned, the port's own LIME moves 3.1e-6 and
  JAX's 6.7e-6 under 1e-7 relative input noise) and Occlusion within 3e-5
  (measured 9.8e-6: a difference of logits, whose own spreads under that
  noise are 6.2e-6 in the port and 9.4e-6 in JAX; a wrong window or fold
  moves it by far more);
- DeepLIFT's summation to f(x) - f(x0) in explanation mode (exact where
  ReLU is the only nonlinearity, b=1; approximate at b=2), GB against the
  hand-gated gradient, K1 refused under guided backprop and DeepLIFT
  (counted on the CPU implementation of the custom op);
- the RISE masks and GradCam's bilinear upsampling against
  ``jax.image.resize`` within 1e-6;
- ``LocalisationAnalyser`` end to end against JAX's on one dataset and one
  model: identical confidences and sampled indices, per-grid metrics
  within 1e-5, for the plain, -neg, -stride= and rescale configs; the
  perfectly localisable ``CellSumModel`` pair scoring 1.0; the
  localisation CLI and sweep on a synthetic tree; the config grid and the
  CLI argument surfaces equal to JAX's.
"""
import argparse
import copy
import pickle

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from bcosification_tpu.interpretability.analyses import localisation as jloc
from bcosification_tpu.interpretability.explanation_methods import explainers as jexpl
from bcosification_tpu.interpretability.explanation_methods import get_explainer as jget
from bcosification_tpu_torch.interpretability.analyses import localisation as tloc
from bcosification_tpu_torch.interpretability.explanation_methods import explainers as texpl
from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer as tget
from test_torch_training import _rel
from torch_port_helpers import NUM_CLASSES, small_pair

torch.set_num_threads(1)
SIZE = 32


def _images(n, seed, size=SIZE):
    x = np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1)


class _Images:
    """A dataset of (image [H, W, C], label)."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], np.int32(self.labels[i])


@pytest.fixture(scope="module")
def flagship():
    """(jax net, variables, port net, 3x3 grid [1, 96, 96, 6], its targets)."""
    net, variables, tnet, _ = small_pair("resnet50", ("bottleneck", (1, 1)), SIZE)
    ds = _Images(_images(9, 3), np.arange(9))
    grid, tgts, offset = jloc.make_multi_image(9, ds)
    tgrid, ttgts, toffset = tloc.make_multi_image(9, ds)
    np.testing.assert_array_equal(grid, tgrid)
    assert (tgts, offset) == (ttgts, toffset) and grid.shape == (1, 96, 96, 6)
    return net, variables, tnet, grid, tgts


EXPLAINERS = [
    ("Ours", {}, 1e-5), ("OursRelative", {}, 1e-5), ("IxG", {}, 1e-5), ("Grad", {}, 1e-5),
    ("GB", {}, 1e-5), ("DeepLIFT", {}, 1e-5), ("DeepLift", {"baseline": 0.3}, 1e-5),
    ("DeepLIFT", {"baseline": 0.3, "explanation_mode": True}, 1e-5),
    ("IntGrad", {}, 1e-5), ("Occlusion", {}, 3e-5), ("Rise", {"n_masks": 128}, 1e-5),
    ("RISE", {}, 1e-5), ("Lime", {}, 2e-5), ("LIME", {"n_samples": 64, "cell_size": 16}, 2e-5),
]


@pytest.mark.parametrize("name,kwargs,bound", EXPLAINERS,
                         ids=[f"{n}-{i}" for i, (n, *_) in enumerate(EXPLAINERS)])
def test_explainer_matches_jax(flagship, name, kwargs, bound):
    """attribute_selection of the 9 targets of the grid, the port's against
    the JAX explainer's on the same weights; attribute of one target is the
    first row."""
    net, variables, tnet, grid, tgts = flagship
    want = np.asarray(jget(net, variables, name, **kwargs).attribute_selection(
        jnp.asarray(grid), jnp.asarray(tgts)))
    explainer = tget(tnet, name, device="cpu", **kwargs)
    got = explainer.attribute_selection(grid, tgts)
    assert isinstance(got, torch.Tensor) and got.shape == (9, 96, 96, 6)
    assert np.abs(want).max() > 0  # the comparison has signal
    assert _rel(got.numpy(), want) <= bound, (name, _rel(got.numpy(), want))
    if name in ("Ours", "IxG"):
        one = explainer.attribute(torch.from_numpy(grid), tgts[4])
        assert one.shape == (1, 96, 96, 6) and _rel(one.numpy(), got[4:5].numpy()) <= 1e-6


def _split_fns(seed=4):
    """A feature/classifier split built in both packages from the same
    weights: a strided 3x3 B-cos conv and ReLU, then a 1x1 B-cos conv to the
    per-location logits."""
    from bcosification_tpu.ops import bcos as jops
    from bcosification_tpu_torch.ops import bcos as tops

    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((16, 6, 3, 3)).astype(np.float32)  # OIHW
    w2 = rng.standard_normal((NUM_CLASSES, 16, 1, 1)).astype(np.float32)
    hwio = [jnp.asarray(w.transpose(2, 3, 1, 0)) for w in (w1, w2)]
    jfeat = lambda x: jax.nn.relu(jops.bcos_conv2d(x, hwio[0], stride=4, padding=1))
    jcls = lambda f: jops.bcos_conv2d(f, hwio[1])
    tw = [torch.from_numpy(w) for w in (w1, w2)]
    tfeat = lambda x: torch.relu(tops.bcos_conv2d(x, tw[0], stride=4, padding=1))
    tcls = lambda f: tops.bcos_conv2d(f, tw[1])
    return (jfeat, jcls), (tfeat, tcls)


def test_gradcam_matches_jax(flagship):
    """GradCam on a feature/classifier split (24x24 maps upsampled to the
    96x96 grid), within 1e-5; without the split it asserts, as in JAX."""
    net, variables, tnet, grid, tgts = flagship
    (jfeat, jcls), (tfeat, tcls) = _split_fns()
    want = np.asarray(jget(net, variables, "GradCam", feature_fn=jfeat, classifier_fn=jcls)
                      .attribute_selection(jnp.asarray(grid), jnp.asarray(tgts)))
    got = tget(tnet, "GradCam", device="cpu", feature_fn=tfeat,
               classifier_fn=tcls).attribute_selection(grid, tgts).numpy()
    assert np.abs(want).max() > 0 and _rel(got, want) <= 1e-5
    with pytest.raises(AssertionError, match="feature_fn"):
        tget(tnet, "GradCam", device="cpu").attribute_selection(grid, tgts)


@pytest.mark.parametrize("size", [(224, 224), (50, 33)])
def test_bilinear_upsample_matches_jax_resize(size):
    """F.interpolate (bilinear, align_corners=False, no antialias) against
    jax.image.resize "linear" / "bilinear" when upsampling, within 1e-6."""
    a = np.random.default_rng(0).random((3, 7, 7)).astype(np.float32)
    got = texpl.bilinear_upsample(torch.from_numpy(a), size).numpy()
    for method in ("linear", "bilinear"):
        want = np.asarray(jax.image.resize(jnp.asarray(a), (3, *size), method))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(224, 224), (96, 80)])
def test_rise_masks_match_jax(hw):
    """The RISE masks (numpy draws, the bilinear upsampling, the random
    crops) against the JAX package's within 1e-6."""
    want = jexpl.Rise(None, None, n_masks=64, cell_size=7, seed=2)._masks(*hw)
    got = texpl.Rise(None, device="cpu", n_masks=64, cell_size=7, seed=2)._masks(*hw)
    assert got.shape == (64, *hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_registry_matches_jax():
    from bcosification_tpu.interpretability import explanation_methods as jem
    from bcosification_tpu_torch.interpretability import explanation_methods as tem

    assert sorted(tem.explainer_map) == sorted(jem.explainer_map)
    assert tem.explanation_configs == jem.explanation_configs
    for alias, name in (("DeepLift", "DeepLIFT"), ("RISE", "Rise"), ("LIME", "Lime")):
        assert tem.explainer_map[alias] is tem.explainer_map[name]
    with pytest.raises(ValueError, match="Unknown explainer"):
        tget(None, "SHAP", device="cpu")


# --------------------------------------------------------------------------
# guided backprop and DeepLIFT
# --------------------------------------------------------------------------
class _ReluMLP(nn.Module):
    def __init__(self, w1, w2):
        super().__init__()
        from bcosification_tpu_torch.modules import ReLU

        self.w1, self.w2, self.act = torch.from_numpy(w1), torch.from_numpy(w2), ReLU()

    def forward(self, x, *, train=False, explain=False):
        return self.act(x.reshape(x.shape[0], -1) @ self.w1) @ self.w2


def test_guided_backprop_matches_manual_gating():
    """GB on Dense -> ReLU -> Dense equals the hand-gated gradient (only
    positive gradients through positively activated units), differs from
    Grad, and leaves no guided ReLU behind (Grad after GB is autograd's)."""
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((12, 16)).astype(np.float32)
    w2 = rng.standard_normal((16, 5)).astype(np.float32)
    x = rng.standard_normal((1, 12)).astype(np.float32)
    model = _ReluMLP(w1, w2)
    got = tget(model, "GB", device="cpu").attribute_selection(x, [2])[0].numpy()
    h, g_h = x[0] @ w1, w2[:, 2]
    np.testing.assert_allclose(got, w1 @ np.where((h > 0) & (g_h > 0), g_h, 0.0),
                               rtol=1e-5, atol=1e-6)
    vanilla = tget(model, "Grad", device="cpu").attribute_selection(x, [2])[0].numpy()
    assert np.abs(got - vanilla).max() > 1e-4
    np.testing.assert_allclose(vanilla, w1 @ np.where(h > 0, g_h, 0.0), rtol=1e-5, atol=1e-6)


def test_guided_relu_values_and_mode_scope():
    """ops.guided.relu has the ReLU's values in every mode; the modes are
    scoped to their context."""
    from bcosification_tpu_torch.ops import guided

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32))
    pair = torch.cat([x, 0.5 * x])
    for ctx, inp in ((guided.guided_backprop, x), (guided.deeplift, pair)):
        with ctx():
            assert guided.guided_mode() or guided.deeplift_mode()
            torch.testing.assert_close(guided.relu(inp), torch.relu(inp), rtol=0, atol=0)
    assert not guided.guided_mode() and not guided.deeplift_mode()


def _b_net(b):
    """The small flagship at b (JAX build, uncalibrated) in both packages."""
    from bcosification_tpu.bcosify.engine import RESNET_LAYERS, build_bcosified_resnet as jbuild
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from torch_port_helpers import FLAGSHIP_CONFIG

    config = {**FLAGSHIP_CONFIG, "name": "resnet50", "bcos_args": {"b": b}}
    old = RESNET_LAYERS["resnet50"]
    RESNET_LAYERS["resnet50"] = ("bottleneck", (1, 1))
    try:
        net, variables = jbuild(config, None, input_size=SIZE, num_classes=NUM_CLASSES,
                                inplanes=8)
    finally:
        RESNET_LAYERS["resnet50"] = old
    tnet = build_bcosified_resnet(config, num_classes=NUM_CLASSES, inplanes=8,
                                  layers=("bottleneck", (1, 1)), device="cpu")
    load_jax_variables(tnet, jax.tree_util.tree_map(np.asarray, variables))
    return net, variables, tnet


def test_deeplift_completeness_in_explanation_mode():
    """sum(attr) = f(x) - f(x0) in explanation mode: exact at b=1 (ReLU the
    only nonlinearity), approximate at b=2 (the dynamic scales keep their
    ordinary gradients), as in JAX; the attributions equal JAX's (1e-5)."""
    x = np.random.default_rng(2).standard_normal((1, SIZE, SIZE, 6)).astype(np.float32)
    baseline = np.full_like(x, 0.3)
    t = 3
    for b, rel_bound in ((1, 1e-4), (2, 0.25)):
        net, variables, tnet = _b_net(b)
        kw = dict(baseline=baseline, explanation_mode=True)
        attr = tget(tnet, "DeepLIFT", device="cpu", **kw).attribute_selection(x, [t])[0]
        want = jget(net, variables, "DeepLIFT", **kw).attribute_selection(
            jnp.asarray(x), jnp.asarray([t]))[0]
        assert _rel(attr.numpy(), np.asarray(want)) <= 1e-5
        with torch.no_grad():
            delta = float(tnet(torch.from_numpy(x), explain=True)[0, t]
                          - tnet(torch.from_numpy(baseline), explain=True)[0, t])
        assert abs(float(attr.sum()) - delta) <= rel_bound * max(abs(delta), 1e-8), (b, delta)


class _TinyReluNet(nn.Module):
    """B-cos 3x3 conv, ReLU, B-cos 1x1 conv, spatial mean: bias-free."""

    def __init__(self):
        super().__init__()
        from bcosification_tpu_torch.modules import BcosConv2d, ReLU

        gen = torch.Generator().manual_seed(2)
        self.conv1 = BcosConv2d(6, 8, 3, padding=1, generator=gen)
        self.act = ReLU()
        self.conv2 = BcosConv2d(8, 4, 1, generator=gen)

    def forward(self, x, *, train=False, explain=False):
        f = dict(train=train, explain=explain)
        return self.conv2(self.act(self.conv1(x, **f), **f), **f).mean(dim=(1, 2))


def test_deeplift_zero_baseline_equals_ixg_on_a_relu_net():
    """On a bias-free ReLU net the Rescale multiplier from a zero baseline is
    the ReLU's gradient: DeepLIFT equals IxG; and GB differs from Grad
    there, but not on the net without its ReLU (the CLIP towers' case)."""
    from bcosification_tpu_torch.modules import Identity

    net = _TinyReluNet()
    x = np.random.default_rng(5).standard_normal((1, 8, 8, 6)).astype(np.float32)
    a_dl = tget(net, "DeepLIFT", device="cpu").attribute_selection(x, [1, 2]).numpy()
    a_ixg = tget(net, "IxG", device="cpu").attribute_selection(x, [1, 2]).numpy()
    np.testing.assert_allclose(a_dl, a_ixg, rtol=1e-5, atol=1e-7)
    a_gb = tget(net, "GB", device="cpu").attribute_selection(x, [1]).numpy()
    a_gr = tget(net, "Grad", device="cpu").attribute_selection(x, [1]).numpy()
    assert np.abs(a_gb - a_gr).max() > 1e-6
    net.act = Identity()
    np.testing.assert_array_equal(tget(net, "GB", device="cpu").attribute_selection(x, [1]),
                                  tget(net, "Grad", device="cpu").attribute_selection(x, [1]))


def test_guided_modes_keep_every_conv_off_k1(flagship, monkeypatch):
    """Outside the modes the explanation-mode forward takes K1 at each fused
    1x1 (conv1, conv3 and the downsample of each bottleneck: 6 here); under
    guided backprop or DeepLIFT no conv takes it (K1's backward has the
    plain ReLU mask built in), and the values stay the same. Counted on the
    custom op's CPU implementation."""
    from bcosification_tpu_torch.ops import guided
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1

    _, _, tnet, grid, _ = flagship
    calls = {"k1": 0}
    plain = bcos_conv1x1.conv1x1_fwd_plain

    def counting(*args, **kwargs):
        calls["k1"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(bcos_conv1x1, "conv1x1_fwd_plain", counting)
    from bcosification_tpu_torch.modules import BcosConv2d

    fused = sum(isinstance(m, BcosConv2d) and m.kernel_size == (1, 1)
                for m in tnet.model.modules()) - 1  # every 1x1 but the classifier
    x = torch.from_numpy(np.concatenate([grid, 0.5 * grid])).requires_grad_(True)
    with torch.enable_grad():
        ref = tnet(x, explain=True)
    assert calls["k1"] == fused == 6
    for mode in (guided.guided_backprop, guided.deeplift):
        calls["k1"] = 0
        with torch.enable_grad(), mode():
            out = tnet(x, explain=True)
        assert calls["k1"] == 0, mode.__name__
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    calls["k1"] = 0
    for name, kw in (("GB", {}), ("DeepLIFT", {"explanation_mode": True}),
                     ("DeepLIFT", {})):
        tget(tnet, name, device="cpu", **kw).attribute_selection(grid, [0, 1])
    assert calls["k1"] == 0
    tget(tnet, "Ours", device="cpu").attribute_selection(grid, [0, 1])
    assert calls["k1"] == fused


# --------------------------------------------------------------------------
# the grid pointing game
# --------------------------------------------------------------------------
class _Offset:
    """The JAX net with a constant per-class offset on its logits (the
    gradients are unchanged): the offset spreads the small net's argmax over
    its classes, so that the strict sampling rule finds enough classes."""

    def __init__(self, net, offset):
        self.net, self.offset = net, jnp.asarray(offset)

    def apply(self, variables, x, train=False, explain=False):
        return self.net.apply(variables, x, train=train, explain=explain) + self.offset


class _TorchOffset(nn.Module):
    def __init__(self, net, offset):
        super().__init__()
        self.net, self.offset = net, torch.from_numpy(offset)

    def forward(self, x, *, train=False, explain=False):
        return self.net(x, train=train, explain=explain) + self.offset


def _offset_pair(flagship, images):
    net, variables, tnet, _, _ = flagship
    with torch.no_grad():
        logits = tnet(torch.from_numpy(images)).numpy()
    offset = (-logits.mean(0)).astype(np.float32)
    labels = (logits + offset).argmax(-1)
    return _Offset(net, offset), variables, _TorchOffset(tnet, offset), labels


def _both_analysers(flagship, images, cfg, tmp_path, explainer="Ours"):
    jnet, variables, tnet, labels = _offset_pair(flagship, images)
    ds = _Images(images, labels)
    ja = jloc.LocalisationAnalyser(jnet, variables, ds, save_folder=tmp_path / "jax",
                                   explainer_name=explainer, **cfg)
    ta = tloc.LocalisationAnalyser(tnet, ds, save_folder=tmp_path / "port", device="cpu",
                                   explainer_name=explainer, **cfg)
    return ja, ta


def _assert_same_analysis(ja, ta):
    jconf, tconf = ja.compute_sorted_confs(), ta.compute_sorted_confs()
    assert sorted(jconf) == sorted(tconf) == list(range(NUM_CLASSES))
    for k in jconf:
        assert [i for i, _ in tconf[k]] == [i for i, _ in jconf[k]], k
        np.testing.assert_allclose([c for _, c in tconf[k]], [c for _, c in jconf[k]],
                                   rtol=1e-5, atol=1e-6)
    jidx, tidx = ja.get_sorted_indices(jconf), ta.get_sorted_indices(tconf)
    assert tidx == jidx and len(tidx) >= 2 * ta.config["n_imgs"]
    jres, tres = ja.run()["localisation_metric"], ta.run()["localisation_metric"]
    assert tres.shape == jres.shape and len(tres) >= 2 * ta.config["n_imgs"]
    np.testing.assert_allclose(tres, jres, rtol=0, atol=1e-5)
    return tres


@pytest.mark.parametrize("config_name,explainer", [
    ("50_2x2_noconfthresh", "Ours"), ("50_2x2_noconfthresh-neg", "Ours"),
    ("50_2x2_noconfthresh-stride=14", "Ours"), ("50_2x2", "IxG"),
])
def test_localisation_analyser_matches_jax(flagship, config_name, explainer, tmp_path):
    """LocalisationAnalyser against JAX's on 48 seeded images labelled by the
    offset model's argmax: the same confidences, the same sampled indices
    and per-grid metrics within 1e-5 (2x2 grids; smooth 15; the striding
    config attributes 5 x 5 overlapping 32x32 crops per grid)."""
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import configs

    cfg = dict(configs[config_name], batch_size=16, sample_size=4)
    ja, ta = _both_analysers(flagship, _images(48, 11), cfg, tmp_path, explainer)
    result = _assert_same_analysis(ja, ta)
    assert np.isfinite(result).all() and ((0 <= result) & (result <= 1)).all()
    with open(tmp_path / "port" / "confidences.pkl", "rb") as f:
        assert pickle.load(f) == ta.compute_sorted_confs()


def _stub_experiment(presets, datamodules):
    class Stub:
        config = {"data": dict(
            train_transform=presets.ImageNetClassificationPresetTrain(crop_size=64,
                                                                       is_bcos=True),
            test_transform=presets.ImageNetClassificationPresetEval(
                crop_size=64, resize_size=72, is_bcos=True),
            batch_size=8, num_workers=0)}

        def get_datamodule(self, **overrides):
            return datamodules.ImageNetDataModule({**self.config["data"], **overrides})

    return Stub()


def test_localisation_rescale_config_matches_jax(flagship, tmp_path, monkeypatch):
    """The rescale config: make_datamodule_for_config shrinks the eval
    transform by the grid size (crop 64 -> 32, resize 72 -> 36 for 2x2) in
    both packages, whose eval sets are then equal; the analysers on them
    agree as above."""
    from bcosification_tpu import settings as jsettings
    from bcosification_tpu.data import datamodules as jdm
    from bcosification_tpu.data import presets as jpresets
    from bcosification_tpu_torch import settings as tsettings
    from bcosification_tpu_torch.data import datamodules as tdm
    from bcosification_tpu_torch.data import presets as tpresets
    from bcosification_tpu_torch.data.synthetic import write_imagenet_tree
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import configs

    tree = tmp_path / "tree"
    write_imagenet_tree(tree, 4, 4, 40, sizes=((80, 90), (96, 72)), seed=1, workers=1)
    monkeypatch.setattr(jsettings, "IMAGENET_PATH", str(tree))
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", str(tree))
    cfg = dict(configs["50_2x2_rescale_noconfthresh"], batch_size=16, sample_size=4)
    modules = []
    for loc, presets, dms in ((jloc, jpresets, jdm), (tloc, tpresets, tdm)):
        dm = loc.make_datamodule_for_config(_stub_experiment(presets, dms), cfg)
        assert dm.config["test_transform"].args["crop_size"] == 32
        dm.setup("test")
        modules.append(dm)
    jds, tds = (dm.eval_dataset for dm in modules)
    images = np.stack([np.asarray(tds[i][0]) for i in range(len(tds))])
    np.testing.assert_array_equal(images, np.stack([np.asarray(jds[i][0])
                                                    for i in range(len(jds))]))
    assert images.shape == (40, 32, 32, 6)
    _assert_same_analysis(*_both_analysers(flagship, images, cfg, tmp_path))


class CellSumModel(nn.Module):
    """Logit c = the mean of channel c over the image: the evidence for
    class c is the input's intensity in channel c (the port's twin of
    tests/test_interpretability.py::CellSumModel)."""

    def __init__(self, num_classes=4):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, x, *, train=False, explain=False):
        return x[..., :self.num_classes].mean(dim=(1, 2))


class OneHotChannelDataset:
    """Image i lights up channel (i % num_classes) in every pixel."""

    def __init__(self, n=32, size=8, num_classes=4, channels=6):
        self.n, self.size, self.num_classes, self.channels = n, size, num_classes, channels

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        c = i % self.num_classes
        img = np.zeros((self.size, self.size, self.channels), np.float32)
        img[..., c] = 1.0
        return img, np.int32(c)


@pytest.mark.parametrize("explainer_name,n_imgs,striding", [
    ("Ours", 4, "none"), ("IxG", 4, "none"), ("IntGrad", 4, "none"), ("Ours", 9, "none"),
    ("IxG", 4, "4"),
])
def test_perfectly_localisable_pair_scores_one(explainer_name, n_imgs, striding, tmp_path):
    """CellSumModel on one-hot-channel images localises perfectly: metric 1.0
    for the input-weighted explainers, also in the striding mode (the
    stride divides the crop, so every pixel has the same cover)."""
    classes = n_imgs + 1  # the sampler needs strictly more classes than cells
    analyser = tloc.LocalisationAnalyser(
        CellSumModel(classes), OneHotChannelDataset(n=6 * classes, num_classes=classes,
                                                    channels=max(6, classes)),
        save_folder=tmp_path, device="cpu", explainer_name=explainer_name,
        sample_size=2, n_imgs=n_imgs, smooth=0, conf_thresh=None, batch_size=8,
        striding=striding)
    metric = analyser.run()["localisation_metric"]
    assert len(metric) == 2 * n_imgs
    np.testing.assert_allclose(metric, 1.0, atol=1e-5)


def test_localisation_config_grid_matches_jax():
    from bcosification_tpu.interpretability.analyses.localisation_configs import configs as jc
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import configs

    assert configs == jc and len(configs) == 288
    c = configs["250_3x3_rescale_noconfthresh-stride=14-neg"]
    assert c["do_rescale"] and c["neg"] and c["striding"] == "14" and c["n_imgs"] == 9


def _flags(parser):
    return {a for act in parser._actions for a in act.option_strings}


def test_cli_argument_surfaces_match_jax():
    """The localisation and text-localisation CLIs take the JAX package's
    flags, no more, with the same defaults."""
    from bcosification_tpu.interpretability.analyses import text_localisation as jtl
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as ttl

    for jmod, tmod, argv in ((jloc, tloc, ["--experiment_name", "resnet_18", "--smooth", "15"]),
                             (jtl, ttl, ["--exp_name", "x", "--text_to_localize", "a,b"])):
        jp, tp = jmod.argument_parser(), tmod.argument_parser()
        assert _flags(tp) == _flags(jp)
        assert vars(tp.parse_args(argv)) == vars(jp.parse_args(argv))


def test_sweep_argument_surface_matches_jax(monkeypatch):
    """The sweep's flags and defaults equal the JAX sweep's (whose parser
    lives inside its main)."""
    from bcosification_tpu.interpretability.analyses import localisation_sweep as jsweep
    from bcosification_tpu_torch.interpretability.analyses import localisation_sweep as tsweep

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def stop(parser, *args, **kwargs):
        seen["flags"] = _flags(parser)
        seen["args"] = vars(parse(parser, ["--experiment_name", "e"]))
        raise SystemExit

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(SystemExit):
        jsweep.main()
    monkeypatch.undo()
    parser = tsweep.argument_parser()
    assert _flags(parser) == seen["flags"]
    assert vars(parser.parse_args(["--experiment_name", "e"])) == seen["args"]


def test_localisation_cli_and_sweep_on_a_synthetic_tree(flagship, tmp_path, monkeypatch):
    """localisation.main and localisation_sweep.main on the CPU over a
    synthetic ImageNet tree, the resnet_50 Experiment's model swapped for
    the small flagship and its checkpoint written by the port's
    CheckpointManager: each reaches its end and writes confidences.pkl, the
    metric array and config.log (the random net classifies the tree's
    images by chance, so the metric may be empty)."""
    import json

    from bcosification_tpu_torch import settings as tsettings
    from bcosification_tpu_torch.data.synthetic import write_imagenet_tree
    from bcosification_tpu_torch.experiments.utils import experiment_utils
    from bcosification_tpu_torch.interpretability.analyses import localisation_sweep
    from bcosification_tpu_torch.training.checkpointing import CheckpointManager

    tnet = flagship[2]
    tree = tmp_path / "tree"
    write_imagenet_tree(tree, 4, 4, 24, sizes=((40, 48),), seed=2, workers=1)
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", str(tree))
    monkeypatch.setattr(tsettings, "EXPERIMENT_ROOT", str(tmp_path / "exp"))
    monkeypatch.setattr(experiment_utils.Experiment, "get_model",
                        lambda self, device=None: copy.deepcopy(tnet).to(device))
    exp = experiment_utils.Experiment("ImageNet", "bcosification", "resnet_50")
    monkeypatch.setitem(exp.config["data"], "test_transform",
                        exp.config["data"]["test_transform"].with_args(crop_size=32,
                                                                       resize_size=36))
    CheckpointManager(str(exp.save_dir), monitor="val_acc1", mode="max").save(
        {"model": tnet.state_dict()}, 0, {"val_acc1": 0.5})
    args = tloc.argument_parser().parse_args(
        ["--experiment_name", "resnet_50", "--analysis_config", "50_3x3_noconfthresh",
         "--smooth", "15", "--save_root", str(tmp_path / "out"), "--batch_size", "8"])
    results = tloc.main(args, device="cpu")
    out = tmp_path / "out" / "resnet_50" / "50_3x3_noconfthresh" / "Ours"
    assert (out / "confidences.pkl").exists() and (out / "config.log").exists()
    saved = np.load(out / "localisation_metric.np.npy")
    np.testing.assert_array_equal(saved, results["localisation_metric"])
    assert json.loads((out / "config.log").read_text())["config"]["explainer_name"] == "Ours"
    sweep = localisation_sweep.argument_parser().parse_args(
        ["--experiment_name", "resnet_50", "--reload", "last", "--explainers", "Ours", "IxG",
         "--analysis_configs", "50_2x2_noconfthresh", "--save_root", str(tmp_path / "sweep")])
    localisation_sweep.main(sweep, device="cpu")
    for name in ("Ours", "IxG"):
        run = tmp_path / "sweep" / "resnet_50" / "50_2x2_noconfthresh" / name
        assert (run / "localisation_metric.np.npy").exists() and (run / "config.log").exists()
