"""The port's command-line tools (bcosification_tpu_torch/scripts/) and its
minimal example (bcosification_tpu_torch/examples/explain_minimal.py)
against the JAX package's ``scripts/`` and ``examples/``, on the CPU in
fp32, at small sizes:

- import_torch_checkpoint: a seeded torchvision-layout ResNet state dict
  (test_torch_import's) through both CLIs, the experiment's build function pointed
  at the small flagship in both packages: the same keys and arrays, the same
  file and sha stamp; each file loads in the other package's loader to the
  same logits (1e-5); the prefix and EMA selection of a Lightning file;
- strip_checkpoints: a checkpoint of a tiny port experiment (the small
  flagship, in the Trainer's checkpoint format) becomes an npz that the JAX
  package loads to the port's logits; ``--ema`` exports the EMA weights and
  raises without them;
- export_serving: the program the port's CLI writes gives the JAX
  program's logits, class and W (the JAX program deserialised and called);
- precompute_zeroshot_weights: both CLIs on one seeded text tower, the class
  and template lists cut to a few, give the same matrix, and each .npy loads
  in the other package; both refuse without weights;
- validate_release_weights: ``evaluate_imagenet`` on a seeded resnet18.pth
  (both registries pointed at a small ResNet-18) over a 2-class tree,
  ``evaluate_clip_zeroshot`` without the reference on a seeded CLIP student
  over 2 shards, and ``main``'s exit codes on the same argv;
- explain_minimal: the calibration, the explanation and the PNG against the
  JAX example's on the small flagship's weights (1000 classes, 224x224).
"""
import importlib.util
import io
import json
import re
import sys
import tarfile
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bcosification_tpu.bcosify import engine as jengine  # noqa: E402
from bcosification_tpu.bcosify.torch_import import variables_from_npz  # noqa: E402
from bcosification_tpu.models import pretrained as jpretrained  # noqa: E402
from bcosification_tpu.models import resnet as jresnet  # noqa: E402
from bcosification_tpu_torch.bcosify import engine as tengine  # noqa: E402
from bcosification_tpu_torch.bcosify.from_jax import (  # noqa: E402
    load_jax_npz,
    load_jax_variables,
    to_jax_variables,
)
from bcosification_tpu_torch.experiments.utils import experiment_utils  # noqa: E402
from bcosification_tpu_torch.models import pretrained as tpretrained  # noqa: E402
from bcosification_tpu_torch.models import resnet as tresnet  # noqa: E402
from bcosification_tpu_torch.scripts import export_serving as texport  # noqa: E402
from bcosification_tpu_torch.scripts import import_torch_checkpoint as titc  # noqa: E402
from bcosification_tpu_torch.scripts import precompute_zeroshot_weights as tzs  # noqa: E402
from bcosification_tpu_torch.scripts import strip_checkpoints as tstrip  # noqa: E402
from bcosification_tpu_torch.scripts import validate_release_weights as tvalidate  # noqa: E402
from scripts import import_torch_checkpoint as jitc  # noqa: E402
from scripts import precompute_zeroshot_weights as jzs  # noqa: E402
from scripts import validate_release_weights as jvalidate  # noqa: E402
from torch_port_helpers import FLAGSHIP_CONFIG, small_pair  # noqa: E402

torch.set_num_threads(1)
SIZE, NUM_CLASSES = 32, 10
LAYERS = ("bottleneck", (1, 1))
EXPERIMENT = ("ImageNet", "bcosification", "resnet_50")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def flagship():
    """(JAX net, JAX variables, port net, x [2, 32, 32, 6]): the calibrated
    small flagship, the module's one JAX build."""
    return small_pair("resnet50", LAYERS, SIZE, seed=2)


def _unset(monkeypatch, *names):
    """Unset environment variables for the test; a CLI's own settings of them
    are undone at its end too."""
    for name in names:
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)


def _jax_logits(net, variables, x):
    return np.asarray(jax.jit(lambda v, t: net.apply(v, t, train=False))(variables,
                                                                         jnp.asarray(x)))


def _port_logits(tnet, x):
    with torch.no_grad():
        return tnet(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# import_torch_checkpoint
# ---------------------------------------------------------------------------
@pytest.fixture
def small_factories(monkeypatch):
    """Both packages' ResNet build functions pointed at the small flagship (inplanes
    8, LAYERS, NUM_CLASSES), so that each script's ``convert`` builds it from
    the resnet_50 experiment's recipe."""
    real_j, real_t = jengine.build_bcosified_resnet, tengine.build_bcosified_resnet

    def jbuild(mc, state_dict=None, **_):
        return real_j(mc, state_dict, input_size=SIZE, num_classes=NUM_CLASSES, inplanes=8)

    def tbuild(mc, state_dict=None, *, device=None, **_):
        return real_t(mc, state_dict, num_classes=NUM_CLASSES, inplanes=8, layers=LAYERS,
                      device=device)

    monkeypatch.setitem(jengine.RESNET_LAYERS, "resnet50", LAYERS)
    monkeypatch.setattr(jengine, "build_bcosified_resnet", jbuild)
    monkeypatch.setattr(tengine, "build_bcosified_resnet", tbuild)


def test_import_torch_checkpoint_matches_jax_and_loads_across(flagship, small_factories,
                                                              tmp_path, monkeypatch):
    from test_torch_import import calibrated_state_dict

    jnet, jtemplate, _, x = flagship
    mc = experiment_utils.Experiment(*EXPERIMENT).model_config
    sd = calibrated_state_dict("resnet50", mc)
    ckpt = tmp_path / "resnet50.pth"
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ckpt)

    argv = ["--checkpoint", str(ckpt), "--experiment_name", "resnet_50"]
    monkeypatch.setattr(sys, "argv", ["import_torch_checkpoint.py", *argv, "--output_dir",
                                      str(tmp_path / "jax")])
    jitc.main()
    (jpath,) = (tmp_path / "jax").glob("*.npz")
    tpath = titc.main([*argv, "--output_dir", str(tmp_path / "port")], device="cpu")
    # the stamp is the file's own sha, and the same weights give the same file
    assert re.fullmatch(r"resnet_50-[0-9a-f]{8}\.npz", tpath.name)
    import hashlib

    assert hashlib.sha256(tpath.read_bytes()).hexdigest()[:8] == tpath.stem[-8:]
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for key in jz.files:
            assert jz[key].dtype == tz[key].dtype, key
            np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    assert tpath.name == jpath.name
    bare = titc.main([*argv, "--output_dir", str(tmp_path / "bare"), "--no-sha",
                      "--entrypoint", "rn50"], device="cpu")
    assert bare.name == "rn50.npz" and bare.read_bytes() == tpath.read_bytes()

    # across: the port's file in the JAX loader, the JAX file in the port's
    jvars = variables_from_npz(str(tpath), jtemplate)
    tnet = tengine.build_bcosified_resnet({**FLAGSHIP_CONFIG, "name": "resnet50"},
                                          device="cpu")
    load_jax_npz(tnet, jpath)
    want = _jax_logits(jnet, jvars, x)
    bias = -np.log(NUM_CLASSES - 1)
    assert np.abs(want - bias).max() > 1e-2  # calibrated: the comparison has signal
    assert _rel(_port_logits(tnet, x) - bias, want - bias) <= 1e-5


def test_import_selects_one_weight_set_like_jax(tmp_path):
    a, b, c = (torch.full((2,), v) for v in (1.0, 2.0, 3.0))
    both = tmp_path / "both.pth"
    torch.save({"state_dict": {"model.conv.weight": a, "ema.module.model.conv.weight": b}},
               both)
    ema_only = tmp_path / "ema_only.pth"
    torch.save({"state_dict": {"ema.module.conv.weight": c}}, ema_only)
    plain = tmp_path / "plain.pth"
    torch.save({"module.model.fc.weight": a}, plain)
    cases = [(both, False, {"conv.weight": a}), (both, True, {"conv.weight": b}),
             (ema_only, True, {"conv.weight": c}), (plain, False, {"fc.weight": a})]
    for path, ema, want in cases:
        got = titc.load_torch_state_dict(str(path), use_ema=ema)
        ref = jitc.load_torch_state_dict(str(path), use_ema=ema)
        assert got.keys() == ref.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k])
            torch.testing.assert_close(ref[k], want[k])
    for mod in (titc, jitc):  # only the other set: it is used, with a warning
        with pytest.warns(UserWarning, match="ema.module"):
            assert mod.load_torch_state_dict(str(ema_only), use_ema=False).keys() == {
                "conv.weight"}


def test_convert_refuses_other_archs_like_jax():
    for mod, kw in ((jitc, {}), (titc, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unsupported arch"):
            mod.convert({}, "ImageNet", "vit_bcosification",
                        "bcosifyv2_bcos_simple_vit_ti_patch16_224", **kw)


# ---------------------------------------------------------------------------
# a tiny port experiment (strip_checkpoints, export_serving)
# ---------------------------------------------------------------------------
NAME = "tiny"


@pytest.fixture
def tiny(flagship, tmp_path, monkeypatch):
    """The resnet_50 recipe on the small flagship as experiment ``tiny`` under
    tmp_path, with the flagship's weights saved as its epoch-0 checkpoint
    (as Trainer.fit writes it). Returns (root, model)."""
    from bcosification_tpu_torch import settings as tsettings
    from bcosification_tpu_torch.experiments.ImageNet.bcosification import (
        experiment_parameters,
    )

    _, _, tnet, _ = flagship

    def model(model_config, device=None):
        net = tengine.build_bcosified_resnet(model_config, num_classes=NUM_CLASSES, inplanes=8,
                                             layers=LAYERS, device=device, seed=7)
        return net

    configs = {NAME: experiment_parameters.CONFIGS["resnet_50"]}
    monkeypatch.setattr(experiment_utils, "get_configs_and_model_factory",
                        lambda dataset, base_network: (configs, model))
    monkeypatch.setattr(tsettings, "EXPERIMENT_ROOT", str(tmp_path / "exp"))
    return tmp_path, tnet


def _save(state):
    experiment_utils.Experiment("ImageNet", "bcosification", NAME)._ckpt_manager().save(
        state, 0, {"val_acc1": 0.0})


def test_strip_checkpoints_loads_in_jax(flagship, tiny):
    jnet, jvars, _, x = flagship
    root, tnet = tiny
    sd = tnet.state_dict()
    _save({"model": sd})
    out = tstrip.main(["--experiment_name", NAME, "--reload", "last", "--output_dir",
                       str(root / "w")], device="cpu")
    assert re.fullmatch(rf"{NAME}-[0-9a-f]{{8}}\.npz", out.name)
    loaded = variables_from_npz(str(out), jvars)
    np.testing.assert_allclose(_jax_logits(jnet, loaded, x), _port_logits(tnet, x), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="EMA"):
        tstrip.main(["--experiment_name", NAME, "--reload", "last", "--ema", "--output_dir",
                     str(root / "w")], device="cpu")
    # with EMA weights, --ema writes them under <name>_ema
    ema = {k: (v * 0.5 if k.endswith(".weight") and v.dim() == 1 else v)
           for k, v in sd.items()}
    _save({"model": sd, "ema": ema})
    out = tstrip.main(["--experiment_name", NAME, "--reload", "last", "--ema", "--no-sha",
                       "--output_dir", str(root / "w")], device="cpu")
    assert out.name == f"{NAME}_ema.npz"
    with np.load(out) as z:
        gamma = "params/model/bn1/weight"
        np.testing.assert_array_equal(z[gamma], ema["model.bn1.weight"].numpy())


def test_export_serving_matches_the_jax_program(flagship, tiny, monkeypatch):
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving as tserving

    jnet, _, _, x = flagship
    root, tnet = tiny
    _save({"model": tnet.state_dict()})
    _unset(monkeypatch, "BCOS_EXPERIMENT_ROOT")
    blob_path = root / "explain.pt2"
    texport.main(["--experiment_name", NAME, "--base_directory", str(root / "exp"),
                  "--explain", "--input_size", str(SIZE), "--out", str(blob_path)],
                 device="cpu")
    import os

    assert os.environ["BCOS_EXPERIMENT_ROOT"] == str(root / "exp")
    got = tserving.load_serialized(blob_path.read_bytes()).call(torch.from_numpy(x))
    jprog = jserving.load_serialized(jserving.export_explain(
        jnet, jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tnet)), input_size=SIZE))
    want = jprog.call(jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _rel(got[2].numpy(), want[2]) <= 1e-5
    # without --explain: the forward program, equal to the eager forward
    fwd_path = root / "forward.pt2"
    texport.main(["--experiment_name", NAME, "--input_size", str(SIZE), "--out",
                  str(fwd_path)], device="cpu")
    logits = tserving.load_serialized(fwd_path.read_bytes()).call(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), _port_logits(tnet, x), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# precompute_zeroshot_weights
# ---------------------------------------------------------------------------
def _clip_weights(tmp_path):
    from test_torch_clip_import import openai_state_dict

    path = tmp_path / "rn50.npz"
    np.savez(path, **openai_state_dict(seed=4))
    return path


def _jax_clip_load_module(monkeypatch):
    """The JAX script imports ``load`` from ``bcosification_tpu.clip``, whose
    __init__ exports the function ``load`` over the module of that name, so
    as shipped it fails on ``clip_load.load_state_dict_file``; for the test
    the package attribute is the module (which has both functions)."""
    import bcosification_tpu.clip as jclip

    monkeypatch.setattr(jclip, "load", importlib.import_module("bcosification_tpu.clip.load"))


def test_precompute_zeroshot_weights_matches_jax(tmp_path, monkeypatch):
    from bcosification_tpu.data import imagenet as jimagenet
    from bcosification_tpu.training.zeroshot import load_zeroshot_weights as jload
    from bcosification_tpu_torch.data import imagenet as timagenet
    from bcosification_tpu_torch.training.zeroshot import load_zeroshot_weights as tload

    for mod in (jimagenet, timagenet):  # the same cut in both CLIs
        monkeypatch.setattr(mod, "imagenet_classes", list(mod.imagenet_classes[:5]))
        monkeypatch.setattr(mod, "imagenet_templates", list(mod.imagenet_templates[:3]))
    _jax_clip_load_module(monkeypatch)
    _unset(monkeypatch, "CLIP_WEIGHTS_PATH", "CLIP_WEIGHTS_DIR", "BCOS_ALLOW_DOWNLOAD")
    weights = _clip_weights(tmp_path)
    jout, tout = tmp_path / "jax.npy", tmp_path / "port.npy"
    jzs.main(["--out", str(jout), "--clip-weights", str(weights), "--batch-classes", "2"])
    monkeypatch.delenv("CLIP_WEIGHTS_PATH")  # the JAX CLI set it from --clip-weights
    tzs.main(["--out", str(tout), "--clip-weights", str(weights), "--batch-classes", "2"],
             device="cpu")
    want, got = np.load(jout), np.load(tout)
    assert got.shape == want.shape == (32, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jload(str(tout))), got)
    np.testing.assert_array_equal(tload(str(jout)).numpy(), want)


def test_precompute_zeroshot_weights_refuses_without_weights(tmp_path, monkeypatch, capsys):
    _jax_clip_load_module(monkeypatch)
    _unset(monkeypatch, "CLIP_WEIGHTS_PATH", "CLIP_WEIGHTS_DIR", "BCOS_ALLOW_DOWNLOAD")
    monkeypatch.setenv("HOME", str(tmp_path))  # no download cache either
    out = tmp_path / "zs.npy"
    for run in (lambda: jzs.main(["--out", str(out)]),
                lambda: tzs.main(["--out", str(out)], device="cpu")):
        with pytest.raises(SystemExit) as exc, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run()
        assert exc.value.code == 2
        assert "no CLIP RN50 weights found" in capsys.readouterr().err
    # the port fetches nothing, also when asked to: the error names the local files
    monkeypatch.setenv("BCOS_ALLOW_DOWNLOAD", "1")
    with pytest.raises(SystemExit):
        tzs.main(["--out", str(out)], device="cpu")
    err = capsys.readouterr().err
    assert "--clip-weights" in err and "CLIP_WEIGHTS_DIR" in err and "BCOS_ALLOW" not in err
    assert not out.exists()


# ---------------------------------------------------------------------------
# validate_release_weights
# ---------------------------------------------------------------------------
@pytest.fixture
def small_resnet18(tmp_path, monkeypatch):
    """Both registries' resnet18 pointed at a small ResNet-18 (basic blocks
    (1, 1), width 8, NUM_CLASSES) and a seeded release-format resnet18.pth
    of it in tmp_path/weights."""
    from bcosification_tpu_torch.bcosify.release_import import release_state_dict

    kw = dict(block="basic", layers=(1, 1), inplanes=8, num_classes=NUM_CLASSES)
    monkeypatch.setitem(jpretrained._REGISTRY, "resnet18", lambda **extra: jpretrained._init(
        jresnet.BcosResNet(**kw, **extra), (SIZE, SIZE, 6)))
    monkeypatch.setitem(tpretrained._REGISTRY, "resnet18",
                        tpretrained._cnn(tresnet.BcosResNet, **kw))
    net = tpretrained.load_model("resnet18", pretrained=False, device="cpu", seed=3)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(release_state_dict(net, "resnet18"), weights / "resnet18.pth")
    return weights


@pytest.fixture
def val_tree(tmp_path):
    from PIL import Image

    root = tmp_path / "imagenet"
    rng = np.random.default_rng(0)
    for wnid in ("n01440764", "n01443537"):
        d = root / "val" / wnid
        d.mkdir(parents=True)
        for i in range(3):
            arr = (rng.random((48, 56, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{wnid}_{i}.JPEG", quality=85)
    return root


def test_evaluate_imagenet_matches_jax(small_resnet18, val_tree, monkeypatch):
    _unset(monkeypatch, "IMAGENET_PATH")
    kw = dict(batch_size=2, limit=0, crop_size=64)
    want = jvalidate.evaluate_imagenet("resnet18", small_resnet18, val_tree, **kw)
    got = tvalidate.evaluate_imagenet("resnet18", small_resnet18, val_tree, device="cpu", **kw)
    assert got == want and got["n"] == 6


def _shards(root, n_shards=2, per_shard=3, classes=("goldfish", "toaster", "jeep")):
    """A wds/imagenet1k layout: test/0000{i}.tar of jpg + cls pairs, the
    class names and two templates."""
    from PIL import Image

    root.mkdir()
    (root / "classnames.txt").write_text("\n".join(classes))
    (root / "zeroshot_classification_templates.txt").write_text(
        "a photo of a {c}.\na picture of a {c}.\n")
    (root / "test").mkdir()
    rng = np.random.default_rng(5)
    for s in range(n_shards):
        with tarfile.open(root / "test" / f"{s:05d}.tar", "w") as tf:
            for i in range(per_shard):
                buf = io.BytesIO()
                Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
                    buf, format="JPEG")
                for ext, data in (("jpg", buf.getvalue()), ("cls", str(i % 3).encode())):
                    info = tarfile.TarInfo(f"{s}{i:05d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return root


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_evaluate_clip_zeroshot_matches_jax(tmp_path, monkeypatch, unpool):
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual
    from test_torch_clip_import import VISION, trained_student_checkpoint

    monkeypatch.setenv("CLIP_WEIGHTS_PATH", str(_clip_weights(tmp_path)))
    net = build_bcosified_clip_visual({"bcosify_args": {"use_bias": False},
                                       "attn_unpool": unpool}, None, VISION, device="cpu")
    ckpt = tmp_path / "student.pth"
    torch.save({k: torch.as_tensor(v) for k, v in trained_student_checkpoint(net).items()},
               ckpt)
    root = _shards(tmp_path / "wds")
    kw = dict(batch_size=6, with_reference=False)  # one batch: the JAX leg runs eagerly
    want = jvalidate.evaluate_clip_zeroshot(ckpt, root, **kw)
    got = tvalidate.evaluate_clip_zeroshot(ckpt, root, device="cpu", **kw)
    assert got == want
    assert got["n"] == 6 and got["attn_unpool"] == unpool and got["text_tower"] == "pretrained"


@pytest.mark.parametrize("case", ["empty", "clip_names_without_wds", "no_reference"])
def test_validate_main_exit_codes_match_jax(case, small_resnet18, tmp_path, monkeypatch,
                                            capsys):
    _unset(monkeypatch, "BCOS_REFERENCE_ROOT", "WDS_IMAGENET1K_PATH", "IMAGENET_PATH")
    if case == "empty":
        argv, want = ["--weights_dir", str(tmp_path / "none")], 0
    elif case == "clip_names_without_wds":
        argv, want = ["--weights_dir", str(small_resnet18), "--clip_names", "my_clip",
                      "--wds_root", str(tmp_path / "nope")], 1
    else:
        argv, want = ["--weights_dir", str(small_resnet18)], 1
    assert jvalidate.main(argv) == want
    capsys.readouterr()
    assert tvalidate.main(argv, device="cpu") == want
    out = capsys.readouterr()
    if case == "no_reference":
        line = json.loads(out.out.strip().splitlines()[-1])
        assert line["name"] == "resnet18" and line["passed"] is False
        assert line["error"].startswith("ModuleNotFoundError")
        assert "FAILED: ['resnet18']" in out.err
        # a root without the reference's bcos package fails the same way
        monkeypatch.setenv("BCOS_REFERENCE_ROOT", str(tmp_path))
        assert tvalidate.main(argv, device="cpu") == 1


# ---------------------------------------------------------------------------
# explain_minimal
# ---------------------------------------------------------------------------
def test_explain_minimal_matches_the_jax_example(tmp_path, monkeypatch, capsys):
    from PIL import Image

    from __graft_entry__ import _flagship
    from bcosification_tpu.explain import core as jcore
    from bcosification_tpu_torch.examples import explain_minimal as tex

    # the small flagship with the example's 1000 classes, its gammas shrunk so
    # that the fp32 logits start exactly at the bias: both calibration stages run
    jnet, jvars = _flagship(input_size=SIZE, inplanes=8, num_classes=1000, layers=LAYERS)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 0.1 if p[-1].key == "weight" and v.ndim == 1 else v,
        jvars["params"])
    jvars = {**jvars, "params": params}
    tnet = tengine.build_bcosified_resnet({**FLAGSHIP_CONFIG, "name": "resnet50"},
                                          num_classes=1000, inplanes=8, layers=LAYERS,
                                          device="cpu")
    load_jax_variables(tnet, jax.tree_util.tree_map(np.array, jvars))

    spec = importlib.util.spec_from_file_location("jax_explain_minimal",
                                                  ROOT / "examples" / "explain_minimal.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    seen = {}

    def make_explain_fn(net):
        fn = jcore.make_explain_fn(net)

        def run(variables, x):
            seen["variables"], seen["out"] = variables, fn(variables, x)
            return seen["out"]

        return run

    monkeypatch.setattr(jmod, "build_bcosified_resnet", lambda *a, **k: (jnet, jvars))
    monkeypatch.setattr(jmod, "explain", types.SimpleNamespace(make_explain_fn=make_explain_fn))
    jmod.main(str(tmp_path / "jax.png"))
    jprint = capsys.readouterr().out

    with torch.no_grad():  # the logits start at the bias: the doubling stage runs
        assert float((tnet(tex.synthetic_image()) - tex.LOGIT_BIAS).abs().max()) == 0.0
    monkeypatch.setattr(tex, "build", lambda device=None, seed=0: tnet)
    got = tex.main(str(tmp_path / "port.png"), device="cpu")
    tprint = capsys.readouterr().out
    assert 0.5 < got["magnitude"] < 50
    for line in ("calibrated |logit - bias| magnitude", "prediction: class"):
        assert [s for s in tprint.splitlines() if s.startswith(line)] == [
            s for s in jprint.splitlines() if s.startswith(line)]
    # the calibrated gammas, the prediction and the explanation
    want = jax.tree_util.tree_map(np.asarray, seen["variables"])
    got_vars = to_jax_variables(tnet)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        node = got_vars["params"]
        for p in path:
            node = node[p.key]
        assert _rel(node, leaf) <= 1e-5, path
    assert got["prediction"] == int(seen["out"]["prediction"][0])
    assert _rel(got["explanation"], seen["out"]["explanation"][0]) <= 1e-5
    jpng = np.asarray(Image.open(tmp_path / "jax.png"), np.int16)
    tpng = np.asarray(Image.open(tmp_path / "port.png"), np.int16)
    assert tpng.shape == jpng.shape == (224, 224, 4)
    assert np.abs(tpng - jpng).max() <= 1
