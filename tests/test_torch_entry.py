"""The port's train and evaluate commands, in-process on the CPU, over a
synthetic ImageNet-layout JPEG folder. The config lookup is patched to a
tiny config (crop 32, batch 8) on the small flagship, ("bottleneck",
(1, 1)) with inplanes 8 and calibrated BN gammas. ``--fast_dev_run``
writes metrics and a checkpoint and resumes from it; ``evaluate --reload
last`` reproduces the fit's logged accuracy and the JAX package's
``evaluate.evaluate`` counts on the same weights and folder; ``--weights``
reads an npz of JAX variables; the logger, profiler and explanation flags
write their files; unported flags raise."""
import argparse

import numpy as np
import pytest
import torch

import jax

from bcosification_tpu import settings as jsettings
from bcosification_tpu.data import datamodules as jdm
from bcosification_tpu.data import presets as jpresets
from bcosification_tpu_torch import evaluate as tevaluate
from bcosification_tpu_torch import settings as tsettings
from bcosification_tpu_torch import train as ttrain
from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
from bcosification_tpu_torch.data import presets as tpresets
from bcosification_tpu_torch.data.synthetic import write_imagenet_tree
from bcosification_tpu_torch.experiments.ImageNet.bcosification import experiment_parameters
from bcosification_tpu_torch.experiments.utils import experiment_utils
from bcosification_tpu_torch.experiments.utils.config_utils import update_config
from bcosification_tpu_torch.training.trainer import UNPORTED_FLAGS, param_hash, run_training

torch.set_num_threads(1)
NAME, LAYERS, NUM_CLASSES = "tiny", ("bottleneck", (1, 1)), 10


def _data_config(presets):
    return dict(train_transform=presets.ImageNetClassificationPresetTrain(crop_size=32,
                                                                           is_bcos=True),
                test_transform=presets.ImageNetClassificationPresetEval(
                    crop_size=32, resize_size=36, is_bcos=True),
                batch_size=8, num_workers=2)


CONFIG = update_config(experiment_parameters.CONFIGS["resnet_50"],
                       {"data": _data_config(tpresets), "trainer": {"max_epochs": 2}})


def tiny_model(model_config, device=None):
    from chip_smoke import calibrate

    net = build_bcosified_resnet(model_config, num_classes=NUM_CLASSES, inplanes=8,
                                 layers=LAYERS, device=device, seed=0)
    probe = np.random.default_rng(0).random((1, 32, 32, 6)).astype(np.float32)
    calibrate(net, torch.from_numpy(probe).to(next(net.parameters()).device))
    return net


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    write_imagenet_tree(root, 3, 16, 10, sizes=((56, 48), (48, 60)), seed=1)
    return str(root)


@pytest.fixture
def tiny(tree, tmp_path, monkeypatch):
    """The patched lookup; returns the experiment root."""
    lookup = lambda dataset, base_network: ({NAME: CONFIG}, tiny_model)  # noqa: E731
    monkeypatch.setattr(experiment_utils, "get_configs_and_model_factory", lookup)
    monkeypatch.setattr(ttrain, "get_configs_and_model_factory", lookup)
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", tree)
    monkeypatch.setattr(jsettings, "IMAGENET_PATH", tree)
    monkeypatch.setattr(tsettings, "EXPERIMENT_ROOT", str(tmp_path))
    return tmp_path


def _train_args(root, *extra):
    return ttrain.get_parser().parse_args(
        ["--dataset", "ImageNet", "--base_network", "bcosification", "--experiment_name", NAME,
         "--fast_dev_run", "--base_directory", str(root), *extra])


def _eval_args(root, *extra):
    return tevaluate.get_parser().parse_args(
        ["--experiment_name", NAME, "--base_directory", str(root), *extra])


def _save_dir(root):
    return root / "ImageNet" / "bcosification" / NAME


def test_fast_dev_run_writes_metrics_and_a_checkpoint_and_resumes(tiny):
    state = run_training(_train_args(tiny), device="cpu")
    save_dir = _save_dir(tiny)
    assert state.step == 1
    assert (save_dir / "checkpoints" / "epoch_0" / "state.pt").exists()
    assert (save_dir / "hparams.json").exists()
    header, row = (save_dir / "metrics.csv").read_text().splitlines()
    assert header.split(",")[0] == "epoch" and "val_acc1" in header and row.startswith("0,")
    # a second run resumes after epoch 0; --force-no-resume starts again
    assert run_training(_train_args(tiny), device="cpu").step == 2
    assert experiment_utils.Experiment("ImageNet", "bcosification", NAME
                                       ).available_checkpoints() == [0, 1]
    assert run_training(_train_args(tiny, "--force-no-resume"), device="cpu").step == 1


def test_evaluate_reproduces_the_fit_and_jax(tiny):
    import evaluate as jevaluate
    from __graft_entry__ import _flagship
    from bcosification_tpu.parallel import mesh as mesh_lib

    run_training(_train_args(tiny), device="cpu")
    top1, top5, (c1, c5, n) = tevaluate.run_evaluation(_eval_args(tiny, "--no-cuda"))
    assert n == 10
    history = experiment_utils.Experiment("ImageNet", "bcosification", NAME).load_metrics()
    assert (top1, top5) == pytest.approx((history["val_acc1"][-1][1],
                                          history["val_acc5"][-1][1]), abs=1e-6)

    model = experiment_utils.Experiment("ImageNet", "bcosification", NAME).load_trained_model(
        "last", device="cpu", verbose=False)
    net, _ = _flagship(input_size=32, arch="resnet50", inplanes=8, num_classes=NUM_CLASSES,
                       layers=LAYERS)
    variables = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_variables(model))
    data = jdm.ImageNetDataModule(_data_config(jpresets))
    data.setup("test")
    want1, want5 = jevaluate.evaluate(net, variables, data.test_dataloader(),
                                      mesh_lib.make_mesh())
    assert (c1, c5) == (round(want1 * n), round(want5 * n))
    assert 0 < c5  # the calibrated net ranks some labels in its top 5


def test_evaluate_weights_npz_and_fresh(tiny, tmp_path_factory):
    run_training(_train_args(tiny), device="cpu")
    model = experiment_utils.Experiment("ImageNet", "bcosification", NAME).load_trained_model(
        "last", device="cpu", verbose=False)
    variables = to_jax_variables(model)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        flat["/".join(k.key for k in path)] = leaf
    npz = tmp_path_factory.mktemp("weights") / "weights.npz"
    np.savez(npz, **flat)
    last = tevaluate.run_evaluation(_eval_args(tiny, "--no-cuda"))
    assert tevaluate.run_evaluation(_eval_args(tiny, "--weights", str(npz)),
                                    device="cpu") == last
    fresh = tevaluate.run_evaluation(_eval_args(tiny, "--reload", "fresh", "--batch_size", "4"),
                                     device="cpu")
    assert fresh[2][2] == 10
    with pytest.raises(FileNotFoundError):
        tevaluate.run_evaluation(_eval_args(tiny, "--reload", "epoch_7"), device="cpu")


@pytest.mark.parametrize("flag,dest,off,where", UNPORTED_FLAGS, ids=[f[0] for f in UNPORTED_FLAGS])
def test_unported_flags_raise(tiny, flag, dest, off, where):
    value = {bool: [], int: ["2"], type(None): ["prof"]}[type(off)]
    args = _train_args(tiny, flag, *value)
    assert getattr(args, dest) != off
    with pytest.raises(NotImplementedError, match=flag):
        run_training(args, device="cpu")
    assert not _save_dir(tiny).exists()  # refused before anything is written


PORTED_FLAGS = {  # flags that raised until the training options were ported
    "--tensorboard_logger": ("tb",),
    "--wandb_logger": (),
    "--explanation_logging": ("explanations/epoch_0.npz", "explanations/epoch_0.png"),
    "--profile_dir": ("prof/trace.json",),
}


@pytest.mark.parametrize("flag", sorted(PORTED_FLAGS))
def test_ported_flags_run(tiny, flag, capsys):
    """A --fast_dev_run with the flag (and --debug) trains its one step and
    writes what the flag asks for under the experiment (the profiler trace
    under --profile_dir); --debug prints the parameter hash."""
    value = [str(_save_dir(tiny) / "prof")] if flag == "--profile_dir" else []
    state = run_training(_train_args(tiny, flag, *value, "--debug"), device="cpu")
    assert state.step == 1
    for rel in PORTED_FLAGS[flag]:
        assert (_save_dir(tiny) / rel).exists(), rel
    assert f"params hash: {param_hash(state.model)}" in capsys.readouterr().out


def test_train_main_validates_the_experiment_name(tiny):
    with pytest.raises(ValueError, match="Unknown experiment"):
        ttrain.main(["--dataset", "ImageNet", "--base_network", "bcosification",
                     "--experiment_name", "resnet_7"])
    assert isinstance(ttrain.get_parser().parse_args(
        ["--dataset", "d", "--base_network", "b", "--experiment_name", "e"]), argparse.Namespace)
