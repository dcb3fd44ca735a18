"""The PyTorch port stands alone: it imports neither JAX (nor flax or optax)
nor the JAX package (nor its top-level ``clip_benchmark``), and its entry
points refuse to fall back to the CPU when no GPU is present."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bcosification_tpu_torch
names = [mod.name for mod in
         pkgutil.walk_packages(bcosification_tpu_torch.__path__, "bcosification_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("losses", "optim.optimizer_factory", "optim.lr_scheduler_factory",
             "training.agc", "training.ema", "training.steps", "training.checkpointing",
             "training.loggers", "training.trainer", "settings", "data.categories",
             "data.transforms", "data.presets", "data.sampler", "data.loader",
             "data.caching", "data.datamodules", "data.synthetic",
             "experiments.utils.config_utils", "experiments.utils.metric_utils",
             "experiments.utils.experiment_utils",
             "experiments.ImageNet.bcosification.experiment_parameters",
             "experiments.ImageNet.bcosification.model", "train", "evaluate",
             "models.densenet", "explain.fast_densenet", "modules.bcosattnpool",
             "clip", "clip.model", "clip.tokenizer", "clip.load", "bcosify.clip_import",
             "explain.fast_clip", "explain.fast_clip_vit", "data.imagenet", "training.zeroshot",
             "experiments.ImageNet.clip_bcosification.experiment_parameters",
             "experiments.ImageNet.clip_bcosification.model", "training.kd", "data.cc3m",
             "experiments.CC3M.clip_bcosification.experiment_parameters",
             "experiments.CC3M.clip_bcosification.model", "models.vit", "explain.fast_vit",
             "experiments.ImageNet.vit_bcosification.experiment_parameters",
             "experiments.ImageNet.vit_bcosification.model",
             "experiments.ImageNet.vit_final.experiment_parameters",
             "experiments.ImageNet.vit_final.model", "ops.guided", "interpretability",
             "interpretability.explanation_methods",
             "interpretability.explanation_methods.explainers", "interpretability.analyses",
             "interpretability.analyses.utils", "interpretability.analyses.localisation_configs",
             "interpretability.analyses.localisation",
             "interpretability.analyses.localisation_sweep",
             "interpretability.analyses.text_localisation", "models.captioner",
             "clip_benchmark", "clip_benchmark.cli", "clip_benchmark.datasets.builder",
             "clip_benchmark.models", "clip_benchmark.models.text2concept",
             "clip_benchmark.models.torch_adapter", "clip_benchmark.models.open_clip",
             "clip_benchmark.models.japanese_clip", "clip_benchmark.models.nllb_clip",
             "clip_benchmark.metrics.zeroshot_classification",
             "clip_benchmark.metrics.linear_probe", "clip_benchmark.metrics.zeroshot_retrieval",
             "clip_benchmark.metrics.image_caption_selection",
             "clip_benchmark.metrics.captioning", "clip_benchmark.metrics.meteor",
             "clip_benchmark.probe_benchmark.common",
             "clip_benchmark.probe_benchmark.scaling_experiments",
             "clip_benchmark.probe_benchmark.laion5b_fewshot_experiments",
             "clip_benchmark.probe_benchmark.build_df_scaling_experiments",
             "clip_benchmark.probe_benchmark.generate_table",
             "clip_benchmark.probe_benchmark.process_vtab", "clip_benchmark.webdataset_builder",
             "clip_benchmark.model_collection", "models.pretrained", "modules.containers",
             "modules.stochastic_depth", "utils", "utils.init_mode",
             "bcosify.release_import", "models.vgg", "models.convnext", "explain.fast_vgg",
             "explain.fast_convnext", "explain._shared"):
    assert "bcosification_tpu_torch." + name in names, name
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "bcosification_tpu",
                                    "clip_benchmark"))
print("FOREIGN", bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FOREIGN []" in out.stdout


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal path is not reachable")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

    cfg = {"name": "resnet50", "bcosify_args": {"use_bias": False}, "bcos_args": {"b": 2}}
    small = dict(num_classes=10, inplanes=8, layers=("bottleneck", (1, 1)))
    with pytest.raises(RuntimeError, match="GPU"):
        build_bcosified_resnet(cfg, **small)
    net = build_bcosified_resnet(cfg, device="cpu", **small)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 6)).astype(np.float32))
    with pytest.raises(RuntimeError, match="GPU"):
        fast_dynamic_linear_weights(net, x)
    with pytest.raises(RuntimeError, match="GPU"):
        dynamic_linear_weights(lambda t: net(t, explain=True), x)
    # asked for explicitly, the CPU runs the plain versions
    _, _, w = fast_dynamic_linear_weights(net, x, device="cpu")
    assert w.shape == x.shape


def test_clip_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.bcosify import clip_import
    from bcosification_tpu_torch.clip.load import load
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.explain import fast_clip

    cfg = {"vision_layers": (1, 1, 1, 1), "vision_width": 16, "embed_dim": 32,
           "image_resolution": 32, "context_length": 77, "vocab_size": 49408,
           "transformer_width": 64, "transformer_heads": 4, "transformer_layers": 1}
    config = {"bcosify_args": {"use_bias": False}, "attn_unpool": True}
    for build in (lambda: clip_import.build_bcosified_clip_visual(config, None, cfg),
                  lambda: clip_import.build_clip_teacher_visual(None, cfg),
                  lambda: clip_import.build_clip_text(None, cfg),
                  lambda: load("RN50", pretrained=False)):
        with pytest.raises(RuntimeError, match="GPU"):
            build()
    name = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
    with pytest.raises(RuntimeError, match="GPU"):
        Experiment("ImageNet", "clip_bcosification", name).get_model()
    net = clip_import.build_bcosified_clip_visual(config, None, cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 6)).astype(np.float32))
    t = torch.ones(32)
    with pytest.raises(RuntimeError, match="GPU"):
        fast_clip.fast_text_dlw(net, x, t)
    with pytest.raises(RuntimeError, match="GPU"):
        serving.export_text_explain(net, embed_dim=32, input_size=32)
    scores, w = fast_clip.fast_text_dlw(net, x, t, device="cpu")
    assert scores.shape == (1,) and w.shape == x.shape


def test_train_and_evaluate_raise_without_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch import evaluate, settings, train
    from bcosification_tpu_torch.training.trainer import run_training

    monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path))
    args = train.get_parser().parse_args(
        ["--dataset", "ImageNet", "--base_network", "bcosification",
         "--experiment_name", "resnet_18", "--fast_dev_run"])
    with pytest.raises(RuntimeError, match="GPU"):
        run_training(args)
    eval_args = evaluate.get_parser().parse_args(["--experiment_name", "resnet_18",
                                                  "--reload", "fresh"])
    with pytest.raises(RuntimeError, match="GPU"):
        evaluate.run_evaluation(eval_args)
    assert not any(tmp_path.iterdir())  # refused before anything was built or written
    # asked for the CPU, evaluate builds the model there (no data: IMAGENET_PATH unset)
    monkeypatch.setattr(settings, "IMAGENET_PATH", None)
    with pytest.raises(AssertionError, match="IMAGENET_PATH"):
        evaluate.run_evaluation(eval_args, device="cpu")
    with pytest.raises(AssertionError, match="IMAGENET_PATH"):
        evaluate.run_evaluation(evaluate.get_parser().parse_args(
            ["--experiment_name", "resnet_18", "--reload", "fresh", "--no-cuda"]))


def test_clip_benchmark_cli_raises_without_gpu(tmp_path):
    """The port's clip_benchmark CLI runs on the card: without a GPU and
    without a device, ``main`` (eval), ``run`` and ``load_clip`` raise before
    anything is loaded or written; ``build`` (CSV only) needs no device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch.clip_benchmark import cli
    from bcosification_tpu_torch.clip_benchmark.models import load_clip

    out = tmp_path / "r.json"
    args = ["eval", "--dataset", "dummy", "--model_type", "standard_clip", "--pretrained",
            "none", "--output", str(out)]
    with pytest.raises(RuntimeError, match="GPU"):
        cli.main(args)
    _, parsed = cli.get_parser_args(args)
    with pytest.raises(RuntimeError, match="GPU"):
        cli.run(parsed)
    with pytest.raises(RuntimeError, match="GPU"):
        load_clip("standard_clip", "RN50", "none")
    assert not out.exists()
    (tmp_path / "a.json").write_text('{"dataset": "d", "model": "m", "pretrained": "p", '
                                     '"task": "t", "language": "en", "metrics": {"acc1": 1.0}}')
    cli.main(["build", str(tmp_path / "a.json"), "--output", str(tmp_path / "b.csv")])
    assert (tmp_path / "b.csv").exists()



def test_zoo_entry_points_raise_without_gpu():
    """The model zoo's load_model and release import build on the card
    unless asked for the CPU; a shape-only build (abstract_init) needs no
    device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch.bcosify.release_import import (
        convert_release_checkpoint,
        release_state_dict,
    )
    from bcosification_tpu_torch.explain import fast_resnet
    from bcosification_tpu_torch.models.pretrained import load_model
    from bcosification_tpu_torch.utils.init_mode import abstract_init

    for name in ("resnet18", "densenet121", "vitc_ti_patch1_14",
                 "standard_simple_vit_ti_patch16_224"):
        with pytest.raises(RuntimeError, match="GPU"):
            load_model(name, pretrained=False)
    with abstract_init():
        meta = load_model("resnet18", pretrained=False)
    assert next(meta.parameters()).device.type == "meta"
    net = load_model("resnet18", pretrained=False, device="cpu", inplanes=8, num_classes=10)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 6)).astype(np.float32))
    with pytest.raises(RuntimeError, match="GPU"):
        fast_resnet.fast_dynamic_linear_weights(net, x)
    sd = release_state_dict(net, "resnet18")
    with pytest.raises(RuntimeError, match="GPU"):
        convert_release_checkpoint("resnet18", sd, return_model=True, inplanes=8,
                                   num_classes=10)
    model, _ = convert_release_checkpoint("resnet18", sd, return_model=True, device="cpu",
                                          inplanes=8, num_classes=10)
    with torch.no_grad():
        assert torch.equal(model(x), net(x))


def test_vgg_and_convnext_entry_points_raise_without_gpu():
    """The zoo's VGGs and ConvNeXts build on the card unless asked for the
    CPU, and so do their hand-scheduled passes."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from bcosification_tpu_torch.explain import fast_convnext, fast_vgg
    from bcosification_tpu_torch.models import convnext, pretrained

    for name in ("vgg11_bnu", "convnext_atto", "convnext_tiny_bnu"):
        with pytest.raises(RuntimeError, match="GPU"):
            pretrained.load_model(name, pretrained=False)
    net = pretrained._cnn(convnext.BcosConvNeXt, num_classes=10,
                          block_setting=[convnext.CNBlockConfig(8, None, 1)])(device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 16, 16, 6)).astype(np.float32))
    assert fast_convnext.supports(net) and not fast_vgg.supports(net)
    with pytest.raises(RuntimeError, match="GPU"):
        fast_convnext.fast_dynamic_linear_weights(net, x)
    assert fast_convnext.fast_dynamic_linear_weights(net, x, device="cpu")[2].shape == x.shape
