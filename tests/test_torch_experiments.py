"""The port's experiment machinery against the JAX package's on the CPU:
the ImageNet/bcosification recipe grid (names and, through
``sanitize_config``, every hyperparameter), ``update_config``, the seed
fan-out, ``Metrics``, the ``Experiment`` handle's checkpoints, and the
model factory's refusals."""
import re

import numpy as np
import pytest
import torch

from bcosification_tpu.experiments.ImageNet.bcosification import (
    experiment_parameters as jparams,
)
from bcosification_tpu.experiments.utils import config_utils as jcu
from bcosification_tpu.experiments.utils import metric_utils as jmu
from bcosification_tpu_torch import settings as tsettings
from bcosification_tpu_torch.experiments.ImageNet.bcosification import (
    experiment_parameters as tparams,
)
from bcosification_tpu_torch.experiments.ImageNet.bcosification import model as tmodel
from bcosification_tpu_torch.experiments.utils import config_utils as tcu
from bcosification_tpu_torch.experiments.utils import metric_utils as tmu
from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

torch.set_num_threads(1)
NAMES = sorted(jparams.CONFIGS)
_OBJECT_AT = re.compile(r"<([\w.]+\.)?(\w+) object at 0x[0-9a-f]+>")


def _without_class_paths(value):
    """A sanitized config with module paths and object addresses taken out
    of its strings (repr() of a transform without a dataclass repr)."""
    if isinstance(value, dict):
        return {k: _without_class_paths(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_without_class_paths(v) for v in value]
    if isinstance(value, str):
        return _OBJECT_AT.sub(r"<\2>", value)
    return value


def test_the_grid_has_the_same_names():
    assert sorted(tparams.CONFIGS) == NAMES
    assert len(NAMES) == 20
    bases = {n.split("-seed=")[0] for n in NAMES}
    assert bases == {"resnet_18", "resnet_18_V1", "resnet_50", "resnet_50_V1", "densenet_121"}


@pytest.mark.parametrize("name", NAMES)
def test_sanitized_configs_are_equal(name):
    j = _without_class_paths(jcu.sanitize_config(jparams.CONFIGS[name]))
    t = _without_class_paths(tcu.sanitize_config(tparams.CONFIGS[name]))
    assert t == j
    assert "object at" not in repr(t)


@pytest.mark.parametrize("base,new", [
    ({"a": 1, "b": {"c": 2, "d": [1]}}, {"b": {"c": 3}, "e": 4}),
    ({"a": {"b": {"c": 1}}}, {"a": {"b": 5}}),
    ({"a": 1}, {}),
])
def test_update_config_agrees(base, new):
    t = tcu.update_config(base, new)
    assert t == jcu.update_config(base, new)
    assert base != t or not new  # the input is not changed in place


def test_seed_fan_out_agrees():
    configs = {"x": {"seed": 0, "lr": 1.0}, "y": {"lr": 2.0}}
    for seeds in ([5, 420, 1337], 7):
        assert (tcu.create_configs_with_different_seeds(configs, seeds)
                == jcu.create_configs_with_different_seeds(configs, seeds))


def test_metrics_agree():
    history = {"val_acc1": [[0, 0.1], [1, 0.4], [2, 0.3]], "val_loss": [[0, 2.0], [1, 1.5]],
               "empty": []}
    j, t = jmu.Metrics(history), tmu.Metrics(history)
    for name in ("val_acc1", "val_loss", "empty", "missing"):
        for mode in ("max", "min"):
            assert t.best_epoch(name, mode) == j.best_epoch(name, mode)
            assert t.best_value(name, mode) == j.best_value(name, mode)
        assert t.last(name) == j.last(name)
        assert t.series(name) == j.series(name)
    rng = np.random.default_rng(0)
    logits, labels = rng.standard_normal((6, 5)), (rng.random((6, 5)) > 0.5).astype(float)
    jm, tm = jmu.MultiLabelMetrics(5, 0.1), tmu.MultiLabelMetrics(5, 0.1)
    jm.update(logits, labels)
    tm.update(logits, labels)
    assert tm.compute() == jm.compute()


def test_unsupported_standard_changes_raise():
    config = tcu.update_config(tparams.CONFIGS["resnet_18"]["model"],
                               {"standard_changes": {"maxpool": "maxpool_3_2_1"}})
    with pytest.raises(NotImplementedError, match="standard_changes"):
        tmodel.get_model(config, device="cpu")


def test_random_init_warns_without_weights(monkeypatch):
    monkeypatch.delenv("TORCHVISION_WEIGHTS_DIR", raising=False)
    with pytest.warns(UserWarning, match="TORCHVISION_WEIGHTS_DIR"):
        assert tmodel.load_torchvision_state_dict("resnet18", "ResNet18_Weights.DEFAULT") is None
    assert tmodel.load_torchvision_state_dict("resnet18", None) is None


def test_experiment_resolves_paths_and_checkpoints(tmp_path, monkeypatch):
    from bcosification_tpu_torch.training.checkpointing import CheckpointManager

    monkeypatch.setattr(tsettings, "EXPERIMENT_ROOT", str(tmp_path))
    exp = Experiment(path="runs/ImageNet/bcosification/resnet_18")
    assert exp.save_dir == tmp_path / "ImageNet" / "bcosification" / "resnet_18"
    assert exp.config is tparams.CONFIGS["resnet_18"]
    assert exp.available_checkpoints() == []
    with pytest.raises(ValueError, match="No config"):
        Experiment("ImageNet", "bcosification", "resnet_7")
    # a checkpoint with an EMA copy: plain and EMA weights, best by val_acc1
    net = exp.get_model(device="cpu")
    ema = {k: v + 1 if v.is_floating_point() else v for k, v in net.state_dict().items()}
    mgr = CheckpointManager(str(exp.save_dir))
    mgr.save({"model": net.state_dict(), "ema": ema, "optimizer": {}, "step": 3}, 0,
             {"val_acc1": 0.5})
    mgr.save({"model": net.state_dict(), "ema": None, "optimizer": {}, "step": 6}, 1,
             {"val_acc1": 0.2})
    assert exp.available_checkpoints() == [0, 1]
    w = "model.conv1.weight"
    best_ema = exp.load_trained_model("best", ema=True, device="cpu", verbose=False)
    assert torch.equal(best_ema.state_dict()[w], ema[w])
    last = exp.load_trained_model("last", ema=True, device="cpu", verbose=False)
    assert torch.equal(last.state_dict()[w], net.state_dict()[w])  # no EMA: plain weights
    with pytest.raises(ValueError, match="EMA"):
        exp.load_trained_model("last", ema=True, strict_ema=True, device="cpu")
    metrics_dir = exp.save_dir / "metrics"
    metrics_dir.mkdir()
    import gzip
    import json

    with gzip.open(metrics_dir / "metrics.json.gz", "wt") as f:
        json.dump({"val_acc1": [[0, 0.5], [1, 0.2]]}, f)
    assert tmu.Metrics.load(exp).best_epoch() == 0
