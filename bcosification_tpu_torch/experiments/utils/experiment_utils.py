"""The ``Experiment`` handle: the entry to an experiment's config, model,
data and trained checkpoints (the port's counterpart of
``bcosification_tpu/experiments/utils/experiment_utils.py``).

``Experiment(dataset, base_network, experiment_name)`` (or ``path=``
ending in those three parts) resolves the config and the model factory of
``bcosification_tpu_torch.experiments.<dataset>.<base_network>``. Its
models are ``torch.nn.Module``s on the GPU unless ``device="cpu"`` is
asked for; checkpoints are those ``Trainer.fit`` writes under ``save_dir``
(``training/checkpointing.py``).
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Any, Dict, Optional

from bcosification_tpu_torch import settings
from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.experiments.utils.config_utils import (
    get_configs_and_model_factory,
)

__all__ = ["Experiment"]


class Experiment:
    def __init__(
        self,
        dataset: str = None,
        base_network: str = None,
        experiment_name: str = None,
        path: Optional[str] = None,
    ):
        if path is not None:
            # .../<dataset>/<base_network>/<experiment_name>
            dataset, base_network, experiment_name = Path(path).parts[-3:]
        assert dataset and base_network and experiment_name
        self.dataset = dataset
        self.base_network = base_network
        self.experiment_name = experiment_name

        configs, get_model = get_configs_and_model_factory(dataset, base_network)
        if experiment_name not in configs:
            raise ValueError(
                f"No config '{experiment_name}' in {dataset}/{base_network}. "
                f"Available: {sorted(configs)[:20]}"
            )
        self.config: Dict[str, Any] = configs[experiment_name]
        self._get_model = get_model

    @property
    def save_dir(self) -> Path:
        """``settings.EXPERIMENT_ROOT``/dataset/base_network/experiment_name
        (read when asked, so a ``--base_directory`` set later applies)."""
        return (Path(settings.EXPERIMENT_ROOT) / self.dataset / self.base_network
                / self.experiment_name)

    @property
    def model_config(self) -> Dict[str, Any]:
        return self.config["model"]

    def get_model(self, device=None):
        """The model at conversion-time init (pretrained weights when the
        factory finds them), eval mode, on ``device`` (default the GPU)."""
        return self._get_model(self.model_config, device=device)

    def get_datamodule(self, cache_dataset: Optional[str] = None, **data_overrides):
        """The registered data module of this experiment's dataset, with
        ``data_overrides`` applied to the data config."""
        from bcosification_tpu_torch.data.datamodules import ClassificationDataModule

        cls = ClassificationDataModule.registry()[self.dataset]
        cfg = dict(self.config["data"])
        if cache_dataset:
            cfg["cache_dataset"] = cache_dataset
        cfg.update(data_overrides)
        return cls(cfg)

    def _ckpt_manager(self):
        from bcosification_tpu_torch.training.checkpointing import CheckpointManager, monitor_for

        monitor, mode = monitor_for(self.config)
        return CheckpointManager(str(self.save_dir), monitor=monitor, mode=mode)

    def _is_clip_kd(self) -> bool:
        """A CLIP knowledge-distillation config: its checkpoints are ranked by
        the validation loss, the others by the top-1 accuracy."""
        from bcosification_tpu_torch.training.checkpointing import is_clip_kd

        return is_clip_kd(self.config)

    def available_checkpoints(self):
        return self._ckpt_manager().available_checkpoints()

    def load_trained_model(self, reload: str = "last", ema: bool = False,
                           verbose: bool = True, strict_ema: bool = False, device=None):
        """The model with the trained weights of checkpoint ``reload`` (last,
        best, best_any or epoch_N). ``ema`` takes the EMA weights; when the
        checkpoint has none the plain weights are returned, unless
        ``strict_ema``, which raises instead."""
        dev = resolve_device(device)
        model = self.get_model(device=dev)
        state, epoch = self._ckpt_manager().restore(reload, map_location=dev)
        if state is None:
            raise FileNotFoundError(f"No checkpoint for {self.save_dir} (reload={reload})")
        if verbose:
            print(f"Loaded epoch {epoch} from {self.save_dir} (ema={ema})")
        if ema and strict_ema and state.get("ema") is None:
            raise ValueError(
                f"EMA weights requested but the checkpoint at {self.save_dir} "
                "carries no EMA state (trained without ema_decay)"
            )
        weights = state["ema"] if (ema and state.get("ema") is not None) else state["model"]
        model.load_state_dict(weights)
        return model

    def load_metrics(self) -> Dict[str, Any]:
        path = self.save_dir / "metrics" / "metrics.json.gz"
        if not path.exists():
            return {}
        with gzip.open(path, "rt") as f:
            return json.load(f)
