"""Config machinery, the ``Experiment`` handle and the metrics history."""
from bcosification_tpu_torch.experiments.utils.config_utils import (
    configs_cli,
    create_configs_with_different_seeds,
    get_configs_and_model_factory,
    sanitize_config,
    update_config,
)
from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
from bcosification_tpu_torch.experiments.utils.metric_utils import Metrics
