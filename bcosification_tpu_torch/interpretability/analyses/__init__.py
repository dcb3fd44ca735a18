from bcosification_tpu_torch.interpretability.analyses import (
    localisation,
    localisation_configs,
    text_localisation,
    utils,
)
