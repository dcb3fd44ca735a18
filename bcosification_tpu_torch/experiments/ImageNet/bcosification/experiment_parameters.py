"""ImageNet/bcosification experiment configs (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/bcosification/experiment_parameters.py``):
the same grid (resnet_18, resnet_18_V1, resnet_50, resnet_50_V1,
densenet_121, each with three seed variants) and the same recipe: batch 64
per device (256 over four), 90 epochs, Adam 1e-4 with the cosine, AGC, the
UniformOffLabels BCE criterion, the uncentered BnUncV2 norm, the maxpool
replaced by an avg-pool and the classifier as a 1x1 conv before the global
average pool.
"""
import math

from bcosification_tpu_torch.data.presets import (
    ImageNetClassificationPresetEval,
    ImageNetClassificationPresetTrain,
)
from bcosification_tpu_torch.experiments.utils.config_utils import (
    configs_cli,
    create_configs_with_different_seeds,
    update_config,
)
from bcosification_tpu_torch.losses import (
    BinaryCrossEntropyLoss,
    UniformOffLabelsBCEWithLogitsLoss,
)
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

__all__ = ["CONFIGS"]

NUM_CLASSES = 1_000
NUM_TRAIN_EXAMPLES = 1_281_167
NUM_EVAL_EXAMPLES = 50_000

DEFAULT_BATCH_SIZE = 64  # per data-shard of 4 => 256 effective (ref recipe)
DEFAULT_NUM_EPOCHS = 90
DEFAULT_LR = 1e-4
DEFAULT_CROP_SIZE = 224

DEFAULT_OPTIMIZER = OptimizerFactory(name="Adam", lr=DEFAULT_LR, bcosify=True, b_opt=False)
DEFAULT_LR_SCHEDULE = LRSchedulerFactory(name="cosineannealinglr", epochs=DEFAULT_NUM_EPOCHS)

DEFAULTS = dict(
    data=dict(
        train_transform=ImageNetClassificationPresetTrain(
            crop_size=DEFAULT_CROP_SIZE, is_bcos=True
        ),
        test_transform=ImageNetClassificationPresetEval(
            crop_size=DEFAULT_CROP_SIZE, is_bcos=True
        ),
        batch_size=DEFAULT_BATCH_SIZE,
        num_workers=16,
        num_classes=NUM_CLASSES,
    ),
    model=dict(
        is_bcos=True,
        args=dict(
            num_classes=NUM_CLASSES,
            logit_bias=-math.log(NUM_CLASSES - 1),
        ),
        bcos_args=dict(b=2, max_out=1),
    ),
    criterion=UniformOffLabelsBCEWithLogitsLoss(),
    test_criterion=BinaryCrossEntropyLoss(),
    optimizer=DEFAULT_OPTIMIZER,
    lr_scheduler=DEFAULT_LR_SCHEDULE,
    trainer=dict(max_epochs=DEFAULT_NUM_EPOCHS),
    use_agc=True,
)


def update_default(new_config):
    return update_config(DEFAULTS, new_config)


RESNET_DEPTHS = [18, 50]
resnets = {
    f"resnet_{depth}" + (f"_{weight}" if weight == "V1" else ""): update_default(
        dict(
            model=dict(
                name=f"resnet{depth}",
                last_layer_name="fc",
                weights=(
                    f"ResNet{depth}_Weights.DEFAULT"
                    if weight == "V2"
                    else "IMAGENET1K_V1" if weight == "V1" and depth == 50 else None
                ),
                bcosify_args=dict(
                    fix_b=True,
                    use_bias=False,
                    norm_layer="BnUncV2",
                    manual_optim=False,
                    gap=True,
                    act_layer=True,
                ),
                standard_changes={"maxpool": "avgpool_3_2_1"},
            ),
        )
    )
    for depth in RESNET_DEPTHS
    for weight in ["V2", "V1"]
}

DENSENET_DEPTHS = [121]
densenets = {
    f"densenet_{depth}": update_default(
        dict(
            model=dict(
                name=f"densenet{depth}",
                last_layer_name="classifier",
                weights=f"DenseNet{depth}_Weights.DEFAULT",
                bcosify_args=dict(
                    fix_b=True,
                    use_bias=False,
                    norm_layer="BnUncV2",
                    manual_optim=False,
                    gap=True,
                    act_layer=True,
                ),
                standard_changes={"features[3]": "avgpool_3_2_1"},
            ),
        )
    )
    for depth in DENSENET_DEPTHS
}

CONFIGS = dict()
CONFIGS.update(resnets)
CONFIGS.update(densenets)
CONFIGS.update(create_configs_with_different_seeds(CONFIGS, seeds=[5, 420, 1337]))

if __name__ == "__main__":
    configs_cli(CONFIGS)
