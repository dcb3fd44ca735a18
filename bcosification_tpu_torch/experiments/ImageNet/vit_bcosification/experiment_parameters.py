"""ImageNet/vit_bcosification experiment configs (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/vit_bcosification/experiment_parameters.py``):
the same grid (the ``bcos_*`` from-scratch baselines of the eight ViT archs,
the ``bcosifyv2_*`` grid over pretrained/random weights, lr, lr warm-up,
GELU, biases and the GAP reorder, three seed copies of each) and the same
recipe: batch 128 (64 for the big models), 90 epochs, Adam, the cosine with
a step-interval warm-up, AGC, mixup 0.2, the UniformOffLabels BCE
criterion.
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
from bcosification_tpu_torch.modules import norms
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

__all__ = ["CONFIGS", "SIMPLE_VIT_ARCHS", "is_big_model"]

NUM_CLASSES = 1_000
DEFAULT_BATCH_SIZE = 128
DEFAULT_NUM_EPOCHS = 90
DEFAULT_LR = 1e-3
DEFAULT_CROP_SIZE = 224

DEFAULT_LR_SCHEDULE = LRSchedulerFactory(
    name="cosineannealinglr",
    epochs=DEFAULT_NUM_EPOCHS,
    warmup_method="linear",
    warmup_steps=10_000,
    interval="step",
    warmup_decay=0.01,
)
LONG_WARM_SCHEDULE = LRSchedulerFactory(
    name="cosineannealinglr",
    epochs=DEFAULT_NUM_EPOCHS,
    warmup_method="linear",
    warmup_steps=50_000,
    interval="step",
    warmup_decay=0.01,
)

DEFAULTS = dict(
    data=dict(
        batch_size=DEFAULT_BATCH_SIZE,
        num_workers=16,
        num_classes=NUM_CLASSES,
        mixup_alpha=0.2,
    ),
    model=dict(args=dict(num_classes=NUM_CLASSES)),
    lr_scheduler=DEFAULT_LR_SCHEDULE,
    trainer=dict(max_epochs=DEFAULT_NUM_EPOCHS),
    use_agc=True,
)


def update_default(new_config):
    return update_config(DEFAULTS, new_config)


def is_big_model(model_name: str) -> bool:
    return "_l_" in model_name or "simple_vit_b" in model_name


SIMPLE_VIT_ARCHS = [
    "simple_vit_ti_patch16_224",
    "simple_vit_s_patch16_224",
    "simple_vit_b_patch16_224",
    "simple_vit_l_patch16_224",
    "vitc_s_patch1_14",
    "vitc_ti_patch1_14",
    "vitc_b_patch1_14",
    "vitc_l_patch1_14",
]

bcos = {
    f"bcos_{name}": update_default(
        dict(
            data=dict(
                batch_size=DEFAULT_BATCH_SIZE
                if not is_big_model(name)
                else DEFAULT_BATCH_SIZE // 2,
                train_transform=ImageNetClassificationPresetTrain(
                    crop_size=DEFAULT_CROP_SIZE, is_bcos=True
                ),
                test_transform=ImageNetClassificationPresetEval(
                    crop_size=DEFAULT_CROP_SIZE, is_bcos=True
                ),
                num_workers=10,
            ),
            model=dict(
                is_bcos=True,
                name=name,
                args=dict(
                    norm_layer=norms.NoBias(norms.DetachableLayerNorm),
                    act_layer="identity",
                    channels=6,
                    norm2d_layer=norms.NoBias(norms.DetachableGNLayerNorm2d),
                ),
                bcos_args=dict(b=2, max_out=1),
                logit_bias=math.log(1 / (NUM_CLASSES - 1)),
            ),
            criterion=UniformOffLabelsBCEWithLogitsLoss(),
            lr_scheduler=DEFAULT_LR_SCHEDULE
            if not is_big_model(name)
            else LONG_WARM_SCHEDULE,
            test_criterion=BinaryCrossEntropyLoss(),
            optimizer=OptimizerFactory("Adam", lr=DEFAULT_LR),
        )
    )
    for name in SIMPLE_VIT_ARCHS
}

# the bcosifyv2 grid: every combination of the six axes below
bcosify = {
    f"bcosifyv2_{name}"
    + (f"_{weight}" if weight == "random" else "")
    + (f"_{lr}" if lr in (1e-3, 1e-2, 1e-5) else "")
    + ("_lrWarmup" if lrwarmup == "lrWarmup" else "")
    + ("_useBias" if use_bias == "useBias" else "")
    + ("_noGelu" if gelu == "noGelu" else "")
    + ("_gapReorder" if gap_reorder == "gapReorder" else ""): update_config(
        old_config,
        dict(
            model=dict(
                weights="pretrained" if weight == "pretrained" else None,
                args=dict(gap_reorder=gap_reorder == "gapReorder"),
                bcosify_args=dict(
                    fix_b=True,
                    use_bias=use_bias == "useBias",
                ),
                logit_layer=True,
                act_layer=gelu == "gelu",
            ),
            lr_scheduler=LRSchedulerFactory(
                name="cosineannealinglr",
                epochs=DEFAULT_NUM_EPOCHS,
                warmup_method="linear" if lrwarmup == "lrWarmup" else "constant",
                warmup_steps=(
                    10_000
                    if (lrwarmup == "lrWarmup" and not is_big_model(name))
                    else 50_000
                    if (lrwarmup == "lrWarmup" and is_big_model(name))
                    else None
                ),
                interval="step",
                warmup_decay=0.01,
            ),
            optimizer=OptimizerFactory("Adam", lr=lr),
        ),
    )
    for name, old_config in bcos.items()
    for weight in ["pretrained", "random"]
    for lrwarmup in ["lrWarmup", "noLrWarmup"]
    for lr in [1e-2, 1e-3, 1e-4, 1e-5]
    for gelu in ["gelu", "noGelu"]
    for use_bias in ["useBias", "noBias"]
    for gap_reorder in ["gapReorder", "noGapReorder"]
}

CONFIGS = dict()
CONFIGS.update(bcos)
CONFIGS.update(bcosify)
CONFIGS.update(create_configs_with_different_seeds(CONFIGS, seeds=[5, 420, 1337]))

if __name__ == "__main__":
    configs_cli(CONFIGS)
