"""ImageNet/vit_final experiment configs (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/vit_final/experiment_parameters.py``):
the from-scratch SimpleViTs of the eight archs, each as a standard baseline
(plain linears, LayerNorm and GELU, 3 channels with Normalize, softmax
cross-entropy, AdamW with weight decay 1e-4, a global-norm clip of 1.0, no
AGC) and as a B-cos ViT (``bcos_*``: BcosLinear and BcosConv2d with b=2,
bias-free detachable norms, no activation, 6 AddInverse channels, the logit
layer, UniformOffLabels BCE, Adam, AGC). The recipe: batch 128 (64 for the
big models), 90 epochs, lr 1e-3, the cosine with a 10 000-step (big models:
50 000) linear warm-up, mixup 0.2.
"""
import math

from bcosification_tpu_torch.data.presets import (
    ImageNetClassificationPresetEval,
    ImageNetClassificationPresetTrain,
)
from bcosification_tpu_torch.experiments.utils.config_utils import (
    configs_cli,
    update_config,
)
from bcosification_tpu_torch.losses import (
    BinaryCrossEntropyLoss,
    CrossEntropyLoss,
    UniformOffLabelsBCEWithLogitsLoss,
)
from bcosification_tpu_torch.modules import norms
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

__all__ = ["CONFIGS"]

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

baseline = {
    name: update_default(
        dict(
            data=dict(
                batch_size=DEFAULT_BATCH_SIZE
                if not is_big_model(name)
                else DEFAULT_BATCH_SIZE // 2,
                train_transform=ImageNetClassificationPresetTrain(
                    crop_size=DEFAULT_CROP_SIZE, is_bcos=False
                ),
                test_transform=ImageNetClassificationPresetEval(
                    crop_size=DEFAULT_CROP_SIZE, is_bcos=False
                ),
            ),
            model=dict(
                is_bcos=False,
                name=name,
                args=dict(
                    # the plain LayerNorm and GELU (no detach under
                    # explain); the stem's group norm stays detachable
                    norm_layer=norms.PlainLayerNorm,
                    channels=3,
                    norm2d_layer=norms.DetachableGNLayerNorm2d,
                    act_layer="gelu_plain",
                ),
            ),
            # the standard baselines: softmax CE, AdamW (wd 1e-4) and a
            # global-norm clip of 1.0 instead of AGC
            criterion=CrossEntropyLoss(),
            test_criterion=CrossEntropyLoss(),
            optimizer=OptimizerFactory("AdamW", lr=DEFAULT_LR, weight_decay=0.0001),
            use_agc=False,
            trainer=dict(gradient_clip_val=1.0),
            lr_scheduler=DEFAULT_LR_SCHEDULE
            if not is_big_model(name)
            else LONG_WARM_SCHEDULE,
        )
    )
    for name in SIMPLE_VIT_ARCHS
}

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
            ),
            model=dict(
                is_bcos=True,
                name=name,
                args=dict(
                    norm_layer=norms.NoBias(norms.DetachableLayerNorm),
                    channels=6,
                    norm2d_layer=norms.NoBias(norms.DetachableGNLayerNorm2d),
                    act_layer="identity",
                ),
                bcos_args=dict(b=2, max_out=1),
                logit_bias=math.log(1 / (NUM_CLASSES - 1)),
            ),
            criterion=UniformOffLabelsBCEWithLogitsLoss(),
            test_criterion=BinaryCrossEntropyLoss(),
            optimizer=OptimizerFactory("Adam", lr=DEFAULT_LR),
            lr_scheduler=DEFAULT_LR_SCHEDULE
            if not is_big_model(name)
            else LONG_WARM_SCHEDULE,
        )
    )
    for name in SIMPLE_VIT_ARCHS
}

CONFIGS = dict()
CONFIGS.update(baseline)
CONFIGS.update(bcos)

if __name__ == "__main__":
    configs_cli(CONFIGS)
