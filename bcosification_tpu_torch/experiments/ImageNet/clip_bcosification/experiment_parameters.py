"""ImageNet/clip_bcosification experiment configs (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/clip_bcosification/experiment_parameters.py``):
the same grid (the CLIP-RN50 student with the cosine or the cyclic
schedule, their attn-unpool variants, the CLIP ViT towers and their
attn-unpool variants, two seed copies of the RN50 configs) and the same
recipe: batch 64 per device (256 over four), 90 epochs, Adam 1e-4, AGC, the
SigLIP criterion, the raw [0, 1] CLIP presets (the model normalises).
"""
import math

from bcosification_tpu_torch.data.presets import (
    CLIPBcosImageNetClassificationPresetEval,
    CLIPBcosImageNetClassificationPresetTrain,
)
from bcosification_tpu_torch.experiments.utils.config_utils import (
    configs_cli,
    create_configs_with_different_seeds,
    update_config,
)
from bcosification_tpu_torch.losses import SigLipLoss
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory

__all__ = ["CONFIGS"]

NUM_CLASSES = 1_000
DEFAULT_BATCH_SIZE = 64
DEFAULT_NUM_EPOCHS = 90
DEFAULT_LR = 1e-4
DEFAULT_CROP_SIZE = 224

DEFAULT_OPTIMIZER = OptimizerFactory(name="Adam", lr=DEFAULT_LR, bcosify=True, b_opt=False)
DEFAULT_LR_SCHEDULE = LRSchedulerFactory(name="cosineannealinglr", epochs=DEFAULT_NUM_EPOCHS)

DEFAULTS = dict(
    data=dict(
        train_transform=CLIPBcosImageNetClassificationPresetTrain(
            crop_size=DEFAULT_CROP_SIZE
        ),
        test_transform=CLIPBcosImageNetClassificationPresetEval(
            crop_size=DEFAULT_CROP_SIZE
        ),
        batch_size=DEFAULT_BATCH_SIZE,
        num_workers=16,
        num_classes=NUM_CLASSES,
    ),
    model=dict(
        is_bcos=True,
        args=dict(num_classes=NUM_CLASSES, logit_bias=-math.log(NUM_CLASSES - 1)),
        bcos_args=dict(b=2, max_out=1),
    ),
    criterion=SigLipLoss(),
    test_criterion=SigLipLoss(),
    optimizer=DEFAULT_OPTIMIZER,
    lr_scheduler=DEFAULT_LR_SCHEDULE,
    trainer=dict(max_epochs=DEFAULT_NUM_EPOCHS),
    use_agc=True,
)


def update_default(new_config):
    return update_config(DEFAULTS, new_config)


RESNET_DEPTHS = [50]
resnets_clip = {
    f"resnet_{depth}_clip_b2_noBias_randomResizedCrop"
    + (f"_{schDLR}" if schDLR == "cyclicLR" else "")
    + "_sigLip_ImageNet_bcosification": update_default(
        dict(
            clip_kd=True,  # read from the config, not from model_config
            model=dict(
                name=f"resnet{depth}clip",
                bcosify_args=dict(
                    clip_kd=True,
                    fix_b=True,
                    norm_layer="BnUncV2",
                    schDLR=schDLR,
                    use_bias=False,
                ),
            ),
        )
    )
    for depth in RESNET_DEPTHS
    for schDLR in ["cosineAnnealingLR", "cyclicLR"]
}

# attn-unpool variant (per-location features for text localisation)
attn_unpool = {
    name + "_attnUnpool": update_config(
        cfg, dict(model=dict(attn_unpool=True, cos_power=2))
    )
    for name, cfg in resnets_clip.items()
}

# the CLIP ViT towers through the same recipe (beyond the reference, which
# B-cosifies CLIP-RN50 only; model.py builds them with the ViT rules)
vits_clip = {
    f"vit_{tag}_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification": (
        update_default(
            dict(
                clip_kd=True,
                model=dict(
                    name=f"vit{tag.replace('_', '')}clip",
                    bcosify_args=dict(
                        clip_kd=True, fix_b=True, use_bias=False,
                        schDLR="cosineAnnealingLR",
                    ),
                ),
            )
        )
    )
    for tag in ("b_32", "b_16", "l_14")
}

vit_unpool = {
    name + "_attnUnpool": update_config(
        cfg, dict(model=dict(attn_unpool=True, cos_power=2))
    )
    for name, cfg in vits_clip.items()
}

CONFIGS = dict()
CONFIGS.update(resnets_clip)
CONFIGS.update(attn_unpool)
CONFIGS.update(vits_clip)
CONFIGS.update(vit_unpool)
CONFIGS.update(create_configs_with_different_seeds(dict(resnets_clip), seeds=[420, 1337]))

if __name__ == "__main__":
    configs_cli(CONFIGS)
