"""CC3M/clip_bcosification experiment configs (the port's counterpart of
``bcosification_tpu/experiments/CC3M/clip_bcosification/experiment_parameters.py``):
the ImageNet KD recipe (batch 64 per device, 90 epochs, Adam 1e-4 with the
cosine schedule, AGC, the SigLIP criterion, the raw [0, 1] CLIP presets) fed
by CC3M's image pipeline. The grid: the CLIP-RN50 student with the cosine or
the cyclic tag, and two seed copies of each.
"""
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

DEFAULT_BATCH_SIZE = 64
DEFAULT_NUM_EPOCHS = 90
DEFAULT_LR = 1e-4
DEFAULT_CROP_SIZE = 224

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
    ),
    model=dict(
        is_bcos=True,
        args=dict(),
        bcos_args=dict(b=2, max_out=1),
    ),
    criterion=SigLipLoss(),
    test_criterion=SigLipLoss(),
    optimizer=OptimizerFactory(name="Adam", lr=DEFAULT_LR, bcosify=True, b_opt=False),
    lr_scheduler=LRSchedulerFactory(name="cosineannealinglr", epochs=DEFAULT_NUM_EPOCHS),
    trainer=dict(max_epochs=DEFAULT_NUM_EPOCHS),
    use_agc=True,
)


def update_default(new_config):
    return update_config(DEFAULTS, new_config)


# the scheduler tag precedes the `_sigLip_kd_CC3M_bcosification` suffix, and
# only the cyclic one is named
CONFIGS = {
    "resnet_50_clip_b2_noBias_randomResizedCrop"
    + ("_" + schDLR if schDLR == "cyclicLR" else "")
    + "_sigLip_kd_CC3M_bcosification": update_default(
        dict(
            clip_kd=True,
            model=dict(
                name="resnet50clip",
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
    for schDLR in ["cosineAnnealingLR", "cyclicLR"]
}
CONFIGS.update(create_configs_with_different_seeds(dict(CONFIGS), seeds=[420, 1337]))

if __name__ == "__main__":
    configs_cli(CONFIGS)
