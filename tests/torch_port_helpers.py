"""Shared set-up of the PyTorch port's parity tests: the small flagships
built in JAX and in the port from the same variables, with calibrated BN
gammas."""
import math

import numpy as np
import torch

import jax

FLAGSHIP_CONFIG = {
    "bcosify_args": {
        "fix_b": True,
        "use_bias": False,
        "norm_layer": "BnUncV2",
        "gap": True,
        "act_layer": True,
    },
    "bcos_args": {"b": 2},
}
NUM_CLASSES = 10


def small_pair(arch, layers, input_size, seed=0):
    """(jax net, jax variables, port net, input x [2, S, S, 6] f32) for a small
    flagship with BN gammas calibrated as chip_smoke.py does; the port runs
    on the CPU."""
    from __graft_entry__ import _flagship
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
    from chip_smoke import calibrate

    net, variables = _flagship(input_size=input_size, arch=arch, inplanes=8,
                               num_classes=NUM_CLASSES, layers=layers)
    variables_np = jax.tree_util.tree_map(np.array, variables)
    tnet = build_bcosified_resnet({**FLAGSHIP_CONFIG, "name": arch},
                                  num_classes=NUM_CLASSES, inplanes=8, layers=layers,
                                  device="cpu")
    load_jax_variables(tnet, variables_np)
    rng = np.random.default_rng(seed)
    probe = torch.from_numpy(rng.random((1, input_size, input_size, 6)).astype(np.float32))
    calibrate(tnet, probe)
    variables_np = to_jax_variables(tnet)
    x = rng.random((2, input_size, input_size, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)  # AddInverse, NHWC
    variables = jax.tree_util.tree_map(jax.numpy.asarray, variables_np)
    return net, variables, tnet, x


def logit_bias():
    return -math.log(NUM_CLASSES - 1)


# the small DenseNet of the port's DenseNet tests: growth 8, two blocks of
# two layers, 16 initial features, bottleneck width 2 x 8
SMALL_DENSENET = dict(growth_rate=8, block_config=(2, 2), num_init_features=16, bn_size=2)


def jax_densenet(model_config, state_dict=None, *, arch_cfg, input_size, num_classes):
    """The JAX package's build_bcosified_densenet on ``arch_cfg``: that
    function reads DENSENET_CONFIGS[name], which is set for the call and
    restored after it, as tests/test_densenet_conversion.py does."""
    from bcosification_tpu.bcosify.engine import build_bcosified_densenet
    from bcosification_tpu.models.densenet import DENSENET_CONFIGS

    name = model_config["name"]
    old = DENSENET_CONFIGS[name]
    DENSENET_CONFIGS[name] = dict(arch_cfg)
    try:
        return build_bcosified_densenet(model_config, state_dict, input_size=input_size,
                                        num_classes=num_classes)
    finally:
        DENSENET_CONFIGS[name] = old


def small_densenet_pair(input_size=32, seed=0):
    """(jax net, jax variables, port net, input x [2, S, S, 6] f32) for the
    small DenseNet with BN gammas calibrated as chip_smoke.py does; the port
    runs on the CPU."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_densenet
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables, to_jax_variables
    from chip_smoke import calibrate

    config = {**FLAGSHIP_CONFIG, "name": "densenet121"}
    net, variables = jax_densenet(config, arch_cfg=SMALL_DENSENET, input_size=input_size,
                                  num_classes=NUM_CLASSES)
    tnet = build_bcosified_densenet(config, num_classes=NUM_CLASSES, arch_cfg=SMALL_DENSENET,
                                    device="cpu")
    load_jax_variables(tnet, jax.tree_util.tree_map(np.array, variables))
    rng = np.random.default_rng(seed)
    probe = torch.from_numpy(rng.random((1, input_size, input_size, 6)).astype(np.float32))
    calibrate(tnet, probe)
    x = rng.random((2, input_size, input_size, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)  # AddInverse, NHWC
    variables = jax.tree_util.tree_map(jax.numpy.asarray, to_jax_variables(tnet))
    return net, variables, tnet, x
