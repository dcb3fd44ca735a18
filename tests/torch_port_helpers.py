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
