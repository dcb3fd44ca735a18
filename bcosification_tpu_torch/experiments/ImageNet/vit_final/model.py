"""Model factory of ImageNet/vit_final (the port's counterpart of
``bcosification_tpu/experiments/ImageNet/vit_final/model.py``): the arch's
SimpleViT with the layers its config names. A B-cos config
(``is_bcos``) gets BcosLinear and BcosConv2d with its ``bcos_args`` and the
logit layer inside the SimpleViT; a standard one PlainLinear and a plain
biased 3x3 stem conv (``PlainConv2d``).
``act_layer`` is "gelu" (the detachable gate), "gelu_plain" (nn.GELU) or
"identity"; ``channels`` the image's (6 AddInverse, 3 Normalize).

The net is initialised on the device from a ``torch.Generator`` seeded
with the config's "seed" (0 when it has none); it does not reproduce the
JAX package's random init (the tests carry JAX weights over with
``bcosify/from_jax.py``). Under ``utils.init_mode.abstract_init`` it is
built on the meta device, shapes only.
"""
from __future__ import annotations

from functools import partial


from bcosification_tpu_torch.models import vit as vit_lib
from bcosification_tpu_torch.modules import (
    BcosConv2d,
    BcosLinear,
    DetachableGELU,
    Identity,
    PlainConv2d,
    PlainLinear,
)
from bcosification_tpu_torch.modules.activations import PlainGELU
from bcosification_tpu_torch.utils.init_mode import build_device, build_generator

__all__ = ["get_model"]

ACTS = {"gelu": DetachableGELU, "gelu_plain": PlainGELU, "identity": Identity}


def get_model(model_config, device=None, **arch):
    """The SimpleViT of ``model_config`` in eval mode on ``device`` (default
    the GPU; ``"cpu"`` when asked). ``arch`` overrides fields of the arch's
    entry (e.g. ``depth``)."""
    dev = build_device(device)
    args = dict(model_config["args"])
    act = args.pop("act_layer", "identity")
    args["act_layer"] = ACTS[act] if isinstance(act, str) else act
    is_bcos = model_config["is_bcos"]
    if "linear_layer" not in args:
        if is_bcos:
            bcos_args = model_config.get("bcos_args", {})
            args["linear_layer"] = partial(BcosLinear, **bcos_args)
            args["conv2d_layer"] = partial(BcosConv2d, **bcos_args)
        else:
            args["linear_layer"] = PlainLinear
            args["conv2d_layer"] = PlainConv2d
    seed = model_config.get("seed", 0) or 0
    factory = getattr(vit_lib, model_config["name"])
    net = factory(with_logit_layer=is_bcos, logit_bias=model_config.get("logit_bias"),
                  device=dev, generator=build_generator(dev, seed),
                  **args, **arch)
    return net.eval().requires_grad_(False)
