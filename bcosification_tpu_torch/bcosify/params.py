"""Pure parameter transforms of the B-cosification conversion, in the port's
layouts (counterpart of ``bcosification_tpu/bcosify/params.py``).

Each transform is a function on numpy arrays. The JAX package converts a
torchvision checkpoint into HWIO conv kernels and (in, out) linear weights;
the port keeps PyTorch's own layouts, OIHW and (out, in), so the same
transforms act on other axes here and a torchvision weight is taken as it
is.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "add_channels_conv_weight",
    "bn_uncentered_fold_bias",
    "linear_to_conv1x1_weight",
    "vit_patchify_linear_add_channels",
]


def add_channels_conv_weight(w: np.ndarray) -> np.ndarray:
    """First-conv 3 -> 6 channel doubling, w' = [w, -w] / 2 on the
    input-channel axis (axis 1 of OIHW). For AddInverse input [z, -z],
    conv(w', [z, -z]) == conv(w, z)."""
    assert w.shape[1] == 3, f"expected 3 input channels, got {w.shape}"
    return np.concatenate([w, -w], axis=1) / 2.0


def bn_uncentered_fold_bias(bias, running_mean, running_var, weight,
                            eps: float = 1e-5) -> np.ndarray:
    """BnUncV2 bias fold: replacing a centered BN by an uncentered one is
    exact in eval mode with b' = b - (mu / sqrt(var + eps)) * gamma."""
    std = np.sqrt(np.asarray(running_var) + eps)
    return np.asarray(bias) - (np.asarray(running_mean) / std) * np.asarray(weight)


def linear_to_conv1x1_weight(w: np.ndarray) -> np.ndarray:
    """(out, in) linear weight -> (out, in, 1, 1) OIHW kernel: the
    GAP-reorder classifier."""
    assert w.ndim == 2
    return w.reshape(*w.shape, 1, 1)


def vit_patchify_linear_add_channels(w: np.ndarray) -> np.ndarray:
    """Channel doubling of a ViT's linear patch embedding, (out, 3 p p) ->
    (out, 6 p p). A patch flattens pixel-major with the channels innermost
    ((p1 p2 c)), so each pixel's 3 input columns become 6, [w / 2, -w / 2]:
    on the normalised AddInverse patch ([n, -n] per pixel) the doubled
    weight gives w's map of n exactly, as the stem conv's doubling does."""
    out, in_dim = w.shape
    assert in_dim % 3 == 0, f"expected 3 channels per pixel, got {w.shape}"
    w3 = np.asarray(w).reshape(out, in_dim // 3, 3)
    return np.concatenate([w3 / 2.0, -w3 / 2.0], axis=2).reshape(out, 2 * in_dim)
