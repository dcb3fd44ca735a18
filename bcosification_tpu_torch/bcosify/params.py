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
