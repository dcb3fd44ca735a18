"""The model wrapper with the reference's ``BcosUtilMixin`` surface
(counterpart of ``bcosification_tpu/common.py``).

``BcosModel(model)`` wraps a B-cos ``nn.Module`` (called as ``model(x,
train=, explain=)``) on the device its weights lie on: the module holds its
weights, so there are no separate variables. ``explanation_mode()`` makes
plain calls take the explanation-variant forward until it exits;
``explain``, ``attribute`` and ``attribute_selection`` go through
``explain/core.py`` on the model's device.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch

from bcosification_tpu_torch.explain.core import (
    attribute as _attribute,
    attribute_selection as _attribute_selection,
    explain as _explain,
    gradient_to_image,
    plot_contribution_map,
)

__all__ = ["BcosModel", "gradient_to_image", "plot_contribution_map"]


def to_probabilities(logits: torch.Tensor) -> torch.Tensor:
    """B-cos nets output BCE logits: their probabilities are a sigmoid."""
    return torch.sigmoid(logits)


def _device_of(model: torch.nn.Module) -> torch.device:
    tensor = next(model.parameters(), None)
    if tensor is None:
        tensor = next(model.buffers(), None)
    return tensor.device if tensor is not None else torch.device("cpu")


class BcosModel:
    """A B-cos ``nn.Module`` with the BcosUtilMixin surface, on its device."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.device = _device_of(model)
        self._explain_default = False

    # -- forward ---------------------------------------------------------------
    def __call__(self, x: torch.Tensor, *, train: bool = False,
                 explain: Optional[bool] = None) -> torch.Tensor:
        explain = self._explain_default if explain is None else explain
        return self.model(x, train=train, explain=explain)

    to_probabilities = staticmethod(to_probabilities)

    # -- explanation mode ------------------------------------------------------
    @contextlib.contextmanager
    def explanation_mode(self):
        """Inside it, plain calls use the explanation-variant forward; the
        default comes back on exit, also when the block raises."""
        prev = self._explain_default
        self._explain_default = True
        try:
            yield self
        finally:
            self._explain_default = prev

    # -- helpers ----------------------------------------------------------------
    def explain(self, in_tensor: torch.Tensor, idx: Optional[int] = None,
                **kwargs) -> Dict[str, Any]:
        """``explain/core.explain`` of the first image of ``in_tensor``."""
        return _explain(self.model, in_tensor, idx=idx, device=self.device, **kwargs)

    def _expl_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, train=False, explain=True)

    def attribute(self, image: torch.Tensor, target, **kwargs) -> torch.Tensor:
        """Input x Gradient with detached dynamic weights: x * W(x)[target]."""
        return _attribute(self._expl_apply, image, target, device=self.device)

    def attribute_selection(self, image: torch.Tensor, targets: Sequence[int],
                            **kwargs) -> torch.Tensor:
        """``attribute`` of the first image for each target: [T, *x.shape[1:]]."""
        return _attribute_selection(self._expl_apply, image, targets, device=self.device)

    gradient_to_image = staticmethod(gradient_to_image)
    plot_contribution_map = staticmethod(plot_contribution_map)
