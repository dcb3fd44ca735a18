"""Explanation core (counterpart of ``bcosification_tpu/explain/core.py``).

The explanation-mode forward (``explain=True``) detaches every dynamic
scale, so the model is linear in its input around x and
W(x) = d logit[selected] / d x comes from one backward pass.
Completeness: for bias-free B-cos nets, (x * W(x)).sum() is the logit.

``explain`` and ``make_explain_fn`` give the prediction, W(x), the
contribution map and the colour explanation (``gradient_to_image``); B-cosified
ResNets take the hand-scheduled pass of ``explain/fast_resnet.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device

__all__ = [
    "dynamic_linear_weights",
    "contribution_map",
    "gradient_to_image",
    "make_explain_fn",
    "explain",
    "attribute",
    "attribute_selection",
    "plot_contribution_map",
]


def dynamic_linear_weights(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                           x: torch.Tensor, idx=None, *, device=None):
    """(logits, selected_idx, W) with W = d logit[selected] / d x, where
    ``apply_fn`` is the explanation-mode forward. ``idx`` None explains the
    argmax; otherwise the given class (or one class per image). Runs on
    ``device`` (default the GPU; raises without one unless device="cpu")."""
    dev = resolve_device(device)
    x = x.detach().to(dev).requires_grad_(True)
    with torch.enable_grad():
        out = apply_fn(x)
    if out.dim() != 2:
        raise ValueError(f"expected (batch, classes) logits, got {tuple(out.shape)}")
    if idx is None:
        sel = out.detach().argmax(dim=1)
    else:
        sel = torch.as_tensor(idx, device=dev).expand(out.shape[0])
    ct = F.one_hot(sel, out.shape[-1]).to(out.dtype)
    (w,) = torch.autograd.grad(out, x, grad_outputs=ct)
    return out.detach(), sel, w


def contribution_map(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(x * W(x)).sum over channels: per-location contributions."""
    return (x * w).sum(-1)


def _to_rgba(image: torch.Tensor, linear_mapping: torch.Tensor, smooth: int,
             alpha_percentile: float) -> torch.Tensor:
    """gradient_to_image on a batch: [N, H, W, 6] -> [N, H, W, 4]."""
    contribs = (image * linear_mapping).sum(-1, keepdim=True)
    # normalise each pixel's 6-vector so that its largest |entry| is 1
    rgb_grad = linear_mapping / (linear_mapping.abs().amax(-1, keepdim=True) + 1e-12)
    rgb_grad = rgb_grad.clamp_min(0)
    # fold the (r, 1 - r) pairs: rgb = pos / (pos + inv)
    rgb = rgb_grad[..., :3] / (rgb_grad[..., :3] + rgb_grad[..., 3:] + 1e-12)

    # alpha: the L2 norm of W at each location, masked to positive contributions
    alpha = torch.linalg.vector_norm(linear_mapping, dim=-1, keepdim=True)
    alpha = torch.where(contribs < 0, torch.full_like(alpha, 1e-12), alpha)
    if smooth:
        # a window sum divided by the full window area, padding included
        pad = (smooth - 1) // 2
        alpha = F.avg_pool2d(alpha.permute(0, 3, 1, 2), smooth, stride=1, padding=pad,
                             divisor_override=smooth * smooth).permute(0, 2, 3, 1)
    # linear interpolation between the closest ranks, as jnp.quantile does
    cut = torch.quantile(alpha.flatten(1), alpha_percentile / 100.0, dim=1)
    alpha = (alpha / cut[:, None, None, None]).clamp(0, 1)
    return torch.cat([rgb, alpha], dim=-1)


def gradient_to_image(image: torch.Tensor, linear_mapping: torch.Tensor, smooth: int = 15,
                      alpha_percentile: float = 99.5) -> torch.Tensor:
    """Colour coding of W(x), channel-last: image and linear_mapping
    [H, W, 6] (AddInverse encoding) -> RGBA [H, W, 4] in [0, 1]."""
    if image.dim() != 3 or image.shape[-1] != 6:
        raise ValueError(f"expected an [H, W, 6] image, got {tuple(image.shape)}")
    return _to_rgba(image[None], linear_mapping[None], smooth, alpha_percentile)[0]


def _explain_run(model, smooth: int, alpha_percentile: float, with_image: bool,
                 use_fast: bool):
    def run(x: torch.Tensor, idx: Optional[int] = None, device=None):
        if use_fast:
            from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

            out, sel, w = fast_dynamic_linear_weights(model, x, idx, device=device)
        else:
            out, sel, w = dynamic_linear_weights(lambda t: model(t, explain=True), x, idx,
                                                 device=device)
        x = x.to(w.device)
        result = {
            "prediction": out.argmax(dim=1),
            "explained_class_idx": sel,
            "dynamic_linear_weights": w,
            "contribution_map": contribution_map(x, w),
            "logits": out,
        }
        if with_image:  # in f32: torch.quantile takes no bf16
            result["explanation"] = _to_rgba(x.float(), w.float(), smooth, alpha_percentile)
        return result

    return run


def make_explain_fn(model, smooth: int = 15, alpha_percentile: float = 99.5,
                    with_image: bool = True, fast: Union[str, bool] = "auto"):
    """explain_fn(x, idx=None, device=None) -> dict for a model called as
    ``model(x, explain=True)``: prediction, explained_class_idx,
    dynamic_linear_weights, contribution_map, logits and (``with_image``)
    the RGBA explanation of each image.

    ``fast``: "auto" routes B-cosified ResNets through the hand-scheduled
    pass (``fast_resnet.supports``); True forces it (raises if unsupported);
    False always differentiates the module forward. Other nets, the
    DenseNet and the ViT among them, differentiate the module forward, as
    in the JAX package (their own passes, ``fast_densenet`` and
    ``fast_vit``, serve ``serving.export_explain``).

    Unlike the JAX package, which caches its jitted functions per model,
    nothing is cached: the function is a closure that costs nothing to build,
    and a cache would keep each model's weights alive."""
    from bcosification_tpu_torch.explain import fast_resnet

    use_fast = fast_resnet.supports(model) if fast == "auto" else bool(fast)
    return _explain_run(model, smooth, alpha_percentile, with_image, use_fast)


def explain(model, x: torch.Tensor, idx: Optional[int] = None, smooth: int = 15,
            alpha_percentile: float = 99.5, *, device=None) -> Dict[str, Any]:
    """One-shot explanation of the first image of x [N, H, W, 6] (NHWC,
    AddInverse): prediction and class (ints), W(x), the contribution map, the
    RGBA explanation [H, W, 4] and the logits. Runs on ``device`` (default
    the GPU; raises without one unless device="cpu")."""
    if x.dim() != 4:
        raise ValueError("Expected 4-dimensional NHWC input tensor")
    out = make_explain_fn(model, smooth, alpha_percentile)(x, idx, device)
    return {
        "prediction": int(out["prediction"][0]),
        "explained_class_idx": int(out["explained_class_idx"][0]),
        "dynamic_linear_weights": out["dynamic_linear_weights"],
        "contribution_map": out["contribution_map"],
        "explanation": out["explanation"][0],
        "logits": out["logits"],
    }


def attribute(apply_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              target: Union[int, torch.Tensor], *, device=None) -> torch.Tensor:
    """Input x Gradient with detached dynamic weights: x * d logit[target] / dx
    for the explanation-mode forward ``apply_fn``; same shape as x."""
    _, _, w = dynamic_linear_weights(apply_fn, x, target, device=device)
    return x.to(w.device) * w


def attribute_selection(apply_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                        targets: Sequence[int], *, device=None) -> torch.Tensor:
    """``attribute`` of the first image of x for each of ``targets``:
    [T, *x.shape[1:]]. One forward of T copies of the image and one backward
    with the T one-hot cotangents, not a loop of backwards."""
    targets = torch.as_tensor(targets)
    xs = x[:1].repeat(len(targets), *([1] * (x.dim() - 1)))
    return attribute(apply_fn, xs, targets.to(resolve_device(device)), device=device)


def plot_contribution_map(contribution_map, ax=None, vrange=None, vmin=None, vmax=None,
                          hide_ticks: bool = True, cmap: str = "bwr",
                          percentile: float = 99.5):
    """Matplotlib view of an [H, W] contribution map, clipped at the
    ``percentile`` of |values|. Needs matplotlib (imported here)."""
    import numpy as np

    if isinstance(contribution_map, torch.Tensor):
        contribution_map = contribution_map.detach().cpu().numpy()
    cm = np.asarray(contribution_map)
    if cm.ndim != 2:
        raise ValueError("Contribution map must have 2 spatial dimensions.")
    cutoff = np.percentile(np.abs(cm), percentile)
    cm = np.clip(cm, -cutoff, cutoff)
    if ax is None:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(1)
    if vrange is None or vrange == "auto":
        vrange = np.max(np.abs(cm.flatten()))
    im = ax.imshow(cm, cmap=cmap, vmin=-vrange if vmin is None else vmin,
                   vmax=vrange if vmax is None else vmax)
    if hide_ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    return ax, im
