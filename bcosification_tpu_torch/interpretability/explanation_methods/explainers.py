"""Attribution methods (counterpart of
``bcosification_tpu/interpretability/explanation_methods/explainers.py``).

Every explainer holds an ``nn.Module`` (called as ``model(x, train=False,
explain=...)`` on NHWC inputs) and a device (the GPU unless the caller
passes ``device="cpu"``) and exposes

    attribute(img [1, H, W, C], target) -> [1, H, W, C]
    attribute_selection(img [1, H, W, C], targets [T]) -> [T, H, W, C]

as tensors on that device. The gradient methods run one forward of T
copies of the image and one backward with the T one-hot cotangents (the
rows of an eval-mode batch are independent), as ``explain/core.py`` does;
IntGrad repeats that for each of its ``n_steps`` alphas. "Ours" and
"OursRelative" differentiate the explanation-mode forward (``explain=True``:
on a B-cosified ResNet K1 forward and K2 backward); IxG, Grad, GB, IntGrad
and DeepLIFT the plain eval forward (``explain=False``: the 1x1 convs
unfused, K3 at stride 1). GB and DeepLIFT run their forward inside
``ops.guided``'s modes, which keep every conv off K1. Occlusion, RISE and
LIME batch their perturbed copies through the no-grad forward (K1), build
each batch of copies on the device as it is needed, and keep the JAX
package's seeds, numpy RNG draws and arithmetic; LIME solves its ridge
regression for all targets at once in float64 on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.ops import guided

__all__ = [
    "ExplainerBase",
    "Ours",
    "OursRelative",
    "IxG",
    "Grad",
    "GB",
    "DeepLift",
    "IntGrad",
    "GradCam",
    "Occlusion",
    "Rise",
    "Lime",
]


def _as_tensor(a, device) -> torch.Tensor:
    """A tensor, numpy array or array-like on ``device``."""
    return (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(device)


def _targets(targets, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(targets), dtype=torch.long, device=device).reshape(-1)


def _copies(img: torch.Tensor, n: int) -> torch.Tensor:
    """n copies of the first image of img [1, H, W, C]."""
    return img[:1].expand(n, *img.shape[1:]).contiguous()


def _input_grads(apply_fn, img: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[T, H, W, C]: d apply_fn(x)[t] / dx at the first image of img for
    each target t, from one forward of T copies and one backward."""
    x = _copies(img, len(targets)).requires_grad_(True)
    with torch.enable_grad():
        out = apply_fn(x)
    ct = F.one_hot(targets, out.shape[-1]).to(out.dtype)
    (g,) = torch.autograd.grad(out, x, grad_outputs=ct)
    return g


def bilinear_upsample(a: torch.Tensor, size) -> torch.Tensor:
    """a [N, h, w] resized to [N, *size] by half-pixel-centred bilinear
    interpolation (``jax.image.resize(..., "linear")`` when upsampling)."""
    return F.interpolate(a[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def _per_channel(amap: torch.Tensor, c: int) -> torch.Tensor:
    """[T, H, W] -> [T, H, W, C]: the map divided evenly over the channels."""
    return (amap[..., None] / c).expand(*amap.shape, c).contiguous()


class ExplainerBase:
    """The common attribute / attribute_selection interface."""

    explanation_mode = False  # differentiate the explain=True forward

    def __init__(self, model, device=None, **config):
        self.model = model
        self.device = resolve_device(device)
        self.config = config

    def _input(self, img) -> torch.Tensor:
        return _as_tensor(img, self.device)

    def _apply(self, x, explain: Optional[bool] = None):
        explain = self.explanation_mode if explain is None else explain
        return self.model(x, train=False, explain=explain)

    def attribute(self, img, target):
        return self.attribute_selection(img, [target])[0:1]

    def attribute_selection(self, img, targets):
        raise NotImplementedError


class Ours(ExplainerBase):
    """The model's own dynamic-linear contributions: input x gradient of the
    explanation-mode forward (the dynamic weights detached)."""

    explanation_mode = True

    def _logits(self, x):
        return self._apply(x)

    def attribute_selection(self, img, targets):
        img = self._input(img)
        grads = _input_grads(self._logits, img, _targets(targets, self.device))
        return grads * img[0]


class OursRelative(Ours):
    """Ours on the logits minus their mean."""

    def _logits(self, x):
        out = self._apply(x)
        return out - out.mean(dim=-1, keepdim=True)


class IxG(ExplainerBase):
    """Input x gradient of the normal (not detached) forward."""

    def attribute_selection(self, img, targets):
        img = self._input(img)
        return _input_grads(self._apply, img, _targets(targets, self.device)) * img[0]


class Grad(ExplainerBase):
    """Saliency: the raw gradients."""

    def attribute_selection(self, img, targets):
        img = self._input(img)
        return _input_grads(self._apply, img, _targets(targets, self.device))


class GB(ExplainerBase):
    """Guided backprop: saliency where every ReLU of the model path
    (``modules.ReLU``, routed through ``ops.guided``) passes back only the
    positive gradients of positively activated units. On a ReLU-free net
    (or the CLIP towers, whose ReLU is plain) GB equals Grad."""

    def _guided(self, x):
        with guided.guided_backprop():
            return self._apply(x)

    def attribute_selection(self, img, targets):
        img = self._input(img)
        return _input_grads(self._guided, img, _targets(targets, self.device))


class DeepLift(ExplainerBase):
    """DeepLIFT with the Rescale rule: one forward of the paired batch
    [x] * T + [baseline] * T under ``ops.guided.deeplift`` and one backward;
    the attributions are (x - baseline) * grad. Non-ReLU nonlinearities (the
    b=2 scales outside explanation mode) keep their ordinary gradients.
    With ``explanation_mode=True`` every other op is linear, so the
    attributions sum to f(x) - f(baseline) when ReLU is the only
    nonlinearity. Default baseline: zeros."""

    def __init__(self, model, device=None, baseline=None, explanation_mode=None, **config):
        super().__init__(model, device, **config)
        self.baseline = baseline
        if explanation_mode is not None:
            self.explanation_mode = explanation_mode

    def attribute_selection(self, img, targets):
        img = self._input(img)
        t = _targets(targets, self.device)
        if self.baseline is None:
            baseline = torch.zeros_like(img)
        else:
            baseline = _as_tensor(self.baseline, self.device).to(img.dtype).broadcast_to(
                img.shape)
        n = len(t)
        pair = torch.cat([_copies(img, n), _copies(baseline, n)]).requires_grad_(True)
        with torch.enable_grad():
            with guided.deeplift():
                out = self._apply(pair)
        ct = torch.zeros_like(out)
        ct[torch.arange(n, device=self.device), t] = 1
        (g,) = torch.autograd.grad(out, pair, grad_outputs=ct)
        return g[:n] * (img - baseline)[0]


class IntGrad(ExplainerBase):
    """Integrated gradients from a zero baseline: the mean of the gradients
    at alpha = (s + 0.5) / n_steps, times the input."""

    def __init__(self, model, device=None, n_steps: int = 20, **config):
        super().__init__(model, device, **config)
        self.n_steps = n_steps

    def attribute_selection(self, img, targets):
        img = self._input(img)
        t = _targets(targets, self.device)
        total = None
        for s in range(self.n_steps):
            alpha = torch.tensor((s + 0.5) / self.n_steps, dtype=torch.float32)
            g = _input_grads(self._apply, img * alpha.to(self.device, img.dtype), t)
            total = g if total is None else total + g
        return total / self.n_steps * img[0]


class GradCam(ExplainerBase):
    """GradCam for classifier-before-GAP models: ``feature_fn(x)`` gives the
    feature map [1, h, w, c], ``classifier_fn(fmap)`` the per-location
    logits [1, h, w, classes]. The map is upsampled to the input's size
    (bilinear) and divided evenly over the channels."""

    def __init__(self, model, device=None, feature_fn=None, classifier_fn=None, **config):
        super().__init__(model, device, **config)
        self.feature_fn = feature_fn
        self.classifier_fn = classifier_fn

    def attribute_selection(self, img, targets):
        assert self.feature_fn is not None and self.classifier_fn is not None, (
            "GradCam needs feature_fn(x)->fmap and classifier_fn(fmap)->logits-"
            "per-location (the classifier-before-GAP split, resnet.py:452-472)"
        )
        img = self._input(img)
        t = _targets(targets, self.device)
        with torch.no_grad():
            fmap = self.feature_fn(img)  # [1, h, w, c]
        fm = _copies(fmap, len(t)).requires_grad_(True)
        with torch.enable_grad():
            logits = self.classifier_fn(fm)  # [T, h, w, classes]
            idx = t.view(-1, 1, 1, 1).expand(*logits.shape[:3], 1)
            score = logits.gather(-1, idx).mean(dim=(1, 2, 3)).sum()
        (g,) = torch.autograd.grad(score, fm)
        weights = g.mean(dim=(1, 2), keepdim=True)
        cams = torch.relu((weights * fmap).sum(-1))  # [T, h, w]
        h, w, c = img.shape[1:]
        return _per_channel(bilinear_upsample(cams, (h, w)), c)


class Occlusion(ExplainerBase):
    """Sliding-window occlusion: the drop of each target's logit when a
    patch is zeroed, averaged over the windows that cover each pixel. The
    occluded copies of each batch are made on the device."""

    def __init__(self, model, device=None, patch_size: int = 16, stride: Optional[int] = None,
                 batch: int = 64, **config):
        super().__init__(model, device, **config)
        self.patch_size = patch_size
        self.stride = stride or patch_size
        self.batch = batch

    def attribute_selection(self, img, targets):
        img = self._input(img)
        t = _targets(targets, self.device)
        H, W, C = img.shape[1:]
        ps, st = self.patch_size, self.stride
        ys = torch.arange(0, H - ps + 1, st, device=self.device)
        xs = torch.arange(0, W - ps + 1, st, device=self.device)
        wy = ys.repeat_interleave(len(xs))  # the windows, row by row
        wx = xs.repeat(len(ys))
        rows = torch.arange(H, device=self.device)
        cols = torch.arange(W, device=self.device)
        outs = []
        with torch.no_grad():
            base = self._apply(img)[0].float()
            for i in range(0, len(wy), self.batch):
                by, bx = wy[i:i + self.batch, None], wx[i:i + self.batch, None]
                in_y = (rows >= by) & (rows < by + ps)  # [b, H]
                in_x = (cols >= bx) & (cols < bx + ps)  # [b, W]
                occluded = _copies(img, len(by)).masked_fill(
                    (in_y[:, :, None] & in_x[:, None, :])[..., None], 0.0)
                outs.append(self.model(occluded, train=False).float())
        outs = torch.cat(outs)  # [n_windows, classes]
        drop = (base[t][:, None] - outs[:, t].t()).reshape(len(t), 1, len(ys), len(xs))
        ones = torch.ones((1, 1, ps, ps), device=self.device)
        # overlap-add of each window's drop over its patch, and the cover count
        amap = F.conv_transpose2d(drop, ones, stride=st)[:, 0]
        counts = F.conv_transpose2d(torch.ones_like(drop[:1]), ones, stride=st)[:, 0]
        pad = (0, W - amap.shape[-1], 0, H - amap.shape[-2])
        amap, counts = F.pad(amap, pad), F.pad(counts, pad)
        return _per_channel(amap / counts.clamp_min(1), C)


class Rise(ExplainerBase):
    """RISE: the mean of each target's logit over random smooth masks times
    the masks, over p. The masks are the JAX package's (its numpy draws):
    an s x s grid of Bernoulli(p) cells upsampled bilinearly to
    (s + 1) * ceil(H / s), then cropped at a random offset."""

    def __init__(self, model, device=None, n_masks: int = 500, cell_size: int = 7,
                 p: float = 0.5, batch: int = 64, seed: int = 0, **config):
        super().__init__(model, device, **config)
        self.n_masks = n_masks
        self.cell_size = cell_size
        self.p = p
        self.batch = batch
        self.seed = seed

    def _masks(self, H: int, W: int) -> torch.Tensor:
        rng = np.random.default_rng(self.seed)
        s = self.cell_size
        grid = (rng.random((self.n_masks, s, s)) < self.p).astype(np.float32)
        ch, cw = int(np.ceil(H / s)), int(np.ceil(W / s))
        up = bilinear_upsample(torch.from_numpy(grid).to(self.device),
                               ((s + 1) * ch, (s + 1) * cw))
        masks = torch.empty((self.n_masks, H, W), device=self.device)
        for i in range(self.n_masks):
            oy, ox = rng.integers(0, ch), rng.integers(0, cw)
            masks[i] = up[i, oy:oy + H, ox:ox + W]
        return masks

    def attribute_selection(self, img, targets):
        img = self._input(img)
        t = _targets(targets, self.device)
        H, W, C = img.shape[1:]
        masks = self._masks(H, W)
        outs = []
        with torch.no_grad():
            for i in range(0, self.n_masks, self.batch):
                m = masks[i:i + self.batch, :, :, None]
                outs.append(self.model(img * m.to(img.dtype), train=False).float())
        outs = torch.cat(outs)  # [n_masks, classes]
        amap = outs[:, t].t() @ masks.reshape(self.n_masks, -1)
        amap = amap.reshape(len(t), H, W) / self.n_masks / self.p
        return _per_channel(amap, C)


class Lime(ExplainerBase):
    """LIME over square segments: a linear surrogate (ridge regression,
    weighted by the kept fraction) fit to random segment on/off
    perturbations; the 6-channel inputs are handled as they are."""

    def __init__(self, model, device=None, n_samples: int = 200, cell_size: int = 8,
                 batch: int = 64, seed: int = 0, **config):
        super().__init__(model, device, **config)
        self.n_samples = n_samples
        self.cell_size = cell_size
        self.batch = batch
        self.seed = seed

    def attribute_selection(self, img, targets):
        img = self._input(img)
        t = _targets(targets, self.device)
        H, W, C = img.shape[1:]
        s = self.cell_size
        gh, gw = int(np.ceil(H / s)), int(np.ceil(W / s))
        n_seg = gh * gw
        rng = np.random.default_rng(self.seed)
        Z = rng.integers(0, 2, (self.n_samples, n_seg)).astype(np.float32)
        Z[0] = 1.0  # include the full image
        seg_map = np.arange(n_seg).reshape(gh, gw)
        seg_map = np.kron(seg_map, np.ones((s, s), int))[:H, :W]

        z_dev = torch.from_numpy(Z).to(self.device)
        seg = torch.from_numpy(seg_map).to(self.device)
        outs = []
        with torch.no_grad():
            for i in range(0, self.n_samples, self.batch):
                m = z_dev[i:i + self.batch][:, seg]  # [b, H, W]
                outs.append(self.model(img * m[..., None].to(img.dtype), train=False).float())
        outs = torch.cat(outs)[:, t].cpu().numpy()  # [n_samples, T]

        # weighted ridge regression (cosine kernel on the fraction kept), in
        # the JAX package's numpy arithmetic; the solve in float64 on the device
        frac = Z.mean(1)
        w = np.exp(-((1 - frac) ** 2) / 0.25)
        ZW = Z * w[:, None]
        A = ZW.T @ Z + 1e-3 * np.eye(n_seg)
        rhs = np.stack([ZW.T @ outs[:, k] for k in range(outs.shape[1])], axis=1)
        beta = torch.linalg.solve(torch.from_numpy(A).to(self.device),
                                  torch.from_numpy(rhs).to(self.device, torch.float64))
        amap = beta.t()[:, seg].float()  # [T, H, W]
        return _per_channel(amap, C)
