"""Linear-probe metric.

Parity target: `CLIP_benchmark/clip_benchmark/metrics/
linear_probe.py`: a `Featurizer` with the B-cos fallback (models without
encode_image are called directly; 3D attn-unpool features mean-pooled over
locations, then L2-normalised, :35-54), feature caching to `feature_root`,
an AdamW + cosine-LR linear head (:68-116, warmup length hardcoded to 0),
the OpenAI-style weight-decay sweep over a 97-point log grid with halving
refinement (:137-148, :279-291), fewshot_k subsampling with the
insufficient-data bailout (:225-244), and the reference's full result-key
set with the `target.max() >= 5` acc5 gate (:295-315).

The protocol is the JAX package's (locked against the reference by
tests/test_linear_probe_parity.py), with the same deliberate deviations: the
head starts from zeros instead of torch's seeded kaiming-uniform, and the
fewshot / minibatch permutations use numpy's seeded generator where the
reference draws from torch's (unseeded at that point) global RNG. The head
trains on ``torch.optim.AdamW`` with optax.adamw's arithmetic (the lr set
by hand before each step, counted from 0 as optax's ``count`` is), in fp32
with TF32 off, on the device the caller names (default the GPU).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from bcosification_tpu_torch.clip_benchmark.models import features_numpy
from bcosification_tpu_torch.device import resolve_device

__all__ = [
    "cosine_lr",
    "featurize",
    "train_linear_head",
    "find_peak",
    "reference_wd_grid",
    "openai_wd_sweep",
    "evaluate",
]


def cosine_lr(base_lr: float, warmup_length: float, steps: int):
    """Per-step LR, numerically exact vs the reference's `cosine_lr`
    (linear_probe.py:16-32): linear warmup to base_lr over warmup_length
    steps, then a raw cosine from base_lr to 0 (no floor)."""

    def lr(step):
        if warmup_length and step < warmup_length:
            return base_lr * (step + 1) / warmup_length
        e = step - warmup_length
        es = steps - warmup_length
        return 0.5 * (1 + np.cos(np.pi * e / es)) * base_lr

    return lr


def featurize(model_bundle, loader, cache_path: Optional[str] = None,
              normalize: bool = True):
    """Encode + cache features (reference Featurizer :35-54 + the caching
    loop :163-221): attn-unpool features are mean-pooled over locations
    BEFORE the optional L2 normalisation."""
    if cache_path and Path(cache_path + "_x.npy").exists():
        return np.load(cache_path + "_x.npy"), np.load(cache_path + "_y.npy")
    xs, ys = [], []
    for batch in loader:
        images, target = batch if isinstance(batch, (tuple, list)) else (
            batch["image"],
            batch["label"],
        )
        feats = features_numpy(model_bundle.encode_image(model_bundle.images(images)))
        if feats.ndim == 3:  # attn-unpool [B, HW, D] -> mean over locations
            feats = feats.mean(axis=1)
        if normalize:
            feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        xs.append(feats)
        ys.append(np.asarray(target))
    x, y = np.concatenate(xs), np.concatenate(ys)
    if cache_path:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        np.save(cache_path + "_x.npy", x)
        np.save(cache_path + "_y.npy", y)
    return x, y


@contextlib.contextmanager
def _fp32_matmuls():
    """TF32 off for CUDA matmuls while it lasts (restored after)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def train_linear_head(
    x: np.ndarray,
    y: np.ndarray,
    num_classes: int,
    lr: float = 0.1,
    epochs: int = 10,
    batch_size: int = 256,
    weight_decay: float = 0.0,
    seed: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AdamW (torch defaults: betas 0.9/0.999, eps 1e-8, decoupled wd) with
    the reference's zero-warmup cosine schedule over epochs*len(loader)
    steps (linear_probe.py:68-116). -> (w [D, C], b [C]) on ``device``."""
    dev = resolve_device(device)
    n, d = x.shape
    # ceil like the reference's DataLoader (drop_last=False): the trailing
    # partial minibatch trains too and counts toward the schedule length
    steps_per_epoch = max(-(-n // batch_size), 1)
    total = epochs * steps_per_epoch

    w = torch.zeros((d, num_classes), dtype=torch.float32, device=dev, requires_grad=True)
    b = torch.zeros((num_classes,), dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    rng = np.random.default_rng(seed)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    yt = torch.as_tensor(np.asarray(y)).to(dev).long()
    count = 0  # optax's schedule count: 0 at the first step
    with _fp32_matmuls():
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(steps_per_epoch):
                idx = torch.as_tensor(order[i * batch_size : (i + 1) * batch_size]).to(dev)
                opt.param_groups[0]["lr"] = 0.5 * (1 + math.cos(math.pi * count / total)) * lr
                loss = F.cross_entropy(xt[idx] @ w + b, yt[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                count += 1
    return w.detach(), b.detach()


def _head_logits(w, b, x) -> np.ndarray:
    with torch.no_grad(), _fp32_matmuls():
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(w.device)
        return (xt @ w + b).cpu().numpy()


def _acc1(logits: np.ndarray, y: np.ndarray) -> float:
    return float((logits.argmax(-1) == y).mean())


def reference_wd_grid() -> Tuple[List[float], List[int]]:
    """The OpenAI-sweep grid (linear_probe.py:279-283): 97 log-spaced decays
    in [1e-6, 1e2] and the indices of the 7-point coarse subset, computed by
    float membership exactly as the reference does."""
    wd_list = np.logspace(-6, 2, num=97).tolist()
    wd_list_init = np.logspace(-6, 2, num=7).tolist()
    return wd_list, [i for i, v in enumerate(wd_list) if v in wd_list_init]


def find_peak(
    wd_list: Sequence[float],
    idxs: Sequence[int],
    x_train, y_train, x_val, y_val,
    num_classes: int,
    lr: float,
    epochs: int,
    batch_size: int,
    seed: int,
    verbose: bool = False,
    device=None,
) -> int:
    """Best wd INDEX among candidates by validation acc1 (linear_probe.py:
    137-148; strict `max_acc < acc` keeps the earliest index on ties, and an
    all-zero landscape returns index 0)."""
    best_wd_idx, max_acc = 0, 0.0
    for idx in idxs:
        w, b = train_linear_head(
            x_train, y_train, num_classes, lr=lr, epochs=epochs,
            batch_size=batch_size, weight_decay=wd_list[idx], seed=seed, device=device,
        )
        acc = _acc1(_head_logits(w, b, x_val), y_val)
        if verbose:
            print(f"Valid accuracy with weight_decay {wd_list[idx]}: {acc}")
        if max_acc < acc:
            best_wd_idx, max_acc = idx, acc
    return best_wd_idx


def openai_wd_sweep(
    x_train, y_train, x_val, y_val, num_classes,
    lr, epochs, batch_size, seed, verbose=False, device=None,
) -> float:
    """The OpenAI-style hyperparameter sweep (linear_probe.py:279-291,
    citing arxiv 2103.00020 A.3): coarse 7-point pass over the 97-point log
    grid, then halving refinement with step spans 8, 4, 2, 1 around the
    running peak."""
    wd_list, init_idxs = reference_wd_grid()
    peak_idx = find_peak(
        wd_list, init_idxs, x_train, y_train, x_val, y_val, num_classes,
        lr, epochs, batch_size, seed, verbose, device,
    )
    step_span = 8
    while step_span > 0:
        left = max(peak_idx - step_span, 0)
        right = min(peak_idx + step_span, len(wd_list) - 1)
        peak_idx = find_peak(
            wd_list, [left, peak_idx, right], x_train, y_train, x_val,
            y_val, num_classes, lr, epochs, batch_size, seed, verbose, device,
        )
        step_span //= 2
    return wd_list[peak_idx]


def evaluate(
    model_bundle,
    train_loader,
    test_loader,
    fewshot_k: int = -1,
    fewshot_lr: float = 0.1,
    fewshot_epochs: int = 10,
    batch_size: int = 256,
    feature_root: str = "features",
    model_id: str = "model",
    dataset_name: str = "dataset",
    seed: int = 0,
    val_loader=None,
    normalize: bool = True,
    verbose: bool = False,
    device=None,
) -> Optional[Dict[str, float]]:
    """Full reference protocol (linear_probe.py:151-315): featurize+cache,
    fewshot subsample, optional 97-point wd sweep with halving refinement
    when a validation split exists (final head then trains on train+val),
    reference result keys. The heads train on ``device`` (default the
    GPU)."""
    tag = "_norm" if normalize else "_raw"
    cache = os.path.join(feature_root, f"{model_id}_{dataset_name}{tag}")
    x_train, y_train = featurize(model_bundle, train_loader, cache + "_train", normalize)
    x_test, y_test = featurize(model_bundle, test_loader, cache + "_test", normalize)
    x_val = y_val = None
    if val_loader is not None:
        x_val, y_val = featurize(model_bundle, val_loader, cache + "_val", normalize)
    # reference :266: output dim from the FULL pre-fewshot TRAIN targets only
    # (a test-only higher class id is never predictable, exactly as there)
    num_classes = int(y_train.max()) + 1

    if fewshot_k > 0:
        # reference :227-244: one permutation over all samples, first k per
        # class in encounter order; bail out if any class is short
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(y_train))
        counts: Dict[int, int] = {}
        keep = []
        for p in perm:
            t = int(y_train[p])
            counts.setdefault(t, 0)
            if counts[t] < fewshot_k:
                counts[t] += 1
                keep.append(p)
        if any(c != fewshot_k for c in counts.values()):
            print("insufficient data for this eval")
            return None
        keep = np.asarray(keep)
        x_train, y_train = x_train[keep], y_train[keep]

    if x_val is not None:
        best_wd = openai_wd_sweep(
            x_train, y_train, x_val, y_val, num_classes,
            fewshot_lr, fewshot_epochs, batch_size, seed, verbose, device,
        )
        x_fit = np.concatenate([x_train, x_val])
        y_fit = np.concatenate([y_train, y_val])
    else:
        best_wd = 0.0
        x_fit, y_fit = x_train, y_train

    w, b = train_linear_head(
        x_fit, y_fit, num_classes, lr=fewshot_lr, epochs=fewshot_epochs,
        batch_size=batch_size, weight_decay=best_wd, seed=seed, device=device,
    )
    logits = _head_logits(w, b, x_test)
    pred = logits.argmax(-1)
    if y_test.max() >= 5:  # reference :298: gate on the max class id seen
        accs = [
            float((np.argsort(-logits, axis=-1)[:, :k] == y_test[:, None]).any(-1).mean())
            for k in (1, 5)
        ]
        acc1, acc5 = accs
    else:
        acc1, acc5 = _acc1(logits, y_test), float("nan")
    from bcosification_tpu_torch.clip_benchmark.metrics.zeroshot_classification import mean_per_class_recall

    return {
        "lp_acc1": acc1,
        "lp_acc5": acc5,
        "lp_mean_per_class_recall": mean_per_class_recall(logits, y_test),
        "weight_decay": best_wd,
        "epochs": fewshot_epochs,
        "seed": seed,
        "fewshot_k": fewshot_k,
        "normalized": normalize,
    }
