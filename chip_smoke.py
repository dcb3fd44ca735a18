#!/usr/bin/env python3
"""Drive the PyTorch port (bcosification_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from ops/cuda/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version at six
   main-path shapes, in fp32 (TF32 off; max |diff| <= 1e-5 max |ref|) and
   bf16 (against the plain version in fp32 on the same rounded inputs;
   ||diff|| <= 1e-2 ||ref||); then (after phase 6, whose streaming rate it
   uses) each kernel's time at every shape one main-path call gives it,
   with its achieved TFLOP/s and GB/s, beside its bound (at the data-sheet
   and at the measured memory rate), its plain version and torch.matmul on
   the same GEMM, and each kernel's time per call beside its earlier
   record (PREVIOUS_MS); K3 is checked with both eps_outside values, also
   at five shapes of the train step (TRAIN_CHECK_SHAPES);
4. parity: the full-width B-cosified ResNet-50 (224x224, gamma-calibrated),
   fp32, 2 images: the fast forward + explanation on the GPU (kernels)
   against the same call on the CPU (plain versions; W within 1e-3, the
   pre-logit features within 1e-4, identical argmax), and the module path
   (autograd through the kernels) against the fast path (1e-4);
5. throughput: batch 128, 224x224, bf16: forward + explanation and
   forward-only images/s, each over one window of calls in a row, with the
   kernel launch counts of one call each (and, for comparison with the
   older records, the median of 10 single calls);
6. probe: K4, the streaming add, against its plain version bit for bit at
   [401408, 256] bf16, then the probe's entry point
   (probes/stream_bandwidth.measure): K4's and PyTorch's a + b + c time and
   rate beside the 3.35 TB/s data-sheet rate;
7. serving: the calibrated net exported (serving.export_forward and
   .export_explain), saved to bytes and loaded back; at batch 128, bf16 the
   loaded programs against the eager calls (argmax identical, logits and W
   within 1e-6 relative: the same ops and kernels on the same inputs), their
   launch counts, forward-only, forward + explanation and a mixed loop in
   which 1 batch in 10 is explained, beside the harmonic model of the two
   and the eager calls timed the same way; then explain() on one image
   (RGBA finite, in [0, 1]);
8. train: the supervised recipe (scripts/bench_train.py: Adam 1e-4 with the
   90-epoch cosine, AGC, UniformOffLabels BCE, EMA, bf16 AMP) on the
   calibrated net at batch 64, 224x224: Trainer.fit for one epoch of 20
   steps on one repeated batch made from a seed (initial validation,
   validation, EMA validation, one checkpoint in a temporary directory),
   then a resume from that checkpoint for one step. It prints the loss per
   5 steps (finite, falling), K3's launches per train step (34: every
   stride-1 1x1 conv), the step's ms and img/s over a window of 10 steps in
   a row after a warm-up step, the host's issue time per step and the peak
   memory; then K3's time at each shape of one train step beside its bound;
   then one fp32 train step of the small flagship on the GPU against the
   same step on the CPU (loss, every gradient, the BN running_var), and its
   bf16 amp gradient on the GPU against the fp32 one on the CPU (every leaf,
   also as a ratio to the CPU amp gradient's own distance from it);
9. entry points: a synthetic ImageNet-layout JPEG tree made from a seed
   (data/synthetic.py: 10 classes, 704 train and 128 val JPEGs of 500x375
   at quality 90) with IMAGENET_PATH pointing at it; the resnet_50
   Experiment's train loader alone (img/s, the host's CPU count, its
   workers); the host-to-card copy of one batch; Trainer.fit for one epoch
   (bf16 amp) fed by that loader, its img/s beside phase 8's repeated-batch
   rate and K3's launches per step; then, in-process, ``train
   --fast_dev_run`` (resuming from the fit's checkpoint), ``evaluate
   --reload last`` (its top-1/top-5 equal to the val_acc1/val_acc5 logged
   for the same weights) and ``evaluate --reload fresh``, with K1's and
   K3's launches per eval batch; then the eval-mode input gradient without
   explain (fault C1's route: the 1x1 convs unfused, K3 and cuDNN) of the
   calibrated full-width net in fp32, GPU against CPU, within ten times
   the CPU's own spread under 1e-7 relative input noise, and phase 5's
   launch counts again;
10. DenseNet-121 (the densenet_121 recipe; growth 32, blocks 6/12/24/16,
   random init from SEED, gamma-calibrated), on the same JPEG tree: K3 and
   K2 against their plain versions at six of its shapes in both dtypes
   (phase 3's bounds), then timed at all 62 shapes of one forward (K3) and
   one explanation (K2) beside their bounds, plain versions and
   torch.matmul; fp32 parity on 2 images of the hand-scheduled pass
   (explain/fast_densenet.py), GPU against CPU (W within ten times the
   CPU's own spread under 1e-7 relative input noise, pre-logits 1e-4,
   argmax identical), and the generic autograd W against it (1e-4);
   forward-only and fwd+explain images/s at batch 128, bf16, over windows
   of about 1.7 s, with their launch counts (K3 62 / K2 0 / K1 0 and K3 62
   / K2 62 / K1 0), host issue time and peak memory; the forward and the
   explanation programs exported, loaded from bytes and held to the eager
   calls (fault C3); Trainer.fit of the Experiment at batch 64, bf16 amp, on one
   repeated batch (a falling loss, K3 62 launches per step, the step's
   img/s, host ms and peak memory); then ``train --fast_dev_run``
   resuming from it and ``evaluate --reload last`` equal to the logged
   accuracies;
11. CLIP-RN50 (the clip_bcosification recipe's student, pooled and
   attn-unpool; widths 64 / 2048, 32 heads, embed_dim 1024, random init
   from SEED, gamma-calibrated), on the same JPEG tree: K1, K2 and K3
   against their plain versions at six CLIP shapes in both dtypes (phase
   3's bounds; at the c_proj shape K2 and K3 with the linear norm,
   eps_outside); per head, fp32 parity on 2 images of the text-grounded
   explanation (explain/fast_clip.py), GPU against CPU (scores 1e-4; W as
   phase 10 holds it) and the module's autograd against it (scores 1e-4, W
   ten times the CPU's spread: the module runs K3 and the BN apart); the
   encode and the text fwd+explain images/s at batch 128, bf16, with their
   launch counts (encode: K3 36, +1 unpooled; explanation: K1 36, K2 36,
   +1 K2 and +1 K3 unpooled), host issue time and peak memory; the pooled
   tower's text explanation and forward exported, loaded from bytes and
   held to the eager calls; the zero-shot classifier of a random-init text
   tower over 1000 classes x 80 templates in bf16 (tokenize and tower
   timed), 8 classes in fp32 against the CPU (1e-4), and
   ``zeroshot_evaluate`` of both heads over the tree's val split; then
   each kernel's time at every shape of one attn-unpool encode (K3) and
   text explanation (K1, K2, K3) beside its bound.

Every time is taken over runs of calls in a row between two CUDA events, so
the host's launch of one call overlaps the card's work on the one before:
a kernel's time is the median of 10 runs of 10 launches, a whole-model rate
is the images of one window of about 1.7 s over its time. No bf16 operand
of a ResNet-50, DenseNet-121 or CLIP-RN50 path needs the TMA padding
(``tma_operands.padded`` stays 0).
The last three lines are the card, one JSON object with the kernels'
numbers, and {"ok": true, "device": {...}}.
Without a GPU, or without the repository next to it, the script exits
non-zero and prints no result.
"""
import collections
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

from bcosification_tpu_torch import evaluate as evaluate_cli
from bcosification_tpu_torch import serving, settings
from bcosification_tpu_torch import train as train_cli
from bcosification_tpu_torch.data.synthetic import write_imagenet_tree
from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
from bcosification_tpu_torch.losses import (
    BinaryCrossEntropyLoss,
    UniformOffLabelsBCEWithLogitsLoss,
)
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
from bcosification_tpu_torch.training import steps as steps_lib
from bcosification_tpu_torch.training import zeroshot
from bcosification_tpu_torch.training.trainer import Trainer
from bcosification_tpu_torch.bcosify.clip_import import build_clip_text
from bcosification_tpu_torch.bcosify.engine import build_bcosified_densenet, build_bcosified_resnet
from bcosification_tpu_torch.clip.model import ModifiedResNet, clip_rn50_config
from bcosification_tpu_torch.clip.tokenizer import tokenize
from bcosification_tpu_torch.data.imagenet import imagenet_classes, imagenet_templates
from bcosification_tpu_torch.explain import fast_clip, fast_densenet
from bcosification_tpu_torch.explain.core import dynamic_linear_weights, explain
from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights
from bcosification_tpu_torch.models import resnet
from bcosification_tpu_torch.models.densenet import BcosDenseNet
from bcosification_tpu_torch.models.resnet import Bottleneck
from bcosification_tpu_torch.modules import BcosConv2d, ReLU
from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS
from bcosification_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3
from bcosification_tpu_torch.ops.cuda import stream as k4
from bcosification_tpu_torch.probes import stream_bandwidth

FLAGSHIP = {
    "name": "resnet50",
    "bcosify_args": {"fix_b": True, "use_bias": False, "norm_layer": "BnUncV2",
                     "gap": True, "act_layer": True},
    "bcos_args": {"b": 2},
}
BATCH, SIZE, SEED = 128, 224, 0
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SOURCES = {
    "bcos_conv1x1_fwd": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_conv1x1_fwd.cu",
                         "bcosification_tpu/ops/pallas/bcos_conv1x1.py:85"),
    "bcos_conv1x1_bwd_explain": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_conv1x1_bwd.cu",
                                 "bcosification_tpu/ops/pallas/bcos_conv1x1.py:124"),
    "bcos_matmul_fwd": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_matmul_fwd.cu",
                        "bcosification_tpu/ops/pallas/bcos_matmul.py:45"),
    "stream_add": ("bcosification_tpu_torch/ops/cuda/csrc/stream_add.cu",
                   "scripts/perf_probe9.py:22"),
}
MODEL_KERNELS = ("bcos_conv1x1_fwd", "bcos_conv1x1_bwd_explain", "bcos_matmul_fwd")
PROBE_M, PROBE_C, PROBE_NIN = 401408, 256, 3  # the layer1 activation at batch 128
SERVE_EVERY = 10  # the mixed loop explains 1 batch in SERVE_EVERY
# calls per timing window: each window holds about 1.7 s of the card's work
# on an H100 at batch 128 (23 ms forward, 42 ms fwd+explain, 237 ms period)
WINDOW_FWD, WINDOW_EXPLAIN, WINDOW_PERIODS = 72, 40, 7
CHECK_SHAPES = [  # (label, M, Cin, Cout, relu) at batch 128, 224x224
    ("layer1.conv1", 401408, 256, 64, True),
    ("layer1.conv3", 401408, 64, 256, False),
    ("layer3.conv3", 25088, 256, 1024, False),
    ("layer4.conv3", 6272, 512, 2048, False),
    ("layer4.downsample(s2)", 6272, 1024, 2048, False),
    ("classifier", 6272, 2048, 1000, False),
    # DenseNet-121's conv1 widths (phase 10): Cout 128 beside a deep Cin
    ("densenet b1.l6.conv1", 401408, 224, 128, True),
    ("densenet b3.l24.conv1", 25088, 992, 128, True),
]
# K3's train-step shapes at batch 64, 224x224 (label, M, K, N): N = 64 is
# below one 128-wide tile, K = 64 one K step of the engine
TRAIN_CHECK_SHAPES = [
    ("train layer1.conv1", 200704, 64, 64),
    ("train layer1.conv3", 200704, 64, 256),
    ("train layer4.conv1", 3136, 2048, 512),
    ("train layer4.conv3", 3136, 512, 2048),
    ("train classifier", 3136, 2048, 1000),
]
# each kernel's earlier ms per fwd+explain call (PERF.md; NVIDIA H100 80GB
# HBM3, 700.00 W), timed by the same method as time_kernels
PREVIOUS_MS = {"bcos_conv1x1_fwd": ("PR 3", 5.32), "bcos_conv1x1_bwd_explain": ("PR 3", 7.61),
               "bcos_matmul_fwd": ("PR 3", 0.507)}
CARD = ""


def say(*parts):
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# 1-2: device and build
# --------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    _build.load()
    say(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


# --------------------------------------------------------------------------
# 3: kernels
# --------------------------------------------------------------------------
def operands(m, k, n, dtype, gen):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    wt = (torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)).to(dtype)
    mult = torch.rand(n, device="cuda", generator=gen) + 0.5
    add = 0.1 * torch.randn(n, device="cuda", generator=gen)
    ct = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    return x, wt, mult, add, ct


def kernel_calls(name, x, wt, mult, add, ct, relu, eps_outside=False):
    """(kernel call, plain call, torch.matmul call) for one launch's work;
    ``eps_outside``: a B-cos linear's (the linear norm, no BN's mult)."""
    if name == "bcos_conv1x1_fwd":
        return (lambda: k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                lambda: k12.conv1x1_fwd_plain(x, wt, mult, add, relu=relu),
                lambda: torch.matmul(x, wt.t()))
    eps = LINEAR_NORM_EPS if eps_outside else 1e-6
    if name == "bcos_conv1x1_bwd_explain":
        a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
        mu = None if eps_outside else mult
        kw = dict(relu=relu, eps=eps, eps_outside=eps_outside)
        return (lambda: k12.conv1x1_bwd_explain(x, wt, ct, a, mu, **kw),
                lambda: k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mu, **kw),
                lambda: torch.matmul(torch.matmul(x, wt.t()), wt))
    return (lambda: k3.bcos_matmul_fwd(x, wt, eps=eps, eps_outside=eps_outside),
            lambda: k3.bcos_matmul_fwd_plain(x, wt, eps=eps, eps_outside=eps_outside),
            lambda: torch.matmul(x, wt.t()))


def _check(worst, name, variant, label, dtype, got, want):
    """Hold one kernel result against its plain version (see phase 3)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        err, bound = float(diff.max() / want.abs().max()), 1e-5
    else:
        err, bound = float((got - want).norm() / want.norm()), 1e-2
    worst[name] = max(worst[name], float(diff.max()))
    ok = err <= bound and bool(torch.isfinite(got).all())
    say(f"check {name + variant:28s} {label:22s} {str(dtype)[6:]:8s} "
        f"rel err {err:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {label}")


def _k3_results(x, wt, ref):
    return [("bcos_matmul_fwd", " eps_outside" if eps_outside else "",
             k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside),
             k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=eps_outside))
            for eps_outside in (False, True)]


def check_kernels():
    """Each kernel against its plain version at the six check shapes, both
    dtypes (K3 with both eps_outside values), and K3 also at the train
    step's shapes. Returns {kernel: max abs error over all checks}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {name: 0.0 for name in MODEL_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu in CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
            results = [  # (kernel, variant, kernel's result, plain version's)
                ("bcos_conv1x1_fwd", "", k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                 k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)),
                ("bcos_conv1x1_bwd_explain", "",
                 k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), ref(a), mult,
                                               relu=relu)),
            ] + _k3_results(x, wt, ref)
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results
        for label, m, k, n in TRAIN_CHECK_SHAPES:
            x, wt, *_ = operands(m, k, n, dtype, gen)
            results = _k3_results(x, wt, ref)
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, results
    return worst


def conv1x1_shapes(model, batch, size):
    """([(M, K, N, relu, stride)] of the trunk's 1x1 convs in forward order:
    conv1, conv3 and the downsample of each bottleneck; (M, K, N) of the
    classifier) at this batch and input size."""
    s = ((size + 6 - 7) // 2 + 1 + 2 - 3) // 2 + 1  # 7x7/s2/p3 conv, 3x3/s2/p1 pool
    convs = []
    for stage, j, planes, stride, has_ds in model.block_cfgs():
        cin = model.block_in(stage, j)
        s_out = (s - 1) // stride + 1
        convs += [(batch * s * s, cin, planes, True, 1),
                  (batch * s_out * s_out, planes, 4 * planes, False, 1)]
        if has_ds:
            convs.append((batch * s_out * s_out, cin, 4 * planes, False, stride))
        s = s_out
    return convs, (batch * s * s, model.block_in(len(model.layers), 0), model.num_classes)


def main_path_launches(model, batch, size):
    """[(kernel, M, K, N, relu)] for every kernel launch of one fast
    forward + explanation call at this batch and input size."""
    convs, (m, k, n) = conv1x1_shapes(model, batch, size)
    launches = []
    for cm, ck, cn, relu, _ in convs:
        launches += [("bcos_conv1x1_fwd", cm, ck, cn, relu),
                     ("bcos_conv1x1_bwd_explain", cm, ck, cn, relu)]
    return launches + [("bcos_matmul_fwd", m, k, n, False),
                       ("bcos_conv1x1_bwd_explain", m, k, n, False)]


def bound_terms(name, m, k, n, relu):
    """(FLOPs, bytes) of the least work one launch must do in bf16: each
    input read once, each output written once."""
    e = 2  # bytes per bf16 element
    if name == "bcos_conv1x1_fwd":
        flops, nbytes = 2 * m * k * n, e * (m * k + n * k + m * n) + 8 * n
    elif name == "bcos_conv1x1_bwd_explain":
        # u = x wt^T recomputed, then dx = g wt: two GEMMs of the same size
        flops = 4 * m * k * n
        nbytes = e * (2 * m * k + n * k + m * n * (2 if relu else 1)) + 4 * n
    else:
        flops, nbytes = 2 * m * k * n, e * (m * k + n * k) + 4 * m * n
    return flops, nbytes


def time_shapes(per_shape, stream_rate, gen, tag=""):
    """{kernel: row} over ``per_shape`` {(kernel, M, K, N, relu[,
    eps_outside]): launches}:
    each distinct shape timed in bf16 as the median of 10 samples of 10
    launches in a row (the plain version 3 samples of 3), weighted by its
    launches. A row sums ms, plain_ms, library_ms (torch.matmul), the bound
    at the data-sheet rate (bound_s, split into flop_s and byte_s by what
    binds) and at ``stream_rate`` (bytes/s, K4's measured rate on this card)."""
    rows = {}
    for (name, m, k, n, relu, *linear), count in sorted(per_shape.items()):
        x, wt, mult, add, ct = operands(m, k, n, torch.bfloat16, gen)
        kern, plain, lib = kernel_calls(name, x, wt, mult, add, ct, relu, any(linear))
        t_k = stream_bandwidth.event_ms(kern, 10)
        t_p = stream_bandwidth.event_ms(plain, 3, warmup=1, burst=3)
        t_l = stream_bandwidth.event_ms(lib, 10)
        flops, nbytes = bound_terms(name, m, k, n, relu)
        f_s, b_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        r = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flop_s=0.0,
                                       byte_s=0.0, bound_s=0.0, measured_bound_s=0.0))
        r["ms"] += count * t_k
        r["plain_ms"] += count * t_p
        r["library_ms"] += count * t_l
        r["bound_s"] += count * max(f_s, b_s)
        r["measured_bound_s"] += count * max(f_s, b_s * PEAK_BYTES / stream_rate)
        r["flop_s" if f_s >= b_s else "byte_s"] += count * max(f_s, b_s)
        label = name + (" linear" if any(linear) else "")
        say(f"time {tag}{label:26s} M={m:6d} K={k:4d} N={n:4d} x{count:2d}: {t_k:.4f} ms, "
            f"{flops / t_k / 1e9:.1f} TFLOP/s, {nbytes / t_k / 1e6:.1f} GB/s "
            f"(bound {1e3 * max(f_s, b_s):.4f} ms by {'FLOPs' if f_s >= b_s else 'bytes'}, "
            f"{1e3 * max(f_s, b_s * PEAK_BYTES / stream_rate):.4f} ms at the measured rate; "
            f"plain {t_p:.4f}, torch.matmul {t_l:.4f}) [{CARD}]")
        del x, wt, ct
    return rows


def time_kernels(model, worst, counts, stream_rate):
    """Per kernel: time, bound, plain and torch.matmul time of ONE main-path
    call's launches (bf16, batch 128; ``time_shapes``)."""
    per_shape = collections.Counter(main_path_launches(model, BATCH, SIZE))
    for name in MODEL_KERNELS:
        expected = sum(c for key, c in per_shape.items() if key[0] == name)
        if counts.get(name) != expected:
            raise AssertionError(f"{name}: {counts.get(name)} launches, shapes list {expected}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = time_shapes(per_shape, stream_rate, gen)
    kernels = []
    for name in MODEL_KERNELS:
        r = rows[name]
        pr, before = PREVIOUS_MS[name]
        say(f"{name} per call: {r['ms']:.4f} ms ({pr}: {before:g} ms); bound "
            f"{1e3 * r['bound_s']:.4f} ms at the 3350 GB/s data sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured "
            f"{stream_rate / 1e9:.1f} GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms [{CARD}]")
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": worst[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": 1e3 * r["bound_s"],
            "bound_by": "operations" if r["flop_s"] >= r["byte_s"] else "bytes",
            "library_ms": r["library_ms"],
        })
    return kernels


# --------------------------------------------------------------------------
# 4: full-width parity
# --------------------------------------------------------------------------
def _output_rms(net, probe, module, transform=None):
    """RMS of ``module``'s output (or of transform(output)) in net(probe)."""
    seen = []
    hook = module.register_forward_hook(
        lambda mod, args, out: seen.append(out if transform is None else transform(out)))
    try:
        with torch.no_grad():
            net(probe)
    finally:
        hook.remove()
    return float(seen[0].double().pow(2).mean().sqrt())


def calibration_steps(m):
    """[(BN, module, transform)] of ``calibrate`` in forward order: each BN
    gamma is divided by the RMS of ``module``'s output (or transform(it))."""
    if isinstance(m, ModifiedResNet):  # CLIP: every norm runs apart from its conv
        steps = [(bn, bn, None) for _, bn, _, _ in m.stem()]
        for blk in m.blocks():
            steps += [(blk.bn1, blk.bn1, None), (blk.bn2, blk.bn2, None),
                      (blk.bn3, blk.bn3, None)]
            if blk.has_downsample:
                steps.append((blk.downsample_norm, blk.downsample_norm, None))
        return steps
    if isinstance(m, BcosDenseNet):
        # pre-activation: each norm's gamma scales the conv after it (b=2
        # convs are homogeneous of degree 1), and a concat keeps the older
        # features as they are, so only the new ones are rescaled
        steps = [(m.norm0, m.norm0, None)]
        for i in range(len(m.block_config)):
            for layer in m.dense_layers(i):
                steps += [(layer.norm1, layer.conv1, None), (layer.norm2, layer.conv2, None)]
            if m.transition(i) is not None:
                steps.append((m.transition(i).norm, m.transition(i).conv, None))
        return steps + [(m.norm5, m.classifier, None)]
    steps = [(m.bn1, m.bn1, None)]
    for blk in m.blocks():
        if isinstance(blk, Bottleneck):
            def y3(c2, blk=blk):  # conv3's segment without the skip-add and ReLU
                mult, add = blk.bn3(None, return_affine=True)
                return blk.conv3(c2, explain=True, epilogue=(mult, add, False))

            steps += [(blk.bn1, blk.conv1, None), (blk.bn2, blk.bn2, None),
                      (blk.bn3, blk.act2, y3)]
        else:  # BasicBlock: both 3x3 norms run unfolded
            steps += [(blk.bn1, blk.bn1, None), (blk.bn2, blk.bn2, None)]
        if hasattr(blk, "downsample_norm"):
            steps.append((blk.downsample_norm, blk.downsample_conv, None))
    return steps


def calibrate(net, probe):
    """Scale each BN gamma, in forward order, so that its segment's output
    (ResNet), the conv after it (DenseNet) or the norm's own output (CLIP)
    has RMS 1 on ``probe``: a random-init b=2 net contracts to ~1e-20 and
    makes every comparison vacuous. A uniform factor on all gammas does not
    work at full depth: the early layers overflow before the output reaches
    O(1). Returns the pre-logit magnitude (a CLIP tower's feature
    magnitude) afterwards."""
    bias = net.logit_bias if net.with_logit_layer else 0.0
    with torch.no_grad():
        for bn, module, transform in calibration_steps(net.model):
            bn.weight.div_(_output_rms(net, probe, module, transform))
        mag = float((net(probe).double() - bias).abs().max())
    if not 1e-4 < mag < 1e4:
        raise AssertionError(f"gamma calibration failed: pre-logit magnitude {mag}")
    return mag


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def phase_parity(net, x2):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    cpu_net = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast_dynamic_linear_weights(cpu_net, x2.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    # the conditioning: how far fp32-rounding-sized input noise moves W on the CPU
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED))
    _, _, wn = fast_dynamic_linear_weights(cpu_net, x2.cpu() * (1 + 1e-7 * noise),
                                           device="cpu")
    say(f"parity W on the cpu under 1e-7 relative input noise: {rel(wn, wc):.3e}")
    bias = net.logit_bias
    pre_err = float(((lg.double().cpu() - bias) - (lc.double() - bias)).abs().max()
                    / (lc.double() - bias).abs().max())
    # (value, bound). Across devices every conv sums in another order, and
    # at full depth W is ill-conditioned in those roundings: on the CPU alone
    # a 1e-7 relative input perturbation moves W by ~6e-5 (PERF.md), so the
    # GPU-vs-CPU bound on W is 1e-3. Within one device the two paths share
    # their convs and are held to 1e-4.
    checks = {
        "W gpu-kernels vs cpu-plain": (rel(wg, wc), 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 1e-4),
        "pre-logit gpu vs cpu (max rel)": (pre_err, 1e-4),
        "pre-logit module vs fast (max rel)": (float(
            (lm.double() - lg.double()).abs().max() / (lg.double() - bias).abs().max()), 1e-4),
    }
    for key, (val, bound) in checks.items():
        say(f"parity {key}: {val:.3e} (bound {bound:.0e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all())
    say(f"parity argmax identical: {same_sel}; cpu plain pass took {cpu_s:.1f} s")
    if not same_sel or any(val > bound for val, bound in checks.values()):
        raise AssertionError("full-width parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError("full-width outputs are not finite or mis-shaped")


# --------------------------------------------------------------------------
# 5: throughput
# --------------------------------------------------------------------------
EXPLAIN_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 37,
                  "bcos_matmul_fwd": 1, "stream_add": 0}
FORWARD_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 0,
                  "bcos_matmul_fwd": 1, "stream_add": 0}


def check_counts(what, counts, expected):
    if counts != expected:
        raise AssertionError(f"{what} launches {counts}, expected {expected}")


def window_ms(fn, calls, warmup=1):
    """Milliseconds per call of ``calls`` calls of ``fn`` in a row between
    two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def timed_iters(fn, iters):
    """(median, all) CUDA-event ms of ``iters`` single calls, and the median
    host ms to issue one call (the Python call's return, before the card
    finishes): while it stays below the card's time, the launches' host
    cost, custom-op dispatch included, is hidden."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times, statistics.median(host)


def phase_throughput(net, x2):
    """bf16 batch of 128 whose first two images are x2 (rounded to bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    x = x.to(torch.bfloat16)

    def explain_call():
        return fast_dynamic_linear_weights(net, x)

    def forward_call():
        with torch.no_grad():
            return net(x)

    explain_call()
    torch.cuda.synchronize()
    reset_launch_counts()
    logits, sel, w = explain_call()
    torch.cuda.synchronize()
    counts_explain = launch_counts()
    reset_launch_counts()
    forward_call()
    torch.cuda.synchronize()
    counts_forward = launch_counts()
    say(f"launches per fwd+explain call: {counts_explain}; per forward: {counts_forward}")
    check_counts("fwd+explain", counts_explain, EXPLAIN_COUNTS)
    check_counts("forward", counts_forward, FORWARD_COUNTS)
    if not (torch.isfinite(logits).all() and torch.isfinite(w).all()) or w.shape != x.shape:
        raise AssertionError("bf16 outputs are not finite or mis-shaped")
    # bf16 against fp32 on the same (rounded) two images, for the record: at
    # full depth W is ill-conditioned in the roundings (see phase_parity), so
    # bf16 rounding moves it far more than fp32 rounding does
    l_ref, _, w_ref = fast_dynamic_linear_weights(net, x[:2].float())
    pre = (logits[:2].double() - net.logit_bias, l_ref.double() - net.logit_bias)
    say(f"bf16 vs fp32 on the first two images: W rel {rel(w[:2].float(), w_ref):.3e}, "
        f"pre-logit max rel {float((pre[0] - pre[1]).abs().max() / pre[1].abs().max()):.3e}")
    torch.cuda.reset_peak_memory_stats()
    ms_explain = window_ms(explain_call, WINDOW_EXPLAIN)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_forward = window_ms(forward_call, WINDOW_FWD)
    single_explain, all_explain, host_explain = timed_iters(explain_call, 10)
    single_forward, all_forward, host_forward = timed_iters(forward_call, 10)
    say(f"throughput fwd+explain: {BATCH / ms_explain * 1e3:.1f} img/s "
        f"({ms_explain:.2f} ms per batch of {BATCH}, one window of {WINDOW_EXPLAIN} calls; "
        f"peak memory {peak_gb:.1f} GB; the host issues one call in {host_explain:.2f} ms; "
        f"median of 10 single calls {BATCH / single_explain * 1e3:.1f} img/s, spread "
        f"{min(all_explain):.2f}-{max(all_explain):.2f} ms) [{CARD}]")
    say(f"throughput forward-only: {BATCH / ms_forward * 1e3:.1f} img/s "
        f"({ms_forward:.2f} ms per batch, one window of {WINDOW_FWD} calls; host "
        f"{host_forward:.2f} ms; median of 10 single calls "
        f"{BATCH / single_forward * 1e3:.1f} img/s, spread {min(all_forward):.2f}-"
        f"{max(all_forward):.2f} ms) [{CARD}]")
    return counts_explain, ms_explain


# --------------------------------------------------------------------------
# 6: the streaming-bandwidth probe (K4)
# --------------------------------------------------------------------------
def phase_probe():
    """K4 against its plain version, bit for bit, at the probe's shape and a
    ragged one; then the probe's own entry point, with K4's launches counted
    over that run. Returns K4's row of the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for shape in ((PROBE_M, PROBE_C), (1001, 7)):
        xs = [torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(PROBE_NIN)]
        got, want = k4.stream_add(*xs), k4.stream_add_plain(*xs)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        say(f"check stream_add {shape} bf16 bit-for-bit against the plain version: "
            f"{'ok' if same else 'FAILED'}")
        if not same:
            raise AssertionError("stream_add disagrees with its plain version")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        del xs, got, want
    reset_launch_counts()
    r = stream_bandwidth.measure(PROBE_M, PROBE_C, 20, nin=PROBE_NIN, seed=SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["stream_add"] < 1 or any(counts[k] for k in MODEL_KERNELS):
        raise AssertionError(f"probe launches {counts}: K4 alone expected")
    bound_ms = r["k4_bytes"] / PEAK_BYTES * 1e3
    say(f"probe [{PROBE_M}, {PROBE_C}] bf16, {PROBE_NIN} inputs: K4 {r['k4_ms']:.4f} ms = "
        f"{r['k4_gbs']:.1f} GB/s over its {r['k4_bytes'] / 1e6:.1f} MB "
        f"({r['k4_gbs'] / (PEAK_BYTES / 1e9):.1%} of the 3350 GB/s data-sheet rate; "
        f"bound {bound_ms:.4f} ms); torch a + b + c {r['torch_ms']:.4f} ms = "
        f"{r['torch_gbs']:.1f} GB/s over its {r['torch_bytes'] / 1e6:.1f} MB [{CARD}]")
    source, replaces = SOURCES["stream_add"]
    return {"name": "stream_add", "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts["stream_add"], "max_abs_err": worst, "ms": r["k4_ms"],
            "plain_ms": r["torch_ms"], "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}, r


# --------------------------------------------------------------------------
# 7: serving export
# --------------------------------------------------------------------------
def blend_rate(p, r_fwd, r_explain):
    """Images/s of a stream in which a fraction p is explained: the
    weighted harmonic mean of the two rates."""
    return 1.0 / ((1.0 - p) / r_fwd + p / r_explain)


def phase_serving(net, x2):
    """Exported forward and forward + explanation programs of the calibrated
    net, loaded from bytes, against the eager calls at batch 128, bf16."""
    t0 = time.perf_counter()
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16)
    blob_explain = serving.export_explain(net, input_size=SIZE, dtype=torch.bfloat16)
    fwd, expl = serving.load_serialized(blob_fwd), serving.load_serialized(blob_explain)
    say(f"serving: exported and loaded both programs in {time.perf_counter() - t0:.1f} s "
        f"({len(blob_fwd) / 1e6:.1f} MB and {len(blob_explain) / 1e6:.1f} MB)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    x = x.to(torch.bfloat16)

    reset_launch_counts()
    logits, sel, w = expl.call(x)
    torch.cuda.synchronize()
    check_counts("loaded fwd+explain", launch_counts(), EXPLAIN_COUNTS)
    reset_launch_counts()
    logits_f = fwd.call(x)
    torch.cuda.synchronize()
    check_counts("loaded forward", launch_counts(), FORWARD_COUNTS)
    le, se, we = fast_dynamic_linear_weights(net, x)
    with torch.no_grad():
        lf = net(x)
    bias = net.logit_bias
    checks = {  # (value, bound): the same ops and kernels on the same inputs
        "W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
        "pre-logit loaded vs eager fwd+explain (rel)": (rel(logits.double() - bias,
                                                            le.double() - bias), 1e-6),
        "pre-logit loaded vs eager forward (rel)": (rel(logits_f.double() - bias,
                                                        lf.double() - bias), 1e-6),
    }
    for key, (val, bound) in checks.items():
        say(f"serving {key}: {val:.3e} (bound {bound:.0e})")
    if not torch.equal(sel, se) or any(val > bound for val, bound in checks.values()):
        raise AssertionError("the loaded programs disagree with the eager calls")

    # every rate from one window of calls in a row, so that one call's host
    # work overlaps the card's work on the one before, as in a serving loop
    ms_fwd = window_ms(lambda: fwd.call(x), WINDOW_FWD)
    ms_explain = window_ms(lambda: expl.call(x), WINDOW_EXPLAIN)

    def mixed_period():  # one explained batch, then SERVE_EVERY - 1 forward-only
        expl.call(x)
        for _ in range(SERVE_EVERY - 1):
            fwd.call(x)

    # the window spans whole periods, so it holds exactly 1 explain in SERVE_EVERY
    ms_period = window_ms(mixed_period, WINDOW_PERIODS)
    host_fwd, host_explain = (timed_iters(lambda: fwd.call(x), 3)[2],
                              timed_iters(lambda: expl.call(x), 3)[2])
    r_fwd, r_explain = BATCH / ms_fwd * 1e3, BATCH / ms_explain * 1e3
    r_mixed = BATCH * SERVE_EVERY / ms_period * 1e3
    modeled = blend_rate(1.0 / SERVE_EVERY, r_fwd, r_explain)
    say(f"serving loaded forward-only: {r_fwd:.1f} img/s ({ms_fwd:.2f} ms per batch of "
        f"{BATCH}; one window of {WINDOW_FWD} calls; the host issues one call in "
        f"{host_fwd:.2f} ms) [{CARD}]")
    say(f"serving loaded fwd+explain: {r_explain:.1f} img/s ({ms_explain:.2f} ms; one "
        f"window of {WINDOW_EXPLAIN} calls; host {host_explain:.2f} ms) [{CARD}]")
    say(f"serving mixed loop, 1 batch in {SERVE_EVERY} explained: {r_mixed:.1f} img/s "
        f"(one window of {WINDOW_PERIODS} periods, {ms_period:.2f} ms per period); harmonic "
        f"model {modeled:.1f} img/s; measured / model - 1 = {r_mixed / modeled - 1:+.4f} "
        f"[{CARD}]")
    with torch.no_grad():
        ms_fwd_eager = window_ms(lambda: net(x), WINDOW_FWD)
    ms_explain_eager = window_ms(lambda: fast_dynamic_linear_weights(net, x), WINDOW_EXPLAIN)
    say(f"serving eager, timed the same way: forward-only {BATCH / ms_fwd_eager * 1e3:.1f} "
        f"img/s ({ms_fwd_eager:.2f} ms), fwd+explain {BATCH / ms_explain_eager * 1e3:.1f} "
        f"img/s ({ms_explain_eager:.2f} ms) [{CARD}]")

    one = explain(net, x[:1])
    rgba = one["explanation"]
    if (tuple(rgba.shape) != (SIZE, SIZE, 4) or not torch.isfinite(rgba).all()
            or float(rgba.min()) < 0 or float(rgba.max()) > 1):
        raise AssertionError("explain(): the RGBA explanation is not finite in [0, 1]")
    say(f"explain() on one image: prediction {one['prediction']}, RGBA {tuple(rgba.shape)} "
        f"in [{float(rgba.min()):.3g}, {float(rgba.max()):.3g}], finite")


# --------------------------------------------------------------------------
# 8: training
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WINDOW = 64, 20, 10
TRAIN_EMA_STEPS = 10  # the recipe updates every 32 steps; 10 updates twice in 20
# one train step: K3 on every stride-1 1x1 conv (conv1 and conv3 of the 16
# bottlenecks, layer1's downsample, the classifier), no K1 or K2 (the
# batch-statistics BN folds into no affine; explain is off)
TRAIN_STEP_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                     "bcos_matmul_fwd": 34, "stream_add": 0}
# bounds of one fp32 train step of the small flagship, GPU against CPU, and
# of its bf16 amp gradient on the GPU against the fp32 gradient on the CPU.
# This net's gradients are sensitive to bf16 rounding: on the CPU the port's
# amp gradient lies 0.30 from its fp32 one (worst leaf), the JAX package's
# 0.32. Planted bf16-only faults in the backward (K3's dw halved, K3's dx
# without its row term and factor 2) read 0.52 and 0.92 on the worst leaf
# and 39x on the ratio to the CPU amp gradient's own distance.
TRAIN_PARITY_BOUNDS = {"loss": 1e-5, "gradient": 1e-4, "running_var": 1e-5,
                       "bf16 gradient": 0.45, "bf16 gradient / cpu bf16 spread": 2.0}


def k3_shapes(model, batch, size):
    """[(module name, M, K, N)] of every conv that ``ops.bcos.bcos_conv2d``
    sends to K3 (a bias-free b=2 1x1 at stride 1) in one forward of the
    backbone ``model`` at this batch and input size, in forward order: read
    from the convs' inputs in one forward at batch 1 (forward hooks), so it
    holds for any family. Its K3 launches are not counted by any caller."""
    names = {mod: name for name, mod in model.named_modules()}
    seen = []

    def hook(mod, args, out):
        if (mod.kernel_size == (1, 1) and mod.stride == (1, 1) and mod.padding == (0, 0)
                and mod.groups == 1 and mod.max_out == 1 and mod.bias is None and mod.b == 2):
            _, h, w, k = args[0].shape
            seen.append((names[mod], batch * h * w, k, mod.weight.shape[0]))

    convs = [mod for mod in model.modules() if isinstance(mod, BcosConv2d)]
    handles = [mod.register_forward_hook(hook) for mod in convs]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, convs[0].in_channels),
                              device=convs[0].weight.device))
    finally:
        for handle in handles:
            handle.remove()
    return seen


def train_k3_launches(model, batch, size):
    """[("bcos_matmul_fwd", M, K, N, False)] of every K3 launch of one train
    step: each stride-1 1x1 conv and the classifier (``k3_shapes``)."""
    return [("bcos_matmul_fwd", m, k, n, False) for _, m, k, n in k3_shapes(model, batch, size)]


def time_train_k3(model, stream_rate):
    """K3's time over one train step's launches (bf16, batch 64;
    ``time_shapes``)."""
    per_shape = collections.Counter(train_k3_launches(model, TRAIN_BATCH, SIZE))
    if sum(per_shape.values()) != TRAIN_STEP_COUNTS["bcos_matmul_fwd"]:
        raise AssertionError(f"the train shapes list {sum(per_shape.values())} K3 launches")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    row = time_shapes(per_shape, stream_rate, gen, tag="train ")["bcos_matmul_fwd"]
    say(f"bcos_matmul_fwd per train step ({sum(per_shape.values())} launches): "
        f"{row['ms']:.4f} ms; bound {1e3 * row['bound_s']:.4f} ms at the data-sheet rate, "
        f"{1e3 * row['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
        f"plain {row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} ms [{CARD}]")
    return row


def device_profile(fn, calls, top=8):
    """(card ms per call, [(kernel, ms per call)] of the ``top`` largest):
    the sum of the card's kernel time over ``calls`` calls of ``fn``, from a
    torch.profiler trace; (None, []) if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()]
    total = sum(ms for _, ms in rows)
    return (total or None), sorted(rows, key=lambda r: -r[1])[:top]


class RepeatedBatch:
    """In-script data module: one batch on the card, ``steps`` times per
    epoch; validation sees it once."""

    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps
        self.batch_size = batch["image"].shape[0]

    def setup(self, stage=None):
        pass

    def train_dataloader(self, seed=0):
        return _RepeatedLoader(self.batch, self.steps)

    def val_dataloader(self):
        return [self.batch]


class _RepeatedLoader:
    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps

    def __iter__(self):
        return iter([self.batch] * self.steps)

    def __len__(self):
        return self.steps

    def set_epoch(self, epoch):
        pass


class RecordedLoss:
    """The train criterion, keeping each step's loss (on the card)."""

    def __init__(self, criterion):
        self.criterion, self.losses = criterion, []

    def __call__(self, out, target):
        loss = self.criterion(out, target)
        self.losses.append(loss.detach())
        return loss


def train_experiment(save_dir, criterion):
    """The resnet_50 recipe (ImageNet/bcosification experiment_parameters)
    plus the EMA of scripts/bench_train.py, one epoch long."""
    return types.SimpleNamespace(save_dir=Path(save_dir), config=dict(
        criterion=criterion, test_criterion=BinaryCrossEntropyLoss(),
        optimizer=OptimizerFactory("Adam", 1e-4, bcosify=True, b_opt=False),
        lr_scheduler=LRSchedulerFactory("cosineannealinglr", epochs=90),
        trainer=dict(max_epochs=1), use_agc=True,
        ema={"decay": 0.9998, "steps": TRAIN_EMA_STEPS}, model={}))


def _raw_grads(model, criterion, batch, amp):
    """{name: gradient in f64 on the CPU} of one train-mode backward of a
    copy of ``model`` (the image in bf16 under amp)."""
    m = copy.deepcopy(model)
    image = batch["image"].to(torch.bfloat16) if amp else batch["image"]
    criterion(m(image, train=True).float(), batch["label"]).backward()
    return {n: p.grad.double().cpu() for n, p in m.named_parameters()}


def train_step_parity(net, batch):
    """One fp32 train step of ``net`` (AGC, Adam with the cosine, EMA) on the
    GPU against the same step of a CPU copy on the same batch, and the bf16
    amp gradient on the GPU against the fp32 one on the CPU: {check: (value,
    bound)} for the loss, the worst gradient leaf (||d||/||ref||, the raw
    gradients of one backward), the BN running_var after the step, the worst
    bf16 leaf, and the worst leaf's ratio of that distance to the CPU bf16
    gradient's own (the spread bf16 rounding alone makes).

    A leaf whose fp32 CPU gradient is zero up to rounding (below 1e-6 of the
    largest leaf's norm: the DenseNet's norm0 gamma, whose per-channel scale
    every train-mode BN after it divides out again) is measured against the
    largest leaf's norm instead of its own, and has no bf16 ratio (a ratio
    of two rounding noises)."""
    recipe = train_experiment(".", UniformOffLabelsBCEWithLogitsLoss()).config
    schedule = recipe["lr_scheduler"].create(1e-4, steps_per_epoch=10)
    results = []
    for dev in ("cuda", "cpu"):
        state = steps_lib.create_train_state(net, recipe["optimizer"].create, with_ema=True,
                                             device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        grads = _raw_grads(state.model, recipe["criterion"], b, amp=False)
        grads_bf16 = _raw_grads(state.model, recipe["criterion"], b, amp=True)
        step = steps_lib.make_train_step(recipe["criterion"], schedule, use_agc=True,
                                         ema_decay=0.9, ema_steps=1)
        state, metrics = step(state, b)
        rv = torch.cat([buf.double().cpu() for n, buf in state.model.named_buffers()
                        if n.endswith("running_var")])
        results.append((float(metrics["loss"]), grads, grads_bf16, rv))
    (loss_g, grads_g, bf16_g, rv_g), (loss_c, grads_c, bf16_c, rv_c) = results
    top = max(float(g.norm()) for g in grads_c.values())
    noise = {n for n, g in grads_c.items() if float(g.norm()) < 1e-6 * top}

    def leaf(got, n):
        return float((got[n] - grads_c[n]).norm()) / (top if n in noise else
                                                      float(grads_c[n].norm()))

    signal = [n for n in grads_c if n not in noise]
    return {"loss": (abs(loss_g - loss_c) / abs(loss_c), TRAIN_PARITY_BOUNDS["loss"]),
            "gradient": (max(leaf(grads_g, n) for n in grads_c),
                         TRAIN_PARITY_BOUNDS["gradient"]),
            "running_var": (rel(rv_g, rv_c), TRAIN_PARITY_BOUNDS["running_var"]),
            "bf16 gradient": (max(leaf(bf16_g, n) for n in grads_c),
                              TRAIN_PARITY_BOUNDS["bf16 gradient"]),
            "bf16 gradient / cpu bf16 spread": (
                max(leaf(bf16_g, n) / leaf(bf16_c, n) for n in signal),
                TRAIN_PARITY_BOUNDS["bf16 gradient / cpu bf16 spread"])}


def phase_train(net, stream_rate):
    """Trainer.fit, resume, the timed window and the fp32 GPU-vs-CPU step.
    Returns K3's train-step numbers for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    image = torch.rand((TRAIN_BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    batch = {"image": torch.cat([image, 1.0 - image], dim=-1),
             "label": torch.randint(0, net.num_classes, (TRAIN_BATCH,), device="cuda",
                                    generator=gen)}
    data = RepeatedBatch(batch, TRAIN_STEPS)
    criterion = RecordedLoss(UniformOffLabelsBCEWithLogitsLoss())
    with tempfile.TemporaryDirectory() as tmp:
        exp = train_experiment(tmp, criterion)
        t0 = time.perf_counter()
        reset_launch_counts()
        trainer = Trainer(exp, {"amp": True})
        state = trainer.fit(net, data)
        torch.cuda.synchronize()
        counts = launch_counts()
        fit_s = time.perf_counter() - t0
        evals = 3  # the initial, the epoch's and the EMA validation: one forward each
        want = {"bcos_conv1x1_fwd": 36 * evals, "bcos_conv1x1_bwd_explain": 0,
                "bcos_matmul_fwd": 34 * TRAIN_STEPS + evals, "stream_add": 0}
        say(f"train: Trainer.fit of {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, bf16 amp, took "
            f"{fit_s:.1f} s; launches {counts}")
        check_counts("Trainer.fit", counts, want)
        losses = [float(v) for v in criterion.losses]
        say("train loss per 5 steps: " + ", ".join(
            f"step {i}: {losses[i]:.6f}" for i in range(0, len(losses), 5))
            + f", step {len(losses) - 1}: {losses[-1]:.6f}")
        history = trainer.metrics.history
        say(f"train metrics: {json.dumps({k: v for k, v in history.items()})}")
        if (len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses)
                or not sum(losses[-5:]) < sum(losses[:5])):
            raise AssertionError(f"train losses are not finite and falling: {losses}")
        if state.step != TRAIN_STEPS or trainer.ckpt.available_checkpoints() != [0]:
            raise AssertionError("fit did not take its steps or save its checkpoint")

        resumed = Trainer(exp, {"amp": True}).fit(net, data, max_epochs=2, fast_dev_run=True)
        if resumed.step != TRAIN_STEPS + 1 or trainer.ckpt.available_checkpoints() != [0, 1]:
            raise AssertionError(f"resume: step {resumed.step}, checkpoints "
                                 f"{trainer.ckpt.available_checkpoints()}")
        say(f"train: resumed from epoch 0 for one step (step {resumed.step}); checkpoints "
            f"{trainer.ckpt.available_checkpoints()}")

    step = steps_lib.make_train_step(criterion, 1e-4, use_agc=True, ema_decay=0.99,
                                     ema_steps=32, amp=True)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    step(state, batch)
    torch.cuda.synchronize()
    per_step = launch_counts()
    say(f"train: launches per train step {per_step}")
    check_counts("train step", per_step, TRAIN_STEP_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_WINDOW):
        t0 = time.perf_counter()
        step(state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_WINDOW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"train step: {TRAIN_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per step of "
        f"{TRAIN_BATCH}, one window of {TRAIN_WINDOW} steps; the host issues a step in "
        f"{statistics.median(host):.2f} ms (median; {min(host):.2f}-{max(host):.2f}); peak "
        f"memory {peak_gb:.1f} GB) [{CARD}]")
    step_img_s = TRAIN_BATCH / ms * 1e3
    busy, top = device_profile(lambda: step(state, batch), 3)
    if busy is None:
        say("train step: the profiler trace holds no device time; card time not measured")
    else:
        say(f"train step: the card is busy {busy:.2f} of {ms:.2f} ms per step (idle share "
            f"{1 - busy / ms:.1%}; torch.profiler over 3 steps) [{CARD}]")
        for name, kms in top:
            say(f"train step card time: {kms:8.3f} ms per step  {name[:110]}")
    if not all(math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError("parameters are not finite after training")
    del state, resumed

    row = time_train_k3(net.model, stream_rate)
    row["launches"] = per_step["bcos_matmul_fwd"]
    row["step_img_s"] = step_img_s

    small = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10,
                                   inplanes=8, layers=("bottleneck", (1, 1)), seed=SEED)
    image = torch.rand((4, 32, 32, 3), device="cuda", generator=gen)
    image = torch.cat([image, 1.0 - image], dim=-1)
    calibrate(small, image[:1])
    checks = train_step_parity(small, {"image": image, "label": torch.tensor(
        [1, 3, 5, 7], device="cuda")})
    for key, (val, bound) in checks.items():
        say(f"train parity small flagship gpu vs cpu fp32, {key}: {val:.3e} (bound {bound:g})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the train step on the GPU disagrees with the CPU")
    return row


# --------------------------------------------------------------------------
# 9: the entry points, fed from JPEGs
# --------------------------------------------------------------------------
ENTRY_CLASSES, ENTRY_TRAIN, ENTRY_VAL = 10, 704, 128  # 11 train batches of 64, 2 val
ENTRY_EXPERIMENT = ("ImageNet", "bcosification", "resnet_50")
# per eval batch of the ResNet-50: K1 on every 1x1 conv of the trunk, K3 on
# the classifier
EVAL_BATCH_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 0,
                     "bcos_matmul_fwd": 1, "stream_add": 0}
# the eval-mode gradient without explain (fault C1's route): no K1; K3 on
# the 34 stride-1 1x1 convs; the 36 eligible convs run unfused
EVAL_GRADIENT_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                        "bcos_matmul_fwd": 34, "stream_add": 0}


def scaled_counts(counts, k, plus=None):
    out = {name: k * v for name, v in counts.items()}
    for name, v in (plus or {}).items():
        out[name] += v
    return out


def eval_gradients(net, x, weights=False):
    """{"x": the input gradient[, parameter name: its gradient]} (f64 on
    the CPU) of sum(logits * c), c a cotangent made from SEED, for
    net(x, train=False) without explain: the gradient the IxG and Grad
    explainers take. The net is copied, so its own weights stay frozen."""
    m = copy.deepcopy(net).requires_grad_(weights)
    xx = x.detach().clone().requires_grad_(True)
    out = m(xx, train=False)
    c = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED)).to(out.device)
    out.backward(c.to(out.dtype))
    grads = {"x": xx.grad.double().cpu()}
    if weights:
        grads.update({n: p.grad.double().cpu() for n, p in m.named_parameters()})
    return grads


class TimedLoader:
    """A train loader that records when its epoch's iteration starts and
    when it ends, after the card has finished the last step's work."""

    def __init__(self, loader):
        self.loader, self.spans = loader, []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        t0 = time.perf_counter()
        n = 0
        for batch in self.loader:
            n += len(batch["label"])
            yield batch
        torch.cuda.synchronize()
        self.spans.append((n, time.perf_counter() - t0))


class TimedData:
    """The data module, with its train loader timed (``TimedLoader``)."""

    def __init__(self, datamodule):
        self.datamodule, self.loader = datamodule, None
        self.batch_size = datamodule.batch_size

    def setup(self, stage=None):
        self.datamodule.setup(stage)

    def train_dataloader(self, seed=0):
        self.loader = TimedLoader(self.datamodule.train_dataloader(seed=seed))
        return self.loader

    def val_dataloader(self):
        return self.datamodule.val_dataloader()


def copy_ms(batch, calls=5):
    """ms of one host-to-card copy of the batch's image array (pageable
    memory), over ``calls`` copies in a row."""
    image = torch.from_numpy(batch["image"])
    image.to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        image.to("cuda")
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls, image.numel() * image.element_size()


@contextlib.contextmanager
def synthetic_imagenet():
    """A synthetic ImageNet-layout JPEG tree in a temporary directory (see
    the module docstring, phase 9), with IMAGENET_PATH and the experiment
    root pointing into it while the context lasts; yields the experiment
    root."""
    old_paths = (settings.IMAGENET_PATH, settings.EXPERIMENT_ROOT, os.environ.get("IMAGENET_PATH"))
    with tempfile.TemporaryDirectory() as tmp:
        data_root, exp_root = Path(tmp) / "imagenet", Path(tmp) / "experiments"
        t0 = time.perf_counter()
        write_imagenet_tree(data_root, ENTRY_CLASSES, ENTRY_TRAIN, ENTRY_VAL, seed=SEED)
        say(f"entry: wrote {ENTRY_TRAIN} train and {ENTRY_VAL} val JPEGs (500x375, quality 90, "
            f"{ENTRY_CLASSES} classes) in {time.perf_counter() - t0:.1f} s")
        os.environ["IMAGENET_PATH"] = settings.IMAGENET_PATH = str(data_root)
        settings.EXPERIMENT_ROOT = str(exp_root)
        try:
            yield exp_root
        finally:
            settings.IMAGENET_PATH, settings.EXPERIMENT_ROOT, env = old_paths
            if env is None:
                os.environ.pop("IMAGENET_PATH", None)
            else:
                os.environ["IMAGENET_PATH"] = env


def phase_entry(net, x2, step_img_s, exp_root):
    """The train and evaluate entry points on the synthetic JPEG tree, then
    fault C1's route. Returns its numbers for the record."""
    out = _entry_runs(net, x2, step_img_s, exp_root)
    out.update(_c1_route(net, x2))
    return out


def _entry_runs(net, x2, step_img_s, exp_root):
    exp = Experiment(*ENTRY_EXPERIMENT)
    datamodule = exp.get_datamodule()
    datamodule.setup("fit")
    loader = datamodule.train_dataloader(seed=0)
    t0 = time.perf_counter()
    n, last = 0, None
    for last in loader:
        n += len(last["label"])
    loader_s = time.perf_counter() - t0
    if n != ENTRY_TRAIN or last["image"].shape != (64, SIZE, SIZE, 6):
        raise AssertionError(f"the train loader gave {n} images, last batch "
                             f"{last['image'].shape}")
    loader_img_s = n / loader_s
    say(f"entry loader alone: {loader_img_s:.1f} img/s ({n} images in {len(loader)} batches "
        f"of 64 in {loader_s:.2f} s; PIL decode in {datamodule.num_workers} threads on a host "
        f"with {os.cpu_count()} CPUs) [{CARD}]")
    ms_copy, nbytes = copy_ms(last)
    say(f"entry host-to-card copy of one batch ({nbytes / 1e6:.1f} MB float32, pageable): "
        f"{ms_copy:.2f} ms = {nbytes / ms_copy / 1e6:.1f} GB/s [{CARD}]")

    model = exp.get_model()
    calibrate(model, x2[:1])
    data = TimedData(datamodule)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(exp, {"amp": True})
    state = trainer.fit(model, data, max_epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    steps, val_batches = ENTRY_TRAIN // 64, -(-ENTRY_VAL // 64)
    evals = 2 * val_batches  # the initial and the epoch's validation
    check_counts("Trainer.fit from JPEGs", counts, scaled_counts(
        EVAL_BATCH_COUNTS, evals, {"bcos_matmul_fwd": TRAIN_STEP_COUNTS["bcos_matmul_fwd"]
                                   * steps}))
    (n_fit, train_s), = data.loader.spans
    fit_img_s = n_fit / train_s
    history = trainer.metrics.history
    say(f"entry Trainer.fit from JPEGs (bf16 amp, batch 64, {steps} steps): {fit_img_s:.1f} "
        f"img/s over the epoch's train loop ({train_s:.2f} s); phase 8's repeated batch on the "
        f"card: {step_img_s:.1f} img/s; fit with two validations and a checkpoint "
        f"{fit_s:.1f} s; K3 launches per train step "
        f"{(counts['bcos_matmul_fwd'] - evals) / steps:g}; launches {counts} [{CARD}]")
    say(f"entry fit metrics: {json.dumps(history)}")
    if state.step != steps or not math.isfinite(history["train_loss"][-1][1]):
        raise AssertionError(f"fit from JPEGs: step {state.step}, history {history}")
    del state, trainer, model

    cli_round_trip(ENTRY_EXPERIMENT, exp_root, EVAL_BATCH_COUNTS,
                   TRAIN_STEP_COUNTS["bcos_matmul_fwd"], ("last", "fresh"))
    return {"loader_img_s": loader_img_s, "fit_img_s": fit_img_s, "copy_ms": ms_copy}


def cli_round_trip(experiment, exp_root, eval_counts, train_step_k3, reloads, tag="entry"):
    """``train --fast_dev_run`` of ``experiment`` (resuming from the
    checkpoint of epoch 0 under ``exp_root``), then ``evaluate --reload``
    each of ``reloads``, with the launch counts of each (``eval_counts`` per
    eval batch, ``train_step_k3`` K3 launches per train step); the top-1 and
    top-5 of ``--reload last`` must equal the val_acc1/val_acc5 the train
    command logged."""
    exp = Experiment(*experiment)
    val_batches = -(-ENTRY_VAL // 64)
    base = ["--base_directory", str(exp_root)]
    reset_launch_counts()
    train_cli.main(["--dataset", experiment[0], "--base_network", experiment[1],
                    "--experiment_name", experiment[2], "--amp", "--fast_dev_run", *base])
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(f"{experiment[2]} train --fast_dev_run", counts, scaled_counts(
        eval_counts, val_batches, {"bcos_matmul_fwd": train_step_k3}))
    if exp.available_checkpoints() != [0, 1]:
        raise AssertionError(f"train --fast_dev_run: checkpoints {exp.available_checkpoints()}")
    logged = exp.load_metrics()
    want = (logged["val_acc1"][-1], logged["val_acc5"][-1])
    say(f"{tag} train --experiment_name {experiment[2]} --fast_dev_run: resumed from epoch 0, "
        f"one step, checkpoints {exp.available_checkpoints()}, logged val_acc1/val_acc5 at "
        f"epoch {want[0][0]}: {want[0][1]:.6f} / {want[1][1]:.6f}; launches {counts}")

    results = {}
    for reload in reloads:
        reset_launch_counts()
        t0 = time.perf_counter()
        top1, top5, (c1, c5, n) = evaluate_cli.main(
            ["--experiment_name", experiment[2], "--reload", reload, *base])
        torch.cuda.synchronize()
        counts = launch_counts()
        say(f"{tag} evaluate --reload {reload}: top-1 {top1:.6f} ({c1}/{n}), top-5 {top5:.6f} "
            f"({c5}/{n}) in {time.perf_counter() - t0:.1f} s; launches {counts}")
        check_counts(f"evaluate --reload {reload}", counts,
                     scaled_counts(eval_counts, val_batches))
        if n != ENTRY_VAL:
            raise AssertionError(f"evaluate --reload {reload} saw {n} images")
        results[reload] = (top1, top5)
    if results["last"] != (want[0][1], want[1][1]):
        raise AssertionError(f"evaluate --reload last {results['last']} differs from the "
                             f"logged {want}")
    say(f"{tag} evaluate --reload last equals the train command's logged "
        f"val_acc1/val_acc5: True")


def _c1_route(net, x2):
    """Fault C1's route at full width: the eval-mode input gradient without
    explain, GPU against CPU in fp32, bounded by ten times the CPU's own
    spread under 1e-7 relative input noise; then phase 5's counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    route = resnet._conv_bn_act.grad_route
    reset_launch_counts()
    got = eval_gradients(net, x2)["x"]
    torch.cuda.synchronize()
    counts = launch_counts()
    unfused = resnet._conv_bn_act.grad_route - route
    check_counts("eval-mode gradient", counts, EVAL_GRADIENT_COUNTS)
    if unfused != 36:
        raise AssertionError(f"eval-mode gradient: {unfused} convs took the unfused route")
    cpu_net = copy.deepcopy(net).to("cpu")
    want = eval_gradients(cpu_net, x2.cpu())["x"]
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 7))
    spread = rel(eval_gradients(cpu_net, x2.cpu() * (1 + 1e-7 * noise))["x"], want)
    err, bound = rel(got, want), 10 * spread
    say(f"entry C1 route: eval-mode input gradient without explain, fp32, 2 images, gpu vs cpu "
        f"{err:.3e} (bound {bound:.3e} = 10 x the cpu spread under 1e-7 relative input noise, "
        f"{spread:.3e}); {unfused} convs unfused; launches {counts}")
    if not err <= bound or not torch.isfinite(got).all():
        raise AssertionError("the eval-mode gradient on the GPU disagrees with the CPU")
    reset_launch_counts()
    fast_dynamic_linear_weights(net, x2)
    torch.cuda.synchronize()
    check_counts("fwd+explain after the gradient", launch_counts(), EXPLAIN_COUNTS)
    reset_launch_counts()
    with torch.no_grad():
        net(x2)
    torch.cuda.synchronize()
    check_counts("forward after the gradient", launch_counts(), FORWARD_COUNTS)
    say("entry phase 5's launch counts after the gradient: unchanged (36 / 37 / 1 and 36 / 0 / 1)")
    return {"c1_err": err, "c1_bound": bound}


# --------------------------------------------------------------------------
# 10: DenseNet-121
# --------------------------------------------------------------------------
DENSENET_EXPERIMENT = ("ImageNet", "bcosification", "densenet_121")
# (label, M, Cin, Cout, relu) at batch 128, 224x224: the first and the
# widest conv1 of block 1, transition 1, the deepest conv1 of block 3,
# transition 3 and the classifier. relu: K2 with the conv1's folded norm2 +
# act2 (mult and mask); otherwise K2 as K3's explanation backward (neither)
DENSENET_CHECK_SHAPES = [
    ("densenet b1.l1.conv1", 401408, 64, 128, True),
    ("densenet b1.l6.conv1", 401408, 224, 128, True),
    ("densenet transition1", 401408, 256, 128, False),
    ("densenet b3.l24.conv1", 25088, 992, 128, True),
    ("densenet transition3", 25088, 1024, 512, False),
    ("densenet classifier", 6272, 1024, 1000, False),
]
# one forward: K3 at the 62 1x1 convs (58 conv1s, 3 transitions, the
# classifier); the explanation adds K2 at each; no K1 (no norm is folded
# into a conv); a train step: K3 at the same 62
DENSENET_FORWARD_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                           "bcos_matmul_fwd": 62, "stream_add": 0}
DENSENET_EXPLAIN_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 62,
                           "bcos_matmul_fwd": 62, "stream_add": 0}
WINDOW_S = 1.7  # seconds of the card's work per timing window


def densenet_launches(model, batch, size):
    """[(kernel, M, K, N, relu)] of every kernel launch of one fast
    forward + explanation of the DenseNet (``explain/fast_densenet.py``):
    K3 at each 1x1 conv, K2 at each, with the mask where it folds a
    conv1's act2."""
    relu = isinstance(model.act0, ReLU)
    launches = []
    for name, m, k, n in k3_shapes(model, batch, size):
        launches += [("bcos_matmul_fwd", m, k, n, False),
                     ("bcos_conv1x1_bwd_explain", m, k, n, relu and name.endswith("conv1"))]
    return launches


def check_densenet_kernels(worst):
    """K3 and K2 against their plain versions at DENSENET_CHECK_SHAPES, in
    both dtypes with phase 3's bounds (K2 as the DenseNet pass calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu in DENSENET_CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            a = k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True) if relu else None
            mu = mult if relu else None
            results = [
                ("bcos_matmul_fwd", "", k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False),
                 k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=False)),
                ("bcos_conv1x1_bwd_explain", "", k12.conv1x1_bwd_explain(x, wt, ct, a, mu,
                                                                           relu=relu),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct),
                                               None if a is None else ref(a), mu, relu=relu)),
            ]
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results


def densenet_parity(net, x2):
    """fp32, 2 images: the fast pass on the GPU against the CPU, the pre-logit
    features within 1e-4 and the argmax identical; W with PyTorch's own CUDA
    convs in place of cuDNN's within ten times the CPU's own spread under
    1e-7 relative input noise, and W with cuDNN within phase 4's bound;
    then the generic autograd W on the GPU against the fast one (1e-4).

    Each cuDNN conv alone agrees with the CPU to 6e-7, yet through the 120
    layers' ReLU masks cuDNN's fp32 convs move W by ~240 times that spread,
    PyTorch's own by about one spread (PERF.md §6): the kernels and the
    pass are held with the latter."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast_densenet.fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    torch.backends.cudnn.enabled = False
    try:
        _, _, w_native = fast_densenet.fast_dynamic_linear_weights(net, x2)
    finally:
        torch.backends.cudnn.enabled = True
    cpu_net = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast_densenet.fast_dynamic_linear_weights(cpu_net, x2.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 9))
    _, _, wn = fast_densenet.fast_dynamic_linear_weights(
        cpu_net, x2.cpu() * (1 + 1e-7 * noise), device="cpu")
    spread = rel(wn, wc)
    bias = net.logit_bias
    err, err_native = rel(wg, wc), rel(w_native, wc)
    checks = {
        "W gpu-kernels (torch convs) vs cpu-plain": (err_native, 10 * spread),
        "W gpu-kernels (cudnn convs) vs cpu-plain": (err, 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 1e-4),
        "pre-logit gpu vs cpu (max rel)": (float(
            ((lg.double().cpu() - bias) - (lc.double() - bias)).abs().max()
            / (lc.double() - bias).abs().max()), 1e-4),
        "pre-logit module vs fast (max rel)": (float(
            (lm.double() - lg.double()).abs().max() / (lg.double() - bias).abs().max()), 1e-4),
    }
    say(f"densenet parity W on the cpu under 1e-7 relative input noise: {spread:.3e}; "
        f"gpu vs cpu {err_native:.3e} = {err_native / spread:.2f} x that spread with PyTorch's "
        f"CUDA convs, {err:.3e} = {err / spread:.2f} x with cuDNN's")
    for key, (val, bound) in checks.items():
        say(f"densenet parity {key}: {val:.3e} (bound {bound:.3e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all())
    say(f"densenet parity argmax identical: {same_sel}; cpu plain pass took {cpu_s:.1f} s")
    if not same_sel or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("DenseNet-121 parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError("DenseNet-121 outputs are not finite or mis-shaped")


def _batch128(x2, seed):
    """bf16 batch of 128 whose first two images are x2 (rounded to bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    return x.to(torch.bfloat16)


def counted(fn):
    """(fn(), the launch counts of that call alone)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def windowed(fn):
    """(ms per call over one window of about WINDOW_S of the card's work,
    the calls in it, the median host ms to issue one call, the peak memory
    in GB of one call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single, _, host = timed_iters(fn, 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = max(3, round(1e3 * WINDOW_S / single))
    return window_ms(fn, calls), calls, host, peak_gb


def densenet_throughput(net, x2):
    """Forward-only and forward + explanation images/s at batch 128, bf16,
    with each call's launch counts, host issue time and peak memory."""
    x = _batch128(x2, SEED + 10)

    def explain_call():
        return fast_densenet.fast_dynamic_linear_weights(net, x)

    def forward_call():
        with torch.no_grad():
            return net(x)

    explain_call()
    (logits, sel, w), counts_explain = counted(explain_call)
    _, counts_forward = counted(forward_call)
    say(f"densenet launches per fwd+explain call: {counts_explain}; per forward: "
        f"{counts_forward}")
    check_counts("densenet fwd+explain", counts_explain, DENSENET_EXPLAIN_COUNTS)
    check_counts("densenet forward", counts_forward, DENSENET_FORWARD_COUNTS)
    if not (torch.isfinite(logits).all() and torch.isfinite(w).all()) or w.shape != x.shape:
        raise AssertionError("DenseNet-121 bf16 outputs are not finite or mis-shaped")
    l_ref, _, w_ref = fast_densenet.fast_dynamic_linear_weights(net, x[:2].float())
    pre = (logits[:2].double() - net.logit_bias, l_ref.double() - net.logit_bias)
    say(f"densenet bf16 vs fp32 on the first two images: W rel {rel(w[:2].float(), w_ref):.3e}, "
        f"pre-logit max rel {float((pre[0] - pre[1]).abs().max() / pre[1].abs().max()):.3e}")
    del logits, sel, w, l_ref, w_ref
    out = {}
    for what, fn in (("fwd+explain", explain_call), ("forward-only", forward_call)):
        ms, calls, host, peak_gb = windowed(fn)
        say(f"densenet throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch "
            f"of {BATCH}, one window of {calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB) [{CARD}]")
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb}
    return out


def densenet_serving(net, x2):
    """The forward and the forward + explanation programs exported, saved to
    bytes and loaded back; at batch 128, bf16, against the eager calls
    (argmax identical, logits and W within 1e-6 relative: the same ops and
    kernels on the same inputs; the same launch counts), then timed."""
    t0 = time.perf_counter()
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16)
    blob = serving.export_explain(net, input_size=SIZE, dtype=torch.bfloat16)
    fwd, program = serving.load_serialized(blob_fwd), serving.load_serialized(blob)
    export_s = time.perf_counter() - t0
    say(f"densenet serving: exported and loaded both programs in {export_s:.1f} s "
        f"({len(blob_fwd) / 1e6:.1f} MB and {len(blob) / 1e6:.1f} MB)")
    x = _batch128(x2, SEED + 11)
    (logits, sel, w), counts = counted(lambda: program.call(x))
    check_counts("densenet loaded fwd+explain", counts, DENSENET_EXPLAIN_COUNTS)
    logits_f, counts_f = counted(lambda: fwd.call(x))
    check_counts("densenet loaded forward", counts_f, DENSENET_FORWARD_COUNTS)
    le, se, we = fast_densenet.fast_dynamic_linear_weights(net, x)
    with torch.no_grad():
        lf = net(x)
    bias = net.logit_bias
    checks = {
        "W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
        "pre-logit loaded vs eager fwd+explain (rel)": (rel(logits.double() - bias,
                                                            le.double() - bias), 1e-6),
        "pre-logit loaded vs eager forward (rel)": (rel(logits_f.double() - bias,
                                                        lf.double() - bias), 1e-6),
    }
    for key, (val, bound) in checks.items():
        say(f"densenet serving {key}: {val:.3e} (bound {bound:.0e})")
    if (not torch.equal(sel, se) or not torch.equal(logits_f.argmax(1), lf.argmax(1))
            or any(not val <= bound for val, bound in checks.values())):
        raise AssertionError("the loaded DenseNet programs disagree with the eager calls")
    out = {"export_s": export_s}
    for what, call in (("forward-only", lambda: fwd.call(x)),
                       ("fwd+explain", lambda: program.call(x))):
        ms, calls, host, _ = windowed(call)
        say(f"densenet serving loaded {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms; one "
            f"window of {calls} calls; host {host:.2f} ms) [{CARD}]")
        out[what] = BATCH / ms * 1e3
    return out


def densenet_train(net):
    """Trainer.fit of the densenet_121 Experiment (its own recipe: Adam 1e-4
    with the 90-epoch cosine, AGC, UniformOffLabels BCE; bf16 amp) at batch
    64 for TRAIN_STEPS steps on one repeated batch: the first of its train
    loader over the synthetic tree (seed 0), so that the net learns the
    tree's classes. It trains into the Experiment's own directory, from
    which the train command resumes. Then the step's launches, its time over
    TRAIN_WINDOW steps in a row, the host's issue time and the peak memory."""
    exp = Experiment(*DENSENET_EXPERIMENT)
    datamodule = exp.get_datamodule()
    datamodule.setup("fit")
    batches = iter(datamodule.train_dataloader(seed=0))
    first = next(batches)
    batches.close()  # stops the loader's threads
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in first.items()}
    criterion = RecordedLoss(exp.config["criterion"])
    exp.config = dict(exp.config, criterion=criterion)
    t0 = time.perf_counter()
    trainer = Trainer(exp, {"amp": True})
    state, counts = counted(lambda: trainer.fit(net, RepeatedBatch(batch, TRAIN_STEPS),
                                                max_epochs=1))
    fit_s = time.perf_counter() - t0
    evals = 2  # the initial and the epoch's validation, one batch each
    say(f"densenet train: Trainer.fit of {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, bf16 amp, "
        f"took {fit_s:.1f} s; launches {counts}")
    check_counts("densenet Trainer.fit", counts,
                 scaled_counts(DENSENET_FORWARD_COUNTS, TRAIN_STEPS + evals))
    losses = [float(v) for v in criterion.losses]
    say("densenet train loss per 5 steps: " + ", ".join(
        f"step {i}: {losses[i]:.6f}" for i in range(0, len(losses), 5))
        + f", step {len(losses) - 1}: {losses[-1]:.6f}")
    if (len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses)
            or not sum(losses[-5:]) < sum(losses[:5])):
        raise AssertionError(f"DenseNet train losses are not finite and falling: {losses}")
    if state.step != TRAIN_STEPS or trainer.ckpt.available_checkpoints() != [0]:
        raise AssertionError("the DenseNet fit did not take its steps or save its checkpoint")

    step = steps_lib.make_train_step(criterion, 1e-4, use_agc=True, amp=True)
    step(state, batch)  # warm-up
    _, per_step = counted(lambda: step(state, batch))
    say(f"densenet train: launches per train step {per_step}")
    check_counts("densenet train step", per_step, DENSENET_FORWARD_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_WINDOW):
        t0 = time.perf_counter()
        step(state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_WINDOW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"densenet train step: {TRAIN_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per step of "
        f"{TRAIN_BATCH}, one window of {TRAIN_WINDOW} steps; the host issues a step in "
        f"{statistics.median(host):.2f} ms (median; {min(host):.2f}-{max(host):.2f}); peak "
        f"memory {peak_gb:.1f} GB) [{CARD}]")
    if not all(math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError("DenseNet parameters are not finite after training")
    return {"step_img_s": TRAIN_BATCH / ms * 1e3, "step_ms": ms, "peak_gb": peak_gb}


def phase_densenet(x2, stream_rate, worst, exp_root):
    """Phase 10: the full-width DenseNet-121 of the densenet_121 recipe
    (random init from SEED, gamma-calibrated). Returns the DenseNet keys of
    K2's and K3's rows of the kernels line."""
    t0 = time.perf_counter()
    net = build_bcosified_densenet(Experiment(*DENSENET_EXPERIMENT).model_config, seed=SEED)
    mag = calibrate(net, x2[:1])
    say(f"densenet: built DenseNet-121 and calibrated its BN gammas in "
        f"{time.perf_counter() - t0:.1f} s: pre-logit magnitude {mag:.3g} on the probe")
    check_densenet_kernels(worst)
    launches = densenet_launches(net.model, BATCH, SIZE)
    per_shape = collections.Counter(launches)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = time_shapes(per_shape, stream_rate, gen, tag="densenet ")
    densenet_parity(net, x2)
    rates = densenet_throughput(net, x2)
    served = densenet_serving(net, x2)
    trained = densenet_train(net)
    cli_round_trip(DENSENET_EXPERIMENT, exp_root, DENSENET_FORWARD_COUNTS,
                   DENSENET_FORWARD_COUNTS["bcos_matmul_fwd"], ("last",), tag="densenet")
    say(f"densenet summary: fwd+explain {rates['fwd+explain']['img_s']:.1f} img/s, forward-only "
        f"{rates['forward-only']['img_s']:.1f}; loaded fwd+explain {served['fwd+explain']:.1f}, "
        f"forward-only {served['forward-only']:.1f}; train step {trained['step_img_s']:.1f} img/s "
        f"(peak {trained['peak_gb']:.1f} GB); export {served['export_s']:.1f} s [{CARD}]")
    keys = {}
    for name in ("bcos_matmul_fwd", "bcos_conv1x1_bwd_explain"):
        r = rows[name]
        say(f"densenet {name} per fwd+explain call ({DENSENET_EXPLAIN_COUNTS[name]} launches): "
            f"{r['ms']:.4f} ms; bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} "
            f"GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
        keys[name] = {"densenet_launches": DENSENET_EXPLAIN_COUNTS[name],
                      "densenet_ms": r["ms"], "densenet_bound_ms": 1e3 * r["bound_s"],
                      "densenet_plain_ms": r["plain_ms"], "densenet_library_ms": r["library_ms"]}
    return keys


# --------------------------------------------------------------------------
# 11: CLIP-RN50
# --------------------------------------------------------------------------
CLIP_NAME = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
CLIP_EXPERIMENTS = {"pooled": ("ImageNet", "clip_bcosification", CLIP_NAME),
                    "unpool": ("ImageNet", "clip_bcosification", CLIP_NAME + "_attnUnpool")}
# (label, M, K, N, relu, eps_outside) at batch 128, 224x224: conv1 of
# layer1's first block and of layer2's (the last 1x1 at 56x56), layer2's
# conv3 after its avg-pool, layer3's downsample, a layer4 conv3 (K2's split
# path, Cout 2048) and the attn-unpool c_proj (the B-cos linear)
CLIP_CHECK_SHAPES = [
    ("clip layer1_0.conv1", 401408, 64, 64, True, False),
    ("clip layer2_0.conv1", 401408, 256, 128, True, False),
    ("clip layer2_0.conv3", 100352, 128, 512, False, False),
    ("clip layer3_0.downsample", 25088, 512, 1024, False, False),
    ("clip layer4_1.conv3", 6272, 512, 2048, False, False),
    ("clip attnpool.c_proj", 6272, 2048, 1024, False, True),
]
CLIP_1X1 = 36  # conv1 and conv3 of the 16 bottlenecks, the 4 downsamples


def clip_counts(unpool, explain):
    """Launches of one encode (the module forward: K3 at every 1x1 conv,
    and at the B-cos c_proj when unpooled) or one text-grounded explanation
    (K1 and K2 at every 1x1; the unpooled c_proj adds one K3 and one K2)."""
    if explain:
        return {"bcos_conv1x1_fwd": CLIP_1X1, "bcos_conv1x1_bwd_explain": CLIP_1X1 + unpool,
                "bcos_matmul_fwd": int(unpool), "stream_add": 0}
    return {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
            "bcos_matmul_fwd": CLIP_1X1 + unpool, "stream_add": 0}


def clip_launches(net, batch, size, explain):
    """[(kernel, M, K, N, relu[, eps_outside])] of every launch of one encode
    or one text-grounded explanation (``clip_counts``), the 1x1 shapes read
    from forward hooks (``k3_shapes``)."""
    convs = k3_shapes(net.model, batch, size)
    pool = net.model.attnpool
    linear = []
    if pool.attn_unpool:
        k, n = pool.c_proj.weight.shape
        linear = [("bcos_matmul_fwd", convs[-1][1], k, n, False, True)]
        if explain:
            linear.append(("bcos_conv1x1_bwd_explain", convs[-1][1], k, n, False, True))
    if not explain:
        return [("bcos_matmul_fwd", m, k, n, False) for _, m, k, n in convs] + linear
    out = []
    for name, m, k, n in convs:
        relu = name.endswith("conv1")
        out += [("bcos_conv1x1_fwd", m, k, n, relu), ("bcos_conv1x1_bwd_explain", m, k, n, relu)]
    return out + linear


def check_clip_kernels(worst):
    """K1 (at the convs), K2 and K3 against their plain versions at
    CLIP_CHECK_SHAPES, both dtypes, phase 3's bounds: K2 as the CLIP pass
    calls it (the BN's mult, and the mask at a conv1; at c_proj no mult and
    the linear norm, eps_outside), K3 with both eps_outside values."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu, linear in CLIP_CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            eps = LINEAR_NORM_EPS if linear else 1e-6
            a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
            mu = None if linear else mult
            kw = dict(relu=relu, eps=eps, eps_outside=linear)
            results = [
                ("bcos_conv1x1_bwd_explain", " eps_outside" if linear else "",
                 k12.conv1x1_bwd_explain(x, wt, ct, a, mu, **kw),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct),
                                               None if a is None else ref(a), mu, **kw)),
            ] + [("bcos_matmul_fwd", " eps_outside" if e else "",
                  k3.bcos_matmul_fwd(x, wt, eps=eps, eps_outside=e),
                  k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=eps, eps_outside=e))
                 for e in (False, True)]
            if not linear:
                results.append(("bcos_conv1x1_fwd", "",
                                k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                                k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)))
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results


def _text_direction(dim, seed, device):
    """A unit text embedding made from ``seed``."""
    t = torch.randn(dim, generator=torch.Generator().manual_seed(seed))
    return (t / t.norm()).to(device)


def clip_parity(net, x2, head):
    """fp32, 2 images, the text-grounded explanation: the fast pass on the
    GPU against the CPU (scores within 1e-4; W with PyTorch's own CUDA convs
    within ten times the CPU's spread under 1e-7 relative input noise, with
    cuDNN's within phase 4's 1e-3, as phase 10 holds them), and the port's
    autograd through the module forward against the fast pass on the GPU
    (scores 1e-4, W ten times that spread). Unlike ResNet-50's, the module
    path does not share the fast pass's kernels: it runs each 1x1 conv on
    K3 and its BN apart, where the pass runs K1, and at full depth that
    rounding moves W by about one spread (~1e-4; PERF.md)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x2.device
    t = _text_direction(net.model.attnpool.c_proj.features, SEED + 15, dev)
    sg, wg = fast_clip.fast_text_dlw(net, x2, t, device=dev)
    xx = x2.clone().requires_grad_(True)
    sm = fast_clip.text_score_head(net(xx, explain=True), t)
    (wm,) = torch.autograd.grad(sm.sum(), xx)
    torch.backends.cudnn.enabled = False
    try:
        _, w_native = fast_clip.fast_text_dlw(net, x2, t, device=dev)
    finally:
        torch.backends.cudnn.enabled = True
    cpu = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    sc, wc = fast_clip.fast_text_dlw(cpu, x2.cpu(), t.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 16))
    _, wn = fast_clip.fast_text_dlw(cpu, x2.cpu() * (1 + 1e-7 * noise), t.cpu(), device="cpu")
    spread = rel(wn, wc)
    err, err_native = rel(wg, wc), rel(w_native, wc)

    def max_rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max() / b.double().abs().max())

    checks = {
        "W gpu-kernels (torch convs) vs cpu-plain": (err_native, 10 * spread),
        "W gpu-kernels (cudnn convs) vs cpu-plain": (err, 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 10 * spread),
        "scores gpu vs cpu (max rel)": (max_rel(sg, sc), 1e-4),
        "scores module vs fast (max rel)": (max_rel(sm.detach(), sg), 1e-4),
    }
    say(f"clip {head} parity W on the cpu under 1e-7 relative input noise: {spread:.3e}; gpu "
        f"vs cpu {err_native:.3e} = {err_native / spread:.2f} x that spread with PyTorch's CUDA "
        f"convs, {err:.3e} = {err / spread:.2f} x with cuDNN's; scores {sg.tolist()}; cpu pass "
        f"took {cpu_s:.1f} s")
    for key, (val, bound) in checks.items():
        say(f"clip {head} parity {key}: {val:.3e} (bound {bound:.3e})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"CLIP {head} parity failed")
    if not all(torch.isfinite(v).all() for v in (sg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"CLIP {head} outputs are not finite or mis-shaped")
    return t


def clip_throughput(net, x, t, unpool, head):
    """Encode and text-grounded fwd+explain images/s at batch 128, bf16, each
    with its launch counts, host issue time and peak memory."""
    def encode():
        with torch.no_grad():
            return net(x)

    def text_explain():
        return fast_clip.fast_text_dlw(net, x, t, device=x.device)

    out = {}
    for what, fn, explain_ in (("encode", encode, False), ("fwd+explain", text_explain, True)):
        fn()
        result, counts = counted(fn)
        check_counts(f"clip {head} {what}", counts, clip_counts(unpool, explain_))
        outs = result if isinstance(result, tuple) else (result,)
        if not all(torch.isfinite(v).all() for v in outs):
            raise AssertionError(f"CLIP {head} {what}: outputs are not finite")
        ms, calls, host, peak_gb = windowed(fn)
        say(f"clip {head} throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch "
            f"of {BATCH}, one window of {calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB; launches {counts}) [{CARD}]")
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb}
    return out


def clip_zeroshot(nets, device):
    """The zero-shot classifier of a random-init CLIP-RN50 text tower (from
    SEED) over the 1000 ImageNet classes x 80 templates in bf16 (tokenize
    and tower timed apart, then the whole ``zeroshot_classifier`` call):
    [1024, 1000], finite, unit-norm columns; 8 classes in fp32 on the GPU
    against the CPU (1e-4); then ``zeroshot_evaluate`` of each head over
    the val split of the synthetic tree through the Experiment's data
    module (the CLIP eval preset), with its K3 launches per batch."""
    texts = [zeroshot.format_template(t, c) for c in imagenet_classes for t in imagenet_templates]
    t0 = time.perf_counter()
    tokens = torch.from_numpy(tokenize(texts))
    tok_s = time.perf_counter() - t0
    cfg = clip_rn50_config()
    text = build_clip_text(None, cfg, seed=SEED, device=device)
    text16 = copy.deepcopy(text).to(torch.bfloat16)
    chunk = 32 * len(imagenet_templates)
    with torch.no_grad():
        text16(tokens[:chunk])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(texts), chunk):
            text16(tokens[i:i + chunk])
        torch.cuda.synchronize()
    tower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = zeroshot.zeroshot_classifier(text16, imagenet_classes, imagenet_templates)
    torch.cuda.synchronize()
    classifier_s = time.perf_counter() - t0
    norms = w.norm(dim=0)
    say(f"clip zero-shot: tokenized {len(texts)} prompts in {tok_s:.2f} s (host); the bf16 text "
        f"tower over them in {tower_s:.2f} s ({len(texts) / tower_s:.0f} prompts/s); "
        f"zeroshot_classifier {classifier_s:.2f} s -> {tuple(w.shape)}, column norms "
        f"{float(norms.min()):.6f}-{float(norms.max()):.6f} [{CARD}]")
    if (tuple(w.shape) != (cfg["embed_dim"], len(imagenet_classes))
            or not bool(torch.isfinite(w).all()) or float((norms - 1).abs().max()) > 1e-5):
        raise AssertionError("the zero-shot classifier is not [embed_dim, classes] finite unit "
                             "columns")
    w_gpu = zeroshot.zeroshot_classifier(text, imagenet_classes[:8], imagenet_templates)
    t0 = time.perf_counter()
    w_cpu = zeroshot.zeroshot_classifier(copy.deepcopy(text).to("cpu"), imagenet_classes[:8],
                                         imagenet_templates)
    err = rel(w_gpu, w_cpu)
    say(f"clip zero-shot fp32, 8 classes x 80 templates, gpu vs cpu: {err:.3e} (bound 1e-4; "
        f"the cpu took {time.perf_counter() - t0:.1f} s)")
    if not err <= 1e-4:
        raise AssertionError("the zero-shot classifier on the GPU disagrees with the CPU")
    del text, text16
    out = {"tokenize_s": tok_s, "tower_s": tower_s, "classifier_s": classifier_s}
    for head, (net, cos_power) in nets.items():
        dm = Experiment(*CLIP_EXPERIMENTS[head]).get_datamodule()
        dm.setup("test")
        loader = dm.val_dataloader()

        def encode(images):
            return net(torch.cat([images, 1.0 - images], dim=-1).to(torch.bfloat16))

        t0 = time.perf_counter()
        acc, counts = counted(lambda: zeroshot.zeroshot_evaluate(encode, loader, w.to(
            torch.bfloat16), cos_power=cos_power))
        batches = len(loader)  # the CLIP config's batch of 64
        check_counts(f"clip {head} zeroshot_evaluate", counts,
                     scaled_counts(clip_counts(head == "unpool", False), batches))
        say(f"clip {head} zeroshot_evaluate over {ENTRY_VAL} val JPEGs ({batches} batches, "
            f"cos_power {cos_power}): top-1 {acc['acc1']:.4f}, top-5 {acc['acc5']:.4f} in "
            f"{time.perf_counter() - t0:.1f} s; launches {counts}")
        out[f"{head}_acc1"] = acc["acc1"]
    return out


def clip_serving(net, x, t):
    """The pooled tower's text-grounded explanation and forward exported,
    saved to bytes and loaded back: at batch 128, bf16, equal to the eager
    calls (1e-6 relative: the same ops and kernels on the same inputs) with
    the same launch counts; the loaded explanation's images/s."""
    t0 = time.perf_counter()
    blob = serving.export_text_explain(net, embed_dim=t.shape[0], input_size=SIZE,
                                       dtype=torch.bfloat16, device=x.device)
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16,
                                      device=x.device)
    program, fwd = serving.load_serialized(blob), serving.load_serialized(blob_fwd)
    export_s = time.perf_counter() - t0
    say(f"clip serving: exported and loaded both programs in {export_s:.1f} s "
        f"({len(blob) / 1e6:.1f} MB and {len(blob_fwd) / 1e6:.1f} MB)")
    t16 = t.to(torch.bfloat16)
    (s, w), counts = counted(lambda: program.call(x, t16))
    check_counts("clip loaded text explain", counts, clip_counts(False, True))
    feats, counts_f = counted(lambda: fwd.call(x))
    check_counts("clip loaded forward", counts_f, clip_counts(False, False))
    es, ew = fast_clip.fast_text_dlw(net, x, t16, device=x.device)
    with torch.no_grad():
        ef = net(x)
    checks = {"scores loaded vs eager (rel)": (rel(s.float(), es.float()), 1e-6),
              "W loaded vs eager (rel)": (rel(w.float(), ew.float()), 1e-6),
              "features loaded vs eager forward (rel)": (rel(feats.float(), ef.float()), 1e-6)}
    for key, (val, bound) in checks.items():
        say(f"clip serving {key}: {val:.3e} (bound {bound:.0e})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the loaded CLIP programs disagree with the eager calls")
    ms, calls, host, _ = windowed(lambda: program.call(x, t16))
    say(f"clip serving loaded text fwd+explain: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms; one "
        f"window of {calls} calls; host {host:.2f} ms) [{CARD}]")
    return {"export_s": export_s, "loaded_img_s": BATCH / ms * 1e3}


def phase_clip(x2, stream_rate, worst):
    """Phase 11: the CLIP-RN50 student of the clip_bcosification recipe, pooled
    and attn-unpool (random init from SEED, gamma-calibrated), on the card.
    Returns the CLIP keys of K1's, K2's and K3's rows of the kernels line."""
    check_clip_kernels(worst)
    nets, rates = {}, {}
    for head, experiment in CLIP_EXPERIMENTS.items():
        t0 = time.perf_counter()
        exp = Experiment(*experiment)
        net = exp.get_model()
        mag = calibrate(net, x2[:1])
        say(f"clip {head}: built {experiment[2]} and calibrated its BN gammas in "
            f"{time.perf_counter() - t0:.1f} s: feature magnitude {mag:.3g} on the probe")
        t = clip_parity(net, x2, head)
        x = _batch128(x2, SEED + 17)
        rates[head] = clip_throughput(net, x, t, head == "unpool", head)
        nets[head] = (net, int(exp.model_config.get("cos_power", 1)) if head == "unpool" else 0)
    pooled = nets["pooled"][0]
    served = clip_serving(pooled, _batch128(x2, SEED + 18),
                          _text_direction(pooled.model.attnpool.c_proj.features, SEED + 19,
                                          x2.device))
    zs = clip_zeroshot(nets, x2.device)
    unpool = nets["unpool"][0]
    gen = torch.Generator(device=x2.device).manual_seed(SEED + 20)
    rows = {what: time_shapes(collections.Counter(clip_launches(unpool, BATCH, SIZE, explain_)),
                              stream_rate, gen, tag=f"clip {what} ")
            for what, explain_ in (("encode", False), ("explain", True))}
    say(f"clip summary: pooled encode {rates['pooled']['encode']['img_s']:.1f} img/s, text "
        f"fwd+explain {rates['pooled']['fwd+explain']['img_s']:.1f}; attn-unpool encode "
        f"{rates['unpool']['encode']['img_s']:.1f}, text fwd+explain "
        f"{rates['unpool']['fwd+explain']['img_s']:.1f}; loaded text fwd+explain "
        f"{served['loaded_img_s']:.1f}; export {served['export_s']:.1f} s; zero-shot classifier "
        f"{zs['classifier_s']:.2f} s [{CARD}]")
    keys = {}
    for what, explain_ in (("encode", False), ("explain", True)):
        counts = clip_counts(True, explain_)
        for name, r in rows[what].items():
            say(f"clip {name} per attn-unpool {what} ({counts[name]} launches): {r['ms']:.4f} ms; "
                f"bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
                f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} "
                f"GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms "
                f"[{CARD}]")
            keys.setdefault(name, {}).update({
                f"clip_{what}_launches": counts[name], f"clip_{what}_ms": r["ms"],
                f"clip_{what}_bound_ms": 1e3 * r["bound_s"],
                f"clip_{what}_plain_ms": r["plain_ms"],
                f"clip_{what}_library_ms": r["library_ms"]})
    return keys


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    CARD = card_line()
    say(f"device: {CARD} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")
    seconds = {}
    t0 = time.perf_counter()
    phase_build()
    seconds["2 build"] = time.perf_counter() - t0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    worst = check_kernels()
    seconds["3 kernel checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    net = build_bcosified_resnet(FLAGSHIP, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x2 = torch.rand((2, SIZE, SIZE, 3), device="cuda", generator=gen)
    x2 = torch.cat([x2, 1.0 - x2], dim=-1)
    mag = calibrate(net, x2[:1])
    say(f"calibrated BN gammas: pre-logit magnitude {mag:.3g} on the probe")
    phase_parity(net, x2)
    seconds["4 parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    counts, ms_explain = phase_throughput(net, x2)
    seconds["5 throughput"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k4_row, probe = phase_probe()
    seconds["6 probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = time_kernels(net.model, worst, counts, probe["k4_gbs"] * 1e9)
    seconds["3 kernel times"] = time.perf_counter() - t0
    kernel_ms = sum(k["ms"] for k in kernels)
    say(f"kernels' share of one fwd+explain call: {kernel_ms:.2f} of {ms_explain:.2f} ms "
        f"[{CARD}]")
    kernels.append(k4_row)

    t0 = time.perf_counter()
    phase_serving(net, x2)
    seconds["7 serving"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train = phase_train(net, probe["k4_gbs"] * 1e9)
    seconds["8 train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with synthetic_imagenet() as exp_root:
        phase_entry(net, x2, train["step_img_s"], exp_root)
        seconds["9 entry points"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} ResNet-50 calls padded their operands")
        say("TMA operand padding on the ResNet-50 paths: 0 calls")
        del net
        t0 = time.perf_counter()
        densenet = phase_densenet(x2, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["10 densenet"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} DenseNet-121 calls padded their "
                                 "operands")
        say("TMA operand padding on the DenseNet-121 paths: 0 calls")
        t0 = time.perf_counter()
        clip = phase_clip(x2, probe["k4_gbs"] * 1e9, worst)
        seconds["11 clip"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} CLIP-RN50 calls padded their operands")
    say("TMA operand padding on the CLIP-RN50 paths: 0 calls")
    k3_row = next(k for k in kernels if k["name"] == "bcos_matmul_fwd")
    k3_row.update({"train_launches": train["launches"], "train_ms": train["ms"],
                   "train_plain_ms": train["plain_ms"],
                   "train_bound_ms": 1e3 * train["bound_s"],
                   "train_library_ms": train["library_ms"]})
    for row in kernels:
        row.update(densenet.get(row["name"], {}))
        row.update(clip.get(row["name"], {}))
        row["max_abs_err"] = worst.get(row["name"], row["max_abs_err"])

    for line in _build.build_log.splitlines():  # per kernel: registers, spills, C7518
        if any(key in line for key in ("Compiling entry", "registers", "spill", "warning")):
            say(f"ptxas: {line.strip()}")
    say("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    say(CARD)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
