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
   record (PREVIOUS_MS); K3 is checked with both eps_outside values;
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
   (RGBA finite, in [0, 1]).

Every time is taken over runs of calls in a row between two CUDA events, so
the host's launch of one call overlaps the card's work on the one before:
a kernel's time is the median of 10 runs of 10 launches, a whole-model rate
is the images of one window of about 1.7 s over its time. The last three
lines are the card, one JSON object with the kernels' numbers, and
{"ok": true, "device": {...}}.
Without a GPU, or without the repository next to it, the script exits
non-zero and prints no result.
"""
import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from bcosification_tpu_torch import serving
from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
from bcosification_tpu_torch.explain.core import dynamic_linear_weights, explain
from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights
from bcosification_tpu_torch.models.resnet import Bottleneck
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


def kernel_calls(name, x, wt, mult, add, ct, relu):
    """(kernel call, plain call, torch.matmul call) for one launch's work."""
    if name == "bcos_conv1x1_fwd":
        return (lambda: k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                lambda: k12.conv1x1_fwd_plain(x, wt, mult, add, relu=relu),
                lambda: torch.matmul(x, wt.t()))
    if name == "bcos_conv1x1_bwd_explain":
        a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
        return (lambda: k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                lambda: k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, relu=relu),
                lambda: torch.matmul(torch.matmul(x, wt.t()), wt))
    return (lambda: k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False),
            lambda: k3.bcos_matmul_fwd_plain(x, wt, eps=1e-6, eps_outside=False),
            lambda: torch.matmul(x, wt.t()))


def check_kernels():
    """Each kernel against its plain version at the six check shapes, both
    dtypes (K3 with both eps_outside values). Returns {kernel: max abs
    error over all checks}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {name: 0.0 for name in MODEL_KERNELS}
    for label, m, k, n, relu in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
            a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
            results = [  # (kernel, variant, kernel's result, plain version's)
                ("bcos_conv1x1_fwd", "", k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                 k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)),
                ("bcos_conv1x1_bwd_explain", "",
                 k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), ref(a), mult,
                                               relu=relu)),
            ]
            for eps_outside in (False, True):
                results.append((
                    "bcos_matmul_fwd", " eps_outside" if eps_outside else "",
                    k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside),
                    k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6,
                                             eps_outside=eps_outside)))
            torch.cuda.synchronize()
            for name, variant, got, want in results:
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
            del x, wt, ct, a, results
    return worst


def main_path_launches(model, batch, size):
    """[(kernel, M, K, N, relu)] for every kernel launch of one fast
    forward + explanation call at this batch and input size."""
    s = ((size + 6 - 7) // 2 + 1 + 2 - 3) // 2 + 1  # 7x7/s2/p3 conv, 3x3/s2/p1 pool
    launches = []
    for stage, j, planes, stride, has_ds in model.block_cfgs():
        cin = model.block_in(stage, j)
        s_out = (s - 1) // stride + 1
        shapes = [(batch * s * s, cin, planes, True),
                  (batch * s_out * s_out, planes, 4 * planes, False)]
        if has_ds:
            shapes.append((batch * s_out * s_out, cin, 4 * planes, False))
        for m, k, n, relu in shapes:
            launches += [("bcos_conv1x1_fwd", m, k, n, relu),
                         ("bcos_conv1x1_bwd_explain", m, k, n, relu)]
        s = s_out
    nf = model.block_in(len(model.layers), 0)
    launches += [("bcos_matmul_fwd", batch * s * s, nf, model.num_classes, False),
                 ("bcos_conv1x1_bwd_explain", batch * s * s, nf, model.num_classes, False)]
    return launches


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


def time_kernels(model, worst, counts, stream_rate):
    """Per kernel: time, bound, plain and torch.matmul time of ONE main-path
    call's launches (bf16, batch 128), each distinct shape timed as the
    median of 10 samples of 10 launches in a row and weighted by how often
    the call launches it. Each bound is also stated at ``stream_rate``
    (bytes/s), the streaming rate K4 measured on this card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    launches = main_path_launches(model, BATCH, SIZE)
    per_shape = {}
    for key in launches:
        per_shape[key] = per_shape.get(key, 0) + 1
    for name in MODEL_KERNELS:
        expected = sum(c for key, c in per_shape.items() if key[0] == name)
        if counts.get(name) != expected:
            raise AssertionError(f"{name}: {counts.get(name)} launches, shapes list {expected}")
    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flop_s=0.0, byte_s=0.0,
                       bound_s=0.0, measured_bound_s=0.0) for name in MODEL_KERNELS}
    for (name, m, k, n, relu), count in sorted(per_shape.items()):
        x, wt, mult, add, ct = operands(m, k, n, torch.bfloat16, gen)
        kern, plain, lib = kernel_calls(name, x, wt, mult, add, ct, relu)
        t_k = stream_bandwidth.event_ms(kern, 10)
        t_p = stream_bandwidth.event_ms(plain, 3, warmup=1, burst=3)
        t_l = stream_bandwidth.event_ms(lib, 10)
        flops, nbytes = bound_terms(name, m, k, n, relu)
        f_s, b_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        r = rows[name]
        r["ms"] += count * t_k
        r["plain_ms"] += count * t_p
        r["library_ms"] += count * t_l
        r["bound_s"] += count * max(f_s, b_s)
        r["measured_bound_s"] += count * max(f_s, b_s * PEAK_BYTES / stream_rate)
        r["flop_s" if f_s >= b_s else "byte_s"] += count * max(f_s, b_s)
        say(f"time {name:26s} M={m:6d} K={k:4d} N={n:4d} x{count:2d}: {t_k:.4f} ms, "
            f"{flops / t_k / 1e9:.1f} TFLOP/s, {nbytes / t_k / 1e6:.1f} GB/s "
            f"(bound {1e3 * max(f_s, b_s):.4f} ms by {'FLOPs' if f_s >= b_s else 'bytes'}; "
            f"plain {t_p:.4f}, torch.matmul {t_l:.4f}) [{CARD}]")
        del x, wt, ct
    kernels = []
    for name, r in rows.items():
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


def calibrate(net, probe):
    """Scale each BN gamma, in forward order, so that its segment's output
    has RMS 1 on ``probe``: a random-init b=2 net contracts to ~1e-20 and
    makes every comparison vacuous. A uniform factor on all gammas does not
    work at full depth: the early layers overflow before the output
    reaches O(1). Returns the pre-logit magnitude afterwards."""
    m = net.model
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
    with torch.no_grad():
        for bn, module, transform in steps:
            bn.weight.div_(_output_rms(net, probe, module, transform))
        mag = float((net(probe).double() - net.logit_bias).abs().max())
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
