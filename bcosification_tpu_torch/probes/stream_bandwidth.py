"""The card's streaming rate: K4 (``ops/cuda/stream.py``) against
PyTorch's own ``a + b + c`` (counterpart of ``scripts/perf_probe9.py``).

    python -m bcosification_tpu_torch.probes.stream_bandwidth

``measure`` makes ``nin`` bf16 arrays of [m, c] on the GPU (the default is
the layer1 activation of the B-cosified ResNet-50 at batch 128,
128*56*56 x 256) and times each path as the median over ``iters`` samples
of one call's device time; a sample is a run of ``burst`` calls between two
CUDA events, so the host's launch time overlaps the device's work instead
of adding to it. K4 moves (nin + 1) * m * c * 2 bytes: each input
read once and the output written once. PyTorch's chain of nin - 1 binary
adds writes and reads back every intermediate sum, 3 * (nin - 1) * m * c * 2
bytes; each rate is stated over the bytes its own path moves. The arrays
are ~205 MB each, so no launch finds them in the 50 MB L2.
"""
from __future__ import annotations

import json
import statistics

import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.ops.cuda.stream import stream_add, stream_add_plain

__all__ = ["measure", "event_ms"]


def event_ms(fn, iters: int, warmup: int = 3, burst: int = 10) -> float:
    """Median milliseconds of one call of ``fn``: ``iters`` samples, each
    the CUDA-event time of ``burst`` calls in a row over ``burst``. A single
    call between two events would also time the host's launch of it, since
    the device idles from the first event until the kernel arrives."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def measure(m: int = 401408, c: int = 256, iters: int = 20, *, nin: int = 3, seed: int = 0,
            device=None) -> dict:
    """K4's and PyTorch's time and rate on nin bf16 arrays of [m, c]."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("stream_bandwidth.measure times the GPU; it has no CPU mode")
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = [torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(nin)]
    k4_ms = event_ms(lambda: stream_add(*inputs), iters)
    torch_ms = event_ms(lambda: stream_add_plain(*inputs), iters)
    elem = m * c * 2
    k4_bytes, torch_bytes = (nin + 1) * elem, 3 * (nin - 1) * elem
    return {
        "m": m, "c": c, "nin": nin, "iters": iters,
        "k4_ms": k4_ms, "k4_bytes": k4_bytes, "k4_gbs": k4_bytes / k4_ms / 1e6,
        "torch_ms": torch_ms, "torch_bytes": torch_bytes,
        "torch_gbs": torch_bytes / torch_ms / 1e6,
        "device": torch.cuda.get_device_name(dev),
    }


if __name__ == "__main__":
    print(json.dumps(measure()))
