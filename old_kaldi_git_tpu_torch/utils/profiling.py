"""Timing and profiling utilities.

Counterpart of old_kaldi_git_tpu/utils/profiling.py:
- src/base/timer.h `Timer`                → utils.log.Timer (wall clock)
- CuDevice's per-function profile (AccuProfile, PrintProfile)
                                          → `profile(name)` + `print_profile()`
- cu-matrix-speed-test.cc micro-benchmarks → `time_jitted` (min of N calls,
                                            each ended by a synchronise of the
                                            CUDA devices its tensors lie on)
- a kernel's speed against the card's roofs → `roofline(...)`
- a device trace                           → `trace(logdir)`: torch.profiler,
                                            CUDA activity when a card is
                                            present, a Chrome trace file

The roofs default to the card the port is measured on: NVIDIA H100 80GB
HBM3 at 700 W, 3.35 TB/s of HBM3 and 989 TFLOP/s of dense BF16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict

import torch
from torch.utils._pytree import tree_leaves

from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("prof")

PEAK_CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12  # dense BF16 tensor-core operations a second
PEAK_HBM_BPS = 3.35e12  # HBM3 bytes a second


def _synchronize(*trees) -> None:
    """Wait for every CUDA device that a tensor of the trees lies on."""
    devs = {t.device for t in tree_leaves(trees)
            if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devs:
        torch.cuda.synchronize(dev)


def time_jitted(fn: Callable, *args, iters: int = 4, warmup: int = 1, **kwargs) -> float:
    """The least wall seconds of `iters` calls of fn(*args, **kwargs), each
    ended by a synchronise of the CUDA devices its inputs and outputs lie
    on (a launch returns before the card is done)."""
    for _ in range(max(warmup, 0)):
        _synchronize(fn(*args, **kwargs), args, kwargs)
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs), args, kwargs)
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class _Acc:
    seconds: float = 0.0
    calls: int = 0


_PROFILE: Dict[str, _Acc] = {}


def _device_barrier() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile(name: str, sync: bool = False):
    """Accumulate wall time under `name` (CuDevice::AccuProfile's role).
    sync=True synchronises the current CUDA device before and after, so the
    launches' queue does not hide the section's cost (for coarse sections,
    not single operations)."""
    if sync:
        _device_barrier()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_barrier()
        acc = _PROFILE.setdefault(name, _Acc())
        acc.seconds += time.perf_counter() - t0
        acc.calls += 1


def print_profile(reset: bool = False) -> str:
    """The cumulative profile, longest first (CuDevice::PrintProfile)."""
    lines = ["-----[ cumulative profile ]-----"]
    for name, acc in sorted(_PROFILE.items(), key=lambda kv: -kv[1].seconds):
        lines.append(f"{name}\t{acc.seconds:.4f}s\t{acc.calls} calls")
    out = "\n".join(lines)
    log.info("%s", out)
    if reset:
        _PROFILE.clear()
    return out


def roofline(flops: float, bytes_moved: float, seconds: float,
             peak_flops: float = PEAK_FLOPS_BF16,
             peak_bw: float = PEAK_HBM_BPS) -> Dict[str, float]:
    """Achieved against speed of light: which roof binds and how close the
    measured time comes to it.  Returns {achieved_tflops, achieved_gbs,
    frac_of_peak, bound}; bound is 'compute' or 'memory', from the work's
    arithmetic intensity against the roofs' ridge point."""
    seconds = max(seconds, 1e-12)
    ai = flops / max(bytes_moved, 1.0)  # operations a byte
    bound = "compute" if ai >= peak_flops / peak_bw else "memory"
    sol = flops / peak_flops if bound == "compute" else bytes_moved / peak_bw
    return {
        "achieved_tflops": flops / seconds / 1e12,
        "achieved_gbs": bytes_moved / seconds / 1e9,
        "frac_of_peak": sol / seconds,
        "bound": bound,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block (CPU activity, and CUDA activity
    when a card is present), written to `logdir`/trace.json in Chrome's
    trace format.  A profiler that cannot start, or a trace with no event,
    raises: a trace that silently records nothing misleads."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch_profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        _device_barrier()
        prof.__exit__(None, None, None)
    if not prof.events():
        raise KaldiError("the profiler recorded no event")
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("trace: %d events → %s", len(prof.events()), path)
