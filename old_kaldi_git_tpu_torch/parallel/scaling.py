"""Scaling-efficiency measurement harness and multi-process set-up.

Counterpart of old_kaldi_git_tpu/parallel/scaling.py: times a step function
at increasing device counts and reports throughput and efficiency;
`init_distributed` joins a torch.distributed process group (one process a
card, NCCL; gloo on the CPU); `run_ranks` starts one.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_map

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("scaling")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join a process group of `num_processes`, as rank `process_id`, at
    `coordinator_address` ("host:port", or any torch init_method URL such
    as "file:///path"); the backend defaults to NCCL with a card, gloo
    without.  No-op without a coordinator (a single process)."""
    if coordinator_address is None:
        return
    import torch.distributed as dist

    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    log.info("distributed: process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)


def _rank_main(rank: int, fn: Callable, n: int, init_method: str, backend: str,
               args: tuple, out) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    try:
        out.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """fn(*args) in n spawned processes, each rank r of one process group
    (a file:// store in a temporary directory; NCCL ranks take card r), one
    torch thread each.  `fn` must be importable by name, its arguments and
    result picklable.  Returns the results by rank; a rank that raises, or
    a run longer than `timeout` seconds, raises here."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _rank_main, args=(fn, n, "file://" + os.path.join(tmp, "store"), backend, args, out),
            nprocs=n, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        done = False
        # drain the queue while waiting: a rank blocks on a full pipe until it is read
        while not (done and out.empty()):
            while not out.empty():
                rank, res = out.get()
                results[rank] = res
            if not done:
                done = procs.join(timeout=0.1)  # raises when a rank failed
            if time.monotonic() > deadline:
                for p in procs.processes:
                    p.kill()
                raise TimeoutError(f"{n} ranks still running after {timeout} s")
    if len(results) != n:
        raise RuntimeError(f"{n - len(results)} of {n} ranks returned nothing")
    return [results[r] for r in range(n)]


@dataclasses.dataclass
class ScalingPoint:
    num_devices: int
    throughput: float  # work units per second
    efficiency: float  # vs linear scaling from the first point


def _synchronize(devices: Sequence[torch.device]) -> None:
    for dev in {str(d): d for d in devices}.values():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_scaling(
    make_step: Callable[[List[torch.device]], Callable],
    make_batch: Callable[[int], object],
    device_counts: Sequence[int],
    work_per_batch: float,
    warmup: int = 1,
    iters: int = 5,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> List[ScalingPoint]:
    """For each device count n: the first n devices, the batch split along
    its first axis into one piece a device, `iters` step calls timed, the
    devices synchronised before each clock read.

    make_step(devices) → step(pieces), pieces[i] on devices[i];
    make_batch(n) → pytree of [B(n), ...] host arrays (B usually ∝ n);
    work_per_batch: units (e.g. audio seconds) per batch at n = 1, scaled by
    n.  devices: default the visible CUDA devices (raises without one)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    points: List[ScalingPoint] = []
    base = None
    for n in device_counts:
        if n > len(devices):
            log.warning("skipping N=%d (only %d devices)", n, len(devices))
            continue
        devs = devices[:n]
        step = make_step(devs)
        batch = make_batch(n)

        def piece(i):
            def cut(x):
                x = torch.as_tensor(x)
                w = x.shape[0] // n
                return x[i * w:(i + 1) * w].to(devs[i])
            return tree_map(cut, batch)

        pieces = [piece(i) for i in range(n)]
        for _ in range(warmup):
            step(pieces)
        _synchronize(devs)
        t0 = time.perf_counter()
        for _ in range(iters):
            step(pieces)
        _synchronize(devs)
        wall = (time.perf_counter() - t0) / iters
        thr = work_per_batch * n / wall
        if base is None:
            base = thr / n
        eff = thr / (n * base)
        points.append(ScalingPoint(n, thr, eff))
        log.info("N=%d: %.1f units/s, efficiency %.1f%%", n, thr, 100 * eff)
    return points
