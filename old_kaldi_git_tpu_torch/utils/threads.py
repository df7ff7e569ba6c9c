"""Host-side ordered thread pool (counterpart of
old_kaldi_git_tpu/utils/threads.py).

Reference parity: src/util/kaldi-thread.h `TaskSequencer<C>`: run tasks on
N threads while keeping their outputs in submission order.  The card runs
its own work in streams; this pool is for the host: table I/O prefetch and
native calls that release the interpreter lock (the ctypes lattice
determinization), where Python threads give real parallelism.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_STOP = object()


def map_ordered(fn: Callable[[T], R], items: Iterable[T], num_threads: int = 4,
                max_in_flight: int = 0) -> Iterator[R]:
    """Parallel map that yields results in input order (the TaskSequencer
    contract).  At most `max_in_flight` tasks (default 2·num_threads) are
    pending, so an unbounded input stream does not queue unboundedly."""
    if num_threads <= 1:
        for x in items:
            yield fn(x)
        return
    cap = max_in_flight if max_in_flight > 0 else 2 * num_threads
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        pending = collections.deque()
        it = iter(items)
        exhausted = False
        try:
            while True:
                while not exhausted and len(pending) < cap:
                    try:
                        pending.append(pool.submit(fn, next(it)))
                    except StopIteration:
                        exhausted = True
                if not pending:
                    break
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


def prefetch(items: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Run the producer iterator on a background thread with a bounded
    queue: I/O prefetch for sequential table readers.  A consumer that stops
    early releases the producer, which then ends."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err = []
    stop = threading.Event()

    def put(x) -> bool:
        """Put x unless the consumer has gone; False when it has."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for x in items:
                if not put(x):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer's side
            err.append(e)
        finally:
            put(_STOP)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _STOP:
                break
            yield x
    finally:
        stop.set()
        t.join(timeout=5.0)
    if err:
        raise err[0]


class TaskSequencer:
    """Submit/collect form of map_ordered (the reference class):
    `submit(fn, *args)` schedules work, `results()` yields return values in
    submission order, `wait()` drains everything (the reference's destructor
    semantics)."""

    def __init__(self, num_threads: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_threads))
        self._pending: collections.deque = collections.deque()

    def submit(self, fn: Callable[..., R], *args, **kwargs) -> None:
        self._pending.append(self._pool.submit(fn, *args, **kwargs))

    def results(self) -> Iterator[R]:
        while self._pending:
            yield self._pending.popleft().result()

    def wait(self) -> Tuple[int, int]:
        """Drain; returns (num_ok, num_failed)."""
        ok = bad = 0
        while self._pending:
            try:
                self._pending.popleft().result()
                ok += 1
            except Exception:  # noqa: BLE001 — counted, as the reference counts failed tasks
                bad += 1
        return ok, bad

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "TaskSequencer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
