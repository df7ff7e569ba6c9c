"""The native graph-plane library (cpp/wfst.cc), built and bound by the port.

Counterpart of old_kaldi_git_tpu/fst/native.py's handle API (`NativeFst`):
composition, DeterminizeStar, encoded minimisation, context composition,
removal of symbols and of local epsilons, AddSelfLoops, Connect,
PushSpecial and the eps-forwarded CSR export run in C++, and only the
final CSR arrays cross into numpy.

The library is built from the checkout's own `cpp/wfst.cc` at first use,
with `cpp/Makefile`'s compiler flags, into `build/` beside the package (an
ignored directory):

    g++ -O2 -std=c++17 -fPIC -Wall -shared -o build/libokt_wfst-<hash>.so cpp/wfst.cc

It is named by a hash of the source and the flags, so an edited source
never meets a stale library, and written under a temporary name and renamed
atomically, so that processes building it at once (test workers) each see
a whole library.  The committed `cpp/libokt_wfst.so` is never loaded.  A
build or load failure raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
from old_kaldi_git_tpu_torch.utils.log import KaldiError

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_DIR, "cpp", "wfst.cc")
BUILD_DIR = os.path.join(REPO_DIR, "build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")  # cpp/Makefile's

_lib = None
build_seconds = 0.0  # wall time this process spent in the compiler


def shared_library_path(source: str, stem: str, build_dir: str) -> str:
    """`build_dir/<stem>-<hash>.so`, the hash of the source and the flags."""
    digest = hashlib.sha1(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_shared_library(source: str, stem: str, build_dir: str) -> Tuple[str, float]:
    """Compile `source` with g++ into its `shared_library_path` unless that
    exists; (its path, the seconds spent in the compiler).  Raises
    KaldiError when the compiler cannot run or fails."""
    lib = shared_library_path(source, stem, build_dir)
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, source]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except OSError as e:
        raise KaldiError(f"cannot run {CXX} to build {stem}: {e}") from e
    if out.returncode != 0:
        raise KaldiError(f"{' '.join(cmd)} failed:\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, time.perf_counter() - t0


def library_path() -> str:
    return shared_library_path(SOURCE, "libokt_wfst", BUILD_DIR)


def build() -> str:
    """Compile the library unless this source's build exists; its path."""
    global build_seconds
    lib, seconds = build_shared_library(SOURCE, "libokt_wfst", BUILD_DIR)
    build_seconds += seconds
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {
        "okt_fst_create": ([i32, i32] + [vp] * 6, vp),
        "okt_fst_destroy": ([vp], None),
        "okt_fst_num_states": ([vp], i32),
        "okt_fst_num_arcs": ([vp], i64),
        "okt_fst_start": ([vp], i32),
        "okt_fst_export": ([vp] * 7, None),
        "okt_compose": ([vp, vp], vp),
        "okt_determinize_star": ([vp, ctypes.c_int, i64], vp),
        "okt_minimize_encoded": ([vp], vp),
        "okt_remove_eps_local": ([vp], None),
        "okt_connect": ([vp], None),
        "okt_compose_context": ([vp, i32, i32, vp, i32, i32], vp),
        "okt_ctx_num_ilabels": ([vp], i32),
        "okt_ctx_info_total": ([vp], i64),
        "okt_ctx_export_info": ([vp, vp, vp], None),
        "okt_ctx_take_fst": ([vp], vp),
        "okt_ctx_destroy": ([vp], None),
        "okt_add_self_loops": ([vp, vp, i32, vp, vp, vp, i32], vp),
        "okt_push_special": ([vp, ctypes.c_float, i32], None),
        "okt_rm_symbols": ([vp, vp, i32, i32], None),
        "okt_fst_to_csr": ([vp], vp),
        "okt_csr_sizes": ([vp, vp], None),
        "okt_csr_export": ([vp] * 10, None),
        "okt_csr_destroy": ([vp], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


class NativeFst:
    """Owning wrapper around a native Fst handle; the handle is destroyed
    when the wrapper is collected."""

    def __init__(self, handle):
        if not handle:
            raise KaldiError("null native fst handle")
        self._h = handle
        weakref.finalize(self, _load().okt_fst_destroy, handle)

    @property
    def num_states(self) -> int:
        return _load().okt_fst_num_states(self._h)

    @property
    def num_arcs(self) -> int:
        return _load().okt_fst_num_arcs(self._h)

    @staticmethod
    def from_arrays(start: int, row_ptr, ilabels, olabels, weights, nextstates,
                    finals) -> "NativeFst":
        """From flat CSR-layout arrays (arcs of state s at
        row_ptr[s]:row_ptr[s+1]; finals +inf = not final)."""
        row_ptr, ilabels, olabels, nextstates = (
            _i32(a) for a in (row_ptr, ilabels, olabels, nextstates))
        weights = np.ascontiguousarray(weights, np.float32)
        finals = np.ascontiguousarray(finals, np.float32)
        if len(row_ptr) != len(finals) + 1 or not (
                len(ilabels) == len(olabels) == len(weights) == len(nextstates)
                == int(row_ptr[-1])):
            raise KaldiError("NativeFst.from_arrays: inconsistent array sizes")
        return NativeFst(_load().okt_fst_create(
            len(finals), start, _ptr(row_ptr), _ptr(ilabels), _ptr(olabels),
            _ptr(weights), _ptr(nextstates), _ptr(finals)))

    @staticmethod
    def from_vector_fst(fst: VectorFst) -> "NativeFst":
        return NativeFst.from_arrays(*fst.to_arrays())

    # -- pipeline ops (each returns a new NativeFst unless noted in place) --

    def compose(self, other: "NativeFst") -> "NativeFst":
        return NativeFst(_load().okt_compose(self._h, other._h))

    def determinize_star(self, use_log: bool = False,
                         max_states: int = 100_000_000) -> "NativeFst":
        h = _load().okt_determinize_star(self._h, 1 if use_log else 0, max_states)
        if not h:
            raise KaldiError("native determinize_star failed (blow-up?)")
        return NativeFst(h)

    def minimize_encoded(self) -> "NativeFst":
        return NativeFst(_load().okt_minimize_encoded(self._h))

    def remove_eps_local(self) -> None:
        _load().okt_remove_eps_local(self._h)

    def connect(self) -> None:
        _load().okt_connect(self._h)

    def push_special(self, delta: float = 1e-3, max_iters: int = 200) -> None:
        _load().okt_push_special(self._h, delta, max_iters)

    def rm_symbols(self, labels: Sequence[int], side: str = "input") -> None:
        arr = _i32(sorted(labels))
        _load().okt_rm_symbols(self._h, _ptr(arr), len(arr), 0 if side == "input" else 1)

    def compose_context(self, N: int, P: int, disambig_ids: Sequence[int],
                        subseq_symbol: int) -> Tuple["NativeFst", List[List[int]]]:
        """(C∘self, ilabel_info): the context-expanded FST and, per new input
        label, its phone window (or a one-element disambiguation entry)."""
        lib = _load()
        dis = _i32(sorted(disambig_ids))
        res = lib.okt_compose_context(self._h, N, P, _ptr(dis), len(dis), subseq_symbol)
        if not res:
            raise KaldiError("native compose_context failed")
        try:
            n = lib.okt_ctx_num_ilabels(res)
            offsets = np.zeros(n + 1, np.int32)
            values = np.zeros(max(lib.okt_ctx_info_total(res), 1), np.int32)
            lib.okt_ctx_export_info(res, _ptr(offsets), _ptr(values))
            ilabel_info = [values[offsets[i]:offsets[i + 1]].tolist() for i in range(n)]
            fst = NativeFst(lib.okt_ctx_take_fst(res))
        finally:
            lib.okt_ctx_destroy(res)
        return fst, ilabel_info

    def add_self_loops(self, tm, self_loop_scale: float = 0.1) -> "NativeFst":
        """AddSelfLoops (reorder) with the per-transition-state self-loop
        tids and weights of a TransitionModel (hmm/hmm_utils.py semantics)."""
        num_ts = len(tm.tuples)
        ts_self_tid = np.zeros(num_ts + 1, np.int32)
        ts_loop_w = np.zeros(num_ts + 1, np.float32)
        ts_fwd_w = np.zeros(num_ts + 1, np.float32)
        for ts in range(num_ts):
            loop_tid = tm.self_loop_tid(ts)
            ts_self_tid[ts] = loop_tid
            if loop_tid:
                p_self = tm.self_loop_prob(ts)
                ts_loop_w[ts] = -self_loop_scale * math.log(max(p_self, 1e-20))
                if p_self > 0.0:
                    ts_fwd_w[ts] = -self_loop_scale * math.log(max(1.0 - p_self, 1e-20))
        tid_tstate = _i32(tm.id2state)
        return NativeFst(_load().okt_add_self_loops(
            self._h, _ptr(tid_tstate), tm.num_tids, _ptr(ts_self_tid),
            _ptr(ts_loop_w), _ptr(ts_fwd_w), num_ts))

    def to_raw_arrays(self) -> Tuple:
        """The arcs as stored, epsilons included: (start, row_ptr, ilabels,
        olabels, weights, nextstates, finals) with finals +inf = not final
        (the split-eps CSR export builds from these)."""
        lib = _load()
        n, a = self.num_states, self.num_arcs
        row_ptr = np.zeros(n + 1, np.int32)
        il, ol, ns = (np.zeros(a, np.int32) for _ in range(3))
        w = np.zeros(a, np.float32)
        finals = np.zeros(n, np.float32)
        lib.okt_fst_export(self._h, *(_ptr(x) for x in (row_ptr, il, ol, w, ns, finals)))
        return lib.okt_fst_start(self._h), row_ptr, il, ol, w, ns, finals

    def to_csr_arrays(self) -> Tuple:
        """Eps-forwarded CSR export: (start, row_ptr, tid, weight, nextstate,
        final_weight, olab_off, olab_val, folab_off, folab_val); the output
        label runs are flat (olab_off[a]:olab_off[a+1] indexes olab_val)."""
        lib = _load()
        res = lib.okt_fst_to_csr(self._h)
        if not res:
            raise KaldiError("native fst_to_csr failed")
        try:
            sizes = np.zeros(5, np.int32)
            lib.okt_csr_sizes(res, _ptr(sizes))
            S, A, n_ol, n_fol, start = (int(x) for x in sizes)
            arrays: Dict[str, np.ndarray] = {
                "row_ptr": np.zeros(S + 1, np.int32), "tid": np.zeros(A, np.int32),
                "weight": np.zeros(A, np.float32), "nextstate": np.zeros(A, np.int32),
                "final_weight": np.zeros(S, np.float32),
                "olab_off": np.zeros(A + 1, np.int32),
                "olab_val": np.zeros(max(n_ol, 1), np.int32),
                "folab_off": np.zeros(S + 1, np.int32),
                "folab_val": np.zeros(max(n_fol, 1), np.int32)}
            lib.okt_csr_export(res, *(_ptr(a) for a in arrays.values()))
        finally:
            lib.okt_csr_destroy(res)
        a = arrays
        return (start, a["row_ptr"], a["tid"], a["weight"], a["nextstate"],
                a["final_weight"], a["olab_off"], a["olab_val"][:n_ol],
                a["folab_off"], a["folab_val"][:n_fol])
