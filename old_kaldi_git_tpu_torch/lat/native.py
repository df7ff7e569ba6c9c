"""The native lattice determinization (cpp/lattice.cc), built and bound by
the port.

Counterpart of old_kaldi_git_tpu/lat/native.py: the C++ mirror of
`lat.determinize.determinize_lattice` (the same weighted subset
construction in the (LatticeWeight, tid-string) semiring, pruned by the
best backward cost), called through ctypes.  The library is built from the
checkout's own `cpp/lattice.cc` at first use, with `cpp/Makefile`'s flags,
into `build/libokt_lattice-<hash>.so` (fst/native.py's
`build_shared_library`: the name hashes the source and the flags; an
atomic rename).  Unlike the JAX
package, which falls back to Python when its library is missing, a build
or load failure raises.

The ABI takes the arcs' and finals' weights as float32 arrays and returns
float32 weights; the subset construction itself runs in double.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np

from old_kaldi_git_tpu_torch.fst.native import BUILD_DIR, REPO_DIR, build_shared_library
from old_kaldi_git_tpu_torch.lat.determinize import CompactLattice, CompactLatticeArc
from old_kaldi_git_tpu_torch.lat.lattice import Lattice
from old_kaldi_git_tpu_torch.utils.log import KaldiError

SOURCE = os.path.join(REPO_DIR, "cpp", "lattice.cc")

_lib = None
build_seconds = 0.0  # wall time this process spent in the compiler


def build() -> str:
    """Compile the library unless this source's build exists; its path."""
    global build_seconds
    lib, seconds = build_shared_library(SOURCE, "libokt_lattice", BUILD_DIR)
    build_seconds += seconds
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    sigs = {
        "okt_lat_determinize": ([i32, i32, i64] + [vp] * 8 + [f32, i64, i64], vp),
        "okt_lat_sizes": ([vp] * 6, None),
        "okt_lat_export": ([vp] * 12, None),
        "okt_lat_destroy": ([vp], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def determinize_lattice_native(
    lat: Lattice,
    lattice_beam: float = math.inf,
    max_states: int = 500000,
    max_arcs: int = 2000000,
) -> CompactLattice:
    """`determinize_lattice` in C++: the same CompactLattice (float32
    weights); raises KaldiError past max_states / max_arcs, as the Python
    algorithm does."""
    lib = _load()
    n = lat.num_states
    if n == 0:
        return CompactLattice()
    flat = [(s, a.nextstate, a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost)
            for s in range(n) for a in lat.arcs[s]]
    cols = list(zip(*flat)) if flat else [()] * 6
    frm, to, il, ol = (np.ascontiguousarray(c, np.int32) for c in cols[:4])
    g, a = (np.ascontiguousarray(c, np.float32) for c in cols[4:])
    fg = np.ascontiguousarray([w[0] for w in lat.finals], np.float32)
    fa = np.ascontiguousarray([w[1] for w in lat.finals], np.float32)
    h = lib.okt_lat_determinize(n, lat.start, len(frm), *(_ptr(x) for x in (
        frm, to, il, ol, g, a, fg, fa)), lattice_beam, max_states, max_arcs)
    if not h:
        raise KaldiError("determinize_lattice (native): state/arc blow-up "
                         f"(max_states={max_states}, max_arcs={max_arcs})")
    try:
        ns, na, nt, nf, st = (ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int64(),
                              ctypes.c_int64(), ctypes.c_int32())
        lib.okt_lat_sizes(h, *(ctypes.addressof(x) for x in (ns, na, nt, nf, st)))
        S, A = ns.value, na.value
        af, at, aw = (np.zeros(A, np.int32) for _ in range(3))
        ag, aa = np.zeros(A, np.float32), np.zeros(A, np.float32)
        aoff = np.zeros(A + 1, np.int64)
        atids = np.zeros(max(nt.value, 1), np.int32)
        fg2, fa2 = np.zeros(max(S, 1), np.float32), np.zeros(max(S, 1), np.float32)
        foff = np.zeros(S + 1, np.int64)
        ftids = np.zeros(max(nf.value, 1), np.int32)
        lib.okt_lat_export(h, *(_ptr(x) for x in (af, at, aw, ag, aa, aoff, atids, fg2,
                                                  fa2, foff, ftids)))
    finally:
        lib.okt_lat_destroy(h)
    clat = CompactLattice()
    for _ in range(S):
        clat.add_state()
    clat.start = int(st.value)
    tid_runs = atids.tolist()
    for i, (src, dst, word, gc, ac) in enumerate(zip(af.tolist(), at.tolist(), aw.tolist(),
                                                      ag.tolist(), aa.tolist())):
        clat.arcs[src].append(CompactLatticeArc(
            word, gc, ac, tuple(tid_runs[aoff[i]: aoff[i + 1]]), dst))
    fin_runs = ftids.tolist()
    for s in range(S):
        if np.isfinite(fg2[s]):
            clat.finals[s] = (float(fg2[s]), float(fa2[s]),
                              tuple(fin_runs[foff[s]: foff[s + 1]]))
    return clat
