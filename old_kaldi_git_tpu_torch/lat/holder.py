"""Lattice / CompactLattice table holders (ark I/O).

Own copy of old_kaldi_git_tpu/lat/holder.py (reference
src/lat/kaldi-lattice.{h,cc} LatticeHolder / CompactLatticeHolder), with
its bytes, so that an archive written by either package reads in the other.
The TEXT form follows the reference's lattice text format:

  Lattice arc:          src dst ilabel olabel [graph,acoustic]
  CompactLattice arc:   src dst word [graph,acoustic,tid1_tid2_...]
  final state:          state [graph,acoustic[,tids]]
  (per-utterance block ends with a blank line; key on its own line first)

Binary uses the same line format wrapped in a small token frame (the
reference's OpenFst binary cells are not reproduced).  Importing this
module registers "lat" and "clat" with utils/table.py, which imports it on
the first request for either.
"""

from __future__ import annotations

from typing import List

from old_kaldi_git_tpu_torch.lat.determinize import CompactLattice, CompactLatticeArc
from old_kaldi_git_tpu_torch.lat.lattice import INF, Lattice, LatticeArc
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from old_kaldi_git_tpu_torch.utils.table import Holder, register_holder


def lattice_to_text(lat: Lattice) -> str:
    out: List[str] = []
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            out.append(
                f"{s} {a.nextstate} {a.ilabel} {a.olabel} "
                f"{a.graph_cost:.6g},{a.acoustic_cost:.6g}"
            )
        g, ac = lat.finals[s]
        if g != INF:
            out.append(f"{s} {g:.6g},{ac:.6g}")
    return "\n".join(out) + "\n"


def lattice_from_text(text: str) -> Lattice:
    lat = Lattice()

    def need(s: int) -> None:
        while lat.num_states <= s:
            lat.add_state()

    for ln in text.splitlines():
        parts = ln.split()
        if not parts:
            continue
        if len(parts) == 5:
            s, d = int(parts[0]), int(parts[1])
            need(max(s, d))
            g, ac = (float(x) for x in parts[4].split(","))
            lat.arcs[s].append(
                LatticeArc(int(parts[2]), int(parts[3]), g, ac, d)
            )
        elif len(parts) == 2:
            s = int(parts[0])
            need(s)
            g, ac = (float(x) for x in parts[1].split(","))
            lat.finals[s] = (g, ac)
        elif len(parts) == 1:
            need(int(parts[0]))
            lat.finals[int(parts[0])] = (0.0, 0.0)
        else:
            raise KaldiError(f"bad lattice line: {ln!r}")
    return lat


def compact_lattice_to_text(clat: CompactLattice) -> str:
    out: List[str] = []

    def wstr(g: float, ac: float, tids) -> str:
        ts = "_".join(str(t) for t in tids)
        return f"{g:.6g},{ac:.6g},{ts}"

    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            out.append(f"{s} {a.nextstate} {a.word} "
                       f"{wstr(a.graph_cost, a.acoustic_cost, a.tids)}")
        g, ac, tids = clat.finals[s]
        if g != INF:
            out.append(f"{s} {wstr(g, ac, tids)}")
    return "\n".join(out) + "\n"


def compact_lattice_from_text(text: str) -> CompactLattice:
    clat = CompactLattice()

    def need(s: int) -> None:
        while clat.num_states <= s:
            clat.add_state()

    def parse_w(tok: str):
        parts = tok.split(",")
        g, ac = float(parts[0]), float(parts[1])
        tids = tuple(
            int(t) for t in parts[2].split("_") if t
        ) if len(parts) > 2 else ()
        return g, ac, tids

    for ln in text.splitlines():
        parts = ln.split()
        if not parts:
            continue
        if len(parts) == 4:
            s, d = int(parts[0]), int(parts[1])
            need(max(s, d))
            g, ac, tids = parse_w(parts[3])
            clat.arcs[s].append(
                CompactLatticeArc(int(parts[2]), g, ac, tids, d)
            )
        elif len(parts) == 2:
            s = int(parts[0])
            need(s)
            clat.finals[s] = parse_w(parts[1])
        elif len(parts) == 1:
            need(int(parts[0]))
            clat.finals[int(parts[0])] = (0.0, 0.0, ())
        else:
            raise KaldiError(f"bad compact-lattice line: {ln!r}")
    return clat


def _read_len_prefixed(f, magic: bytes) -> str:
    got = f.read(len(magic))
    if got != magic:
        raise KaldiError(f"bad lattice magic {got!r}")
    n = b""
    while True:
        c = f.read(1)
        if c == b" " or not c:
            break
        n += c
    return f.read(int(n)).decode()


def _read_text_block(f) -> str:
    # text: one block per utterance, terminated by a blank line or EOF
    lines: List[str] = []
    while True:
        ln = f.readline()
        if not ln or ln.strip() == b"":
            break
        lines.append(ln.decode())
    return "".join(lines)


class LatticeHolder(Holder):
    name = "lat"
    _magic = b"\x00LAT "
    _to_text = staticmethod(lattice_to_text)
    _from_text = staticmethod(lattice_from_text)

    def write(self, f, value, binary: bool) -> None:
        data = self._to_text(value).encode()
        if binary:
            f.write(self._magic + str(len(data)).encode() + b" " + data)
        else:
            f.write(data + b"\n")

    def read(self, f):
        # binary iff the next byte is NUL (pipes are non-seekable: peek only)
        if f.peek(1)[:1] == b"\x00":
            return self._from_text(_read_len_prefixed(f, self._magic))
        return self._from_text(_read_text_block(f))


class CompactLatticeHolder(LatticeHolder):
    name = "clat"
    _magic = b"\x00CLAT "
    _to_text = staticmethod(compact_lattice_to_text)
    _from_text = staticmethod(compact_lattice_from_text)


register_holder("lat", LatticeHolder)
register_holder("clat", CompactLatticeHolder)
