"""Table (archive / script) I/O.

Own copy of old_kaldi_git_tpu/utils/table.py (reference
src/util/kaldi-table.h): SequentialTableReader, RandomAccessTableReader and
TableWriter over rspecifiers and wspecifiers, with the JAX package's bytes,
so that an archive written by either package reads in the other:

    ark:foo.ark          a binary archive      ark,t:-     a text archive to stdout
    scp:foo.scp          a script (key → rxfilename, with an optional :offset)
    ark,scp:a.ark,a.scp  an archive and its index
    options: t (text), p (permissive: skip bad entries); o, s, cs are
    accepted and advisory

Holders: "mat" (float matrix), "cmat" (written as a compressed matrix,
read as any), "vec" (float vector), "ivec" (int32 vector: alignments),
"text" (a line of tokens), "flt" (a scalar) and "wav" (a RIFF wave);
"lat" / "clat" (lat/holder.py) and "post" / "gpost" (hmm/posterior.py)
register themselves (`register_holder`) and load on first request.
"""

from __future__ import annotations

import importlib
import os
from typing import BinaryIO, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.kio import Input, Output
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.wav import read_wav_stream, write_wav_stream

log = get_logger("table")


class Holder:
    name = "abstract"

    def write(self, f: BinaryIO, value, binary: bool) -> None:
        raise NotImplementedError

    def read(self, f: BinaryIO):
        """One object; the stream stands just after "key "."""
        raise NotImplementedError


class MatrixHolder(Holder):
    name = "mat"

    def write(self, f, value, binary):
        if binary:
            f.write(iof.BINARY_HEADER)
            iof.write_matrix(f, value)
        else:
            f.write(iof.format_matrix_text(np.asarray(value)).encode())

    def read(self, f):
        if iof.init_kaldi_input_stream(f):
            return iof.read_matrix(f)
        chunks = []
        while True:
            line = f.readline()
            if not line:
                raise KaldiError("EOF in text matrix")
            chunks.append(line.decode())
            if b"]" in line:
                break
        return iof.parse_matrix_text("".join(chunks))


class CompressedMatrixHolder(MatrixHolder):
    """Writes CompressedMatrix ("CM") cells; reads any matrix."""

    name = "cmat"

    def write(self, f, value, binary):
        if binary:
            f.write(iof.BINARY_HEADER)
            iof.write_compressed_matrix(f, value)
        else:
            f.write(iof.format_matrix_text(np.asarray(value)).encode())


class VectorHolder(Holder):
    name = "vec"

    def write(self, f, value, binary):
        if binary:
            f.write(iof.BINARY_HEADER)
            iof.write_vector(f, value)
        else:
            vals = " ".join(f"{v:.7g}" for v in np.asarray(value).reshape(-1))
            f.write(f" [ {vals} ]\n".encode())

    def read(self, f):
        if iof.init_kaldi_input_stream(f):
            return iof.read_vector(f)
        line = f.readline().decode().strip()
        if line.startswith("["):
            line = line[1:]
        if line.endswith("]"):
            line = line[:-1]
        return np.asarray([float(x) for x in line.split()], dtype=np.float32)


class Int32VectorHolder(Holder):
    name = "ivec"

    def write(self, f, value, binary):
        if binary:
            f.write(iof.BINARY_HEADER)
            iof.write_int_vector(f, value)
        else:
            f.write((" ".join(str(int(v)) for v in value) + "\n").encode())

    def read(self, f):
        if iof.init_kaldi_input_stream(f):
            return iof.read_int_vector(f)
        line = f.readline().decode().strip()
        return np.asarray([int(x) for x in line.split()] if line else [], dtype=np.int32)


class TextHolder(Holder):
    """A whole line of tokens (a transcript)."""

    name = "text"

    def write(self, f, value, binary):
        if isinstance(value, (list, tuple)):
            value = " ".join(value)
        f.write((value + "\n").encode())

    def read(self, f):
        return f.readline().decode().rstrip("\n")


class FloatHolder(Holder):
    name = "flt"

    def write(self, f, value, binary):
        if binary:
            f.write(iof.BINARY_HEADER)
            iof.write_float(f, float(value))
        else:
            f.write(f"{float(value):.9g}\n".encode())

    def read(self, f):
        if iof.init_kaldi_input_stream(f):
            return iof.read_float(f)
        return float(f.readline().decode().strip())


class WaveHolder(Holder):
    name = "wav"

    def write(self, f, value, binary):
        write_wav_stream(f, value)

    def read(self, f):
        return read_wav_stream(f)


_HOLDERS: Dict[str, Callable[[], Holder]] = {
    h.name: h for h in (MatrixHolder, CompressedMatrixHolder, VectorHolder,
                        Int32VectorHolder, TextHolder, FloatHolder, WaveHolder)}


def register_holder(name: str, factory: Callable[[], Holder]) -> None:
    _HOLDERS[name] = factory


# holders that other modules register when imported; get_holder imports the
# module on the first request for one of them
_LAZY_PROVIDERS = {
    "lat": "old_kaldi_git_tpu_torch.lat.holder",
    "clat": "old_kaldi_git_tpu_torch.lat.holder",
    "post": "old_kaldi_git_tpu_torch.hmm.posterior",
    "gpost": "old_kaldi_git_tpu_torch.hmm.posterior",
    "fst": "old_kaldi_git_tpu_torch.fst.holder",
    "kfst": "old_kaldi_git_tpu_torch.fst.kaldi_fst_io",
    "kclat": "old_kaldi_git_tpu_torch.fst.kaldi_fst_io",
    "regx": "old_kaldi_git_tpu_torch.transform.regtree",
}


def get_holder(name) -> Holder:
    if isinstance(name, Holder):
        return name
    if name not in _HOLDERS and name in _LAZY_PROVIDERS:
        importlib.import_module(_LAZY_PROVIDERS[name])
    if name not in _HOLDERS:
        raise KaldiError(f"unknown holder {name!r}; have {sorted(_HOLDERS)}")
    return _HOLDERS[name]()


class _Spec:
    def __init__(self, specifier: str):
        if ":" not in specifier:
            raise KaldiError(f"bad table specifier {specifier!r}")
        head, _, rest = specifier.partition(":")
        opts = head.split(",")
        self.kind = opts[0]
        if self.kind not in ("ark", "scp"):
            raise KaldiError(f"bad table specifier {specifier!r}")
        self.text = "t" in opts[1:]
        self.permissive = "p" in opts[1:]
        self.both = self.kind == "ark" and "scp" in opts[1:]
        self.target = rest

    def split_targets(self) -> Tuple[str, str]:
        ark, _, scp = self.target.partition(",")
        if not scp:
            raise KaldiError("ark,scp: needs two comma-separated filenames")
        return ark, scp


def _read_key(f: BinaryIO) -> Optional[str]:
    """"key " (whitespace-terminated, leading whitespace skipped); None at
    the end of the stream."""
    chunks = []
    while True:
        c = f.read(1)
        if not c:
            return b"".join(chunks).decode() if chunks else None
        if c in b" \t\n":
            if chunks:
                return b"".join(chunks).decode()
            continue
        chunks.append(c)


def _read_scp(rxfilename: str) -> List[Tuple[str, str]]:
    with Input(rxfilename) as f:
        lines = f.read().decode().splitlines()
    out = []
    for ln in lines:
        ln = ln.strip()
        if ln:
            key, _, rx = ln.partition(" ")
            out.append((key, rx.strip()))
    return out


class SequentialTableReader:
    """(key, value) pairs of an rspecifier in file order."""

    def __init__(self, rspecifier: str, holder: str = "mat"):
        self._spec = _Spec(rspecifier)
        self._holder = get_holder(holder)
        self._scp_entries: Optional[List[Tuple[str, str]]] = None
        if self._spec.kind == "scp":
            self._scp_entries = _read_scp(self._spec.target)
        else:
            self._input = Input(self._spec.target)

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        if self._scp_entries is not None:
            for key, rx in self._scp_entries:
                try:
                    with Input(rx) as f:
                        yield key, self._holder.read(f)
                except Exception:
                    if self._spec.permissive:
                        log.warning("skipping bad scp entry %s -> %s", key, rx)
                        continue
                    raise
            return
        f = self._input.stream
        while True:
            key = _read_key(f)
            if key is None:
                break
            try:
                yield key, self._holder.read(f)
            except Exception:
                if self._spec.permissive:
                    log.warning("skipping bad archive entry %s", key)
                    break  # a binary stream cannot be resynchronised
                raise
        self._input.close()

    def close(self) -> None:
        if self._scp_entries is None:
            self._input.close()


class RandomAccessTableReader:
    """Access by key: a script's entries are opened on demand (offsets
    included), an archive is read whole on construction (a pipe cannot
    seek)."""

    def __init__(self, rspecifier: str, holder: str = "mat"):
        self._spec = _Spec(rspecifier)
        self._holder_name = holder
        self._index: Dict[str, str] = {}
        self._cache: Dict[str, object] = {}
        if self._spec.kind == "scp":
            self._index = dict(_read_scp(self._spec.target))
        else:
            self._cache = dict(SequentialTableReader(rspecifier, holder))

    def __contains__(self, key: str) -> bool:
        return key in self._cache or key in self._index

    def __getitem__(self, key: str):
        if key in self._cache:
            return self._cache[key]
        if key in self._index:
            with Input(self._index[key]) as f:
                return get_holder(self._holder_name).read(f)
        raise KeyError(key)

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self) -> List[str]:
        return list(self._cache) or list(self._index)


class TableWriter:
    def __init__(self, wspecifier: str, holder: str = "mat"):
        self._spec = _Spec(wspecifier)
        self._holder = get_holder(holder)
        self._scp = None
        if self._spec.both:
            ark, scp = self._spec.split_targets()
            self._out = Output(ark)
            self._scp = open(scp, "w")
            self._ark_path = os.path.abspath(ark)
        else:
            self._out = Output(self._spec.target)

    def write(self, key: str, value) -> None:
        f = self._out.stream
        if self._scp is not None:
            self._scp.write(f"{key} {self._ark_path}:{f.tell() + len(key) + 1}\n")
        f.write(key.encode() + b" ")
        self._holder.write(f, value, binary=not self._spec.text)

    def __setitem__(self, key: str, value) -> None:
        self.write(key, value)

    def close(self) -> None:
        self._out.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self) -> "TableWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_table(rspecifier: str, holder: str = "mat") -> Dict[str, object]:
    """A whole table, in file order."""
    return dict(SequentialTableReader(rspecifier, holder))
