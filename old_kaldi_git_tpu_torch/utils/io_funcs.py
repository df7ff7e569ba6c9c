"""Kaldi's binary object format (own copy of the parts of
old_kaldi_git_tpu/utils/io_funcs.py that reading and writing a `.mdl`
need).

Parity with reference src/base/io-funcs.h and src/matrix/kaldi-matrix.cc:
the `\\0B` binary header, whitespace-terminated tokens, size-marked int32 and
float scalars, the raw int32 vectors inside model objects, and "FM "/"DM "
matrices and "FV "/"DV " vectors.  Little-endian throughout.

Writers emit the JAX package's bytes exactly, so a `.mdl` written by either
package loads in the other.  Streams are read forward only: a look-ahead uses the buffered reader's
`peek()`, never `tell()`/`seek()`, so pipes work as files do.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from old_kaldi_git_tpu_torch.utils.log import KaldiError

BINARY_HEADER = b"\x00B"
_MAT_TOKENS = {"FM": np.float32, "DM": np.float64}
_VEC_TOKENS = {"FV": np.float32, "DV": np.float64}


def _peek(f: BinaryIO, n: int) -> bytes:
    """Up to `n` bytes ahead of the read position, not consumed.  The
    stream must be a buffered reader (`open(path, "rb")`, a pipe's stdout,
    `io.BufferedReader` around anything else)."""
    if not hasattr(f, "peek"):
        raise KaldiError("a Kaldi input stream needs peek(): wrap it in "
                         "io.BufferedReader")
    return f.peek(n)[:n]


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    raw = f.read(n)
    if len(raw) != n:
        raise KaldiError(f"truncated {what}")
    return raw


def init_kaldi_input_stream(f: BinaryIO) -> bool:
    """Consume the two-byte binary header if it is there; True if binary."""
    if _peek(f, 2) == BINARY_HEADER:
        f.read(2)
        return True
    return False


def _skip_whitespace(f: BinaryIO) -> None:
    while True:
        c = _peek(f, 1)
        if not c or not c.isspace():
            return
        f.read(1)


def read_token(f: BinaryIO) -> str:
    """A whitespace-terminated token, leading whitespace skipped; the one
    whitespace byte that ends it is consumed, as the reference does."""
    _skip_whitespace(f)
    chunks = []
    while True:
        c = f.read(1)
        if not c:
            if chunks:
                break
            raise EOFError("read_token: EOF")
        if c.isspace():
            break
        chunks.append(c)
    return b"".join(chunks).decode("utf-8")


def peek_token(f: BinaryIO) -> str:
    """The next token, not consumed (leading whitespace is).  It must lie
    within the stream's look-ahead buffer, which holds kilobytes; a token
    is a few bytes."""
    _skip_whitespace(f)
    ahead = _peek(f, 1 << 12)
    for i, byte in enumerate(ahead):
        if bytes((byte,)).isspace():
            return ahead[:i].decode("utf-8")
    raise KaldiError("peek_token: no whole token within the look-ahead")


def expect_token(f: BinaryIO, token: str) -> None:
    got = read_token(f)
    if got != token:
        raise KaldiError(f"expected token {token!r}, got {got!r}")


def read_int32(f: BinaryIO) -> int:
    marker = f.read(1)
    if marker != b"\x04":
        raise KaldiError(f"expected int32 size marker, got {marker!r}")
    return struct.unpack("<i", _read_exact(f, 4, "int32"))[0]


def read_float(f: BinaryIO) -> float:
    marker = f.read(1)
    if marker == b"\x04":
        return struct.unpack("<f", _read_exact(f, 4, "float"))[0]
    if marker == b"\x08":
        return struct.unpack("<d", _read_exact(f, 8, "double"))[0]
    raise KaldiError(f"expected float size marker, got {marker!r}")


def read_integer_vector(f: BinaryIO) -> np.ndarray:
    """Reference ReadIntegerVector inside model objects: element size 4, a
    raw int32 count, raw int32 elements."""
    marker = f.read(1)
    if marker != b"\x04":
        raise KaldiError(f"expected elem-size marker 4, got {marker!r}")
    n = struct.unpack("<i", _read_exact(f, 4, "integer-vector size"))[0]
    if n < 0:
        raise KaldiError(f"bad integer-vector size {n}")
    raw = _read_exact(f, 4 * n, "integer-vector")
    return np.frombuffer(raw, dtype="<i4").astype(np.int32)


def read_matrix(f: BinaryIO) -> np.ndarray:
    """An "FM " (float32) or "DM " (float64) matrix, in its own type.
    Compressed matrices do not occur in model files and are refused."""
    tok = read_token(f)
    if tok not in _MAT_TOKENS:
        raise KaldiError(f"unknown matrix token {tok!r}")
    dtype = np.dtype(_MAT_TOKENS[tok])
    rows, cols = read_int32(f), read_int32(f)
    raw = _read_exact(f, rows * cols * dtype.itemsize, "matrix data")
    return np.frombuffer(raw, dtype.newbyteorder("<")).reshape(rows, cols).astype(dtype)


def read_vector(f: BinaryIO) -> np.ndarray:
    """An "FV " (float32) or "DV " (float64) vector, in its own type."""
    tok = read_token(f)
    if tok not in _VEC_TOKENS:
        raise KaldiError(f"unknown vector token {tok!r}")
    dtype = np.dtype(_VEC_TOKENS[tok])
    n = read_int32(f)
    raw = _read_exact(f, n * dtype.itemsize, "vector data")
    return np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def init_kaldi_output_stream(f: BinaryIO, binary: bool = True) -> None:
    if binary:
        f.write(BINARY_HEADER)


def write_token(f: BinaryIO, token: str) -> None:
    if not token or any(c.isspace() for c in token):
        raise KaldiError(f"invalid token {token!r}")
    f.write(token.encode("utf-8") + b" ")


def write_int32(f: BinaryIO, value: int) -> None:
    f.write(b"\x04" + struct.pack("<i", value))


def write_float(f: BinaryIO, value: float) -> None:
    f.write(b"\x04" + struct.pack("<f", value))


def write_double(f: BinaryIO, value: float) -> None:
    f.write(b"\x08" + struct.pack("<d", value))


def write_integer_vector(f: BinaryIO, values) -> None:
    """Reference WriteIntegerVector inside model objects: element size 4, a
    raw int32 count, raw int32 elements."""
    values = np.asarray(values, dtype=np.int32)
    f.write(b"\x04" + struct.pack("<i", int(values.size)))
    if values.size:
        f.write(values.astype("<i4").tobytes())


def write_matrix(f: BinaryIO, mat: np.ndarray, dtype=np.float32) -> None:
    """An "FM " (float32) or "DM " (float64) matrix."""
    mat = np.ascontiguousarray(np.asarray(mat), dtype=dtype)
    if mat.ndim != 2:
        raise KaldiError(f"write_matrix needs 2-D, got shape {mat.shape}")
    write_token(f, "FM" if dtype == np.float32 else "DM")
    write_int32(f, mat.shape[0])
    write_int32(f, mat.shape[1])
    f.write(mat.astype("<f4" if dtype == np.float32 else "<f8").tobytes())


def write_vector(f: BinaryIO, vec: np.ndarray, dtype=np.float32) -> None:
    """An "FV " (float32) or "DV " (float64) vector."""
    vec = np.ascontiguousarray(np.asarray(vec), dtype=dtype).reshape(-1)
    write_token(f, "FV" if dtype == np.float32 else "DV")
    write_int32(f, vec.shape[0])
    f.write(vec.astype("<f4" if dtype == np.float32 else "<f8").tobytes())
