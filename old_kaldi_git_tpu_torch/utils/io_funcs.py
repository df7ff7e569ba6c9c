"""Kaldi's binary object format (own copy of
old_kaldi_git_tpu/utils/io_funcs.py).

Parity with reference src/base/io-funcs.h, src/matrix/kaldi-matrix.cc and
src/matrix/compressed-matrix.cc: the `\\0B` binary header,
whitespace-terminated tokens, size-marked int32 and float scalars, bools,
the raw int32 vectors inside model objects and the size-marked ones of
table values ("ivec" holders, the tree's event maps), "FM "/"DM " matrices
and "FV "/"DV " vectors, the compressed matrices "CM", "CM2" and "CM3", and
the bracketed text forms of `ark,t:`.  Little-endian throughout.

Writers emit the JAX package's bytes exactly, so a `.mdl` written by either
package loads in the other.  Streams are read forward only: a look-ahead uses the buffered reader's
`peek()`, never `tell()`/`seek()`, so pipes work as files do.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List

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


def read_bool(f: BinaryIO) -> bool:
    c = f.read(1)
    if c == b"T":
        return True
    if c == b"F":
        return False
    raise KaldiError(f"expected bool T/F, got {c!r}")


def read_int_vector(f: BinaryIO) -> np.ndarray:
    """A table value's vector<int32> (BasicVectorHolder): a size-marked
    count, then size-marked elements."""
    n = read_int32(f)
    if n < 0:
        raise KaldiError(f"bad int-vector size {n}")
    arr = np.frombuffer(_read_exact(f, 5 * n, "int-vector"), np.uint8).reshape(n, 5)
    if n and not (arr[:, 0] == 4).all():
        raise KaldiError("bad element size marker in int-vector")
    return arr[:, 1:].copy().view("<i4").reshape(n).astype(np.int32)


def read_matrix(f: BinaryIO) -> np.ndarray:
    """An "FM " (float32) or "DM " (float64) matrix, in its own type, or a
    compressed one ("CM", "CM2", "CM3") as float32."""
    tok = read_token(f)
    if tok == "CM":
        return _read_compressed_matrix(f)
    if tok == "CM2":
        return _read_compressed_matrix_global(f, 65535.0, "<u2")
    if tok == "CM3":
        return _read_compressed_matrix_global(f, 255.0, "u1")
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


def write_bool(f: BinaryIO, value: bool) -> None:
    f.write(b"T" if value else b"F")


def write_int_vector(f: BinaryIO, values) -> None:
    """A table value's vector<int32> (BasicVectorHolder): a size-marked
    count, then each element with its own size marker."""
    values = np.asarray(values, dtype=np.int32).reshape(-1)
    write_int32(f, int(values.size))
    if values.size:
        out = np.empty((values.size, 5), np.uint8)
        out[:, 0] = 4
        out[:, 1:] = values.astype("<i4").view(np.uint8).reshape(-1, 4)
        f.write(out.tobytes())


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


# ---------------------------------------------------------------------------
# compressed matrices (reference src/matrix/compressed-matrix.cc)
# ---------------------------------------------------------------------------

def write_compressed_matrix(f: BinaryIO, mat: np.ndarray, format: int = 1) -> None:
    """CompressedMatrix::CopyFromMat + Write: format 1 ("CM", per-column
    percentile headers and 8-bit codes; needs 8 rows or more), 2 ("CM2",
    a uint16 code an element against the global range) or 3 ("CM3", a
    uint8 code).  The JAX package's bytes."""
    mat = np.asarray(mat, np.float64)
    if mat.ndim != 2:
        raise KaldiError(f"write_compressed_matrix needs 2-D, got {mat.shape}")
    num_rows, num_cols = mat.shape
    min_value = float(mat.min()) if mat.size else 0.0
    rng = float(mat.max() - min_value) if mat.size else 1.0
    if rng <= 0:
        rng = 1.0
    if format in (2, 3):
        levels = 65535.0 if format == 2 else 255.0
        dt = "<u2" if format == 2 else "u1"
        write_token(f, "CM2" if format == 2 else "CM3")
        f.write(struct.pack("<ff", np.float32(min_value), np.float32(rng)))
        f.write(struct.pack("<ii", num_rows, num_cols))
        codes = np.clip(np.round((mat - min_value) / rng * levels), 0, levels).astype(dt)
        f.write(codes.tobytes())
        return
    if format != 1:
        raise KaldiError(f"unknown CompressedMatrix format {format}")

    def float_to_uint16(v):
        return np.clip(np.round((v - min_value) / rng * 65535.0), 0, 65535).astype("<u2")

    def uint16_to_float(q):
        return min_value + rng * (q.astype(np.float64) / 65535.0)

    write_token(f, "CM")
    f.write(struct.pack("<ff", np.float32(min_value), np.float32(rng)))
    f.write(struct.pack("<ii", num_rows, num_cols))
    cols = mat.T
    order = np.sort(cols, axis=1)

    def at(frac):
        return order[:, min(num_rows - 1, int(frac * (num_rows - 1)))]

    q0 = float_to_uint16(at(0.0))
    q25 = np.maximum(float_to_uint16(at(0.25)), q0 + 1)
    q75 = np.maximum(float_to_uint16(at(0.75)), q25 + 1)
    q100 = np.maximum(float_to_uint16(at(1.0)), q75 + 1)
    f.write(np.stack([q0, q25, q75, q100], axis=1).astype("<u2").tobytes())
    p0, p25, p75, p100 = (uint16_to_float(q)[:, None] for q in (q0, q25, q75, q100))
    lo = np.clip(np.round((cols - p0) / np.maximum(p25 - p0, 1e-20) * 64.0), 0, 64)
    mid = np.clip(np.round(64.0 + (cols - p25) / np.maximum(p75 - p25, 1e-20) * 128.0),
                  65, 192)
    hi = np.clip(np.round(192.0 + (cols - p75) / np.maximum(p100 - p75, 1e-20) * 63.0),
                 193, 255)
    codes = np.where(cols <= p25, lo, np.where(cols <= p75, mid, hi))
    f.write(codes.astype(np.uint8).tobytes())


def _read_compressed_matrix_global(f: BinaryIO, levels: float, dt: str) -> np.ndarray:
    """Formats 2 and 3: global linear quantisation, row-major codes."""
    min_value, rng = struct.unpack("<ff", _read_exact(f, 8, "CompressedMatrix header"))
    num_rows, num_cols = struct.unpack("<ii", _read_exact(f, 8, "CompressedMatrix header"))
    itemsize = np.dtype(dt).itemsize
    raw = _read_exact(f, num_rows * num_cols * itemsize, "CompressedMatrix data")
    codes = np.frombuffer(raw, dtype=dt).reshape(num_rows, num_cols)
    return (min_value + rng * codes.astype(np.float64) / levels).astype(np.float32)


def _read_compressed_matrix(f: BinaryIO) -> np.ndarray:
    """Format 1: per-column percentile headers (p0, p25, p75, p100 as
    uint16 against the global range) and 8-bit codes, column-major."""
    min_value, rng = struct.unpack("<ff", _read_exact(f, 8, "CompressedMatrix header"))
    num_rows, num_cols = struct.unpack("<ii", _read_exact(f, 8, "CompressedMatrix header"))
    headers = np.frombuffer(_read_exact(f, 8 * num_cols, "CompressedMatrix headers"),
                            dtype="<u2").reshape(num_cols, 4)
    c = np.frombuffer(_read_exact(f, num_rows * num_cols, "CompressedMatrix data"),
                      dtype=np.uint8).reshape(num_cols, num_rows).astype(np.float64)
    p0, p25, p75, p100 = (
        (min_value + rng * (headers[:, j].astype(np.float64) / 65535.0))[:, None]
        for j in range(4))
    out = np.where(c <= 64, p0 + (p25 - p0) * c / 64.0,
                   np.where(c <= 192, p25 + (p75 - p25) * (c - 64.0) / 128.0,
                            p75 + (p100 - p75) * (c - 192.0) / 63.0))
    return out.T.astype(np.float32)


# ---------------------------------------------------------------------------
# text forms (ark,t:)
# ---------------------------------------------------------------------------

def format_matrix_text(mat: np.ndarray) -> str:
    rows = [" ".join(f"{v:.7g}" for v in row) for row in np.asarray(mat)]
    return " [\n  " + " \n  ".join(rows) + " ]\n"


def parse_matrix_text(text: str) -> np.ndarray:
    text = text.strip()
    if not (text.startswith("[") and text.endswith("]")):
        raise KaldiError("text matrix must be bracketed")
    body = text[1:-1].strip()
    if not body:
        return np.zeros((0, 0), dtype=np.float32)
    rows: List[List[float]] = [[float(x) for x in line.split()]
                               for line in body.splitlines() if line.strip()]
    return np.asarray(rows, dtype=np.float32)
