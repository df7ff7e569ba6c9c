"""Extended filenames: files, `.gz`, pipes, stdin and stdout.

Own copy of old_kaldi_git_tpu/utils/kio.py (reference src/util/kaldi-io.h,
the Input and Output classes): plain paths, "-" (stdin / stdout), input
pipes ("gunzip -c foo.gz |"), output pipes ("| gzip -c > foo.gz"), byte
offsets ("foo.ark:12345"), and `.gz` paths through the gzip module.  Every
input stream is a buffered reader with `peek()`, which the binary readers
of utils/io_funcs.py use instead of seeking, so pipes read as files do.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
from typing import BinaryIO, Optional, Tuple

from old_kaldi_git_tpu_torch.utils.log import KaldiError


def _classify(name: str) -> Tuple[str, str, Optional[int]]:
    name = name.strip()
    if name in ("", "-"):
        return "std", name, None
    if name.endswith("|"):
        return "pipe_in", name[:-1].strip(), None
    if name.startswith("|"):
        return "pipe_out", name[1:].strip(), None
    if ":" in name:
        path, _, off = name.rpartition(":")
        if off.isdigit() and path:
            return "offset", path, int(off)
    return "file", name, None


class Input:
    """An rxfilename opened for binary reading; a context manager that
    yields the stream.  Closing an input pipe raises when its command
    failed."""

    def __init__(self, rxfilename: str):
        kind, name, offset = _classify(rxfilename)
        self._proc: Optional[subprocess.Popen] = None
        if kind == "std":
            self.stream: BinaryIO = sys.stdin.buffer
        elif kind == "pipe_in":
            self._proc = subprocess.Popen(name, shell=True, stdout=subprocess.PIPE)
            self.stream = self._proc.stdout  # type: ignore[assignment]
        elif kind in ("file", "offset"):
            if not os.path.exists(name):
                raise KaldiError(f"no such file: {name}")
            if name.endswith(".gz") and kind == "file":
                self.stream = gzip.open(name, "rb")  # type: ignore[assignment]
            else:
                self.stream = open(name, "rb")
                if offset:
                    self.stream.seek(offset)
        else:
            raise KaldiError(f"cannot open {rxfilename!r} for reading")

    def close(self) -> None:
        if self.stream is not sys.stdin.buffer:
            self.stream.close()
        if self._proc is not None:
            self._proc.wait()
            if self._proc.returncode != 0:
                raise KaldiError(f"input pipe failed with rc={self._proc.returncode}")

    def __enter__(self) -> BinaryIO:
        return self.stream

    def __exit__(self, *exc) -> None:
        self.close()


class Output:
    """A wxfilename opened for binary writing (parent directories are
    made); a context manager that yields the stream.  Closing an output
    pipe waits for its command and raises when it failed."""

    def __init__(self, wxfilename: str):
        kind, name, _ = _classify(wxfilename)
        self._proc: Optional[subprocess.Popen] = None
        if kind == "std":
            self.stream: BinaryIO = sys.stdout.buffer
        elif kind == "pipe_out":
            self._proc = subprocess.Popen(name, shell=True, stdin=subprocess.PIPE)
            self.stream = self._proc.stdin  # type: ignore[assignment]
        elif kind == "file":
            os.makedirs(os.path.dirname(os.path.abspath(name)), exist_ok=True)
            self.stream = (gzip.open(name, "wb") if name.endswith(".gz")  # type: ignore
                           else open(name, "wb"))
        else:
            raise KaldiError(f"cannot open {wxfilename!r} for writing")

    def close(self) -> None:
        if self.stream is not sys.stdout.buffer:
            self.stream.close()
        if self._proc is not None:
            self._proc.wait()
            if self._proc.returncode != 0:
                raise KaldiError(f"output pipe failed with rc={self._proc.returncode}")

    def __enter__(self) -> BinaryIO:
        return self.stream

    def __exit__(self, *exc) -> None:
        self.close()
