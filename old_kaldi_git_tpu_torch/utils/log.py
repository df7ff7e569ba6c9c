"""Logging and error handling (counterpart of old_kaldi_git_tpu/utils/log.py).

stderr logging with file:line provenance, the framework's fatal-error
exception type and the verbosity level the CLI's --verbose sets.
"""

from __future__ import annotations

import logging
import sys


class KaldiError(RuntimeError):
    """Fatal framework error (reference: KALDI_ERR throws std::runtime_error)."""


_FORMAT = "%(levelname).1s %(asctime)s %(name)s %(filename)s:%(lineno)d] %(message)s"
_ROOT = "okt_torch"


def get_logger(name: str = _ROOT) -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_verbose_level(level: int) -> None:
    """--verbose=N: N >= 1 enables DEBUG (reference KALDI_VLOG semantics)."""
    get_logger()
    logging.getLogger(_ROOT).setLevel(logging.DEBUG if level >= 1 else logging.INFO)
