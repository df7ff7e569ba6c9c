"""Option structs (counterpart of old_kaldi_git_tpu/utils/parse_options.py).

Only the declarative decorator: the command-line parser belongs to the
CLI, which this package does not have yet.
"""

from __future__ import annotations

import dataclasses


def options_dataclass(cls):
    """Decorator: plain dataclass, kept for declarative intent."""
    return dataclasses.dataclass(cls)
