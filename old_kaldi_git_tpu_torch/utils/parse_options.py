"""Option structs and the command-line parser (counterpart of
old_kaldi_git_tpu/utils/parse_options.py; reference src/util/parse-options.h).

Every tool registers typed options (possibly from nested option structs with
name prefixes) and gets ``--config=file.conf``, ``--print-args``,
``--verbose`` and ``--help``; the Kaldi flag spelling ``--dotted-names`` maps
to ``snake_case`` fields.
"""

from __future__ import annotations

import dataclasses
import shlex
import sys
from typing import Any, Dict, List, Optional

from old_kaldi_git_tpu_torch.utils.log import KaldiError, set_verbose_level


def options_dataclass(cls):
    """Decorator: plain dataclass, kept for declarative intent."""
    return dataclasses.dataclass(cls)


def _parse_value(text: str, current: Any) -> Any:
    if isinstance(current, bool):
        return text.lower() in ("true", "t", "1", "yes")
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    if isinstance(current, (list, tuple)):
        elem = current[0] if current else ""
        return type(current)(_parse_value(x, elem) for x in text.split(","))
    return text


class ParseOptions:
    def __init__(self, usage: str):
        self.usage = usage
        self._targets: Dict[str, tuple] = {}  # flag -> (obj, field)
        self._docs: Dict[str, str] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, obj: Any, field: str, doc: str = "") -> None:
        self._targets[name] = (obj, field)
        self._docs[name] = doc

    def register_dataclass(self, obj: Any, prefix: str = "") -> Any:
        for f in dataclasses.fields(obj):
            flag = f.name.replace("_", "-")
            if prefix:
                flag = f"{prefix}-{flag}"
            self.register(flag, obj, f.name, str(f.metadata.get("doc", "")))
        return obj

    # -- parsing -----------------------------------------------------------
    def _set(self, flag: str, text: str) -> None:
        if flag not in self._targets:
            raise KaldiError(f"unknown option --{flag}\n{self.print_usage()}")
        obj, field = self._targets[flag]
        setattr(obj, field, _parse_value(text, getattr(obj, field)))

    def parse(self, argv: Optional[List[str]] = None) -> List[str]:
        """Returns positional args; applies flags to registered objects."""
        argv = list(sys.argv[1:] if argv is None else argv)
        positional: List[str] = []
        print_args = False
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--":
                positional.extend(argv[i + 1 :])
                break
            if a.startswith("--"):
                body = a[2:]
                if "=" in body:
                    flag, _, val = body.partition("=")
                else:
                    flag, val = body, "true"
                if flag == "help":
                    print(self.print_usage(), file=sys.stderr)
                    raise SystemExit(0)
                elif flag == "config":
                    self._read_config(val)
                elif flag == "verbose":
                    set_verbose_level(int(val))
                elif flag == "print-args":
                    print_args = val.lower() in ("true", "t", "1", "yes")
                else:
                    self._set(flag, val)
            else:
                positional.append(a)
            i += 1
        if print_args:
            print(" ".join(shlex.quote(a) for a in sys.argv), file=sys.stderr)
        return positional

    def _read_config(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if not line.startswith("--"):
                    raise KaldiError(f"bad config line {line!r} in {path}")
                body = line[2:]
                flag, _, val = body.partition("=")
                self._set(flag, val if val else "true")

    def print_usage(self) -> str:
        lines = [self.usage, "", "Options:"]
        for flag in sorted(self._targets):
            obj, field = self._targets[flag]
            cur = getattr(obj, field)
            doc = self._docs.get(flag, "")
            lines.append(f"  --{flag:<30} {doc} (default: {cur})")
        lines += [
            "  --config=FILE                  read options from config file",
            "  --verbose=N                    verbosity level",
            "  --print-args=BOOL              log the command line",
        ]
        return "\n".join(lines)
