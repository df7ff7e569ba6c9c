"""Model surgery: the nnet3-copy --edits language.

Counterpart of old_kaldi_git_tpu/models/edits.py (reference
src/nnet3/nnet-utils.cc ReadEditConfig), directives separated by ';' or
newlines:

  set-learning-rate-factor [name=<glob>] learning-rate-factor=<f>
      per-layer learning-rate factors by top-level module name ('output',
      'prefinal', 'tdnn0', 'tdnnf1', ...), kept on the model
      (`AmNnet.lr_factors`) for an optimizer to apply;
  set-learning-rate [name=<glob>] learning-rate=<f>
      the same, relative to a schedule's base rate of 1.0;
  set-dropout-proportion [name=<glob>] proportion=<p>
      the dropout rate of the matching layer specs;
  remove-output-nodes name=<glob>
      accepted and ignored with a warning: the xent head shares the output
      logits, so there is no separate node to remove.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Dict

from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import TdnnModel
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("edits")


def _parse_kv(tokens):
    out = {}
    for t in tokens:
        if "=" not in t:
            raise KaldiError(f"edit directive token {t!r} is not key=value")
        k, v = t.split("=", 1)
        out[k] = v
    return out


def apply_edits(am: AmNnet, edits: str) -> AmNnet:
    """Apply an edit-config string and return the edited model, a new
    AmNnet on am's device holding a copy of its weights and statistics."""
    lr_factors: Dict[str, float] = dict(am.lr_factors or {})
    config = am.config
    for line in re.split(r"[;\n]", edits):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        op, *rest = line.split()
        kv = _parse_kv(rest)
        name = kv.get("name", "*")
        if op == "set-learning-rate-factor":
            lr_factors[name] = float(kv["learning-rate-factor"])
        elif op == "set-learning-rate":
            lr_factors[name] = float(kv["learning-rate"])
        elif op == "set-dropout-proportion":
            p = float(kv["proportion"])
            layers, n = [], 0
            for i, spec in enumerate(config.layers):
                if fnmatch.fnmatch(f"{spec.kind}{i}", name):
                    layers.append(dataclasses.replace(spec, dropout=p))
                    n += 1
                else:
                    layers.append(spec)
            config = dataclasses.replace(config, layers=tuple(layers))
            log.info("set-dropout-proportion %.3f on %d layers", p, n)
        elif op == "remove-output-nodes":
            log.warning("remove-output-nodes ignored: the xent head shares the "
                        "output logits in this architecture")
        else:
            raise KaldiError(f"unknown edit directive {op!r}")
    model = TdnnModel(config)
    model.load_state_dict(am.model.state_dict())
    out = AmNnet(config, model, None, device=am.device, ivector_dim=am.ivector_dim,
                 lr_factors=lr_factors or None)
    out.log_priors = am.log_priors
    return out
