"""xconfig front end: the recipes' layer language → TdnnConfig.

Counterpart of old_kaldi_git_tpu/models/xconfig.py (reference
steps/libs/nnet3/xconfig/{parser,layers}.py and
steps/nnet3/xconfig_to_configs.py).  The reference compiles xconfig lines to
nnet3 config text; here they become a TdnnConfig that the port's TdnnModel
runs directly.

Layer types:
  input name=input dim=D
  relu-batchnorm-layer / relu-renorm-layer / relu-batchnorm-dropout-layer
        name=.. dim=D [input=Append(..)] [dropout-proportion=..]
  tdnnf-layer   name=.. dim=D bottleneck-dim=B time-stride=S
        [bypass-scale=..] [dropout-proportion=..]
  fast-lstmp-layer / lstmp-layer  name=.. cell-dim=C recurrent-projection-dim=R
        [non-recurrent-projection-dim=N]
  blstmp-layer  (bidirectional variant)
  pgru-layer / norm-pgru-layer / gru-layer  name=.. cell-dim=C
        [recurrent-projection-dim=R] [non-recurrent-projection-dim=N]
  attention-relu-renorm-layer / attention-layer  name=.. num-heads=H key-dim=K
        value-dim=V num-left-inputs=L num-right-inputs=R [time-stride=S]
  conv-relu-batchnorm-layer / conv-layer  name=.. height-in=H height-out=H'
        num-filters-out=F [time-offsets=-1,0,1] [height-offsets=-1,0,1]
  prefinal-layer name=.. dim=D
  output-layer  name=output dim=NumPdfs

`input=` takes the whole nnet3 Descriptor language (models/descriptor.py):
an Append of integers splices the previous layer (the layer's offsets);
anything else (named cross-layer references, Sum/Scale/Const,
IfDefined/Failover, Round, ReplaceIndex) is kept as the layer's Descriptor
and evaluated by the model over its nodes by name, e.g.
  relu-batchnorm-layer name=tdnn3 dim=512 input=Sum(tdnn2, IfDefined(Offset(tdnn1, -3)))
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from old_kaldi_git_tpu_torch.models.descriptor import parse_descriptor
from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, TdnnLayerSpec
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("xconfig")


def _parse_line(line: str) -> Tuple[str, Dict[str, str]]:
    # whitespace splits tokens except inside brackets, so a Descriptor value
    # such as input=Sum(tdnn2, IfDefined(Offset(tdnn1, -3))) stays one token
    parts: List[str] = []
    depth = 0
    cur = ""
    for ch in line:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch.isspace() and depth == 0:
            if cur:
                parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    kind = parts[0]
    kv: Dict[str, str] = {}
    for tok in parts[1:]:
        if "=" not in tok:
            raise KaldiError(f"xconfig: bad token {tok!r} in {line!r}")
        k, v = tok.split("=", 1)
        kv[k] = v
    return kind, kv


def _offsets(kv: Dict[str, str]) -> Tuple[Tuple[int, ...], str]:
    """(splice offsets, descriptor) for a layer's input= attribute.

    An Append of integers (or Offset(input, n)) splices the previous
    layer: offsets, no Descriptor.  Anything else is validated now and kept
    as the layer's Descriptor."""
    inp = kv.get("input", "")
    if not inp:
        return (0,), ""
    m = re.fullmatch(r"Append\(([-0-9,\s]+)\)", inp)
    if m:
        offs = tuple(int(x) for x in m.group(1).replace(" ", "").split(","))
        return offs, ""
    m = re.fullmatch(r"Offset\(input,\s*(-?\d+)\)", inp)
    if m:
        return (int(m.group(1)),), ""
    parse_descriptor(inp)  # validate now; evaluated by the model
    return (0,), inp


def parse_xconfig(text: str) -> TdnnConfig:
    """The TdnnConfig of an xconfig text; KaldiError on an unknown layer
    type, a malformed token or Descriptor, or a missing input / output line."""
    input_dim = -1
    num_outputs = -1
    final_hidden = 0
    layers: List[TdnnLayerSpec] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        kind, kv = _parse_line(line)
        name = kv.get("name", "")
        if kind == "input":
            input_dim = int(kv["dim"])
        elif kind in ("relu-batchnorm-layer", "relu-renorm-layer",
                      "relu-batchnorm-dropout-layer"):
            offs, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec(
                    "tdnn", int(kv["dim"]), offs, input_desc=desc, name=name,
                    dropout=float(kv.get("dropout-proportion", 0.0)),
                )
            )
        elif kind == "tdnnf-layer":
            _offs_unused, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec(
                    "tdnnf", int(kv["dim"]), input_desc=desc, name=name,
                    bottleneck_dim=int(kv["bottleneck-dim"]),
                    time_stride=int(kv.get("time-stride", 1)),
                    bypass_scale=float(kv.get("bypass-scale", 0.66)),
                    dropout=float(kv.get("dropout-proportion", 0.0)),
                )
            )
        elif kind in ("fast-lstmp-layer", "lstmp-layer", "blstmp-layer"):
            cell = int(kv["cell-dim"])
            rec = int(kv.get("recurrent-projection-dim", max(1, cell // 4)))
            nonrec = int(kv.get("non-recurrent-projection-dim", 0))
            _offs_unused, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec(
                    "blstmp" if kind.startswith("b") else "lstmp", cell,
                    input_desc=desc, name=name,
                    recurrent_dim=rec, nonrecurrent_dim=nonrec,
                )
            )
        elif kind in ("pgru-layer", "norm-pgru-layer", "gru-layer"):
            cell = int(kv["cell-dim"])
            rec = int(kv.get("recurrent-projection-dim", max(1, cell // 4)))
            nonrec = int(kv.get("non-recurrent-projection-dim", 0))
            _offs_unused, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec("pgru", cell, input_desc=desc, name=name,
                              recurrent_dim=rec, nonrecurrent_dim=nonrec)
            )
        elif kind in ("attention-relu-renorm-layer", "attention-layer"):
            _offs_unused, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec(
                    "attention", 0, input_desc=desc, name=name,
                    num_heads=int(kv.get("num-heads", 4)),
                    key_dim=int(kv.get("key-dim", 40)),
                    value_dim=int(kv.get("value-dim", 60)),
                    num_left_inputs=int(kv.get("num-left-inputs", 5)),
                    num_right_inputs=int(kv.get("num-right-inputs", 2)),
                    time_stride=int(kv.get("time-stride", 1)),
                )
            )
        elif kind in ("conv-relu-batchnorm-layer", "conv-layer"):
            h_in = int(kv["height-in"])
            h_out = int(kv.get("height-out", h_in))
            sub = max(1, round(h_in / max(1, h_out)))
            t_off = tuple(int(x) for x in kv.get(
                "time-offsets", "-1,0,1").split(","))
            h_off = tuple(int(x) for x in kv.get(
                "height-offsets", "-1,0,1").split(","))
            _offs_unused, desc = _offsets(kv)
            layers.append(
                TdnnLayerSpec(
                    "conv", int(kv["num-filters-out"]), t_off,
                    input_desc=desc, name=name,
                    height_in=h_in, height_offsets=h_off,
                    height_subsample=sub,
                )
            )
        elif kind == "prefinal-layer":
            final_hidden = int(kv["dim"])
        elif kind == "output-layer":
            num_outputs = int(kv["dim"])
        else:
            raise KaldiError(f"xconfig: unsupported layer type {kind!r}")
    if input_dim <= 0:
        raise KaldiError("xconfig: missing 'input' line with dim")
    if num_outputs <= 0:
        raise KaldiError("xconfig: missing 'output-layer' line with dim")
    cfg = TdnnConfig(
        input_dim, num_outputs, tuple(layers), final_hidden_dim=final_hidden
    )
    log.info(
        "xconfig: %d layers, context -%d/+%d, %d outputs",
        len(layers), cfg.left_context, cfg.right_context, num_outputs,
    )
    return cfg
