"""The port's xconfig parser and nnet3-copy --edits against the JAX
package's on the CPU: every layer type of the xconfig language parses to
an equal TdnnConfig, field by field; the strings the JAX package refuses
are refused; apply_edits gives the same config, learning-rate factors and
weights (exactly: edits copy tensors, they do not compute)."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu.models.edits import apply_edits as japply_edits
from old_kaldi_git_tpu.models.xconfig import parse_xconfig as jparse
from old_kaldi_git_tpu.utils.log import KaldiError as JaxKaldiError
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models.edits import apply_edits
from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from tests.test_torch_architectures import random_jax_am

LINES = [
    "relu-batchnorm-layer name=tdnn1 dim=64 input=Append(-1,0,1)",
    "relu-renorm-layer name=tdnn1 dim=32 input=Offset(input, -2)",
    "relu-batchnorm-dropout-layer name=t dim=16 dropout-proportion=0.2",
    "relu-batchnorm-layer name=t3 dim=24 input=Sum(Offset(input, -1), Scale(0.5, input))",
    "tdnnf-layer name=tdnnf2 dim=64 bottleneck-dim=16 time-stride=3 bypass-scale=0.75",
    "tdnnf-layer name=f dim=40 bottleneck-dim=8 time-stride=0 dropout-proportion=0.1",
    "fast-lstmp-layer name=lstm1 cell-dim=32 recurrent-projection-dim=8",
    "lstmp-layer name=l cell-dim=32 non-recurrent-projection-dim=4",
    "blstmp-layer name=b cell-dim=16 recurrent-projection-dim=4",
    "pgru-layer name=g cell-dim=16 recurrent-projection-dim=8 non-recurrent-projection-dim=2",
    "norm-pgru-layer name=g cell-dim=24",
    "gru-layer name=g cell-dim=12 input=IfDefined(Offset(input, -1))",
    "attention-relu-renorm-layer name=a num-heads=2 key-dim=8 value-dim=8 "
    "num-left-inputs=3 num-right-inputs=1",
    "attention-layer name=a time-stride=3",
    "conv-relu-batchnorm-layer name=c height-in=40 height-out=20 num-filters-out=32",
    "conv-layer name=c height-in=20 height-out=20 num-filters-out=8 time-offsets=-2,0,2 "
    "height-offsets=-1,0",
    "prefinal-layer name=prefinal dim=48",
]

GARBAGE = [
    "relu-batchnorm-layer name=a dim=8\noutput-layer name=o dim=4",  # no input line
    "input name=input dim=8\nweird-layer name=x dim=4\noutput-layer name=o dim=4",
    "input name=input dim=8\nrelu-batchnorm-layer name=a dim=8",  # no output layer
    "input name=input dim=8\nrelu-batchnorm-layer name a\noutput-layer name=o dim=4",
    "input name=input dim=8\nrelu-batchnorm-layer name=a dim=8 input=Bogus(x)\n"
    "output-layer name=o dim=4",
    "input name=input dim=8\nrelu-batchnorm-layer name=a dim=8 input=Sum(x)\n"
    "output-layer name=o dim=4",
]


def _text(line):
    return f"input name=input dim=40\n{line}\noutput-layer name=output dim=100\n"


def test_every_layer_type_parses_to_equal_configs():
    for line in LINES:
        want = dataclasses.asdict(jparse(_text(line)))
        got = dataclasses.asdict(parse_xconfig(_text(line)))
        assert got == want, line
    both = "\n".join(["input name=input dim=40"] + LINES[:3] + LINES[6:8]
                     + ["output-layer name=output dim=100"])
    assert dataclasses.asdict(parse_xconfig(both)) == dataclasses.asdict(jparse(both))


def test_garbage_is_refused():
    for text in GARBAGE:
        with pytest.raises(JaxKaldiError):
            jparse(text)
        with pytest.raises(KaldiError):
            parse_xconfig(text)


EDITS = """set-learning-rate-factor name=tdnn* learning-rate-factor=0.25
set-learning-rate name=output learning-rate=0.5; set-dropout-proportion name=tdnnf* proportion=0.3
remove-output-nodes name=output-xent
# a comment"""


def test_apply_edits_gives_the_same_model():
    text = _text(LINES[0] + "\n" + LINES[4])
    j = random_jax_am(jparse(text), seed=1)
    t = convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, j.log_priors,
                                 device="cpu")
    je, te = japply_edits(j, EDITS), apply_edits(t, EDITS)
    assert dataclasses.asdict(te.config) == dataclasses.asdict(je.config)
    assert te.config.layers[1].dropout == 0.3
    assert te.lr_factors == je.lr_factors == {"tdnn*": 0.25, "output": 0.5}
    want = convert.torch_params_from_flax(je.variables["params"])
    for k, v in te.model.named_parameters():
        assert np.array_equal(v.detach().numpy(), want[k])
    assert torch.equal(te.log_priors, t.log_priors)
    for bad in ("frobnicate name=x", "set-learning-rate-factor 0.5"):
        with pytest.raises(JaxKaldiError):
            japply_edits(j, bad)
        with pytest.raises(KaldiError):
            apply_edits(t, bad)
