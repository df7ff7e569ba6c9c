"""The port's nnet3 Descriptor language against the JAX package's on the
CPU (tests/test_descriptor.py's cases): parse trees and offset ranges equal,
`eval_descriptor` on every operator within 1e-6 absolute (copies, sums of
two float32 values and a scale: exact or one rounding apart), the defined
masks equal; and the xconfig DAG with Sum, IfDefined(Offset), Failover and
Round through both packages' models within 1e-4 of max|ref| (four layers of
sums of at most 72 float32 products in another order)."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.models.descriptor as jdesc
from old_kaldi_git_tpu.models.xconfig import parse_xconfig as jparse_xconfig
from old_kaldi_git_tpu.utils.log import KaldiError as JaxKaldiError
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import descriptor as tdesc
from old_kaldi_git_tpu_torch.models.xconfig import parse_xconfig
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from tests.test_torch_architectures import random_jax_am

EXPRESSIONS = [
    "Append(Offset(a, -3), b, Sum(a, Scale(2.0, b)))",
    "Append(-1, 0, 1)",
    "Offset(a, -2)", "Offset(a, 3)", "Offset(a, 11)",
    "Round(a, 3)", "Round(Offset(a, -1), 3)",
    "ReplaceIndex(a, t, 0)", "ReplaceIndex(b, t, 5)",
    "IfDefined(Offset(a, -3))", "Failover(Offset(a, -3), b)",
    "Sum(a, Scale(-1.0, a))", "Const(0.5, 4)", "Append(a, Const(1.0, 2))",
    "Sum(a, IfDefined(Offset(a, -5)))",
    "Append(Failover(Offset(a, -2), b), Round(Sum(a, b), 3), ReplaceIndex(b, t, 0))",
    "Append(Offset(Round(a, 2), 1), Failover(Offset(b, 2), IfDefined(Offset(a, -1))))",
]

BAD = ["Bogus(a)", "Append(a,)", "Round(a, 0)", "Const(1.0, 0)", "Sum(a)",
       "ReplaceIndex(a, y, 0)", "Failover(a)", "Offset(a, 1", "Append(a) b"]


def _env(T=8, D=3, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(B, T, D)).astype(np.float32)
            for k in ("a", "b", "__prev__")}


def _tree(d):
    return (d.op, d.name, float(d.num), int(d.dim), tuple(_tree(a) for a in d.args))


def test_parse_trees_names_and_ranges_equal():
    for text in EXPRESSIONS:
        got, want = tdesc.parse_descriptor(text), jdesc.parse_descriptor(text)
        assert _tree(got) == _tree(want), text
        assert tdesc.referenced_names(got) == jdesc.referenced_names(want)
        assert tdesc.offset_range(got) == jdesc.offset_range(want)
    assert tdesc.offset_range(tdesc.parse_descriptor("Round(Offset(a, -1), 3)")) == (-3, -1)


def test_garbage_is_refused_as_the_jax_package_refuses_it():
    for text in BAD:
        with pytest.raises(JaxKaldiError):
            jdesc.parse_descriptor(text)
        with pytest.raises(KaldiError):
            tdesc.parse_descriptor(text)


@pytest.mark.parametrize("T", [7, 8])
def test_eval_on_every_operator(T):
    env = _env(T=T)
    tenv = {k: torch.from_numpy(v) for k, v in env.items()}
    for text in EXPRESSIONS:
        want, wmask = jdesc.eval_descriptor(jdesc.parse_descriptor(text), env)
        got, gmask = tdesc.eval_descriptor(tdesc.parse_descriptor(text), tenv)
        assert tuple(got.shape) == want.shape, text
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0, err_msg=text)
        assert np.array_equal(gmask, wmask), text
        dims = {k: v.shape[-1] for k, v in env.items()}
        assert tdesc.descriptor_dim(tdesc.parse_descriptor(text), dims) == want.shape[-1]
    with pytest.raises(KaldiError):
        tdesc.eval_descriptor(tdesc.parse_descriptor(
            "Failover(Offset(a, -3), Append(b, b))"), tenv)
    with pytest.raises(KaldiError):
        tdesc.eval_descriptor(tdesc.parse_descriptor("Sum(a, Append(a, b))"), tenv)


def test_gradients_through_the_gathers():
    """Offset, Round and ReplaceIndex backward: every frame's gradient is the
    count of output frames that read it (sums by reductions, no scatter)."""
    a = torch.ones((1, 7, 2), requires_grad=True)
    d = tdesc.parse_descriptor("Sum(Offset(a, -2), Sum(Round(a, 3), ReplaceIndex(a, t, 6)))")
    v, _ = tdesc.eval_descriptor(d, {"a": a})
    v.sum().backward()
    want = np.zeros(7)
    for t in range(7):
        want[max(0, t - 2)] += 1
        want[(t // 3) * 3] += 1
        want[6] += 1
    np.testing.assert_array_equal(a.grad[0, :, 0].numpy(), want)


XCONFIG_DAG = """
input name=input dim=13
relu-batchnorm-layer name=tdnn1 dim=24 input=Append(-1,0,1)
relu-batchnorm-layer name=tdnn2 dim=24
relu-batchnorm-layer name=tdnn3 dim=24 input=Sum(tdnn2, IfDefined(Offset(tdnn1, -3)))
relu-batchnorm-layer name=tdnn4 dim=24 input=Append(tdnn3, Failover(Offset(tdnn1, -6), tdnn2), Round(tdnn2, 3))
output-layer name=output dim=11
"""


@pytest.mark.parametrize("stride", [1, 3])
def test_xconfig_dag_forward(stride):
    jcfg, tcfg = jparse_xconfig(XCONFIG_DAG), parse_xconfig(XCONFIG_DAG)
    assert (tcfg.left_context, tcfg.right_context) == (jcfg.left_context,
                                                       jcfg.right_context)
    j = random_jax_am(jcfg, seed=1)
    t = convert.am_nnet_from_jax(dataclasses.asdict(jcfg), j.variables, j.log_priors,
                                 device="cpu")
    assert t.config == tcfg
    x = np.random.default_rng(1).normal(size=(2, 31, 13)).astype(np.float32)
    want = np.asarray(j.logits(x, output_stride=stride))
    got = t.logits(x, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
