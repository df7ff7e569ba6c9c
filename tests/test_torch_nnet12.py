"""The port's nnet1 and nnet2 families against the JAX package's, on the CPU.

The p-norm, radial normalisation and whitening fixed affine equal the JAX
functions within 1e-6; both networks' loglikes from carried parameters
(convert.am_nnet1_from_jax / am_nnet2_from_jax: the JAX-trained weights,
priors and nnet1's feature transform) within 1e-5.  The trainers
run in lockstep from shared weights on a few random utterances: nnet1's
frame-shuffled SGD with newbob for 3 epochs takes the JAX package's
accept / reject / halving decisions (read from its log) and ends within
1e-5 of its parameters (of each tensor's max|ref|) with equal priors, Xent
and Mse; nnet2's parallel SGD with averaging, 3 iterations, within 1e-5 with
SGD, and Adam's trained model's CE within 1e-4 (Adam parts elements whose
gradient is float noise by up to 2·lr, the neural training tests' rule).  `-m slow`: the JAX
tests' yesno flows of both families through recipes/nnet12.py, WER ≤ 2.0."""

import tests.torch_threads  # noqa: F401
import logging
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.models.nnet1 as j1
import old_kaldi_git_tpu.models.nnet2 as j2
import old_kaldi_git_tpu_torch.models.nnet1 as t1
import old_kaldi_git_tpu_torch.models.nnet2 as t2
from old_kaldi_git_tpu.models.tdnn import splice as jsplice
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.recipes.triphone import splice_numpy


def _data(seed=0, n=10, dim=5, pdfs=7):
    rng = np.random.default_rng(seed)
    feats = {f"u{i:02d}": rng.normal(size=(int(rng.integers(30, 60)), dim)).astype(np.float32)
             for i in range(n)}
    labels = {k: rng.integers(0, pdfs, size=len(v)).astype(np.int32) for k, v in feats.items()}
    return feats, labels


def _gap(jparams, model) -> float:
    """The largest |port − JAX| over each tensor's max|JAX|."""
    want = convert.torch_params_from_flax(jparams)
    got = model.state_dict()
    return max(float(np.abs(got[k].numpy() - w).max() / np.abs(w).max())
               for k, w in want.items())


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def jax_log():
    """The messages the JAX nnet1 / nnet2 loggers emit during the test."""
    h = _Records()
    loggers = [logging.getLogger(n) for n in ("okt.nnet1", "okt.nnet2")]
    for lg in loggers:
        lg.addHandler(h)
    yield h.messages
    for lg in loggers:
        lg.removeHandler(h)


@pytest.mark.parametrize("p", [2.0, 3.0])
def test_group_pnorm_equals_the_jax_function(p):
    x = np.random.default_rng(1).normal(size=(3, 7, 12)).astype(np.float32)
    want = np.asarray(j2.group_pnorm(jnp.asarray(x), 4, p))
    np.testing.assert_allclose(t2.group_pnorm(torch.from_numpy(x), 4, p).numpy(), want,
                               atol=1e-6, rtol=0)


def test_radial_normalize_and_fixed_affine_equal_the_jax_functions():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(5, 16)) * 3.0).astype(np.float32)
    np.testing.assert_allclose(t2.radial_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j2.radial_normalize(jnp.asarray(x))), atol=1e-6, rtol=0)
    X = rng.normal(size=(4, 50, 6)).astype(np.float32) @ np.diag(
        [5, 1, 0.2, 3, 1, 1]).astype(np.float32)
    jw, jb, jd = j2.make_fixed_affine(X)
    tw, tb, td = t2.make_fixed_affine(X)
    assert td == jd == 6
    for a, b in ((tw, jw), (tb, jb)):
        np.testing.assert_allclose(np.frombuffer(a, np.float32), np.frombuffer(b, np.float32),
                                   atol=1e-6, rtol=0)
    feats, _ = _data(3)
    sp = np.concatenate([np.asarray(jsplice(jnp.asarray(feats[k][None]), tuple(range(-2, 3))))[0]
                         for k in sorted(feats)])
    assert np.array_equal(sp, np.concatenate([splice_numpy(feats[k], 2, 2)
                                              for k in sorted(feats)]))


def _nnet1_pair(seed=0, **kw):
    cfg = j1.Nnet1Config(5, 7, hidden_dim=16, num_hidden_layers=2, left_context=2,
                         right_context=2, **kw)
    jam = j1.AmNnet1.init(cfg, seed=seed)
    return jam, convert.am_nnet1_from_jax(vars(cfg), jam.params, device="cpu")


def _nnet2_pair(feats, seed=0):
    sp = np.concatenate([splice_numpy(feats[k], 2, 2) for k in sorted(feats)])
    cfg = j2.Nnet2Config(5, 7, left_context=2, right_context=2, pnorm_input_dim=24,
                         pnorm_output_dim=6, fixed_affine=j2.make_fixed_affine(sp))
    jam = j2.AmNnet2.init(cfg, seed=seed)
    return jam, convert.am_nnet2_from_jax(vars(cfg), jam.params, device="cpu")


def _assert_carried_forward(jam, carry, x):
    """The JAX model's loglikes against the port's on its parameters
    carried by `carry` (priors and, for nnet1, the feature transform with
    them), within 1e-5."""
    want = np.asarray(jam.loglikes_batch(x))
    got = carry(jam).loglikes_batch(x).numpy()
    assert got.shape == want.shape == x.shape[:2] + (7,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _carry1(jam):
    return convert.am_nnet1_from_jax(vars(jam.config), jam.params, jam.log_priors,
                                     jam.feat_shift, jam.feat_scale, device="cpu")


def _carry2(jam):
    return convert.am_nnet2_from_jax(vars(jam.config), jam.params, jam.log_priors,
                                     device="cpu")


def _decisions(messages):
    """(epoch, accepted) from the JAX nnet1 log lines."""
    return [(int(m[1]), m[2] == "accepted") for m in
            (re.match(r"nnet1 epoch (\d+): .* (accepted|rejected)$", x) for x in messages) if m]


@pytest.mark.parametrize("loss", ["xent", "mse"])
def test_nnet1_frmshuff_newbob_in_lockstep(jax_log, loss):
    feats, labels = _data(7)
    if loss == "mse":
        w = np.random.default_rng(8).normal(size=(5, 7))
        labels = {k: (feats[k] @ w).astype(np.float32) for k in feats}
    jam, tam = _nnet1_pair(seed=1)
    opts = dict(max_epochs=3, minibatch_size=16, learn_rate=0.5 if loss == "xent" else 0.02,
                momentum=0.5, loss=loss,
                start_halving_impr=0.02 if loss == "xent" else 0.05, cv_fraction=0.2)
    jout = j1.train_nnet1_frmshuff(jam, feats, labels, j1.Nnet1TrainOptions(**opts))
    hist = []
    tout = t1.train_nnet1_frmshuff(tam, feats, labels, t1.Nnet1TrainOptions(**opts),
                                   history=hist)
    assert [(h["epoch"], h["accepted"]) for h in hist] == _decisions(jax_log)
    assert len(hist) >= 2 and any(h["halving"] for h in hist)
    assert _gap(jout.params, tout.model) <= 1e-5
    np.testing.assert_array_equal(tout.feat_shift.numpy(), jout.feat_shift)
    np.testing.assert_array_equal(tout.feat_scale.numpy(), jout.feat_scale)
    if loss == "xent":
        np.testing.assert_array_equal(tout.log_priors.numpy(), jout.log_priors)
        _assert_carried_forward(jout, _carry1, np.stack([feats[k][:30] for k in sorted(feats)]))
    else:
        assert jout.log_priors is None and tout.log_priors is None
        assert hist[0]["accepted"]  # the regression error fell


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_nnet2_parallel_sgd_with_averaging_in_lockstep(jax_log, optimizer):
    feats, labels = _data(9, n=12)
    jam, tam = _nnet2_pair(feats, seed=2)
    opts = dict(num_epochs=3, minibatch_size=2, num_jobs_initial=2, num_jobs_final=3,
                initial_lr=0.05, final_lr=0.01, optimizer=optimizer,
                momentum=0.5 if optimizer == "sgd" else 0.0)
    jout = j2.train_nnet2_parallel(jam, feats, labels, j2.Nnet2TrainOptions(**opts))
    hist = []
    tout = t2.train_nnet2_parallel(tam, feats, labels, t2.Nnet2TrainOptions(**opts),
                                   history=hist)
    jobs = [int(m[1]) for m in (re.match(r"nnet2 iter \d+: (\d+) jobs", x) for x in jax_log)
            if m]
    assert [h["jobs"] for h in hist] == jobs == [2, 2, 3]
    np.testing.assert_array_equal(tout.log_priors.numpy(), jout.log_priors)
    if optimizer == "sgd":
        assert _gap(jout.params, tout.model) <= 1e-5
    x = np.stack([feats[k][:30] for k in sorted(feats)])
    y = np.stack([labels[k][:30] for k in sorted(feats)])

    def ce(logits):
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return -np.take_along_axis(logp, y[..., None], -1).mean()

    _assert_carried_forward(jout, _carry2, x)
    want = ce(np.asarray(jout.logits(x), np.float64))
    got = ce(tout.logits(x).numpy().astype(np.float64))
    assert abs(got - want) <= 1e-4 * abs(want)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.slow
@pytest.mark.parametrize("family", ["nnet1", "nnet2"])
def test_yesno_end_to_end(family):
    """The JAX package's slow yesno flows (tests/test_nnet12.py) on the
    port: WER ≤ 2.0, the JAX package's own gate."""
    from old_kaldi_git_tpu_torch.recipes import nnet12

    system = nnet12.yesno_system("cpu")
    train = nnet12.train_nnet1_yesno if family == "nnet1" else nnet12.train_nnet2_yesno
    stats = nnet12.decode_wer(system, train(system))
    assert stats.wer <= 2.0, stats.report()


def test_nnet1_default_learning_rate_moves_both_packages_alike(jax_log):
    """ROADMAP queue 3: Nnet1TrainOptions' learn_rate 8e-3 is the reference's
    per-frame rate (nnet1 sums the gradient over a minibatch), applied to
    the minibatch's mean CE, so an epoch improves the CV loss by under 2 %
    here (at minilib scale it leaves the CE near uniform: PERF.md §4), in
    both packages alike."""
    feats, labels = _data(10)
    jam, tam = _nnet1_pair(seed=3)
    opts = dict(max_epochs=3, minibatch_size=16, cv_fraction=0.2)
    jout = j1.train_nnet1_frmshuff(jam, feats, labels, j1.Nnet1TrainOptions(**opts))
    hist = []
    tout = t1.train_nnet1_frmshuff(tam, feats, labels, t1.Nnet1TrainOptions(**opts),
                                   history=hist)
    assert [(h["epoch"], h["accepted"]) for h in hist] == _decisions(jax_log)
    assert all(0.0 < h["rel_impr"] < 0.02 for h in hist) and hist[-1]["halving"]
    assert _gap(jout.params, tout.model) <= 1e-5
