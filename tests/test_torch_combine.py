"""Egs, model combination and diagnostics in the port vs the JAX package, on
the CPU.

The in-memory egs (`models/egs.py`): CE egs cut from an utterance with
per-chunk iVectors, chain egs of yesno's biphone chain objects, and their
batches: arrays equal.  `combine_models` (two TDNN-Fs of 3 layers, 64 wide,
carried from the JAX package's initialisation with two seeds, on 10
utterances) and `combine_chain_models` (two chain TDNN-Fs on yesno's chain
egs): the weights within 1e-4 (the JAX package does not return its weights:
they are solved from its combined parameters, which are the weights' sum of
the models'), and the combined objective no worse than at uniform weights.
`compute_prob` and `compute_chain_prob`: within 1e-5 relative."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.diagnostics as jdiag
import old_kaldi_git_tpu.models.egs as jegs
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
import old_kaldi_git_tpu.recipes.chain as jchain
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import diagnostics as tdiag
from old_kaldi_git_tpu_torch.models import egs as tegs
from old_kaldi_git_tpu_torch.models import train as ttrain
from old_kaldi_git_tpu_torch.recipes import chain as tchain
from yesno_chain import yesno_chain_objects

D, P = 13, 40
CONFIG = dict(input_dim=D, num_outputs=P, hidden_dim=64, bottleneck_dim=16, num_layers=3)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def corpus(seed, n_utts=10, T=(70, 200)):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, D)) * 2
    feats, labels = {}, {}
    for u in range(n_utts):
        n = int(rng.integers(*T))
        lab = np.repeat(rng.integers(0, P, size=n // 5 + 1), 5)[:n].astype(np.int32)
        feats[f"u{u:02d}"] = (means[lab] + rng.normal(size=(n, D))).astype(np.float32)
        labels[f"u{u:02d}"] = lab
    return feats, labels


def solved_weights(stacked_params, combined):
    """The weights w with Σ w_m p_m = combined, by least squares over every
    parameter element."""
    A = np.stack([np.concatenate([np.asarray(v, np.float64).ravel() for v in p])
                  for p in stacked_params], axis=1)
    b = np.concatenate([np.asarray(v, np.float64).ravel() for v in combined])
    return np.linalg.lstsq(A, b, rcond=None)[0]


def flat_params(params_tree):
    return [v for _, v in sorted(convert.torch_params_from_flax(params_tree).items())]


@pytest.fixture(scope="module")
def yes():
    return yesno_chain_objects()


def test_ce_egs_and_their_batch():
    feats, labels = corpus(0, n_utts=3)
    rng = np.random.default_rng(1)
    jl, tl = [], []
    for k in sorted(feats):
        iv = rng.normal(size=(len(labels[k]), 4)).astype(np.float32)
        je = jegs.get_ce_egs(feats[k], labels[k], 32, ivectors=iv)
        te = tegs.get_ce_egs(feats[k], labels[k], 32, ivectors=iv)
        assert len(je) == len(te)
        for a, b in zip(je, te):
            for f in ("feats", "labels", "mask", "ivector"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        jl += je
        tl += te
    for jb, tb in zip(jegs.iter_merged(jl, 5), tegs.iter_merged(tl, 5)):
        for a, b in zip(jegs.batch_ce_egs(jb), tegs.batch_ce_egs(tb)):
            np.testing.assert_array_equal(a, b)
    assert [len(b) for b in tegs.iter_merged(tl, 5, drop_last=True)] == \
        [len(b) for b in jegs.iter_merged(jl, 5, drop_last=True)]


def chain_egs(yes, keys, ivec_dim=0):
    (jcd, jtm, jden), (tcd, ttm, tden) = yes["jobj"], yes["tobj"]
    rng = np.random.default_rng(2)
    je, te = [], []
    for k in keys:
        iv = (rng.normal(size=(len(yes["feats"][k]), ivec_dim)).astype(np.float32)
              if ivec_dim else None)
        je += jegs.get_chain_egs(yes["feats"][k], yes["ali"][k], yes["jgmm"].tm, jcd, jden,
                                 ivectors=iv)
        te += tegs.get_chain_egs(yes["feats"][k], yes["ali"][k], yes["gmm"].tm, tcd, tden,
                                 ivectors=iv)
    return je, te


def test_chain_egs_and_their_batch(yes):
    je, te = chain_egs(yes, sorted(yes["ali"])[:5], ivec_dim=3)
    for a, b in zip(jegs.batch_chain_egs(je), tegs.batch_chain_egs(te)):
        np.testing.assert_array_equal(a, b)


def test_combine_models(caplog):
    feats, labels = corpus(3)
    js = [jam.AmNnet.init(jtdnn.make_tdnnf(**CONFIG), seed=s) for s in (4, 5)]
    ts = [convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, j.log_priors,
                                   device="cpu") for j in js]
    jout = jtrain.combine_models(js, feats, labels, num_steps=20)
    report = {}
    tout = ttrain.combine_models(ts, feats, labels, num_steps=20, report=report)
    want = solved_weights([flat_params(j.variables["params"]) for j in js],
                          flat_params(jout.variables["params"]))
    assert np.abs(np.asarray(report["weights"]) - want).max() < 1e-4
    assert report["objf_final"] <= report["objf_uniform"]
    got = {k: v.detach().numpy() for k, v in tout.model.named_parameters()}
    wantp = convert.torch_params_from_flax(jout.variables["params"])
    assert max(rel(got[k], wantp[k]) for k in wantp) < 1e-4


def chain_pair(yes, seeds=(6, 7)):
    (jcd, jtm, jden), (tcd, ttm, tden) = yes["jobj"], yes["tobj"]
    config = jtdnn.make_tdnnf(39, jcd.num_pdfs, 48, 12, 4, subsampled_stride=3,
                              num_full_rate_layers=2)
    jcms, tcms = [], []
    for s in seeds:
        j = jam.AmNnet.init(config, seed=s)
        jcms.append(jchain.ChainModel(j, jcd, jtm, jden, 3))
        t = convert.am_nnet_from_jax(dataclasses.asdict(config), j.variables, None,
                                     device="cpu")
        tcms.append(tchain.ChainModel.from_parts(t, tcd, ttm, tden, 3))
    return jcms, tcms


def test_combine_chain_models(yes):
    jcms, tcms = chain_pair(yes)
    je, te = chain_egs(yes, sorted(yes["ali"])[:8])
    jout = jchain.combine_chain_models(jcms, je, num_steps=10, max_egs=8)
    report = {}
    tchain.combine_chain_models(tcms, te, num_steps=10, max_egs=8, report=report)
    want = solved_weights([flat_params(c.am.variables["params"]) for c in jcms],
                          flat_params(jout.am.variables["params"]))
    assert np.abs(np.asarray(report["weights"]) - want).max() < 1e-4
    assert report["objf_final"] <= report["objf_uniform"]


def test_compute_prob():
    feats, labels = corpus(8, n_utts=6)
    j = jam.AmNnet.init(jtdnn.make_tdnnf(**CONFIG), seed=9)
    t = convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, j.log_priors,
                                 device="cpu")
    del labels["u03"]  # an utterance without labels is left out
    jce, jacc = jdiag.compute_prob(j, feats, labels)
    tce, tacc = tdiag.compute_prob(t, feats, labels)
    assert abs(tce - jce) <= 1e-5 * abs(jce) and abs(tacc - jacc) <= 1e-6


def test_compute_chain_prob(yes):
    jcms, tcms = chain_pair(yes, seeds=(10,))
    keys = sorted(yes["ali"])[:6]
    feats = {k: yes["feats"][k] for k in keys}
    want = jdiag.compute_chain_prob(jcms[0], feats, yes["ali"], yes["jgmm"])
    got = tdiag.compute_chain_prob(tcms[0], feats, yes["ali"], yes["gmm"])
    assert abs(got - want) <= 1e-5 * abs(want)
