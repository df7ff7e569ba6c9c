"""The GMM slice of the port as a whole, against the JAX package on the CPU:
waves → features → GMM loglikes → decode_batch → words → score.

Tier-1: a toy GMM system (a small random graph, a 40-pdf GMM whose means are
frames of the features, 3 synthesised utterances) through both packages'
decode_dataset and score_hyps.  It runs at acoustic_scale 1.0: see the slow
cases for why the JAX package is not held to the port at 0.1 on its own.

Slow: the committed tri.mdl on the committed HCLG (1,058,721 states) with the
8 shortest held-out utterances, the top-K regime (K = 7000)."""

import tests.torch_threads  # noqa: F401
import dataclasses
import os
import types

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.recipes.decode as jdecode
import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu.utils.batching as jbatching
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.recipes.decode as tdecode
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from old_kaldi_git_tpu_torch import convert
from test_torch_slice import _graph_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
P = 40


def _toy_pdfs(feats, seed):
    """40 pdfs of 1-3 Gaussians, means drawn from the features' frames,
    variances the global ones: loglikes of a realistic spread."""
    rng = np.random.default_rng(seed)
    frames = np.concatenate([feats[k] for k in sorted(feats)]).astype(np.float64)
    var = frames.var(axis=0) + 1e-2
    pdfs = []
    for _ in range(P):
        m = int(rng.integers(1, 4))
        w = rng.random(m) + 0.5
        pdfs.append((w / w.sum(), frames[rng.integers(0, len(frames), m)],
                     np.tile(var, (m, 1))))
    return pdfs


def test_toy_gmm_system_end_to_end():
    jopts = jminilib.MinilibOptions(num_words=300, num_test=3)
    topts = tminilib.MinilibOptions(num_words=300, num_test=3)
    jwaves, jtext = jminilib.synth_set(
        jopts, jminilib.make_text(jopts, 3, 91, min_len=2, max_len=4), "toy", 92)
    twaves, ttext = tminilib.synth_set(
        topts, tminilib.make_text(topts, 3, 91, min_len=2, max_len=4), "toy", 92)
    assert jtext == ttext
    jfeats = jminilib.compute_feats(jwaves)
    tfeats = tminilib.compute_feats(twaves, device="cpu")
    pdfs = _toy_pdfs(tfeats, 93)
    fields = _graph_fields(5)
    words = [f"word{i}" for i in range(50)]
    text = {k: [words[1 + i % 49] for i in range(len(v))] for k, v in ttext.items()}
    opts = dict(beam=12.0, max_active=64, acoustic_scale=1.0)

    jmodel = types.SimpleNamespace(am=jgmm.AmDiagGmm([jgmm.DiagGmm(*p) for p in pdfs]))
    jhyps = jdecode.decode_dataset(jmodel, jcsr.CsrGraph(**fields),
                                   types.SimpleNamespace(words=words), jfeats,
                                   jdecode.DecodeOptions(**opts))
    tmodel = types.SimpleNamespace(am=convert.am_diag_gmm_from_jax(pdfs, device="cpu"))
    failed = []
    thyps = tdecode.decode_dataset(tmodel, tcsr.CsrGraph(**fields), words, tfeats,
                                   tdecode.DecodeOptions(**opts), failed=failed)
    assert sorted(thyps) == sorted(jhyps) == sorted(ttext)
    assert thyps == jhyps and failed == []
    assert all(len(h) > 0 for h in thyps.values())
    jstats = jdecode.score_hyps(text, jhyps)
    tstats = tdecode.score_hyps(text, thyps)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    # an object with a `.words` table is taken as well as the table itself
    again = tdecode.decode_dataset(tmodel, tcsr.CsrGraph(**fields),
                                   types.SimpleNamespace(words=words), tfeats,
                                   tdecode.DecodeOptions(**opts))
    assert again == thyps


def test_decode_dataset_stage_timings():
    rng = np.random.default_rng(4)
    feats = {f"u{i}": rng.normal(size=(n, 39)).astype(np.float32)
             for i, n in enumerate((9, 14))}
    tmodel = types.SimpleNamespace(
        am=convert.am_diag_gmm_from_jax(_toy_pdfs(feats, 5), device="cpu"))
    timings = {}
    hyps = tdecode.decode_dataset(tmodel, tcsr.CsrGraph(**_graph_fields(6)),
                                  [f"w{i}" for i in range(50)], feats,
                                  timings=timings)
    assert sorted(hyps) == ["u0", "u1"]
    assert sorted(timings) == ["host_tail_seconds", "loglikes_seconds", "search_seconds"]
    assert all(v >= 0 for v in timings.values())


# ---------------------------------------------------------------------------
# slow: the committed tri.mdl on the committed HCLG
# ---------------------------------------------------------------------------

NUM_UTTS = 8


@pytest.fixture(scope="module")
def committed_gmm_decode():
    """Both packages' inputs for the 8 shortest held-out utterances and the
    port's decode_dataset at DecodeOptions() (acoustic_scale 0.1), with the
    DecodeResults it made on the way."""
    opts = tminilib.MinilibOptions()
    waves, text = tminilib.make_test_set(opts)
    keys = sorted(waves, key=lambda k: (len(waves[k]), k))[:NUM_UTTS]
    waves = {k: waves[k] for k in keys}
    jsys = jminilib.load_system(WORKDIR, jminilib.MinilibOptions(num_test=4),
                                build_missing=False)
    system = tminilib.load_system(WORKDIR, tminilib.MinilibOptions(num_test=4),
                                  device="cpu")
    model = convert.load_am_gmm_model(os.path.join(WORKDIR, "tri.mdl"), device="cpu")
    jmodel = jgmm.AmGmmModel.load(os.path.join(WORKDIR, "tri.mdl"))

    recorded = []

    def recording_decode_batch(*args, **kwargs):
        recorded.extend(tdecode_batch(*args, **kwargs))
        return recorded

    tdecode_batch = tdecode.decode_batch
    tdecode.decode_batch = recording_decode_batch
    try:
        hyps = tdecode.decode_dataset(model, system.csr, system.words,
                                      tminilib.compute_feats(waves, device="cpu"))
    finally:
        tdecode.decode_batch = tdecode_batch
    jkeys, jpadded, jnf = jbatching.pad_feature_batch(jminilib.compute_feats(waves))
    assert jkeys == sorted(keys)
    jll = np.asarray(jmodel.am.loglikes_batch(jpadded))
    return dict(keys=jkeys, text=text, hyps=hyps, results=recorded, jsys=jsys,
                jll=jll, jnf=jnf)


@pytest.mark.slow
def test_committed_tri_model_matches_the_jax_package(committed_gmm_decode):
    """The port at acoustic_scale 0.1 against the JAX package's decode_batch
    on loglikes × np.float32(0.1) at acoustic_scale 1.0: words, alignments
    and costs (1e-3 relative) equal, all utterances decoded."""
    d = committed_gmm_decode
    o = jdecode.DecodeOptions()
    jres = jvit.decode_batch(d["jsys"].csr, d["jll"] * np.float32(o.acoustic_scale),
                             d["jnf"], jvit.ViterbiOptions(beam=o.beam,
                                                           max_active=o.max_active,
                                                           acoustic_scale=1.0))
    words = d["jsys"].lang.words
    for k, jr, tr in zip(d["keys"], jres, d["results"]):
        assert jr is not None and tr is not None, k
        assert tr.words == jr.words, k
        assert np.array_equal(tr.alignment, jr.alignment), k
        assert tr.cost == pytest.approx(jr.cost, rel=1e-3), k
        assert d["hyps"][k] == [words[w] for w in jr.words], k
    stats = tdecode.score_hyps({k: d["text"][k] for k in d["keys"]}, d["hyps"])
    print(f"tri.mdl, {NUM_UTTS} shortest: both packages {stats.report()}")
    assert stats.errors == 0


@pytest.mark.slow
def test_reference_winner_test_fault_at_acoustic_scale_0_1(committed_gmm_decode):
    """The JAX package's own decode_batch at acoustic_scale 0.1 on the 4
    shortest of these utterances, as a batch of 4, returns None where the
    port decodes (the port's rows do not depend on the batch they ride in).
    Its winner test `cand <= new_alpha[:, ns] + 1e-6` (viterbi.py:352)
    compares two computations of `cand` that XLA on the CPU may round
    differently when the product `acoustic_scale * ll` is inexact; 1e-6 is
    below a float32 ulp at path costs near 1.5e3, so backtraces break.  It
    depends on how XLA compiles the batch: the same call on all 8
    utterances decodes them.  The port computes `cand` once.  If this ever
    fails because the JAX package decodes, the fault is gone and the parity
    target may return to its own scale."""
    d = committed_gmm_decode
    o = jdecode.DecodeOptions()
    shortest = np.argsort(d["jnf"], kind="stable")[:4]
    nf = d["jnf"][shortest]
    jres = jvit.decode_batch(d["jsys"].csr, d["jll"][shortest, : nf.max()], nf,
                             jvit.ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                                 acoustic_scale=o.acoustic_scale))
    failed = [d["keys"][i] for i, r in zip(shortest, jres) if r is None]
    assert all(d["results"][i] is not None for i in shortest)
    print(f"JAX package at acoustic_scale 0.1, batch of 4: {len(failed)} return None")
    assert failed
