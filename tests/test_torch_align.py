"""Forced alignment in the port against the JAX package, on the CPU.

align_batch on the yes/no toy and on the 8 shortest training utterances
with `tri.mdl` and `mono.mdl`: the same transition-ids, and scores within
1e-5 relative, on loglikes pre-scaled by np.float32(0.1) at acoustic scale
1.0 (the winner test's 1e-6 is below a float32 ulp at these path costs, so
the JAX package is held to the port on pre-scaled loglikes, ROADMAP queue
3); the port at 0.1 equals the port on the pre-scaled loglikes bit for
bit.  The equal alignment (zero loglikes) exactly.  A too-short utterance
comes back as None in both.  align_all does not depend on its chunking, and
the entry point `minilib.align_training_set` gives align_batch's tids.

Slow: all 600 training utterances with tri.mdl and mono.mdl, and the equal
alignment, through the port's entry point on the CPU, held frame for frame
to the JAX package on the same (pre-scaled) loglikes; it prints the
per-utterance digests that chip_smoke.py commits."""

import tests.torch_threads  # noqa: F401
import os
import zlib

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.csr as jcsr
import old_kaldi_git_tpu.decoder.graph as jgraph
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.recipes import gmm_common, minilib
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from tests.test_decoder import _simulate_loglikes, _toy_system
from tests.test_torch_chain import port_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
SCALE = np.float32(0.1)


def jax_graph(g):
    """The JAX package's CsrGraph over the same arrays as a port CsrGraph."""
    return jcsr.CsrGraph(start=g.start, row_ptr=g.row_ptr, tid=g.tid, pdf=g.pdf,
                         weight=g.weight, nextstate=g.nextstate,
                         final_weight=g.final_weight, arc_olabels=g.arc_olabels,
                         final_olabels=g.final_olabels)


def assert_same_alignment(j, t):
    (ja, js), (ta, ts) = j, t
    assert [a is None for a in ja] == [a is None for a in ta]
    for a, b in zip(ja, ta):
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    js, ts = np.asarray(js), np.asarray(ts)
    ok = np.isfinite(js)
    assert np.array_equal(ok, np.isfinite(ts))
    np.testing.assert_allclose(ts[ok], js[ok], rtol=1e-5)


def digest(tids) -> str:
    """What chip_smoke.py holds the card's alignment to, per utterance."""
    return "--------" if tids is None else f"{zlib.crc32(np.asarray(tids, '<i4').tobytes()):08x}"


@pytest.fixture(scope="module")
def corpus():
    """The port's lang and the 8 shortest training utterances: features
    and transcripts."""
    waves, text = minilib.training_set(minilib.MinilibOptions())
    keys = sorted(waves, key=lambda k: (len(waves[k]), k))[:8]
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device="cpu")
    return minilib.make_lang(), feats, {k: text[k] for k in keys}


def _graphs_and_loglikes(model, corpus):
    lang, feats, text = corpus
    res = minilib.align_training_set(WORKDIR, feats, text, model=model, lang=lang,
                                     device="cpu")
    keys, padded, nf = pad_feature_batch(feats)
    gmm = AmGmmModel.load(os.path.join(WORKDIR, f"{model}.mdl"), device="cpu")
    ll = gmm.am.loglikes_batch(torch.from_numpy(padded)).numpy()
    return res, keys, ll, nf


def test_align_batch_on_the_toy_equals_the_jax_package():
    lang, topo, cd, tm = _toy_system()
    gc = jgraph.GraphCompiler(lang, cd, tm)
    transcripts = [["yes"], ["no"], ["yes", "no"], ["no", "no", "yes"]]
    graphs = [gc.compile_csr_from_text(t) for t in transcripts]

    def phone_ids(words):
        m = {"yes": ["Y", "EH", "S"], "no": ["N", "OW"]}
        return [lang.phones[p] for w in words for p in m[w]]

    rng = np.random.default_rng(3)
    lls = [_simulate_loglikes(tm, cd, lang, phone_ids(t), frames_per_phone=6)
           for t in transcripts]
    T = max(len(x) for x in lls)
    ll = (rng.normal(size=(len(lls), T, cd.num_pdfs)) - 20.0).astype(np.float32)
    nf = np.asarray([len(x) for x in lls], np.int32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x + rng.normal(size=x.shape).astype(np.float32)
    want = jvit.align_batch(graphs, ll, nf, jvit.ViterbiOptions(acoustic_scale=1.0))
    got = tvit.align_batch([port_graph(g) for g in graphs], ll, nf,
                           tvit.ViterbiOptions(acoustic_scale=1.0), device="cpu")
    assert all(a is not None for a in got[0])
    assert_same_alignment(want, got)
    # at 0.1 on the raw loglikes, the port equals itself on pre-scaled ones
    at01 = tvit.align_batch([port_graph(g) for g in graphs], ll, nf,
                            tvit.ViterbiOptions(acoustic_scale=0.1), device="cpu")
    pre = tvit.align_batch([port_graph(g) for g in graphs], ll * SCALE, nf,
                           tvit.ViterbiOptions(acoustic_scale=1.0), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(at01[0], pre[0]))
    assert at01[1] == pre[1]


@pytest.mark.parametrize("model", ["tri", "mono"])
def test_training_utterances_align_as_the_jax_package(model, corpus):
    res, keys, ll, nf = _graphs_and_loglikes(model, corpus)
    graphs = [res.graphs[k] for k in keys]
    want = jvit.align_batch([jax_graph(g) for g in graphs], ll * SCALE, nf,
                            jvit.ViterbiOptions(acoustic_scale=1.0))
    got = tvit.align_batch(graphs, ll * SCALE, nf, tvit.ViterbiOptions(acoustic_scale=1.0),
                           device="cpu")
    assert all(a is not None for a in got[0])
    assert_same_alignment(want, got)
    # the entry point aligned at 0.1 on its own loglikes: the same tids
    assert res.failed == [] and res.frames_scanned == int(nf.max())
    for k, a in zip(keys, got[0]):
        assert np.array_equal(res.alignments[k], a)
        assert len(a) == len(corpus[1][k])
    assert set(res.seconds) == {"lang_seconds", "graphs_seconds", "features_seconds",
                                "loglikes_seconds", "align_seconds"}


def test_equal_alignment_is_exact(corpus):
    lang, feats, text = corpus
    res = minilib.align_training_set(WORKDIR, feats, text, model="mono", equal=True,
                                     lang=lang, device="cpu")
    keys, _, nf = pad_feature_batch(feats)
    graphs = [res.graphs[k] for k in keys]
    zeros = np.zeros((len(keys), int(nf.max()), 125), np.float32)
    want = jvit.align_batch([jax_graph(g) for g in graphs], zeros, nf,
                            jvit.ViterbiOptions(beam=1e9, acoustic_scale=1.0))
    assert res.failed == []
    for k, a in zip(keys, want[0]):
        assert np.array_equal(res.alignments[k], a)
        assert res.scores[k] == want[1][keys.index(k)]


def test_a_too_short_utterance_fails_in_both(corpus):
    res, keys, ll, nf = _graphs_and_loglikes("tri", corpus)
    graphs = [res.graphs[k] for k in keys[:3]]
    nf = nf[:3].copy()
    nf[1] = 4  # fewer frames than the transcript's HMM states
    want = jvit.align_batch([jax_graph(g) for g in graphs], ll[:3] * SCALE, nf,
                            jvit.ViterbiOptions(acoustic_scale=1.0))
    got = tvit.align_batch(graphs, ll[:3] * SCALE, nf,
                           tvit.ViterbiOptions(acoustic_scale=1.0), device="cpu")
    assert want[0][1] is None and got[0][1] is None and got[1][1] == np.inf
    assert got[0][0] is not None and got[0][2] is not None
    assert_same_alignment(want, got)


def test_alignment_does_not_depend_on_the_chunking(corpus):
    lang, feats, text = corpus
    res = minilib.align_training_set(WORKDIR, feats, text, lang=lang, device="cpu")
    keys, padded, nf = pad_feature_batch(feats)
    graphs = [res.graphs[k] for k in keys]
    gmm = AmGmmModel.load(os.path.join(WORKDIR, "tri.mdl"), device="cpu")
    vopts = tvit.ViterbiOptions(acoustic_scale=0.1)
    whole_t = {}
    whole = gmm_common.align_all(gmm.am, graphs, padded, nf, vopts, timings=whole_t)
    assert all(np.array_equal(res.alignments[k], a) for k, a in zip(keys, whole[0]))
    for chunk in (3, 1):
        part_t = {}
        part = gmm_common.align_all(gmm.am, graphs, padded, nf, vopts, max_batch=chunk,
                                    timings=part_t)
        assert part[1] == whole[1]
        assert all(np.array_equal(a, b) for a, b in zip(part[0], whole[0]))
        assert part_t["align_frames"] > whole_t["align_frames"] == int(nf.max())


def test_entry_points_default_to_the_gpu(corpus, monkeypatch):
    lang, feats, text = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minilib.align_training_set(WORKDIR, feats, text, lang=lang)
    g = tcsr.CsrGraph(0, np.array([0, 1], np.int32), np.array([1], np.int32),
                      np.array([0], np.int32), np.zeros(1, np.float32),
                      np.array([0], np.int32), np.zeros(1, np.float32), [()], [()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.align_batch([g], np.zeros((1, 2, 3), np.float32), [2])


# ---------------------------------------------------------------------------
# slow: the whole training set
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_the_training_set_aligns_as_the_jax_package():
    waves, text = minilib.training_set(minilib.MinilibOptions())
    feats = minilib.compute_feats(waves, device="cpu")
    lang = minilib.make_lang()
    for name, model, equal in (("align_tri", "tri", False), ("align_mono", "mono", False),
                               ("align_equal", "mono", True)):
        res = minilib.align_training_set(WORKDIR, feats, text, model=model, equal=equal,
                                         lang=lang, device="cpu")
        keys, padded, nf = pad_feature_batch(feats)
        graphs = [res.graphs[k] for k in keys]
        if equal:
            ll = np.zeros((len(keys), padded.shape[1], 125), np.float32)
        else:
            gmm = AmGmmModel.load(os.path.join(WORKDIR, f"{model}.mdl"), device="cpu")
            ll = gmm.am.loglikes_batch(torch.from_numpy(padded)).numpy() * SCALE
        want = jvit.align_batch([jax_graph(g) for g in graphs], ll, nf,
                                jvit.ViterbiOptions(acoustic_scale=1.0))
        got = [res.alignments.get(k) for k in keys]
        assert [a is None for a in want[0]] == [a is None for a in got]
        same = [a is None or np.array_equal(a, b) for a, b in zip(want[0], got)]
        print(name, "frames", int(nf.sum()), "failed", res.failed,
              "differing from the JAX package", [k for k, s in zip(keys, same) if not s])
        print(name, "digests", "".join(digest(a) for a in got))
        assert all(same)
