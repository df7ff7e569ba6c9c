"""BASELINE config 2 (LDA+MLLT, fMLLR, SAT) in the port against the JAX
package, on the CPU, at run_all's yesno scale.

The inputs are shared: the JAX package's statics of the 24 training and 8
test utterances, and a tri1 model and its alignments trained once by the
port's run_all stages 0-20 and read by both packages (the `.mdl` file,
whose <DiagGMM> layout both read and write, and the `ivec` archive).  Then
`train_lda_mllt` at run_all's options (60 leaves, target_dim 20, MLLT
after iterations 2 and 4, 8 iterations towards 60 Gaussians) runs through
both packages in lockstep: the JAX package's alignment on loglikes
pre-scaled by np.float32(0.1) at acoustic scale 1.0 (the GMM alignment's
parity rule, ROADMAP queue 3).  Held: the LDA transform and each MLLT
matrix within 1e-6 relative, rows up to sign (both solve in float64 numpy
on statistics that differ in float order), the tree (its bytes), the
Gaussian count at every iteration, the tids at every alignment pass and
the final tids of all 24 utterances.  `estimate_fmllr_per_speaker` on the
test set (the two-pass decode of run_all's stage 40) and `train_sat` at
yesno scale are held the same way; `decode_dataset_with_lattices` gives
the JAX package's lattices arc for arc on the same pre-scaled loglikes.
Recorded, not repaired (both packages share them): the starved leaves of
the 60-leaf trees (3 counts or fewer, which take the global statistics
that count the first leaf twice) and the words on the yesno HCLG's final
states (the lattices drop them)."""

import tests.torch_threads  # noqa: F401
import dataclasses
import io

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.recipes.gmm_common as jgc
import old_kaldi_git_tpu.recipes.triphone as jtri
import old_kaldi_git_tpu.recipes.yesno as jyes
import old_kaldi_git_tpu_torch.recipes.gmm_common as tgc
import old_kaldi_git_tpu_torch.recipes.triphone as ttri
from old_kaldi_git_tpu.decoder.csr import fst_to_csr
from old_kaldi_git_tpu.decoder.graph import mkgraph
from old_kaldi_git_tpu.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu.gmm.diag_gmm import AmGmmModel as JModel
from old_kaldi_git_tpu.recipes.decode import DecodeOptions as JDecodeOptions
from old_kaldi_git_tpu.recipes.decode import decode_dataset_with_lattices as jlattices
from old_kaldi_git_tpu.utils.table import read_table as jread_table
from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.recipes import run_all, yesno
from old_kaldi_git_tpu_torch.recipes.decode import DecodeOptions, decode_dataset_with_lattices
from old_kaldi_git_tpu_torch.recipes.gmm_common import GmmTrainOptions

SCALE = np.float32(0.1)
FAST = dict(num_iters=8, totgauss=60, realign_iters=(1, 2, 3, 4, 6))
TRANSFORM_TOL = 1e-6


def _jax_align_batch(graphs, ll, nf, vopts):
    return jvit.align_batch(graphs, np.asarray(ll) * SCALE, nf,
                            jvit.ViterbiOptions(beam=vopts.beam, acoustic_scale=1.0))


def _recorder(fn, passes):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        passes.append(out[0])
        return out
    return wrapped


def _rows_rel(got, want) -> float:
    """Largest difference relative to the largest element, each row of
    `got` taken with the sign that brings it nearer `want`'s."""
    got, want = np.asarray(got), np.asarray(want)
    sign = np.where((got * want).sum(axis=1, keepdims=True) < 0, -1.0, 1.0)
    return float(np.abs(sign * got - want).max() / np.abs(want).max())


def _tree_bytes(tree) -> bytes:
    f = io.BytesIO()
    tree.write(f)
    return f.getvalue()


def _leaf_counts(stats, tree):
    counts = np.zeros(tree.num_pdfs)
    for event, st in stats.items():
        d = dict(event)
        counts[tree.compute([d[i] for i in range(tree.N)], d[-1])] += st.count
    return counts


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("run_all"))
    pipe = run_all.build_pipeline(wd, device="cpu")
    pipe._stages[:] = [s for s in pipe._stages if s[0] <= 20]
    pipe.run()
    tw, tt, sw, st = jyes.make_corpus(run_all.NUM_TRAIN, run_all.NUM_TEST)
    return dict(
        wd=wd, text=tt, test_text=st,
        statics=jyes.compute_static_feats(tw), test_statics=jyes.compute_static_feats(sw),
        jtri1=JModel.load(f"{wd}/tri1/final.mdl"),
        ttri1=AmGmmModel.load(f"{wd}/tri1/final.mdl", device="cpu"),
        ali=jread_table(f"ark:{wd}/tri1/ali.ark", "ivec"),
        jlang=jyes.make_lang(), tlang=yesno.make_lang())


@pytest.fixture(scope="module")
def lockstep(shared):
    mp = pytest.MonkeyPatch()
    rec = {k: [] for k in ("jpasses", "tpasses", "jgauss", "jm", "tm", "jtree", "ttree")}
    update = jgc.mle_am_diag_gmm_update

    def jax_update(am, accs, opts):
        rec["jgauss"].append(am.num_gauss)
        return update(am, accs, opts)

    def keep(fn, key):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec[key].append((args[0], out))
            return out
        return wrapped

    mp.setattr(jgc, "align_batch", _jax_align_batch)
    mp.setattr(jgc, "align_all", _recorder(jgc.align_all, rec["jpasses"]))
    mp.setattr(jgc, "mle_am_diag_gmm_update", jax_update)
    mp.setattr(tgc, "align_all", _recorder(tgc.align_all, rec["tpasses"]))
    mp.setattr(jtri, "update_mllt", keep(jtri.update_mllt, "jm"))
    mp.setattr(ttri, "update_mllt", keep(ttri.update_mllt, "tm"))
    mp.setattr(jtri, "build_tree", keep(jtri.build_tree, "jtree"))
    mp.setattr(ttri, "build_tree", keep(ttri.build_tree, "ttree"))
    kw = dict(num_leaves=60, target_dim=20, mllt_iters=(2, 4))
    try:
        jres = jtri.train_lda_mllt(shared["statics"], shared["text"], shared["jlang"],
                                   shared["jtri1"], shared["ali"],
                                   opts=jgc.GmmTrainOptions(**FAST), **kw)
        history = []
        tres = ttri.train_lda_mllt(shared["statics"], shared["text"], shared["tlang"],
                                   shared["ttri1"], shared["ali"],
                                   opts=GmmTrainOptions(**FAST), device="cpu",
                                   history=history, **kw)
    finally:
        mp.undo()
    return dict(rec, jres=jres, tres=tres, history=history)


def test_lda_mllt_transform_and_tree_equal_the_jax_packages(lockstep):
    jres, tres = lockstep["jres"], lockstep["tres"]
    assert tres.transform.shape == jres.transform.shape == (20, 91)
    assert _rows_rel(tres.transform, jres.transform) <= TRANSFORM_TOL
    assert len(lockstep["tm"]) == len(lockstep["jm"]) == 2
    for (_, (tm, _)), (_, (jm, _)) in zip(lockstep["tm"], lockstep["jm"]):
        assert _rows_rel(tm, jm) <= TRANSFORM_TOL
    assert _tree_bytes(tres.ctx_dep) == _tree_bytes(jres.ctx_dep)
    assert tres.ctx_dep.num_pdfs == jres.ctx_dep.num_pdfs


def test_lda_mllt_trains_in_lockstep_with_the_jax_package(lockstep):
    jp, tp = lockstep["jpasses"], lockstep["tpasses"]
    # three segments (2, 2 and 4 iterations): 1 + 3 realignments + a final pass
    assert len(tp) == len(jp) == 8
    for j, t in zip(jp, tp):
        assert [a is None for a in j] == [a is None for a in t]
        assert all(a is None or np.array_equal(a, b) for a, b in zip(j, t))
    hist = lockstep["history"]
    assert [h["gaussians"] for h in hist] == lockstep["jgauss"]
    assert [h["segment"] for h in hist] == [0, 0, 1, 1, 2, 2, 2, 2]
    jres, tres = lockstep["jres"], lockstep["tres"]
    assert tres.model.am.num_gauss == jres.model.am.num_gauss
    assert sorted(tres.alignments) == sorted(jres.alignments) and len(tres.alignments) == 24
    assert all(np.array_equal(tres.alignments[k], jres.alignments[k]) for k in jres.alignments)


def test_starved_leaves_of_the_60_leaf_tree_in_both_packages(lockstep):
    (jstats, jtree), = lockstep["jtree"]
    (tstats, ttree), = lockstep["ttree"]
    jc, tc = _leaf_counts(jstats, jtree), _leaf_counts(tstats, ttree)
    np.testing.assert_allclose(tc, jc, rtol=1e-9)
    starved = int((jc <= 3.0).sum())
    print(f"STARVED_LEAVES {starved} of {len(jc)} (counts {sorted(jc)[:5]})")
    assert int((tc <= 3.0).sum()) == starved


def _graphs(shared, jres, tres):
    jg = make_unigram_grammar_fst(list(shared["text"].values()), shared["jlang"].words)
    jcsr = fst_to_csr(mkgraph(shared["jlang"], jg, jres.ctx_dep, jres.model.tm),
                      jres.model.tm.tid_to_pdf_array())
    tg = run_all.make_unigram_grammar_fst(list(shared["text"].values()),
                                          shared["tlang"].words)
    return jcsr, mkgraph_csr(shared["tlang"], tg, tres.ctx_dep, tres.model.tm)


def _lda_feats(statics, transform):
    return {k: (jtri.splice_numpy(v) @ transform.T).astype(np.float32)
            for k, v in statics.items()}


def test_fmllr_per_speaker_equals_the_jax_packages(shared, lockstep):
    jres, tres = lockstep["jres"], lockstep["tres"]
    feats = _lda_feats(shared["test_statics"], jres.transform)
    utt2spk = {k: k.split("_")[0] for k in feats}
    # the test set aligned to its reference text with the JAX model, as
    # stage 40 aligns the first pass's words
    gc = jtri.GraphCompiler(shared["jlang"], jres.ctx_dep, jres.model.tm)
    keys, fp, nf = jgc.pad_feats(feats)
    graphs = [gc.compile_csr_from_text(shared["test_text"][k]) for k in keys]
    alis, _ = _jax_align_batch(graphs, jres.model.am.loglikes_batch(fp), nf,
                               jvit.ViterbiOptions(beam=32.0))
    ali = {k: a for k, a in zip(keys, alis) if a is not None}
    assert len(ali) == 8
    want = jtri.estimate_fmllr_per_speaker(jres.model, feats, ali, utt2spk, min_count=50.0)
    got = ttri.estimate_fmllr_per_speaker(tres.model, feats, ali, utt2spk, min_count=50.0)
    assert list(got) == list(want) == ["test"]
    assert np.abs(got["test"] - want["test"]).max() <= 1e-6 * np.abs(want["test"]).max()
    # one utterance a speaker: each under min_count=500 is refused, as there
    per_utt = {k: k for k in feats}
    assert ttri.estimate_fmllr_per_speaker(tres.model, feats, ali, per_utt,
                                           min_count=500.0) == {}
    assert jtri.estimate_fmllr_per_speaker(jres.model, feats, ali, per_utt,
                                           min_count=500.0) == {}


def test_lattices_equal_the_jax_packages_on_the_same_loglikes(shared, lockstep):
    jres, tres = lockstep["jres"], lockstep["tres"]
    jcsr, tcsr = _graphs(shared, jres, tres)
    for name in ("start", "final_weight", "arc_ilabel" if hasattr(jcsr, "arc_ilabel")
                 else "tid"):
        assert np.array_equal(np.asarray(getattr(tcsr, name)), np.asarray(getattr(jcsr, name)))
    # no final state of the yesno HCLG carries words, so these lattices lose
    # none (ROADMAP queue 3: the lattice builders drop a final state's words)
    assert len(tcsr.final_olabels.values) == 0
    assert all(len(jcsr.final_olabels[s]) == 0 for s in range(jcsr.num_states))
    feats = _lda_feats(shared["test_statics"], jres.transform)
    tmodel = AmGmmModel(tres.model.tm, tres.model.am)
    want_model = JModel(jres.model.tm, jres.model.am)
    scaled = want_model.am.loglikes_batch
    want_model.am.loglikes_batch = lambda x: np.asarray(scaled(x)) * SCALE
    want = jlattices(want_model, jcsr, shared["jlang"], feats,
                     JDecodeOptions(beam=20.0, acoustic_scale=1.0), lattice_beam=12.0)
    got = decode_dataset_with_lattices(tmodel, tcsr, shared["tlang"], feats,
                                       DecodeOptions(beam=20.0), lattice_beam=12.0)
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        g, w = got[k], want[k]
        assert g.num_states == w.num_states and g.finals == w.finals
        for ga, wa in zip(g.arcs, w.arcs):
            assert [(a.ilabel, a.olabel, a.nextstate) for a in ga] == [
                (a.ilabel, a.olabel, a.nextstate) for a in wa]
            # the port's acoustic costs are the unscaled loglikes, the JAX
            # package's here the pre-scaled ones
            np.testing.assert_allclose([(a.graph_cost, a.acoustic_cost * SCALE) for a in ga],
                                       [(a.graph_cost, a.acoustic_cost) for a in wa],
                                       rtol=1e-5, atol=1e-4)


def test_train_sat_in_lockstep_with_the_jax_package(shared, lockstep):
    feats = _lda_feats(shared["statics"], lockstep["jres"].transform)
    prev_j, prev_t = lockstep["jres"].model, lockstep["tres"].model
    ali = lockstep["jres"].alignments
    utt2spk = {k: f"spk{int(k.split('_')[1]) % 3}" for k in feats}
    opts = dict(num_leaves=60, fmllr_iters=(2, 4))
    jpasses, tpasses = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgc, "align_batch", _jax_align_batch)
        mp.setattr(jgc, "align_all", _recorder(jgc.align_all, jpasses))
        mp.setattr(tgc, "align_all", _recorder(tgc.align_all, tpasses))
        jm, jtree, jw, jali = jtri.train_sat(feats, shared["text"], shared["jlang"], prev_j,
                                             ali, utt2spk, opts=jgc.GmmTrainOptions(**FAST),
                                             **opts)
        tm, ttree, tw, tali = ttri.train_sat(feats, shared["text"], shared["tlang"], prev_t,
                                             ali, utt2spk, opts=GmmTrainOptions(**FAST),
                                             device="cpu", **opts)
    assert _tree_bytes(ttree) == _tree_bytes(jtree)
    assert sorted(tw) == sorted(jw) == ["spk0", "spk1", "spk2"]
    for s in jw:
        assert np.abs(tw[s] - jw[s]).max() <= 1e-5 * np.abs(jw[s]).max(), s
    assert len(tpasses) == len(jpasses) == 8
    for j, t in zip(jpasses, tpasses):
        assert all(a is None or np.array_equal(a, b) for a, b in zip(j, t))
    assert tm.am.num_gauss == jm.am.num_gauss
    assert all(np.array_equal(tali[k], jali[k]) for k in jali)


MINILIB_LDA_MLLT = dict(num_leaves=2000, target_dim=40, mllt_iters=(2, 4, 6))


def minilib_lda_mllt_record(res, history, tm, tri_ali) -> dict:
    """The record chip_smoke.py holds the card to: the tree's leaf digests
    (the events of tri_ali.pkl's tree statistics, which the alignments alone
    fix), the Gaussians before each iteration's update and the final count,
    the like/frame of each iteration, and the final transform (float32,
    zlib, base64)."""
    import base64
    import zlib

    from old_kaldi_git_tpu_torch.tree import build_tree as tbt

    stats = {}
    for k, a in tri_ali.items():
        tbt.accumulate_tree_stats(a, np.zeros((len(a), 1)), tm, stats=stats)
    return {"leaf_digests": "".join(tbt.leaf_digests(res.ctx_dep, stats)),
            "gaussians": [h["gaussians"] for h in history],
            "gaussians_final": res.model.am.num_gauss,
            "like_per_frame": [h["like_per_frame"] for h in history],
            "transform": base64.b64encode(zlib.compress(
                res.transform.astype("<f4").tobytes(), 9)).decode()}


@pytest.mark.slow
def test_minilib_lda_mllt_on_the_cpu():
    # the record of chip_smoke.py's lda_mllt_minilib phase: the 600 training
    # utterances' statics, tri.mdl and tri_ali.pkl, 2,000 leaves, 40
    # dimensions, 8 iterations in segments of 2, 2, 2 and 2 with 3 MLLT
    # updates (about 15 minutes on this box's CPU)
    import json
    import os
    import time

    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.feat.compute import compute_utterance_feats
    from old_kaldi_git_tpu_torch.recipes import minilib

    opts = minilib.MinilibOptions()
    waves, text = minilib.training_set(opts)
    statics = compute_utterance_feats(waves, minilib.SAMP_FREQ, torch.device("cpu"),
                                      deltas=False, chunk=minilib.FEAT_CHUNK)
    workdir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "exp", "minilib")
    tri = AmGmmModel.load(os.path.join(workdir, "tri.mdl"), device="cpu")
    tri_ali = convert.load_pickle(os.path.join(workdir, "tri_ali.pkl"))
    history, timings = [], {}
    t0 = time.perf_counter()
    res = ttri.train_lda_mllt(statics, text, minilib.make_lang(opts), tri, tri_ali,
                              opts=GmmTrainOptions(num_iters=8, totgauss=4000),
                              device="cpu", history=history, timings=timings,
                              **MINILIB_LDA_MLLT)
    wall = time.perf_counter() - t0
    assert res.ctx_dep.num_pdfs == 2000 and len(history) == 8
    print("LDA_MLLT_CPU_RECORD = " + json.dumps(
        minilib_lda_mllt_record(res, history, tri.tm, tri_ali)))
    print(f"wall {wall:.1f} s; " + json.dumps(timings))
