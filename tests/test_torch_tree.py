"""The port's tree building and alignment utilities against the JAX
package's, on the CPU.

On the 8 shortest training utterances, with the committed `mono.mdl` and
`mono_ali.pkl` and the port's features (the same numpy arrays into both
packages): the tree statistics (the same events in the same order, every
count, Σx and Σx² equal), the phone-cluster questions, `build_tree` to
about 60 leaves (the same split at every node and the same pdf for every
event), the per-phone split, phones and pdfs of each alignment, and
`convert_alignment` to the built tree (the same tids), all exactly; and
the leaves' single-Gaussian models (`init_am_from_tree_stats`) within
1e-12.

Slow: the full 600-utterance statistics (34,485 events) and the 2,000-leaf
tree, tree for tree; and the port's tree on the JAX package's features of
the same waves, against the tree on its own."""

import tests.torch_threads  # noqa: F401
import gzip
import importlib
import os
import pickle
import time

import numpy as np
import pytest

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.gmm.mle as jmle
import old_kaldi_git_tpu.hmm.transition_model as jtm
import old_kaldi_git_tpu.tree.event_map as jem
import old_kaldi_git_tpu_torch.hmm.hmm_utils as thu
import old_kaldi_git_tpu_torch.hmm.transition_model as ttm
import old_kaldi_git_tpu_torch.gmm.mle as tmle
import old_kaldi_git_tpu_torch.tree.build_tree as tbt
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.recipes import minilib

# the JAX package's tree/__init__ binds `build_tree` to the function
jbt = importlib.import_module("old_kaldi_git_tpu.tree.build_tree")
jhu = importlib.import_module("old_kaldi_git_tpu.hmm.hmm_utils")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")


def structure(node):
    """A tree as nested tuples, the same for both packages' EventMaps."""
    if hasattr(node, "answer"):
        return ("C", node.answer)
    if hasattr(node, "table"):
        return ("T", node.key, tuple((k, structure(v)) for k, v in sorted(node.table.items())))
    return ("S", node.key, tuple(sorted(node.yes_set)), structure(node.yes),
            structure(node.no))


def assert_same_stats(js, ts):
    assert list(js) == list(ts)
    for event, j in js.items():
        t = ts[event]
        assert t.count == j.count
        assert np.array_equal(t.x, j.x) and np.array_equal(t.x2, j.x2)


def load_alignments():
    with gzip.open(os.path.join(WORKDIR, "mono_ali.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def setup():
    waves, _text = minilib.training_set(minilib.MinilibOptions())
    keys = sorted(sorted(waves, key=lambda k: (len(waves[k]), k))[:8])
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device="cpu")
    ali = load_alignments()
    ali = {k: ali[k] for k in keys}
    tmono = AmGmmModel.load(os.path.join(WORKDIR, "mono.mdl"), device="cpu").tm
    jmono = jgmm.AmGmmModel.load(os.path.join(WORKDIR, "mono.mdl")).tm
    js, ts = {}, {}
    for k in keys:
        jbt.accumulate_tree_stats(ali[k], feats[k], jmono, stats=js)
        tbt.accumulate_tree_stats(ali[k], feats[k], tmono, stats=ts)
    lang = minilib.make_lang()
    return dict(feats=feats, ali=ali, tmono=tmono, jmono=jmono, js=js, ts=ts,
                phones=lang.real_phone_ids,
                npc={p: tmono.topo.num_pdf_classes(p) for p in lang.real_phone_ids})


def test_tree_stats_equal_the_jax_package(setup):
    assert len(setup["ts"]) > 200
    assert_same_stats(setup["js"], setup["ts"])


def test_tree_stats_add_to_existing_events_as_the_jax_package(setup):
    """A second pass over the same utterances adds to every event frame by
    frame, after the first pass's sums."""
    js = {e: s.copy() for e, s in setup["js"].items()}
    ts = {e: s.copy() for e, s in setup["ts"].items()}
    k = sorted(setup["ali"])[3]
    jbt.accumulate_tree_stats(setup["ali"][k], setup["feats"][k], setup["jmono"], stats=js)
    tbt.accumulate_tree_stats(setup["ali"][k], setup["feats"][k], setup["tmono"], stats=ts)
    assert_same_stats(js, ts)


def test_questions_equal_the_jax_package(setup):
    jq = jbt.cluster_phones_into_questions(setup["js"], setup["phones"])
    tq = tbt.cluster_phones_into_questions(setup["ts"], setup["phones"])
    assert tq == jq and len(tq) > 20


@pytest.mark.parametrize("leaves", [60, 25])
def test_build_tree_equals_the_jax_package(setup, leaves):
    jc = jbt.build_tree(setup["js"], setup["phones"], setup["npc"], max_leaves=leaves,
                        thresh=20.0)
    tc = tbt.build_tree(setup["ts"], setup["phones"], setup["npc"], max_leaves=leaves,
                        thresh=20.0)
    assert tc.num_pdfs == jc.num_pdfs and (tc.N, tc.P) == (jc.N, jc.P)
    assert structure(tc.root) == structure(jc.root)
    assert [tc.root.map(e) for e in setup["ts"]] == [jc.root.map(e) for e in setup["js"]]


def test_leaf_models_from_tree_stats_equal_the_jax_package(setup):
    """gmm-init-model: a Gaussian per leaf from its pooled stats, the global
    stats for a leaf of 3 counts or fewer (here the phones without data)."""
    jc = jbt.build_tree(setup["js"], setup["phones"], setup["npc"], max_leaves=60,
                        thresh=20.0)
    tc = tbt.build_tree(setup["ts"], setup["phones"], setup["npc"], max_leaves=60,
                        thresh=20.0)
    jam = jmle.init_am_from_tree_stats(jc, setup["js"])
    tam = tmle.init_am_from_tree_stats(tc, setup["ts"], device="cpu")
    assert tam.num_pdfs == jam.num_pdfs == tc.num_pdfs
    fallback = 0
    for tp, jp in zip(tam.pdfs, jam.pdfs):
        fallback += np.array_equal(tp.means, tam.pdfs[-1].means)
        for field in ("weights", "means", "vars"):
            np.testing.assert_allclose(getattr(tp, field), getattr(jp, field), rtol=1e-12,
                                       atol=0)
    assert fallback > 1


def test_a_question_with_the_same_partition_does_not_win():
    """Two questions that split a leaf's events the same way score the same;
    the earlier one is the split, as in the JAX package's scan."""
    rng = np.random.default_rng(2)
    js, ts = {}, {}
    for left in (1, 2, 3):
        for right in (1, 2):
            event = jem.make_event([(-1, 0), (0, left), (1, 1), (2, right)])
            st = jbt.GaussClusterable(3)
            for _ in range(20):
                st.add_sample(rng.normal(loc=left, size=3))
            js[event] = st
            t = tbt.GaussClusterable(3)
            t.count, t.x, t.x2 = st.count, st.x.copy(), st.x2.copy()
            ts[event] = t
    # {1, 4} and {1} both put left context 1 alone on the "yes" side, {2, 3}
    # on the "no" side: all three score the same, and {1, 4} is the split
    questions = [{1, 4}, {1}, {2, 3}, {1, 2, 3}]
    jc = jbt.build_tree(js, [1, 2, 3, 4], {p: 1 for p in (1, 2, 3, 4)},
                        questions=questions, max_leaves=3, thresh=0.0)
    tc = tbt.build_tree(ts, [1, 2, 3, 4], {p: 1 for p in (1, 2, 3, 4)},
                        questions=questions, max_leaves=3, thresh=0.0)
    assert structure(tc.root) == structure(jc.root)
    assert structure(tc.root)[2][0][1][2] == (1, 4)


def test_alignment_utilities_equal_the_jax_package(setup):
    tm, jm = setup["tmono"], setup["jmono"]
    for k, ali in setup["ali"].items():
        assert thu.split_to_phones(tm, ali) == jhu.split_to_phones(jm, ali)
        assert thu.alignment_to_phones(tm, ali) == jhu.alignment_to_phones(jm, ali)
        assert thu.alignment_to_pdfs(tm, ali) == jhu.alignment_to_pdfs(jm, ali)


def test_convert_alignment_equals_the_jax_package(setup):
    jc = jbt.build_tree(setup["js"], setup["phones"], setup["npc"], max_leaves=60,
                        thresh=20.0)
    tc = tbt.build_tree(setup["ts"], setup["phones"], setup["npc"], max_leaves=60,
                        thresh=20.0)
    jnew = jtm.TransitionModel(jc, setup["jmono"].topo)
    tnew = ttm.TransitionModel.from_context_dependency(tc, setup["tmono"].topo)
    assert tnew.tuples == jnew.tuples and tnew.num_pdfs == jnew.num_pdfs
    for k, ali in setup["ali"].items():
        want = jhu.convert_alignment(ali, setup["jmono"], jnew, jc)
        got = thu.convert_alignment(ali, setup["tmono"], tnew, tc)
        assert got.dtype == np.int32 and got.tolist() == want
        assert thu.alignment_to_phones(tnew, got) == jhu.alignment_to_phones(jnew, want)


@pytest.mark.slow
def test_the_full_training_set_builds_the_jax_packages_tree():
    """All 600 training utterances' statistics from the committed
    mono_ali.pkl and the port's CPU features, and the 2,000-leaf tree of
    minilib stage 4, in both packages: the same stats, the same tree.
    Prints the seconds of each and the port's leaf digests."""
    opts = minilib.MinilibOptions()
    waves, _ = minilib.training_set(opts)
    feats = minilib.compute_feats(waves, device="cpu")
    ali = load_alignments()
    tmono = AmGmmModel.load(os.path.join(WORKDIR, "mono.mdl"), device="cpu").tm
    jmono = jgmm.AmGmmModel.load(os.path.join(WORKDIR, "mono.mdl")).tm
    js, ts = {}, {}
    for k, a in ali.items():
        jbt.accumulate_tree_stats(a, feats[k], jmono, stats=js)
    t0 = time.perf_counter()
    for k, a in ali.items():
        tbt.accumulate_tree_stats(a, feats[k], tmono, stats=ts)
    stats_s = time.perf_counter() - t0
    assert len(ts) == 34485
    assert_same_stats(js, ts)
    phones = minilib.make_lang(opts).real_phone_ids
    npc = {p: tmono.topo.num_pdf_classes(p) for p in phones}
    t0 = time.perf_counter()
    jc = jbt.build_tree(js, phones, npc, max_leaves=opts.tree_leaves, thresh=20.0)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc = tbt.build_tree(ts, phones, npc, max_leaves=opts.tree_leaves, thresh=20.0)
    port_s = time.perf_counter() - t0
    assert tc.num_pdfs == jc.num_pdfs == opts.tree_leaves
    assert structure(tc.root) == structure(jc.root)
    digests = tbt.leaf_digests(tc, ts)
    # the tree of the JAX package's features of the same waves (a few 1e-3
    # from the port's): the leaves that hold other events, as chip_smoke.py
    # counts them for the card's tree
    jfeats = importlib.import_module("old_kaldi_git_tpu.recipes.minilib").compute_feats(waves)
    js2 = {}
    for k, a in ali.items():
        tbt.accumulate_tree_stats(a, jfeats[k], tmono, stats=js2)
    other = tbt.leaf_digests(tbt.build_tree(js2, phones, npc, max_leaves=opts.tree_leaves,
                                        thresh=20.0), js2)
    print(f"\ntree stats {stats_s:.2f} s; build_tree: JAX package {jax_s:.1f} s, "
          f"port {port_s:.1f} s; on the JAX package's features "
          f"{len(set(other) - set(digests))} leaves hold other events")
    print("LEAF_DIGESTS", "".join(digests))
