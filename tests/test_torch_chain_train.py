"""The port's chain (LF-MMI) training against the JAX package's, on the CPU.

The same numpy inputs through both packages:

- the phone LM (orders 2 and 3): arcs, weights, finals and state histories
  exactly;
- the den graph (phone LM ∘ chain topology, power iteration), for the
  monophone and a left-biphone tree of yesno (built from the same port
  alignments and features): every array exactly, the trees pdf for pdf;
- supervision from those alignments (tolerance windows, den-graph weights,
  xent labels): exactly;
- the denominator, dense and sparse, with and without the leaky-HMM term,
  and its gradient against jax.grad: within 1e-5 relative to the largest
  value of each (float32 sums in other orders); the sparse form equals the
  dense one to the same bound;
- each numerator, and chain_loss's metrics and gradient: within 1e-5
  relative (the loss and the objective, a difference of the numerator and
  denominator terms, within 1e-5 of the larger term per frame);
- one chain step (LF-MMI + xent, Adam, max-change) from carried parameters:
  the loss within 1e-4 relative, every parameter within 1e-4 absolute;
- chain_loss of the committed chain.mdl (its den graph converted, 11,456
  states, the sparse form) on the 4 shortest training utterances: the same
  bounds, and the gradient, (γ_den − γ_num) / frames with occupancies that
  cancel for a trained model, within 1e-5 of 1 / frames.
`-m slow`: the biphone chain tree from the 600 training utterances'
features; stage 8 (G, mkgraph, split-eps export) on the committed
chain.mdl against chain_hclg.npz, array for array; the yesno chain e2e."""

import tests.torch_threads  # noqa: F401
import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import old_kaldi_git_tpu.chain.loss as jloss
import old_kaldi_git_tpu.chain.phone_lm as jlm
import old_kaldi_git_tpu.chain.supervision as jsup
import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
import old_kaldi_git_tpu.recipes.chain as jchain
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.chain import loss as tloss
from old_kaldi_git_tpu_torch.chain import phone_lm as tlm
from old_kaldi_git_tpu_torch.chain import supervision as tsup
from old_kaldi_git_tpu_torch.models import train as ttrain
from old_kaldi_git_tpu_torch.recipes import chain as tchain
from old_kaldi_git_tpu_torch.recipes import minilib, yesno
from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
DEN_FIELDS = ("from_state", "to_state", "pdf", "log_prob", "initial_log_probs",
              "final_log_probs", "lm_next", "advance_lm_log_prob")


def close(got, want, rel=None, atol=None):
    want = np.asarray(want)
    tol = atol if atol is not None else rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def same_den(t, j):
    for f in DEN_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.num_states, t.num_pdfs, t.lm_start) == (j.num_states, j.num_pdfs, j.lm_start)
    assert t.arc_lookup == j.arc_lookup


@pytest.mark.parametrize("order", [2, 3])
def test_phone_lm_arcs_and_weights(order):
    rng = np.random.default_rng(order)
    seqs = [rng.integers(1, 9, size=rng.integers(2, 12)).tolist() for _ in range(60)]
    j, t = jlm.estimate_phone_lm(seqs, order), tlm.estimate_phone_lm(seqs, order)
    assert t.start == j.start and t.finals == j.finals
    assert [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs] for arcs in t.arcs] == \
        [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs] for arcs in j.arcs]
    assert t.state_hist == j.state_hist


@pytest.fixture(scope="module")
def yes(tmp_path_factory):
    """yesno: the port's features and a short monophone training on the CPU,
    the model written by the port and read by both packages, and the chain
    objects of a monophone and a left-biphone tree in both."""
    waves, text, _, _ = yesno.make_corpus(24, 8)
    feats = yesno.compute_feats(waves, "cpu")
    lang = yesno.make_lang()
    gmm, ali = train_mono(feats, text, lang, MonoTrainOptions(
        num_iters=4, totgauss=40, realign_iters=(1, 2)), device="cpu")
    path = str(tmp_path_factory.mktemp("yes") / "mono.mdl")
    gmm.save(path)
    jgm = jgmm.AmGmmModel.load(path)
    from old_kaldi_git_tpu.fst.lang import Lang as JLang, Lexicon as JLexicon
    jlang = JLang(JLexicon.from_dict({w: " ".join(p) for w, p in yesno.WORD_PRONS.items()}),
                  silence_phone="SIL", sil_prob=0.5)
    assert jlang.real_phone_ids == lang.real_phone_ids
    objs = {}
    for width in (1, 2):
        kw = dict(phone_lm_order=3, tree_context_width=width, tree_max_leaves=12,
                  tree_thresh=10.0)
        objs[width] = (jchain.build_chain_objects(jgm, ali, jlang,
                                                  jchain.ChainTrainOptions(**kw), feats),
                       tchain.build_chain_objects(gmm, ali, lang,
                                                  tchain.ChainTrainOptions(**kw), feats))
    return dict(feats=feats, text=text, lang=lang, gmm=gmm, jgmm=jgm, ali=ali, objs=objs)


@pytest.mark.parametrize("width", [1, 2])
def test_den_graph_and_tree(yes, width):
    (jcd, jtm, jden), (tcd, ttm, tden) = yes["objs"][width]
    assert tcd.num_pdfs == jcd.num_pdfs and (width == 1 or tcd.num_pdfs > 6)
    phones = yes["lang"].real_phone_ids
    windows = [[p] for p in phones] if width == 1 else \
        [[l, p] for l in [0] + phones for p in phones]
    assert [tcd.compute(w, 0) for w in windows] == [jcd.compute(w, 0) for w in windows]
    assert ttm.tuples == jtm.tuples
    same_den(tden, jden)


def test_supervision_arrays(yes):
    (jcd, _, jden), (tcd, _, tden) = yes["objs"][2]
    keys = sorted(yes["ali"])
    jsups, tsups = [], []
    for k in keys:
        a = yes["ali"][k]
        j = jsup.alignment_to_supervision(a, yes["jgmm"].tm, jcd, 3, 5, 5, den=jden)
        t = tsup.alignment_to_supervision(a, yes["gmm"].tm, tcd, 3, 5, 5, den=tden)
        for f in ("pdf_seq", "allowed", "advance_lp"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert t.num_frames == j.num_frames
        np.testing.assert_array_equal(
            tsup.chain_xent_labels(a, yes["gmm"].tm, tcd, 3, t.num_frames),
            jsup.chain_xent_labels(a, yes["jgmm"].tm, jcd, 3, j.num_frames))
        jsups.append(j)
        tsups.append(t)
    for a, b in zip(tsup.pad_supervisions(tsups), jsup.pad_supervisions(jsups)):
        np.testing.assert_array_equal(a, b)


def jax_values_and_grad(f, x):
    """f(x) [B] and the gradient of its sum, as one compiled program."""
    def both(z):
        vals, vjp = jax.vjp(f, z)
        return vals, vjp(jnp.ones_like(vals))[0]

    vals, grad = jax.jit(both)(jnp.asarray(x))
    return np.asarray(vals), np.asarray(grad)


def den_pair(yes, dense, leaky, logits, nf):
    (_, _, jden), (_, _, tden) = yes["objs"][2]
    limit = 10 ** 9 if dense else 0
    want = jax_values_and_grad(lambda x: jloss.denominator_logprob(
        x, jnp.asarray(nf), jden, leaky, dense_state_limit=limit), logits)
    x = torch.tensor(logits, requires_grad=True)
    tv = tloss.denominator_logprob(x, torch.from_numpy(nf), tden, leaky,
                                   dense_state_limit=limit)
    tv.sum().backward()
    return (tv.detach().numpy(), x.grad.numpy()), want


@pytest.mark.parametrize("leaky", [0.1, 0.0])
def test_denominator_and_gradient(yes, leaky):
    rng = np.random.default_rng(20)
    P = yes["objs"][2][1][0].num_pdfs
    logits = (rng.normal(size=(3, 24, P)) * 3).astype(np.float32)
    nf = np.array([24, 17, 6], np.int32)
    dense = {}
    for d in (True, False):
        (tv, tg), (jv, jg) = den_pair(yes, d, leaky, logits, nf)
        close(tv, jv, rel=1e-5)
        close(tg, jg, rel=1e-5)
        dense[d] = (tv, tg)
    close(dense[False][0], dense[True][0], rel=1e-5)
    close(dense[False][1], dense[True][1], rel=1e-5)


def batch_of(yes, keys, fsf=3):
    (jcd, _, jden), (tcd, _, tden) = yes["objs"][2]
    sups = [tsup.alignment_to_supervision(yes["ali"][k], yes["gmm"].tm, tcd, fsf, 5, 5,
                                          den=tden) for k in keys]
    return tsup.pad_supervisions(sups)


def same_loss(tl, tm, jl, jm, nf):
    """num and den within 1e-5 relative; the loss and the objective, their
    difference over the frames, within 1e-5 of the larger term per frame
    (the subtraction cancels most of their digits)."""
    for k in ("num", "den"):
        close(float(tm[k].detach()), float(jm[k]), rel=1e-5)
    scale = max(abs(float(jm["num"])), abs(float(jm["den"]))) * len(nf) / float(np.sum(nf))
    close(float(tl.detach()), float(jl), atol=1e-5 * scale)
    close(float(tm["objf"].detach()), float(jm["objf"]), atol=1e-5 * scale)


def test_numerator_and_chain_loss(yes):
    (_, _, jden), (tcd, _, tden) = yes["objs"][2]
    pdf_seq, allowed, nf, sl, adv = batch_of(yes, sorted(yes["ali"])[:4])
    rng = np.random.default_rng(21)
    logits = (rng.normal(size=(4, allowed.shape[1], tcd.num_pdfs)) * 2).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (pdf_seq, allowed, nf, sl, adv)]
    targs = [torch.from_numpy(a) for a in (pdf_seq, allowed, nf, sl, adv)]
    def jax_loss(z):  # one trace: the loss, its metrics, each numerator
        loss, metrics = jloss.chain_loss(z, jden, *jargs, jloss.ChainLossOptions())
        return loss, (metrics, jloss.numerator_logprob(z, *jargs, float(jden.loop_log_prob)))

    (jl, (jm, jnum)), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl, tm = tloss.chain_loss(x, tden, *targs, tloss.ChainLossOptions())
    tl.backward()
    tnum = tloss.numerator_logprob(x.detach(), *targs, float(tden.loop_log_prob)).numpy()
    close(tnum, jnum, rel=1e-5)
    same_loss(tl, tm, jl, jm, nf)
    close(float(tm["l2"].detach()), float(jm["l2"]), rel=1e-5)
    close(x.grad.numpy(), jg, rel=1e-5)
    assert np.all(tnum <= tloss.denominator_logprob(x.detach(), targs[2], tden, 0.0).numpy()
                  + 1e-3)


def test_one_chain_step_from_carried_parameters(yes):
    (jcd, _, jden), (tcd, _, tden) = yes["objs"][2]
    keys = sorted(yes["ali"])[:6]
    pdf_seq, allowed, nf, sl, adv = batch_of(yes, keys)
    xent = np.stack([tsup.chain_xent_labels(yes["ali"][k], yes["gmm"].tm, tcd, 3,
                                            allowed.shape[1]) for k in keys])
    T = allowed.shape[1] * 3
    bf = np.zeros((len(keys), T, 39), np.float32)
    for i, k in enumerate(keys):
        f = yes["feats"][k][:T]
        bf[i, : len(f)] = f
    config = jtdnn.make_tdnnf(39, jcd.num_pdfs, 48, 12, 4, subsampled_stride=3,
                              num_full_rate_layers=2)
    j = jam.AmNnet.init(config, seed=3)
    t = convert.am_nnet_from_jax(dataclasses.asdict(config), j.variables, None, device="cpu")
    opts = jtrain.NnetTrainOptions()
    jopt = jtrain.make_optimizer(opts, 10)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(), 10)
    jstep = jchain.make_chain_step(jtdnn.TdnnModel(config), jden, jopt,
                                   jloss.ChainLossOptions(), 3)
    t.model.train()
    tstep = tchain.make_chain_step(t.model, tden, topt, tloss.ChainLossOptions(), 3)
    args = (bf, pdf_seq, allowed, nf, sl, adv, xent)
    jstate = jtrain.TrainState(j.variables["params"], j.variables["batch_stats"],
                               jopt.init(j.variables["params"]), 0)
    jstate, jl, jm = jstep(jstate, *args)
    tstate, tl, tm = tstep(ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0),
                           *args)
    close(float(tl), float(jl), rel=1e-4)
    for k in ("objf", "xent"):
        close(float(tm[k]), float(jm[k]), rel=1e-4)
    want = convert.torch_params_from_flax(jstate.params)
    for k, p in t.model.named_parameters():
        close(p.detach().numpy(), want[k], atol=1e-4)


@pytest.fixture(scope="module")
def committed_chain():
    """chain.mdl in both packages, and the 4 shortest training utterances'
    logits from its network (the port's features on the CPU) with their
    supervision."""
    jcm = jchain.ChainModel.load(os.path.join(WORKDIR, "chain.mdl"))
    tcm = tchain.ChainModel.load(os.path.join(WORKDIR, "chain.mdl"), device="cpu")
    tri = convert.load_am_gmm_model(os.path.join(WORKDIR, "tri.mdl"), device="cpu")
    ali = convert.load_pickle(os.path.join(WORKDIR, "tri_ali.pkl"))
    waves, _ = minilib.training_set(minilib.MinilibOptions())
    keys = sorted(waves, key=lambda k: (len(waves[k]), k))[:4]
    feats = minilib.compute_feats({k: waves[k] for k in keys}, device="cpu")
    sups = [tsup.alignment_to_supervision(ali[k], tri.tm, tcm.ctx_dep, 3, den=tcm.den)
            for k in keys]
    pdf_seq, allowed, nf, sl, adv = tsup.pad_supervisions(sups)
    T = allowed.shape[1] * 3
    x = np.zeros((len(keys), T, 39), np.float32)
    for i, k in enumerate(keys):
        x[i, : min(T, len(feats[k]))] = feats[k][:T]
    logits = tcm.am.logits(x, output_stride=3)[:, : allowed.shape[1]].numpy()
    return jcm, tcm, logits, (pdf_seq, allowed, nf, sl, adv)


def test_chain_loss_of_the_committed_chain_mdl(committed_chain):
    jcm, tcm, logits, arrays = committed_chain
    assert tcm.den.num_states == 11456 and tcm.den.num_states > tloss.DENSE_STATE_LIMIT
    same_den(tcm.den, jcm.den)
    assert tcm.ctx_dep.num_pdfs == 1624 and tcm.tm.tuples == [tuple(x) for x in jcm.tm.tuples]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda z, *a: jloss.chain_loss(z, jcm.den, *a, jloss.ChainLossOptions()),
        has_aux=True))(jnp.asarray(logits), *[jnp.asarray(a) for a in arrays])
    x = torch.tensor(logits, requires_grad=True)
    tl, tm = tloss.chain_loss(x, tcm.den, *[torch.from_numpy(a) for a in arrays])
    tl.backward()
    same_loss(tl, tm, jl, jm, arrays[2])
    # the gradient is (γ_den − γ_num) / frames, occupancies of at most 1
    # that cancel for a trained model: within 1e-5 of 1 / frames
    close(x.grad.numpy(), jg, atol=1e-5 / float(np.sum(arrays[2])))


@pytest.mark.slow
def test_biphone_chain_tree_of_the_training_set():
    """build_chain_objects as stage 7 calls it, on the JAX package's
    features of the 600 training waves, in both packages."""
    from old_kaldi_git_tpu.fst.lang import Lang as JLang, Lexicon as JLexicon
    from old_kaldi_git_tpu.recipes import minilib as jminilib

    opts = jminilib.MinilibOptions()
    sents = jminilib.make_text(opts, opts.num_train, opts.seed + 4, min_len=4, max_len=11)
    waves, _ = jminilib.synth_set(opts, sents, "train", opts.seed + 5)
    feats = jminilib.compute_feats(waves)
    ali = convert.load_pickle(os.path.join(WORKDIR, "tri_ali.pkl"))
    jlang = JLang(JLexicon.from_dict(jminilib.make_lexicon(opts)), silence_phone="SIL",
                  sil_prob=0.5)
    copts = minilib.chain_train_options(minilib.MinilibOptions())
    jcd, jtm, jden = jchain.build_chain_objects(
        jgmm.AmGmmModel.load(os.path.join(WORKDIR, "tri.mdl")), ali, jlang,
        jchain.ChainTrainOptions(**dataclasses.asdict(copts)), feats)
    tcd, ttm, tden = tchain.build_chain_objects(
        convert.load_am_gmm_model(os.path.join(WORKDIR, "tri.mdl"), device="cpu"), ali,
        minilib.make_lang(), copts, feats)
    print("biphone tree:", tcd.num_pdfs, "pdfs; den", tden.num_states, "states",
          len(tden.pdf), "arcs")
    assert tcd.num_pdfs == jcd.num_pdfs
    assert ttm.tuples == jtm.tuples
    same_den(tden, jden)


@pytest.mark.slow
def test_stage_8_rebuilds_the_committed_chain_hclg():
    """G from the pruned trigram, mkgraph at self-loop-scale 1.0, the
    split-eps export, from chain.mdl's tree: chain_hclg.npz array for
    array."""
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa

    tcm = tchain.ChainModel.load(os.path.join(WORKDIR, "chain.mdl"), device="cpu")
    lang = minilib.make_lang()
    with gzip.open(os.path.join(WORKDIR, "arpa.txt.gz"), "rt") as f:
        g = arpa_to_fst(parse_arpa(f.read()), lang.words)
    csr = tchain.make_chain_decode_graph(tcm, lang, g, split_eps=True)
    z = np.load(os.path.join(WORKDIR, "chain_hclg.npz"))
    assert (csr.start, csr.eps_depth) == (int(z["start"]), int(z["eps_depth"]))
    got = {"olab_off": csr.arc_olabels.offsets, "olab_val": csr.arc_olabels.values,
           "folab_off": csr.final_olabels.offsets, "folab_val": csr.final_olabels.values}
    for k in ("row_ptr", "tid", "weight", "nextstate", "final_weight", "eps_ns", "eps_w",
              "eps_olab", "olab_off", "olab_val", "folab_off", "folab_val"):
        np.testing.assert_array_equal(got.get(k, getattr(csr, k, None)), z[k], err_msg=k)


@pytest.mark.slow
def test_chain_e2e_on_yesno():
    """tests/test_chain.py::test_chain_e2e_yesno through the port on the CPU."""
    from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu_torch.recipes.decode import score_hyps

    train_waves, train_text, test_waves, test_text = yesno.make_corpus(24, 8)
    train_feats = yesno.compute_feats(train_waves, "cpu")
    test_feats = yesno.compute_feats(test_waves, "cpu")
    lang = yesno.make_lang()
    gmm, ali = train_mono(train_feats, train_text, lang, MonoTrainOptions(
        num_iters=8, totgauss=60, realign_iters=(1, 2, 3, 4, 6)), device="cpu")
    chain = tchain.train_chain(gmm, train_feats, ali, lang, tchain.ChainTrainOptions(
        num_epochs=40, minibatch_size=8, hidden_dim=128, bottleneck_dim=32, num_layers=3,
        initial_lr=5e-3, final_lr=5e-4), device="cpu")
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    graph = tchain.make_chain_decode_graph(chain, lang, g)
    stats = score_hyps(test_text, tchain.decode_chain(chain, graph, lang, test_feats,
                                                      beam=20.0))
    assert stats.wer == 0.0, stats.report()


@pytest.mark.parametrize("skewed", [False, True])
def test_sparse_map_and_its_transpose(skewed):
    """tloss.SparseMap along the last dimension, one padded width or buckets
    by count: the map and
    its backward (the transposed map) against float64 sums within 1e-6 of
    the largest, rows without terms 0, the same bits twice."""
    rng = np.random.default_rng(30)
    n_in, n_out, nnz = 40, 50, 300
    dst = rng.integers(0, n_out - 5, nnz)  # the last 5 rows have no terms
    if skewed:
        dst[:200] = 3
    src = rng.integers(0, n_in, nnz)
    w = rng.normal(size=nnz).astype(np.float32)
    m = tloss.SparseMap(src, dst, w, n_in, n_out, torch.device("cpu"))
    assert (len(m.forward.buckets) > 1) == skewed
    x = torch.tensor(rng.normal(size=(3, n_in)).astype(np.float32), requires_grad=True)
    y = m(x)  # along the last dimension
    xs = x.detach().numpy().astype(np.float64)
    want = np.zeros((3, n_out))
    np.add.at(want.T, dst, w[:, None].astype(np.float64) * xs.T[src])
    close(y.detach().numpy(), want, rel=1e-6)
    assert not y.detach().numpy()[:, -5:].any()
    g = rng.normal(size=(3, n_out)).astype(np.float32)
    y.backward(torch.from_numpy(g))
    want_g = np.zeros((3, n_in))
    np.add.at(want_g.T, src, w[:, None].astype(np.float64) * g.T.astype(np.float64)[dst])
    close(x.grad.numpy(), want_g, rel=1e-6)
    assert torch.equal(m(x.detach()), y.detach())
