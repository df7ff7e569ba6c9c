"""Flat-start (e2e) LF-MMI in the port against the JAX package on the CPU.

The same numpy inputs (yesno transcripts, the port's features, seeded
random logits) through both packages:

- the full left-biphone tree (biphone_context_dependency), node for node;
- a JAX e2e ChainModel (either tree) saved by the JAX package and read by
  the port's ChainModel.load: tree, den graph, logits within 1e-4;
- the e2e objects (tree, transition model, the phone LM with its
  silence-augmented sequences, den graph) and each utterance's numerator
  (normalize_numerator_csr of its training graph) for the monophone and
  biphone trees: every array exactly, states in the same order;
  NumeratorGraphBatch.from_csr_graphs likewise;
- generic_numerator_logprob within 1e-4 relative, and its gradient against
  jax.grad's within 1e-4 of the largest;
- chain_e2e_loss with seq_weights: loss and metrics within 1e-4; num ≤ den
  on random logits;
- one e2e step (Adam, max-change) from carried parameters at toy widths:
  loss within 1e-4 relative, every parameter within 1e-4;
- train_chain_e2e on the port at toy size: the objective ≤ 0 and rising.
`-m slow`: e2e yesno at the JAX test's sizes (24/8 utterances, 50 epochs,
hidden 128) to a held-out WER ≤ 2.0 on the port."""

import dataclasses

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401
import jax
import jax.numpy as jnp

import old_kaldi_git_tpu.chain.den_graph as jdg
import old_kaldi_git_tpu.chain.e2e as je2e
import old_kaldi_git_tpu.chain.loss as jloss
import old_kaldi_git_tpu.chain.phone_lm as jlm
import old_kaldi_git_tpu.chain.topology as jtopo
import old_kaldi_git_tpu.decoder.graph as jgraph
import old_kaldi_git_tpu.hmm.transition_model as jtm
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
import old_kaldi_git_tpu.recipes.yesno as jyesno
import old_kaldi_git_tpu.tree.context_dep as jcd
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.chain import e2e as te2e
from old_kaldi_git_tpu_torch.chain import loss as tloss
from old_kaldi_git_tpu_torch.models import train as ttrain
from old_kaldi_git_tpu_torch.recipes import chain as tchain, yesno
from old_kaldi_git_tpu_torch.tree.context_dep import biphone_context_dependency, tree_key
from tests.test_torch_chain_train import close, same_den

SIMPLE_FIELDS = ("src", "dst", "pdf", "weight", "final_lp")
BATCH_FIELDS = ("src", "dst", "pdf", "weight", "mask", "init_lp", "final_lp")


def jax_e2e_objects(text, keys, jlang, order, width):
    """The JAX package's train_chain_e2e objects, built as it builds them."""
    phones = jlang.real_phone_ids
    topo = jtopo.chain_topology(phones)
    make = jcd.biphone_context_dependency if width == 2 else jcd.monophone_context_dependency
    ctx = make(phones, {p: 1 for p in phones})
    tm = jtm.TransitionModel(ctx, topo)
    first = {}
    for word, _p, pron in jlang.lexicon.entries:
        first.setdefault(word, [jlang.phones[p] for p in pron])
    seqs = []
    for k in keys:
        seq, seq_sil = [], [jlang.silence_id]
        for w in text[k]:
            seq.extend(first[w])
            seq_sil.extend(first[w])
            seq_sil.append(jlang.silence_id)
        seqs += [seq, seq_sil]
    den = jdg.make_denominator_graph(jlm.estimate_phone_lm(seqs, order), ctx)
    comp = jgraph.GraphCompiler(jlang, ctx, tm)
    graphs = [je2e.normalize_numerator_csr(comp.compile_csr_from_text(text[k]), tm, den)
              for k in keys]
    return ctx, tm, den, graphs


@pytest.fixture(scope="module")
def yes():
    waves, text, _, _ = yesno.make_corpus(8, 2)
    feats = yesno.compute_feats(waves, "cpu")
    keys = sorted(text)
    out = {"feats": feats, "text": text, "keys": keys}
    for width in (1, 2):
        opts = tchain.ChainTrainOptions(phone_lm_order=3, tree_context_width=width)
        tobj = tchain.e2e_chain_objects(text, keys, yesno.make_lang(), opts)
        tgraphs = tchain.numerator_graphs(yesno.make_lang(), *tobj,
                                          [text[k] for k in keys])
        out[width] = (jax_e2e_objects(text, keys, jyesno.make_lang(), 3, width),
                      (*tobj, tgraphs))
    return out


def test_biphone_tree_node_for_node():
    phones = [1, 2, 3, 5]
    ncls = {1: 1, 2: 2, 3: 1, 5: 3}
    t = biphone_context_dependency(phones, ncls)
    j = jcd.biphone_context_dependency(phones, ncls)
    assert tree_key(t) == tree_key(convert.context_dependency_from_pickle(j))
    assert t.num_pdfs == j.num_pdfs == sum(ncls.values()) * 5
    for left in [0] + phones:
        for c in phones:
            for pc in range(ncls[c]):
                assert t.compute([left, c], pc) == j.compute([left, c], pc)


@pytest.mark.parametrize("width", [1, 2])
def test_e2e_objects_and_numerators_array_for_array(yes, width):
    (jctx, jtmod, jden, jgraphs), (tctx, ttmod, tden, tgraphs) = yes[width]
    assert tctx.num_pdfs == jctx.num_pdfs
    assert ttmod.tuples == [tuple(t) for t in jtmod.tuples]
    same_den(tden, jden)
    assert len(tgraphs) == len(jgraphs)
    for t, j in zip(tgraphs, jgraphs):
        assert (t.start, t.num_states) == (j.start, j.num_states)
        for f in SIMPLE_FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
            assert getattr(t, f).dtype == getattr(j, f).dtype
    tb = te2e.NumeratorGraphBatch.from_csr_graphs(tgraphs)
    jb = je2e.NumeratorGraphBatch.from_csr_graphs(jgraphs)
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    idx = np.array([3, 0, 5])
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb.take(idx), f), getattr(jb, f)[idx])


@pytest.mark.parametrize("width", [1, 2])
def test_an_e2e_chain_model_of_the_jax_package_loads_in_the_port(yes, width, tmp_path):
    """A JAX ChainModel of the e2e objects (monophone or full-biphone tree,
    chain topology, den graph), saved by the JAX package and read by
    ChainModel.load: tree, transition model, den graph and logits."""
    import old_kaldi_git_tpu.recipes.chain as jchain

    (jctx, jtmod, jden, _), (tctx, ttmod, tden, _) = yes[width]
    config = jtdnn.make_tdnnf(39, jctx.num_pdfs, 32, 8, 2, subsampled_stride=3,
                              num_full_rate_layers=1)
    jcm = jchain.ChainModel(jam.AmNnet.init(config, seed=2), jctx, jtmod, jden, 3)
    jcm.save(str(tmp_path / "e2e.mdl"))
    tcm = tchain.ChainModel.load(str(tmp_path / "e2e.mdl"), device="cpu")
    assert tree_key(tcm.ctx_dep) == tree_key(tctx)
    assert tcm.tm.tuples == ttmod.tuples
    same_den(tcm.den, tden)
    x = yes["feats"][yes["keys"][0]][None]
    close(tcm.am.logits(x, output_stride=3).numpy(),
          np.asarray(jcm.am.logits(jnp.asarray(x), output_stride=3)), atol=1e-4)


def _random_logits(yes, width, seed, scale=2.0):
    (jctx, _, _, jgraphs), _ = yes[width]
    rng = np.random.default_rng(seed)
    nf = np.array([38, 25, 31, 12, 40, 29, 33, 21], np.int32)
    x = (scale * rng.normal(size=(len(nf), int(nf.max()), jctx.num_pdfs))).astype(np.float32)
    return x, nf


@pytest.mark.parametrize("width", [1, 2])
def test_generic_numerator_and_its_gradient(yes, width):
    (_, _, _, jgraphs), (_, _, _, tgraphs) = yes[width]
    x, nf = _random_logits(yes, width, seed=width)
    jb = je2e.NumeratorGraphBatch.from_csr_graphs(jgraphs)
    tb = te2e.NumeratorGraphBatch.from_csr_graphs(tgraphs)
    jfun = lambda l: jnp.sum(je2e.generic_numerator_logprob(l, jb, jnp.asarray(nf)))  # noqa
    jval = je2e.generic_numerator_logprob(jnp.asarray(x), jb, jnp.asarray(nf))
    jgrad = jax.grad(jfun)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tval = te2e.generic_numerator_logprob(xt, tb, torch.from_numpy(nf))
    tval.sum().backward()
    close(tval.detach().numpy(), jval, rel=1e-4)
    close(xt.grad.numpy(), jgrad, atol=1e-4 * float(np.abs(np.asarray(jgrad)).max()))
    # occupancies: one a frame on the utterance's frames, none after
    g = xt.grad.numpy().sum(axis=2)
    for b, n in enumerate(nf):
        np.testing.assert_allclose(g[b, :n], 1.0, atol=1e-4)
        np.testing.assert_allclose(g[b, n:], 0.0, atol=1e-6)


def test_chain_e2e_loss_with_seq_weights(yes):
    (_, _, jden, jgraphs), (_, _, tden, tgraphs) = yes[2]
    x, nf = _random_logits(yes, 2, seed=7)
    wts = np.array([1.0, 0.5, 1.0, 0.0, 0.25, 1.0, 2.0, 1.0], np.float32)
    jb = je2e.NumeratorGraphBatch.from_csr_graphs(jgraphs)
    tb = te2e.NumeratorGraphBatch.from_csr_graphs(tgraphs)
    jl, jm = je2e.chain_e2e_loss(jnp.asarray(x), jden, jb, jnp.asarray(nf),
                                 jloss.ChainLossOptions(), seq_weights=jnp.asarray(wts))
    tl, tm = te2e.chain_e2e_loss(torch.from_numpy(x), tden, tb, torch.from_numpy(nf),
                                 tloss.ChainLossOptions(), seq_weights=torch.from_numpy(wts))
    close(float(tl), float(jl), rel=1e-4)
    for k in ("objf", "num", "den", "l2"):
        close(float(tm[k]), float(jm[k]), atol=1e-4 * max(1.0, abs(float(jm["den"]))))
    # num ≤ den, utterance by utterance, on random logits: normalised numerators
    num = te2e.generic_numerator_logprob(torch.from_numpy(x), tb, torch.from_numpy(nf))
    den = tloss.denominator_logprob(torch.from_numpy(x), torch.from_numpy(nf), tden, 0.0)
    assert (num <= den + 1e-3).all(), (num, den)
    assert float(tm["objf"]) <= 0.0


def test_one_e2e_step_from_carried_parameters(yes):
    (jctx, _, jden, jgraphs), (_, _, tden, tgraphs) = yes[1]
    keys = yes["keys"][:4]
    fsf = 3
    bf, nf = tchain.pad_subsampled(yes["feats"], keys, fsf)
    jb = je2e.NumeratorGraphBatch.from_csr_graphs(jgraphs[:4])
    tb = te2e.NumeratorGraphBatch.from_csr_graphs(tgraphs[:4])
    config = jtdnn.make_tdnnf(39, jctx.num_pdfs, 32, 8, 2, subsampled_stride=3,
                              num_full_rate_layers=1)
    j = jam.AmNnet.init(config, seed=5)
    t = convert.am_nnet_from_jax(dataclasses.asdict(config), j.variables, None, device="cpu")
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOptions(initial_lr=2e-3, final_lr=2e-4), 10)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(initial_lr=2e-3, final_lr=2e-4), 10)
    jopts, topts = jloss.ChainLossOptions(xent_regularize=0.0), tloss.ChainLossOptions(
        xent_regularize=0.0)
    model = jtdnn.TdnnModel(config)

    def jloss_fn(params):
        logits, _ = model.apply({"params": params, "batch_stats": j.variables["batch_stats"]},
                                jnp.asarray(bf), train=True,
                                dropout_rng=jax.random.PRNGKey(0), mutable=["batch_stats"],
                                output_stride=fsf)
        return je2e.chain_e2e_loss(logits, jden, jb, jnp.asarray(nf), jopts)

    params = j.variables["params"]
    (jl, jm), grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(params)
    updates, _ = jopt.update(grads, jopt.init(params), params)
    jparams = jax.tree.map(lambda p, u: p + u, params, updates)
    t.model.train()
    step = tchain.make_chain_e2e_step(t.model, tden, topt, topts, fsf)
    _, tl, tm = step(ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0),
                     bf, nf, tb)
    close(float(tl), float(jl), rel=1e-4)
    close(float(tm["objf"]), float(jm["objf"]), rel=1e-4)
    want = convert.torch_params_from_flax(jparams)
    for k, p in t.model.named_parameters():
        close(p.detach().numpy(), want[k], atol=1e-4)


def test_train_chain_e2e_on_the_port_at_toy_size(yes):
    hist, rep = [], {}
    chain = tchain.train_chain_e2e(
        yes["feats"], yes["text"], yesno.make_lang(),
        tchain.ChainTrainOptions(num_epochs=4, minibatch_size=8, hidden_dim=32,
                                 bottleneck_dim=8, num_layers=2, initial_lr=2e-3,
                                 final_lr=2e-3, tree_context_width=2, phone_lm_order=3),
        device="cpu", history=hist, report=rep)
    objs = [h["objf"] for h in hist]
    assert len(objs) == 4 and all(o <= 1e-6 for o in objs), objs
    assert objs[-1] > objs[0]
    assert chain.ctx_dep.N == 2 and rep["steps"] == 4
    assert rep["num_states"] == max(g.num_states for g in yes[2][1][3])


@pytest.mark.slow
def test_chain_e2e_yesno_wer_on_the_port():
    from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu_torch.recipes.decode import score_hyps

    train_waves, train_text, test_waves, test_text = yesno.make_corpus(24, 8)
    lang = yesno.make_lang()
    chain = tchain.train_chain_e2e(
        yesno.compute_feats(train_waves, "cpu"), train_text, lang,
        tchain.ChainTrainOptions(num_epochs=50, minibatch_size=8, hidden_dim=128,
                                 bottleneck_dim=32, num_layers=3, initial_lr=2e-3,
                                 final_lr=2e-4), device="cpu")
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    graph = tchain.make_chain_decode_graph(chain, lang, g)
    hyps = tchain.decode_chain(chain, graph, lang, yesno.compute_feats(test_waves, "cpu"),
                               beam=20.0)
    stats = score_hyps(test_text, hyps)
    assert stats.wer <= 2.0, stats.report()
