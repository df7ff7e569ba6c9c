"""Semi-supervised (lattice-supervised) LF-MMI in the port against the JAX
package on the CPU.

A seed chain model is trained flat-start by the port on 8 supervised yesno
utterances at toy widths; its decode lattices of 4 unsupervised ones
(recipes/semisup.decode_chain_lattices) are copied arc for arc into the JAX
package's Lattice, and its tree, transition model and den graph are the
JAX package's own objects built from the same transcripts (held array for
array in tests/test_torch_e2e.py).  Then:

- lattice_to_numerator at several LM and acoustic scales, and on a lattice
  with an epsilon arc spliced in (as lat.lattice._emit writes multi-word
  output labels): every array exactly, states in the same order;
- num ≤ den + 1e-3 for every lattice numerator on random logits, and the
  lattice's LM costs only lower the numerator;
- train_chain_semisup on the port at toy size: finite objective ≤ 0 every
  epoch, and the seed model left as it was.
`-m slow`: the JAX slow test's flow (12 + 12 utterances, a 30-epoch seed
from the JAX package's initial network, 6 semisup epochs): held-out WER ≤
max(the seed's, 15)."""

import copy

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401
import old_kaldi_git_tpu.chain.semisup as jsemi
import old_kaldi_git_tpu.recipes.yesno as jyesno
from old_kaldi_git_tpu_torch.chain import e2e as te2e
from old_kaldi_git_tpu_torch.chain import loss as tloss
from old_kaldi_git_tpu_torch.chain import semisup as tsemi
from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu_torch.lat import lattice as tlat
from old_kaldi_git_tpu_torch.recipes import chain as tchain, semisup, yesno
from old_kaldi_git_tpu_torch.recipes.decode import score_hyps
from tests.test_torch_e2e import SIMPLE_FIELDS, jax_e2e_objects
from tests.test_torch_lattice_post import to_jax

SEED_OPTS = dict(minibatch_size=8, hidden_dim=32, bottleneck_dim=8, num_layers=2,
                 initial_lr=2e-3, final_lr=4e-4)


def seed_system(n_sup, n_unsup, n_test, epochs, **kw):
    train_waves, train_text, test_waves, test_text = yesno.make_corpus(n_sup + n_unsup,
                                                                      n_test)
    keys = sorted(train_text)
    feats = yesno.compute_feats(train_waves, "cpu")
    sup = keys[:n_sup]
    lang = yesno.make_lang()
    seed = tchain.train_chain_e2e({k: feats[k] for k in sup},
                                  {k: train_text[k] for k in sup}, lang,
                                  tchain.ChainTrainOptions(num_epochs=epochs, **kw),
                                  device="cpu")
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    graph = tchain.make_chain_decode_graph(seed, lang, g)
    return dict(seed=seed, lang=lang, graph=graph, feats=feats, text=train_text, sup=sup,
                unsup=keys[n_sup:], test_feats=yesno.compute_feats(test_waves, "cpu"),
                test_text=test_text)


@pytest.fixture(scope="module")
def sys_():
    s = seed_system(8, 4, 2, 6, **SEED_OPTS)
    s["lats"] = semisup.decode_chain_lattices(s["seed"], s["graph"],
                                              {k: s["feats"][k] for k in s["unsup"]},
                                              beam=14.0, lattice_beam=6.0)
    jctx, jtm, jden, _ = jax_e2e_objects(s["text"], s["sup"], jyesno.make_lang(), 2, 1)
    s["jax"] = (jtm, jden)
    return s


def same_numerator(t, j):
    assert (t.start, t.num_states) == (j.start, j.num_states)
    for f in SIMPLE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def spliced(lat, mod):
    """An epsilon arc (graph cost 1.25) after the first arc out of the first
    state with arcs."""
    lat = copy.deepcopy(lat)
    src = next(s for s in range(lat.num_states) if lat.arcs[s])
    arc = lat.arcs[src][0]
    mid = lat.add_state(time=lat.state_time[src])
    dst = arc.nextstate
    arc.nextstate = mid
    lat.arcs[mid].append(mod.LatticeArc(0, 0, 1.25, 0.0, dst))
    return lat


def test_decode_lattices_carry_the_decoder_words(sys_):
    lats = sys_["lats"]
    assert sorted(lats) == sys_["unsup"]
    hyps = tchain.decode_chain(sys_["seed"], sys_["graph"], sys_["lang"],
                               {k: sys_["feats"][k] for k in sys_["unsup"]}, beam=14.0)
    for k, lat in lats.items():
        words = tlat.lattice_best_path(lat, 1.0, 1.0)[0]
        assert [sys_["lang"].words[w] for w in words] == hyps[k]


@pytest.mark.parametrize("lm_scale,ac_scale", [(0.0, 0.0), (0.5, 0.0), (1.0, 0.3)])
def test_lattice_to_numerator_array_for_array(sys_, lm_scale, ac_scale):
    jtm, jden = sys_["jax"]
    seed = sys_["seed"]
    for k, lat in sys_["lats"].items():
        t = tsemi.lattice_to_numerator(lat, seed.tm, seed.den, lm_scale, ac_scale)
        j = jsemi.lattice_to_numerator(to_jax(lat), jtm, jden, lm_scale, ac_scale)
        same_numerator(t, j)


def test_lattice_to_numerator_folds_an_epsilon_splice(sys_):
    jtm, jden = sys_["jax"]
    seed = sys_["seed"]
    k = sorted(sys_["lats"])[0]
    lat = spliced(sys_["lats"][k], tlat)
    t = tsemi.lattice_to_numerator(lat, seed.tm, seed.den, lattice_lm_scale=0.7)
    j = jsemi.lattice_to_numerator(to_jax(lat), jtm, jden, lattice_lm_scale=0.7)
    same_numerator(t, j)
    nf = torch.tensor([max(x for x in lat.state_time if x >= 0) + 1])
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, int(nf[0]), seed.ctx_dep.num_pdfs)).astype(np.float32))
    num = te2e.generic_numerator_logprob(x, te2e.NumeratorGraphBatch.from_csr_graphs([t]), nf)
    den = tloss.denominator_logprob(x, nf, seed.den, 0.0)
    assert torch.isfinite(num).all() and (num <= den + 1e-3).all()


def test_lattice_numerators_bounded_by_the_denominator(sys_):
    seed = sys_["seed"]
    keys = sorted(sys_["lats"])
    nf = torch.tensor([max(sys_["lats"][k].state_time) + 1 for k in keys])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(len(keys), int(nf.max()), seed.ctx_dep.num_pdfs)).astype(np.float32))
    den = tloss.denominator_logprob(x, nf, seed.den, 0.0)
    nums = []
    for scale in (0.0, 0.5):
        g = te2e.NumeratorGraphBatch.from_csr_graphs(
            [tsemi.lattice_to_numerator(sys_["lats"][k], seed.tm, seed.den, scale)
             for k in keys])
        nums.append(te2e.generic_numerator_logprob(x, g, nf))
        assert (nums[-1] <= den + 1e-3).all(), (nums[-1], den)
    assert (nums[1] <= nums[0] + 1e-3).all()


def test_train_chain_semisup_on_the_port_at_toy_size(sys_):
    seed = sys_["seed"]
    before = {k: v.clone() for k, v in seed.am.model.state_dict().items()}
    hist, rep = [], {}
    model = semisup.train_chain_semisup(
        seed, sys_["lang"], {k: sys_["feats"][k] for k in sys_["sup"]},
        {k: sys_["text"][k] for k in sys_["sup"]},
        {k: sys_["feats"][k] for k in sys_["unsup"]}, sys_["graph"],
        semisup.SemisupOptions(num_epochs=2, minibatch_size=6, lattice_lm_scale=0.5),
        history=hist, report=rep)
    assert rep["unsup_utterances"] == len(sys_["unsup"])
    assert len(hist) == 2 and all(np.isfinite(h["objf"]) and h["objf"] <= 1e-6
                                  for h in hist), hist
    for k, v in seed.am.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert model.den is seed.den and model.ctx_dep is seed.ctx_dep


@pytest.mark.slow
def test_semisup_holds_the_seed_wer_on_the_port(monkeypatch):
    """The seed starts from the JAX package's initial network (flax's
    draws for seed 0, carried over), so that the port runs the JAX test's
    flow from its very numbers: a 30-step yesno seed is as sensitive to
    its initial draw in both packages (the port's own torch draw for seed
    0 gives a seed at 42 % WER and semisup at 47 %)."""
    import dataclasses

    import old_kaldi_git_tpu.models.am_nnet as jam
    import old_kaldi_git_tpu.models.tdnn as jtdnn
    from old_kaldi_git_tpu_torch import convert

    def jax_init(config, seed=0, device=None, log_priors=None):
        jconfig = jtdnn.TdnnConfig(
            config.input_dim, config.num_outputs,
            tuple(jtdnn.TdnnLayerSpec(**dataclasses.asdict(l)) for l in config.layers),
            config.final_hidden_dim)
        j = jam.AmNnet.init(jconfig, seed=seed)
        return convert.am_nnet_from_jax(dataclasses.asdict(jconfig), j.variables, None,
                                        device=device)

    monkeypatch.setattr(tchain.AmNnet, "init", staticmethod(jax_init))
    s = seed_system(12, 12, 6, 30, minibatch_size=8, hidden_dim=128, bottleneck_dim=32,
                    num_layers=3, initial_lr=2e-3, final_lr=4e-4)
    test = s["test_feats"]
    seed_stats = score_hyps(s["test_text"], tchain.decode_chain(
        s["seed"], s["graph"], s["lang"], test, beam=20.0))
    model = semisup.train_chain_semisup(
        s["seed"], s["lang"], {k: s["feats"][k] for k in s["sup"]},
        {k: s["text"][k] for k in s["sup"]}, {k: s["feats"][k] for k in s["unsup"]},
        s["graph"], semisup.SemisupOptions(num_epochs=6, minibatch_size=8,
                                           initial_lr=3e-4, final_lr=1e-4,
                                           lattice_lm_scale=0.5, unsup_egs_weight=1.0))
    stats = score_hyps(s["test_text"], tchain.decode_chain(model, s["graph"], s["lang"],
                                                           test, beam=20.0))
    assert stats.wer <= max(seed_stats.wer, 15.0), (stats.wer, seed_stats.wer)
