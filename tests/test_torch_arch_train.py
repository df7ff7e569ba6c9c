"""CE training of the new architectures through the port against the JAX
package, on the CPU.

- 5 CE steps of `make_ce_train_step` (Adam, the linear schedule, max-change)
  on a small TDNN-LSTM and a small CNN-TDNN-F from the same initial weights
  and batch statistics (convert.am_nnet_from_jax) on the same chunks: the
  losses within 1e-4 relative; every parameter within 1e-4 absolute except
  where Adam's first update is ±lr on a gradient at float32's noise floor
  (PR 9's rule: there the two packages may part by up to 2·lr a step, and
  such elements are at most 1 % of the model); the running statistics
  within 1e-4 relative.
- The slice: tests/test_models.py:309's yesno TDNN-LSTM (hidden 64, cell 64,
  recurrent 16, one block) through the port's recipes on the CPU at 10
  epochs (the JAX test's 30 cut for time): yesno features, the flat-start
  monophones, train_tdnn, decode_tdnn on the unigram graph at beam 20; its
  words are the reference text, which the JAX package's own test holds its
  words to.  `-m slow` runs the JAX flow beside it, at the JAX test's 30
  epochs, and compares the words utterance by utterance, and holds the
  three factories at their full widths (39 or 40 inputs, 2,000 outputs)
  from flax's initial weights within 1e-4 of max|ref|."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import train as ttrain

D, P = 12, 30
CONFIGS = {
    "tdnn_lstm": lambda m: m.make_tdnn_lstm(D, P, hidden_dim=32, cell_dim=32,
                                            recurrent_dim=8, num_blocks=1),
    "cnn_tdnnf": lambda m: m.make_cnn_tdnnf(D, P, height=6, num_filters=(4, 6),
                                            hidden_dim=32, bottleneck_dim=8,
                                            num_tdnnf_layers=2),
}
LR = 1e-3  # NnetTrainOptions' initial_lr, the largest step


def corpus(seed, n_utts=8, T=(50, 120)):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, D)) * 2
    feats, labels = {}, {}
    for u in range(n_utts):
        n = int(rng.integers(*T))
        lab = np.repeat(rng.integers(0, P, size=n // 5 + 1), 5)[:n].astype(np.int32)
        feats[f"u{u:02d}"] = (means[lab] + rng.normal(size=(n, D))).astype(np.float32)
        labels[f"u{u:02d}"] = lab
    return feats, labels


def _held(got, want, steps):
    """PR 9's rule for parameters after `steps` Adam steps."""
    diff = np.abs(got - want)
    apart = diff > 1e-4
    assert apart.mean() <= 0.01, f"{apart.sum()} of {diff.size} elements apart"
    assert diff.max() <= 2 * LR * steps + 1e-4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_five_ce_steps_in_lockstep(name):
    j = jam.AmNnet.init(CONFIGS[name](jtdnn), seed=2)
    t = convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, None,
                                 device="cpu")
    feats, labels = corpus(3)
    kw = dict(chunk_width=40, minibatch_size=4)
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOptions(**kw), 20)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(**kw), 20)
    jstep = jtrain.make_ce_train_step(jtdnn.TdnnModel(j.config), jopt)
    t.model.train()
    tstep = ttrain.make_ce_train_step(t.model, topt)
    jstate = jtrain.TrainState(j.variables["params"], j.variables["batch_stats"],
                               jopt.init(j.variables["params"]), 0)
    tstate = ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0)
    batches = list(ttrain._chunk_batches(feats, labels, 40, 4, np.random.default_rng(4)))
    assert len(batches) >= 5
    for bf, bl, bm in batches[:5]:
        jstate, jm = jstep(jstate, bf, bl, bm)
        tstate, tm = tstep(tstate, bf, bl, bm)
        loss = float(jm["loss"])
        assert abs(float(tm["loss"]) - loss) <= 1e-4 * abs(loss)
    want = convert.torch_params_from_flax(jstate.params)
    for k, v in t.model.named_parameters():
        _held(v.detach().numpy(), want[k], 5)
    for layer, stats in jstate.batch_stats.items():
        for s in ("mean", "var"):
            ref = np.asarray(stats["batchnorm"][s])
            got = getattr(t.model, layer).state_dict()[s].numpy()
            np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def _port_yesno_tdnn_lstm(num_epochs):
    from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
    from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu_torch.models.tdnn import make_tdnn_lstm
    from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
    from old_kaldi_git_tpu_torch.recipes.nnet3 import decode_tdnn, train_tdnn
    from old_kaldi_git_tpu_torch.recipes.yesno import compute_feats, make_corpus, make_lang
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency

    tw, tt, sw, st = make_corpus(24, 8)
    tf, sf = compute_feats(tw, "cpu"), compute_feats(sw, "cpu")
    lang = make_lang()
    model, ali = train_mono(tf, tt, lang, MonoTrainOptions(num_iters=10, totgauss=80),
                            device="cpu")
    cfg = make_tdnn_lstm(tf[sorted(tf)[0]].shape[1], model.am.num_pdfs, hidden_dim=64,
                         cell_dim=64, recurrent_dim=16, num_blocks=1)
    history = []
    am = train_tdnn(model, tf, ali, config=cfg, device="cpu", history=history,
                    opts=ttrain.NnetTrainOptions(num_epochs=num_epochs))
    g = make_unigram_grammar_fst(list(tt.values()), lang.words)
    phones = lang.real_phone_ids
    cd = monophone_context_dependency(
        phones, {p: model.tm.topo.num_pdf_classes(p) for p in phones})
    csr = mkgraph_csr(lang, g, cd, model.tm)
    return st, decode_tdnn(am, csr, lang, sf, beam=20.0), history


def test_yesno_tdnn_lstm_slice():
    text, hyps, history = _port_yesno_tdnn_lstm(10)
    losses = [h["loss"] for h in history]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert hyps == {k: list(v) for k, v in text.items()}


@pytest.mark.slow
def test_yesno_tdnn_lstm_words_equal_the_jax_packages():
    from old_kaldi_git_tpu.decoder.csr import fst_to_csr
    from old_kaldi_git_tpu.decoder.graph import mkgraph
    from old_kaldi_git_tpu.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu.recipes.mono import MonoTrainOptions, train_mono
    from old_kaldi_git_tpu.recipes.nnet3 import decode_tdnn, train_tdnn
    from old_kaldi_git_tpu.recipes.yesno import compute_feats, make_corpus, make_lang
    from old_kaldi_git_tpu.tree.context_dep import monophone_context_dependency

    tw, tt, sw, st = make_corpus(24, 8)
    tf, sf = compute_feats(tw), compute_feats(sw)
    lang = make_lang()
    model, ali = train_mono(tf, tt, lang, MonoTrainOptions(num_iters=10, totgauss=80))
    cfg = jtdnn.make_tdnn_lstm(tf[sorted(tf)[0]].shape[1], model.am.num_pdfs,
                               hidden_dim=64, cell_dim=64, recurrent_dim=16, num_blocks=1)
    am = train_tdnn(model, tf, ali, config=cfg, opts=jtrain.NnetTrainOptions(num_epochs=30))
    phones = lang.real_phone_ids
    cd = monophone_context_dependency(
        phones, {p: model.tm.topo.num_pdf_classes(p) for p in phones})
    csr = fst_to_csr(mkgraph(lang, make_unigram_grammar_fst(list(tt.values()), lang.words),
                             cd, model.tm), model.tm.tid_to_pdf_array())
    want = decode_tdnn(am, csr, lang, sf, beam=20.0)
    _, got, _ = _port_yesno_tdnn_lstm(30)
    assert got == want


@pytest.mark.slow
@pytest.mark.parametrize("name", ["make_tdnn_lstm", "make_tdnn_attention",
                                  "make_cnn_tdnnf"])
def test_full_width_factories(name):
    """From flax's own initial draws: random weights of larger scale make the
    3-LSTMP stack chaotic, where float32 rounding alone grows to O(1)."""
    dim = 40 if name == "make_cnn_tdnnf" else 39
    j = jam.AmNnet.init(getattr(jtdnn, name)(dim, 2000), seed=3)
    t = convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, j.log_priors,
                                 device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 60, dim)).astype(np.float32)
    for stride in (1, 3):
        want = np.asarray(j.logits(x, output_stride=stride))
        got = t.logits(x, stride).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
