"""The dense decoder's lattice mode, the dense StreamingDecoder and the
fused toy pipeline in the port, against the JAX package on the CPU.

decode_batch(want_lattice=True) on the yes/no toy (K = S) and on a random
graph with words (K < S): words and alignments equal, `frame_states`
equal, `frame_costs` within 1e-5, and lat.lattice_from_decode's arcs equal
(each lattice's best path is the decoder's words).  The dense
StreamingDecoder: words equal to the batch decode's and to the JAX
StreamingDecoder's for every chunking; endpointing on trailing silence.
The toy system of bench.py: the same graph as the JAX package's
mkgraph_csr, front end and TDNN-F (JAX weights carried over) within the
front end's tolerance, and the search's words equal on the JAX package's
loglikes.  Loglikes are synthesised from known phone sequences, as
tests/test_online.py's _loglikes_for does, at acoustic scale 1.0 (the
winner test's parity rule, ROADMAP queue 3)."""

import tests.torch_threads  # noqa: F401
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.graph as jgraph
import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.feat.compute as jcompute
import old_kaldi_git_tpu.feat.functions as jfunctions
import old_kaldi_git_tpu.fst.lang as jlang
import old_kaldi_git_tpu.hmm.topology as jtopo
import old_kaldi_git_tpu.hmm.transition_model as jtm
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.online.streaming as jstream
import old_kaldi_git_tpu.tree.context_dep as jcd
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.online.streaming as tstream
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.recipes import toy
from tests.test_online import _loglikes_for, _toy_decode_system
from tests.test_torch_chain import port_graph
from tests.test_torch_decoder import _random_graph

OPTS = dict(beam=30.0, max_active=200, acoustic_scale=1.0)
SEQUENCES = [["Y", "EH", "S"], ["N", "OW"], ["SIL", "N", "OW", "Y", "EH", "S"],
             ["Y", "EH", "S", "N", "OW", "N", "OW"]]


def _batch(lang, tm, cd, seqs, seed=0):
    """Loglikes of each phone sequence, noise added, padded into a batch."""
    rng = np.random.default_rng(seed)
    lls = [_loglikes_for(tm, cd, lang, s) for s in seqs]
    T = max(len(x) for x in lls)
    ll = np.full((len(lls), T, cd.num_pdfs), -6.0, np.float32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x + 0.5 * rng.normal(size=x.shape).astype(np.float32)
    return ll, np.asarray([len(x) for x in lls], np.int32)


def _lattice_arcs(lat):
    return ([[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate)
              for a in lst] for lst in lat.arcs], lat.finals, lat.state_time)


def _end_state_words(graph, res):
    """The final eps-path words of a lattice-mode decode's end state."""
    states, costs = res.frame_states[-1], res.frame_costs[-1]
    fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, 1e10)
    total = np.where(states >= 0, costs + fw[np.maximum(states, 0)], np.inf)
    return [] if not total.min() < 1e10 else list(
        graph.final_olabels[int(states[np.argmin(total)])])


def _compare_lattice_mode(jg, ll, nf, **opts):
    jres = jvit.decode_batch(jg, ll, nf, jvit.ViterbiOptions(**opts), want_lattice=True)
    tg = port_graph(jg)
    tres = tvit.decode_batch(tg, ll, nf, tvit.ViterbiOptions(**opts), want_lattice=True,
                             device="cpu")
    assert len(jres) == len(tres)
    decoded = with_tail = 0
    for b, (j, t) in enumerate(zip(jres, tres)):
        assert (j is None) == (t is None)
        if j is None:
            continue
        decoded += 1
        assert t.words == j.words and np.array_equal(t.alignment, j.alignment)
        assert t.cost == pytest.approx(j.cost, rel=1e-5, abs=1e-5)
        assert t.frame_states.shape == j.frame_states.shape
        assert np.array_equal(t.frame_states, j.frame_states)
        np.testing.assert_allclose(t.frame_costs, j.frame_costs, rtol=1e-5, atol=1e-5)
        jl = jlat.lattice_from_decode(jg, ll[b, : nf[b]], j.frame_states, j.frame_costs,
                                      opts["acoustic_scale"], lattice_beam=8.0)
        tl = tlat.lattice_from_decode(tg, ll[b, : nf[b]], t.frame_states, t.frame_costs,
                                      opts["acoustic_scale"], lattice_beam=8.0)
        assert _lattice_arcs(tl) == _lattice_arcs(jl)
        best = tlat.lattice_best_path(tl, 1.0, opts["acoustic_scale"])
        assert best[0] == jlat.lattice_best_path(jl, 1.0, opts["acoustic_scale"])[0]
        tail = _end_state_words(tg, t)
        with_tail += bool(tail)
        assert best[0] + tail == t.words
        assert best[2] == pytest.approx(t.cost, rel=1e-5)
    return decoded, tres, with_tail


def test_lattice_mode_on_the_yes_no_toy_equals_the_jax_package():
    lang, topo, cd, tm, csr = _toy_decode_system()
    ll, nf = _batch(lang, tm, cd, SEQUENCES)
    decoded, res, _ = _compare_lattice_mode(csr, ll, nf, **OPTS)
    assert decoded == len(SEQUENCES)
    K = min(OPTS["max_active"], csr.num_states)
    assert res[0].frame_states.shape == (nf[0], K)
    assert [lang.words[w] for w in res[0].words] == ["yes"]


@pytest.mark.parametrize("max_active,beam", [(8, 30.0), (24, 4.0)])
def test_top_k_lattice_mode_equals_the_jax_package(max_active, beam):
    import old_kaldi_git_tpu.decoder.csr as jcsr

    kw = _random_graph(5, S=120, deg=4, P=20, words=True)
    jg = jcsr.CsrGraph(**kw)
    rng = np.random.default_rng(6)
    ll = (rng.normal(size=(3, 30, 20)) * 2.0).astype(np.float32)
    nf = np.asarray([30, 17, 1], np.int32)
    decoded, res, _ = _compare_lattice_mode(jg, ll, nf, beam=beam, max_active=max_active,
                                         acoustic_scale=1.0)
    assert decoded >= 2
    assert res[0].frame_states.shape == (30, max_active)


def _stream_words(dec, ll, chunk):
    for lo in range(0, len(ll), chunk):
        dec.advance(ll[lo: lo + chunk])
    dec.advance(np.zeros((0, ll.shape[1]), np.float32), final=True)
    return dec.best_words()


@pytest.mark.parametrize("chunk", [1, 5, 7, 40])
def test_dense_streaming_decoder_equals_batch_and_the_jax_package(chunk):
    lang, topo, cd, tm, csr = _toy_decode_system()
    tg = port_graph(csr)
    opts = tvit.ViterbiOptions(**OPTS)
    for seq in SEQUENCES:
        ll, nf = _batch(lang, tm, cd, [seq], seed=len(seq))
        ll = ll[0]
        batch = tvit.decode_batch(tg, ll[None], nf, opts, device="cpu")[0]
        dec = tstream.StreamingDecoder(tg, lambda x: x, [lang.silence_id],
                                       tm.tid_to_phone_array(), opts,
                                       chunk_quantum=8, device="cpu")
        got = _stream_words(dec, ll, chunk)
        jdec = jstream.StreamingDecoder(csr, lambda f: jnp.asarray(f), [lang.silence_id],
                                        tm.tid_to_phone_array(),
                                        jvit.ViterbiOptions(**OPTS))
        for lo in range(0, len(ll), chunk):
            jdec.advance(ll[lo: lo + chunk])
        assert got == batch.words == jdec.best_words()
        # a second utterance after reset decodes alike
        dec.reset()
        assert _stream_words(dec, ll, chunk) == got


def test_dense_streaming_decoder_endpoints_and_refuses_split_graphs():
    from tests.test_online import _backoff_split_system

    lang, topo, cd, tm, csr = _toy_decode_system()
    speech = _loglikes_for(tm, cd, lang, ["N", "OW"])
    silence = _loglikes_for(tm, cd, lang, ["SIL"], frames_per_phone=120)
    dec = tstream.StreamingDecoder(
        port_graph(csr), lambda x: x, [lang.silence_id], tm.tid_to_phone_array(),
        tvit.ViterbiOptions(**OPTS), endpoint_rules=[tstream.EndpointRule(True, 0.5, 0.0)],
        device="cpu")
    dec.advance(speech)
    assert not dec.endpoint_detected()
    dec.advance(silence)
    assert dec.trailing_silence_frames() * 0.01 >= 0.5 and dec.endpoint_detected()
    assert [lang.words[w] for w in dec.best_words()] == ["no"]
    _folded, split, t2p = _backoff_split_system()
    with pytest.raises(NotImplementedError, match="folded"):
        tstream.StreamingDecoder(port_graph(split), lambda x: x, [1],
                                 np.zeros(50, np.int32), device="cpu")


def _jax_toy_graph():
    """bench.py's build_toy_system up to the graph, with the JAX package's
    mkgraph_csr."""
    rng = np.random.default_rng(toy.SEED)
    lang = jlang.Lang(jlang.Lexicon.from_dict(toy.toy_lexicon(rng)),
                      silence_phone="SIL", sil_prob=0.5)
    phones = lang.real_phone_ids
    topo = jtopo.HmmTopology.standard(phones, silence_phones=[lang.silence_id])
    cd = jcd.monophone_context_dependency(phones, {p: topo.num_pdf_classes(p)
                                                   for p in phones})
    tm = jtm.TransitionModel(cd, topo)
    sentences = [[f"w{rng.integers(0, toy.NUM_WORDS):03d}"
                  for _ in range(rng.integers(1, 8))]
                 for _ in range(500)]
    g = jlang.make_unigram_grammar_fst(sentences, lang.words)
    return jgraph.mkgraph_csr(lang, g, cd, tm), cd.num_pdfs


def test_toy_system_and_pipeline_equal_the_jax_package():
    jg, num_pdfs = _jax_toy_graph()
    system = toy.build_toy_system(device="cpu")
    for f in ("row_ptr", "tid", "pdf", "weight", "nextstate", "final_weight"):
        assert np.array_equal(getattr(jg, f), getattr(system.csr, f)), f
    assert 900 < system.csr.num_states < 1200
    assert system.am.config.num_outputs == num_pdfs
    assert np.allclose(system.am.log_priors.numpy(), -np.log(num_pdfs))
    # the JAX package's initial weights, carried into the port
    config = jtdnn.make_tdnnf(39, num_pdfs, hidden_dim=512, bottleneck_dim=64,
                              num_layers=6)
    jnet = jam.AmNnet.init(config, seed=0)
    jnet.log_priors = system.am.log_priors.numpy()
    system.am = convert.am_nnet_from_jax(dataclasses.asdict(config), jnet.variables,
                                         jnet.log_priors, device="cpu")
    waves = (np.random.default_rng(1).normal(size=(2, 16000)) * 2000.0).astype(np.float32)
    mopts = jcompute.MfccOptions()
    mopts.frame_opts.dither = 0.0
    jfeats = np.array(jfunctions.compute_deltas(jcompute.Mfcc(mopts)(jnp.asarray(waves))))
    jll = np.array(jnet.loglikes_batch(jfeats))
    timings = {}
    res = toy.decode_toy(system, torch.from_numpy(waves), timings=timings)
    assert set(timings) == {"front_end_seconds", "acoustic_model_seconds",
                            "search_seconds", "host_tail_seconds"}
    assert len(res) == 2 and all(r is not None for r in res)
    # the stages: front end within its tolerance, the TDNN-F on the same
    # features within 1e-4, the search exact on the same loglikes
    from old_kaldi_git_tpu_torch.feat import Mfcc, MfccOptions, compute_deltas

    popts = MfccOptions()
    popts.frame_opts.dither = 0.0
    tfeats = compute_deltas(Mfcc(popts)(torch.from_numpy(waves))).numpy()
    assert tfeats.shape == jfeats.shape == (2, 98, 39)
    assert np.abs(tfeats - jfeats).max() <= 1e-3 + 1e-5 * np.abs(jfeats).max()
    np.testing.assert_allclose(system.am.loglikes_batch(jfeats).numpy(), jll, atol=1e-4)
    S = system.csr.num_states
    want = jvit.decode_batch(jg, jll, [98, 98],
                             jvit.ViterbiOptions(beam=toy.BEAM, max_active=S,
                                                 acoustic_scale=1.0))
    got = tvit.decode_batch(system.csr, jll, [98, 98],
                            tvit.ViterbiOptions(beam=toy.BEAM, max_active=S,
                                                acoustic_scale=1.0), device="cpu")
    for j, t in zip(want, got):
        assert t.words == j.words and np.array_equal(t.alignment, j.alignment)


def test_lattices_of_the_toy_graph_lack_the_final_words_in_both_packages():
    """On the toy HCLG the last word of an utterance can sit on the eps path
    from its end state to the final state (the graph's `final_olabels`).
    decode_batch puts it into the words; lattice_from_decode, the JAX
    package's and the port's alike, gives lattice finals no words, so a
    lattice's best path lacks it (ROADMAP queue 3)."""
    system = toy.build_toy_system(device="cpu")
    jg = _jax_toy_graph()[0]
    rng = np.random.default_rng(5)
    vocab = sorted(w for w in system.lang.words.symbols() if w.startswith("w"))
    sents = [[vocab[i] for i in rng.integers(0, len(vocab), rng.integers(2, 7))]
             for _ in range(6)]
    ll, nf = toy.synthetic_loglikes(system, sents, seed=6)
    decoded, res, with_tail = _compare_lattice_mode(jg, ll, nf, beam=toy.BEAM,
                                                    max_active=64, acoustic_scale=1.0)
    assert decoded == len(sents) and with_tail > 0
    assert any(len(system.csr.final_olabels[s]) for s in range(system.csr.num_states))


def test_am_nnet_init_draws_from_its_seed():
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
    from old_kaldi_git_tpu_torch.models.tdnn import make_tdnnf

    config = make_tdnnf(39, 50, hidden_dim=64, bottleneck_dim=16, num_layers=3)
    a, b, c = (AmNnet.init(config, seed=s, device="cpu") for s in (0, 0, 1))
    sa, sb, sc = (x.model.state_dict() for x in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["output.weight"], sc["output.weight"])
    w = sa["output.weight"]
    assert abs(float(w.std()) * 64 ** 0.5 - 1.0) < 0.1  # lecun normal: var 1/fan_in
    assert float(w.abs().max()) * 64 ** 0.5 <= 2.0 / 0.87962566103423978 + 1e-6
    assert not sa["output.bias"].any() and torch.equal(sa["tdnn0.var"], torch.ones(64))
    assert a.loglikes_batch(np.zeros((1, 5, 39), np.float32)).shape == (1, 5, 50)
