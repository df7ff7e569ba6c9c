"""The committed chain system in the port vs the JAX package on the CPU (split
from tests/test_torch_chain.py): chain.mdl through the port's loader, its
logits at frame-subsampling 3 within 1e-4 of the JAX package on held-out
utterances, chain_hclg.npz, and the chain recipe's words on the 4 shortest
held-out utterances (all 256, clean and noisy: slow)."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.recipes.minilib as jminilib
from old_kaldi_git_tpu.recipes.chain import ChainModel as JaxChainModel
from old_kaldi_git_tpu.utils.batching import pad_feature_batch
import old_kaldi_git_tpu_torch.decoder.csr as tcsr
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from old_kaldi_git_tpu_torch.recipes.chain import ChainModel
from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer
from tests.test_torch_chain import WORKDIR


@pytest.fixture(scope="module")
def chain_models():
    return (JaxChainModel.load(os.path.join(WORKDIR, "chain.mdl")),
            ChainModel.load(os.path.join(WORKDIR, "chain.mdl"), device="cpu"))


def test_chain_model_loads(chain_models):
    jcm, cm = chain_models
    assert cm.frame_subsampling_factor == jcm.frame_subsampling_factor == 3
    assert cm.am.ivector_dim == jcm.am.ivector_dim == 0
    assert cm.am.log_priors is None
    assert cm.am.config.num_outputs == 1624 and cm.am.config.input_dim == 39
    assert [s.time_stride for s in cm.am.config.layers] == [1, 1, 1, 1, 3, 3]
    want = jcm.tm.tid_to_pdf_array()
    assert cm.tid_to_pdf.dtype == want.dtype and np.array_equal(cm.tid_to_pdf, want)
    assert len(cm.tid_to_pdf) == 3249 and cm.tid_to_pdf.max() == 1623


def test_chain_logits_at_stride_3(chain_models):
    """Two held-out utterances padded as the chain recipe pads them (T to a
    multiple of 384 input frames): the raw logits at stride 3 within 1e-4."""
    jcm, cm = chain_models
    waves, _ = jminilib.make_test_set(jminilib.MinilibOptions(num_test=2))
    _, padded, nf = pad_feature_batch(jminilib.compute_feats(waves))
    T = padded.shape[1]
    padded = np.pad(padded, ((0, 0), (0, -(-T // 384) * 384 - T), (0, 0)))
    want = np.asarray(jcm.am.logits(padded, output_stride=3))
    got = cm.am.logits(padded, output_stride=3).numpy()
    assert got.shape == want.shape == (2, padded.shape[1] // 3, 1624)
    assert np.abs(got - want).max() <= 1e-4


def _jax_chain_hyps(jcm, csr, words, waves, batch, max_active=2048, beam=14.0):
    """The JAX package's decode_and_score_chain loop, down to words, for a
    given set of waves."""
    feats = jminilib.compute_feats(waves)
    vopts = jvit.ViterbiOptions(beam=beam, max_active=max_active, acoustic_scale=1.0)
    by_dur = sorted(feats, key=lambda k: feats[k].shape[0])
    hyps = {}
    for lo in range(0, len(by_dur), batch):
        chunk = by_dur[lo: lo + batch]
        keys, padded, nf = pad_feature_batch({k: feats[k] for k in chunk})
        T = padded.shape[1]
        padded = np.pad(padded, ((0, batch - len(keys)), (0, -(-T // 384) * 384 - T),
                                 (0, 0)))
        nf = np.concatenate([nf, np.zeros(batch - len(keys), nf.dtype)])
        results = jvit.decode_batch_tokens(
            csr, jcm.am.logits(padded, output_stride=3), (nf + 2) // 3, vopts)
        for k, res in zip(keys, results):
            hyps[k] = [words[w] for w in res.words] if res else []
    return hyps


@pytest.fixture(scope="module")
def chain_systems(chain_models):
    jcm, _ = chain_models
    jgraph = jminilib.load_csr(os.path.join(WORKDIR, "chain_hclg.npz"),
                               jcm.tm.tid_to_pdf_array())
    return jcm, jgraph, tminilib.load_chain_system(WORKDIR, device="cpu")


def test_chain_graph_loads(chain_systems):
    _, jgraph, system = chain_systems
    g = system.csr
    assert (g.num_states, g.num_arcs, g.eps_depth) == (349439, 1305377, 3)
    assert np.array_equal(g.pdf, jgraph.pdf) and int((g.eps_ns >= 0).sum()) == 116591
    assert tcsr.build_tile_graph(g).num_tiles == 481202


def test_chain_recipe_words_equal_on_the_shortest_utterances(chain_systems):
    jcm, jgraph, system = chain_systems
    waves, text = tminilib.make_test_set(tminilib.MinilibOptions())
    short = {k: waves[k] for k in sorted(waves, key=lambda k: len(waves[k]))[:4]}
    want = _jax_chain_hyps(jcm, jgraph, system.words, short, batch=4)
    timings = {}
    got = tminilib.decode_chain_test_set(system, short, batch=4, timings=timings)
    assert got == want
    assert all(got[k] == text[k] for k in short)
    assert sorted(timings) == ["acoustic_model_seconds", "front_end_seconds",
                               "search_frames", "search_seconds"]


@pytest.mark.slow
@pytest.mark.parametrize("noise", [None, 400.0])
def test_chain_recipe_words_equal_on_the_held_out_set(chain_systems, noise):
    """All 256 held-out utterances, clean and at the noisy operating point:
    the same words from both packages on the CPU, hence the same WER."""
    jcm, jgraph, system = chain_systems
    opts = tminilib.MinilibOptions()
    waves, text = tminilib.make_test_set(opts, noise=noise)
    want = _jax_chain_hyps(jcm, jgraph, system.words, waves, batch=64)
    got = tminilib.decode_chain_test_set(system, waves, batch=64)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    stats = compute_wer({k: list(v) for k, v in text.items()}, got)
    wer, _ = tminilib.decode_and_score_chain(system, opts, noise=noise)
    assert wer == pytest.approx(stats.wer)
    print(f"chain noise={noise}: both packages {stats.report()}; utterances with "
          f"errors: {sorted(k for k in text if list(text[k]) != got[k])}")
