"""The recipe's front end in the port vs the JAX package on the CPU, on the
synthesised held-out utterances (split from tests/test_torch_feat.py, whose
tolerances these are): the synthesis bit-equal, `compute_feats` (MFCC +
per-utterance CMN + deltas) on ragged utterances within 1e-3 + 1e-5 of the
largest feature, independent of the batch an utterance rides in, closer to
a float64 oracle than 1e-3, and the word table of the lang bundle."""

import tests.torch_threads  # noqa: F401
import math

import numpy as np
import pytest

import old_kaldi_git_tpu.recipes.minilib as jminilib
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from tests.test_torch_feat import ATOL


@pytest.fixture(scope="module")
def test_sets():
    """4 held-out utterances through both packages' synthesis."""
    jset = jminilib.make_test_set(jminilib.MinilibOptions(num_test=4))
    tset = tminilib.make_test_set(tminilib.MinilibOptions(num_test=4))
    return jset, tset


def test_synthesised_waves_and_text_bit_equal(test_sets):
    (jw, jt), (tw, tt) = test_sets
    assert sorted(jw) == sorted(tw) and jt == tt
    lens = {len(w) for w in tw.values()}
    assert len(lens) > 1  # ragged
    for k in jw:
        assert jw[k].dtype == tw[k].dtype == np.float32
        assert np.array_equal(jw[k], tw[k])
    # the pieces, at other sizes
    jo = jminilib.MinilibOptions(num_words=300, num_test=3, seed=5)
    to = tminilib.MinilibOptions(num_words=300, num_test=3, seed=5)
    assert tminilib.make_lexicon(to) == jminilib.make_lexicon(jo)
    for a, b in zip(tminilib.make_text(to, 5, 9), jminilib.make_text(jo, 5, 9)):
        assert np.array_equal(a, b)
    jn, _ = jminilib.synth_set(jo, jminilib.make_text(jo, 2, 9), "n", 11, noise=400.0)
    tn, _ = tminilib.synth_set(to, tminilib.make_text(to, 2, 9), "n", 11, noise=400.0)
    assert all(np.array_equal(jn[k], tn[k]) for k in jn)


def test_compute_feats_on_ragged_utterances(test_sets):
    (jw, _), (tw, _) = test_sets
    want = jminilib.compute_feats(jw)
    got = tminilib.compute_feats(tw, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[1] == 39
        assert got[k].dtype == np.float32
        tol = ATOL + 1e-5 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)


def test_compute_feats_is_independent_of_the_batch_it_rides_in(test_sets):
    """The port pads each chunk to its own longest wave, the JAX recipe to
    the global maximum: an utterance's features must not depend on that."""
    _, (tw, _) = test_sets
    together = tminilib.compute_feats(tw, device="cpu")
    for k in tw:
        alone = tminilib.compute_feats({k: tw[k]}, device="cpu")[k]
        np.testing.assert_allclose(alone, together[k], atol=1e-4, rtol=0)


def test_word_table_matches_the_lang_bundle(tmp_path):
    """id 0 = <eps>, id i = the (i-1)-th word of the sorted lexicon, then #0:
    held against the JAX package's lang bundle for the default options."""
    lang = jminilib._load_lang(str(tmp_path))
    table = tminilib.word_table(tminilib.make_lexicon(tminilib.MinilibOptions()))
    assert len(table) == len(lang.words.symbols()) == 20002
    for i in (0, 1, 2, 777, 19999, 20000, 20001):
        assert table[i] == lang.words[i]
    assert table[0] == "<eps>" and table[-1] == "#0"
    assert all(table[i] == f"w{i - 1:05d}" for i in range(1, 20001))


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _oracle_feats(wave, samp_freq=8000.0, num_bins=23, num_ceps=13, lifter=22.0):
    """The recipe's features from their definitions, in float64 numpy: snip-
    edge frames of 25 ms every 10 ms, DC removed, raw log energy, preemphasis
    0.97, povey window, |FFT|² without the Nyquist bin, 23 triangular mel
    bins from 20 Hz, log floored at 1e-30, orthonormal DCT-II with lifter 22,
    c0 := log energy, per-utterance CMN, deltas of order 2 over ±2 frames
    with clipped edges."""
    x = np.asarray(wave, np.float64)
    shift, length = int(samp_freq * 0.010), int(samp_freq * 0.025)
    pad = 1 << (length - 1).bit_length()
    T = 1 + (len(x) - length) // shift
    fr = x[np.arange(T)[:, None] * shift + np.arange(length)[None, :]]
    fr = fr - fr.mean(axis=1, keepdims=True)
    log_e = np.log(np.maximum((fr ** 2).sum(axis=1), np.finfo(np.float32).tiny))
    fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], axis=1)
    i = np.arange(length)
    fr = fr * (0.5 - 0.5 * np.cos(2 * math.pi * i / (length - 1))) ** 0.85
    spec = np.fft.rfft(fr, n=pad, axis=1)[:, : pad // 2]
    power = spec.real ** 2 + spec.imag ** 2
    lo, hi = _mel(20.0), _mel(samp_freq / 2)
    d = (hi - lo) / (num_bins + 1)
    left = lo + np.arange(num_bins) * d
    fm = _mel(np.arange(pad // 2) * samp_freq / pad)[:, None]
    banks = np.maximum(0.0, np.minimum((fm - left) / d, (left + 2 * d - fm) / d))
    logmel = np.log(np.maximum(power @ banks, 1e-30))
    n = np.arange(num_bins)
    k = np.arange(num_ceps)[:, None]
    dct = np.sqrt(2.0 / num_bins) * np.cos(math.pi * k * (2 * n + 1) / (2 * num_bins))
    dct[0] = np.sqrt(1.0 / num_bins)
    ceps = logmel @ dct.T * (1.0 + 0.5 * lifter * np.sin(math.pi * np.arange(num_ceps) / lifter))
    ceps[:, 0] = log_e
    ceps -= ceps.mean(axis=0)
    j = np.arange(-2, 3, dtype=np.float64)
    kern = j / np.sum(j ** 2)
    outs, filt = [], np.array([1.0])
    for order in range(3):
        if order:
            filt = np.convolve(filt, kern)
        r = (len(filt) - 1) // 2
        idx = np.clip(np.arange(T)[:, None] + np.arange(-r, r + 1)[None, :], 0, T - 1)
        outs.append(np.einsum("tkd,k->td", ceps[idx], filt))
    return np.concatenate(outs, axis=1)


def test_compute_feats_against_a_float64_oracle(test_sets):
    """Which side of the 1e-3 + 1e-5·max|feature| agreement above is off:
    against the float64 oracle the port is within a flat 1e-3 on every
    utterance and closer than the JAX recipe (worst and mean error); the JAX
    recipe needs the wider bound (measured worst: port 6.6e-4, JAX recipe
    1.8e-3, at features up to 127)."""
    (jw, _), (tw, _) = test_sets
    want = jminilib.compute_feats(jw)
    got = tminilib.compute_feats(tw, device="cpu")
    for k in sorted(tw):
        oracle = _oracle_feats(tw[k])
        assert oracle.shape == got[k].shape == want[k].shape
        port_err = np.abs(got[k] - oracle)
        jax_err = np.abs(want[k] - oracle)
        assert port_err.max() < ATOL
        assert jax_err.max() < ATOL + 1e-5 * float(np.abs(oracle).max())
        assert port_err.max() < jax_err.max() and port_err.mean() < jax_err.mean()
