"""The port's filterbank, spectrogram and PLP against the JAX package's on
the CPU, on the yesno waves (8 kHz, 4 utterances padded into one batch):
within 1e-3 + 1e-5·max|feature| (the MFCC rule of tests/test_torch_feat.py).
The port computes the spectrum in float64 (torch.fft.rfft) and the JAX
package as float32 products of DFT tables; at spectrogram bins some seven
orders of magnitude below their frame's peak the JAX package's own float32
rounding reaches 4e-3 in the log, so the spectrogram is held at that
tolerance where a bin's power is at least 1e-6 of its frame's largest, and
everywhere within 1e-6 of numpy's float64 FFT of the same float64 frames.  The
batched front end `compute_utterance_fbank` gives the MFCC front end's
frame counts and per-utterance means of 0 (1e-4)."""

import tests.torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.feat.compute as jc
from old_kaldi_git_tpu.recipes.yesno import make_corpus
import old_kaldi_git_tpu_torch.feat.compute as tc
from old_kaldi_git_tpu_torch.feat.window import extract_frames


@pytest.fixture(scope="module")
def waves():
    tw, _, _, _ = make_corpus(4, 2)
    keys = sorted(tw)[:4]
    batch = np.zeros((len(keys), max(len(tw[k]) for k in keys)), np.float32)
    for i, k in enumerate(keys):
        batch[i, : len(tw[k])] = tw[k]
    return {k: tw[k] for k in keys}, batch


def _opts(mod, name, **kw):
    o = getattr(mod, name)(**{k: v for k, v in kw.items() if k != "num_bins"})
    o.frame_opts.samp_freq = 8000.0
    o.frame_opts.dither = 0.0
    if "num_bins" in kw:
        o.mel_opts.num_bins = kw["num_bins"]
    return o


def _rule(got, want):
    np.testing.assert_allclose(got, want, atol=1e-3 + 1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("cls,kw", [
    ("Fbank", {}), ("Fbank", dict(num_bins=40, use_energy=True, energy_floor=1.0)),
    ("Fbank", dict(use_power=False, use_log_fbank=False)),
    ("Plp", {}), ("Plp", dict(cepstral_scale=2.0, use_energy=False, lpc_order=10)),
])
def test_against_the_jax_package(waves, cls, kw):
    _, batch = waves
    want = np.asarray(getattr(jc, cls)(_opts(jc, cls + "Options", **kw))(jnp.asarray(batch)))
    comp = getattr(tc, cls)(_opts(tc, cls + "Options", **kw))
    got = comp(torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape and got.shape[-1] == comp.dim
    _rule(got, want)


def test_spectrogram(waves):
    _, batch = waves
    jo, to = _opts(jc, "SpectrogramOptions"), _opts(tc, "SpectrogramOptions")
    want = np.asarray(jc.Spectrogram(jo)(jnp.asarray(batch)))
    got = tc.Spectrogram(to)(torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape and got.shape[-1] == tc.Spectrogram(to).dim
    frames, log_energy = extract_frames(torch.from_numpy(batch).double(), to.frame_opts)
    power = np.abs(np.fft.rfft(frames.numpy(), axis=-1)) ** 2
    ref64 = np.log(np.maximum(power, tc.EPSILON))
    ref64[..., 0] = log_energy.numpy()
    np.testing.assert_allclose(got, ref64, atol=1e-6 * np.abs(ref64).max(), rtol=1e-6)
    resolved = power >= 1e-6 * power.max(axis=-1, keepdims=True)
    resolved[..., 0] = True
    tol = 1e-3 + 1e-5 * np.abs(want).max()
    assert np.abs(got - want)[resolved].max() <= tol


def test_batched_fbank_front_end(waves):
    by_key, _ = waves
    feats = tc.compute_utterance_fbank(by_key, 8000.0, torch.device("cpu"), chunk=3)
    mfcc = tc.compute_utterance_feats(by_key, 8000.0, torch.device("cpu"), deltas=False)
    for k, f in feats.items():
        assert f.shape == (mfcc[k].shape[0], 40) and f.dtype == np.float32
        np.testing.assert_allclose(f.mean(0), 0.0, atol=1e-4)
    # one utterance alone: the same rows as in the batch
    alone = tc.compute_utterance_fbank({k: by_key[k] for k in sorted(by_key)[:1]}, 8000.0,
                                       torch.device("cpu"))
    k0 = sorted(by_key)[0]
    np.testing.assert_allclose(alone[k0], feats[k0], atol=1e-5, rtol=0)
