"""Port front end vs the JAX package on the CPU: framing, MFCC and deltas
(the recipe's compute_feats on synthesised utterances of ragged length, with
the tolerances below: tests/test_torch_feat_sets.py).  Tolerance 1e-3 absolute: float32 sums in
another order at cepstral magnitudes of tens.  On the synthesised speech the
liftered cepstra reach magnitudes above 100, where 1e-3 absolute would be
1e-5 relative — a few float32 ulps of 256-term sums — and CMN and the delta
filters carry that error into small elements too, so there the bound adds
1e-5 of the utterance's largest feature (measured worst case: 1.5e-3 at a
largest feature of 114; the JAX package's own kernel test allows 1e-3
relative on top of 1e-3 absolute).  The synthesis itself is a numpy copy and
must be bit-equal."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.feat.compute as jcompute
import old_kaldi_git_tpu.feat.functions as jfunctions
import old_kaldi_git_tpu.feat.window as jwindow
import old_kaldi_git_tpu_torch.feat.compute as tcompute
import old_kaldi_git_tpu_torch.feat.functions as tfunctions
import old_kaldi_git_tpu_torch.feat.window as twindow

ATOL = 1e-3


def _wave(seed, shape, amp=1500.0):
    return (np.random.default_rng(seed).normal(size=shape) * amp).astype(np.float32)


def _frame_opts(mod, **kw):
    o = mod.FrameExtractionOptions(dither=0.0)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


@pytest.mark.parametrize("kw", [
    dict(samp_freq=8000.0),
    dict(samp_freq=16000.0),
    dict(samp_freq=8000.0, snip_edges=False),
    dict(samp_freq=8000.0, window_type="hamming", preemph_coeff=0.0,
         remove_dc_offset=False, round_to_power_of_two=False),
])
def test_extract_frames(kw):
    jo, to = _frame_opts(jwindow, **kw), _frame_opts(twindow, **kw)
    assert to.window_size == jo.window_size
    assert to.padded_window_size == jo.padded_window_size
    for n in (0, 199, 200, 1234, 8000):
        assert twindow.num_frames(n, to) == jwindow.num_frames(n, jo)
    assert np.array_equal(twindow.feature_window(to), jwindow.feature_window(jo))
    assert np.array_equal(twindow.frame_start_indices(3000, to),
                          jwindow.frame_start_indices(3000, jo))
    wave = _wave(0, (2, 3000))
    jf, je = jwindow.extract_frames(jnp.asarray(wave), jo)
    tf, te = twindow.extract_frames(torch.from_numpy(wave), to)
    assert tuple(tf.shape) == jf.shape and tuple(te.shape) == je.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4, rtol=0)


def test_dither_needs_an_explicit_generator():
    to = twindow.FrameExtractionOptions(samp_freq=8000.0, dither=1.0)
    wave = torch.from_numpy(_wave(1, (1, 2000)))
    plain, _ = twindow.extract_frames(wave, to)
    again, _ = twindow.extract_frames(wave, to)
    assert torch.equal(plain, again)  # no generator: no dither, deterministic
    g = torch.Generator().manual_seed(3)
    dithered, _ = twindow.extract_frames(wave, to, dither_generator=g)
    assert not torch.equal(plain, dithered)


@pytest.mark.parametrize("samp_freq,use_energy", [(8000.0, True), (16000.0, True),
                                                  (8000.0, False)])
def test_mfcc(samp_freq, use_energy):
    jo = jcompute.MfccOptions(use_energy=use_energy)
    to = tcompute.MfccOptions(use_energy=use_energy)
    for o in (jo, to):
        o.frame_opts.samp_freq = samp_freq
        o.frame_opts.dither = 0.0
    assert np.array_equal(tcompute.dct_matrix(13, 23), jcompute.dct_matrix(13, 23))
    assert np.array_equal(tcompute.lifter_coeffs(13, 22.0),
                          jcompute.lifter_coeffs(13, 22.0))
    wave = _wave(2, (3, 4321))
    want = np.asarray(jcompute.Mfcc(jo)(jnp.asarray(wave)))
    got = tcompute.Mfcc(to)(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("order,window,T", [(2, 2, 50), (1, 3, 7), (2, 2, 3)])
def test_compute_deltas(order, window, T):
    jo = jfunctions.DeltaFeaturesOptions(order=order, window=window)
    to = tfunctions.DeltaFeaturesOptions(order=order, window=window)
    for a, b in zip(tfunctions.delta_filters(to), jfunctions.delta_filters(jo)):
        assert np.array_equal(a, b)
    x = _wave(3, (2, T, 13), amp=10.0)
    want = np.asarray(jfunctions.compute_deltas(jnp.asarray(x), jo))
    got = tfunctions.compute_deltas(torch.from_numpy(x), to).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("warp", [0.9, 1.1, 1.0])
def test_mfcc_vtln_warp(warp):
    """Mfcc(wave, vtln_warp=w) runs the kernel's plain version on the warped
    mel table and equals the JAX Mfcc at that warp within the features rule
    (1e-3 + 1e-5 of the largest feature); the warp-1.0 call is the unwarped
    one, bit for bit, and another warp moves the cepstra."""
    jo, to = jcompute.MfccOptions(), tcompute.MfccOptions()
    for o in (jo, to):
        o.frame_opts.samp_freq = 8000.0
        o.frame_opts.dither = 0.0
    wave = _wave(4, (2, 4000))
    want = np.asarray(jcompute.Mfcc(jo)(jnp.asarray(wave), vtln_warp=warp))
    mfcc = tcompute.Mfcc(to)
    got = mfcc(torch.from_numpy(wave), vtln_warp=warp).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL + 1e-5 * np.abs(want).max(), rtol=0)
    plain = mfcc(torch.from_numpy(wave)).numpy()
    if warp == 1.0:
        assert np.array_equal(got, plain)
    else:
        assert np.abs(got - plain).max() > 0.1
        assert set(mfcc._weights) == {("cpu", warp), ("cpu", 1.0)}
