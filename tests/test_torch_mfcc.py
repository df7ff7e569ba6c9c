"""Port fused MFCC (plain version, the one a CPU tensor takes) vs the JAX
Pallas kernel in interpret mode and vs its jnp reference.  Tolerance 1e-3
absolute: float32 sums taken in another order at log-mel magnitudes ~20."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.feat.compute as jcompute
import old_kaldi_git_tpu.ops.mfcc_kernel as jk
from old_kaldi_git_tpu.feat.window import extract_frames as jax_extract_frames
from old_kaldi_git_tpu_torch.feat.compute import MfccOptions
from old_kaldi_git_tpu_torch.ops.mfcc_kernel import (
    fused_mfcc_from_frames,
    fused_mfcc_reference,
    make_mfcc_weights,
)


def _opts(samp_freq):
    j, t = jcompute.MfccOptions(use_energy=False), MfccOptions(use_energy=False)
    for o in (j, t):
        o.frame_opts.samp_freq = samp_freq
        o.frame_opts.dither = 0.0
    return j, t


def _frames(jopts, seed, num_samples, amp):
    rng = np.random.default_rng(seed)
    wave = (rng.normal(size=num_samples) * amp).astype(np.float32)
    frames, _ = jax_extract_frames(jnp.asarray(wave), jopts.frame_opts)
    return np.array(frames)  # a writable copy


@pytest.mark.parametrize("samp_freq", [8000.0, 16000.0])
def test_weight_tables_equal(samp_freq):
    jopts, topts = _opts(samp_freq)
    jw = [np.asarray(x) for x in jk.make_mfcc_weights(jopts)]
    tw = [x.numpy() for x in make_mfcc_weights(topts, device="cpu")]
    nb, nc = topts.mel_opts.num_bins, topts.num_ceps
    w = topts.frame_opts.padded_window_size
    assert tw[0].shape == tw[1].shape == (w, w // 2)
    assert tw[2].shape == (w // 2, nb) and tw[3].shape == (nb, nc)
    np.testing.assert_allclose(tw[0], jw[0], atol=1e-6)
    np.testing.assert_allclose(tw[1], jw[1], atol=1e-6)
    # the TPU tables are the same numbers padded to 128 lanes with zeros
    np.testing.assert_allclose(tw[2], jw[2][:, :nb], atol=1e-6)
    np.testing.assert_allclose(tw[3], jw[3][:nb, :nc], atol=1e-6)
    assert not jw[2][:, nb:].any() and not jw[3][nb:].any() and not jw[3][:, nc:].any()


@pytest.mark.parametrize("samp_freq,num_samples,amp", [
    (8000.0, 6000, 2500.0),   # the flagship front end: W=256
    (16000.0, 5000, 500.0),   # W=512
])
def test_matches_pallas_interpret_and_reference(samp_freq, num_samples, amp):
    jopts, topts = _opts(samp_freq)
    frames = _frames(jopts, 1, num_samples, amp)
    assert frames.shape[0] % 128 != 0  # ragged against the TPU tile
    jw = jk.make_mfcc_weights(jopts)
    out = fused_mfcc_from_frames(
        torch.from_numpy(frames), make_mfcc_weights(topts, device="cpu")).numpy()
    assert out.shape == (frames.shape[0], 13) and out.dtype == np.float32
    ref = np.asarray(jk.fused_mfcc_reference(jnp.asarray(frames), jw))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    pallas = np.asarray(jk.fused_mfcc_from_frames(jnp.asarray(frames), jw,
                                                  interpret=True))
    np.testing.assert_allclose(out, pallas, atol=1e-3, rtol=0)


def test_silent_frames_hit_the_log_floor_like_the_reference():
    jopts, topts = _opts(8000.0)
    frames = np.zeros((5, 256), np.float32)
    out = fused_mfcc_reference(torch.from_numpy(frames), make_mfcc_weights(topts, device="cpu"))
    ref = np.asarray(jk.fused_mfcc_reference(jnp.asarray(frames),
                                             jk.make_mfcc_weights(jopts)))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)


def test_wrapper_refuses_tables_that_do_not_chain():
    _, topts = _opts(8000.0)
    w = make_mfcc_weights(topts, device="cpu")
    with pytest.raises(ValueError):
        fused_mfcc_from_frames(torch.zeros((4, 512)), w)
    with pytest.raises(TypeError):
        fused_mfcc_from_frames(torch.zeros((4, 256), dtype=torch.float64), w)
    before = fused_mfcc_from_frames.launches
    fused_mfcc_from_frames(torch.zeros((4, 256)), w)
    assert fused_mfcc_from_frames.launches == before  # CPU: no kernel launch


def test_weight_tables_go_to_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, topts = _opts(8000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mfcc_weights(topts)
    assert all(t.device.type == "cpu" for t in make_mfcc_weights(topts, device="cpu"))
