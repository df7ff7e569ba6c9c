"""The fused MFCC kernel's "fft" route, on the CPU.

csrc/mfcc.cu runs only on the card; what surrounds it is held here:

- the route choice by window (`mfcc_route`) and the radices of each
  window's passes;
- the float64 twiddle table (`twiddles`);
- the mel spans (`mel_spans`), which must rebuild the dense [W/2, num_bins]
  filterbank exactly and fit the kernel's span table (`check_mel_spans`);
- an emulation of the kernel's arithmetic: the W/2-point complex FFT in the
  passes of FFT_PLANS[W] (Stockham order, a radix-2 decimation-in-frequency
  DFT inside each pass, with the kernel's constants), the real-input split,
  then power, the span sums, the floored log and the DCT in float64.  It
  must equal `torch.fft.rfft` in float64 to 1e-9 relative, stay within the
  kernel's contract of 1e-3 absolute of the float32 plain version on real
  held-out frames, and within 1e-4 of the plain version run in float64;
- that the same frames make a 3×TF32 DFT and a float32 FFT miss the 1e-3
  check that the float64 design meets: that is why the route is float64."""

import tests.torch_threads  # noqa: F401
import math

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.feat import MfccOptions, extract_frames
from old_kaldi_git_tpu_torch.ops import mfcc_kernel as mk
from old_kaldi_git_tpu_torch.ops.gmm_kernel import tf32_round
from old_kaldi_git_tpu_torch.recipes import minilib

TOL = 1e-3      # the kernel's contract against the float32 plain version
TOL64 = 1e-4    # against the plain version run in float64


def _opts(samp_freq, pow2=True):
    o = MfccOptions()
    o.frame_opts.samp_freq = samp_freq
    o.frame_opts.dither = 0.0
    o.frame_opts.round_to_power_of_two = pow2
    return o


@pytest.fixture(scope="module")
def held_out_waves():
    """The first 32 utterances (by key) of the 256-utterance held-out set,
    padded into one batch as the front end pads a chunk."""
    waves, _ = minilib.make_test_set(minilib.MinilibOptions())
    keys = sorted(waves)[:32]
    batch = np.zeros((len(keys), max(waves[k].shape[0] for k in keys)), np.float32)
    for i, k in enumerate(keys):
        batch[i, : waves[k].shape[0]] = waves[k]
    return torch.from_numpy(batch)


def _frames(batch, opts):
    frames, _ = extract_frames(batch, opts.frame_opts)
    return frames.reshape(-1, frames.shape[-1]).contiguous()


# ---- the emulation -----------------------------------------------------------

def _root16(t, dtype):
    """e^{−2πit/16}, the constants of the kernel's in-register DFTs."""
    return dtype(math.cos(2 * math.pi * t / 16) - 1j * math.sin(2 * math.pi * t / 16))


def _bitrev(k, r):
    bits = r.bit_length() - 1
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_dif(v, dtype):
    """An R-point DFT along the last axis as the kernel's registers take it:
    radix-2 decimation in frequency, the result in bit-reversed positions."""
    r = v.shape[-1]
    v = v.copy()
    h = r // 2
    while h >= 1:
        for s in range(0, r, 2 * h):
            for q in range(h):
                a, c = s + q, s + q + h
                x, y = v[..., a].copy(), v[..., c].copy()
                v[..., a] = x + y
                v[..., c] = (x - y) * _root16(q * (16 // (2 * h)), dtype)
        h //= 2
    return v[..., [_bitrev(k, r) for k in range(r)]]


def emulate_spectrum(frames, w, dtype=np.complex128):
    """[N, W] real frames → [N, W/2] bins X[k], in the kernel's order of
    operations: z[n] = x[2n] + i·x[2n+1]; the passes of FFT_PLANS[w]; the
    split.  complex64 gives the same algorithm in float32."""
    tw = mk.twiddles(w)
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(dtype)
    m = w // 2
    x = np.asarray(frames, np.float64)
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(dtype)
    ns = 1
    for r in mk.FFT_PLANS[w]:
        j = np.arange(m // r)
        rr = np.arange(r)
        v = z[:, j[:, None] + rr[None, :] * (m // r)]
        if ns > 1:
            v = v * twc[(rr[None, :] * (j % ns)[:, None]) * (w // (ns * r))]
        v = _dft_dif(v, dtype)
        out = np.empty_like(z)
        out[:, ((j // ns) * ns * r + j % ns)[:, None] + rr[None, :] * ns] = v
        z, ns = out, ns * r
    k = np.arange(m)
    a, b = z[:, k], np.conj(z[:, (m - k) % m])
    half = dtype(0.5)
    return half * (a + b) - half * 1j * twc[k] * (a - b)


def emulate_kernel(frames, weights):
    """The "fft" route: the float64 spectrum, then power, the span sums,
    the floored log and the DCT in float64 against the float32 tables;
    float32 out."""
    _, _, mel, dct = (t.numpy() for t in weights)
    w = frames.shape[1]
    x = emulate_spectrum(frames, w)
    power = x.real ** 2 + x.imag ** 2
    energies = np.stack(
        [(power[:, s: s + n] * mel[s: s + n, i].astype(np.float64)).sum(1)
         for i, (s, n) in enumerate(mk.mel_spans(mel))], axis=1)
    return (np.log(np.maximum(energies, mk.EPS)) @ dct.astype(np.float64)).astype(np.float32)


def _plain64(frames, opts):
    return mk.fused_mfcc_reference(
        torch.as_tensor(frames).double(),
        mk.make_mfcc_weights(opts, device="cpu", dtype=torch.float64)).numpy()


# ---- the host tables ---------------------------------------------------------

@pytest.mark.parametrize("w,route", [(128, "fft"), (256, "fft"), (512, "fft"),
                                     (1024, "fft"), (400, "dft"), (200, "dft"),
                                     (64, "dft"), (2048, "dft")])
def test_route_is_chosen_by_the_window(w, route):
    assert mk.mfcc_route(w) == route


@pytest.mark.parametrize("w", sorted(mk.FFT_PLANS))
def test_fft_plan_covers_the_window(w):
    """A radix-16 pass first (16 points a thread), then passes whose radices
    divide 16, W/2 points in all."""
    plan = mk.FFT_PLANS[w]
    assert math.prod(plan) == w // 2 and plan[0] == 16
    assert all(16 % r == 0 for r in plan)


@pytest.mark.parametrize("w", [8, 128, 256, 400, 512, 1024])
def test_twiddle_table_is_exact_float64(w):
    t = mk.twiddles(w)
    assert t.dtype == np.float64 and t.shape == (w, 2)
    q = np.arange(w)
    want = np.exp(-2j * np.pi * q / w)
    assert np.abs(t[:, 0] + 1j * t[:, 1] - want).max() < 1e-15
    assert np.abs(np.hypot(t[:, 0], t[:, 1]) - 1.0).max() < 3e-16
    for k, (c, s) in enumerate([(1, 0), (0, -1), (-1, 0), (0, 1)]):
        assert t[k * w // 4, 0] == c and t[k * w // 4, 1] == s
    # the mirrored entries are the same numbers: e^{−2πi(w−q)/w} = conj
    assert np.array_equal(t[1:, 0], t[:0:-1, 0])
    assert np.array_equal(t[1:, 1], -t[:0:-1, 1])


@pytest.mark.parametrize("w", [100, 250])
def test_twiddle_table_of_a_window_not_divisible_by_8(w):
    t = mk.twiddles(w)
    want = np.exp(-2j * np.pi * np.arange(w) / w)
    assert t.shape == (w, 2) and np.abs(t[:, 0] + 1j * t[:, 1] - want).max() < 1e-15
    assert t[0, 0] == 1.0 and t[0, 1] == 0.0


@pytest.mark.parametrize("samp_freq,w,pow2", [
    (8000.0, 128, True), (8000.0, 256, True), (16000.0, 512, True),
    (8000.0, 1024, True), (16000.0, 400, False)])
def test_the_filterbanks_of_each_route_fit_the_span_table(samp_freq, w, pow2):
    o = _opts(samp_freq, pow2)
    o.frame_opts.frame_length_ms = 1000.0 * (w - (8 if pow2 else 0)) / samp_freq
    mel = mk.make_mfcc_weights(o, device="cpu")[2]
    assert mel.shape[0] == w // 2
    mk.check_mel_spans(mel)  # does not raise
    assert mk.mel_spans(mel.numpy())[:, 1].sum() <= 2 * (w // 2) + mel.shape[1]


def test_a_filterbank_that_overflows_the_span_table_is_refused_again_after_an_edit():
    mel = mk.make_mfcc_weights(_opts(8000.0), device="cpu")[2].clone()
    mk.check_mel_spans(mel)
    mel[:, 0] = 1.0  # one filter over every bin: 128 more than a triangle's span
    with pytest.raises(ValueError, match="span table"):
        mk.check_mel_spans(mel)
    with pytest.raises(ValueError, match="span table"):
        mk.check_mel_spans(torch.ones((128, 23)))


@pytest.mark.parametrize("samp_freq,w", [(8000.0, 256), (16000.0, 512)])
def test_mel_spans_rebuild_the_dense_filterbank_exactly(samp_freq, w):
    mel = mk.make_mfcc_weights(_opts(samp_freq), device="cpu")[2].numpy()
    assert mel.shape[0] == w // 2
    spans = mk.mel_spans(mel)
    assert spans.shape == (mel.shape[1], 2) and spans.dtype == np.int32
    dense = np.zeros_like(mel)
    for m, (s, n) in enumerate(spans):
        assert n > 0 and s + n <= w // 2
        dense[s: s + n, m] = mel[s: s + n, m]
    assert np.array_equal(dense, mel)
    # about 2 products a bin instead of num_bins
    assert spans[:, 1].sum() <= 2 * (w // 2)


def test_weight_tables_in_float64_hold_the_exact_dft_and_the_same_mel_and_dct():
    o = _opts(8000.0)
    t32 = mk.make_mfcc_weights(o, device="cpu")
    t64 = mk.make_mfcc_weights(o, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in t64)
    assert torch.equal(t64[2], t32[2].double()) and torch.equal(t64[3], t32[3].double())
    assert torch.equal(t64[0].float(), t32[0]) and torch.equal(t64[1].float(), t32[1])
    n = np.arange(256)[:, None] * np.arange(128)[None, :]
    assert np.abs(t64[0].numpy() - np.cos(2 * np.pi * n / 256)).max() < 1e-13


# ---- the emulated kernel -----------------------------------------------------

def emulate_direct(frames, w):
    """The "dft" route's spectrum: X[k] = Σ_n x[n]·tw[nk mod W], float64."""
    tw = mk.twiddles(w)
    q = (np.arange(w)[:, None] * np.arange(w // 2)[None, :]) % w
    x = np.asarray(frames, np.float64)
    return x @ tw[q, 0] + 1j * (x @ tw[q, 1])


@pytest.mark.parametrize("samp_freq", [8000.0, 16000.0])
def test_direct_route_at_a_window_of_400_meets_both_checks(samp_freq, held_out_waves):
    o = _opts(samp_freq, pow2=False)
    o.frame_opts.frame_length_ms = 400_000.0 / samp_freq  # W = 400 samples
    frames = _frames(held_out_waves[:4], o)
    w = frames.shape[1]
    assert w == 400 and mk.mfcc_route(w) == "dft"
    live = frames[frames.abs().amax(1) > 0].numpy()
    got = emulate_direct(live, w)
    want = np.fft.rfft(live.astype(np.float64), axis=1)[:, : w // 2]
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    weights = mk.make_mfcc_weights(o, device="cpu")
    power = got.real ** 2 + got.imag ** 2
    mel, dct = weights[2].numpy().astype(np.float64), weights[3].numpy().astype(np.float64)
    out = (np.log(np.maximum(power @ mel, mk.EPS)) @ dct).astype(np.float32)
    plain = mk.fused_mfcc_reference(torch.from_numpy(live), weights).numpy()
    assert np.abs(out - plain).max() <= TOL
    assert np.abs(out - _plain64(live, o)).max() <= TOL64


@pytest.mark.parametrize("w", sorted(mk.FFT_PLANS))
def test_emulated_fft_equals_rfft_in_float64(w, held_out_waves):
    o = _opts(8000.0)
    o.frame_opts.frame_length_ms = 1000.0 * (w - 8) / 8000.0  # pads to w
    frames = _frames(held_out_waves[:2], o).numpy()
    frames = frames[np.abs(frames).max(1) > 0]  # not the batch's padding
    assert frames.shape[1] == w and np.abs(frames).max() > 100
    got = emulate_spectrum(frames, w)
    want = np.fft.rfft(frames.astype(np.float64), axis=1)[:, : w // 2]
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    # bin by bin too, where a bin is not far below the frame's loudest
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max(1, keepdims=True))
    assert rel.max() < 1e-9


@pytest.mark.parametrize("samp_freq", [8000.0, 16000.0])
def test_emulated_kernel_meets_the_contract_on_real_frames(samp_freq, held_out_waves):
    o = _opts(samp_freq)
    frames = _frames(held_out_waves, o)
    weights = mk.make_mfcc_weights(o, device="cpu")
    assert frames.shape[1] == (256 if samp_freq == 8000.0 else 512)
    out = emulate_kernel(frames.numpy(), weights)
    plain = mk.fused_mfcc_reference(frames, weights).numpy()
    assert out.shape == plain.shape and np.isfinite(out).all()
    assert np.abs(out - plain).max() <= TOL
    assert np.abs(out - _plain64(frames, o)).max() <= TOL64
    # and the oracle: the exact spectrum through the same float32 tables
    spec = torch.fft.rfft(frames.double(), dim=1)[:, : frames.shape[1] // 2]
    power = spec.real ** 2 + spec.imag ** 2
    oracle = (torch.log(torch.clamp(power @ weights[2].double(), min=mk.EPS))
              @ weights[3].double()).numpy()
    assert np.abs(out - oracle).max() <= TOL64


def test_silent_frames_hit_the_log_floor_exactly():
    o = _opts(8000.0)
    weights = mk.make_mfcc_weights(o, device="cpu")
    frames = np.zeros((5, 256), np.float32)
    spec = emulate_spectrum(frames, 256)
    assert not spec.any()
    # every mel energy is 0: the log takes the floor, exactly
    floor = np.full((5, weights[2].shape[1]), np.log(mk.EPS))
    out = emulate_kernel(frames, weights)
    want = (floor @ weights[3].numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(out, want)
    plain = mk.fused_mfcc_reference(torch.from_numpy(frames), weights).numpy()
    assert np.abs(out - plain).max() <= TOL
    assert np.abs(out - _plain64(frames, o)).max() <= TOL64


def test_three_tf32_dft_and_fp32_fft_miss_the_check_that_float64_meets(held_out_waves):
    o = _opts(8000.0)
    frames = _frames(held_out_waves, o)
    weights = mk.make_mfcc_weights(o, device="cpu")
    plain = mk.fused_mfcc_reference(frames, weights).numpy()
    c_re, c_im, mel, dct = weights

    def tail(re, im):
        power = re * re + im * im
        return (torch.log(torch.clamp(power @ mel, min=mk.EPS)) @ dct).numpy()

    # the DFT as three TF32 products (hi·hi + hi·lo + lo·hi), float32 sums
    x = frames.numpy()
    xh = tf32_round(x)
    xl = tf32_round(x - xh)

    def three(c):
        ch = tf32_round(c.numpy())
        cl = tf32_round(c.numpy() - ch)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        return t(xh) @ t(ch) + t(xh) @ t(cl) + t(xl) @ t(ch)

    three_tf32 = np.abs(tail(three(c_re), three(c_im)) - plain).max()
    # the kernel's own FFT order in float32
    spec = emulate_spectrum(x, 256, np.complex64)
    fp32_fft = np.abs(tail(torch.from_numpy(spec.real.copy()),
                           torch.from_numpy(spec.imag.copy())) - plain).max()
    float64 = np.abs(emulate_kernel(x, weights) - plain).max()
    assert float64 <= TOL < min(three_tf32, fp32_fft)
