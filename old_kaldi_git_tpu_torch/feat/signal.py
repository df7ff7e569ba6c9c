"""Signal-level utilities: FFT convolution and reverberation (counterpart
of old_kaldi_git_tpu/feat/signal.py).

Reference parity (SURVEY.md §2.2): src/feat/signal.{h,cc}
(FFTbasedBlockConvolveSignals — the wav-reverberate data-augmentation
path): convolve speech with a room impulse response via overlap-add block
FFT, with optional level normalization and additive noise mixing at a
target SNR.

This is data preparation on the host, in numpy float64, as in the JAX
package: wav-reverberate writes waves, which the feature tools then move to
the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from old_kaldi_git_tpu_torch.utils.log import get_logger

log = get_logger("signal")


def fft_convolve(signal: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Linear convolution via block FFT (overlap-add); output length
    len(signal) + len(kernel) - 1.  Matches np.convolve to float32
    precision but runs in O(N log N)."""
    signal = np.asarray(signal, np.float64)
    kernel = np.asarray(kernel, np.float64)
    n_out = len(signal) + len(kernel) - 1
    block = 1
    while block < 4 * len(kernel) or block < 4096:
        block *= 2
    step = block - len(kernel) + 1
    kf = np.fft.rfft(kernel, block)
    out = np.zeros(n_out + block)
    for s in range(0, len(signal), step):
        seg = signal[s: s + step]
        out[s: s + block] += np.fft.irfft(
            np.fft.rfft(seg, block) * kf, block
        )
    return out[:n_out].astype(np.float32)


def reverberate(
    signal: np.ndarray,
    rir: np.ndarray,
    shift_output: bool = True,
    volume: Optional[float] = None,
) -> np.ndarray:
    """~ wav-reverberate: convolve with a room impulse response.

    shift_output aligns the output to the RIR's direct path (its absolute
    peak), keeping the output time-aligned with the input as the reference
    does; the result is trimmed to the input length and power-normalized to
    the input unless an explicit volume is given."""
    signal = np.asarray(signal, np.float64)
    rir = np.asarray(rir, np.float64)
    wet = fft_convolve(signal, rir).astype(np.float64)
    if shift_output:
        peak = int(np.argmax(np.abs(rir)))
        wet = wet[peak: peak + len(signal)]
    else:
        wet = wet[: len(signal)]
    if volume is not None:
        wet = wet * volume
    else:
        p_in = float(np.mean(signal ** 2))
        p_out = float(np.mean(wet ** 2))
        if p_out > 0:
            wet = wet * np.sqrt(p_in / p_out)
    return wet.astype(np.float32)


def add_noise(
    signal: np.ndarray, noise: np.ndarray, snr_db: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Mix noise at the given SNR (wav-reverberate --additive-signals).

    Noise shorter than the signal is tiled; longer noise contributes a
    random window."""
    signal = np.asarray(signal, np.float64)
    noise = np.asarray(noise, np.float64)
    # fresh entropy by default: a fixed seed here would give every
    # utterance the identical noise window, collapsing augmentation
    # diversity (pass an explicit rng for reproducible pipelines)
    rng = rng if rng is not None else np.random.default_rng()
    if len(noise) < len(signal):
        reps = int(np.ceil(len(signal) / len(noise)))
        noise = np.tile(noise, reps)
    if len(noise) > len(signal):
        off = int(rng.integers(0, len(noise) - len(signal) + 1))
        noise = noise[off: off + len(signal)]
    p_sig = float(np.mean(signal ** 2))
    p_noise = float(np.mean(noise ** 2))
    if p_noise <= 0 or p_sig <= 0:
        return signal.astype(np.float32)
    target = p_sig / (10.0 ** (snr_db / 10.0))
    return (signal + noise * np.sqrt(target / p_noise)).astype(np.float32)
