"""Offline feature computers: MFCC, filterbank, spectrogram, PLP.

Counterpart of old_kaldi_git_tpu/feat/compute.py (reference
src/feat/feature-{mfcc,fbank,spectrogram,plp}.h and feature-common.h
OfflineFeatureTpl).  Array-first: a computer maps [B, num_samples] →
[B, T, D].

MFCC's spectrum path (DFT → power → mel → log → liftered DCT) runs through
the fused kernel of old_kaldi_git_tpu_torch.ops.mfcc_kernel; the column c0 is
then overwritten with the raw log energy.  Filterbank, spectrogram and PLP
reach no kernel (the JAX package computes them with jnp products): their
framing, spectrum (`torch.fft.rfft`), mel products and PLP's
Levinson-Durbin recursion run in float64, the result float32.
`compute_utterance_feats` and `compute_utterance_fbank` are the recipes'
batched front ends (per-utterance CMN; MFCC with optional deltas).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.feat.mel import MelBanksOptions, mel_banks_matrix
from old_kaldi_git_tpu_torch.feat.window import (
    FrameExtractionOptions,
    extract_frames,
    num_frames,
)
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

FEAT_CHUNK = 128  # utterances per front-end batch
EPSILON = float(np.finfo(np.float32).tiny)  # the floor under every log


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II (reference src/matrix/matrix-functions.cc
    ComputeDctMatrix): row 0 = sqrt(1/N), row k = sqrt(2/N) cos(pi k (2n+1)/2N)."""
    n = np.arange(num_cols)
    k = np.arange(num_rows)[:, None]
    mat = np.sqrt(2.0 / num_cols) * np.cos(math.pi * k * (2 * n + 1) / (2 * num_cols))
    mat[0] = np.sqrt(1.0 / num_cols)
    return mat.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Reference ComputeLifterCoeffs: 1 + 0.5*Q*sin(pi*i/Q)."""
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def _frame_opts():
    return FrameExtractionOptions()


def _mel_opts():
    return MelBanksOptions(num_bins=23)


@options_dataclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(default_factory=_frame_opts)
    mel_opts: MelBanksOptions = dataclasses.field(default_factory=_mel_opts)
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True


@options_dataclass
class SpectrogramOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(default_factory=_frame_opts)
    energy_floor: float = 0.0
    raw_energy: bool = True


@options_dataclass
class PlpOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(default_factory=_frame_opts)
    mel_opts: MelBanksOptions = dataclasses.field(default_factory=_mel_opts)
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0


@options_dataclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(default_factory=_frame_opts)
    mel_opts: MelBanksOptions = dataclasses.field(default_factory=_mel_opts)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


class Mfcc:
    """Reference src/feat/feature-mfcc.h MfccComputer.  The kernel's tables
    are built once per device and VTLN warp at first use."""

    def __init__(self, opts: Optional[MfccOptions] = None):
        self.opts = opts or MfccOptions()
        self.frame_opts: FrameExtractionOptions = self.opts.frame_opts
        self._weights = {}

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_opts)

    def weights(self, device: torch.device, vtln_warp: float = 1.0):
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import make_mfcc_weights

        key = (str(device), vtln_warp)
        if key not in self._weights:
            self._weights[key] = make_mfcc_weights(self.opts, device=device,
                                                   vtln_warp=vtln_warp)
        return self._weights[key]

    def __call__(self, wave: torch.Tensor, *,
                 dither_generator: Optional[torch.Generator] = None,
                 vtln_warp: float = 1.0) -> torch.Tensor:
        """[..., num_samples] → [..., T, num_ceps].  T from the padded length;
        use num_frames(actual_samples) to mask.  vtln_warp warps the mel
        filters (the kernel runs on the warped table)."""
        frames, log_energy = extract_frames(
            wave, self.frame_opts, dither_generator=dither_generator)
        return self._compute(frames, log_energy, vtln_warp)

    def _compute(self, frames: torch.Tensor, log_energy: torch.Tensor,
                 vtln_warp: float = 1.0) -> torch.Tensor:
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import fused_mfcc_from_frames

        o = self.opts
        lead = frames.shape[:-1]
        flat = frames.reshape(-1, frames.shape[-1]).contiguous()
        ceps = fused_mfcc_from_frames(
            flat, self.weights(frames.device, vtln_warp)).reshape(*lead, o.num_ceps)
        if o.use_energy:
            if o.energy_floor > 0.0:
                log_energy = torch.clamp(log_energy, min=math.log(o.energy_floor))
            ceps[..., 0] = log_energy  # in place: ceps is this call's own buffer
        return ceps


def real_spectrum(frames: torch.Tensor):
    """[..., N] → (real, imag), each [..., N//2 + 1] (rfft semantics),
    computed in float64, returned in the frames' dtype."""
    spec = torch.fft.rfft(frames.to(torch.float64), dim=-1)
    return spec.real.to(frames.dtype), spec.imag.to(frames.dtype)


def power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """[..., padded_N] windowed frames → [..., padded_N//2] power spectrum
    (the Nyquist bin dropped, matching MelBanks), in the frames' dtype."""
    return _SpectrumComputer.power(frames)[..., :-1].to(frames.dtype)


def _floored_log_energy(log_energy: torch.Tensor, energy_floor: float) -> torch.Tensor:
    if energy_floor > 0.0:
        return torch.clamp(log_energy, min=math.log(energy_floor))
    return log_energy


class _SpectrumComputer:
    """Framing and the float64 power spectrum shared by Fbank, Spectrogram
    and Plp; subclasses map (frames, log energy) to features."""

    def __init__(self, opts):
        self.opts = opts
        self.frame_opts: FrameExtractionOptions = opts.frame_opts
        self._mel_cache: Dict[float, np.ndarray] = {}

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_opts)

    def __call__(self, wave: torch.Tensor, *,
                 dither_generator: Optional[torch.Generator] = None,
                 vtln_warp: float = 1.0) -> torch.Tensor:
        """[..., num_samples] → [..., T, dim] float32.  T from the padded
        length; use num_frames(actual_samples) to mask.  Framed in float64:
        the log of a near-empty mel bin would carry float32's rounding of
        the frames (which differs between devices) into the features."""
        frames, log_energy = extract_frames(
            wave.to(torch.float64), self.frame_opts, dither_generator=dither_generator)
        return self._compute(frames, log_energy, vtln_warp).to(torch.float32)

    @staticmethod
    def power(frames: torch.Tensor) -> torch.Tensor:
        """[..., N] windowed frames → [..., N/2 + 1] power spectrum, float64."""
        spec = torch.fft.rfft(frames.to(torch.float64), dim=-1)
        return spec.real * spec.real + spec.imag * spec.imag

    def mel(self, like: torch.Tensor, vtln_warp: float = 1.0) -> torch.Tensor:
        """The [N/2, num_bins] mel weights (float32 values, as the JAX
        package's) in float64 on `like`'s device."""
        if vtln_warp not in self._mel_cache:
            w, _ = mel_banks_matrix(self.opts.mel_opts, self.frame_opts.samp_freq,
                                    self.frame_opts.padded_window_size, vtln_warp)
            self._mel_cache[vtln_warp] = np.asarray(w, np.float32)
        return torch.from_numpy(self._mel_cache[vtln_warp].astype(np.float64)).to(like.device)

    def _compute(self, frames, log_energy, vtln_warp):
        raise NotImplementedError


class Fbank(_SpectrumComputer):
    """Reference src/feat/feature-fbank.h FbankComputer: log mel energies
    [..., num_bins], the log energy first when use_energy."""

    def __init__(self, opts: Optional[FbankOptions] = None):
        super().__init__(opts or FbankOptions())

    @property
    def dim(self) -> int:
        return self.opts.mel_opts.num_bins + int(self.opts.use_energy)

    def _compute(self, frames, log_energy, vtln_warp):
        o = self.opts
        power = self.power(frames)[..., :-1]
        if not o.use_power:
            power = torch.sqrt(power)
        mel = power @ self.mel(power, vtln_warp)
        if o.use_log_fbank:
            mel = torch.log(torch.clamp(mel, min=EPSILON))
        if o.use_energy:
            e = _floored_log_energy(log_energy, o.energy_floor).to(mel.dtype)
            mel = torch.cat([e[..., None], mel], dim=-1)
        return mel


class Spectrogram(_SpectrumComputer):
    """Reference src/feat/feature-spectrogram.h: the log power spectrum
    [..., N/2 + 1] with the raw log energy in column 0."""

    def __init__(self, opts: Optional[SpectrogramOptions] = None):
        super().__init__(opts or SpectrogramOptions())

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1

    def _compute(self, frames, log_energy, vtln_warp):
        log_power = torch.log(torch.clamp(self.power(frames), min=EPSILON))
        e = _floored_log_energy(log_energy, self.opts.energy_floor).to(log_power.dtype)
        return torch.cat([e[..., None], log_power[..., 1:]], dim=-1)


def _idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """Reference src/feat/feature-functions.cc InitIdftBases: cosine bases
    mapping a symmetric spectrum of `dimension` points to autocorrelations."""
    k = np.arange(n_bases)[:, None]
    j = np.arange(dimension)[None, :]
    base = np.cos(math.pi * k * j / (dimension - 1))
    base[:, 0] *= 0.5
    base[:, -1] *= 0.5
    return (base / (dimension - 1)).astype(np.float64)


def _durbin(autocorr: torch.Tensor, order: int):
    """Levinson-Durbin over [..., order+1] autocorrelations → (lpc
    [..., order], residual energy [...]) (reference Durbin)."""
    r = [autocorr[..., i] for i in range(order + 1)]
    err = r[0]
    a = []
    for i in range(order):
        acc = r[i + 1]
        for j in range(i):
            acc = acc - a[j] * r[i - j]
        k = acc / torch.clamp(err, min=1e-20)
        a = [a[j] - k * a[i - 1 - j] for j in range(i)] + [k]
        err = err * (1.0 - k * k)
    return torch.stack(a, dim=-1), err


def _lpc_to_cepstrum(lpc: torch.Tensor, err: torch.Tensor, num_ceps: int) -> torch.Tensor:
    """LPC coefficients → cepstra (the JAX package's Lpc2Cepstrum);
    c0 = ln(residual) / 2."""
    order = lpc.shape[-1]
    ceps = [0.5 * torch.log(torch.clamp(err, min=1e-20))]
    for n in range(1, num_ceps):
        c = lpc[..., n - 1] if n <= order else torch.zeros_like(err)
        for k in range(1, n):
            if n - k <= order:
                c = c + (k / n) * ceps[k] * lpc[..., n - k - 1]
        ceps.append(c)
    return torch.stack(ceps, dim=-1)


class Plp(_SpectrumComputer):
    """Reference src/feat/feature-plp.h PlpComputer: mel spectrum →
    equal-loudness weighting → cube-root compression → IDFT → LPC →
    cepstra, liftered and scaled, c0 the log energy when use_energy."""

    def __init__(self, opts: Optional[PlpOptions] = None):
        super().__init__(opts or PlpOptions())
        o = self.opts
        _, centers = mel_banks_matrix(o.mel_opts, self.frame_opts.samp_freq,
                                      self.frame_opts.padded_window_size)
        fsq = centers.astype(np.float64) ** 2
        fsub = fsq / (fsq + 1.6e5)
        self._eql = (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)
        self._idft = _idft_bases(o.lpc_order + 1, o.mel_opts.num_bins + 2).T
        self._lifter = (lifter_coeffs(o.num_ceps, o.cepstral_lifter)
                        if o.cepstral_lifter != 0.0 else None)

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def _compute(self, frames, log_energy, vtln_warp):
        o = self.opts
        as64 = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(frames.device)  # noqa: E731
        mel = self.power(frames)[..., :-1] @ self.mel(frames)
        compressed = torch.pow(torch.clamp(mel * as64(self._eql), min=EPSILON),
                               o.compress_factor)
        spec = torch.cat([compressed[..., :1], compressed, compressed[..., -1:]], dim=-1)
        lpc, err = _durbin(spec @ as64(self._idft), o.lpc_order)
        ceps = _lpc_to_cepstrum(lpc, err, o.num_ceps)
        if self._lifter is not None:
            ceps = ceps * as64(self._lifter)
        if o.cepstral_scale != 1.0:
            ceps = ceps * o.cepstral_scale
        if o.use_energy:
            e = _floored_log_energy(log_energy, o.energy_floor).to(ceps.dtype)
            ceps = torch.cat([e[..., None], ceps[..., 1:]], dim=-1)
        return ceps


def _batched_waves(waves: Dict[str, np.ndarray], part, device: torch.device) -> torch.Tensor:
    """The waves of `part`, zero-padded to the longest, as one [B, S] tensor."""
    mlen = max(waves[k].shape[0] for k in part)
    batch = np.zeros((len(part), mlen), np.float32)
    for i, k in enumerate(part):
        batch[i, : waves[k].shape[0]] = waves[k]
    return torch.from_numpy(batch).to(device)


def _cmn(feats: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
    """[B, T, D] → frames past each utterance's end repeat its last frame,
    then its mean over its own frames is subtracted."""
    T = feats.shape[1]
    t_idx = torch.arange(T, device=feats.device)[None, :]
    idx = torch.minimum(t_idx, (nf - 1).clamp(min=0)[:, None])
    feats = feats.gather(1, idx[:, :, None].expand(-1, -1, feats.shape[2]))
    mask = (t_idx < nf[:, None]).to(feats.dtype)
    mean = (feats * mask[:, :, None]).sum(1) / nf.clamp(min=1)[:, None]
    return feats - mean[:, None, :]


def compute_utterance_fbank(waves: Dict[str, np.ndarray], samp_freq: float,
                            device: torch.device, num_bins: int = 40,
                            chunk: int = FEAT_CHUNK) -> Dict[str, np.ndarray]:
    """{utt: wave} → {utt: [T, num_bins] float32 log mel filterbank with
    per-utterance CMN}, undithered, framed as compute_utterance_feats frames
    (so a frame-level alignment of the MFCC features fits them), in chunks
    of `chunk` utterances (sorted by key) on `device`."""
    opts = FbankOptions()
    opts.frame_opts.samp_freq = samp_freq
    opts.frame_opts.dither = 0.0
    opts.mel_opts.num_bins = num_bins
    fbank = Fbank(opts)
    keys = sorted(waves)
    out: Dict[str, np.ndarray] = {}
    for c0 in range(0, len(keys), chunk):
        part = keys[c0: c0 + chunk]
        nf_h = np.asarray([fbank.num_frames(waves[k].shape[0]) for k in part])
        feats = fbank(_batched_waves(waves, part, device))
        res = _cmn(feats, torch.from_numpy(nf_h).to(device)).cpu().numpy()
        for i, k in enumerate(part):
            out[k] = res[i, : nf_h[i]].astype(np.float32)
    return out


def compute_utterance_feats(waves: Dict[str, np.ndarray], samp_freq: float,
                            device: torch.device, deltas: bool = True,
                            chunk: int = FEAT_CHUNK) -> Dict[str, np.ndarray]:
    """{utt: wave} → {utt: [T, 13] float32 MFCC with per-utterance CMN, and
    deltas ([T, 39]) with `deltas`}, undithered.  Each chunk of `chunk`
    utterances (sorted by key) is padded to its own longest wave, framed and
    run through the MFCC kernel as one [B·T, W] call; CMN and deltas run on
    the same device.  Frames past an utterance's end repeat its last frame
    before the deltas, so the edge regression equals the unbatched one."""
    from old_kaldi_git_tpu_torch.feat.functions import compute_deltas

    opts = MfccOptions()
    opts.frame_opts.samp_freq = samp_freq
    opts.frame_opts.dither = 0.0
    mfcc = Mfcc(opts)
    keys = sorted(waves)
    out: Dict[str, np.ndarray] = {}
    for c0 in range(0, len(keys), chunk):
        part = keys[c0: c0 + chunk]
        nf_h = np.asarray([mfcc.num_frames(waves[k].shape[0]) for k in part])
        feats = _cmn(mfcc(_batched_waves(waves, part, device)),  # [B, T, 13]
                     torch.from_numpy(nf_h).to(device))
        res = (compute_deltas(feats) if deltas else feats).cpu().numpy()
        for i, k in enumerate(part):
            out[k] = res[i, : nf_h[i]].astype(np.float32)
    return out
