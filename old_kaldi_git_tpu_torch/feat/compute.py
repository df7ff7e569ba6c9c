"""Offline feature computers: MFCC.

Counterpart of old_kaldi_git_tpu/feat/compute.py (reference
src/feat/feature-mfcc.h and feature-common.h OfflineFeatureTpl).  Array-first:
the computer maps [B, num_samples] → [B, T, D].

The spectrum path (DFT → power → mel → log → liftered DCT) runs through the
fused kernel of old_kaldi_git_tpu_torch.ops.mfcc_kernel; the column c0 is then
overwritten with the raw log energy.  `compute_utterance_feats` is the
recipes' batched front end (MFCC, per-utterance CMN, optional deltas).
Fbank, spectrogram and PLP are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.feat.mel import MelBanksOptions
from old_kaldi_git_tpu_torch.feat.window import (
    FrameExtractionOptions,
    extract_frames,
    num_frames,
)
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

FEAT_CHUNK = 128  # utterances per front-end batch


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
    are built once per device at first use."""

    def __init__(self, opts: Optional[MfccOptions] = None):
        self.opts = opts or MfccOptions()
        self.frame_opts: FrameExtractionOptions = self.opts.frame_opts
        self._weights = {}

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_opts)

    def weights(self, device: torch.device):
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import make_mfcc_weights

        key = str(device)
        if key not in self._weights:
            self._weights[key] = make_mfcc_weights(self.opts, device=device)
        return self._weights[key]

    def __call__(self, wave: torch.Tensor, *,
                 dither_generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """[..., num_samples] → [..., T, num_ceps].  T from the padded length;
        use num_frames(actual_samples) to mask."""
        frames, log_energy = extract_frames(
            wave, self.frame_opts, dither_generator=dither_generator)
        return self._compute(frames, log_energy)

    def _compute(self, frames: torch.Tensor, log_energy: torch.Tensor
                 ) -> torch.Tensor:
        from old_kaldi_git_tpu_torch.ops.mfcc_kernel import fused_mfcc_from_frames

        o = self.opts
        lead = frames.shape[:-1]
        flat = frames.reshape(-1, frames.shape[-1]).contiguous()
        ceps = fused_mfcc_from_frames(
            flat, self.weights(frames.device)).reshape(*lead, o.num_ceps)
        if o.use_energy:
            if o.energy_floor > 0.0:
                log_energy = torch.clamp(log_energy, min=math.log(o.energy_floor))
            ceps[..., 0] = log_energy  # in place: ceps is this call's own buffer
        return ceps


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
        mlen = max(waves[k].shape[0] for k in part)
        batch = np.zeros((len(part), mlen), np.float32)
        for i, k in enumerate(part):
            batch[i, : waves[k].shape[0]] = waves[k]
        nf_h = np.asarray([mfcc.num_frames(waves[k].shape[0]) for k in part])
        feats = mfcc(torch.from_numpy(batch).to(device))  # [B, T, 13]
        T = feats.shape[1]
        nf = torch.from_numpy(nf_h).to(device)
        t_idx = torch.arange(T, device=device)[None, :]
        idx = torch.minimum(t_idx, (nf - 1).clamp(min=0)[:, None])
        feats = feats.gather(1, idx[:, :, None].expand(-1, -1, feats.shape[2]))
        mask = (t_idx < nf[:, None]).to(feats.dtype)
        mean = (feats * mask[:, :, None]).sum(1) / nf.clamp(min=1)[:, None]
        feats = feats - mean[:, None, :]
        res = (compute_deltas(feats) if deltas else feats).cpu().numpy()
        for i, k in enumerate(part):
            out[k] = res[i, : nf_h[i]].astype(np.float32)
    return out
