"""Energy-based voice activity detection (counterpart of
old_kaldi_git_tpu/ivector/vad.py; reference
src/ivector/voice-activity-detection.{h,cc} ComputeVadEnergy, the compute-vad
tool).

A frame is voiced when its log energy (feature column 0, the C0 / energy
coefficient) exceeds vad_energy_threshold + vad_energy_mean_scale ·
mean(log energy) and, with vad_frames_context > 0, when at least
vad_proportion_threshold of the 2·context+1 frames around it pass the same
test.  Batched [B, T] with a validity mask; the context vote is a box
filter.
"""

from __future__ import annotations

import torch

from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass


@options_dataclass
class VadOptions:
    vad_energy_threshold: float = 5.0
    vad_energy_mean_scale: float = 0.5
    vad_frames_context: int = 0
    vad_proportion_threshold: float = 0.6


def compute_vad_energy(log_energy: torch.Tensor, opts: VadOptions = None,
                       num_frames=None) -> torch.Tensor:
    """[B, T] log energies (num_frames: [B] valid frames, None = all) →
    [B, T] float 0/1 voicing decisions, invalid frames 0."""
    opts = opts or VadOptions()
    log_energy = torch.as_tensor(log_energy, dtype=torch.float32)
    if log_energy.ndim == 1:
        log_energy = log_energy[None]
    B, T = log_energy.shape
    dev = log_energy.device
    if num_frames is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=dev)
    else:
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.as_tensor(num_frames, device=dev)[:, None]).to(torch.float32)
    denom = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    mean_e = (log_energy * mask).sum(dim=1, keepdim=True) / denom
    cutoff = opts.vad_energy_threshold + opts.vad_energy_mean_scale * mean_e
    raw = (log_energy > cutoff).to(torch.float32) * mask
    ctx = opts.vad_frames_context
    if ctx > 0:
        kernel = torch.ones((1, 1, 2 * ctx + 1), dtype=torch.float32, device=dev)
        votes = torch.nn.functional.conv1d(raw[:, None], kernel, padding=ctx)[:, 0]
        counts = torch.nn.functional.conv1d(mask[:, None], kernel, padding=ctx)[:, 0]
        raw = (votes >= opts.vad_proportion_threshold * counts.clamp(min=1.0)
               ).to(torch.float32) * mask
    return raw
