"""Long-recording segmentation and decode.

Counterpart of old_kaldi_git_tpu/recipes/segment.py (the reference's
steps/segmentation and steps/cleanup/segment_long_utterances.sh): split an
unbounded recording into decodable utterances.

  segment_by_vad        — energy-VAD islands (ivector/vad.compute_vad_energy
                          on the device) with the padding and merge rules on
                          the host: minimum silence gap, minimum and maximum
                          segment duration, boundary padding;
  decode_long_recording — segment, decode all segments as one batch through
                          recipes/decode.decode_dataset, and return each
                          segment's words with its absolute times.

An island longer than max_segment_sec is cut again at its lowest-energy
frame in its middle half, as the reference splits at the weakest point
rather than mid-phone.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.ivector.vad import VadOptions, compute_vad_energy
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("segment")


@options_dataclass
class SegmentationOptions:
    min_silence_sec: float = 0.3  # gaps shorter than this merge segments
    min_segment_sec: float = 0.3  # drop islands shorter than this
    max_segment_sec: float = 30.0  # cut longer islands at the weakest frame
    pad_sec: float = 0.1  # widen each segment boundary
    frame_shift: float = 0.01


def segment_by_vad(log_energy: np.ndarray, vad_opts: Optional[VadOptions] = None,
                   opts: Optional[SegmentationOptions] = None,
                   device: DeviceLike = None) -> List[Tuple[float, float]]:
    """[(start_sec, end_sec)] speech segments from frame log energies [T];
    the voicing decisions on `device` (default the card)."""
    opts = opts or SegmentationOptions()
    vad_opts = vad_opts or VadOptions(vad_frames_context=2)
    fs = opts.frame_shift
    energy = torch.as_tensor(np.asarray(log_energy, np.float32)).to(resolve_device(device))
    voiced = compute_vad_energy(energy[None], vad_opts)[0].cpu().numpy() > 0.5
    T = len(voiced)
    # islands of voiced frames
    segs: List[Tuple[int, int]] = []
    t = 0
    while t < T:
        if not voiced[t]:
            t += 1
            continue
        s = t
        while t < T and voiced[t]:
            t += 1
        segs.append((s, t))
    # merge across short silences
    min_gap = int(opts.min_silence_sec / fs)
    merged: List[Tuple[int, int]] = []
    for s, e in segs:
        if merged and s - merged[-1][1] < min_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    # drop the too short, cut the too long at the lowest-energy frame
    min_len = int(opts.min_segment_sec / fs)
    max_len = int(opts.max_segment_sec / fs)
    out: List[Tuple[int, int]] = []
    stack = [se for se in merged if se[1] - se[0] >= min_len]
    while stack:
        s, e = stack.pop(0)
        if e - s <= max_len:
            out.append((s, e))
            continue
        lo = s + (e - s) // 4
        hi = e - (e - s) // 4
        cut = lo + int(np.argmin(log_energy[lo:hi]))
        stack[:0] = [(s, cut), (cut, e)]
    out.sort()
    pad = int(opts.pad_sec / fs)
    return [(max(0, s - pad) * fs, min(T, e + pad) * fs) for s, e in out]


def frame_log_energy(wave: np.ndarray, samp_freq: float, frame_shift: float = 0.01,
                     window_sec: float = 0.025) -> np.ndarray:
    """Per-frame log power of a wave (25 ms windows every frame_shift)."""
    shift = int(samp_freq * frame_shift)
    win = int(samp_freq * window_sec)
    n = max(0, (len(wave) - win) // shift + 1)
    e = np.asarray([np.sum(wave[t * shift: t * shift + win] ** 2.0) for t in range(n)])
    return np.log(np.maximum(e, 1e-10))


def decode_long_recording(
    model,
    graph: CsrGraph,
    lang,
    wave: np.ndarray,
    samp_freq: float,
    feats_fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]],
    energy_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    seg_opts: Optional[SegmentationOptions] = None,
    decode_opts=None,
) -> List[Tuple[float, float, List[str]]]:
    """Segment a long recording and decode the pieces as ONE batch on the
    model's device.

    feats_fn: {utt: wave} → {utt: feats [T, D]} (the recipe's front end);
    energy_fn: wave → per-frame log energy (default `frame_log_energy`).
    Returns [(start_sec, end_sec, words)]."""
    from old_kaldi_git_tpu_torch.recipes.decode import DecodeOptions, decode_dataset

    seg_opts = seg_opts or SegmentationOptions()
    if energy_fn is None:
        def energy_fn(w):
            return frame_log_energy(w, samp_freq, seg_opts.frame_shift)
    segments = segment_by_vad(energy_fn(wave), opts=seg_opts, device=model.am.device)
    if not segments:
        return []
    waves = {f"seg{i:04d}": wave[int(s * samp_freq): int(e * samp_freq)]
             for i, (s, e) in enumerate(segments)}
    hyps = decode_dataset(model, graph, lang, feats_fn(waves),
                          decode_opts or DecodeOptions())
    log.info("decode_long_recording: %d segments over %.1fs", len(segments),
             len(wave) / samp_freq)
    return [(s, e, hyps.get(f"seg{i:04d}", [])) for i, (s, e) in enumerate(segments)]
