"""Streaming ('looped') evaluation of nnet3-style acoustic models.

Counterpart of old_kaldi_git_tpu/models/streaming_am.py (reference
src/nnet3/nnet-compile-looped.cc, decodable-online-looped.cc): every layer
becomes a small streaming node.

- finite-context layers (tdnn, tdnnf, attention, conv, the prefinal layer
  and the output affine) keep a short history of their input and emit an
  output frame as soon as the frame's whole receptive field has arrived, so
  outputs are delayed by the layer's right context; edge frames are clamped
  as splice() clamps them, so chunked output equals whole-utterance output;
- lstmp and pgru layers carry their (c, r) state from chunk to chunk and
  run their input in pieces of QUANTUM frames (the rest flushed on final);
- blstmp is refused (a backward scan needs the future), and so is a layer
  with a Descriptor input (it reads nodes other than the previous layer).

The whole stack is StreamingAmNnet: feed feature frames, get loglike frames
back (delay: the sum of the layers' right contexts, and up to QUANTUM − 1
frames a recurrent layer mid-stream).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import layer_offsets


class _FiniteCtxStream:
    """A translation-invariant layer with left/right context (l, r) over
    [1, T, D] → [1, T, D']: buffers its input and emits the outputs whose
    receptive field is complete."""

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 lctx: int, rctx: int, device: torch.device):
        self.apply = apply_fn
        self.l = lctx
        self.r = rctx
        self.device = device
        self.hist: Optional[np.ndarray] = None  # retained input frames
        self.base = 0  # stream index of hist[0]
        self.n_emitted = 0

    def feed(self, frames: np.ndarray, final: bool = False) -> np.ndarray:
        if frames.size:
            self.hist = (frames.copy() if self.hist is None
                         else np.concatenate([self.hist, frames]))
        if self.hist is None:
            return np.zeros((0, 0), np.float32)
        total = self.base + len(self.hist)
        emit_upto = total if final else max(self.n_emitted, total - self.r)
        if emit_upto <= self.n_emitted:
            return np.zeros((0, 0), np.float32)
        # full left context (or the true stream start, where splice's clamp
        # is the whole-utterance behaviour) and full right context (the true
        # end when final)
        lo = max(0, self.n_emitted - self.l)
        hi = min(total, emit_upto - 1 + self.r) + 1
        x = self.hist[lo - self.base: hi - self.base]
        with torch.inference_mode():
            y = self.apply(torch.from_numpy(np.ascontiguousarray(x[None]))
                           .to(self.device))[0].cpu().numpy()
        out = y[self.n_emitted - lo: emit_upto - lo]
        self.n_emitted = emit_upto
        # keep only what later outputs still need
        keep_from = max(self.base, emit_upto - self.l)
        self.hist = self.hist[keep_from - self.base:]
        self.base = keep_from
        return out


class _LstmpStream:
    """A carried-state recurrent layer (lstmp, pgru): 1:1 frames, run in
    pieces of QUANTUM frames mid-stream; the remainder is flushed on final."""

    QUANTUM = 32
    r = 0  # right context: the carry sees no future frame

    def __init__(self, layer: torch.nn.Module, device: torch.device):
        self.layer = layer
        self.device = device
        cell = layer.cell
        self.carry = (torch.zeros((1, cell.cell_dim), device=device),
                      torch.zeros((1, cell.recurrent_dim), device=device))
        self.pending: Optional[np.ndarray] = None

    def feed(self, frames: np.ndarray, final: bool = False) -> np.ndarray:
        if frames.size:
            self.pending = (frames.copy() if self.pending is None
                            else np.concatenate([self.pending, frames]))
        if self.pending is None or not self.pending.size:
            return np.zeros((0, 0), np.float32)
        q = self.QUANTUM
        n_run = len(self.pending) if final else len(self.pending) // q * q
        if n_run == 0:
            return np.zeros((0, 0), np.float32)
        x = torch.from_numpy(np.ascontiguousarray(self.pending[None, :n_run])).to(self.device)
        with torch.inference_mode():
            y, self.carry = self.layer(x, initial_carry=self.carry, return_carry=True)
        self.pending = self.pending[n_run:]
        return y[0].cpu().numpy()


class StreamingAmNnet:
    """Feed features chunk by chunk, receive loglike frames (log-softmax
    minus log priors, as AmNnet.loglikes_batch), delayed by the model's
    total right context; equals loglikes_batch over the whole utterance."""

    def __init__(self, am: AmNnet):
        self.am = am
        cfg = am.config
        model = am.model
        dev = am.device
        self.streams: List[object] = []
        for i, spec in enumerate(cfg.layers):
            layer = getattr(model, f"{spec.kind}{i}")
            if spec.input_desc:
                raise ValueError(f"layer {i} ({spec.kind}) reads a Descriptor input "
                                 f"{spec.input_desc!r}: use whole-utterance evaluation")
            if spec.kind == "blstmp":
                raise ValueError("blstmp cannot stream (backward scan needs the future); "
                                 "use whole-utterance evaluation")
            if spec.kind in ("lstmp", "pgru"):
                self.streams.append(_LstmpStream(layer, dev))
                continue
            offs = layer_offsets(spec)
            self.streams.append(_FiniteCtxStream(
                layer, -min(0, min(offs)), max(0, max(offs)), dev))
        if cfg.final_hidden_dim:
            self.streams.append(_FiniteCtxStream(model.prefinal, 0, 0, dev))
        self.streams.append(_FiniteCtxStream(model.output, 0, 0, dev))

    @property
    def total_right_context(self) -> int:
        return sum(s.r for s in self.streams)

    def accept(self, feats: np.ndarray, final: bool = False) -> np.ndarray:
        """Feed [T, D] feature frames; returns the newly final loglike
        frames [T', num_pdfs]."""
        x = np.asarray(feats, np.float32)
        for s in self.streams:
            x = s.feed(x, final=final)
        if not x.size:
            return np.zeros((0, self.am.config.num_outputs), np.float32)
        logp = torch.log_softmax(torch.from_numpy(x).to(self.am.device), dim=-1)
        if self.am.log_priors is not None:
            logp = logp - self.am.log_priors
        return logp.cpu().numpy()
