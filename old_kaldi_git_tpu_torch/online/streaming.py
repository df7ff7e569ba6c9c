"""Streaming feature extraction and token-sparse streaming decoding.

Counterpart of old_kaldi_git_tpu/online/streaming.py (reference src/online2
and src/feat/online-feature.h):

  OnlineFeaturePipeline   ~ OnlineNnet2FeaturePipeline: accept_waveform()
                            buffers samples and returns feature frames as
                            soon as they are final (MFCC through the fused
                            kernel, a causal mean, deltas with a ±4 frame
                            hold-back, optionally online iVectors appended).
  StreamingTokenDecoder   ~ SingleUtteranceNnet3Decoder over
                            LatticeFasterOnlineDecoder::AdvanceDecoding: the
                            acoustic model over a fixed window with its
                            receptive-field context, then the token-sparse
                            search (decoder/viterbi._decode_scan_tokens, the
                            loglike gather kernel once a search frame) with
                            the [1, K] token set carried across chunks and
                            the backpointers written in place into
                            preallocated device buffers; best path and
                            endpointing on request.
  StreamingDecoder        ~ the same over a dense [1, S] beam state
                            (decoder/viterbi._decode_scan_impl: every arc
                            relaxed each frame), for graphs of up to some
                            10^5 states.
  EndpointRule            ~ online-endpoint.h OnlineEndpointRule.

The JAX package runs each chunk as one jitted program; here it is a plain
sequence of calls on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph, build_tile_graph
from old_kaldi_git_tpu_torch.decoder.viterbi import (
    BIG, ViterbiOptions, _backtrace_scan, _decode_scan_impl, _decode_scan_tokens,
    _dense_graph_arrays, _eps_hop_table, _start_alpha, _token_budget, _top_tokens,
    split_words_for_arc_seq, start_closure)
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.feat import Mfcc, MfccOptions, compute_deltas
from old_kaldi_git_tpu_torch.utils.log import KaldiError


class OnlineFeaturePipeline:
    """Streaming MFCC with a causal mean, deltas and optional online
    iVectors, on `device` (the MFCC kernel's)."""

    def __init__(
        self,
        mfcc_opts: Optional[MfccOptions] = None,
        add_deltas: bool = True,
        cmn_window: int = 600,
        global_cmvn_stats: Optional[np.ndarray] = None,
        cmn_min_frames: int = 100,
        ivector_extractor=None,
        device: DeviceLike = None,
    ):
        """global_cmvn_stats [2, D+1] (feat.cmvn layout) primes the causal
        mean while fewer than cmn_min_frames have been seen (reference
        OnlineCmvn global-stats smoothing).

        ivector_extractor: an ivector.extractor.OnlineIvectorExtractor fed
        the pipeline's own output frames; each frame comes back with its
        online iVector appended, held back until its iVector period is
        complete (at most period−1 frames), so for any chunking the appended
        iVectors equal extract_online_ivectors over the whole stream."""
        self.device = resolve_device(device)
        self.mfcc = Mfcc(mfcc_opts or MfccOptions())
        self.add_deltas = add_deltas
        self.cmn_window = cmn_window
        self.cmn_min_frames = cmn_min_frames
        self._iv = ivector_extractor
        self._iv_pending: Optional[np.ndarray] = None  # frames awaiting iVectors
        if global_cmvn_stats is not None:
            st = np.asarray(global_cmvn_stats, np.float64)
            self.global_mean = st[0, :-1] / max(st[0, -1], 1e-10)
        else:
            self.global_mean = None
        self.delta_ctx = 4 if add_deltas else 0  # ±(order·window) look-ahead
        self._samples = np.zeros(0, np.float32)
        self._raw_frames: Optional[np.ndarray] = None  # [n, 13] raw cepstra
        self._emitted = 0
        self.finished = False

    def accept_waveform(self, samples: np.ndarray) -> np.ndarray:
        """Returns the newly final output frames [n_new, output_dim]."""
        self._samples = np.concatenate([self._samples, np.asarray(samples, np.float32)])
        return self._advance()

    def input_finished(self) -> np.ndarray:
        self.finished = True
        return self._advance()

    def _advance(self) -> np.ndarray:
        n_ready = self.mfcc.num_frames(len(self._samples))
        have = 0 if self._raw_frames is None else len(self._raw_frames)
        if n_ready > have:
            # the whole buffer again, as the JAX package does (window
            # positions are absolute, so earlier frames come out the same)
            self._raw_frames = self.mfcc(
                torch.from_numpy(self._samples).to(self.device)).cpu().numpy()
        total = 0 if self._raw_frames is None else len(self._raw_frames)
        # a frame is final once its delta look-ahead exists (or input ended)
        final_until = total if self.finished else max(0, total - self.delta_ctx)
        if final_until <= self._emitted:
            out = np.zeros((0, self.base_dim), np.float32)
        else:
            out = self._process(self._raw_frames, self._emitted, final_until)
            self._emitted = final_until
        if self._iv is None:
            return out
        return self._append_ivectors(out)

    def _append_ivectors(self, out_new: np.ndarray) -> np.ndarray:
        """Feed the newly final frames to the online extractor (each frame
        once; it buffers partial periods), queue the frames whose iVector is
        not final yet, and return [n, base_dim + R] for those whose period
        completed."""
        ivs = self._iv.accept(out_new)
        if self.finished:
            tail = self._iv.input_finished()
            ivs = np.concatenate([ivs, tail]) if ivs.size else tail
        queue = out_new
        if self._iv_pending is not None and self._iv_pending.size:
            queue = (np.concatenate([self._iv_pending, out_new])
                     if out_new.size else self._iv_pending)
        n = len(ivs)  # never more than len(queue): iVectors come back in order
        ready, self._iv_pending = queue[:n], queue[n:]
        if n == 0:
            return np.zeros((0, self.output_dim), np.float32)
        return np.concatenate([ready, ivs], axis=1).astype(np.float32)

    @property
    def base_dim(self) -> int:
        return self.mfcc.opts.num_ceps * (3 if self.add_deltas else 1)

    @property
    def output_dim(self) -> int:
        return self.base_dim + (self._iv.ivector_dim if self._iv else 0)

    def _causal_mean(self, raw: np.ndarray, t: int) -> np.ndarray:
        """Mean over up to cmn_window frames ending at t, padded with the
        global mean while fewer than cmn_min_frames are available."""
        lo = max(0, t + 1 - self.cmn_window)
        count = t + 1 - lo
        s = raw[lo: t + 1].sum(axis=0)
        if self.global_mean is not None and count < self.cmn_min_frames:
            s = s + (self.cmn_min_frames - count) * self.global_mean
            count = self.cmn_min_frames
        return s / count

    def _process(self, raw: np.ndarray, start: int, end: int) -> np.ndarray:
        """Causal mean normalisation and deltas of frames [start, end)."""
        if not self.add_deltas:
            rows = [raw[t] - self._causal_mean(raw, t) for t in range(start, end)]
            return np.stack(rows).astype(np.float32)
        # the deltas' context is normalised causally too; at the stream's
        # edges the regression replicates frames as the batch path does
        ctx_lo = max(0, start - self.delta_ctx)
        ctx_hi = min(len(raw), end + self.delta_ctx)
        ctx = np.stack([raw[t] - self._causal_mean(raw, t)
                        for t in range(ctx_lo, ctx_hi)])
        deltas = compute_deltas(torch.from_numpy(ctx[None]).to(self.device))[0]
        return deltas[start - ctx_lo: end - ctx_lo].cpu().numpy().astype(np.float32)


@dataclasses.dataclass
class EndpointRule:
    """Reference OnlineEndpointRule."""

    must_contain_nonsilence: bool = True
    min_trailing_silence: float = 1.0  # seconds
    min_utterance_length: float = 0.0

    def triggered(self, utt_sec: float, trailing_sil_sec: float,
                  said_something: bool) -> bool:
        if self.must_contain_nonsilence and not said_something:
            return False
        return (trailing_sil_sec >= self.min_trailing_silence
                and utt_sec >= self.min_utterance_length)


def default_endpoint_rules() -> List[EndpointRule]:
    """Reference default rules 1, 2 and 5 (a simplified set)."""
    return [
        EndpointRule(False, 5.0, 0.0),  # long silence, nothing said
        EndpointRule(True, 1.0, 0.0),  # said something, then 1 s of silence
        EndpointRule(True, 0.0, 20.0),  # a hard cap on the utterance length
    ]


class StreamingTokenDecoder:
    """Streaming decode over large graphs: the token-sparse search run chunk
    by chunk with the [1, K] token set carried across chunks, so the work a
    frame does not depend on the graph's size.  Feed final feature frames
    with advance(); read best_words() / endpoint_detected().

    am_loglikes_fn maps a [1, W, D] feature window (a tensor on `device`) to
    [1, W/fsf, P] loglikes there (AmNnet.loglikes_batch, or AmNnet.logits
    with output_stride=fsf for a chain model)."""

    def __init__(
        self,
        graph: CsrGraph,
        am_loglikes_fn: Callable[[torch.Tensor], torch.Tensor],
        silence_phones: Sequence[int],
        tid_to_phone: np.ndarray,
        opts: Optional[ViterbiOptions] = None,
        frame_shift: float = 0.01,
        am_left_context: int = 0,
        am_right_context: int = 0,
        endpoint_rules: Optional[List[EndpointRule]] = None,
        max_frames: int = 6000,
        chunk_quantum: int = 32,
        frame_subsampling_factor: int = 1,
        device: DeviceLike = None,
    ):
        """frame_subsampling_factor > 1 streams a chain model: features come
        at the input rate, the acoustic model subsamples, and the search
        advances one graph frame for every fsf input frames.  Split-eps
        graphs stream as they decode in a batch: the start state's eps
        closure seeds the token set and the hop merge runs after every
        frame, so streaming equals the batch decode."""
        self.graph = graph
        self.am = am_loglikes_fn
        self.opts = opts or ViterbiOptions()
        self.device = resolve_device(device)
        self.silence_phones = set(int(p) for p in silence_phones)
        self.tid_to_phone = tid_to_phone
        self.fsf = int(frame_subsampling_factor)
        if self.fsf < 1:
            raise KaldiError("frame_subsampling_factor must be >= 1")
        if chunk_quantum % self.fsf:
            raise KaldiError("chunk_quantum must be a multiple of "
                             "frame_subsampling_factor (chunks advance whole "
                             "subsampled frames)")
        # endpointing counts input seconds; a search frame covers fsf frames
        self.frame_shift = frame_shift * self.fsf
        # the left context rounded up to the subsample grid, so that the
        # window's stride phase is the batch evaluation's
        self.lctx = -(-am_left_context // self.fsf) * self.fsf
        self.rctx = am_right_context
        self.rules = endpoint_rules or default_endpoint_rules()
        self.K = max(4, min(self.opts.max_active, graph.num_states))
        self.max_frames = max_frames
        self.chunk_quantum = chunk_quantum
        self._fw = np.where(np.isfinite(graph.final_weight), graph.final_weight, BIG)
        self._init_search()
        # a fixed window length: a multiple of 16·fsf keeps the subsample
        # grid aligned
        self.window_frames = (-(-(self.lctx + chunk_quantum + self.rctx)
                                // (16 * self.fsf)) * 16 * self.fsf)
        self.reset()

    def _init_search(self) -> None:
        """The graph's tile layout and, on a split-eps graph, its hop table
        and the start state's eps closure, on the device."""
        graph = self.graph
        self._tg = build_tile_graph(graph)
        self.E = _token_budget(graph, self.K, self._tg.md)  # the tile budget ET
        self._tile_ptr, self._tiles, self._frm = self._tg.device_arrays(self.device)
        self._eps_hops, self._D = None, 0
        self._seeds = [(graph.start, 0.0)]
        if graph.eps_ns is not None:
            self._eps_hops, self._D = _eps_hop_table(graph, self.device)
            self._seeds = start_closure(graph, self._D)

    def reset(self) -> None:
        self._feat_buf = np.zeros((0, 0), np.float32)
        self._frames_decoded = 0
        rows = -(-self.max_frames // self.fsf)
        self._bps_buf = torch.full((rows, 1, self.K), -1, dtype=torch.int32,
                                   device=self.device)
        self._bpa_buf = torch.full((rows, 1, self.K), -1, dtype=torch.int32,
                                   device=self.device)
        self._reset_search()

    def _reset_search(self) -> None:
        ts0 = np.full((1, self.K), -1, np.int32)
        tc0 = np.full((1, self.K), BIG, np.float32)
        for i, (s_i, c_i) in enumerate(self._seeds[: self.K]):
            ts0[:, i] = s_i
            tc0[:, i] = c_i
        self._tok_state = torch.from_numpy(ts0).to(self.device)
        self._tok_cost = torch.from_numpy(tc0).to(self.device)

    def _window_loglikes(self, window: np.ndarray, t_off: int) -> torch.Tensor:
        """The acoustic model over the [1, W, D] window; the chunk's search
        frames [1, chunk/fsf, P] as a view of its output."""
        qs = self.chunk_quantum // self.fsf  # search frames a chunk
        x = torch.from_numpy(np.ascontiguousarray(window[None])).to(self.device)
        ll = self.am(x)[0]  # [W/fsf, P]
        return ll[t_off: t_off + qs][None]

    def _chunk(self, window: np.ndarray, t_off: int, n_valid: int, t0: int) -> None:
        """One chunk: the chunk's search frames read in place from the
        acoustic model's output, the token-sparse search from the carried
        tokens, backpointers into rows t0.. of the buffers."""
        ll_new = self._window_loglikes(window, t_off)
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=self.device)
        self._tok_state, self._tok_cost, _, _, _ = _decode_scan_tokens(
            self._tile_ptr, self._tiles, self.graph.start, ll_new, nv,
            float(self.opts.acoustic_scale), float(self.opts.beam), self.K, self.E,
            self.graph.num_states, 0, 0.0, (self._tok_state, self._tok_cost),
            self._eps_hops, self._D, bp_out=(self._bps_buf, self._bpa_buf, t0))

    def advance(self, new_feats: np.ndarray, final: bool = False) -> None:
        """Feed newly final feature frames.  The last am_right_context frames
        are held back until more arrive (or final=True), so every decoded
        frame's loglikes saw their full right context."""
        if new_feats.size != 0:
            self._feat_buf = (new_feats.copy() if self._feat_buf.size == 0
                              else np.concatenate([self._feat_buf, new_feats]))
        avail = len(self._feat_buf) if self._feat_buf.size else 0
        total = avail if final else max(self._frames_decoded, avail - self.rctx)
        if not final:
            # mid-stream only whole subsampled frames advance, so the
            # window's stride phase stays the batch path's
            total = (self._frames_decoded
                     + ((total - self._frames_decoded) // self.fsf) * self.fsf)
        n_new = total - self._frames_decoded
        if n_new <= 0:
            return
        q = self.chunk_quantum
        if total + q > self.max_frames:
            raise ValueError(f"stream + chunk padding exceeds max_frames="
                             f"{self.max_frames}; raise it or endpoint/reset")
        while n_new > 0:
            take = min(q, n_new)
            fd = self._frames_decoded
            lo = max(0, fd - self.lctx)
            window = self._feat_buf[lo:avail]
            # a fixed-length window, edge-replicated: the clipped splice's
            # edge semantics, so the kept frames' outputs are the batch
            # path's
            if len(window) < self.window_frames:
                window = np.pad(window, ((0, self.window_frames - len(window)),
                                         (0, 0)), mode="edge")
            else:
                window = window[: self.window_frames]
            self._chunk(window, (fd - lo) // self.fsf, -(-take // self.fsf),
                        fd // self.fsf)
            self._frames_decoded = fd + take
            n_new -= take

    def _backtrace(self) -> Tuple[List[int], List[int]]:
        """(words, tids) of the current best path; the backtrace runs on the
        device and only the path's arc ids come to the host."""
        if self._frames_decoded == 0:
            return [], []
        nf_s = -(-self._frames_decoded // self.fsf)  # search frames
        tok_state, tok_cost = self._final_tokens()
        cb = np.where(tok_state >= 0, tok_cost, BIG)
        total = cb + self._fw[np.maximum(tok_state, 0)]
        use_final = bool(total.min() < BIG)
        if not use_final:
            total = cb
        slot = int(np.argmin(total))
        state = int(tok_state[slot])
        if state < 0:
            return [], []
        arcs = _backtrace_scan(
            self._bps_buf, self._bpa_buf, self._frm,
            torch.full((1,), state, dtype=torch.int32, device=self.device),
            torch.full((1,), nf_s, dtype=torch.int32, device=self.device),
        )[:nf_s, 0].cpu().numpy()
        if (arcs < 0).any():
            return [], []
        arcs = self._graph_arcs(arcs)
        if self.graph.eps_ns is not None:
            words = split_words_for_arc_seq(self.graph, arcs, state)
            if words is None:
                return [], []
        else:
            words = []
            for a in arcs:
                words.extend(self.graph.arc_olabels[a])
        if use_final:
            words = words + list(self.graph.final_olabels[state])
        return words, [int(self.graph.tid[a]) for a in arcs]

    def _final_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        """The carried [K] token states (−1 = empty) and costs, on the host."""
        return self._tok_state[0].cpu().numpy(), self._tok_cost[0].cpu().numpy()

    def _graph_arcs(self, arcs: np.ndarray) -> np.ndarray:
        """Backpointer arc ids → graph arc ids (padded tile slots here)."""
        return self._tg.pad2orig[arcs]

    def best_words(self) -> List[int]:
        return self._backtrace()[0]

    def trailing_silence_frames(self) -> int:
        _, tids = self._backtrace()
        n = 0
        for tid in reversed(tids):
            if int(self.tid_to_phone[tid]) not in self.silence_phones:
                break
            n += 1
        return n

    def endpoint_detected(self) -> bool:
        words, _ = self._backtrace()
        utt_sec = self._frames_decoded * self.frame_shift
        sil_sec = self.trailing_silence_frames() * self.frame_shift
        return any(r.triggered(utt_sec, sil_sec, len(words) > 0) for r in self.rules)


class StreamingDecoder(StreamingTokenDecoder):
    """Streaming decode with a dense beam state (the JAX package's
    StreamingDecoder): the [1, S] cost vector carried across chunks and
    every arc of the graph relaxed each frame (decoder/viterbi.py
    `_decode_scan_impl`, K = min(max_active, S) kept states a frame), so
    it suits graphs up to some 10^5 states; StreamingTokenDecoder is the
    large-graph decoder.  The acoustic window, the held-back right context,
    the in-place backpointers, best path and endpointing are
    StreamingTokenDecoder's; the best path's words include the final
    state's output labels, as the batch decode's do.  Folded graphs only."""

    def _init_search(self) -> None:
        if self.graph.eps_ns is not None:
            raise NotImplementedError(
                "the dense StreamingDecoder takes folded graphs; split-eps "
                "graphs stream through StreamingTokenDecoder")
        self._frm, self._pdf, self._w, self._ns, _ = _dense_graph_arrays(
            self.graph, self.device)

    def _reset_search(self) -> None:
        self._alpha = _start_alpha(1, self.graph.num_states, self.graph.start,
                                   self.device)

    def _chunk(self, window: np.ndarray, t_off: int, n_valid: int, t0: int) -> None:
        """One chunk: the dense scan from the carried [1, S] costs over the
        chunk's search frames, backpointers into rows t0.. of the buffers."""
        ll_new = self._window_loglikes(window, t_off)
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=self.device)
        self._alpha = _decode_scan_impl(
            self._frm, self._pdf, self._w, self._ns, self._alpha, ll_new, nv,
            float(self.opts.acoustic_scale), float(self.opts.beam), self.K,
            self.graph.num_states, (self._bps_buf, self._bpa_buf, None), t0)

    def _final_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        """The K best states of the carried costs, as lax.top_k gives them."""
        state, cost = _top_tokens(self._alpha, self.K)
        return state[0].to(torch.int32).cpu().numpy(), cost[0].cpu().numpy()

    def _graph_arcs(self, arcs: np.ndarray) -> np.ndarray:
        return arcs
