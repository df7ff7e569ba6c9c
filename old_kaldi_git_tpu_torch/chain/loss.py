"""LF-MMI objective: the denominator and numerator forward recursions.

Counterpart of old_kaldi_git_tpu/chain/loss.py (reference
src/chain/{chain-denominator,chain-numerator,chain-training}.{h,cc,cu}):
the denominator alpha recursion over the den graph in linear-space float32
with the leaky-HMM term and a renormalisation each frame, the
tolerance-lattice numerator in log space, objective = (num − den) / frames
with the output l2 term.  The gradient is autograd's, as the JAX package
takes jax.grad of its scans: d(log Z)/d(logit) is the occupancy.

Two forms of the denominator, one recursion: dense (S ≤ DENSE_STATE_LIMIT,
one [S, S] product a frame) and sparse (an arc list, O(A) a frame: alpha
gathered at the arcs' sources, scaled, summed into their destinations).
The sparse form's step is one linear map over the arcs (`SparseMap`: each
state's incoming arcs summed in a fixed order, where the JAX package gathers
and takes a segment_sum over arcs sorted by destination; its backward the
transposed map), the emissions a gather whose backward is such a map too,
and the numerator takes its token scores by a product with a one-hot
matrix, so no step adds with atomics: the objective and its gradient repeat
bit for bit on the card.  Nothing in the objective waits on the host, so it
can be captured in a CUDA graph (recipes/chain.py).  NEG_INF is a finite
−1e30, as in the JAX package: torch's logaddexp has a NaN gradient at −inf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.chain.den_graph import DenominatorGraph
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

NEG_INF = -1e30
PROB_FLOOR = 1e-30  # floor of a linear-space normaliser before its log

# Above this many den-graph states the dense [S, S] transition matrix is not
# worth its memory and the arc-list form takes over (the JAX package's rule)
DENSE_STATE_LIMIT = 4096


@options_dataclass
class ChainLossOptions:
    leaky_hmm_coefficient: float = 0.1
    l2_regularize: float = 5e-5
    xent_regularize: float = 0.1


# ---------------------------------------------------------------------------
# sparse linear maps with a fixed order of adds
# ---------------------------------------------------------------------------

class _PaddedSum:
    """y[..., r] = Σ v·x[..., c] over the terms (r, c, v) of a sparse matrix,
    along the last dimension: x [..., N_in] → y [..., N_out], each row's
    terms added in one fixed order.

    Each row's terms are padded to a width with terms of weight 0 on a zero
    column: one gather of the [rows, width] inputs along the last dimension
    (contiguous, as the [B, S] alphas lie), a product with the weights and
    a sum over the width.  One width, the largest count, when that pads the
    terms at most PAD_LIMIT-fold (a den graph's in-degrees: 108,418 arcs, at
    most 38 into a state); otherwise the rows are grouped into buckets of
    widths 1, 2, 4, … and put back in order by one more gather.  Gathers,
    products, sums and concatenations: nothing adds with atomics and nothing
    waits on the host, so the result repeats bit for bit and can be captured
    in a CUDA graph.  Built on the host once."""

    PAD_LIMIT = 8

    def __init__(self, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                 num_out: int, num_in: int, device: torch.device):
        rows = np.asarray(rows, np.int64)
        counts = np.bincount(rows, minlength=num_out)
        order = np.argsort(rows, kind="stable")  # terms grouped by row
        starts = np.concatenate([[0], np.cumsum(counts)])
        cols = np.append(np.asarray(cols, np.int64)[order], num_in)  # + the zero row
        weights = np.append(np.asarray(weights, np.float32)[order], np.float32(0))
        widest = int(counts.max(initial=1))
        if num_out * widest <= self.PAD_LIMIT * max(len(rows), 1):
            groups = [(np.arange(num_out), widest)]
        else:
            groups, width = [], 1
            while width // 2 < widest:
                rs = np.nonzero((counts > width // 2) & (counts <= width))[0]
                if len(rs):
                    groups.append((rs, width))
                width *= 2
        self.buckets = []  # (input columns [n * width], weights [n, width], n, width)
        for rs, width in groups:
            k = np.arange(width)[None, :]
            at = np.where(k < counts[rs][:, None], starts[rs][:, None] + k, len(cols) - 1)
            self.buckets.append((torch.from_numpy(cols[at].reshape(-1)).to(device),
                                 torch.from_numpy(weights[at]).to(device), len(rs), width))
        self.row_map = None  # one bucket holds every row, in order
        if len(groups) > 1 or len(groups[0][0]) != num_out:
            grouped = np.concatenate([rs for rs, _ in groups])
            row_pos = np.full(num_out, len(grouped), np.int64)
            row_pos[grouped] = np.arange(len(grouped))
            self.row_map = torch.from_numpy(row_pos).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        zero = x2.new_zeros((x2.shape[0], 1))
        xz = torch.cat([x2, zero], dim=1)
        parts = [(xz.index_select(1, c).view(-1, n, width) * w.to(x.dtype)).sum(-1)
                 for c, w, n, width in self.buckets]
        if self.row_map is not None:  # rows without terms read the zero column
            parts = [torch.cat(parts + [zero], dim=1).index_select(1, self.row_map)]
        return parts[0].view(*lead, -1)


class SparseMap:
    """The linear map y[..., j] = Σ_{a: dst[a] = j} w[a]·x[..., src[a]] along
    the last dimension, and its transpose for the backward, both
    _PaddedSum; no tensor is kept for the backward (the map is linear)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_src: int,
                 num_dst: int, device: torch.device):
        self.forward = _PaddedSum(dst, src, w, num_dst, num_src, device)
        self.backward = _PaddedSum(src, dst, w, num_src, num_dst, device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _SparseMapFn.apply(x, self)


class _SparseMapFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sparse_map):
        ctx.sparse_map = sparse_map
        return sparse_map.forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sparse_map.backward(g), None


def gather_map(idx: np.ndarray, num_src: int, device: torch.device) -> SparseMap:
    """y[..., j] = x[..., idx[j]] as a SparseMap: a gather whose backward
    sums each source column's gradients in a fixed order."""
    idx = np.asarray(idx, np.int64)
    return SparseMap(idx, np.arange(len(idx)), np.ones(len(idx), np.float32), num_src,
                     len(idx), device)


# ---------------------------------------------------------------------------
# the denominator
# ---------------------------------------------------------------------------

class DenArrays:
    """A den graph's arrays on one device: the state → pdf gather, the
    initial (linear) and final (log) probabilities, and the transitions: for
    the sparse form a map over the arcs (their linear weights), for the
    dense form the [S, S] matrix."""

    def __init__(self, den: DenominatorGraph, device: torch.device, dense: bool):
        S = den.num_states
        state_pdf = np.zeros(S, np.int64)
        self_loops = den.from_state == den.to_state
        state_pdf[den.from_state[self_loops]] = den.pdf[self_loops]
        self.state_pdf = gather_map(state_pdf, den.num_pdfs, device)
        self.init_lin = torch.exp(torch.from_numpy(den.initial_log_probs)).to(device)
        self.final = torch.from_numpy(den.final_log_probs).to(device)
        self.M = self.transition = None
        if dense:
            M = np.zeros((S, S), np.float32)
            np.add.at(M, (den.from_state, den.to_state), np.exp(den.log_prob))
            self.M = torch.from_numpy(M).to(device)
        else:
            self.transition = SparseMap(den.from_state, den.to_state,
                                        np.exp(den.log_prob).astype(np.float32), S, S,
                                        device)


def den_arrays(den: DenominatorGraph, device: torch.device, dense: bool) -> DenArrays:
    """The graph's DenArrays on `device`, made once and kept on the graph."""
    cache = den.__dict__.setdefault("_device_arrays", {})
    key = (str(device), dense)
    if key not in cache:
        cache[key] = DenArrays(den, device, dense)
    return cache[key]


def denominator_logprob(logits: torch.Tensor, num_frames: torch.Tensor,
                        den: DenominatorGraph, leaky_hmm_coefficient: float = 0.1,
                        dense_state_limit: int = None) -> torch.Tensor:
    """[B, T, P] chain logits → [B] log Z_den, dense up to
    `dense_state_limit` states (DENSE_STATE_LIMIT), sparse above."""
    limit = DENSE_STATE_LIMIT if dense_state_limit is None else dense_state_limit
    return _denominator(logits, num_frames, den, leaky_hmm_coefficient,
                        dense=den.num_states <= limit)


def _denominator(logits: torch.Tensor, num_frames: torch.Tensor, den: DenominatorGraph,
                 leaky: float, dense: bool) -> torch.Tensor:
    """The alpha recursion on [B, S] alphas.  Each frame's emissions are
    shifted for exp(): dense by the max over the graph's states, sparse by
    the max over all pdfs (an upper bound of it), as in the JAX package;
    the dense form's first normaliser has no floor, the sparse form's has."""
    B, T, P = logits.shape
    arrs = den_arrays(den, logits.device, dense)
    e_log = arrs.state_pdf(logits)  # [B, T, S], gathered once for all frames
    shift = (e_log if dense else logits).amax(dim=2)  # [B, T]
    e_lin = torch.exp(e_log - shift[..., None]).unbind(1)
    shift = shift.unbind(1)
    alpha = arrs.init_lin * e_lin[0]
    z0 = alpha.sum(1)
    if dense:
        alpha = alpha / z0[:, None]
        logz = torch.log(z0) + shift[0]
    else:
        alpha = alpha / torch.clamp(z0, min=PROB_FLOOR)[:, None]
        logz = torch.log(torch.clamp(z0, min=PROB_FLOOR)) + shift[0]
    active = torch.arange(T, device=logits.device)[None, :] < num_frames[:, None]  # [B, T]
    for t in range(1, T):
        ax = (alpha @ arrs.M if dense else arrs.transition(alpha)) * e_lin[t]
        if leaky > 0:
            ax = ax + leaky * ax.sum(1, keepdim=True) * arrs.init_lin
        z = ax.sum(1)
        new_alpha = ax / torch.clamp(z, min=PROB_FLOOR)[:, None]
        alpha = torch.where(active[:, t, None], new_alpha, alpha)
        logz = logz + torch.where(active[:, t], torch.log(torch.clamp(z, min=PROB_FLOOR))
                                  + shift[t], torch.zeros_like(z))
    final = torch.logsumexp(torch.log(torch.clamp(alpha, min=PROB_FLOOR)) + arrs.final, dim=1)
    return logz + final


# ---------------------------------------------------------------------------
# the numerator
# ---------------------------------------------------------------------------

def numerator_logprob(logits: torch.Tensor, pdf_seq: torch.Tensor, allowed: torch.Tensor,
                      num_frames: torch.Tensor, seq_len: torch.Tensor,
                      advance_lp: torch.Tensor = None, loop_lp: float = 0.0
                      ) -> torch.Tensor:
    """Tolerance-lattice forward: [B, T, P] logits, [B, L] pdfs, [B, T, L]
    allowed mask → [B] numerator log-prob.  advance_lp [B, L] and loop_lp
    carry the den graph's weights: staying costs loop_lp a frame, entering
    token l loop_lp + advance_lp[:, l] (token 0's advance_lp, the initial
    prob, is applied at frame 0 without loop_lp)."""
    B, T, P = logits.shape
    L = pdf_seq.shape[1]
    dev = logits.device
    if advance_lp is None:
        advance_lp = torch.zeros((B, L), dtype=logits.dtype, device=dev)
    # the token scores as a product with a one-hot [B, P, L]: exact (one term
    # of 1.0, the rest 0.0) and its backward a product too, without atomics
    onehot = torch.zeros((B, P, L), dtype=logits.dtype, device=dev)
    onehot.scatter_(1, pdf_seq.long()[:, None, :], 1.0)
    scores = torch.bmm(logits, onehot).permute(1, 0, 2).unbind(0)  # T × [B, L]
    allowed = allowed.permute(1, 0, 2)  # [T, B, L]
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=dev)
    first = torch.arange(L, device=dev)[None, :] == 0
    alpha = torch.where(first, scores[0] + torch.where(allowed[0], 0.0, neg)
                        + advance_lp[:, :1], neg)
    z0 = torch.logsumexp(alpha, dim=1, keepdim=True)
    alpha = alpha - z0
    logz = z0[:, 0]
    active = torch.arange(T, device=dev)[:, None] < num_frames[None, :]  # [T, B]
    pad = neg.expand(B, 1)
    for t in range(1, T):
        shifted = torch.cat([pad, alpha[:, :-1]], dim=1)
        new_alpha = torch.logaddexp(alpha + loop_lp, shifted + loop_lp + advance_lp) + scores[t]
        new_alpha = torch.where(allowed[t], new_alpha, neg)
        z = torch.logsumexp(new_alpha, dim=1, keepdim=True)
        z_safe = torch.clamp(z, min=NEG_INF / 2)
        alpha = torch.where(active[t][:, None], new_alpha - z_safe, alpha)
        logz = logz + torch.where(active[t], z_safe[:, 0], torch.zeros_like(logz))
    end = torch.gather(alpha, 1, (seq_len.long() - 1)[:, None])[:, 0]
    return logz + end


def chain_loss(logits: torch.Tensor, den: DenominatorGraph, pdf_seq: torch.Tensor,
               allowed: torch.Tensor, num_frames: torch.Tensor, seq_len: torch.Tensor,
               advance_lp: torch.Tensor = None, opts: ChainLossOptions = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-batch LF-MMI loss (the negated objective, per frame, plus the
    output l2 term) and its metrics."""
    opts = opts or ChainLossOptions()
    num = numerator_logprob(logits, pdf_seq, allowed, num_frames, seq_len, advance_lp,
                            float(den.loop_log_prob))
    den_lp = denominator_logprob(logits, num_frames, den, opts.leaky_hmm_coefficient)
    tot_frames = torch.clamp(num_frames.sum(), min=1).to(logits.dtype)
    objf = (num - den_lp).sum() / tot_frames
    frame_mask = (torch.arange(logits.shape[1], device=logits.device)[None, :]
                  < num_frames[:, None])[..., None]
    l2 = (logits * logits * frame_mask).sum() / tot_frames
    loss = -objf + 0.5 * opts.l2_regularize * l2
    return loss, {"objf": objf, "num": num.mean(), "den": den_lp.mean(), "l2": l2}
