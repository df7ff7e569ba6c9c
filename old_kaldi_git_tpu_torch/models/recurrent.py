"""Recurrent and attention acoustic-model layers, as nn.Modules.

Counterpart of old_kaldi_git_tpu/models/recurrent.py (reference
src/nnet3/nnet-combined-component.{h,cc} LstmNonlinearityComponent and the
GRU pieces, the xconfig `lstmp-layer` / `pgru-layer` wiring, and
nnet-attention-component.{h,cc} RestrictedAttentionComponent):

  LstmpLayer   LSTM with recurrent and non-recurrent projection;
  GruLayer     projected GRU, the same (c, r) carry as LstmpLayer;
  BlstmpLayer  a forward and a reverse LstmpLayer, concatenated;
  RestrictedAttentionLayer  multi-head self-attention over a fixed window
               of offsets around each frame.

The JAX package scans a cell over time with flax's `nn.scan`; here the
input's share of every gate is one product over all frames, and only the
recurrent share runs frame by frame (a loop of small launches: on the card
the recurrence is bound by the launch rate, not by its products).

The flax conventions kept, so that weights carry over
(`convert.torch_params_from_flax`):
  - LSTM gate pre-activations split in the order i, f, g, o;
  - the forget gate's bias of +1 is added at run time, not stored;
  - the cell is clipped to ±cell_clip (50);
  - the projections have no bias; y = W_p m holds [r; p], r its first
    recurrent_dim entries;
  - the GRU's reset gate has the recurrent width and multiplies r;
  - parameter names as flax's module names: `cell.gates`, `cell.proj`
    (LSTMP), `cell.update`, `cell.reset`, `cell.cand`, `cell.proj` (GRU),
    `forward.cell.*` / `backward.cell.*` (BLSTMP), `qkv` (attention); flax
    kernels are [in, out], nn.Linear weights their transpose.

None of these layers is natural-gradient instrumented (`ng_instrumented`
False): the reference preconditions its affine components, and its LSTM and
attention components carry their own update rules.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c [B, cell], r [B, recurrent])


def flax_dense_init_(linear: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    """flax Dense's defaults: lecun_normal kernel (a normal truncated at two
    standard deviations, scaled to variance 1/fan_in), zero bias."""
    fan_in = linear.weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's shrink
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if linear.bias is not None:
            linear.bias.zero_()


class LstmpCell(nn.Module):
    """One step: (c, r), x_t → (c', r'), y with y = [r'; p]."""

    def __init__(self, input_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int = 0, cell_clip: float = 50.0):
        super().__init__()
        self.input_dim, self.cell_dim = input_dim, cell_dim
        self.recurrent_dim, self.cell_clip = recurrent_dim, cell_clip
        self.gates = nn.Linear(input_dim + recurrent_dim, 4 * cell_dim)
        self.proj = nn.Linear(cell_dim, recurrent_dim + nonrecurrent_dim, bias=False)
        # the forget gate's +1, added to the input's share at run time
        forget_one = torch.zeros(4 * cell_dim)
        forget_one[cell_dim: 2 * cell_dim] = 1.0
        self.register_buffer("forget_one", forget_one, persistent=False)

    def recurrent_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W_r [rec, 4·cell], W_p [cell, rec + nonrec]) in the products'
        orientation, taken once a sequence."""
        return self.gates.weight[:, self.input_dim:].t(), self.proj.weight.t()

    def step(self, carry: Carry, x_gates: torch.Tensor,
             weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[Carry, torch.Tensor]:
        """One frame from input_gates' row x_t W_x + b (+1 on f)."""
        c, r = carry
        w_r, w_p = weights if weights is not None else self.recurrent_weights()
        i, f, g, o = torch.addmm(x_gates, r, w_r).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        c_new = torch.clamp(c_new, -self.cell_clip, self.cell_clip)
        y = (torch.sigmoid(o) * torch.tanh(c_new)) @ w_p
        return (c_new, y[..., : self.recurrent_dim]), y

    def forward(self, carry: Carry, x_t: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        return self.step(carry, self.input_gates(x_t))

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x W_x + b over any leading axes, the forget gate's +1 added."""
        return torch.nn.functional.linear(x, self.gates.weight[:, : self.input_dim],
                                          self.gates.bias + self.forget_one)


class LstmpLayer(nn.Module):
    """LSTM with projection over time: [B, T, D] → [B, T, rec + nonrec]."""

    ng_instrumented = False

    def __init__(self, input_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int = 0, cell_clip: float = 50.0,
                 reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.cell = LstmpCell(input_dim, cell_dim, recurrent_dim, nonrecurrent_dim,
                              cell_clip)

    def forward(self, x: torch.Tensor, initial_carry: Optional[Carry] = None,
                return_carry: bool = False):
        """initial_carry / return_carry: the streaming seam, the (c, r) state
        carried across chunks (reference nnet-compile-looped.cc); forward
        direction only."""
        B = x.shape[0]
        if self.reverse:
            if initial_carry is not None or return_carry:
                raise ValueError("carried state unsupported for reverse scan")
            x = x.flip(1)
        cell = self.cell
        carry = initial_carry if initial_carry is not None else (
            x.new_zeros((B, cell.cell_dim)), x.new_zeros((B, cell.recurrent_dim)))
        y, carry = _scan(cell, carry, cell.input_gates(x))
        if self.reverse:
            y = y.flip(1)
        return (y, carry) if return_carry else y


def _scan(cell, carry: Carry, xs: torch.Tensor):
    """Run cell.step over axis 1 of the input gates xs, the recurrent
    weights taken once → (outputs [B, T, rec + nonrec], final carry)."""
    weights = cell.recurrent_weights()
    ys = []
    for t in range(xs.shape[1]):
        carry, y = cell.step(carry, xs[:, t], weights)
        ys.append(y)
    y = (torch.stack(ys, dim=1) if ys
         else xs.new_zeros((xs.shape[0], 0, cell.proj.weight.shape[0])))
    return y, carry


class GruCell(nn.Module):
    """One projected-GRU step: carry (c, r), x_t → (c', r'), y.

      z = σ(W_z [x; r])            update gate [cell]
      g = σ(W_r [x; r])            reset gate [rec]
      h = tanh(W_h [x; g ⊙ r])     candidate [cell]
      c' = (1 − z) ⊙ h + z ⊙ c
      y = W_p c' (no bias), r' = y[:rec]
    """

    def __init__(self, input_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int = 0):
        super().__init__()
        self.input_dim, self.cell_dim = input_dim, cell_dim
        self.recurrent_dim = recurrent_dim
        self.update = nn.Linear(input_dim + recurrent_dim, cell_dim)
        self.reset = nn.Linear(input_dim + recurrent_dim, recurrent_dim)
        self.cand = nn.Linear(input_dim + recurrent_dim, cell_dim)
        self.proj = nn.Linear(cell_dim, recurrent_dim + nonrecurrent_dim, bias=False)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """The input's share of [update; reset; cand] plus their biases, over
        any leading axes: one product [.., 2·cell + rec]."""
        d = self.input_dim
        w = torch.cat([self.update.weight[:, :d], self.reset.weight[:, :d],
                       self.cand.weight[:, :d]])
        b = torch.cat([self.update.bias, self.reset.bias, self.cand.bias])
        return torch.nn.functional.linear(x, w, b)

    def recurrent_weights(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(W_zr [rec, cell + rec], W_h [rec, cell], W_p [cell, rec + nonrec])
        in the products' orientation, taken once a sequence."""
        d = self.input_dim
        w_zr = torch.cat([self.update.weight[:, d:], self.reset.weight[:, d:]]).t()
        return w_zr, self.cand.weight[:, d:].t(), self.proj.weight.t()

    def step(self, carry: Carry, x_gates: torch.Tensor, weights=None
             ) -> Tuple[Carry, torch.Tensor]:
        c, r = carry
        w_zr, w_h, w_p = weights if weights is not None else self.recurrent_weights()
        C, R = self.cell_dim, self.recurrent_dim
        s = torch.sigmoid(torch.addmm(x_gates[:, : C + R], r, w_zr))
        z, gate_r = s[:, :C], s[:, C:]
        h = torch.tanh(torch.addmm(x_gates[:, C + R:], gate_r * r, w_h))
        c_new = torch.addcmul((1.0 - z) * h, z, c)
        y = c_new @ w_p
        return (c_new, y[:, :R]), y

    def forward(self, carry: Carry, x_t: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        return self.step(carry, self.input_gates(x_t))


class GruLayer(nn.Module):
    """Projected GRU over time: [B, T, D] → [B, T, rec + nonrec], with the
    same carry seam as LstmpLayer (initial_carry / return_carry)."""

    ng_instrumented = False

    def __init__(self, input_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int = 0):
        super().__init__()
        self.cell = GruCell(input_dim, cell_dim, recurrent_dim, nonrecurrent_dim)

    def forward(self, x: torch.Tensor, initial_carry: Optional[Carry] = None,
                return_carry: bool = False):
        cell = self.cell
        B = x.shape[0]
        carry = initial_carry if initial_carry is not None else (
            x.new_zeros((B, cell.cell_dim)), x.new_zeros((B, cell.recurrent_dim)))
        y, carry = _scan(cell, carry, cell.input_gates(x))
        return (y, carry) if return_carry else y


class BlstmpLayer(nn.Module):
    """Bidirectional LSTMP: a forward and a reverse LstmpLayer over the same
    input, their outputs concatenated [B, T, 2·(rec + nonrec)]."""

    ng_instrumented = False

    def __init__(self, input_dim: int, cell_dim: int, recurrent_dim: int,
                 nonrecurrent_dim: int = 0):
        super().__init__()
        self.forward_layer = LstmpLayer(input_dim, cell_dim, recurrent_dim,
                                        nonrecurrent_dim)
        self.backward_layer = LstmpLayer(input_dim, cell_dim, recurrent_dim,
                                         nonrecurrent_dim, reverse=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.forward_layer(x), self.backward_layer(x)], dim=-1)


# BlstmpLayer's sub-layers carry flax's names ("forward", "backward") in the
# state dict; nn.Module reserves `forward` as an attribute name
BLSTMP_NAMES = {"forward_layer": "forward", "backward_layer": "backward"}


def _shift_time(v: torch.Tensor, o: int) -> torch.Tensor:
    """[B, T, ...] → frame t takes frame clip(t + o, 0, T − 1)."""
    if o == 0:
        return v
    T = v.shape[1]
    k = min(abs(o), T)
    if o > 0:
        return torch.cat([v[:, k:], v[:, -1:].expand(-1, k, *v.shape[2:])], dim=1)
    return torch.cat([v[:, :1].expand(-1, k, *v.shape[2:]), v[:, : T - k]], dim=1)


class RestrictedAttentionLayer(nn.Module):
    """Time-restricted multi-head self-attention.  Head h at frame t attends
    over the offsets {−L·s, …, 0, …, +R·s} (s = time_stride) with scores
    q_t·k_{t+o}/sqrt(key_dim), softmax over the window; edges clamp to the
    first / last frame.  Output [B, T, H·V], then the weights [B, T, H·W]
    appended when `output_context`.  The window is taken one offset at a
    time (a shifted slice each), so no [B, T, W, H, K] copy is made."""

    ng_instrumented = False

    def __init__(self, input_dim: int, num_heads: int = 4, key_dim: int = 40,
                 value_dim: int = 60, num_left_inputs: int = 5,
                 num_right_inputs: int = 2, time_stride: int = 1,
                 output_context: bool = True):
        super().__init__()
        self.num_heads, self.key_dim, self.value_dim = num_heads, key_dim, value_dim
        self.offsets = tuple(o * time_stride
                             for o in range(-num_left_inputs, num_right_inputs + 1))
        self.output_context = output_context
        self.qkv = nn.Linear(input_dim, num_heads * (2 * key_dim + value_dim))

    @property
    def output_dim(self) -> int:
        H = self.num_heads
        return H * self.value_dim + (H * len(self.offsets) if self.output_context else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        H, K, V = self.num_heads, self.key_dim, self.value_dim
        qkv = self.qkv(x).reshape(B, T, H, 2 * K + V)
        q, k, v = qkv[..., :K], qkv[..., K: 2 * K], qkv[..., 2 * K:]
        scores = torch.stack([(q * _shift_time(k, o)).sum(-1) / math.sqrt(K)
                              for o in self.offsets], dim=2)  # [B, T, W, H]
        w = torch.softmax(scores, dim=2)
        out = sum(w[:, :, j, :, None] * _shift_time(v, o)
                  for j, o in enumerate(self.offsets))  # [B, T, H, V]
        out = out.reshape(B, T, H * V)
        if self.output_context:
            out = torch.cat([out, w.transpose(2, 3).reshape(B, T, H * len(self.offsets))],
                            dim=-1)
        return out
