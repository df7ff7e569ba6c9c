"""LSTM with projection (LSTMP), as nn.Modules.

Counterpart of `LstmpCell` / `LstmpLayer` of
old_kaldi_git_tpu/models/recurrent.py (reference
src/nnet3/nnet-combined-component.{h,cc} LstmNonlinearityComponent and the
xconfig `lstmp-layer`: gates, cell clipping, recurrent and non-recurrent
projection).  The JAX package scans the cell over time with flax's
`nn.scan`; here the input's share of the gates is one product over all
frames, and only the recurrent share runs frame by frame.

The flax conventions kept, so that weights carry over
(`convert.torch_params_from_flax`):
  - the gate pre-activations split in the order i, f, g, o;
  - the forget gate's bias of +1 is added at run time, not stored;
  - the cell is clipped to ±cell_clip (50);
  - the projection has no bias; y = W_p m holds [r; p], r its first
    recurrent_dim entries;
  - parameter names `cell.gates.{weight,bias}`, `cell.proj.weight` (flax
    `lstm/cell/gates/{kernel,bias}`, `lstm/cell/proj/kernel`, kernels
    [in, out] transposed).
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

    def step(self, carry: Carry, x_gates: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """One frame from the input's share of the gates, x_t W_x + b."""
        c, r = carry
        z = x_gates + r @ self.gates.weight[:, self.input_dim:].T
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        c_new = torch.clamp(c_new, -self.cell_clip, self.cell_clip)
        y = self.proj(torch.sigmoid(o) * torch.tanh(c_new))
        return (c_new, y[..., : self.recurrent_dim]), y

    def forward(self, carry: Carry, x_t: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        return self.step(carry, self.input_gates(x_t))

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x W_x + b over any leading axes."""
        return torch.nn.functional.linear(x, self.gates.weight[:, : self.input_dim],
                                          self.gates.bias)


class LstmpLayer(nn.Module):
    """LSTM with projection over time: [B, T, D] → [B, T, rec + nonrec]."""

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
        B, T = x.shape[0], x.shape[1]
        if self.reverse:
            if initial_carry is not None or return_carry:
                raise ValueError("carried state unsupported for reverse scan")
            x = x.flip(1)
        cell = self.cell
        carry = initial_carry if initial_carry is not None else (
            x.new_zeros((B, cell.cell_dim)), x.new_zeros((B, cell.recurrent_dim)))
        xg = cell.input_gates(x)
        ys = []
        for t in range(T):
            carry, y = cell.step(carry, xg[:, t])
            ys.append(y)
        y = torch.stack(ys, dim=1) if ys else x.new_zeros(
            (B, 0, cell.proj.weight.shape[0]))
        if self.reverse:
            y = y.flip(1)
        return (y, carry) if return_carry else y
