"""TDNN and factored TDNN (TDNN-F) acoustic models.

Counterpart of old_kaldi_git_tpu/models/tdnn.py (reference src/nnet3
components as the standard recipes use them): Append/Offset splicing is a
static time gather with indices clipped at the utterance edges;
relu-batchnorm layers; TDNN-F factorized layers with a scaled bypass.
Modules are nn.Modules over [B, T, D], named as the flax modules are
(`tdnn0`, `tdnnf1`, …, `prefinal`, `output`) so weights carry across by
name.  The affines are plain large products and go to torch's matmul.

In eval mode the batch-norms normalise with their running statistics; in
train mode (`model.train()`) with the batch's, over every (B, T) position,
padding frames included, the biased variance E[x²] − E[x]², and update the
running statistics as flax's BatchNorm(momentum=0.99) does.  The TDNN-F
bottleneck factors are kept semi-orthogonal by `apply_orthonormal_constraints`
(reference nnet-utils.cc ConstrainOrthonormal).  The natural-gradient
instrumentation of the JAX package's `ng_dense` (every affine's input rows
and output derivatives) is `models/natural_gradient.NgCollector`: hooks on
these nn.Linear layers, set only while a step collects.

Layer kinds other than `tdnn` and `tdnnf` (recurrent, attention, conv) and
Descriptor inputs are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

BATCHNORM_EPS = 1e-5  # flax.linen.BatchNorm default, which the reference model used
BATCHNORM_MOMENTUM = 0.99  # running ← 0.99·running + 0.01·batch (flax's convention)


def splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Append(Offset(x, o) for o in offsets): [B, T, D] → [B, T, D*len].
    Edge frames are replicated (indices clipped), not zero-padded: the
    sequence is padded with copies of its edge frames and each offset is a
    slice of it, so the backward pass sums the copies by `expand`'s
    reduction instead of by atomic adds, and repeats itself bit for bit."""
    if tuple(offsets) == (0,):
        return x
    T = x.shape[-2]
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    parts = [x]
    if lo:
        parts.insert(0, x[..., :1, :].expand(*x.shape[:-2], lo, x.shape[-1]))
    if hi:
        parts.append(x[..., -1:, :].expand(*x.shape[:-2], hi, x.shape[-1]))
    padded = torch.cat(parts, dim=-2) if len(parts) > 1 else x
    return torch.cat([padded[..., lo + o: lo + o + T, :] for o in offsets], dim=-1)


@dataclasses.dataclass(frozen=True)
class TdnnLayerSpec:
    kind: str  # "tdnn" | "tdnnf" (others: later slices of the port)
    dim: int  # output dim
    offsets: Tuple[int, ...] = (0,)  # time offsets (tdnn splice)
    input_desc: str = ""  # nnet3 Descriptor input; not ported yet
    bottleneck_dim: int = 0  # tdnnf only
    time_stride: int = 1  # tdnnf: factor context
    bypass_scale: float = 0.66  # tdnnf
    dropout: float = 0.0  # tdnnf, train mode only


@dataclasses.dataclass(frozen=True)
class TdnnConfig:
    input_dim: int
    num_outputs: int  # pdfs
    layers: Tuple[TdnnLayerSpec, ...]
    final_hidden_dim: int = 0  # prefinal layer (0 = none)

    @property
    def left_context(self) -> int:
        """Input frames before a frame that its output depends on."""
        return -sum(min(0, min(layer_offsets(l))) for l in self.layers)

    @property
    def right_context(self) -> int:
        """Input frames after a frame that its output depends on."""
        return sum(max(0, max(layer_offsets(l))) for l in self.layers)


def layer_offsets(spec: TdnnLayerSpec) -> Tuple[int, ...]:
    """A layer's time offsets: a tdnnf's (-ts, 0, ts), a tdnn's splice."""
    if spec.kind == "tdnnf" and spec.time_stride:
        return (-spec.time_stride, 0, spec.time_stride)
    return tuple(spec.offsets)


class _BatchNormLayer(nn.Module):
    """A layer ending in a BatchNorm without scale or offset (the reference
    BatchNormComponent): running statistics as buffers `mean` and `var`."""

    def _init_stats(self, dim: int) -> None:
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def batchnorm(self, y: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (y - self.mean) * torch.rsqrt(self.var + BATCHNORM_EPS)
        axes = tuple(range(y.dim() - 1))
        mean = y.mean(axes)
        var = torch.clamp((y * y).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            m = BATCHNORM_MOMENTUM
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return (y - mean) * torch.rsqrt(var + BATCHNORM_EPS)


class ReluBatchNorm(_BatchNormLayer):
    """relu-batchnorm-layer: Affine → ReLU → BatchNorm (no scale/offset,
    like the reference BatchNormComponent)."""

    def __init__(self, in_dim: int, dim: int, offsets: Tuple[int, ...] = (0,)):
        super().__init__()
        self.offsets = tuple(offsets)
        self.affine = nn.Linear(in_dim * len(self.offsets), dim)
        self._init_stats(dim)

    def forward(self, x: torch.Tensor, sub: int = 1,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """`sub`: the sequence was already subsampled by this factor, so the
        time offsets (multiples of it by construction) shrink by it."""
        offsets = tuple(o // sub for o in self.offsets)
        return self.batchnorm(torch.relu(self.affine(splice(x, offsets))))


class TdnnfLayer(_BatchNormLayer):
    """Factored TDNN layer: bias-free linear-to-bottleneck over (-ts, 0),
    affine back up over (0, ts), ReLU + BatchNorm, dropout in train mode,
    scaled residual bypass when the dims match."""

    def __init__(self, in_dim: int, dim: int, bottleneck_dim: int,
                 time_stride: int = 1, bypass_scale: float = 0.66,
                 dropout: float = 0.0):
        super().__init__()
        ts = time_stride
        self.down_offsets = (-ts, 0) if ts else (0,)
        self.up_offsets = (0, ts) if ts else (0,)
        self.bypass_scale = bypass_scale
        self.dropout = dropout
        self.bypass = in_dim == dim
        self.linear = nn.Linear(in_dim * len(self.down_offsets), bottleneck_dim,
                                bias=False)
        self.affine = nn.Linear(bottleneck_dim * len(self.up_offsets), dim)
        self._init_stats(dim)

    def forward(self, x: torch.Tensor, sub: int = 1,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.linear(splice(x, tuple(o // sub for o in self.down_offsets)))
        y = torch.relu(self.affine(
            splice(y, tuple(o // sub for o in self.up_offsets))))
        y = self.batchnorm(y)
        if self.dropout > 0 and self.training:
            # flax's Dropout: keep with probability 1 − rate, scaled up
            keep = torch.rand(y.shape, generator=dropout_gen, device=y.device) >= self.dropout
            y = torch.where(keep, y / (1.0 - self.dropout), torch.zeros_like(y))
        if self.bypass:
            y = y + self.bypass_scale * x
        return y


def _subsample_at(config: TdnnConfig, output_stride: int) -> int:
    """Earliest tail position from which every remaining layer is a tdnn/tdnnf
    whose time offsets are all multiples of output_stride: subsampling THERE
    is exact, and the tail of the trunk runs at T/stride."""
    stride_at = len(config.layers)
    if output_stride > 1:
        for j in range(len(config.layers), 0, -1):
            spec = config.layers[j - 1]
            if spec.kind == "tdnn":
                if any(o % output_stride for o in spec.offsets):
                    break
            elif spec.time_stride % output_stride:
                break
            stride_at = j - 1
    return stride_at


class TdnnModel(nn.Module):
    """Executes a TdnnConfig of sequential `tdnn` / `tdnnf` layers, an
    optional prefinal relu-batchnorm layer and the output affine.

    `forward(feats, output_stride)` returns raw logits
    [B, ceil(T/output_stride), num_outputs]; the stride only changes where
    the sequence is subsampled and the splice offsets past that point.
    `dropout_gen` draws the dropout masks of a train-mode forward."""

    def __init__(self, config: TdnnConfig):
        super().__init__()
        self.config = config
        dim = config.input_dim
        for i, spec in enumerate(config.layers):
            if getattr(spec, "input_desc", ""):
                raise NotImplementedError(
                    "Descriptor inputs (models/descriptor.py) are not ported "
                    "yet: they come with the remaining tensor modules")
            if spec.kind == "tdnn":
                layer = ReluBatchNorm(dim, spec.dim, spec.offsets)
            elif spec.kind == "tdnnf":
                layer = TdnnfLayer(dim, spec.dim, spec.bottleneck_dim,
                                   spec.time_stride, spec.bypass_scale, spec.dropout)
            else:
                raise NotImplementedError(
                    f"layer kind {spec.kind!r} is not ported yet: recurrent, "
                    "attention and conv layers come with the remaining "
                    "tensor modules (models/recurrent.py, the conv layer)")
            self.add_module(f"{spec.kind}{i}", layer)
            dim = spec.dim
        if config.final_hidden_dim:
            self.prefinal = ReluBatchNorm(dim, config.final_hidden_dim, (0,))
            dim = config.final_hidden_dim
        self.output = nn.Linear(dim, config.num_outputs)

    def forward(self, feats: torch.Tensor, output_stride: int = 1,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = feats
        stride_at = _subsample_at(self.config, output_stride)
        sub = 1  # subsampling already applied to the running sequence
        for i, spec in enumerate(self.config.layers):
            if output_stride > 1 and i == stride_at:
                x = x[:, ::output_stride]
                sub = output_stride
            x = getattr(self, f"{spec.kind}{i}")(x, sub, dropout_gen)
        if output_stride > sub:
            # the trunk could not be subsampled earlier: the prefinal and
            # output affines still run only at the subsampled frames
            x = x[:, ::output_stride]
        if self.config.final_hidden_dim:
            x = self.prefinal(x)
        return self.output(x)


def make_tdnn(input_dim: int, num_outputs: int, hidden_dim: int = 512,
              num_layers: int = 5, splice_context: int = 1) -> TdnnConfig:
    """Plain TDNN (the JAX package's make_tdnn, steps/nnet3 tdnn recipes):
    relu-batchnorm layers spliced ±splice_context at the even layers."""
    offs = tuple(range(-splice_context, splice_context + 1))
    return TdnnConfig(input_dim, num_outputs, tuple(
        TdnnLayerSpec("tdnn", hidden_dim, offs if i % 2 == 0 else (0,))
        for i in range(num_layers)))


def make_tdnnf(input_dim: int, num_outputs: int, hidden_dim: int = 768,
               bottleneck_dim: int = 96, num_layers: int = 9, time_stride: int = 1,
               subsampled_stride: int = 0, num_full_rate_layers: int = 3) -> TdnnConfig:
    """TDNN-F stack (the JAX package's make_tdnnf): a spliced tdnn layer at
    offsets (-1, 0, 1), num_layers − 1 tdnnf layers at `time_stride` (those
    past num_full_rate_layers at `subsampled_stride` when it is set), and a
    prefinal layer of hidden_dim."""
    layers = [TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1))]
    for i in range(num_layers - 1):
        ts = time_stride
        if subsampled_stride and i + 1 > num_full_rate_layers:
            ts = subsampled_stride
        layers.append(TdnnLayerSpec("tdnnf", hidden_dim, offsets=(0,),
                                    bottleneck_dim=bottleneck_dim, time_stride=ts))
    return TdnnConfig(input_dim, num_outputs, tuple(layers), final_hidden_dim=hidden_dim)


# ---------------------------------------------------------------------------
# semi-orthogonal constraint (reference nnet-utils.cc ConstrainOrthonormal)
# ---------------------------------------------------------------------------

def constrain_orthonormal(w: torch.Tensor, scale: float = 0.0) -> torch.Tensor:
    """One step of the constrained-orthonormal update of a matrix in flax's
    [in, out] orientation: for M = w or wᵀ with rows ≤ cols,
    M ← M − 1/(4σ²)·(MMᵀ − σ²I)·M, σ² = tr(MMᵀMMᵀ)/tr(MMᵀ) (the "floating"
    scale, reference scale < 0, which tdnnf uses) or scale²."""
    transpose = w.shape[0] > w.shape[1]
    m = w.T if transpose else w
    mmt = m @ m.T
    if scale <= 0.0:
        sigma2 = torch.sum(mmt * mmt) / torch.clamp(torch.trace(mmt), min=1e-10)
    else:
        sigma2 = torch.tensor(scale * scale, dtype=w.dtype, device=w.device)
    update = (mmt - torch.eye(mmt.shape[0], dtype=w.dtype, device=w.device) * sigma2) @ m
    m = m - (0.25 / sigma2) * update
    return m.T if transpose else m


@torch.no_grad()
def apply_orthonormal_constraints(model: nn.Module, every_name: str = "linear") -> None:
    """constrain_orthonormal, in place, on the weight of every module named
    `every_name` (the tdnnf bottleneck factors), taken in flax's [in, out]
    orientation: an nn.Linear holds the transpose."""
    for name, module in model.named_modules():
        if name.split(".")[-1] == every_name and isinstance(module, nn.Linear):
            module.weight.copy_(constrain_orthonormal(module.weight.T).T)
