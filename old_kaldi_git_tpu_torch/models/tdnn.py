"""TDNN, TDNN-F and the nnet3 architectures built around them.

Counterpart of old_kaldi_git_tpu/models/tdnn.py (reference src/nnet3
components as the standard recipes use them): Append/Offset splicing is a
static time gather with indices clipped at the utterance edges;
relu-batchnorm layers; TDNN-F factorized layers with a scaled bypass; the
time-height convolution of the CNN-TDNN front end; and, from
models/recurrent.py, LSTMP, BLSTMP, projected-GRU and time-restricted
attention layers.  Modules are nn.Modules over [B, T, D], named as the flax
modules are (`tdnn0`, `tdnnf1`, `lstmp3`, `conv0`, …, `prefinal`, `output`)
so weights carry across by name.  The affines are plain large products and
go to torch's matmul.

A layer whose spec carries an `input_desc` reads its input through an nnet3
Descriptor (models/descriptor.py) over the nodes computed before it, by
name: `input`, `<kind><index>`, the spec's xconfig `name`, and `__prev__`
(the previous layer); every other layer reads the previous layer, spliced
by its offsets.

In eval mode the batch-norms normalise with their running statistics; in
train mode (`model.train()`) with the batch's, over every (B, T) position,
padding frames included, the biased variance E[x²] − E[x]², and update the
running statistics as flax's BatchNorm(momentum=0.99) does.  The TDNN-F
bottleneck factors are kept semi-orthogonal by `apply_orthonormal_constraints`
(reference nnet-utils.cc ConstrainOrthonormal).  The natural-gradient instrumentation of the JAX
package's `ng_dense` (the affines of the tdnn, tdnnf, conv, prefinal and
output layers) is `models/natural_gradient.NgCollector`: hooks on those
nn.Linear layers, set only while a step collects; the recurrent and
attention layers are not instrumented, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from old_kaldi_git_tpu_torch.models.descriptor import (
    descriptor_dim, eval_descriptor, offset_range, parse_descriptor)
from old_kaldi_git_tpu_torch.models.recurrent import (
    BlstmpLayer, GruLayer, LstmpLayer, RestrictedAttentionLayer)

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
    kind: str  # "tdnn" | "tdnnf" | "lstmp" | "blstmp" | "pgru" | "attention" | "conv"
    dim: int  # output dim (tdnn/tdnnf), cell dim (lstmp/blstmp/pgru), filters (conv)
    offsets: Tuple[int, ...] = (0,)  # time offsets (tdnn splice / conv kernel)
    # nnet3 Descriptor input (models/descriptor.py); "" = the previous
    # layer, spliced by `offsets`
    input_desc: str = ""
    name: str = ""  # xconfig node name ("" = <kind><index>)
    bottleneck_dim: int = 0  # tdnnf only
    time_stride: int = 1  # tdnnf: factor context; attention: window stride
    bypass_scale: float = 0.66  # tdnnf
    dropout: float = 0.0  # tdnnf, train mode only
    recurrent_dim: int = 0  # lstmp/blstmp/pgru projection (0 → dim // 4)
    nonrecurrent_dim: int = 0
    num_heads: int = 4  # attention
    key_dim: int = 40
    value_dim: int = 60
    num_left_inputs: int = 5
    num_right_inputs: int = 2
    height_in: int = 0  # conv: input read as [.., height_in, D // height_in]
    height_offsets: Tuple[int, ...] = (-1, 0, 1)  # conv kernel over height
    height_subsample: int = 1  # conv: stride over height


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


RECURRENT_KINDS = ("lstmp", "blstmp", "pgru")


def layer_offsets(spec: TdnnLayerSpec) -> Tuple[int, ...]:
    """A layer's time offsets (the JAX package's TdnnConfig._offs): a
    tdnnf's (-ts, 0, ts), an attention window's ends, 0 for a recurrent
    layer (its context is unbounded, not spliced), a tdnn's splice or a
    conv's time taps; widened by the reach of its Descriptor input."""
    if spec.kind == "tdnnf" and spec.time_stride:
        intrinsic = (-spec.time_stride, 0, spec.time_stride)
    elif spec.kind == "attention":
        intrinsic = (-spec.num_left_inputs * spec.time_stride,
                     spec.num_right_inputs * spec.time_stride)
    elif spec.kind in RECURRENT_KINDS:
        intrinsic = (0,)
    else:
        intrinsic = tuple(spec.offsets)
    if spec.input_desc:
        lo, hi = offset_range(parse_descriptor(spec.input_desc))
        return (lo + min(intrinsic), hi + max(intrinsic))
    return intrinsic


class _BatchNormLayer(nn.Module):
    """A layer ending in a BatchNorm without scale or offset (the reference
    BatchNormComponent): running statistics as buffers `mean` and `var`.
    `stats_sum`, when set, sums a train-mode statistic over every rank that
    holds a part of the batch (parallel/dryrun.py's data-parallel step), so
    the statistics are the whole batch's."""

    stats_sum = None

    def _init_stats(self, dim: int) -> None:
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def batchnorm(self, y: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (y - self.mean) * torch.rsqrt(self.var + BATCHNORM_EPS)
        axes = tuple(range(y.dim() - 1))
        if self.stats_sum is None:
            mean, sq = y.mean(axes), (y * y).mean(axes)
        else:
            count = self.stats_sum(y.new_full((1,), float(y[..., 0].numel())))
            mean = self.stats_sum(y.sum(axes)) / count
            sq = self.stats_sum((y * y).sum(axes)) / count
        var = torch.clamp(sq - mean * mean, min=0.0)
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


class TimeHeightConvLayer(_BatchNormLayer):
    """Time-height convolution + ReLU + BatchNorm (reference
    nnet-convolutional-component TimeHeightConvolutionComponent), the
    CNN-TDNN front-end layer.  The input frame is a [height_in, C] grid;
    the (time, height) taps are gathered (time clamped at the edges as
    splice() does, height zero-padded) into channels, in the JAX package's
    order (time tap, height tap, channel), and one nn.Linear shared over the
    heights is the convolution; then every `height_subsample`-th height is
    kept.  Output [B, T, ceil(height_in / s) · num_filters]."""

    def __init__(self, in_dim: int, num_filters: int, height_in: int,
                 time_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_subsample: int = 1):
        super().__init__()
        if in_dim % height_in:
            raise ValueError(f"input dim {in_dim} not divisible by height {height_in}")
        self.height_in = height_in
        self.time_offsets = tuple(time_offsets)
        self.height_offsets = tuple(height_offsets)
        self.height_subsample = height_subsample
        channels = in_dim // height_in
        self.conv = nn.Linear(len(self.time_offsets) * len(self.height_offsets) * channels,
                              num_filters)
        self._init_stats(self.output_dim)  # one statistic per (height, filter)

    @property
    def output_dim(self) -> int:
        return -(-self.height_in // self.height_subsample) * self.conv.out_features

    def forward(self, x: torch.Tensor, sub: int = 1,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        H, nt = self.height_in, len(self.time_offsets)
        C = D // H
        x5 = splice(x, self.time_offsets).reshape(B, T, nt, H, C)
        taps = []
        for o in self.height_offsets:
            k = min(abs(o), H)
            zeros = x5.new_zeros((B, T, nt, k, C))
            if o > 0:
                taps.append(torch.cat([x5[:, :, :, k:], zeros], dim=3))
            elif o < 0:
                taps.append(torch.cat([zeros, x5[:, :, :, : H - k]], dim=3))
            else:
                taps.append(x5)
        # [B, T, H, nt·nh·C]: the kernel's taps as channels at every (t, h)
        y = torch.cat(taps, dim=-1).transpose(2, 3).reshape(B, T, H, -1)
        y = self.conv(y)[:, :, :: self.height_subsample].reshape(B, T, -1)
        return self.batchnorm(torch.relu(y))


def _subsample_at(config: TdnnConfig, output_stride: int) -> int:
    """Earliest tail position from which every remaining layer is a
    Descriptor-free tdnn/tdnnf whose time offsets are all multiples of
    output_stride: subsampling THERE is exact, and the tail of the trunk
    runs at T/stride."""
    stride_at = len(config.layers)
    if output_stride > 1:
        for j in range(len(config.layers), 0, -1):
            spec = config.layers[j - 1]
            if spec.input_desc:
                break
            if spec.kind == "tdnn":
                if any(o % output_stride for o in spec.offsets):
                    break
            elif spec.kind == "tdnnf":
                if spec.time_stride % output_stride:
                    break
            else:
                break
            stride_at = j - 1
    return stride_at


def build_layer(spec: TdnnLayerSpec, in_dim: int) -> Tuple[nn.Module, int]:
    """The module of one layer spec reading `in_dim` features, and its
    output width."""
    if spec.kind == "tdnn":
        offs = (0,) if spec.input_desc else spec.offsets
        return ReluBatchNorm(in_dim, spec.dim, offs), spec.dim
    if spec.kind == "tdnnf":
        return TdnnfLayer(in_dim, spec.dim, spec.bottleneck_dim, spec.time_stride,
                          spec.bypass_scale, spec.dropout), spec.dim
    if spec.kind in RECURRENT_KINDS:
        rec = spec.recurrent_dim or max(1, spec.dim // 4)
        cls = {"lstmp": LstmpLayer, "blstmp": BlstmpLayer, "pgru": GruLayer}[spec.kind]
        width = rec + spec.nonrecurrent_dim
        return (cls(in_dim, spec.dim, rec, spec.nonrecurrent_dim),
                2 * width if spec.kind == "blstmp" else width)
    if spec.kind == "attention":
        layer = RestrictedAttentionLayer(in_dim, spec.num_heads, spec.key_dim,
                                         spec.value_dim, spec.num_left_inputs,
                                         spec.num_right_inputs, spec.time_stride)
        return layer, layer.output_dim
    if spec.kind == "conv":
        layer = TimeHeightConvLayer(in_dim, spec.dim, spec.height_in, spec.offsets,
                                    spec.height_offsets, spec.height_subsample)
        return layer, layer.output_dim
    raise ValueError(f"unknown layer kind {spec.kind}")


class TdnnModel(nn.Module):
    """Executes a TdnnConfig: its layers in order, each reading the previous
    layer or, through its Descriptor input, any earlier node by name; then
    an optional prefinal relu-batchnorm layer and the output affine.

    `forward(feats, output_stride)` returns raw logits
    [B, ceil(T/output_stride), num_outputs]; the stride only changes where
    the sequence is subsampled and the splice offsets past that point.
    `dropout_gen` draws the dropout masks of a train-mode forward."""

    def __init__(self, config: TdnnConfig):
        super().__init__()
        self.config = config
        dims: Dict[str, int] = {"input": config.input_dim, "__prev__": config.input_dim}
        self.descs = {}
        for i, spec in enumerate(config.layers):
            in_dim = dims["__prev__"]
            if spec.input_desc:
                self.descs[i] = parse_descriptor(spec.input_desc)
                in_dim = descriptor_dim(self.descs[i], dims)
            layer, out_dim = build_layer(spec, in_dim)
            self.add_module(f"{spec.kind}{i}", layer)
            for key in ("__prev__", f"{spec.kind}{i}", spec.name):
                if key:
                    dims[key] = out_dim
        dim = dims["__prev__"]
        if config.final_hidden_dim:
            self.prefinal = ReluBatchNorm(dim, config.final_hidden_dim, (0,))
            dim = config.final_hidden_dim
        self.output = nn.Linear(dim, config.num_outputs)

    def forward(self, feats: torch.Tensor, output_stride: int = 1,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = feats
        env = {"input": feats, "__prev__": feats}
        stride_at = _subsample_at(self.config, output_stride)
        sub = 1  # subsampling already applied to the running sequence
        for i, spec in enumerate(self.config.layers):
            if output_stride > 1 and i == stride_at:
                x = x[:, ::output_stride]
                env["__prev__"] = x
                sub = output_stride
            if i in self.descs:
                x, _ = eval_descriptor(self.descs[i], env)
            layer = getattr(self, f"{spec.kind}{i}")
            if spec.kind in ("tdnn", "tdnnf", "conv"):
                x = layer(x, sub, dropout_gen)
            else:
                x = layer(x)
            for key in ("__prev__", f"{spec.kind}{i}", spec.name):
                if key:
                    env[key] = x
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


def make_tdnn_lstm(input_dim: int, num_outputs: int, hidden_dim: int = 512,
                   cell_dim: int = 512, recurrent_dim: int = 128,
                   num_blocks: int = 3) -> TdnnConfig:
    """TDNN-LSTM (the JAX package's make_tdnn_lstm, the tdnn_lstm chain
    recipes): a spliced tdnn layer, then blocks of two spliced tdnn layers
    and an LSTMP layer."""
    layers = [TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1))]
    for _ in range(num_blocks):
        layers.append(TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1)))
        layers.append(TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1)))
        layers.append(TdnnLayerSpec("lstmp", cell_dim, recurrent_dim=recurrent_dim))
    return TdnnConfig(input_dim, num_outputs, tuple(layers))


def make_tdnn_attention(input_dim: int, num_outputs: int, hidden_dim: int = 512,
                        num_layers: int = 5, num_heads: int = 4, key_dim: int = 40,
                        value_dim: int = 60) -> TdnnConfig:
    """TDNN stack with a time-restricted attention layer on top (the JAX
    package's make_tdnn_attention, window −5…+2) and a prefinal layer."""
    layers = [TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1))
              for _ in range(num_layers - 1)]
    layers.append(TdnnLayerSpec("attention", hidden_dim, num_heads=num_heads,
                                key_dim=key_dim, value_dim=value_dim,
                                num_left_inputs=5, num_right_inputs=2))
    return TdnnConfig(input_dim, num_outputs, tuple(layers), final_hidden_dim=hidden_dim)


def make_cnn_tdnnf(input_dim: int, num_outputs: int, height: int = 40,
                   num_filters: Tuple[int, ...] = (32, 64), hidden_dim: int = 768,
                   bottleneck_dim: int = 96, num_tdnnf_layers: int = 6,
                   time_stride: int = 1) -> TdnnConfig:
    """CNN-TDNN-F (the JAX package's make_cnn_tdnnf, the cnn_tdnn chain
    recipes): time-height conv layers over the mel grid, each halving the
    height, then a spliced tdnn layer, a TDNN-F stack and a prefinal layer."""
    if input_dim % height:
        raise ValueError(f"input dim {input_dim} not divisible by {height}")
    layers = []
    h = height
    for f in num_filters:
        layers.append(TdnnLayerSpec("conv", f, offsets=(-1, 0, 1), height_in=h,
                                    height_offsets=(-1, 0, 1), height_subsample=2))
        h = (h + 1) // 2
    layers.append(TdnnLayerSpec("tdnn", hidden_dim, (-1, 0, 1)))
    for _ in range(num_tdnnf_layers):
        layers.append(TdnnLayerSpec("tdnnf", hidden_dim, offsets=(0,),
                                    bottleneck_dim=bottleneck_dim, time_stride=time_stride))
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
