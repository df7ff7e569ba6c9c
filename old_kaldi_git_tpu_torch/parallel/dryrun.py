"""The flagship forward and the multi-device dry run.

Counterpart of the JAX package's root `__graft_entry__.py`:

  entry()             — the recipe-scale TDNN-F forward (1536 hidden, 160
                        bottleneck, 17 layers, 6,008 pdfs, 40 inputs) on
                        [4, 64, 40] features: (fn, example_args).
  dryrun_multichip(n) — over n ranks of a torch.distributed process group
                        (NCCL on cards, gloo on the CPU):
      1. one CE training step on a ("data", "model") mesh: the batch split
         over "data", every `affine` weight split by output over "model";
         the batch-norm statistics and the gradients summed over "data",
         the max-change norms taken over the whole tensors, so the step
         equals the same step on one rank (which the dry run also takes
         and compares);
      2. the AM forward with the time axis split over "model": each rank
         receives halos as wide as the model's left and right context from
         its neighbours (the compiler inserted them in the JAX package);
      3. the graph-sharded token decode (decoder/sharded.py) on a random
         256-state graph, one shard a rank.

`dryrun_multichip` runs in the caller's process group when one of n ranks
exists; otherwise it starts one (in this process when n = 1, else n
processes, one a card).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Set

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from old_kaldi_git_tpu_torch.device import DeviceLike
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.tdnn import _BatchNormLayer, make_tdnnf
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("dryrun")


def _flagship(num_pdfs: int = 6008, input_dim: int = 40,
              device: DeviceLike = None) -> AmNnet:
    """Recipe-scale chain TDNN-F (reference egs/librispeech tdnn_1d xconfig:
    1536-dim, 160 bottleneck, 17 factored layers, about 6k pdfs)."""
    config = make_tdnnf(input_dim, num_pdfs, hidden_dim=1536, bottleneck_dim=160,
                        num_layers=17, subsampled_stride=3, num_full_rate_layers=3)
    return AmNnet.init(config, seed=0, device=device)


def entry(device: DeviceLike = None):
    """(fn, example_args): the flagship model's forward to pseudo-loglikes
    on [4, 64, 40] features from a seed, on `device` (default the card)."""
    am = _flagship(device=device)
    feats = np.random.default_rng(0).normal(size=(4, 64, 40)).astype(np.float32)
    return am.loglikes_batch, (torch.from_numpy(feats).to(am.device),)


# ---------------------------------------------------------------------------
# collectives with gradients
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's input is the sum of
    the ranks' output gradients (the loss is the ranks' summed losses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """All-gather of the ranks' column blocks along the last axis; every
    rank computes the same loss downstream, so the gradient of a block is
    its columns of the output gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), None, None, None


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    group (each rank's column block gives only its share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class ColumnShardedLinear(nn.Module):
    """This rank's block of an nn.Linear's output columns (weight rows);
    the forward gathers the blocks, then adds the replicated bias."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int):
        super().__init__()
        w = full.out_features // size
        self.group, self.rank, self.size = group, rank, size
        self.weight = nn.Parameter(full.weight.detach()[rank * w:(rank + 1) * w].clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _SumGradients.apply(x, self.group)
        y = _GatherColumns.apply(torch.nn.functional.linear(x, self.weight),
                                 self.group, self.rank, self.size)
        return y if self.bias is None else y + self.bias


def shard_affine_columns(model: nn.Module, group, rank: int, size: int) -> Set[str]:
    """Replace every `affine` nn.Linear whose output splits `size` ways by
    its ColumnShardedLinear block (the JAX dry run's tensor-parallel spec:
    the affine kernels' output axis over "model"; the rest replicated).
    Returns the names of the split weights."""
    names = set()
    if size == 1:
        return names
    for mname, module in list(model.named_modules()):
        lin = getattr(module, "affine", None)
        if isinstance(lin, nn.Linear) and lin.out_features % size == 0:
            module.affine = ColumnShardedLinear(lin, group, rank, size)
            names.add(f"{mname}.affine.weight")
    return names


def sync_batchnorm_stats(model: nn.Module, group) -> None:
    """Train-mode batch-norm statistics over the whole batch: every
    _BatchNormLayer sums its statistics over `group`."""
    for module in model.modules():
        if isinstance(module, _BatchNormLayer):
            module.stats_sum = lambda x: _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# the data × model CE step
# ---------------------------------------------------------------------------

def make_sharded_ce_step(model: nn.Module, optimizer, mesh, sharded: Set[str]):
    """CE step of a model whose batch is split over the mesh's "data" axis
    and whose `sharded` weights are split by rows over "model":
    (opt_state, feats, labels, mask) of this rank's batch slice →
    (opt_state, whole-batch loss).  The loss is the whole batch's masked
    mean, the gradients are summed over "data", and the optimizer's
    max-change norms are taken over the whole tensors."""
    from old_kaldi_git_tpu_torch.models.train import ce_loss

    data_g, model_g = mesh.get_group("data"), mesh.get_group("model")
    params = dict(model.named_parameters())

    def squares(named: Dict[str, torch.Tensor]) -> torch.Tensor:
        split = [t for k, t in named.items() if k in sharded]
        whole = [t for k, t in named.items() if k not in sharded]
        dev = next(iter(named.values())).device
        total = sum((torch.sum(t * t) for t in whole), torch.zeros((), device=dev))
        if split:
            part = sum(torch.sum(t * t) for t in split).reshape(1)
            dist.all_reduce(part, group=model_g)
            total = total + part[0]
        return total

    optimizer.sum_squares = squares

    def step(opt_state, feats, labels, mask):
        count = mask.sum().reshape(1)
        dist.all_reduce(count, group=data_g)
        model.zero_grad(set_to_none=True)
        loss, _ = ce_loss(model, feats, labels.long(), mask)
        # ce_loss divides by this rank's mask count; the whole batch's mean
        # is the ranks' sum over the whole count
        loss = loss * torch.clamp(mask.sum(), min=1.0) / torch.clamp(count[0], min=1.0)
        loss.backward()
        with torch.no_grad():
            grads = {}
            for k, p in params.items():
                g = p.grad.contiguous()
                dist.all_reduce(g, group=data_g)
                grads[k] = g
            updates, opt_state = optimizer.update(grads, opt_state, params)
            for k, p in params.items():
                p.add_(updates[k])
            total = loss.detach().reshape(1).clone()
            dist.all_reduce(total, group=data_g)
        model.zero_grad(set_to_none=True)
        return opt_state, total[0]

    return step


def gather_columns(model: nn.Module, sharded: Set[str], group, size: int
                   ) -> Dict[str, torch.Tensor]:
    """The whole model's parameters: the split weights' row blocks
    gathered over `group`, the rest as they are."""
    out = {}
    for k, p in model.named_parameters():
        if k in sharded:
            parts = [torch.empty_like(p) for _ in range(size)]
            dist.all_gather(parts, p.detach().contiguous(), group=group)
            out[k] = torch.cat(parts, dim=0)
        else:
            out[k] = p.detach()
    return out


# ---------------------------------------------------------------------------
# the time-split forward
# ---------------------------------------------------------------------------

def forward_time_split(model: nn.Module, x: torch.Tensor, group, left: int,
                       right: int, output_stride: int = 1) -> torch.Tensor:
    """Forward of this rank's contiguous slice x [B, w, D] of the time axis
    (the group's ranks hold the slices in rank order, all of width w, a
    multiple of the output stride): halos of `left` and `right` frames
    (the model's context; the left one rounded up to the stride) come from
    the neighbouring slices, the extended slice runs through the model, and
    the output frames of the slice itself are returned.  At the sequence's
    ends the halo is empty and the model's own edge handling applies, as in
    the unsplit forward."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    B, w, D = x.shape
    s = output_stride
    if w % s:
        raise ValueError(f"time slice {w} is not a multiple of the stride {s}")
    left = -(-left // s) * s
    Lw, Rw = min(w, left), min(w, right)
    # every rank's last Lw and first Rw frames; a halo wider than a slice
    # takes whole slices from several neighbours
    send = torch.cat([x[:, w - Lw:], x[:, :Rw]], dim=1).contiguous()
    edges = torch.empty((size * B,) + tuple(send.shape[1:]), dtype=x.dtype,
                        device=x.device)
    dist.all_gather_into_tensor(edges, send, group=group)
    edges = edges.view((size,) + tuple(send.shape))
    parts = []
    if Lw:
        lq = range(max(0, rank - -(-left // Lw)), rank)
        parts += [torch.cat([edges[q, :, :Lw] for q in lq] + [x[:, :0]], dim=1)[:, -left:]]
    else:
        parts += [x[:, :0]]
    parts.append(x)
    if Rw:
        rq = range(rank + 1, min(size, rank + 1 + -(-right // Rw)))
        parts.append(torch.cat([x[:, :0]] + [edges[q, :, Lw:] for q in rq], dim=1)[:, :right])
    y = model(torch.cat(parts, dim=1), output_stride=s)
    a = parts[0].shape[1] // s
    return y[:, a:a + w // s]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _random_graph(seed: int = 2, S: int = 256, deg: int = 4, P: int = 32):
    from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph

    gr = np.random.default_rng(seed)
    graph = CsrGraph(
        start=0, row_ptr=(np.arange(S + 1) * deg).astype(np.int32),
        tid=gr.integers(1, 50, S * deg).astype(np.int32),
        pdf=gr.integers(0, P, S * deg).astype(np.int32),
        weight=gr.exponential(1.0, S * deg).astype(np.float32),
        nextstate=((np.repeat(np.arange(S), deg) + gr.integers(1, 37, S * deg))
                   % S).astype(np.int32),
        final_weight=np.zeros(S, np.float32),
        arc_olabels=[() for _ in range(S * deg)],
        final_olabels=[() for _ in range(S)])
    return graph, gr


def dryrun_rank(device: Optional[torch.device] = None) -> dict:
    """This rank's part of the dry run in the current (world) process group.
    Returns a report: the sharded step's loss, its difference from the
    one-rank step's loss and largest parameter difference, the time-split
    forward's largest difference from the unsplit one, and the sharded
    decode's costs (equal on every rank)."""
    from old_kaldi_git_tpu_torch.decoder.sharded import (
        ProcessGroupShards, decode_batch_tokens_sharded)
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
    from old_kaldi_git_tpu_torch.models.train import (
        NnetTrainOptions, TrainState, make_ce_train_step, make_optimizer)
    from old_kaldi_git_tpu_torch.parallel.mesh import MeshConfig, make_mesh, shard_batch

    n = dist.get_world_size()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    data_par = n // model_par
    mesh = make_mesh(MeshConfig(data=data_par, model=model_par))
    m_rank = mesh.get_local_rank("model")
    report: dict = {"data": data_par, "model": model_par}

    num_pdfs, input_dim = 128, 40
    config = make_tdnnf(input_dim, num_pdfs, hidden_dim=256, bottleneck_dim=32,
                        num_layers=3)
    opts = NnetTrainOptions(minibatch_size=data_par * 2, chunk_width=16)
    B, T = opts.minibatch_size, opts.chunk_width
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T, input_dim)).astype(np.float32)
    labels = rng.integers(0, num_pdfs, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)

    # 1. the data × model step, and the same step on one rank
    am = AmNnet.init(config, seed=0, device=device)
    model = am.model.train()
    sharded = shard_affine_columns(model, mesh.get_group("model"), m_rank, model_par)
    if data_par > 1:
        sync_batchnorm_stats(model, mesh.get_group("data"))
    optimizer = make_optimizer(opts, num_steps=10)
    step = make_sharded_ce_step(model, optimizer, mesh, sharded)
    x, y, m = shard_batch(mesh, (feats, labels, mask))
    _, loss = step(optimizer.init(dict(model.named_parameters())), x, y, m)
    loss = float(loss)
    if not np.isfinite(loss):
        raise KaldiError(f"dryrun loss not finite: {loss}")
    ref_am = AmNnet.init(config, seed=0, device=device)
    ref_model = ref_am.model.train()
    ref_opt = make_optimizer(opts, num_steps=10)
    ref_step = make_ce_train_step(ref_model, ref_opt)
    _, metrics = ref_step(TrainState(ref_opt.init(dict(ref_model.named_parameters())), 0),
                          torch.from_numpy(feats), torch.from_numpy(labels),
                          torch.from_numpy(mask))
    whole = gather_columns(model, sharded, mesh.get_group("model"), model_par)
    ref_params = dict(ref_model.named_parameters())
    report["loss"] = loss
    report["loss_diff"] = abs(loss - float(metrics["loss"]))
    report["param_diff"] = max(float((whole[k] - ref_params[k].detach()).abs().max())
                               for k in ref_params)
    report["split_weights"] = len(sharded)
    log.info("dryrun step: mesh data=%d model=%d loss=%.4f (one rank: |d| %.2e, "
             "params %.2e)", data_par, model_par, loss, report["loss_diff"],
             report["param_diff"])

    # 2. the time axis split over "model" (the "seq" axis of the JAX dry run)
    fwd = AmNnet.init(config, seed=0, device=device).model.eval()
    feats_h = np.random.default_rng(1).normal(
        size=(data_par * 2, 16 * model_par, input_dim)).astype(np.float32)
    with torch.no_grad():
        full = torch.from_numpy(feats_h).to(device)
        ref = fwd(full)
        d_rank = mesh.get_local_rank("data")
        b = feats_h.shape[0] // data_par
        w = 16
        mine = full[d_rank * b:(d_rank + 1) * b, m_rank * w:(m_rank + 1) * w]
        got = forward_time_split(fwd, mine, mesh.get_group("model"),
                                 config.left_context, config.right_context)
        want = ref[d_rank * b:(d_rank + 1) * b, m_rank * w:(m_rank + 1) * w]
        diff = (got - want).abs().max().reshape(1)
        bad = ((got - want).abs() > 2e-4 + 1e-3 * want.abs()).sum().reshape(1).float()
        dist.all_reduce(diff, op=dist.ReduceOp.MAX)
        dist.all_reduce(bad)
    report["seq_max_diff"] = float(diff[0])
    report["seq_out_of_tolerance"] = int(bad[0])
    if report["seq_out_of_tolerance"]:
        raise KaldiError(f"time-split forward differs by {float(diff[0]):.3e}")
    log.info("dryrun seq-parallel: T split %d-way, max diff %.2e", model_par,
             report["seq_max_diff"])

    # 3. the graph-sharded token decode, one shard a rank
    graph, gr = _random_graph()
    ll = gr.normal(size=(2, 12, 32)).astype(np.float32)
    res = decode_batch_tokens_sharded(
        graph, ll, [12, 9], group=ProcessGroupShards(device=device),
        opts=ViterbiOptions(beam=1e9, max_active=64, acoustic_scale=0.1))
    if not all(r is not None and np.isfinite(r.cost) for r in res):
        raise KaldiError("dryrun graph-sharded decode failed")
    report["decode_costs"] = [r.cost for r in res]
    report["decode_alignments"] = [r.alignment.tolist() for r in res]
    log.info("dryrun graph-sharded decode: %d arc shards, costs %s", n,
             [round(c, 2) for c in report["decode_costs"]])
    return report


def dryrun_multichip(n_devices: int, backend: Optional[str] = None) -> dict:
    """The dry run over n_devices ranks (module docstring); returns rank
    0's report.  Inside a process group of n_devices ranks it runs as this
    rank; otherwise it starts the group: backend NCCL with a card (one card
    a rank), gloo without."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"process group has {dist.get_world_size()} ranks, "
                             f"asked for {n_devices}")
        return dryrun_rank()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise KaldiError(f"{n_devices} ranks but {torch.cuda.device_count()} cards")
    if n_devices > 1:
        from old_kaldi_git_tpu_torch.parallel.scaling import run_ranks

        return run_ranks(dryrun_rank, n_devices, backend=backend)[0]
    with tempfile.TemporaryDirectory() as tmp:
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            return dryrun_rank()
        finally:
            dist.destroy_process_group()
