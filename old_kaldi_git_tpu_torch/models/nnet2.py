"""nnet2: p-norm DNNs and parallel SGD with model averaging.

Counterpart of old_kaldi_git_tpu/models/nnet2.py (reference src/nnet2/):

* `group_pnorm` (PnormComponent) and `radial_normalize`
  (NormalizeComponent), the nnet2 nonlinearity stack affine → p-norm →
  normalize;
* a fixed input affine (FixedAffineComponent), a whitening transform of the
  spliced features estimated on the host in float64 (`make_fixed_affine`);
* `train_nnet2_parallel`: each iteration trains `J` replicas on disjoint
  shards of the utterances and averages their parameters (nnet-am-average),
  with the jobs ramping num_jobs_initial → num_jobs_final and a geometric
  learning rate (steps/nnet2/train_pnorm_simple.sh).

The J jobs run as one batched program, as the JAX package's `jax.vmap`:
their parameters are stacked [J, ...] and each step is one forward through
`torch.baddbmm` over the jobs axis, one backward of the sum of the jobs'
losses (each job's gradient is its own, the jobs share no parameter) and
one elementwise update of the stacked tensors; no Python loop runs over
jobs.  The per-job optimizer is optax's `scale_by_adam` (then × −1, the
learning rate applied outside) or SGD with an optional momentum trace,
made fresh each iteration, as fresh jobs are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.models.am_nnet import lecun_normal_
from old_kaldi_git_tpu_torch.models.tdnn import splice
from old_kaldi_git_tpu_torch.models.train import ADAM_B1, ADAM_B2, ADAM_EPS
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("nnet2")


def group_pnorm(x: torch.Tensor, output_dim: int, p: float = 2.0) -> torch.Tensor:
    """PnormComponent: y_i = (Σ_{j in group i} |x_j|^p)^(1/p), groups of
    input_dim / output_dim consecutive units."""
    d = x.shape[-1]
    if d % output_dim:
        raise KaldiError(f"pnorm input {d} not divisible by {output_dim}")
    g = x.reshape(*x.shape[:-1], output_dim, d // output_dim)
    if p == 2.0:
        return torch.sqrt((g * g).sum(-1) + 1e-20)
    return torch.pow(torch.pow(g.abs(), p).sum(-1) + 1e-20, 1.0 / p)


def radial_normalize(x: torch.Tensor) -> torch.Tensor:
    """NormalizeComponent: each frame scaled to unit RMS, the RMS floored
    at 1e-6."""
    rms = torch.sqrt((x * x).mean(-1, keepdim=True))
    return x / torch.clamp(rms, min=1e-6)


@dataclasses.dataclass(frozen=True)
class Nnet2Config:
    input_dim: int
    output_dim: int
    left_context: int = 4
    right_context: int = 4
    pnorm_input_dim: int = 512
    pnorm_output_dim: int = 64
    num_hidden_layers: int = 2
    p: float = 2.0
    # the fixed affine as (W [d, d] float32 bytes, b [d] float32 bytes, d),
    # the JAX package's hashable form; None = identity
    fixed_affine: Optional[Tuple[bytes, bytes, int]] = None

    @property
    def spliced_dim(self) -> int:
        return self.input_dim * (self.left_context + self.right_context + 1)

    @property
    def offsets(self) -> tuple:
        return tuple(range(-self.left_context, self.right_context + 1))

    def fixed_affine_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.fixed_affine is None:
            return None
        wb, bb, d = self.fixed_affine
        return np.frombuffer(wb, np.float32).reshape(d, d), np.frombuffer(bb, np.float32)


def make_fixed_affine(feats_spliced: np.ndarray) -> Tuple[bytes, bytes, int]:
    """The whitening transform of spliced features [..., d] (the
    FixedAffineComponent that steps/nnet2/get_lda.sh estimates), in float64
    on the host, as Nnet2Config.fixed_affine."""
    X = feats_spliced.reshape(-1, feats_spliced.shape[-1]).astype(np.float64)
    mu = X.mean(0)
    cov = np.cov(X - mu, rowvar=False) + 1e-4 * np.eye(X.shape[1])
    evals, evecs = np.linalg.eigh(cov)
    W = (evecs / np.sqrt(np.maximum(evals, 1e-8))) @ evecs.T  # symmetric
    b = -W @ mu
    return W.astype(np.float32).tobytes(), b.astype(np.float32).tobytes(), X.shape[1]


class Nnet2Model(nn.Module):
    """Splice → (fixed affine) → N × (affine → p-norm → normalize) → affine,
    over [..., T, D]; the affines named as the flax module's (`affine<i>`,
    `final_affine`), the fixed affine held as buffers."""

    def __init__(self, config: Nnet2Config):
        super().__init__()
        self.config = config
        fa = config.fixed_affine_arrays()
        if fa is not None:
            self.register_buffer("fixed_w", torch.from_numpy(fa[0].copy()))
            self.register_buffer("fixed_b", torch.from_numpy(fa[1].copy()))
        dim = config.spliced_dim
        for i in range(config.num_hidden_layers):
            setattr(self, f"affine{i}", nn.Linear(dim, config.pnorm_input_dim))
            dim = config.pnorm_output_dim
        self.final_affine = nn.Linear(dim, config.output_dim)

    def preconditioned(self, feats: torch.Tensor) -> torch.Tensor:
        """The spliced input through the fixed affine, x Wᵀ + b (correct for
        a non-symmetric W too)."""
        x = splice(feats, self.config.offsets)
        if self.config.fixed_affine is not None:
            x = x @ self.fixed_w.T + self.fixed_b
        return x

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = self.preconditioned(feats)
        for i in range(c.num_hidden_layers):
            x = radial_normalize(group_pnorm(getattr(self, f"affine{i}")(x),
                                             c.pnorm_output_dim, c.p))
        return self.final_affine(x)


def _stacked_forward(model: Nnet2Model, params: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """J replicas at once: params [J, ...] by name, x [J, N, d] (already
    preconditioned) → logits [J, N, P], one baddbmm a layer."""
    c = model.config

    def affine(name, h):
        return torch.baddbmm(params[f"{name}.bias"][:, None, :], h,
                             params[f"{name}.weight"].transpose(1, 2))

    for i in range(c.num_hidden_layers):
        x = radial_normalize(group_pnorm(affine(f"affine{i}", x), c.pnorm_output_dim, c.p))
    return affine("final_affine", x)


class AmNnet2:
    """AmNnet (nnet2/am-nnet.h) role: the network and its log priors →
    pseudo-loglikes, on one device."""

    def __init__(self, config: Nnet2Config, model: Nnet2Model,
                 log_priors: Optional[np.ndarray] = None, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.log_priors = None
        if log_priors is not None:
            self.log_priors = torch.as_tensor(np.asarray(log_priors, np.float32)).to(self.device)

    @staticmethod
    def init(config: Nnet2Config, generator: torch.Generator,
             device: DeviceLike = None) -> "AmNnet2":
        """A fresh network, its weights drawn as flax's Dense default from
        `generator` (the values are not flax's: the generators differ)."""
        model = Nnet2Model(config)
        lecun_normal_(model, generator)
        return AmNnet2(config, model, device=device)

    @torch.no_grad()
    def logits(self, feats) -> torch.Tensor:
        return self.model(torch.as_tensor(feats, dtype=torch.float32, device=self.device))

    def loglikes_batch(self, feats) -> torch.Tensor:
        logp = torch.log_softmax(self.logits(feats), dim=-1)
        return logp if self.log_priors is None else logp - self.log_priors

    def set_priors_from_alignment_counts(self, counts: np.ndarray) -> None:
        p = np.asarray(counts, np.float64) + 0.5
        p = np.maximum(p / p.sum(), 0.01 / len(p))
        self.log_priors = torch.from_numpy(np.log(p).astype(np.float32)).to(self.device)


@options_dataclass
class Nnet2TrainOptions:
    """Options named after steps/nnet2/train_pnorm_simple.sh."""

    num_epochs: int = 10
    minibatch_size: int = 4
    num_jobs_initial: int = 2
    num_jobs_final: int = 4
    initial_lr: float = 2e-3
    final_lr: float = 2e-4
    momentum: float = 0.0
    # the per-job update: "adam" (a stand-in for the reference's online
    # natural-gradient preconditioning) or "sgd" (--use-preconditioning=false)
    optimizer: str = "adam"
    seed: int = 0


def train_nnet2_parallel(am: AmNnet2, feats: Dict[str, np.ndarray],
                         labels: Dict[str, np.ndarray],
                         opts: Optional[Nnet2TrainOptions] = None,
                         history: Optional[List[dict]] = None) -> AmNnet2:
    """Parallel SGD with model averaging on `am`'s device (the JAX package's
    train_nnet2_parallel): utterances padded into one [N, T, D] batch on the
    device; each iteration draws a permutation, deals `J·nb·B` utterances
    (np.resize repeats a short set) to J jobs of nb minibatches of B, runs
    them as one batched program and averages the J results.  Priors from
    the labels' counts.  history: one dict an iteration (`iteration`,
    `jobs`, `lr`, `loss`: the mean over jobs of each job's mean minibatch
    CE, `steps`)."""
    opts = opts or Nnet2TrainOptions()
    if opts.optimizer not in ("adam", "sgd"):
        raise KaldiError(f"unknown nnet2 optimizer {opts.optimizer!r}")
    c = am.config
    dev = am.device
    keys = sorted(k for k in labels if k in feats)
    if not keys:
        raise KaldiError("no labeled utterances")
    N, T = len(keys), max(feats[k].shape[0] for k in keys)
    bf = np.zeros((N, T, c.input_dim), np.float32)
    bl = np.zeros((N, T), np.int64)
    bm = np.zeros((N, T), np.float32)
    counts = np.zeros(c.output_dim, np.float64)
    for i, k in enumerate(keys):
        t = min(feats[k].shape[0], len(labels[k]))
        bf[i, :t] = feats[k][:t]
        bl[i, :t] = labels[k][:t]
        bm[i, :t] = 1.0
        counts += np.bincount(labels[k][:t], minlength=c.output_dim)
    model = Nnet2Model(c).to(dev)
    model.load_state_dict(am.model.state_dict())
    with torch.no_grad():  # the fixed affine is not trained: precondition once
        xf = model.preconditioned(torch.from_numpy(bf).to(dev))
    yl, ym = torch.from_numpy(bl).to(dev), torch.from_numpy(bm).to(dev)
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    adam = opts.optimizer == "adam"

    def job_losses(stacked, idx):
        """Each job's masked CE of its minibatch idx [J, B] → [J]."""
        J, B = idx.shape
        x = xf[idx].reshape(J, B * T, -1)
        logp = torch.log_softmax(_stacked_forward(model, stacked, x), dim=-1)
        ll = logp.gather(-1, yl[idx].reshape(J, B * T, 1))[..., 0]
        m = ym[idx].reshape(J, B * T)
        return -(ll * m).sum(1) / torch.clamp(m.sum(1), min=1.0)

    rng = np.random.default_rng(opts.seed)
    B = opts.minibatch_size
    for it in range(opts.num_epochs):
        frac = it / max(opts.num_epochs - 1, 1)
        J = int(round(opts.num_jobs_initial
                      + frac * (opts.num_jobs_final - opts.num_jobs_initial)))
        J = max(1, min(J, max(1, N // B)))
        lr = opts.initial_lr * (opts.final_lr / opts.initial_lr) ** frac
        order = rng.permutation(N)
        nb = max(1, N // (J * B))  # minibatches a job, equal across jobs
        take = J * nb * B
        idx = order[:take] if take <= N else np.resize(order, take)
        sel = torch.from_numpy(idx.reshape(J, nb, B)).to(dev)
        stacked = [params[n].expand(J, *params[n].shape).clone().requires_grad_()
                   for n in names]
        # the optimizer's state, fresh each iteration as fresh jobs are
        mu = [torch.zeros_like(p) for p in stacked]
        nu = [torch.zeros_like(p) for p in stacked] if adam else None
        losses = []
        for s in range(nb):
            loss = job_losses(dict(zip(names, stacked)), sel[:, s])
            grads = torch.autograd.grad(loss.sum(), stacked)
            with torch.no_grad():
                if adam:
                    count = s + 1
                    torch._foreach_lerp_(mu, grads, 1.0 - ADAM_B1)
                    torch._foreach_mul_(nu, ADAM_B2)
                    torch._foreach_addcmul_(nu, grads, grads, 1.0 - ADAM_B2)
                    den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - ADAM_B2 ** count))
                    torch._foreach_add_(den, ADAM_EPS)
                    step = torch._foreach_div(torch._foreach_div(mu, 1.0 - ADAM_B1 ** count),
                                              den)
                elif opts.momentum > 0:
                    torch._foreach_mul_(mu, opts.momentum)
                    torch._foreach_add_(mu, grads)
                    step = mu
                else:
                    step = grads
                torch._foreach_add_(stacked, step, alpha=-lr)
            losses.append(loss.detach())
        mean_loss = float(torch.stack(losses).mean(0).mean())
        params = {n: p.detach().mean(0) for n, p in zip(names, stacked)}
        log.info("nnet2 iter %d: %d jobs, lr %.2e, CE %.4f", it, J, lr, mean_loss)
        if history is not None:
            history.append({"iteration": it, "jobs": J, "lr": lr, "loss": mean_loss,
                            "steps": nb})
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    out = AmNnet2(c, model, device=dev)
    out.set_priors_from_alignment_counts(counts)
    return out
