"""Cross-entropy training for neural acoustic models.

Counterpart of old_kaldi_git_tpu/models/train.py (reference
src/nnet3/nnet-training.{h,cc} NnetTrainer): objective = per-frame CE
against aligned pdf-ids, Adam (or plain / momentum SGD), max-change
clipping per component and globally, backstitch, periodic semi-orthogonal
re-constraint of the TDNN-F factors, halved-learning-rate retries of an
epoch that diverges.

The optimizer is optax's chain written as plain functions on tensors, in
optax's order, which torch.optim.Adam cannot express (it puts the learning
rate inside its step and cannot clip after it):

  decayed weights → Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias-corrected) → × −lr(count), the linear schedule reading the
  count before its increment → learning-rate factors by top-level name →
  max-change per top-level module, then globally.

"Top-level module" is the first component of a parameter's name (`tdnn0`,
`tdnnf1`, …, `prefinal`, `output`), flax's top-level keys.  The batch-norm
statistics are buffers, not parameters: the optimizer never sees them.
The natural-gradient optimizers take Adam's place in the chain
(`ng-sgd`: decayed weights → the NG transform → momentum → × −lr → …;
`ng-sgd-act` the same with the activation estimator, whose step runs the
model instrumented: models/natural_gradient.py).  `combine_models` finds
one softmax weight per model by Adam on the CE objective of held-out data
(reference nnet3-combine).
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.natural_gradient import (
    NaturalGradient, NaturalGradientActivations, NgCollector)
from old_kaldi_git_tpu_torch.models.tdnn import apply_orthonormal_constraints
from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass
from old_kaldi_git_tpu_torch.utils.timing import StageClock

log = get_logger("nnet-train")

Params = Dict[str, torch.Tensor]


@options_dataclass
class NnetTrainOptions:
    num_epochs: int = 6
    minibatch_size: int = 16
    chunk_width: int = 140
    initial_lr: float = 1e-3
    final_lr: float = 1e-4
    max_param_change: float = 2.0  # global l2 of the update per step
    max_change_per_component: float = 0.75
    momentum: float = 0.0
    l2_regularize: float = 0.0
    optimizer: str = "adam"  # adam | sgd | ng-sgd | ng-sgd-act
    orthonormal_interval: int = 4  # steps between tdnnf re-constraints
    # backstitch (nnet-training.cc): every `interval` steps, first step
    # AGAINST the update scaled by -alpha, recompute the gradient there,
    # then step by (1 + alpha)
    backstitch_scale: float = 0.0
    backstitch_interval: int = 1
    # halved-LR retries of a diverging epoch; a non-finite objective after
    # them aborts
    max_lr_retries: int = 2
    seed: int = 0


# ---------------------------------------------------------------------------
# the optimizer: optax's chain as functions on {name: tensor} dicts
# ---------------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
NORM_FLOOR = 1e-20  # added under the square root of every max-change norm


def linear_schedule(init_value: float, end_value: float, transition_steps: int
                    ) -> Callable[[int], np.float32]:
    """optax.linear_schedule in float32: init → end over transition_steps
    counts, then flat."""
    def lr(count: int) -> np.float32:
        c = min(max(count, 0), transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)
    return lr


def top_level(name: str) -> str:
    return name.split(".")[0]


class NnetOptimizer:
    """The update rule of `make_optimizer`; its state is a plain dict
    (`count`: updates made; `mu`, `nu`: Adam's moments; `trace`: momentum;
    `ng`: the natural-gradient transform's), which `update` returns anew, so
    a caller can keep or drop it (backstitch's two updates, a rewound
    epoch).  `sum_squares` ({name: tensor} → the sum of their squares),
    when set, takes the max-change norms: a step whose tensors are split
    over ranks sets one that sums over the whole tensors
    (parallel/dryrun.py)."""

    def __init__(self, opts: NnetTrainOptions, num_steps: int,
                 lr_factors: Optional[Dict[str, float]] = None):
        if opts.optimizer not in ("adam", "sgd", "ng-sgd", "ng-sgd-act"):
            raise ValueError(f"unknown optimizer {opts.optimizer}")
        self.opts = opts
        self.lr = linear_schedule(opts.initial_lr, opts.final_lr, max(num_steps, 1))
        self.lr_factors = dict(lr_factors or {})
        self.sum_squares: Optional[Callable[[Params], torch.Tensor]] = None
        self.ng = (NaturalGradient() if opts.optimizer == "ng-sgd"
                   else NaturalGradientActivations() if opts.optimizer == "ng-sgd-act"
                   else None)

    def init(self, params: Params) -> dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        state = {"count": 0}
        if self.opts.optimizer == "adam":
            state.update(mu=zeros(), nu=zeros())
        elif self.opts.momentum > 0:
            state["trace"] = zeros()
        if self.ng is not None:
            state["ng"] = self.ng.init(params)
        return state

    def _factor(self, name: str) -> float:
        f = 1.0
        for pat, v in self.lr_factors.items():
            if fnmatch.fnmatch(name, pat):
                f = float(v)
        return f

    def update(self, grads: Params, state: dict, params: Params,
               ng_stats: Optional[dict] = None) -> Tuple[Params, dict]:
        """(updates to add to the params, the new state).  ng_stats: the
        activation Fisher statistics of this step, for "ng-sgd-act"."""
        o = self.opts
        count = state["count"]
        u = {k: g + o.l2_regularize * params[k] for k, g in grads.items()}
        new = {"count": count + 1}
        if o.optimizer == "ng-sgd":
            u, new["ng"] = self.ng.update(u, state["ng"])
        elif o.optimizer == "ng-sgd-act":
            u, new["ng"] = self.ng.update(u, state["ng"], ng_stats)
        if o.optimizer == "adam":
            mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][k] for k, g in u.items()}
            nu = {k: (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k] for k, g in u.items()}
            c1 = np.float32(1 - np.float32(ADAM_B1) ** np.float32(count + 1))
            c2 = np.float32(1 - np.float32(ADAM_B2) ** np.float32(count + 1))
            u = {k: (mu[k] / float(c1)) / (torch.sqrt(nu[k] / float(c2)) + ADAM_EPS)
                 for k in u}
            new.update(mu=mu, nu=nu)
        elif o.momentum > 0:
            u = {k: g + o.momentum * state["trace"][k] for k, g in u.items()}
            new["trace"] = u
        step = -float(self.lr(count))
        u = {k: v * (step * self._factor(top_level(k))) for k, v in u.items()}
        return clip_max_change(u, o.max_param_change, o.max_change_per_component,
                               self.sum_squares), new


def sum_squares(tensors: Params) -> torch.Tensor:
    return sum(torch.sum(t * t) for t in tensors.values())


def clip_max_change(updates: Params, global_max: float, per_component_max: float,
                    squares: Optional[Callable[[Params], torch.Tensor]] = None) -> Params:
    """Kaldi's max-change on the final update: each top-level module's
    update scaled to at most `per_component_max` in l2, then the whole to
    at most `global_max` (on the device, without a synchronise).
    `squares` ({name: tensor} → their sum of squares) defaults to
    `sum_squares`."""
    squares = squares or sum_squares

    def norm(named: Params) -> torch.Tensor:
        return torch.sqrt(squares(named) + NORM_FLOOR)

    groups: Dict[str, List[str]] = {}
    for k in updates:
        groups.setdefault(top_level(k), []).append(k)
    out = {}
    for names in groups.values():
        scale = torch.clamp(per_component_max / norm({k: updates[k] for k in names}),
                            max=1.0)
        out.update({k: updates[k] * scale for k in names})
    scale = torch.clamp(global_max / norm(out), max=1.0)
    return {k: v * scale for k, v in out.items()}


def make_optimizer(opts: NnetTrainOptions, num_steps: int,
                   lr_factors: Optional[Dict[str, float]] = None) -> NnetOptimizer:
    return NnetOptimizer(opts, num_steps, lr_factors)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """What a step carries besides the model's own tensors: the optimizer
    state and the step count."""

    opt_state: dict
    step: int


def snapshot(model: torch.nn.Module, state: TrainState) -> tuple:
    """A copy of the model's tensors and the train state, for a rewind."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(state))


def restore(model: torch.nn.Module, snap: tuple) -> TrainState:
    model.load_state_dict(snap[0])
    return copy.deepcopy(snap[1])


def apply_update(model: torch.nn.Module, loss_fn: Callable, optimizer: NnetOptimizer,
                 opt_state: dict, scale: float, collector: Optional[NgCollector] = None
                 ) -> Tuple[dict, torch.Tensor, dict]:
    """One gradient of `loss_fn()` → (loss, metrics) at the model's
    parameters, one optimizer update, params += scale · update.  Returns
    (new optimizer state, loss, metrics).  With a `collector`, the forward
    and backward run instrumented and the update takes their activation
    Fisher statistics ("ng-sgd-act")."""
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    if collector is not None:
        collector.active = True
    try:
        loss, metrics = loss_fn()
        loss.backward()
    finally:
        if collector is not None:
            collector.active = False
    grads = {k: p.grad for k, p in params.items()}
    ng_stats = None if collector is None else collector.stats()
    with torch.no_grad():
        updates, new_state = optimizer.update(grads, opt_state, params, ng_stats)
        for k, p in params.items():
            p.add_(updates[k] * scale)
    model.zero_grad(set_to_none=True)
    return new_state, loss.detach(), {k: v.detach() for k, v in metrics.items()}


def backstitch_step(model: torch.nn.Module, loss_fn: Callable, optimizer: NnetOptimizer,
                    state: TrainState, lr_scale: float, backstitch_scale: float,
                    backstitch_interval: int) -> Tuple[TrainState, torch.Tensor, dict]:
    """A train step, plain or backstitch (the JAX package's shared step
    body): on a backstitch step the update is applied at −α·lr_scale, the
    gradient recomputed there and a (1 + α)·lr_scale update follows; both
    updates advance the optimizer state, and the batch-norm statistics are
    those of the second forward from the step's starting statistics."""
    if backstitch_scale <= 0 or state.step % backstitch_interval:
        opt, loss, metrics = apply_update(model, loss_fn, optimizer, state.opt_state,
                                          lr_scale)
        return TrainState(opt, state.step + 1), loss, metrics
    a = backstitch_scale
    stats = {k: b.clone() for k, b in model.named_buffers()}
    opt1, loss, metrics = apply_update(model, loss_fn, optimizer, state.opt_state,
                                       -a * lr_scale)
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(stats[k])
    opt2, _, _ = apply_update(model, loss_fn, optimizer, opt1, (1.0 + a) * lr_scale)
    return TrainState(opt2, state.step + 1), loss, metrics


def ce_loss(model: torch.nn.Module, feats: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, dropout_gen: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Masked per-frame CE of a train-mode forward and its accuracy."""
    logits = model(feats, dropout_gen=dropout_gen)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).to(mask.dtype) * mask).sum() / denom
    return loss, {"acc": acc}


def ng_step(model: torch.nn.Module, loss_fn: Callable, optimizer: NnetOptimizer,
            state: TrainState, lr_scale: float, collector: NgCollector
            ) -> Tuple[TrainState, torch.Tensor, dict]:
    """The "ng-sgd-act" step: one instrumented update (no backstitch, as in
    the JAX package's NG step)."""
    opt, loss, metrics = apply_update(model, loss_fn, optimizer, state.opt_state,
                                      lr_scale, collector)
    return TrainState(opt, state.step + 1), loss, metrics


def make_ce_train_step(model: torch.nn.Module, optimizer: NnetOptimizer,
                       backstitch_scale: float = 0.0, backstitch_interval: int = 1,
                       ng_activation: bool = False) -> Callable:
    """CE step: (state, feats [B, T, D], labels [B, T], mask [B, T]
    [, lr_scale]) → (state, {"loss", "acc"}), the model's parameters and
    batch-norm statistics updated in place.  lr_scale multiplies the final
    update (the halved-LR retry).  ng_activation: the model runs
    instrumented and the update takes the activation Fisher statistics
    ("ng-sgd-act")."""
    dev = next(model.parameters()).device
    collector = NgCollector(model) if ng_activation else None

    def step(state: TrainState, feats, labels, mask, lr_scale: float = 1.0):
        x = torch.as_tensor(feats, device=dev)
        y = torch.as_tensor(labels, device=dev).long()
        m = torch.as_tensor(mask, device=dev)
        gen = torch.Generator(device=dev).manual_seed(state.step)
        loss_fn = lambda: ce_loss(model, x, y, m, gen)  # noqa: E731
        if collector is not None:
            state, loss, metrics = ng_step(model, loss_fn, optimizer, state, lr_scale,
                                           collector)
        else:
            state, loss, metrics = backstitch_step(model, loss_fn, optimizer, state,
                                                   lr_scale, backstitch_scale,
                                                   backstitch_interval)
        return state, {"loss": loss, **metrics}

    step.collector = collector  # its hooks stay on the model until removed
    return step


def check_divergence(model: torch.nn.Module, state: TrainState, snap: tuple,
                     mean_loss: float, prev_loss: Optional[float], epoch: int, retries: int,
                     lr_scale: float, max_retries: int, on_accept: Callable[[], None]):
    """Divergence recovery shared by the CE and chain epoch loops
    (reference steps/libs/nnet3/train/common.py halved-LR re-run and
    nnet3-train's fatal non-finite check).  Returns (state, prev_loss,
    epoch, retries, lr_scale): on divergence (non-finite, or worse than the
    previous epoch by 10 % relative + 0.1 absolute) rewinds the model and
    state to `snap`, halves the LR scale and retries the epoch, up to
    `max_retries` times; on acceptance calls `on_accept`, advances the
    epoch and restores the full LR."""
    diverged = (not np.isfinite(mean_loss)) or (
        prev_loss is not None and mean_loss > prev_loss + 0.1 * abs(prev_loss) + 0.1)
    if diverged and retries < max_retries:
        log.warning("epoch %d diverged (objf %.4f, previous %s); rewinding and "
                    "retrying with LR scale %.3f", epoch, mean_loss, prev_loss,
                    lr_scale * 0.5)
        return restore(model, snap), prev_loss, epoch, retries + 1, lr_scale * 0.5
    if not np.isfinite(mean_loss):
        raise KaldiError(f"non-finite objective {mean_loss} after {max_retries} "
                         "halved-LR retries; aborting (nnet3-train KALDI_ERR behavior)")
    on_accept()
    return state, mean_loss, epoch + 1, 0, 1.0


# ---------------------------------------------------------------------------
# CE training
# ---------------------------------------------------------------------------

def _chunk_batches(feats: Dict[str, np.ndarray], labels: Dict[str, np.ndarray],
                   chunk: int, batch: int, rng: np.random.Generator
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Cut utterances into fixed chunks (reference nnet3-get-egs and the
    ExampleMerger's minibatches), shuffled by `rng`: the JAX package's
    chunks and order from the same generator state."""
    pieces = []
    for k in sorted(feats):
        f, l = feats[k], labels[k]
        t = min(len(l), f.shape[0])
        for s in range(0, t, chunk):
            e = min(s + chunk, t)
            if e - s < chunk // 2 and s > 0:
                s = max(0, e - chunk)  # a short tail becomes a full window
            pieces.append((k, s, e))
    rng.shuffle(pieces)
    D = next(iter(feats.values())).shape[1]
    for i in range(0, len(pieces), batch):
        group = pieces[i: i + batch]
        bf = np.zeros((len(group), chunk, D), np.float32)
        bl = np.zeros((len(group), chunk), np.int32)
        bm = np.zeros((len(group), chunk), np.float32)
        for j, (k, s, e) in enumerate(group):
            bf[j, : e - s] = feats[k][s:e]
            bl[j, : e - s] = labels[k][s:e]
            bm[j, : e - s] = 1.0
        yield bf, bl, bm


def train_ce(am: AmNnet, feats: Dict[str, np.ndarray], pdf_labels: Dict[str, np.ndarray],
             opts: Optional[NnetTrainOptions] = None,
             history: Optional[List[dict]] = None,
             timings: Optional[Dict[str, float]] = None) -> AmNnet:
    """Train a copy of `am` with CE on aligned pdf labels, on am's device;
    then priors from its average posteriors over the first 64 utterances
    (sorted), as the JAX package does.  history: receives one dict an
    accepted epoch (`epoch`, `loss`, `acc`, `steps`, `step_losses`); timings: the
    host-clock `train_seconds` and `priors_seconds`, each ended by a device
    synchronise, and `steps`."""
    opts = opts or NnetTrainOptions()
    clock = StageClock(am.device, timings)
    rng = np.random.default_rng(opts.seed)
    model = copy.deepcopy(am.model).train()
    num_chunks = sum(max(1, feats[k].shape[0] // opts.chunk_width) for k in feats)
    steps_per_epoch = max(1, num_chunks // opts.minibatch_size)
    optimizer = make_optimizer(opts, steps_per_epoch * opts.num_epochs)
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    step_fn = make_ce_train_step(model, optimizer, opts.backstitch_scale,
                                 opts.backstitch_interval,
                                 ng_activation=opts.optimizer == "ng-sgd-act")
    epoch, retries, lr_scale, prev_loss = 0, 0, 1.0, None
    while epoch < opts.num_epochs:
        snap = snapshot(model, state)
        losses, accs = [], []
        for bf, bl, bm in _chunk_batches(feats, pdf_labels, opts.chunk_width,
                                         opts.minibatch_size, rng):
            state, metrics = step_fn(state, bf, bl, bm, lr_scale)
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
            if opts.orthonormal_interval and state.step % opts.orthonormal_interval == 0:
                apply_orthonormal_constraints(model)
        # one copy to the host an epoch
        loss_v = torch.stack(losses).cpu().numpy().astype(np.float64)
        acc_v = torch.stack(accs).cpu().numpy().astype(np.float64)
        mean_loss, e = float(np.mean(loss_v)), epoch

        def accept():
            log.info("epoch %d: CE %.4f acc %.3f (%d steps)", e, mean_loss,
                     float(np.mean(acc_v)), len(loss_v))
            if history is not None:
                history.append({"epoch": e, "loss": mean_loss,
                                "acc": float(np.mean(acc_v)), "steps": len(loss_v),
                                "step_losses": loss_v.tolist()})

        state, prev_loss, epoch, retries, lr_scale = check_divergence(
            model, state, snap, mean_loss, prev_loss, epoch, retries, lr_scale,
            opts.max_lr_retries, accept)
    if step_fn.collector is not None:
        step_fn.collector.remove()
    clock.lap("train_seconds")
    clock.add("steps", state.step)
    out = AmNnet(am.config, model.eval(), device=am.device, ivector_dim=am.ivector_dim)
    _, sample, nf = pad_feature_batch(feats, keys=sorted(feats)[:64])
    out.set_priors_from_posteriors(sample, nf)
    clock.lap("priors_seconds")
    return out


def average_models(ams: Sequence[AmNnet], weights: Optional[Sequence[float]] = None
                   ) -> AmNnet:
    """Weighted average of models with one config: every parameter and
    batch-norm statistic, summed in float64 (~ nnet3-average), and the
    priors averaged in probability."""
    if not ams:
        raise ValueError("average_models: no models")
    weights = [1.0 / len(ams)] * len(ams) if weights is None else list(weights)
    if len(weights) != len(ams):
        raise ValueError(f"average_models: {len(weights)} weights for {len(ams)} models")
    total = float(sum(weights))
    states = [am.model.state_dict() for am in ams]
    avg = {}
    for k, v in states[0].items():
        acc = torch.zeros(v.shape, dtype=torch.float64, device=v.device)
        for w, st in zip(weights, states):
            acc += (w / total) * st[k].double()
        avg[k] = acc.to(v.dtype)
    model = copy.deepcopy(ams[0].model)
    model.load_state_dict(avg)
    log_priors = None
    if ams[0].log_priors is not None:
        prior = sum((w / total) * np.exp(am.log_priors.double().cpu().numpy())
                    for w, am in zip(weights, ams))
        log_priors = np.log(prior).astype(np.float32)
    return AmNnet(ams[0].config, model, log_priors, device=ams[0].device,
                  ivector_dim=ams[0].ivector_dim)


# ---------------------------------------------------------------------------
# model combination (reference nnet3-combine)
# ---------------------------------------------------------------------------

def adam_minimise(objf: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                  num_steps: int, lr: float) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`num_steps` steps of plain Adam (optax.adam(lr): b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected) on objf from x0.
    Returns the final point and the objective before each step (0-d
    tensors, no synchronise)."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    losses = []
    for i in range(num_steps):
        xg = x.detach().requires_grad_()
        loss = objf(xg)
        (g,) = torch.autograd.grad(loss, xg)
        losses.append(loss.detach())
        with torch.no_grad():
            mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
            c1 = float(np.float32(1 - np.float32(ADAM_B1) ** np.float32(i + 1)))
            c2 = float(np.float32(1 - np.float32(ADAM_B2) ** np.float32(i + 1)))
            x = x - lr * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))
    return x, losses


def stacked_state(models: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """Every parameter and batch-norm statistic of models with one config,
    stacked on a new first axis [M, ...]."""
    states = [m.state_dict() for m in models]
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def combined_state(w: torch.Tensor, stacked: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Σ_m w_m · tensor_m for every stacked tensor."""
    return {k: torch.tensordot(w, s, dims=1) for k, s in stacked.items()}


def combine_weights(model: torch.nn.Module, stacked: Dict[str, torch.Tensor],
                    objective: Callable[[torch.nn.Module, Dict[str, torch.Tensor]],
                                        torch.Tensor],
                    num_steps: int, lr: float, report: Optional[dict] = None
                    ) -> torch.Tensor:
    """The combination search shared by combine_models and
    combine_chain_models: one weight per model, softmax of log-weights
    from 0, minimised by `num_steps` of Adam on `objective(model, tensors)`
    evaluated with the combined tensors through torch.func.functional_call
    (eval mode: batch-norm from the combined running statistics).  report:
    receives `weights`, `objf_by_step` (before each step), `objf_uniform`
    and `objf_final` (at the final weights)."""
    n = next(iter(stacked.values())).shape[0]

    def objf(logw):
        return objective(model, combined_state(torch.softmax(logw, 0), stacked))

    logw0 = torch.zeros(n, dtype=torch.float32, device=next(iter(stacked.values())).device)
    logw, losses = adam_minimise(objf, logw0, num_steps, lr)
    w = torch.softmax(logw, 0)
    if report is not None:
        with torch.no_grad():
            final = objf(logw)
        report.update(weights=w.cpu().numpy().tolist(),
                      objf_by_step=torch.stack(losses).cpu().numpy().tolist(),
                      objf_uniform=float(losses[0]) if losses else float(final),
                      objf_final=float(final))
    return w.detach()


def combine_models(ams: Sequence[AmNnet], feats: Dict[str, np.ndarray],
                   pdf_labels: Dict[str, np.ndarray], num_steps: int = 60, lr: float = 0.3,
                   max_utts: int = 64, report: Optional[dict] = None) -> AmNnet:
    """Optimised model combination (reference nnet3-combine; the JAX
    package's one weight per model): the softmax weights that minimise the
    masked CE of the first `max_utts` utterances (sorted) that have labels,
    found by 60 steps of plain Adam, then the weighted sum of the models'
    parameters and batch-norm statistics; the priors are the first model's.
    On the first model's device.  report: combine_weights'."""
    if len(ams) == 1:
        return ams[0]
    dev = ams[0].device
    keys = [k for k in sorted(feats) if k in pdf_labels][:max_utts]
    keys, x, nf = pad_feature_batch(feats, keys=keys)
    T = x.shape[1]
    y = np.zeros((len(keys), T), np.int64)
    m = np.zeros((len(keys), T), np.float32)
    for i, k in enumerate(keys):
        t = min(int(nf[i]), len(pdf_labels[k]))
        y[i, :t] = pdf_labels[k][:t]
        m[i, :t] = 1.0
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, m))
    model = copy.deepcopy(ams[0].model).eval()
    stacked = stacked_state([am.model for am in ams])

    def objective(mdl, tensors):
        logits = torch.func.functional_call(mdl, tensors, (xt,))
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, yt[..., None])[..., 0]
        return -(ll * mt).sum() / torch.clamp(mt.sum(), min=1.0)

    rep = {} if report is None else report
    w = combine_weights(model, stacked, objective, num_steps, lr, rep)
    log.info("combine_models: %d models, CE %.4f → %.4f, weights %s", len(ams),
             rep["objf_uniform"], rep["objf_final"], np.round(rep["weights"], 3))
    with torch.no_grad():
        model.load_state_dict(combined_state(w, stacked))
    priors = ams[0].log_priors
    return AmNnet(ams[0].config, model, None if priors is None else priors.cpu().numpy(),
                  device=dev, ivector_dim=ams[0].ivector_dim)
