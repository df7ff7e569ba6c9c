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
The natural-gradient optimizers (`ng-sgd`, `ng-sgd-act`) and
`combine_models` are not ported yet; an optimizer the port lacks raises.
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
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
    optimizer: str = "adam"  # adam | sgd
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
    (`count`: updates made; `mu`, `nu`: Adam's moments; `trace`: SGD's
    momentum), which `update` returns anew, so a caller can keep or drop
    it (backstitch's two updates, a rewound epoch)."""

    def __init__(self, opts: NnetTrainOptions, num_steps: int,
                 lr_factors: Optional[Dict[str, float]] = None):
        if opts.optimizer not in ("adam", "sgd"):
            raise ValueError(
                f"optimizer {opts.optimizer!r} is not ported (adam, sgd); the "
                "natural-gradient optimizers come with models/natural_gradient.py")
        self.opts = opts
        self.lr = linear_schedule(opts.initial_lr, opts.final_lr, max(num_steps, 1))
        self.lr_factors = dict(lr_factors or {})

    def init(self, params: Params) -> dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        state = {"count": 0}
        if self.opts.optimizer == "adam":
            state.update(mu=zeros(), nu=zeros())
        elif self.opts.momentum > 0:
            state["trace"] = zeros()
        return state

    def _factor(self, name: str) -> float:
        f = 1.0
        for pat, v in self.lr_factors.items():
            if fnmatch.fnmatch(name, pat):
                f = float(v)
        return f

    def update(self, grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        """(updates to add to the params, the new state)."""
        o = self.opts
        count = state["count"]
        u = {k: g + o.l2_regularize * params[k] for k, g in grads.items()}
        new = {"count": count + 1}
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
        return clip_max_change(u, o.max_param_change, o.max_change_per_component), new


def _norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors) + NORM_FLOOR)


def clip_max_change(updates: Params, global_max: float, per_component_max: float) -> Params:
    """Kaldi's max-change on the final update: each top-level module's
    update scaled to at most `per_component_max` in l2, then the whole to
    at most `global_max` (on the device, without a synchronise)."""
    groups: Dict[str, List[str]] = {}
    for k in updates:
        groups.setdefault(top_level(k), []).append(k)
    out = {}
    for names in groups.values():
        scale = torch.clamp(per_component_max / _norm([updates[k] for k in names]), max=1.0)
        out.update({k: updates[k] * scale for k in names})
    scale = torch.clamp(global_max / _norm(list(out.values())), max=1.0)
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
                 opt_state: dict, scale: float) -> Tuple[dict, torch.Tensor, dict]:
    """One gradient of `loss_fn()` → (loss, metrics) at the model's
    parameters, one optimizer update, params += scale · update.  Returns
    (new optimizer state, loss, metrics)."""
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    with torch.no_grad():
        updates, new_state = optimizer.update(grads, opt_state, params)
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


def make_ce_train_step(model: torch.nn.Module, optimizer: NnetOptimizer,
                       backstitch_scale: float = 0.0, backstitch_interval: int = 1
                       ) -> Callable:
    """CE step: (state, feats [B, T, D], labels [B, T], mask [B, T]
    [, lr_scale]) → (state, {"loss", "acc"}), the model's parameters and
    batch-norm statistics updated in place.  lr_scale multiplies the final
    update (the halved-LR retry)."""
    dev = next(model.parameters()).device

    def step(state: TrainState, feats, labels, mask, lr_scale: float = 1.0):
        x = torch.as_tensor(feats, device=dev)
        y = torch.as_tensor(labels, device=dev).long()
        m = torch.as_tensor(mask, device=dev)
        gen = torch.Generator(device=dev).manual_seed(state.step)
        state, loss, metrics = backstitch_step(
            model, lambda: ce_loss(model, x, y, m, gen), optimizer, state, lr_scale,
            backstitch_scale, backstitch_interval)
        return state, {"loss": loss, **metrics}

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
    accepted epoch (`epoch`, `loss`, `acc`, `steps`); timings: the
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
                                 opts.backstitch_interval)
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
                                "acc": float(np.mean(acc_v)), "steps": len(loss_v)})

        state, prev_loss, epoch, retries, lr_scale = check_divergence(
            model, state, snap, mean_loss, prev_loss, epoch, retries, lr_scale,
            opts.max_lr_retries, accept)
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
