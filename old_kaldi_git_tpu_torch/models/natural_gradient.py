"""Online natural-gradient (NG-SGD) preconditioning.

Counterpart of old_kaldi_git_tpu/models/natural_gradient.py (reference
src/nnet3/natural-gradient-online.{h,cc}, Povey et al. 2014): each affine
component's update is preconditioned on both sides, the input space and the
output-derivative space, by the inverse of an exponentially decayed Fisher
factor smoothed toward the identity (F + α·tr(F)/D·I), then rescaled to the
raw update's Frobenius norm.  Factors are full [D, D] matrices whose
inverses are recomputed every `update_period` updates.

Two estimators, as in the JAX package:

1. `NaturalGradient` (optimizer "ng-sgd"): the factors from the gradient
   itself, F_in ← (1−η)F_in + η·normalised(GᵀG), F_out from G Gᵀ, for every
   2-D parameter; vectors pass through.
2. `NaturalGradientActivations` (optimizer "ng-sgd-act", the reference's
   estimator): F_in from each affine component's input rows with a column
   of ones for the bias, F_out from its output-derivative rows.  The rows
   come from `NgCollector` (hooks on the model's nn.Linear layers: the input
   kept from the forward, the output's gradient from a tensor hook) and
   become factors in `activation_fisher_stats`.

Layout: a flax Dense kernel is [din, dout] and the JAX package computes
P_in G P_out; an nn.Linear weight is [dout, din], so the port computes
P_out G P_in on it (the transpose of the same product), and an affine's
combined matrix is [dout, din + 1], the bias its last column.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn


class FactorState(NamedTuple):
    f_in: torch.Tensor  # [din, din] decayed Fisher-factor estimate
    f_out: torch.Tensor  # [dout, dout]
    p_in: torch.Tensor  # [din, din] the inverse preconditioner in use
    p_out: torch.Tensor  # [dout, dout]


def identity_factors(din: int, dout: int, alpha: float, like: torch.Tensor) -> FactorState:
    eye_in = torch.eye(din, dtype=like.dtype, device=like.device)
    eye_out = torch.eye(dout, dtype=like.dtype, device=like.device)
    return FactorState(eye_in, eye_out, eye_in / (1.0 + alpha), eye_out / (1.0 + alpha))


def _norm_outer(m: torch.Tensor) -> torch.Tensor:
    """m mᵀ scaled to mean diagonal 1."""
    o = m @ m.T
    return o * (m.shape[0] / torch.clamp(torch.trace(o), min=1e-20))


def _inv_smoothed(f: torch.Tensor, alpha: float) -> torch.Tensor:
    d = f.shape[0]
    rho = alpha * torch.trace(f) / d
    return torch.linalg.inv(f + (rho + 1e-8) * torch.eye(d, dtype=f.dtype, device=f.device))


def _apply(g: torch.Tensor, st: FactorState, f_in: torch.Tensor, f_out: torch.Tensor,
           alpha: float, recompute: bool):
    """P_out g P_in for g [dout, din], renormalised to g's Frobenius norm,
    and the new factor state."""
    if recompute:
        p_in, p_out = _inv_smoothed(f_in, alpha), _inv_smoothed(f_out, alpha)
    else:
        p_in, p_out = st.p_in, st.p_out
    g2 = p_out @ g @ p_in
    g2 = g2 * (torch.sqrt(torch.sum(g * g)) / torch.clamp(torch.sqrt(torch.sum(g2 * g2)),
                                                            min=1e-20))
    return g2, FactorState(f_in, f_out, p_in, p_out)


def precondition(g: torch.Tensor, st: FactorState, eta: float, alpha: float,
                 recompute: bool):
    """The gradient-estimated step (the JAX package's `_precondition`) for an
    nn.Linear-oriented g [dout, din]."""
    f_in = (1.0 - eta) * st.f_in + eta * _norm_outer(g.T)
    f_out = (1.0 - eta) * st.f_out + eta * _norm_outer(g)
    return _apply(g, st, f_in, f_out, alpha, recompute)


class NaturalGradient:
    """The "ng-sgd" transform (scale_by_natural_gradient; the reference's
    defaults: 4 minibatches of history, α = 4), on {name: tensor} updates.
    State: {"step": int, "factors": {name: FactorState}} for 2-D tensors."""

    def __init__(self, num_minibatches_history: float = 4.0, alpha: float = 4.0,
                 update_period: int = 4):
        self.eta = 1.0 / float(num_minibatches_history)
        self.alpha = alpha
        self.update_period = update_period

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"step": 0, "factors": {
            k: identity_factors(p.shape[1], p.shape[0], self.alpha, p)
            for k, p in params.items() if p.dim() == 2}}

    def update(self, updates: Dict[str, torch.Tensor], state: dict):
        recompute = state["step"] % self.update_period == 0
        out, factors = dict(updates), {}
        for k, st in state["factors"].items():
            out[k], factors[k] = precondition(updates[k], st, self.eta, self.alpha, recompute)
        return out, {"step": state["step"] + 1, "factors": factors}


def affine_names(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """{module name: has a bias} of every 2-D `<module>.weight`."""
    return {k[: -len(".weight")]: f"{k[: -len('.weight')]}.bias" in params
            for k, p in params.items() if k.endswith(".weight") and p.dim() == 2}


class NaturalGradientActivations:
    """The "ng-sgd-act" transform (scale_by_natural_gradient_activations):
    every affine module's combined [dout, din (+1)] update preconditioned by
    the factors that `activation_fisher_stats` made from this step's rows
    (`ng_stats`: {module: {"f_in", "f_out"}}).  Without stats the updates
    and the state pass through, as in the JAX package."""

    def __init__(self, num_minibatches_history: float = 4.0, alpha: float = 4.0,
                 update_period: int = 4):
        self.eta = 1.0 / float(num_minibatches_history)
        self.alpha = alpha
        self.update_period = update_period

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        factors = {}
        for name, has_bias in affine_names(params).items():
            w = params[f"{name}.weight"]
            factors[name] = identity_factors(w.shape[1] + int(has_bias), w.shape[0],
                                             self.alpha, w)
        return {"step": 0, "factors": factors}

    def update(self, updates: Dict[str, torch.Tensor], state: dict,
               ng_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        if ng_stats is None:
            return updates, state
        recompute = state["step"] % self.update_period == 0
        out, factors = dict(updates), dict(state["factors"])
        eta = self.eta
        for name, st in state["factors"].items():
            stats = ng_stats.get(name)
            if stats is None:
                continue
            wk, bk = f"{name}.weight", f"{name}.bias"
            has_bias = bk in updates
            g = (torch.cat([updates[wk], updates[bk][:, None]], dim=1) if has_bias
                 else updates[wk])
            f_in_stat = stats["f_in"]
            if f_in_stat.shape[0] == g.shape[1] + 1:
                # a bias-free affine: the raw rows' factor is the top-left block
                f_in_stat = f_in_stat[:-1, :-1]
            f_in = (1.0 - eta) * st.f_in + eta * f_in_stat
            f_out = (1.0 - eta) * st.f_out + eta * stats["f_out"]
            g2, factors[name] = _apply(g, st, f_in, f_out, self.alpha, recompute)
            if has_bias:
                out[wk], out[bk] = g2[:, :-1], g2[:, -1]
            else:
                out[wk] = g2
        return out, {"step": state["step"] + 1, "factors": factors}


def _factor(rows: torch.Tensor, max_rows: int) -> torch.Tensor:
    """Rows [..., d] strided down to ≤ max_rows, then RᵀR scaled to mean
    diagonal 1 (the stride depends on the shape alone)."""
    r2 = rows.reshape(-1, rows.shape[-1])
    stride = max(1, -(-r2.shape[0] // max_rows))
    sub = r2[::stride].to(torch.float32)
    f = sub.T @ sub
    return f * (f.shape[0] / torch.clamp(torch.trace(f), min=1e-20))


def activation_fisher_stats(inputs: Dict[str, torch.Tensor],
                            out_grads: Dict[str, torch.Tensor],
                            max_rows: int = 2048) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {"f_in": [din+1, din+1], "f_out": [dout, dout]}} from each
    instrumented affine's input rows (a column of ones appended for the
    bias) and its output-derivative rows."""
    out = {}
    for name, x in inputs.items():
        g = out_grads.get(name)
        if g is None:
            continue
        xr = x.reshape(-1, x.shape[-1])
        ones = torch.ones((xr.shape[0], 1), dtype=xr.dtype, device=xr.device)
        out[name] = {"f_in": _factor(torch.cat([xr, ones], dim=1), max_rows),
                     "f_out": _factor(g, max_rows)}
    return out


class NgCollector:
    """The NG instrumentation of a model (the JAX package's `ng_dense`): while
    `active`, every instrumented nn.Linear keeps its input from the forward
    and, through a tensor hook on its output, the gradient of the loss with
    respect to that output.  Each forward overwrites its layer's entries, so nothing grows
    from call to call, and nothing waits on the host."""

    def __init__(self, model: nn.Module):
        self.active = False
        self.inputs: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        # the recurrent and attention layers are not instrumented (their
        # class says `ng_instrumented = False`), as in the JAX package
        skip = [name for name, m in model.named_modules()
                if not getattr(m, "ng_instrumented", True)]
        self._handles = [m.register_forward_hook(self._hook(name))
                         for name, m in model.named_modules()
                         if isinstance(m, nn.Linear)
                         and not any(name.startswith(f"{p}.") for p in skip)]

    def _hook(self, name: str):
        def fwd(module, args, output):
            if not self.active or not output.requires_grad:
                return
            self.inputs[name] = args[0].detach()

            def keep(g):
                self.grads[name] = g
            output.register_hook(keep)
        return fwd

    def stats(self, max_rows: int = 2048) -> Dict[str, Dict[str, torch.Tensor]]:
        """The Fisher statistics of the last forward and backward; the kept
        rows are released."""
        out = activation_fisher_stats(self.inputs, self.grads, max_rows)
        self.inputs, self.grads = {}, {}
        return out

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
