"""nnet3 discriminative sequence training: MMI, sMBR and MPFE.

Counterpart of old_kaldi_git_tpu/models/discriminative.py (reference
src/nnet3/nnet-discriminative-{example,training,diagnostics}.{h,cc},
nnet3-discriminative-train): each minibatch rescores its den lattices'
acoustic costs with the current model, runs the lattice forward-backward on
the host, and backpropagates the per-frame derivative of the objective
through the network.  The same split as the JAX package:

  device: the forward, pseudo-loglikes [B, T, P];
  host:   per utterance, the lattice rescored and its forward-backward →
          dF/dlog p(pdf), grad [B, T, P] (float64 host code over ragged
          arcs, as the reference's CPU lattice code);
  device: the update, whose surrogate loss −Σ grad · log_softmax(logits)
          has exactly the criterion's derivative as its gradient (grad is
          a constant of the parameters); autograd takes it, SGD applies it.

Criteria (the derivative per frame, each summing to 0 over the pdfs):
  mmi:   onehot(numerator pdf) − γ_den (the numerator fixed to the
         alignment, the reference's default);
  smbr / mpfe: the signed accuracy posteriors of
         lat/discriminative.py forward_backward_mpe_variants, tid → pdf.
The network runs in eval mode throughout (batch-norm statistics are not
updated), as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.lat.discriminative import forward_backward_mpe_variants
from old_kaldi_git_tpu_torch.lat.lattice import (
    lattice_arc_posteriors, lattice_state_times, lattice_total_logprob)
from old_kaldi_git_tpu_torch.lat.rescore import rescore_lattice_acoustics
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.train import (
    NnetTrainOptions, TrainState, apply_update, make_optimizer)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("nnet3_discriminative")


@dataclasses.dataclass
class DiscriminativeOptions:
    criterion: str = "smbr"  # smbr | mpfe | mmi
    acoustic_scale: float = 0.1
    num_epochs: int = 2
    minibatch_size: int = 8
    learning_rate: float = 2e-4
    silence_phones: Tuple[int, ...] = ()


def discriminative_grad(tm, loglikes: np.ndarray, num_ali: Sequence[int], den_lat,
                        criterion: str = "smbr", acoustic_scale: float = 0.1,
                        silence_phones: Sequence[int] = ()) -> Tuple[np.ndarray, float]:
    """(dF/dlog p [T, P] float64, objective per frame) of one utterance.
    The den lattice is rescored in place with `loglikes` first (reference
    DiscriminativeComputation).  The MMI objective is (num acoustic
    loglike − den total) / T: the den total carries the lattice's graph
    costs, a constant of the model, so its changes are exact."""
    T, P = loglikes.shape
    lattice_state_times(den_lat)
    rescore_lattice_acoustics(den_lat, loglikes, tm.tid_to_pdf)
    grad = np.zeros((T, P))
    ali = np.asarray(num_ali)[:T]
    pdfs = np.asarray([tm.tid_to_pdf(t) for t in ali])
    if criterion == "mmi":
        post = lattice_arc_posteriors(den_lat, lm_scale=1.0, ac_scale=acoustic_scale)
        times = den_lat.state_time
        for s in range(den_lat.num_states):
            t = times[s]
            for a, p in zip(den_lat.arcs[s], post[s]):
                if a.ilabel and 0 <= t < T and p > 0:
                    grad[t, tm.tid_to_pdf(a.ilabel)] -= p
        grad[np.arange(len(pdfs)), pdfs] += 1.0
        num_ll = acoustic_scale * loglikes[np.arange(len(pdfs)), pdfs].sum()
        den_ll = lattice_total_logprob(den_lat, lm_scale=1.0, ac_scale=acoustic_scale)
        objf = float(num_ll - den_ll) / max(T, 1)
        grad *= acoustic_scale  # dF/dlog p carries the scale
    elif criterion in ("smbr", "mpfe"):
        post, acc = forward_backward_mpe_variants(
            den_lat, tm, ali, criterion=criterion, silence_phones=silence_phones,
            lm_scale=1.0, ac_scale=acoustic_scale)
        for t, frame in enumerate(post):
            if t >= T:
                break
            for tid, w in frame:
                grad[t, tm.tid_to_pdf(tid)] += acoustic_scale * w
        objf = acc / max(T, 1)
    else:
        raise KaldiError(f"bad criterion {criterion!r}")
    return grad, objf


def _log_probs(am: AmNnet, model: torch.nn.Module, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_softmax of the logits, pseudo-loglikes = that − log priors)."""
    logp = torch.log_softmax(model(x), dim=-1)
    return logp, (logp if am.log_priors is None else logp - am.log_priors)


def train_discriminative(am: AmNnet, feats: Dict[str, np.ndarray],
                         num_ali: Dict[str, np.ndarray], den_lats: Dict[str, object], tm,
                         opts: Optional[DiscriminativeOptions] = None,
                         history: Optional[list] = None) -> AmNnet:
    """Sequence-train a copy of `am` on its device; returns the updated
    model (priors kept).  Utterances go in shuffled minibatches (the last
    one short), each padded to the longest utterance of the set, as in the
    JAX package; plain SGD at a constant learning rate.  history: one dict
    an epoch (`epoch`, `objf`, `utterances`)."""
    opts = opts or DiscriminativeOptions()
    keys = sorted(k for k in feats if k in num_ali and k in den_lats)
    if not keys:
        raise KaldiError("no utterances with feats+ali+lattice")
    dev = am.device
    model = copy.deepcopy(am.model).eval()
    steps = max(1, (len(keys) // opts.minibatch_size) * opts.num_epochs)
    optimizer = make_optimizer(NnetTrainOptions(
        num_epochs=opts.num_epochs, minibatch_size=opts.minibatch_size,
        initial_lr=opts.learning_rate, final_lr=opts.learning_rate, optimizer="sgd"), steps)
    state = TrainState(optimizer.init(dict(model.named_parameters())), 0)
    rng = np.random.default_rng(0)
    T_pad = max(len(feats[k]) for k in keys)
    D = feats[keys[0]].shape[1]
    for epoch in range(opts.num_epochs):
        order = list(keys)
        rng.shuffle(order)
        objfs = []
        for lo in range(0, len(order), opts.minibatch_size):
            batch = order[lo:lo + opts.minibatch_size]
            x = np.zeros((len(batch), T_pad, D), np.float32)
            for i, k in enumerate(batch):
                x[i, :len(feats[k])] = feats[k]
            x = torch.from_numpy(x).to(dev)
            with torch.no_grad():
                ll_h = _log_probs(am, model, x)[1].cpu().numpy()
            g = np.zeros(ll_h.shape, np.float32)
            for i, k in enumerate(batch):
                t = len(feats[k])
                gi, objf = discriminative_grad(
                    tm, ll_h[i, :t], num_ali[k], copy.deepcopy(den_lats[k]),
                    criterion=opts.criterion, acoustic_scale=opts.acoustic_scale,
                    silence_phones=opts.silence_phones)
                g[i, :t] = gi
                objfs.append(objf)
            g_dev = torch.from_numpy(g).to(dev)
            surrogate = lambda: (-(g_dev * _log_probs(am, model, x)[0]).sum(), {})  # noqa: E731
            opt, _, _ = apply_update(model, surrogate, optimizer, state.opt_state, 1.0)
            state = TrainState(opt, state.step + 1)
        log.info("discriminative epoch %d (%s): objf %.4f", epoch, opts.criterion,
                 float(np.mean(objfs)))
        if history is not None:
            history.append({"epoch": epoch, "objf": float(np.mean(objfs)),
                            "utterances": len(objfs)})
    priors = None if am.log_priors is None else am.log_priors.cpu().numpy()
    return AmNnet(am.config, model.eval(), priors, device=dev, ivector_dim=am.ivector_dim)


def compute_discriminative_objf(am: AmNnet, feats: Dict[str, np.ndarray],
                                num_ali: Dict[str, np.ndarray], den_lats: Dict[str, object],
                                tm, opts: Optional[DiscriminativeOptions] = None) -> float:
    """The average objective per frame over a data set, each utterance
    scored alone (nnet3-discriminative-compute-objf)."""
    opts = opts or DiscriminativeOptions()
    tot = frames = 0.0
    for k in sorted(feats):
        if k not in num_ali or k not in den_lats:
            continue
        ll = am.loglikes_batch(np.asarray(feats[k], np.float32)[None])[0].cpu().numpy()
        _, objf = discriminative_grad(
            tm, ll, num_ali[k], copy.deepcopy(den_lats[k]), criterion=opts.criterion,
            acoustic_scale=opts.acoustic_scale, silence_phones=opts.silence_phones)
        tot += objf * len(ll)
        frames += len(ll)
    return tot / max(frames, 1.0)
