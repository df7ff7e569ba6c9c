"""nnet1: Karel Veselý's layer-list DNN and its frame-shuffled trainer.

Counterpart of old_kaldi_git_tpu/models/nnet1.py (reference src/nnet/ and
src/nnetbin/): a plain layer list over spliced frames, splice →
[Linear → sigmoid]* → Linear (→ softmax); `train_nnet1_frmshuff`
(nnet-train-frmshuff) runs globally frame-shuffled minibatch SGD with
momentum under the newbob schedule of steps/nnet/train.sh: an epoch is kept
only when the cross-validation loss falls (else the last accepted snapshot
is reloaded), the learning rate halves once the relative CV improvement
drops below `start_halving_impr`, and training stops when it drops below
`end_halving_impr` while halving.  Losses Xent and Mse (nnet-loss.h).

The saved "feature_transform" is the global CMVN of the spliced frames,
applied before the network; priors from the label counts make
pseudo-loglikes for decoding (nnet-forward --class-frame-counts).  The host
work (splicing, CMVN, the permutations) is the JAX package's, in numpy, so
both packages see the same frames in the same order; the steps run on the
model's device, one minibatch at a time from device-resident frames (on
the card each step replays one CUDA graph).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.models.am_nnet import lecun_normal_
from old_kaldi_git_tpu_torch.models.tdnn import splice
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("nnet1")


@dataclasses.dataclass(frozen=True)
class Nnet1Config:
    input_dim: int
    output_dim: int
    hidden_dim: int = 256
    num_hidden_layers: int = 2
    left_context: int = 5
    right_context: int = 5

    @property
    def spliced_dim(self) -> int:
        return self.input_dim * (self.left_context + self.right_context + 1)

    @property
    def offsets(self) -> tuple:
        return tuple(range(-self.left_context, self.right_context + 1))


class Nnet1Model(nn.Module):
    """Layer list over pre-spliced frames [*, spliced_dim] → logits; the
    affines are named as the flax module's (`affine<i>`, `final_affine`)."""

    def __init__(self, config: Nnet1Config):
        super().__init__()
        self.config = config
        dim = config.spliced_dim
        for i in range(config.num_hidden_layers):
            setattr(self, f"affine{i}", nn.Linear(dim, config.hidden_dim))
            dim = config.hidden_dim
        self.final_affine = nn.Linear(dim, config.output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.config.num_hidden_layers):
            x = torch.sigmoid(getattr(self, f"affine{i}")(x))
        return self.final_affine(x)


class AmNnet1:
    """The network, its feature transform (shift, scale over the spliced
    dims, or none) and its log priors (or none), on one device."""

    def __init__(self, config: Nnet1Config, model: Nnet1Model,
                 log_priors: Optional[np.ndarray] = None,
                 feat_shift: Optional[np.ndarray] = None,
                 feat_scale: Optional[np.ndarray] = None, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

        def tensor(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32)).to(self.device)

        self.log_priors = tensor(log_priors)
        self.feat_shift = tensor(feat_shift)
        self.feat_scale = tensor(feat_scale)

    @staticmethod
    def init(config: Nnet1Config, generator: torch.Generator,
             device: DeviceLike = None) -> "AmNnet1":
        """A fresh network, its weights drawn as flax's Dense default from
        `generator` (the values are not flax's: the generators differ)."""
        model = Nnet1Model(config)
        lecun_normal_(model, generator)
        return AmNnet1(config, model, device=device)

    def spliced(self, feats) -> torch.Tensor:
        """[B, T, D] → the network's input [B, T, spliced_dim]: spliced, then
        (x + shift) · scale when the model has its feature transform."""
        x = splice(torch.as_tensor(feats, dtype=torch.float32, device=self.device),
                   self.config.offsets)
        if self.feat_shift is not None:
            x = (x + self.feat_shift) * self.feat_scale
        return x

    @torch.no_grad()
    def loglikes_batch(self, feats) -> torch.Tensor:
        """[B, T, D] → [B, T, P] pseudo-loglikes (nnet-forward role)."""
        logp = torch.log_softmax(self.model(self.spliced(feats)), dim=-1)
        return logp if self.log_priors is None else logp - self.log_priors


def _graphed(step, mom):
    """`step` captured as one CUDA graph (forward, backward and update of a
    minibatch: a few launches a step instead of tens, which the host's
    launch rate bounds), replayed on its fixed input and parameter
    addresses.  The warm-up calls run at −lr = 0 on a real minibatch, so
    they leave the weights as they were; the momentum they gathered is
    zeroed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for v in mom:
            v.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss = step()

    def replay() -> torch.Tensor:
        graph.replay()
        return loss.clone()

    return replay


@options_dataclass
class Nnet1TrainOptions:
    """steps/nnet/train.sh's options (the newbob schedule)."""

    max_epochs: int = 20
    minibatch_size: int = 256
    learn_rate: float = 8e-3  # the recipes' default 0.008
    momentum: float = 0.0
    loss: str = "xent"  # xent | mse
    start_halving_impr: float = 0.01
    end_halving_impr: float = 0.001
    halving_factor: float = 0.5
    cv_fraction: float = 0.1
    seed: int = 777  # the nnet1 scripts' traditional seed


def train_nnet1_frmshuff(am: AmNnet1, feats: Dict[str, np.ndarray],
                         labels: Dict[str, np.ndarray],
                         opts: Optional[Nnet1TrainOptions] = None,
                         history: Optional[List[dict]] = None) -> AmNnet1:
    """nnet-train-frmshuff + newbob on `am`'s device; returns the trained
    model (a copy) with its feature transform and, for xent, priors from the
    label counts.  For loss="mse" `labels` maps to float targets
    [T, output_dim].  history: one dict an epoch (`epoch`, `lr`, `train`,
    `cv`, `rel_impr`, `accepted`, `halving`, `steps`)."""
    opts = opts or Nnet1TrainOptions()
    c = am.config
    dev = am.device
    keys = sorted(k for k in labels if k in feats)
    if not keys:
        raise KaldiError("no labeled utterances")
    xs, ys = [], []
    for k in keys:
        t = min(feats[k].shape[0], len(labels[k]))
        x = torch.from_numpy(np.ascontiguousarray(feats[k][:t], np.float32))
        xs.append(splice(x, c.offsets).numpy())
        ys.append(np.asarray(labels[k][:t]))
    X = np.concatenate(xs, 0)
    Y = np.concatenate(ys, 0)
    # the feature transform: global CMVN over the spliced dims (the nnet1
    # scripts' compute-cmvn-stats on the spliced egs), saved with the model
    if am.feat_shift is None:
        feat_shift = (-X.mean(0)).astype(np.float32)
        feat_scale = (1.0 / np.maximum(X.std(0), 1e-3)).astype(np.float32)
    else:
        feat_shift = am.feat_shift.cpu().numpy()
        feat_scale = am.feat_scale.cpu().numpy()
    X = (X + feat_shift) * feat_scale
    rng = np.random.default_rng(opts.seed)
    perm = rng.permutation(len(X))
    X, Y = X[perm], Y[perm]
    ncv = max(1, int(len(X) * opts.cv_fraction))
    B = opts.minibatch_size
    nb = max(1, (len(X) - ncv) // B)
    xent = opts.loss == "xent"
    ydtype = torch.int64 if xent else torch.float32
    x_cv = torch.from_numpy(np.ascontiguousarray(X[:ncv])).to(dev)
    y_cv = torch.from_numpy(np.ascontiguousarray(Y[:ncv])).to(dev, ydtype)
    x_tr = torch.from_numpy(np.ascontiguousarray(X[ncv:][: nb * B])).to(dev)
    y_tr = torch.from_numpy(np.ascontiguousarray(Y[ncv:][: nb * B])).to(dev, ydtype)
    n_tr = x_tr.shape[0]

    model = Nnet1Model(c).to(dev)
    model.load_state_dict(am.model.state_dict())
    params = list(model.parameters())

    def loss_of(bx, by):
        logits = model(bx)
        if xent:
            return -torch.log_softmax(logits, dim=-1).gather(-1, by[:, None]).mean()
        return 0.5 * ((logits - by) ** 2).sum(-1).mean()

    def cv_loss() -> float:
        with torch.no_grad():
            return float(loss_of(x_cv, y_cv))

    def snapshot():
        return [p.detach().clone() for p in params], [v.clone() for v in mom]

    mom = [torch.zeros_like(p) for p in params]
    neg_lr = torch.zeros((), device=dev)  # −lr, read on the device by the step
    bx = x_tr[:B].clone()  # the minibatch, at fixed addresses
    by = y_tr[:B].clone()

    def step() -> torch.Tensor:
        """One SGD step on (bx, by): v ← m·v + g, p ← p + (−lr)·v; its loss."""
        loss = loss_of(bx, by)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            torch._foreach_mul_(mom, opts.momentum)
            torch._foreach_add_(mom, grads)
            torch._foreach_add_(params, torch._foreach_mul(mom, neg_lr))
        return loss.detach()

    if dev.type == "cuda":
        step = _graphed(step, mom)
    lr = opts.learn_rate
    prev_cv = cv_loss()
    halving = False
    log.info("nnet1: %d train / %d cv frames, initial CV %.4f", n_tr, ncv, prev_cv)
    for epoch in range(opts.max_epochs):
        kept = snapshot()
        order = torch.from_numpy(rng.permutation(n_tr).reshape(nb, B)).to(dev)
        neg_lr.fill_(-lr)
        losses = []
        for s in range(nb):
            torch.index_select(x_tr, 0, order[s], out=bx)
            torch.index_select(y_tr, 0, order[s], out=by)
            losses.append(step())
        tr = float(torch.stack(losses).mean())
        cv = cv_loss()
        rel = (prev_cv - cv) / max(abs(prev_cv), 1e-9)
        accepted = cv < prev_cv
        log.info("nnet1 epoch %d: lr %.2e train %.4f CV %.4f (rel impr %.4f) %s",
                 epoch, lr, tr, cv, rel, "accepted" if accepted else "rejected")
        if accepted:
            prev_cv = cv
        else:  # reload the last accepted network, as train_scheduler.sh does
            with torch.no_grad():
                for dst, src in zip(params + mom, kept[0] + kept[1]):
                    dst.copy_(src)
        if history is not None:
            history.append({"epoch": epoch, "lr": lr, "train": tr, "cv": cv, "rel_impr": rel,
                            "accepted": accepted, "halving": halving or
                            rel < opts.start_halving_impr, "steps": nb})
        if halving or rel < opts.start_halving_impr:
            halving = True
            lr *= opts.halving_factor
        if halving and rel < opts.end_halving_impr and epoch > 0:
            break
    priors = None
    if xent:
        counts = np.bincount(Y, minlength=c.output_dim).astype(np.float64)
        p = np.maximum((counts + 0.5) / (counts.sum() + 0.5 * len(counts)),
                       0.01 / len(counts))
        priors = np.log(p).astype(np.float32)
    return AmNnet1(c, model, priors, feat_shift, feat_scale, device=dev)
