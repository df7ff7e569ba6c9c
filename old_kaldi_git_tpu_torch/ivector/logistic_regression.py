"""Multiclass logistic regression (the language-id / speaker-id back end).

Counterpart of old_kaldi_git_tpu/ivector/logistic_regression.py (reference
src/ivector/logistic-regression.{h,cc}): a linear classifier over iVectors
augmented with a trailing 1, trained by full-batch Adam on the
L2-regularised mean log-likelihood, with the reference's mix-up (a class
may own several weight rows, scored by logsumexp over its rows).

The arithmetic is the JAX package's in float64 torch on the device the
caller names, in the same order of work: Adam's moments and steps, then
mix-up's rows drawn from numpy's generator seeded `seed` on the host, then
Adam again.  The model keeps float64 weights on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("logistic")


@dataclasses.dataclass
class LogisticRegressionConfig:
    max_steps: int = 200
    normalizer: float = 0.0025  # L2 regularization weight
    learning_rate: float = 0.2
    mix_up: int = 0  # target total number of weight rows (0 = one per class)
    power: float = 0.15  # occupancy^power row allocation, as the reference


class LogisticRegression:
    """weights [R, D+1] (float64, host); row_to_class [R] maps rows to classes."""

    def __init__(self, weights: np.ndarray, row_to_class: Optional[np.ndarray] = None):
        self.weights = np.asarray(weights, np.float64)
        if row_to_class is None:
            row_to_class = np.arange(self.weights.shape[0])
        self.row_to_class = np.asarray(row_to_class, np.int32)
        if self.weights.ndim != 2 or len(self.row_to_class) != len(self.weights):
            raise KaldiError("LogisticRegression: bad shapes")

    @property
    def num_classes(self) -> int:
        return int(self.row_to_class.max()) + 1

    @property
    def dim(self) -> int:
        return self.weights.shape[1] - 1

    def log_posteriors(self, x, device: DeviceLike = None) -> torch.Tensor:
        """[N, D] (or [D]) → [N, K] float64 log p(class | x) on `device`;
        a class's rows combine by logsumexp (reference GetLogPosteriors)."""
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(x, np.float64)).to(dev)
        if x.ndim == 1:
            x = x[None]
        xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=torch.float64, device=dev)], 1)
        logits = xa @ torch.from_numpy(self.weights).to(dev).T  # [N, R]
        K = self.num_classes
        rows_of = [np.flatnonzero(self.row_to_class == k) for k in range(K)]
        width = max(len(r) for r in rows_of)
        idx = np.zeros((K, width), np.int64)
        valid = np.zeros((K, width), bool)
        for k, r in enumerate(rows_of):
            idx[k, :len(r)] = r
            valid[k, :len(r)] = True
        per = logits[:, torch.from_numpy(idx).to(dev)]  # [N, K, W]
        per = torch.where(torch.from_numpy(valid).to(dev)[None], per, -torch.inf)
        m = per.max(dim=2).values
        out = m + torch.log(torch.exp(per - m[:, :, None]).sum(dim=2))
        out = out - out.max(dim=1, keepdim=True).values
        return out - torch.log(torch.exp(out).sum(dim=1, keepdim=True))

    def classify(self, x, device: DeviceLike = None) -> np.ndarray:
        return self.log_posteriors(x, device).argmax(dim=1).cpu().numpy()

    # -- serialization (the JAX package's bytes) -------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_token(f, "<LogisticRegression>")
            iof.write_matrix(f, self.weights.astype(np.float64), dtype=np.float64)
            iof.write_int_vector(f, self.row_to_class)
            iof.write_token(f, "</LogisticRegression>")

    @staticmethod
    def load(path: str) -> "LogisticRegression":
        with open(path, "rb") as f:
            if not iof.init_kaldi_input_stream(f):
                raise KaldiError("LogisticRegression.load: expected binary")
            iof.expect_token(f, "<LogisticRegression>")
            w = iof.read_matrix(f)
            r2c = iof.read_int_vector(f)
            iof.expect_token(f, "</LogisticRegression>")
            return LogisticRegression(w, r2c)


def objf_and_grad(w: torch.Tensor, row_to_class: torch.Tensor, xa: torch.Tensor,
                  ys: torch.Tensor, normalizer: float):
    """Mean log p(y|x) − normalizer·||w||² (a 0-d tensor) and its gradient
    with respect to w [R, D+1], float64 on w's device."""
    n = xa.shape[0]
    logits = xa @ w.T  # [N, R]
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    post_rows = e / e.sum(dim=1, keepdim=True)
    onehot_rows = (row_to_class[None, :] == ys[:, None]).to(torch.float64)
    p_y = torch.clamp((post_rows * onehot_rows).sum(dim=1), min=1e-300)
    objf = torch.log(p_y).mean() - normalizer * (w * w).sum()
    within = post_rows * onehot_rows / p_y[:, None]
    grad = ((within - post_rows) / n).T @ xa - 2.0 * normalizer * w
    return objf, grad


def train_logistic_regression(xs, ys: Sequence[int],
                              config: Optional[LogisticRegressionConfig] = None,
                              seed: int = 0, device: DeviceLike = None) -> LogisticRegression:
    """Full-batch training on `device` (reference LogisticRegression::Train);
    with config.mix_up above the class count, the classes get extra rows
    split from their trained ones (reference MixUp) and training goes on."""
    cfg = config or LogisticRegressionConfig()
    dev = resolve_device(device)
    xs = np.asarray(xs, np.float64)
    ys_h = np.asarray(ys, np.int64)
    K = int(ys_h.max()) + 1
    xa = torch.from_numpy(np.concatenate([xs, np.ones((len(xs), 1))], axis=1)).to(dev)
    y = torch.from_numpy(ys_h).to(dev)
    row_to_class = np.arange(K)
    w = _adam(torch.zeros((K, xs.shape[1] + 1), dtype=torch.float64, device=dev),
              torch.from_numpy(row_to_class).to(dev), xa, y, cfg)
    if cfg.mix_up > K:
        w_h, row_to_class = _mix_up(w.cpu().numpy(), row_to_class, ys_h, cfg, seed)
        w = _adam(torch.from_numpy(w_h).to(dev),
                  torch.from_numpy(row_to_class.astype(np.int64)).to(dev), xa, y, cfg)
    return LogisticRegression(w.cpu().numpy(), row_to_class)


def _adam(w: torch.Tensor, row_to_class: torch.Tensor, xa: torch.Tensor, ys: torch.Tensor,
          cfg: LogisticRegressionConfig) -> torch.Tensor:
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    b1, b2, eps = 0.9, 0.999, 1e-8
    objf = None
    for t in range(1, cfg.max_steps + 1):
        objf, g = objf_and_grad(w, row_to_class, xa, ys, cfg.normalizer)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        w = w + cfg.learning_rate * mh / (torch.sqrt(vh) + eps)
        if t % 50 == 0 or t == cfg.max_steps:
            log.info("logistic step %d: objf %.5f", t, float(objf))
    if objf is not None:
        log.info("logistic training done: objf %.5f", float(objf))
    return w


def _mix_up(w: np.ndarray, row_to_class: np.ndarray, ys: np.ndarray,
            cfg: LogisticRegressionConfig, seed: int):
    """Extra rows ∝ count^power (reference GetSplitTargets), host numpy."""
    rng = np.random.default_rng(seed)
    K = int(row_to_class.max()) + 1
    counts = np.bincount(ys, minlength=K).astype(np.float64)
    targets = np.maximum(counts ** cfg.power, 1.0)
    targets = np.maximum(np.round(targets * cfg.mix_up / targets.sum()).astype(int), 1)
    rows: List[np.ndarray] = []
    r2c: List[int] = []
    for k in range(K):
        base = w[row_to_class == k]
        for j in range(targets[k]):
            src = base[j % len(base)]
            noise = 1e-4 * rng.standard_normal(src.shape) if j >= len(base) else 0.0
            rows.append(src + noise)
            r2c.append(k)
    log.info("mix_up: %d classes -> %d rows", K, len(rows))
    return np.stack(rows), np.asarray(r2c, np.int32)
