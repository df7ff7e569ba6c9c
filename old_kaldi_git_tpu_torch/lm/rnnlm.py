"""Recurrent (LSTMP) word language model and n-best rescoring with it.

Counterpart of old_kaldi_git_tpu/lm/rnnlm.py (reference
src/lm/mikolov-rnnlm-lib.* and the n-best rescoring path of its vintage:
nbest-to-linear, scoring, reranking).  The model is an embedding, one
LSTMP layer (models/recurrent.py) and a softmax layer over the vocabulary,
on one device; training steps over padded sentence batches, and scoring
takes every hypothesis of an n-best list in one forward pass.

Vocabulary ids: 0 = BOS (input side), 1 = EOS (target side and padding),
caller word id w at w + 2.  Every sentence is padded to the longest one of
the set (plus EOS).  The optimizer is optax's
`chain(clip_by_global_norm(5.0), adam(lr))` written on tensors in optax's
order (clip the whole gradient's l2 norm to 5, Adam's moments with bias
correction, × −lr), as models/train.py writes its chain; the per-epoch
permutation is `np.random.default_rng(seed).permutation`, as in the JAX
package, so that both train in lockstep from the same parameters
(`convert.rnnlm_from_jax`).
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.models.recurrent import LstmpLayer, flax_dense_init_
from old_kaldi_git_tpu_torch.models.train import ADAM_B1, ADAM_B2, ADAM_EPS
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import options_dataclass

log = get_logger("rnnlm")

CLIP_NORM = 5.0  # clip_by_global_norm's bound: LSTM gradients explode without it


@options_dataclass
class RnnLmOptions:
    embed_dim: int = 64
    cell_dim: int = 128
    recurrent_dim: int = 32
    num_epochs: int = 10
    batch_size: int = 32
    learning_rate: float = 3e-3
    seed: int = 0


class RnnLmModule(nn.Module):
    """[B, T] int tokens → [B, T, vocab] logits: embed → LSTMP → softmax
    layer (flax names `embed`, `lstm`, `softmax`)."""

    def __init__(self, vocab: int, embed_dim: int, cell_dim: int, recurrent_dim: int):
        super().__init__()
        self.embed = nn.Embedding(vocab, embed_dim)
        self.lstm = LstmpLayer(embed_dim, cell_dim, recurrent_dim)
        self.softmax = nn.Linear(recurrent_dim, vocab)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.softmax(self.lstm(self.embed(tokens)))

    def init_like_flax(self, seed: int) -> None:
        """flax's default initialisers, drawn from a torch generator (not
        flax's numbers): embedding normal with std 1/√embed_dim, dense
        kernels lecun_normal, biases zero."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            w = torch.randn(self.embed.weight.shape, generator=gen)
            self.embed.weight.copy_(w / self.embed.weight.shape[1] ** 0.5)
            for lin in (self.lstm.cell.gates, self.lstm.cell.proj, self.softmax):
                cpu = nn.Linear(lin.in_features, lin.out_features, bias=lin.bias is not None)
                flax_dense_init_(cpu, gen)
                lin.weight.copy_(cpu.weight)
                if lin.bias is not None:
                    lin.bias.copy_(cpu.bias)


def pad_sentences(seqs: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inputs, targets, mask), each [B, T] with T the longest sentence + 1:
    inputs BOS then the words, targets the words then EOS, EOS as padding."""
    T = max(len(s) for s in seqs) + 1
    B = len(seqs)
    inp = np.zeros((B, T), np.int64)
    tgt = np.full((B, T), 1, np.int64)
    mask = np.zeros((B, T), np.float32)
    for b, s in enumerate(seqs):
        ws = [int(w) + 2 for w in s]
        inp[b, 1: 1 + len(ws)] = ws
        tgt[b, : len(ws)] = ws
        tgt[b, len(ws)] = 1
        mask[b, : len(ws) + 1] = 1.0
    return inp, tgt, mask


def token_logprobs(model: RnnLmModule, inp: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """[B, T] natural-log P(target token) under the model."""
    logp = torch.log_softmax(model(inp), dim=-1)
    return torch.gather(logp, 2, tgt[:, :, None])[:, :, 0]


@dataclasses.dataclass
class RnnLm:
    model: RnnLmModule
    opts: RnnLmOptions
    vocab: int  # including BOS / EOS

    @property
    def device(self) -> torch.device:
        return self.model.embed.weight.device

    def logprobs_batch(self, seqs: Sequence[Sequence[int]]) -> np.ndarray:
        """Total natural-log P(sentence) of each word-id sequence (float64
        on the host), in one forward pass on the model's device."""
        if not seqs:
            return np.zeros(0)
        inp, tgt, mask = pad_sentences(seqs)
        dev = self.device
        with torch.no_grad():
            tok = token_logprobs(self.model, torch.from_numpy(inp).to(dev),
                                 torch.from_numpy(tgt).to(dev))
            total = (tok * torch.from_numpy(mask).to(dev)).sum(dim=1)
        return total.cpu().numpy().astype(np.float64)

    def score(self, words: Sequence[int]) -> float:
        """−log P (the graph-cost convention, for rescore_nbest)."""
        return float(-self.logprobs_batch([list(words)])[0])


def make_rnnlm(num_words: int, opts: Optional[RnnLmOptions] = None,
               device: DeviceLike = None) -> RnnLm:
    """A new model over word ids 1..num_words, initialised from opts.seed."""
    opts = opts or RnnLmOptions()
    vocab = num_words + 3
    model = RnnLmModule(vocab, opts.embed_dim, opts.cell_dim, opts.recurrent_dim)
    model.init_like_flax(opts.seed)
    return RnnLm(model.to(resolve_device(device)), opts, vocab)


def _clip_adam(grads: List[torch.Tensor], state: dict, lr: float) -> List[torch.Tensor]:
    """optax chain(clip_by_global_norm(5), adam(lr)) on a list of gradients:
    the updates to add; `state` (count, mu, nu) is updated in place.  No
    host synchronise: the clip is a tensor select."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < CLIP_NORM
    grads = [torch.where(keep, g, (g / norm) * CLIP_NORM) for g in grads]
    count = state["count"] + 1
    c1 = float(np.float32(1 - np.float32(ADAM_B1) ** np.float32(count)))
    c2 = float(np.float32(1 - np.float32(ADAM_B2) ** np.float32(count)))
    out = []
    for k, g in enumerate(grads):
        state["mu"][k] = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][k]
        state["nu"][k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][k]
        u = (state["mu"][k] / c1) / (torch.sqrt(state["nu"][k] / c2) + ADAM_EPS)
        out.append(-lr * u)
    state["count"] = count
    return out


def train_rnnlm(
    seqs: Sequence[Sequence[int]],
    num_words: int,
    opts: Optional[RnnLmOptions] = None,
    device: DeviceLike = None,
    init: Optional[RnnLm] = None,
    history: Optional[List[Dict]] = None,
) -> RnnLm:
    """Train on word-id sequences (ids in [1, num_words]) on the device.

    init: start from this model's parameters (copied) instead of a draw
    from opts.seed.  history: a list that receives one dict an epoch:
    `loss` (mean of the steps'), `perplexity` (its exp), `step_seconds`
    (each step's host-clock seconds, a device synchronise at each end) and
    `losses`."""
    opts = opts or RnnLmOptions()
    dev = resolve_device(device)
    lm = (RnnLm(RnnLmModule(init.vocab, opts.embed_dim, opts.cell_dim,
                            opts.recurrent_dim), opts, init.vocab)
          if init is not None else make_rnnlm(num_words, opts, "cpu"))
    if init is not None:
        lm.model.load_state_dict(init.model.state_dict())
    lm.model.to(dev)
    model = lm.model
    inp, tgt, mask = (torch.from_numpy(a).to(dev) for a in pad_sentences(seqs))
    params = list(model.parameters())
    state = {"count": 0, "mu": [torch.zeros_like(p) for p in params],
             "nu": [torch.zeros_like(p) for p in params]}
    rng = np.random.default_rng(opts.seed)
    n = len(seqs)
    for epoch in range(opts.num_epochs):
        order = rng.permutation(n)
        losses, seconds = [], []
        for i in range(0, n, opts.batch_size):
            t0 = time.perf_counter()
            sel = torch.from_numpy(order[i: i + opts.batch_size]).to(dev)
            bm = mask[sel]
            tok = token_logprobs(model, inp[sel], tgt[sel])
            loss = -torch.sum(tok * bm) / torch.clamp(torch.sum(bm), min=1.0)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, u in zip(params, _clip_adam(list(grads), state, opts.learning_rate)):
                    p.add_(u)
            losses.append(loss.item())  # the step's end: a device synchronise
            seconds.append(time.perf_counter() - t0)
        ppl = float(np.exp(np.mean(losses)))
        log.info("rnnlm epoch %d: ppl %.2f", epoch, ppl)
        if history is not None:
            history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                            "perplexity": ppl, "losses": losses, "step_seconds": seconds})
    return lm


def rescore_nbest_rnnlm(
    nbest: Sequence[Tuple[List[int], float]],
    rnnlm: RnnLm,
    old_lm_score,
    rnnlm_scale: float = 1.0,
) -> List[Tuple[List[int], float]]:
    """~ the reference's RNNLM n-best rescoring: the old LM score of every
    hypothesis replaced by rnnlm_scale · (−log P_rnn), in one forward pass,
    re-sorted."""
    if not nbest:
        return []
    lps = rnnlm.logprobs_batch([w for w, _ in nbest])
    out = [(words, cost - old_lm_score(words) + rnnlm_scale * float(-lp))
           for (words, cost), lp in zip(nbest, lps)]
    out.sort(key=lambda x: x[1])
    return out


def flax_params(model: RnnLmModule) -> dict:
    """The parameters as the JAX package's flax tree (numpy, kernels
    [in, out])."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return {"embed": {"embedding": sd["embed.weight"]},
            "lstm": {"cell": {"gates": {"kernel": sd["lstm.cell.gates.weight"].T.copy(),
                                        "bias": sd["lstm.cell.gates.bias"]},
                              "proj": {"kernel": sd["lstm.cell.proj.weight"].T.copy()}}},
            "softmax": {"kernel": sd["softmax.weight"].T.copy(), "bias": sd["softmax.bias"]}}


def save_rnnlm(lm: RnnLm, path: str) -> None:
    """A pickle in the JAX package's layout: {"kind", "params" (the flax
    tree), "opts", "vocab"}."""
    with open(path, "wb") as f:
        pickle.dump({"kind": "rnnlm", "params": flax_params(lm.model), "opts": lm.opts,
                     "vocab": lm.vocab}, f)


def load_rnnlm(path: str, device: DeviceLike = None) -> RnnLm:
    """A pickle of save_rnnlm's, or of the JAX package's (read without
    importing it, through convert.StubUnpickler)."""
    from old_kaldi_git_tpu_torch import convert

    d = convert.load_pickle(path)
    fields = convert._fields_of(d["opts"])
    known = {f.name for f in dataclasses.fields(RnnLmOptions)}
    opts = RnnLmOptions(**{k: v for k, v in fields.items() if k in known})
    return convert.rnnlm_from_jax(d["params"], opts, int(d["vocab"]), device)
