"""Neural acoustic-model wrapper with priors.

Counterpart of old_kaldi_git_tpu/models/am_nnet.py (reference
src/nnet3/am-nnet-simple.h AmNnetSimple + nnet-am-decodable-simple): holds
the model, its priors and its device; produces pseudo-loglikelihoods
log p(x|pdf) ∝ log softmax(logits) − log prior for the decoder, batched
[B, T, num_pdfs]; float32.  Training (models/train.py) runs the same
modules in train mode; `set_priors_from_posteriors` sets the priors after
it, and `save` writes the port's own format, which `load` reads beside the
JAX package's pickles.  `AmNnetModel` is the nnet3 `final.mdl` bundle: the
transition model beside the network (reference am-nnet-simple.h models are
written behind a TransitionModel), in the port's format or the JAX
package's pickle.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, Optional

import numpy as np
import torch

from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, TdnnLayerSpec, TdnnModel
from old_kaldi_git_tpu_torch.utils import io_funcs as iof

# first bytes of a file `torch.save` writes (a zip archive); the JAX
# package's models are plain pickles
_ZIP_MAGIC = b"PK"
SAVE_FORMAT = "old_kaldi_git_tpu_torch.AmNnet/1"
BUNDLE_FORMAT = "old_kaldi_git_tpu_torch.AmNnetModel/1"

# the TdnnLayerSpec fields that are tuples (saved as lists)
TUPLE_FIELDS = ("offsets", "height_offsets")

# flax's lecun_normal: a normal truncated at ±2σ, σ chosen so that the
# truncated draw has variance 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


class AmNnet:
    def __init__(self, config: TdnnConfig, model: TdnnModel,
                 log_priors: Optional[np.ndarray] = None,
                 device: DeviceLike = None, ivector_dim: int = 0,
                 lr_factors: Optional[Dict[str, float]] = None):
        self.config = config
        # the trailing input dims that carry an online iVector (0 = none)
        self.ivector_dim = ivector_dim
        # per-layer learning-rate factors {top-level name glob: factor}, set
        # by models/edits.apply_edits (nnet3-copy --edits)
        self.lr_factors = lr_factors
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.log_priors = (
            None if log_priors is None
            else torch.from_numpy(np.array(log_priors, np.float32)).to(self.device))

    def _as_input(self, feats) -> torch.Tensor:
        return torch.as_tensor(feats, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def logits(self, feats, output_stride: int = 1) -> torch.Tensor:
        """[B, T, D] → [B, ceil(T/stride), num_pdfs] raw logits;
        output_stride > 1 evaluates only every stride-th frame (reference
        frame-subsampling decode for chain models)."""
        return self.model(self._as_input(feats), output_stride)

    @torch.inference_mode()
    def loglikes_batch(self, feats) -> torch.Tensor:
        """[B, T, D] → [B, T, num_pdfs] pseudo-loglikes (log-softmax − prior),
        a tensor on the model's device."""
        out = torch.log_softmax(self.model(self._as_input(feats)), dim=-1)
        return out if self.log_priors is None else out - self.log_priors

    def loglikes_batch_chunked(self, feats, chunk: int = 150) -> torch.Tensor:
        """loglikes_batch in time chunks of `chunk` frames, each with the
        model's left and right context around it: equal to the whole
        utterance's for finite-context models while bounding activation
        memory (reference DecodableAmNnetSimple --frames-per-chunk).  A model
        with lstmp or blstmp layers (unbounded context) is evaluated whole,
        as in the JAX package."""
        if any(l.kind in ("lstmp", "blstmp") for l in self.config.layers):
            return self.loglikes_batch(feats)
        x = self._as_input(feats)
        T = x.shape[1]
        if T <= chunk:
            return self.loglikes_batch(x)
        lctx, rctx = self.config.left_context, self.config.right_context
        outs = []
        for s0 in range(0, T, chunk):
            e0 = min(s0 + chunk, T)
            lo, hi = max(0, s0 - lctx), min(T, e0 + rctx)
            outs.append(self.loglikes_batch(x[:, lo:hi])[:, s0 - lo: e0 - lo])
        return torch.cat(outs, dim=1)

    def set_priors_from_alignment_counts(self, counts: np.ndarray,
                                         prior_floor_frac: float = 0.01) -> None:
        """Priors from the training data's pdf occupancy (the JAX package's
        set_priors_from_alignment_counts): (counts + 0.5), normalised, floored
        at prior_floor_frac / num_pdfs so that a pdf the alignments never
        visited gets no unbounded pseudo-loglike boost."""
        p = np.asarray(counts, np.float64) + 0.5
        p = np.maximum(p / p.sum(), prior_floor_frac / len(p))
        self.log_priors = torch.from_numpy(np.log(p).astype(np.float32)).to(self.device)

    @torch.inference_mode()
    def set_priors_from_posteriors(self, feats_sample, num_frames=None) -> None:
        """Priors = the model's average posterior over a sample of the
        training data [B, T, D], frames past `num_frames` [B] left out
        (reference nnet3-adjust-priors / ComputePriors); floored at 1e-8
        after normalising, as the JAX package does."""
        post = torch.softmax(self.model(self._as_input(feats_sample)), dim=-1)
        if num_frames is not None:
            nf = torch.as_tensor(np.asarray(num_frames), device=self.device)
            mask = (torch.arange(post.shape[1], device=self.device)[None, :]
                    < nf[:, None]).to(post.dtype)
            post = post * mask[:, :, None]
            denom = mask.sum()
        else:
            denom = post.shape[0] * post.shape[1]
        p = (post.sum(dim=(0, 1)) / denom).double().cpu().numpy()
        p = np.maximum(p / p.sum(), 1e-8)
        self.log_priors = torch.from_numpy(np.log(p).astype(np.float32)).to(self.device)

    def saved(self) -> dict:
        """What `save` writes: plain types and CPU tensors."""
        return {
            "format": SAVE_FORMAT,
            "config": dataclasses.asdict(self.config),
            "state_dict": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "log_priors": None if self.log_priors is None else self.log_priors.cpu(),
            "ivector_dim": self.ivector_dim,
            "lr_factors": None if self.lr_factors is None else dict(self.lr_factors),
        }

    def save(self, path: str) -> None:
        """The port's own format (torch.save of plain types and tensors):
        the config's fields, the weights and batch-norm statistics by name,
        the priors, the iVector dims and the learning-rate factors."""
        torch.save(self.saved(), path)

    @staticmethod
    def init(config: TdnnConfig, seed: int = 0, device: DeviceLike = None,
             log_priors: Optional[np.ndarray] = None) -> "AmNnet":
        """A freshly initialised model (the JAX package's AmNnet.init): every
        affine weight drawn as flax's default (lecun normal, truncated at
        ±2σ) from a torch.Generator seeded with `seed`, biases 0, batch-norm
        statistics mean 0 and variance 1.  The values are not flax's: the
        two generators differ."""
        gen = torch.Generator().manual_seed(seed)
        model = TdnnModel(config)
        with torch.no_grad():
            for module in model.modules():
                if isinstance(module, torch.nn.Linear):
                    std = (1.0 / module.in_features) ** 0.5 / _TRUNCATED_STD
                    torch.nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std,
                                                2 * std, generator=gen)
                    if module.bias is not None:
                        module.bias.zero_()
        return AmNnet(config, model, log_priors, device=device)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "AmNnet":
        """Load a model written by `save`, or one pickled by the JAX
        package's AmNnet.save, without importing that package (see
        convert.py)."""
        with open(path, "rb") as f:
            magic = f.read(len(_ZIP_MAGIC))
        if magic != _ZIP_MAGIC:
            from old_kaldi_git_tpu_torch import convert

            return convert.load_am_nnet(path, device=device)
        return AmNnet.from_saved(torch.load(path, map_location="cpu", weights_only=True),
                                 device, path)

    @staticmethod
    def from_saved(d: dict, device: DeviceLike = None, path: str = "") -> "AmNnet":
        """The model of a `saved()` dict."""
        if d.get("format") != SAVE_FORMAT:
            raise ValueError(f"{path}: not a {SAVE_FORMAT} file")
        fields = dict(d["config"])
        fields["layers"] = tuple(
            TdnnLayerSpec(**{**layer, **{k: tuple(layer[k]) for k in TUPLE_FIELDS
                                         if k in layer}})
            for layer in fields["layers"])
        config = TdnnConfig(**fields)
        model = TdnnModel(config)
        model.load_state_dict(d["state_dict"])
        priors = d["log_priors"]
        return AmNnet(config, model, None if priors is None else priors.numpy(),
                      device=device, ivector_dim=int(d["ivector_dim"]),
                      lr_factors=d.get("lr_factors"))


@dataclasses.dataclass
class AmNnetModel:
    """The nnet3 `final.mdl` bundle: the network with its priors and the
    transition model whose tid → pdf map the decoders need."""

    am: AmNnet
    tm: TransitionModel

    def save(self, path: str) -> None:
        """The port's format: torch.save of AmNnet.saved() and the
        transition model's Kaldi binary bytes."""
        buf = io.BytesIO()
        iof.init_kaldi_output_stream(buf, True)
        self.tm.write(buf)
        torch.save({"format": BUNDLE_FORMAT, "am": self.am.saved(),
                    "tm": buf.getvalue()}, path)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "AmNnetModel":
        """A bundle written by `save`, or the JAX package's pickled
        AmNnetModel (read without importing that package, convert.py)."""
        with open(path, "rb") as f:
            magic = f.read(len(_ZIP_MAGIC))
        if magic != _ZIP_MAGIC:
            from old_kaldi_git_tpu_torch import convert

            d = convert.load_pickle(path)
            if not isinstance(d, dict) or d.get("kind") != "am-nnet-model":
                raise ValueError(f"{path}: not an AmNnetModel bundle")
            am = convert.am_nnet_from_jax(convert._fields_of(d["config"]), d["variables"],
                                          d.get("log_priors"), device=device,
                                          ivector_dim=int(d.get("ivector_dim", 0)))
            return AmNnetModel(am, convert.transition_model_from_pickle(d["tm"]))
        d = torch.load(path, map_location="cpu", weights_only=True)
        if d.get("format") != BUNDLE_FORMAT:
            raise ValueError(f"{path}: not a {BUNDLE_FORMAT} file")
        buf = io.BufferedReader(io.BytesIO(d["tm"]))
        iof.init_kaldi_input_stream(buf)
        return AmNnetModel(AmNnet.from_saved(d["am"], device, path), TransitionModel.read(buf))
