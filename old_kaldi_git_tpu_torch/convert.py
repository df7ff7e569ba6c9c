"""Weights and state carried across from the JAX package's artifacts.

Six things:

* `am_nnet_from_jax`: a flax variable tree (as numpy) → the port's AmNnet,
  every layer kind (tdnn, tdnnf, lstmp, blstmp, pgru, attention, conv).
  flax `Dense.kernel` is [in, out], `nn.Linear.weight` is [out, in];
  `batch_stats/<layer>/batchnorm/{mean,var}` become the layers' buffers.
* a reader for the committed pickles that does NOT import the JAX package:
  an Unpickler whose `find_class` maps every `old_kaldi_git_tpu.*` class to
  a plain stub that keeps the pickled `__dict__`.  `final.am` pickles
  `models.tdnn.TdnnConfig`/`TdnnLayerSpec`; `tree.pkl` pickles
  `(ContextDependency, TransitionModel)`, whose tree becomes the port's
  classes through `context_dependency_from_pickle`.
* GMM models: `am_diag_gmm_from_jax` from per-pdf (weights, means, vars)
  arrays, as the JAX package's DiagGmms hold them; `load_am_gmm_model` reads
  a binary `.mdl` (TransitionModel + AmDiagGmm) with the port's own reader.
* training state: flax parameter trees → the port's parameter names
  (`torch_params_from_flax`), optax's Adam state
  (`optimizer_state_from_jax`), and a `chain.mdl`'s tree, transition model
  and denominator graph (`transition_model_from_pickle`,
  `den_graph_from_pickle`), so a test can start both packages from one
  point.
* the RNNLM: `rnnlm_from_jax`, a flax RnnLmModule tree → the port's RnnLm.
* the nnet1 and nnet2 families: `am_nnet1_from_jax` / `am_nnet2_from_jax`,
  a flax `Dense` tree (`affine<i>`, `final_affine`) → the port's nn.Linear
  layers; an Nnet2Config's fixed-affine bytes become the model's `fixed_w`
  / `fixed_b` buffers.
"""

from __future__ import annotations

import dataclasses
import gzip
import pickle
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.chain.den_graph import DenominatorGraph
from old_kaldi_git_tpu_torch.device import DeviceLike, resolve_device
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
from old_kaldi_git_tpu_torch.hmm.topology import HmmState, HmmTopology
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.models.recurrent import BLSTMP_NAMES
from old_kaldi_git_tpu_torch.models.tdnn import TdnnConfig, TdnnLayerSpec, TdnnModel
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.tree.event_map import (
    ConstantEventMap, EventMap, SplitEventMap, TableEventMap)

JAX_PACKAGE = "old_kaldi_git_tpu"


class _Stub:
    """Stand-in for a class of the JAX package: the unpickler fills its
    `__dict__` with the pickled state and none of the original's code runs."""

    def __repr__(self):
        return f"<stub {type(self).__qualname__} {sorted(self.__dict__)}>"


class StubUnpickler(pickle.Unpickler):
    """Unpickler that never imports the JAX package.  Only numpy, builtins,
    the standard library and the port's own classes (a `tree.pkl` the port's
    system build wrote) resolve normally; anything else is refused."""

    _ALLOWED_ROOTS = ("numpy", "builtins", "collections", "copyreg",
                      "old_kaldi_git_tpu_torch")

    def __init__(self, file):
        super().__init__(file)
        self._stubs: Dict[str, type] = {}

    def find_class(self, module: str, name: str):
        if module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
            key = f"{module}.{name}"
            if key not in self._stubs:
                self._stubs[key] = type(name, (_Stub,), {"__module__": module})
            return self._stubs[key]
        if module.split(".")[0] in self._ALLOWED_ROOTS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def load_pickle(path: str) -> Any:
    """Unpickle one of the committed artifacts with JAX-package classes as
    stubs; a gzip file (`mono_ali.pkl`, `tri_ali.pkl`) is read through gzip."""
    with open(path, "rb") as f:
        gz = f.peek(2)[:2] == b"\x1f\x8b"
    with (gzip.open(path, "rb") if gz else open(path, "rb")) as f:
        return StubUnpickler(f).load()


def _fields_of(obj: Any) -> Dict[str, Any]:
    """Field dict of a config object: a mapping, or a stub's `__dict__`."""
    return dict(obj) if isinstance(obj, Mapping) else dict(vars(obj))


def tdnn_config_from_fields(config_fields: Mapping[str, Any]) -> TdnnConfig:
    """The port's TdnnConfig from the JAX config's fields (layers as objects
    or dicts).  A field the port does not know is dropped; one a config
    pickled before the field existed lacks takes its default."""
    known = {f.name for f in dataclasses.fields(TdnnLayerSpec)}
    layers = []
    for layer in config_fields["layers"]:
        fields = _fields_of(layer)
        spec = {k: v for k, v in fields.items() if k in known}
        for k in ("offsets", "height_offsets"):
            if k in spec:
                spec[k] = tuple(int(o) for o in spec[k])
        layers.append(TdnnLayerSpec(**spec))
    return TdnnConfig(
        input_dim=int(config_fields["input_dim"]),
        num_outputs=int(config_fields["num_outputs"]),
        layers=tuple(layers),
        final_hidden_dim=int(config_fields.get("final_hidden_dim", 0)),
    )


def am_nnet_from_jax(config_fields: Mapping[str, Any],
                     variables: Mapping[str, Any],
                     log_priors: Optional[np.ndarray] = None,
                     device: DeviceLike = None, ivector_dim: int = 0,
                     lr_factors: Optional[Mapping[str, float]] = None) -> AmNnet:
    """The port's AmNnet from a JAX AmNnet's parts: `config_fields` the
    TdnnConfig's fields (layers as objects or dicts), `variables` the flax
    tree {'params': …, 'batch_stats': …} of numpy arrays, `ivector_dim` the
    input dims that carry an online iVector, `lr_factors` its learning-rate
    factors.  Every parameter and statistic
    must fill the port's model exactly (names and shapes)."""
    config = tdnn_config_from_fields(config_fields)
    model = TdnnModel(config)
    named = torch_params_from_flax(variables["params"])
    for layer, stats in variables.get("batch_stats", {}).items():
        for k in ("mean", "var"):
            named[f"{layer}.{k}"] = np.array(stats["batchnorm"][k], np.float32)
    state = model.state_dict()
    missing = sorted(set(state) - set(named))
    extra = sorted(set(named) - set(state))
    if missing or extra:
        raise ValueError(f"flax tree does not fit the model: missing {missing}, "
                         f"unexpected {extra}")
    for k, v in named.items():
        if tuple(state[k].shape) != v.shape:
            raise ValueError(f"{k}: {v.shape} does not fit {tuple(state[k].shape)}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in named.items()})
    return AmNnet(config, model, log_priors, device=device, ivector_dim=ivector_dim,
                  lr_factors=None if lr_factors is None else dict(lr_factors))


def load_am_nnet(path: str, device: DeviceLike = None) -> AmNnet:
    """An `AmNnet.save` pickle of the JAX package → the port's AmNnet, with
    the input dims that carry an online iVector (`ivector_dim`)."""
    d = load_pickle(path)
    return am_nnet_from_jax(_fields_of(d["config"]), d["variables"],
                            d.get("log_priors"), device=device,
                            ivector_dim=int(d.get("ivector_dim", 0)),
                            lr_factors=d.get("lr_factors"))


def _per_tid(tm: Any, column: int) -> np.ndarray:
    """[num_tids+1] int32 map tid → field `column` of its transition state's
    tuple (phone, hmm_state, pdf), entry 0 = -1 (epsilon), from a stub
    TransitionModel's `tuples` and `state2id` (first tid of each
    transition state, 1-based)."""
    state2id = np.asarray(tm.state2id, np.int64)
    values = np.asarray([t[column] for t in tm.tuples], np.int32)
    out = np.full(int(state2id[-1]), -1, np.int32)
    out[1:] = np.repeat(values, np.diff(state2id))
    return out


def tid_to_pdf_from_transition_model(tm: Any) -> np.ndarray:
    """tid → pdf, as hmm/transition_model.py tid_to_pdf_array computes it."""
    return _per_tid(tm, 2)


def tid_to_phone_from_transition_model(tm: Any) -> np.ndarray:
    """tid → phone, as hmm/transition_model.py tid_to_phone_array computes
    it (the streaming decoder's trailing-silence count reads it)."""
    return _per_tid(tm, 0)


def am_diag_gmm_from_jax(pdfs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                         device: DeviceLike = None) -> AmDiagGmm:
    """The port's AmDiagGmm from per-pdf (weights [M], means [M, D],
    vars [M, D]) arrays, the fields of the JAX package's DiagGmms."""
    return AmDiagGmm([DiagGmm(w, m, v) for w, m, v in pdfs], device)


def load_am_gmm_model(path: str, device: DeviceLike = None) -> AmGmmModel:
    """A GMM `.mdl` written by the JAX package (or by Kaldi) → the port's
    AmGmmModel, read without the JAX package."""
    return AmGmmModel.load(path, device)


def _event_map_from_stub(node: Any) -> EventMap:
    """A pickled TableEventMap / SplitEventMap / ConstantEventMap stub (and
    its children) → the port's EventMap classes."""
    kind = type(node).__name__
    if kind == "ConstantEventMap":
        return ConstantEventMap(int(node.answer))
    if kind == "TableEventMap":
        return TableEventMap(int(node.key), {int(v): _event_map_from_stub(c)
                                             for v, c in node.table.items()})
    if kind == "SplitEventMap":
        return SplitEventMap(int(node.key), {int(v) for v in node.yes_set},
                             _event_map_from_stub(node.yes),
                             _event_map_from_stub(node.no))
    raise ValueError(f"not an EventMap stub: {kind}")


def context_dependency_from_pickle(stub: Any) -> ContextDependency:
    """The stub of a pickled ContextDependency (`tree.pkl`'s first item) →
    the port's ContextDependency (one the port pickled passes through)."""
    if isinstance(stub, ContextDependency):
        return stub
    return ContextDependency(int(stub.N), int(stub.P), _event_map_from_stub(stub.root))


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------

def torch_params_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax parameter tree {layer: {sub: {kernel, bias}}} (or {output:
    {kernel, bias}}) → {torch parameter name: float32 array} in nn.Linear's
    orientation: `kernel` [in, out] becomes `weight` [out, in].  A BLSTMP's
    `forward` / `backward` sub-layers are the port's `forward_layer` /
    `backward_layer` (nn.Module keeps `forward` for its method)."""
    out: Dict[str, np.ndarray] = {}
    renamed = {v: k for k, v in BLSTMP_NAMES.items()}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{renamed.get(k, k)}.")
            elif k == "kernel":
                out[f"{prefix}weight"] = np.array(np.asarray(v, np.float32).T)
            else:
                out[f"{prefix}{k}"] = np.array(v, np.float32)

    walk(params, "")
    return out


def optimizer_state_from_jax(opt_state: Any, device: DeviceLike = "cpu") -> Dict[str, Any]:
    """optax's chain state for `make_optimizer` with Adam → the port's
    NnetOptimizer state: the count and Adam's moments by torch name.  The
    Adam count and the schedule's count move together in the JAX package's
    step, so one count stands for both."""
    adam = [s for s in _flatten_states(opt_state) if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state in the optax chain, found {len(adam)}")
    moments = {name: {k: torch.from_numpy(v).to(device)
                      for k, v in torch_params_from_flax(getattr(adam[0], name)).items()}
               for name in ("mu", "nu")}
    return {"count": int(np.asarray(adam[0].count)), **moments}


def _flatten_states(state: Any) -> list:
    if isinstance(state, (tuple, list)) and not hasattr(state, "mu"):
        return [x for s in state for x in _flatten_states(s)]
    return [state]


def transition_model_from_pickle(stub: Any) -> TransitionModel:
    """A pickled TransitionModel stub (its topology, tuples and
    log-probs) → the port's TransitionModel (one the port pickled passes
    through)."""
    if isinstance(stub, TransitionModel):
        return stub
    entries = {int(p): [HmmState(int(st.pdf_class), [(int(n), float(q))
                                                     for n, q in st.transitions])
                        for st in states]
               for p, states in stub.topo._entries.items()}
    return TransitionModel(HmmTopology(entries), [tuple(int(x) for x in t) for t in stub.tuples],
                           np.asarray(stub.log_probs, np.float64), int(stub.num_pdfs))


def den_graph_from_pickle(stub: Any) -> DenominatorGraph:
    """A pickled DenominatorGraph stub → the port's DenominatorGraph."""
    fields = {f.name for f in dataclasses.fields(DenominatorGraph)}
    d = {k: v for k, v in vars(stub).items() if k in fields}
    d["arc_lookup"] = {(int(a), int(b)): int(s) for (a, b), s in stub.arc_lookup.items()}
    return DenominatorGraph(**d)


# ---------------------------------------------------------------------------
# the RNNLM
# ---------------------------------------------------------------------------

def rnnlm_from_jax(params: Mapping[str, Any], opts: Any, vocab: int,
                   device: DeviceLike = None):
    """A flax RnnLmModule parameter tree (numpy) → the port's RnnLm (with
    `opts`, the port's RnnLmOptions, and the vocabulary size with BOS/EOS).
    Names through `torch_params_from_flax`; flax's `embed/embedding` is
    nn.Embedding's `embed.weight`."""
    from old_kaldi_git_tpu_torch.lm.rnnlm import RnnLm, RnnLmModule

    model = RnnLmModule(vocab, opts.embed_dim, opts.cell_dim, opts.recurrent_dim)
    named = torch_params_from_flax(params)
    named["embed.weight"] = named.pop("embed.embedding")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in named.items()})
    return RnnLm(model.to(resolve_device(device)), opts, vocab)


# ---------------------------------------------------------------------------
# nnet1 and nnet2
# ---------------------------------------------------------------------------

def _load_flax_dense(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """A flax Dense tree into `model`'s nn.Linear layers by name; buffers
    (an nnet2 fixed affine) stay as the config made them."""
    named = {k: torch.from_numpy(v) for k, v in torch_params_from_flax(params).items()}
    model.load_state_dict({**model.state_dict(), **named})


def am_nnet1_from_jax(config_fields: Mapping[str, Any], params: Mapping[str, Any],
                      log_priors: Optional[np.ndarray] = None,
                      feat_shift: Optional[np.ndarray] = None,
                      feat_scale: Optional[np.ndarray] = None, device: DeviceLike = None):
    """The JAX package's AmNnet1 (its config's fields, flax params, priors
    and feature transform, as numpy) → the port's AmNnet1."""
    from old_kaldi_git_tpu_torch.models.nnet1 import AmNnet1, Nnet1Config, Nnet1Model

    config = Nnet1Config(**{f.name: config_fields[f.name]
                            for f in dataclasses.fields(Nnet1Config)})
    model = Nnet1Model(config)
    _load_flax_dense(model, params)
    return AmNnet1(config, model, log_priors, feat_shift, feat_scale, device=device)


def am_nnet2_from_jax(config_fields: Mapping[str, Any], params: Mapping[str, Any],
                      log_priors: Optional[np.ndarray] = None, device: DeviceLike = None):
    """The JAX package's AmNnet2 (its config's fields, the fixed affine's
    bytes among them, flax params and priors, as numpy) → the port's
    AmNnet2."""
    from old_kaldi_git_tpu_torch.models.nnet2 import AmNnet2, Nnet2Config, Nnet2Model

    config = Nnet2Config(**{f.name: config_fields[f.name]
                            for f in dataclasses.fields(Nnet2Config)})
    model = Nnet2Model(config)
    _load_flax_dense(model, params)
    return AmNnet2(config, model, log_priors, device=device)
