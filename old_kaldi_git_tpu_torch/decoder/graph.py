"""Decoding graphs and per-utterance training graphs, straight to CSR form.

Counterpart of old_kaldi_git_tpu/decoder/graph.py (reference
utils/mkgraph.sh and src/decoder/training-graph-compiler.{h,cc}), on the
native library's handles only (fst/native.py; no Python graph algorithms):

  LG   = minimizeencoded(determinizestar(L_disambig ∘ G, log))
         [+ pushspecial for a decoding graph]
  CLG  = composecontext(LG, N, P)            [+ ilabel_info]
  Ha   = make-h-transducer(ilabel_info, tree, model)
  HCLGa= minimizeencoded(rmepslocal(rmsymbols(determinizestar(Ha ∘ CLG))))
  HCLG = connect(add-self-loops(HCLGa, self_loop_scale))

and the eps-forwarded (folded) CSR export, or with `split_eps` the
split-eps one (the chain graph's: emitting arcs un-duplicated, one backoff
arc a state).  Training graphs run the same pipeline with G = the linear
acceptor over the transcript (optional silence comes from L), with
L_disambig converted to a native handle once per compiler.  `mkgraph` and
`GraphCompiler.compile_graph_from_text` return the HCLG as a VectorFst (the
mkgraph and compile-train-graphs tools write it as OKTFST01), its self-loops
added on the host in float64 as the JAX package's tools add them, so that
the files are byte for byte theirs;
`mkgraph_csr(fst_out=...)` also writes the upstream HCLG.fst (OpenFst
VectorFst<StdArc> bytes) straight from the native arrays, and
`read_hclg_csr` turns an OKTFST01 HCLG file into the decoders' CSR through
the native export, without Python arc objects.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from old_kaldi_git_tpu_torch.decoder.csr import (
    CsrGraph, fst_to_csr_native, fst_to_split_csr_arrays)
from old_kaldi_git_tpu_torch.fst.lang import Lang
from old_kaldi_git_tpu_torch.fst.native import NativeFst
from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst, read_arrays
from old_kaldi_git_tpu_torch.hmm.hmm_utils import add_self_loops, make_h_transducer
from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("graph")


def _hclga_native(lg: NativeFst, lang: Lang, ctx_dep: ContextDependency,
                  tm: TransitionModel, transition_scale: float) -> NativeFst:
    """LG → CLG → HCLGa (no self-loops) on native handles."""
    subseq = max(lang.phones.ids()) + 1
    clg, ilabel_info = lg.compose_context(
        ctx_dep.N, ctx_dep.P, lang.disambig_phone_ids, subseq)
    ha, disambig_tids = make_h_transducer(ilabel_info, ctx_dep, tm, transition_scale)
    hclga = NativeFst.from_vector_fst(ha).compose(clg)
    del clg
    hclga = hclga.determinize_star()
    hclga.rm_symbols(disambig_tids, side="input")
    hclga.remove_eps_local()
    return hclga.minimize_encoded()


def _hclg_native(lg: NativeFst, lang: Lang, ctx_dep: ContextDependency,
                 tm: TransitionModel, transition_scale: float,
                 self_loop_scale: float) -> NativeFst:
    """LG → CLG → HCLG on native handles."""
    hclg = _hclga_native(lg, lang, ctx_dep, tm, transition_scale).add_self_loops(
        tm, self_loop_scale)
    hclg.connect()
    return hclg


def _hclg_vector_fst(lg: NativeFst, lang: Lang, ctx_dep: ContextDependency,
                     tm: TransitionModel, transition_scale: float,
                     self_loop_scale: float) -> VectorFst:
    """LG → HCLGa on native handles, then the self-loops on the host in
    float64 and the trim: the JAX package's HCLG VectorFst, weight for
    weight."""
    hclga = _hclga_native(lg, lang, ctx_dep, tm, transition_scale)
    hclg = add_self_loops(VectorFst.from_arrays(*hclga.to_raw_arrays()), tm,
                          self_loop_scale)
    hclg.connect()
    return hclg


def _hclg_csr(lg: NativeFst, lang: Lang, ctx_dep: ContextDependency,
              tm: TransitionModel, transition_scale: float,
              self_loop_scale: float, tid_to_pdf: np.ndarray,
              split_eps: bool = False,
              timings: Optional[Dict[str, float]] = None,
              fst_out: Optional[str] = None) -> CsrGraph:
    """LG → CLG → HCLG → CsrGraph, folded or split-eps, on native handles.
    A graph whose eps arcs are not backoff-shaped is folded, with a
    warning, as the JAX package does.  fst_out: also write the HCLG there
    as an upstream OpenFst file.  timings: receives `hclg_seconds` and
    `export_seconds` (host clock)."""
    t0 = time.perf_counter()
    hclg = _hclg_native(lg, lang, ctx_dep, tm, transition_scale, self_loop_scale)
    t1 = time.perf_counter()
    # one raw export serves both the file and the split-eps build
    raw = hclg.to_raw_arrays() if (fst_out or split_eps) else None
    if fst_out:
        from old_kaldi_git_tpu_torch.fst.kaldi_fst_io import write_fst_kaldi_arrays

        with open(fst_out, "wb") as fh:
            write_fst_kaldi_arrays(fh, *raw)
        log.info("mkgraph: wrote %s (%d bytes)", fst_out, os.path.getsize(fst_out))
    csr = None
    if split_eps:
        try:
            csr = fst_to_split_csr_arrays(*raw, tid_to_pdf)
        except KaldiError as e:
            log.warning("split-eps export failed (%s); folding", e)
    csr = csr or fst_to_csr_native(hclg, tid_to_pdf)
    if timings is not None:
        timings["hclg_seconds"] = timings.get("hclg_seconds", 0.0) + t1 - t0
        timings["export_seconds"] = (timings.get("export_seconds", 0.0)
                                     + time.perf_counter() - t1)
    return csr


def _lg(lang: Lang, g: VectorFst) -> NativeFst:
    lg = NativeFst.from_vector_fst(lang.L_disambig).compose(NativeFst.from_vector_fst(g))
    lg = lg.determinize_star(use_log=True).minimize_encoded()
    lg.push_special()
    log.info("mkgraph: LG has %d states / %d arcs", lg.num_states, lg.num_arcs)
    return lg


def mkgraph(lang: Lang, g: VectorFst, ctx_dep: ContextDependency,
            tm: TransitionModel, transition_scale: float = 1.0,
            self_loop_scale: float = 0.1) -> VectorFst:
    """The decoding graph HCLG as a VectorFst (the JAX package's mkgraph;
    reference utils/mkgraph.sh), built on native handles."""
    hclg = _hclg_vector_fst(_lg(lang, g), lang, ctx_dep, tm, transition_scale,
                            self_loop_scale)
    log.info("mkgraph: HCLG has %d states / %d arcs", hclg.num_states, hclg.num_arcs)
    return hclg


def mkgraph_csr(lang: Lang, g: VectorFst, ctx_dep: ContextDependency,
                tm: TransitionModel, transition_scale: float = 1.0,
                self_loop_scale: float = 0.1, split_eps: bool = False,
                timings: Optional[Dict[str, float]] = None,
                fst_out: Optional[str] = None) -> CsrGraph:
    """A decoding graph HCLG from a grammar G (reference utils/mkgraph.sh):
    the folded CsrGraph that `decode_batch` takes, or with `split_eps` the
    split-eps one that `decode_batch_tokens` takes (chain graphs:
    self_loop_scale 1.0).  fst_out: also write the HCLG there as an
    upstream OpenFst VectorFst<StdArc> file (reference WriteFstKaldi).
    timings: receives the host-clock seconds of `lg_seconds`,
    `hclg_seconds` (C, H, self-loops) and `export_seconds`."""
    t0 = time.perf_counter()
    lg = _lg(lang, g)
    if timings is not None:
        timings["lg_seconds"] = timings.get("lg_seconds", 0.0) + time.perf_counter() - t0
    csr = _hclg_csr(lg, lang, ctx_dep, tm, transition_scale, self_loop_scale,
                    tm.tid_to_pdf_array(), split_eps, timings, fst_out)
    log.info("mkgraph: HCLG has %d states / %d arcs", csr.num_states, csr.num_arcs)
    return csr


def read_hclg_csr(path: str, tid_to_pdf: np.ndarray) -> CsrGraph:
    """The folded CsrGraph of an OKTFST01 HCLG file: its arrays read in one
    pass and handed to the native eps-forwarding export."""
    with open(path, "rb") as f:
        raw = read_arrays(f)
    return fst_to_csr_native(NativeFst.from_arrays(*raw), tid_to_pdf)


class GraphCompiler:
    """Per-utterance training graphs (reference TrainingGraphCompiler)."""

    def __init__(self, lang: Lang, ctx_dep: ContextDependency, tm: TransitionModel,
                 transition_scale: float = 1.0, self_loop_scale: float = 0.1):
        self.lang = lang
        self.ctx_dep = ctx_dep
        self.tm = tm
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self._l_native = None  # native handle of L_disambig, made once
        self._tid2pdf = tm.tid_to_pdf_array()

    def _word_ids(self, words: Sequence[str]) -> List[int]:
        missing = [w for w in words if w not in self.lang.words]
        if missing:
            raise KaldiError(f"words not in lexicon: {missing}")
        return [self.lang.words[w] for w in words]

    def _lg(self, words: Sequence[str]) -> NativeFst:
        word_ids = self._word_ids(words)
        if self._l_native is None:
            self._l_native = NativeFst.from_vector_fst(self.lang.L_disambig)
        # the linear acceptor over the transcript, straight to arrays
        n = len(word_ids) + 1
        row_ptr = np.minimum(np.arange(n + 1, dtype=np.int32), n - 1)
        lab = np.asarray(word_ids, np.int32)
        finals = np.full(n, np.inf, np.float32)
        finals[n - 1] = 0.0
        g = NativeFst.from_arrays(0, row_ptr, lab, lab, np.zeros(n - 1, np.float32),
                                  np.arange(1, n, dtype=np.int32), finals)
        lg = self._l_native.compose(g)
        return lg.determinize_star(use_log=True).minimize_encoded()

    def compile_csr_from_text(self, words: Sequence[str]) -> CsrGraph:
        """One transcript's training graph as a folded CsrGraph (reference
        TrainingGraphCompiler::CompileGraphFromText)."""
        return _hclg_csr(self._lg(words), self.lang, self.ctx_dep, self.tm,
                         self.transition_scale, self.self_loop_scale, self._tid2pdf)

    def compile_graph_from_text(self, words: Sequence[str]) -> VectorFst:
        """One transcript's training graph as a VectorFst (the
        compile-train-graphs tool's archive cells)."""
        return _hclg_vector_fst(self._lg(words), self.lang, self.ctx_dep, self.tm,
                                self.transition_scale, self.self_loop_scale)

    def compile_csr_graphs(self, transcripts: Sequence[Sequence[str]]) -> List[CsrGraph]:
        return [self.compile_csr_from_text(t) for t in transcripts]
