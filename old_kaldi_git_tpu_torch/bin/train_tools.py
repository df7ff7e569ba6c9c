"""Alignment tools of the training pipeline (counterpart of the alignment
part of old_kaldi_git_tpu/bin/train_tools.py; reference src/bin and
src/gmmbin): compile-train-graphs, align-equal-compiled and
gmm-align-compiled.  The alignments run the batched Viterbi scan of
decoder/viterbi.py `align_batch`, whose gathers are the gather kernel's, on
GMM loglikes from the GMM kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import _host_model, _usage, device_option, tool
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("bin")


def _load_tree(path: str):
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    with open(path, "rb") as f:
        return ContextDependency.read(f)


@tool("compile-train-graphs")
def compile_train_graphs_tool(argv: List[str]) -> int:
    """Per-utterance HCLG training graphs → an fst table (reference
    bin/compile-train-graphs.cc), on the native graph library."""
    from old_kaldi_git_tpu_torch.decoder.graph import GraphCompiler
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("compile-train-graphs [options] <tree> <model> <lang-dir> "
                      "<transcript-rspecifier> <graphs-wspecifier>")

    class Opts:
        transition_scale = 1.0
        self_loop_scale = 0.1
        silence_phone = "SIL"

    o = Opts()
    po.register("transition-scale", o, "transition_scale")
    po.register("self-loop-scale", o, "self_loop_scale")
    po.register("silence-phone", o, "silence_phone")
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    compiler = GraphCompiler(load_lang_dir(args[2], silence_phone=o.silence_phone),
                             _load_tree(args[0]), _host_model(args[1]).tm,
                             transition_scale=o.transition_scale,
                             self_loop_scale=o.self_loop_scale)
    n = 0
    with TableWriter(args[4], "fst") as w:
        for key, text in SequentialTableReader(args[3], "text"):
            try:
                w[key] = compiler.compile_graph_from_text(text.split())
                n += 1
            except KaldiError as e:
                log.warning("%s: %s", key, e)
    log.info("compile-train-graphs: %d graphs", n)
    return 0


def batch_align(model, graphs_rspec: str, feats_rspec: str, ali_wspec: str, beam: float,
                acoustic_scale: float, device, zero_acoustics: bool = False) -> int:
    """Align every utterance with both a graph and features, as one padded
    batch (`align_batch`); with zero_acoustics every loglike is 0, so that
    any path through the graph serves (the equal alignment).  model: an
    AmGmmModel or an AmNnetModel on `device`."""
    import torch

    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    graphs = dict(SequentialTableReader(graphs_rspec, "fst"))
    feats = {k: np.asarray(v, np.float32)
             for k, v in SequentialTableReader(feats_rspec, "mat") if k in graphs}
    if not feats:
        raise KaldiError("no utterances with both graph and features")
    tid2pdf = model.tm.tid_to_pdf_array()
    keys, padded, num_frames = pad_feature_batch(feats)
    csr = [fst_to_csr_native(NativeFst.from_arrays(*graphs[k].to_arrays()), tid2pdf)
           for k in keys]
    x = torch.from_numpy(padded).to(device)
    if zero_acoustics:
        loglikes = torch.zeros((len(keys), padded.shape[1], model.am.num_pdfs),
                               dtype=torch.float32, device=device)
    else:
        loglikes = model.am.loglikes_batch(x)
    alis, _ = align_batch(csr, loglikes, num_frames,
                          ViterbiOptions(beam=beam, acoustic_scale=acoustic_scale),
                          device=device)
    ok = 0
    with TableWriter(ali_wspec, "ivec") as w:
        for i, k in enumerate(keys):
            if alis[i] is None:
                log.warning("%s: alignment failed", k)
                continue
            w[k] = np.asarray(alis[i], np.int32)
            ok += 1
    log.info("aligned %d/%d utterances", ok, len(keys))
    return 0 if ok else 1


@tool("align-equal-compiled")
def align_equal_compiled_tool(argv: List[str]) -> int:
    """The initial alignment: Viterbi with zero acoustic scores takes a
    valid path through each graph (reference bin/align-equal-compiled.cc,
    the uniform start of train_mono)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel

    po = ParseOptions("align-equal-compiled <model> <graphs-rspecifier> <feats-rspecifier> "
                      "<ali-wspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    return batch_align(AmGmmModel.load(args[0], device=dev), args[1], args[2], args[3],
                       beam=1e9, acoustic_scale=1.0, device=dev, zero_acoustics=True)


@tool("gmm-align-compiled")
def gmm_align_compiled_tool(argv: List[str]) -> int:
    """Batched Viterbi alignment over per-utterance graphs (reference
    gmmbin/gmm-align-compiled.cc): the whole batch in one scan on the
    device."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel

    po = ParseOptions("gmm-align-compiled [options] <model> <graphs-rspecifier> "
                      "<feats-rspecifier> <ali-wspecifier>")

    class Opts:
        beam = 200.0
        acoustic_scale = 1.0

    o = Opts()
    po.register("beam", o, "beam")
    po.register("acoustic-scale", o, "acoustic_scale")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    return batch_align(AmGmmModel.load(args[0], device=dev), args[1], args[2], args[3],
                       beam=o.beam, acoustic_scale=o.acoustic_scale, device=dev)
