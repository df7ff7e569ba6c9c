"""The training tools (counterpart of old_kaldi_git_tpu/bin/train_tools.py;
reference src/bin, src/gmmbin, src/featbin): the binaries of train_mono.sh,
train_deltas.sh, train_lda_mllt.sh and train_sat.sh, and the adaptation and
fMPE tools, each a thin wrapper over the port's library with the JAX tool's
options, arguments, exit codes and files.

- Model initialisation and the EM loop: gmm-init-mono, gmm-init-model,
  compile-train-graphs, align-equal-compiled, gmm-align-compiled,
  convert-ali, gmm-acc-stats-ali (every aligned frame of the table in one
  float64 `accumulate_corpus` on the model's device), gmm-sum-accs, gmm-est,
  gmm-mixup, gmm-boost-silence, gmm-compute-likes (the table in one padded
  launch of the GMM kernel).  The alignments run the batched Viterbi scan
  of decoder/viterbi.py `align_batch`, whose gathers are the gather
  kernel's, on GMM loglikes from the GMM kernel.
- Trees: acc-tree-stats, sum-tree-stats, cluster-phones, compile-questions,
  build-tree, build-tree-two-level (host numpy, files byte for byte).
- Posteriors and alignments: ali-to-pdf, ali-to-post, weight-silence-post,
  post-to-pdf-post, post-to-weights.
- LDA, MLLT, fMLLR: acc-lda, est-lda, gmm-acc-mllt, est-mllt,
  gmm-transform-means, gmm-est-fmllr, transform-feats, compose-transforms,
  gmm-post-to-gpost, gmm-est-fmllr-gpost.  The statistics of a table (or of
  each speaker) come from all its posterior entries at once, float64 on the
  model's device; the small solves run where the library runs them.
- Utilities: copy-matrix, copy-vector, copy-int-vector, sum-matrices,
  show-transitions, align-text, make-h-transducer, add-self-loops.
- Basis fMLLR, linear VTLN, regression-tree MLLR / fMLLR (the two
  gmm-decode-faster-regtree tools score through the GMM kernel, an MLLR
  speaker on their adapted model, an fMLLR speaker in float64 on the
  device, then search with decoder/viterbi.py `decode_batch`) and fMPE.

A tool takes --device=cuda|cpu when its library makes tensors on a device;
the others run on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import (
    _host_model, _symbols, _usage, _words_text, device_option, tool)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("bin")


def _load_tree(path: str):
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    with open(path, "rb") as f:
        return ContextDependency.read(f)


# ---------------------------------------------------------------------------
# small array files (the JAX package's token-framed named float64 arrays) and
# table helpers
# ---------------------------------------------------------------------------


def write_arrays(path: str, kind: str, arrays: Dict[str, np.ndarray]) -> None:
    """<kind> n, then per array its name, rank, dims and a float64 matrix of
    its rows, </kind>."""
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    with open(path, "wb") as f:
        iof.init_kaldi_output_stream(f, True)
        iof.write_token(f, f"<{kind}>")
        iof.write_int32(f, len(arrays))
        for name, a in arrays.items():
            a = np.asarray(a, np.float64)
            iof.write_token(f, name)
            iof.write_int32(f, a.ndim)
            for d in a.shape:
                iof.write_int32(f, int(d))
            iof.write_matrix(f, a.reshape(a.shape[0] if a.ndim else 1, -1), dtype=np.float64)
        iof.write_token(f, f"</{kind}>")


def read_arrays(path: str, kind: str) -> Dict[str, np.ndarray]:
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    with open(path, "rb") as f:
        if not iof.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: acc file must be binary")
        iof.expect_token(f, f"<{kind}>")
        out: Dict[str, np.ndarray] = {}
        for _ in range(iof.read_int32(f)):
            name = iof.read_token(f)
            shape = tuple(iof.read_int32(f) for _ in range(iof.read_int32(f)))
            out[name] = iof.read_matrix(f).reshape(shape)
        iof.expect_token(f, f"</{kind}>")
        return out


def _read_ali_table(rspec: str) -> Dict[str, np.ndarray]:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    return {k: np.asarray(v, np.int32) for k, v in SequentialTableReader(rspec, "ivec")}


def _read_mat(path: str) -> np.ndarray:
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    with open(path, "rb") as f:
        iof.init_kaldi_input_stream(f)
        return np.asarray(iof.read_matrix(f), np.float64)


def _write_mat(path: str, m: np.ndarray) -> None:
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    with open(path, "wb") as f:
        iof.init_kaldi_output_stream(f, True)
        iof.write_matrix(f, m, dtype=np.float32)


def _read_questions(path: str):
    if not path:
        return None
    with open(path) as f:
        return [{int(p) for p in ln.split()} for ln in f if ln.split()]


def _spk2utt(path: str, keys) -> Dict[str, List[str]]:
    """spk2utt's speakers in file order, or each utterance its own speaker."""
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    return ({k: v.split() for k, v in _read_map(path).items()} if path
            else {k: [k] for k in keys})


def _post_entries(post, tm):
    """(frame, pdf, weight) arrays of a pdf- or tid-posterior: an id in
    1..num_tids is a tid, mapped to its pdf."""
    num_tids = tm.num_tids
    t2p = tm.tid_to_pdf_array()
    rows, pdfs, ws = [], [], []
    for t, frame in enumerate(post):
        for i, w in frame:
            rows.append(t)
            pdfs.append(int(t2p[i]) if 1 <= i <= num_tids else i)
            ws.append(w)
    return (np.asarray(rows, np.int64), np.asarray(pdfs, np.int64),
            np.asarray(ws, np.float64))


class _Corpus:
    """Every posterior entry of the utterances that have features and
    posteriors, speaker by speaker: x [N, D] float64 (the entry's frame),
    pdf [N], weight [N], utt [N] (the utterance's index: the JAX tools'
    per-utterance call), spk [N] (index into `speakers`)."""

    def __init__(self, tm, feats: Dict[str, np.ndarray], posts, spk2utt):
        xs, pdfs, ws, utts, spks = [], [], [], [], []
        self.speakers: List[str] = []
        n_utt = 0
        for spk, members in spk2utt.items():
            got = False
            for u in members:
                if u not in feats or u not in posts:
                    continue
                x = np.asarray(feats[u], np.float64)
                t, p, w = _post_entries(posts[u], tm)
                xs.append(x[t])
                pdfs.append(p)
                ws.append(w)
                utts.append(np.full(len(t), n_utt, np.int64))
                spks.append(np.full(len(t), len(self.speakers), np.int64))
                self.dim = x.shape[1]
                n_utt += 1
                got = True
            if got:
                self.speakers.append(spk)
        cat = (lambda a, dt: np.concatenate(a) if a else np.zeros(0, dt))  # noqa: E731
        self.x = np.concatenate(xs) if xs else np.zeros((0, 0))
        self.pdf, self.w = cat(pdfs, np.int64), cat(ws, np.float64)
        self.utt, self.spk = cat(utts, np.int64), cat(spks, np.int64)

    def of(self, s: int):
        """(x, pdf, weight, utt) of speaker s's entries."""
        sel = self.spk == s
        return self.x[sel], self.pdf[sel], self.w[sel], self.utt[sel]

    def fmllr_accs(self, am, dev):
        """One FmllrAccs a speaker, all accumulated at once."""
        from old_kaldi_git_tpu_torch.transform.fmllr import FmllrAccs, accumulate_speakers

        accs = [FmllrAccs(self.dim, dev) for _ in self.speakers]
        if accs and len(self.pdf):
            accumulate_speakers(accs, am, self.x, self.pdf, self.spk, self.utt, self.w)
        return accs


def _speaker_corpus(model, feats_rspec: str, post_rspec: str, spk2utt_opt: str) -> _Corpus:
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, SequentialTableReader

    feats = dict(SequentialTableReader(feats_rspec, "mat"))
    return _Corpus(model.tm, feats, RandomAccessTableReader(post_rspec, "post"),
                   _spk2utt(spk2utt_opt, feats))


# ---------------------------------------------------------------------------
# model initialisation (gmm-init-mono, gmm-init-model)
# ---------------------------------------------------------------------------


@tool("gmm-init-mono")
def gmm_init_mono_tool(argv: List[str]) -> int:
    """The flat-start monophone model and tree from the features' global
    mean and variance (reference gmmbin/gmm-init-mono.cc)."""
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel
    from old_kaldi_git_tpu_torch.hmm.topology import HmmTopology
    from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("gmm-init-mono [options] <lang-dir> <feats-rspecifier> <model-out> "
                      "<tree-out>")

    class Opts:
        silence_phone = "SIL"
        num_states = 3
        sil_num_states = 5
        perturb_factor = 0.0

    o = Opts()
    po.register("silence-phone", o, "silence_phone")
    po.register("num-states", o, "num_states")
    po.register("sil-num-states", o, "sil_num_states")
    po.register("perturb-factor", o, "perturb_factor")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    lang = load_lang_dir(args[0], silence_phone=o.silence_phone)
    n = 0
    s = ss = None
    for _, feats in SequentialTableReader(args[1], "mat"):
        x = np.asarray(feats, np.float64)
        s = x.sum(0) if s is None else s + x.sum(0)
        ss = (x ** 2).sum(0) if ss is None else ss + (x ** 2).sum(0)
        n += len(x)
    if not n:
        raise KaldiError("gmm-init-mono: no features")
    glob_mean = s / n
    glob_var = np.maximum(ss / n - glob_mean ** 2, 1e-3)
    phones = lang.real_phone_ids
    topo = HmmTopology.standard(phones, silence_phones=[lang.silence_id],
                                num_states=o.num_states, sil_num_states=o.sil_num_states)
    ctx_dep = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    am = AmDiagGmm.init_mono(ctx_dep.num_pdfs, glob_mean, glob_var, perturb=o.perturb_factor,
                             device="cpu")
    AmGmmModel(TransitionModel.from_context_dependency(ctx_dep, topo), am).save(args[2])
    with open(args[3], "wb") as f:
        ctx_dep.write(f)
    log.info("gmm-init-mono: %d pdfs, dim %d from %d frames", ctx_dep.num_pdfs,
             len(glob_mean), n)
    return 0


@tool("gmm-init-model")
def gmm_init_model_tool(argv: List[str]) -> int:
    """Tree + tree statistics (+ a model for the topology) → one Gaussian a
    leaf (reference gmmbin/gmm-init-model.cc)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import init_am_from_tree_stats
    from old_kaldi_git_tpu_torch.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu_torch.tree.build_tree import read_tree_stats

    po = ParseOptions("gmm-init-model <tree> <tree-stats> <topo-model> <model-out>")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    ctx_dep = _load_tree(args[0])
    with open(args[1], "rb") as f:
        stats = read_tree_stats(f)
    tm = TransitionModel.from_context_dependency(ctx_dep, _host_model(args[2]).tm.topo)
    AmGmmModel(tm, init_am_from_tree_stats(ctx_dep, stats, device="cpu")).save(args[3])
    log.info("gmm-init-model: %d pdfs", ctx_dep.num_pdfs)
    return 0


# ---------------------------------------------------------------------------
# training graphs + alignment
# ---------------------------------------------------------------------------


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


@tool("convert-ali")
def convert_ali_tool(argv: List[str]) -> int:
    """Alignments re-mapped to another model and tree (reference
    bin/convert-ali.cc)."""
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import convert_alignment
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("convert-ali <old-model> <new-model> <new-tree> <ali-rspecifier> "
                      "<ali-wspecifier>")
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    old_tm, new_tm = _host_model(args[0]).tm, _host_model(args[1]).tm
    ctx_dep = _load_tree(args[2])
    n = 0
    with TableWriter(args[4], "ivec") as w:
        for k, ali in _read_ali_table(args[3]).items():
            w[k] = np.asarray(convert_alignment(ali, old_tm, new_tm, ctx_dep), np.int32)
            n += 1
    log.info("convert-ali: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# GMM statistics: accumulate / sum / estimate
# ---------------------------------------------------------------------------


@tool("gmm-acc-stats-ali")
def gmm_acc_stats_ali_tool(argv: List[str]) -> int:
    """GMM and transition statistics from alignments (reference
    gmmbin/gmm-acc-stats-ali.cc): every aligned frame of the table in one
    float64 `accumulate_corpus` call on the model's device; an utterance
    whose alignment and features differ in length is skipped."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm, write_accs
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("gmm-acc-stats-ali <model> <feats-rspecifier> <ali-rspecifier> "
                      "<stats-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    alis = _read_ali_table(args[2])
    trans_stats = np.zeros(model.tm.num_tids + 1)
    mats, tids = [], []
    for k, feats in SequentialTableReader(args[1], "mat"):
        if k not in alis:
            continue
        ali = alis[k]
        if len(ali) != len(feats):
            log.warning("%s: ali length %d != frames %d, skipping", k, len(ali), len(feats))
            continue
        model.tm.accumulate(ali, trans_stats)
        mats.append(np.asarray(feats, np.float32))
        tids.append(ali)
    accs = AccumAmDiagGmm(model.am)
    if mats:
        pdfs = model.tm.tid_to_pdf_array()[np.concatenate(tids)]
        accs.accumulate_corpus(model.am, torch.from_numpy(np.concatenate(mats)).to(dev), pdfs)
    with open(args[3], "wb") as f:
        write_accs(f, accs, trans_stats)
    log.info("gmm-acc-stats-ali: %d utts, %d frames, avg like/frame %.4f", len(mats),
             sum(len(a) for a in tids), accs.tot_like / max(accs.tot_frames, 1.0))
    return 0


@tool("gmm-sum-accs")
def gmm_sum_accs_tool(argv: List[str]) -> int:
    """Sum accumulator files (reference gmmbin/gmm-sum-accs.cc), on the
    host."""
    from old_kaldi_git_tpu_torch.gmm.mle import read_accs, write_accs

    po = ParseOptions("gmm-sum-accs <stats-out> <stats-in1> <stats-in2> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    total = trans_total = None
    for path in args[1:]:
        with open(path, "rb") as f:
            accs, trans = read_accs(f, device="cpu")
        if total is None:
            total, trans_total = accs, trans
        else:
            total.add(accs)
            trans_total += trans
    with open(args[0], "wb") as f:
        write_accs(f, total, trans_total)
    log.info("gmm-sum-accs: summed %d acc files", len(args) - 1)
    return 0


@tool("gmm-est")
def gmm_est_tool(argv: List[str]) -> int:
    """The M-step on the accumulators' device, the transition update and an
    optional mix-up (reference gmmbin/gmm-est.cc)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import (
        MleDiagGmmOptions, mixup, mle_am_diag_gmm_update, read_accs)

    po = ParseOptions("gmm-est [options] <model-in> <stats-in> <model-out>")
    gopts = MleDiagGmmOptions()

    class Opts:
        mix_up = 0
        perturb_factor = 0.01
        transition_floor = 0.01

    o = Opts()
    po.register_dataclass(gopts)
    po.register("mix-up", o, "mix_up")
    po.register("perturb-factor", o, "perturb_factor")
    po.register("transition-floor", o, "transition_floor")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    with open(args[1], "rb") as f:
        accs, trans_stats = read_accs(f, device=dev)
    log.info("gmm-est: avg like/frame %.4f over %.0f frames",
             accs.tot_like / max(accs.tot_frames, 1.0), accs.tot_frames)
    am = mle_am_diag_gmm_update(model.am, accs, gopts)
    model.tm.mle_update(trans_stats, floor=o.transition_floor)
    if o.mix_up > 0:
        am = mixup(am, o.mix_up, occs=accs.pdf_occupancy(), perturb_factor=o.perturb_factor)
    AmGmmModel(model.tm, am).save(args[2])
    return 0


@tool("gmm-mixup")
def gmm_mixup_tool(argv: List[str]) -> int:
    """Split Gaussians up to --mix-up in all (reference gmmbin/gmm-mixup.cc);
    with three arguments the pdfs' occupancies come from an "Occs" array
    file."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import mixup

    po = ParseOptions("gmm-mixup --mix-up=N <model-in> <occs?> <model-out>")

    class Opts:
        mix_up = 0
        perturb_factor = 0.01

    o = Opts()
    po.register("mix-up", o, "mix_up")
    po.register("perturb-factor", o, "perturb_factor")
    args = po.parse(argv)
    if len(args) not in (2, 3):
        return _usage(po)
    model = _host_model(args[0])
    occs = read_arrays(args[1], "Occs")["occs"] if len(args) == 3 else None
    am = mixup(model.am, o.mix_up, occs=occs, perturb_factor=o.perturb_factor)
    AmGmmModel(model.tm, am).save(args[-1])
    return 0


@tool("gmm-boost-silence")
def gmm_boost_silence_tool(argv: List[str]) -> int:
    """Scale the mixture weights of the pdfs of silence phones by --boost
    (reference gmmbin/gmm-boost-silence.cc): log(boost) on their
    likelihoods."""
    import math

    po = ParseOptions("gmm-boost-silence [options] <silence-phones-colon-list> <model-in> "
                      "<model-out>")

    class Opts:
        boost = 1.0

    o = Opts()
    po.register("boost", o, "boost")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    sil = {int(p) for p in args[0].split(":") if p}
    model = _host_model(args[1])
    tm = model.tm
    pdfs = sorted({tm.tid_to_pdf(t) for t in range(1, tm.num_tids + 1)
                   if tm.tid_to_phone(t) in sil})
    for pdf in pdfs:
        model.am.pdfs[pdf].weights = model.am.pdfs[pdf].weights * o.boost
    model.am.invalidate()
    model.save(args[2])
    log.info("gmm-boost-silence: boosted %d pdfs by %.2f (log %.2f)", len(pdfs), o.boost,
             math.log(max(o.boost, 1e-10)))
    return 0


@tool("gmm-compute-likes")
def gmm_compute_likes_tool(argv: List[str]) -> int:
    """Per-frame pdf log-likelihoods (reference gmmbin/gmm-compute-likes.cc):
    the table as one padded batch through the GMM kernel."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("gmm-compute-likes <model> <feats-rspecifier> <likes-wspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    feats = {k: np.asarray(v, np.float32) for k, v in SequentialTableReader(args[1], "mat")}
    keys, padded, num_frames = pad_feature_batch(feats)
    loglikes = model.am.loglikes_batch(torch.from_numpy(padded).to(dev)).cpu().numpy()
    with TableWriter(args[2], "mat") as w:
        for i, k in enumerate(keys):
            w[k] = loglikes[i, : num_frames[i]]
    return 0


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


@tool("acc-tree-stats")
def acc_tree_stats_tool(argv: List[str]) -> int:
    """Phonetic-context statistics for tree building (reference
    bin/acc-tree-stats.cc)."""
    from old_kaldi_git_tpu_torch.tree.build_tree import accumulate_tree_stats, write_tree_stats
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("acc-tree-stats [options] <model> <feats-rspecifier> <ali-rspecifier> "
                      "<tree-stats-out>")

    class Opts:
        context_width = 3
        central_position = 1

    o = Opts()
    po.register("context-width", o, "context_width")
    po.register("central-position", o, "central_position")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    alis = _read_ali_table(args[2])
    stats: Dict[tuple, object] = {}
    n = 0
    for k, feats in SequentialTableReader(args[1], "mat"):
        if k not in alis:
            continue
        accumulate_tree_stats(alis[k], np.asarray(feats), tm, N=o.context_width,
                              P=o.central_position, stats=stats)
        n += 1
    with open(args[3], "wb") as f:
        write_tree_stats(f, stats)
    log.info("acc-tree-stats: %d utts → %d events", n, len(stats))
    return 0


@tool("sum-tree-stats")
def sum_tree_stats_tool(argv: List[str]) -> int:
    """Sum tree-statistics files (reference bin/sum-tree-stats.cc)."""
    from old_kaldi_git_tpu_torch.tree.build_tree import (
        read_tree_stats, sum_tree_stats, write_tree_stats)

    po = ParseOptions("sum-tree-stats <stats-out> <stats-in1> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    total: Dict[tuple, object] = {}
    for path in args[1:]:
        with open(path, "rb") as f:
            sum_tree_stats(total, read_tree_stats(f))
    with open(args[0], "wb") as f:
        write_tree_stats(f, total)
    return 0


@tool("cluster-phones")
def cluster_phones_tool(argv: List[str]) -> int:
    """Questions by agglomerative clustering of the central phones' stats
    (reference bin/cluster-phones.cc): a line of phone ids a question."""
    from old_kaldi_git_tpu_torch.tree.build_tree import (
        cluster_phones_into_questions, read_tree_stats)

    po = ParseOptions("cluster-phones [options] <tree-stats> <phone-list-colon> "
                      "<questions-out>")

    class Opts:
        central_position = 1

    o = Opts()
    po.register("central-position", o, "central_position")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    with open(args[0], "rb") as f:
        stats = read_tree_stats(f)
    phones = [int(p) for p in args[1].split(":") if p]
    questions = cluster_phones_into_questions(stats, phones, P=o.central_position)
    with open(args[2], "w") as f:
        for q in questions:
            f.write(" ".join(str(p) for p in sorted(q)) + "\n")
    log.info("cluster-phones: %d questions", len(questions))
    return 0


@tool("compile-questions")
def compile_questions_tool(argv: List[str]) -> int:
    """Normalise a question set against the model's phones (reference
    bin/compile-questions.cc; build-tree reads the text file): phones
    outside the inventory dropped, duplicates removed, each sorted, and the
    all-phones question appended."""
    po = ParseOptions("compile-questions [options] <topo-model> <questions-in> "
                      "<questions-out>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    inventory = set(_host_model(args[0]).tm.topo.phones)
    seen = set()
    out: List[List[int]] = []
    with open(args[1]) as f:
        for line in f:
            q = sorted({int(p) for p in line.split()} & inventory)
            if q and tuple(q) not in seen:
                seen.add(tuple(q))
                out.append(q)
    allq = sorted(inventory)
    if tuple(allq) not in seen:
        out.append(allq)
    with open(args[2], "w") as f:
        for q in out:
            f.write(" ".join(str(p) for p in q) + "\n")
    log.info("compile-questions: %d questions over %d phones", len(out), len(inventory))
    return 0


def _build_tree_from_args(o, stats_path: str, model_path: str, max_leaves: int):
    from old_kaldi_git_tpu_torch.tree.build_tree import build_tree, read_tree_stats

    with open(stats_path, "rb") as f:
        stats = read_tree_stats(f)
    topo = _host_model(model_path).tm.topo
    phones = topo.phones
    ctx_dep = build_tree(stats, phones, {p: topo.num_pdf_classes(p) for p in phones},
                         N=o.context_width, P=o.central_position,
                         questions=_read_questions(o.questions), max_leaves=max_leaves,
                         thresh=o.thresh)
    return stats, ctx_dep


@tool("build-tree")
def build_tree_tool(argv: List[str]) -> int:
    """Greedy likelihood-gain tree building (reference bin/build-tree.cc):
    the topology from <topo-model>; questions by clustering when no
    --questions file is given."""
    po = ParseOptions("build-tree [options] <tree-stats> <topo-model> <tree-out>")

    class Opts:
        max_leaves = 1000
        thresh = 20.0
        context_width = 3
        central_position = 1
        questions = ""

    o = Opts()
    for name in ("max-leaves", "thresh", "context-width", "central-position", "questions"):
        po.register(name, o, name.replace("-", "_"))
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    _, ctx_dep = _build_tree_from_args(o, args[0], args[1], o.max_leaves)
    with open(args[2], "wb") as f:
        ctx_dep.write(f)
    log.info("build-tree: %d leaves", ctx_dep.num_pdfs)
    return 0


@tool("build-tree-two-level")
def build_tree_two_level_tool(argv: List[str]) -> int:
    """A tree of --max-leaves-second leaves and the clustering of its leaves
    into --max-leaves-first groups by likelihood loss (reference
    bin/build-tree-two-level.cc): writes the tree and the leaf → group
    int vector."""
    from old_kaldi_git_tpu_torch.tree.build_tree import cluster_leaves
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_output_stream, write_int_vector

    po = ParseOptions("build-tree-two-level [options] <tree-stats> <topo-model> <tree-out> "
                      "<mapping-out>")

    class Opts:
        max_leaves_first = 100
        max_leaves_second = 1000
        thresh = 20.0
        context_width = 3
        central_position = 1
        questions = ""

    o = Opts()
    for name in ("max-leaves-first", "max-leaves-second", "thresh", "context-width",
                 "central-position", "questions"):
        po.register(name, o, name.replace("-", "_"))
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    stats, ctx_dep = _build_tree_from_args(o, args[0], args[1], o.max_leaves_second)
    mapping = cluster_leaves(stats, ctx_dep, o.max_leaves_first)
    with open(args[2], "wb") as f:
        ctx_dep.write(f)
    with open(args[3], "wb") as f:
        init_kaldi_output_stream(f, True)
        write_int_vector(f, mapping)
    log.info("build-tree-two-level: %d fine leaves → %d coarse", ctx_dep.num_pdfs,
             max(mapping) + 1)
    return 0


# ---------------------------------------------------------------------------
# posteriors and alignments
# ---------------------------------------------------------------------------


@tool("ali-to-pdf")
def ali_to_pdf_tool(argv: List[str]) -> int:
    """Transition-id alignments → pdf ids (reference bin/ali-to-pdf.cc)."""
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import alignment_to_pdfs
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("ali-to-pdf <model> <ali-rspecifier> <pdf-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    with TableWriter(args[2], "ivec") as w:
        for k, ali in _read_ali_table(args[1]).items():
            w[k] = np.asarray(alignment_to_pdfs(tm, ali), np.int32)
    return 0


@tool("ali-to-post")
def ali_to_post_tool(argv: List[str]) -> int:
    """Alignments → posteriors of weight 1 (reference bin/ali-to-post.cc)."""
    from old_kaldi_git_tpu_torch.hmm.posterior import ali_to_post
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("ali-to-post <ali-rspecifier> <post-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "post") as w:
        for k, ali in _read_ali_table(args[0]).items():
            w[k] = ali_to_post(ali)
    return 0


@tool("weight-silence-post")
def weight_silence_post_tool(argv: List[str]) -> int:
    """Scale the silence phones' posterior entries (reference
    bin/weight-silence-post.cc)."""
    from old_kaldi_git_tpu_torch.hmm.posterior import weight_silence_post
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("weight-silence-post <silence-weight> <silence-phones-colon> <model> "
                      "<post-rspecifier> <post-wspecifier>")
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    weight = float(args[0])
    sil = [int(p) for p in args[1].split(":") if p]
    tm = _host_model(args[2]).tm
    with TableWriter(args[4], "post") as w:
        for k, post in SequentialTableReader(args[3], "post"):
            w[k] = weight_silence_post(post, tm, sil, weight)
    return 0


@tool("post-to-pdf-post")
def post_to_pdf_post_tool(argv: List[str]) -> int:
    """Transition-id posteriors → pdf posteriors (reference
    bin/post-to-pdf-post.cc)."""
    from old_kaldi_git_tpu_torch.hmm.posterior import post_to_pdf_post
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("post-to-pdf-post <model> <post-rspecifier> <post-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    with TableWriter(args[2], "post") as w:
        for k, post in SequentialTableReader(args[1], "post"):
            w[k] = post_to_pdf_post(post, tm)
    return 0


@tool("post-to-weights")
def post_to_weights_tool(argv: List[str]) -> int:
    """Each frame's posterior mass (reference bin/post-to-weights.cc)."""
    from old_kaldi_git_tpu_torch.hmm.posterior import post_to_weights
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("post-to-weights <post-rspecifier> <weights-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "vec") as w:
        for k, post in SequentialTableReader(args[0], "post"):
            w[k] = np.asarray(post_to_weights(post), np.float32)
    return 0


# ---------------------------------------------------------------------------
# LDA / MLLT / fMLLR and their application
# ---------------------------------------------------------------------------


@tool("acc-lda")
def acc_lda_tool(argv: List[str]) -> int:
    """LDA statistics, a class a pdf, from posteriors (reference
    bin/acc-lda.cc): every entry of the table at once on the device."""
    from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate

    po = ParseOptions("acc-lda <model> <feats-rspecifier> <post-rspecifier> <lda-acc-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = _host_model(args[0])
    corpus = _speaker_corpus(model, args[1], args[2], "")
    if not corpus.speakers:
        raise KaldiError("acc-lda: no data")
    acc = LdaEstimate(model.am.num_pdfs, corpus.dim, dev)
    acc.accumulate(corpus.x, corpus.pdf, corpus.w)
    write_arrays(args[3], "LdaAccs", {k: getattr(acc, k).cpu().numpy()
                                      for k in ("counts", "first", "second")})
    return 0


@tool("est-lda")
def est_lda_tool(argv: List[str]) -> int:
    """The LDA transform from summed statistics (reference bin/est-lda.cc),
    on the host."""
    import torch

    from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate

    po = ParseOptions("est-lda [options] <lda-acc1> ... <lda-mat-out>")

    class Opts:
        dim = 40

    o = Opts()
    po.register("dim", o, "dim")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    tot = None
    for path in args[:-1]:
        a = read_arrays(path, "LdaAccs")
        tot = a if tot is None else {k: tot[k] + a[k] for k in tot}
    acc = LdaEstimate(tot["counts"].shape[0], tot["first"].shape[1], "cpu")
    for k in ("counts", "first", "second"):
        setattr(acc, k, torch.from_numpy(np.asarray(tot[k], np.float64)))
    mat = acc.estimate(o.dim)
    _write_mat(args[-1], mat)
    log.info("est-lda: [%d, %d] transform", mat.shape[0], mat.shape[1])
    return 0


@tool("gmm-acc-mllt")
def gmm_acc_mllt_tool(argv: List[str]) -> int:
    """MLLT statistics from posteriors (reference gmmbin/gmm-acc-mllt.cc):
    every entry of the table at once on the model's device."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.mllt import MlltAccs

    po = ParseOptions("gmm-acc-mllt <model> <feats-rspecifier> <post-rspecifier> "
                      "<mllt-acc-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    corpus = _speaker_corpus(model, args[1], args[2], "")
    if not corpus.speakers:
        raise KaldiError("gmm-acc-mllt: no data")
    acc = MlltAccs(corpus.dim, dev)
    acc.accumulate(model.am, corpus.x, corpus.pdf, corpus.w, corpus.utt)
    write_arrays(args[3], "MlltAccs", {"G": acc.G.cpu().numpy(), "beta": np.asarray([acc.beta])})
    return 0


@tool("est-mllt")
def est_mllt_tool(argv: List[str]) -> int:
    """The MLLT rotation from summed statistics (reference bin/est-mllt.cc),
    on the host; compose it with transform-feats / gmm-transform-means."""
    import torch

    from old_kaldi_git_tpu_torch.transform.mllt import MlltAccs, update_mllt

    po = ParseOptions("est-mllt <mllt-acc1> ... <mllt-mat-out>")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    acc = None
    for path in args[:-1]:
        a = read_arrays(path, "MlltAccs")
        if acc is None:
            acc = MlltAccs(a["G"].shape[1], "cpu")
        acc.G += torch.from_numpy(np.asarray(a["G"], np.float64))
        acc.beta += float(a["beta"][0])
    m, objf = update_mllt(acc)
    _write_mat(args[-1], m)
    log.info("est-mllt: objf improvement %.4f", objf)
    return 0


@tool("gmm-transform-means")
def gmm_transform_means_tool(argv: List[str]) -> int:
    """μ ← M μ for every Gaussian (reference gmmbin/gmm-transform-means.cc,
    after est-mllt)."""
    from old_kaldi_git_tpu_torch.transform.mllt import transform_gmm_means

    po = ParseOptions("gmm-transform-means <mat> <model-in> <model-out>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    m = _read_mat(args[0])
    model = _host_model(args[1])
    transform_gmm_means(model.am, m)
    model.save(args[2])
    return 0


@tool("gmm-est-fmllr")
def gmm_est_fmllr_tool(argv: List[str]) -> int:
    """Per-speaker fMLLR transforms from posteriors (reference
    gmmbin/gmm-est-fmllr.cc): every speaker's statistics at once on the
    model's device, then every speaker's solve together."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.fmllr import compute_fmllr_transforms
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("gmm-est-fmllr [options] <model> <feats-rspecifier> <post-rspecifier> "
                      "<transform-wspecifier>")

    class Opts:
        spk2utt = ""
        fmllr_min_count = 500.0

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("fmllr-min-count", o, "fmllr_min_count")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    corpus = _speaker_corpus(model, args[1], args[2], o.spk2utt)
    trans = compute_fmllr_transforms(corpus.fmllr_accs(model.am, dev),
                                     min_count=o.fmllr_min_count)
    n = 0
    with TableWriter(args[3], "mat") as w:
        for spk, t in zip(corpus.speakers, trans):
            if t is not None:
                w[spk] = t.astype(np.float32)
                n += 1
    log.info("gmm-est-fmllr: %d transforms", n)
    return 0


@tool("transform-feats")
def transform_feats_tool(argv: List[str]) -> int:
    """A global or per-speaker linear / affine transform of the features
    (reference featbin/transform-feats.cc), float64 on the host."""
    from old_kaldi_git_tpu_torch.transform.fmllr import apply_affine_transform
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("transform-feats [options] <transform-(file|rspecifier)> "
                      "<feats-rspecifier> <feats-wspecifier>")

    class Opts:
        utt2spk = ""

    o = Opts()
    po.register("utt2spk", o, "utt2spk")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    per_spk = ":" in args[0] and not args[0].endswith(".mat")
    utt2spk = _read_map(o.utt2spk) if o.utt2spk else None
    if per_spk:
        trans = RandomAccessTableReader(args[0], "mat")
    else:
        global_mat = _read_mat(args[0])
    n = 0
    with TableWriter(args[2], "mat") as w:
        for k, feats in SequentialTableReader(args[1], "mat"):
            x = np.asarray(feats, np.float64)
            if per_spk:
                spk = utt2spk[k] if utt2spk and k in utt2spk else k
                if spk not in trans:
                    log.warning("%s: no transform for speaker %s", k, spk)
                    continue
                m = np.asarray(trans[spk], np.float64)
            else:
                m = global_mat
            if m.shape[1] == x.shape[1]:  # linear
                y = x @ m.T
            elif m.shape[1] == x.shape[1] + 1:  # affine
                y = apply_affine_transform(x, m)
            else:
                raise KaldiError(f"{k}: transform {m.shape} vs feats dim {x.shape[1]}")
            w[k] = y.astype(np.float32)
            n += 1
    log.info("transform-feats: %d utterances", n)
    return 0


@tool("compose-transforms")
def compose_transforms_tool(argv: List[str]) -> int:
    """out = A ∘ B for linear or affine A and B, affinity told by the shapes
    (reference featbin/compose-transforms.cc)."""
    po = ParseOptions("compose-transforms <A-file> <B-file> <out-file>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    a, b = _read_mat(args[0]), _read_mat(args[1])
    if a.shape[1] == b.shape[0]:  # A linear (B's bias column, if any, maps through A)
        out = a @ b
    elif a.shape[1] == b.shape[0] + 1:
        lin, bias = a[:, :-1], a[:, -1]
        if b.shape[1] == b.shape[0]:
            out = np.concatenate([lin @ b, bias[:, None]], axis=1)
        else:
            out = np.concatenate([lin @ b[:, :-1], (lin @ b[:, -1] + bias)[:, None]], axis=1)
    else:
        raise KaldiError(f"compose-transforms: incompatible {a.shape} ∘ {b.shape}")
    _write_mat(args[2], out)
    return 0


@tool("gmm-post-to-gpost")
def gmm_post_to_gpost_tool(argv: List[str]) -> int:
    """Transition-id posteriors → per-Gaussian posteriors (reference
    gmmbin/gmm-post-to-gpost.cc), the responsibilities in float64 on the
    model's device."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.hmm.posterior import post_to_gpost
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("gmm-post-to-gpost [options] <model> <feats-rspecifier> "
                      "<post-rspecifier> <gpost-wspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    model = AmGmmModel.load(args[0], device=device())
    posts = RandomAccessTableReader(args[2], "post")
    n = 0
    with TableWriter(args[3], "gpost") as w:
        for utt, feats in SequentialTableReader(args[1], "mat"):
            if utt in posts:
                w[utt] = post_to_gpost(posts[utt], model.tm, model.am, feats)
                n += 1
    log.info("gmm-post-to-gpost: %d utterances", n)
    return 0


@tool("gmm-est-fmllr-gpost")
def gmm_est_fmllr_gpost_tool(argv: List[str]) -> int:
    """Per-speaker fMLLR from Gaussian-level posteriors (reference
    gmmbin/gmm-est-fmllr-gpost.cc)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.fmllr import FmllrAccs, compute_fmllr_transforms
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("gmm-est-fmllr-gpost [options] <model> <feats-rspecifier> "
                      "<gpost-rspecifier> <transform-wspecifier>")

    class Opts:
        spk2utt = ""
        fmllr_min_count = 500.0

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("fmllr-min-count", o, "fmllr_min_count")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    gposts = RandomAccessTableReader(args[2], "gpost")
    feats = dict(SequentialTableReader(args[1], "mat"))
    speakers, accs = [], []
    for spk, utts in _spk2utt(o.spk2utt, feats).items():
        acc = None
        for u in utts:
            if u in feats and u in gposts:
                acc = acc or FmllrAccs(feats[u].shape[1], dev)
                acc.accumulate_gpost(model.am, feats[u], gposts[u])
        if acc is not None:
            speakers.append(spk)
            accs.append(acc)
    n = 0
    with TableWriter(args[3], "mat") as w:
        for spk, t in zip(speakers, compute_fmllr_transforms(accs,
                                                             min_count=o.fmllr_min_count)):
            if t is not None:
                w[spk] = t.astype(np.float32)
                n += 1
    log.info("gmm-est-fmllr-gpost: %d transforms", n)
    return 0


# ---------------------------------------------------------------------------
# matrix / vector utilities and the graph helpers
# ---------------------------------------------------------------------------


def _copy_table(argv: List[str], name: str, holder: str, scaled: bool) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(f"{name} [options] <{holder}-rspecifier> <{holder}-wspecifier>")

    class Opts:
        scale = 1.0

    o = Opts()
    if scaled:
        po.register("scale", o, "scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], holder) as w:
        for k, v in SequentialTableReader(args[0], holder):
            w[k] = np.asarray(v) * o.scale if scaled else np.asarray(v, np.int32)
    return 0


@tool("copy-matrix")
def copy_matrix_tool(argv: List[str]) -> int:
    """Copy a matrix table, optionally scaled (reference bin/copy-matrix.cc)."""
    return _copy_table(argv, "copy-matrix", "mat", True)


@tool("copy-vector")
def copy_vector_tool(argv: List[str]) -> int:
    """Copy a vector table, optionally scaled (reference bin/copy-vector.cc)."""
    return _copy_table(argv, "copy-vector", "vec", True)


@tool("copy-int-vector")
def copy_int_vector_tool(argv: List[str]) -> int:
    """Copy an int-vector table (reference bin/copy-int-vector.cc)."""
    return _copy_table(argv, "copy-int-vector", "ivec", False)


@tool("sum-matrices")
def sum_matrices_tool(argv: List[str]) -> int:
    """Sum matrix files in float64 (reference bin/sum-matrices.cc)."""
    po = ParseOptions("sum-matrices <mat-out> <mat-in1> <mat-in2> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    total = None
    for path in args[1:]:
        m = _read_mat(path)
        total = m if total is None else total + m
    _write_mat(args[0], total)
    return 0


@tool("show-transitions")
def show_transitions_tool(argv: List[str]) -> int:
    """The transition model in text (reference bin/show-transitions.cc)."""
    po = ParseOptions("show-transitions <phones.txt> <model>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    names: Dict[int, str] = {}
    with open(args[0]) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) == 2:
                names[int(parts[1])] = parts[0]
    tm = _host_model(args[1]).tm
    for ts, (phone, hmm_state, pdf) in enumerate(tm.tuples):
        print(f"Transition-state {ts + 1}: phone = {names.get(phone, phone)} "
              f"hmm-state = {hmm_state} pdf = {pdf}")
        for tid in range(tm.state2id[ts], tm.state2id[ts + 1]):
            print(f" Transition-id = {tid} p = {float(np.exp(tm.log_probs[tid])):.2f}")
    return 0


@tool("align-text")
def align_text_tool(argv: List[str]) -> int:
    """Word-aligned ref / hyp pairs, <eps> for a gap (reference
    bin/align-text.cc): the edit-distance table's backtrace, a substitution
    or match first, then a deletion, then an insertion."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("align-text <ref-rspecifier> <hyp-rspecifier> <alignment-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    hyps = dict(SequentialTableReader(args[1], "text"))
    with TableWriter(args[2], "text") as w:
        for k, ref_text in SequentialTableReader(args[0], "text"):
            if k not in hyps:
                continue
            ref, hyp = ref_text.split(), hyps[k].split()
            R, H = len(ref), len(hyp)
            dp = np.zeros((R + 1, H + 1), np.int32)
            dp[:, 0] = np.arange(R + 1)
            dp[0, :] = np.arange(H + 1)
            for i in range(1, R + 1):
                for j in range(1, H + 1):
                    dp[i, j] = min(dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                                   dp[i - 1, j] + 1, dp[i, j - 1] + 1)
            pairs = []
            i, j = R, H
            while i > 0 or j > 0:
                if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
                    pairs.append((ref[i - 1], hyp[j - 1]))
                    i, j = i - 1, j - 1
                elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
                    pairs.append((ref[i - 1], "<eps>"))
                    i -= 1
                else:
                    pairs.append(("<eps>", hyp[j - 1]))
                    j -= 1
            w[k] = " ; ".join(f"{a} {b}" for a, b in reversed(pairs))
    return 0


@tool("make-h-transducer")
def make_h_transducer_tool(argv: List[str]) -> int:
    """Ha from the ilabel-info file (a line of phone-window ids an ilabel),
    the tree and the model (reference bin/make-h-transducer.cc)."""
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import make_h_transducer

    po = ParseOptions("make-h-transducer [options] <ilabel-info-file> <tree> <model> "
                      "<fst-out>")

    class Opts:
        transition_scale = 1.0

    o = Opts()
    po.register("transition-scale", o, "transition_scale")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    with open(args[0]) as f:
        ilabel_info = [[int(x) for x in ln.split()] for ln in f]
    ha, disambig = make_h_transducer(ilabel_info, _load_tree(args[1]), _host_model(args[2]).tm,
                                     transition_scale=o.transition_scale)
    with open(args[3], "wb") as f:
        ha.write(f)
    log.info("make-h-transducer: %d states, %d disambig tids", ha.num_states, len(disambig))
    return 0


@tool("add-self-loops")
def add_self_loops_tool(argv: List[str]) -> int:
    """Self-loops with the (1 − p_self) correction, in float64 on the host
    (reference bin/add-self-loops.cc, mkgraph's last step)."""
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import add_self_loops

    po = ParseOptions("add-self-loops [options] <model> <fst-in> <fst-out>")

    class Opts:
        self_loop_scale = 0.1

    o = Opts()
    po.register("self-loop-scale", o, "self_loop_scale")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    with open(args[1], "rb") as f:
        fst = VectorFst.read(f)
    out = add_self_loops(fst, tm, self_loop_scale=o.self_loop_scale)
    with open(args[2], "wb") as f:
        out.write(f)
    return 0


# ---------------------------------------------------------------------------
# basis fMLLR (reference gmmbin/gmm-basis-fmllr-training.cc,
# gmm-est-basis-fmllr.cc)
# ---------------------------------------------------------------------------


def _speaker_fmllr_accs(model, dev, feats_rspec: str, post_rspec: str, spk2utt: str):
    """{speaker: FmllrAccs} of the speakers with frames."""
    corpus = _speaker_corpus(model, feats_rspec, post_rspec, spk2utt)
    return {spk: acc for spk, acc in zip(corpus.speakers, corpus.fmllr_accs(model.am, dev))
            if acc.beta > 0}


@tool("gmm-basis-fmllr-training")
def gmm_basis_fmllr_training_tool(argv: List[str]) -> int:
    """An fMLLR basis from the training speakers' statistics (reference
    gmmbin/gmm-basis-fmllr-training.cc); exits 1 without any."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.basis_fmllr import estimate_fmllr_basis

    po = ParseOptions("gmm-basis-fmllr-training [options] <model> <feats-rspecifier> "
                      "<post-rspecifier> <basis-out>")

    class Opts:
        spk2utt = ""
        num_bases = 0  # 0 → min(D·(D+1), 200)

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("num-bases", o, "num_bases")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    accs = _speaker_fmllr_accs(AmGmmModel.load(args[0], device=dev), dev, args[1], args[2],
                               o.spk2utt)
    if not accs:
        log.warning("gmm-basis-fmllr-training: no speaker stats")
        return 1
    basis = estimate_fmllr_basis(list(accs.values()), o.num_bases if o.num_bases > 0 else None)
    basis.save(args[3])
    log.info("gmm-basis-fmllr-training: %d bases from %d speakers → %s", basis.num_bases,
             len(accs), args[3])
    return 0


@tool("gmm-est-basis-fmllr")
def gmm_est_basis_fmllr_tool(argv: List[str]) -> int:
    """Per-speaker transforms in a learned basis (reference
    gmmbin/gmm-est-basis-fmllr.cc): far fewer frames than gmm-est-fmllr."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.basis_fmllr import (
        BasisFmllr, compute_fmllr_basis_transform)
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("gmm-est-basis-fmllr [options] <model> <basis-in> <feats-rspecifier> "
                      "<post-rspecifier> <transform-wspecifier>")

    class Opts:
        spk2utt = ""
        size_scale = 0.2
        fmllr_min_count = 10.0
        num_iters = 10

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("size-scale", o, "size_scale")
    po.register("fmllr-min-count", o, "fmllr_min_count")
    po.register("num-iters", o, "num_iters")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    dev = device()
    basis = BasisFmllr.load(args[1])
    accs = _speaker_fmllr_accs(AmGmmModel.load(args[0], device=dev), dev, args[2], args[3],
                               o.spk2utt)
    n = 0
    with TableWriter(args[4], "mat") as w:
        for spk, acc in accs.items():
            res = compute_fmllr_basis_transform(acc, basis, size_scale=o.size_scale,
                                                num_iters=o.num_iters,
                                                min_count=o.fmllr_min_count)
            if res is not None:
                w[spk] = res[0].astype(np.float32)
                n += 1
    log.info("gmm-est-basis-fmllr: %d transforms", n)
    return 0


# ---------------------------------------------------------------------------
# linear VTLN (reference gmmbin/gmm-init-lvtln.cc, gmm-train-lvtln-special.cc,
# gmm-est-lvtln-trans.cc)
# ---------------------------------------------------------------------------


@tool("gmm-init-lvtln")
def gmm_init_lvtln_tool(argv: List[str]) -> int:
    """A LinearVtln of identity transforms at --num-classes warps evenly
    from --min-warp to --max-warp."""
    from old_kaldi_git_tpu_torch.transform.lvtln import LinearVtln

    po = ParseOptions("gmm-init-lvtln [options] <lvtln-out>")

    class Opts:
        dim = 13
        num_classes = 31
        min_warp = 0.85
        max_warp = 1.25

    o = Opts()
    for name in ("dim", "num-classes", "min-warp", "max-warp"):
        po.register(name, o, name.replace("-", "_"))
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    LinearVtln.init(o.dim, np.linspace(o.min_warp, o.max_warp, o.num_classes).tolist()
                    ).save(args[0])
    log.info("gmm-init-lvtln: %d classes, warps %.2f..%.2f, dim %d", o.num_classes,
             o.min_warp, o.max_warp, o.dim)
    return 0


@tool("gmm-train-lvtln-special")
def gmm_train_lvtln_special_tool(argv: List[str]) -> int:
    """Fit one class by least squares from paired (unwarped, warped) feature
    tables, the products on the device."""
    from old_kaldi_git_tpu_torch.transform.lvtln import LinearVtln, train_lvtln_class
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, SequentialTableReader

    po = ParseOptions("gmm-train-lvtln-special [options] <class-index> <lvtln-in> <lvtln-out> "
                      "<feats-unwarped-rspecifier> <feats-warped-rspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    dev = device()
    c = int(args[0])
    lvtln = LinearVtln.load(args[1])
    warped = RandomAccessTableReader(args[4], "mat")
    pairs = [(np.asarray(warped[k]), np.asarray(y)) for k, y in
             SequentialTableReader(args[3], "mat") if k in warped]
    if not pairs:
        raise KaldiError("no paired utterances")
    lvtln.set_transform(c, train_lvtln_class(pairs, dev))
    lvtln.save(args[2])
    log.info("gmm-train-lvtln-special: class %d from %d utterances", c, len(pairs))
    return 0


@tool("gmm-est-lvtln-trans")
def gmm_est_lvtln_trans_tool(argv: List[str]) -> int:
    """Per speaker the LVTLN class of largest auxiliary: writes its [D, D+1]
    transform and the warp factor."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.lvtln import LinearVtln, select_lvtln_transform
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("gmm-est-lvtln-trans [options] <model> <lvtln> <feats-rspecifier> "
                      "<post-rspecifier> <transform-wspecifier> <warp-wspecifier>")

    class Opts:
        spk2utt = ""
        min_count = 10.0
        estimate_offset = True

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("min-count", o, "min_count")
    po.register("estimate-offset", o, "estimate_offset")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 6:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    lvtln = LinearVtln.load(args[1])
    corpus = _speaker_corpus(model, args[2], args[3], o.spk2utt)
    n = 0
    with TableWriter(args[4], "mat") as wt, TableWriter(args[5], "text") as ww:
        for spk, acc in zip(corpus.speakers, corpus.fmllr_accs(model.am, dev)):
            res = select_lvtln_transform(acc, lvtln, estimate_offset=o.estimate_offset,
                                         min_count=o.min_count)
            if res is None:
                continue
            w, warp, _c, _impr = res
            wt[spk] = w.astype(np.float32)
            ww[spk] = f"{warp:.4f}"
            n += 1
    log.info("gmm-est-lvtln-trans: %d speakers", n)
    return 0


# ---------------------------------------------------------------------------
# regression-tree MLLR / fMLLR (reference gmmbin/gmm-make-regtree.cc,
# gmm-est-regtree-{fmllr,mllr}.cc, gmm-decode-faster-regtree-{fmllr,mllr}.cc)
# ---------------------------------------------------------------------------


@tool("gmm-make-regtree")
def gmm_make_regtree_tool(argv: List[str]) -> int:
    """Cluster the model's Gaussians into a regression tree (host numpy)."""
    from old_kaldi_git_tpu_torch.transform.regtree import RegressionTree

    po = ParseOptions("gmm-make-regtree [options] <model> <regtree-out>")

    class Opts:
        max_leaves = 32
        seed = 0

    o = Opts()
    po.register("max-leaves", o, "max_leaves")
    po.register("seed", o, "seed")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    RegressionTree.build(_host_model(args[0]).am, o.max_leaves, seed=o.seed).save(args[1])
    return 0


def _est_regtree(argv: List[str], kind: str) -> int:
    """Per-speaker regression-tree transforms: each speaker's utterances at
    once on the model's device; fMLLR's regression nodes of every speaker
    solved in one batch."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.regtree import (
        RegressionTree, RegtreeFmllrAccs, RegtreeMllrAccs, estimate_regtree_fmllr_speakers,
        estimate_regtree_mllr)
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions(f"gmm-est-regtree-{kind} [options] <model> <regtree> "
                      "<feats-rspecifier> <post-rspecifier> <xforms-wspecifier>")

    class Opts:
        spk2utt = ""
        min_count = 1000.0

    o = Opts()
    po.register("spk2utt", o, "spk2utt")
    po.register("min-count", o, "min_count")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    tree = RegressionTree.load(args[1])
    corpus = _speaker_corpus(model, args[2], args[3], o.spk2utt)
    accs = []
    for s in range(len(corpus.speakers)):
        acc = (RegtreeFmllrAccs if kind == "fmllr" else RegtreeMllrAccs)(
            model.am.dim, tree.num_baseclasses, dev)
        x, pdf, wt, utt = corpus.of(s)
        acc.accumulate(model.am, tree, x, pdf, wt, utt)
        accs.append(acc)
    xforms = (estimate_regtree_fmllr_speakers(accs, tree, o.min_count) if kind == "fmllr"
              else [estimate_regtree_mllr(a, tree, o.min_count) for a in accs])
    with TableWriter(args[4], "regx") as w:
        for spk, xf in zip(corpus.speakers, xforms):
            w[spk] = xf
    log.info("gmm-est-regtree-%s: %d speakers", kind, len(corpus.speakers))
    return 0


@tool("gmm-est-regtree-fmllr")
def gmm_est_regtree_fmllr_tool(argv: List[str]) -> int:
    """Per-speaker regression-tree fMLLR feature transforms."""
    return _est_regtree(argv, "fmllr")


@tool("gmm-est-regtree-mllr")
def gmm_est_regtree_mllr_tool(argv: List[str]) -> int:
    """Per-speaker regression-tree MLLR mean transforms."""
    return _est_regtree(argv, "mllr")


def regtree_loglikes(model, tree, xforms, utt2spk: Dict[str, str], feats: Dict[str, np.ndarray],
                     kind: str, dev):
    """(keys, loglikes [B, T, P] float32 on `dev`, frames [B]) of the sorted
    utterances, frames past an utterance at −1e30: an utterance whose
    speaker has no transform through the GMM kernel in one launch, an MLLR
    speaker's through the kernel on their adapted model (one launch a
    speaker), an fMLLR speaker's by `regtree_fmllr_loglikes` in float64."""
    import torch

    from old_kaldi_git_tpu_torch.transform.regtree import (
        apply_mllr_to_model, regtree_fmllr_loglikes)
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    keys = sorted(feats)
    nf = np.asarray([len(feats[k]) for k in keys])
    loglikes = torch.full((len(keys), int(nf.max()), model.am.num_pdfs), -1e30,
                          dtype=torch.float32, device=dev)
    by_spk: Dict[Optional[str], List[int]] = {}
    for i, k in enumerate(keys):
        spk = utt2spk.get(k, k)
        by_spk.setdefault(spk if spk in xforms else None, []).append(i)
    for spk, rows in by_spk.items():
        if spk is not None and kind == "fmllr":
            for i in rows:
                loglikes[i, :nf[i]] = regtree_fmllr_loglikes(
                    model.am, tree, xforms[spk], feats[keys[i]]).float()
            continue
        am = model.am if spk is None else apply_mllr_to_model(model.am, tree, xforms[spk])
        _, padded, _ = pad_feature_batch(feats, [keys[i] for i in rows])
        ll = am.loglikes_batch(torch.from_numpy(padded).to(dev))
        for j, i in enumerate(rows):
            loglikes[i, :nf[i]] = ll[j, :nf[i]]
    return keys, loglikes, nf


def _decode_regtree(argv: List[str], kind: str) -> int:
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.regtree import RegressionTree
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions(f"gmm-decode-faster-regtree-{kind} [options] <model> <regtree> "
                      "<hclg-fst> <feats-rspecifier> <xforms-rspecifier> "
                      "<words-wspecifier> [<ali-wspecifier>]")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 0.1
        word_symbol_table = ""
        utt2spk = ""

    o = Opts()
    for name in ("beam", "max-active", "acoustic-scale", "word-symbol-table", "utt2spk"):
        po.register(name, o, name.replace("-", "_"))
    device = device_option(po)
    args = po.parse(argv)
    if len(args) not in (6, 7):
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    tree = RegressionTree.load(args[1])
    csr = read_hclg_csr(args[2], model.tm.tid_to_pdf_array())
    xforms = RandomAccessTableReader(args[4], "regx")
    feats = dict(SequentialTableReader(args[3], "mat"))
    if not feats:
        log.warning("no features")
        return 1
    keys, loglikes, nf = regtree_loglikes(model, tree, xforms,
                                          _read_map(o.utt2spk) if o.utt2spk else {}, feats,
                                          kind, dev)
    results = decode_batch(csr, loglikes, nf,
                           ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                          acoustic_scale=o.acoustic_scale), device=dev)
    words_tab = _symbols(o.word_symbol_table)
    awriter = TableWriter(args[6], "ivec") if len(args) == 7 else None
    n = 0
    with TableWriter(args[5], "text") as w:
        for key, res in zip(keys, results):
            if res is None:
                log.warning("decode failed for %s", key)
                continue
            w[key] = _words_text(words_tab, res.words)
            if awriter is not None:
                awriter[key] = np.asarray(res.alignment, np.int32)
            n += 1
    if awriter is not None:
        awriter.close()
    log.info("gmm-decode-faster-regtree-%s: decoded %d/%d", kind, n, len(keys))
    return 0


@tool("gmm-decode-faster-regtree-fmllr")
def gmm_decode_faster_regtree_fmllr_tool(argv: List[str]) -> int:
    """Best-path decode with per-speaker regression-tree fMLLR features."""
    return _decode_regtree(argv, "fmllr")


@tool("gmm-decode-faster-regtree-mllr")
def gmm_decode_faster_regtree_mllr_tool(argv: List[str]) -> int:
    """Best-path decode with per-speaker regression-tree MLLR means."""
    return _decode_regtree(argv, "mllr")


# ---------------------------------------------------------------------------
# fMPE (reference gmmbin/fmpe-init.cc, gmm-get-stats-deriv.cc,
# gmm-fmpe-acc-stats.cc, fmpe-sum-accs.cc, fmpe-est.cc, fmpe-apply-transform.cc)
# ---------------------------------------------------------------------------


@tool("fmpe-init")
def fmpe_init_tool(argv: List[str]) -> int:
    """An fMPE object of zero projection from a diagonal UBM."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
    from old_kaldi_git_tpu_torch.transform.fmpe import DEFAULT_CONTEXTS, Fmpe, parse_contexts

    po = ParseOptions("fmpe-init [options] <diag-ubm> <fmpe-out>")

    class Opts:
        context_expansion = ""
        post_scale = 5.0
        num_gselect = 25

    o = Opts()
    for name in ("context-expansion", "post-scale", "num-gselect"):
        po.register(name, o, name.replace("-", "_"))
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    ubm = DiagGmm.load(args[0])
    ctx = parse_contexts(o.context_expansion) if o.context_expansion else DEFAULT_CONTEXTS
    Fmpe.init(ubm, ctx, o.post_scale, o.num_gselect, device="cpu").save(args[1])
    log.info("fmpe-init: %d Gaussians, %d contexts, dim %d", ubm.num_mix, len(ctx), ubm.dim)
    return 0


@tool("gmm-get-stats-deriv")
def gmm_get_stats_deriv_tool(argv: List[str]) -> int:
    """The per-Gaussian derivative statistics of the discriminative
    objective and the ML occupancies of the alignment (reference
    gmmbin/gmm-get-stats-deriv.cc): the input of fMPE's indirect
    differential, from the signed posteriors and the ML alignment."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.fmpe import Fmpe, ModelDerivStats
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, SequentialTableReader

    po = ParseOptions("gmm-get-stats-deriv [options] <model> <fmpe> <feats-rspecifier> "
                      "<signed-post-rspecifier> <ali-rspecifier> <deriv-stats-out>")

    class Opts:
        apply_fmpe = True

    o = Opts()
    po.register("apply-fmpe", o, "apply_fmpe")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 6:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    fmpe = Fmpe.load(args[1], dev)
    posts = RandomAccessTableReader(args[3], "post")
    alis = RandomAccessTableReader(args[4], "ivec")
    stats = ModelDerivStats(model.am)
    n = 0
    for key, x in SequentialTableReader(args[2], "mat"):
        if key not in posts or key not in alis:
            continue
        xt = fmpe.transformed(x) if o.apply_fmpe else x
        stats.accumulate(model.am, model.tm, xt, posts[key], np.asarray(alis[key]))
        n += 1
    stats.save(args[5])
    log.info("gmm-get-stats-deriv: %d utterances", n)
    return 0


@tool("gmm-fmpe-acc-stats")
def gmm_fmpe_acc_stats_tool(argv: List[str]) -> int:
    """fMPE's projection-gradient statistics from signed (MPE / sMBR)
    posteriors: the direct differential at the fMPE features, plus the
    indirect one when --model-derivs (a gmm-get-stats-deriv file) and --ali
    are given."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.fmpe import (
        Fmpe, FmpeAccs, ModelDerivStats, model_deriv_direct, model_deriv_indirect)
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, SequentialTableReader

    po = ParseOptions("gmm-fmpe-acc-stats [options] <model> <fmpe> <feats-rspecifier> "
                      "<signed-post-rspecifier> <accs-out>")

    class Opts:
        model_derivs = ""
        ali = ""

    o = Opts()
    po.register("model-derivs", o, "model_derivs")
    po.register("ali", o, "ali")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    fmpe = Fmpe.load(args[1], dev)
    posts = RandomAccessTableReader(args[3], "post")
    deriv_stats = ModelDerivStats.load(o.model_derivs, model.am) if o.model_derivs else None
    if deriv_stats is not None and not o.ali:
        raise KaldiError("--model-derivs needs --ali (the ML alignment)")
    alis = RandomAccessTableReader(o.ali, "ivec") if o.ali else None
    accs = FmpeAccs.zeros_like(fmpe)
    n = 0
    for key, x in SequentialTableReader(args[2], "mat"):
        if key not in posts:
            continue
        # the gradient at the fMPE features, as the reference takes it
        xt = fmpe.transformed(x)
        deriv = model_deriv_direct(model.am, model.tm, xt, posts[key])
        if deriv_stats is not None and key in alis:
            deriv = deriv + model_deriv_indirect(model.am, model.tm, xt,
                                                 np.asarray(alis[key]), deriv_stats)
        accs.add(fmpe.acc_from_deriv(x, deriv))
        n += 1
    accs.save(args[4])
    log.info("gmm-fmpe-acc-stats: %d utterances%s", n,
             " (direct+indirect)" if deriv_stats is not None else "")
    return 0


@tool("fmpe-sum-accs")
def fmpe_sum_accs_tool(argv: List[str]) -> int:
    """Sum fMPE statistics files (reference gmmbin/fmpe-sum-accs.cc), on the
    host."""
    from old_kaldi_git_tpu_torch.transform.fmpe import FmpeAccs

    po = ParseOptions("fmpe-sum-accs <accs-out> <accs-in1> [<accs-in2> ...]")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    tot = FmpeAccs.load(args[1], "cpu")
    for p in args[2:]:
        tot.add(FmpeAccs.load(p, "cpu"))
    tot.save(args[0])
    return 0


@tool("fmpe-est")
def fmpe_est_tool(argv: List[str]) -> int:
    """Update the fMPE projection from summed statistics, on the host."""
    from old_kaldi_git_tpu_torch.transform.fmpe import Fmpe, FmpeAccs

    po = ParseOptions("fmpe-est [options] <fmpe-in> <accs> <fmpe-out>")

    class Opts:
        learning_rate = 0.1

    o = Opts()
    po.register("learning-rate", o, "learning_rate")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    fmpe = Fmpe.load(args[0], "cpu")
    fmpe.update(FmpeAccs.load(args[1], "cpu"), o.learning_rate)
    fmpe.save(args[2])
    return 0


@tool("fmpe-apply-transform")
def fmpe_apply_transform_tool(argv: List[str]) -> int:
    """x' = x + offset(x) over a feature table, on the device."""
    from old_kaldi_git_tpu_torch.transform.fmpe import Fmpe
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("fmpe-apply-transform <fmpe> <feats-rspecifier> <feats-wspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    fmpe = Fmpe.load(args[0], device())
    n = 0
    with TableWriter(args[2], "mat") as w:
        for key, x in SequentialTableReader(args[1], "mat"):
            w[key] = fmpe.apply(np.asarray(x)).cpu().numpy()
            n += 1
    log.info("fmpe-apply-transform: %d utterances", n)
    return 0
