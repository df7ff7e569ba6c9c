"""SGMM2 tools (counterpart of old_kaldi_git_tpu/bin/sgmm2_tools.py;
reference src/sgmm2bin: sgmm2-init, sgmm2-info, sgmm2-est-fmllr,
sgmm2-est-spkvecs, sgmm2-acc-stats-ali, sgmm2-sum-accs, sgmm2-est,
sgmm2-align-compiled, sgmm2-latgen-faster).

Wrappers over gmm/sgmm2.py under the JAX tools' names, options, defaults
and exit codes.  Six make tensors and take --device (cuda by default):
sgmm2-acc-stats-ali accumulates all of a table's unadapted frames in one
pass (an utterance with a speaker vector in a pass of its own),
sgmm2-est runs the M-step, sgmm2-est-spkvecs and sgmm2-est-fmllr work speaker
by speaker on the model's device (the fMLLR ascent of all speakers at once),
sgmm2-align-compiled aligns the table as one padded batch (the gather
kernel, three launches a scanned frame) and sgmm2-latgen-faster scores the
table as one padded batch, then decodes it and rebuilds the lattices.  The
decodable seam is loglikes [B, T, num_pdfs], shared with the GMM and nnet3
paths.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import _symbols, _usage, device_option, tool
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("sgmm2_tools")

CPU = "cpu"


def _read_utt2spk(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


@tool("sgmm2-init")
def sgmm2_init_tool(argv: List[str]) -> int:
    """An SGMM2 from a GMM model's transition structure and a
    full-covariance UBM (the transition model comes from an existing
    .mdl)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import AmSgmm2, Sgmm2Model

    po = ParseOptions("sgmm2-init [options] <gmm-mdl-in> <fgmm-ubm-in> <sgmm2-out>")

    class Opts:
        phn_space_dim = 0
        spk_space_dim = 0
        symmetric = False

    o = Opts()
    po.register("phn-space-dim", o, "phn_space_dim")
    po.register("spk-space-dim", o, "spk_space_dim")
    po.register("symmetric", o, "symmetric")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    base = AmGmmModel.load(args[0], device=CPU)
    sgmm = AmSgmm2.init(FullGmm.load(args[1]), base.am.num_pdfs, o.phn_space_dim or None,
                        device=CPU)
    if o.spk_space_dim:
        sgmm.init_speaker_subspace(o.spk_space_dim, symmetric=o.symmetric)
    elif o.symmetric:
        return _usage(po)  # --symmetric needs --spk-space-dim
    Sgmm2Model(base.tm, sgmm).save(args[2])
    log.info("sgmm2-init: %d pdfs, %d Gaussians, phn-dim %d, spk-dim %d%s", sgmm.num_pdfs,
             sgmm.num_gauss, sgmm.phn_dim, sgmm.spk_dim,
             " (symmetric)" if sgmm.u is not None else "")
    return 0


@tool("sgmm2-info")
def sgmm2_info_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model

    po = ParseOptions("sgmm2-info <sgmm2-in>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    m = Sgmm2Model.load(args[0], device=CPU)
    print(f"number of pdfs {m.sgmm.num_pdfs}")
    print(f"number of gaussians {m.sgmm.num_gauss}")
    print(f"feature dimension {m.sgmm.dim}")
    print(f"phone-space dimension {m.sgmm.phn_dim}")
    print(f"number of substates {m.sgmm.num_substates}")
    print(f"speaker-space dimension {m.sgmm.spk_dim}")
    print(f"symmetric {'true' if m.sgmm.u is not None else 'false'}")
    print(f"number of transition-ids {m.tm.num_tids}")
    return 0


def _by_speaker(feats_rspec: str, ali_rspec: str, tid2pdf: np.ndarray, u2s: dict) -> Dict:
    """{speaker: (frames, pdf ids)} of the utterances with an alignment,
    each utterance cut to the shorter of its features and alignment."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    alis = dict(SequentialTableReader(ali_rspec, "ivec"))
    by_spk: Dict[str, tuple] = {}
    for key, x in SequentialTableReader(feats_rspec, "mat"):
        if key not in alis:
            continue
        ali = np.asarray(alis[key])
        x = np.asarray(x, np.float64)
        t = min(len(x), len(ali))
        fx, fp = by_spk.setdefault(u2s.get(key, key), ([], []))
        fx.append(x[:t])
        fp.append(tid2pdf[ali[:t]])
    return {s: (np.concatenate(fx), np.concatenate(fp)) for s, (fx, fp) in by_spk.items()}


@tool("sgmm2-est-fmllr")
def sgmm2_est_fmllr_tool(argv: List[str]) -> int:
    """Per-speaker fMLLR transforms [D, D+1] for an SGMM2 (each speaker's
    frames pooled; speakers under --min-count get the identity), to apply
    with transform-feats before decoding."""
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model
    from old_kaldi_git_tpu_torch.gmm.sgmm2_fmllr import (
        FmllrSgmm2Accs, FmllrSgmm2Options, estimate_sgmm2_fmllr_batch,
        sgmm2_fmllr_objf_improvement)
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("sgmm2-est-fmllr [options] <sgmm2-mdl> <feats-rspecifier> "
                      "<ali-rspecifier> <mats-wspecifier>")

    class Opts:
        utt2spk = ""
        spk_vecs = ""
        num_iters = 10
        min_count = 100.0

    o = Opts()
    po.register("utt2spk", o, "utt2spk")
    po.register("spk-vecs", o, "spk_vecs")
    po.register("num-iters", o, "num_iters")
    po.register("min-count", o, "min_count")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    model = Sgmm2Model.load(args[0], device=device())
    u2s = _read_utt2spk(o.utt2spk) if o.utt2spk else {}
    vecs = dict(SequentialTableReader(o.spk_vecs, "vec")) if o.spk_vecs else {}
    by_spk = _by_speaker(args[1], args[2], model.tm.tid_to_pdf_array(), u2s)
    spks = sorted(by_spk)
    accs = []
    for spk in spks:
        a = FmllrSgmm2Accs(model.sgmm)
        vs = vecs.get(spk)
        a.accumulate(model.sgmm, *by_spk[spk],
                     spk_vec=None if vs is None else np.asarray(vs, np.float64))
        accs.append(a)
    Ws = estimate_sgmm2_fmllr_batch(model.sgmm, accs,
                                    FmllrSgmm2Options(num_iters=o.num_iters,
                                                      min_count=o.min_count))
    D = model.sgmm.dim
    ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    tot_impr = tot_beta = 0.0
    with TableWriter(args[3], "mat") as w:
        for spk, a, W in zip(spks, accs, Ws):
            if W is None:
                w[spk] = ident.astype(np.float32)
                continue
            tot_impr += sgmm2_fmllr_objf_improvement(model.sgmm, a, W) * a.beta
            tot_beta += a.beta
            w[spk] = W.cpu().numpy().astype(np.float32)
    log.info("sgmm2-est-fmllr: %d speakers, avg auxiliary improvement %.4f/frame", len(spks),
             tot_impr / max(tot_beta, 1.0))
    return 0


@tool("sgmm2-est-spkvecs")
def sgmm2_est_spkvecs_tool(argv: List[str]) -> int:
    """Per-speaker vectors from aligned frames (each speaker's utterances
    pooled, --utt2spk, else each utterance alone); a 'vec' table keyed by
    speaker."""
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model, estimate_spk_vector
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("sgmm2-est-spkvecs [options] <sgmm2-mdl> <feats-rspecifier> "
                      "<ali-rspecifier> <vecs-wspecifier>")

    class Opts:
        utt2spk = ""
        num_iters = 2
        min_count = 10.0

    o = Opts()
    po.register("utt2spk", o, "utt2spk")
    po.register("num-iters", o, "num_iters")
    po.register("min-count", o, "min_count")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    model = Sgmm2Model.load(args[0], device=device())
    if model.sgmm.N is None:
        raise KaldiError("model has no speaker subspace (sgmm2-init --spk-space-dim)")
    u2s = _read_utt2spk(o.utt2spk) if o.utt2spk else {}
    by_spk = _by_speaker(args[1], args[2], model.tm.tid_to_pdf_array(), u2s)
    with TableWriter(args[3], "vec") as w:
        for spk in sorted(by_spk):
            vs = estimate_spk_vector(model.sgmm, *by_spk[spk], num_iters=o.num_iters,
                                     min_count=o.min_count)
            w[spk] = vs.cpu().numpy().astype(np.float32)
    log.info("sgmm2-est-spkvecs: %d speakers", len(by_spk))
    return 0


@tool("sgmm2-acc-stats-ali")
def sgmm2_acc_stats_ali_tool(argv: List[str]) -> int:
    """SGMM2 EM statistics from alignments."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.sgmm2 import MleAmSgmm2Accs, Sgmm2Model
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("sgmm2-acc-stats-ali [options] <sgmm2-mdl> <feats-rspecifier> "
                      "<ali-rspecifier> <accs-out>")

    class Opts:
        spk_vecs = ""
        utt2spk = ""

    o = Opts()
    po.register("spk-vecs", o, "spk_vecs")
    po.register("utt2spk", o, "utt2spk")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = Sgmm2Model.load(args[0], device=dev)
    alis = dict(SequentialTableReader(args[2], "ivec"))
    vecs = dict(SequentialTableReader(o.spk_vecs, "vec")) if o.spk_vecs else {}
    u2s = _read_utt2spk(o.utt2spk) if o.utt2spk else {}
    tid2pdf = model.tm.tid_to_pdf_array()
    # one pass over every unadapted frame; an adapted utterance's frames in a
    # pass of their own (a call's symmetric-SGMM statistics are per call)
    plain: tuple = ([], [])
    accs = MleAmSgmm2Accs(model.sgmm)
    n = 0
    for key, x in SequentialTableReader(args[1], "mat"):
        if key not in alis:
            continue
        ali = np.asarray(alis[key])
        t = min(len(x), len(ali))
        vs = vecs.get(u2s.get(key, key)) if vecs else None
        x, pdfs = np.asarray(x, np.float64)[:t], tid2pdf[ali[:t]]
        if vs is None:
            plain[0].append(x)
            plain[1].append(pdfs)
        else:
            accs.accumulate(model.sgmm, torch.from_numpy(x).to(dev), pdfs, spk_vec=vs)
        n += 1
    if plain[0]:
        accs.accumulate(model.sgmm, torch.from_numpy(np.concatenate(plain[0])).to(dev),
                        np.concatenate(plain[1]))
    accs.save(args[3])
    log.info("sgmm2-acc-stats-ali: %d utterances, %.0f frames, avg like %.4f", n,
             accs.total_frames, accs.total_like / max(accs.total_frames, 1.0))
    return 0


@tool("sgmm2-sum-accs")
def sgmm2_sum_accs_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import MleAmSgmm2Accs, Sgmm2Model

    po = ParseOptions("sgmm2-sum-accs <sgmm2-mdl> <accs-out> <accs-in1> [<accs-in2> ...]")
    args = po.parse(argv)
    if len(args) < 3:
        return _usage(po)
    model = Sgmm2Model.load(args[0], device=CPU)
    tot = MleAmSgmm2Accs.load(args[2], model.sgmm)
    for p in args[3:]:
        tot.add(MleAmSgmm2Accs.load(p, model.sgmm))
    tot.save(args[1])
    return 0


@tool("sgmm2-est")
def sgmm2_est_tool(argv: List[str]) -> int:
    """The M-step and optional substate splitting.  'v' and 'M' must come
    from different iterations: pass --update-flags=vwc and
    --update-flags=MS alternately."""
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import (
        MleAmSgmm2Accs, Sgmm2Model, Sgmm2UpdateOptions, sgmm2_update, split_substates)

    po = ParseOptions("sgmm2-est [options] <sgmm2-in> <accs> <sgmm2-out>")

    class Opts:
        update_flags = "vwc"
        split_substates_n = 0
        min_gaussian_occupancy = 10.0
        cov_floor = 1e-3

    o = Opts()
    po.register("update-flags", o, "update_flags")
    po.register("split-substates", o, "split_substates_n")
    po.register("min-gaussian-occupancy", o, "min_gaussian_occupancy")
    po.register("cov-floor", o, "cov_floor")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    model = Sgmm2Model.load(args[0], device=device())
    accs = MleAmSgmm2Accs.load(args[1], model.sgmm)
    sgmm2_update(model.sgmm, accs, Sgmm2UpdateOptions(
        update_flags=o.update_flags, min_gaussian_occupancy=o.min_gaussian_occupancy,
        cov_floor=o.cov_floor))
    if o.split_substates_n > model.sgmm.num_substates:
        split_substates(model.sgmm, accs, o.split_substates_n)
    model.save(args[2])
    return 0


@tool("sgmm2-align-compiled")
def sgmm2_align_compiled_tool(argv: List[str]) -> int:
    """Batched Viterbi alignment with SGMM2 acoustics (the aligner of the
    GMM path through the loglikes [B, T, P] seam)."""
    from old_kaldi_git_tpu_torch.bin.train_tools import batch_align
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model

    po = ParseOptions("sgmm2-align-compiled [options] <sgmm2-mdl> <graphs-rspecifier> "
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
    model = Sgmm2Model.load(args[0], device=dev)

    class _Bundle:  # the (tm, am) pair batch_align reads
        tm = model.tm
        am = model.sgmm

    return batch_align(_Bundle(), args[1], args[2], args[3], beam=o.beam,
                       acoustic_scale=o.acoustic_scale, device=dev)


@tool("sgmm2-latgen-faster")
def sgmm2_latgen_faster_tool(argv: List[str]) -> int:
    """Lattice decoding with SGMM2 acoustics: the table scored as one
    padded batch, decode_batch, then each lattice rebuilt."""
    import torch

    from old_kaldi_git_tpu_torch.bin.tools import write_decode_outputs
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("sgmm2-latgen-faster [options] <sgmm2-mdl> <hclg-fst> "
                      "<feats-rspecifier> <lat-wspecifier> [<words-wspecifier>]")

    class Opts:
        beam = 16.0
        lattice_beam = 10.0
        max_active = 7000
        acoustic_scale = 0.1
        word_symbol_table = ""
        spk_vecs = ""
        utt2spk = ""

    o = Opts()
    for name, attr in (("beam", "beam"), ("lattice-beam", "lattice_beam"),
                       ("max-active", "max_active"), ("acoustic-scale", "acoustic_scale"),
                       ("word-symbol-table", "word_symbol_table"), ("spk-vecs", "spk_vecs"),
                       ("utt2spk", "utt2spk")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) not in (4, 5):
        return _usage(po)
    dev = device()
    model = Sgmm2Model.load(args[0], device=dev)
    csr = read_hclg_csr(args[1], model.tm.tid_to_pdf_array())
    feats = dict(SequentialTableReader(args[2], "mat"))
    if not feats:
        raise KaldiError("no features")
    keys, padded, nf = pad_feature_batch(feats)
    spk_vecs = None
    if o.spk_vecs:
        vecs = dict(SequentialTableReader(o.spk_vecs, "vec"))
        u2s = _read_utt2spk(o.utt2spk) if o.utt2spk else {}
        spk_vecs = [vecs.get(u2s.get(k, k)) for k in keys]
    loglikes = model.sgmm.loglikes_batch(torch.from_numpy(padded).to(dev), num_frames=nf,
                                         spk_vecs=spk_vecs).to(torch.float32)
    results = decode_batch(csr, loglikes, nf,
                           ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                          acoustic_scale=o.acoustic_scale),
                           want_lattice=True, device=dev)
    write_decode_outputs(csr, keys, results, loglikes.cpu().numpy(), nf, o.acoustic_scale,
                         o.lattice_beam, args[3], args[4] if len(args) == 5 else None,
                         _symbols(o.word_symbol_table))
    return 0
