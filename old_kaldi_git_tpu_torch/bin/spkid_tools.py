"""Speaker-recognition and UBM tools (counterpart of
old_kaldi_git_tpu/bin/spkid_tools.py; reference src/ivectorbin and the
gmm-global-* / fgmm-global-* tools of src/gmmbin).

The sre-style chain: energy VAD → select-voiced-frames → diagonal UBM →
full-covariance UBM → T-matrix training → ivector-extract → mean / length
normalisation → LDA → PLDA scoring or logistic regression, and compute-eer,
under the JAX tools' names, options, defaults and exit codes.  gselect
archives are [T, N] int-valued float matrices under the "mat" holder.

Eight tools make tensors and take --device (cuda by default):
gmm-global-init-from-feats, gmm-gselect / fgmm-gselect,
gmm-global-acc-stats, gmm-global-get-post, fgmm-global-acc-stats,
ivector-extractor-acc-stats and ivector-extract.  Each takes all of a
table's frames in one float64 pass (the UBMs' scores and statistics,
ivector/extractor.py's batched statistics and posteriors), not utterance by
utterance.  The others are host tools over per-utterance vectors (PLDA,
LDA, EER, logistic regression, the estimators on small statistics), in
float64 on the CPU.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import _usage, device_option, tool
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("spkid")

CPU = "cpu"


def _read_map_list(path: str) -> Dict[str, List[str]]:
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    return {k: v.split() for k, v in _read_map(path).items()}


def _load_gmm(path: str):
    """A DiagGmm or a FullGmm, by the leading token."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm
    from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm

    with open(path, "rb") as f:
        if not iof.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: expected binary model")
        token = iof.peek_token(f)
        if token == "<DiagGMM>":
            return DiagGmm.read(f)
        if token == "<FullGMM>":
            return FullGmm.read(f)
        raise KaldiError(f"{path}: unknown model token {token!r}")


def _table(rspec: str, holder: str = "mat") -> Dict[str, np.ndarray]:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    return {k: np.asarray(v) for k, v in SequentialTableReader(rspec, holder)}


def _frames(feats: Dict[str, np.ndarray], dev):
    """All utterances' frames as one float64 tensor on `dev`, and the row
    where each utterance starts."""
    import torch

    keys = list(feats)
    lens = [len(feats[k]) for k in keys]
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    x = (np.concatenate([np.asarray(feats[k], np.float64) for k in keys]) if keys
         else np.zeros((0, 1)))
    return keys, starts, torch.from_numpy(x).to(dev)


# ---------------------------------------------------------------------------
# gmm-global-* (diagonal UBM)
# ---------------------------------------------------------------------------

@tool("gmm-global-init-from-feats")
def gmm_global_init_from_feats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.extractor import train_ubm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    class Opts:
        num_gauss = 64
        num_iters = 10
        num_frames = 200000
        seed = 0

    o = Opts()
    po = ParseOptions("gmm-global-init-from-feats [options] <feats-rspecifier> <model-out>")
    po.register("num-gauss", o, "num_gauss")
    po.register("num-iters", o, "num_iters")
    po.register("num-frames", o, "num_frames")
    po.register("srand", o, "seed")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    dev = device()
    chunks, total = [], 0
    for _, f in SequentialTableReader(args[0], "mat"):
        chunks.append(np.asarray(f))
        total += len(f)
        if total >= o.num_frames:
            break
    x = np.concatenate(chunks)[: o.num_frames]
    gmm = train_ubm(x, num_gauss=o.num_gauss, num_iters=o.num_iters, seed=o.seed, device=dev)
    gmm.save(args[1])
    log.info("initialized %d-gauss UBM on %d frames", o.num_gauss, len(x))
    return 0


@tool("gmm-gselect")
@tool("fgmm-gselect")
def gmm_gselect_tool(argv: List[str]) -> int:
    """The N best Gaussians a frame, best first, every frame of the table
    scored in one float64 pass."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.full_gmm import FRAME_CHUNK, gselect
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    class Opts:
        n = 50

    o = Opts()
    po = ParseOptions("gmm-gselect [--n=50] <model> <feats-rspecifier> <gsel-wspecifier>")
    po.register("n", o, "n")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    gmm = _load_gmm(args[0])
    keys, starts, x = _frames(_table(args[1]), dev)
    sel = (torch.cat([gselect(gmm, x[lo: lo + FRAME_CHUNK], o.n)
                      for lo in range(0, x.shape[0], FRAME_CHUNK)]).cpu().numpy()
           if keys else None)
    with TableWriter(args[2], "mat") as w:
        for i, key in enumerate(keys):
            w[key] = sel[starts[i]: starts[i + 1]].astype(np.float32)
    return 0


def _gsel_groups(keys, starts, gsel_rspec: str):
    """(rows, gsel) of the frames with and those without a gselect entry:
    [(row index array, [n, N] int64 or None)]."""
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader

    gsel = RandomAccessTableReader(gsel_rspec, "mat") if gsel_rspec else None
    with_rows, with_sel, without = [], [], []
    for i, key in enumerate(keys):
        rows = np.arange(starts[i], starts[i + 1])
        if gsel is not None and key in gsel:
            with_rows.append(rows)
            with_sel.append(np.asarray(gsel[key]).astype(np.int64))
        else:
            without.append(rows)
    groups = []
    if with_rows:
        groups.append((np.concatenate(with_rows), np.concatenate(with_sel)))
    if without:
        groups.append((np.concatenate(without), None))
    return groups


@tool("gmm-global-acc-stats")
def gmm_global_acc_stats(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.gmm.mle import AccumDiagGmm

    class Opts:
        gselect = ""

    o = Opts()
    po = ParseOptions("gmm-global-acc-stats [--gselect=rspec] <model> <feats-rspecifier> "
                      "<accs-out>")
    po.register("gselect", o, "gselect")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    gmm = _load_gmm(args[0])
    accs = AccumDiagGmm(gmm.num_mix, gmm.dim, dev)
    keys, starts, x = _frames(_table(args[1]), dev)
    for rows, sel in _gsel_groups(keys, starts, o.gselect):
        accs.accumulate(gmm, x[torch.from_numpy(rows).to(dev)], gsel=sel)
    with open(args[2], "wb") as f:
        accs.write(f)
    log.info("accumulated %0.f frames, avg like %.4f", accs.tot_frames,
             accs.tot_like / max(accs.tot_frames, 1.0))
    return 0


@tool("gmm-global-sum-accs")
def gmm_global_sum_accs(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.mle import AccumDiagGmm

    po = ParseOptions("gmm-global-sum-accs <accs-out> <accs-in1> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    total: Optional[AccumDiagGmm] = None
    for path in args[1:]:
        with open(path, "rb") as f:
            a = AccumDiagGmm.read(f, CPU)
        if total is None:
            total = a
        else:
            total.add(a)
    with open(args[0], "wb") as f:
        total.write(f)
    return 0


@tool("gmm-global-est")
def gmm_global_est(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm
    from old_kaldi_git_tpu_torch.gmm.mle import (
        AccumDiagGmm, MleDiagGmmOptions, mixup, mle_diag_gmm_update)

    class Opts:
        min_gaussian_occupancy = 10.0
        variance_floor = 1e-3
        mix_up = 0
        remove_low_count_gaussians = True

    o = Opts()
    po = ParseOptions("gmm-global-est [options] <model-in> <accs-in> <model-out>")
    po.register("min-gaussian-occupancy", o, "min_gaussian_occupancy")
    po.register("variance-floor", o, "variance_floor")
    po.register("mix-up", o, "mix_up")
    po.register("remove-low-count-gaussians", o, "remove_low_count_gaussians")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    gmm = _load_gmm(args[0])
    with open(args[1], "rb") as f:
        accs = AccumDiagGmm.read(f, CPU)
    opts = MleDiagGmmOptions(min_gaussian_occupancy=o.min_gaussian_occupancy,
                             variance_floor=o.variance_floor,
                             remove_low_count_gaussians=o.remove_low_count_gaussians)
    new = mle_diag_gmm_update(gmm, accs.occ, accs.mean_acc, accs.var_acc, opts)
    if o.mix_up > new.num_mix:
        new = mixup(AmDiagGmm([new], CPU), o.mix_up).pdfs[0]
    new.save(args[2])
    log.info("gmm-global-est: %d -> %d gaussians, avg like %.4f", gmm.num_mix, new.num_mix,
             accs.tot_like / max(accs.tot_frames, 1.0))
    return 0


@tool("gmm-global-to-fgmm")
def gmm_global_to_fgmm(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.full_gmm import FullGmm

    po = ParseOptions("gmm-global-to-fgmm <diag-model-in> <full-model-out>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    FullGmm.from_diag(_load_gmm(args[0])).save(args[1])
    return 0


@tool("fgmm-global-to-gmm")
def fgmm_global_to_gmm(argv: List[str]) -> int:
    po = ParseOptions("fgmm-global-to-gmm <full-model-in> <diag-model-out>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    _load_gmm(args[0]).to_diag().save(args[1])
    return 0


@tool("gmm-global-info")
@tool("fgmm-global-info")
def gmm_global_info(argv: List[str]) -> int:
    po = ParseOptions("gmm-global-info <model-in>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    gmm = _load_gmm(args[0])
    print(f"number of gaussians {gmm.num_mix}")
    print(f"feature dimension {gmm.dim}")
    print(f"covariance type {'full' if hasattr(gmm, 'covars') else 'diag'}")
    return 0


@tool("gmm-global-get-post")
def gmm_global_get_post(argv: List[str]) -> int:
    """The top-N component posteriors a frame, renormalised (the
    fgmm-global-gselect-to-post / gmm-global-get-post roles); the table's
    posteriors in one float64 pass."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.full_gmm import FRAME_CHUNK
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    class Opts:
        n = 10
        min_post = 0.0

    o = Opts()
    po = ParseOptions("gmm-global-get-post [--n=10] <model> <feats-rspecifier> "
                      "<post-wspecifier>")
    po.register("n", o, "n")
    po.register("min-post", o, "min_post")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    gmm = _load_gmm(args[0])
    keys, starts, x = _frames(_table(args[1]), dev)
    posts = (torch.cat([gmm.posteriors(x[lo: lo + FRAME_CHUNK])
                        for lo in range(0, x.shape[0], FRAME_CHUNK)]).cpu().numpy()
             if keys else None)
    with TableWriter(args[2], "post") as w:
        for i, key in enumerate(keys):
            post = posts[starts[i]: starts[i + 1]]
            n = min(o.n, post.shape[1])
            idx = np.argpartition(-post, n - 1, axis=1)[:, :n]
            out = []
            for t in range(post.shape[0]):
                pairs = [(int(c), float(post[t, c])) for c in idx[t] if post[t, c] > o.min_post]
                tot = sum(p for _, p in pairs) or 1.0
                out.append([(c, p / tot) for c, p in sorted(pairs, key=lambda cp: -cp[1])])
            w[key] = out
    return 0


# ---------------------------------------------------------------------------
# fgmm-global-* (full-covariance UBM)
# ---------------------------------------------------------------------------

@tool("fgmm-global-acc-stats")
def fgmm_global_acc_stats(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.gmm.full_gmm import AccumFullGmm

    class Opts:
        gselect = ""

    o = Opts()
    po = ParseOptions("fgmm-global-acc-stats [--gselect=rspec] <model> <feats-rspecifier> "
                      "<accs-out>")
    po.register("gselect", o, "gselect")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    fgmm = _load_gmm(args[0])
    accs = AccumFullGmm(fgmm.num_mix, fgmm.dim, dev)
    keys, starts, x = _frames(_table(args[1]), dev)
    for rows, sel in _gsel_groups(keys, starts, o.gselect):
        accs.accumulate(fgmm, x[torch.from_numpy(rows).to(dev)],
                        None if sel is None else torch.from_numpy(sel).to(dev))
    with open(args[2], "wb") as f:
        accs.write(f)
    return 0


@tool("fgmm-global-sum-accs")
def fgmm_global_sum_accs(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.full_gmm import AccumFullGmm

    po = ParseOptions("fgmm-global-sum-accs <accs-out> <accs-in1> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    total = None
    for path in args[1:]:
        with open(path, "rb") as f:
            a = AccumFullGmm.read(f, CPU)
        if total is None:
            total = a
        else:
            total.add(a)
    with open(args[0], "wb") as f:
        total.write(f)
    return 0


@tool("fgmm-global-est")
def fgmm_global_est(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.gmm.full_gmm import AccumFullGmm, mle_full_gmm_update

    class Opts:
        min_gaussian_occupancy = 10.0
        variance_floor = 1e-3
        remove_low_count_gaussians = False

    o = Opts()
    po = ParseOptions("fgmm-global-est [options] <model-in> <accs-in> <model-out>")
    po.register("min-gaussian-occupancy", o, "min_gaussian_occupancy")
    po.register("variance-floor", o, "variance_floor")
    po.register("remove-low-count-gaussians", o, "remove_low_count_gaussians")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    fgmm = _load_gmm(args[0])
    with open(args[1], "rb") as f:
        accs = AccumFullGmm.read(f, CPU)
    mle_full_gmm_update(fgmm, accs, min_gaussian_occupancy=o.min_gaussian_occupancy,
                        variance_floor=o.variance_floor,
                        remove_low_count=o.remove_low_count_gaussians).save(args[2])
    return 0


# ---------------------------------------------------------------------------
# ivector-extractor-* + ivector-extract
# ---------------------------------------------------------------------------

def write_ie_accs(path: str, A: np.ndarray, B: np.ndarray, auxf: float) -> None:
    """<IvectorExtractorStats> C D R, A as [C·R, R] and B as [C·D, R] float64,
    the auxiliary as a double </IvectorExtractorStats> (the JAX package's
    bytes)."""
    c, r, _ = A.shape
    d = B.shape[1]
    with open(path, "wb") as f:
        iof.init_kaldi_output_stream(f, True)
        iof.write_token(f, "<IvectorExtractorStats>")
        iof.write_int32(f, c)
        iof.write_int32(f, d)
        iof.write_int32(f, r)
        iof.write_matrix(f, A.reshape(c * r, r), dtype=np.float64)
        iof.write_matrix(f, B.reshape(c * d, r), dtype=np.float64)
        iof.write_double(f, auxf)
        iof.write_token(f, "</IvectorExtractorStats>")


def read_ie_accs(path: str):
    """(A [C, R, R], B [C, D, R], auxiliary) as float64 numpy."""
    with open(path, "rb") as f:
        if not iof.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: expected binary accs")
        iof.expect_token(f, "<IvectorExtractorStats>")
        c = iof.read_int32(f)
        d = iof.read_int32(f)
        r = iof.read_int32(f)
        A = np.asarray(iof.read_matrix(f), np.float64).reshape(c, r, r)
        B = np.asarray(iof.read_matrix(f), np.float64).reshape(c, d, r)
        auxf = iof.read_float(f)
        iof.expect_token(f, "</IvectorExtractorStats>")
        return A, B, auxf


@tool("ivector-extractor-init")
def ivector_extractor_init(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.extractor import init_ivector_extractor

    class Opts:
        ivector_dim = 100
        seed = 0

    o = Opts()
    po = ParseOptions("ivector-extractor-init [--ivector-dim=100] <fgmm-in> <extractor-out>")
    po.register("ivector-dim", o, "ivector_dim")
    po.register("srand", o, "seed")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    init_ivector_extractor(_load_gmm(args[0]), o.ivector_dim, o.seed, CPU).save(args[1])
    return 0


@tool("ivector-extractor-acc-stats")
def ivector_extractor_acc_stats(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, acc_ivector_extractor_stats)

    po = ParseOptions("ivector-extractor-acc-stats <extractor-in> <feats-rspecifier> "
                      "<accs-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    ext = IvectorExtractor.load(args[0], device())
    feats = list(_table(args[1]).values())
    A, B, auxf = acc_ivector_extractor_stats(ext, feats)
    write_ie_accs(args[2], A.cpu().numpy(), B.cpu().numpy(), float(auxf))
    log.info("accumulated T stats over %d utterances", len(feats))
    return 0


@tool("ivector-extractor-sum-accs")
def ivector_extractor_sum_accs(argv: List[str]) -> int:
    po = ParseOptions("ivector-extractor-sum-accs <accs-out> <accs-in1> ...")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    A = B = None
    auxf = 0.0
    for path in args[1:]:
        a, b, x = read_ie_accs(path)
        A = a if A is None else A + a
        B = b if B is None else B + b
        auxf += x
    write_ie_accs(args[0], A, B, auxf)
    return 0


@tool("ivector-extractor-est")
def ivector_extractor_est(argv: List[str]) -> int:
    import torch

    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, est_ivector_extractor)

    po = ParseOptions("ivector-extractor-est <extractor-in> <accs-in> <extractor-out>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    ext = IvectorExtractor.load(args[0], CPU)
    A, B, auxf = read_ie_accs(args[1])
    est_ivector_extractor(ext, torch.from_numpy(A), torch.from_numpy(B)).save(args[2])
    log.info("ivector-extractor-est: auxf %.4f", auxf)
    return 0


@tool("ivector-extract")
def ivector_extract(argv: List[str]) -> int:
    """Each utterance's (or, with --spk2utt, each speaker's pooled) iVector,
    the table's statistics and posteriors in one batched float64 pass."""
    import torch

    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, batch_posteriors, batch_utt_stats)
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    class Opts:
        spk2utt = ""

    o = Opts()
    po = ParseOptions("ivector-extract [--spk2utt=f] <extractor-in> <feats-rspecifier> "
                      "<ivector-wspecifier>")
    po.register("spk2utt", o, "spk2utt")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    ext = IvectorExtractor.load(args[0], device())
    feats = _table(args[1])
    keys = list(feats)
    with TableWriter(args[2], "vec") as w:
        if not keys:
            return 0
        gamma, f = batch_utt_stats(ext, [feats[k] for k in keys])
        if o.spk2utt:
            utt2spk = {u: s for s, us in _read_map_list(o.spk2utt).items() for u in us}
            groups: Dict[str, List[int]] = {}
            for i, k in enumerate(keys):
                groups.setdefault(utt2spk.get(k, k), []).append(i)
            keys = list(groups)
            gamma = torch.stack([gamma[ix].sum(0) for ix in groups.values()])
            f = torch.stack([f[ix].sum(0) for ix in groups.values()])
        mean, _ = batch_posteriors(ext, gamma, f)
        ivecs = mean.to(torch.float32).cpu().numpy()
        for k, iv in zip(keys, ivecs):
            w[k] = iv
    return 0


# ---------------------------------------------------------------------------
# iVector post-processing and scoring (host)
# ---------------------------------------------------------------------------

@tool("ivector-mean")
def ivector_mean(argv: List[str]) -> int:
    """<spk2utt> <ivecs> <spk-ivecs-out> [<num-utts-out>], or <ivecs>
    <mean-out> (the global mean vector file)."""
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("ivector-mean <spk2utt> <ivec-rspecifier> <spk-ivec-wspecifier> "
                      "[<num-utts-wspecifier>]   or: ivector-mean <ivec-rspecifier> "
                      "<mean-wxfilename>")
    args = po.parse(argv)
    if len(args) == 2:
        mean = np.mean(list(_table(args[0], "vec").values()), axis=0)
        with open(args[1], "wb") as f:
            iof.init_kaldi_output_stream(f, True)
            iof.write_vector(f, mean.astype(np.float64), dtype=np.float64)
        return 0
    if len(args) not in (3, 4):
        return _usage(po)
    spk2utt = _read_map_list(args[0])
    ivecs = _table(args[1], "vec")
    counts = {}
    with TableWriter(args[2], "vec") as w:
        for spk, utts in spk2utt.items():
            got = [ivecs[u] for u in utts if u in ivecs]
            if not got:
                log.warning("ivector-mean: no ivectors for %s", spk)
                continue
            w[spk] = np.mean(got, axis=0).astype(np.float32)
            counts[spk] = len(got)
    if len(args) == 4:
        with TableWriter(args[3], "flt") as w:
            for spk, n in counts.items():
                w[spk] = float(n)
    return 0


@tool("ivector-subtract-global-mean")
def ivector_subtract_global_mean(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("ivector-subtract-global-mean [<mean-rxfilename>] <ivec-rspecifier> "
                      "<ivec-wspecifier>")
    args = po.parse(argv)
    if len(args) == 3:
        with open(args[0], "rb") as f:
            iof.init_kaldi_input_stream(f)
            mean = np.asarray(iof.read_vector(f), np.float64)
        args = args[1:]
    elif len(args) == 2:
        mean = np.mean(list(_table(args[0], "vec").values()), axis=0)
    else:
        return _usage(po)
    with TableWriter(args[1], "vec") as w:
        for k, v in _table(args[0], "vec").items():
            w[k] = (np.asarray(v, np.float64) - mean).astype(np.float32)
    return 0


@tool("ivector-normalize-length")
def ivector_normalize_length(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    class Opts:
        normalize = True
        scaleup = True

    o = Opts()
    po = ParseOptions("ivector-normalize-length <ivec-rspecifier> <ivec-wspecifier>")
    po.register("normalize", o, "normalize")
    po.register("scaleup", o, "scaleup")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    ratios = []
    with TableWriter(args[1], "vec") as w:
        for k, v in _table(args[0], "vec").items():
            x = np.asarray(v, np.float64)
            norm = np.linalg.norm(x)
            ratio = norm / np.sqrt(len(x))
            ratios.append(ratio)
            if o.normalize and norm > 0:
                x = x * (1.0 / (ratio if o.scaleup else norm))
            w[k] = x.astype(np.float32)
    if ratios:
        log.info("ivector-normalize-length: avg ratio %.4f over %d", float(np.mean(ratios)),
                 len(ratios))
    return 0


@tool("ivector-compute-lda")
def ivector_compute_lda(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.transform.lda import LdaEstimate
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    class Opts:
        dim = 100
        total_covariance_factor = 0.0

    o = Opts()
    po = ParseOptions("ivector-compute-lda [--dim=100] <ivec-rspecifier> "
                      "<utt2spk-rxfilename> <lda-matrix-out>")
    po.register("dim", o, "dim")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    utt2spk = _read_map(args[1])
    spk_id = {s: i for i, s in enumerate(sorted(set(utt2spk.values())))}
    ivecs = _table(args[0], "vec")
    dim = len(next(iter(ivecs.values())))
    lda = LdaEstimate(len(spk_id), dim, CPU)
    keys = [u for u in ivecs if u in utt2spk]
    lda.accumulate(np.stack([ivecs[u] for u in keys]),
                   np.asarray([spk_id[utt2spk[u]] for u in keys]))
    mat = lda.estimate(min(o.dim, dim))
    with open(args[2], "wb") as f:
        iof.init_kaldi_output_stream(f, True)
        iof.write_matrix(f, mat.astype(np.float64), dtype=np.float64)
    return 0


@tool("ivector-transform")
def ivector_transform(argv: List[str]) -> int:
    """A global linear (or affine) transform of iVectors."""
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("ivector-transform <matrix-rxfilename> <ivec-rspecifier> "
                      "<ivec-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    with open(args[0], "rb") as f:
        iof.init_kaldi_input_stream(f)
        mat = np.asarray(iof.read_matrix(f), np.float64)
    with TableWriter(args[2], "vec") as w:
        for k, v in _table(args[1], "vec").items():
            x = np.asarray(v, np.float64)
            if mat.shape[1] == len(x) + 1:
                x = np.append(x, 1.0)
            w[k] = (mat @ x).astype(np.float32)
    return 0


@tool("ivector-compute-plda")
def ivector_compute_plda(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.plda import PldaStats, estimate_plda

    class Opts:
        num_em_iters = 10

    o = Opts()
    po = ParseOptions("ivector-compute-plda <spk2utt-rxfilename> <ivec-rspecifier> <plda-out>")
    po.register("num-em-iters", o, "num_em_iters")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    spk2utt = _read_map_list(args[0])
    ivecs = _table(args[1], "vec")
    stats = PldaStats(dim=len(next(iter(ivecs.values()))))
    for spk, utts in spk2utt.items():
        got = [ivecs[u] for u in utts if u in ivecs]
        if len(got) < 2:
            log.warning("ivector-compute-plda: skipping %s (%d examples)", spk, len(got))
            continue
        stats.add_samples(np.stack(got))
    estimate_plda(stats, num_em_iters=o.num_em_iters).save(args[2])
    return 0


@tool("ivector-plda-scoring")
def ivector_plda_scoring(argv: List[str]) -> int:
    """Every trial's log-likelihood ratio, the trials scored as one batch."""
    import torch

    from old_kaldi_git_tpu_torch.ivector.plda import Plda

    class Opts:
        num_utts = ""
        normalize_length = True

    o = Opts()
    po = ParseOptions("ivector-plda-scoring [--num-utts=rspec] <plda> "
                      "<enroll-ivec-rspecifier> <test-ivec-rspecifier> <trials-in> "
                      "<scores-out>")
    po.register("num-utts", o, "num_utts")
    po.register("normalize-length", o, "normalize_length")
    args = po.parse(argv)
    if len(args) != 5:
        return _usage(po)
    plda = Plda.load(args[0])

    def transformed(rspec):
        vecs = _table(rspec, "vec")
        if not vecs:
            return {}
        u = plda.transform_ivectors(np.stack(list(vecs.values())), o.normalize_length, CPU)
        return {k: i for i, k in enumerate(vecs)}, u

    enroll, test = transformed(args[1]), transformed(args[2])
    nutts: Dict[str, int] = {}
    if o.num_utts:
        nutts = {k: int(v) for k, v in _table(o.num_utts, "flt").items()}
    trials, n_miss = [], 0
    with open(args[3]) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) < 2:
                continue
            e, t = parts[0], parts[1]
            if not enroll or not test or e not in enroll[0] or t not in test[0]:
                n_miss += 1
                continue
            trials.append((e, t))
    with open(args[4], "w") as out:
        if trials:
            scores = plda.log_likelihood_ratios(
                enroll[1][[enroll[0][e] for e, _ in trials]],
                torch.tensor([nutts.get(e, 1) for e, _ in trials]),
                test[1][[test[0][t] for _, t in trials]]).numpy()
            for (e, t), score in zip(trials, scores):
                print(f"{e} {t} {float(score):.6f}", file=out)
    log.info("scored %d trials (%d missing)", len(trials), n_miss)
    return 0 if trials else 1


@tool("select-voiced-frames")
def select_voiced_frames(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("select-voiced-frames <feats-rspecifier> <vad-rspecifier> "
                      "<feats-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    vad = RandomAccessTableReader(args[1], "vec")
    with TableWriter(args[2], "mat") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            if key not in vad:
                log.warning("select-voiced-frames: no VAD for %s", key)
                continue
            mask = np.asarray(vad[key]) > 0.5
            x = np.asarray(f)[: len(mask)][mask[: len(f)]]
            if len(x):
                w[key] = x
    return 0


def compute_eer(target: np.ndarray, nontarget: np.ndarray):
    """(eer, threshold): where the false-alarm rate meets the miss rate."""
    if len(target) == 0 or len(nontarget) == 0:
        raise KaldiError("compute_eer: need both target and nontarget scores")
    thresholds = np.unique(np.concatenate([target, nontarget]))
    miss = np.mean(target[None, :] < thresholds[:, None], axis=1)
    fa = np.mean(nontarget[None, :] >= thresholds[:, None], axis=1)
    i = int(np.argmin(np.abs(miss - fa)))
    return 0.5 * float(miss[i] + fa[i]), float(thresholds[i])


@tool("compute-eer")
def compute_eer_tool(argv: List[str]) -> int:
    """The equal error rate of '<score> target|nontarget' lines."""
    po = ParseOptions("compute-eer <scores-rxfilename (- for stdin)>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    f = sys.stdin if args[0] == "-" else open(args[0])
    target, nontarget = [], []
    with f:
        for ln in f:
            parts = ln.split()
            if len(parts) != 2:
                continue
            (target if parts[1] == "target" else nontarget).append(float(parts[0]))
    eer, thresh = compute_eer(np.asarray(target), np.asarray(nontarget))
    print(f"{100 * eer:.4f}")
    log.info("EER %.4f%% at threshold %.6f (%d target, %d nontarget)", 100 * eer, thresh,
             len(target), len(nontarget))
    return 0


# ---------------------------------------------------------------------------
# logistic regression (the language-id back end, host)
# ---------------------------------------------------------------------------

@tool("logistic-regression-train")
def logistic_regression_train_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.logistic_regression import (
        LogisticRegressionConfig, train_logistic_regression)
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    cfg = LogisticRegressionConfig()
    po = ParseOptions("logistic-regression-train <ivec-rspecifier> <utt2label-rxfilename> "
                      "<model-out>   (labels are integers or arbitrary strings)")
    po.register("max-steps", cfg, "max_steps")
    po.register("normalizer", cfg, "normalizer")
    po.register("mix-up", cfg, "mix_up")
    po.register("power", cfg, "power")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    utt2label = _read_map(args[1])
    lab_id = {s: i for i, s in enumerate(sorted(set(utt2label.values())))}
    xs, ys = [], []
    for k, v in _table(args[0], "vec").items():
        if k in utt2label:
            xs.append(v)
            ys.append(lab_id[utt2label[k]])
    train_logistic_regression(np.stack(xs), ys, cfg, device=CPU).save(args[2])
    log.info("trained logistic regression: %d classes, %d examples", len(lab_id), len(xs))
    return 0


@tool("logistic-regression-eval")
def logistic_regression_eval_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.ivector.logistic_regression import LogisticRegression
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    po = ParseOptions("logistic-regression-eval <model-in> <ivec-rspecifier> "
                      "<log-post-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    model = LogisticRegression.load(args[0])
    vecs = _table(args[1], "vec")
    with TableWriter(args[2], "vec") as w:
        if vecs:
            post = model.log_posteriors(np.stack(list(vecs.values())), CPU).numpy()
            for k, p in zip(vecs, post):
                w[k] = p.astype(np.float32)
    return 0
