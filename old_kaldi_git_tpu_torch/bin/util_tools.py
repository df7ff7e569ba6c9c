"""Data-dir, info and utility tools (counterpart of
old_kaldi_git_tpu/bin/util_tools.py; the reference's utils/*.pl scripts,
the *-info tools and a few bin rows).

Host code, as in the JAX package, under its tools' names, options and exit
codes, except ivector-extract-online2, which takes --device and extracts
the online iVectors in float64 on the card.  Registered as an import side
effect of bin/tools.py.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import (
    _host_model, _symbols, _usage, _write_fst, device_option, tool)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("util_tools")


def _open_r(path: str):
    return sys.stdin if path == "-" else open(path)


def _open_w(path: str):
    return sys.stdout if path == "-" else open(path, "w")


def _close(*files) -> None:
    for f in files:
        if f not in (sys.stdin, sys.stdout):
            f.close()


def _write_spk2utt(out, spk2utt: Dict[str, List[str]]) -> None:
    for spk in sorted(spk2utt):
        out.write(f"{spk} {' '.join(sorted(spk2utt[spk]))}\n")


@tool("utt2spk-to-spk2utt")
def utt2spk_to_spk2utt_tool(argv: List[str]) -> int:
    po = ParseOptions("utt2spk-to-spk2utt <utt2spk-file|-> [<spk2utt-file|->]")
    args = po.parse(argv)
    if len(args) not in (1, 2):
        return _usage(po)
    fin = _open_r(args[0])
    spk2utt: dict = {}
    for ln in fin:
        parts = ln.split()
        if len(parts) == 2:
            spk2utt.setdefault(parts[1], []).append(parts[0])
    _close(fin)
    out = _open_w(args[1] if len(args) == 2 else "-")
    _write_spk2utt(out, spk2utt)
    _close(out)
    return 0


@tool("spk2utt-to-utt2spk")
def spk2utt_to_utt2spk_tool(argv: List[str]) -> int:
    po = ParseOptions("spk2utt-to-utt2spk <spk2utt-file|-> [<utt2spk-file|->]")
    args = po.parse(argv)
    if len(args) not in (1, 2):
        return _usage(po)
    fin = _open_r(args[0])
    pairs = [(u, parts[0]) for parts in (ln.split() for ln in fin) for u in parts[1:]]
    _close(fin)
    out = _open_w(args[1] if len(args) == 2 else "-")
    for u, s in sorted(pairs):
        out.write(f"{u} {s}\n")
    _close(out)
    return 0


@tool("validate-data-dir")
def validate_data_dir_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.data_dir import DataDir

    po = ParseOptions("validate-data-dir <data-dir>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    try:
        d = DataDir(args[0])
        d.validate()
    except KaldiError as e:
        print(f"validate-data-dir: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"validate-data-dir: OK ({len(d.utts)} utterances)")
    return 0


@tool("split-data")
def split_data_tool(argv: List[str]) -> int:
    """Shard a data dir into <data>/split<N>/{1..N}/, speakers kept together
    (reference utils/split_data.sh)."""
    from old_kaldi_git_tpu_torch.utils.data_dir import DataDir

    po = ParseOptions("split-data <data-dir> <num-splits>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    d = DataDir(args[0])
    n = int(args[1])
    maps = ("wav.scp", "text", "utt2spk", "feats.scp", "segments", "utt2dur", "cmvn.scp")
    for i, utts in enumerate(d.split(n), start=1):
        sub = os.path.join(args[0], f"split{n}", str(i))
        os.makedirs(sub, exist_ok=True)
        keep = set(utts)
        for name in maps:
            src = os.path.join(args[0], name)
            if not os.path.exists(src):
                continue
            with open(src) as f, open(os.path.join(sub, name), "w") as g:
                for ln in f:
                    parts = ln.split(None, 1)
                    if parts and parts[0] in keep:
                        g.write(ln)
        # spk2utt made anew from the shard's utt2spk
        u2s = os.path.join(sub, "utt2spk")
        if os.path.exists(u2s):
            spk2utt: dict = {}
            with open(u2s) as f:
                for ln in f:
                    p = ln.split()
                    if len(p) == 2:
                        spk2utt.setdefault(p[1], []).append(p[0])
            with open(os.path.join(sub, "spk2utt"), "w") as g:
                _write_spk2utt(g, spk2utt)
    log.info("split %d utterances into %d shards", len(d.utts), n)
    return 0


def _read_tree(path: str):
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    with open(path, "rb") as f:
        return ContextDependency.read(f)


@tool("tree-info")
def tree_info_tool(argv: List[str]) -> int:
    po = ParseOptions("tree-info <tree-file>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    cd = _read_tree(args[0])
    print(f"num-pdfs {cd.num_pdfs}")
    print(f"context-width {cd.N}")
    print(f"central-position {cd.P}")
    return 0


@tool("am-info")
def am_info_tool(argv: List[str]) -> int:
    po = ParseOptions("am-info <gmm-model>")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    m = _host_model(args[0])
    print(f"number of phones {len(m.tm.topo.phones)}")
    print(f"number of pdfs {m.am.num_pdfs}")
    print(f"number of transition-ids {m.tm.num_tids}")
    print(f"feature dimension {m.am.dim}")
    print(f"number of gaussians {m.am.num_gauss}")
    return 0


@tool("wav-copy")
def wav_copy_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("wav-copy <wav-rspecifier> <wav-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    n = 0
    with TableWriter(args[1], "wav") as w:
        for key, wave in SequentialTableReader(args[0], "wav"):
            w[key] = wave
            n += 1
    log.info("copied %d waves", n)
    return 0


@tool("est-pca")
def est_pca_tool(argv: List[str]) -> int:
    """PCA transform from features (reference bin/est-pca.cc; iVector
    whitening and dimension reduction), in float64 numpy on the host."""
    from old_kaldi_git_tpu_torch.utils.io_funcs import BINARY_HEADER, write_matrix
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("est-pca [options] <feats-rspecifier> <pca-matrix-out>")

    class Opts:
        dim = 0  # 0 = keep all
        normalize_variance = False
        normalize_mean = True

    o = Opts()
    po.register("dim", o, "dim")
    po.register("normalize-variance", o, "normalize_variance")
    po.register("normalize-mean", o, "normalize_mean")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    n = 0
    s1 = s2 = None
    for _k, f in SequentialTableReader(args[0], "mat"):
        f = np.asarray(f, np.float64)
        if s1 is None:
            s1, s2 = f.sum(0), f.T @ f
        else:
            s1 += f.sum(0)
            s2 += f.T @ f
        n += f.shape[0]
    if not n:
        log.error("no features")
        return 1
    mean = s1 / n
    evals, evecs = np.linalg.eigh(s2 / n - np.outer(mean, mean))
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    dim = o.dim if o.dim > 0 else len(evals)
    T = evecs[:, :dim].T  # [dim, D]
    if o.normalize_variance:
        T = T / np.sqrt(np.maximum(evals[:dim], 1e-10))[:, None]
    if o.normalize_mean:  # affine: -T·mean as the last column (Kaldi's convention)
        T = np.concatenate([T, (-T @ mean)[:, None]], axis=1)
    with open(args[1], "wb") as fo:
        fo.write(BINARY_HEADER)
        write_matrix(fo, T.astype(np.float32))
    log.info("PCA: %d frames, kept %d of %d dims (top eval %.3g)",
             n, dim, len(evals), float(evals[0]))
    return 0


@tool("modify-cmvn-stats")
def modify_cmvn_stats_tool(argv: List[str]) -> int:
    """Make selected dimensions of CMVN stats look zero-mean, unit-variance
    (src/featbin/modify-cmvn-stats.cc: normalisation off for them, e.g.
    pitch)."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("modify-cmvn-stats [options] <fake-dims-colon|''> "
                      "<stats-rspecifier> <stats-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    fake = [int(x) for x in args[0].split(":") if x]
    with TableWriter(args[2], "mat") as w:
        for key, st in SequentialTableReader(args[1], "mat"):
            st = np.array(st, np.float64)
            dim = st.shape[1] - 1
            count = st[0, dim]
            for d in fake:
                if 0 <= d < dim:
                    st[0, d] = 0.0  # sum → mean 0
                    st[1, d] = count  # sum of squares → variance 1
            w[key] = st
    return 0


@tool("extract-feature-segments")
def extract_feature_segments_tool(argv: List[str]) -> int:
    """Cut feature matrices by a segments file (frame ranges from times;
    src/featbin/extract-feature-segments.cc)."""
    from old_kaldi_git_tpu_torch.utils.table import RandomAccessTableReader, TableWriter

    po = ParseOptions("extract-feature-segments [options] <feats-rspecifier> "
                      "<segments-file> <feats-wspecifier>")

    class Opts:
        frame_shift = 0.01

    o = Opts()
    po.register("frame-shift", o, "frame_shift")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    feats = RandomAccessTableReader(args[0], "mat")
    n = 0
    with TableWriter(args[2], "mat") as w, open(args[1]) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) != 4:
                continue
            seg, rec, t0, t1 = parts[0], parts[1], float(parts[2]), float(parts[3])
            if rec not in feats:
                log.warning("no features for recording %s", rec)
                continue
            m = feats[rec]
            lo = int(round(t0 / o.frame_shift))
            hi = min(int(round(t1 / o.frame_shift)), m.shape[0])
            if hi - lo < 1:
                log.warning("empty segment %s", seg)
                continue
            w[seg] = m[lo:hi]
            n += 1
    log.info("extracted %d feature segments", n)
    return 0


@tool("show-alignments")
def show_alignments_tool(argv: List[str]) -> int:
    """Human-readable alignments: each utterance's phone segments with their
    frame spans (src/bin/show-alignments.cc, simplified)."""
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import split_to_phones
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("show-alignments <phones-symtab|''> <model> <ali-rspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    phones_tab = _symbols(args[0])
    tm = _host_model(args[1]).tm
    for key, ali in SequentialTableReader(args[2], "ivec"):
        t = 0
        parts = []
        for seg in split_to_phones(tm, ali):
            ph = tm.tid_to_phone(seg[0])
            parts.append(f"{phones_tab[ph] if phones_tab else ph}[{t}:{t + len(seg)}]")
            t += len(seg)
        print(f"{key} {' '.join(parts)}")
    return 0


@tool("ivector-extract-online2")
def ivector_extract_online2_tool(argv: List[str]) -> int:
    """Online iVectors re-estimated every --ivector-period frames from the
    cumulative statistics (src/online2bin/ivector-extract-online2.cc; rows
    repeat within a period, as the reference's feature does), in float64 on
    the card."""
    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, extract_online_ivectors)
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("ivector-extract-online2 [options] <extractor> <feats-rspecifier> "
                      "<ivectors-wspecifier>")

    class Opts:
        ivector_period = 10
        max_count = 0.0
        stats_scale = 1.0

    o = Opts()
    po.register("ivector-period", o, "ivector_period")
    po.register("max-count", o, "max_count")
    po.register("stats-scale", o, "stats_scale")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    ext = IvectorExtractor.load(args[0], device=device())
    n = 0
    with TableWriter(args[2], "mat") as w:
        for key, f in SequentialTableReader(args[1], "mat"):
            w[key] = extract_online_ivectors(ext, np.asarray(f, np.float32), o.ivector_period,
                                             o.stats_scale, o.max_count).cpu().numpy()
            n += 1
    log.info("extracted online ivectors for %d utterances", n)
    return 0


@tool("fstaddselfloops")
def fstaddselfloops_tool(argv: List[str]) -> int:
    """Add disambiguation-symbol self-loops (reference
    fstbin/fstaddselfloops.cc): parallel lists of input and output ids, the
    loops at the start, final and word-emitting states."""
    from old_kaldi_git_tpu_torch.fst.algorithms import add_disambig_self_loops
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst

    po = ParseOptions("fstaddselfloops <disambig-in-list> <disambig-out-list> "
                      "[<fst-in> [<fst-out>]]  (lists: files of integer ids)")
    args = po.parse(argv)
    if len(args) < 2 or len(args) > 4:
        return _usage(po)

    def read_ids(path):
        with open(path) as f:
            return [int(tok) for tok in f.read().split()]

    isyms, osyms = read_ids(args[0]), read_ids(args[1])
    if len(isyms) != len(osyms):
        raise KaldiError("disambig lists differ in length")
    fst_in = args[2] if len(args) > 2 else "-"
    fst_out = args[3] if len(args) > 3 else "-"
    if fst_in == "-":
        fst = VectorFst.read(sys.stdin.buffer)
    else:
        with open(fst_in, "rb") as f:
            fst = VectorFst.read(f)
    add_disambig_self_loops(fst, list(zip(isyms, osyms)))
    if fst_out == "-":
        fst.write(sys.stdout.buffer)
        sys.stdout.buffer.flush()
        return 0
    return _write_fst(fst, fst_out)


@tool("draw-tree")
def draw_tree_tool(argv: List[str]) -> int:
    """Graphviz dot of the phonetic decision tree (reference bin/draw-tree.cc):
    phones named through the symbol table; key -1 is the pdf-class, the
    others context positions."""
    from old_kaldi_git_tpu_torch.tree.event_map import (
        ConstantEventMap, SplitEventMap, TableEventMap)

    po = ParseOptions("draw-tree <phone-symbol-table> <tree-file>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    syms = _symbols(args[0])
    cd = _read_tree(args[1])
    lines = ["digraph tree {", "  node [shape=box];"]
    counter = [0]

    def label(key: int, v: int) -> str:
        if key == -1:
            return str(v)
        return str(syms[v] if v in syms else v)

    def key_name(key: int) -> str:
        return "pdf-class" if key == -1 else f"ctx[{key}]"

    def walk(em) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        if isinstance(em, ConstantEventMap):
            lines.append(f'  {nid} [shape=ellipse, label="pdf {em.answer}"];')
        elif isinstance(em, SplitEventMap):
            vals = sorted(em.yes_set)
            shown = ",".join(label(em.key, v) for v in vals[:8])
            if len(vals) > 8:
                shown += ",..."
            lines.append(f'  {nid} [label="{key_name(em.key)} in {{{shown}}}?"];')
            y, n = walk(em.yes), walk(em.no)
            lines.append(f'  {nid} -> {y} [label="yes"];')
            lines.append(f'  {nid} -> {n} [label="no"];')
        elif isinstance(em, TableEventMap):
            lines.append(f'  {nid} [label="table on {key_name(em.key)}"];')
            for v, sub in sorted(em.table.items()):
                c = walk(sub)
                lines.append(f'  {nid} -> {c} [label="{label(em.key, v)}"];')
        else:
            lines.append(f'  {nid} [label="{type(em).__name__}"];')
        return nid

    walk(cd.root)
    lines.append("}")
    print("\n".join(lines))
    return 0


@tool("analyze-counts")
def analyze_counts_tool(argv: List[str]) -> int:
    """Occurrences of each integer id in alignments, printed as a Kaldi
    vector (reference bin/analyze-counts.cc; priors and data checks)."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("analyze-counts [options] <int-vector-rspecifier> <counts-out|->")

    class Opts:
        counts_dim = 0

    o = Opts()
    po.register("counts-dim", o, "counts_dim")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    counts: Dict[int, int] = {}
    n_utts = 0
    for _key, vec in SequentialTableReader(args[0], "ivec"):
        n_utts += 1
        for v in np.asarray(vec).tolist():
            counts[int(v)] = counts.get(int(v), 0) + 1
    arr = np.zeros(max(o.counts_dim, (max(counts) + 1) if counts else 0), np.float64)
    for k, c in counts.items():
        arr[k] = c
    text = "[ " + " ".join(str(int(x)) for x in arr) + " ]"
    if args[1] == "-":
        print(text)
    else:
        with open(args[1], "w") as f:
            f.write(text + "\n")
    log.info("analyze-counts: %d utterances, %d distinct ids, %d frames",
             n_utts, len(counts), int(arr.sum()))
    return 0


@tool("fstrand")
def fstrand_tool(argv: List[str]) -> int:
    """Write a random FST (reference fstbin/fstrand.cc, fstext/rand-fst.h:
    the equivalence tests' generator); --srand gives the JAX tool's FST."""
    import random

    from old_kaldi_git_tpu_torch.fst.rand import rand_fst

    po = ParseOptions("fstrand [options] <fst-out>")

    class Opts:
        num_states = 6
        num_arcs = 10
        num_labels = 3
        seed = 0
        acyclic = False

    o = Opts()
    po.register("num-states", o, "num_states")
    po.register("num-arcs", o, "num_arcs")
    po.register("num-labels", o, "num_labels")
    po.register("srand", o, "seed")
    po.register("acyclic", o, "acyclic")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    fst = rand_fst(random.Random(o.seed), o.num_states, o.num_arcs, o.num_labels,
                   o.num_labels, acyclic=o.acyclic)
    return _write_fst(fst, args[0])


@tool("subset-feats")
def subset_feats_tool(argv: List[str]) -> int:
    """Copy a subset of a feature table (reference featbin/subset-feats.cc:
    the first --n utterances, or an --include list)."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("subset-feats [options] <feats-rspecifier> <feats-wspecifier>")

    class Opts:
        n = 10
        include = ""

    o = Opts()
    po.register("n", o, "n")
    po.register("include", o, "include")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    include = None
    if o.include:
        with open(o.include) as f:
            include = {line.split()[0] for line in f if line.strip()}
    n = 0
    with TableWriter(args[1], "mat") as w:
        for key, m in SequentialTableReader(args[0], "mat"):
            if include is not None:
                if key not in include:
                    continue
            elif n >= o.n:
                break
            w[key] = m
            n += 1
    log.info("subset-feats: wrote %d utterances", n)
    return 0


@tool("feat-to-post")
def feat_to_post_tool(argv: List[str]) -> int:
    """Feature rows → posterior entries (reference featbin/feat-to-post.cc):
    each frame's --top-n largest (index, value) pairs, the generic soft-target
    format."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("feat-to-post [options] <feats-rspecifier> <post-wspecifier>")

    class Opts:
        top_n = 10

    o = Opts()
    po.register("top-n", o, "top_n")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "post") as w:
        for key, m in SequentialTableReader(args[0], "mat"):
            m = np.asarray(m)
            k = min(o.top_n, m.shape[1])
            idx = np.argpartition(-m, k - 1, axis=1)[:, :k]
            w[key] = [[(c, float(m[t, c])) for c in sorted(int(c) for c in idx[t])]
                      for t in range(len(m))]
    return 0


# ---------------------------------------------------------------------------
# the utils/ script family (reference utils/sym2int.pl, int2sym.pl,
# apply_map.pl, filter_scp.pl, subset_data_dir.sh, compute-wer-bootci)
# ---------------------------------------------------------------------------

def _map_lines(args: List[str], fn) -> None:
    """Each line of args[1] (a file or -), split, mapped by fn to tokens,
    written as a line to args[2] (a file or -)."""
    fin, fout = _open_r(args[1]), _open_w(args[2])
    try:
        for line in fin:
            fout.write(" ".join(fn(line.split())) + "\n")
    finally:
        _close(fin, fout)


@tool("sym2int")
def sym2int_tool(argv: List[str]) -> int:
    """Symbols → integer ids through a symbol table (reference
    utils/sym2int.pl; the first field, the utterance id, is kept)."""
    po = ParseOptions("sym2int [options] <symtab> <text-in|-> <text-out|->")

    class Opts:
        map_oov = ""
        skip_first_field = True

    o = Opts()
    po.register("map-oov", o, "map_oov")
    po.register("skip-first-field", o, "skip_first_field")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    syms = _symbols(args[0])
    oov = syms[o.map_oov] if o.map_oov else None
    n_oov = [0]

    def to_ids(parts):
        start = 1 if (o.skip_first_field and parts) else 0
        out = parts[:start]
        for w in parts[start:]:
            if w in syms:
                out.append(str(syms[w]))
            elif oov is not None:
                out.append(str(oov))
                n_oov[0] += 1
            else:
                raise KaldiError(f"sym2int: OOV {w!r} and no --map-oov given")
        return out

    _map_lines(args, to_ids)
    if n_oov[0]:
        log.warning("sym2int: mapped %d OOV tokens", n_oov[0])
    return 0


@tool("int2sym")
def int2sym_tool(argv: List[str]) -> int:
    """Integer ids → symbols (reference utils/int2sym.pl)."""
    po = ParseOptions("int2sym [options] <symtab> <text-in|-> <text-out|->")

    class Opts:
        skip_first_field = True

    o = Opts()
    po.register("skip-first-field", o, "skip_first_field")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    syms = _symbols(args[0])

    def to_syms(parts):
        start = 1 if (o.skip_first_field and parts) else 0
        return parts[:start] + [syms[int(w)] for w in parts[start:]]

    _map_lines(args, to_syms)
    return 0


@tool("apply-map")
def apply_map_tool(argv: List[str]) -> int:
    """Replace each token after the key through a map file (reference
    utils/apply_map.pl); --permissive keeps unmapped tokens."""
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    po = ParseOptions("apply-map [options] <map-file> <text-in|-> <text-out|->")

    class Opts:
        permissive = False

    o = Opts()
    po.register("permissive", o, "permissive")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    mapping = _read_map(args[0])

    def mapped(parts):
        out = parts[:1]
        for w in parts[1:]:
            if w in mapping:
                out.append(mapping[w])
            elif o.permissive:
                out.append(w)
            else:
                raise KaldiError(f"apply-map: no mapping for {w!r}")
        return out

    _map_lines(args, mapped)
    return 0


@tool("filter-scp")
def filter_scp_tool(argv: List[str]) -> int:
    """Keep the lines whose key is in an id list (reference
    utils/filter_scp.pl; --exclude inverts)."""
    po = ParseOptions("filter-scp [options] <id-list> <in|-> <out|->")

    class Opts:
        exclude = False

    o = Opts()
    po.register("exclude", o, "exclude")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    with open(args[0]) as f:
        ids = {line.split()[0] for line in f if line.strip()}
    fin, fout = _open_r(args[1]), _open_w(args[2])
    n = 0
    try:
        for line in fin:
            parts = line.split()
            if parts and (parts[0] in ids) != o.exclude:
                fout.write(line if line.endswith("\n") else line + "\n")
                n += 1
    finally:
        _close(fin, fout)
    log.info("filter-scp: kept %d lines", n)
    return 0


@tool("subset-data-dir")
def subset_data_dir_tool(argv: List[str]) -> int:
    """Subset a data dir (reference utils/subset_data_dir.sh): the first N
    utterances, an --utt-list, or --per-spk N utterances a speaker."""
    from old_kaldi_git_tpu_torch.utils.data_dir import DataDir, _write_map

    po = ParseOptions("subset-data-dir [options] <src-data-dir> <n> <dest-data-dir>")

    class Opts:
        utt_list = ""
        per_spk = False

    o = Opts()
    po.register("utt-list", o, "utt_list")
    po.register("per-spk", o, "per_spk")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    src = DataDir(args[0], require_text=False)
    n = int(args[1])
    if o.utt_list:
        have = set(src.utts)
        with open(o.utt_list) as f:
            keep = [u for u in (line.split()[0] for line in f if line.strip()) if u in have]
    elif o.per_spk:
        keep = [u for _spk, utts in sorted(src.spk2utt.items()) for u in sorted(utts)[:n]]
    else:
        keep = sorted(src.utts)[:n]
    keep_set = set(keep)
    os.makedirs(args[2], exist_ok=True)
    for name, mapping in (("wav.scp", src.wav_scp), ("text", src.text),
                          ("utt2spk", src.utt2spk), ("feats.scp", src.feats_scp),
                          ("segments", src.segments)):
        if mapping:
            _write_map(os.path.join(args[2], name),
                       {k: v for k, v in mapping.items() if k in keep_set})
    log.info("subset-data-dir: %d of %d utterances", len(keep), len(src.utts))
    return 0


@tool("compute-wer-bootci")
def compute_wer_bootci_tool(argv: List[str]) -> int:
    """WER with a bootstrap confidence interval (reference
    bin/compute-wer-bootci.cc, Bisani & Ney 2004): utterances resampled with
    replacement by numpy's generator seeded --srand (the JAX tool's draws),
    the 95 % interval reported."""
    from old_kaldi_git_tpu_torch.utils.edit_distance import edit_distance
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("compute-wer-bootci [options] <ref-rspecifier> <hyp-rspecifier>")

    class Opts:
        replications = 10000
        seed = 0

    o = Opts()
    po.register("replications", o, "replications")
    po.register("srand", o, "seed")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    refs = dict(SequentialTableReader(args[0], "text"))
    hyps = dict(SequentialTableReader(args[1], "text"))
    keys = sorted(set(refs) & set(hyps))
    if not keys:
        raise KaldiError("no overlapping utterances")
    errs = np.asarray([edit_distance(refs[k].split(), hyps[k].split()).errors for k in keys],
                      np.float64)
    lens = np.asarray([len(refs[k].split()) for k in keys], np.float64)
    wer = 100.0 * errs.sum() / max(lens.sum(), 1.0)
    idx = np.random.default_rng(o.seed).integers(0, len(keys),
                                                 size=(o.replications, len(keys)))
    boot = 100.0 * errs[idx].sum(axis=1) / np.maximum(lens[idx].sum(axis=1), 1.0)
    lo, hi = np.percentile(boot, [2.5, 97.5])
    print(f"Set up with {len(keys)} utterances.")
    print(f"WER {wer:.2f} 95% conf interval [ {lo:.2f}, {hi:.2f} ]")
    return 0
