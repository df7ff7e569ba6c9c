"""Second batch of CLI tools (counterpart of old_kaldi_git_tpu/bin/lat_tools.py):
latbin, posterior, vector, feature-info, fstbin, lmbin and gmmbin extras.

Thin wrappers over the port's library, under the JAX tools' names, options,
defaults and exit codes (reference src/latbin, src/bin, src/fstbin,
src/gmmbin).  Registered as an import side effect of bin/tools.py.  Six of
them make tensors and take --device: gmm-decode-faster and
gmm-rescore-lattice score a whole table's features in one padded launch of
the GMM kernel, gmm-acc-stats accumulates every posterior entry of the table
in one float64 call on the card, and rnnlm-train / lattice-lmrescore-rnnlm
run the RNNLM there; the rest are host code.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import (
    _host_model, _read_fst, _symbols, _usage, _words_text, _write_fst, device_option, tool)
from old_kaldi_git_tpu_torch.utils.log import get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("lat_tools")


def _scale_options(po: ParseOptions, acoustic_scale: float = 0.1):
    """--lm-scale (1.0) and --acoustic-scale on an options object."""

    class Opts:
        lm_scale = 1.0

    o = Opts()
    o.acoustic_scale = acoustic_scale
    po.register("lm-scale", o, "lm_scale")
    po.register("acoustic-scale", o, "acoustic_scale")
    return o


# ---------------------------------------------------------------------------
# latbin
# ---------------------------------------------------------------------------

@tool("lattice-1best")
def lattice_1best_tool(argv: List[str]) -> int:
    """Best path per lattice as a linear lattice (src/latbin/lattice-1best.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import (
        lattice_nbest_paths, linear_lattice_from_path)
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-1best [options] <lat-rspecifier> <lat-wspecifier>")
    o = _scale_options(po)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            paths = lattice_nbest_paths(lat, 1, o.lm_scale, o.acoustic_scale)
            if not paths:
                log.warning("empty lattice for %s", key)
                continue
            w[key] = linear_lattice_from_path(*paths[0])
    return 0


@tool("lattice-copy")
def lattice_copy_tool(argv: List[str]) -> int:
    """Copy lattices between archives (src/latbin/lattice-copy.cc);
    --compact copies CompactLattice archives instead."""
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-copy [options] <lat-rspecifier> <lat-wspecifier>")

    class Opts:
        compact = False

    o = Opts()
    po.register("compact", o, "compact")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    holder = "clat" if o.compact else "lat"
    n = 0
    with TableWriter(args[1], holder) as w:
        for key, lat in SequentialTableReader(args[0], holder):
            w[key] = lat
            n += 1
    log.info("copied %d lattices", n)
    return 0


def _map_arcs(lat, fn) -> None:
    """Replace each arc a of every state by fn(state, a), in place."""
    for s in range(lat.num_states):
        lat.arcs[s] = [fn(s, a) for a in lat.arcs[s]]


@tool("lattice-add-penalty")
def lattice_add_penalty_tool(argv: List[str]) -> int:
    """Add a word insertion penalty to the graph cost of every word arc
    (src/latbin/lattice-add-penalty.cc AddWordInsPenToCompactLattice)."""
    from old_kaldi_git_tpu_torch.lat.lattice import LatticeArc
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-add-penalty [options] <lat-rspecifier> <lat-wspecifier>")

    class Opts:
        word_ins_penalty = 0.0

    o = Opts()
    po.register("word-ins-penalty", o, "word_ins_penalty")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            _map_arcs(lat, lambda _s, a: LatticeArc(
                a.ilabel, a.olabel, a.graph_cost + (o.word_ins_penalty if a.olabel else 0.0),
                a.acoustic_cost, a.nextstate))
            w[key] = lat
    return 0


@tool("lattice-rmali")
def lattice_rmali_tool(argv: List[str]) -> int:
    """Strip transition-id alignments (src/latbin/lattice-rmali.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import LatticeArc
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-rmali <lat-rspecifier> <lat-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "lat") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            _map_arcs(lat, lambda _s, a: LatticeArc(0, a.olabel, a.graph_cost,
                                                    a.acoustic_cost, a.nextstate))
            w[key] = lat
    return 0


@tool("lattice-to-post")
def lattice_to_post_tool(argv: List[str]) -> int:
    """Per-frame posteriors from lattices (src/latbin/lattice-to-post.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_to_post
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-to-post [options] <model> <lat-rspecifier> <post-wspecifier>")
    o = _scale_options(po)
    o.min_post = 0.01
    po.register("min-post", o, "min_post")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    with TableWriter(args[2], "post") as w:
        for key, lat in SequentialTableReader(args[1], "lat"):
            w[key] = lattice_to_post(lat, tm, o.lm_scale, o.acoustic_scale, o.min_post)
    return 0


@tool("lattice-to-ctm-conf")
def lattice_to_ctm_conf_tool(argv: List[str]) -> int:
    """One-best CTM with word times and confidences
    (src/latbin/lattice-to-ctm-conf.cc): CTM text lines."""
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.lat.ctm import lattice_to_ctm_conf
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("lattice-to-ctm-conf [options] <model> <lang-dir> <lat-rspecifier> "
                      "<ctm-file|->")
    o = _scale_options(po)
    o.frame_shift = 0.01
    po.register("frame-shift", o, "frame_shift")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    lang = load_lang_dir(args[1])
    out = sys.stdout if args[3] == "-" else open(args[3], "w")
    try:
        for key, lat in SequentialTableReader(args[2], "lat"):
            for e in lattice_to_ctm_conf(lat, tm, lang, utt=key, lm_scale=o.lm_scale,
                                         ac_scale=o.acoustic_scale,
                                         frame_shift=o.frame_shift):
                out.write(e.line() + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _align_words_tool(argv: List[str], usage: str, aligner_of, exit_code) -> int:
    """lattice-align-words[-lexicon]: each lattice's best path aligned to
    word times by `aligner_of(first argument)(tm, words, tids)` (the model
    is the second), written as 'word start_frame num_frames' triples; the
    exit code is exit_code(aligned, failed)."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(usage)
    o = _scale_options(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    align = aligner_of(args[0])
    tm = _host_model(args[1]).tm
    n_done = n_err = 0
    with TableWriter(args[3], "text") as w:
        for key, lat in SequentialTableReader(args[2], "lat"):
            words, tids, _ = lattice_best_path(lat, o.lm_scale, o.acoustic_scale)
            try:
                ali = align(tm, words, tids)
            except Exception as e:  # noqa: BLE001 — a failed utterance is counted, not fatal
                log.warning("alignment failed for %s: %s", key, e)
                n_err += 1
                continue
            w[key] = " ; ".join(f"{w_} {s} {n}" for w_, s, n in ali)
            n_done += 1
    log.info("aligned %d lattices (%d failed)", n_done, n_err)
    return exit_code(n_done, n_err)


@tool("lattice-align-words-lexicon")
def lattice_align_words_lexicon_tool(argv: List[str]) -> int:
    """Word time alignment of the best path through the lexicon
    (src/latbin/lattice-align-words-lexicon.cc role)."""
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.lat.ctm import align_words_lexicon

    def aligner_of(lang_dir):
        lang = load_lang_dir(lang_dir)
        return lambda tm, words, tids: align_words_lexicon(tm, lang, words, tids)

    return _align_words_tool(argv, "lattice-align-words-lexicon [options] <lang-dir> <model> "
                             "<lat-rspecifier> <align-wspecifier>", aligner_of,
                             lambda done, err: 0 if err == 0 or done else 1)


@tool("lattice-to-fst")
def lattice_to_fst_tool(argv: List[str]) -> int:
    """Word acceptor FSTs from lattices (src/latbin/lattice-to-fst.cc; costs
    combined with the given scales)."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_to_word_fst
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-to-fst [options] <lat-rspecifier> <fst-wspecifier>")
    o = _scale_options(po, acoustic_scale=0.0)
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "fst") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            w[key] = lattice_to_word_fst(lat, o.lm_scale, o.acoustic_scale)
    return 0


@tool("lattice-determinize")
def lattice_determinize_tool(argv: List[str]) -> int:
    """Determinize lattices to CompactLattices, keeping only the best
    alignment of each word sequence (src/latbin/lattice-determinize.cc).
    Utterances are independent: --num-threads determinizes them on an
    ordered host pool, the output in the input's order."""
    from old_kaldi_git_tpu_torch.lat.determinize import determinize_lattice
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter
    from old_kaldi_git_tpu_torch.utils.threads import map_ordered

    po = ParseOptions("lattice-determinize [options] <lat-rspecifier> <clat-wspecifier>")

    class Opts:
        num_threads = 1

    o = Opts()
    po.register("num-threads", o, "num_threads")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)

    def work(kv):
        return kv[0], determinize_lattice(kv[1])

    with TableWriter(args[1], "clat") as w:
        for key, clat in map_ordered(work, SequentialTableReader(args[0], "lat"),
                                     o.num_threads):
            w[key] = clat
    return 0


def _clat_map_tool(argv: List[str], name: str, fn) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(f"{name} <clat-rspecifier> <clat-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "clat") as w:
        for key, clat in SequentialTableReader(args[0], "clat"):
            w[key] = fn(clat)
    return 0


@tool("lattice-push")
def lattice_push_tool(argv: List[str]) -> int:
    """Push CompactLattice weights toward the start (src/latbin/lattice-push.cc)."""
    from old_kaldi_git_tpu_torch.lat.determinize import push_compact_lattice

    return _clat_map_tool(argv, "lattice-push", push_compact_lattice)


@tool("lattice-minimize")
def lattice_minimize_tool(argv: List[str]) -> int:
    """Minimize deterministic CompactLattices (src/latbin/lattice-minimize.cc)."""
    from old_kaldi_git_tpu_torch.lat.determinize import minimize_compact_lattice

    return _clat_map_tool(argv, "lattice-minimize", minimize_compact_lattice)


def _lm_rescore_tool(argv: List[str], usage: str, rescore, extra=()) -> int:
    """The LM-rescoring tools: `rescore(clat, words, lm, o)` on every
    CompactLattice; `extra`: (option, attribute, default) beyond --lm-scale
    and --words."""
    from old_kaldi_git_tpu_torch.lm.arpa import load_lm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions(usage)

    class Opts:
        lm_scale = 1.0
        words = ""

    o = Opts()
    po.register("lm-scale", o, "lm_scale")
    for name, attr, default in extra:
        setattr(o, attr, default)
        po.register(name, o, attr)
    po.register("words", o, "words")
    args = po.parse(argv)
    if len(args) != 3 or not o.words:
        return _usage(po)
    lm = load_lm(args[1])
    words = _symbols(o.words)
    with TableWriter(args[2], "clat") as w:
        for key, clat in SequentialTableReader(args[0], "clat"):
            w[key] = rescore(clat, words, lm, o)
    return 0


@tool("lattice-lmrescore")
def lattice_lmrescore_tool(argv: List[str]) -> int:
    """Add a scaled LM score to CompactLattices; a negative scale removes the
    old LM (src/latbin/lattice-lmrescore.cc semantics, exact composition
    with the ARPA / const-arpa LM instead of an FST G)."""
    from old_kaldi_git_tpu_torch.lat.rescore import lmrescore_compact_lattice

    return _lm_rescore_tool(
        argv, "lattice-lmrescore [options] --words=words.txt <clat-rspecifier> "
        "<lm-file> <clat-wspecifier>",
        lambda clat, words, lm, o: lmrescore_compact_lattice(clat, words, lm,
                                                             new_scale=o.lm_scale))


@tool("lattice-rescore-mapped")
def lattice_rescore_mapped_tool(argv: List[str]) -> int:
    """Replace lattice acoustic scores from a precomputed log-likelihood
    matrix (src/latbin/lattice-rescore-mapped.cc)."""
    from old_kaldi_git_tpu_torch.lat.rescore import rescore_lattice_acoustics
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("lattice-rescore-mapped <model> <lat-rspecifier> "
                      "<loglikes-rspecifier> <lat-wspecifier>")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    likes = RandomAccessTableReader(args[2], "mat")
    n = 0
    with TableWriter(args[3], "lat") as w:
        for key, lat in SequentialTableReader(args[1], "lat"):
            if key not in likes:
                log.warning("no loglikes for %s", key)
                continue
            rescore_lattice_acoustics(lat, likes[key], tm.tid_to_pdf)
            w[key] = lat
            n += 1
    log.info("rescored %d lattices", n)
    return 0


@tool("gmm-rescore-lattice")
def gmm_rescore_lattice_tool(argv: List[str]) -> int:
    """Replace lattice acoustic scores with a GMM model's over features
    (src/gmmbin/gmm-rescore-lattice.cc): the features of every lattice's
    utterance padded into one batch, one GMM-kernel launch, then each
    lattice's acoustic costs from its rows."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.lat.rescore import rescore_lattice_acoustics
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("gmm-rescore-lattice <model> <lat-rspecifier> <feats-rspecifier> "
                      "<lat-wspecifier>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    feats = RandomAccessTableReader(args[2], "mat")
    lats = []
    for key, lat in SequentialTableReader(args[1], "lat"):
        if key not in feats:
            log.warning("no features for %s", key)
            continue
        lats.append((key, lat))
    rows: Dict[str, np.ndarray] = {}
    if lats:
        keys, padded, nf = pad_feature_batch({k: feats[k] for k, _ in lats})
        ll = model.am.loglikes_batch(torch.from_numpy(padded).to(dev)).cpu().numpy()
        rows = {k: ll[i, : nf[i]] for i, k in enumerate(keys)}
    with TableWriter(args[3], "lat") as w:
        for key, lat in lats:
            rescore_lattice_acoustics(lat, rows[key], model.tm.tid_to_pdf)
            w[key] = lat
    log.info("rescored %d lattices", len(lats))
    return 0


@tool("lattice-boost-ali")
def lattice_boost_ali_tool(argv: List[str]) -> int:
    """Boosted-MMI lattices: b × (frame phone errors against the alignment)
    subtracted from each arc's graph cost (src/latbin/lattice-boost-ali.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import LatticeArc
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("lattice-boost-ali [options] <model> <lat-rspecifier> "
                      "<ali-rspecifier> <lat-wspecifier>")

    class Opts:
        b = 0.05
        silence_phones = ""
        max_silence_error = 0.0

    o = Opts()
    po.register("b", o, "b")
    po.register("silence-phones", o, "silence_phones")
    po.register("max-silence-error", o, "max_silence_error")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    sil = {int(x) for x in o.silence_phones.split(":") if x}
    alis = RandomAccessTableReader(args[2], "ivec")
    n = 0
    with TableWriter(args[3], "lat") as w:
        for key, lat in SequentialTableReader(args[1], "lat"):
            if key not in alis:
                log.warning("no alignment for %s", key)
                continue
            ref_phones = [tm.tid_to_phone(int(t)) for t in alis[key]]
            T = len(ref_phones)

            def boost(s, a):
                t, g = lat.state_time[s], a.graph_cost
                if a.ilabel and 0 <= t < T:
                    hyp = tm.tid_to_phone(a.ilabel)
                    if hyp in sil or ref_phones[t] in sil:
                        err = o.max_silence_error
                    else:
                        err = 0.0 if hyp == ref_phones[t] else 1.0
                    g -= o.b * err
                return LatticeArc(a.ilabel, a.olabel, g, a.acoustic_cost, a.nextstate)

            _map_arcs(lat, boost)
            w[key] = lat
            n += 1
    log.info("boosted %d lattices", n)
    return 0


# ---------------------------------------------------------------------------
# posterior / vector tools (src/bin rows)
# ---------------------------------------------------------------------------

@tool("copy-post")
def copy_post_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.hmm.posterior import scale_post
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("copy-post [options] <post-rspecifier> <post-wspecifier>")

    class Opts:
        scale = 1.0

    o = Opts()
    po.register("scale", o, "scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "post") as w:
        for key, post in SequentialTableReader(args[0], "post"):
            w[key] = scale_post(post, o.scale)
    return 0


@tool("scale-post")
def scale_post_tool(argv: List[str]) -> int:
    """Scale posteriors by per-utterance scalars or a global scale
    (src/bin/scale-post.cc)."""
    from old_kaldi_git_tpu_torch.hmm.posterior import scale_post
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("scale-post <post-rspecifier> <scale-rspecifier|scale> <post-wspecifier>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    try:
        global_scale, scales = float(args[1]), None
    except ValueError:
        global_scale, scales = 1.0, RandomAccessTableReader(args[1], "flt")
    with TableWriter(args[2], "post") as w:
        for key, post in SequentialTableReader(args[0], "post"):
            if scales is None:
                w[key] = scale_post(post, global_scale)
            elif key in scales:
                w[key] = scale_post(post, float(scales[key]))
            else:
                log.warning("no scale for %s", key)
    return 0


@tool("sum-post")
def sum_post_tool(argv: List[str]) -> int:
    """Sum two posterior archives frame by frame (src/bin/sum-post.cc)."""
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("sum-post [options] <post1-rspecifier> <post2-rspecifier> "
                      "<post-wspecifier>")

    class Opts:
        scale1 = 1.0
        scale2 = 1.0

    o = Opts()
    po.register("scale1", o, "scale1")
    po.register("scale2", o, "scale2")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    r2 = RandomAccessTableReader(args[1], "post")
    with TableWriter(args[2], "post") as w:
        for key, p1 in SequentialTableReader(args[0], "post"):
            if key not in r2:
                log.warning("no second posterior for %s", key)
                continue
            p2 = r2[key]
            if len(p1) != len(p2):
                log.warning("length mismatch for %s", key)
                continue
            out = []
            for f1, f2 in zip(p1, p2):
                d: Dict[int, float] = {}
                for i, v in f1:
                    d[i] = d.get(i, 0.0) + o.scale1 * v
                for i, v in f2:
                    d[i] = d.get(i, 0.0) + o.scale2 * v
                out.append(sorted(d.items()))
            w[key] = out
    return 0


@tool("vector-scale")
def vector_scale_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("vector-scale [options] <vec-rspecifier> <vec-wspecifier>")

    class Opts:
        scale = 1.0

    o = Opts()
    po.register("scale", o, "scale")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "vec") as w:
        for key, v in SequentialTableReader(args[0], "vec"):
            w[key] = np.asarray(v) * o.scale
    return 0


@tool("vector-sum")
def vector_sum_tool(argv: List[str]) -> int:
    """Sum vectors across archives by key, or every vector of one archive
    into a single file with --sum-all (src/bin/vector-sum.cc)."""
    from old_kaldi_git_tpu_torch.utils.io_funcs import BINARY_HEADER, write_vector
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("vector-sum <vec-rspecifier> [<vec-rspecifier2> ...] <vec-wspecifier>\n"
                      "  or: vector-sum --sum-all <vec-rspecifier> <vec-file>")

    class Opts:
        sum_all = False

    o = Opts()
    po.register("sum-all", o, "sum_all")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    if o.sum_all:
        tot = None
        for _key, v in SequentialTableReader(args[0], "vec"):
            tot = np.asarray(v, np.float64) if tot is None else tot + v
        if tot is None:
            log.error("vector-sum --sum-all: empty input archive")
            return 1
        with open(args[1], "wb") as f:
            f.write(BINARY_HEADER)
            write_vector(f, np.asarray(tot, np.float32))
        return 0
    readers = [RandomAccessTableReader(a, "vec") for a in args[1:-1]]
    with TableWriter(args[-1], "vec") as w:
        for key, v in SequentialTableReader(args[0], "vec"):
            missing = [r for r in readers if key not in r]
            if missing:
                log.warning("missing %s in an input archive", key)
                continue
            acc = np.asarray(v, np.float64)
            for r in readers:
                acc = acc + r[key]
            w[key] = acc.astype(np.float32)
    return 0


# ---------------------------------------------------------------------------
# feature info tools (src/featbin rows)
# ---------------------------------------------------------------------------

@tool("feat-to-dim")
def feat_to_dim_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("feat-to-dim <feats-rspecifier> <dim-wspecifier|->")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    it = SequentialTableReader(args[0], "mat")
    if args[1] == "-":
        for _key, f in it:
            print(f.shape[1])
            return 0
        return 1
    with TableWriter(args[1], "text") as w:
        for key, f in it:
            w[key] = str(f.shape[1])
    return 0


@tool("feat-to-len")
def feat_to_len_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("feat-to-len <feats-rspecifier> <len-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "text") as w:
        for key, f in SequentialTableReader(args[0], "mat"):
            w[key] = str(f.shape[0])
    return 0


@tool("wav-to-duration")
def wav_to_duration_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("wav-to-duration <wav-rspecifier> <dur-wspecifier>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with TableWriter(args[1], "text") as w:
        for key, wav in SequentialTableReader(args[0], "wav"):
            w[key] = f"{wav.data.shape[1] / wav.samp_freq:.5g}"
    return 0


# ---------------------------------------------------------------------------
# fstbin extras
# ---------------------------------------------------------------------------

@tool("fsttablecompose")
def fsttablecompose_tool(argv: List[str]) -> int:
    """fstcompose under the reference's name (its table matcher is a lookup
    detail; compose sorts and hashes the arcs already)."""
    from old_kaldi_git_tpu_torch.fst.algorithms import compose

    po = ParseOptions("fsttablecompose <fst1> <fst2> <out-fst>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    return _write_fst(compose(_read_fst(args[0]), _read_fst(args[1])), args[2])


@tool("fstisstochastic")
def fstisstochastic_tool(argv: List[str]) -> int:
    """Arc-probability stochasticity in the log semiring: prints the (min,
    max) deviation as the reference does (src/fstbin/fstisstochastic.cc);
    exit 0 iff within delta."""
    po = ParseOptions("fstisstochastic [options] <fst>")

    class Opts:
        delta = 0.01

    o = Opts()
    po.register("delta", o, "delta")
    args = po.parse(argv)
    if len(args) != 1:
        return _usage(po)
    fst = _read_fst(args[0])
    lo = hi = 0.0
    for s in fst.states():
        tot = [math.exp(-a.weight) for a in fst.arcs[s]]
        if fst.is_final(s):
            tot.append(math.exp(-fst.finals[s]))
        if not tot:
            continue
        d = -math.log(sum(tot))
        lo, hi = min(lo, d), max(hi, d)
    print(f"{lo:.6g} {hi:.6g}")
    return 0 if (hi - lo) <= o.delta and abs(lo) <= o.delta else 1


@tool("fstaddsubsequentialloop")
def fstaddsubsequentialloop_tool(argv: List[str]) -> int:
    from old_kaldi_git_tpu_torch.fst.context import add_subsequential_loop

    po = ParseOptions("fstaddsubsequentialloop <subseq-symbol> <in-fst> <out-fst>")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    return _write_fst(add_subsequential_loop(_read_fst(args[1]), int(args[0])), args[2])


@tool("fstequivalent")
def fstequivalent_tool(argv: List[str]) -> int:
    """Bounded-length equivalence test of two FSTs (the reference uses
    fst::RandEquivalent in its tests); exit 0 iff equivalent."""
    from old_kaldi_git_tpu_torch.fst.algorithms import fst_equivalent

    po = ParseOptions("fstequivalent [options] <fst1> <fst2>")

    class Opts:
        max_len = 8
        delta = 0.01

    o = Opts()
    po.register("max-len", o, "max_len")
    po.register("delta", o, "delta")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    ok = fst_equivalent(_read_fst(args[0]), _read_fst(args[1]), max_len=o.max_len,
                        tol=o.delta)
    print("equivalent" if ok else "NOT equivalent")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# lmbin / gmmbin extras
# ---------------------------------------------------------------------------

@tool("arpa-to-const-arpa")
def arpa_to_const_arpa_tool(argv: List[str]) -> int:
    """Pre-parse an ARPA LM into the fast-loading const-arpa binary
    (src/lmbin/arpa-to-const-arpa.cc role)."""
    from old_kaldi_git_tpu_torch.lm.arpa import parse_arpa, write_const_arpa

    po = ParseOptions("arpa-to-const-arpa <arpa-file> <const-arpa-file>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    with open(args[0]) as f:
        lm = parse_arpa(f.read())
    write_const_arpa(lm, args[1])
    return 0


@tool("gmm-copy")
def gmm_copy_tool(argv: List[str]) -> int:
    po = ParseOptions("gmm-copy <model-in> <model-out>")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    _host_model(args[0]).save(args[1])
    return 0


@tool("gmm-decode-faster")
def gmm_decode_faster_tool(argv: List[str]) -> int:
    """Decode to the best path only: words and alignment, no lattice
    (src/gmmbin/gmm-decode-faster.cc).  The table's features in one padded
    batch through the GMM kernel, then decoder/viterbi.py's dense search."""
    import torch

    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("gmm-decode-faster [options] <model> <hclg-fst> <feats-rspecifier> "
                      "<words-wspecifier> [<ali-wspecifier>]")

    class Opts:
        beam = 16.0
        max_active = 7000
        acoustic_scale = 0.1
        word_symbol_table = ""

    o = Opts()
    for name, attr in (("beam", "beam"), ("max-active", "max_active"),
                       ("acoustic-scale", "acoustic_scale"),
                       ("word-symbol-table", "word_symbol_table")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) not in (4, 5):
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    csr = read_hclg_csr(args[1], model.tm.tid_to_pdf_array())
    feats = dict(SequentialTableReader(args[2], "mat"))
    if not feats:
        log.warning("no features")
        return 1
    keys, padded, nf = pad_feature_batch(feats)
    loglikes = model.am.loglikes_batch(torch.from_numpy(padded).to(dev))
    results = decode_batch(csr, loglikes, nf,
                           ViterbiOptions(beam=o.beam, max_active=o.max_active,
                                          acoustic_scale=o.acoustic_scale), device=dev)
    words_tab = _symbols(o.word_symbol_table)
    awriter = TableWriter(args[4], "ivec") if len(args) == 5 else None
    n = 0
    with TableWriter(args[3], "text") as w:
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
    log.info("decoded %d/%d utterances", n, len(keys))
    return 0


@tool("gmm-acc-stats")
def gmm_acc_stats_tool(argv: List[str]) -> int:
    """GMM and transition statistics from (tid) posteriors: soft counts, the
    MMI / MPE and silence-weighted path (src/gmmbin/gmm-acc-stats.cc).  Every
    posterior entry of the table, (frame, tid, weight), goes into one float64
    `accumulate_corpus` call on the model's device; the transition counts
    are summed in float64 on the host."""
    import torch

    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.gmm.mle import AccumAmDiagGmm, write_accs
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader)

    po = ParseOptions("gmm-acc-stats <model> <feats-rspecifier> <post-rspecifier> <stats-out>")
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    dev = device()
    model = AmGmmModel.load(args[0], device=dev)
    posts = RandomAccessTableReader(args[2], "post")
    trans_stats = np.zeros(model.tm.num_tids + 1)
    mats, rows, tids, wts = [], [], [], []
    n = frames = 0
    for k, feats in SequentialTableReader(args[1], "mat"):
        if k not in posts:
            continue
        post = posts[k]
        if len(post) != len(feats):
            log.warning("%s: post length %d != frames %d, skipping", k, len(post), len(feats))
            continue
        for t, frame in enumerate(post):
            for tid, wgt in frame:
                rows.append(frames + t)
                tids.append(int(tid))
                wts.append(float(wgt))
        mats.append(np.asarray(feats, np.float32))
        n += 1
        frames += len(post)
    tids = np.asarray(tids, np.int64)
    wts = np.asarray(wts, np.float64)
    np.add.at(trans_stats, tids, wts)  # in entry order, as the reference's loop adds
    accs = AccumAmDiagGmm(model.am)
    if len(tids):
        x = torch.from_numpy(np.concatenate(mats)).to(dev)[torch.from_numpy(
            np.asarray(rows, np.int64)).to(dev)]
        accs.accumulate_corpus(model.am, x, model.tm.tid_to_pdf_array()[tids], weights=wts)
    with open(args[3], "wb") as f:
        write_accs(f, accs, trans_stats)
    log.info("gmm-acc-stats: %d utts, %d frames", n, frames)
    return 0


@tool("fstcomposecontext")
def fstcomposecontext_tool(argv: List[str]) -> int:
    """Compose an LG with the context transducer C, writing the ilabel-info
    table (src/fstbin/fstcomposecontext.cc / ComposeContext)."""
    from old_kaldi_git_tpu_torch.fst.context import compose_context

    po = ParseOptions("fstcomposecontext [options] <ilabels-out> <in-fst|LG> <out-fst|CLG>")

    class Opts:
        context_size = 3
        central_position = 1
        read_disambig_syms = ""
        subseq_symbol = 0  # 0 → the largest ilabel + 1

    o = Opts()
    po.register("context-size", o, "context_size")
    po.register("central-position", o, "central_position")
    po.register("read-disambig-syms", o, "read_disambig_syms")
    po.register("subseq-symbol", o, "subseq_symbol")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    lg = _read_fst(args[1])
    disambig = []
    if o.read_disambig_syms:
        with open(o.read_disambig_syms) as f:
            disambig = [int(x) for x in f.read().split()]
    subseq = o.subseq_symbol or 1 + max(
        (a.ilabel for s in lg.states() for a in lg.arcs[s]), default=0)
    clg, ilabel_info = compose_context(lg, o.context_size, o.central_position, disambig,
                                       subseq)
    with open(args[0], "w") as f:
        for info in ilabel_info:
            f.write(" ".join(str(x) for x in info) + "\n")
    return _write_fst(clg, args[2])


@tool("lattice-interp")
def lattice_interp_tool(argv: List[str]) -> int:
    """Interpolate the scores of paired lattices: alpha × lat1 + (1 - alpha) ×
    lat2's word-sequence costs on their common word sequences
    (src/latbin/lattice-interp.cc)."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_interp
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("lattice-interp [options] <lat1-rspecifier> <lat2-rspecifier> "
                      "<lat-wspecifier>")

    class Opts:
        alpha = 0.5
        lm_scale2 = 1.0
        acoustic_scale2 = 0.1

    o = Opts()
    po.register("alpha", o, "alpha")
    po.register("lm-scale2", o, "lm_scale2")
    po.register("acoustic-scale2", o, "acoustic_scale2")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    lat2s = RandomAccessTableReader(args[1], "lat")
    n_done = n_empty = n_missing = 0
    with TableWriter(args[2], "lat") as w:
        for key, lat1 in SequentialTableReader(args[0], "lat"):
            if key not in lat2s:
                n_missing += 1
                continue
            out = lattice_interp(lat1, lat2s[key], alpha=o.alpha, lm_scale2=o.lm_scale2,
                                 ac_scale2=o.acoustic_scale2)
            if out is None:
                n_empty += 1
                continue
            w[key] = out
            n_done += 1
    log.info("lattice-interp: %d done, %d empty intersections, %d missing",
             n_done, n_empty, n_missing)
    return 0 if n_done else 1


@tool("lattice-align-words")
def lattice_align_words_tool(argv: List[str]) -> int:
    """Word time alignment of the best path by word-boundary phone marks
    (src/latbin/lattice-align-words.cc; input: the lang's
    word_boundary.int); triples as lattice-align-words-lexicon writes."""
    from old_kaldi_git_tpu_torch.lat.ctm import align_words_boundary, read_word_boundary

    def aligner_of(path):
        boundary = read_word_boundary(path)
        return lambda tm, words, tids: align_words_boundary(tm, boundary, words, tids)

    return _align_words_tool(argv, "lattice-align-words [options] <word-boundary-int> <model> "
                             "<lat-rspecifier> <align-wspecifier>", aligner_of,
                             lambda done, err: 0 if done or not err else 1)


@tool("phone-align-lattice")
def phone_align_lattice_tool(argv: List[str]) -> int:
    """Phone time alignment of the best path (src/latbin/phone-align-lattice.cc
    role): 'phone start_frame num_frames' triples."""
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import split_to_phones
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("phone-align-lattice [options] <model> <lat-rspecifier> "
                      "<align-wspecifier>")
    o = _scale_options(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    tm = _host_model(args[0]).tm
    n = 0
    with TableWriter(args[2], "text") as w:
        for key, lat in SequentialTableReader(args[1], "lat"):
            _words, tids, _ = lattice_best_path(lat, o.lm_scale, o.acoustic_scale)
            segs, t = [], 0
            for seg in split_to_phones(tm, list(tids)):
                segs.append(f"{tm.tid_to_phone(seg[0])} {t} {len(seg)}")
                t += len(seg)
            w[key] = " ; ".join(segs)
            n += 1
    log.info("phone-aligned %d lattices", n)
    return 0 if n else 1


@tool("lattice-to-mpe-post")
def lattice_to_mpe_post_tool(argv: List[str], _default_criterion: str = "mpfe") -> int:
    """Signed MPE ('mpfe') / sMBR tid posteriors from lattices and numerator
    alignments (src/latbin/lattice-to-mpe-post.cc via
    LatticeForwardBackwardMpeVariants): positive weight on arcs more
    accurate than the average, negative on the others."""
    from old_kaldi_git_tpu_torch.lat.discriminative import forward_backward_mpe_variants
    from old_kaldi_git_tpu_torch.utils.table import (
        RandomAccessTableReader, SequentialTableReader, TableWriter)

    po = ParseOptions("lattice-to-mpe-post [options] <model> <num-ali-rspecifier> "
                      "<lats-rspecifier> <post-wspecifier>")
    o = _scale_options(po)
    o.criterion, o.silence_phones = _default_criterion, ""
    po.register("criterion", o, "criterion")
    po.register("silence-phones", o, "silence_phones")
    args = po.parse(argv)
    if len(args) != 4:
        return _usage(po)
    tm = _host_model(args[0]).tm
    sil = [int(p) for p in o.silence_phones.split(":") if p]
    alis = RandomAccessTableReader(args[1], "ivec")
    tot_acc = tot_frames = 0.0
    n = 0
    with TableWriter(args[3], "post") as w:
        for key, lat in SequentialTableReader(args[2], "lat"):
            if key not in alis:
                log.warning("no numerator alignment for %s", key)
                continue
            post, acc = forward_backward_mpe_variants(
                lat, tm, alis[key], criterion=o.criterion, silence_phones=sil,
                lm_scale=o.lm_scale, ac_scale=o.acoustic_scale)
            w[key] = post
            tot_acc += acc
            tot_frames += len(post)
            n += 1
    if tot_frames:
        log.info("lattice-to-%s-post: avg accuracy %.4f over %d utts",
                 o.criterion, tot_acc / tot_frames, n)
    return 0


@tool("lattice-to-smbr-post")
def lattice_to_smbr_post_tool(argv: List[str]) -> int:
    """sMBR (pdf-accuracy) signed posteriors (src/latbin/lattice-to-smbr-post.cc)."""
    return lattice_to_mpe_post_tool(argv, _default_criterion="smbr")


@tool("make-grammar-fst")
def make_grammar_fst_tool(argv: List[str]) -> int:
    """Expand the nonterminal arcs of a top-level FST with sub-FSTs (the
    build-time role of src/decoder/grammar-fst.{h,cc} / make-grammar-fst;
    the expansion is static, so the decoding graph stays one CSR graph).

    usage: make-grammar-fst <top-fst> <label1> <sub-fst1> \
               [<label2> <sub-fst2> ...] <out-fst>
    Labels are word ids, or symbols when --word-symbol-table is given."""
    from old_kaldi_git_tpu_torch.fst.algorithms import replace_fst

    po = ParseOptions("make-grammar-fst [options] <top-fst> <label1> <sub-fst1> "
                      "[<label2> <sub-fst2> ...] <out-fst>")

    class Opts:
        word_symbol_table = ""

    o = Opts()
    po.register("word-symbol-table", o, "word_symbol_table")
    args = po.parse(argv)
    if len(args) < 4 or len(args) % 2 != 0:
        return _usage(po)
    syms = _symbols(o.word_symbol_table)
    top = _read_fst(args[0])
    pairs = args[1:-1]
    repl = {(syms[lab] if syms and not lab.isdigit() else int(lab)): _read_fst(path)
            for lab, path in zip(pairs[0::2], pairs[1::2])}
    out = replace_fst(top, repl)
    log.info("make-grammar-fst: %d nonterminals, %d states, %d arcs",
             len(repl), out.num_states, out.num_arcs)
    return _write_fst(out, args[-1])


@tool("lattice-confidence")
def lattice_confidence_tool(argv: List[str]) -> int:
    """Per-utterance confidence: the total-cost gap between the best and the
    second-best word sequences (src/lat/confidence.{h,cc}
    ComputeLatticeConfidence, latbin/lattice-confidence.cc), clipped to [0,
    max], max for a lattice of one word sequence."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_nbest_paths
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-confidence [options] <lat-rspecifier> <conf-wspecifier>")
    o = _scale_options(po)
    o.max_confidence = 1e10
    po.register("max-confidence", o, "max_confidence")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    n = 0
    with TableWriter(args[1], "flt") as w:
        for key, lat in SequentialTableReader(args[0], "lat"):
            # over DISTINCT word sequences: a raw lattice has many paths of
            # one word sequence (other alignments), so a deep n-best is
            # deduplicated on the words
            seen, seen_words = [], set()
            for arcs, (fg, fa) in lattice_nbest_paths(lat, 64, o.lm_scale, o.acoustic_scale):
                words = tuple(a.olabel for a in arcs if a.olabel)
                if words in seen_words:
                    continue
                seen_words.add(words)
                seen.append(sum(lat.combined(a, o.lm_scale, o.acoustic_scale) for a in arcs)
                            + o.lm_scale * fg + o.acoustic_scale * fa)
                if len(seen) == 2:
                    break
            if not seen:
                continue
            w[key] = (o.max_confidence if len(seen) < 2
                      else min(max(seen[1] - seen[0], 0.0), o.max_confidence))
            n += 1
    log.info("lattice-confidence: %d utterances", n)
    return 0


@tool("rnnlm-train")
def rnnlm_train_tool(argv: List[str]) -> int:
    """Train the LSTM word LM on a transcript table, on the card (the
    reference's rnnlm training role); the model file is the JAX package's
    pickle layout."""
    from old_kaldi_git_tpu_torch.lm.rnnlm import RnnLmOptions, save_rnnlm, train_rnnlm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions("rnnlm-train [options] <text-rspecifier> <word-symbol-table> "
                      "<rnnlm-out>")
    o = RnnLmOptions()
    for name, attr in (("embed-dim", "embed_dim"), ("cell-dim", "cell_dim"),
                       ("recurrent-dim", "recurrent_dim"), ("num-epochs", "num_epochs"),
                       ("learning-rate", "learning_rate"), ("srand", "seed")):
        po.register(name, o, attr)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    dev = device()
    syms = _symbols(args[1])
    num_words = max(syms.ids())
    seqs = []
    for _, line in SequentialTableReader(args[0], "text"):
        ids = [syms[w] for w in line.split() if w in syms]
        if ids:
            seqs.append(ids)
    save_rnnlm(train_rnnlm(seqs, num_words, o, device=dev), args[2])
    log.info("rnnlm-train: %d sentences, vocab %d", len(seqs), num_words)
    return 0


@tool("lattice-lmrescore-rnnlm")
def lattice_lmrescore_rnnlm_tool(argv: List[str]) -> int:
    """RNNLM n-best rescoring of lattices (the reference's
    rnnlm/lmrescore_nbest path: lattice-to-nbest, score, re-rank): each
    lattice's n best paths scored in one forward pass on the card; each
    path's graph cost interpolated with the RNNLM's −log P at --rnnlm-scale;
    the re-ranked n-best written as one lattice."""
    from old_kaldi_git_tpu_torch.lat.lattice import (
        LatticeArc, lattice_nbest_paths, lattice_union, linear_lattice_from_path)
    from old_kaldi_git_tpu_torch.lm.rnnlm import load_rnnlm
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader, TableWriter

    po = ParseOptions("lattice-lmrescore-rnnlm [options] <rnnlm> <lat-rspecifier> "
                      "<lat-wspecifier>")

    class Opts:
        rnnlm_scale = 0.5
        n = 10

    o = Opts()
    po.register("rnnlm-scale", o, "rnnlm_scale")
    po.register("n", o, "n")
    o2 = _scale_options(po)
    device = device_option(po)
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    rnnlm = load_rnnlm(args[0], device=device())
    n_done = 0
    with TableWriter(args[2], "lat") as w:
        for key, lat in SequentialTableReader(args[1], "lat"):
            paths = lattice_nbest_paths(lat, o.n, o2.lm_scale, o2.acoustic_scale)
            if not paths:
                continue
            rnn_neglogs = -rnnlm.logprobs_batch([[a.olabel for a in arcs if a.olabel]
                                                 for arcs, _ in paths])
            linear = []
            for (arcs, fin), rnn in zip(paths, rnn_neglogs):
                old_g = sum(a.graph_cost for a in arcs) + fin[0]
                new_g = (1.0 - o.rnnlm_scale) * old_g + o.rnnlm_scale * float(rnn)
                # the interpolated graph cost on the first arc; the final
                # keeps only its acoustic part
                new_arcs = [LatticeArc(a.ilabel, a.olabel, new_g if i == 0 else 0.0,
                                       a.acoustic_cost, a.nextstate)
                            for i, a in enumerate(arcs)]
                linear.append(linear_lattice_from_path(new_arcs, (0.0, fin[1])))
            w[key] = lattice_union(linear)
            n_done += 1
    log.info("lattice-lmrescore-rnnlm: %d lattices", n_done)
    return 0


@tool("lattice-lmrescore-pruned")
def lattice_lmrescore_pruned_tool(argv: List[str]) -> int:
    """Beam-pruned LM rescoring of compact lattices (src/lat/compose-lattice-
    pruned.{h,cc} via latbin/lattice-lmrescore-pruned): only the
    competitive region of the (lattice × LM history) product is expanded,
    the big-LM path where exact composition blows up."""
    from old_kaldi_git_tpu_torch.lat.rescore import compose_lattice_pruned

    return _lm_rescore_tool(
        argv, "lattice-lmrescore-pruned [options] --words=words.txt <clat-rspecifier> "
        "<const-arpa-or-arpa-file> <clat-wspecifier>",
        lambda clat, words, lm, o: compose_lattice_pruned(
            clat, words, lm, new_scale=o.lm_scale, lattice_beam=o.lattice_beam,
            max_arcs=o.max_arcs),
        extra=(("lattice-beam", "lattice_beam", 6.0), ("max-arcs", "max_arcs", 200000)))
