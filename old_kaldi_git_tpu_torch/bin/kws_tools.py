"""Keyword-search tools (counterpart of old_kaldi_git_tpu/bin/kws_tools.py;
reference src/kwsbin: lattice-to-kws-index, kws-index-union, kws-search,
compute-atwv).

Host tools over kws/: an inverted occurrence index and an exact phrase DP in
place of the reference's factor transducer, with the reference's pipeline
and its output lines ('kwid utt tbeg tend score').  The index file is the
JAX package's pickle.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from old_kaldi_git_tpu_torch.bin.tools import _usage, tool
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger
from old_kaldi_git_tpu_torch.utils.parse_options import ParseOptions

log = get_logger("kws_tools")


def _read_keywords(path: str, word_syms=None) -> Dict[str, List[int]]:
    """Keyword file: 'kwid word [word ...]' per line; words are integer ids
    or, with a symbol table, text."""
    out: Dict[str, List[int]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kwid, words = parts[0], parts[1:]
            if not words:
                raise KaldiError(f"keyword {kwid} has no words")
            if word_syms is not None:
                ids = [int(word_syms[w]) for w in words]
            else:
                ids = [int(w) for w in words]
            out[kwid] = ids
    return out


@tool("lattice-to-kws-index")
def lattice_to_kws_index_tool(argv: List[str]) -> int:
    """Build the inverted single-word occurrence index from lattices
    (reference kwsbin/lattice-to-kws-index.cc role)."""
    from old_kaldi_git_tpu_torch.kws.search import build_kws_index, save_index
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions(
        "lattice-to-kws-index [options] <lattice-rspecifier> <index-out>")

    class Opts:
        acoustic_scale = 0.1
        lm_scale = 1.0
        min_post = 1e-4

    o = Opts()
    po.register("acoustic-scale", o, "acoustic_scale")
    po.register("lm-scale", o, "lm_scale")
    po.register("min-post", o, "min_post")
    args = po.parse(argv)
    if len(args) != 2:
        return _usage(po)
    lats = dict(SequentialTableReader(args[0], "lat"))
    index = build_kws_index(
        lats, lm_scale=o.lm_scale, ac_scale=o.acoustic_scale,
        min_log_post=float(np.log(o.min_post)))
    save_index(index, args[1])
    n = sum(len(v) for v in index.values())
    log.info("indexed %d occurrences of %d words from %d lattices",
             n, len(index), len(lats))
    return 0


@tool("kws-index-union")
def kws_index_union_tool(argv: List[str]) -> int:
    """Merge per-shard indexes (reference kwsbin/kws-index-union.cc)."""
    from old_kaldi_git_tpu_torch.kws.search import (
        load_index,
        merge_indexes,
        save_index,
    )

    po = ParseOptions(
        "kws-index-union <index-in-1> [<index-in-2> ...] <index-out>")
    args = po.parse(argv)
    if len(args) < 2:
        return _usage(po)
    merged = merge_indexes([load_index(p) for p in args[:-1]])
    save_index(merged, args[-1])
    return 0


@tool("kws-search")
def kws_search_tool(argv: List[str]) -> int:
    """Search keywords; writes 'kwid utt tbeg tend score' lines
    (reference kwsbin/kws-search.cc output convention; score =
    occurrence posterior).  Single-word keywords are answered from the
    index if one is given via --index; phrases (and everything when no
    index is given) run the exact lattice DP."""
    from old_kaldi_git_tpu_torch.kws.search import (
        load_index,
        search_index,
        search_phrase,
    )
    from old_kaldi_git_tpu_torch.utils.table import SequentialTableReader

    po = ParseOptions(
        "kws-search [options] <lattice-rspecifier> <keywords-file> "
        "<results-out|->")

    class Opts:
        acoustic_scale = 0.1
        lm_scale = 1.0
        index = ""
        word_symbol_table = ""
        min_post = 1e-4
        frame_shift = 0.0  # >0: report times in seconds

    o = Opts()
    po.register("acoustic-scale", o, "acoustic_scale")
    po.register("lm-scale", o, "lm_scale")
    po.register("index", o, "index")
    po.register("word-symbol-table", o, "word_symbol_table")
    po.register("min-post", o, "min_post")
    po.register("frame-shift", o, "frame_shift")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)
    syms = None
    if o.word_symbol_table:
        from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable

        syms = SymbolTable.read(o.word_symbol_table)
    keywords = _read_keywords(args[1], syms)
    index = load_index(o.index) if o.index else None
    min_lp = float(np.log(o.min_post))
    results = []
    need_lats = (index is None) or any(
        len(ws) > 1 for ws in keywords.values())
    lats = dict(SequentialTableReader(args[0], "lat")) if need_lats else {}
    for kwid, words in sorted(keywords.items()):
        if len(words) == 1 and index is not None:
            for h in search_index(index, words[0]):
                if h.log_post >= min_lp:
                    results.append(
                        (kwid, h.utt, h.tbeg, h.tend, h.log_post))
        else:
            for utt, lat in sorted(lats.items()):
                for tbeg, tend, lp in search_phrase(
                    lat, words, lm_scale=o.lm_scale,
                    ac_scale=o.acoustic_scale, min_log_post=min_lp,
                ):
                    results.append((kwid, utt, tbeg, tend, lp))
    out = sys.stdout if args[2] == "-" else open(args[2], "w")
    try:
        for kwid, utt, tbeg, tend, lp in results:
            if o.frame_shift > 0:
                tbeg, tend = tbeg * o.frame_shift, tend * o.frame_shift
                print(f"{kwid} {utt} {tbeg:.2f} {tend:.2f} "
                      f"{np.exp(lp):.6f}", file=out)
            else:
                print(f"{kwid} {utt} {tbeg} {tend} {np.exp(lp):.6f}",
                      file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    log.info("kws-search: %d hits for %d keywords", len(results),
             len(keywords))
    return 0


@tool("compute-atwv")
def compute_atwv_tool(argv: List[str]) -> int:
    """Actual Term-Weighted Value from a reference-occurrence file and a
    kws-search results file (reference kwsbin/compute-atwv.cc).  Both
    files: 'kwid utt tbeg tend [score]' with times in seconds."""
    from old_kaldi_git_tpu_torch.kws.atwv import compute_atwv

    po = ParseOptions(
        "compute-atwv [options] <trials-duration-sec> <ref-file> <hyp-file>")

    class Opts:
        beta = 999.9
        max_distance = 0.5
        threshold = 0.0  # keep hyps with score >= threshold

    o = Opts()
    po.register("beta", o, "beta")
    po.register("max-distance", o, "max_distance")
    po.register("threshold", o, "threshold")
    args = po.parse(argv)
    if len(args) != 3:
        return _usage(po)

    def read_entries(path, with_score):
        out = []
        with open(path) as f:
            for line in f:
                p = line.split()
                if not p:
                    continue
                e = (p[0], p[1], float(p[2]), float(p[3]))
                if with_score:
                    score = float(p[4]) if len(p) > 4 else 1.0
                    if score < o.threshold:
                        continue
                    e = e + (score,)
                out.append(e)
        return out

    refs = read_entries(args[1], with_score=False)
    hyps = read_entries(args[2], with_score=True)
    atwv, per_kw = compute_atwv(
        float(args[0]), refs, hyps, beta=o.beta, max_distance=o.max_distance)
    for kw in sorted(per_kw):
        log.info("TWV(%s) = %.4f", kw, per_kw[kw])
    print(f"ATWV = {atwv:.4f}")
    return 0
