"""A small on-disk system that the CLI tests of both packages share (a
helper, not a test module).

From the committed exp/minilib: `tri.mdl`, its tree (`tree.pkl` written as a
Kaldi ContextDependency file), `final.am` bundled with tri.mdl's transition
model by each package's nnet3-am-init, a lexicon.txt of the minilib
lexicon's words that those sentences use and the first words that cover
every phone (so that the phone ids are the 20k-word lexicon's), a lang dir
from the port's prepare-lang, a unigram ARPA over the words of the first
NUM_UTTS held-out sentences and the HCLG the port's mkgraph builds from it, for tri.mdl and for mono.mdl (the GMM decode tests score the smaller
mono.mdl: the GMM kernel's plain version is the CPU's cost); those utterances synthesised at 8 kHz as a wave archive with wav.scp,
their features (13 MFCC with CMN and deltas, as the minilib system's), text
and word-id references.  Built once per process."""

import atexit
import os
import shutil
import tempfile

import numpy as np
import pytest

import old_kaldi_git_tpu.bin.tools as jtools
import old_kaldi_git_tpu_torch.bin.tools as ttools
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.feat.compute import compute_utterance_feats
from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable
from old_kaldi_git_tpu_torch.lm.ngram import estimate_ngram_lm, write_arpa
from old_kaldi_git_tpu_torch.recipes import minilib
from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from old_kaldi_git_tpu_torch.utils.wav import WaveData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
NUM_UTTS = 4
SR = minilib.SAMP_FREQ

_SYSTEM = {}


def jax_tool(*argv) -> int:
    return jtools.main(list(argv))


def port_tool(*argv) -> int:
    """A port tool on the CPU (--device=cpu right after the tool's name for
    the tools that make tensors)."""
    name, rest = argv[0], list(argv[1:])
    return ttools.main([name] + (["--device=cpu"] if name in TENSOR_TOOLS else []) + rest)


# the tools that register --device
TENSOR_TOOLS = frozenset((
    "compute-mfcc-feats", "compute-fbank-feats", "compute-spectrogram-feats",
    "compute-plp-feats", "compute-kaldi-pitch-feats", "process-kaldi-pitch-feats",
    "compute-cmvn-stats", "apply-cmvn", "add-deltas", "compute-vad",
    "gmm-latgen-faster", "online-wav-gmm-latgen-faster", "nnet3-info", "nnet3-compute",
    "nnet3-average", "nnet3-init", "nnet3-copy", "nnet3-am-init", "nnet3-align-compiled",
    "nnet3-latgen-faster", "online2-wav-nnet3-latgen-faster",
    "online2-tcp-nnet3-decode-faster", "align-equal-compiled", "gmm-align-compiled",
    "gmm-decode-faster", "gmm-rescore-lattice", "gmm-acc-stats", "rnnlm-train",
    "lattice-lmrescore-rnnlm", "ivector-extract-online2", "gmm-acc-stats-ali", "gmm-est",
    "gmm-compute-likes", "acc-lda", "gmm-acc-mllt", "gmm-est-fmllr", "gmm-post-to-gpost",
    "gmm-est-fmllr-gpost", "gmm-basis-fmllr-training", "gmm-est-basis-fmllr",
    "gmm-train-lvtln-special", "gmm-est-lvtln-trans", "gmm-est-regtree-fmllr",
    "gmm-est-regtree-mllr", "gmm-decode-faster-regtree-fmllr",
    "gmm-decode-faster-regtree-mllr", "gmm-get-stats-deriv", "gmm-fmpe-acc-stats",
    "fmpe-apply-transform", "nnet3-train", "nnet3-compute-prob", "nnet3-adjust-priors",
    "nnet3-combine", "nnet3-chain-init", "nnet3-chain-train", "nnet3-chain-compute-prob",
    "nnet3-chain-combine", "nnet3-discriminative-train",
    "nnet3-discriminative-compute-objf", "gmm-global-init-from-feats", "gmm-gselect",
    "fgmm-gselect", "gmm-global-acc-stats", "gmm-global-get-post", "fgmm-global-acc-stats",
    "ivector-extractor-acc-stats", "ivector-extract", "sgmm2-acc-stats-ali", "sgmm2-est",
    "sgmm2-est-spkvecs", "sgmm2-est-fmllr", "sgmm2-align-compiled", "sgmm2-latgen-faster"))


def lattices_equal(a, b, atol=1e-5, ac_rtol=2e-5):
    """Equal arc for arc: graph costs within atol, acoustic costs within
    atol + ac_rtol·|cost|."""
    assert a.num_states == b.num_states and a.start == b.start
    assert list(a.state_time) == list(b.state_time)
    for (ga, aa), (gb, ab) in zip(a.finals, b.finals):
        assert ga == pytest.approx(gb, abs=atol)
        assert aa == pytest.approx(ab, abs=atol, rel=ac_rtol)
    for s in range(a.num_states):
        assert len(a.arcs[s]) == len(b.arcs[s])
        for x, y in zip(a.arcs[s], b.arcs[s]):
            assert (x.ilabel, x.olabel, x.nextstate) == (y.ilabel, y.olabel, y.nextstate)
            assert x.graph_cost == pytest.approx(y.graph_cost, abs=atol)
            assert x.acoustic_cost == pytest.approx(y.acoustic_cost, abs=atol, rel=ac_rtol)


def run(capsys, fn, *argv):
    """(exit code, stdout) of an in-process tool."""
    capsys.readouterr()
    rc = fn(*argv)
    return rc, capsys.readouterr().out


def system() -> dict:
    """Paths and data of the shared system (built at the first call)."""
    if _SYSTEM:
        return _SYSTEM
    root = tempfile.mkdtemp(prefix="okt_cli_")
    atexit.register(shutil.rmtree, root, True)
    p = lambda *a: os.path.join(root, *a)  # noqa: E731
    opts = minilib.MinilibOptions()
    sents = minilib.make_text(opts, NUM_UTTS, opts.seed + 6)
    waves, text = minilib.synth_set(opts, sents, "test", opts.seed + 7)
    lex = minilib.make_lexicon(opts)
    keep = {w for ws in text.values() for w in ws}
    phones = {ph for w in lex for ph in lex[w].split()}
    for w in sorted(lex):
        if phones <= {ph for k in keep for ph in lex[k].split()}:
            break
        keep.add(w)
    with open(p("lexicon.txt"), "w") as f:
        for w in sorted(keep):
            f.write(f"{w} {lex[w]}\n")
    assert ttools.main(["prepare-lang", p("lexicon.txt"), p("lang")]) == 0
    write_arpa(estimate_ngram_lm(list(text.values()), order=1), p("G.arpa"))
    with open(p("tree"), "wb") as f:
        convert.context_dependency_from_pickle(
            convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))[0]).write(f)
    tri, mono = os.path.join(WORKDIR, "tri.mdl"), os.path.join(WORKDIR, "mono.mdl")
    assert ttools.main(["mkgraph", f"--tree={p('tree')}", p("lang"), p("G.arpa"), tri,
                        p("graph")]) == 0
    assert ttools.main(["mkgraph", p("lang"), p("G.arpa"), mono, p("graph_mono")]) == 0
    with TableWriter(f"ark,scp:{p('wav.ark')},{p('wav.scp')}", "wav") as w:
        for k in sorted(waves):
            w[k] = WaveData(samp_freq=SR, data=np.asarray(waves[k], np.float32)[None])
    read_back = read_table(f"scp:{p('wav.scp')}", "wav")
    feats = compute_utterance_feats({k: v.data[0] for k, v in read_back.items()}, SR,
                                    "cpu")
    with TableWriter(f"ark:{p('feats.ark')}", "mat") as w:
        for k in sorted(feats):
            w[k] = feats[k]
    words = SymbolTable.read(p("lang", "words.txt"))
    with TableWriter(f"ark,t:{p('text.ark')}", "text") as w:
        for k in sorted(text):
            w[k] = " ".join(text[k])
    with TableWriter(f"ark,t:{p('ref_ids.ark')}", "text") as w:
        for k in sorted(text):
            w[k] = " ".join(str(words[x]) for x in text[k])
    final_am = os.path.join(WORKDIR, "final.am")
    assert jtools.main(["nnet3-am-init", tri, final_am, p("final_jax.mdl")]) == 0
    assert ttools.main(["nnet3-am-init", "--device=cpu", tri, final_am,
                        p("final.mdl")]) == 0
    _SYSTEM.update(root=root, p=p, tri=tri, mono=mono, final_am=final_am, waves=waves,
                   text=text, feats=feats, words=words, hclg=p("graph", "HCLG.fst"),
                   hclg_mono=p("graph_mono", "HCLG.fst"))
    return _SYSTEM


_TRAIN = {}


def train_system() -> dict:
    """system() and the training tools' shared inputs (built once): the
    training graphs of the utterances' transcripts with tri.mdl and its
    tree, their equal alignments (the port's align-equal-compiled: the GMM
    kernel's plain version on tri.mdl is the CPU's cost, 6 s), those
    as posteriors (post.ark) and a spk2utt of two speakers of two
    utterances each."""
    s = system()
    if _TRAIN:
        return _TRAIN
    p = s["p"]
    assert port_tool("compile-train-graphs", p("tree"), s["tri"], p("lang"),
                     f"ark:{p('text.ark')}", f"ark:{p('train_graphs.ark')}") == 0
    assert port_tool("align-equal-compiled", s["tri"], f"ark:{p('train_graphs.ark')}",
                     f"ark:{p('feats.ark')}", f"ark:{p('ali.ark')}") == 0
    assert port_tool("ali-to-post", f"ark:{p('ali.ark')}", f"ark:{p('post.ark')}") == 0
    keys = sorted(s["feats"])
    with open(p("spk2utt"), "w") as f:
        f.write(f"spkA {keys[0]} {keys[1]}\nspkB {keys[2]} {keys[3]}\n")
    with open(p("utt2spk"), "w") as f:
        f.writelines(f"{k} {'spkA' if i < 2 else 'spkB'}\n" for i, k in enumerate(keys))
    _TRAIN.update(s, ali=f"ark:{p('ali.ark')}", post=f"ark:{p('post.ark')}",
                  feats_r=f"ark:{p('feats.ark')}", spk2utt=p("spk2utt"),
                  utt2spk=p("utt2spk"), keys=keys)
    return _TRAIN


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def both(name: str, *argv, tag: str = "", rc: int = 0) -> None:
    """Runs a tool in both packages on the same arguments, "{out}" in an
    argument replaced by "jax" / "port" (+ tag), so that each writes its
    own files; asserts both exit with rc."""
    for pre, fn in (("jax", jax_tool), ("port", port_tool)):
        got = fn(name, *[a.replace("{out}", pre + tag) for a in argv])
        assert got == rc, f"{pre} {name} exited {got}"


def mono_train_system() -> dict:
    """train_system() and mono.mdl's inputs (built once): the port's
    gmm-decode-faster best paths of the utterances with mono.mdl at
    --acoustic-scale=1.0 (mono_ali) and those as posteriors (mono_post)."""
    s = train_system()
    if "mono_ali" not in _TRAIN:
        p = s["p"]
        assert port_tool("gmm-decode-faster", "--acoustic-scale=1.0", "--max-active=500",
                         s["mono"], s["hclg_mono"], s["feats_r"], f"ark,t:{p('mono_w.txt')}",
                         f"ark:{p('mono_ali.ark')}") == 0
        assert port_tool("ali-to-post", f"ark:{p('mono_ali.ark')}",
                         f"ark:{p('mono_post.ark')}") == 0
        _TRAIN.update(mono_ali=f"ark:{p('mono_ali.ark')}", mono_post=f"ark:{p('mono_post.ark')}")
    return _TRAIN


def lda_system() -> dict:
    """train_system() and a 13-dimensional LDA space, as train_lda_mllt.sh
    builds it (the port's tools, once): silence-weighted posteriors of the
    alignments (wpost), the LDA features (lda_feats) and a single-Gaussian
    model on tri.mdl's tree in that space (lda_mdl)."""
    s = train_system()
    if "lda_mdl" not in _TRAIN:
        p = s["p"]
        for argv in (("weight-silence-post", "0.1", "1", s["tri"], s["post"],
                      f"ark:{p('wpost.ark')}"),
                     ("acc-lda", s["tri"], s["feats_r"], f"ark:{p('wpost.ark')}", p("x.lacc")),
                     ("est-lda", "--dim=13", p("x.lacc"), p("x_lda.mat")),
                     ("transform-feats", p("x_lda.mat"), s["feats_r"], f"ark:{p('x_lda.ark')}"),
                     ("acc-tree-stats", s["tri"], f"ark:{p('x_lda.ark')}", s["ali"],
                      p("x_lda.stats")),
                     ("gmm-init-model", p("tree"), p("x_lda.stats"), s["tri"], p("x_lda.mdl"))):
            assert port_tool(*argv) == 0
        _TRAIN.update(wpost=f"ark:{p('wpost.ark')}", lda_feats=f"ark:{p('x_lda.ark')}",
                      lda_mdl=p("x_lda.mdl"))
    return _TRAIN
