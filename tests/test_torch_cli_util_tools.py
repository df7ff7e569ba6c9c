"""The 24 utility tools of the port's CLI (bin/util_tools.py) against the JAX
package's, on the CPU (tools called in-process; only
ivector-extract-online2 takes --device).

The shared system of tests/torch_cli_system.py: its waves, features, text,
lang, tree and models, and a data dir of its 4 utterances on two speakers.
Every file the tools write (maps, data dirs, archives, FSTs, the PCA
matrix, counts) is byte-equal to the JAX tool's, each package reading the
other's archives, and what they print is the same, exit codes included;
the random tools (fstrand, compute-wer-bootci, whose draws split-data does
not make) draw the same numbers from the same seed.  est-pca's
eigenvectors, which the JAX package's and the port's numpy return alike,
are held byte for byte and, against a float64 PCA of the features, up to
sign within 1e-5.  ivector-extract-online2: the JAX package scores the
UBM's Gaussian selection in float32 and the port in float64, so the
iVectors are held within 1e-4 relative (PR 11's rule), and to the port's
library `extract_online_ivectors` on the same features exactly."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import WORKDIR, jax_tool, port_tool, run, system

IVEC_REL = 1e-4


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = _bytes(os.path.join(d, f))
    return out


def _both(capsys, tool, *argv):
    """(rc, stdout) of each package's tool; '{o}' in an argument becomes
    that package's own output path prefix, '{u}' the shared directory."""
    out = {}
    u = system()["p"]
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        args = [a.replace("{o}", u(f"ut_{name}")).replace("{u}", u()) for a in argv]
        out[name] = run(capsys, fn, tool, *args)
    assert out["jax"] == out["port"], tool
    return out["port"]


@pytest.fixture(scope="module")
def s():
    """The shared system and, in it, a data dir of its 4 utterances on two
    speakers, their features as an scp, and the best-path alignments of
    mono.mdl's decode."""
    s = system()
    p = s["p"]
    keys = sorted(s["feats"])
    d = p("ut_data")
    os.makedirs(d, exist_ok=True)
    with TableWriter(f"ark,scp:{p('ut_feats.ark')},{p('ut_feats.scp')}", "mat") as w:
        for k in keys:
            w[k] = s["feats"][k]
    with open(p("wav.scp")) as f:
        wav = f.read()
    text = read_table(f"ark:{p('text.ark')}", "text")
    files = {"wav.scp": wav, "feats.scp": open(p("ut_feats.scp")).read(),
             "text": "".join(f"{k} {text[k]}\n" for k in keys),
             "utt2spk": "".join(f"{k} spk{i % 2}\n" for i, k in enumerate(keys)),
             "utt2dur": "".join(f"{k} {len(s['waves'][k]) / 8000:.3f}\n" for k in keys)}
    for name, body in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(body)
    assert port_tool("gmm-decode-faster", "--acoustic-scale=1.0", "--max-active=500", s["mono"],
                     s["hclg_mono"], f"ark:{p('feats.ark')}", f"ark:{p('ut_w.txt')}",
                     f"ark:{p('ut_ali.ark')}") == 0
    with open(p("ut_list"), "w") as f:
        f.write("\n".join(keys[1:3]) + "\n")
    return s


def test_speaker_maps_print_and_write_as_the_jax_tools(s, capsys):
    p = s["p"]
    rc, out = _both(capsys, "utt2spk-to-spk2utt", p("ut_data", "utt2spk"))
    assert rc == 0 and out.splitlines()[0].startswith("spk0 ")
    _both(capsys, "utt2spk-to-spk2utt", p("ut_data", "utt2spk"), "{o}_spk2utt")
    assert _bytes(p("ut_jax_spk2utt")) == _bytes(p("ut_port_spk2utt"))
    rc, out = _both(capsys, "spk2utt-to-utt2spk", "{u}/ut_port_spk2utt")
    assert out == open(p("ut_data", "utt2spk")).read()
    _both(capsys, "spk2utt-to-utt2spk", "{u}/ut_jax_spk2utt", "{o}_utt2spk")
    assert _bytes(p("ut_jax_utt2spk")) == _bytes(p("ut_port_utt2spk"))


def test_data_dir_tools_write_the_jax_tools_dirs(s, capsys):
    p = s["p"]
    data = p("ut_data")
    assert _both(capsys, "validate-data-dir", data) == (0, "validate-data-dir: OK (4 utterances)\n")
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        os.makedirs(p(f"ut_{name}_d"), exist_ok=True)
        for f in os.listdir(data):
            with open(os.path.join(data, f)) as a, open(p(f"ut_{name}_d", f), "w") as b:
                b.write(a.read())
        assert fn("split-data", p(f"ut_{name}_d"), "2") == 0
    assert _tree_bytes(p("ut_jax_d")) == _tree_bytes(p("ut_port_d"))
    assert len(_tree_bytes(p("ut_port_d/split2"))) == 12
    for opts in ([], ["--per-spk"], ["--utt-list={u}/ut_list"]):
        tag = "".join(o[2:5] for o in opts)
        _both(capsys, "subset-data-dir", *opts, data, "1", "{o}_sub" + tag)
        assert _tree_bytes(p(f"ut_jax_sub{tag}")) == _tree_bytes(p(f"ut_port_sub{tag}")), opts
    assert len(open(p("ut_port_subper/utt2spk")).readlines()) == 2
    with open(os.path.join(p("ut_port_d"), "text"), "a") as f:
        f.write("extra_utt a b\n")
    rc, out = _both(capsys, "validate-data-dir", "{u}/ut_port_d")
    assert rc == 1 and out == ""


def test_info_tools_print_as_the_jax_tools(s, capsys):
    p = s["p"]
    assert _both(capsys, "tree-info", p("tree"))[1].startswith("num-pdfs 2000\n")
    for mdl in (s["mono"], s["tri"]):
        assert "number of gaussians" in _both(capsys, "am-info", mdl)[1]
    rc, dot = _both(capsys, "draw-tree", p("lang", "phones.txt"), p("tree"))
    assert rc == 0 and dot.startswith("digraph tree {") and dot.count("->") > 1000


def test_feature_tools_write_the_jax_tools_archives(s, capsys):
    p = s["p"]
    feats = f"scp:{p('ut_feats.scp')}"
    _both(capsys, "wav-copy", f"scp:{p('wav.scp')}", "ark:{o}_wav.ark")
    assert _bytes(p("ut_jax_wav.ark")) == _bytes(p("ut_port_wav.ark"))
    with open(p("ut_segments"), "w") as f:
        k = sorted(s["feats"])
        f.write(f"s1 {k[0]} 0.10 0.95\ns2 {k[1]} 1.50 99.0\ns3 {k[2]} 0.5 0.5\ns4 none 0 1\n")
    with open(p("ut_keep"), "w") as f:
        f.write(f"{k[3]}\n{k[1]}\n")
    for argv in (["extract-feature-segments", feats, "{u}/ut_segments", "ark:{o}.ark"],
                 ["subset-feats", "--n=3", feats, "ark:{o}.ark"],
                 ["subset-feats", "--include={u}/ut_keep", feats,
                  "ark:{o}.ark"],
                 ["feat-to-post", "--top-n=3", feats, "ark:{o}.ark"]):
        _both(capsys, *argv)
        assert _bytes(p("ut_jax.ark")) == _bytes(p("ut_port.ark")) and len(_bytes(p("ut_port.ark"))), argv
    segs = read_table(f"ark:{p('ut_port.ark')}", "post")
    assert len(segs) == 4 and all(len(fr) == 3 for fr in segs[k[0]])
    with TableWriter(f"ark:{p('ut_cmvn.ark')}", "mat") as w:
        for key in k:
            f = s["feats"][key].astype(np.float64)
            w[key] = np.stack([np.append(f.sum(0), len(f)), np.append((f * f).sum(0), 0.0)])
    _both(capsys, "modify-cmvn-stats", "1:5:38", "ark:{u}/ut_cmvn.ark", "ark:{o}.ark")
    assert _bytes(p("ut_jax.ark")) == _bytes(p("ut_port.ark"))
    st = read_table(f"ark:{p('ut_port.ark')}", "mat")[k[0]]
    assert st[0, 5] == 0.0 and st[1, 5] == st[0, -1]


def test_est_pca_writes_the_jax_tools_matrix(s, capsys):
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_input_stream, read_matrix

    p = s["p"]
    feats = f"scp:{p('ut_feats.scp')}"
    x = np.concatenate([s["feats"][k] for k in sorted(s["feats"])]).astype(np.float64)
    evals, evecs = np.linalg.eigh(np.cov(x.T, bias=True))
    for opts in ([], ["--dim=10", "--normalize-variance=true"], ["--normalize-mean=false"]):
        _both(capsys, "est-pca", *opts, feats, "{o}_pca.mat")
        assert _bytes(p("ut_jax_pca.mat")) == _bytes(p("ut_port_pca.mat")), opts
        with open(p("ut_port_pca.mat"), "rb") as f:
            assert init_kaldi_input_stream(f)
            T = read_matrix(f)
        rows = 10 if "--dim=10" in opts else 39
        assert T.shape == (rows, 39 + (opts != ["--normalize-mean=false"]))
        if not opts:
            want = evecs[:, ::-1].T
            got = T[:, :39] * np.sign((T[:, :39] * want).sum(1))[:, None]
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_alignment_tools_print_and_count_as_the_jax_tools(s, capsys):
    p = s["p"]
    rc, out = _both(capsys, "show-alignments", p("lang", "phones.txt"), s["mono"],
                    "ark:{u}/ut_ali.ark")
    assert rc == 0 and len(out.splitlines()) == 4 and "SIL[0:" in out
    assert _both(capsys, "show-alignments", "", s["mono"], "ark:{u}/ut_ali.ark")[0] == 0
    rc, out = _both(capsys, "analyze-counts", "ark:{u}/ut_ali.ark", "-")
    counts = [int(x) for x in out.split()[1:-1]]
    assert rc == 0 and sum(counts) == sum(len(v) for v in s["feats"].values())
    _both(capsys, "analyze-counts", "--counts-dim=400", "ark:{u}/ut_ali.ark", "{o}_counts")
    assert _bytes(p("ut_jax_counts")) == _bytes(p("ut_port_counts"))


def test_ivector_extract_online2_equals_the_jax_tool_and_the_library(s):
    import torch

    from old_kaldi_git_tpu_torch.ivector.extractor import (
        IvectorExtractor, extract_online_ivectors)

    p = s["p"]
    ie = os.path.join(WORKDIR, "final.ie")
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("ivector-extract-online2", "--ivector-period=7", ie, f"ark:{p('feats.ark')}",
                  f"ark:{p('ut_' + name + '_iv.ark')}") == 0
    j, t = read_table(f"ark:{p('ut_jax_iv.ark')}", "mat"), read_table(f"ark:{p('ut_port_iv.ark')}", "mat")
    ext = IvectorExtractor.load(ie, device="cpu")
    assert sorted(j) == sorted(t) == sorted(s["feats"])
    for k, v in t.items():
        assert v.shape == (len(s["feats"][k]), ext.ivector_dim)
        np.testing.assert_allclose(v, j[k], rtol=0, atol=IVEC_REL * np.abs(j[k]).max())
        lib = extract_online_ivectors(ext, torch.from_numpy(s["feats"][k]), 7)
        assert np.array_equal(v, lib.numpy())


def test_fst_tools_write_the_jax_tools_files(s, capsys):
    p = s["p"]
    for opts in ([], ["--srand=3", "--num-states=8", "--num-arcs=14"],
                 ["--srand=11", "--acyclic", "--num-labels=5"]):
        _both(capsys, "fstrand", *opts, "{o}_r.fst")
        assert _bytes(p("ut_jax_r.fst")) == _bytes(p("ut_port_r.fst")), opts
    with open(p("ut_din"), "w") as f:
        f.write("300 301\n")
    with open(p("ut_dout"), "w") as f:
        f.write("0 400\n")
    for fst in ("{u}/ut_port_r.fst", p("lang", "L.fst")):
        _both(capsys, "fstaddselfloops", "{u}/ut_din", "{u}/ut_dout", fst, "{o}_loops.fst")
        assert _bytes(p("ut_jax_loops.fst")) == _bytes(p("ut_port_loops.fst"))
    with open(p("ut_dout"), "w") as f:
        f.write("0\n")
    assert _both(capsys, "fstaddselfloops", "{u}/ut_din", "{u}/ut_dout", fst, "{o}_x.fst")[0] == 1


def test_text_map_tools_write_the_jax_tools_files(s, capsys):
    p = s["p"]
    words = p("lang", "words.txt")
    with open(p("ut_text"), "w") as f:
        f.write(open(p("ut_data", "text")).read() + "u9 NOT_A_WORD\n")
    _both(capsys, "sym2int", f"--map-oov={open(words).readline().split()[0]}", words, "{u}/ut_text",
          "{o}_int")
    assert _bytes(p("ut_jax_int")) == _bytes(p("ut_port_int"))
    rc, out = _both(capsys, "sym2int", words, "{u}/ut_text", "-")
    assert rc == 1 and len(out.splitlines()) == 4
    rc, out = _both(capsys, "int2sym", words, "{u}/ut_port_int", "-")
    assert rc == 0 and out.splitlines()[:4] == open(p("ut_data", "text")).read().splitlines()
    with open(p("ut_map"), "w") as f:
        toks = sorted({w for ln in open(p("ut_text")) for w in ln.split()[1:]})
        f.write("".join(f"{w} W{i}\n" for i, w in enumerate(toks[::2])))
    for opts in (["--permissive"], []):
        rc, out = _both(capsys, "apply-map", *opts, "{u}/ut_map", "{u}/ut_text", "-")
        assert rc == (0 if opts else 1)
    for opts in ([], ["--exclude"]):
        rc, out = _both(capsys, "filter-scp", *opts, "{u}/ut_list", p("wav.scp"), "-")
        assert rc == 0 and len(out.splitlines()) == (2 if not opts else 2)


def test_compute_wer_bootci_prints_the_jax_tools_interval(s, capsys):
    p = s["p"]
    rc, out = _both(capsys, "compute-wer-bootci", "--replications=500", "--srand=4",
                    f"ark:{p('text.ark')}", f"ark:{p('text.ark')}")
    assert rc == 0 and "WER 0.00 95% conf interval [ 0.00, 0.00 ]" in out
    with TableWriter(f"ark,t:{p('ut_hyp.txt')}", "text") as w:
        for i, (k, v) in enumerate(sorted(read_table(f"ark:{p('text.ark')}", "text").items())):
            w[k] = " ".join(v.split()[: -1 - i % 2])
    rc, out = _both(capsys, "compute-wer-bootci", f"ark:{p('text.ark')}", "ark:{u}/ut_hyp.txt")
    lo, hi = (float(x) for x in out.split("[")[1].split("]")[0].split(","))
    assert rc == 0 and out.startswith("Set up with 4 utterances.") and 0 < lo < hi
