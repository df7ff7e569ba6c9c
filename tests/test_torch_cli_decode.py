"""The decode and lattice tools of the port's CLI against the JAX package's,
on the CPU (tools called in-process, the port's with --device=cpu).

The shared system of tests/torch_cli_system.py: mono.mdl on its HCLG of the
lexicon and a unigram over 4 held-out sentences.  The JAX package's
GMM decode breaks its backtraces at acoustic scale 0.1 (ROADMAP queue 3), so
the tools are held to each other at --acoustic-scale=1.0, and the port's
tool at its default 0.1 to the JAX decoder on loglikes pre-scaled by
np.float32(0.1) at scale 1.0, the queue's rule.  Words are equal; lattices
equal arc for arc, graph costs within 1e-5 and acoustic costs within 1e-5 +
2e-5·|cost|: the JAX tool scores the GMMs in float64 on the host
(`loglikes_numpy`), the port in float32 (the GMM kernel's plain version
here), 1.4e-3 apart at loglikes of 5.9e3; a lattice arc's acoustic cost
sums them.  Every lattice-tool output (tables, text, stdout) is equal, each
package's tool reading the other's lattices."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import jax_tool, lattices_equal, port_tool, run, system


@pytest.fixture(scope="module")
def decoded():
    """Both packages' gmm-latgen-faster at --acoustic-scale=1.0 (lattices
    and words) and the port's at its defaults."""
    s = system()
    p = s["p"]
    wt = f"--word-symbol-table={p('lang', 'words.txt')}"
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("gmm-latgen-faster", "--acoustic-scale=1.0", "--lattice-beam=6",
                  "--max-active=500", wt,
                  s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                  f"ark:{p(name + '_lat.ark')}",
                  f"ark,t:{p(name + '_words.txt')}") == 0
    assert port_tool("gmm-latgen-faster", wt, s["mono"], s["hclg_mono"],
                     f"ark:{p('feats.ark')}",
                     f"ark:{p('port_lat01.ark')}", f"ark,t:{p('port_words01.txt')}") == 0
    return s


def test_gmm_latgen_faster_equals_the_jax_tool(decoded):
    p = decoded["p"]
    jw = read_table(f"ark:{p('jax_words.txt')}", "text")
    tw = read_table(f"ark:{p('port_words.txt')}", "text")
    assert jw == tw and len(tw) == 4
    # the port's lattices read by the JAX package's holder, and the reverse
    import old_kaldi_git_tpu.utils.table as jtable

    jl = jtable.read_table(f"ark:{p('jax_lat.ark')}", "lat")
    tl = read_table(f"ark:{p('port_lat.ark')}", "lat")
    tl_by_jax = jtable.read_table(f"ark:{p('port_lat.ark')}", "lat")
    jl_by_port = read_table(f"ark:{p('jax_lat.ark')}", "lat")
    assert sorted(jl) == sorted(tl) == sorted(tw)
    for k in tl:
        lattices_equal(jl[k], tl[k])
        lattices_equal(tl_by_jax[k], tl[k], 0.0, 0.0)
        lattices_equal(jl_by_port[k], jl[k], 0.0, 0.0)


def test_gmm_latgen_faster_at_scale_0_1_equals_the_jax_decoder_on_prescaled_loglikes(
        decoded):
    import old_kaldi_git_tpu.decoder.csr as jcsr
    import old_kaldi_git_tpu.decoder.viterbi as jvit
    import old_kaldi_git_tpu.fst.vector_fst as jfst
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    s = decoded
    model = jgmm.AmGmmModel.load(s["mono"])
    with open(s["hclg_mono"], "rb") as f:
        csr = jcsr.fst_to_csr(jfst.VectorFst.read(f), model.tm.tid_to_pdf_array())
    keys, padded, nf = pad_feature_batch(s["feats"])
    B, T, D = padded.shape
    ll = model.am.loglikes_numpy(padded.reshape(-1, D)).reshape(B, T, -1)
    res = jvit.decode_batch(csr, (ll * np.float32(0.1)).astype(np.float32), nf,
                            jvit.ViterbiOptions(acoustic_scale=1.0))
    words = s["words"]
    want = {k: " ".join(words[w] for w in r.words) for k, r in zip(keys, res)}
    assert read_table(f"ark:{s['p']('port_words01.txt')}", "text") == want


@pytest.mark.parametrize("tool,opts,holder", [
    ("lattice-best-path", ["--acoustic-scale=1.0"], "text"),
    ("lattice-prune", ["--beam=3", "--acoustic-scale=1.0"], "lat"),
    ("lattice-scale", ["--acoustic-scale=0.5", "--lm-scale=2"], "lat"),
    ("lattice-to-nbest", ["--n=3", "--acoustic-scale=1.0"], "lat"),
])
def test_lattice_tools_equal_the_jax_tools(decoded, tool, opts, holder):
    p = decoded["p"]
    outs = {}
    for name, fn, src in (("jax", jax_tool, "port_lat.ark"),
                          ("port", port_tool, "jax_lat.ark")):
        assert fn(tool, *opts, f"ark:{p(src)}", f"ark:{p(name + '_' + tool)}") == 0
        outs[name] = read_table(f"ark:{p(name + '_' + tool)}", holder)
    assert sorted(outs["jax"]) == sorted(outs["port"]) and outs["port"]
    for k in outs["port"]:
        if holder == "lat":
            lattices_equal(outs["jax"][k], outs["port"][k])
        else:
            assert outs["jax"][k] == outs["port"][k]


def test_nbest_linear_round_trip_and_combine(decoded):
    p = decoded["p"]
    got = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        o = lambda x: p(f"{name}_{x}")  # noqa: E731
        assert fn("lattice-to-nbest", "--n=2", "--acoustic-scale=1.0",
                  f"ark:{p('port_lat.ark')}", f"ark:{o('nb.ark')}") == 0
        assert fn("nbest-to-linear", f"ark:{o('nb.ark')}", f"ark:{o('ali.ark')}",
                  f"ark,t:{o('w.txt')}", f"ark,t:{o('lm.txt')}", f"ark,t:{o('ac.txt')}") == 0
        assert fn("linear-to-nbest", f"ark:{o('ali.ark')}", f"ark:{o('w.txt')}",
                  f"ark:{o('lm.txt')}", f"ark:{o('ac.txt')}", f"ark:{o('lin.ark')}") == 0
        assert fn("lattice-combine", "--lat-weights=0.5:0.5", f"ark:{p('port_lat.ark')}",
                  f"ark:{p('jax_lat.ark')}", f"ark:{o('comb.ark')}") == 0
        got[name] = [read_table(f"ark:{o('ali.ark')}", "ivec"),
                     read_table(f"ark:{o('w.txt')}", "text"),
                     read_table(f"ark:{o('lm.txt')}", "text"),
                     read_table(f"ark:{o('lin.ark')}", "lat"),
                     read_table(f"ark:{o('comb.ark')}", "lat")]
    j, t = got["jax"], got["port"]
    assert sorted(j[0]) == sorted(t[0]) and len(t[0]) == 8
    for k in t[0]:
        assert np.array_equal(j[0][k], t[0][k])
    assert j[1] == t[1] and j[2] == t[2]
    for k in t[3]:
        lattices_equal(j[3][k], t[3][k])
    for k in t[4]:
        lattices_equal(j[4][k], t[4][k])


def test_determinize_rescore_and_mbr_equal_the_jax_tools(decoded):
    p = decoded["p"]
    wl = f"--words={p('lang', 'words.txt')}"
    out = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        o = lambda x: p(f"{name}_{x}")  # noqa: E731
        assert fn("lattice-determinize-pruned", "--beam=6", "--acoustic-scale=1.0",
                  f"ark:{p('port_lat.ark')}", f"ark:{o('clat.ark')}") == 0
        assert fn("lattice-lmrescore-const-arpa", wl, "--lm-scale=0.5",
                  f"ark:{o('clat.ark')}", p("G.arpa"), f"ark:{o('clat2.ark')}") == 0
        assert fn("lattice-mbr-decode", "--acoustic-scale=1.0",
                  f"ark:{o('clat2.ark')}", f"ark,t:{o('mbr.txt')}", f"ark:{o('conf.ark')}") == 0
        out[name] = (open(o("clat.ark"), "rb").read(), open(o("clat2.ark"), "rb").read(),
                     read_table(f"ark:{o('mbr.txt')}", "text"),
                     read_table(f"ark:{o('conf.ark')}", "vec"))
    assert out["jax"][0] == out["port"][0]
    assert out["jax"][1] == out["port"][1]
    # the const-arpa form of the same LM, written by the JAX package
    import old_kaldi_git_tpu.lm.arpa as jarpa

    jarpa.write_const_arpa(jarpa.load_lm(p("G.arpa")), p("G.carpa"))
    assert port_tool("lattice-lmrescore-const-arpa", wl, "--lm-scale=0.5",
                     f"ark:{p('port_clat.ark')}", p("G.carpa"), f"ark:{p('carpa.ark')}") == 0
    assert open(p("carpa.ark"), "rb").read() == out["port"][1]
    assert out["jax"][2] == out["port"][2] and len(out["port"][2]) == 4
    for k, v in out["port"][3].items():
        np.testing.assert_allclose(v, out["jax"][3][k], atol=1e-6)


def test_oracle_depth_wer_and_model_tools_print_as_the_jax_tools(decoded, capsys):
    p = decoded["p"]
    pairs = [
        ("lattice-oracle", f"ark:{p('port_lat.ark')}", f"ark:{p('ref_ids.ark')}",
         "ark,t:{o}"),
        ("lattice-depth", f"ark:{p('jax_lat.ark')}"),
        ("compute-wer", f"ark:{p('text.ark')}", f"ark:{p('port_words01.txt')}"),
        ("gmm-info", decoded["mono"]),
    ]
    for argv in pairs:
        res = {}
        for name, fn in (("jax", jax_tool), ("port", port_tool)):
            args = [a.replace("{o}", p(f"{name}_oracle.txt")) for a in argv[1:]]
            res[name] = run(capsys, fn, argv[0], *args)
        assert res["jax"] == res["port"], argv[0]
        assert res["port"][0] == 0 and res["port"][1]
    assert read_table(f"ark:{p('jax_oracle.txt')}", "text") == read_table(
        f"ark:{p('port_oracle.txt')}", "text")


def test_ali_to_phones_equals_the_jax_tool(decoded):
    p = decoded["p"]
    assert port_tool("lattice-best-path", "--acoustic-scale=1.0", f"ark:{p('port_lat.ark')}",
                     f"ark:{p('bp_w.txt')}", f"ark:{p('bp_ali.ark')}") == 0
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("ali-to-phones", decoded["mono"], f"ark:{p('bp_ali.ark')}",
                  f"ark:{p(name + '_phones.ark')}") == 0
    j = read_table(f"ark:{p('jax_phones.ark')}", "ivec")
    t = read_table(f"ark:{p('port_phones.ark')}", "ivec")
    assert sorted(j) == sorted(t) and len(t) == 4
    assert all(np.array_equal(j[k], t[k]) and len(t[k]) > 0 for k in t)


def test_online_wav_gmm_latgen_faster_equals_the_jax_tool(decoded, capsys):
    """The first 1.5 s of one utterance, cut by extract-segments (the JAX
    package's streaming GMM decode compiles for each chunk shape;
    tests/test_torch_online.py holds the decoder itself)."""
    s = decoded
    p = s["p"]
    with open(p("segments"), "w") as f:
        f.write("seg1 test_0001 0.0 1.5\n")
    assert port_tool("extract-segments", f"scp:{p('wav.scp')}", p("segments"),
                     f"ark:{p('seg.ark')}") == 0
    wt = f"--word-symbol-table={p('lang', 'words.txt')}"
    got = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        rc, out = run(capsys, fn, "online-wav-gmm-latgen-faster", "--samp-freq=8000",
                      "--chunk-seconds=0.75", wt, s["mono"], s["hclg_mono"],
                      f"ark:{p('seg.ark')}",
                      f"ark,t:{p(name + '_online.txt')}")
        assert rc == 0
        printed = [ln.split("): ", 1)[1] for ln in out.splitlines() if "): " in ln]
        got[name] = (read_table(f"ark:{p(name + '_online.txt')}", "text"), printed)
    assert got["jax"] == got["port"] and len(got["port"][0]) == 1
    assert list(got["port"][0].values()) == got["port"][1] and got["port"][1][0]


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_the_lattice_rebuild_keeps_the_jax_loops_arcs(decoded, scale):
    """`lattice_from_decode` finds its candidate arcs with numpy: on the same
    decode (mono.mdl's loglikes, K = S) it keeps exactly the arcs of the JAX
    package's per-arc loop, state for state."""
    import old_kaldi_git_tpu.lat.lattice as jlat
    import old_kaldi_git_tpu_torch.lat.lattice as tlat
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    s = decoded
    model = AmGmmModel.load(s["mono"], device="cpu")
    csr = read_hclg_csr(s["hclg_mono"], model.tm.tid_to_pdf_array())
    keys, padded, nf = pad_feature_batch(s["feats"])
    ll = model.am.loglikes_batch(torch.from_numpy(padded)).numpy()
    res = decode_batch(csr, ll[:2], nf[:2], ViterbiOptions(acoustic_scale=scale),
                       want_lattice=True, device="cpu")
    arcs = 0
    for b, r in enumerate(res):
        args = (csr, ll[b, : nf[b]], r.frame_states, r.frame_costs, scale, 8.0)
        tl, jl = tlat.lattice_from_decode(*args), jlat.lattice_from_decode(*args)
        assert tl.start == jl.start and tl.state_time == jl.state_time
        assert tl.finals == jl.finals
        assert [[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate) for a in x]
                for x in tl.arcs] == [[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                                        a.nextstate) for a in x] for x in jl.arcs]
        arcs += tl.num_arcs
    assert arcs > 1000
