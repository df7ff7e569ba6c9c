"""The tensor tools of the port's second CLI batch, and its GMM and LM file
tools, against the JAX package's, on the CPU (the port's tools with
--device=cpu, where the GMM kernel runs its plain version).

The shared system of tests/torch_cli_system.py with mono.mdl.  The JAX GMM
decode breaks its backtraces at acoustic scale 0.1 (ROADMAP queue 3), so
gmm-decode-faster is held tool to tool at --acoustic-scale=1.0 and at its
default 0.1 to the JAX decoder on loglikes pre-scaled by np.float32(0.1)
at scale 1.0: words and alignments equal.  gmm-rescore-lattice's lattices
equal the JAX tool's arc for arc, graph costs within 1e-5 and acoustic
costs within 1e-5 + 2e-5·|cost| (the JAX tool scores in float64, the port
in float32: tests/test_torch_cli_decode.py); an archived lattice carries
no state times, so both tools leave its costs as they were (the state-time
fault, ROADMAP queue 3), and the rows of the tool's one padded launch
rescore a lattice whose times are recomputed exactly as a per-utterance
call does.  gmm-acc-stats' accumulators are within 1e-9 relative of the JAX
tool's (it sums by pdf, the port in one call over every entry), transition
counts equal, each package reading the other's file.  gmm-copy and arpa-to-const-arpa write the JAX tools' files byte for
byte.  The RNNLM tools at toy widths, as tests/test_cli.py runs them: each
package's rnnlm-train learns the corpus (the rescored best path flips), the
port's file is the library's `train_rnnlm` on the same sentences, and both
packages' lattice-lmrescore-rnnlm on either package's model agree within
1e-4 on every cost (the LSTM in float32 in both).  The six tensor tools
raise without a card unless --device=cpu is given."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import jax_tool, lattices_equal, port_tool, system

ACC_REL = 1e-9
TOL_LM = 1e-4


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def s():
    """The port's lattices of the 4 utterances at --acoustic-scale=1.0 and
    their posteriors."""
    s = system()
    p = s["p"]
    assert port_tool("gmm-latgen-faster", "--acoustic-scale=1.0", "--lattice-beam=6",
                     "--max-active=500", s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                     f"ark:{p('gl_lat.ark')}") == 0
    assert port_tool("lattice-to-post", "--acoustic-scale=1.0", s["mono"],
                     f"ark:{p('gl_lat.ark')}", f"ark:{p('gl_post.ark')}") == 0
    return s


def _mono_loglikes(s):
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    model = AmGmmModel.load(s["mono"], device="cpu")
    keys, padded, nf = pad_feature_batch(s["feats"])
    return model, keys, model.am.loglikes_batch(torch.from_numpy(padded)), nf


def test_gmm_decode_faster_equals_the_jax_tool(s):
    p = s["p"]
    out = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("gmm-decode-faster", "--acoustic-scale=1.0", "--max-active=500",
                  f"--word-symbol-table={p('lang', 'words.txt')}", s["mono"], s["hclg_mono"],
                  f"ark:{p('feats.ark')}", f"ark,t:{p('gl_' + name + '_w.txt')}",
                  f"ark:{p('gl_' + name + '_ali.ark')}") == 0
        out[name] = (read_table(f"ark:{p('gl_' + name + '_w.txt')}", "text"),
                     read_table(f"ark:{p('gl_' + name + '_ali.ark')}", "ivec"))
    assert out["jax"][0] == out["port"][0] and len(out["port"][0]) == 4
    for k, a in out["port"][1].items():
        assert np.array_equal(a, out["jax"][1][k]) and len(a) == len(s["feats"][k])


def test_gmm_decode_faster_at_scale_0_1_equals_the_jax_decoder_and_the_library(s):
    import old_kaldi_git_tpu.decoder.csr as jcsr
    import old_kaldi_git_tpu.decoder.viterbi as jvit
    import old_kaldi_git_tpu.fst.vector_fst as jfst
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    p = s["p"]
    assert port_tool("gmm-decode-faster", s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                     f"ark,t:{p('gl_w01.txt')}", f"ark:{p('gl_ali01.ark')}") == 0
    got = read_table(f"ark:{p('gl_w01.txt')}", "text")
    ali = read_table(f"ark:{p('gl_ali01.ark')}", "ivec")
    jmodel = jgmm.AmGmmModel.load(s["mono"])
    with open(s["hclg_mono"], "rb") as f:
        csr = jcsr.fst_to_csr(jfst.VectorFst.read(f), jmodel.tm.tid_to_pdf_array())
    keys, padded, nf = pad_feature_batch(s["feats"])
    B, T, D = padded.shape
    ll = jmodel.am.loglikes_numpy(padded.reshape(-1, D)).reshape(B, T, -1)
    res = jvit.decode_batch(csr, (ll * np.float32(0.1)).astype(np.float32), nf,
                            jvit.ViterbiOptions(acoustic_scale=1.0))
    assert got == {k: " ".join(str(w) for w in r.words) for k, r in zip(keys, res)}
    model, keys, tll, nf = _mono_loglikes(s)
    lib = decode_batch(read_hclg_csr(s["hclg_mono"], model.tm.tid_to_pdf_array()), tll, nf,
                       ViterbiOptions(), device="cpu")
    for k, r in zip(keys, lib):
        assert got[k] == " ".join(str(w) for w in r.words)
        assert np.array_equal(ali[k], r.alignment)


def test_gmm_rescore_lattice_equals_the_jax_tool_and_per_utterance_rescoring(s):
    """The tools read archived lattices, which carry no state times, so
    both leave the costs as they were (the state-time fault); the rows of
    the tool's one padded launch rescore lattices with their times
    recomputed exactly as per-utterance calls do."""
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_state_times
    from old_kaldi_git_tpu_torch.lat.rescore import rescore_lattice_acoustics

    p = s["p"]
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("gmm-rescore-lattice", s["mono"], f"ark:{p('gl_lat.ark')}",
                  f"ark:{p('feats.ark')}", f"ark:{p('gl_' + name + '_resc.ark')}") == 0
    j = read_table(f"ark:{p('gl_jax_resc.ark')}", "lat")
    t = read_table(f"ark:{p('gl_port_resc.ark')}", "lat")
    assert sorted(j) == sorted(t) == sorted(s["feats"])
    model, keys, ll, nf = _mono_loglikes(s)
    batched = read_table(f"ark:{p('gl_lat.ark')}", "lat")
    single = read_table(f"ark:{p('gl_lat.ark')}", "lat")
    for i, k in enumerate(keys):
        lattices_equal(j[k], t[k])
        lattices_equal(single[k], t[k], 0.0, 0.0)
        one = model.am.loglikes_batch(torch.from_numpy(s["feats"][k])).numpy()
        assert np.array_equal(ll[i, : nf[i]].numpy(), one)
        for lat, rows in ((batched[k], ll[i, : nf[i]].numpy()), (single[k], one)):
            lattice_state_times(lat)
            rescore_lattice_acoustics(lat, rows, model.tm.tid_to_pdf)
        lattices_equal(batched[k], single[k], 0.0, 0.0)
        assert any(x.acoustic_cost != y.acoustic_cost for a, b in zip(t[k].arcs, single[k].arcs)
                   for x, y in zip(a, b))


def test_gmm_acc_stats_equals_the_jax_tool(s):
    """On weighted tid posteriors of the best paths' alignments, and on
    lattice-to-post's posteriors (pdf ids, read as tids by both tools),
    which have no frame (the state-time fault): both write zero
    statistics."""
    import old_kaldi_git_tpu.gmm.mle as jmle
    from old_kaldi_git_tpu_torch.gmm.mle import read_accs

    p = s["p"]
    assert port_tool("lattice-best-path", "--acoustic-scale=1.0", f"ark:{p('gl_lat.ark')}",
                     f"ark,t:{p('gl_bp.txt')}", f"ark:{p('gl_bp_ali.ark')}") == 0
    rng = np.random.default_rng(5)
    with TableWriter(f"ark:{p('gl_tpost.ark')}", "post") as w:
        for k, a in read_table(f"ark:{p('gl_bp_ali.ark')}", "ivec").items():
            w[k] = [[(int(t), float(rng.uniform(0.2, 1.0))), (1 + int(t) % 7, 0.125)] for t in a]
    for post in ("gl_post.ark", "gl_tpost.ark"):
        for name, fn in (("jax", jax_tool), ("port", port_tool)):
            assert fn("gmm-acc-stats", s["mono"], f"ark:{p('feats.ark')}", f"ark:{p(post)}",
                      p(f"gl_{name}.acc")) == 0
        accs = {}
        for name in ("jax", "port"):
            with open(p(f"gl_{name}.acc"), "rb") as f:
                accs[name] = read_accs(f, device="cpu")
        with open(p("gl_port.acc"), "rb") as f:
            by_jax, jtrans = jmle.read_accs(f)
        (ja, jt), (ta, tt) = accs["jax"], accs["port"]
        assert np.array_equal(jt, tt) and np.array_equal(jtrans, tt)
        assert (tt.sum() > 100) == (post == "gl_tpost.ark")
        for f in ("occ", "mean_acc", "var_acc"):
            a, b = getattr(ta, f).numpy(), getattr(ja, f).numpy()
            np.testing.assert_allclose(a, b, rtol=ACC_REL, atol=ACC_REL * np.abs(b).max())
            assert np.array_equal(getattr(by_jax, f), a)
        assert ta.tot_frames == pytest.approx(ja.tot_frames, rel=ACC_REL)
        assert ta.tot_like == pytest.approx(ja.tot_like, rel=ACC_REL)


def test_model_and_lm_file_tools_write_the_jax_tools_files(s):
    p = s["p"]
    for tool, args in (("gmm-copy", [s["mono"]]), ("arpa-to-const-arpa", [p("G.arpa")])):
        for name, fn in (("jax", jax_tool), ("port", port_tool)):
            assert fn(tool, *args, p(f"gl_{name}_{tool}")) == 0
        assert _bytes(p(f"gl_jax_{tool}")) == _bytes(p(f"gl_port_{tool}")), tool
    # the const-arpa file rescores as its ARPA text does, in both packages
    assert port_tool("lattice-determinize", f"ark:{p('gl_lat.ark')}",
                     f"ark:{p('gl_clat.ark')}") == 0
    wl = f"--words={p('lang', 'words.txt')}"
    outs = []
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        for lm in ("G.arpa", "gl_port_arpa-to-const-arpa"):
            o = p(f"gl_{name}_pruned_{os.path.basename(lm)}")
            assert fn("lattice-lmrescore-pruned", wl, "--lm-scale=0.5", "--lattice-beam=4",
                      f"ark:{p('gl_clat.ark')}", p(lm), f"ark:{o}") == 0
            outs.append(_bytes(o))
    assert all(o == outs[0] for o in outs) and len(outs[0]) > 100


def _toy_rnnlm_inputs(p):
    """tests/test_cli.py's corpus (alpha alpha, 30 times) and its two-word
    lattice whose old graph costs prefer beta beta."""
    from old_kaldi_git_tpu_torch.lat.lattice import Lattice, LatticeArc

    with open(p("gl_rwords.txt"), "w") as f:
        f.write("<eps> 0\nalpha 1\nbeta 2\n")
    with TableWriter(f"ark:{p('gl_rtext.ark')}", "text") as w:
        for i in range(30):
            w[f"s{i}"] = "alpha alpha"
    lat = Lattice()
    s0, s1, s2 = (lat.add_state(t) for t in range(3))
    lat.start = s0
    for a, b in ((s0, s1), (s1, s2)):
        lat.arcs[a] += [LatticeArc(1, 1, 0.3, 0.0, b), LatticeArc(2, 2, 0.0, 0.0, b)]
    lat.finals[s2] = (0.0, 0.0)
    with TableWriter(f"ark:{p('gl_rlat.ark')}", "lat") as w:
        w["u0"] = lat
        w["u1"] = lat


def test_rnnlm_train_and_lattice_lmrescore_rnnlm_equal_across_the_packages(s):
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path
    from old_kaldi_git_tpu_torch.lm.rnnlm import RnnLmOptions, load_rnnlm, train_rnnlm

    p = s["p"]
    _toy_rnnlm_inputs(p)
    widths = ["--num-epochs=20", "--embed-dim=8", "--cell-dim=16", "--recurrent-dim=8"]
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("rnnlm-train", *widths, f"ark:{p('gl_rtext.ark')}", p("gl_rwords.txt"),
                  p(f"gl_{name}.rnnlm")) == 0
    lib = train_rnnlm([[1, 1]] * 30, 2, RnnLmOptions(num_epochs=20, embed_dim=8, cell_dim=16,
                                                     recurrent_dim=8), device="cpu")
    tool = load_rnnlm(p("gl_port.rnnlm"), device="cpu")
    for a, b in zip(lib.model.state_dict().values(), tool.model.state_dict().values()):
        assert torch.equal(a, b)
    for model in ("jax", "port"):
        res = {}
        for name, fn in (("jax", jax_tool), ("port", port_tool)):
            o = p(f"gl_resc_{model}_by_{name}.ark")
            assert fn("lattice-lmrescore-rnnlm", "--rnnlm-scale=1.0", "--n=4",
                      p(f"gl_{model}.rnnlm"), f"ark:{p('gl_rlat.ark')}", f"ark:{o}") == 0
            res[name] = read_table(f"ark:{o}", "lat")
        assert sorted(res["jax"]) == sorted(res["port"]) == ["u0", "u1"]
        for k, lat in res["port"].items():
            lattices_equal(res["jax"][k], lat, atol=TOL_LM, ac_rtol=0.0)
            assert lattice_best_path(lat)[0] == [1, 1], model


def test_the_tensor_tools_raise_without_a_card_and_run_on_the_cpu_by_name(s):
    import old_kaldi_git_tpu_torch.bin.tools as ttools

    p = s["p"]
    calls = {
        "gmm-decode-faster": [s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                              f"ark:{p('gl_dev.txt')}"],
        "gmm-rescore-lattice": [s["mono"], f"ark:{p('gl_lat.ark')}", f"ark:{p('feats.ark')}",
                                f"ark:{p('gl_dev.ark')}"],
        "gmm-acc-stats": [s["mono"], f"ark:{p('feats.ark')}", f"ark:{p('gl_post.ark')}",
                          p("gl_dev.acc")],
        "rnnlm-train": ["--num-epochs=1", "--embed-dim=4", "--cell-dim=4", "--recurrent-dim=4",
                        f"ark:{p('text.ark')}", p("lang", "words.txt"), p("gl_dev.rnnlm")],
        "lattice-lmrescore-rnnlm": [p("gl_dev.rnnlm"), f"ark:{p('gl_lat.ark')}",
                                    f"ark:{p('gl_dev_r.ark')}"],
        "ivector-extract-online2": [os.path.join(os.path.dirname(s["mono"]), "final.ie"),
                                    f"ark:{p('feats.ark')}", f"ark:{p('gl_dev_iv.ark')}"],
    }
    for tool, args in calls.items():
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ttools.main([tool] + args)
        assert ttools.main([tool, "--device=cpu"] + args) == 0, tool
    assert len(read_table(f"ark:{p('gl_dev_iv.ark')}", "mat")) == 4
