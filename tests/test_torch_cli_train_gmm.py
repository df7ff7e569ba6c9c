"""The port's model-initialisation, EM, posterior and utility training tools
against the JAX package's, on the CPU (the port's tensor tools with
--device=cpu).

The shared system of tests/torch_cli_system.py (train_system: tri.mdl's
equal alignments of the 4 utterances).  Files
the JAX tools write in integers, float64 or through host numpy in both
packages are held byte for byte (models of gmm-init-mono, gmm-init-model,
gmm-mixup and gmm-boost-silence, alignments, posteriors, the utility
tools' outputs); gmm-acc-stats-ali's float64 accumulators within 1e-9 of
each array's largest magnitude, each package reading the other's file in
gmm-sum-accs and gmm-est; gmm-est's float32 models within one float32
rounding (rtol 1e-6) of the JAX tool's; gmm-compute-likes within the GMM
kernel's contract (2e-3 + 2e-3·|ref|, tests/test_torch_gmm_tiles.py) of the
JAX tool and equal to the port's loglikes_batch."""

import tests.torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.bin.train_tools import read_arrays, write_arrays
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import both, jax_tool, port_tool, read_bytes, train_system

ACC_REL = 1e-9
MODEL_RTOL = 1e-6
K3_TOL = 2e-3


@pytest.fixture(scope="module")
def s():
    s = train_system()
    p = s["p"]
    # a small tree and its model (the port's tools) for gmm-init-model / convert-ali
    assert port_tool("acc-tree-stats", s["tri"], s["feats_r"], s["ali"], p("g_tree.stats")) == 0
    assert port_tool("build-tree", "--max-leaves=40", p("g_tree.stats"), s["tri"],
                     p("g_tree")) == 0
    return s


def _models_close(a_path, b_path, rtol=0.0):
    a, b = (AmGmmModel.load(x, device="cpu") for x in (a_path, b_path))
    assert a.am.num_pdfs == b.am.num_pdfs
    for x, y in zip(a.am.pdfs, b.am.pdfs):
        for f in ("weights", "means", "vars"):
            np.testing.assert_allclose(getattr(x, f), getattr(y, f), rtol=rtol, atol=0)
    np.testing.assert_allclose(a.tm.log_probs, b.tm.log_probs, rtol=rtol, atol=1e-7)


def _accs(path):
    from old_kaldi_git_tpu_torch.gmm.mle import read_accs

    with open(path, "rb") as f:
        accs, trans = read_accs(f, device="cpu")
    return {"occ": accs.occ.numpy(), "mean": accs.mean_acc.numpy(),
            "var": accs.var_acc.numpy(), "trans": trans,
            "like": np.asarray([accs.tot_like]), "frames": np.asarray([accs.tot_frames])}


def _close_rel(a, b, rel):
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= rel * max(np.abs(b[k]).max(), 1e-300), k


def test_gmm_init_mono_writes_the_jax_tools_model_and_tree(s):
    p = s["p"]
    both("gmm-init-mono", p("lang"), s["feats_r"], p("{out}_0.mdl"), p("{out}_mono.tree"))
    assert read_bytes(p("jax_0.mdl")) == read_bytes(p("port_0.mdl"))
    assert read_bytes(p("jax_mono.tree")) == read_bytes(p("port_mono.tree"))


def test_gmm_init_model_and_convert_ali_are_the_jax_tools_bytes(s):
    p = s["p"]
    both("gmm-init-model", p("g_tree"), p("g_tree.stats"), s["tri"], p("{out}_init.mdl"))
    assert read_bytes(p("jax_init.mdl")) == read_bytes(p("port_init.mdl"))
    both("convert-ali", s["tri"], p("port_init.mdl"), p("g_tree"), s["ali"],
         f"ark:{p('{out}_conv.ali')}")
    assert read_bytes(p("jax_conv.ali")) == read_bytes(p("port_conv.ali"))
    conv = read_table(f"ark:{p('port_conv.ali')}", "ivec")
    assert {k: len(v) for k, v in conv.items()} == {k: len(v) for k, v in s["feats"].items()}


def test_gmm_acc_stats_ali_sum_accs_and_est(s):
    """Accumulators within 1e-9 relative; gmm-sum-accs of the halves, each
    package reading the other's files; gmm-est (with --mix-up) on either
    package's sum within one float32 rounding."""
    p = s["p"]
    keys = s["keys"]
    for half, ks in (("a", keys[:2]), ("b", keys[2:])):
        with TableWriter(f"ark:{p('g_feats_' + half + '.ark')}", "mat") as w:
            for k in ks:
                w[k] = s["feats"][k]
        both("gmm-acc-stats-ali", s["tri"], f"ark:{p('g_feats_' + half + '.ark')}", s["ali"],
             p("{out}_" + half + ".acc"))
        _close_rel(_accs(p("port_" + half + ".acc")), _accs(p("jax_" + half + ".acc")), ACC_REL)
    assert jax_tool("gmm-sum-accs", p("jax_sum_of_port.acc"), p("port_a.acc"),
                    p("port_b.acc")) == 0
    assert port_tool("gmm-sum-accs", p("port_sum_of_jax.acc"), p("jax_a.acc"),
                     p("jax_b.acc")) == 0
    _close_rel(_accs(p("port_sum_of_jax.acc")), _accs(p("jax_sum_of_port.acc")), ACC_REL)
    both("gmm-acc-stats-ali", s["tri"], s["feats_r"], s["ali"], p("{out}_all.acc"))
    _close_rel(_accs(p("port_sum_of_jax.acc")), _accs(p("port_all.acc")), ACC_REL)
    both("gmm-est", "--mix-up=2900", "--min-gaussian-occupancy=3", s["tri"],
         p("jax_sum_of_port.acc"), p("{out}_est.mdl"))
    _models_close(p("port_est.mdl"), p("jax_est.mdl"), MODEL_RTOL)
    assert AmGmmModel.load(p("port_est.mdl"), device="cpu").am.num_gauss == 2900


def test_gmm_mixup_and_boost_silence_are_the_jax_tools_bytes(s):
    p = s["p"]
    occs = np.arange(1.0, 126.0)
    write_arrays(p("g.occs"), "Occs", {"occs": occs})
    np.testing.assert_array_equal(read_arrays(p("g.occs"), "Occs")["occs"], occs)
    both("gmm-mixup", "--mix-up=600", s["mono"], p("{out}_mix.mdl"))
    both("gmm-mixup", "--mix-up=600", s["mono"], p("g.occs"), p("{out}_mixo.mdl"))
    assert read_bytes(p("jax_mix.mdl")) == read_bytes(p("port_mix.mdl"))
    assert read_bytes(p("jax_mixo.mdl")) == read_bytes(p("port_mixo.mdl"))
    assert read_bytes(p("port_mix.mdl")) != read_bytes(p("port_mixo.mdl"))
    both("gmm-boost-silence", "--boost=1.5", "1", s["mono"], p("{out}_boost.mdl"))
    assert read_bytes(p("jax_boost.mdl")) == read_bytes(p("port_boost.mdl"))


def test_gmm_compute_likes_within_the_kernel_contract(s):
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    p = s["p"]
    both("gmm-compute-likes", s["mono"], s["feats_r"], f"ark:{p('{out}_likes.ark')}")
    j = read_table(f"ark:{p('jax_likes.ark')}", "mat")
    t = read_table(f"ark:{p('port_likes.ark')}", "mat")
    model = AmGmmModel.load(s["mono"], device="cpu")
    keys, padded, nf = pad_feature_batch(s["feats"])
    lib = model.am.loglikes_batch(torch.from_numpy(padded)).numpy()
    assert sorted(j) == sorted(t) == keys
    for i, k in enumerate(keys):
        assert t[k].shape == (nf[i], model.am.num_pdfs)
        np.testing.assert_array_equal(t[k], lib[i, :nf[i]])
        assert np.all(np.abs(t[k] - j[k]) <= K3_TOL + K3_TOL * np.abs(j[k]))


@pytest.mark.parametrize("tool,args,holder", [
    ("ali-to-pdf", ("{tri}", "{ali}", "ark:{p}/{out}.pdf"), "ivec"),
    ("ali-to-post", ("{ali}", "ark:{p}/{out}.post"), "post"),
    ("weight-silence-post", ("0.01", "1", "{tri}", "{post}", "ark:{p}/{out}.wpost"), "post"),
    ("post-to-pdf-post", ("{tri}", "{post}", "ark:{p}/{out}.ppost"), "post"),
    ("post-to-weights", ("{post}", "ark:{p}/{out}.weights"), "vec"),
])
def test_posterior_tools_write_the_jax_tools_archives(s, tool, args, holder):
    fill = dict(tri=s["tri"], ali=s["ali"], post=s["post"], p=s["root"])
    both(tool, *[a.format(out="{out}", **fill) for a in args])
    out = args[-1].format(out="{out}", **fill)[4:]
    j, t = out.replace("{out}", "jax"), out.replace("{out}", "port")
    assert read_bytes(j) == read_bytes(t)
    assert sorted(read_table(f"ark:{t}", holder)) == s["keys"]


def test_matrix_and_vector_utilities_write_the_jax_tools_files(s):
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_output_stream, write_matrix

    p = s["p"]
    rng = np.random.default_rng(17)
    with TableWriter(f"ark:{p('g_vec.ark')}", "vec") as w:
        for k in s["keys"]:
            w[k] = rng.normal(size=7).astype(np.float32)
    for i in range(2):
        with open(p(f"g_m{i}.mat"), "wb") as f:
            init_kaldi_output_stream(f, True)
            write_matrix(f, rng.normal(size=(5, 6)))
    both("copy-matrix", "--scale=0.5", s["feats_r"], f"ark:{p('{out}_cm.ark')}")
    both("copy-vector", "--scale=2", f"ark:{p('g_vec.ark')}", f"ark:{p('{out}_cv.ark')}")
    both("copy-int-vector", s["ali"], f"ark:{p('{out}_ci.ark')}")
    both("sum-matrices", p("{out}_sum.mat"), p("g_m0.mat"), p("g_m1.mat"))
    for name in ("cm.ark", "cv.ark", "ci.ark", "sum.mat"):
        assert read_bytes(p("jax_" + name)) == read_bytes(p("port_" + name)), name
    assert read_bytes(p("port_ci.ark")) == read_bytes(s["ali"][4:])


def test_text_and_graph_utilities_equal_the_jax_tools(s, capsys):
    """show-transitions' text, align-text's pairs, make-h-transducer's and
    add-self-loops' FSTs byte for byte."""
    p = s["p"]
    outs = {}
    for pre, fn in (("jax", jax_tool), ("port", port_tool)):
        capsys.readouterr()
        assert fn("show-transitions", p("lang", "phones.txt"), s["mono"]) == 0
        outs[pre] = capsys.readouterr().out
    assert outs["jax"] == outs["port"] and "Transition-id = " in outs["port"]
    with TableWriter(f"ark,t:{p('g_hyp.txt')}", "text") as w:
        for i, k in enumerate(s["keys"]):
            words = s["text"][k]
            w[k] = " ".join(words[1:] + (["extra"] if i % 2 else []))
    both("align-text", f"ark:{p('text.ark')}", f"ark:{p('g_hyp.txt')}",
         f"ark,t:{p('{out}_align.txt')}")
    assert read_bytes(p("jax_align.txt")) == read_bytes(p("port_align.txt"))
    assert "<eps>" in open(p("port_align.txt")).read()
    with open(p("g_ilabels.txt"), "w") as f:
        f.write("\n-42\n0 2 3\n2 3 4\n3 4 0\n0\n")
    both("make-h-transducer", p("g_ilabels.txt"), p("tree"), s["tri"], p("{out}_Ha.fst"))
    assert read_bytes(p("jax_Ha.fst")) == read_bytes(p("port_Ha.fst"))
    with open(p("g_ilabels_nd.txt"), "w") as f:  # no disambiguation symbols
        f.write("\n0 2 3\n2 3 4\n3 4 0\n")
    assert port_tool("make-h-transducer", p("g_ilabels_nd.txt"), p("tree"), s["tri"],
                     p("port_Ha_nd.fst")) == 0
    both("add-self-loops", "--self-loop-scale=0.1", s["tri"], p("port_Ha_nd.fst"),
         p("{out}_Hloops.fst"))
    assert read_bytes(p("jax_Hloops.fst")) == read_bytes(p("port_Hloops.fst"))
    assert read_bytes(p("port_Hloops.fst")) != read_bytes(p("port_Ha_nd.fst"))
