"""The 9 SGMM2 tools (bin/sgmm2_tools.py) and the 4 keyword-search tools
(bin/kws_tools.py, with kws/) of the port against the JAX package's, on
the CPU (the tensor tools with --device=cpu), in process.

SGMM2: the shared system of tests/torch_cli_system.py, mono.mdl (125
pdfs) on its 4 utterances, an 8-Gaussian UBM from the JAX tools, the
monophone training graphs of the utterances (gmm-init-mono's tree) and
mono.mdl's alignments of them; two speakers of two utterances.  Model
files from the same inputs byte for byte (sgmm2-init) or their float32
fields within 1e-6 relative (after EM), float64 accumulators within 1e-9
of each array's largest magnitude, each package reading the other's;
speaker vectors and fMLLR transforms within 1e-6 relative; alignments and
decoded words equal, lattices arc for arc.

KWS: the lattices of the JAX package's tests/test_kws.py (two paths of
posteriors 0.7 / 0.3, an epsilon between two words), built in both
packages; index files (pickles) byte for byte both ways, the search
results and ATWV equal."""

import tests.torch_threads  # noqa: F401

import math
import os

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.gmm.sgmm2 import MleAmSgmm2Accs, Sgmm2Model
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import (
    jax_tool, lattices_equal, port_tool, read_bytes, run, system)

TOL = 1e-9
MODEL_RTOL = 1e-6


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def both(name, *argv, rc=0):
    for pre, fn in (("jax", jax_tool), ("port", port_tool)):
        got = fn(name, *[a.replace("{out}", pre) for a in argv])
        assert got == rc, f"{pre} {name} exited {got}"


@pytest.fixture(scope="module")
def s():
    """system() and the SGMM2 inputs (the port's tools): mono.mdl's
    monophone training graphs, its alignments, the JAX UBM as a full
    covariance GMM, the plain and the symmetric speaker-subspace SGMM2 of
    each package."""
    s = dict(system())
    p = s["p"]
    s["feats_r"] = f"ark:{p('feats.ark')}"
    for argv in (("gmm-init-mono", p("lang"), s["feats_r"], p("sg_flat.mdl"), p("sg_mono.tree")),
                 ("compile-train-graphs", p("sg_mono.tree"), s["mono"], p("lang"),
                  f"ark:{p('text.ark')}", f"ark:{p('sg_graphs.ark')}"),
                 ("gmm-align-compiled", s["mono"], f"ark:{p('sg_graphs.ark')}", s["feats_r"],
                  f"ark:{p('sg.ali')}")):
        assert port_tool(*argv) == 0
    assert jax_tool("gmm-global-init-from-feats", "--num-gauss=8", "--num-iters=3",
                    s["feats_r"], p("sg_ubm.diag")) == 0
    assert jax_tool("gmm-global-to-fgmm", p("sg_ubm.diag"), p("sg_ubm.full")) == 0
    keys = sorted(s["feats"])
    with open(p("sg_utt2spk"), "w") as f:
        f.writelines(f"{k} {'spkA' if i < 2 else 'spkB'}\n" for i, k in enumerate(keys))
    s.update(ali=f"ark:{p('sg.ali')}", graphs=f"ark:{p('sg_graphs.ark')}",
             utt2spk=p("sg_utt2spk"), keys=keys)
    return s


def _accs_close(a_path, b_path, model):
    a, b = (MleAmSgmm2Accs.load(x, model) for x in (a_path, b_path))
    for name in ("gamma", "y", "Y", "Q", "S", "Y_N", "Q_N", "a_u", "Q_u"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert rel(x.numpy(), y.numpy()) <= TOL, name
    assert a.total_like == pytest.approx(b.total_like, rel=TOL)


def _models_close(a_path, b_path, rtol=MODEL_RTOL):
    a, b = (Sgmm2Model.load(x, device="cpu").sgmm for x in (a_path, b_path))
    assert a.counts.tolist() == b.counts.tolist()
    for name in ("M", "w", "sigma_inv", "V", "C", "N", "u"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None:
            assert rel(x.numpy(), y.numpy()) <= rtol, name


def test_sgmm2_init_and_info(s, capsys):
    p = s["p"]
    both("sgmm2-init", s["mono"], p("sg_ubm.full"), p("{out}_sg0.mdl"))
    both("sgmm2-init", "--spk-space-dim=3", "--symmetric=true", s["mono"], p("sg_ubm.full"),
         p("{out}_sgs0.mdl"))
    for name in ("sg0.mdl", "sgs0.mdl"):
        assert read_bytes(p("port_" + name)) == read_bytes(p("jax_" + name)), name
    outs = [run(capsys, fn, "sgmm2-info", p("jax_sgs0.mdl")) for fn in (jax_tool, port_tool)]
    assert outs[0] == outs[1] and "number of pdfs 125" in outs[0][1]
    assert "symmetric true" in outs[0][1]
    both("sgmm2-init", "--symmetric=true", s["mono"], p("sg_ubm.full"), p("{out}_bad.mdl"),
         rc=1)


def test_sgmm2_acc_stats_sum_and_est(s):
    """Two EM iterations ('vwc', then 'MS' with a split to 140 substates),
    the accumulators of each package summed by the other."""
    p = s["p"]
    model = Sgmm2Model.load(p("jax_sg0.mdl"), device="cpu").sgmm
    both("sgmm2-acc-stats-ali", p("jax_sg0.mdl"), s["feats_r"], s["ali"], p("{out}_sg0.acc"))
    _accs_close(p("port_sg0.acc"), p("jax_sg0.acc"), model)
    assert jax_tool("sgmm2-sum-accs", p("jax_sg0.mdl"), p("jax_sum_of_port.acc"),
                    p("port_sg0.acc"), p("port_sg0.acc")) == 0
    assert port_tool("sgmm2-sum-accs", p("jax_sg0.mdl"), p("port_sum_of_jax.acc"),
                     p("jax_sg0.acc"), p("jax_sg0.acc")) == 0
    _accs_close(p("port_sum_of_jax.acc"), p("jax_sum_of_port.acc"), model)
    both("sgmm2-est", "--update-flags=vwc", p("jax_sg0.mdl"), p("jax_sg0.acc"),
         p("{out}_sg1.mdl"))
    _models_close(p("port_sg1.mdl"), p("jax_sg1.mdl"))
    both("sgmm2-acc-stats-ali", p("jax_sg1.mdl"), s["feats_r"], s["ali"], p("{out}_sg1.acc"))
    _accs_close(p("port_sg1.acc"), p("jax_sg1.acc"),
                Sgmm2Model.load(p("jax_sg1.mdl"), device="cpu").sgmm)
    both("sgmm2-est", "--update-flags=MS", "--split-substates=140",
         "--min-gaussian-occupancy=3", p("jax_sg1.mdl"), p("jax_sg1.acc"), p("{out}_sg2.mdl"))
    _models_close(p("port_sg2.mdl"), p("jax_sg2.mdl"))
    assert Sgmm2Model.load(p("port_sg2.mdl"), device="cpu").sgmm.num_substates == 140


def test_sgmm2_speaker_vectors_and_adapted_statistics(s):
    """sgmm2-est-spkvecs on the symmetric model, then the statistics with
    those vectors (every speaker term) and the v, w, c, N and u updates (a
    fresh model's substates all share one mean until v moves: its decode
    keeps every state within the lattice beam)."""
    p = s["p"]
    both("sgmm2-est-spkvecs", f"--utt2spk={s['utt2spk']}", "--min-count=5",
         p("jax_sgs0.mdl"), s["feats_r"], s["ali"], f"ark:{p('{out}_vs.ark')}")
    j, t = (read_table(f"ark:{p(w + '_vs.ark')}", "vec") for w in ("jax", "port"))
    assert list(j) == list(t) == ["spkA", "spkB"]
    assert rel(np.stack(list(t.values())), np.stack(list(j.values()))) <= MODEL_RTOL
    both("sgmm2-acc-stats-ali", f"--spk-vecs=ark:{p('jax_vs.ark')}",
         f"--utt2spk={s['utt2spk']}", p("jax_sgs0.mdl"), s["feats_r"], s["ali"],
         p("{out}_sgs0.acc"))
    _accs_close(p("port_sgs0.acc"), p("jax_sgs0.acc"),
                Sgmm2Model.load(p("jax_sgs0.mdl"), device="cpu").sgmm)
    both("sgmm2-est", "--update-flags=vwcNu", p("jax_sgs0.mdl"), p("jax_sgs0.acc"),
         p("{out}_sgs1.mdl"))
    _models_close(p("port_sgs1.mdl"), p("jax_sgs1.mdl"))


def test_sgmm2_est_fmllr(s):
    p = s["p"]
    both("sgmm2-est-fmllr", f"--utt2spk={s['utt2spk']}", "--num-iters=4", p("jax_sg1.mdl"),
         s["feats_r"], s["ali"], f"ark:{p('{out}_fmllr.ark')}")
    j, t = (read_table(f"ark:{p(w + '_fmllr.ark')}", "mat") for w in ("jax", "port"))
    assert list(j) == list(t) == ["spkA", "spkB"]
    for k in j:
        assert t[k].shape == (13 * 3, 13 * 3 + 1) or t[k].shape == j[k].shape
        assert rel(t[k], j[k]) <= MODEL_RTOL
        assert not np.allclose(t[k][:, :-1], np.eye(t[k].shape[0]))


def test_sgmm2_align_compiled(s):
    """The JAX tool's alignments, and the port's library align_batch on the
    same loglikes."""
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    p = s["p"]
    both("sgmm2-align-compiled", p("jax_sg1.mdl"), s["graphs"], s["feats_r"],
         f"ark:{p('{out}_sgali.ark')}")
    assert read_bytes(p("port_sgali.ark")) == read_bytes(p("jax_sgali.ark"))
    model = Sgmm2Model.load(p("jax_sg1.mdl"), device="cpu")
    graphs = read_table(s["graphs"], "fst")
    keys, padded, nf = pad_feature_batch(s["feats"])
    csr = [fst_to_csr_native(NativeFst.from_arrays(*graphs[k].to_arrays()),
                             model.tm.tid_to_pdf_array()) for k in keys]
    alis, _ = align_batch(csr, model.sgmm.loglikes_batch(padded, num_frames=nf), nf,
                          ViterbiOptions(beam=200.0, acoustic_scale=1.0), device="cpu")
    got = read_table(f"ark:{p('port_sgali.ark')}", "ivec")
    assert all((np.asarray(got[k]) == a).all() for k, a in zip(keys, alis))


def test_sgmm2_latgen_faster(s):
    """Words equal and lattices arc for arc, plain and with speaker vectors,
    at --acoustic-scale=1.0 (at 0.1 the JAX decode breaks its backtraces:
    ROADMAP queue 3)."""
    p = s["p"]
    syms = f"--word-symbol-table={p('lang', 'words.txt')}"
    both("sgmm2-latgen-faster", "--max-active=500", "--acoustic-scale=1.0", syms, p("jax_sg2.mdl"), s["hclg_mono"],
         s["feats_r"], f"ark:{p('{out}_sglat.ark')}", f"ark,t:{p('{out}_sgw.txt')}")
    assert read_bytes(p("port_sgw.txt")) == read_bytes(p("jax_sgw.txt"))
    j, t = (read_table(f"ark:{p(w + '_sglat.ark')}", "lat") for w in ("jax", "port"))
    assert list(j) == list(t) == s["keys"]
    for k in j:
        lattices_equal(t[k], j[k])
    both("sgmm2-latgen-faster", "--max-active=500", "--acoustic-scale=1.0",
         f"--spk-vecs=ark:{p('jax_vs.ark')}",
         f"--utt2spk={s['utt2spk']}", p("jax_sgs1.mdl"), s["hclg_mono"], s["feats_r"],
         f"ark:{p('{out}_sgslat.ark')}", f"ark,t:{p('{out}_sgsw.txt')}")
    assert read_bytes(p("port_sgsw.txt")) == read_bytes(p("jax_sgsw.txt"))
    j, t = (read_table(f"ark:{p(w + '_sgslat.ark')}", "lat") for w in ("jax", "port"))
    assert list(j) == list(t) == s["keys"]
    for k in j:
        lattices_equal(t[k], j[k])


# ---------------------------------------------------------------------------
# keyword search
# ---------------------------------------------------------------------------

def _lattices(pkg):
    """The JAX test's two-path lattice (p_top) and its epsilon lattice, in
    the package `pkg` ("jax" or "port")."""
    if pkg == "jax":
        from old_kaldi_git_tpu.lat.lattice import Lattice, LatticeArc
    else:
        from old_kaldi_git_tpu_torch.lat.lattice import Lattice, LatticeArc

    def two_path(p_top):
        lat = Lattice()
        s0, s1, s2, s3 = (lat.add_state(t) for t in (0, 1, 1, 2))
        lat.start = s0
        lat.arcs[s0].append(LatticeArc(1, 10, 0.0, -math.log(p_top), s1))
        lat.arcs[s0].append(LatticeArc(1, 30, 0.0, -math.log(1 - p_top), s2))
        lat.arcs[s1].append(LatticeArc(1, 20, 0.0, 0.0, s3))
        lat.arcs[s2].append(LatticeArc(1, 20, 0.0, 0.0, s3))
        lat.finals[s3] = (0.0, 0.0)
        return lat

    def with_eps():
        lat = Lattice()
        s0, s1, s2, s3 = (lat.add_state(t) for t in (0, 1, 2, 3))
        lat.start = s0
        lat.arcs[s0].append(LatticeArc(1, 10, 0.0, 0.0, s1))
        lat.arcs[s1].append(LatticeArc(1, 0, 0.0, 0.0, s2))
        lat.arcs[s2].append(LatticeArc(1, 20, 0.0, 0.0, s3))
        lat.finals[s3] = (0.0, 0.0)
        return lat

    return {"u1": two_path(0.7), "u2": two_path(0.6), "u3": with_eps()}


def test_kws_library_against_the_jax_package(tmp_path):
    """build_kws_index / merge / save (the pickle byte for byte both ways),
    search_index, search_phrase (through an epsilon, absent phrases) and
    compute_atwv on the JAX test's cases."""
    import old_kaldi_git_tpu.kws.atwv as ja
    import old_kaldi_git_tpu.kws.search as js
    import old_kaldi_git_tpu_torch.kws.atwv as pa
    import old_kaldi_git_tpu_torch.kws.search as ps

    jl, pl = _lattices("jax"), _lattices("port")
    for ac in (1.0, 0.1):
        ji = js.build_kws_index(jl, lm_scale=1.0, ac_scale=ac)
        pi = ps.build_kws_index(pl, lm_scale=1.0, ac_scale=ac)
        js.save_index(ji, str(tmp_path / "j.idx"))
        ps.save_index(pi, str(tmp_path / "p.idx"))
        assert (tmp_path / "j.idx").read_bytes() == (tmp_path / "p.idx").read_bytes()
        back = ps.load_index(str(tmp_path / "j.idx"))
        ps.save_index(back, str(tmp_path / "pp.idx"))
        assert (tmp_path / "pp.idx").read_bytes() == (tmp_path / "j.idx").read_bytes()
        jm = js.merge_indexes([ji, js.load_index(str(tmp_path / "p.idx"))])
        pm = ps.merge_indexes([pi, back])
        js.save_index(jm, str(tmp_path / "jm.idx"))
        ps.save_index(pm, str(tmp_path / "pm.idx"))
        assert (tmp_path / "jm.idx").read_bytes() == (tmp_path / "pm.idx").read_bytes()
        for w in (10, 20, 30, 99):
            assert ([tuple(vars(h).values()) for h in ps.search_index(pi, w)]
                    == [tuple(vars(h).values()) for h in js.search_index(ji, w)])
        for kw in ([10, 20], [30, 20], [20, 10], [10], [99]):
            for u in jl:
                assert (ps.search_phrase(pl[u], kw, 1.0, ac)
                        == js.search_phrase(jl[u], kw, 1.0, ac)), (kw, u)
    (tb, te, lp), = ps.search_phrase(pl["u3"], [10, 20], 1.0, 1.0)
    assert (tb, te) == (0, 3) and math.exp(lp) == pytest.approx(1.0, rel=1e-6)
    refs = [("kw1", "u1", 0.0, 0.5), ("kw1", "u2", 1.0, 1.5), ("kw2", "u1", 2.0, 2.5)]
    hyps = [(k, u, b, e, 1.0) for k, u, b, e in refs] + [("kw2", "u2", 9.0, 9.5, 0.9),
                                                        ("kw1", "u1", 0.3, 0.8, 0.5)]
    for r, h in ((refs, hyps), (refs, []), (refs[:1], hyps[-1:])):
        assert pa.compute_atwv(3600.0, r, h) == ja.compute_atwv(3600.0, r, h)


def test_kws_tools(tmp_path, capsys):
    """lattice-to-kws-index, kws-index-union (each package's index read by
    the other), kws-search with and without --index and with
    --frame-shift, compute-atwv: files and output equal."""
    from old_kaldi_git_tpu.utils.table import TableWriter

    p = lambda name: str(tmp_path / name)  # noqa: E731
    with TableWriter(f"ark:{p('lat.ark')}", "lat") as w:
        for k, lat in _lattices("jax").items():
            w[k] = lat
    with open(p("keywords.txt"), "w") as f:
        f.write("KW-A 10\nKW-B 20\nKW-PHRASE 10 20\nKW-NONE 99\n")
    both("lattice-to-kws-index", "--acoustic-scale=1.0", f"ark:{p('lat.ark')}",
         p("{out}.idx"))
    assert read_bytes(p("port.idx")) == read_bytes(p("jax.idx"))
    assert jax_tool("kws-index-union", p("port.idx"), p("jax.idx"), p("jax_u.idx")) == 0
    assert port_tool("kws-index-union", p("jax.idx"), p("port.idx"), p("port_u.idx")) == 0
    assert read_bytes(p("port_u.idx")) == read_bytes(p("jax_u.idx"))
    for extra, tag in (([f"--index={p('jax.idx')}"], "i"), ([], "n"),
                       ([f"--index={p('port.idx')}", "--frame-shift=0.01"], "f")):
        both("kws-search", "--acoustic-scale=1.0", *extra, f"ark:{p('lat.ark')}",
             p("keywords.txt"), p("{out}_res_" + tag))
        assert read_bytes(p("port_res_" + tag)) == read_bytes(p("jax_res_" + tag)), tag
    lines = [ln.split() for ln in open(p("port_res_i"))]
    assert "KW-NONE" not in {ln[0] for ln in lines}
    (score,) = [float(ln[4]) for ln in lines if ln[0] == "KW-A" and ln[1] == "u1"]
    assert score == pytest.approx(0.7, abs=2e-6)  # the archive's float32 costs
    with open(p("ref.txt"), "w") as f:
        f.write("KW-A u1 0 1\nKW-PHRASE u1 0 2\nKW-B u3 2 3\n")
    outs = [run(capsys, fn, "compute-atwv", "3600", p("ref.txt"), p("jax_res_i"))
            for fn in (jax_tool, port_tool)]
    assert outs[0] == outs[1] and outs[0][1].startswith("ATWV = ")
    assert port_tool("kws-search", p("lat.ark")) == 1


def test_every_new_tool_is_held_here_or_beside(s):
    """The 43 tools of this slice each run in one of the two new CLI test
    files (the speaker-ID ones in tests/test_torch_cli_spkid.py)."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    here = open(os.path.join(root, "test_torch_cli_sgmm2_kws.py")).read()
    spkid = open(os.path.join(root, "test_torch_cli_spkid.py")).read()
    jax_bin = os.path.join(os.path.dirname(root), "old_kaldi_git_tpu", "bin")
    for f, text in (("spkid_tools.py", spkid), ("sgmm2_tools.py", here),
                    ("kws_tools.py", here)):
        names = re.findall(r'@tool\("([^"]+)"\)', open(os.path.join(jax_bin, f)).read())
        for n in names:
            assert f'"{n}"' in text, n
