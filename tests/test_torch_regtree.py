"""Regression-tree MLLR / fMLLR (transform/regtree.py) and its tools against
the JAX package's, on the CPU.

The module cases mirror tests/test_transforms.py on the same seeded
two-group toy models, each package on its own statistics: the tree file
byte for byte, the per-baseclass statistics within 1e-9 of each array's
largest magnitude, the fMLLR transforms and loglikes (float64 on the
model's device here) within 1e-9, the MLLR transforms and adapted means
equal on the JAX package's statistics and within 1e-5 on the port's (the
toy's rank-3 mean scatters make the row solves ill-conditioned),
per-class adaptation above global above none, the files both ways.  The
tools with mono.mdl on the shared system's 4 utterances as two speakers
(tests/torch_cli_system.py, mono_train_system: mono.mdl's best paths as
posteriors): gmm-make-regtree byte for byte, the regx archives' baseclass
maps equal and float32 transforms within 1e-5·max|ref|, and the two
decoders' words and alignments equal to the JAX tools' at
--acoustic-scale=1.0 (the JAX tools score in float64, the port through the
GMM kernel's plain version in float32; ROADMAP's parity rule for GMM
decodes) and to the port's library on the same transforms."""

import tests.torch_threads  # noqa: F401
import io

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.transform.regtree as jrt
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
from old_kaldi_git_tpu_torch.transform import regtree as trt
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import both, mono_train_system, read_bytes

REL = 1e-9
# a class's MLLR rows solve G_i + 1e-6·I, G_i the scatter of 3 extended
# means (rank 3 of 5): ulps of the statistics grow to 1e-6 in the solve
MLLR_REL = 1e-5


def _two_group(rng, dim=4, per_group=3):
    params = []
    for center in (5.0, -5.0):
        for _ in range(per_group):
            params.append((np.ones(1), center + rng.normal(size=(1, dim)),
                           0.5 + rng.random((1, dim))))
    return (jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in params]),
            AmDiagGmm([DiagGmm(*a) for a in params], device="cpu"))


def _grouped_speaker(rng, am, frames_per_pdf):
    feats, pdfs, group = [], [], []
    for pdf in range(am.num_pdfs):
        g = am.pdfs[pdf]
        feats.append(g.means[0] + np.sqrt(g.vars[0]) * rng.normal(size=(frames_per_pdf, am.dim)))
        pdfs.append(np.full(frames_per_pdf, pdf))
        group.append(np.full(frames_per_pdf, pdf // (am.num_pdfs // 2)))
    return np.concatenate(feats), np.concatenate(pdfs), np.concatenate(group)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _trees(jam, tam, **kw):
    jt = jrt.RegressionTree.build(jam, **kw)
    tt = trt.RegressionTree.build(tam, **kw)
    jb, tb = io.BytesIO(), io.BytesIO()
    jt.write(jb)
    tt.write(tb)
    assert jb.getvalue() == tb.getvalue()
    return jt, tt


def test_tree_build_and_files_are_the_jax_packages():
    jam, tam = _two_group(np.random.default_rng(0))
    jt, tt = _trees(jam, tam, num_baseclasses=2, seed=1)
    assert tt.num_baseclasses == 2 and tt.num_nodes == 3 and tt.parents[tt.root] == tt.root
    leaf = [tt.gauss2bclass[p][0] for p in range(6)]
    assert len(set(leaf[:3])) == len(set(leaf[3:])) == 1 and leaf[0] != leaf[3]
    buf = io.BytesIO()
    jt.write(buf)
    back = trt.RegressionTree.read(io.BufferedReader(io.BytesIO(buf.getvalue())))
    np.testing.assert_array_equal(back.parents, jt.parents)
    xf = trt.RegtreeTransform("fmllr", np.random.default_rng(0).normal(size=(2, 3, 4)),
                              [0, 1, 1, 0])
    jxf = jrt.RegtreeTransform("fmllr", xf.xforms, [0, 1, 1, 0])
    a, b = io.BytesIO(), io.BytesIO()
    xf.write(a)
    jxf.write(b)
    assert a.getvalue() == b.getvalue()
    back = trt.RegtreeTransform.read(io.BufferedReader(io.BytesIO(b.getvalue())))
    assert back.kind == "fmllr" and np.allclose(back.logdets, jxf.logdets, atol=1e-5)
    # a bigger model: 12 pdfs of 3 Gaussians into 5 baseclasses
    rng = np.random.default_rng(9)
    params = [(rng.random(3) + 0.1, rng.normal(size=(3, 4)) * 3, 0.5 + rng.random((3, 4)))
              for _ in range(12)]
    _trees(jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in params]),
           AmDiagGmm([DiagGmm(*a) for a in params], device="cpu"), num_baseclasses=5, seed=3)


def test_mllr_per_class_beats_global_as_the_jax_package():
    rng = np.random.default_rng(3)
    jam, tam = _two_group(rng)
    jt, tt = _trees(jam, tam, num_baseclasses=2, seed=1)
    x, pdfs, grp = _grouped_speaker(rng, jam, 200)
    x = x + np.where(grp[:, None] == 0, 1.5, -2.0)
    ja = jrt.RegtreeMllrAccs(4, 2)
    ja.accumulate(jam, jt, x, pdfs)
    ta = trt.RegtreeMllrAccs(4, 2, "cpu")
    ta.accumulate(tam, tt, x, pdfs)
    for name in ("K", "G", "beta"):
        assert _rel(getattr(ta, name).numpy(), getattr(ja, name)) <= REL, name

    def like(am):
        return sum(am.pdfs[p].loglikes(x[pdfs == p]).sum() for p in range(6))

    on_jax = trt.RegtreeMllrAccs(4, 2, "cpu")
    for name in ("K", "G", "beta"):
        setattr(on_jax, name, torch.from_numpy(getattr(ja, name).copy()))
    likes = []
    for min_count, n in ((50.0, 2), (1000.0, 1), (1e9, 1)):
        jx = jrt.estimate_regtree_mllr(ja, jt, min_count)
        tx = trt.estimate_regtree_mllr(ta, tt, min_count)
        assert tx.num_xforms == jx.num_xforms == n
        np.testing.assert_array_equal(tx.bclass2xform, jx.bclass2xform)
        np.testing.assert_array_equal(trt.estimate_regtree_mllr(on_jax, tt, min_count).xforms,
                                      jx.xforms)
        assert _rel(tx.xforms, jx.xforms) <= MLLR_REL
        jm, tm = jrt.apply_mllr_to_model(jam, jt, jx), trt.apply_mllr_to_model(tam, tt, tx)
        for a, b in zip(tm.pdfs, jm.pdfs):
            assert _rel(a.means, b.means) <= MLLR_REL
        likes.append(like(jm))
    assert likes[0] > likes[1] > like(jam) and likes[2] == pytest.approx(like(jam))


def test_fmllr_per_class_and_its_loglikes_as_the_jax_package():
    rng = np.random.default_rng(4)
    jam, tam = _two_group(rng)
    jt, tt = _trees(jam, tam, num_baseclasses=2, seed=1)
    x, pdfs, grp = _grouped_speaker(rng, jam, 250)
    dists = [np.eye(4) + 0.25 * rng.normal(size=(4, 4)) / 2.0 for _ in range(2)]
    y = x.copy()
    for g in range(2):
        sel = grp == g
        y[sel] = x[sel] @ dists[g].T + (0.5 if g else -0.5)
    ja = jrt.RegtreeFmllrAccs(4, 2)
    ja.accumulate(jam, jt, y, pdfs)
    ta = trt.RegtreeFmllrAccs(4, 2, "cpu")
    ta.accumulate(tam, tt, y, pdfs)
    for a, b in zip(ta.accs, ja.accs):
        assert _rel(a.K.numpy(), b.K) <= REL and _rel(a.G.numpy(), b.G) <= REL
    totals = []
    for min_count, n in ((50.0, 2), (1200.0, 1)):
        jx = jrt.estimate_regtree_fmllr(ja, jt, min_count)
        tx = trt.estimate_regtree_fmllr(ta, tt, min_count)
        assert tx.num_xforms == jx.num_xforms == n and _rel(tx.xforms, jx.xforms) <= REL
        jl = jrt.regtree_fmllr_loglikes(jam, jt, jx, y)
        tl = trt.regtree_fmllr_loglikes(tam, tt, tx, y)
        assert tl.dtype == torch.float64 and _rel(tl.numpy(), jl) <= REL
        totals.append(tl.numpy()[np.arange(len(pdfs)), pdfs].sum())
    base = jam.loglikes_numpy(y)[np.arange(len(pdfs)), pdfs].sum()
    assert totals[0] > totals[1] > base


@pytest.fixture(scope="module")
def s():
    return mono_train_system()


def test_regtree_tools_and_decoders(s):
    from old_kaldi_git_tpu_torch.decoder.graph import read_hclg_csr
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, decode_batch
    from old_kaldi_git_tpu_torch.bin.train_tools import regtree_loglikes
    from old_kaldi_git_tpu_torch.utils.data_dir import _read_map

    p = s["p"]
    both("gmm-make-regtree", "--max-leaves=8", s["mono"], p("{out}.regtree"))
    assert read_bytes(p("jax.regtree")) == read_bytes(p("port.regtree"))
    model = AmGmmModel.load(s["mono"], device="cpu")
    tree = trt.RegressionTree.load(p("port.regtree"))
    feats = {k: np.asarray(v) for k, v in s["feats"].items()}
    for kind in ("mllr", "fmllr"):
        both(f"gmm-est-regtree-{kind}", f"--spk2utt={s['spk2utt']}", "--min-count=200",
             s["mono"], p("port.regtree"), s["feats_r"], s["mono_post"],
             f"ark:{p('{out}_' + kind + '.regx')}")
        j = read_table(f"ark:{p('jax_' + kind + '.regx')}", "regx")
        t = read_table(f"ark:{p('port_' + kind + '.regx')}", "regx")
        assert sorted(j) == sorted(t) == ["spkA", "spkB"]
        for k in j:
            assert t[k].kind == kind and t[k].num_xforms > 1
            np.testing.assert_array_equal(t[k].bclass2xform, j[k].bclass2xform)
            assert _rel(t[k].xforms, j[k].xforms) <= 1e-5
        both(f"gmm-decode-faster-regtree-{kind}", "--acoustic-scale=1.0", "--max-active=500",
             f"--utt2spk={s['utt2spk']}", s["mono"], p("port.regtree"), s["hclg_mono"],
             s["feats_r"], f"ark:{p('jax_' + kind + '.regx')}",
             f"ark,t:{p('{out}_' + kind + '_w.txt')}", f"ark:{p('{out}_' + kind + '_ali.ark')}")
        words = read_table(f"ark:{p('port_' + kind + '_w.txt')}", "text")
        assert words == read_table(f"ark:{p('jax_' + kind + '_w.txt')}", "text")
        assert len(words) == 4
        assert (read_bytes(p("jax_" + kind + "_ali.ark"))
                == read_bytes(p("port_" + kind + "_ali.ark")))
        keys, ll, nf = regtree_loglikes(
            model, tree, read_table(f"ark:{p('jax_' + kind + '.regx')}", "regx"),
            _read_map(s["utt2spk"]), feats, kind, torch.device("cpu"))
        lib = decode_batch(read_hclg_csr(s["hclg_mono"], model.tm.tid_to_pdf_array()), ll, nf,
                           ViterbiOptions(max_active=500, acoustic_scale=1.0), device="cpu")
        assert words == {k: " ".join(str(w) for w in r.words) for k, r in zip(keys, lib)}
