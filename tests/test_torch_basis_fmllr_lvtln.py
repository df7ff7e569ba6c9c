"""Basis fMLLR and linear VTLN (transform/basis_fmllr.py, transform/lvtln.py)
and their tools against the JAX package's, on the CPU.

The module cases mirror tests/test_transforms.py (basis fMLLR from 45
frames where full fMLLR refuses, near full fMLLR with ample data, LVTLN
picking the class of the speaker's distortion, the files) on the same
seeded toy models, each package on its own statistics: bases, transforms
and LVTLN classes within 1e-9 of the JAX package's (on the JAX package's
statistics, the port's host solves give its numbers to the bit), files byte
for byte both ways.  The tools on tri.mdl's equal alignments of the shared
system's 4 utterances as two speakers (tests/torch_cli_system.py), basis
fMLLR in its 13-dimensional LDA space (lda_system: a scatter of 182² where
the raw features' is 1,560²): the float32 basis (2 bases: two speakers'
gradients span two directions, the rest of the eigenvectors are a
degenerate null space) within 1e-6·max|ref|,
the transforms within 1e-5·max|ref|, LVTLN files within 1e-6 and the warp
factors equal."""

import tests.torch_threads  # noqa: F401
import io

import numpy as np
import pytest

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.transform.basis_fmllr as jbasis
import old_kaldi_git_tpu.transform.fmllr as jfmllr
import old_kaldi_git_tpu.transform.lvtln as jlvtln
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmDiagGmm, DiagGmm
from old_kaldi_git_tpu_torch.transform import basis_fmllr as tbasis
from old_kaldi_git_tpu_torch.transform import lvtln as tlvtln
from old_kaldi_git_tpu_torch.transform.fmllr import FmllrAccs, compute_fmllr_transform
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import both, lda_system, read_bytes

REL = 1e-9


def _toy(rng, num_pdfs=3, dim=4):
    """(JAX AmDiagGmm, the port's on the CPU) of the same single Gaussians."""
    params = [(np.ones(1), rng.normal(size=(1, dim)) * 2, 0.5 + rng.random((1, dim)))
              for _ in range(num_pdfs)]
    return (jgmm.AmDiagGmm([jgmm.DiagGmm(*a) for a in params]),
            AmDiagGmm([DiagGmm(*a) for a in params], device="cpu"))


def _speaker_data(rng, am, frames_per_pdf):
    feats, pdfs = [], []
    for pdf in range(am.num_pdfs):
        g = am.pdfs[pdf]
        feats.append(g.means[0] + np.sqrt(g.vars[0]) * rng.normal(size=(frames_per_pdf, am.dim)))
        pdfs.append(np.full(frames_per_pdf, pdf))
    return np.concatenate(feats), np.concatenate(pdfs)


def _affine_corrupt(rng, clean, scale_spread=0.15, shift_spread=0.5):
    d = clean.shape[1]
    a = np.eye(d) + scale_spread * rng.normal(size=(d, d)) / np.sqrt(d)
    return clean @ a.T + shift_spread * rng.normal(size=d)


def _accs(jam, tam, x, pdfs):
    j = jfmllr.FmllrAccs(x.shape[1])
    j.accumulate(jam, x, pdfs)
    t = FmllrAccs(x.shape[1], "cpu")
    t.accumulate(tam, x, pdfs)
    return j, t


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _training_speakers(seed, n, frames):
    rng = np.random.default_rng(seed)
    jam, tam = _toy(rng)
    pairs = []
    for _ in range(n):
        clean, pdfs = _speaker_data(rng, jam, frames)
        pairs.append(_accs(jam, tam, _affine_corrupt(rng, clean), pdfs))
    return rng, jam, tam, pairs


def test_basis_from_tiny_data_beats_refusal_as_the_jax_package():
    rng, jam, tam, pairs = _training_speakers(7, 12, 200)
    jb = jbasis.estimate_fmllr_basis([j for j, _ in pairs])
    tb = tbasis.estimate_fmllr_basis([t for _, t in pairs])
    assert tb.mats.shape == jb.mats.shape and tb.num_bases >= 10
    np.testing.assert_array_equal(tbasis.estimate_fmllr_basis([j for j, _ in pairs]).mats,
                                  jb.mats)
    clean, pdfs = _speaker_data(rng, jam, 15)
    corrupted = _affine_corrupt(rng, clean)
    j, t = _accs(jam, tam, corrupted, pdfs)
    assert compute_fmllr_transform(t, min_count=500.0) is None
    jw, jn, ji = jbasis.compute_fmllr_basis_transform(j, jb)
    tw, tn, ti = tbasis.compute_fmllr_basis_transform(t, tb)
    assert tn == jn and 1 <= tn <= tb.num_bases and ti > 0.01
    assert _rel(tw, jw) <= REL and abs(ti - ji) <= REL * abs(ji)
    w2, _, _ = tbasis.compute_fmllr_basis_transform(j, jb)
    np.testing.assert_array_equal(w2, jw)
    restored = jfmllr.apply_affine_transform(corrupted, tw)
    like = lambda y: sum(jam.pdfs[p].loglikes(y[pdfs == p]).sum() for p in range(3))  # noqa
    assert like(restored) > like(corrupted)
    assert tbasis.compute_fmllr_basis_transform(t, tb, min_count=1e4) is None


def test_basis_with_ample_data_approaches_full_fmllr_as_the_jax_package():
    rng, jam, tam, pairs = _training_speakers(11, 10, 250)
    tb = tbasis.estimate_fmllr_basis([t for _, t in pairs])
    clean, pdfs = _speaker_data(rng, jam, 400)
    j, t = _accs(jam, tam, _affine_corrupt(rng, clean), pdfs)
    stats = tbasis.HostStats.of(t)
    w_full = compute_fmllr_transform(t, min_count=10.0)
    full_gain = tbasis.aux_objf(w_full, stats) - tbasis.aux_objf(tbasis.identity_w(4), stats)
    w_b, n, impr = tbasis.compute_fmllr_basis_transform(t, tb, num_iters=20)
    assert impr * t.beta > 0.6 * full_gain
    jw, jn, _ = jbasis.compute_fmllr_basis_transform(
        j, jbasis.estimate_fmllr_basis([jj for jj, _ in pairs]), num_iters=20)
    assert n == jn and _rel(w_b, jw) <= REL


def test_basis_file_is_the_jax_packages_both_ways():
    mats = np.random.default_rng(1).normal(size=(6, 4, 5))
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jbasis.BasisFmllr(mats).write(jbuf)
    tbasis.BasisFmllr(mats).write(tbuf)
    assert jbuf.getvalue() == tbuf.getvalue()
    back = tbasis.BasisFmllr.read(io.BufferedReader(io.BytesIO(jbuf.getvalue())))
    np.testing.assert_allclose(back.mats, mats, atol=1e-6)
    assert back.num_bases == 6 and back.dim == 4


def test_lvtln_selects_the_speakers_class_as_the_jax_package():
    rng = np.random.default_rng(5)
    dim = 4
    jam, tam = _toy(rng, dim=dim)
    warps = [0.9, 1.0, 1.1]
    dists = [np.eye(dim) + 0.2 * rng.normal(size=(dim, dim)) / np.sqrt(dim) for _ in range(3)]
    dists[1] = np.eye(dim)
    jl, tl = jlvtln.LinearVtln.init(dim, warps), tlvtln.LinearVtln.init(dim, warps)
    clean, _ = _speaker_data(rng, jam, 400)
    for c, d in enumerate(dists):
        jl.set_transform(c, jlvtln.train_lvtln_class([(clean @ d.T, clean)]))
        tl.set_transform(c, tlvtln.train_lvtln_class([(clean @ d.T, clean)], "cpu"))
    assert _rel(tl.mats, jl.mats) <= REL
    np.testing.assert_allclose(tl.mats[0] @ dists[0], np.eye(dim), atol=1e-4)
    x, pdfs = _speaker_data(rng, jam, 80)
    for feats, want in ((x @ dists[2].T, 2), (x, 1)):
        j, t = _accs(jam, tam, feats, pdfs)
        jw, jwarp, jc, ji = jlvtln.select_lvtln_transform(j, jl)
        tw, twarp, tc, ti = tlvtln.select_lvtln_transform(t, tl)
        assert (tc, twarp) == (jc, jwarp) == (want, warps[want])
        assert _rel(tw, jw) <= REL and abs(ti - ji) <= REL * max(abs(ji), 1e-3)
    assert tlvtln.select_lvtln_transform(t, tl, min_count=1e6) is None
    buf = io.BytesIO()
    tl.write(buf)
    jbuf = io.BytesIO()
    jl.write(jbuf)
    back = tlvtln.LinearVtln.read(io.BufferedReader(io.BytesIO(jbuf.getvalue())))
    assert back.warps == pytest.approx(warps) and _rel(back.mats, jl.mats) <= 1e-6
    jback = jlvtln.LinearVtln.read(io.BufferedReader(io.BytesIO(buf.getvalue())))
    assert _rel(jback.mats, tl.mats) <= 1e-6


@pytest.fixture(scope="module")
def s():
    return lda_system()


def test_basis_fmllr_tools(s):
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    p = s["p"]
    spk = f"--spk2utt={s['spk2utt']}"
    both("gmm-basis-fmllr-training", spk, "--num-bases=2", s["lda_mdl"], s["lda_feats"],
         s["wpost"], p("{out}.basis"))
    jb = tbasis.BasisFmllr.load(p("jax.basis"))
    tb = tbasis.BasisFmllr.load(p("port.basis"))
    assert tb.mats.shape == jb.mats.shape == (2, 13, 14) and _rel(tb.mats, jb.mats) <= 1e-6
    both("gmm-est-basis-fmllr", spk, "--fmllr-min-count=100", s["lda_mdl"], p("jax.basis"),
         s["lda_feats"], s["wpost"], f"ark:{p('{out}_bx.ark')}")
    j = read_table(f"ark:{p('jax_bx.ark')}", "mat")
    t = read_table(f"ark:{p('port_bx.ark')}", "mat")
    assert sorted(j) == sorted(t) == ["spkA", "spkB"]
    for k in j:
        assert _rel(t[k], j[k]) <= 1e-5
    with TableWriter(f"ark:{p('b_none.ark')}", "post") as w:
        w["nobody"] = [[(1, 1.0)]]
    both("gmm-basis-fmllr-training", s["lda_mdl"], s["lda_feats"], f"ark:{p('b_none.ark')}",
         p("{out}_none.basis"), rc=1)


def test_lvtln_tools(s):
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    p = s["p"]
    both("gmm-init-lvtln", "--dim=39", "--num-classes=3", "--min-warp=0.9", "--max-warp=1.1",
         p("{out}_0.lvtln"))
    assert read_bytes(p("jax_0.lvtln")) == read_bytes(p("port_0.lvtln"))
    rng = np.random.default_rng(3)
    d = np.eye(39) + 0.05 * rng.normal(size=(39, 39))
    with TableWriter(f"ark:{p('b_warped.ark')}", "mat") as w:
        for k in s["keys"]:
            w[k] = (s["feats"][k] @ d.T).astype(np.float32)
    both("gmm-train-lvtln-special", "0", p("jax_0.lvtln"), p("{out}_1.lvtln"), s["feats_r"],
         f"ark:{p('b_warped.ark')}")
    jl, tl = (tlvtln.LinearVtln.load(p(n + "_1.lvtln")) for n in ("jax", "port"))
    assert _rel(tl.mats, jl.mats) <= 1e-6 and not np.allclose(tl.mats[0], np.eye(39))
    both("gmm-est-lvtln-trans", f"--spk2utt={s['spk2utt']}", s["tri"], p("jax_1.lvtln"),
         s["feats_r"], s["wpost"], f"ark:{p('{out}_lx.ark')}", f"ark,t:{p('{out}_warp.txt')}")
    assert read_bytes(p("jax_warp.txt")) == read_bytes(p("port_warp.txt"))
    j = read_table(f"ark:{p('jax_lx.ark')}", "mat")
    t = read_table(f"ark:{p('port_lx.ark')}", "mat")
    assert sorted(j) == sorted(t) == ["spkA", "spkB"]
    for k in j:
        assert _rel(t[k], j[k]) <= 1e-5
