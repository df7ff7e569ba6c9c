"""The port's SGMM2 (gmm/sgmm2.py, gmm/sgmm2_fmllr.py, recipes/sgmm2.py)
against the JAX package's, on the CPU, at the sizes of the JAX package's
tests/test_sgmm2.py (D 4-8, I 8), from the same numpy inputs made from a
seed.

Loglikes (plain, speaker-adapted, symmetric) and every statistic within
1e-9 of the largest magnitude of the JAX array; each update flag, the
split and the speaker vector within 1e-9 (the M and N solves invert
Q + 1e-6·I: 1e-8 there); SGMM2 fMLLR's statistics within 1e-9 and its
transform within 1e-8; model and accumulator files read by the other
package; train_sgmm2 with fixed alignments in lockstep: the written
models' float32 fields within 1e-6 relative.  The occupancies a split
ranks are sums of posteriors, equal across the packages to rounding only:
the data give no two substates the same occupancy (weighted frames, or a
distinct odd number of frames a pdf), so that the greedy choice cannot
hinge on rounding."""

import tests.torch_threads  # noqa: F401

import copy

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.gmm.sgmm2 as J
import old_kaldi_git_tpu.gmm.sgmm2_fmllr as JF
from old_kaldi_git_tpu.gmm.full_gmm import FullGmm as JFullGmm
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.gmm import sgmm2 as P
from old_kaldi_git_tpu_torch.gmm import sgmm2_fmllr as PF

TOL = 1e-9


def rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if isinstance(want, list):
        want = np.concatenate(want)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _ubm(rng, I=8, D=5):
    covs = []
    for _ in range(I):
        a = rng.normal(size=(D, D)) * 0.2
        covs.append(np.eye(D) + a @ a.T)
    return JFullGmm(np.full(I, 1 / I), rng.normal(size=(I, D)) * 2, np.stack(covs))


def jax_model(seed, I=8, D=5, subs=(2, 1, 3, 1), spk=0, symmetric=False):
    rng = np.random.default_rng(seed)
    m = J.AmSgmm2.init(_ubm(rng, I, D), len(subs))
    m.v = [rng.normal(size=(k, m.phn_dim)) for k in subs]
    m.c = [rng.random(k) + 0.1 for k in subs]
    m.w = rng.normal(size=m.w.shape) * 0.5
    if spk:
        m.init_speaker_subspace(spk, symmetric=symmetric)
        m.N = m.N + rng.normal(size=m.N.shape) * 0.3
        if symmetric:
            m.u = rng.normal(size=m.u.shape) * 0.3
    m.invalidate()
    return m


def port(m, device="cpu"):
    return convert.sgmm2_from_jax(
        m.M, m.w, m.sigma_inv, m.v, m.c,
        None if m.ubm is None else (m.ubm.weights, m.ubm.means, m.ubm.covars), m.N, m.u,
        device=device)


def data(seed, m, T=240):
    rng = np.random.default_rng(seed + 100)
    return (rng.normal(size=(T, m.dim)) * 2, rng.integers(0, m.num_pdfs, size=T),
            0.5 + rng.random(T), rng.normal(size=m.spk_dim) if m.spk_dim else None)


@pytest.mark.parametrize("kind", ["plain", "speaker", "symmetric"])
def test_loglikes(kind):
    """[T, J] loglikes, and loglikes_batch on a padded batch (the padding's
    rows stay 0)."""
    m = jax_model(0, spk=0 if kind == "plain" else 2, symmetric=kind == "symmetric")
    p = port(m)
    x, _, _, vs = data(0, m, T=50)
    want = m.loglikes_numpy(x, spk_vec=vs)
    assert rel(p.loglikes(x, spk_vec=vs), want) <= TOL
    pad = np.zeros((2, 30, m.dim))
    pad[0], pad[1, :20] = x[:30], x[30:]
    got = p.loglikes_batch(pad, num_frames=[30, 20], spk_vecs=None if vs is None else [vs, vs])
    assert rel(got[0], want[:30]) <= TOL and rel(got[1, :20], want[30:]) <= TOL
    assert (got[1, 20:] == 0).all()


@pytest.mark.parametrize("kind", ["plain", "symmetric"])
def test_statistics(kind, monkeypatch):
    """Every accumulator of one call over weighted frames, and the sum of
    two calls; again in chunks of a few frames (the frames sorted by their
    pdf's substate count, each chunk padded to its own largest count)."""
    m = jax_model(1, spk=0 if kind == "plain" else 3, symmetric=kind == "symmetric")
    p = port(m)
    x, pdfs, w, vs = data(1, m)
    ja, pa, small = J.MleAmSgmm2Accs(m), P.MleAmSgmm2Accs(p), P.MleAmSgmm2Accs(p)
    for lo, hi in ((0, 100), (100, len(x))):
        ja.accumulate(m, x[lo:hi], pdfs[lo:hi], weights=w[lo:hi], spk_vec=vs)
        pa.accumulate(p, x[lo:hi], pdfs[lo:hi], weights=w[lo:hi], spk_vec=vs)
    monkeypatch.setattr(P, "POST_ELEMS", 7 * p.num_gauss)
    for lo, hi in ((0, 100), (100, len(x))):
        small.accumulate(p, x[lo:hi], pdfs[lo:hi], weights=w[lo:hi], spk_vec=vs)
    names = ("gamma", "y", "Y", "Q", "S") + (("Y_N", "Q_N", "a_u", "Q_u") if vs is not None
                                             else ())
    for name in names:
        assert rel(getattr(pa, name), getattr(ja, name)) <= TOL, name
        assert rel(getattr(small, name), getattr(ja, name)) <= TOL, name
    if vs is None:
        assert pa.Y_N is None and pa.a_u is None
    assert pa.total_like == pytest.approx(ja.total_like, rel=TOL)
    assert pa.total_frames == pytest.approx(ja.total_frames, rel=TOL)


def _stats_pair(seed, spk=2, symmetric=True, T=400):
    m = jax_model(seed, subs=(2, 2, 3, 1), spk=spk, symmetric=symmetric)
    p = port(m)
    x, pdfs, w, _ = data(seed, m, T=T)
    rng = np.random.default_rng(seed + 7)
    ja, pa = J.MleAmSgmm2Accs(m), P.MleAmSgmm2Accs(p)
    for s in range(4):  # four speakers
        sel = slice(s * T // 4, (s + 1) * T // 4)
        vs = rng.normal(size=spk)
        ja.accumulate(m, x[sel], pdfs[sel], weights=w[sel], spk_vec=vs)
        pa.accumulate(p, x[sel], pdfs[sel], weights=w[sel], spk_vec=vs)
    return m, p, ja, pa


@pytest.mark.parametrize("flags", ["vwc", "MS", "Nu"])
def test_each_update_flag(flags):
    m, p, ja, pa = _stats_pair(2)
    opts = dict(update_flags=flags, min_gaussian_occupancy=5.0, min_substate_occupancy=3.0)
    ja_avg = J.sgmm2_update(m, ja, J.Sgmm2UpdateOptions(**opts))
    pa_avg = P.sgmm2_update(p, pa, P.Sgmm2UpdateOptions(**opts))
    assert pa_avg == pytest.approx(ja_avg, rel=TOL)
    solved = {"M": 1e-8, "N": 1e-8}  # Y (Q + 1e-6 I)^-1
    for name, want in (("V", m.v), ("M", m.M), ("sigma_inv", m.sigma_inv), ("w", m.w),
                       ("C", m.c), ("N", m.N), ("u", m.u)):
        assert rel(getattr(p, name), want) <= solved.get(name, TOL), name
    # the updated model scores as the JAX package's
    x = data(2, m, T=20)[0]
    assert rel(p.loglikes(x), m.loglikes_numpy(x)) <= 1e-8


def test_split_substates():
    """The split to 14 substates from weighted statistics (no tied
    occupancies): the same substates, perturbations and weights."""
    m = jax_model(3, subs=(2, 1, 3, 1))
    p = port(m)
    x, pdfs, w, _ = data(3, m)
    ja, pa = J.MleAmSgmm2Accs(m), P.MleAmSgmm2Accs(p)
    ja.accumulate(m, x, pdfs, weights=w)
    pa.accumulate(p, x, pdfs, weights=w)
    J.split_substates(m, ja, 14)
    P.split_substates(p, pa, 14)
    assert p.counts.tolist() == [len(v) for v in m.v] and p.num_substates == 14
    assert rel(p.V, m.v) <= TOL and rel(p.C, m.c) <= TOL
    assert rel(p.loglikes(x[:20]), m.loglikes_numpy(x[:20])) <= TOL


@pytest.mark.parametrize("symmetric", [False, True])
def test_speaker_vector(symmetric):
    m = jax_model(4, spk=2, symmetric=symmetric)
    p = port(m)
    x, pdfs, w, _ = data(4, m)
    want = J.estimate_spk_vector(m, x, pdfs, weights=w, num_iters=3)
    got = P.estimate_spk_vector(p, x, pdfs, weights=w, num_iters=3)
    assert rel(got, want) <= TOL
    assert (P.estimate_spk_vector(p, x[:3], pdfs[:3], min_count=10.0) == 0).all()


def test_sgmm2_fmllr():
    """Statistics with a speaker vector on a symmetric model, and the
    transforms of three speakers estimated together (one under min_count)
    against the JAX package's one by one."""
    m = jax_model(5, D=4, subs=(1, 2, 1), spk=2, symmetric=True)
    rng = np.random.default_rng(55)
    m.v = [2.0 * rng.normal(size=(len(v), m.phn_dim)) for v in m.v]
    m.invalidate()
    p = port(m)
    A0 = np.eye(4) + 0.25 * rng.normal(size=(4, 4))
    jaccs, paccs = [], []
    for s, n in enumerate((300, 240, 40)):
        x = (rng.normal(size=(n, 4)) * 1.5) @ A0.T + 0.3 * s
        pdfs = rng.integers(0, 3, size=n)
        vs = rng.normal(size=2)
        ja, pa = JF.FmllrSgmm2Accs(m), PF.FmllrSgmm2Accs(p)
        ja.accumulate(m, x, pdfs, spk_vec=vs)
        pa.accumulate(p, x, pdfs, spk_vec=vs)
        for name in ("L", "G", "sigma_bar"):
            assert rel(getattr(pa, name), getattr(ja, name)) <= TOL, name
        assert pa.beta == pytest.approx(ja.beta, rel=TOL)
        jaccs.append(ja)
        paccs.append(pa)
    opts = dict(num_iters=8, min_count=100.0)
    Ws = PF.estimate_sgmm2_fmllr_batch(p, paccs, PF.FmllrSgmm2Options(**opts))
    for ja, pa, W in zip(jaccs, paccs, Ws):
        want = JF.estimate_sgmm2_fmllr(m, ja, JF.FmllrSgmm2Options(**opts))
        if want is None:
            assert W is None
            continue
        assert rel(W, want) <= 1e-8
        assert PF.sgmm2_fmllr_objf_improvement(p, pa, W) == pytest.approx(
            JF.sgmm2_fmllr_objf_improvement(m, ja, want), rel=1e-8)
    assert Ws[2] is None


def test_model_and_accumulator_files_both_ways(tmp_path):
    """Each package reads the other's model (the float32 fields within one
    float32 rounding of the in-memory float64 ones, the structure and
    scores equal) and accumulator files (float64, exactly)."""
    m = jax_model(6, spk=2, symmetric=True)
    m.ubm = _ubm(np.random.default_rng(6))
    p = port(m)
    jpath, ppath = str(tmp_path / "j.sgmm"), str(tmp_path / "p.sgmm")
    with open(jpath, "wb") as f:
        m.write(f)
    with open(ppath, "wb") as f:
        p.write(f)
    with open(jpath, "rb") as f:
        jbytes = f.read()
    with open(ppath, "rb") as f:
        assert f.read() == jbytes
    with open(jpath, "rb") as f:
        back = P.AmSgmm2.read(f, "cpu")
    with open(ppath, "rb") as f:
        jback = J.AmSgmm2.read(f)
    assert back.counts.tolist() == [len(v) for v in jback.v] and back.spk_dim == 2
    for name, want in (("M", jback.M), ("sigma_inv", jback.sigma_inv), ("V", jback.v),
                       ("C", jback.c), ("N", jback.N), ("u", jback.u)):
        assert rel(getattr(back, name), want) == 0.0, name
    x, pdfs, w, vs = data(6, m)
    ja, pa = J.MleAmSgmm2Accs(m), P.MleAmSgmm2Accs(p)
    ja.accumulate(m, x, pdfs, spk_vec=vs)
    pa.accumulate(p, x, pdfs, spk_vec=vs)
    ja.save(str(tmp_path / "j.acc"))
    pa.save(str(tmp_path / "p.acc"))
    pa2 = P.MleAmSgmm2Accs.load(str(tmp_path / "j.acc"), p)
    ja2 = J.MleAmSgmm2Accs.load(str(tmp_path / "p.acc"), m)
    for name in ("gamma", "y", "Y", "Q", "S", "Y_N", "Q_N", "a_u", "Q_u"):
        assert rel(getattr(pa2, name), getattr(ja, name)) == 0.0, name
        assert rel(getattr(pa, name), getattr(ja2, name)) == 0.0, name


def test_train_sgmm2_in_lockstep(tmp_path):
    """recipes/sgmm2.train_sgmm2 at the JAX test's size (num_iters 4, an
    8-Gaussian UBM, 4 more substates than pdfs, fixed alignments): each
    pdf owns a distinct odd number of frames, the written models' float32
    fields within 1e-6 relative, the loglikes of one utterance within 1e-6
    of the largest."""
    from old_kaldi_git_tpu.fst.lang import Lang, Lexicon
    from old_kaldi_git_tpu.gmm.diag_gmm import AmDiagGmm, AmGmmModel, DiagGmm
    from old_kaldi_git_tpu.hmm.topology import HmmTopology
    from old_kaldi_git_tpu.hmm.transition_model import TransitionModel
    from old_kaldi_git_tpu.recipes.sgmm2 import Sgmm2TrainOptions as JOpts
    from old_kaldi_git_tpu.recipes.sgmm2 import train_sgmm2 as j_train
    from old_kaldi_git_tpu.tree.context_dep import monophone_context_dependency
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel as PAmGmmModel
    from old_kaldi_git_tpu_torch.recipes.sgmm2 import Sgmm2TrainOptions, train_sgmm2

    rng = np.random.default_rng(0)
    lang = Lang(Lexicon.from_dict({"yes": "Y EH S", "no": "N OW"}), silence_phone="SIL",
                sil_prob=0.5)
    phones = lang.real_phone_ids
    topo = HmmTopology.standard(phones, silence_phones=[lang.silence_id])
    cd = monophone_context_dependency(phones, {q: topo.num_pdf_classes(q) for q in phones})
    tm = TransitionModel(cd, topo)
    D = 4
    am = AmDiagGmm([DiagGmm(np.ones(1), rng.normal(size=(1, D)) * 2, 0.5 + rng.random((1, D)))
                    for _ in range(cd.num_pdfs)])
    base = AmGmmModel(tm, am)
    base.save(str(tmp_path / "base.mdl"))
    pbase = PAmGmmModel.load(str(tmp_path / "base.mdl"), device="cpu")
    tid2pdf = tm.tid_to_pdf_array()
    self_loops = {}
    for tid in range(1, tm.num_tids + 1):
        self_loops.setdefault(int(tid2pdf[tid]), tid)
    seq = rng.permutation(np.repeat(np.arange(cd.num_pdfs), 2 * np.arange(cd.num_pdfs) + 1))
    feats, alis = {}, {}
    for u, part in enumerate(np.array_split(seq, 6)):
        feats[f"u{u}"] = np.stack([am.pdfs[q].means[0] + np.sqrt(am.pdfs[q].vars[0])
                                   * rng.normal(size=D) for q in part]).astype(np.float32)
        alis[f"u{u}"] = np.asarray([self_loops[int(q)] for q in part], np.int32)
    kw = dict(num_iters=4, num_ubm_gauss=8, total_substates=cd.num_pdfs + 4)
    jm = j_train(base, feats, alis, opts=JOpts(**kw))
    hist = []
    pm = train_sgmm2(pbase, feats, alis, opts=Sgmm2TrainOptions(**kw), device="cpu",
                     history=hist)
    assert [h["flags"] for h in hist] == ["vwc", "MS", "vwc", "MS"]
    assert pm.sgmm.counts.tolist() == [len(v) for v in jm.sgmm.v]
    jm.save(str(tmp_path / "j.mdl"))
    pm.save(str(tmp_path / "p.mdl"))
    from old_kaldi_git_tpu_torch.gmm.sgmm2 import Sgmm2Model

    a = Sgmm2Model.load(str(tmp_path / "j.mdl"), device="cpu").sgmm
    b = Sgmm2Model.load(str(tmp_path / "p.mdl"), device="cpu").sgmm
    for name in ("M", "w", "sigma_inv", "V", "C"):
        assert rel(getattr(b, name), getattr(a, name)) <= 1e-6, name
    assert rel(pm.sgmm.loglikes(feats["u0"]), jm.sgmm.loglikes_numpy(feats["u0"])) <= 1e-6
    for x, y in zip(hist, hist[1:]):
        assert y["avg_like"] >= x["avg_like"] - 1e-6
