"""Online iVectors in the port vs the JAX package, on the CPU.

final.ie through the port's reader (a diagonal UBM of 64 Gaussians at dim
39, T [64, 39, 32]); the UBM's float64 scores and posteriors within 1e-12
relative; the extractor's float64 statistics, precision and posterior means
within 1e-9 relative, the online update points too; online iVectors (float32
after one cast) within 1e-6 relative, on final.ie with held-out utterances
and on a small extractor trained by the JAX package.  OnlineIvectorExtractor:
tests/test_torch_ivector_stream.py; the feature wiring and the iVector
recipes: tests/test_torch_ivector_recipes.py; both use the fixtures here.
Training: tests/test_torch_ivector_train.py."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.ivector.extractor as jiv
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu_torch.ivector.extractor as tiv
import old_kaldi_git_tpu_torch.recipes.minilib as tminilib
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.gmm.diag_gmm import DiagGmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
FINAL_IE = os.path.join(WORKDIR, "final.ie")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def final_ie():
    return jiv.IvectorExtractor.load(FINAL_IE), tiv.IvectorExtractor.load(FINAL_IE,
                                                                         device="cpu")


@pytest.fixture(scope="module")
def small():
    """A 4-Gaussian, 3-dim extractor at feature dim 5, trained by the JAX
    package (as tests/test_ivector_online.py trains it) and carried over."""
    rng = np.random.default_rng(0)
    utts = [(rng.normal(size=(60, 5)) + 2.0 * (i % 2)).astype(np.float32)
            for i in range(6)]
    ubm = jiv.train_ubm(np.concatenate(utts), num_gauss=4, num_iters=3)
    je = jiv.train_ivector_extractor(ubm, utts, ivector_dim=3, num_iters=3)
    return je, tiv.IvectorExtractor(DiagGmm(ubm.weights, ubm.means, ubm.vars), je.T,
                                    device="cpu")


@pytest.fixture(scope="module")
def held_out_feats():
    waves, _ = tminilib.make_test_set(tminilib.MinilibOptions())
    keys = sorted(waves)[:3]
    return tminilib.compute_feats({k: waves[k] for k in keys}, device="cpu")


@pytest.mark.parametrize("name,ivector_dim,input_dim", [
    ("final.am", 0, 39), ("final_ivec.am", 32, 71)])
def test_load_am_nnet_keeps_the_ivector_dim(name, ivector_dim, input_dim):
    am = convert.load_am_nnet(os.path.join(WORKDIR, name), device="cpu")
    assert am.ivector_dim == ivector_dim == jam.AmNnet.load(
        os.path.join(WORKDIR, name)).ivector_dim
    assert am.config.input_dim == input_dim


def test_final_ie_loads(final_ie):
    je, te = final_ie
    assert tuple(te.T.shape) == je.T.shape == (64, 39, 32) and te.ivector_dim == 32
    assert te.T.dtype == torch.float64 and np.array_equal(te.T.numpy(), je.T)
    for f in ("weights", "means", "vars"):
        assert np.array_equal(getattr(te.ubm, f), getattr(je.ubm, f))


def test_full_covariance_extractor_is_refused(tmp_path):
    """A full-covariance (kind 1) header over final.ie's diagonal UBM is
    refused: kind 1 reads a <FullGMM> (real kind-1 files:
    tests/test_torch_ivector_train.py); so is a kind the reader does not
    know."""
    raw = bytearray(open(FINAL_IE, "rb").read())
    at = raw.index(b"<IvectorExtractor> ") + len(b"<IvectorExtractor> ")
    assert raw[at] == 4 and raw[at + 1: at + 5] == b"\0\0\0\0"  # int32 kind 0
    for kind, match in ((1, "<FullGMM>"), (2, "unknown UBM kind")):
        raw[at + 1] = kind
        path = tmp_path / f"kind{kind}.ie"
        path.write_bytes(bytes(raw))
        with pytest.raises(tiv.KaldiError, match=match):
            tiv.IvectorExtractor.load(str(path), device="cpu")


@pytest.mark.parametrize("method", ["component_loglikes", "loglikes", "posteriors"])
def test_diag_gmm_scores_equal(final_ie, method):
    je, te = final_ie
    x = np.random.default_rng(1).normal(size=(50, 39)) * 3
    want = getattr(je.ubm, method)(x)
    got = getattr(te.ubm, method)(torch.from_numpy(x))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= 1e-12
    if method == "posteriors":
        assert np.allclose(got.sum(1).numpy(), 1.0, rtol=0, atol=1e-12)


def test_float64_pieces_equal(final_ie, held_out_feats):
    je, te = final_ie
    x = held_out_feats[sorted(held_out_feats)[0]]
    jg, jf = jiv._utt_stats(je.ubm, x)
    tg, tf = tiv._utt_stats(te.ubm, te.frames(x))
    assert rel(tg.numpy(), jg) <= 1e-9 and rel(tf.numpy(), jf) <= 1e-9
    for got, want in zip(tiv._precomputed(te), jiv._precomputed(je)):
        assert rel(got.numpy(), want) <= 1e-9
    jm, jL = jiv._posterior(je, jg, jf)
    tm, tL = tiv._posterior(te, tg, tf)
    assert rel(tL.numpy(), jL) <= 1e-9 and rel(tm.numpy(), jm) <= 1e-9
    assert rel(tiv.extract_ivector(te, x).numpy(), jiv.extract_ivector(je, x)) <= 1e-6


SCALE_COUNT = [(1.0, 0.0), (0.5, 0.0), (1.0, 20.0)]


def _jax_updates64(je, x, period, stats_scale, max_count):
    """The JAX package's float64 posterior means at every update point, from
    its own statistics over each prefix, scaled as its OnlineIvectorExtractor
    scales them."""
    out = []
    for end in range(period, len(x) + period, period):
        g, f = jiv._utt_stats(je.ubm, x[:end])
        g, f = g * stats_scale, f * stats_scale
        if max_count > 0 and g.sum() > max_count:
            s = max_count / g.sum()
            g, f = g * s, f * s
        out.append(jiv._posterior(je, g, f)[0])
    return np.stack(out)


@pytest.mark.parametrize("scale_count", SCALE_COUNT)
@pytest.mark.parametrize("which", ["small", "final_ie"])
def test_online_ivectors_equal(request, held_out_feats, which, scale_count):
    je, te = request.getfixturevalue(which)
    stats_scale, max_count = scale_count
    if which == "small":
        xs = [np.random.default_rng(2).normal(size=(63, 5)).astype(np.float32)]
    else:
        xs = [held_out_feats[k] for k in sorted(held_out_feats)]
    for x in xs:
        got64 = tiv.online_ivector_updates(te, x, 10, stats_scale, max_count)
        assert got64.dtype == torch.float64
        assert rel(got64.numpy(), _jax_updates64(je, x, 10, stats_scale, max_count)) <= 1e-9
        want = jiv.extract_online_ivectors(je, x, 10, stats_scale, max_count)
        got = tiv.extract_online_ivectors(te, x, 10, stats_scale, max_count)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert rel(got.numpy(), want) <= 1e-6
        assert np.array_equal(got.numpy(), np.repeat(
            got64.numpy().astype(np.float32), 10, axis=0)[:len(x)])
    assert tuple(tiv.extract_online_ivectors(te, xs[0][:0]).shape) == (0, te.ivector_dim)


# ---------------------------------------------------------------------------
# the iVector recipes
# ---------------------------------------------------------------------------
