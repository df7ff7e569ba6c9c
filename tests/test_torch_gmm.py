"""Port GMM readers and loglikes (the plain version of the GMM kernel, the
one a CPU tensor takes) vs the JAX package on the CPU.

Readers: every number of the committed tri.mdl and mono.mdl equals the JAX
package's, and the packed rows are its `stacked()` to the bit.  Loglikes:
within atol 2e-3 + rtol 2e-3 of the JAX Pallas kernel (interpret mode) and of
its jnp path: the TPU kernel's own test tolerance (tests/test_ops.py), fp32
sums taken in another order over terms up to ~1e4."""

import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
import old_kaldi_git_tpu.ops.gmm_kernel as jk
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.ops import gmm_kernel as tk
from old_kaldi_git_tpu_torch.recipes import minilib
from old_kaldi_git_tpu_torch.utils import io_funcs as iof
from old_kaldi_git_tpu_torch.utils.log import KaldiError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
TOL = dict(atol=2e-3, rtol=2e-3)


class _Pipe(io.RawIOBase):
    """A raw stream that cannot seek or tell, as a pipe; `most` bytes a read."""

    def __init__(self, data: bytes, most: int = 1 << 16):
        self._src, self._most = io.BytesIO(data), most

    def readable(self):
        return True

    def readinto(self, b):
        chunk = self._src.read(min(len(b), self._most))
        b[: len(chunk)] = chunk
        return len(chunk)


@pytest.mark.parametrize("name", ["tri.mdl", "mono.mdl"])
def test_reads_committed_models_like_the_jax_package(name):
    path = os.path.join(WORKDIR, name)
    jm = jgmm.AmGmmModel.load(path)
    tm = convert.load_am_gmm_model(path, device="cpu")
    assert tm.tm.tuples == jm.tm.tuples
    assert tm.tm.state2id == jm.tm.state2id and tm.tm.num_tids == jm.tm.num_tids
    assert tm.tm.num_pdfs == jm.tm.num_pdfs == tm.am.num_pdfs
    assert np.array_equal(tm.tm.log_probs, jm.tm.log_probs)
    assert np.array_equal(tm.tm.tid_to_pdf_array(), jm.tm.tid_to_pdf_array())
    assert tm.am.num_pdfs == jm.am.num_pdfs and tm.am.num_gauss == jm.am.num_gauss
    for tp, jp in zip(tm.am.pdfs, jm.am.pdfs):
        for field in ("weights", "means", "vars", "gconsts"):
            a, b = getattr(tp, field), getattr(jp, field)
            assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b), field
    W, mask, M = tm.am.stacked()
    jW, jmask, jM = jm.am.stacked()
    assert M == jM and np.array_equal(mask, np.asarray(jmask))
    assert W.dtype == np.float32
    assert np.array_equal(W.view(np.int32), np.asarray(jW).view(np.int32))
    packed = tm.am.weights()
    assert packed.num_gauss == tm.am.num_gauss and packed.max_mix == M
    assert packed.depth % 8 == 0 and int((packed.col_pdf >= 0).sum()) == packed.num_gauss


def test_tri_model_tid_to_pdf_equals_the_graphs():
    """tri.mdl decodes against the committed HCLG, whose pdf column comes
    from tree.pkl's transition model."""
    tm = convert.load_am_gmm_model(os.path.join(WORKDIR, "tri.mdl"), device="cpu").tm
    _ctx, tree_tm = convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))
    assert np.array_equal(tm.tid_to_pdf_array(),
                          convert.tid_to_pdf_from_transition_model(tree_tm))


def test_reader_takes_a_pipe_and_peeks_without_seeking():
    with open(os.path.join(WORKDIR, "mono.mdl"), "rb") as f:
        data = f.read()
    stream = io.BufferedReader(_Pipe(data))
    assert not stream.seekable()
    assert iof.init_kaldi_input_stream(stream)
    assert iof.peek_token(stream) == "<TransitionModel>"
    assert iof.peek_token(stream) == "<TransitionModel>"
    assert iof.read_token(stream) == "<TransitionModel>"
    assert iof.peek_token(stream) == "<Topology>"
    # a pipe that hands over 7 bytes a read: the reader needs no look-ahead
    # beyond a byte or two; a whole-token peek may run past it and says so
    stream = io.BufferedReader(_Pipe(data, most=7))
    assert iof.init_kaldi_input_stream(stream)
    with pytest.raises(KaldiError, match="look-ahead"):
        iof.peek_token(stream)
    model = AmGmmModel.read(stream, device="cpu")
    ref = convert.load_am_gmm_model(os.path.join(WORKDIR, "mono.mdl"), device="cpu")
    assert np.array_equal(model.am.stacked()[0], ref.am.stacked()[0])
    assert stream.read() == b""
    with pytest.raises(KaldiError, match="peek"):
        iof.init_kaldi_input_stream(io.BytesIO(data))
    text = io.BufferedReader(_Pipe(b"<Foo> 3"))
    assert not iof.init_kaldi_input_stream(text) and iof.read_token(text) == "<Foo>"


def _random_pdfs(seed, num_pdfs, dim, mix):
    """Per-pdf (weights, means, vars), the builder of tests/test_ops.py."""
    rng = np.random.default_rng(seed)
    pdfs = []
    for i in range(num_pdfs):
        m = mix(rng, i)
        w = np.abs(rng.random(m)) + 0.1
        pdfs.append((w / w.sum(), rng.normal(size=(m, dim)) * 2,
                     0.3 + rng.random((m, dim))))
    return pdfs


def _both_models(pdfs):
    jam = jgmm.AmDiagGmm([jgmm.DiagGmm(*p) for p in pdfs])
    return jam, convert.am_diag_gmm_from_jax(pdfs, device="cpu")


def test_plain_matches_pallas_interpret_and_jnp_on_a_ragged_model():
    """The 37-pdf, 2-6-mixture, D=13 model of tests/test_ops.py, 200 frames."""
    pdfs = _random_pdfs(2, 37, 13, lambda rng, i: 1 + int(rng.integers(1, 6)))
    jam, tam = _both_models(pdfs)
    x = np.random.default_rng(3).normal(size=(200, 13)).astype(np.float32)
    out = tk.gmm_loglikes_plain(torch.from_numpy(x), tam.weights()).numpy()
    assert out.shape == (200, 37) and out.dtype == np.float32
    pallas = np.asarray(jk.gmm_loglikes_pallas(jnp.asarray(x), jk.pack_gmm_weights(jam),
                                               interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)
    ref = np.asarray(jam.loglikes_batch(x[None]))[0]
    np.testing.assert_allclose(out, ref, **TOL)
    # the float64 host oracle of the JAX package
    np.testing.assert_allclose(out, jam.loglikes_numpy(x), **TOL)


def test_plain_matches_jnp_above_the_tpu_kernels_mixture_cap():
    """One pdf with 130 Gaussians: the TPU kernel refuses more than 128
    (pack_gmm_weights), the jnp main path and the port take any count."""
    pdfs = _random_pdfs(4, 9, 13, lambda rng, i: 130 if i == 4 else 1 + i % 3)
    jam, tam = _both_models(pdfs)
    with pytest.raises(ValueError):
        jk.pack_gmm_weights(jam)
    x = np.random.default_rng(5).normal(size=(45, 13)).astype(np.float32)
    out = tam.loglikes_batch(torch.from_numpy(x)).numpy()
    assert tam.weights().max_mix == 256 and tam.weights().num_gauss == 130 + 16
    np.testing.assert_allclose(out, np.asarray(jam.loglikes_batch(x[None]))[0], **TOL)


def test_tri_model_on_real_features_matches_pallas_and_jnp():
    """About 300 frames of two held-out utterances through tri.mdl (2,000
    pdfs, 1-52 Gaussians each), batched [B, T, D] as decode_dataset calls it."""
    opts = minilib.MinilibOptions(num_test=2)
    waves, _ = minilib.make_test_set(opts)
    feats = minilib.compute_feats(waves, device="cpu")
    x = np.concatenate([feats[k] for k in sorted(feats)])[:300]
    assert x.shape == (300, 39)
    path = os.path.join(WORKDIR, "tri.mdl")
    jm = jgmm.AmGmmModel.load(path)
    tm = convert.load_am_gmm_model(path, device="cpu")
    out = tm.am.loglikes_batch(torch.from_numpy(x.reshape(3, 100, 39))).numpy()
    assert out.shape == (3, 100, 2000)
    out = out.reshape(300, 2000)
    ref = np.asarray(jm.am.loglikes_batch(x[None]))[0]
    np.testing.assert_allclose(out, ref, **TOL)
    pallas = np.asarray(jk.gmm_loglikes_pallas(jnp.asarray(x), jk.pack_gmm_weights(jm.am),
                                               interpret=True))
    # The TPU kernel's per-group stabiliser (exp(·/8) of scores relative to
    # the 128-lane block's best) underflows for a pdf far below the other
    # pdf of its block (M_pad = 64: two pdfs a block): there it departs from
    # the jnp main path, which the port follows.  Inside its range the port
    # equals it; outside, the departure is the kernel's, not the port's.
    below = ref.reshape(300, -1, 2).max(axis=2).repeat(2, axis=1) - ref
    near = below < 600.0
    assert near.mean() > 0.9
    np.testing.assert_allclose(out[near], pallas[near], **TOL)
    off = ~np.isclose(pallas, ref, **TOL)
    assert off.any() and below[off].min() > 600.0


def test_plain_version_does_not_depend_on_its_chunking(monkeypatch):
    pdfs = _random_pdfs(6, 11, 13, lambda rng, i: 1 + i % 5)
    _, tam = _both_models(pdfs)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(77, 13)).astype(np.float32))
    whole = tk.gmm_loglikes_plain(x, tam.weights())
    monkeypatch.setattr(tk, "PLAIN_CHUNK_BYTES", 4 * 11 * 8 * 10)  # 10 frames a chunk
    np.testing.assert_allclose(tk.gmm_loglikes_plain(x, tam.weights()).numpy(),
                               whole.numpy(), atol=1e-5, rtol=0)


def test_ragged_rows_are_the_real_gaussians_of_the_padded_ones():
    """The kernel's tile columns are the real Gaussians of the padded rows,
    pdf by pdf, split hi + lo; the rest of the tile is zero padding."""
    pdfs = _random_pdfs(8, 5, 3, lambda rng, i: [1, 3, 2, 4, 1][i])
    _, tam = _both_models(pdfs)
    W, mask, _ = tam.stacked()
    packed = tam.weights()
    assert packed.col_pdf.tolist() == [0, 1, 1, 1, 2, 2, 3, 3, 3, 3, 4] + [-1] * 53
    assert packed.segments.tolist() == [[0, 0, 1, 0], [1, 1, 4, 0], [2, 4, 6, 0],
                                        [3, 6, 10, 0], [4, 10, 11, 0]]
    assert packed.seg_offsets.tolist() == [0, 5]
    hi, lo = (c.numpy() for c in packed.columns())
    assert hi.shape == lo.shape == (64, 8) and not hi[11:].any() and not hi[:, 7:].any()
    rows = W[mask.reshape(-1)]
    assert np.all(np.abs(hi[:11, :7] + lo[:11, :7] - rows) <= 2.0 ** -22 * np.abs(rows))
    with pytest.raises(ValueError, match="at least one"):
        tk.pack_gmm_weights(W, np.array([1, 3, 0, 4, 1]), torch.device("cpu"))


def test_cpu_tensors_take_the_plain_version_and_the_card_is_the_default(monkeypatch):
    pdfs = _random_pdfs(9, 4, 13, lambda rng, i: 2)
    _, tam = _both_models(pdfs)
    x = torch.zeros((6, 13))
    before = tk.gmm_loglikes.launches
    assert torch.equal(tam.loglikes_batch(x), tk.gmm_loglikes_plain(x, tam.weights()))
    assert tk.gmm_loglikes.launches == before
    with pytest.raises(TypeError):
        tk.gmm_loglikes(x.double(), tam.weights())
    with pytest.raises(ValueError, match="feats"):
        tk.gmm_loglikes(torch.zeros((6, 12)), tam.weights())
    with pytest.raises(ValueError, match="weights on"):
        tk.gmm_loglikes(torch.zeros((6, 13), device="meta"), tam.weights())
    with pytest.raises(TypeError):
        tam.loglikes_batch(np.zeros((6, 13), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_am_gmm_model(os.path.join(WORKDIR, "mono.mdl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.am_diag_gmm_from_jax(pdfs)
