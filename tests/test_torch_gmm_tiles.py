"""The GMM kernel's tile layout and arithmetic, on the CPU.

csrc/gmm.cu runs only on the card; what surrounds it is held here:

- the packing (`pack_gmm_weights`, `pack_columns`): the real Gaussians pdf by
  pdf in tiles of 64 columns, each exactly once, padding columns −1 and zero,
  a pdf split only when it is larger than a tile, and the tile's segments;
- the hi/lo split (`tf32_round`): TF32 values, ties away from zero as
  `cvt.rna.tf32.f32` rounds, and W − hi − lo within 2⁻²²·|W|;
- an emulation of the kernel's arithmetic over the packed tiles (three TF32
  products summed in float32, then the per-tile logsumexp with the carry),
  which must equal the plain version within the kernel's contract,
  2e-3 + 2e-3·|plain| (tests/test_ops.py), while one TF32 product must not:
  that is why the split exists."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.ops import gmm_kernel as tk
from old_kaldi_git_tpu_torch.recipes import minilib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRI = os.path.join(REPO, "exp", "minilib", "tri.mdl")
ATOL = RTOL = 2e-3
C = tk.COLS_PER_TILE


def _gmm(mix, dim, seed):
    """A random AmDiagGmm on the CPU with the given mixture counts."""
    rng = np.random.default_rng(seed)
    pdfs = []
    for m in mix:
        w = rng.random(m) + 0.1
        pdfs.append((w / w.sum(), rng.normal(size=(m, dim)) * 2,
                     0.3 + rng.random((m, dim))))
    return convert.am_diag_gmm_from_jax(pdfs, device="cpu")


@pytest.fixture(scope="module")
def tri():
    return convert.load_am_gmm_model(TRI, device="cpu").am


@pytest.fixture(scope="module")
def tri_frames():
    """About 300 real frames of two held-out utterances."""
    waves, _ = minilib.make_test_set(minilib.MinilibOptions(num_test=2))
    feats = minilib.compute_feats(waves, device="cpu")
    return np.concatenate([feats[k] for k in sorted(feats)])[:300]


def _ragged():
    return _gmm(np.random.default_rng(11).integers(1, 21, size=137), 13, 12)


def _spanning():
    """One 300-Gaussian pdf that starts mid-tile and runs over four more."""
    return _gmm([3, 300, 2, 64, 1, 63, 5], 13, 13)


def _ends_mid_tile():
    """pdfs that fill a tile exactly, leave a tile's rest unused, and end
    the model part-way through its last tile."""
    return _gmm([64, 30, 40, 20, 7], 3, 14)


MODELS = {"ragged": _ragged, "spanning": _spanning, "ends_mid_tile": _ends_mid_tile}


def _check_packing(am):
    W, mask, _ = am.stacked()
    w = am.weights()
    num_mix = mask.sum(axis=1)
    col_pdf = w.col_pdf.numpy()
    real = col_pdf >= 0
    assert len(col_pdf) == w.num_tiles * C and w.num_gauss == num_mix.sum()
    # every Gaussian exactly once, in pdf order
    assert np.array_equal(col_pdf[real], np.repeat(np.arange(len(num_mix)), num_mix))
    hi, lo = (c.numpy() for c in w.columns())
    e = W.shape[1]
    assert w.depth % tk.K_STEP == 0 and w.depth - tk.K_STEP < e <= w.depth
    rows = W[mask.reshape(-1)]
    assert np.all(np.abs(rows - hi[real, :e] - lo[real, :e]) <= 2.0 ** -22 * np.abs(rows))
    assert not hi[~real].any() and not lo[~real].any()
    assert not hi[:, e:].any() and not lo[:, e:].any()
    # a pdf is split only when it is larger than a tile
    tile_of = np.arange(len(col_pdf)) // C
    for p, m in enumerate(num_mix):
        tiles = np.unique(tile_of[col_pdf == p])
        assert len(tiles) == (1 if m <= C else len(tiles)) and np.all(np.diff(tiles) == 1)
    # the tile descriptors: one segment per (tile, pdf), its columns and flags
    segs, so = w.segments.numpy(), w.seg_offsets.numpy()
    work, wo = w.work.numpy(), w.work_offsets.numpy()
    assert len(wo) == 2 * w.num_tiles + 1 and np.all(np.diff(wo) >= 0) and wo[-1] == len(work)
    first_pdf, count = w.tile_pdfs().T
    for t in range(w.num_tiles):
        tile = col_pdf[t * C: (t + 1) * C]
        pdfs = list(dict.fromkeys(tile[tile >= 0].tolist()))
        assert first_pdf[t] == pdfs[0] and count[t] == len(pdfs)
        got = segs[so[t]: so[t + 1]]
        assert got[:, 0].tolist() == pdfs
        for p, c0, c1, flags in got.tolist():
            assert np.array_equal(np.flatnonzero(tile == p), np.arange(c0, c1))
            assert flags == (tk.CARRY_IN * bool((tile_of[col_pdf == p] < t).any())
                             + tk.CARRY_OUT * bool((tile_of[col_pdf == p] > t).any()))
        # the work: every segment but a lone Gaussian, in order, in two halves
        # whose larger one is as small as a split can make it
        todo = [(c0, c1, flags) for _, c0, c1, flags in got.tolist() if flags or c1 - c0 > 1]
        assert work[wo[2 * t]: wo[2 * t + 2]].tolist() == [
            c0 | c1 << 8 | flags << 16 for c0, c1, flags in todo]
        cost = np.cumsum([0] + [4 + c1 - c0 for c0, c1, _ in todo])
        k = wo[2 * t + 1] - wo[2 * t]
        assert max(cost[k], cost[-1] - cost[k]) == np.maximum(cost, cost[-1] - cost).min()
    return w


def test_tri_model_packs_into_45_tiles_of_real_gaussians(tri):
    w = _check_packing(tri)
    assert (w.num_tiles, w.depth, w.num_gauss) == (45, 80, 2800)
    assert 0.97 < w.num_gauss / (w.num_tiles * C) < 0.975
    assert tk.smem_bytes(w.depth) <= tk.MAX_SMEM_BYTES
    assert not w.segments[:, 3].any()  # no tri.mdl pdf outruns a tile


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packing_invariants(name):
    w = _check_packing(MODELS[name]())
    if name == "spanning":
        assert w.segments[:7].tolist() == [
            [0, 0, 3, 0], [1, 3, 64, tk.CARRY_OUT],
            [1, 0, 64, tk.CARRY_IN | tk.CARRY_OUT], [1, 0, 64, tk.CARRY_IN | tk.CARRY_OUT],
            [1, 0, 64, tk.CARRY_IN | tk.CARRY_OUT], [1, 0, 47, tk.CARRY_IN], [2, 47, 49, 0]]
    if name == "ends_mid_tile":
        assert w.tile_pdfs().tolist() == [[0, 1], [1, 1], [2, 2], [4, 1]]
        assert (w.col_pdf.view(-1, C) >= 0).sum(1).tolist() == [64, 30, 60, 7]


def test_staged_tiles_fit_shared_memory_up_to_feature_dim_47():
    """The wrapper refuses a wider model on the card (chip_smoke.py)."""
    fits = [d for d in range(1, 60)
            if tk.smem_bytes(-(-(2 * d + 1) // tk.K_STEP) * tk.K_STEP) <= tk.MAX_SMEM_BYTES]
    assert fits == list(range(1, 48))


def test_tf32_round_keeps_ten_mantissa_bits_and_rounds_ties_away(tri):
    W = tri.stacked()[0]
    W = W[np.abs(W) < 1e29]  # the padded rows' gconst −1e30 is not a Gaussian
    hi = tk.tf32_round(W)
    lo = tk.tf32_round(W - hi)
    assert hi.dtype == lo.dtype == np.float32
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(W - hi - lo) <= 2.0 ** -22 * np.abs(W))
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4,
                  2 ** -126 * (1 + ulp / 2), 0.0, -0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1, 1 + ulp,
                     2 ** -126 * (1 + ulp), 0.0, -0.0], np.float32)
    got = tk.tf32_round(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _emulate(x: np.ndarray, w, products: int = 3) -> np.ndarray:
    """csrc/gmm.cu's arithmetic in float32 on the CPU: the frame rows split
    like the tiles, lo·hi + hi·lo + hi·hi (or hi·hi alone); then per tile a
    pdf of one Gaussian taken as it is, and the tile's work list, each entry's
    columns four at a time into a running (max, sum), written at the pdf's
    first column or carried into the next tile; then the stores."""
    n, d = x.shape
    ext = np.zeros((n, w.depth), np.float32)
    ext[:, :d], ext[:, d: 2 * d], ext[:, 2 * d] = x, x * x, 1.0
    xh = tk.tf32_round(ext)
    xl = tk.tf32_round(ext - xh)
    hi, lo = (c.numpy() for c in w.columns())
    scores = xh @ hi.T
    if products == 3:
        scores = xl @ hi.T + xh @ lo.T + scores
    out = np.full((n, w.num_pdfs), np.nan, np.float32)
    segs, so = w.segments.numpy(), w.seg_offsets.numpy()
    work, wo = w.work.numpy(), w.work_offsets.numpy()
    carry = None
    with np.errstate(over="ignore"):
        for t in range(w.num_tiles):
            tile = scores[:, t * C: (t + 1) * C].copy()
            for w_ in work[wo[2 * t]: wo[2 * t + 2]].tolist():
                c0, c1, flags = w_ & 0xFF, (w_ >> 8) & 0xFF, w_ >> 16
                m, s = carry if flags & tk.CARRY_IN else (np.float32(-np.inf), np.float32(0))
                for c in range(c0, c1, 4):
                    v = np.full((n, 4), -np.inf, np.float32)
                    v[:, : min(4, c1 - c)] = tile[:, c: min(c + 4, c1)]
                    mn = np.maximum(m, v.max(axis=1))
                    e = np.exp(v - mn[:, None])
                    s = s * np.exp(m - mn) + ((e[:, 0] + e[:, 1]) + (e[:, 2] + e[:, 3]))
                    m = mn
                if flags & tk.CARRY_OUT:
                    carry = (m, s)
                else:
                    tile[:, c0] = m + np.log(s)
            for p, c0, _, flags in segs[so[t]: so[t + 1]].tolist():
                if not flags & tk.CARRY_OUT:
                    out[:, p] = tile[:, c0]
    return out


def _share(out, ref):
    """Worst |out − ref| over its allowance atol + rtol·|ref|."""
    return float((np.abs(out - ref) / (ATOL + RTOL * np.abs(ref))).max())


def test_three_tf32_products_meet_the_contract_on_real_frames_and_one_does_not(
        tri, tri_frames):
    w = tri.weights()
    x = np.ascontiguousarray(tri_frames, np.float32)
    assert x.shape == (300, 39) and np.abs(x).max() > 50
    ref = tk.gmm_loglikes_plain(torch.from_numpy(x), w).numpy()
    three = _emulate(x, w)
    assert not np.isnan(three).any()
    assert _share(three, ref) < 0.05
    # one TF32 product moves loglikes by nats: far outside the contract
    assert _share(_emulate(x, w, products=1), ref) > 2.0


@pytest.mark.parametrize("case", ["random_1_150", "spanning_300", "ragged_d13"])
def test_emulated_kernel_matches_the_plain_version(case):
    rng = np.random.default_rng(21)
    if case == "random_1_150":  # chip_smoke.py's random model: 999 pdfs, 1-150 Gaussians
        mix = rng.integers(1, 151, size=999)
        mix[7] = 150
        am, n, scale = _gmm(mix, 39, 3), 64, 3.0
    elif case == "spanning_300":
        am, n, scale = _gmm([3, 300, 2, 64, 1, 63, 5, 130], 39, 4), 129, 3.0
    else:
        am, n, scale = _ragged(), 200, 1.0
    w = am.weights()
    if case != "ragged_d13":
        assert w.segments[:, 3].any()  # some pdf is carried across tiles
    x = (scale * rng.normal(size=(n, am.dim))).astype(np.float32)
    ref = tk.gmm_loglikes_plain(torch.from_numpy(x), w).numpy()
    out = _emulate(x, w)
    assert not np.isnan(out).any() and _share(out, ref) <= 1.0
