"""The port's egs holders against the JAX package's, on the CPU.

CE egs (<Eg>: a float matrix, int labels, a float mask, an optional <IVec>)
and chain egs (<ChainEg>: features, pdf_seq, `allowed` as a 0/1 float
matrix read back as > 0.5, num_frames, advance_lp, xent labels, an optional
<IVec>), with and without iVectors, written by one package's TableWriter are
read by the other's and written again byte for byte; a text archive is
refused; "egs" / "cegs" load their module on first request."""

import tests.torch_threads  # noqa: F401
import os
import subprocess
import sys

import numpy as np
import pytest

import old_kaldi_git_tpu.chain.supervision as jsup
import old_kaldi_git_tpu.models.egs as jegs
import old_kaldi_git_tpu.utils.table as jtable
import old_kaldi_git_tpu_torch.chain.supervision as tsup
import old_kaldi_git_tpu_torch.models.egs as tegs
import old_kaldi_git_tpu_torch.utils.table as ttable
from old_kaldi_git_tpu_torch.utils.log import KaldiError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jegs, jsup, jtable), "port": (tegs, tsup, ttable)}


def _egs(pkg: str, kind: str, ivector: bool, seed: int = 0) -> dict:
    """Three egs of ragged lengths, made from a seed, of one package's types."""
    egs, sup, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    out = {}
    for i, t in enumerate((7, 12, 9)):
        feats = rng.normal(size=(3 * t, 5)).astype(np.float32)
        iv = rng.normal(size=4).astype(np.float32) if ivector else None
        if kind == "egs":
            out[f"utt{i}-0"] = egs.NnetEg(feats, rng.integers(0, 50, 3 * t).astype(np.int32),
                                          rng.random(3 * t).astype(np.float32), iv)
        else:
            L = t // 2 + 1
            s = sup.ChainSupervision(rng.integers(0, 40, L).astype(np.int32),
                                     rng.random((t, L)) > 0.6, t,
                                     rng.normal(size=L).astype(np.float32))
            out[f"utt{i}-0"] = egs.ChainEg(feats, s, rng.integers(0, 40, t).astype(np.int32),
                                           iv)
    return out


def _write(pkg: str, path: str, kind: str, items: dict) -> bytes:
    with PACKAGES[pkg][2].TableWriter(f"ark:{path}", kind) as w:
        for k, v in items.items():
            w[k] = v
    with open(path, "rb") as f:
        return f.read()


def _same(a, b, kind: str) -> None:
    """Field for field (dtype-insensitive values, exact)."""
    assert np.array_equal(a.feats, b.feats)
    assert (a.ivector is None) == (b.ivector is None)
    if a.ivector is not None:
        assert np.array_equal(a.ivector, b.ivector)
    if kind == "egs":
        assert np.array_equal(a.labels, b.labels) and np.array_equal(a.mask, b.mask)
    else:
        assert np.array_equal(a.xent, b.xent)
        for f in ("pdf_seq", "allowed", "advance_lp"):
            assert np.array_equal(getattr(a.sup, f), getattr(b.sup, f))
        assert int(a.sup.num_frames) == int(b.sup.num_frames)
        assert a.sup.allowed.dtype == b.sup.allowed.dtype == np.bool_


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["egs", "cegs"])
@pytest.mark.parametrize("ivector", [False, True])
def test_archives_cross_both_ways_byte_for_byte(tmp_path, writer, reader, kind, ivector):
    items = _egs(writer, kind, ivector)
    raw = _write(writer, str(tmp_path / "a.ark"), kind, items)
    back = PACKAGES[reader][2].read_table(f"ark:{tmp_path / 'a.ark'}", kind)
    assert list(back) == list(items)
    for k in items:
        _same(back[k], items[k], kind)
    assert _write(reader, str(tmp_path / "b.ark"), kind, back) == raw
    # and the two packages write the same bytes from the same values
    assert _write(reader, str(tmp_path / "c.ark"), kind, _egs(reader, kind, ivector)) == raw


@pytest.mark.parametrize("kind", ["egs", "cegs"])
def test_a_text_archive_is_refused(tmp_path, kind):
    eg = next(iter(_egs("port", kind, False).values()))
    with pytest.raises(KaldiError, match="binary-only"):
        with ttable.TableWriter(f"ark,t:{tmp_path / 'a.txt'}", kind) as w:
            w["utt0-0"] = eg


def test_egs_holders_load_lazily():
    code = ("import sys; import old_kaldi_git_tpu_torch.utils.table as t; "
            "m = 'old_kaldi_git_tpu_torch.models.egs'; assert m not in sys.modules; "
            "h = t.get_holder('cegs'); assert m in sys.modules; "
            "from old_kaldi_git_tpu_torch.models.egs import ChainEgHolder, NnetEgHolder; "
            "assert isinstance(h, ChainEgHolder); "
            "assert isinstance(t.get_holder('egs'), NnetEgHolder); print('lazy')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "lazy", out.stderr
