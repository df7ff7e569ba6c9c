"""The port's on-disk I/O against the JAX package's, on the CPU: archives,
scripts, pipes, gz files and waves written by one package read in the
other (and the same bytes where both write), a tree written by either read
by the other, and the nnet3 `final.mdl` bundle (AmNnetModel) in the port's
format and from the JAX package's pickle.  The values are made from a seed
with numpy."""

import tests.torch_threads  # noqa: F401
import io
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.utils.table as jtable
import old_kaldi_git_tpu.utils.wav as jwav
import old_kaldi_git_tpu_torch.utils.table as ttable
import old_kaldi_git_tpu_torch.utils.wav as twav
from old_kaldi_git_tpu_torch.utils import io_funcs as tiof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")


def _values(holder):
    rng = np.random.default_rng(sum(map(ord, holder)))
    if holder == "mat":
        return {f"u{i}": rng.normal(size=(5 + i, 3)).astype(np.float32) for i in range(3)}
    if holder == "cmat":
        return {f"u{i}": rng.normal(size=(10 + i, 4)).astype(np.float32) for i in range(3)}
    if holder == "vec":
        return {f"u{i}": rng.normal(size=7 + i).astype(np.float32) for i in range(3)}
    if holder == "ivec":
        return {f"u{i}": rng.integers(-5, 3000, 9 + i).astype(np.int32) for i in range(3)}
    if holder == "text":
        return {f"u{i}": " ".join(rng.choice(["yes", "no"], 3 + i)) for i in range(3)}
    if holder == "flt":
        return {f"u{i}": float(np.float32(rng.normal())) for i in range(3)}
    return {f"u{i}": twav.WaveData(8000.0, np.round(3000 * rng.normal(size=(1, 400 + i))
                                                    ).astype(np.float32))
            for i in range(3)}


def _same(a, b):
    if isinstance(a, (str, float)):
        return a == b
    if hasattr(a, "samp_freq"):
        return a.samp_freq == b.samp_freq and np.array_equal(a.data, b.data)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _write(mod, spec, holder, values):
    with mod.TableWriter(spec, holder) as w:
        for k, v in values.items():
            w[k] = v


@pytest.mark.parametrize("holder", ["mat", "cmat", "vec", "ivec", "text", "flt", "wav"])
def test_archives_cross_read_with_the_same_bytes(holder, tmp_path):
    values = _values(holder)
    a, b = str(tmp_path / "j.ark"), str(tmp_path / "t.ark")
    _write(jtable, f"ark:{a}", holder, values)
    _write(ttable, f"ark:{b}", holder, values)
    assert open(a, "rb").read() == open(b, "rb").read()
    got_t = ttable.read_table(f"ark:{a}", holder)
    got_j = jtable.read_table(f"ark:{b}", holder)
    assert list(got_t) == list(got_j) == list(values)
    for k in values:
        assert _same(got_t[k], got_j[k])
        if holder in ("cmat", "wav"):
            continue  # quantised: the JAX package's own read is the yardstick
        assert _same(got_t[k], values[k])


def test_ark_scp_offsets_and_random_access_both_ways(tmp_path):
    values = _values("mat")
    for w, r, tag in ((jtable, ttable, "j"), (ttable, jtable, "t")):
        ark, scp = str(tmp_path / f"{tag}.ark"), str(tmp_path / f"{tag}.scp")
        _write(w, f"ark,scp:{ark},{scp}", "mat", values)
        seq = r.read_table(f"scp:{scp}", "mat")
        ra = r.RandomAccessTableReader(f"scp:{scp}", "mat")
        ra_ark = r.RandomAccessTableReader(f"ark:{ark}", "mat")
        for k, v in values.items():
            assert _same(seq[k], v) and _same(ra[k], v) and _same(ra_ark[k], v)
        assert "nope" not in ra and ra.get("nope") is None
    assert open(str(tmp_path / "j.scp")).read().replace("j.ark", "x") == open(
        str(tmp_path / "t.scp")).read().replace("t.ark", "x")


def test_pipes_and_gz_both_ways(tmp_path):
    values = _values("ivec")
    for w, r, tag in ((jtable, ttable, "j"), (ttable, jtable, "t")):
        gz = str(tmp_path / f"{tag}.ark.gz")
        _write(w, f"ark:| gzip -c > {gz}", "ivec", values)
        for spec in (f"ark:gunzip -c {gz} |", f"ark:{gz}"):
            got = r.read_table(spec, "ivec")
            assert all(_same(got[k], v) for k, v in values.items())
    # a .gz path written natively, read through a pipe by the other package
    _write(ttable, f"ark:{tmp_path / 'n.ark.gz'}", "ivec", values)
    got = jtable.read_table(f"ark:gunzip -c {tmp_path / 'n.ark.gz'} |", "ivec")
    assert all(_same(got[k], v) for k, v in values.items())


def test_text_archives_both_ways(tmp_path):
    for holder in ("mat", "vec", "ivec", "flt"):
        values = _values(holder)
        a, b = str(tmp_path / f"j{holder}.txt"), str(tmp_path / f"t{holder}.txt")
        _write(jtable, f"ark,t:{a}", holder, values)
        _write(ttable, f"ark,t:{b}", holder, values)
        assert open(a).read() == open(b).read()
        got_t = ttable.read_table(f"ark:{a}", holder)
        got_j = jtable.read_table(f"ark:{b}", holder)
        for k in values:
            assert _same(got_t[k], got_j[k])


def test_waves_and_codecs_both_ways(tmp_path):
    rng = np.random.default_rng(9)
    samples = np.round(8000 * rng.normal(size=(2, 333))).astype(np.float32)
    for w, r, tag in ((jwav, twav, "j"), (twav, jwav, "t")):
        path = str(tmp_path / f"{tag}.wav")
        w.write_wav(path, samples, 16000.0)
        got = r.read_wav(path)
        assert got.samp_freq == 16000.0 and np.array_equal(got.data, np.clip(samples, -32768,
                                                                             32767))
        assert r.read_wav(f"cat {path} |").data.shape == (2, 333)
    assert np.array_equal(twav._ALAW_TABLE, jwav._ALAW_TABLE)
    assert np.array_equal(twav._MULAW_TABLE, jwav._MULAW_TABLE)
    # 8-bit A-law and µ-law and unsigned 8-bit PCM read as the JAX package reads them
    for fmt in (1, 6, 7):
        raw = bytes(rng.integers(0, 256, 100, dtype=np.uint8))
        hdr = (b"RIFF" + (36 + len(raw)).to_bytes(4, "little") + b"WAVE" + b"fmt "
               + (16).to_bytes(4, "little") + fmt.to_bytes(2, "little")
               + (1).to_bytes(2, "little") + (8000).to_bytes(4, "little")
               + (8000).to_bytes(4, "little") + (1).to_bytes(2, "little")
               + (8).to_bytes(2, "little") + b"data" + len(raw).to_bytes(4, "little"))
        want = jwav.read_wav_stream(io.BytesIO(hdr + raw)).data
        got = twav.read_wav_stream(io.BufferedReader(io.BytesIO(hdr + raw))).data
        assert np.array_equal(got, want)


def test_the_tree_written_by_one_reads_in_the_other():
    from old_kaldi_git_tpu.tree.context_dep import ContextDependency as JCtx
    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency, tree_key

    tree = convert.context_dependency_from_pickle(
        convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))[0])
    f = io.BytesIO()
    tree.write(f)
    port_bytes = f.getvalue()
    jtree = JCtx.read(io.BytesIO(port_bytes))
    g = io.BytesIO()
    jtree.write(g)
    assert g.getvalue() == port_bytes
    back = ContextDependency.read(io.BufferedReader(io.BytesIO(g.getvalue())))
    assert tree_key(back) == tree_key(tree) and back.num_pdfs == 2000


def test_am_nnet_model_bundles(tmp_path):
    import torch

    import old_kaldi_git_tpu.models.am_nnet as jam
    import old_kaldi_git_tpu.models.tdnn as jtdnn
    from old_kaldi_git_tpu.gmm.diag_gmm import AmGmmModel as JModel
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet, AmNnetModel
    from old_kaldi_git_tpu_torch.models.tdnn import make_tdnn

    jtri = JModel.load(os.path.join(WORKDIR, "tri.mdl"))
    num_pdfs = jtri.am.num_pdfs
    x = np.random.default_rng(3).normal(size=(2, 20, 39)).astype(np.float32)
    # the JAX package's pickle
    jbundle = jam.AmNnetModel(jam.AmNnet.init(jtdnn.make_tdnn(39, num_pdfs, 32, 2)), jtri.tm)
    jbundle.am.log_priors = np.log(np.full(num_pdfs, 1.0 / num_pdfs, np.float32))
    jpath = str(tmp_path / "jax.mdl")
    jbundle.save(jpath)
    got = AmNnetModel.load(jpath, device="cpu")
    np.testing.assert_allclose(got.am.loglikes_batch(x).numpy(),
                               np.asarray(jbundle.am.loglikes_batch(x)), atol=1e-4)
    assert np.array_equal(got.tm.tid_to_pdf_array(), jtri.tm.tid_to_pdf_array())
    # the port's own format round trip
    am = AmNnet.init(make_tdnn(39, num_pdfs, 32, 2), device="cpu")
    tpath = str(tmp_path / "port.mdl")
    AmNnetModel(am, got.tm).save(tpath)
    back = AmNnetModel.load(tpath, device="cpu")
    assert torch.equal(back.am.loglikes_batch(x), am.loglikes_batch(x))
    assert np.array_equal(back.tm.log_probs, got.tm.log_probs)
    with pytest.raises(ValueError):
        AmNnetModel.load(os.path.join(WORKDIR, "final.am"), device="cpu")


def test_compressed_matrix_formats_and_bools():
    import old_kaldi_git_tpu.utils.io_funcs as jiof

    m = np.random.default_rng(4).normal(size=(12, 5))
    for fmt in (1, 2, 3):
        a, b = io.BytesIO(), io.BytesIO()
        jiof.write_compressed_matrix(a, m, fmt)
        tiof.write_compressed_matrix(b, m, fmt)
        assert a.getvalue() == b.getvalue()
        got = tiof.read_matrix(io.BufferedReader(io.BytesIO(b.getvalue())))
        assert np.array_equal(got, jiof.read_matrix(io.BytesIO(a.getvalue())))
    f = io.BytesIO()
    tiof.write_bool(f, True)
    tiof.write_int_vector(f, [3, -1, 7])
    assert jiof.read_bool(io.BytesIO(f.getvalue()[:1])) is True
    assert list(jiof.read_int_vector(io.BytesIO(f.getvalue()[1:]))) == [3, -1, 7]
