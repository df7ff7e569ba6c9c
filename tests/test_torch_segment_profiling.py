"""Long-recording segmentation, the arbitrary resampler, utils/profiling.py
and the last public names of the port's modules, against the JAX package on
the CPU.

`segment_by_vad` gives the JAX package's segments on the JAX tests' energy
contours (tests/test_segment.py); `decode_long_recording` on the JAX test's
yes/no recording (20 training and 3 test utterances joined by 0.8 s of
low-level noise; a monophone system the port trains, read by both packages
from its `.mdl`; the JAX package's HCLG) gives the JAX function's segments
exactly and its words.  `arbitrary_resample` within 1e-5 of the JAX
package's, its indices exact.  The profiling helpers on known numbers.
Each name the port lacked until now against its JAX counterpart:
`splice_frames` exactly, `sliding_window_cmn` within 1e-4, the spectra
within 1e-4 of max|ref| (the JAX package's float32 DFT), the Kaldi FST
files byte for byte, `fst_sentence_cost`, the `add_self_loops_from` stub,
`compile_training_graphs` byte for byte, `pad_feats` and `align_utts`
exactly; slow: `export_upstream_artifacts` on 8 utterances, final.mdl byte
for byte and lat.1.gz's archive bytes (the gzip container carries its own
time stamp) equal when both packages decode the same loglikes."""

import tests.torch_threads  # noqa: F401
import gzip
import io
import os
import shutil

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.decoder.viterbi as jvit
import old_kaldi_git_tpu.feat.compute as jcomp
import old_kaldi_git_tpu.feat.functions as jfun
import old_kaldi_git_tpu.feat.resample as jres
import old_kaldi_git_tpu.fst.algorithms as jalg
import old_kaldi_git_tpu.fst.kaldi_fst_io as jkio
import old_kaldi_git_tpu.fst.vector_fst as jvf
import old_kaldi_git_tpu.recipes.gmm_common as jgc
import old_kaldi_git_tpu.recipes.mono as jmono
import old_kaldi_git_tpu.recipes.segment as jseg
import old_kaldi_git_tpu.recipes.yesno as jyes
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.feat.compute as tcomp
import old_kaldi_git_tpu_torch.feat.functions as tfun
import old_kaldi_git_tpu_torch.feat.resample as tres
import old_kaldi_git_tpu_torch.fst.algorithms as talg
import old_kaldi_git_tpu_torch.fst.kaldi_fst_io as tkio
import old_kaldi_git_tpu_torch.fst.vector_fst as tvf
import old_kaldi_git_tpu_torch.recipes.gmm_common as tgc
import old_kaldi_git_tpu_torch.recipes.mono as tmono
import old_kaldi_git_tpu_torch.recipes.segment as tseg
import old_kaldi_git_tpu_torch.recipes.yesno as tyes
from old_kaldi_git_tpu.decoder.csr import fst_to_csr
from old_kaldi_git_tpu.decoder.graph import (
    GraphCompiler as JGraphCompiler, compile_training_graphs as jctg, mkgraph)
from old_kaldi_git_tpu.fst.lang import make_unigram_grammar_fst
from old_kaldi_git_tpu.gmm.diag_gmm import AmGmmModel as JAmGmmModel
from old_kaldi_git_tpu.ivector.vad import VadOptions as JVad
from old_kaldi_git_tpu.recipes.decode import DecodeOptions as JDecodeOptions
from old_kaldi_git_tpu.tree.context_dep import monophone_context_dependency as jmono_cd
from old_kaldi_git_tpu_torch.decoder.graph import compile_training_graphs as tctg
from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel as TAmGmmModel
from old_kaldi_git_tpu_torch.ivector.vad import VadOptions as TVad
from old_kaldi_git_tpu_torch.recipes.decode import DecodeOptions as TDecodeOptions
from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency as tmono_cd
from old_kaldi_git_tpu_torch.utils import log as tlog
from old_kaldi_git_tpu_torch.utils import profiling
from tests.test_torch_chain import WORKDIR, port_graph


def _islands():
    e = np.full(1000, 0.0)
    for s, en in ((100, 250), (400, 560), (800, 950)):
        e[s:en] = 10.0
    e[300:305] = 10.0
    e[560:575] = 0.0
    e[575:590] = 10.0
    return e, dict(pad_sec=0.0)


def _long_speech():
    e = np.full(3000, 10.0)
    e[1500] = 1.0
    return e, dict(max_segment_sec=20.0, pad_sec=0.0)


@pytest.mark.parametrize("contour", [_islands, _long_speech])
def test_segment_by_vad_gives_the_jax_segments(contour):
    e, seg = contour()
    vad = dict(vad_energy_threshold=5.0, vad_energy_mean_scale=0.0)
    want = jseg.segment_by_vad(e, JVad(**vad), jseg.SegmentationOptions(**seg))
    got = tseg.segment_by_vad(e, TVad(**vad), tseg.SegmentationOptions(**seg), device="cpu")
    assert got == want and len(got) in (2, 3)


@pytest.fixture(scope="module")
def yesno_system(tmp_path_factory):
    """A monophone yes/no system trained by the port, read by both packages
    from one .mdl, and the JAX package's graph of the training sentences."""
    tw, tt, sw, st = jyes.make_corpus(20, 3)
    model, _ = tmono.train_mono(tyes.compute_feats(tw, device="cpu"), tt, tyes.make_lang(),
                                tmono.MonoTrainOptions(num_iters=8, totgauss=60),
                                device="cpu")
    path = str(tmp_path_factory.mktemp("yesno") / "mono.mdl")
    model.save(path)
    jmodel = JAmGmmModel.load(path)
    lang = jyes.make_lang()
    phones = lang.real_phone_ids
    topo = jmodel.tm.topo
    cd = jmono_cd(phones, {p: topo.num_pdf_classes(p) for p in phones})
    g = make_unigram_grammar_fst(list(tt.values()), lang.words)
    csr = fst_to_csr(mkgraph(lang, g, cd, jmodel.tm), jmodel.tm.tid_to_pdf_array())
    return dict(jmodel=jmodel, tmodel=TAmGmmModel.load(path, device="cpu"), lang=lang,
                csr=csr, tw=tw, tt=tt, sw=sw, st=st, cd=cd, tmodel_obj=model)


def test_decode_long_recording_gives_the_jax_segments_and_words(yesno_system):
    y = yesno_system
    rng = np.random.default_rng(0)

    def gap():
        return (rng.normal(size=int(0.8 * jyes.SAMP_FREQ)) * 10).astype(np.float32)

    pieces = [gap()]
    for k in sorted(y["sw"]):
        pieces.extend([y["sw"][k], gap()])
    wave = np.concatenate(pieces)
    seg = dict(min_silence_sec=0.4, min_segment_sec=0.3, pad_sec=0.1)
    want = jseg.decode_long_recording(
        y["jmodel"], y["csr"], y["lang"], wave, jyes.SAMP_FREQ, jyes.compute_feats,
        seg_opts=jseg.SegmentationOptions(**seg),
        decode_opts=JDecodeOptions(beam=20.0, acoustic_scale=1.0))
    got = tseg.decode_long_recording(
        y["tmodel"], port_graph(y["csr"]), y["lang"].words, wave, jyes.SAMP_FREQ,
        lambda w: tyes.compute_feats(w, device="cpu"),
        seg_opts=tseg.SegmentationOptions(**seg),
        decode_opts=TDecodeOptions(beam=20.0, acoustic_scale=1.0))
    assert len(got) == len(want) == len(y["sw"])
    for (s, e, words), (js, je, jwords), k in zip(got, want, sorted(y["sw"])):
        assert (s, e) == (js, je)
        assert words == jwords == list(y["st"][k])


def test_training_graphs_pad_feats_and_align_utts(yesno_system, tmp_path):
    y = yesno_system
    keys = sorted(y["tt"])[:6]
    texts = [y["tt"][k] for k in keys]
    tm_t = y["tmodel"].tm
    tlang = tyes.make_lang()
    tcd = tmono_cd(tlang.real_phone_ids,
                   {p: tm_t.topo.num_pdf_classes(p) for p in tlang.real_phone_ids})
    jg = jctg(y["lang"], y["cd"], y["jmodel"].tm, texts)
    tg = tctg(tlang, tcd, tm_t, texts)
    for i, (a, b) in enumerate(zip(jg, tg)):
        jkio.write_fst_kaldi_file(str(tmp_path / f"j{i}.fst"), a)
        tkio.write_fst_kaldi_file(str(tmp_path / f"t{i}.fst"), b)
        assert (tmp_path / f"j{i}.fst").read_bytes() == (tmp_path / f"t{i}.fst").read_bytes()
        back = tkio.read_fst_kaldi_file(str(tmp_path / f"j{i}.fst"))
        assert back.num_states == b.num_states
    feats = jyes.compute_feats({k: y["tw"][k] for k in keys})
    jk, jp, jn = jgc.pad_feats(feats)
    tk, tp, tn = tgc.pad_feats(feats)
    assert jk == tk and np.array_equal(jp, tp) and np.array_equal(jn, tn)
    jcomp_ = JGraphCompiler(y["lang"], y["cd"], y["jmodel"].tm)
    jgraphs = [jcomp_.compile_csr_from_text(t) for t in texts]
    opts = dict(beam=32.0, max_active=7000, acoustic_scale=1.0)
    jali, _ = jmono.align_utts(y["jmodel"].am, jgraphs, jp, jn, jvit.ViterbiOptions(**opts))
    tali, _ = tmono.align_utts(y["tmodel"].am, [port_graph(g) for g in jgraphs], tp, tn,
                               tvit.ViterbiOptions(**opts))
    for a, b in zip(jali, tali):
        assert a is not None and np.array_equal(a, b)


def test_arbitrary_resample_equals_the_jax_package():
    rng = np.random.default_rng(3)
    wave = rng.normal(size=(2, 800)).astype(np.float32)
    points = np.sort(rng.uniform(0.0, 0.1, size=97))
    ji, jw = jres.arbitrary_resample_weights(800, 8000.0, points, 3000.0)
    ti, tw = tres.arbitrary_resample_weights(800, 8000.0, points, 3000.0)
    assert np.array_equal(ji, ti) and np.array_equal(jw, tw)
    want = np.asarray(jres.arbitrary_resample(wave, 8000.0, points))
    got = tres.arbitrary_resample(torch.from_numpy(wave), 8000.0, points)
    assert tuple(got.shape) == (2, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_spectra_splice_and_sliding_cmn_equal_the_jax_package():
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(3, 7, 256)).astype(np.float32)
    jre, jim = (np.asarray(x) for x in jcomp.real_spectrum(frames))
    tre, tim = tcomp.real_spectrum(torch.from_numpy(frames))
    scale = np.abs(jre).max()
    np.testing.assert_allclose(tre.numpy(), jre, atol=1e-4 * scale)
    np.testing.assert_allclose(tim.numpy(), jim, atol=1e-4 * scale)
    jp = np.asarray(jcomp.power_spectrum(frames))
    tp = tcomp.power_spectrum(torch.from_numpy(frames)).numpy()
    assert tp.shape == jp.shape == (3, 7, 128)
    np.testing.assert_allclose(tp, jp, atol=1e-4 * np.abs(jp).max())
    feats = rng.normal(size=(2, 150, 5)).astype(np.float32) * 3 + 1
    x = torch.from_numpy(feats)
    assert np.array_equal(tfun.splice_frames(x, 3, 2).numpy(),
                          np.asarray(jfun.splice_frames(feats, 3, 2)))
    for center, var in ((False, False), (True, True), (False, True)):
        o = dict(cmn_window=40, min_window=10, center=center, normalize_variance=var)
        want = np.asarray(jfun.sliding_window_cmn(feats, jfun.SlidingWindowCmnOptions(**o)))
        got = tfun.sliding_window_cmn(x, tfun.SlidingWindowCmnOptions(**o)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


def _backoff_g(pkg):
    """A small backoff G acceptor (word ids 1-3, backoff label 9) built by
    either package's VectorFst."""
    fst = pkg.VectorFst()
    for _ in range(4):
        fst.add_state()
    fst.set_start(0)
    for s, il, w, ns in ((0, 1, 0.5, 1), (0, 9, 1.25, 3), (1, 2, 0.75, 2), (1, 9, 0.5, 3),
                         (2, 9, 0.25, 3), (3, 1, 2.0, 1), (3, 2, 2.5, 2), (3, 3, 3.0, 3)):
        fst.add_arc(s, pkg.Arc(il, il, w, ns))
    fst.set_final(2, 0.125)
    fst.set_final(3, 1.5)
    return fst


def test_fst_files_sentence_cost_and_the_self_loop_stub(tmp_path):
    jg, tg = _backoff_g(jvf), _backoff_g(tvf)
    jkio.write_fst_kaldi_file(str(tmp_path / "j.fst"), jg)
    tkio.write_fst_kaldi_file(str(tmp_path / "t.fst"), tg)
    raw = (tmp_path / "j.fst").read_bytes()
    assert raw == (tmp_path / "t.fst").read_bytes()
    want = jkio.read_fst_kaldi_arrays(io.BytesIO(raw))
    got = tkio.read_fst_kaldi_arrays(io.BytesIO(raw))
    assert want[0] == got[0]
    for a, b in zip(want[1:], got[1:]):
        assert np.array_equal(a, b)
    back = tkio.read_fst_kaldi_file(str(tmp_path / "j.fst"))
    assert [len(a) for a in back.arcs] == [len(a) for a in tg.arcs]
    for words in ([1, 2], [2], [3, 1, 2], [], [1, 1, 3]):
        assert talg.fst_sentence_cost(tg, words, 9) == jalg.fst_sentence_cost(jg, words, 9)
    with pytest.raises(NotImplementedError):
        jalg.add_self_loops_from(jg)
    with pytest.raises(NotImplementedError):
        talg.add_self_loops_from(tg)


def test_profiling_helpers_on_known_numbers(tmp_path):
    x = torch.ones(64, 64)
    t = profiling.time_jitted(lambda a: a @ a, x, iters=2)
    assert 0 < t < 10
    with profiling.profile("unit-test-section"):
        pass
    assert "unit-test-section\t" in profiling.print_profile(reset=True)
    assert "unit-test-section" not in profiling.print_profile()
    # the card's roofs: ridge 989e12 / 3.35e12 = 295 operations a byte
    r = profiling.roofline(flops=989e12 * 1e-3, bytes_moved=1e6, seconds=2e-3)
    assert r["bound"] == "compute" and r["frac_of_peak"] == pytest.approx(0.5)
    assert r["achieved_tflops"] == pytest.approx(494.5)
    r2 = profiling.roofline(flops=1024, bytes_moved=3.35e9, seconds=1e-2)
    assert r2["bound"] == "memory" and r2["frac_of_peak"] == pytest.approx(0.1)
    assert r2["achieved_gbs"] == pytest.approx(335.0)
    assert (profiling.PEAK_FLOPS_BF16, profiling.PEAK_HBM_BPS) == (989e12, 3.35e12)
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_timer_and_verbose_level():
    timer = tlog.Timer()
    assert timer.elapsed() >= 0.0
    timer.reset()
    assert timer.elapsed() < 5.0
    before = tlog.verbose_level()
    tlog.set_verbose_level(2)
    assert tlog.verbose_level() == 2
    tlog.set_verbose_level(before)


@pytest.mark.slow
def test_export_upstream_artifacts_bytes(tmp_path, monkeypatch):
    import old_kaldi_git_tpu.recipes.minilib as jmini
    from old_kaldi_git_tpu.models.am_nnet import AmNnet as JAmNnet
    from old_kaldi_git_tpu_torch.recipes import minilib as tmini
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet as TAmNnet

    dirs = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        for name in ("tri.mdl", "tree.pkl", "hclg.npz", "final.am", "lang.pkl"):
            os.symlink(os.path.join(WORKDIR, name), d / name)
        dirs[who] = str(d)
    # both packages decode the same loglikes: the JAX package's front end and
    # TDNN forward, handed to the port's search
    lls = {}
    real = JAmNnet.loglikes_batch

    def keep(self, feats):
        out = real(self, feats)
        lls["ll"] = np.asarray(out)
        return out

    monkeypatch.setattr(JAmNnet, "loglikes_batch", keep)
    monkeypatch.setattr(tmini, "compute_feats", lambda waves, device=None: jmini.compute_feats(waves))
    monkeypatch.setattr(TAmNnet, "loglikes_batch",
                        lambda self, feats: torch.from_numpy(lls["ll"]))
    jmini.export_upstream_artifacts(dirs["jax"], num_utts=8)
    report = tmini.export_upstream_artifacts(dirs["port"], num_utts=8, device="cpu")
    a, b = (os.path.join(dirs[w], "final.mdl") for w in ("jax", "port"))
    assert open(a, "rb").read() == open(b, "rb").read()
    with gzip.open(os.path.join(dirs["jax"], "lat.1.gz")) as fa, \
            gzip.open(os.path.join(dirs["port"], "lat.1.gz")) as fb:
        assert fa.read() == fb.read()
    assert report["lat.1.gz"]["cells"] > 0 and report["final.mdl"]["num_pdfs"] == 2000
    shutil.rmtree(tmp_path)
