"""The feature tools of the port's CLI against the JAX package's, on the CPU
(tools in-process, the port's with --device=cpu; the MFCC kernel and the
rest through their plain versions).

Waves: two segments of the shared system's 8 kHz held-out utterances
(tests/torch_cli_system.py), cut by extract-segments.  Features within
1e-3 + 1e-5·max|feature| (the spectrogram there at the bins the JAX
package's float32 DFT resolves, and everywhere within 1e-6 of numpy's
float64 FFT, as tests/test_torch_fbank_plp.py holds it); CMVN statistics in float64 within 1e-9 relative;
pitch: the lag path equal and the features within 1e-4 of max|ref|; VAD
decisions equal; the host tools' archives byte-equal."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import SR, jax_tool, port_tool, system


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_feats_close(j, t):
    assert sorted(j) == sorted(t) and t
    for k in t:
        assert j[k].shape == t[k].shape, k
        tol = 1e-3 + 1e-5 * float(np.abs(j[k]).max())
        assert float(np.abs(j[k] - t[k]).max()) <= tol, k


@pytest.fixture(scope="module")
def s():
    s = system()
    p = s["p"]
    with open(p("fsegments"), "w") as f:
        f.write("a test_0000 0.5 1.5\nb test_0003 1.0 2.3\n")
    for name, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("extract-segments", f"scp:{p('wav.scp')}", p("fsegments"),
                  f"ark,scp:{p(name + 'fw.ark')},{p(name + 'fw.scp')}") == 0
    assert _bytes(p("jfw.ark")) == _bytes(p("tfw.ark"))
    # the port's MFCC and pitch of the segments, input to the later tools
    assert port_tool("compute-mfcc-feats", f"--samp-freq={SR}", "--dither=0",
                     f"scp:{p('tfw.scp')}", f"ark:{p('tmfcc.ark')}") == 0
    assert port_tool("compute-kaldi-pitch-feats", f"--samp-freq={SR}",
                     f"scp:{p('tfw.scp')}", f"ark:{p('tpitch.ark')}") == 0
    return s


def _both(s, tool, opts, src, holder="mat", name=None):
    p = s["p"]
    name = name or tool
    out = {}
    for pre, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn(tool, *opts, *src, f"ark:{p(pre + name)}") == 0
        out[pre] = read_table(f"ark:{p(pre + name)}", holder)
    return out["j"], out["t"]


@pytest.mark.parametrize("tool", ["compute-mfcc-feats", "compute-fbank-feats",
                                  "compute-spectrogram-feats", "compute-plp-feats"])
def test_spectral_feature_tools_equal_the_jax_tools(s, tool):
    j, t = _both(s, tool, [f"--samp-freq={SR}", "--dither=0"], [f"scp:{s['p']('tfw.scp')}"])
    if tool != "compute-spectrogram-feats":
        assert_feats_close(j, t)
        return
    import old_kaldi_git_tpu_torch.feat.compute as tc
    from old_kaldi_git_tpu_torch.feat.window import extract_frames

    opts = tc.SpectrogramOptions()
    opts.frame_opts.samp_freq, opts.frame_opts.dither = SR, 0.0
    for k, w in read_table(f"scp:{s['p']('tfw.scp')}", "wav").items():
        frames, log_energy = extract_frames(torch.from_numpy(w.data[0]).double(),
                                            opts.frame_opts)
        power = np.abs(np.fft.rfft(frames.numpy(), axis=-1)) ** 2
        ref64 = np.log(np.maximum(power, tc.EPSILON))
        ref64[..., 0] = log_energy.numpy()
        np.testing.assert_allclose(t[k], ref64, atol=1e-6 * np.abs(ref64).max(), rtol=1e-6)
        resolved = power >= 1e-6 * power.max(axis=-1, keepdims=True)
        resolved[..., 0] = True
        tol = 1e-3 + 1e-5 * np.abs(j[k]).max()
        assert np.abs(t[k] - j[k])[resolved].max() <= tol


def test_pitch_tools_equal_the_jax_tools(s):
    p = s["p"]
    j, t = _both(s, "compute-kaldi-pitch-feats", [f"--samp-freq={SR}"],
                 [f"scp:{p('tfw.scp')}"])
    for k in t:
        assert t[k].shape == j[k].shape and t[k].shape[1] == 2
        assert np.array_equal(t[k][:, 1], j[k][:, 1]), "lag path"
        assert np.abs(t[k] - j[k]).max() <= 1e-4 * np.abs(j[k]).max()
    j2, t2 = _both(s, "process-kaldi-pitch-feats", [], [f"ark:{p('tpitch.ark')}"])
    for k in t2:
        assert t2[k].shape == j2[k].shape and t2[k].shape[1] == 3
        assert np.abs(t2[k] - j2[k]).max() <= 1e-4 * np.abs(j2[k]).max()


def test_lag_viterbi_and_pitch_postprocessing_equal_the_jax_package():
    """The lag track on random NCCF fronts, batched, equal; the POV and
    normalisation on random (nccf, pitch) within 1e-5."""
    import jax.numpy as jnp

    import old_kaldi_git_tpu.feat.pitch as jp
    import old_kaldi_git_tpu_torch.feat.pitch as tp

    rng = np.random.default_rng(0)
    nccf = rng.uniform(-1, 1, (3, 57, 71)).astype(np.float32)
    lags = np.log(np.arange(10, 81, dtype=np.float64))
    pen = (0.1 * np.square(lags[:, None] - lags[None, :]) * 40.0).astype(np.float32)
    a = np.asarray(jp._lag_viterbi(jnp.asarray(nccf), jnp.asarray(pen)))
    b = tp._lag_viterbi(torch.from_numpy(nccf), torch.from_numpy(pen)).numpy()
    assert np.array_equal(a, b)
    pitch = np.stack([rng.uniform(-1, 1, (2, 200)), rng.uniform(60, 390, (2, 200))],
                     axis=-1).astype(np.float32)
    np.testing.assert_allclose(tp.process_pitch(torch.from_numpy(pitch)).numpy(),
                               np.asarray(jp.process_pitch(jnp.asarray(pitch))), atol=1e-5)


def test_cmvn_stats_apply_and_deltas_equal_the_jax_tools(s):
    p = s["p"]
    mf = [f"ark:{p('tmfcc.ark')}"]
    with open(p("spk2utt"), "w") as f:
        f.write("spk a b\n")
    with open(p("utt2spk"), "w") as f:
        f.write("a spk\nb spk\n")
    for opts, name in (([], "cmvn_utt"), ([f"--spk2utt={p('spk2utt')}"], "cmvn_spk")):
        j, t = _both(s, "compute-cmvn-stats", opts, mf, name=name)
        assert sorted(j) == sorted(t) and t
        for k in t:  # float64 statistics, written as float32 matrices by both
            np.testing.assert_allclose(t[k], j[k], rtol=1.2e-7, atol=0)
    for opts, stats in (([], "cmvn_utt"), (["--norm-vars=true", f"--utt2spk={p('utt2spk')}"],
                                           "cmvn_spk")):
        j, t = _both(s, "apply-cmvn", opts, [f"ark:{p('t' + stats)}", *mf], name="cmvn_applied")
        assert_feats_close(j, t)
    j, t = _both(s, "add-deltas", [], [f"ark:{p('tcmvn_applied')}"])
    assert_feats_close(j, t)


def test_cmvn_statistics_in_float64_equal_the_jax_packages(s):
    import old_kaldi_git_tpu.feat.cmvn as jcmvn
    import old_kaldi_git_tpu_torch.feat.cmvn as tcmvn

    feats = s["feats"]
    w = np.random.default_rng(4).uniform(0, 1, len(feats["test_0001"]))
    for k, f in feats.items():
        a = jcmvn.acc_cmvn_stats(f)
        b = tcmvn.acc_cmvn_stats(torch.from_numpy(f))
        assert b.dtype == a.dtype == np.float64
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tcmvn.acc_cmvn_stats(feats["test_0001"], w),
                               jcmvn.acc_cmvn_stats(feats["test_0001"], w), rtol=1e-9, atol=0)
    st = tcmvn.sum_cmvn_stats([tcmvn.acc_cmvn_stats(f) for f in feats.values()])
    for nv in (False, True):
        for x, y in zip(tcmvn.cmvn_shift_scale(st, nv), jcmvn.cmvn_shift_scale(st, nv)):
            assert np.array_equal(x, y)


def test_the_cli_front_end_equals_compute_utterance_feats(s):
    """compute-mfcc-feats → compute-cmvn-stats → apply-cmvn → add-deltas gives
    the library's compute_utterance_feats(..., deltas=True) on the same
    waves, within the front-end rule."""
    from old_kaldi_git_tpu_torch.feat.compute import compute_utterance_feats

    p = s["p"]
    steps = [("compute-mfcc-feats", [f"--samp-freq={SR}", "--dither=0", f"scp:{p('wav.scp')}"],
              "c1"),
             ("compute-cmvn-stats", ["ark:c1"], "c2"),
             ("apply-cmvn", ["ark:c2", "ark:c1"], "c3"),
             ("add-deltas", ["ark:c3"], "c4")]
    for tool, args, out in steps:
        args = [a.replace("ark:c", f"ark:{p('c')}") for a in args]
        assert port_tool(tool, *args, f"ark:{p(out)}") == 0
    got = read_table(f"ark:{p('c4')}", "mat")
    waves = read_table(f"scp:{p('wav.scp')}", "wav")
    want = compute_utterance_feats({k: w.data[0] for k, w in waves.items()}, SR, "cpu")
    assert_feats_close(want, got)


def test_host_feature_tools_write_the_jax_tools_archives(s):
    p = s["p"]
    mf = f"ark:{p('tmfcc.ark')}"
    pi = f"ark:{p('tpitch.ark')}"
    runs = [("splice-feats", ["--left-context=2", "--right-context=1", mf]),
            ("copy-feats", ["--compress=true", mf]),
            ("paste-feats", [mf, pi]),
            ("select-feats", ["0-3,7", mf]),
            ("subsample-feats", ["--n=3", "--offset=1", mf])]
    for tool, args in runs:
        for pre, fn in (("j", jax_tool), ("t", port_tool)):
            assert fn(tool, *args, f"ark:{p(pre + tool)}") == 0
        assert _bytes(p("j" + tool)) == _bytes(p("t" + tool)), tool
        assert len(_bytes(p("t" + tool))) > 1000


def test_compute_vad_equals_the_jax_tool(s):
    from old_kaldi_git_tpu_torch.ivector.vad import VadOptions, compute_vad_energy
    import old_kaldi_git_tpu.ivector.vad as jvad

    p = s["p"]
    j, t = _both(s, "compute-vad", ["--vad-energy-threshold=0", "--vad-energy-mean-scale=1",
                                    "--vad-frames-context=2"],
                 [f"ark:{p('tmfcc.ark')}"], holder="vec")
    assert all(np.array_equal(j[k], t[k]) for k in t)
    assert 0 < sum(v.sum() for v in t.values()) < sum(len(v) for v in t.values())
    e = np.random.default_rng(1).normal(0, 3, (3, 50)).astype(np.float32)
    o = VadOptions(vad_energy_threshold=0.0, vad_frames_context=3)
    nf = np.asarray([50, 31, 7])
    a = np.asarray(jvad.compute_vad_energy(e, jvad.VadOptions(0.0, 0.5, 3, 0.6), nf))
    b = compute_vad_energy(torch.from_numpy(e), o, torch.from_numpy(nf)).numpy()
    assert np.array_equal(a, b)


def test_wav_reverberate_writes_the_jax_tools_archive(s):
    from old_kaldi_git_tpu_torch.utils.wav import WaveData, write_wav

    p = s["p"]
    rng = np.random.default_rng(2)
    rir = np.exp(-np.arange(400) / 60.0) * rng.normal(size=400)
    rir[5] = 3.0
    write_wav(p("rir.wav"), (1000 * rir).astype(np.float32), SR)
    with TableWriter(f"ark:{p('noise.ark')}", "wav") as w:
        w["a"] = WaveData(samp_freq=SR, data=(300 * rng.normal(size=(1, 4000))).astype(np.float32))
    args = [f"--impulse-response={p('rir.wav')}", f"--additive-noise=ark:{p('noise.ark')}",
            "--snr-db=10", "--seed=7", f"scp:{p('tfw.scp')}"]
    for pre, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("wav-reverberate", *args, f"ark:{p(pre + 'rev.ark')}") == 0
    assert _bytes(p("jrev.ark")) == _bytes(p("trev.ark"))
    assert len(read_table(f"ark:{p('trev.ark')}", "wav")) == 2
