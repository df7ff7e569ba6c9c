"""The 30 speaker-ID tools of the port (bin/spkid_tools.py) against the JAX
package's, on the CPU (the port's tensor tools with --device=cpu), in
process.

The corpus is the generator of the JAX package's tests/test_spkid_cli.py
(cluster centres, a speaker offset in a low-rank basis, noise; 6 speakers
of 5 utterances of 150 frames, seed 0).  The JAX package scores gselect and
the full-covariance E-step in float32; here it is handed its own float64
scoring there (as tests/test_torch_ivector_train.py does), so that both
packages compute the same float64 arithmetic.  Text, integer and vector
files are held byte for byte, each package reading the other's inputs;
float64 statistics and models within 1e-9 of each array's largest
magnitude (the float32 UBM files within 1e-6 relative); iVectors within
1e-4 relative.  The chain ends where the JAX test ends: EER under 0.15 and
logistic-regression accuracy over 0.8."""

import tests.torch_threads  # noqa: F401

import io
import os

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.gmm.diag_gmm as jdg
import old_kaldi_git_tpu.gmm.full_gmm as jfg
from old_kaldi_git_tpu_torch.bin.spkid_tools import _load_gmm, compute_eer, read_ie_accs
from old_kaldi_git_tpu_torch.gmm.full_gmm import AccumFullGmm
from old_kaldi_git_tpu_torch.gmm.mle import AccumDiagGmm
from old_kaldi_git_tpu_torch.ivector.extractor import IvectorExtractor
from old_kaldi_git_tpu_torch.ivector.logistic_regression import LogisticRegression
from old_kaldi_git_tpu_torch.ivector.plda import Plda
from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import jax_tool, port_tool, read_bytes, run

TOL = 1e-9
MODEL_RTOL = 1e-6
IVEC_REL = 1e-4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(autouse=True)
def float64_reference(monkeypatch):
    monkeypatch.setattr(jfg.FullGmm, "component_loglikes_batch",
                        jfg.FullGmm.component_loglikes)
    monkeypatch.setattr(jdg.DiagGmm, "component_loglikes_batch",
                        jdg.DiagGmm.component_loglikes, raising=False)


@pytest.fixture(scope="module")
def c(tmp_path_factory):
    root = tmp_path_factory.mktemp("spkid_cli")
    p = lambda *a: os.path.join(root, *a)  # noqa: E731
    rng = np.random.default_rng(0)
    dim, num_spk, per_spk = 8, 6, 5
    clusters = rng.standard_normal((5, dim)) * 3.0
    basis = rng.standard_normal((2, dim))
    spk_off = rng.standard_normal((num_spk, 2)) @ basis * 0.8
    utt2spk, feats = {}, {}
    with TableWriter(f"ark:{p('feats.ark')}", "mat") as w:
        for s in range(num_spk):
            for u in range(per_spk):
                key = f"s{s}-u{u}"
                which = rng.integers(0, 5, size=150)
                feats[key] = w[key] = (clusters[which] + spk_off[s] + 0.6 * rng.standard_normal(
                    (150, dim))).astype(np.float32)
                utt2spk[key] = f"s{s}"
    with open(p("utt2spk"), "w") as f:
        f.writelines(f"{u} {s}\n" for u, s in sorted(utt2spk.items()))
    spk2utt = {}
    for u, s in utt2spk.items():
        spk2utt.setdefault(s, []).append(u)
    with open(p("spk2utt"), "w") as f:
        f.writelines(f"{s} {' '.join(sorted(us))}\n" for s, us in sorted(spk2utt.items()))
    return {"p": p, "feats": f"ark:{p('feats.ark')}", "utt2spk": utt2spk, "spk2utt": spk2utt,
            "x": feats}


def both(name, *argv, rc=0):
    """The tool in each package, "{out}" → jax / port in the arguments."""
    for pre, fn in (("jax", jax_tool), ("port", port_tool)):
        got = fn(name, *[a.replace("{out}", pre) for a in argv])
        assert got == rc, f"{pre} {name} exited {got}"


def _diag_close(a, b, rtol):
    for f in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(_load_gmm(a), f), getattr(_load_gmm(b), f),
                                   rtol=rtol, atol=0)


def _full_close(a, b, rtol):
    for f in ("weights", "means", "covars"):
        x, y = getattr(_load_gmm(a), f), getattr(_load_gmm(b), f)
        assert rel(x, y) <= rtol, f


def _accs(path, kind):
    with open(path, "rb") as f:
        a = (AccumDiagGmm if kind == "diag" else AccumFullGmm).read(io.BufferedReader(f), "cpu")
    second = a.var_acc if kind == "diag" else a.cov_acc
    return [a.occ.numpy(), a.mean_acc.numpy(), second.numpy(),
            np.asarray([float(a.tot_like), a.tot_frames])]


def _accs_close(a, b, kind):
    for x, y in zip(_accs(a, kind), _accs(b, kind)):
        assert rel(x, y) <= TOL


def _vecs(path):
    return {k: np.asarray(v) for k, v in read_table(f"ark:{path}", "vec").items()}


def test_diagonal_ubm_tools(c, capsys):
    """init-from-feats, gselect, acc-stats (with and without gselect),
    sum-accs across the packages, est with --mix-up, info, to-fgmm and
    back."""
    p = c["p"]
    both("gmm-global-init-from-feats", "--num-gauss=8", "--num-iters=4", c["feats"],
         p("{out}_ubm0"))
    _diag_close(p("port_ubm0"), p("jax_ubm0"), MODEL_RTOL)
    both("gmm-gselect", "--n=4", p("jax_ubm0"), c["feats"], f"ark:{p('{out}_gsel.ark')}")
    assert read_bytes(p("port_gsel.ark")) == read_bytes(p("jax_gsel.ark"))
    both("gmm-global-acc-stats", f"--gselect=ark:{p('jax_gsel.ark')}", p("jax_ubm0"),
         c["feats"], p("{out}_g.acc"))
    _accs_close(p("port_g.acc"), p("jax_g.acc"), "diag")
    both("gmm-global-acc-stats", p("jax_ubm0"), c["feats"], p("{out}_nog.acc"))
    _accs_close(p("port_nog.acc"), p("jax_nog.acc"), "diag")
    assert jax_tool("gmm-global-sum-accs", p("jax_sum_of_port.acc"), p("port_g.acc"),
                    p("port_nog.acc")) == 0
    assert port_tool("gmm-global-sum-accs", p("port_sum_of_jax.acc"), p("jax_g.acc"),
                     p("jax_nog.acc")) == 0
    _accs_close(p("port_sum_of_jax.acc"), p("jax_sum_of_port.acc"), "diag")
    both("gmm-global-est", "--mix-up=10", p("jax_ubm0"), p("jax_sum_of_port.acc"),
         p("{out}_ubm1"))
    _diag_close(p("port_ubm1"), p("jax_ubm1"), MODEL_RTOL)
    assert _load_gmm(p("port_ubm1")).num_mix == 10
    for pre, fn in (("jax", jax_tool), ("port", port_tool)):
        rc, out = run(capsys, fn, "gmm-global-info", p("jax_ubm1"))
        assert rc == 0
        c.setdefault("info", []).append(out)
    assert c["info"][0] == c["info"][1] and "covariance type diag" in c["info"][0]
    both("gmm-global-to-fgmm", p("jax_ubm1"), p("{out}_ubm1.full"))
    assert read_bytes(p("port_ubm1.full")) == read_bytes(p("jax_ubm1.full"))
    both("fgmm-global-to-gmm", p("jax_ubm1.full"), p("{out}_back.diag"))
    assert read_bytes(p("port_back.diag")) == read_bytes(p("jax_back.diag"))


def test_gmm_global_get_post(c):
    """The top-3 posteriors of every frame: the same Gaussians in the same
    order, values within 1e-6 (float32 in the archive)."""
    p = c["p"]
    both("gmm-global-get-post", "--n=3", p("jax_ubm1"), c["feats"],
         f"ark:{p('{out}_post.ark')}")
    j = read_table(f"ark:{p('jax_post.ark')}", "post")
    t = read_table(f"ark:{p('port_post.ark')}", "post")
    assert list(j) == list(t)
    for k in j:
        for fj, ft in zip(j[k], t[k]):
            assert [g for g, _ in fj] == [g for g, _ in ft]
            assert np.allclose([x for _, x in fj], [x for _, x in ft], atol=1e-6, rtol=0)
            assert abs(sum(x for _, x in ft) - 1.0) < 1e-4 and len(ft) <= 3


def test_full_ubm_tools(c, capsys):
    """fgmm-gselect, fgmm-global-acc-stats (gselect), sum-accs across the
    packages, fgmm-global-est, fgmm-global-info."""
    p = c["p"]
    both("fgmm-gselect", "--n=4", p("jax_ubm1.full"), c["feats"],
         f"ark:{p('{out}_gself.ark')}")
    assert read_bytes(p("port_gself.ark")) == read_bytes(p("jax_gself.ark"))
    both("fgmm-global-acc-stats", f"--gselect=ark:{p('jax_gself.ark')}", p("jax_ubm1.full"),
         c["feats"], p("{out}_f.acc"))
    _accs_close(p("port_f.acc"), p("jax_f.acc"), "full")
    assert jax_tool("fgmm-global-sum-accs", p("jax_fsum.acc"), p("port_f.acc")) == 0
    assert port_tool("fgmm-global-sum-accs", p("port_fsum.acc"), p("jax_f.acc")) == 0
    _accs_close(p("port_fsum.acc"), p("jax_fsum.acc"), "full")
    both("fgmm-global-est", "--min-gaussian-occupancy=3", p("jax_ubm1.full"),
         p("jax_fsum.acc"), p("{out}_final.ubm"))
    _full_close(p("port_final.ubm"), p("jax_final.ubm"), MODEL_RTOL)
    outs = [run(capsys, fn, "fgmm-global-info", p("jax_final.ubm"))
            for fn in (jax_tool, port_tool)]
    assert outs[0] == outs[1] and "covariance type full" in outs[0][1]


def test_ivector_extractor_tools(c):
    """init (byte for byte), two rounds of acc-stats (1e-9), sum-accs
    across the packages and est (T within 1e-9), on the JAX UBM."""
    p = c["p"]
    both("ivector-extractor-init", "--ivector-dim=4", p("jax_final.ubm"), p("{out}_ie.0"))
    assert read_bytes(p("port_ie.0")) == read_bytes(p("jax_ie.0"))
    for it in range(2):
        both("ivector-extractor-acc-stats", p(f"jax_ie.{it}"), c["feats"],
             p(f"{{out}}_ie.acc.{it}"))
        for x, y in zip(read_ie_accs(p(f"port_ie.acc.{it}")), read_ie_accs(p(f"jax_ie.acc.{it}"))):
            assert rel(x, y) <= TOL
        assert jax_tool("ivector-extractor-sum-accs", p(f"jax_ie.sum.{it}"),
                        p(f"port_ie.acc.{it}")) == 0
        assert port_tool("ivector-extractor-sum-accs", p(f"port_ie.sum.{it}"),
                         p(f"jax_ie.acc.{it}")) == 0
        assert read_bytes(p(f"port_ie.sum.{it}")) == read_bytes(p(f"jax_ie.acc.{it}"))
        both("ivector-extractor-est", p(f"jax_ie.{it}"), p(f"jax_ie.sum.{it}"),
             p(f"{{out}}_ie.{it + 1}"))
        T = [IvectorExtractor.load(p(f"{w}_ie.{it + 1}"), "cpu").T.numpy() for w in ("port", "jax")]
        assert rel(T[0], T[1]) <= TOL


def test_ivector_extract(c):
    """Per utterance and, with --spk2utt, per speaker (pooled statistics):
    1e-4 relative."""
    p = c["p"]
    both("ivector-extract", p("jax_ie.2"), c["feats"], f"ark:{p('{out}_ivec.ark')}")
    j, t = _vecs(p("jax_ivec.ark")), _vecs(p("port_ivec.ark"))
    assert list(j) == list(t) and len(j) == 30
    assert rel(np.stack(list(t.values())), np.stack(list(j.values()))) <= IVEC_REL
    both("ivector-extract", f"--spk2utt={p('spk2utt')}", p("jax_ie.2"), c["feats"],
         f"ark:{p('{out}_spkivec.ark')}")
    j, t = _vecs(p("jax_spkivec.ark")), _vecs(p("port_spkivec.ark"))
    assert list(j) == list(t) and len(j) == 6
    assert rel(np.stack(list(t.values())), np.stack(list(j.values()))) <= IVEC_REL


def test_ivector_post_processing_is_the_jax_tools_bytes(c):
    """mean (both forms), subtract-global-mean (both forms),
    normalize-length, compute-lda (1e-9) and transform on the JAX package's
    iVectors: vector, mean and count files byte for byte."""
    p = c["p"]
    iv = f"ark:{p('jax_ivec.ark')}"
    both("ivector-mean", p("spk2utt"), iv, f"ark:{p('{out}_spk.ark')}",
         f"ark,t:{p('{out}_n.txt')}")
    both("ivector-mean", iv, p("{out}_global.mean"))
    both("ivector-subtract-global-mean", p("jax_global.mean"), iv, f"ark:{p('{out}_c.ark')}")
    both("ivector-subtract-global-mean", iv, f"ark:{p('{out}_c2.ark')}")
    both("ivector-normalize-length", f"ark:{p('jax_c.ark')}", f"ark:{p('{out}_nrm.ark')}")
    both("ivector-normalize-length", "--scaleup=false", f"ark:{p('jax_c.ark')}",
         f"ark:{p('{out}_nrm1.ark')}")
    for name in ("spk.ark", "n.txt", "global.mean", "c.ark", "c2.ark", "nrm.ark", "nrm1.ark"):
        assert read_bytes(p("port_" + name)) == read_bytes(p("jax_" + name)), name
    normed = _vecs(p("port_nrm.ark"))
    assert all(abs(np.linalg.norm(v) - 2.0) < 1e-4 for v in normed.values())
    both("ivector-compute-lda", "--dim=2", f"ark:{p('jax_nrm.ark')}", p("utt2spk"),
         p("{out}_lda.mat"))
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    mats = []
    for w in ("port", "jax"):
        with open(p(f"{w}_lda.mat"), "rb") as f:
            iof.init_kaldi_input_stream(f)
            mats.append(iof.read_matrix(f))
    assert mats[0].shape == (2, 4) and rel(mats[0], mats[1]) <= TOL
    both("ivector-transform", p("jax_lda.mat"), f"ark:{p('jax_nrm.ark')}",
         f"ark:{p('{out}_l.ark')}")
    assert read_bytes(p("port_l.ark")) == read_bytes(p("jax_l.ark"))


def test_plda_scoring_and_eer(c, capsys):
    """compute-plda (1e-9), plda-scoring of every speaker against every
    utterance (the score lines byte for byte on the JAX model), compute-eer
    (its output equal), the EER under 0.15; no trials exits 1."""
    p = c["p"]
    nrm = f"ark:{p('jax_nrm.ark')}"
    both("ivector-compute-plda", p("spk2utt"), nrm, p("{out}.plda"))
    a, b = Plda.load(p("port.plda")), Plda.load(p("jax.plda"))
    for f in ("mean", "transform", "psi"):
        assert rel(getattr(a, f), getattr(b, f)) <= TOL, f
    both("ivector-mean", p("spk2utt"), nrm, f"ark:{p('{out}_enroll.ark')}",
         f"ark:{p('{out}_enroll_n.ark')}")
    with open(p("trials"), "w") as f:
        f.writelines(f"{s} {u}\n" for u in sorted(c["utt2spk"]) for s in sorted(c["spk2utt"]))
    both("ivector-plda-scoring", f"--num-utts=ark:{p('jax_enroll_n.ark')}", p("jax.plda"),
         f"ark:{p('jax_enroll.ark')}", nrm, p("trials"), p("{out}_scores"))
    assert read_bytes(p("port_scores")) == read_bytes(p("jax_scores"))
    with open(p("port_scores")) as f, open(p("eer_in"), "w") as out:
        for ln in f:
            s, u, score = ln.split()
            out.write(f"{score} {'target' if c['utt2spk'][u] == s else 'nontarget'}\n")
    outs = [run(capsys, fn, "compute-eer", p("eer_in")) for fn in (jax_tool, port_tool)]
    assert outs[0] == outs[1]
    assert float(outs[1][1]) < 15.0
    tgt, non = [], []
    for ln in open(p("eer_in")):
        sc, kind = ln.split()
        (tgt if kind == "target" else non).append(float(sc))
    assert compute_eer(np.asarray(tgt), np.asarray(non))[0] < 0.15
    with open(p("no_trials"), "w") as f:
        f.write("nobody nothing\n")
    both("ivector-plda-scoring", p("jax.plda"), f"ark:{p('jax_enroll.ark')}", nrm,
         p("no_trials"), p("{out}_none"), rc=1)


def test_logistic_regression_tools(c):
    """train with mix-up (weights within 1e-9, the same rows), eval of each
    package's model by the other (log-posteriors byte for byte), accuracy
    over 0.8."""
    p = c["p"]
    nrm = f"ark:{p('jax_nrm.ark')}"
    both("logistic-regression-train", "--max-steps=150", "--mix-up=8", nrm, p("utt2spk"),
         p("{out}_lr.mdl"))
    a, b = LogisticRegression.load(p("port_lr.mdl")), LogisticRegression.load(p("jax_lr.mdl"))
    assert (a.row_to_class == b.row_to_class).all() and rel(a.weights, b.weights) <= TOL
    assert jax_tool("logistic-regression-eval", p("port_lr.mdl"), nrm,
                    f"ark:{p('jax_post_of_port.ark')}") == 0
    assert port_tool("logistic-regression-eval", p("port_lr.mdl"), nrm,
                     f"ark:{p('port_post_of_port.ark')}") == 0
    assert read_bytes(p("port_post_of_port.ark")) == read_bytes(p("jax_post_of_port.ark"))
    both("logistic-regression-eval", p("jax_lr.mdl"), nrm, f"ark:{p('{out}_lrpost.ark')}")
    assert read_bytes(p("port_lrpost.ark")) == read_bytes(p("jax_lrpost.ark"))
    labels = sorted(set(c["utt2spk"].values()))
    post = _vecs(p("port_lrpost.ark"))
    acc = np.mean([labels[int(v.argmax())] == c["utt2spk"][k] for k, v in post.items()])
    assert acc > 0.8 and all(abs(np.exp(v).sum() - 1) < 1e-3 for v in post.values())


def test_select_voiced_frames(c):
    p = c["p"]
    keys = sorted(c["x"])[:3]
    with TableWriter(f"ark:{p('vad.ark')}", "vec") as w:
        for i, k in enumerate(keys[:2]):
            vad = np.zeros(150, np.float32)
            vad[10 + i: 60 + 3 * i] = 1.0
            w[k] = vad
    both("select-voiced-frames", c["feats"], f"ark:{p('vad.ark')}", f"ark:{p('{out}_v.ark')}")
    assert read_bytes(p("port_v.ark")) == read_bytes(p("jax_v.ark"))
    got = read_table(f"ark:{p('port_v.ark')}", "mat")
    assert list(got) == keys[:2]
    np.testing.assert_array_equal(got[keys[0]], c["x"][keys[0]][10:60])


def test_usage_errors_exit_1():
    for name in ("gmm-global-init-from-feats", "gmm-gselect", "ivector-extract",
                 "ivector-mean", "compute-eer", "logistic-regression-eval"):
        assert jax_tool(name) == 1 and port_tool(name) == 1, name
    assert torch.get_num_threads() == 2


class _Pipe(io.RawIOBase):
    """A non-seekable byte stream, as a pipe's."""

    def __init__(self, data: bytes):
        self._b = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, buf):
        return self._b.readinto(buf)


def test_a_binary_header_across_the_read_buffer(tmp_path):
    """An archive of 8,192 entries of 25 bytes puts a binary header "\\0B"
    across every buffer edge of 4 and 8 KiB: read from a file, the port
    reads every entry as the JAX package does (it misread the first such
    entry as text before).  On a stream that cannot seek (a pipe), both
    packages see only the buffer's "\\0" and take the object for text
    (ROADMAP queue 3)."""
    import old_kaldi_git_tpu.utils.io_funcs as jio
    import old_kaldi_git_tpu.utils.table as jtable
    from old_kaldi_git_tpu_torch.utils import io_funcs as pio

    path = str(tmp_path / "small.ark")
    with TableWriter(f"ark:{path}", "mat") as w:
        for i in range(8192):
            w[f"k{i:04d}"] = np.full((1, 1), i, np.float32)
    got = read_table(f"ark:{path}", "mat")
    want = dict(jtable.SequentialTableReader(f"ark:{path}", "mat"))
    assert list(got) == list(want) and len(got) == 8192
    assert all(float(got[k][0, 0]) == float(want[k][0, 0]) == i for i, k in enumerate(got))
    data = b"x" * 4095 + b"\0BFM " + b"\4" + (1).to_bytes(4, "little") + b"\4" + (
        1).to_bytes(4, "little") + np.float32(7).tobytes()
    for mod, pipe_binary in ((jio, False), (pio, False)):
        for stream, binary in ((io.BufferedReader(io.BytesIO(data), 4096), True),
                               (io.BufferedReader(_Pipe(data), 4096), pipe_binary)):
            stream.read(4095)
            assert mod.init_kaldi_input_stream(stream) == binary, (mod.__name__, stream)
