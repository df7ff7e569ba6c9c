"""The port's LDA, MLLT and fMLLR tools against the JAX package's, on the CPU
(the port's tensor tools with --device=cpu).

tri.mdl's equal alignments of the 4 utterances of the shared system
(tests/torch_cli_system.py) as posteriors, silence weighted, two speakers
of two utterances; MLLT and fMLLR in a 13-dimensional LDA space with a
single-Gaussian model on tri.mdl's tree (tests/torch_cli_system.py
lda_system), as train_lda_mllt.sh and train_sat.sh run them (on the raw 39
dimensions both packages' MLLT cofactor iteration meets a singular matrix,
and the JAX fMLLR's 39-row solves take seconds).  The float64 statistics
files of acc-lda and gmm-acc-mllt are within 1e-9 of each array's largest
magnitude of the JAX tools'; est-lda, est-mllt, gmm-transform-means,
transform-feats and compose-transforms on the same input files write the
JAX tools' bytes (the solves and products are host numpy in both
packages), and on the other package's statistics their float32 matrices
agree within 1e-6·max|ref|; gmm-est-fmllr's and gmm-est-fmllr-gpost's
float32 transforms (every speaker's solve on the device here, float64 numpy
row by row there) within 1e-5·max|ref|; gmm-post-to-gpost's float32
Gaussian posteriors within 1e-6."""

import tests.torch_threads  # noqa: F401

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.bin.train_tools import read_arrays
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import both, jax_tool, lda_system, port_tool, read_bytes

REL = 1e-9
MAT_REL = 1e-6
FMLLR_REL = 1e-5


def _mat(path):
    from old_kaldi_git_tpu_torch.bin.train_tools import _read_mat

    return _read_mat(path)


def _rel_gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def s():
    return lda_system()


def test_acc_lda_and_est_lda(s):
    p = s["p"]
    both("acc-lda", s["tri"], s["feats_r"], s["wpost"], p("{out}.lacc"))
    j, t = read_arrays(p("jax.lacc"), "LdaAccs"), read_arrays(p("port.lacc"), "LdaAccs")
    for k in ("counts", "first", "second"):
        assert j[k].shape == t[k].shape and _rel_gap(t[k], j[k]) <= REL, k
    for acc in ("jax.lacc", "port.lacc"):
        both("est-lda", "--dim=20", p(acc), p(acc), p("{out}_" + acc + ".mat"))
        assert read_bytes(p("jax_" + acc + ".mat")) == read_bytes(p("port_" + acc + ".mat"))
    m = _mat(p("port_port.lacc.mat"))
    assert m.shape == (20, 39) and _rel_gap(m, _mat(p("jax_jax.lacc.mat"))) <= MAT_REL


def test_gmm_acc_mllt_est_mllt_and_transform_means(s):
    p = s["p"]
    both("gmm-acc-mllt", s["lda_mdl"], s["lda_feats"], s["wpost"], p("{out}.macc"))
    j, t = read_arrays(p("jax.macc"), "MlltAccs"), read_arrays(p("port.macc"), "MlltAccs")
    assert _rel_gap(t["G"], j["G"]) <= REL
    assert abs(t["beta"][0] - j["beta"][0]) <= REL * j["beta"][0]
    both("est-mllt", p("jax.macc"), p("port.macc"), p("{out}_mllt.mat"))
    assert read_bytes(p("jax_mllt.mat")) == read_bytes(p("port_mllt.mat"))
    assert port_tool("est-mllt", p("port.macc"), p("port_own_mllt.mat")) == 0
    assert jax_tool("est-mllt", p("jax.macc"), p("jax_own_mllt.mat")) == 0
    assert _rel_gap(_mat(p("port_own_mllt.mat")), _mat(p("jax_own_mllt.mat"))) <= MAT_REL
    both("gmm-transform-means", p("jax_mllt.mat"), s["lda_mdl"], p("{out}_mllt.mdl"))
    assert read_bytes(p("jax_mllt.mdl")) == read_bytes(p("port_mllt.mdl"))


def test_transform_feats_and_compose_transforms(s):
    """A linear (LDA), an affine (composed) and per-speaker transforms."""
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_output_stream, write_matrix
    from old_kaldi_git_tpu_torch.utils.table import TableWriter

    p = s["p"]
    rng = np.random.default_rng(5)
    for name, cols in (("x_lin.mat", 39), ("x_aff.mat", 40)):
        with open(p(name), "wb") as f:
            init_kaldi_output_stream(f, True)
            write_matrix(f, np.eye(39, cols) + 0.01 * rng.normal(size=(39, cols)))
    with TableWriter(f"ark:{p('x_spk.ark')}", "mat") as w:
        for i, spk in enumerate(("spkA", "spkB")):
            w[spk] = np.concatenate([np.eye(39) * (1 + 0.1 * i), np.full((39, 1), 0.5 * i)], 1)
    both("compose-transforms", p("x_lin.mat"), p("x_aff.mat"), p("{out}_comp.mat"))
    both("compose-transforms", p("x_aff.mat"), p("x_lin.mat"), p("{out}_comp2.mat"))
    for name in ("comp.mat", "comp2.mat"):
        assert read_bytes(p("jax_" + name)) == read_bytes(p("port_" + name))
    both("transform-feats", p("port_comp.mat"), s["feats_r"], f"ark:{p('{out}_tf.ark')}")
    both("transform-feats", f"--utt2spk={s['utt2spk']}", f"ark:{p('x_spk.ark')}", s["feats_r"],
         f"ark:{p('{out}_tfs.ark')}")
    for name in ("tf.ark", "tfs.ark"):
        assert read_bytes(p("jax_" + name)) == read_bytes(p("port_" + name))
    assert sorted(read_table(f"ark:{p('port_tfs.ark')}", "mat")) == s["keys"]


def test_gmm_est_fmllr_per_speaker(s):
    p = s["p"]
    both("gmm-est-fmllr", f"--spk2utt={s['spk2utt']}", "--fmllr-min-count=100", s["lda_mdl"],
         s["lda_feats"], s["wpost"], f"ark:{p('{out}_fmllr.ark')}")
    j = read_table(f"ark:{p('jax_fmllr.ark')}", "mat")
    t = read_table(f"ark:{p('port_fmllr.ark')}", "mat")
    assert sorted(j) == sorted(t) == ["spkA", "spkB"]
    for k in j:
        assert t[k].shape == (13, 14) and _rel_gap(t[k], j[k]) <= FMLLR_REL
    both("gmm-est-fmllr", "--fmllr-min-count=5000", s["lda_mdl"], s["lda_feats"], s["wpost"],
         f"ark:{p('{out}_none.ark')}")
    assert read_table(f"ark:{p('port_none.ark')}", "mat") == {}


def test_gmm_post_to_gpost_and_est_fmllr_gpost(s):
    p = s["p"]
    both("gmm-post-to-gpost", s["lda_mdl"], s["lda_feats"], s["wpost"], f"ark:{p('{out}.gpost')}")
    j = read_table(f"ark:{p('jax.gpost')}", "gpost")
    t = read_table(f"ark:{p('port.gpost')}", "gpost")
    assert sorted(j) == sorted(t) == s["keys"]
    for k in j:
        assert len(j[k]) == len(t[k])
        for fj, ft in zip(j[k], t[k]):
            assert [a for a, _ in fj] == [a for a, _ in ft]
            for (_, gj), (_, gt) in zip(fj, ft):
                np.testing.assert_allclose(gt, gj, atol=1e-6, rtol=0)
    both("gmm-est-fmllr-gpost", f"--spk2utt={s['spk2utt']}", "--fmllr-min-count=100",
         s["lda_mdl"], s["lda_feats"], f"ark:{p('jax.gpost')}", f"ark:{p('{out}_gfmllr.ark')}")
    jg = read_table(f"ark:{p('jax_gfmllr.ark')}", "mat")
    tg = read_table(f"ark:{p('port_gfmllr.ark')}", "mat")
    assert sorted(jg) == sorted(tg) == ["spkA", "spkB"]
    for k in jg:
        assert _rel_gap(tg[k], jg[k]) <= FMLLR_REL



def test_mllt_on_the_raw_features_meets_a_singular_matrix_in_both_packages(s):
    """The JAX package's MLLT update scales each cofactor row by det(M),
    which underflows to 0 on the raw 39-dimensional MFCC+delta statistics of
    these utterances; both packages then stop on a singular matrix (ROADMAP
    queue 3, a fault the port repeats)."""
    import old_kaldi_git_tpu.transform.mllt as jmllt
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.transform.mllt import MlltAccs, update_mllt

    model = AmGmmModel.load(s["tri"], device="cpu")
    ali = read_table(s["ali"], "ivec")
    t2p = model.tm.tid_to_pdf_array()
    acc = MlltAccs(39, "cpu")
    for i, k in enumerate(s["keys"]):
        acc.accumulate(model.am, s["feats"][k], t2p[ali[k]], groups=np.full(len(ali[k]), i))
    j = jmllt.MlltAccs(39)
    j.G, j.beta = acc.G.numpy().copy(), acc.beta
    for fn, a in ((update_mllt, acc), (jmllt.update_mllt, j)):
        with pytest.raises(np.linalg.LinAlgError, match="Singular matrix"):
            fn(a)
