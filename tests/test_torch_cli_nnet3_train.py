"""nnet3 training from the port's command line against the JAX package's, on
the CPU (tools in-process, the port's with --device=cpu), on
tests/torch_cli_system.py's `train_system()`.

Every comparison starts both packages from the same JAX-written model
(nnet3-init / nnet3-chain-init run by the JAX tool, read by the port): CE
training, the objectives the diagnostics print (parsed, within 1e-4; the
chain's 1e-4 relative), the trained models' loglikes (1e-4 of max|ref|),
priors (1e-5), combinations (1e-3), chain training and combination, and
sequence training (objective 1e-5, one epoch's 1e-4).  Adam moves an
element whose gradient is float noise by ±lr in either package (the
neural training tests' rule), so models are held through what they compute, not parameter by
parameter.  The port's own chain-init network prints as the JAX tool's."""

import tests.torch_threads  # noqa: F401
import re

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import both, jax_tool, port_tool, run, train_system

CE_XCONFIG = """input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=32 input=Append(-1,0,1)
relu-batchnorm-layer name=tdnn2 dim=32 input=Append(-1,0,1)
output-layer name=output dim=2000
"""
CHAIN_XCONFIG = """input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=32 input=Append(-1,0,1)
relu-batchnorm-layer name=tdnn2 dim=32 input=Append(-3,0,3)
output-layer name=output dim={pdfs}
"""


@pytest.fixture(scope="module")
def s():
    """train_system() and the JAX tools' inputs: CE egs of 32 frames, a
    CE nnet from nnet3-init, the monophone chain tree, its den graph, chain
    egs and a chain model from nnet3-chain-init, the port's den file, and
    denominator lattices of final.mdl on the 4 utterances."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    t = train_system()
    p = t["p"]
    for argv in (("ali-to-pdf", t["tri"], t["ali"], f"ark:{p('pdf.ark')}"),
                 ("nnet3-get-egs", "--frames-per-eg=32", t["feats_r"], f"ark:{p('pdf.ark')}",
                  f"ark:{p('egs.ark')}"),
                 ("ali-to-phones", t["tri"], t["ali"], f"ark:{p('ph.ark')}"),
                 ("chain-est-phone-lm", f"ark:{p('ph.ark')}", p("lm.fst")),
                 ("chain-build-tree", t["tri"], t["feats_r"], t["ali"], p("ctree")),
                 ("chain-make-den-fst", p("ctree"), p("lm.fst"), p("den")),
                 ("nnet3-chain-get-egs", t["tri"], p("ctree"), p("den"), t["feats_r"], t["ali"],
                  f"ark:{p('cegs.ark')}")):
        assert jax_tool(*argv) == 0, argv[0]
    assert port_tool("chain-make-den-fst", p("ctree"), p("lm.fst"), p("port_den")) == 0
    with open(p("ctree"), "rb") as f:
        pdfs = ContextDependency.read(f).num_pdfs
    with open(p("ce.xconfig"), "w") as f:
        f.write(CE_XCONFIG)
    with open(p("chain.xconfig"), "w") as f:
        f.write(CHAIN_XCONFIG.format(pdfs=pdfs))
    phones = ":".join(str(x) for x in AmGmmModel.load(t["tri"], device="cpu").tm.topo.phones)
    assert jax_tool("nnet3-init", "--srand=1", p("ce.xconfig"), p("j0.raw")) == 0
    assert jax_tool("nnet3-chain-init", "--srand=2", p("ctree"), p("den"), p("chain.xconfig"),
                    phones, p("jc0.mdl")) == 0
    assert port_tool("nnet3-latgen-faster", "--acoustic-scale=1.0", "--beam=12",
                     p("final.mdl"), t["hclg"], t["feats_r"], f"ark:{p('denlat.ark')}") == 0
    return dict(t, phones=phones, egs=f"ark:{p('egs.ark')}", cegs=f"ark:{p('cegs.ark')}")


def _number(out: str, pattern: str) -> float:
    return float(re.search(pattern, out)[1])


def _compute_prob(capsys, fn, model, egs) -> float:
    rc, out = run(capsys, fn, "nnet3-compute-prob", model, egs)
    assert rc == 0
    return _number(out, r"log-probability per frame: (\S+)")


def _chain_prob(capsys, fn, model, cegs) -> float:
    rc, out = run(capsys, fn, "nnet3-chain-compute-prob", model, cegs)
    assert rc == 0
    return _number(out, r"chain objective per frame: (\S+)")


def _loglikes(s, model: str, name: str) -> dict:
    p = s["p"]
    assert port_tool("nnet3-compute", model, s["feats_r"], f"ark:{p(name)}") == 0
    return read_table(f"ark:{p(name)}", "mat")


def _assert_loglikes_close(s, got: str, want: str, rel: float) -> None:
    a, b = _loglikes(s, got, "ll_got.ark"), _loglikes(s, want, "ll_want.ark")
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= rel * np.abs(b[k]).max(), k


@pytest.fixture(scope="module")
def ce_trained(s):
    """nnet3-train, minibatches of 4 egs, from the JAX nnet3-init model."""
    p = s["p"]
    both("nnet3-train", "--minibatch-size=4", "--initial-lr=2e-3", "--final-lr=1e-3",
         "--srand=3", p("j0.raw"), s["egs"], p("{out}_1.raw"))
    return s


def test_nnet3_train_and_compute_prob_equal_the_jax_tools(ce_trained, capsys):
    s, p = ce_trained, ce_trained["p"]
    start = _compute_prob(capsys, port_tool, p("j0.raw"), s["egs"])
    j = _compute_prob(capsys, jax_tool, p("jax_1.raw"), s["egs"])
    t = _compute_prob(capsys, port_tool, p("port_1.raw"), s["egs"])
    assert t == pytest.approx(j, abs=1e-4) and t > start
    _assert_loglikes_close(s, p("port_1.raw"), p("jax_1.raw"), 1e-4)


def test_nnet3_adjust_priors_equal_the_jax_tool(ce_trained):
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet

    s, p = ce_trained, ce_trained["p"]
    both("nnet3-adjust-priors", "--max-egs=6", p("jax_1.raw"), s["egs"], p("{out}_pri.raw"))
    j, t = (AmNnet.load(p(f"{n}_pri.raw"), device="cpu").log_priors.numpy()
            for n in ("jax", "port"))
    assert t.shape == (2000,) and np.abs(t - j).max() <= 1e-5


def test_nnet3_combine_equals_the_jax_tool(ce_trained, capsys):
    s, p = ce_trained, ce_trained["p"]
    both("nnet3-combine", "--num-steps=20", p("j0.raw"), p("jax_1.raw"), s["egs"],
         p("{out}_comb.raw"))
    _assert_loglikes_close(s, p("port_comb.raw"), p("jax_comb.raw"), 1e-3)
    assert _compute_prob(capsys, port_tool, p("port_comb.raw"), s["egs"]) == pytest.approx(
        _compute_prob(capsys, port_tool, p("jax_comb.raw"), s["egs"]), abs=1e-3)


def test_nnet3_train_refuses_a_diverged_model(s, capsys):
    """A non-finite mean CE is fatal in both packages (KaldiError: exit 1)."""
    p = s["p"]
    eg = next(iter(read_table(s["egs"], "egs").values()))
    eg.feats = eg.feats.copy()
    eg.feats[3, 5] = np.nan
    with TableWriter(f"ark:{p('nan_egs.ark')}", "egs") as w:
        w["nan-0"] = eg
    capsys.readouterr()
    both("nnet3-train", p("j0.raw"), f"ark:{p('nan_egs.ark')}", p("{out}_nan.raw"), rc=1)
    assert capsys.readouterr().err.count("non-finite CE") == 2


def test_nnet3_chain_init_prints_as_the_jax_tools_network(s, capsys):
    """The port's nnet3-chain-init: the JAX tool's network (its own draws),
    as nnet3-info prints the two raw nnets, and the same tree, den graph
    and transition model."""
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel

    p = s["p"]
    assert port_tool("nnet3-chain-init", "--srand=2", p("ctree"), p("port_den"),
                     p("chain.xconfig"), s["phones"], p("tc0.mdl")) == 0
    j, t = (ChainModel.load(p(m), device="cpu") for m in ("jc0.mdl", "tc0.mdl"))
    for cm, raw in ((j, "jc0.raw"), (t, "tc0.raw")):
        cm.am.save(p(raw))
    info = [run(capsys, port_tool, "nnet3-info", p(m)) for m in ("jc0.raw", "tc0.raw")]
    assert info[0] == info[1] and "layer 1: tdnn dim=32" in info[1][1]
    assert np.array_equal(j.tid_to_pdf, t.tid_to_pdf)
    assert np.array_equal(j.den.pdf, t.den.pdf) and j.frame_subsampling_factor == 3
    assert j.ctx_dep.num_pdfs == t.ctx_dep.num_pdfs


def test_nnet3_chain_train_and_compute_prob_equal_the_jax_tools(s, capsys):
    p = s["p"]
    start = _chain_prob(capsys, port_tool, p("jc0.mdl"), s["cegs"])
    both("nnet3-chain-train", "--minibatch-size=2", "--srand=1", p("jc0.mdl"), s["cegs"],
         p("{out}_c1.mdl"))
    j = _chain_prob(capsys, jax_tool, p("jax_c1.mdl"), s["cegs"])
    t = _chain_prob(capsys, port_tool, p("port_c1.mdl"), s["cegs"])
    # the saved den graph leaves behind the arrays the loss kept on it for
    # its device (a card-trained model's would load as CPU tensors)
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel

    assert "_device_arrays" not in vars(ChainModel.load(p("port_c1.mdl"), device="cpu").den)
    assert t == pytest.approx(j, rel=1e-4) and start < t <= 0.0
    assert _chain_prob(capsys, port_tool, p("jax_c1.mdl"), s["cegs"]) == pytest.approx(
        j, rel=1e-4)
    both("nnet3-chain-combine", "--num-steps=10", p("jc0.mdl"), p("jax_c1.mdl"), s["cegs"],
         p("{out}_cc.mdl"))
    jc, tc = (_chain_prob(capsys, port_tool, p(f"{n}_cc.mdl"), s["cegs"])
              for n in ("jax", "port"))
    assert tc == pytest.approx(jc, rel=1e-4)


def test_nnet3_discriminative_objf_and_training_equal_the_jax_tools(s, capsys):
    p = s["p"]
    tables = (s["feats_r"], s["ali"], f"ark:{p('denlat.ark')}")

    def objf(fn, model):
        rc, out = run(capsys, fn, "nnet3-discriminative-compute-objf", "--criterion=smbr",
                      "--acoustic-scale=1.0", model, *tables)
        assert rc == 0
        return _number(out, r"smbr objf per frame: (\S+)")

    o0 = objf(jax_tool, p("final_jax.mdl"))
    assert objf(port_tool, p("final_jax.mdl")) == pytest.approx(o0, abs=1e-5)
    both("nnet3-discriminative-train", "--criterion=smbr", "--acoustic-scale=1.0",
         "--learning-rate=1e-3", p("final_jax.mdl"), *tables, p("{out}_smbr.mdl"))
    j, t = objf(port_tool, p("jax_smbr.mdl")), objf(port_tool, p("port_smbr.mdl"))
    assert t == pytest.approx(j, abs=1e-4) and t >= o0 - 1e-6
