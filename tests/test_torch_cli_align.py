"""The alignment tools of the port's CLI against the JAX package's, and the
CLI's interface, on the CPU.

compile-train-graphs writes the JAX tool's fst archive byte for byte (the
self-loops added on the host in float64, as the JAX tool adds them);
gmm-align-compiled (tri.mdl), align-equal-compiled and nnet3-align-compiled
(final.am bundled with tri.mdl) give the JAX tools' tids, and the port's
library `align_batch` on the same graphs and loglikes.  The interface: the
module entry lists exactly the 201 ported tools, an unknown tool exits 1, the
tools that make tensors take --device (the others do not) and raise without
a card when it is left at cuda."""

import tests.torch_threads  # noqa: F401
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu_torch.bin.tools as ttools
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import REPO, TENSOR_TOOLS, jax_tool, port_tool, system

JAX_BIN = os.path.join(REPO, "old_kaldi_git_tpu", "bin")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def graphs():
    s = system()
    p = s["p"]
    for pre, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("compile-train-graphs", p("tree"), s["tri"], p("lang"),
                  f"ark:{p('text.ark')}", f"ark:{p(pre + 'graphs.ark')}") == 0
    return s


def test_compile_train_graphs_writes_the_jax_tools_archive(graphs):
    p = graphs["p"]
    assert _bytes(p("jgraphs.ark")) == _bytes(p("tgraphs.ark"))
    g = read_table(f"ark:{p('tgraphs.ark')}", "fst")
    assert sorted(g) == sorted(graphs["text"]) and min(x.num_states for x in g.values()) > 50


@pytest.mark.parametrize("tool,model", [
    ("gmm-align-compiled", "tri"), ("align-equal-compiled", "tri"),
    ("nnet3-align-compiled", "final_jax.mdl")])
def test_aligners_give_the_jax_tools_tids(graphs, tool, model):
    p = graphs["p"]
    mdl = graphs["tri"] if model == "tri" else p(model)
    out = {}
    for pre, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn(tool, mdl, f"ark:{p('jgraphs.ark')}", f"ark:{p('feats.ark')}",
                  f"ark:{p(pre + tool)}") == 0
        out[pre] = read_table(f"ark:{p(pre + tool)}", "ivec")
    assert sorted(out["j"]) == sorted(out["t"]) == sorted(graphs["feats"])
    for k, v in out["t"].items():
        assert np.array_equal(v, out["j"][k]) and len(v) == len(graphs["feats"][k])


def test_gmm_align_compiled_equals_the_library_align_batch(graphs):
    from old_kaldi_git_tpu_torch.decoder.csr import fst_to_csr_native
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions, align_batch
    from old_kaldi_git_tpu_torch.fst.native import NativeFst
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch

    p = graphs["p"]
    model = AmGmmModel.load(graphs["tri"], device="cpu")
    g = read_table(f"ark:{p('tgraphs.ark')}", "fst")
    keys, padded, nf = pad_feature_batch(graphs["feats"])
    csr = [fst_to_csr_native(NativeFst.from_arrays(*g[k].to_arrays()),
                             model.tm.tid_to_pdf_array()) for k in keys]
    alis, _ = align_batch(csr, model.am.loglikes_batch(torch.from_numpy(padded)), nf,
                          ViterbiOptions(beam=200.0, acoustic_scale=1.0), device="cpu")
    tool = read_table(f"ark:{p('tgmm-align-compiled')}", "ivec")
    for k, a in zip(keys, alis):
        assert np.array_equal(tool[k], a)


def _registered_names(path):
    with open(path) as f:
        return re.findall(r'@tool\("([^"]+)"\)', f.read())


def test_the_module_entry_lists_exactly_the_ported_tools():
    out = subprocess.run([sys.executable, "-m", "old_kaldi_git_tpu_torch.bin", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0
    listed = [ln.strip() for ln in out.stderr.splitlines() if ln.startswith("  ")]
    want = set(_registered_names(os.path.join(JAX_BIN, "tools.py")))
    assert len(want) == 50
    nnet3 = set(_registered_names(os.path.join(JAX_BIN, "nnet3_tools.py")))
    assert len(nnet3) == 28 and not nnet3 & want  # all of the JAX nnet3_tools.py
    want |= nnet3 | {"compile-train-graphs", "align-equal-compiled", "gmm-align-compiled"}
    jax_names = set()
    for f in ("tools.py", "nnet3_tools.py", "train_tools.py"):
        jax_names |= set(_registered_names(os.path.join(JAX_BIN, f)))
    assert want <= jax_names
    batch2 = set()
    for f, n in (("lat_tools.py", 42), ("util_tools.py", 24)):
        names = set(_registered_names(os.path.join(JAX_BIN, f)))
        assert len(names) == n and not names & (want | batch2)
        batch2 |= names
    want |= batch2
    train = set(_registered_names(os.path.join(JAX_BIN, "train_tools.py")))
    assert len(train) == 57 and not train & batch2
    want |= train
    assert listed == sorted(want) and len(listed) == 201
    assert set(ttools.TOOLS) == want


def test_unknown_tools_and_bad_usage_exit_1(capsys):
    assert ttools.main(["no-such-tool"]) == 1
    assert ttools.main([]) == 1
    assert ttools.main(["fstinfo"]) == 1
    assert ttools.main(["compute-wer", "ark:/nonexistent/a", "ark:/nonexistent/b"]) == 1
    assert "ERROR (compute-wer)" in capsys.readouterr().err


def test_device_option_and_refusal_without_a_card(graphs, capsys):
    """--device is on exactly the tools that make tensors; left at its
    default (cuda) it raises here, where there is no card."""
    for name in sorted(ttools.TOOLS):
        with pytest.raises(SystemExit):
            ttools.main([name, "--help"])
        assert ("--device" in capsys.readouterr().err) == (name in TENSOR_TOOLS), name
    if torch.cuda.is_available():
        return
    p = graphs["p"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.main(["gmm-align-compiled", graphs["tri"], f"ark:{p('tgraphs.ark')}",
                     f"ark:{p('feats.ark')}", f"ark:{p('never.ark')}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.main(["compute-mfcc-feats", f"scp:{p('wav.scp')}", f"ark:{p('never.ark')}"])
    assert not os.path.exists(p("never.ark"))
