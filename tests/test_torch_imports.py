"""The port stands alone: importing it and every sub-module pulls in neither
jax, flax nor the JAX package, and chip_smoke.py names none of them."""

import tests.torch_threads  # noqa: F401
import ast
import os
import pkgutil
import subprocess
import sys

import old_kaldi_git_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "old_kaldi_git_tpu")


def _port_modules():
    names = ["old_kaldi_git_tpu_torch"]
    for m in pkgutil.walk_packages(old_kaldi_git_tpu_torch.__path__,
                                   "old_kaldi_git_tpu_torch."):
        names.append(m.name)
    return names


def test_port_has_the_slice_modules():
    names = set(_port_modules())
    for want in ("device", "convert", "utils.log", "utils.parse_options",
                 "utils.batching", "utils.edit_distance", "ops._build",
                 "ops.gather_kernel", "ops.mfcc_kernel", "feat.window",
                 "feat.mel", "feat.compute", "feat.functions", "models.tdnn",
                 "models.am_nnet", "decoder.csr", "decoder.viterbi",
                 "recipes.minilib", "utils.io_funcs", "utils.timing",
                 "hmm.topology", "hmm.transition_model", "gmm.diag_gmm",
                 "ops.gmm_kernel", "recipes.decode", "recipes.chain",
                 "lat.lattice", "lat.determinize", "lat.rescore", "lm.arpa",
                 "lm.ngram", "ivector.extractor", "online.streaming",
                 "models.streaming_am", "recipes.nnet3", "fst.vector_fst",
                 "fst.symbols", "fst.lang", "fst.native", "tree.event_map",
                 "tree.context_dep", "hmm.hmm_utils", "decoder.graph",
                 "recipes.gmm_common", "recipes.toy", "gmm.mle",
                 "tree.build_tree", "recipes.mono", "recipes.triphone",
                 "recipes.yesno", "models.train", "chain", "chain.topology",
                 "chain.phone_lm", "chain.den_graph", "chain.supervision",
                 "chain.loss", "gmm.full_gmm", "utils.pipeline",
                 "models.natural_gradient", "models.egs", "models.diagnostics",
                 "transform", "transform.lda", "transform.mllt", "transform.fmllr",
                 "utils.kio", "utils.wav", "utils.table", "recipes.run_all",
                 "chain.e2e", "chain.semisup", "recipes.semisup", "gmm.ebw",
                 "recipes.mmi", "lat.discriminative", "models.discriminative",
                 "lat.mbr", "lat.ctm", "lat.holder", "lat.native", "hmm.posterior",
                 "models.recurrent", "lm.rnnlm", "models.descriptor",
                 "models.xconfig", "models.edits", "bin", "bin.__main__", "bin.tools",
                 "bin.nnet3_tools", "bin.train_tools", "utils.data_dir", "fst.algorithms",
                 "fst.holder", "fst.kaldi_fst_io", "feat.cmvn", "feat.signal", "feat.pitch",
                 "feat.resample", "ivector.vad", "bin.lat_tools", "bin.util_tools",
                 "fst.context", "fst.rand", "utils.threads", "transform.basis_fmllr",
                 "transform.lvtln", "transform.regtree", "transform.fmpe",
                 "models.nnet1", "models.nnet2", "recipes.nnet12", "ivector.plda",
                 "ivector.logistic_regression", "gmm.sgmm2", "gmm.sgmm2_fmllr",
                 "recipes.sgmm2", "kws", "kws.search", "kws.atwv", "bin.spkid_tools",
                 "bin.sgmm2_tools", "bin.kws_tools"):
        assert f"old_kaldi_git_tpu_torch.{want}" in names


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for n in {_port_modules()!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "import torch\n"
        "print('TF32', torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "TF32 False False" in out.stdout, out.stdout


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_name_no_forbidden_import():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    pkg = os.path.join(REPO, "old_kaldi_git_tpu_torch")
    for d, _dirs, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {sorted(bad)}"


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    """On a machine without CUDA the script must exit non-zero before any
    result line (this test runs where there is no GPU; with one it would
    decode, so it is bounded by checking availability first)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""
