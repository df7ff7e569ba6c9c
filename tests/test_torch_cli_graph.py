"""The graph tools of the port's CLI and the FST file formats against the
JAX package's, on the CPU.

prepare-lang, arpa2fst and mkgraph (with tri.mdl's tree and with mono.mdl)
write the JAX tools' files byte for byte; the eight fst* tools on L∘G of the
shared system (tests/torch_cli_system.py) write OKTFST01 files byte-equal
to the JAX tools' and print what they print; the OpenFst / CompactLattice
writers of fst/kaldi_fst_io.py, `mkgraph_csr(fst_out=...)` and the
"fst" / "kfst" / "kclat" holders are byte-equal both ways; and the decoders'
CSR of an HCLG file (`read_hclg_csr`, the native export) equals the JAX
package's Python `fst_to_csr` array for array."""

import tests.torch_threads  # noqa: F401
import io
import os

import numpy as np
import pytest

from tests.torch_cli_system import WORKDIR, jax_tool, port_tool, run, system

CSR_FIELDS = ("row_ptr", "tid", "pdf", "weight", "nextstate", "final_weight")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def s():
    return system()


def test_prepare_lang_and_arpa2fst_write_the_jax_tools_files(s):
    p = s["p"]
    assert jax_tool("prepare-lang", p("lexicon.txt"), p("jlang")) == 0
    for f in ("words.txt", "phones.txt", "L.fst", "L_disambig.fst", "lexicon.txt"):
        assert _bytes(p("jlang", f)) == _bytes(p("lang", f)), f
    for name, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("arpa2fst", f"--words={p('lang', 'words.txt')}", p("G.arpa"),
                  p(f"{name}G.fst")) == 0
    assert _bytes(p("jG.fst")) == _bytes(p("tG.fst"))


@pytest.mark.parametrize("model", ["tri", "mono"])
def test_mkgraph_writes_the_jax_tools_hclg(s, model):
    p = s["p"]
    mdl = os.path.join(WORKDIR, f"{model}.mdl")
    tree = [f"--tree={p('tree')}"] if model == "tri" else []
    for name, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("mkgraph", *tree, p("lang"), p("G.arpa"), mdl,
                  p(f"{name}graph_{model}")) == 0
    j, t = _bytes(p(f"jgraph_{model}", "HCLG.fst")), _bytes(p(f"tgraph_{model}", "HCLG.fst"))
    assert j == t and len(t) > 10_000
    assert _bytes(p(f"jgraph_{model}", "words.txt")) == _bytes(p("lang", "words.txt"))


@pytest.fixture(scope="module")
def lg_files(s):
    """L_disambig ∘ G from both packages' fstcompose."""
    p = s["p"]
    for name, fn in (("j", jax_tool), ("t", port_tool)):
        assert fn("arpa2fst", f"--words={p('lang', 'words.txt')}", p("G.arpa"),
                  p(f"{name}G.fst")) == 0
        assert fn("fstcompose", p("lang", "L_disambig.fst"), p(f"{name}G.fst"),
                  p(f"{name}_lg.fst")) == 0
    assert _bytes(p("j_lg.fst")) == _bytes(p("t_lg.fst"))
    with open(p("disambig.txt"), "w") as f:
        words = s["words"]
        f.write(" ".join(str(i) for i in range(1, 3)) + f" {words['#0']}\n")
    return s


@pytest.mark.parametrize("chain", [
    [("fstdeterminizestar", ["--use-log=true"]), ("fstminimizeencoded", []),
     ("fstpushspecial", [])],
    [("fstdeterminizestar", []), ("fstrmepslocal", []), ("fstproject", [])],
    [("fstrmsymbols", ["@disambig"]), ("fstproject", ["--project-output=true"])],
])
def test_fst_tools_write_the_jax_tools_files(lg_files, chain):
    p = lg_files["p"]
    for name, fn in (("j", jax_tool), ("t", port_tool)):
        src = p(f"{name}_lg.fst")
        for i, (tool, opts) in enumerate(chain):
            dst = p(f"{name}_{tool}_{i}.fst")
            opts = [p("disambig.txt") if o == "@disambig" else o for o in opts]
            assert fn(tool, *opts, src, dst) == 0
            src = dst
    for i, (tool, _) in enumerate(chain):
        assert _bytes(p(f"j_{tool}_{i}.fst")) == _bytes(p(f"t_{tool}_{i}.fst")), tool


def test_fst_printing_tools_print_as_the_jax_tools(lg_files, capsys):
    p = lg_files["p"]
    for tool in ("fstinfo", "fstprint", "fstshortestpath"):
        j = run(capsys, jax_tool, tool, p("j_lg.fst"))
        t = run(capsys, port_tool, tool, p("t_lg.fst"))
        assert j == t and t[0] == 0 and len(t[1]) > 20, tool


def test_openfst_and_compact_lattice_writers_are_byte_equal_both_ways(s, tmp_path):
    import old_kaldi_git_tpu.fst.kaldi_fst_io as jk
    import old_kaldi_git_tpu.fst.vector_fst as jv
    import old_kaldi_git_tpu_torch.fst.kaldi_fst_io as tk
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst, read_arrays

    with open(s["hclg"], "rb") as f:
        th = VectorFst.read(f)
    with open(s["hclg"], "rb") as f:
        jh = jv.VectorFst.read(f)
    bj, bt, ba = io.BytesIO(), io.BytesIO(), io.BytesIO()
    jk.write_fst_kaldi(bj, jh)
    tk.write_fst_kaldi(bt, th)
    with open(s["hclg"], "rb") as f:
        tk.write_fst_kaldi_arrays(ba, *read_arrays(f))
    assert bj.getvalue() == bt.getvalue() == ba.getvalue()
    back = tk.read_fst_kaldi(io.BytesIO(bj.getvalue()))
    out = io.BytesIO()
    back.write(out)
    assert out.getvalue() == _bytes(s["hclg"])
    # CompactLattice cells: the port's determinization, read by the JAX holder
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
    import old_kaldi_git_tpu.utils.table as jtable

    p = s["p"]
    assert port_tool("gmm-latgen-faster", "--acoustic-scale=1.0", "--max-active=500",
                     s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                     f"ark:{tmp_path}/lat.ark") == 0
    assert port_tool("lattice-determinize-pruned", "--acoustic-scale=1.0",
                     f"ark:{tmp_path}/lat.ark", f"ark:{tmp_path}/clat.ark") == 0
    clats = read_table(f"ark:{tmp_path}/clat.ark", "clat")
    with TableWriter(f"ark:{tmp_path}/k.ark", "kclat") as w:
        for k, v in clats.items():
            w[k] = v
    with TableWriter(f"ark:{tmp_path}/kf.ark", "kfst") as w:
        w["hclg"] = th
    jc = jtable.read_table(f"ark:{tmp_path}/k.ark", "kclat")
    with jtable.TableWriter(f"ark:{tmp_path}/kj.ark", "kclat") as w:
        for k in sorted(jc):
            w[k] = jc[k]
    assert _bytes(f"{tmp_path}/kj.ark") == _bytes(f"{tmp_path}/k.ark")
    jf = jtable.read_table(f"ark:{tmp_path}/kf.ark", "kfst")["hclg"]
    assert (jf.num_states, jf.num_arcs) == (th.num_states, th.num_arcs)


def test_mkgraph_csr_fst_out_and_the_decoders_csr_equal_the_jax_packages(s, tmp_path):
    import old_kaldi_git_tpu.decoder.csr as jcsr
    import old_kaldi_git_tpu.decoder.graph as jgraph
    import old_kaldi_git_tpu.fst.lang as jlang
    import old_kaldi_git_tpu.fst.vector_fst as jv
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    import old_kaldi_git_tpu.lm.arpa as jarpa
    import old_kaldi_git_tpu.tree.context_dep as jcd
    import old_kaldi_git_tpu_torch.decoder.graph as tgraph
    from old_kaldi_git_tpu_torch.fst.lang import load_lang_dir
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa
    from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency

    p = s["p"]
    text = open(p("G.arpa")).read()
    tl = load_lang_dir(p("lang"))
    jl = jlang.load_lang_dir(p("lang"))
    with open(p("tree"), "rb") as f:
        tc = ContextDependency.read(f)
    with open(p("tree"), "rb") as f:
        jc = jcd.ContextDependency.read(f)
    tm = AmGmmModel.load(s["tri"], device="cpu").tm
    jm = jgmm.AmGmmModel.load(s["tri"]).tm
    tgraph.mkgraph_csr(tl, arpa_to_fst(parse_arpa(text), tl.words), tc, tm,
                       fst_out=f"{tmp_path}/t.fst")
    jgraph.mkgraph_csr(jl, jarpa.arpa_to_fst(jarpa.parse_arpa(text), jl.words), jc, jm,
                       fst_out=f"{tmp_path}/j.fst")
    assert _bytes(f"{tmp_path}/t.fst") == _bytes(f"{tmp_path}/j.fst")
    t2p = tm.tid_to_pdf_array()
    with open(s["hclg"], "rb") as f:
        jg = jcsr.fst_to_csr(jv.VectorFst.read(f), t2p)
    tg = tgraph.read_hclg_csr(s["hclg"], t2p)
    assert jg.start == tg.start and tg.num_states > 1000
    for f in CSR_FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f)
        assert np.array_equal(a, b), f
    for i in range(tg.num_arcs):
        assert tuple(jg.arc_olabels[i]) == tg.arc_olabels[i]
    for i in range(tg.num_states):
        assert tuple(jg.final_olabels[i]) == tg.final_olabels[i]


def test_fst_holder_tables_cross_between_the_packages(s, tmp_path):
    import old_kaldi_git_tpu.fst.holder  # noqa: F401
    import old_kaldi_git_tpu.utils.table as jtable
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst
    from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table

    p = s["p"]
    with open(p("lang", "L.fst"), "rb") as f:
        L = VectorFst.read(f)
    with open(s["hclg"], "rb") as f:
        H = VectorFst.read(f)
    with TableWriter(f"ark,scp:{tmp_path}/g.ark,{tmp_path}/g.scp", "fst") as w:
        w["L"], w["H"] = L, H
    j = jtable.read_table(f"scp:{tmp_path}/g.scp", "fst")
    with jtable.TableWriter(f"ark:{tmp_path}/j.ark", "fst") as w:
        w["L"], w["H"] = j["L"], j["H"]
    assert _bytes(f"{tmp_path}/j.ark") == _bytes(f"{tmp_path}/g.ark")
    back = read_table(f"ark:{tmp_path}/j.ark", "fst")
    assert back["H"].to_text() == H.to_text() and back["L"].num_arcs == L.num_arcs
