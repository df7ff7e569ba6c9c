"""The host tools of bin/lat_tools.py (latbin, posterior, vector,
feature-info and fstbin extras) against the JAX package's, on the CPU (tools
called in-process; none of them takes --device).

The lattices are the port's gmm-latgen-faster on the shared system of
tests/torch_cli_system.py (mono.mdl, --acoustic-scale=1.0), and each
package's tool reads the other package's archives.  Lattice, CompactLattice,
posterior, text and float tables are equal byte for byte (the tools that
read an archived lattice's state times find none in either package: the
state-time fault, pinned here), except where a
word FST is involved: the port's comes from the native DeterminizeStar in
float32 and the JAX package's from Python in float64 (tests/test_torch_
lattice_ops.py), so lattice-to-fst is held by each word sequence's cost and
lattice-interp by its n-best lists and best path, within float32's 1e-6
relative.  lattice-determinize gives the same archive on 1 and 3 threads."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest
import torch

from old_kaldi_git_tpu_torch.utils.table import TableWriter, read_table
from tests.torch_cli_system import jax_tool, port_tool, run, system

F32_REL = 1e-6  # the native word FST's float32 weights


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def s():
    """The port's lattices of the 4 utterances, their best paths' words and
    alignments, and mono.mdl's loglikes as a matrix table."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel

    s = system()
    p = s["p"]
    assert port_tool("gmm-latgen-faster", "--acoustic-scale=1.0", "--lattice-beam=6",
                     "--max-active=500", s["mono"], s["hclg_mono"], f"ark:{p('feats.ark')}",
                     f"ark:{p('lt_lat.ark')}") == 0
    assert port_tool("lattice-best-path", "--acoustic-scale=1.0", f"ark:{p('lt_lat.ark')}",
                     f"ark,t:{p('lt_bp.txt')}", f"ark:{p('lt_ali.ark')}") == 0
    am = AmGmmModel.load(s["mono"], device="cpu").am
    with TableWriter(f"ark:{p('lt_ll.ark')}", "mat") as w:
        for k, f in sorted(s["feats"].items()):
            w[k] = am.loglikes_batch(torch.from_numpy(f)).numpy()
    with open(p("lang", "phones.txt")) as f:
        s["sil"] = next(ln.split()[1] for ln in f if ln.split()[0] == "SIL")
    return s


def both(s, argv, holder=None, tag=""):
    """Each package's tool on the same arguments ('{o}' its own output path,
    '{lat}' the port's lattices); returns {name: output}, the table when a
    holder is given, else the file's bytes."""
    p = s["p"]
    out = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        o = p(f"lt_{name}_{tag or argv[0]}")
        args = [a.replace("{o}", o).replace("{lat}", p("lt_lat.ark")) for a in argv[1:]]
        assert fn(argv[0], *args) == 0, (name, argv)
        out[name] = read_table(f"ark:{o}", holder) if holder else _bytes(o)
    return out


@pytest.mark.parametrize("argv", [
    ["lattice-1best", "--acoustic-scale=1.0", "ark:{lat}", "ark:{o}"],
    ["lattice-copy", "ark:{lat}", "ark:{o}"],
    ["lattice-add-penalty", "--word-ins-penalty=0.5", "ark:{lat}", "ark:{o}"],
    ["lattice-rmali", "ark:{lat}", "ark:{o}"],
])
def test_lattice_to_lattice_tools_write_the_jax_tools_archives(s, argv):
    out = both(s, argv)
    assert out["jax"] == out["port"] and len(out["port"]) > 1000
    lats = read_table(f"ark:{s['p'](f'lt_port_{argv[0]}')}", "lat")
    assert sorted(lats) == sorted(s["feats"])


def test_rescore_mapped_boost_and_alignment_tools_equal_the_jax_tools(s):
    p = s["p"]
    mono = s["mono"]
    out = both(s, ["lattice-rescore-mapped", mono, "ark:{lat}", f"ark:{p('lt_ll.ark')}",
                   "ark:{o}"])
    assert out["jax"] == out["port"]
    for opts in (["--b=0.5"], ["--b=1.0", f"--silence-phones={s['sil']}",
                               "--max-silence-error=0.3"]):
        out = both(s, ["lattice-boost-ali", *opts, mono, "ark:{lat}", f"ark:{p('lt_ali.ark')}",
                       "ark:{o}"])
        assert out["jax"] == out["port"]
    for tool in ("lattice-align-words-lexicon", "phone-align-lattice"):
        first = [p("lang")] if tool.endswith("lexicon") else []
        out = both(s, [tool, "--acoustic-scale=1.0", *first, mono, "ark:{lat}", "ark,t:{o}"],
                   holder="text")
        assert out["jax"] == out["port"] and len(out["port"]) == 4


def test_archived_lattices_carry_no_state_times_in_either_package(s):
    """The state-time fault (ROADMAP queue 3, PR 16): a lattice read from an
    archive has state_time -1 everywhere, so the tools that read it find no
    frame.  In both packages lattice-to-post writes posteriors of no frames,
    and lattice-rescore-mapped, gmm-rescore-lattice and lattice-boost-ali
    write their input archive back unchanged; with the times recomputed
    (`lattice_state_times`, as lattice-to-mpe-post does) the same library
    calls do reach every frame (lattice_to_post keys a posterior by the frame
    of its arc's end state, so frame 0 of its output stays empty)."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_state_times, lattice_to_post

    p = s["p"]
    lat_bytes = _bytes(p("lt_lat.ark"))
    for argv in (["lattice-rescore-mapped", s["mono"], "ark:{lat}",
                  f"ark:{p('lt_ll.ark')}", "ark:{o}"],
                 ["gmm-rescore-lattice", s["mono"], "ark:{lat}", f"ark:{p('feats.ark')}",
                  "ark:{o}"],
                 ["lattice-boost-ali", "--b=1.0", s["mono"], "ark:{lat}",
                  f"ark:{p('lt_ali.ark')}", "ark:{o}"]):
        out = both(s, argv)
        assert out["jax"] == out["port"] == lat_bytes, argv[0]
    both(s, ["lattice-to-post", "--acoustic-scale=1.0", s["mono"], "ark:{lat}", "ark:{o}"])
    for name in ("jax", "port"):
        posts = read_table(f"ark:{p('lt_' + name + '_lattice-to-post')}", "post")
        assert sorted(posts) == sorted(s["feats"]) and all(len(v) == 0 for v in posts.values())
    tm = AmGmmModel.load(s["mono"], device="cpu").tm
    for k, lat in read_table(f"ark:{p('lt_lat.ark')}", "lat").items():
        assert set(lat.state_time) == {-1}
        lattice_state_times(lat)
        post = lattice_to_post(lat, tm, 1.0, 1.0)
        assert sum(1 for fr in post if fr) == len(s["feats"][k])


def test_lattice_align_words_by_word_boundaries_equals_the_jax_tool(s):
    """Linear lattices of the best paths, one word a non-silence phone, with
    every such phone a singleton and SIL a nonword: each package aligns
    them alike; on the decoded lattices, whose words span several phones,
    both fail every utterance and exit 1."""
    from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
    from old_kaldi_git_tpu_torch.hmm.hmm_utils import split_to_phones
    from old_kaldi_git_tpu_torch.lat.lattice import Lattice, LatticeArc

    p = s["p"]
    tm = AmGmmModel.load(s["mono"], device="cpu").tm
    sil = int(s["sil"])
    phones = sorted(set(tm.tid_to_phone_array()[1:].tolist()))
    with open(p("lt_wb.int"), "w") as f:
        f.writelines(f"{ph} {'nonword' if ph == sil else 'singleton'}\n" for ph in phones)
    with TableWriter(f"ark:{p('lt_lin.ark')}", "lat") as w:
        for k, ali in read_table(f"ark:{p('lt_ali.ark')}", "ivec").items():
            lat = Lattice()
            cur = lat.add_state(0)
            lat.start = cur
            t = 0
            for seg in split_to_phones(tm, list(ali)):
                ph = tm.tid_to_phone(seg[0])
                for i, tid in enumerate(seg):
                    nxt = lat.add_state(t + 1)
                    word = 1000 + ph if i == 0 and ph != sil else 0
                    lat.arcs[cur].append(LatticeArc(int(tid), word, 0.5, 1.0, nxt))
                    cur, t = nxt, t + 1
            lat.finals[cur] = (0.0, 0.0)
            w[k] = lat
    out = both(s, ["lattice-align-words", f"{p('lt_wb.int')}", s["mono"],
                   f"ark:{p('lt_lin.ark')}", "ark,t:{o}"], holder="text")
    assert out["jax"] == out["port"] and len(out["port"]) == 4
    first = out["port"][sorted(out["port"])[0]].split(" ; ")
    assert len(first) > 3 and all(int(x.split()[0]) > 1000 for x in first)
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        assert fn("lattice-align-words", p("lt_wb.int"), s["mono"], f"ark:{p('lt_lat.ark')}",
                  f"ark,t:{p('lt_fail_' + name)}") == 1


def test_posterior_tools_write_the_jax_tools_archives(s):
    p = s["p"]
    mono = s["mono"]
    for tool in ("lattice-to-mpe-post", "lattice-to-smbr-post"):
        out = both(s, [tool, "--acoustic-scale=1.0", f"--silence-phones={s['sil']}", mono,
                       f"ark:{p('lt_ali.ark')}", "ark:{lat}", "ark:{o}"])
        assert out["jax"] == out["port"]
    post = p("lt_port_lattice-to-mpe-post")  # signed tid posteriors, every frame
    with TableWriter(f"ark,t:{p('lt_scales.txt')}", "flt") as w:
        for i, k in enumerate(sorted(s["feats"])):
            w[k] = 0.5 + i
    for argv in (["copy-post", "--scale=0.7", f"ark:{post}", "ark:{o}"],
                 ["scale-post", f"ark:{post}", "1.5", "ark:{o}"],
                 ["scale-post", f"ark:{post}", f"ark:{p('lt_scales.txt')}", "ark:{o}"],
                 ["sum-post", "--scale2=0.25", f"ark:{post}",
                  f"ark:{p('lt_jax_lattice-to-smbr-post')}", "ark:{o}"]):
        out = both(s, argv, tag=f"{argv[0]}{len(argv)}")
        assert out["jax"] == out["port"], argv[0]
    frames = read_table(f"ark:{post}", "post")
    assert [len(frames[k]) for k in sorted(frames)] == [len(s["feats"][k])
                                                        for k in sorted(s["feats"])]


@pytest.mark.parametrize("threads", [1, 3])
def test_determinize_push_minimize_and_lm_rescoring_equal_the_jax_tools(s, threads):
    p = s["p"]
    out = both(s, ["lattice-determinize", f"--num-threads={threads}", "ark:{lat}", "ark:{o}"],
               tag=f"det{threads}")
    assert out["jax"] == out["port"]
    if threads == 1:
        return
    assert out["port"] == _bytes(p("lt_port_det1"))
    chain = p("lt_port_det3")
    for tool in ("lattice-push", "lattice-minimize"):
        out = both(s, [tool, f"ark:{chain}", "ark:{o}"])
        assert out["jax"] == out["port"], tool
        chain = p(f"lt_jax_{tool}")  # the next port tool reads the JAX tool's archive
    out = both(s, ["lattice-copy", "--compact", f"ark:{chain}", "ark:{o}"], tag="copy_clat")
    assert out["jax"] == out["port"] == _bytes(chain)
    wl = f"--words={p('lang', 'words.txt')}"
    for tool in ("lattice-lmrescore", "lattice-lmrescore-pruned"):
        out = both(s, [tool, wl, "--lm-scale=-1.0", f"ark:{chain}", p("G.arpa"), "ark:{o}"])
        assert out["jax"] == out["port"], tool
    assert len(read_table(f"ark:{p('lt_port_lattice-lmrescore-pruned')}", "clat")) == 4


def test_word_fsts_interpolation_and_confidence_equal_the_jax_tools(s, capsys):
    from tests.test_torch_lattice_ops import word_fst_paths
    from old_kaldi_git_tpu_torch.lat.lattice import lattice_best_path, lattice_nbest

    p = s["p"]
    for scale in ("0.0", "1.0"):
        out = both(s, ["lattice-to-fst", f"--acoustic-scale={scale}", "ark:{lat}", "ark:{o}"],
                   holder="fst", tag=f"fst{scale}")
        assert sorted(out["jax"]) == sorted(out["port"]) == sorted(s["feats"])
        for k, got in out["port"].items():
            gp, wp = word_fst_paths(got), word_fst_paths(out["jax"][k])
            assert sorted(gp) == sorted(wp)
            np.testing.assert_allclose([gp[x] for x in sorted(gp)], [wp[x] for x in sorted(wp)],
                                       rtol=F32_REL)
    out = both(s, ["lattice-interp", "--alpha=0.7", "--acoustic-scale2=1.0", "ark:{lat}",
                   f"ark:{p('lt_port_lattice-add-penalty')}", "ark:{o}"], holder="lat")
    assert sorted(out["jax"]) == sorted(out["port"]) == sorted(s["feats"])
    for k, got in out["port"].items():
        want = out["jax"][k]
        gn, wn = lattice_nbest(got, 10, 1.0, 1.0), lattice_nbest(want, 10, 1.0, 1.0)
        assert [w for w, _ in gn] == [w for w, _ in wn]
        np.testing.assert_allclose([c for _, c in gn], [c for _, c in wn], rtol=F32_REL)
        gb, wb = lattice_best_path(got, 1.0, 1.0), lattice_best_path(want, 1.0, 1.0)
        assert gb[:2] == wb[:2]
    out = both(s, ["lattice-confidence", "--acoustic-scale=1.0", "ark:{lat}", "ark,t:{o}"],
               holder="flt")
    assert out["jax"] == out["port"] and len(out["port"]) == 4
    ctm = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        ctm[name] = run(capsys, fn, "lattice-to-ctm-conf", "--acoustic-scale=1.0", s["mono"],
                        p("lang"), f"ark:{p('lt_lat.ark')}", "-")
    assert ctm["jax"] == ctm["port"] and ctm["port"][0] == 0
    words = read_table(f"ark:{p('lt_bp.txt')}", "text")
    assert len(ctm["port"][1].splitlines()) == sum(len(v.split()) for v in words.values())
    assert os.path.exists(p("lt_port_lattice-confidence"))


def test_vector_feature_info_and_fst_tools_equal_the_jax_tools(s, capsys):
    """vector-scale / vector-sum (by key and --sum-all), feat-to-dim,
    feat-to-len, wav-to-duration, and the fstbin extras on the shared
    system's L_disambig composed with a unigram G: files byte for byte,
    what they print and their exit codes the JAX tools'."""
    from old_kaldi_git_tpu_torch.fst.vector_fst import VectorFst, linear_fst
    from old_kaldi_git_tpu_torch.lm.arpa import arpa_to_fst, parse_arpa

    p = s["p"]
    with TableWriter(f"ark:{p('lt_vec.ark')}", "vec") as w:
        for k, f in sorted(s["feats"].items()):
            w[k] = f.mean(0)
    for argv in (["vector-scale", "--scale=-1.5", f"ark:{p('lt_vec.ark')}", "ark:{o}"],
                 ["vector-sum", f"ark:{p('lt_vec.ark')}", f"ark:{p('lt_vec.ark')}", "ark:{o}"],
                 ["vector-sum", "--sum-all", f"ark:{p('lt_vec.ark')}", "{o}"],
                 ["feat-to-len", f"ark:{p('feats.ark')}", "ark,t:{o}"],
                 ["feat-to-dim", f"ark:{p('feats.ark')}", "ark,t:{o}"],
                 ["wav-to-duration", f"scp:{p('wav.scp')}", "ark,t:{o}"]):
        out = both(s, argv, tag=f"{argv[0]}{len(argv)}")
        assert out["jax"] == out["port"] and out["port"], argv[0]
    printed = {}
    for name, fn in (("jax", jax_tool), ("port", port_tool)):
        printed[name] = run(capsys, fn, "feat-to-dim", f"ark:{p('feats.ark')}", "-")
    assert printed["jax"] == printed["port"] == (0, "39\n")
    with open(p("lang", "words.txt")) as f:
        words = [ln.split()[0] for ln in f if not ln.startswith(("<", "#"))][:20]
    with open(p("lt_g.arpa"), "w") as f:
        f.write("\\data\\\nngram 1=%d\n\n\\1-grams:\n" % (len(words) + 2)
                + "".join(f"-1.3\t{w}\n" for w in words) + "-1.3\t</s>\n-99\t<s>\n\n\\end\\\n")
    from old_kaldi_git_tpu_torch.fst.symbols import SymbolTable

    with open(p("lt_G.fst"), "wb") as f:
        arpa_to_fst(parse_arpa(open(p("lt_g.arpa")).read()),
                    SymbolTable.read(p("lang", "words.txt"))).write(f)
    with open(p("lang", "phones.txt")) as f:
        disambig = [ln.split()[1] for ln in f if ln.startswith("#")]
    with open(p("lt_disambig.int"), "w") as f:
        f.write("\n".join(disambig) + "\n")
    for name, fst in (("lt_top.fst", linear_fst([5, 1, 6])), ("lt_sub.fst", linear_fst([7]))):
        with open(p(name), "wb") as f:
            fst.write(f)
    L = p("lang", "L_disambig.fst")
    for argv in (["fsttablecompose", L, p("lt_G.fst"), "{o}"],
                 ["fstaddsubsequentialloop", "999", p("lt_jax_fsttablecompose4"), "{o}"],
                 ["fstcomposecontext", f"--read-disambig-syms={p('lt_disambig.int')}",
                  "{o}.ilabels", p("lt_jax_fsttablecompose4"), "{o}"],
                 ["fstcomposecontext", "--context-size=2", "--central-position=1",
                  "{o}.ilabels", p("lt_jax_fsttablecompose4"), "{o}"],
                 ["make-grammar-fst", p("lt_top.fst"), "1", p("lt_sub.fst"), "{o}"]):
        out = both(s, argv, tag=f"{argv[0]}{len(argv)}")
        assert out["jax"] == out["port"] and out["port"], argv[0]
        if argv[0] == "fstcomposecontext":
            tag = f"{argv[0]}{len(argv)}"
            assert _bytes(p(f"lt_jax_{tag}.ilabels")) == _bytes(p(f"lt_port_{tag}.ilabels"))
    with open(p("lt_jax_fstcomposecontext6"), "rb") as f:
        assert VectorFst.read(f).num_states > 100
    for argv in (["fstisstochastic", p("lt_G.fst")], ["fstisstochastic", L],
                 ["fstequivalent", p("lt_jax_fsttablecompose4"), p("lt_port_fsttablecompose4")],
                 ["fstequivalent", "--max-len=4", p("lt_top.fst"), p("lt_sub.fst")]):
        printed = {}
        for name, fn in (("jax", jax_tool), ("port", port_tool)):
            printed[name] = run(capsys, fn, *argv)
        assert printed["jax"] == printed["port"] and printed["port"][1], argv
    assert printed["port"] == (1, "NOT equivalent\n")
