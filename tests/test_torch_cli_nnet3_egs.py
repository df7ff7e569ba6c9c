"""The egs and chain graph tools of the port's CLI against the JAX package's,
on the CPU (tools in-process, the port's with --device=cpu where they take
it), on tests/torch_cli_system.py's `train_system()`: tri.mdl's equal
alignments of 4 utterances.

Every archive, phone LM and tree is held byte for byte to the JAX tool's on
the same inputs, and each package's tools read the other's archives; the
den graph, which each package writes in its own format, array for array
(the JAX pickle through convert); chain egs from either den file are the
same bytes.  A biphone tree's den graph is refused by both packages'
chain-make-den-fst: the phone LM read from its file has lost the state
histories the biphone windows need (ROADMAP queue 3)."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import both, port_tool, read_bytes, train_system


@pytest.fixture(scope="module")
def s():
    """train_system() and, from each package's tools: the pdf alignments,
    CE egs of 32 frames, phone sequences, the order-2 phone LM, the
    monophone chain tree, its den graph and the chain egs."""
    t = train_system()
    p = t["p"]
    both("ali-to-pdf", t["tri"], t["ali"], f"ark:{p('{out}_pdf.ark')}")
    both("nnet3-get-egs", "--frames-per-eg=32", t["feats_r"], f"ark:{p('{out}_pdf.ark')}",
         f"ark:{p('{out}_egs.ark')}")
    both("ali-to-phones", t["tri"], t["ali"], f"ark:{p('{out}_ph.ark')}")
    both("chain-est-phone-lm", "--ngram-order=2", f"ark:{p('{out}_ph.ark')}",
         p("{out}_lm.fst"))
    both("chain-build-tree", t["tri"], t["feats_r"], t["ali"], p("{out}_ctree1"))
    both("chain-make-den-fst", p("{out}_ctree1"), p("{out}_lm.fst"), p("{out}_den"))
    both("nnet3-chain-get-egs", t["tri"], p("{out}_ctree1"), p("{out}_den"), t["feats_r"],
         t["ali"], f"ark:{p('{out}_cegs.ark')}")
    return t


def _same_files(p, *names):
    for n in names:
        assert read_bytes(p(f"jax_{n}")) == read_bytes(p(f"port_{n}")), n


def test_get_egs_and_the_graph_inputs_are_the_jax_bytes(s):
    p = s["p"]
    _same_files(p, "pdf.ark", "egs.ark", "ph.ark", "lm.fst", "ctree1", "cegs.ark")
    egs = read_table(f"ark:{p('port_egs.ark')}", "egs")
    assert len(egs) >= 4 and all(e.feats.shape[0] <= 32 for e in egs.values())
    cegs = read_table(f"ark:{p('port_cegs.ark')}", "cegs")
    assert sorted(cegs) == [f"{k}-0" for k in s["keys"]]


@pytest.mark.parametrize("src", ["jax", "port"])
@pytest.mark.parametrize("chain", [False, True])
def test_copy_shuffle_merge_equal_the_jax_tools_on_either_archive(s, src, chain):
    """Each package's tools on the archive either package wrote: the same
    bytes (round-robin copy to 2 outputs, shuffle by --srand, merge)."""
    p = s["p"]
    ark = f"ark:{p(src + ('_cegs.ark' if chain else '_egs.ark'))}"
    pre = "nnet3-chain-" if chain else "nnet3-"
    tag = f"_{src}_{int(chain)}"
    both(pre + "shuffle-egs", "--srand=5", ark, f"ark:{p('{out}_shuf' + tag)}")
    both(pre + "copy-egs", ark, f"ark:{p('{out}_c0' + tag)}", f"ark:{p('{out}_c1' + tag)}")
    both(pre + "merge-egs", f"ark:{p('jax_shuf' + tag)}", f"ark:{p('{out}_merged' + tag)}")
    _same_files(p, "shuf" + tag, "c0" + tag, "c1" + tag, "merged" + tag)
    holder = "cegs" if chain else "egs"
    whole = read_table(ark, holder)
    merged = read_table(f"ark:{p('port_merged' + tag)}", holder)
    assert sorted(merged) == sorted(whole)
    lengths = [e.feats.shape[0] for e in merged.values()]
    assert lengths == sorted(lengths)
    halves = [read_table(f"ark:{p(f'port_c{i}' + tag)}", holder) for i in (0, 1)]
    assert list(halves[0]) == list(whole)[0::2] and list(halves[1]) == list(whole)[1::2]


@pytest.mark.parametrize("width", [1, 2])
def test_chain_build_tree_is_the_jax_tree(s, width):
    p = s["p"]
    both("chain-build-tree", f"--context-width={width}", "--max-leaves=40", "--thresh=10",
         s["tri"], s["feats_r"], s["ali"], p(f"{{out}}_ctree_w{width}"))
    _same_files(p, f"ctree_w{width}")


def test_chain_make_den_fst_arrays_equal_the_jax_pickle(s):
    from old_kaldi_git_tpu_torch.bin.nnet3_tools import read_den_graph

    p = s["p"]
    assert read_bytes(p("port_den"))[:2] == b"PK"  # torch.save's zip
    j, t = read_den_graph(p("jax_den")), read_den_graph(p("port_den"))
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        assert (np.array_equal(a, b) and a.dtype == b.dtype) if isinstance(a, np.ndarray) \
            else a == b, f.name


def test_chain_get_egs_gives_the_same_bytes_from_either_den_file(s):
    p = s["p"]
    for den in ("jax_den", "port_den"):
        assert port_tool("nnet3-chain-get-egs", s["tri"], p("jax_ctree1"), p(den),
                         s["feats_r"], s["ali"], f"ark:{p('x_' + den + '.ark')}") == 0
        assert read_bytes(p("x_" + den + ".ark")) == read_bytes(p("jax_cegs.ark"))
    # no alignment for any utterance: no egs, exit 1 in both packages
    open(p("no_ali.ark"), "wb").close()
    both("nnet3-chain-get-egs", s["tri"], p("jax_ctree1"), p("jax_den"), s["feats_r"],
         f"ark:{p('no_ali.ark')}", f"ark:{p('{out}_none.ark')}", rc=1)


def test_a_biphone_den_graph_is_refused_by_both_packages(s, capsys):
    """Queue 3: the phone LM's file carries no state histories, so
    chain-make-den-fst refuses a left-biphone tree in both packages."""
    p = s["p"]
    both("chain-build-tree", "--context-width=2", "--max-leaves=40", "--thresh=10",
         s["tri"], s["feats_r"], s["ali"], p("{out}_ctree2"))
    capsys.readouterr()
    both("chain-make-den-fst", p("{out}_ctree2"), p("{out}_lm.fst"), p("{out}_den2"), rc=1)
    err = capsys.readouterr().err
    assert err.count("biphone den graph needs a phone LM with state histories") == 2
