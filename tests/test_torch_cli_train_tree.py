"""The port's tree tools against the JAX package's, on the CPU: every file
byte for byte.

acc-tree-stats on tri.mdl's equal alignments of the 4 utterances of the
shared system (tests/torch_cli_system.py), sum-tree-stats of two halves
(each package summing the other's files), cluster-phones and
compile-questions, build-tree with and without the questions file, and
build-tree-two-level (the tree and the leaf → cluster map), all at sizes
where the JAX package's cluster_leaves (a scan of every pair at each merge)
takes under a second."""

import tests.torch_threads  # noqa: F401

import pytest

from old_kaldi_git_tpu_torch.utils.table import TableWriter
from tests.torch_cli_system import both, jax_tool, port_tool, read_bytes, train_system

PHONES = ":".join(str(i) for i in range(1, 42))  # SIL and p00..p39


@pytest.fixture(scope="module")
def s():
    s = train_system()
    p = s["p"]
    keys = s["keys"]
    for half, ks in (("a", keys[:2]), ("b", keys[2:])):
        with TableWriter(f"ark:{p('t_feats_' + half + '.ark')}", "mat") as w:
            for k in ks:
                w[k] = s["feats"][k]
    assert port_tool("acc-tree-stats", s["tri"], s["feats_r"], s["ali"], p("t_whole.stats")) == 0
    assert port_tool("cluster-phones", p("t_whole.stats"), PHONES, p("t_q.txt")) == 0
    return s


def test_acc_tree_stats_writes_the_jax_tools_stats(s):
    p = s["p"]
    both("acc-tree-stats", s["tri"], s["feats_r"], s["ali"], p("{out}_t.stats"))
    assert read_bytes(p("jax_t.stats")) == read_bytes(p("port_t.stats"))
    both("acc-tree-stats", "--context-width=2", "--central-position=1", s["tri"], s["feats_r"],
         s["ali"], p("{out}_t2.stats"))
    assert read_bytes(p("jax_t2.stats")) == read_bytes(p("port_t2.stats"))


def test_sum_tree_stats_of_halves_is_the_whole_in_both_packages(s):
    p = s["p"]
    for half in ("a", "b"):
        both("acc-tree-stats", s["tri"], f"ark:{p('t_feats_' + half + '.ark')}", s["ali"],
             p("{out}_" + half + ".stats"))
        assert read_bytes(p("jax_" + half + ".stats")) == read_bytes(p("port_" + half + ".stats"))
    assert jax_tool("sum-tree-stats", p("jax_sum.stats"), p("port_a.stats"),
                    p("port_b.stats")) == 0
    assert port_tool("sum-tree-stats", p("port_sum.stats"), p("jax_a.stats"),
                     p("jax_b.stats")) == 0
    assert read_bytes(p("jax_sum.stats")) == read_bytes(p("port_sum.stats"))
    # the halves' sums differ from the whole's only where an event's Σx was
    # added in another order: same events, counts equal
    from old_kaldi_git_tpu_torch.tree.build_tree import read_tree_stats

    with open(p("port_sum.stats"), "rb") as f, open(p("t_whole.stats"), "rb") as g:
        a, b = read_tree_stats(f), read_tree_stats(g)
    assert list(a) == list(b) and all(a[e].count == b[e].count for e in a)


def test_cluster_phones_and_compile_questions_write_the_jax_tools_questions(s):
    p = s["p"]
    both("cluster-phones", p("t_whole.stats"), PHONES, p("{out}_q.txt"))
    assert read_bytes(p("jax_q.txt")) == read_bytes(p("port_q.txt"))
    with open(p("t_q_extra.txt"), "w") as f:
        f.write(open(p("port_q.txt")).read() + "2 3 999\n3 2\n\n")
    both("compile-questions", s["tri"], p("t_q_extra.txt"), p("{out}_cq.txt"))
    assert read_bytes(p("jax_cq.txt")) == read_bytes(p("port_cq.txt"))


@pytest.mark.parametrize("questions", [False, True])
def test_build_tree_writes_the_jax_tools_tree(s, questions):
    p = s["p"]
    opts = [f"--questions={p('t_q.txt')}"] if questions else []
    tag = "_q" if questions else ""
    both("build-tree", "--max-leaves=30", "--thresh=10", *opts, p("t_whole.stats"), s["tri"],
         p("{out}_tree" + tag))
    assert read_bytes(p("jax_tree" + tag)) == read_bytes(p("port_tree" + tag))


def test_build_tree_two_level_writes_the_jax_tools_tree_and_map(s):
    from old_kaldi_git_tpu_torch.utils.io_funcs import init_kaldi_input_stream, read_int_vector

    p = s["p"]
    both("build-tree-two-level", "--max-leaves-second=30", "--max-leaves-first=8",
         "--thresh=10", p("t_whole.stats"), s["tri"], p("{out}_tree2"), p("{out}_map"))
    assert read_bytes(p("jax_tree2")) == read_bytes(p("port_tree2"))
    assert read_bytes(p("jax_map")) == read_bytes(p("port_map"))
    with open(p("port_map"), "rb") as f:
        init_kaldi_input_stream(f)
        mapping = read_int_vector(f)
    assert sorted(set(mapping.tolist())) == list(range(8))
