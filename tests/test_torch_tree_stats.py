"""The port's tree-statistics I/O and leaf clustering against the JAX
package's (tree/build_tree.py `write_tree_stats`, `read_tree_stats`,
`sum_tree_stats`, `cluster_leaves`), on the CPU.

The statistics of tri.mdl's equal alignments of the 4 utterances of the
shared system (tests/torch_cli_system.py), accumulated by each package's
library: the files byte for byte both ways, each package reading the
other's; the sum of two halves; and cluster_leaves' map on the port's
tree, equal to the JAX package's exhaustive scan (the port keeps the pair
losses between merges) at several cluster counts."""

import tests.torch_threads  # noqa: F401
import importlib
import io

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.gmm.diag_gmm import AmGmmModel
from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import train_system

# (the JAX package's tree/__init__ exports the function build_tree under the
# module's name)
jbt = importlib.import_module("old_kaldi_git_tpu.tree.build_tree")
jcd = importlib.import_module("old_kaldi_git_tpu.tree.context_dep")
tbt = importlib.import_module("old_kaldi_git_tpu_torch.tree.build_tree")


def _bytes(write, stats) -> bytes:
    buf = io.BytesIO()
    write(buf, stats)
    return buf.getvalue()


def _reader(data: bytes):
    return io.BufferedReader(io.BytesIO(data))


@pytest.fixture(scope="module")
def stats():
    """(port stats, JAX stats) of the whole set, and of its two halves."""
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm

    s = train_system()
    ali = read_table(s["ali"], "ivec")
    ttm = AmGmmModel.load(s["tri"], device="cpu").tm
    jtm = jgmm.AmGmmModel.load(s["tri"]).tm
    out = {}
    for name, keys in (("all", s["keys"]), ("a", s["keys"][:2]), ("b", s["keys"][2:])):
        t, j = {}, {}
        for k in keys:
            tbt.accumulate_tree_stats(ali[k], s["feats"][k], ttm, stats=t)
            jbt.accumulate_tree_stats(ali[k], s["feats"][k], jtm, stats=j)
        out[name] = (t, j)
    return out


def test_tree_stats_files_are_the_jax_packages_both_ways(stats):
    t, j = stats["all"]
    data = _bytes(tbt.write_tree_stats, t)
    assert data == _bytes(jbt.write_tree_stats, j)
    back_t = tbt.read_tree_stats(_reader(_bytes(jbt.write_tree_stats, j)))
    back_j = jbt.read_tree_stats(_reader(data))
    assert list(back_t) == list(back_j) == sorted(t)
    for e in back_t:
        assert back_t[e].count == back_j[e].count
        np.testing.assert_array_equal(back_t[e].x, back_j[e].x)
        np.testing.assert_array_equal(back_t[e].x2, back_j[e].x2)
    assert _bytes(tbt.write_tree_stats, back_t) == data


def test_sum_tree_stats_equals_the_jax_packages(stats):
    (ta, ja), (tb, jb) = stats["a"], stats["b"]
    tot_t = tbt.sum_tree_stats({}, ta)
    tbt.sum_tree_stats(tot_t, tb)
    tot_j = jbt.sum_tree_stats({}, ja)
    jbt.sum_tree_stats(tot_j, jb)
    assert _bytes(tbt.write_tree_stats, tot_t) == _bytes(jbt.write_tree_stats, tot_j)
    assert ta[next(iter(ta))] is not tot_t[next(iter(ta))]  # copies, not the halves' objects
    assert sorted(tot_t) == sorted(stats["all"][0])


@pytest.fixture(scope="module")
def trees(stats):
    """The port's 50-leaf tree of the stats, and the JAX package's reading
    of its file."""
    t, _ = stats["all"]
    topo = AmGmmModel.load(train_system()["tri"], device="cpu").tm.topo
    phones = topo.phones
    tree = tbt.build_tree(t, phones, {p: topo.num_pdf_classes(p) for p in phones},
                          max_leaves=50, thresh=10.0)
    buf = io.BytesIO()
    tree.write(buf)
    return tree, jcd.ContextDependency.read(_reader(buf.getvalue()))


@pytest.mark.parametrize("num_clusters", [1, 7, 25, 200])
def test_cluster_leaves_gives_the_jax_packages_map(stats, trees, num_clusters):
    t, j = stats["all"]
    tree, jtree = trees
    got = tbt.cluster_leaves(t, tree, num_clusters)
    assert got == jbt.cluster_leaves(j, jtree, num_clusters)
    assert len(got) == tree.num_pdfs
    assert max(got) + 1 == min(num_clusters, len(set(got)))
