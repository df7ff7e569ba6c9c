"""Scale-out on the CPU: process groups, the dry run, the mesh helpers and
the scaling harness.

One spawn of four gloo ranks (`parallel.scaling.run_ranks` of
tests/torch_parallel_ranks.py: one torch thread a rank, a file:// store in
a temporary directory) runs every
multi-rank case: the graph-sharded decode through `ProcessGroupShards` on
the world (N = 4) and on the pair of ranks 0-1 (N = 2), on the JAX test's
random graph and toy yes/no HCLG (tests/test_torch_sharded.py), each equal
to the in-process shards' result exactly (words, alignments, costs,
per-frame token sets); the mesh helpers; and `dryrun_multichip(4)`: the
data × model CE step against the same step on one rank (loss and
parameters within 1e-5), the time-split forward against the unsplit one
(the JAX dry run's 2e-4 absolute / 1e-3 relative), the graph-sharded decode
against the in-process shards.  In this process: the one-rank dry run, the
flagship forward `entry()`, the JAX mesh error, `init_distributed` without
a coordinator and `measure_scaling` over CPU devices."""

import tests.torch_threads  # noqa: F401
import logging

import numpy as np
import pytest
import torch

import old_kaldi_git_tpu_torch.decoder.sharded as tsh
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
from old_kaldi_git_tpu_torch.parallel import dryrun
from old_kaldi_git_tpu_torch.parallel.mesh import MeshConfig, mesh_shape
from old_kaldi_git_tpu_torch.parallel.scaling import (
    init_distributed, measure_scaling, run_ranks)
from tests.test_sharded_decoder import _random_csr
from tests.test_torch_chain import _FIELDS, port_graph
from tests.test_torch_sharded import toy_hclg

WORLD = 4


def _graphs():
    rng = np.random.default_rng(5)
    g = _random_csr(rng)
    ll = rng.normal(size=(5, 30, 20)).astype(np.float32)
    nf = np.array([30, 30, 12, 0, 7], np.int32)
    csr, tll, tnf = toy_hclg()
    return {
        "random": (g, ll, nf, dict(beam=8.0, max_active=64, acoustic_scale=0.5)),
        "toy": (csr, tll, tnf, dict(beam=30.0, max_active=200, acoustic_scale=1.0)),
    }


@pytest.fixture(scope="module")
def spawned():
    from tests.torch_parallel_ranks import cases

    graphs = {k: ({f: getattr(port_graph(g), f) for f in _FIELDS}, ll, nf, o)
              for k, (g, ll, nf, o) in _graphs().items()}
    return dict(enumerate(run_ranks(cases, WORLD, (graphs,), timeout=300.0)))


@pytest.mark.parametrize("name,N", [("random", 4), ("random", 2), ("toy", 4), ("toy", 2)])
def test_process_group_equals_in_process_shards(spawned, name, N):
    g, ll, nf, opts = _graphs()[name]
    want = tsh.decode_batch_tokens_sharded(
        port_graph(g), ll, nf, group=tsh.InProcessShards(["cpu"] * N),
        opts=tvit.ViterbiOptions(**opts), want_lattice=True)
    for rank in range(N):
        got = spawned[rank][(name, N)]
        assert len(got) == len(want)
        for w, r in zip(want, got):
            assert (w is None) == (r is None)
            if w is None:
                continue
            words, ali, cost, states = r
            assert words == w.words
            assert np.array_equal(ali, w.alignment)
            assert cost == w.cost
            assert np.array_equal(states, w.frame_states)


def test_dp_tp_step_equals_the_one_rank_step(spawned):
    for rank in range(WORLD):
        rep = spawned[rank]["dryrun"] if rank == 0 else spawned[0]["dryrun"]
        assert (rep["data"], rep["model"]) == (2, 2)
        assert rep["split_weights"] == 4  # tdnn0, tdnnf1, tdnnf2, prefinal affines
        assert np.isfinite(rep["loss"])
        assert rep["loss_diff"] <= 1e-5
        assert rep["param_diff"] <= 1e-5


def test_time_split_forward_equals_the_unsplit_one(spawned):
    rep = spawned[0]["dryrun"]
    assert rep["seq_out_of_tolerance"] == 0
    assert rep["seq_max_diff"] <= 2e-4


def test_dryrun_decode_equals_in_process_shards(spawned):
    graph, gr = dryrun._random_graph()
    ll = gr.normal(size=(2, 12, 32)).astype(np.float32)
    want = tsh.decode_batch_tokens_sharded(
        graph, ll, [12, 9], group=tsh.InProcessShards(["cpu"] * WORLD),
        opts=tvit.ViterbiOptions(beam=1e9, max_active=64, acoustic_scale=0.1))
    rep = spawned[0]["dryrun"]
    assert rep["decode_costs"] == [r.cost for r in want]
    assert rep["decode_alignments"] == [r.alignment.tolist() for r in want]


def test_mesh_helpers_on_four_ranks(spawned):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for rank in range(WORLD):
        d, m = spawned[rank]["mesh_coords"]
        assert (d, m) == (rank // 2, rank % 2)
        assert np.array_equal(spawned[rank]["shard_batch"], x[4 * d:4 * d + 4])
        assert np.array_equal(spawned[rank]["replicate"], np.zeros(2, np.float32))
    assert len({spawned[r]["pid"] for r in range(WORLD)}) == WORLD


def test_one_rank_dry_run_in_this_process():
    rep = dryrun.dryrun_multichip(1, backend="gloo")
    assert (rep["data"], rep["model"]) == (1, 1)
    assert rep["loss_diff"] == 0.0 and rep["param_diff"] == 0.0
    assert rep["seq_max_diff"] == 0.0
    assert all(np.isfinite(rep["decode_costs"]))
    assert not torch.distributed.is_initialized()


def test_flagship_entry_on_the_cpu():
    fn, (feats,) = dryrun.entry(device="cpu")
    assert tuple(feats.shape) == (4, 64, 40)
    out = fn(feats)
    assert tuple(out.shape) == (4, 64, 6008)
    assert torch.isfinite(out).all()
    cfg = dryrun._flagship(device="cpu").config
    assert (cfg.layers[0].dim, cfg.layers[1].bottleneck_dim, len(cfg.layers)) == (1536, 160, 17)


def test_mesh_shape_and_init_without_coordinator():
    assert mesh_shape(MeshConfig(), 8) == (8, 1)
    assert mesh_shape(MeshConfig(model=2), 8) == (4, 2)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 4 devices"):
        mesh_shape(MeshConfig(data=3, model=2), 4)
    init_distributed(None)
    assert not torch.distributed.is_initialized()


def test_measure_scaling_over_cpu_devices():
    seen, warned = [], []

    def make_step(devs):
        seen.append(len(devs))
        return lambda pieces: [p["x"].sum() for p in pieces]

    class Keep(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    log = logging.getLogger("okt_torch.scaling")
    handler = Keep(logging.WARNING)
    log.addHandler(handler)
    try:
        pts = measure_scaling(make_step, lambda n: {"x": np.ones((2 * n, 16), np.float32)},
                              [1, 2, 4], work_per_batch=1.0, iters=2, devices=["cpu"] * 2)
    finally:
        log.removeHandler(handler)
    assert [p.num_devices for p in pts] == [1, 2] and seen == [1, 2]
    assert pts[0].efficiency == pytest.approx(1.0)
    assert all(p.throughput > 0 for p in pts)
    assert warned == ["skipping N=4 (only 2 devices)"]
