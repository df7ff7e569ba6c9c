"""Rank function of tests/test_torch_parallel.py (not a test module).

The test file starts one spawn of four gloo ranks
(parallel/scaling.run_ranks); the children import this module, which
imports torch, numpy and the port only (no JAX, no conftest).  Each rank
runs every multi-rank case and returns its results."""

import os

import numpy as np
import torch
import torch.distributed as dist


def cases(graphs: dict) -> dict:
    from old_kaldi_git_tpu_torch.decoder.csr import CsrGraph
    from old_kaldi_git_tpu_torch.decoder.sharded import (
        ProcessGroupShards, decode_batch_tokens_sharded)
    from old_kaldi_git_tpu_torch.decoder.viterbi import ViterbiOptions
    from old_kaldi_git_tpu_torch.parallel.dryrun import dryrun_multichip
    from old_kaldi_git_tpu_torch.parallel.mesh import (
        MeshConfig, make_mesh, replicate, shard_batch)

    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}
    pair = dist.new_group([0, 1])
    # the graph-sharded decode through the process group: the world (N = 4)
    # and the pair of ranks 0 and 1 (N = 2)
    for name, (fields, ll, nf, opts) in graphs.items():
        g = CsrGraph(**fields)
        vopts = ViterbiOptions(**opts)
        for n, grp in ((world, None), (2, pair)):
            if grp is pair and rank > 1:
                continue
            dec = decode_batch_tokens_sharded(g, ll, nf, group=ProcessGroupShards(grp),
                                              opts=vopts, want_lattice=True)
            res[(name, n)] = [None if r is None else
                              (r.words, r.alignment, r.cost, r.frame_states) for r in dec]
    # the mesh helpers
    mesh = make_mesh(MeshConfig(model=2))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    res["shard_batch"] = shard_batch(mesh, {"x": x})["x"].numpy()
    res["mesh_coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    mine = torch.full((2,), float(rank))
    res["replicate"] = replicate(mesh, mine).numpy()
    # the dry run, as this rank of the world
    res["dryrun"] = dryrun_multichip(world)
    res["pid"] = os.getpid()
    return res
