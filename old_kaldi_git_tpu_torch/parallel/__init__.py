"""Parallelism: device meshes, the data × model training step, the
time-split forward, the graph-sharded decode's process groups and the
scaling harness, on torch.distributed.

Counterpart of old_kaldi_git_tpu/parallel/: data parallelism is the batch
over the mesh's "data" axis with the gradients and batch-norm statistics
summed over it, model parallelism the affine weights split by output over
"model", multi-host `init_distributed`.
"""

from old_kaldi_git_tpu_torch.parallel.mesh import (
    MeshConfig,
    make_mesh,
    replicate,
    shard_batch,
)
