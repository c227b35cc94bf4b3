"""The leaf-sharded index on torch.distributed (port of
scann_tpu/parallel/): a ("data", "shard") DeviceMesh, every rank running
the same code on its own coordinate."""

from scann_torch.parallel.build import (build_sharded,
                                        build_sharded_streaming,
                                        sharded_kmeans_step)
from scann_torch.parallel.launch import close, init_mesh, spawn
from scann_torch.parallel.mesh import ShardedTreeAHSearcher, load_sharded

__all__ = ["ShardedTreeAHSearcher", "build_sharded",
           "build_sharded_streaming", "close", "init_mesh", "load_sharded",
           "sharded_kmeans_step", "spawn"]
