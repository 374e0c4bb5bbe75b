"""Mesh and sharding utilities over torch.distributed: the replacement for
run.pl/queue.pl job arrays and filesystem reduces (SURVEY.md §2.11).
Counterpart of kaldi_tpu/parallel; one process drives one device."""

from kaldi_tpu_torch.parallel.mesh import make_mesh, data_parallel_sharding
from kaldi_tpu_torch.parallel.mesh import batch_sharding, decode_sharded
from kaldi_tpu_torch.parallel.frontier_decode import decode_frontier_sharded
from kaldi_tpu_torch.parallel.launch import (init_distributed, global_mesh,
                                             host_shard, launch_local)
