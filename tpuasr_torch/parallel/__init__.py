"""The parallel layer (port of ``tpuasr/parallel``): the ranks' (data x
model) mesh over torch.distributed, batch sharding, the ZeRO stages and the
sharded streaming decode. `init_distributed` joins the process group. The
JAX package's `batch_sharding`, `replicated_sharding` and
`train_state_shardings` name `NamedSharding` layouts that XLA then places;
here a rank holds its part itself, and `shard_batch` and
`shard_train_state` cut it out. `scaling` records the collectives a step
issues and costs them over a multi-host layout (the JAX package's
`parallel/scaling.py`)."""

from tpuasr_torch.parallel.decode import make_sharded_streaming_decode
from tpuasr_torch.parallel.mesh import (
    Mesh, VocabShard, init_distributed, make_mesh, rank_grid, shard_batch, vocab_range,
)
from tpuasr_torch.parallel.scaling import Collective, record_collectives
from tpuasr_torch.parallel.zero import (
    STAGES, ZeroShard, assert_sharded, shard_train_state, whole_state,
)

__all__ = ["Collective", "Mesh", "STAGES", "VocabShard", "ZeroShard", "assert_sharded",
           "init_distributed", "make_mesh", "make_sharded_streaming_decode", "rank_grid",
           "record_collectives", "shard_batch", "shard_train_state", "vocab_range",
           "whole_state"]
