"""The parallel layer over ``torch.distributed`` (port of
``mri_interpolation_tpu/parallel``): process groups (``mesh``),
data-parallel fitting and sharded grid evaluation (``data_parallel``), and
the hash table sharded over the ranks (``sharded_table``).

The JAX package's mesh names (``Mesh``, ``NamedSharding``, ``P``,
``replicated``, ``sharded_batch``) describe array shardings and have no
counterpart here; :class:`RankGroup` describes a rank's group instead."""

from .data_parallel import DataParallelTrainer, evaluate_grid_sharded, fit_multi_volume
from .mesh import RankGroup, RankPool, init_from_env, make_mesh
from .sharded_table import (
    ShardedHashTrainer,
    TableShardingPlan,
    evaluate_grid_sharded_table,
    make_sharded_encode,
    plan_table_sharding,
    shard_table,
    sharded_encode_apply,
    unshard_table,
)

__all__ = [
    "DataParallelTrainer",
    "evaluate_grid_sharded",
    "fit_multi_volume",
    "ShardedHashTrainer",
    "evaluate_grid_sharded_table",
    "plan_table_sharding",
    "make_sharded_encode",
    "sharded_encode_apply",
    "shard_table",
    "unshard_table",
    "make_mesh",
    "TableShardingPlan",
    "RankGroup",
    "RankPool",
    "init_from_env",
]
