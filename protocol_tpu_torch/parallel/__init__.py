"""Device-mesh parallelism on torch: the counterpart of
``protocol_tpu/parallel/``. One process drives every shard of a
``Mesh`` (an ordered list of torch devices, which may repeat one card);
the collectives are plain functions over per-shard tensors
(``parallel.mesh``). Row-sharded gather and Clos-routed converges, the
checkpointed loop, lane-sharded ingest (``parallel.ingest``), the
sharded NTT (``parallel.ntt``) and the sharded round 3 of the prover
(``parallel.prover``)."""

from .mesh import make_mesh, rows_axis
from .converge import (
    ShardedOperator,
    build_sharded_operator,
    place_sharded,
    sharded_converge_fixed,
    sharded_converge_adaptive,
)
from .checkpointed import run_with_retries, sharded_converge_checkpointed
from .routed import (
    ShardedRoutedOperator,
    build_sharded_routed_operator,
    place_sharded_routed,
    sharded_routed_converge_fixed,
    sharded_routed_converge_adaptive,
)

__all__ = [
    "make_mesh",
    "rows_axis",
    "ShardedOperator",
    "build_sharded_operator",
    "place_sharded",
    "sharded_converge_fixed",
    "sharded_converge_adaptive",
    "sharded_converge_checkpointed",
    "run_with_retries",
    "ShardedRoutedOperator",
    "build_sharded_routed_operator",
    "place_sharded_routed",
    "sharded_routed_converge_fixed",
    "sharded_routed_converge_adaptive",
]
