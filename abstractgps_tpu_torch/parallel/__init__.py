"""Multi-process SPMD execution over ``torch.distributed``: meshes, the
data-parallel collapsed ELBO and training loop, the tensor-parallel exact
GP (the block-cyclic distributed Cholesky, ``sharded_logpdf``,
``sharded_mean_and_var``), and the multi-process runtime. Counterpart of
the JAX package's ``parallel`` layer (``P`` and ``NamedSharding`` have no
counterpart: a shard here is this rank's block, ``shard_along``)."""

from .data_parallel import ShardedFitResult, fit_sharded
from .mesh import make_mesh, replicate, shard_along
from .multihost import (
    host_local_array,
    initialize_distributed,
    is_distributed,
    make_pod_mesh,
)
from .sharded_linalg import (
    distributed_cholesky,
    sharded_gram,
    sharded_logpdf,
    sharded_mean_and_var,
)

__all__ = [
    "make_mesh",
    "shard_along",
    "replicate",
    "fit_sharded",
    "ShardedFitResult",
    "distributed_cholesky",
    "sharded_gram",
    "sharded_logpdf",
    "sharded_mean_and_var",
    "initialize_distributed",
    "is_distributed",
    "make_pod_mesh",
    "host_local_array",
]
