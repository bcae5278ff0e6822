"""The device mesh (counterpart of `vitiq/parallel`): `mesh.py` holds the
mesh, its sharding rules and the gathers, `comm.py` the process groups and
collectives."""

from vitiq_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated_sharding,
    shard_batch,
    shard_params,
)
