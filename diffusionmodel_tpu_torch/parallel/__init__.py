"""Data parallelism over ``torch.distributed`` (counterpart of
``diffusionmodel_tpu/parallel``): the process mesh, the sharding rules
(ZeRO-1 included) and the pooled statistics of H-sharded activations."""

from diffusionmodel_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharding,
    all_reduce_mean_,
    batch_sharding,
    broadcast_object,
    check_supported,
    init_from_env,
    make_mesh,
    mesh_shape,
    opt_state_shardings,
    param_shardings,
    replicated,
)
