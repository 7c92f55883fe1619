"""Data and spatial parallelism over ``torch.distributed`` (counterpart
of ``diffusionmodel_tpu/parallel``): the process mesh, the sharding rules
(ZeRO-1 included) and the transport of H-sharded activations
(``parallel.spatial``)."""

from diffusionmodel_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharding,
    all_reduce_mean_,
    batch_sharding,
    broadcast_object,
    check_supported,
    image_sharding,
    init_from_env,
    make_mesh,
    mesh_shape,
    opt_state_shardings,
    param_shardings,
    replicated,
)
