"""Data, spatial and tensor parallelism over ``torch.distributed``
(counterpart of ``diffusionmodel_tpu/parallel``): the process mesh, the
sharding rules (ZeRO-1 included), the transport of H-sharded activations
(``parallel.spatial``) and of output-channel blocks over 'model'
(``parallel.tensor``)."""

from diffusionmodel_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharding,
    all_reduce_mean_,
    batch_sharding,
    broadcast_object,
    image_sharding,
    init_from_env,
    make_mesh,
    mesh_shape,
    opt_state_shardings,
    param_shardings,
    replicated,
)
