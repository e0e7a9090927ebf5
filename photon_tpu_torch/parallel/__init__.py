from photon_tpu_torch.parallel.mesh import (  # noqa: F401
    BATCH_AXIS,
    ENTITY_AXIS,
    make_mesh,
    replicate,
    shard_batch,
)
