from rumpy_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    get_mesh,
    local_batch_size,
    replicate,
    shard_batch,
)
