"""Data parallelism over rays: devices of one process (`mesh`) and
processes of a `torch.distributed` group (`distributed`)."""

from ibl_nerf_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_rays,
    make_sharded_train_step,
)
