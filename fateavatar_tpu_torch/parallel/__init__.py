"""Multi-device training over ``torch.distributed``: data parallel
(``data_parallel``), splat-sharded rendering (``splat_parallel``) and the
2-D (data, gauss) layout (``mesh2d``). Port of ``fateavatar_tpu/parallel``."""

from fateavatar_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DeviceMesh,
    make_device_mesh,
    make_dp_train_step,
    replicate,
    shard_frames,
    stack_frames,
)
