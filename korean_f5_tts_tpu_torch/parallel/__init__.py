from korean_f5_tts_tpu_torch.parallel.mesh import (
    make_mesh,
    param_partition_spec,
    shard_batch,
    shard_params,
)

__all__ = ["make_mesh", "param_partition_spec", "shard_batch", "shard_params"]
