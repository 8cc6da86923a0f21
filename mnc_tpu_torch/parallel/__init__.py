"""Parallel training and evaluation on ``torch.distributed`` — port of
``mnc_tpu/parallel`` (data parallelism, tensor-parallel fc heads, a
height-sharded trunk)."""

from mnc_tpu_torch.parallel.spatial import shard_image, spatial_trunk_features  # noqa: F401
from mnc_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_eval_step,
    data_parallel_train_step,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from mnc_tpu_torch.parallel.tensor import (  # noqa: F401
    hybrid_parallel_train_step,
    mnc_tp_shardings,
    shard_train_state,
)
