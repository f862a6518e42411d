"""Data and tensor parallelism over ``torch.distributed``."""

from eda_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_rows_for_ranks,
    init_from_env,
    init_process_group,
    make_global_batch,
    make_mesh,
    process_batch_rows,
    shard_params,
    to_host_global,
    tp_param_spec,
)
