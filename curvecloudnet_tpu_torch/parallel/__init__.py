"""Scale-out: data-parallel training over processes (counterpart of
``curvecloudnet_tpu/parallel``).  The JAX package shards the batch over a
device mesh and lets XLA place the collectives; the port runs a process
a device (or several on one card, with gloo) and sums the step's
statistics, loss terms and gradients over them where the step forms them
(``parallel/mesh.py``)."""

from .mesh import (
    agree,
    all_gather_rows,
    all_reduce_sum,
    backend_for,
    barrier,
    broadcast_state,
    collective_timer,
    global_rows,
    initialize_distributed,
    is_primary,
    local,
    local_device,
    merge_moments,
    moments,
    process_count,
    process_index,
    process_shard_range,
    rand_rows,
    reduce_sum,
    shard_batch,
    sharded_eval_step,
    sharded_train_step,
    shutdown,
    sum_gradients,
    with_value,
    world,
)

__all__ = [
    "agree", "all_gather_rows", "all_reduce_sum", "backend_for", "barrier",
    "broadcast_state", "collective_timer", "global_rows",
    "initialize_distributed", "is_primary", "local", "local_device",
    "merge_moments", "moments", "process_count", "process_index",
    "process_shard_range", "rand_rows", "reduce_sum", "shard_batch",
    "sharded_eval_step", "sharded_train_step", "shutdown", "sum_gradients",
    "with_value", "world",
]
