"""Multi-rank training over the mesh's ``data`` and ``fsdp`` axes (port of
``musketeer_tpu/parallel``; the ``model``, ``pipe`` and ``seq`` axes are not
ported)."""

from .data_parallel import DataParallel, init_distributed
from .mesh import (
    AXES, DATA, FSDP, MODEL, PIPE, SEQ, Mesh, batch_block, leaf_spec, make_mesh, param_spec,
    shard_batches,
)

__all__ = ["AXES", "DATA", "DataParallel", "FSDP", "MODEL", "Mesh", "PIPE", "SEQ", "batch_block",
           "init_distributed", "leaf_spec", "make_mesh", "param_spec", "shard_batches"]
