"""Multi-rank training over the mesh's five axes (port of
``musketeer_tpu/parallel``): ``data`` and ``fsdp`` (``data_parallel.py``),
``model`` (``tensor_parallel.py``), ``pipe`` (``pipeline.py``) and ``seq``
(``ring_attention.py``).

``DataParallel`` and ``init_distributed`` are imported on first use: the
model imports the axes' modules, and ``data_parallel`` the training step."""

from .mesh import (
    AXES, DATA, FSDP, MODEL, PIPE, SEQ, Mesh, batch_block, get_mesh, leaf_spec, make_mesh,
    param_spec, set_mesh, shard_batches,
)

__all__ = ["AXES", "DATA", "DataParallel", "FSDP", "MODEL", "Mesh", "PIPE", "SEQ", "batch_block",
           "get_mesh", "init_distributed", "leaf_spec", "make_mesh", "param_spec", "set_mesh",
           "shard_batches"]


def __getattr__(name: str):
    if name in ("DataParallel", "init_distributed"):
        from . import data_parallel

        return getattr(data_parallel, name)
    raise AttributeError(name)
