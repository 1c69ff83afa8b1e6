"""The split of a run over torch.distributed ranks (the counterpart of
fscl_tpu/parallel/): mesh.py places a process, shard.py exchanges the
host arrays of its share."""

from .mesh import SOLO, Split, close_split, init_split  # noqa: F401
from .shard import (  # noqa: F401
    gather_cols,
    gather_rows,
    psum_counts,
    split_range,
)
