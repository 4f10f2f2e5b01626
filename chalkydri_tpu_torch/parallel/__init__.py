"""A rig over several devices (port of ``chalkydri_tpu/parallel``): cameras
data-parallel over the ``data`` axis of a device grid, and the rows of each
frame banded over its ``space`` axis through the whole detect -> pose step.

One process drives every device of the grid (``mesh``); the exchanges
between bands are plain functions over the list of band tensors
(``collectives``).
"""

from chalkydri_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    frame_sharding,
    make_mesh,
    replicated,
)
from chalkydri_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_sharded_vision_pipeline,
)
from chalkydri_tpu_torch.parallel.sharded_stages import (  # noqa: F401
    sharded_adaptive_threshold,
)
