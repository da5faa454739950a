"""Device-mesh parallelism (walker sharding, replacing threads/MPIPool).

``mesh``: single-host walker-axis sharding over local devices.
``distributed``: multi-host runtime wiring (``jax.distributed``) and
global-mesh helpers — the multi-host path replacing the reference's MPI pool.
"""

from . import distributed  # noqa: F401
from .mesh import (WALKER_AXIS, make_mesh, make_sharded_logp_batch,
                   make_sharded_pt_batch, replicate)  # noqa: F401
