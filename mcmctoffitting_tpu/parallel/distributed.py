"""Multi-host execution: jax.distributed replaces the MPI pool.

The reference scales past one node with ``emcee.utils.MPIPool`` — a
master/worker task farm where worker ranks sit in ``pool.wait()`` and the
master ships every per-walker lnprob evaluation over MPI
(``tests/mpiTOFmodel.py:187-201``, ``tests/simultFit.py:688-706``).  The
replacement is multi-controller SPMD: every process runs the SAME program,
``jax.distributed.initialize`` wires the processes into one runtime, and
the walker axis is sharded over the GLOBAL device mesh — the per-walker
likelihood work runs on each process's local GPUs, and the only
cross-device traffic is the collectives XLA derives from the shardings
(the small half-ensemble all-gather of the move), which XLA hands to NCCL:
NVLink between the GPUs of one host, the network between hosts.  There is
no master, no task queue, and no hand-written communication backend.  One
process driving all GPUs of a host needs none of this module.

Environment-variable conventions (all optional; flags/args take priority):

  MCMCTOF_COORDINATOR   host:port of process 0 (jax coordinator)
  MCMCTOF_NUM_PROCESSES total process count
  MCMCTOF_PROCESS_ID    this process's rank

On plain GPU hosts nothing discovers these: give all three (e.g.
``localhost:<free port>`` for processes on one host).  The CPU bring-up
uses the same variables (the 2-process virtual test,
``__graft_entry__.dryrun_multihost`` / ``tests/test_distributed.py``).
"""
from __future__ import annotations

import os
from typing import Optional

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import WALKER_AXIS, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join this process into the multi-host runtime.

    Must run before any other jax API touches the backend.  The
    coordinator, process count and rank come from arguments or the
    MCMCTOF_* env vars.  Replaces the reference's MPI rank logic
    (``tests/mpiTOFmodel.py:187-191``): after this call there are no
    ranks to branch on — every process runs the same program over the
    global device set.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "MCMCTOF_COORDINATOR")
    if num_processes is None and "MCMCTOF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MCMCTOF_NUM_PROCESSES"])
    if process_id is None and "MCMCTOF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MCMCTOF_PROCESS_ID"])

    # decide CPU from the environment only — jax.default_backend() would
    # initialize the XLA backend, which must not happen before
    # jax.distributed.initialize()
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        # cross-process collectives on the CPU backend need an explicit
        # implementation; gloo is the portable one
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jax: option absent; single-host CPU still works

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis_name: str = WALKER_AXIS) -> Mesh:
    """1-D walker mesh over the GLOBAL device set (all processes).

    Within one process this is exactly ``make_mesh()``; after
    :func:`initialize` it spans hosts and the walker axis crosses them.
    """
    return make_mesh(None, axis_name)


def make_global_array(x, mesh: Mesh, spec: P = P()):
    """Host data (identical on every process) -> one global jax.Array.

    Every process must pass the same ``x`` (deterministic same-seed host
    computation — the pattern this package's drivers already follow); each
    process contributes its addressable shards.
    """
    import jax
    import numpy as np

    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def replicate_global(tree, mesh: Mesh):
    """Place a pytree (same values on every process) fully replicated."""
    import jax

    return jax.tree.map(lambda x: make_global_array(x, mesh, P()), tree)


def shard_walkers(x, mesh: Mesh, axis_name: str = WALKER_AXIS):
    """Shard axis 0 (walkers) of host data over the global mesh."""
    import jax

    return make_global_array(x, mesh, P(axis_name))
