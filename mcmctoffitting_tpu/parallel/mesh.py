"""Multi-chip execution: walker-axis sharding over a device mesh.

Replaces the reference's process-level parallelism — emcee ``threads=N``
multiprocessing pools and ``emcee.utils.MPIPool`` master/worker task farms
(``tests/simultFit.py:688-718``, ``tests/mpiTOFmodel.py:187-201``) — with the
single-controller JAX model: walkers are a sharded array axis on a
``jax.sharding.Mesh``; the expensive per-walker log-probability evaluations
run fully parallel on every device via ``shard_map``; the tiny stretch-move
bookkeeping stays replicated, and XLA inserts the one small all-gather of
half-ensemble log-probs (NCCL over NVLink between the GPUs of one host).
There is no hand-written communication backend — the only collectives are
those XLA derives from the shardings (SURVEY.md §2.4).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WALKER_AXIS = "walkers"


def make_mesh(devices=None, axis_name: str = WALKER_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices: the walker axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_sharded_logp_batch(log_prob_fn, mesh: Mesh, *,
                            stochastic: bool = True,
                            chunk: Optional[int] = None,
                            axis_name: str = WALKER_AXIS):
    """Batched log-prob evaluator with the batch axis sharded over the mesh.

    Inside each shard the walkers are vmapped (optionally lax.map-chunked to
    bound per-chip memory — the Monte-Carlo forward holds O(n_samples *
    x_bins) intermediates per walker).  The returned function has the same
    signature as ``sampler.make_logp_batch``'s result, so it drops into
    ``run_mcmc`` unchanged: sharding is a deployment detail, not an API.
    """
    from ..sampler.stretch import make_logp_batch

    local_batch = make_logp_batch(log_prob_fn, stochastic=stochastic,
                                  chunk=chunk)

    def sharded(thetas, keys):
        n = thetas.shape[0]
        n_dev = mesh.devices.size
        if n % n_dev:
            raise ValueError(
                f"walker half-ensemble {n} not divisible by mesh size "
                f"{n_dev}; choose n_walkers as a multiple of 2*n_devices")
        out = jax.shard_map(
            local_batch, mesh=mesh,
            in_specs=(P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
            check_vma=False,
        )(thetas, keys)
        # move results back to replicated for the (tiny) move bookkeeping
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P()))

    return sharded


def make_sharded_pt_batch(fn, mesh: Mesh, *, stochastic: bool = True,
                          axis_name: str = WALKER_AXIS):
    """(T, W)-batched evaluator for the PT sampler, walker axis sharded.

    The temperature ladder stays replicated (it is small and every rung
    participates in replica exchange each step); within each rung the
    walkers are split over the mesh exactly like the flat ensemble's
    (``make_sharded_logp_batch``).  Drops into ``sample_pt``'s
    ``loglike_batch=`` / ``logprior_batch=`` hooks.
    """
    if stochastic:
        per = fn
    else:
        def per(theta, key):
            del key
            return fn(theta)
    local_batch = jax.vmap(jax.vmap(per))     # (T, W) within the shard

    def sharded(thetas, keys):
        n = thetas.shape[1]
        n_dev = mesh.devices.size
        if n % n_dev:
            raise ValueError(
                f"per-rung walker half-ensemble {n} not divisible by mesh "
                f"size {n_dev}; choose walkers as a multiple of "
                f"2*n_devices")
        out = jax.shard_map(
            local_batch, mesh=mesh,
            in_specs=(P(None, axis_name), P(None, axis_name)),
            out_specs=P(None, axis_name),
            check_vma=False,
        )(thetas, keys)
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P()))

    return sharded


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
