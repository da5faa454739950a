"""Shared step-size adaptation (Nesterov dual averaging, Hoffman-Gelman).

Used by both gradient samplers (hmc.py, nuts.py).  The whole warm-up runs
as ONE ``lax.scan`` program — the dual-averaging update is four lines of
scalar arithmetic and rides in the scan carry, so there are no per-step
host round-trips.

``scan_segments`` optionally splits that scan into several dispatches
(e.g. to bound how long one device program runs) while computing the
IDENTICAL iteration sequence — the carry passes between segments and the
results are bitwise-equal to the single-scan program (pinned by
tests/test_nuts.py).  The CLIs run the single scan.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75


def scan_segments(f, carry, xs, segment_steps: int = 0):
    """``lax.scan(f, carry, xs)``, dispatched in host-bounded segments.

    ``segment_steps <= 0`` (or >= len(xs)) runs the single-program scan.
    Otherwise the scan executes in ceil(n/segment_steps) jitted dispatches
    whose per-iteration computation is identical — same f, same xs slices
    in the same order — so the result matches the single scan bitwise.
    """
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    if segment_steps <= 0 or segment_steps >= n:
        return jax.lax.scan(f, carry, xs)
    seg = jax.jit(functools.partial(jax.lax.scan, f))
    outs = []
    for s in range(0, n, segment_steps):
        block = jax.tree_util.tree_map(
            lambda x: x[s: s + segment_steps], xs)
        carry, out = seg(carry, block)
        outs.append(out)
    stacked = jax.tree_util.tree_map(
        lambda *o: jnp.concatenate(o, axis=0), *outs)
    return carry, stacked


def dual_averaging_warmup(key, state, one_step: Callable, n_warmup: int,
                          init_step_size: float, target_accept: float,
                          segment_steps: int = 0):
    """Adapt the step size over ``n_warmup`` iterations.

    ``one_step(state, step_size, key) -> (state, alpha)`` advances the
    sampler one transition; ``alpha`` is the per-chain acceptance
    statistic (any shape — its mean drives the adaptation).
    ``segment_steps`` bounds dispatch length (see :func:`scan_segments`).

    Returns (warmed state, adapted step size as a float32 scalar array).
    """
    mu = jnp.log(10.0 * init_step_size)
    log_eps0 = jnp.log(jnp.float32(init_step_size))

    def body(carry, i):
        state, log_eps, log_eps_bar, h_bar = carry
        k = jax.random.fold_in(key, i)
        state, alpha = one_step(state, jnp.exp(log_eps), k)
        # a divergent trajectory can overflow positions -> NaN Hamiltonian
        # -> NaN acceptance statistic; score it as alpha = 0 (Stan's
        # convention) so the step size shrinks instead of the whole
        # adaptation going NaN (observed on the oneBD posterior, whose
        # reference guess point starts far from the mode with |grad|~1e4)
        alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
        a = jnp.mean(alpha)
        t = i.astype(jnp.float32) + 1.0
        frac = 1.0 / (t + _T0)
        h_bar = (1.0 - frac) * h_bar + frac * (target_accept - a)
        log_eps = mu - jnp.sqrt(t) / _GAMMA * h_bar
        eta = t ** -_KAPPA
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        return (state, log_eps, log_eps_bar, h_bar), None

    # log_eps_bar starts at log_eps0 so n_warmup=0 returns init_step_size
    # (not exp(0)); indices scan as int32 (exact for any n_warmup)
    (state, _, log_eps_bar, _), _ = scan_segments(
        body, (state, log_eps0, log_eps0, jnp.float32(0.0)),
        jnp.arange(n_warmup, dtype=jnp.int32), segment_steps)
    return state, jnp.exp(log_eps_bar)
