"""Parallel-tempering ensemble sampler (replica exchange).

Replaces ``emcee.PTSampler`` as used by the reference's analytic-vs-numeric
study (20 temperatures x 100 walkers, ``tests/shiftingGaussian_brute.py:
349-360``).  Design: the temperature ladder is just one more
vmapped array axis on top of the walker axis — per-temperature stretch
moves run as a (T, W)-batched computation, and the replica-exchange phase
is a tiny elementwise shuffle between adjacent temperature slices.

Tempered posterior at inverse temperature beta: logprior + beta * loglike.
Swap acceptance between adjacent rungs (i cold, j=i+1 hot), with walkers of
the hotter rung randomly permuted:  ln U < (beta_i - beta_j) *
(loglike_j - loglike_i)  — standard replica exchange, matching PTSampler.

The within-rung proposal family matches the ensemble sampler's
(``move=`` 'stretch' | 'de' | 'mixed'; see sampler/stretch.py) — the
tempered DE half-update just adds the beta weighting to the symmetric
Metropolis ratio.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


def default_beta_ladder(n_temps: int, t_max: float | None = None) -> np.ndarray:
    """Geometric inverse-temperature ladder, beta_0 = 1 (cold chain).

    Default spacing 1/sqrt(2) per rung like emcee 2's PTSampler default;
    with ``t_max`` given, spaces geometrically down to 1/t_max.
    """
    if t_max is None:
        ratio = 2.0 ** 0.5
        return (1.0 / ratio) ** np.arange(n_temps)
    return np.geomspace(1.0, 1.0 / t_max, n_temps)


class PTState(NamedTuple):
    positions: jax.Array   # (T, W, D)
    log_like: jax.Array    # (T, W)
    log_prior: jax.Array   # (T, W)
    key: jax.Array
    step: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PTChain:
    positions: jax.Array       # (S, T, W, D) — S = n_steps // thin rows
    log_like: jax.Array        # (S, T, W)
    log_prior: jax.Array       # (S, T, W)
    n_accepted: jax.Array      # (T, W) — over ALL n_steps, not just kept
    n_swaps_accepted: jax.Array  # (T-1,)
    n_steps: jax.Array         # () total steps sampled (pre-thin)
    state: PTState
    # (T,) ladder the chain was sampled at, as a STATIC tuple of Python
    # floats: a jnp data leaf would silently downcast the f64 ladder to
    # f32 through any jit/device_put pytree round-trip (x64 off), and an
    # np.ndarray leaf is unhashable as static — a tuple keeps full f64
    # precision for the TI integral and survives transforms untouched
    betas: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def acceptance_fraction(self):
        return self.n_accepted / self.n_steps

    @property
    def cold_chain(self):
        """(S, W, D) samples of the beta=1 target posterior."""
        return self.positions[:, 0]

    def thermodynamic_integration_log_evidence(self, betas=None, *,
                                               fburnin: float = 0.1):
        """(ln Z, error) for the ladder this chain was sampled at.

        Defaults to ``self.betas`` — the ladder ``sample_pt`` actually
        used (for ``sample_pt_adaptive`` chains this is the FINAL adapted
        ladder; the late — post-adaptation — samples dominate after
        burn-in).  The explicit ``betas`` argument remains as an override.
        """
        if betas is None:
            betas = self.betas
        return thermodynamic_integration_log_evidence(
            self.log_like, betas, fburnin=fburnin)


def thermodynamic_integration_log_evidence(log_like, betas, *,
                                           fburnin: float = 0.1):
    """Log-evidence ln Z = ln p(data) by thermodynamic integration.

    ln Z(beta=1) - ln Z(beta=0) = integral_0^1 <ln L>_beta dbeta, with the
    per-rung posterior expectations <ln L>_beta estimated from the tempered
    chains.  This is the capability ``emcee.PTSampler.
    thermodynamic_integration_log_evidence`` provides on the sampler the
    reference configures (``tests/shiftingGaussian_brute.py:352-360``):
    trapezoid rule over the (descending) beta ladder, constant
    extrapolation from the hottest rung to beta=0 when the ladder does not
    reach it, and an error estimate from re-integrating on every other
    rung (discretization dominates, so halving the ladder resolution
    brackets the quadrature error).

    Parameters
    ----------
    log_like : (S, T, W) tempered log-likelihood chain (``PTChain.log_like``)
    betas : (T,) inverse temperatures, descending, betas[0] == 1
    fburnin : fraction of the S axis discarded as burn-in

    Returns ``(ln_z, d_ln_z)``.
    """
    ll = np.asarray(log_like, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    if ll.ndim != 3 or ll.shape[1] != betas.shape[0]:
        raise ValueError(f"log_like (S, T, W) with T == len(betas); got "
                         f"{ll.shape} vs {betas.shape}")
    if np.any(np.diff(betas) >= 0.0) or abs(betas[0] - 1.0) > 1e-6:
        raise ValueError("betas must be strictly decreasing from 1.0")
    start = int(fburnin * ll.shape[0])
    mean_logls = ll[start:].mean(axis=(0, 2))              # (T,)

    if betas[-1] != 0.0:
        betas = np.concatenate([betas, [0.0]])
        mean_logls = np.concatenate([mean_logls, mean_logls[-1:]])

    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    ln_z = -trapezoid(mean_logls, betas)
    # half-resolution ladder for the error estimate: every other rung with
    # BOTH endpoints kept — a bare betas[::2] silently drops the appended
    # beta=0 endpoint whenever the rung count is odd, inflating the error
    # bar by the whole hot-tail strip (emcee 2 re-appends 0 after
    # subsampling for the same reason)
    idx = np.arange(0, betas.size, 2)
    if idx[-1] != betas.size - 1:
        idx = np.concatenate([idx, [betas.size - 1]])
    ln_z2 = -trapezoid(mean_logls[idx], betas[idx])
    return float(ln_z), float(abs(ln_z - ln_z2))


def _make_batched(fn: Callable, stochastic: bool) -> Callable:
    if stochastic:
        per = fn
    else:
        def per(theta, key):
            del key
            return fn(theta)
    return jax.vmap(jax.vmap(per))  # over (T, W)


def init_pt_state(key, p0, loglike_batch, logprior_batch) -> PTState:
    """p0: (T, W, D).  One compiled program, as ``stretch.init_state``."""
    return jax.jit(functools.partial(_init_pt_state, loglike_batch,
                                     logprior_batch))(
        key, jnp.asarray(p0, dtype=jnp.float32))


def _init_pt_state(loglike_batch, logprior_batch, key, p0) -> PTState:
    t, w, _ = p0.shape
    key, k0 = jax.random.split(key)
    keys = jax.random.split(k0, t * w).reshape(t, w, -1)
    ll = loglike_batch(p0, keys)
    lp = logprior_batch(p0, keys)
    return PTState(p0, ll, lp, key, jnp.asarray(0, jnp.int32))


def _tempered_half_update(pos, ll, lp, betas, parity, step_key,
                          loglike_batch, logprior_batch, a, n_dim):
    """Red-black stretch half-update batched over (T, walkers/2)."""
    n_temps, n_walkers, _ = pos.shape
    n_half = n_walkers // 2
    active = pos[:, parity::2]
    passive = pos[:, 1 - parity::2]
    ll_a = ll[:, parity::2]
    lp_a = lp[:, parity::2]

    kz, kj, ku, ke = jax.random.split(step_key, 4)
    u = jax.random.uniform(kz, (n_temps, n_half))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    j = jax.random.randint(kj, (n_temps, n_half), 0, n_half)
    partners = jnp.take_along_axis(passive, j[:, :, None], axis=1)
    prop = partners + z[..., None] * (active - partners)

    eval_keys = jax.random.split(ke, n_temps * n_half).reshape(
        n_temps, n_half, -1)
    ll_new = loglike_batch(prop, eval_keys)
    lp_new = logprior_batch(prop, eval_keys)

    logpost_new = lp_new + betas[:, None] * ll_new
    logpost_old = lp_a + betas[:, None] * ll_a
    log_ratio = (n_dim - 1.0) * jnp.log(z) + logpost_new - logpost_old
    accept = jnp.log(jax.random.uniform(ku, (n_temps, n_half))) < log_ratio

    pos = pos.at[:, parity::2].set(
        jnp.where(accept[..., None], prop, active))
    ll = ll.at[:, parity::2].set(jnp.where(accept, ll_new, ll_a))
    lp = lp.at[:, parity::2].set(jnp.where(accept, lp_new, lp_a))
    return pos, ll, lp, accept


def _tempered_half_update_de(pos, ll, lp, betas, parity, step_key,
                             loglike_batch, logprior_batch, gamma0,
                             de_sigma):
    """DE-MC half-update batched over (T, walkers/2) — the tempered twin
    of ``stretch._half_update_de`` (symmetric proposal: no z factor)."""
    n_temps, n_walkers, _ = pos.shape
    n_half = n_walkers // 2
    if n_half < 2:
        raise ValueError("the DE move needs >= 4 walkers per rung")
    active = pos[:, parity::2]
    passive = pos[:, 1 - parity::2]
    ll_a = ll[:, parity::2]
    lp_a = lp[:, parity::2]

    kg, kj, ku, ke = jax.random.split(step_key, 4)
    k1, k2 = jax.random.split(kj)
    j1 = jax.random.randint(k1, (n_temps, n_half), 0, n_half)
    j2 = (j1 + 1 + jax.random.randint(k2, (n_temps, n_half), 0,
                                      n_half - 1)) % n_half
    g = gamma0 * (1.0 + de_sigma * jax.random.normal(
        kg, (n_temps, n_half)))
    d = (jnp.take_along_axis(passive, j1[:, :, None], axis=1)
         - jnp.take_along_axis(passive, j2[:, :, None], axis=1))
    prop = active + g[..., None] * d

    eval_keys = jax.random.split(ke, n_temps * n_half).reshape(
        n_temps, n_half, -1)
    ll_new = loglike_batch(prop, eval_keys)
    lp_new = logprior_batch(prop, eval_keys)

    log_ratio = (lp_new + betas[:, None] * ll_new
                 - lp_a - betas[:, None] * ll_a)
    accept = jnp.log(jax.random.uniform(ku, (n_temps, n_half))) < log_ratio

    pos = pos.at[:, parity::2].set(
        jnp.where(accept[..., None], prop, active))
    ll = ll.at[:, parity::2].set(jnp.where(accept, ll_new, ll_a))
    lp = lp.at[:, parity::2].set(jnp.where(accept, lp_new, lp_a))
    return pos, ll, lp, accept


def _replica_exchange(pos, ll, lp, betas, key):
    """One sweep of adjacent-rung swaps, coldest pair last."""
    n_temps, n_walkers, _ = pos.shape
    swap_counts = jnp.zeros(n_temps - 1, jnp.int32)

    for i in range(n_temps - 2, -1, -1):
        k_perm, k_acc, key = jax.random.split(jax.random.fold_in(key, i), 3)
        perm = jax.random.permutation(k_perm, n_walkers)
        ll_hot = ll[i + 1][perm]
        log_ratio = (betas[i] - betas[i + 1]) * (ll_hot - ll[i])
        accept = jnp.log(jax.random.uniform(k_acc, (n_walkers,))) < log_ratio

        pos_hot = pos[i + 1][perm]
        lp_hot = lp[i + 1][perm]
        new_cold_pos = jnp.where(accept[:, None], pos_hot, pos[i])
        new_cold_ll = jnp.where(accept, ll_hot, ll[i])
        new_cold_lp = jnp.where(accept, lp_hot, lp[i])
        # hot rung receives the displaced cold walkers at permuted slots
        hot_pos = pos[i + 1].at[perm].set(
            jnp.where(accept[:, None], pos[i], pos_hot))
        hot_ll = ll[i + 1].at[perm].set(jnp.where(accept, ll[i], ll_hot))
        hot_lp = lp[i + 1].at[perm].set(jnp.where(accept, lp[i], lp_hot))

        pos = pos.at[i].set(new_cold_pos).at[i + 1].set(hot_pos)
        ll = ll.at[i].set(new_cold_ll).at[i + 1].set(hot_ll)
        lp = lp.at[i].set(new_cold_lp).at[i + 1].set(hot_lp)
        swap_counts = swap_counts.at[i].add(jnp.sum(accept.astype(jnp.int32)))
    return pos, ll, lp, swap_counts


def make_pt_step(loglike_batch, logprior_batch, betas, a: float = 2.0,
                 *, move: str = "stretch",
                 gamma0: Optional[float] = None, de_sigma: float = 1e-5):
    if move not in ("stretch", "de", "mixed"):
        raise ValueError(f"unknown move {move!r}")
    betas = jnp.asarray(betas, jnp.float32)

    def step(state: PTState, _):
        pos, ll, lp, key, step_idx = state
        n_dim = pos.shape[-1]
        g0 = (2.38 / (2.0 * n_dim) ** 0.5) if gamma0 is None else gamma0
        key, k_e, k_o, k_s = jax.random.split(
            jax.random.fold_in(key, step_idx), 4)

        def stretch_both(pos, ll, lp):
            pos, ll, lp, acc_e = _tempered_half_update(
                pos, ll, lp, betas, 0, k_e, loglike_batch, logprior_batch,
                a, n_dim)
            pos, ll, lp, acc_o = _tempered_half_update(
                pos, ll, lp, betas, 1, k_o, loglike_batch, logprior_batch,
                a, n_dim)
            return pos, ll, lp, acc_e, acc_o

        def de_both(pos, ll, lp):
            pos, ll, lp, acc_e = _tempered_half_update_de(
                pos, ll, lp, betas, 0, k_e, loglike_batch, logprior_batch,
                g0, de_sigma)
            pos, ll, lp, acc_o = _tempered_half_update_de(
                pos, ll, lp, betas, 1, k_o, loglike_batch, logprior_batch,
                g0, de_sigma)
            return pos, ll, lp, acc_e, acc_o

        if move == "stretch":
            pos, ll, lp, acc_e, acc_o = stretch_both(pos, ll, lp)
        elif move == "de":
            pos, ll, lp, acc_e, acc_o = de_both(pos, ll, lp)
        else:
            pos, ll, lp, acc_e, acc_o = jax.lax.cond(
                step_idx % 2 == 0, stretch_both, de_both, pos, ll, lp)
        pos, ll, lp, swaps = _replica_exchange(pos, ll, lp, betas, k_s)
        accepted = jnp.zeros(pos.shape[:2], jnp.int32)
        accepted = accepted.at[:, 0::2].set(acc_e.astype(jnp.int32))
        accepted = accepted.at[:, 1::2].set(acc_o.astype(jnp.int32))
        new_state = PTState(pos, ll, lp, key, step_idx + 1)
        return new_state, (pos, ll, lp, accepted, swaps)

    return step


def sample_pt_adaptive(key, p0, n_steps: int, loglike_fn, logprior_fn, *,
                       betas=None, n_temps: Optional[int] = None,
                       a: float = 2.0, stochastic: bool = False,
                       thin: int = 1, adapt_t0: float = 100.0,
                       adapt_nu: float = 10.0):
    """PT with on-the-fly temperature-ladder adaptation (Vousden, Farr &
    Mandel 2016 scheme).

    The reference's PTSampler uses a fixed geometric ladder
    (``tests/shiftingGaussian_brute.py:349-360``); a mis-spaced ladder
    starves replica flow through whichever pair has the lowest swap
    acceptance.  Here the log temperature gaps S_i = log(1/beta_{i+1} -
    1/beta_i) evolve as dS_i = eta(t) (A_i - A_{i+1}) with the
    instantaneous pair swap-acceptance fractions A_i and the decaying rate
    eta(t) = t0 / (nu (t + t0)) — interior pair acceptances equalize and
    the adaptation freezes as t grows (so late samples are asymptotically
    unbiased).  beta_0 = 1 and the TOTAL 1/beta span are held fixed (the
    gaps renormalize each step), so the caller chooses the temperature
    range and the adaptation redistributes the interior spacing.

    Returns (PTChain, betas_final (T,), betas_history (S, T)).
    """
    p0 = jnp.asarray(p0, dtype=jnp.float32)
    if p0.ndim == 2:
        if n_temps is None:
            raise ValueError("give p0 as (T, W, D) or pass n_temps")
        p0 = jnp.broadcast_to(p0, (n_temps,) + p0.shape)
    n_t = p0.shape[0]
    if betas is None:
        betas = default_beta_ladder(n_t)
    betas = jnp.asarray(betas, jnp.float32)
    if n_t < 3:
        raise ValueError("ladder adaptation needs >= 3 temperatures")
    if abs(float(betas[0]) - 1.0) > 1e-6:
        # the adapted ladder is parameterized by log-gaps above a cold
        # chain pinned at beta=1 (betas_of below); a non-cold-anchored
        # ladder would silently sample a different target than requested
        raise ValueError("sample_pt_adaptive requires betas[0] == 1.0 "
                         "(cold-anchored ladder); use sample_pt for "
                         "arbitrary fixed ladders")
    if not bool(jnp.all(jnp.diff(betas) < 0.0)):
        # the gap parameterization below is log(diff(1/betas)); a
        # non-decreasing ladder would silently produce NaN gaps and an
        # all-NaN chain instead of an error
        raise ValueError("sample_pt_adaptive requires strictly decreasing "
                         "betas (hottest last)")

    loglike_batch = _make_batched(loglike_fn, stochastic)
    logprior_batch = _make_batched(logprior_fn, stochastic)
    state = init_pt_state(key, p0, loglike_batch, logprior_batch)
    n_walkers = p0.shape[1]

    inv_b = 1.0 / betas
    gaps0 = jnp.log(jnp.diff(inv_b))                      # (T-1,)
    span0 = jnp.sum(jnp.exp(gaps0))                       # 1/beta_top - 1

    def betas_of(log_gaps):
        inv = jnp.concatenate(
            [jnp.ones((1,)), 1.0 + jnp.cumsum(jnp.exp(log_gaps))])
        return 1.0 / inv

    def step(carry, _):
        st, log_gaps = carry
        pos, ll, lp, key, step_idx = st
        b = betas_of(log_gaps)
        n_dim = pos.shape[-1]
        key, k_e, k_o, k_s = jax.random.split(
            jax.random.fold_in(key, step_idx), 4)
        pos, ll, lp, acc_e = _tempered_half_update(
            pos, ll, lp, b, 0, k_e, loglike_batch, logprior_batch, a, n_dim)
        pos, ll, lp, acc_o = _tempered_half_update(
            pos, ll, lp, b, 1, k_o, loglike_batch, logprior_batch, a, n_dim)
        pos, ll, lp, swaps = _replica_exchange(pos, ll, lp, b, k_s)

        # ladder update: equalize adjacent pair acceptances, then
        # renormalize so the total 1/beta span (the caller's temperature
        # range) is preserved exactly
        pair_acc = swaps.astype(jnp.float32) / n_walkers   # (T-1,)
        eta = adapt_t0 / (adapt_nu * (step_idx.astype(jnp.float32)
                                      + adapt_t0))
        delta = eta * (pair_acc[:-1] - pair_acc[1:])       # (T-2,)
        log_gaps = log_gaps.at[:-1].add(delta)
        span = jnp.sum(jnp.exp(log_gaps))
        log_gaps = log_gaps + jnp.log(span0 / span)

        accepted = jnp.zeros(pos.shape[:2], jnp.int32)
        accepted = accepted.at[:, 0::2].set(acc_e.astype(jnp.int32))
        accepted = accepted.at[:, 1::2].set(acc_o.astype(jnp.int32))
        new_st = PTState(pos, ll, lp, key, step_idx + 1)
        return (new_st, log_gaps), (pos, ll, lp, accepted, swaps,
                                    betas_of(log_gaps))

    (final, log_gaps), (pos, ll, lp, acc, swaps, b_hist) = jax.lax.scan(
        step, (state, gaps0), None, length=n_steps)
    if thin > 1:
        pos, ll, lp, b_hist = (pos[::thin], ll[::thin], lp[::thin],
                               b_hist[::thin])
    betas_final = betas_of(log_gaps)
    # same static-tuple representation as sample_pt's constructor (the
    # adapted ladder is computed in f32 on device; the tuple just pins
    # the values against further downcasts/retraces)
    chain = PTChain(pos, ll, lp, jnp.sum(acc, axis=0),
                    jnp.sum(swaps, axis=0),
                    jnp.asarray(n_steps, jnp.int32), final,
                    tuple(float(b)
                          for b in np.asarray(betas_final, np.float64)))
    return chain, betas_final, b_hist


def sample_pt(key, p0, n_steps: int, loglike_fn, logprior_fn, *,
              betas=None, n_temps: Optional[int] = None, a: float = 2.0,
              stochastic: bool = False, thin: int = 1,
              move: str = "stretch",
              loglike_batch: Optional[Callable] = None,
              logprior_batch: Optional[Callable] = None) -> PTChain:
    """PTSampler equivalent: p0 (T, W, D) or (W, D) with n_temps given.

    ``loglike_batch``/``logprior_batch`` override the default
    ``vmap(vmap(fn))`` lifting with caller-built (T, W)-batched
    evaluators — the hook the multi-chip path uses to shard the walker
    axis over a device mesh (``parallel/mesh.py``) while the tempered
    move bookkeeping stays replicated.
    """
    p0 = jnp.asarray(p0, dtype=jnp.float32)
    if p0.ndim == 2:
        if n_temps is None:
            raise ValueError("give p0 as (T, W, D) or pass n_temps")
        p0 = jnp.broadcast_to(p0, (n_temps,) + p0.shape)
    if betas is None:
        betas = default_beta_ladder(p0.shape[0])

    if loglike_batch is None:
        loglike_batch = _make_batched(loglike_fn, stochastic)
    if logprior_batch is None:
        logprior_batch = _make_batched(logprior_fn, stochastic)
    state = init_pt_state(key, p0, loglike_batch, logprior_batch)
    step = make_pt_step(loglike_batch, logprior_batch, betas, a, move=move)
    final, (pos, ll, lp, acc, swaps) = jax.lax.scan(
        step, state, None, length=n_steps)
    if thin > 1:
        pos, ll, lp = pos[::thin], ll[::thin], lp[::thin]
    # record the ladder at the caller's (f64) precision: the TI integral
    # is computed in f64, so a rounded f32 copy would shift ln Z
    return PTChain(pos, ll, lp, jnp.sum(acc, axis=0),
                   jnp.sum(swaps, axis=0),
                   jnp.asarray(n_steps, jnp.int32), final,
                   tuple(float(b) for b in np.asarray(betas, np.float64)))
