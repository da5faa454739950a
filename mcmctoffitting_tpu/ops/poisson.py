"""Exact Poisson sampling from plain uniforms (PTRS + CDF inversion).

Why this exists: counts mode draws F + 2 Poisson cell counts per run and
evaluation, and ``jax.random.poisson`` is implemented for the threefry
generator ONLY (it also carries a generic rejection loop).  This module
samples Poisson exactly using nothing but ``jax.random.uniform``, so it
runs (and vectorizes) under any PRNG impl (``-prng``).

Algorithms (both exact, no normal approximation anywhere):

* ``lam >= 10``: Hormann's PTRS transformed rejection with squeeze
  (W. Hormann, "The transformed rejection method for generating Poisson
  random variables", 1993) — the same algorithm numpy uses.  Acceptance
  is ~94%, so the vectorized while_loop over rejected lanes terminates in
  a handful of rounds; a ``max_rounds`` guard (probability ~0 to bind)
  falls back to round(lam).
* ``lam < 10``: sequential CDF inversion with a FIXED 48-round fori_loop
  (one uniform total; the rounds are multiply-add + compare, no
  transcendentals).  P(X > 48 | lam=10) < 1e-19, i.e. exact at f32
  resolution.

Matches the reference's per-cell count randomness contract
(``tests/simultFit.py:263-296`` draws-per-bin become Poisson counts under
the counts estimator; see ops/e0grid.poissonized_moments).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

__all__ = ["poisson_ptrs"]


_SMALL_CUTOFF = 10.0
_INV_ROUNDS = 48
_MAX_PTRS_ROUNDS = 64


def _ptrs_log_pmf(k, lam, loglam):
    """Poisson log-pmf for the PTRS slow-accept test, cancellation-free.

    The naive ``k*log(lam) - lam - gammaln(k+1)`` subtracts three
    O(lam*log(lam))-magnitude terms to produce an O(1) result: at
    lam = 1e4 the f32 rounding of the ~9e4-magnitude operands is ~1e-2
    absolute and the acceptance test visibly skews (measured +2% variance
    inflation at lam = 1e4, +3% at 1e5).  Rewriting around
    d = k - lam (EXACT in f32 by Sterbenz: k, lam within a factor of 2):

        log pmf = d - k*log1p(d/lam) - log(2*pi*k)/2 - 1/(12k) + 1/(360k^3)

    keeps every intermediate O(d) — but XLA's f32 ``log1p`` is itself
    only ~1e-6 ABSOLUTE (~700 ulp at t ~ 0.025, measured on the CPU
    backend), and ``k *`` amplifies that to ~0.2 at lam = 1e5: a +-20%
    oscillating acceptance skew in the slow path that deflated the
    sampled variance by 1.3%.  So for small
    t the log1p is expanded in-place:

        d - k*log1p(t) = -d^2/lam - k*r,
        r = -t^2/2 + t^3/3 - t^4/4 + t^5/5 - t^6/6 + t^7/7

    (k*t = d + d^2/lam exactly to f32 rounding).  With |t| <= 1/16 the
    truncation is lam*t^8/8 < 6e-6 at lam = 2e5 and every term is
    evaluated at its own scale, so the absolute error stays ~1e-4 over
    the whole PTRS proposal range (the 1/16 domain reaches 6.2 sigma
    even at lam = 1e4); |t| > 1/16 keeps the library log1p, where the
    pmf is so far below the acceptance threshold that the amplified
    error is immaterial.  The Stirling tail is exact to ~1e-8 for
    k >= 8; lanes with k < 8 (possible only via the tiny-us proposal
    tail) fall back to the naive form, which is safe there because the
    result is dominated by the exactly-representable ``-lam``.
    """
    d = k - lam
    kk = jnp.maximum(k, 1.0)
    t = jnp.where(k >= 8.0, d / lam, 0.0)      # log1p(-1) guard for k=0
    r = t * t * (-1.0 / 2.0 + t * (1.0 / 3.0 + t * (
        -1.0 / 4.0 + t * (1.0 / 5.0 + t * (-1.0 / 6.0 + t * (1.0 / 7.0))))))
    core = jnp.where(jnp.abs(t) <= 0.0625,
                     -(d * d) / lam - k * r,
                     d - k * jnp.log1p(t))
    stable = (core
              - 0.5 * jnp.log(2.0 * jnp.pi * kk)
              - (1.0 / 12.0 - (1.0 / 360.0) / (kk * kk)) / kk)
    naive = k * loglam - lam - gammaln(k + 1.0)
    return jnp.where(k >= 8.0, stable, naive)


def _small_inversion(u, lam):
    """CDF inversion via 48 fixed rounds (lam < 10 lanes).

    Uses X = #{k : S(k) >= v} with the survival function S accumulated
    DOWNWARD (s -= pmf) and v = 1 - u: s underflows to ~0 within a few
    ulps, so a lane whose v is at the uniform's resolution floor stops at
    the matching extreme quantile instead of riding an f32-saturated CDF
    to the round cap (upward accumulation measurably did: cdf can stick
    1-2 ulp below a u ~ 1 lane and increment forever).  v is floored at
    1e-5 because 48 f32 pmf accumulations carry up to ~3e-6 of absolute
    drift: a v below the drift would still ride to the cap.  The floor
    collapses the tail beyond the 1 - 1e-5 quantile (~lam + 4.3 sigma)
    onto that quantile — invisible next to f32 pmf rounding itself
    (measured: mean/var z-scores unchanged, runaway max gone)."""
    v = jnp.maximum(1.0 - u, 1e-5)

    def body(i, carry):
        p, s, cnt = carry
        s = s - p
        cnt = cnt + (s >= v).astype(cnt.dtype)
        p = p * lam / (i.astype(lam.dtype) + 1.0)
        return p, s, cnt

    _, _, cnt = jax.lax.fori_loop(
        0, _INV_ROUNDS, body,
        (jnp.exp(-lam), jnp.ones_like(lam), jnp.zeros_like(lam)))
    return cnt


def poisson_ptrs(key, lam):
    """Exact Poisson draws, shape = lam.shape, float dtype of lam.

    Works under any PRNG impl (threefry, rbg, ...) — only uniforms are
    consumed.  Returns floats (like the counts pipeline expects); cast if
    integers are needed.
    """
    lam = jnp.asarray(lam)
    dtype = jnp.promote_types(lam.dtype, jnp.float32)
    lam = jnp.maximum(lam.astype(dtype), 0.0)
    shape = lam.shape
    small = lam < _SMALL_CUTOFF

    # ---- small-rate lanes: one uniform, fixed flop rounds ----
    u_small = jax.random.uniform(jax.random.fold_in(key, 0), shape,
                                 dtype=dtype)
    small_lam = jnp.where(small, lam, 1.0)  # keep exp/cdf well-behaved
    cnt_small = _small_inversion(u_small, small_lam)

    # ---- large-rate lanes: PTRS (numpy's random_poisson_ptrs) ----
    big_lam = jnp.where(small, 100.0, lam)  # dummy params on small lanes
    slam = jnp.sqrt(big_lam)
    loglam = jnp.log(big_lam)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + 1.1328 / (b - 3.4)
    vr = 0.9277 - 3.6224 / (b - 2.0)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def cond(state):
        rounds, done, _ = state
        return jnp.logical_and(rounds < _MAX_PTRS_ROUNDS,
                               jnp.logical_not(jnp.all(done)))

    def body(state):
        rounds, done, result = state
        kk = jax.random.fold_in(key, 1 + rounds)
        uv = jax.random.uniform(kk, (2,) + shape, dtype=dtype)
        u = uv[0] - 0.5
        v = jnp.maximum(uv[1], tiny)
        us = 0.5 - jnp.abs(u)
        k = jnp.floor((2.0 * a / jnp.maximum(us, tiny) + b) * u
                      + big_lam + 0.43)
        fast_accept = jnp.logical_and(us >= 0.07, v <= vr)
        reject = jnp.logical_or(
            k < 0.0, jnp.logical_and(us < 0.013, v > us))
        log_accept = (jnp.log(v) + jnp.log(invalpha)
                      - jnp.log(a / jnp.maximum(us * us, tiny) + b))
        slow_accept = log_accept <= _ptrs_log_pmf(k, big_lam, loglam)
        accept = jnp.logical_or(fast_accept,
                                jnp.logical_and(~reject, slow_accept))
        take = jnp.logical_and(~done, accept)
        result = jnp.where(take, k, result)
        return rounds + 1, jnp.logical_or(done, accept), result

    init = (0, small, jnp.zeros(shape, dtype))
    _, done, cnt_big = jax.lax.while_loop(cond, body, init)
    # max_rounds guard: probability ~(1-0.94)^64 per lane; keep it finite
    cnt_big = jnp.where(done, cnt_big, jnp.round(big_lam))

    return jnp.where(small, cnt_small, cnt_big)
