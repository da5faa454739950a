"""No-U-Turn Sampler (NUTS), iterative and jit-compatible.

Completes the reference's pymc3-experiment parity
(``tests/testSimpleNested.py:181-220`` drives ``pm.NUTS``): a true
dynamic-termination NUTS rather than the jittered-trajectory HMC stand-in
(sampler/hmc.py, which remains the cheaper option).

Algorithm: multinomial NUTS with biased progressive sampling
(Betancourt, "A conceptual introduction to HMC") and the
momentum-sum U-turn criterion, iterative formulation:

* the doubling loop is a ``lax.while_loop`` bounded by ``max_depth``;
* each doubling builds its subtree with a ``lax.while_loop`` whose trip
  count is 2^depth with EARLY EXIT on divergence/U-turn (no wasted
  gradient evaluations past an invalidation);
* the recursive U-turn checks on every balanced (dyadic) sub-subtree are
  replayed iteratively: leaves and momentum prefix-sums are stored in
  static ``2^(max_depth-1)`` buffers (the largest subtree ever built),
  and at leaf ``i`` every dyadic interval that ENDS at ``i`` (one per
  trailing 1-bit of ``i``) is checked with the interval's momentum sum
  against its endpoint momenta.  The buffer is O(2^max_depth * dim) — a
  few hundred KB at this package's dimensions (<= 35), traded
  deliberately for auditability over the O(log) checkpoint stack used by
  e.g. numpyro; both are mathematically the same checks.
* divergence (leaf energy error < -1000) or an internal U-turn discards
  the entire new subtree, exactly like the recursive sampler.

Accelerator notes: static shapes throughout; all chains advance under one vmap;
the whole chain segment runs in a single ``lax.scan`` program.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

_DIVERGENCE_THRESHOLD = 1000.0


@dataclasses.dataclass
class NUTSChain:
    positions: jax.Array     # (S, C, D)
    log_probs: jax.Array     # (S, C)
    accept_stat: jax.Array   # (S, C) mean leaf acceptance statistic
    tree_depth: jax.Array    # (S, C) doublings performed
    diverging: jax.Array     # (S, C) bool
    step_size: float
    inv_mass: jax.Array = None  # (D,) adapted diagonal inverse mass


class _TreeState(NamedTuple):
    # trajectory ends (physical momenta; backward integration uses a
    # negated step so r stays physical and rho is a plain sum)
    z_minus: jax.Array
    r_minus: jax.Array
    g_minus: jax.Array
    z_plus: jax.Array
    r_plus: jax.Array
    g_plus: jax.Array
    # progressive-multinomial proposal
    z_prop: jax.Array
    lp_prop: jax.Array
    g_prop: jax.Array
    # tree statistics
    log_sum_w: jax.Array
    rho: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_alpha: jax.Array
    n_alpha: jax.Array
    key: jax.Array


def _transition(logp_grad_fn: Callable, z, lp, grad, key, step_size,
                max_depth: int, inv_mass=None):
    """One NUTS transition for a single chain.  Returns
    (z, lp, grad, accept_stat, depth, diverged).

    ``inv_mass``: (D,) diagonal inverse mass matrix (None = identity).
    Momenta are drawn r ~ N(0, M); the kinetic energy is r^T M^-1 r / 2,
    the leapfrog position update uses the velocity M^-1 r, and the U-turn
    criterion compares momentum sums against VELOCITIES (Stan's
    Euclidean-metric generalization)."""
    n_dim = z.shape[-1]
    # the doubling loop runs while depth < max_depth, so the LARGEST
    # subtree ever built has 2^(max_depth-1) leaves
    n_leaf_max = 1 << (max_depth - 1)
    if inv_mass is None:
        inv_mass = jnp.ones(n_dim)
    sqrt_mass = 1.0 / jnp.sqrt(inv_mass)

    k_mom, k_loop = jax.random.split(key)
    r0 = sqrt_mass * jax.random.normal(k_mom, (n_dim,))
    h0 = lp - 0.5 * jnp.dot(r0, inv_mass * r0)

    def leapfrog(z, r, g, eps):
        r1 = r + 0.5 * eps * g
        z1 = z + eps * (inv_mass * r1)
        lp1, g1 = logp_grad_fn(z1)
        r1 = r1 + 0.5 * eps * g1
        return z1, r1, g1, lp1

    def build_subtree(carry_key, z0, r0_, g0, eps, n_leaf):
        """Integrate ``n_leaf`` leapfrog leaves from (z0, r0_, g0).

        Returns subtree stats + the far endpoint.  Leaves/prefix sums live
        in static buffers; the traced trip count is n_leaf <= n_leaf_max.
        """
        z_buf = jnp.zeros((n_leaf_max, n_dim))
        r_buf = jnp.zeros((n_leaf_max, n_dim))
        rho_pre = jnp.zeros((n_leaf_max + 1, n_dim))
        # pre-drawn per-leaf uniforms (typed PRNG keys cannot ride the
        # masked tree_map below)
        u_take = jnp.log(jax.random.uniform(carry_key, (n_leaf_max,)))

        init = dict(
            z=z0, r=r0_, g=g0,
            z_buf=z_buf, r_buf=r_buf, rho_pre=rho_pre,
            lsw=-jnp.inf, zp=z0, lpp=-jnp.inf, gp=g0,
            turning=jnp.asarray(False), diverging=jnp.asarray(False),
            sum_alpha=jnp.asarray(0.0), n_alpha=jnp.asarray(0.0))

        def leaf_step(i, st):
            z, r, g, lp = leapfrog(st["z"], st["r"], st["g"], eps)
            lw = (lp - 0.5 * jnp.dot(r, inv_mass * r)) - h0
            lw = jnp.where(jnp.isnan(lw), -jnp.inf, lw)
            diverged = lw < -_DIVERGENCE_THRESHOLD

            # progressive multinomial within the subtree
            new_lsw = jnp.logaddexp(st["lsw"], lw)
            take = u_take[i] < lw - new_lsw
            zp = jnp.where(take, z, st["zp"])
            lpp = jnp.where(take, lp, st["lpp"])
            gp = jnp.where(take, g, st["gp"])

            z_buf = st["z_buf"].at[i].set(z)
            r_buf = st["r_buf"].at[i].set(r)
            rho_pre = st["rho_pre"].at[i + 1].set(st["rho_pre"][i] + r)

            # U-turn checks for every dyadic interval ending at leaf i:
            # interval size 2^k applies iff the low k bits of i are all 1
            turning = st["turning"]
            for k in range(1, max_depth):
                size = 1 << k
                applicable = (i & (size - 1)) == (size - 1)
                s = jnp.maximum(i - size + 1, 0)
                rho_int = rho_pre[i + 1] - rho_pre[s]
                r_a = r_buf[s]
                turn_k = ((jnp.dot(rho_int, inv_mass * r_a) < 0)
                          | (jnp.dot(rho_int, inv_mass * r) < 0))
                turning = turning | (applicable & turn_k)

            return dict(
                z=z, r=r, g=g, z_buf=z_buf, r_buf=r_buf, rho_pre=rho_pre,
                lsw=new_lsw, zp=zp, lpp=lpp, gp=gp,
                turning=turning,
                diverging=st["diverging"] | diverged,
                sum_alpha=st["sum_alpha"] + jnp.minimum(1.0, jnp.exp(lw)),
                n_alpha=st["n_alpha"] + 1.0,
                i=i + 1)

        # while-loop with early exit: once the subtree is invalid, no
        # further (expensive) gradient evaluations run — matching the
        # recursive sampler, which stops building on divergence/U-turn
        def alive(st):
            return ((st["i"] < n_leaf)
                    & ~(st["turning"] | st["diverging"]))

        init["i"] = jnp.asarray(0, n_leaf.dtype) \
            if hasattr(n_leaf, "dtype") else 0
        out = jax.lax.while_loop(alive, lambda st: leaf_step(st["i"], st),
                                 init)
        # the momentum sum of the (valid) subtree; for an invalidated
        # subtree this is discarded by the caller anyway
        out["rho"] = out["rho_pre"][jnp.minimum(out["i"], n_leaf)]
        return out

    root = _TreeState(
        z_minus=z, r_minus=r0, g_minus=grad,
        z_plus=z, r_plus=r0, g_plus=grad,
        z_prop=z, lp_prop=lp, g_prop=grad,
        log_sum_w=jnp.asarray(0.0),        # root leaf weight exp(h0-h0)=1
        rho=r0,
        depth=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_alpha=jnp.asarray(0.0), n_alpha=jnp.asarray(0.0),
        key=k_loop)

    def cond(ts: _TreeState):
        return ((ts.depth < max_depth) & ~ts.turning & ~ts.diverging)

    def body(ts: _TreeState):
        key, k_dir, k_take, k_sub = jax.random.split(ts.key, 4)
        go_right = jax.random.bernoulli(k_dir)
        eps = jnp.where(go_right, step_size, -step_size)
        z0 = jnp.where(go_right, ts.z_plus, ts.z_minus)
        r0_ = jnp.where(go_right, ts.r_plus, ts.r_minus)
        g0 = jnp.where(go_right, ts.g_plus, ts.g_minus)
        n_leaf = 1 << ts.depth

        sub = build_subtree(k_sub, z0, r0_, g0, eps, n_leaf)
        sub_ok = ~(sub["turning"] | sub["diverging"])

        # biased progressive sampling across the doubling
        accept_lp = sub["lsw"] - ts.log_sum_w
        take = (jnp.log(jax.random.uniform(k_take)) < accept_lp) & sub_ok
        z_prop = jnp.where(take, sub["zp"], ts.z_prop)
        lp_prop = jnp.where(take, sub["lpp"], ts.lp_prop)
        g_prop = jnp.where(take, sub["gp"], ts.g_prop)

        # merge ends / tree stats only when the subtree is valid
        def upd(new, old):
            return jnp.where(sub_ok, new, old)
        z_plus = upd(jnp.where(go_right, sub["z"], ts.z_plus), ts.z_plus)
        r_plus = upd(jnp.where(go_right, sub["r"], ts.r_plus), ts.r_plus)
        g_plus = upd(jnp.where(go_right, sub["g"], ts.g_plus), ts.g_plus)
        z_minus = upd(jnp.where(go_right, ts.z_minus, sub["z"]), ts.z_minus)
        r_minus = upd(jnp.where(go_right, ts.r_minus, sub["r"]), ts.r_minus)
        g_minus = upd(jnp.where(go_right, ts.g_minus, sub["g"]), ts.g_minus)
        rho = upd(ts.rho + sub["rho"], ts.rho)
        log_sum_w = upd(jnp.logaddexp(ts.log_sum_w, sub["lsw"]),
                        ts.log_sum_w)

        turning_top = ((jnp.dot(rho, inv_mass * r_minus) < 0)
                       | (jnp.dot(rho, inv_mass * r_plus) < 0))
        return _TreeState(
            z_minus, r_minus, g_minus, z_plus, r_plus, g_plus,
            z_prop, lp_prop, g_prop, log_sum_w, rho,
            ts.depth + 1,
            # an invalid subtree ends the transition like 'turning' does
            (sub_ok & turning_top) | sub["turning"],
            ts.diverging | sub["diverging"],
            ts.sum_alpha + sub["sum_alpha"],
            ts.n_alpha + sub["n_alpha"],
            key)

    final = jax.lax.while_loop(cond, body, root)
    accept_stat = final.sum_alpha / jnp.maximum(final.n_alpha, 1.0)
    return (final.z_prop, final.lp_prop, final.g_prop, accept_stat,
            final.depth, final.diverging)


def nuts_sample(key, p0, n_steps: int, log_prob_fn: Callable, *,
                n_warmup: int = 300, max_depth: int = 8,
                init_step_size: float = 0.1,
                target_accept: float = 0.8,
                adapt_mass: bool = True,
                segment_steps: int = 0) -> NUTSChain:
    """Run C parallel NUTS chains.  p0: (C, D).

    Warm-up (Stan-style windows): (1) dual-averaging step-size adaptation
    under the identity metric for ~half the budget, (2) a collection
    window estimating the per-dimension posterior variance, (3) a second
    dual-averaging run under the adapted diagonal metric.  Sampling keeps
    both fixed.  ``adapt_mass=False`` restores the single-window identity
    -metric warm-up (standardize parameters beforehand in that case).

    ``segment_steps > 0`` caps every device dispatch at that many NUTS
    transitions (warm-up windows and main chain alike) with bitwise-
    identical results (sampler/_adapt.scan_segments).
    """
    p0 = jnp.asarray(p0, dtype=jnp.float32)
    n_chains, n_dim = p0.shape
    logp_grad = jax.value_and_grad(log_prob_fn)
    lp0, g0 = jax.vmap(logp_grad)(p0)

    vtrans = jax.vmap(_transition,
                      in_axes=(None, 0, 0, 0, 0, None, None, None))

    def one_step(z, lp, g, eps, step_key, inv_mass):
        keys = jax.random.split(step_key, n_chains)
        return vtrans(logp_grad, z, lp, g, keys, eps, max_depth, inv_mass)

    # --- dual-averaging warm-up: one scanned program (sampler/_adapt.py)
    from ._adapt import dual_averaging_warmup, scan_segments

    def make_warm_step(inv_mass):
        def warm_step(state, eps, k):
            z, lp, g = state
            z, lp, g, alpha, _, _ = one_step(z, lp, g, eps, k, inv_mass)
            return (z, lp, g), alpha
        return warm_step

    # dedicated subkeys per warm-up window: deriving them with small
    # fold_in constants would collide with dual_averaging_warmup's own
    # per-iteration fold_in(key, i) namespace on the same base key
    k_w1, k_collect, k_w2, k_main = jax.random.split(key, 4)
    inv_mass = jnp.ones(n_dim)
    if adapt_mass and n_warmup >= 60:
        # windows clamp to the requested budget (~50% / 25% / 25%)
        n_w1 = n_warmup // 2
        n_collect = n_warmup // 4
        n_w2 = n_warmup - n_w1 - n_collect
        (z, lp, g), eps1 = dual_averaging_warmup(
            k_w1, (p0, lp0, g0), make_warm_step(inv_mass), n_w1,
            init_step_size, target_accept, segment_steps)

        # collection window: per-dimension posterior variance -> metric
        def collect_step(carry, step_key):
            z, lp, g = carry
            z, lp, g, _, _, _ = one_step(z, lp, g, eps1, step_key,
                                         inv_mass)
            return (z, lp, g), z
        ckeys = jax.random.split(k_collect, n_collect)
        (z, lp, g), zs_c = scan_segments(collect_step, (z, lp, g), ckeys,
                                         segment_steps)
        # WITHIN-chain variance averaged over chains (pooled variance
        # would inflate the metric with between-chain dispersion from
        # unmixed/multimodal ensembles — Stan uses within-chain too)
        var = jnp.mean(jnp.var(zs_c, axis=0), axis=0)
        n_eff = n_collect
        # Stan's regularization toward unit scale
        inv_mass = (var * n_eff / (n_eff + 5.0)
                    + 1e-3 * 5.0 / (n_eff + 5.0))

        (z, lp, g), eps = dual_averaging_warmup(
            k_w2, (z, lp, g), make_warm_step(inv_mass), n_w2,
            float(eps1), target_accept, segment_steps)
    else:
        if adapt_mass and n_warmup > 0:
            print("nuts_sample: n_warmup < 60 — skipping mass adaptation "
                  "(identity metric)")
        (z, lp, g), eps = dual_averaging_warmup(
            k_w1, (p0, lp0, g0), make_warm_step(inv_mass), n_warmup,
            init_step_size, target_accept, segment_steps)
    step_size = float(eps)

    # --- sampling: one scan program ---
    def scan_step(carry, step_key):
        z, lp, g = carry
        z, lp, g, alpha, depth, div = one_step(
            z, lp, g, jnp.float32(step_size), step_key, inv_mass)
        return (z, lp, g), (z, lp, alpha, depth, div)

    keys = jax.random.split(k_main, n_steps)
    _, (zs, lps, alphas, depths, divs) = scan_segments(
        scan_step, (z, lp, g), keys, segment_steps)
    return NUTSChain(zs, lps, alphas, depths, divs, step_size, inv_mass)
