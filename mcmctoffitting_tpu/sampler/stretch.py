"""Native affine-invariant ensemble sampler (Goodman-Weare stretch move).

Replaces emcee's ``EnsembleSampler`` (the reference drives it with
``threads=N`` process pools or an ``MPIPool`` — ``tests/csi_oneBD.py:863-868``,
``tests/simultFit.py:688-718``).  Design:

* walkers are an **array axis**, not processes: the log-probability is
  evaluated for a whole half-ensemble with one batched call (vmap inside;
  shardable over a device mesh via ``parallel/mesh.py``);
* the ensemble is split **red-black** (even/odd walker indices) so that when
  the walker axis is sharded, both halves occupy every device (contiguous
  halves would idle half the mesh during each half-update);
* steps advance under ``jax.lax.scan`` — the entire chain segment is one
  XLA program with zero host round-trips; chains are returned as device
  arrays and streamed to disk by the caller at segment granularity;
* stochastic ("pseudo-marginal") likelihoods get a fresh PRNG subkey per
  (step, walker) eval, faithful to the reference's re-sampling likelihood
  (``tests/simultFit.py:386-388``); retained log-probs are NOT re-evaluated,
  matching emcee semantics.

Move semantics match emcee's default stretch move: scale a=2, proposal
z ~ g(z) with g ∝ 1/sqrt(z) on [1/a, a] via inverse-CDF
z = ((a-1)u + 1)^2 / a, partner drawn uniformly from the complementary
half, acceptance ln U < (D-1) ln z + logp(y) - logp(x).

Beyond the reference (which only ever drives emcee's stretch), a
differential-evolution move family is available via ``move=``:
'de' is ter Braak's DE-MC / emcee's DEMove (y = x + g (a - b), two
distinct complementary-half partners, g = gamma0 (1 + sigma N(0,1)),
gamma0 = 2.38/sqrt(2D)); 'mixed' alternates stretch and DE steps.
The stretch path's PRNG stream is untouched by the extension (bitwise
reproducibility of existing chains).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class EnsembleState(NamedTuple):
    """Resumable sampler state (checkpointable as a pytree)."""

    positions: jax.Array   # (W, D)
    log_probs: jax.Array   # (W,)
    key: jax.Array         # PRNG key
    step: jax.Array        # global step counter (for key folding)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Chain:
    """Sampled chain segment (a pytree: valid across jit boundaries)."""

    positions: jax.Array      # (S, W, D)
    log_probs: jax.Array      # (S, W)
    n_accepted: jax.Array     # (W,) accepted moves in this segment
    state: EnsembleState      # final state (resume from here)

    @property
    def acceptance_fraction(self):
        return self.n_accepted / self.positions.shape[0]


def make_logp_batch(log_prob_fn: Callable, *, stochastic: bool = True,
                    chunk: Optional[int] = None) -> Callable:
    """Lift a per-walker log_prob into a batched evaluator.

    log_prob_fn(theta (D,), key) -> scalar   (stochastic=True)
    log_prob_fn(theta (D,)) -> scalar        (stochastic=False)

    ``chunk``: evaluate the batch in vmapped chunks via ``lax.map`` to bound
    peak memory (the Monte-Carlo forward model holds O(n_samples * x_bins)
    intermediates per walker).
    """
    if stochastic:
        per = log_prob_fn
    else:
        def per(theta, key):
            del key
            return log_prob_fn(theta)

    vm = jax.vmap(per)

    def batch(thetas, keys):
        if chunk is None or thetas.shape[0] <= chunk:
            return vm(thetas, keys)
        k = thetas.shape[0]
        if k % chunk:
            raise ValueError(f"batch {k} not divisible by chunk {chunk}")
        thetas_c = thetas.reshape(k // chunk, chunk, -1)
        keys_c = keys.reshape(k // chunk, chunk, *keys.shape[1:])
        out = jax.lax.map(lambda ab: vm(ab[0], ab[1]), (thetas_c, keys_c))
        return out.reshape(k)

    return batch


def init_state(key, p0, logp_batch) -> EnsembleState:
    """Evaluate initial log-probs and build a state. p0: (W, D).

    Pseudo-marginal init guard: the likelihood is a stochastic estimator
    (fresh MC draws per eval), so a walker's FIRST logp can come out
    -inf on an unlucky draw (e.g. a zero model bin against nonzero
    observed counts) even at a perfectly healthy position — and which
    walker it hits is f32-rounding- (hence machine-) dependent.  The
    chain recovers on its own (-inf current state accepts the next valid
    proposal), but the first few recorded steps then carry -inf rows.
    Before the chain starts, the (position, estimate) pair may be drawn
    any way we like, so refresh the estimate of non-finite walkers up to
    8 times (positions unchanged; walkers that are -inf DETERMINISTICALLY
    — outside the prior box — stay -inf, as they should).  When the
    first draw is already all-finite this consumes no extra randomness
    and is bitwise identical to the unguarded init.

    The evaluation runs as one compiled program: called eagerly, a
    sharded ``logp_batch`` (``shard_map``) would dispatch every primitive
    of the forward model as its own multi-device program.
    """
    p0 = jnp.asarray(p0, dtype=jnp.float32)
    n_walkers = p0.shape[0]
    if n_walkers % 2:
        raise ValueError(
            f"n_walkers must be even for the red-black stretch move, "
            f"got {n_walkers}")
    return jax.jit(functools.partial(_init_state, logp_batch))(key, p0)


def _init_state(logp_batch, key, p0) -> EnsembleState:
    n_walkers = p0.shape[0]
    key, k0 = jax.random.split(key)
    lp0 = logp_batch(p0, jax.random.split(k0, n_walkers))

    # Refresh keys: fold_in(k0, small) would collide with split(k0, n)'s
    # outputs under threefry (fold_in(k0, i) IS the i-th split key), so
    # the first refresh round would reuse walker 0's initial key tree —
    # correlated estimator draws.  A large disjoint salt keeps the keys
    # off the split range (n_walkers << 2**30) while preserving the
    # bitwise-identical-when-finite property (no extra split consumed).
    _REFRESH_SALT = 1 << 30

    def _any_bad(carry):
        tries, lp, improved = carry
        # stop early once a refresh round fixes nothing: walkers that are
        # -inf DETERMINISTICALLY (outside the prior box) can never
        # improve, and burning the remaining full-ensemble evals on them
        # is pure waste (9x init cost for one bad walker)
        return jnp.logical_and(
            jnp.logical_and(tries < 8, improved),
            jnp.logical_not(jnp.all(jnp.isfinite(lp))))

    def _refresh(carry):
        tries, lp, _ = carry
        kr = jax.random.fold_in(k0, _REFRESH_SALT + tries)
        lp_new = logp_batch(p0, jax.random.split(kr, n_walkers))
        fixed = jnp.logical_and(jnp.isfinite(lp_new),
                                jnp.logical_not(jnp.isfinite(lp)))
        return (tries + 1, jnp.where(jnp.isfinite(lp), lp, lp_new),
                jnp.any(fixed))

    _, lp0, _ = jax.lax.while_loop(
        _any_bad, _refresh,
        (jnp.asarray(0, jnp.int32), lp0, jnp.asarray(True)))
    return EnsembleState(p0, lp0, key, jnp.asarray(0, jnp.int32))


def _half_update(pos, lp, parity, step_key, logp_batch, a, n_dim):
    """Update the even (parity=0) or odd (parity=1) walkers."""
    n_half = pos.shape[0] // 2
    active = pos[parity::2]
    passive = pos[1 - parity::2]
    lp_active = lp[parity::2]

    kz, kj, ku, ke = jax.random.split(step_key, 4)
    u = jax.random.uniform(kz, (n_half,))
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    j = jax.random.randint(kj, (n_half,), 0, n_half)
    partners = passive[j]
    proposal = partners + z[:, None] * (active - partners)

    eval_keys = jax.random.split(ke, n_half)
    lp_prop = logp_batch(proposal, eval_keys)

    log_ratio = (n_dim - 1.0) * jnp.log(z) + lp_prop - lp_active
    accept = jnp.log(jax.random.uniform(ku, (n_half,))) < log_ratio

    new_active = jnp.where(accept[:, None], proposal, active)
    new_lp_active = jnp.where(accept, lp_prop, lp_active)
    pos = pos.at[parity::2].set(new_active)
    lp = lp.at[parity::2].set(new_lp_active)
    return pos, lp, accept


def _half_update_de(pos, lp, parity, step_key, logp_batch, gamma0,
                    de_sigma):
    """Differential-evolution half-update (ter Braak DE-MC; emcee DEMove).

    Proposal y = x + g * (a - b) with a != b drawn from the complementary
    half and g = gamma0 * (1 + de_sigma * N(0,1)).  The proposal is
    symmetric, so the Metropolis ratio is just logp(y) - logp(x) — no
    stretch-style dimension factor.  DE adapts its step to the ensemble's
    own covariance along EVERY direction (the difference vectors sample
    it), which mixes the eLoss/scale/s lognorm ridge the stretch move
    crawls along; the reference offers emcee's stretch only.
    """
    n_half = pos.shape[0] // 2
    if n_half < 2:
        raise ValueError("the DE move needs >= 4 walkers (two distinct "
                         "complementary-half partners per proposal)")
    active = pos[parity::2]
    passive = pos[1 - parity::2]
    lp_active = lp[parity::2]

    kg, kj, ku, ke = jax.random.split(step_key, 4)
    k1, k2 = jax.random.split(kj)
    j1 = jax.random.randint(k1, (n_half,), 0, n_half)
    # distinct second partner: uniform over the other n_half - 1 indices
    j2 = (j1 + 1 + jax.random.randint(k2, (n_half,), 0, n_half - 1)
          ) % n_half
    g = gamma0 * (1.0 + de_sigma * jax.random.normal(kg, (n_half,)))
    proposal = active + g[:, None] * (passive[j1] - passive[j2])

    eval_keys = jax.random.split(ke, n_half)
    lp_prop = logp_batch(proposal, eval_keys)

    accept = jnp.log(jax.random.uniform(ku, (n_half,))) < lp_prop - lp_active
    new_active = jnp.where(accept[:, None], proposal, active)
    new_lp_active = jnp.where(accept, lp_prop, lp_active)
    pos = pos.at[parity::2].set(new_active)
    lp = lp.at[parity::2].set(new_lp_active)
    return pos, lp, accept


def make_step(logp_batch, a: float = 2.0, *, move: str = "stretch",
              gamma0: Optional[float] = None, de_sigma: float = 1e-5):
    """One full ensemble step (both half-updates) as a scannable function.

    ``move``: 'stretch' (emcee default, bitwise-stable key stream),
    'de' (differential evolution), or 'mixed' (alternate stretch / DE per
    step — a cycle of valid kernels shares their stationary distribution,
    pairing stretch's affine invariance with DE's ridge-following).
    ``gamma0`` defaults to ter Braak's 2.38 / sqrt(2 D).
    """
    if move not in ("stretch", "de", "mixed"):
        raise ValueError(f"unknown move {move!r}")

    def step(state: EnsembleState, _):
        pos, lp, key, step_idx = state
        n_dim = pos.shape[1]
        g0 = (2.38 / (2.0 * n_dim) ** 0.5) if gamma0 is None else gamma0
        key, k_even, k_odd = jax.random.split(
            jax.random.fold_in(key, step_idx), 3)

        def stretch_both(pos, lp):
            pos, lp, acc_e = _half_update(pos, lp, 0, k_even, logp_batch,
                                          a, n_dim)
            pos, lp, acc_o = _half_update(pos, lp, 1, k_odd, logp_batch,
                                          a, n_dim)
            return pos, lp, acc_e, acc_o

        def de_both(pos, lp):
            pos, lp, acc_e = _half_update_de(pos, lp, 0, k_even,
                                             logp_batch, g0, de_sigma)
            pos, lp, acc_o = _half_update_de(pos, lp, 1, k_odd,
                                             logp_batch, g0, de_sigma)
            return pos, lp, acc_e, acc_o

        if move == "stretch":
            pos, lp, acc_e, acc_o = stretch_both(pos, lp)
        elif move == "de":
            pos, lp, acc_e, acc_o = de_both(pos, lp)
        else:  # mixed: even steps stretch, odd steps DE
            pos, lp, acc_e, acc_o = jax.lax.cond(
                step_idx % 2 == 0,
                lambda p, l: stretch_both(p, l),
                lambda p, l: de_both(p, l),
                pos, lp)
        accepted = jnp.zeros(pos.shape[0], jnp.int32)
        accepted = accepted.at[0::2].set(acc_e.astype(jnp.int32))
        accepted = accepted.at[1::2].set(acc_o.astype(jnp.int32))
        new_state = EnsembleState(pos, lp, key, step_idx + 1)
        return new_state, (pos, lp, accepted)

    return step


def run_mcmc(state: EnsembleState, n_steps: int, logp_batch, *,
             a: float = 2.0, unroll: int = 1, move: str = "stretch",
             gamma0: Optional[float] = None, de_sigma: float = 1e-5
             ) -> Chain:
    """Advance the ensemble ``n_steps`` steps under one ``lax.scan``."""
    step = make_step(logp_batch, a, move=move, gamma0=gamma0,
                     de_sigma=de_sigma)
    final, (pos_hist, lp_hist, acc_hist) = jax.lax.scan(
        step, state, None, length=n_steps, unroll=unroll)
    return Chain(pos_hist, lp_hist, jnp.sum(acc_hist, axis=0), final)


def sample(key, p0, n_steps: int, log_prob_fn, *, a: float = 2.0,
           stochastic: bool = True, chunk: Optional[int] = None,
           move: str = "stretch", gamma0: Optional[float] = None) -> Chain:
    """One-call convenience API: init + run.

    Mirrors ``EnsembleSampler(nWalkers, dim, lnprob).run_mcmc(p0, N)``.
    """
    logp_batch = make_logp_batch(log_prob_fn, stochastic=stochastic,
                                 chunk=chunk)
    state = init_state(key, p0, logp_batch)
    return run_mcmc(state, n_steps, logp_batch, a=a, move=move,
                    gamma0=gamma0)
