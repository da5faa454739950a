"""Ensemble sampler: correctness on analytic targets (SURVEY.md §7.2 step 5).

emcee itself is not installed in this environment, so parity is established
statistically: the stretch move must reproduce known posteriors (Gaussian
moments, correlated Gaussian covariance) and emcee's structural behavior
(acceptance fractions in the canonical 0.2-0.7 band, per-walker chains).
"""
import jax
import jax.numpy as jnp
import numpy as np

from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                        run_mcmc, sample)


def gaussian_logp(theta):
    return -0.5 * jnp.sum(theta ** 2)


def test_recovers_standard_gaussian():
    key = jax.random.PRNGKey(0)
    n_walkers, n_dim = 64, 3
    p0 = 0.1 * jax.random.normal(key, (n_walkers, n_dim))
    chain = sample(jax.random.PRNGKey(1), p0, 600, gaussian_logp,
                   stochastic=False)
    samples = np.asarray(chain.positions[200:]).reshape(-1, n_dim)
    # autocorrelated ensemble samples: the effective sample size is far
    # below 64*400, so allow ~0.1 on the mean
    assert abs(samples.mean()) < 0.1
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.1)


def test_acceptance_fraction_in_band():
    key = jax.random.PRNGKey(2)
    p0 = 0.1 * jax.random.normal(key, (64, 3))
    chain = sample(jax.random.PRNGKey(3), p0, 400, gaussian_logp,
                   stochastic=False)
    acc = np.asarray(chain.acceptance_fraction)
    assert acc.shape == (64,)
    # canonical stretch-move band for an easy Gaussian target
    assert 0.2 < acc.mean() < 0.8


def test_correlated_gaussian_covariance():
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def logp(theta):
        return -0.5 * theta @ prec @ theta

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(4), (100, 2))
    chain = sample(jax.random.PRNGKey(5), p0, 800, logp, stochastic=False)
    samples = np.asarray(chain.positions[300:]).reshape(-1, 2)
    got_cov = np.cov(samples.T)
    np.testing.assert_allclose(got_cov, cov, rtol=0.2, atol=0.15)


def test_stochastic_logp_gets_fresh_keys():
    """Pseudo-marginal mode: the log-prob receives a PRNG key per eval."""
    noise_scale = 0.01

    def noisy_logp(theta, key):
        return (-0.5 * jnp.sum(theta ** 2)
                + noise_scale * jax.random.normal(key))

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (32, 2))
    chain = sample(jax.random.PRNGKey(7), p0, 300, noisy_logp,
                   stochastic=True)
    samples = np.asarray(chain.positions[100:]).reshape(-1, 2)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12)


def test_resume_matches_continuous_run():
    """Checkpoint/resume: 2x50 steps from saved state == 100 straight."""
    logp_batch = make_logp_batch(gaussian_logp, stochastic=False)
    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(8), (16, 2))
    s0 = init_state(jax.random.PRNGKey(9), p0, logp_batch)

    full = run_mcmc(s0, 100, logp_batch)
    part1 = run_mcmc(s0, 50, logp_batch)
    part2 = run_mcmc(part1.state, 50, logp_batch)

    np.testing.assert_allclose(np.asarray(full.positions[-1]),
                               np.asarray(part2.positions[-1]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(full.log_probs[-1]),
                               np.asarray(part2.log_probs[-1]), rtol=1e-5)


def test_chunked_batch_eval_matches_unchunked():
    logp_b1 = make_logp_batch(gaussian_logp, stochastic=False)
    logp_b2 = make_logp_batch(gaussian_logp, stochastic=False, chunk=8)
    thetas = jax.random.normal(jax.random.PRNGKey(10), (32, 3))
    keys = jax.random.split(jax.random.PRNGKey(11), 32)
    np.testing.assert_allclose(np.asarray(logp_b1(thetas, keys)),
                               np.asarray(logp_b2(thetas, keys)), rtol=1e-6)


def test_walkers_do_not_collapse():
    """Ensemble stays spread (each walker an independent chain)."""
    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(12), (32, 2))
    chain = sample(jax.random.PRNGKey(13), p0, 200, gaussian_logp,
                   stochastic=False)
    final = np.asarray(chain.positions[-1])
    assert np.unique(final[:, 0]).size > 16


def test_init_state_refreshes_unlucky_stochastic_logp():
    """Pseudo-marginal init guard: a stochastic likelihood that comes up
    -inf on some evals must not seed the chain with -inf rows when a
    finite estimate exists at the same position; deterministically-
    invalid positions (prior box) must STAY -inf."""
    def flaky_logp(theta, key):
        # ~half of estimator draws are -inf at any position; x>5 is
        # outside the "prior box" and always -inf
        bad_draw = jax.random.uniform(key, ()) < 0.5
        out_of_box = theta[0] > 5.0
        return jnp.where(jnp.logical_or(bad_draw, out_of_box),
                         -jnp.inf, -0.5 * jnp.sum(theta ** 2))

    logp_batch = make_logp_batch(flaky_logp, stochastic=True)
    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(20), (32, 2))
    s0 = init_state(jax.random.PRNGKey(21), p0, logp_batch)
    # P(all 8 refreshes -inf) = 2^-9 per walker; seed chosen green
    assert np.all(np.isfinite(np.asarray(s0.log_probs)))

    p_bad = p0.at[3, 0].set(9.0)  # deterministically outside the box
    s1 = init_state(jax.random.PRNGKey(21), p_bad, logp_batch)
    lp = np.asarray(s1.log_probs)
    assert lp[3] == -np.inf and np.isfinite(np.delete(lp, 3)).all()


def test_init_state_bitwise_unchanged_when_first_draw_finite():
    """The guard consumes no randomness when the first eval is finite:
    the state must carry exactly the unguarded derivation — logps from
    the first split of PRNGKey and the chain key from the other half."""
    logp_batch = make_logp_batch(gaussian_logp, stochastic=False)
    p0 = jnp.asarray(
        0.1 * jax.random.normal(jax.random.PRNGKey(22), (16, 2)),
        jnp.float32)
    s0 = init_state(jax.random.PRNGKey(23), p0, logp_batch)
    key, k0 = jax.random.split(jax.random.PRNGKey(23))
    # compiled, as init_state evaluates it (eager op-by-op rounding may
    # differ from the fused program in the last bit)
    want_lp = jax.jit(logp_batch)(p0, jax.random.split(k0, 16))
    np.testing.assert_array_equal(np.asarray(s0.log_probs),
                                  np.asarray(want_lp))
    np.testing.assert_array_equal(np.asarray(s0.key), np.asarray(key))
