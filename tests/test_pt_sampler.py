"""Parallel-tempering sampler: cold chain correctness + swap machinery."""
import jax
import jax.numpy as jnp
import numpy as np

from mcmctoffitting_tpu.sampler.pt import (default_beta_ladder, sample_pt)


def test_beta_ladder():
    b = default_beta_ladder(5)
    assert b[0] == 1.0
    np.testing.assert_allclose(b[1] / b[0], 2 ** -0.5, rtol=1e-6)
    b2 = default_beta_ladder(4, t_max=100.0)
    np.testing.assert_allclose(b2[-1], 0.01, rtol=1e-6)


def test_cold_chain_recovers_gaussian():
    def loglike(theta):
        return -0.5 * jnp.sum(theta ** 2)

    def logprior(theta):
        return jnp.asarray(0.0)

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (4, 32, 2))
    chain = sample_pt(jax.random.PRNGKey(1), p0, 500, loglike, logprior)
    cold = np.asarray(chain.cold_chain[200:]).reshape(-1, 2)
    assert abs(cold.mean()) < 0.12
    np.testing.assert_allclose(cold.std(axis=0), 1.0, atol=0.12)


def test_hot_chains_are_wider():
    def loglike(theta):
        return -0.5 * jnp.sum(theta ** 2)

    def logprior(theta):
        return jnp.asarray(0.0)

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (4, 32, 2))
    chain = sample_pt(jax.random.PRNGKey(3), p0, 500, loglike, logprior)
    pos = np.asarray(chain.positions[300:])  # (S, T, W, D)
    cold_std = pos[:, 0].std()
    hot_std = pos[:, -1].std()
    # beta_hot = 2^-1.5 ~ 0.35 -> std ~ 1/sqrt(beta) ~ 1.68x wider
    assert hot_std > 1.2 * cold_std


def test_swaps_happen():
    def loglike(theta):
        return -0.5 * jnp.sum(theta ** 2)

    def logprior(theta):
        return jnp.asarray(0.0)

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(4), (3, 16, 2))
    chain = sample_pt(jax.random.PRNGKey(5), p0, 100, loglike, logprior)
    swaps = np.asarray(chain.n_swaps_accepted)
    assert swaps.shape == (2,)
    assert (swaps > 0).all(), "replica exchange never accepted a swap"


def test_multimodal_mixing_beats_plain_ensemble():
    """PT's raison d'etre: a well-separated bimodal target.  The cold PT
    chain must populate both modes."""
    def loglike(theta):
        x = theta[0]
        return jnp.logaddexp(-0.5 * ((x - 6.0) / 0.5) ** 2,
                             -0.5 * ((x + 6.0) / 0.5) ** 2)

    def logprior(theta):
        return jnp.where(jnp.abs(theta[0]) < 20.0, 0.0, -jnp.inf)

    # all walkers start in ONE mode
    p0 = 6.0 + 0.3 * jax.random.normal(jax.random.PRNGKey(6), (8, 32, 1))
    chain = sample_pt(jax.random.PRNGKey(7), p0, 800, loglike, logprior,
                      betas=default_beta_ladder(8, t_max=300.0))
    cold = np.asarray(chain.cold_chain[400:]).reshape(-1)
    frac_left = (cold < 0).mean()
    assert 0.1 < frac_left < 0.9, (
        f"cold chain stuck in one mode (left fraction {frac_left})")


def test_thinning():
    def loglike(theta):
        return -0.5 * jnp.sum(theta ** 2)

    def logprior(theta):
        return jnp.asarray(0.0)

    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(8), (2, 8, 2))
    chain = sample_pt(jax.random.PRNGKey(9), p0, 100, loglike, logprior,
                      thin=10)
    assert chain.positions.shape[0] == 10
    # acceptance is per sampled step (all 100), not per kept row
    acc = np.asarray(chain.acceptance_fraction)
    assert np.all(acc <= 1.0) and acc.mean() > 0.1


def test_pt_on_reduced_tof_posterior_traverses_ridge():
    """Replica exchange on the real physics posterior: the beamE-eLoss direction is a ~34 keV-per-sigma degeneracy
    ridge under the corrected likelihood; the cold chain of a short PT run
    must traverse a macroscopic stretch of it and the inter-rung swaps
    must actually fire."""
    from mcmctoffitting_tpu.cli.shifting_gaussian import main

    out = main(["-model", "tof", "-nTemps", "4", "-ptWalkers", "16",
                "-ptBurnin", "30", "-ptSteps", "60", "-thin", "2",
                "-outputPrefix", "/tmp/sgtest_"])
    assert out["beamE_span_keV"] > 1.0
    assert all(0.0 <= s <= 1.0 for s in out["swap_acceptance"])
    assert max(out["swap_acceptance"]) > 0.01
    # thermodynamic-integration ln Z reported (emcee 2 PTSampler parity)
    ln_z, d_ln_z = out["pt_ln_evidence"]
    assert np.isfinite(ln_z) and np.isfinite(d_ln_z) and d_ln_z >= 0.0


def test_shifting_gaussian_cli_debug_smoke():
    """The reference's full driver shape (ensemble + PT) end-to-end."""
    from mcmctoffitting_tpu.cli.shifting_gaussian import TRUTH, main

    out = main(["--debug", "-outputPrefix", "/tmp/sgtest_"])
    # PT cold medians near truth (generous debug-size tolerances)
    assert abs(out["pt"]["sigma"] - TRUTH[0]) < 0.3
    assert abs((5 * out["pt"]["m"] + out["pt"]["b"])
               - (5 * TRUTH[1] + TRUTH[2])) < 0.5
    # ln Z rides along (correctness of the estimator is pinned against an
    # analytic evidence in test_pt_evidence.py; here: the CLI reports it)
    ln_z, d_ln_z = out["pt_ln_evidence"]
    assert np.isfinite(ln_z) and np.isfinite(d_ln_z) and d_ln_z >= 0.0


def test_adaptive_ladder_equalizes_swap_acceptance():
    """sample_pt_adaptive (Vousden-style): starting from a deliberately
    lopsided ladder, the interior pair swap acceptances must end up closer
    to uniform than they started, posteriors staying correct."""
    from mcmctoffitting_tpu.models import shifting_gaussian as sg
    from mcmctoffitting_tpu.sampler.pt import sample_pt, sample_pt_adaptive

    data = sg.generate_data(jax.random.PRNGKey(3), 800, 1.0, -0.2, 6.0)
    loglike, logprior = sg.make_pt_fns(data, numeric=True)
    # lopsided: one huge gap then tiny ones (bad by construction)
    betas0 = np.asarray([1.0, 0.05, 0.045, 0.04, 0.035], np.float32)
    p0 = (jnp.asarray([1.2, -0.25, 5.5])
          + 0.01 * jax.random.normal(jax.random.PRNGKey(4), (5, 16, 3)))

    fixed = sample_pt(jax.random.PRNGKey(5), p0, 250, loglike, logprior,
                      betas=betas0)
    adapt, betas_f, _ = sample_pt_adaptive(
        jax.random.PRNGKey(5), p0, 250, loglike, logprior, betas=betas0,
        adapt_t0=50.0, adapt_nu=2.0)

    def spread(chain):
        acc = np.asarray(chain.n_swaps_accepted, float) / (250 * 16)
        inner = acc[:-1]  # pairs the adaptation controls
        return inner.max() - inner.min()

    assert spread(adapt) < spread(fixed)
    b = np.asarray(betas_f)
    assert b[0] == 1.0 and np.all(np.diff(b) < 0)  # still a valid ladder
    # endpoints pinned: the hottest temperature is the caller's
    np.testing.assert_allclose(b[-1], betas0[-1], rtol=1e-3)
    # cold posterior still recovers truth
    cold = np.asarray(adapt.cold_chain[120:]).reshape(-1, 3)
    q50 = np.percentile(cold, 50, axis=0)
    assert abs(q50[0] - 1.0) < 0.25
    assert abs((5 * q50[1] + q50[2]) - 5.0) < 0.4
