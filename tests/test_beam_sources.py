"""Beam-source generality of the unified forward model.

Oracles for the three initial-energy families the reference used across
campaigns: lognorm (simultFit/oneBD), skewnorm (ppcTools-era,
``utilities/ppcTools.py:213-217``), gaussian (v2.5,
``tests/intermediateTOFmodel.py:128``) — plus the deterministic-background
mode and PPC on a skewnorm-era chain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats as st

from mcmctoffitting_tpu.models import csi2016, onebd
from mcmctoffitting_tpu.models.forward import (sample_beam_energies,
                                               tof_spectrum)

N = 40_000


def test_skewnorm_source_matches_scipy():
    """eZeros = skewnorm(a=skew0, loc=e0, scale=e0*sigma0)
    (utilities/ppcTools.py:214): KS-compare against scipy's skewnorm."""
    spec = csi2016.default_spec(n_samples=N)
    e0, sigma0, skew0 = 900.0, 0.05, 2.0
    params = jnp.asarray([e0, sigma0, skew0, 1.0])
    draws = np.asarray(sample_beam_energies(jax.random.PRNGKey(0), spec,
                                            params))
    ks = st.kstest(draws, st.skewnorm(a=skew0, loc=e0,
                                      scale=e0 * sigma0).cdf)
    assert ks.pvalue > 1e-3, f"KS p={ks.pvalue}"


def test_skewnorm_source_normal_fallback():
    """Non-positive scale: the reference catches skewnorm's ValueError and
    falls back to a plain normal (utilities/ppcTools.py:213-217).  Here the
    fallback triggers on scale <= 0; draws must stay finite."""
    spec = csi2016.default_spec(n_samples=N)
    params = jnp.asarray([900.0, 0.0, 2.0, 1.0])  # sigma0=0 -> scale=0
    draws = np.asarray(sample_beam_energies(jax.random.PRNGKey(1), spec,
                                            params))
    assert np.isfinite(draws).all()
    # fallback normal has scale clamped to 1; mean must sit at e0
    assert abs(draws.mean() - 900.0) < 0.5


def test_gaussian_source_moments():
    """eZeros = Normal(e0, e0*sigma0) (tests/intermediateTOFmodel.py:128)."""
    spec = dataclasses.replace(csi2016.default_spec(n_samples=N),
                               beam_source="gaussian")
    e0, sigma0 = 1000.0, 0.08
    draws = np.asarray(sample_beam_energies(
        jax.random.PRNGKey(2), spec, jnp.asarray([e0, sigma0, 0.0, 0.0])))
    assert abs(draws.mean() - e0) < 3 * e0 * sigma0 / np.sqrt(N)
    np.testing.assert_allclose(draws.std(), e0 * sigma0, rtol=0.05)


def test_unknown_beam_source_raises():
    import pytest
    spec = dataclasses.replace(csi2016.default_spec(n_samples=16),
                               beam_source="cauchy")
    with pytest.raises(ValueError, match="beam_source"):
        sample_beam_energies(jax.random.PRNGKey(0), spec,
                             jnp.zeros(4))


def test_deterministic_background_mode():
    """bg_mode='expected' adds exactly the background level (no Poisson
    draw): spectrum(bg) == spectrum(no bg) + bg."""
    spec = dataclasses.replace(onebd.default_spec(n_samples=4000),
                               bg_mode="expected")
    problem = onebd.OneBDProblem(spec, n_runs=1)
    theta4 = jnp.asarray([2490.0, 1300.0, 80.0, 0.6])
    key = jax.random.PRNGKey(3)
    base = tof_spectrum(key, theta4, spec, problem.standoffs[0],
                        problem.windows[0], get_pdf=True, scale=5e4)
    with_bg = tof_spectrum(key, theta4, spec, problem.standoffs[0],
                           problem.windows[0], get_pdf=True, scale=5e4,
                           bg_level=jnp.asarray(17.5))
    np.testing.assert_allclose(np.asarray(with_bg), np.asarray(base) + 17.5,
                               rtol=1e-6)


def test_deterministic_bg_joint_logp_is_deterministic():
    """With bg_mode='expected' and a fixed key the joint log-prob is
    reproducible (pseudo-marginal noise comes only from the MC draws)."""
    spec = dataclasses.replace(onebd.default_spec(n_samples=2000),
                               bg_mode="expected")
    problem = onebd.OneBDProblem(spec, n_runs=2)
    rng = np.random.default_rng(0)
    observed = tuple(rng.poisson(150.0, w.n_bins).astype(np.float64)
                     for w in problem.windows)
    logp = problem.make_log_prob_fn(observed)
    theta = jnp.asarray([1300.0, 80.0, 0.6, 5e4, 5e4, 20.0, 20.0],
                        jnp.float32)
    key = jax.random.PRNGKey(4)
    a = float(logp(theta, key))
    b = float(logp(theta, key))
    assert np.isfinite(a) and a == b


def test_ppc_on_skewnorm_era_chain():
    """PPC must be representable for old-campaign
    (skewnorm-parameterized) chains through the unified forward."""
    from mcmctoffitting_tpu.utils.ppc import PPCSampler
    spec = csi2016.default_spec(n_samples=2000)
    problem = csi2016.Csi2016Problem(spec, n_runs=2)
    rng = np.random.default_rng(5)
    center = np.array([900.0, 0.05, 1.0, 1e4])
    scales = np.array([10.0, 0.005, 0.2, 500.0])
    chain = center + scales * rng.standard_normal((40, 6, 4))
    probs = -500.0 + rng.standard_normal((40, 6))
    sampler = PPCSampler(problem, chain, probs)
    result = sampler.generate(jax.random.PRNGKey(6), n_draws=3)
    assert len(result.tof_spectra) == 2
    assert result.tof_spectra[0].shape == (3, problem.windows[0].n_bins)
    assert result.neutron_spectra.shape == (3, spec.x_binning.n,
                                            spec.ed_binning.n)
    for s in result.tof_spectra:
        assert np.isfinite(s).all()
    assert result.neutron_spectra.sum() > 0
