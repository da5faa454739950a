"""Thermodynamic-integration log-evidence vs an analytic Gaussian.

The reference configures ``emcee.PTSampler`` (``tests/
shiftingGaussian_brute.py:352-360``), whose headline capability beyond
tempered sampling is ``thermodynamic_integration_log_evidence``.  For a
Gaussian likelihood y=0 ~ N(theta, sigma^2 I) under a Gaussian prior
theta ~ N(0, s^2 I) the evidence is closed-form:
Z = prod_i N(0; 0, sigma^2 + s^2).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcmctoffitting_tpu.sampler.pt import (
    default_beta_ladder, sample_pt, thermodynamic_integration_log_evidence)

D, S_PRIOR, SIG = 2, 3.0, 1.0
LNZ_TRUE = D * (-0.5 * np.log(2 * np.pi * (SIG ** 2 + S_PRIOR ** 2)))


def _loglike(th):
    return jnp.sum(-0.5 * (th / SIG) ** 2 - 0.5 * jnp.log(2 * jnp.pi * SIG ** 2))


def _logprior(th):
    return jnp.sum(-0.5 * (th / S_PRIOR) ** 2
                   - 0.5 * jnp.log(2 * jnp.pi * S_PRIOR ** 2))


@pytest.fixture(scope="module")
def pt_chain():
    betas = default_beta_ladder(16)
    p0 = jax.random.normal(jax.random.key(1), (16, 64, D)) * S_PRIOR
    chain = sample_pt(jax.random.key(0), p0, 800, _loglike, _logprior,
                      betas=betas)
    return chain, betas


def test_ti_log_evidence_matches_analytic(pt_chain):
    chain, betas = pt_chain
    ln_z, d_ln_z = thermodynamic_integration_log_evidence(
        chain.log_like, betas, fburnin=0.3)
    # measured |err| ~ 0.03 at this config with d_ln_z ~ 0.06
    assert abs(ln_z - LNZ_TRUE) < 0.15
    assert abs(ln_z - LNZ_TRUE) < 4.0 * d_ln_z + 0.05
    assert 0.0 < d_ln_z < 0.5


def test_ti_method_on_chain(pt_chain):
    chain, betas = pt_chain
    ln_z_fn, _ = thermodynamic_integration_log_evidence(
        chain.log_like, betas, fburnin=0.3)
    ln_z_m, _ = chain.thermodynamic_integration_log_evidence(
        betas, fburnin=0.3)
    assert ln_z_m == ln_z_fn
    # the chain stores the ladder it was sampled at; the no-arg call
    # must use it (no re-derivation at call sites)
    np.testing.assert_allclose(np.asarray(chain.betas), betas, rtol=1e-6)
    ln_z_default, _ = chain.thermodynamic_integration_log_evidence(
        fburnin=0.3)
    assert ln_z_default == ln_z_fn


def test_ti_rejects_bad_ladders(pt_chain):
    chain, betas = pt_chain
    with pytest.raises(ValueError, match="decreasing"):
        thermodynamic_integration_log_evidence(chain.log_like, betas[::-1])
    with pytest.raises(ValueError, match="T == len"):
        thermodynamic_integration_log_evidence(chain.log_like, betas[:-1])


def test_ti_evidence_ranks_models(pt_chain):
    """A mis-scaled likelihood (sigma 3x too wide) must lose in evidence."""
    chain, betas = pt_chain

    def loglike_bad(th):
        return jnp.sum(-0.5 * (th / (3 * SIG)) ** 2
                       - 0.5 * jnp.log(2 * jnp.pi * (3 * SIG) ** 2))

    p0 = jax.random.normal(jax.random.key(3), (16, 64, D)) * S_PRIOR
    chain_bad = sample_pt(jax.random.key(2), p0, 800, loglike_bad,
                          _logprior, betas=betas)
    ln_z, _ = thermodynamic_integration_log_evidence(
        chain.log_like, betas, fburnin=0.3)
    ln_z_bad, _ = thermodynamic_integration_log_evidence(
        chain_bad.log_like, betas, fburnin=0.3)
    lnz_bad_true = D * (-0.5 * np.log(2 * np.pi * ((3 * SIG) ** 2
                                                   + S_PRIOR ** 2)))
    assert ln_z > ln_z_bad
    assert abs(ln_z_bad - lnz_bad_true) < 0.15


def test_ti_odd_ladder_error_bar_keeps_beta0_endpoint():
    """Regression: betas[::2] on an odd rung count dropped the appended
    beta=0 endpoint, inflating d_ln_z by the whole hot-tail strip.

    Construct a chain whose mean ln L is exactly linear in beta: the
    trapezoid rule is then exact at ANY resolution, so d_ln_z must be ~0
    for every ladder size, odd or even.
    """
    for n_temps in (15, 16, 21):
        betas = default_beta_ladder(n_temps)
        # mean ln L(beta) = a + b*beta, identical across walkers/steps
        ll = (2.0 + 3.0 * betas)[None, :, None] * np.ones((50, n_temps, 4))
        ln_z, d_ln_z = thermodynamic_integration_log_evidence(
            ll, betas, fburnin=0.2)
        # residual ~2e-5 is the real flat-tail [0, beta_min] quadrature
        # error; the dropped-endpoint bug measured 0.0775 at n_temps=15
        assert d_ln_z < 1e-3, (n_temps, d_ln_z)
        # ln Z = integral of (2 + 3 beta) over beta in [0, 1] = 3.5
        assert abs(ln_z - 3.5) < 1e-2
