"""Box-logit transform (sampler/transforms.py): exactness + NUTS impact.

The transform fixes the flagship NUTS divergence rate: box faces move to
infinity, so leapfrog never lands on a -inf prior cliff.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmctoffitting_tpu.sampler.transforms import BoxLogitTransform


LO = np.array([1825.0, 600.0, 0.0], np.float32)
HI = np.array([1925.0, 1000.0, 1.0e6], np.float32)


def test_round_trip():
    tr = BoxLogitTransform(LO, HI)
    theta = jnp.asarray([[1878.4, 850.0, 5.0e4],
                         [1830.0, 990.0, 9.9e5]], jnp.float32)
    back = tr.to_theta(tr.to_u(theta))
    np.testing.assert_allclose(np.asarray(back), np.asarray(theta),
                               rtol=2e-4)


def test_log_det_matches_autodiff_jacobian():
    tr = BoxLogitTransform(LO, HI)
    u = jnp.asarray([0.3, -1.2, 2.0], jnp.float32)
    jac = jax.jacfwd(tr.to_theta)(u)
    want = np.linalg.slogdet(np.asarray(jac, np.float64))[1]
    got = float(tr.log_det_jacobian(u))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_faces_map_to_finite_u_and_boundary_logdet_is_neg_inf_free():
    tr = BoxLogitTransform(LO, HI)
    u_edge = tr.to_u(jnp.asarray(LO))          # exactly on the low face
    assert np.all(np.isfinite(np.asarray(u_edge)))
    assert np.isfinite(float(tr.log_det_jacobian(u_edge)))


def test_wrap_logp_is_the_exact_change_of_variables():
    """Integral check by importance sampling: under logp_u, u-samples
    pushed through to_theta must have the target theta-density — here a
    box-truncated Gaussian, checked via NUTS moments."""
    from mcmctoffitting_tpu.sampler import nuts_sample

    lo = np.array([-1.0, -2.0], np.float32)
    hi = np.array([3.0, 2.0], np.float32)
    tr = BoxLogitTransform(lo, hi)
    mu = jnp.asarray([0.5, -0.25])
    sig = jnp.asarray([0.6, 0.8])

    def logp_theta(theta):
        return -0.5 * jnp.sum(((theta - mu) / sig) ** 2)

    logp_u = tr.wrap_logp(logp_theta)
    p0 = tr.to_u(jnp.asarray([[0.4, 0.0], [0.6, -0.5], [0.5, 0.5],
                              [0.0, 0.0]], jnp.float32))
    chain = nuts_sample(jax.random.PRNGKey(0), p0, 400, logp_u,
                        n_warmup=300)
    theta = np.asarray(tr.to_theta(chain.positions)).reshape(-1, 2)
    n_div = int(np.sum(np.asarray(chain.diverging)))
    assert n_div == 0, f"box-logit NUTS diverged {n_div} times"
    # truncation barely clips this target; moments ~ the Gaussian's
    se = np.asarray(sig) / np.sqrt(200.0)   # generous tau allowance
    assert np.all(np.abs(theta.mean(0) - np.asarray(mu)) < 6 * se + 0.03)
    np.testing.assert_allclose(theta.std(0), np.asarray(sig), rtol=0.15)


def test_bad_bounds_raise():
    with pytest.raises(ValueError):
        BoxLogitTransform([0.0, 1.0], [1.0, 1.0])
