"""NUTS sampler (sampler/nuts.py) — statistical correctness.

Parity target: the reference's pymc3 NUTS experiment
(``tests/testSimpleNested.py:181-220``).  Checks: moment recovery on
known Gaussian targets (incl. a strongly correlated one, where dynamic
trajectory lengths are what NUTS exists for), sane tree behavior, and
agreement with the package's own HMC on the same target.
"""
import jax
import jax.numpy as jnp
import numpy as np

from mcmctoffitting_tpu.sampler import hmc_sample, nuts_sample


def _flat(chain, burn=0):
    z = np.asarray(chain.positions[burn:])
    return z.reshape(-1, z.shape[-1])


def test_standard_normal_moments():
    def logp(x):
        return -0.5 * jnp.sum(x * x)

    key = jax.random.PRNGKey(0)
    p0 = jax.random.normal(key, (4, 3))
    chain = nuts_sample(jax.random.fold_in(key, 1), p0, 600, logp,
                        n_warmup=200, max_depth=6)
    z = _flat(chain)
    n_eff_guess = 400.0  # conservative vs the ~2400 draws
    tol = 4.0 / np.sqrt(n_eff_guess)
    assert np.abs(z.mean(axis=0)).max() < tol
    assert np.abs(z.std(axis=0) - 1.0).max() < 2.0 * tol
    # adaptation hit a sensible step size and acceptance
    assert 0.05 < chain.step_size < 5.0
    a = float(np.mean(np.asarray(chain.accept_stat)))
    assert 0.55 < a <= 1.0
    assert not np.asarray(chain.diverging).any()


def test_correlated_gaussian_covariance():
    rho = 0.95
    cov = np.array([[1.0, rho], [rho, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def logp(x):
        return -0.5 * x @ prec @ x

    key = jax.random.PRNGKey(2)
    p0 = 0.1 * jax.random.normal(key, (4, 2))
    chain = nuts_sample(jax.random.fold_in(key, 3), p0, 1500, logp,
                        n_warmup=300, max_depth=8)
    z = _flat(chain, burn=100)
    emp = np.cov(z.T)
    assert np.abs(emp - cov).max() < 0.2, emp
    # the correlated target needs multi-doubling trajectories: NUTS should
    # actually grow its tree (this is what the jittered-HMC stand-in lacks)
    mean_depth = float(np.mean(np.asarray(chain.tree_depth)))
    assert mean_depth > 1.5, mean_depth
    assert mean_depth < 8.0


def test_matches_hmc_on_shared_target():
    def logp(x):
        # anisotropic Gaussian, scales (1, 0.3)
        return -0.5 * (x[0] ** 2 + (x[1] / 0.3) ** 2)

    key = jax.random.PRNGKey(4)
    p0 = jax.random.normal(key, (4, 2)) * jnp.asarray([1.0, 0.3])
    nuts = nuts_sample(jax.random.fold_in(key, 5), p0, 1000, logp,
                       n_warmup=250, max_depth=7)
    hmc = hmc_sample(jax.random.fold_in(key, 6), p0, 1000, logp,
                     n_warmup=250, n_leapfrog=16)
    zn = _flat(nuts, burn=100)
    zh = np.asarray(hmc.positions[100:]).reshape(-1, 2)
    for d, scale in enumerate((1.0, 0.3)):
        assert np.abs(zn[:, d].std() - scale) < 0.12 * max(scale, 0.5)
        assert np.abs(zn[:, d].std() - zh[:, d].std()) < 0.15


def test_divergence_flag_on_pathological_target():
    """A near-discontinuous target at a huge step size must flag
    divergences rather than silently accept garbage."""
    def logp(x):
        return -0.5 * jnp.sum((x * 50.0) ** 2)  # tiny scale

    key = jax.random.PRNGKey(7)
    p0 = jnp.ones((2, 2))
    from mcmctoffitting_tpu.sampler.nuts import _transition
    logp_grad = jax.value_and_grad(logp)
    lp0, g0 = jax.vmap(logp_grad)(p0)
    vtrans = jax.vmap(
        lambda z, lp, g, k: _transition(logp_grad, z, lp, g, k,
                                        jnp.float32(10.0), 4))
    out = vtrans(p0, lp0, g0, jax.random.split(key, 2))
    assert np.asarray(out[5]).all()  # diverging flag set


def test_nuts_on_shifting_gaussian_model():
    """NUTS on the analytic model the reference drove through pm.NUTS
    (``tests/testSimpleNested.py:181-220``): MAP-adjacent start + NUTS,
    recovering the synthesis truth."""
    from mcmctoffitting_tpu.models import shifting_gaussian as sg
    data = sg.generate_data(jax.random.PRNGKey(6), 1500, 1.0, -0.2, 6.0)
    obs = jnp.asarray(data)

    def logp(theta):
        th = jnp.stack([jnp.abs(theta[0]) + 1e-3, theta[1], theta[2]])
        return sg.loglike_projected(th, obs, numeric=True)

    p0 = (jnp.asarray([1.1, -0.22, 5.9])
          + 0.01 * jax.random.normal(jax.random.PRNGKey(7), (4, 3)))
    chain = nuts_sample(jax.random.PRNGKey(8), p0, 300, logp,
                        n_warmup=150, max_depth=6)
    samples = _flat(chain, burn=100)
    q50 = np.percentile(samples, 50, axis=0)
    assert abs(abs(q50[0]) - 1.0) < 0.15
    assert abs((5 * q50[1] + q50[2]) - 5.0) < 0.25
    assert not np.asarray(chain.diverging)[100:].any()


def test_nuts_gradients_on_flagship_posterior():
    """Gradient-based NUTS on the REAL physics posterior — impossible in
    the reference (its likelihood is MC + int()-sawtooth).  Requires the
    differentiable configuration: expected forward (closed-form moments),
    correct Poisson likelihood, rint off (rint has zero gradient).
    Cross-validates the corrected-likelihood ensemble results: the
    beamE-eLoss degeneracy ridge is wide, their difference tight."""
    import dataclasses

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.utils import data_io

    spec = dataclasses.replace(
        simult.default_spec(n_samples=200_000, sampling="expected"),
        rint_draws=False)
    prob = simult.SimultFitProblem(spec, n_runs=2, likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, [5e4, 5e4]])
    observed = data_io.synthesize_observed(jax.random.PRNGKey(9), prob,
                                           truth)
    logp_full = prob.make_log_prob_fn(observed)
    key0 = jax.random.PRNGKey(0)   # unused: deterministic likelihood
    center = jnp.asarray(truth, jnp.float32)
    scales = jnp.asarray([30.0, 30.0, 3.0, 0.01, 300.0, 300.0],
                         jnp.float32)

    def logp_u(u):
        return logp_full(center + scales * u, key0)

    g = np.asarray(jax.grad(logp_u)(jnp.zeros(6)))
    assert np.isfinite(g).all()
    assert (np.abs(g[:4]) > 0.05).all(), g  # shape dims carry gradient
    # the beamE-eLoss degeneracy shows as near-opposite gradients
    assert abs(g[0] + g[1]) < 0.2 * (abs(g[0]) + abs(g[1]) + 1e-6)

    chain = nuts_sample(
        jax.random.PRNGKey(1),
        0.1 * jax.random.normal(jax.random.PRNGKey(2), (2, 6)),
        150, logp_u, n_warmup=120, max_depth=6)
    z = (np.asarray(chain.positions[50:]).reshape(-1, 6)
         * np.asarray(scales) + np.asarray(center))
    # the constrained combination: mean on-target energy beamE - eLoss
    diff = z[:, 0] - z[:, 1]
    # short chains (2 x 100 post-burn draws): the difference posterior is
    # ~+-4 wide, so the median carries a few keV of sampling error
    assert abs(np.median(diff) - 1028.4) < 10.0
    # the ridge itself is wide (the sawtooth's false +-1 keV is gone)
    assert np.std(z[:, 0]) > 8.0


def test_mass_matrix_adaptation_handles_anisotropy():
    """Scales (1, 0.05) without manual standardization: the windowed
    warm-up must estimate the diagonal metric and recover both scales;
    with adapt_mass=False the identity metric needs far deeper trees."""
    def logp(x):
        return -0.5 * (x[0] ** 2 + (x[1] / 0.05) ** 2)

    key = jax.random.PRNGKey(11)
    p0 = jax.random.normal(key, (4, 2)) * jnp.asarray([1.0, 0.05])
    chain = nuts_sample(jax.random.fold_in(key, 1), p0, 600, logp,
                        n_warmup=300, max_depth=8)
    z = _flat(chain, burn=100)
    assert abs(z[:, 0].std() - 1.0) < 0.15
    assert abs(z[:, 1].std() - 0.05) < 0.01
    # the adapted metric should be ~the marginal variances
    im = np.asarray(chain.inv_mass)
    assert 0.4 < im[0] < 2.5
    assert 0.4 < im[1] / 0.05 ** 2 < 2.5
    # with the metric, trajectories need not resolve the 20:1 ratio
    depth_adapted = float(np.mean(np.asarray(chain.tree_depth)))
    chain_id = nuts_sample(jax.random.fold_in(key, 2), p0, 200, logp,
                           n_warmup=200, max_depth=8, adapt_mass=False)
    depth_identity = float(np.mean(np.asarray(chain_id.tree_depth)))
    assert depth_adapted < depth_identity, (depth_adapted, depth_identity)


def test_segmented_dispatch_is_bitwise_identical():
    """segment_steps caps device dispatch length; the segmented execution
    must reproduce the single-scan program EXACTLY — same transitions,
    same adaptation, same draws."""
    key = jax.random.PRNGKey(11)

    def logp(x):
        return -0.5 * jnp.sum(x ** 2)

    p0 = jax.random.normal(jax.random.fold_in(key, 0), (4, 3))
    one = nuts_sample(jax.random.fold_in(key, 1), p0, 90, logp,
                      n_warmup=80)
    seg = nuts_sample(jax.random.fold_in(key, 1), p0, 90, logp,
                      n_warmup=80, segment_steps=16)
    assert one.step_size == seg.step_size
    np.testing.assert_array_equal(np.asarray(one.positions),
                                  np.asarray(seg.positions))
    np.testing.assert_array_equal(np.asarray(one.diverging),
                                  np.asarray(seg.diverging))

    h_one = hmc_sample(jax.random.fold_in(key, 2), p0, 60, logp,
                       n_warmup=40)
    h_seg = hmc_sample(jax.random.fold_in(key, 2), p0, 60, logp,
                       n_warmup=40, segment_steps=16)
    assert h_one.step_size == h_seg.step_size
    np.testing.assert_array_equal(np.asarray(h_one.positions),
                                  np.asarray(h_seg.positions))
