"""sampling='counts': Poissonized Rao-Blackwell MC (ops/e0grid.poissonized_moments).

The estimator replaces the per-sample draw + one-hot pipeline with
per-fine-cell Poisson counts at the closed-form expected occupancies times
conditional moments.  These tests pin the statistical contract:

* unbiased for the same limit as the faithful MC path (= the 'expected'
  closed form), cell by cell;
* per-cell variance statistically equal to the MC path's (Rao-Blackwell
  makes it <=; Poissonization of the total is cancelled by the forward
  model's normalization);
* per-eval log-probability noise no worse than the MC path's at the same
  draw count (the pseudo-marginal mixing criterion);
* the e0 lattice mean carries sample-faithful jitter around the closed-form
  mean (overflow cells included);
* guard rails for invalid spec combinations.

Reference semantics being emulated: fresh draws per lnlike eval
(``tests/simultFit.py:386-388``) feeding the weighted (x, eD) histogram
(``:263-283``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmctoffitting_tpu.models import onebd, simult
from mcmctoffitting_tpu.models.forward import grid_and_mean
from mcmctoffitting_tpu.ops.e0grid import expected_e0_mean

THETA = jnp.asarray([1878.4, 850.0, 170.0, 0.5], jnp.float32)
N = 50_000
K = 30


@pytest.fixture(scope="module")
def specs():
    mc = simult.default_spec(n_samples=N, xs_mode="e0grid")
    return {
        "mc": mc,
        "counts": dataclasses.replace(mc, sampling="counts"),
        "expected": dataclasses.replace(mc, sampling="expected"),
    }


@pytest.fixture(scope="module")
def grids(specs):
    gm = jax.jit(lambda k, sp: grid_and_mean(sp, THETA, k),
                 static_argnums=1)
    keys = [jax.random.PRNGKey(i) for i in range(K)]
    out = {}
    for name in ("mc", "counts"):
        gs, means = [], []
        for k in keys:
            g, m = gm(k, specs[name])
            gs.append(np.asarray(g))
            means.append(float(m))
        out[name] = (np.stack(gs), np.asarray(means))
    g_ex, m_ex = gm(keys[0], specs["expected"])
    out["expected"] = (np.asarray(g_ex), float(m_ex))
    return out


def test_counts_unbiased_vs_expected(grids):
    """Mean of counts-mode grids == the closed-form limit, within CLT."""
    g_ct, _ = grids["counts"]
    g_ex, _ = grids["expected"]
    mask = g_ex > g_ex.max() * 1e-3
    sem = g_ct.std(axis=0) / np.sqrt(K)
    z = (g_ct.mean(axis=0) - g_ex)[mask] / np.maximum(sem[mask], 1e-12)
    # elementwise 5-sigma over ~500 cells: P(any) ~ 1e-4 under H0
    assert np.abs(z).max() < 5.0


def test_counts_variance_matches_mc(grids):
    """Per-cell variance of the counts estimator == the MC path's.

    Rao-Blackwell makes the within-cell part strictly smaller and
    Poissonization is cancelled by normalization downstream, so the ratio
    should be ~1; with K=30 the sample-variance ratio has ~40% spread per
    cell (F(29,29)), hence the loose per-cell band and a tight median.
    """
    g_mc, _ = grids["mc"]
    g_ct, _ = grids["counts"]
    g_ex, _ = grids["expected"]
    mask = g_ex > g_ex.max() * 1e-2
    r = g_ct.var(axis=0)[mask] / np.maximum(g_mc.var(axis=0)[mask], 1e-12)
    assert 0.7 < np.median(r) < 1.4
    assert np.percentile(r, 90) < 3.0


def test_counts_e0_mean_jitters_around_closed_form(grids):
    """The lattice mean keeps sample-faithful jitter (overflow cells incl.)."""
    _, m_ct = grids["counts"]
    _, m_mc = grids["mc"]
    truth = float(expected_e0_mean(THETA[0], THETA[1], THETA[2], THETA[3],
                                   truncated=True))
    assert abs(np.mean(m_ct) - truth) < 5.0 * np.std(m_ct) / np.sqrt(K)
    # jitter magnitude matches the MC sample mean's (same information)
    assert 0.5 < np.std(m_ct) / np.std(m_mc) < 2.0


def test_counts_logp_noise_not_worse_than_mc(specs):
    """Pseudo-marginal criterion: logp std at fixed theta, counts <= ~mc.

    Uses the PRODUCTION counts spec (default_spec picks the 4x finer grid
    for counts mode; the coarse-F counts estimator is noisier under rint —
    measured 1.38x at F=256 vs 1.18x at F=1024 at 50k draws, and BELOW mc
    at the flagship 200k: 1.08 vs 1.16).
    """
    from mcmctoffitting_tpu.utils import data_io

    truth = np.concatenate([simult.GUESS_SHARED, np.full(2, 5.0e4)])
    th = jnp.asarray(truth, jnp.float32)
    stds = {}
    for name, sp in (("mc", specs["mc"]),
                     ("counts",
                      simult.default_spec(n_samples=N, sampling="counts"))):
        prob = simult.SimultFitProblem(sp, n_runs=2, likelihood="poisson")
        obs = data_io.synthesize_observed(jax.random.PRNGKey(99), prob,
                                          truth)
        logp = jax.jit(prob.make_log_prob_fn(obs))
        vals = np.asarray([float(logp(th, jax.random.PRNGKey(3000 + i)))
                           for i in range(20)])
        assert np.all(np.isfinite(vals))
        stds[name] = vals.std()
    assert stds["counts"] < 1.6 * stds["mc"]


def test_counts_deterministic_per_key(specs):
    gm = jax.jit(lambda k: grid_and_mean(specs["counts"], THETA, k))
    g1, m1 = gm(jax.random.PRNGKey(7))
    g2, m2 = gm(jax.random.PRNGKey(7))
    g3, m3 = gm(jax.random.PRNGKey(8))
    assert np.array_equal(np.asarray(g1), np.asarray(g2))
    assert float(m1) == float(m2)
    assert not np.array_equal(np.asarray(g1), np.asarray(g3))


def test_counts_onebd_untruncated_path(specs):
    """oneBD spec: untruncated draws (n_redraw_rounds=0) + attenuation."""
    spec = onebd.default_spec(n_samples=20_000, sampling="counts")
    theta = jnp.asarray([2490.0, 1300.0, 80.0, 0.6], jnp.float32)
    g, m = jax.jit(lambda k: grid_and_mean(spec, theta, k))(
        jax.random.PRNGKey(0))
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.sum(g)) > 0
    truth = float(expected_e0_mean(theta[0], theta[1], theta[2], theta[3],
                                   truncated=False))
    assert abs(float(m) - truth) < 5.0


def test_counts_guards():
    spec = simult.default_spec(n_samples=1000, xs_mode="taylor")
    bad = dataclasses.replace(spec, sampling="counts")
    with pytest.raises(ValueError, match="e0grid"):
        grid_and_mean(bad, jnp.zeros(4), jax.random.PRNGKey(0))
    good = simult.default_spec(n_samples=1000, sampling="counts")
    bad2 = dataclasses.replace(good, beam_source="gaussian")
    with pytest.raises(ValueError, match="lognorm"):
        grid_and_mean(bad2, jnp.zeros(4), jax.random.PRNGKey(0))


def test_counts_invalid_params_zero_grid(specs):
    """Degenerate theta (scale<=0) -> zero grid, finite mean (NaN-free)."""
    theta = jnp.asarray([1878.4, 850.0, -1.0, 0.5], jnp.float32)
    g, m = jax.jit(lambda k: grid_and_mean(specs["counts"], theta, k))(
        jax.random.PRNGKey(0))
    assert float(jnp.sum(jnp.abs(g))) == 0.0
    assert np.isfinite(float(m))


def test_counts_batched_run_axis_matches_sequential():
    """counts supports both run axes (sequential lax.map is the measured
    default; batched vmap is a spec option): same per-run keys must give
    statistically identical spectra either way."""
    from mcmctoffitting_tpu.models.forward import tof_spectra_multi

    seq = simult.default_spec(n_samples=4000, sampling="counts")
    assert seq.run_axis == "sequential"
    spec = dataclasses.replace(seq, run_axis="batched")
    prob = simult.SimultFitProblem(spec, n_runs=3)
    run_keys = tuple(jax.random.fold_in(jax.random.PRNGKey(7), r)
                     for r in range(3))
    scales = jnp.asarray([5e4, 4e4, 3e4], jnp.float32)
    out_b = tof_spectra_multi(run_keys, THETA, spec, prob.standoffs,
                              prob.windows, scales)
    out_s = tof_spectra_multi(run_keys, THETA, seq, prob.standoffs,
                              prob.windows, scales)
    for b, s in zip(out_b, out_s):
        np.testing.assert_allclose(np.asarray(b), np.asarray(s),
                                   rtol=1e-6, atol=1e-6)
