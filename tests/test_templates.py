"""Template-fitting model: generation, cache, matvec build, likelihood."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmctoffitting_tpu.config import Binning
from mcmctoffitting_tpu.constants import TUNL_SSA_CSI
from mcmctoffitting_tpu.models import templates as T
from mcmctoffitting_tpu.models.forward import ForwardSpec
from mcmctoffitting_tpu.ops.stopping import d2_gas_stopping


def small_spec():
    """Reduced binning/samples for CPU tests."""
    return ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=Binning(200.0, 1700.0, 30),
        x_binning=Binning(0.0, TUNL_SSA_CSI.cell_length, 10),
        stopping=d2_gas_stopping(),
        transport="rk4",
        zero_degree="none",
        add_half_zero_deg=True,
        n_samples=5000,
    )


def test_template_spectrum_properties():
    spec = small_spec()
    win = T.tof_windows["mid"]
    out = np.asarray(T.template_spectrum(
        jax.random.PRNGKey(0), 800.0, 825.0, spec,
        TUNL_SSA_CSI.standoff_mid, win))
    assert out.shape == (win.n_bins,)
    assert np.isfinite(out).all() and out.sum() > 0
    # a monoenergetic slice produces a concentrated TOF peak (the
    # exGaussian kernel spreads it over ~5 ns)
    peak_frac = out.max() / out.sum()
    assert peak_frac > 0.08


def test_higher_energy_slice_arrives_earlier():
    spec = small_spec()
    win = T.tof_windows["mid"]
    lo_e = np.asarray(T.template_spectrum(
        jax.random.PRNGKey(1), 500.0, 525.0, spec,
        TUNL_SSA_CSI.standoff_mid, win))
    hi_e = np.asarray(T.template_spectrum(
        jax.random.PRNGKey(2), 1100.0, 1125.0, spec,
        TUNL_SSA_CSI.standoff_mid, win))
    centers = np.linspace(win.lo, win.hi, win.n_bins)
    assert (centers * hi_e).sum() / hi_e.sum() < \
           (centers * lo_e).sum() / lo_e.sum()


def test_csv_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tmpl = [rng.random((T.N_TEMPLATES, 50)), rng.random((T.N_TEMPLATES, 45))]
    path = str(tmp_path / "templates.csv")
    T.save_templates_csv(path, tmpl)
    # per-run bin counts differ; loader needs uniform rows per run — save
    # and load run-by-run like the reference does for its 4 standoffs
    loaded = T.load_templates_csv(path, n_runs=2)
    np.testing.assert_allclose(loaded[0], tmpl[0], rtol=1e-12)
    np.testing.assert_allclose(loaded[1], tmpl[1], rtol=1e-12)


def test_build_model_tof_is_matvec():
    rng = np.random.default_rng(1)
    tmpl = rng.random((T.N_TEMPLATES, 50)).astype(np.float32)
    coeffs = rng.random(T.N_TEMPLATES).astype(np.float32)
    got = np.asarray(T.build_model_tof(2.0, coeffs, tmpl))
    want = 2.0 * coeffs @ tmpl
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_problem_log_prob_and_prior():
    rng = np.random.default_rng(2)
    prob = T.TemplateFitProblem(n_runs=4)
    templates = [rng.random((T.N_TEMPLATES, w.n_bins)).astype(np.float32)
                 * 100 for w in prob.windows]
    observed = [rng.poisson(500, w.n_bins).astype(np.float64)
                for w in prob.windows]
    logp = prob.make_log_prob_fn(observed, templates)

    theta_ok = jnp.concatenate([
        jnp.asarray([1.0, 0.5, 1.5]),
        jnp.full(T.N_TEMPLATES, 10.0)])
    lp = float(logp(theta_ok, jax.random.PRNGKey(0)))
    assert np.isfinite(lp)

    # scale outside per-run limits -> -inf (scaleLims, devShapeTemplates:350)
    theta_bad = theta_ok.at[1].set(2.0)  # run-3 scale lim is (0.25, 1.0)
    assert float(logp(theta_bad, jax.random.PRNGKey(0))) == -np.inf
    # negative coefficient -> -inf
    theta_bad2 = theta_ok.at[5].set(-1.0)
    assert float(logp(theta_bad2, jax.random.PRNGKey(0))) == -np.inf


def test_recover_coefficients_shape():
    """Sanity: fitting data built FROM the templates prefers the true
    coefficients over a shuffled version."""
    rng = np.random.default_rng(3)
    prob = T.TemplateFitProblem(n_runs=2)
    templates = [rng.random((T.N_TEMPLATES, w.n_bins)).astype(np.float32)
                 * 50 for w in prob.windows]
    true_coeffs = rng.uniform(5, 50, T.N_TEMPLATES)
    observed = [np.asarray(T.build_model_tof(1.0, true_coeffs, t))
                for t in templates]
    logp = prob.make_log_prob_fn(observed, templates)
    theta_true = jnp.concatenate([jnp.asarray([0.9, 0.5, 1.5]),
                                  jnp.asarray(true_coeffs)])
    theta_perm = jnp.concatenate([jnp.asarray([0.9, 0.5, 1.5]),
                                  jnp.asarray(rng.permutation(true_coeffs))])
    assert float(logp(theta_true, jax.random.PRNGKey(0))) > \
        float(logp(theta_perm, jax.random.PRNGKey(0)))


def test_initial_guess_model():
    g = T.TemplateFitProblem().initial_guess_model()
    assert g.shape == (T.N_TEMPLATES,)
    assert g.max() > 0
    # peaked around ~800 keV
    centers = (T.TEMPLATE_BOUNDS[:-1] + T.TEMPLATE_BOUNDS[1:]) / 2
    assert 700 < centers[np.argmax(g)] < 900


def test_template_fit_cli_writes_unfolded_spectrum(tmp_path, monkeypatch):
    """The driver's closing visualization (the reference ends with an
    unfolded-spectrum plot, tests/devShapeTemplates.py:584-631) must be
    produced by the CLI, not just the trace plot."""
    import os

    monkeypatch.chdir(tmp_path)
    from mcmctoffitting_tpu.cli.template_fit import main

    out = main(["-nDraws", "2000", "-nWalkers", "16", "-nBurnin", "10",
                "-templateFile", str(tmp_path / "templates.csv"),
                "-outputPrefix", "tf_"])
    assert len(out["coeffs_median"]) == T.N_TEMPLATES
    png = tmp_path / "tf_unfolded_spectrum.png"
    assert png.exists() and os.path.getsize(png) > 5_000
    assert (tmp_path / "tf_trace.png").exists()


@pytest.mark.slow
def test_template_closure_nuts_recovers_truth():
    """35-dim statistical closure at reduced scale (the committed
    production artifact is tools/template_closure.py -> artifacts/
    template_closure_*): synthesize observed spectra from known
    coefficients with the likelihood's OWN noise law (7%/15% relative
    Gaussian; Poisson counts are ~45x overdispersed vs the assumed
    error in low-count bins and measure likelihood misspecification,
    not the sampler), fit with NUTS in box-logit coordinates, and
    require the recovered quantiles to bracket truth.

    Reference endpoint: tests/devShapeTemplates.py:554-631 (500-walker
    emcee unfolding; its ensemble acceptance collapses to ~0.05 on this
    posterior — the gradient sampler is the production answer here).
    """
    import jax.numpy as jnp

    from mcmctoffitting_tpu.sampler.nuts import nuts_sample
    from mcmctoffitting_tpu.sampler.transforms import BoxLogitTransform

    spec = T.default_spec(n_samples=3000)
    problem = T.TemplateFitProblem(n_runs=4)
    templates = T.generate_templates(jax.random.PRNGKey(0), spec)

    true_coeffs = problem.initial_guess_model()
    true_scales = [1.0, 1.1, 0.6, 1.5]
    rng = np.random.default_rng(7)
    sigma_rel = (0.07 ** -2 + 0.15 ** -2) ** -0.5
    observed = []
    for r in range(4):
        model = np.asarray(T.build_model_tof(true_scales[r], true_coeffs,
                                             templates[r]))
        noisy = model * (1 + sigma_rel * rng.standard_normal(model.shape))
        observed.append(np.where(model >= 1.0, np.maximum(noisy, 0.0), 0.0))

    logp = problem.make_log_prob_fn(observed, templates)
    lo = np.concatenate([[l0 for (l0, _) in T.SCALE_LIMS],
                         np.zeros(T.N_TEMPLATES)])
    hi = np.concatenate([[h0 for (_, h0) in T.SCALE_LIMS],
                         np.full(T.N_TEMPLATES, T.COEFF_LIM[1])])
    tr = BoxLogitTransform(jnp.asarray(lo, jnp.float32),
                           jnp.asarray(hi, jnp.float32))
    guess = np.concatenate([[1.1, 0.6, 1.5], true_coeffs])
    u = rng.uniform(0.9, 1.1, (2, problem.n_dim))
    p0 = jnp.asarray(np.clip(guess * u, lo + 1e-6, hi - 1e-6), jnp.float32)
    chain = nuts_sample(jax.random.PRNGKey(5), tr.to_u(p0), 400,
                        tr.wrap_logp(lambda th: logp(th, None)),
                        n_warmup=150, max_depth=8)
    samples = np.asarray(tr.to_theta(chain.positions)).reshape(
        -1, problem.n_dim)

    truth = np.concatenate([true_scales[1:], true_coeffs])
    q = np.percentile(samples, [1, 16, 50, 84, 99], axis=0)
    sig = np.maximum(0.5 * (q[3] - q[1]), 1e-12)
    in98 = (truth >= q[0]) & (truth <= q[4])
    z = (q[2] - truth) / sig
    # 35 params at 98%: expect ~34.3 inside; the reduced scale earns a
    # little slack (production artifact: 34-35/35)
    assert int(in98.sum()) >= 31
    assert int((np.abs(z) < 4.0).sum()) >= 32
