"""-sampler nuts|hmc CLI surface: the gradient samplers on the flagships.

Beyond the reference (its MC + int()-sawtooth likelihood has no usable
gradient); the differentiable configuration is expected forward +
Poisson logpmf + rint off (cross-validation study).
"""
import numpy as np
import pytest


def test_gradient_sampler_requires_differentiable_config(tmp_path,
                                                         monkeypatch):
    """Clear one-line errors when the configuration has no gradient."""
    monkeypatch.chdir(tmp_path)
    from mcmctoffitting_tpu.cli import csi_onebd, simult_fit

    with pytest.raises(SystemExit, match="expectedForward"):
        simult_fit.main(["-debug", "1", "-batch", "1", "-sampler", "nuts"])
    with pytest.raises(SystemExit, match="likelihood"):
        simult_fit.main(["-debug", "1", "-batch", "1", "-sampler", "hmc",
                         "-expectedForward"])
    with pytest.raises(SystemExit, match="deterministicBG"):
        csi_onebd.main(["-debug", "1", "-batch", "1", "-sampler", "nuts",
                        "-expectedForward", "-likelihood", "poisson"])
    with pytest.raises(SystemExit, match="resume"):
        simult_fit.main(["-debug", "1", "-batch", "1", "-sampler", "nuts",
                         "-expectedForward", "-likelihood", "poisson",
                         "-resume", "x.npz"])


def test_nuts_cli_end_to_end(tmp_path, monkeypatch):
    """Tiny NUTS fit on the simult flagship: chain file written in the
    shared emcee-text format, medians land near the synthesis truth
    (debug sizes; the shape parameters are tightly identified even at
    20 samples because the expected forward is noiseless)."""
    monkeypatch.chdir(tmp_path)
    from mcmctoffitting_tpu.cli import simult_fit
    from mcmctoffitting_tpu.utils import chain_io

    out = simult_fit.main(["-debug", "1", "-nRuns", "1", "-batch", "1",
                           "-sampler", "nuts", "-expectedForward",
                           "-likelihood", "poisson", "-nChains", "2",
                           "-maxDepth", "2"])
    q = out["quantiles"]
    assert abs(q["beamE"][0] - 1878.4) < 40.0
    assert abs(q["eLoss"][0] - 850.0) < 60.0
    assert abs(q["s"][0] - 0.5) < 0.1
    chain, _, n_params, n_walkers, n_steps = chain_io.read_chain_text(
        "mainchain.dat")
    assert (n_steps, n_walkers, n_params) == (10, 2, 5)
    assert np.isfinite(chain).all()


def test_dual_averaging_survives_nan_alpha():
    """A divergent warm-up trajectory (NaN Hamiltonian -> NaN acceptance
    statistic) must shrink the step size, not poison the adaptation
    (observed on the oneBD posterior; sampler/_adapt.py)."""
    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.sampler._adapt import dual_averaging_warmup

    def one_step(state, eps, k):
        alpha = jnp.where(eps > 0.01, jnp.nan, jnp.float32(1.0))
        return state, alpha

    _, eps = dual_averaging_warmup(
        jax.random.PRNGKey(0), (jnp.zeros(2),), one_step, 120, 0.1, 0.8)
    assert np.isfinite(float(eps)) and float(eps) > 0.0
