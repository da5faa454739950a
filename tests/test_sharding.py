"""Multi-chip sharding on the virtual 8-device CPU mesh (SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmctoffitting_tpu.parallel import (make_mesh, make_sharded_logp_batch,
                                         replicate)
from mcmctoffitting_tpu.sampler import init_state, make_logp_batch, run_mcmc


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def gaussian_logp(theta, key):
    del key
    return -0.5 * jnp.sum(theta ** 2)


def test_sharded_logp_matches_local(mesh):
    logp_sharded = make_sharded_logp_batch(gaussian_logp, mesh)
    logp_local = make_logp_batch(gaussian_logp)
    thetas = jax.random.normal(jax.random.PRNGKey(0), (32, 4))
    keys = jax.random.split(jax.random.PRNGKey(1), 32)
    np.testing.assert_allclose(np.asarray(logp_sharded(thetas, keys)),
                               np.asarray(logp_local(thetas, keys)),
                               rtol=1e-6)


def test_sharded_sampler_matches_unsharded_statistics(mesh):
    """Same seed: sharded and local runs must produce identical chains
    (the move logic is replicated; only lnprob eval is sharded)."""
    p0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (32, 3))
    logp_local = make_logp_batch(gaussian_logp)
    logp_sharded = make_sharded_logp_batch(gaussian_logp, mesh)

    s_local = init_state(jax.random.PRNGKey(3), p0, logp_local)
    # feed the sharded run a mesh-replicated p0: the replicated-input path
    # must produce the same chain as a plain host array
    s_shard = init_state(jax.random.PRNGKey(3), replicate(p0, mesh),
                         logp_sharded)
    c_local = run_mcmc(s_local, 30, logp_local)
    c_shard = run_mcmc(s_shard, 30, logp_sharded)
    np.testing.assert_allclose(np.asarray(c_local.positions),
                               np.asarray(c_shard.positions), atol=1e-5)


def test_sharded_real_physics_matches_local(mesh):
    """Mesh correctness of the ACTUAL program:
    one small SimultFitProblem driven through the sharded and local
    evaluators with the same seed must produce near-bitwise-equal chains
    (stochastic Monte-Carlo likelihood included — keys are per-walker, so
    sharding must not change the draw streams)."""
    from mcmctoffitting_tpu.models import simult

    spec = simult.default_spec(n_samples=512)
    problem = simult.SimultFitProblem(spec, n_runs=2)
    rng = np.random.default_rng(7)
    observed = tuple(rng.poisson(150.0, w.n_bins).astype(np.float64)
                     for w in problem.windows)
    logp = problem.make_log_prob_fn(observed)
    logp_local = make_logp_batch(logp)
    logp_sharded = make_sharded_logp_batch(logp, mesh)

    p0 = problem.initial_walkers_from_observed(
        jax.random.PRNGKey(8), 16, observed)
    s_local = init_state(jax.random.PRNGKey(9), p0, logp_local)
    s_shard = init_state(jax.random.PRNGKey(9), p0, logp_sharded)
    c_local = run_mcmc(s_local, 5, logp_local)
    c_shard = run_mcmc(s_shard, 5, logp_sharded)
    np.testing.assert_allclose(np.asarray(c_local.positions),
                               np.asarray(c_shard.positions), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(c_local.log_probs),
                               np.asarray(c_shard.log_probs), rtol=2e-4)


def test_indivisible_walker_count_raises(mesh):
    logp_sharded = make_sharded_logp_batch(gaussian_logp, mesh)
    thetas = jax.random.normal(jax.random.PRNGKey(0), (30, 4))  # 30 % 8 != 0
    keys = jax.random.split(jax.random.PRNGKey(1), 30)
    with pytest.raises(ValueError, match="not divisible"):
        logp_sharded(thetas, keys)


def test_graft_dryrun_multichip():
    """The driver's multi-chip validation path end-to-end."""
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_bench_mesh_smoke(monkeypatch):
    """bench.py's mesh-aware path executes on the virtual 8-device mesh
    (the timing code itself runs on any backend; only bench.main()
    insists on a GPU)."""
    import bench

    monkeypatch.setattr(bench, "N_WALKERS", 32)
    monkeypatch.setattr(bench, "N_RUNS", 2)
    monkeypatch.setattr(bench, "N_DRAWS", 2000)
    monkeypatch.setattr(bench, "N_STEPS_MEASURE", 2)
    monkeypatch.setattr(bench, "WALKER_CHUNK", 2)
    monkeypatch.setattr(bench, "MESH", 8)
    rate, n_dev = bench.measure_segment(sampling="counts")
    assert rate > 0 and np.isfinite(rate)
    assert n_dev == 8


def test_sharded_counts_mode_matches_local(mesh):
    """Same sharded==local invariant for the production counts estimator:
    its Poisson cell draws are keyed per walker, so sharding must not
    change the count streams either."""
    from mcmctoffitting_tpu.models import simult

    spec = simult.default_spec(n_samples=4096, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=2)
    rng = np.random.default_rng(11)
    observed = tuple(rng.poisson(150.0, w.n_bins).astype(np.float64)
                     for w in problem.windows)
    logp = problem.make_log_prob_fn(observed)
    logp_local = make_logp_batch(logp)
    logp_sharded = make_sharded_logp_batch(logp, mesh)

    p0 = problem.initial_walkers_from_observed(
        jax.random.PRNGKey(12), 16, observed)
    s_local = init_state(jax.random.PRNGKey(13), p0, logp_local)
    s_shard = init_state(jax.random.PRNGKey(13), p0, logp_sharded)
    c_local = run_mcmc(s_local, 5, logp_local)
    c_shard = run_mcmc(s_shard, 5, logp_sharded)
    np.testing.assert_allclose(np.asarray(c_local.positions),
                               np.asarray(c_shard.positions), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(c_local.log_probs),
                               np.asarray(c_shard.log_probs), rtol=2e-4)
