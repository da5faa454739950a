"""Noise-free fine-grid (F) error bound for -hardcore: logp surface shift.

The MCMC-based F comparison (tools/hardcore_fidelity_study.py) is floor-
limited by the sampler's own seed-to-seed scatter (measured: the same-F
control moves medians as much as changing F does).  This tool removes the
sampler entirely: under the DETERMINISTIC forward (sampling='expected',
bg_mode='expected') the log-posterior is an exact function of theta, so
the effect of the fine-grid operator is measured directly as

    delta_F(theta) = logp_F(theta) - logp_F4096(theta)

over a set of posterior-typical theta draws.  The posterior density the
operator induces differs from the F=4096 one by exp(delta - <delta>):
if std(delta) << 1 (log-likelihood units), changing F cannot materially
reweight the posterior — a far sharper statement than any chain-level
median comparison.

Usage: python tools/hardcore_f_logp_shift.py [--ndraws N]
Writes out/hardcore_f_logp_shift.json.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp
import numpy as np

from mcmctoffitting_tpu.utils import compile_cache  # noqa: E402
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from mcmctoffitting_tpu.models import onebd
from mcmctoffitting_tpu.ops.e0grid import cached_e0_grid_table
from mcmctoffitting_tpu.ops.xs import ddn_xs_uniform
from mcmctoffitting_tpu.sampler import init_state, make_logp_batch, run_mcmc
from mcmctoffitting_tpu.utils import data_io


def main():
    n_draws = int(sys.argv[sys.argv.index("--ndraws") + 1]) \
        if "--ndraws" in sys.argv else 192  # multiple of the walker chunk
    fs = (512, 1024, 2048)
    f_ref = 4096

    base = onebd.default_spec(n_samples=200_000, hardcore=True)
    base = dataclasses.replace(base, sampling="expected",
                               bg_mode="expected")
    problem0 = onebd.OneBDProblem(base, n_runs=3, likelihood="poisson")
    truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4, 20.0, 20.0, 20.0])
    key = jax.random.PRNGKey(0)
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 99),
                                           problem0, truth)

    def spec_at(f):
        tab = cached_e0_grid_table(base.stopping_table, base.ed_binning,
                                   ddn_xs_uniform, f)
        return dataclasses.replace(base, e0_grid_fine=f, e0_grid_table=tab)

    # posterior-typical thetas from a short fit at the production F=1024
    # (same compiled program as the fidelity study)
    problem = onebd.OneBDProblem(spec_at(1024), n_runs=3,
                                 likelihood="poisson")
    logp_batch = make_logp_batch(problem.make_log_prob_fn(observed),
                                 chunk=32)
    p0 = problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 1), 256, observed)
    state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
    seg = jax.jit(lambda s, n: run_mcmc(s, n, logp_batch),
                  static_argnums=1)
    state = seg(state, 150).state
    chain = seg(state, 150)
    flat = np.asarray(chain.positions[75:]).reshape(-1, 9)
    idx = np.random.default_rng(0).choice(len(flat), n_draws, replace=False)
    thetas = jnp.asarray(flat[idx], jnp.float32)
    fixed_keys = jax.random.split(jax.random.PRNGKey(7), n_draws)

    logps = {}
    for f in fs + (f_ref,):
        t0 = time.time()
        prob_f = onebd.OneBDProblem(spec_at(f), n_runs=3,
                                    likelihood="poisson")
        lb = make_logp_batch(prob_f.make_log_prob_fn(observed), chunk=32)
        logps[f] = np.asarray(lb(thetas, fixed_keys), np.float64)
        print(f"F={f}: {n_draws} logp evals in {time.time()-t0:.0f}s",
              flush=True)

    out = {"n_draws": n_draws, "f_ref": f_ref, "deltas": {}}
    print(f"{'F':>6} {'std(delta)':>11} {'max|delta-mean|':>16} "
          f"{'mean(delta)':>12}")
    for f in fs:
        d = logps[f] - logps[f_ref]
        dc = d - d.mean()
        out["deltas"][str(f)] = {"std": float(d.std()),
                                 "max_centered": float(np.abs(dc).max()),
                                 "mean": float(d.mean())}
        print(f"{f:>6} {d.std():11.4f} {np.abs(dc).max():16.4f} "
              f"{d.mean():12.4f}")
    print("interpretation: the F-induced posterior reweighting is "
          "exp(delta - <delta>); std << 1 means F cannot move the "
          "posterior materially")
    os.makedirs("out", exist_ok=True)
    with open("out/hardcore_f_logp_shift.json", "w") as fj:
        json.dump(out, fj, indent=1)
    print("written out/hardcore_f_logp_shift.json")


if __name__ == "__main__":
    main()
