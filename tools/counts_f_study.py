"""Fine-grid (F) evidence for the counts estimator's default grids.

Two instruments per flagship, both sampler-free:

1. *Deterministic operator shift*: under sampling='expected' (the counts
   estimator's infinite-draw limit) the log-posterior is an exact
   function of theta, so delta_F(theta) = logp_F - logp_F4096 over
   posterior-typical thetas measures how the fine-grid operator itself
   reweights the posterior: exp(delta - <delta>).  std << 1 => F cannot
   move the posterior.  (Same instrument as
   tools/hardcore_f_logp_shift.py, which pinned the oneBD -hardcore MC
   grid; this one runs the COUNTS configs of both flagships.)
2. *Pseudo-marginal noise*: counts-mode per-eval logp std at fixed theta
   (30 keys) at each F — the coarse-F counts estimator is noisier under
   rint, so the default F must keep this at or below the
   faithful MC path's noise (measured 1.16 at the flagship simult
   config).

Usage: JAX_PLATFORMS=cpu python tools/counts_f_study.py [--onebd]
           [--closure cell]
Writes out/counts_f_study_{simult,onebd}[_cell].json.

--closure cell runs BOTH instruments with the 2-row moment closure at
every candidate F while the reference stays exact@4096 — the deltas then
measure the TOTAL operator deviation (closure residual + grid error) of
the cell configuration, which is what gates dropping the CLI's
keep-the-finer-grid guard for the closure.
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

from mcmctoffitting_tpu.ops.e0grid import cached_e0_grid_table
from mcmctoffitting_tpu.ops.xs import ddn_xs_uniform
from mcmctoffitting_tpu.sampler import init_state, make_logp_batch, run_mcmc
from mcmctoffitting_tpu.utils import data_io


def main():
    onebd_mode = "--onebd" in sys.argv
    closure = "exact"
    if "--closure" in sys.argv:
        i = sys.argv.index("--closure") + 1
        val = sys.argv[i] if i < len(sys.argv) else ""
        if val not in ("exact", "cell"):
            sys.exit(f"--closure must be 'exact' or 'cell', got {val!r}")
        closure = val
    n_thetas = 192
    fs = (256, 512, 1024) if not onebd_mode else (512, 1024, 2048)
    f_ref = 4096

    if onebd_mode:
        from mcmctoffitting_tpu.models import onebd as m
        base = m.default_spec(n_samples=200_000, sampling="counts")
        make_problem = lambda sp: m.OneBDProblem(
            sp, n_runs=3, likelihood="poisson")
        base = dataclasses.replace(base, bg_mode="expected")
        truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4,
                          20.0, 20.0, 20.0])
        n_dim, tag = 9, "onebd"
    else:
        from mcmctoffitting_tpu.models import simult as m
        base = m.default_spec(n_samples=200_000, sampling="counts")
        make_problem = lambda sp: m.SimultFitProblem(
            sp, n_runs=4, likelihood="poisson")
        truth = np.concatenate([m.GUESS_SHARED, np.full(4, 5.0e4)])
        n_dim, tag = 8, "simult"

    key = jax.random.PRNGKey(0)
    problem0 = make_problem(base)
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 99),
                                           problem0, truth)

    def spec_at(f, sampling, clo=None):
        tab = cached_e0_grid_table(base.stopping_table, base.ed_binning,
                                   ddn_xs_uniform, f)
        return dataclasses.replace(base, e0_grid_fine=f, e0_grid_table=tab,
                                   sampling=sampling,
                                   moment_closure=clo or closure)

    # posterior-typical thetas: short counts-mode fit at the current default
    problem = make_problem(base)
    logp_batch = make_logp_batch(problem.make_log_prob_fn(observed),
                                 chunk=32)
    p0 = problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 1), 256, observed)
    state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
    seg = jax.jit(lambda s, n: run_mcmc(s, n, logp_batch), static_argnums=1)
    state = seg(state, 150).state
    chain = seg(state, 150)
    flat = np.asarray(chain.positions[75:]).reshape(-1, n_dim)
    idx = np.random.default_rng(0).choice(len(flat), n_thetas,
                                          replace=False)
    thetas = jnp.asarray(flat[idx], jnp.float32)
    fixed_keys = jax.random.split(jax.random.PRNGKey(7), n_thetas)

    # instrument 1: deterministic operator shift (expected forward);
    # the f_ref reference is ALWAYS the exact closure
    logps = {}
    for f in fs + (f_ref,):
        t0 = time.time()
        prob_f = make_problem(spec_at(
            f, "expected", clo="exact" if f == f_ref else None))
        lb = make_logp_batch(prob_f.make_log_prob_fn(observed), chunk=32)
        logps[f] = np.asarray(lb(thetas, fixed_keys), np.float64)
        print(f"shift F={f}: {n_thetas} logp evals in "
              f"{time.time() - t0:.0f}s", flush=True)

    # instrument 2: counts-mode per-eval noise at truth
    th = jnp.asarray(truth, jnp.float32)
    noise = {}
    for f in fs:
        prob_f = make_problem(spec_at(f, "counts"))
        lp = jax.jit(prob_f.make_log_prob_fn(observed))
        vals = np.asarray([float(lp(th, jax.random.PRNGKey(5000 + i)))
                           for i in range(30)])
        noise[f] = float(vals[np.isfinite(vals)].std())
        print(f"noise F={f}: per-eval logp std {noise[f]:.3f}", flush=True)

    out = {"model": tag, "n_thetas": n_thetas, "f_ref": f_ref,
           "closure": closure,
           "deltas": {}, "noise_std": {str(f): noise[f] for f in fs}}
    print(f"{'F':>6} {'std(delta)':>11} {'max|delta-mean|':>16} "
          f"{'noise std':>10}")
    for f in fs:
        d = logps[f] - logps[f_ref]
        d = d[np.isfinite(d)]
        dc = d - d.mean()
        out["deltas"][str(f)] = {"std": float(d.std()),
                                 "max_centered": float(np.abs(dc).max()),
                                 "mean": float(d.mean())}
        print(f"{f:>6} {d.std():11.4f} {np.abs(dc).max():16.4f} "
              f"{noise[f]:10.3f}")
    os.makedirs("out", exist_ok=True)
    path = (f"out/counts_f_study_{tag}.json" if closure == "exact"
            else f"out/counts_f_study_{tag}_cell.json")
    with open(path, "w") as fj:
        json.dump(out, fj, indent=1)
    print(f"written {path}")


if __name__ == "__main__":
    main()
