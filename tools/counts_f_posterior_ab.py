"""Posterior-level A/B: counts estimator at F=half-default vs default.

Closes the loop the sampler-free instruments (tools/counts_f_study.py)
open: identical observed data, likelihood and chain configuration, the
ONLY difference the fine-grid size F.  Reports the same dz table the
reference-parity studies use (dz = difference of medians over the
pooled sigma); |dz| << 1 means the halved grid samples the same
posterior.

Chain config mirrors the ess-per-step study (64 walkers, 300 burn-in +
900 main, 50k draws, corrected likelihood) — lengths at which the
parity studies measured converged medians.

Usage: python tools/counts_f_posterior_ab.py [--onebd] [--closure-ab]
Writes out/counts_f_posterior_ab_{simult,onebd}[_closure].json.

--closure-ab holds F at the production default and A/Bs the MOMENT
CLOSURE instead (cell vs exact): the posterior-level instrument for
running `-momentClosure cell` at the halved production grids.
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

N_WALKERS = 64
N_BURNIN = 300
N_MAIN = 900
N_DRAWS = 50_000


def main():
    onebd_mode = "--onebd" in sys.argv
    # --closure-ab targets the PRODUCTION configuration (200k draws, which
    # is also what selects the halved default grid); counts-mode cost is
    # O(F), independent of the draw count, so the chains run just as fast
    n_draws = 200_000 if "--closure-ab" in sys.argv else N_DRAWS
    if onebd_mode:
        from mcmctoffitting_tpu.models import onebd as m
        base = m.default_spec(n_samples=n_draws, sampling="counts")
        base = dataclasses.replace(base, bg_mode="expected")
        make_problem = lambda sp: m.OneBDProblem(
            sp, n_runs=1, likelihood="poisson")
        truth = np.array([1300.0, 80.0, 0.6, 5e4, 20.0])
        names = ["eLoss", "scale", "s", "N1", "BG1"]
        f_pair = (1024, 2048)
        tag = "onebd"
    else:
        from mcmctoffitting_tpu.models import simult as m
        base = m.default_spec(n_samples=n_draws, sampling="counts")
        make_problem = lambda sp: m.SimultFitProblem(
            sp, n_runs=2, likelihood="poisson")
        truth = np.concatenate([m.GUESS_SHARED, np.full(2, 5.0e4)])
        names = ["beamE", "eLoss", "scale", "s", "N1", "N2"]
        f_pair = (512, 1024)
        tag = "simult"

    closure_ab = "--closure-ab" in sys.argv
    if closure_ab:
        # hold F at the production default; A/B the closure itself
        f_def = base.e0_grid_fine
        ab_pair = (("cell", f_def), ("exact", f_def))
    else:
        ab_pair = (("exact", f_pair[0]), ("exact", f_pair[1]))

    key = jax.random.PRNGKey(0)
    problem0 = make_problem(base)
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 99),
                                           problem0, truth)

    def run_at(f, closure="exact"):
        tab = cached_e0_grid_table(base.stopping_table, base.ed_binning,
                                   ddn_xs_uniform, f)
        spec = dataclasses.replace(base, e0_grid_fine=f, e0_grid_table=tab,
                                   moment_closure=closure)
        problem = make_problem(spec)
        lb = make_logp_batch(problem.make_log_prob_fn(observed))
        p0 = problem.initial_walkers_from_observed(
            jax.random.fold_in(key, 1), N_WALKERS, observed)
        state = init_state(jax.random.fold_in(key, 2), p0, lb)
        seg = jax.jit(lambda s, n: run_mcmc(s, n, lb), static_argnums=1)
        t0 = time.time()
        state = seg(state, N_BURNIN).state
        chain = seg(state, N_MAIN)
        flat = np.asarray(chain.positions).reshape(-1, len(names))
        acc = float(np.sum(np.asarray(chain.n_accepted))) / (
            N_MAIN * N_WALKERS)
        print(f"F={f}/{closure}: {N_BURNIN}+{N_MAIN} steps in "
              f"{time.time()-t0:.0f}s, acc {acc:.2f}", flush=True)
        return flat, acc

    (clo_a, f_a), (clo_b, f_b) = ab_pair
    flat_a, acc_a = run_at(f_a, clo_a)
    flat_b, acc_b = run_at(f_b, clo_b)

    lab_a = f"F{f_a}" + ("/cell" if clo_a == "cell" else "")
    lab_b = f"F{f_b}" + ("/cell" if clo_b == "cell" else "")
    rows, worst = [], 0.0
    print(f"{'param':>8} {lab_a + ' med':>14} {lab_b + ' med':>14} "
          f"{'dz':>7}")
    for d, name in enumerate(names):
        ma, mb = np.median(flat_a[:, d]), np.median(flat_b[:, d])
        sig = np.sqrt(0.5 * (flat_a[:, d].std() ** 2
                             + flat_b[:, d].std() ** 2))
        dz = float((ma - mb) / sig) if sig > 0 else 0.0
        worst = max(worst, abs(dz))
        rows.append({"param": name, "med_a": float(ma), "med_b": float(mb),
                     "sigma": float(sig), "dz": float(dz)})
        print(f"{name:>8} {ma:12.4g} {mb:12.4g} {dz:7.2f}")
    verdict = "PASS" if worst < 1.0 else "FAIL"
    print(f"worst |dz| = {worst:.2f} -> {verdict}")
    os.makedirs("out", exist_ok=True)
    path = (f"out/counts_f_posterior_ab_{tag}_closure.json" if closure_ab
            else f"out/counts_f_posterior_ab_{tag}.json")
    with open(path, "w") as fj:
        json.dump({"ab_pair": [list(p) for p in ab_pair],
                   "acc": [acc_a, acc_b], "rows": rows,
                   "worst_abs_dz": worst, "verdict": verdict}, fj, indent=1)
    print(f"written {path}")


if __name__ == "__main__":
    main()
