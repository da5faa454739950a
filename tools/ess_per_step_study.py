"""ESS-per-step parity: does the counts estimator mix as well as mc?

The headline metric (walker-steps/s) only proves the counts estimator
STEPS faster; a pseudo-marginal sampler's science throughput is
ESS/second = ESS/step x steps/second, and a noisier per-eval logp can
in principle buy step rate with worse mixing.  An earlier study pinned
the per-eval logp noise at 1.08 (counts) vs 1.16 (mc) — this study
closes the loop at the CHAIN level: identical problem, observed data
and chain lengths under both estimators, integrated autocorrelation
time / ESS / acceptance compared per parameter.

Both estimators target the same posterior (posterior parity PASS both
flagships), so equal-or-better tau here means the full walker-steps/s
ratio carries to ESS/second.

Config mirrors the parity studies (simult, 2 runs, 50k draws, corrected
Poisson likelihood); chain lengths are sized so S >> 50*tau.  CPU
runtime is dominated by the mc side (~1-2 h); counts takes minutes.

Usage: [JAX_PLATFORMS=cpu] python tools/ess_per_step_study.py
       [--walkers W] [--burnin B] [--main M] [--skip-mc]
Writes out/ess_per_step.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import numpy as np

from mcmctoffitting_tpu.utils import compile_cache  # noqa: E402
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from mcmctoffitting_tpu.models import simult
from mcmctoffitting_tpu.sampler import init_state, make_logp_batch, run_mcmc
from mcmctoffitting_tpu.utils import data_io
from mcmctoffitting_tpu.utils.diagnostics import (integrated_autocorr_time,
                                                  split_rhat)


def _arg(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


N_WALKERS = _arg("--walkers", 64)
N_BURNIN = _arg("--burnin", 300)
N_MAIN = _arg("--main", 900)
N_RUNS, N_DRAWS = 2, 50_000


def run_chain(sampling: str, move: str = "stretch"):
    import jax.numpy as jnp
    if "--onebd" in sys.argv:
        import dataclasses

        from mcmctoffitting_tpu.models import onebd
        spec = onebd.default_spec(n_samples=N_DRAWS, sampling=sampling)
        # deterministic background isolates the MOVE effect (the faithful
        # per-eval Poisson bg draw freezes acceptance for every move;
        # the third reference noise source, README "Statistical findings")
        spec = dataclasses.replace(spec, bg_mode="expected")
        problem = onebd.OneBDProblem(spec, n_runs=3,
                                     likelihood="poisson")
        truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4,
                          20.0, 20.0, 20.0])
    else:
        spec = simult.default_spec(n_samples=N_DRAWS, sampling=sampling)
        problem = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                          likelihood="poisson")
        truth = np.concatenate([simult.GUESS_SHARED,
                                np.full(N_RUNS, 5.0e4)])
    key = jax.random.PRNGKey(11)
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 0),
                                           problem, truth)
    logp_batch = make_logp_batch(problem.make_log_prob_fn(observed))
    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               N_WALKERS, observed)
    t0 = time.time()
    state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
    burn = run_mcmc(state, N_BURNIN, logp_batch, move=move)
    main = run_mcmc(burn.state, N_MAIN, logp_batch, move=move)
    elapsed = time.time() - t0
    chain = np.asarray(main.positions)                 # (S, W, D)
    acc = float(np.mean(np.asarray(main.acceptance_fraction)))
    tau = integrated_autocorr_time(chain)
    ess = chain.shape[0] * chain.shape[1] / tau
    rhat = split_rhat(chain)
    print(f"{sampling}/{move}: {elapsed:.0f}s, acc={acc:.3f}, "
          f"max tau={tau.max():.1f}, min ESS={ess.min():.0f}, "
          f"max R-hat={np.nanmax(rhat):.3f}", flush=True)
    return {"sampling": sampling, "move": move,
            "elapsed_s": elapsed, "acc": acc,
            "tau": tau.tolist(), "ess": ess.tolist(),
            "ess_per_step": (ess / N_MAIN).tolist(),
            "rhat": np.asarray(rhat).tolist(),
            "n_steps": N_MAIN, "n_walkers": N_WALKERS}


def main():
    if "--compare-moves" in sys.argv:
        # mixing of the proposal families at equal chain length (counts
        # estimator; the reference's emcee offers stretch only)
        suffix = "_onebd" if "--onebd" in sys.argv else ""
        out = {"config": {"runs": N_RUNS, "draws": N_DRAWS,
                          "walkers": N_WALKERS, "burnin": N_BURNIN,
                          "main": N_MAIN, "likelihood": "poisson",
                          "sampling": "counts",
                          "problem": "onebd" if suffix else "simult"}}
        for move in ("stretch", "de", "mixed"):
            out[move] = run_chain("counts", move=move)
        base = np.min(out["stretch"]["ess"])
        for move in ("de", "mixed"):
            r = float(np.min(out[move]["ess"]) / base)
            out[f"min_ess_ratio_{move}_over_stretch"] = r
            print(f"min-ESS ratio {move}/stretch: {r:.2f}", flush=True)
        os.makedirs("out", exist_ok=True)
        with open(f"out/ess_moves{suffix}.json", "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote out/ess_moves{suffix}.json")
        return

    out = {"config": {"runs": N_RUNS, "draws": N_DRAWS,
                      "walkers": N_WALKERS, "burnin": N_BURNIN,
                      "main": N_MAIN, "likelihood": "poisson"}}
    out["counts"] = run_chain("counts")
    if "--skip-mc" not in sys.argv:
        out["mc"] = run_chain("mc")
        r = (np.min(out["counts"]["ess"]) / np.min(out["mc"]["ess"]))
        out["min_ess_ratio_counts_over_mc"] = float(r)
        print(f"\nmin-ESS ratio counts/mc at equal chain length: {r:.2f} "
              "(>= 1 means the counts estimator's step-rate advantage "
              "carries fully to ESS/second)", flush=True)
    os.makedirs("out", exist_ok=True)
    with open("out/ess_per_step.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote out/ess_per_step.json")


if __name__ == "__main__":
    main()
