"""Move-family ESS/s A/B at the flagship production config (r4 item 2b).

Walker-steps/s is the vanity metric; ESS/s is the science metric.  This
study runs the SAME flagship posterior (simultFit, 4 runs, 200k draws,
counts estimator, 256 walkers — the reference default,
``tests/simultFit.py:673``) under each ensemble move family
('stretch' = emcee's default, 'de' = ter Braak DE-MC, 'mixed' =
alternating), equilibrates 400 steps, then continues until the
integrated-autocorrelation estimate is self-consistent (S >= 20 tau)
and reports ESS/s = W * S / (tau_max * wall).  The winner becomes the
recommended CLI/bench default.  Culture match: the reference's
acceptance/autocorr diagnostics, ``tests/shiftingGaussian_brute.py:
329-334``.

Usage: python tools/move_ess_ab.py [--walkers W] [--draws N] [--cap S]
Writes artifacts/move_ess_ab.json.
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _arg(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


def main() -> int:
    n_walkers = _arg("--walkers", 256)
    n_draws = _arg("--draws", 200_000)
    wall_cap = _arg("--cap", 300, float)

    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                            run_mcmc)
    from mcmctoffitting_tpu.utils import data_io
    from mcmctoffitting_tpu.utils.diagnostics import \
        integrated_autocorr_time

    spec = simult.default_spec(n_samples=n_draws, sampling="counts")
    # production run-axis policy (cli/_driver.resolve_run_axis): batched
    # at <= 512 walkers/device
    import dataclasses

    from mcmctoffitting_tpu.cli._driver import RUN_AXIS_CROSSOVER_WALKERS
    axis = ("batched" if n_walkers <= RUN_AXIS_CROSSOVER_WALKERS
            else "sequential")
    spec = dataclasses.replace(spec, run_axis=axis)
    # ESS/s is measured on the CORRECTED Poisson likelihood: under the
    # faithful sawtooth the ensemble's acceptance decays to zero as it
    # tightens (the int()-gammaln pseudo-noise), so tau
    # grows without bound and no move family has a stationary ESS there
    # (measured: acc 0.00 after 13k steps, tau still climbing).  The
    # poisson chain is stationary and is the recommended production
    # config (-likelihood poisson).
    problem = simult.SimultFitProblem(spec, n_runs=4,
                                      likelihood="poisson")
    key = jax.random.PRNGKey(0)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    synth_key = jax.random.key(0, impl="threefry2x32")
    observed = data_io.synthesize_observed(
        jax.random.fold_in(synth_key, 9), problem, truth)
    logp = problem.make_log_prob_fn(observed)
    lb = make_logp_batch(logp)
    p0 = problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 1), n_walkers, observed)

    results = {}
    for move in ("stretch", "de", "mixed"):
        state = init_state(jax.random.fold_in(key, 2), p0, lb)
        seg = jax.jit(lambda s, m=move: run_mcmc(s, 100, lb, move=m))
        seg = seg.lower(state).compile()
        for _ in range(4):                     # 400-step equilibration
            state = seg(state).state
        jax.block_until_ready(state.positions)

        t0 = time.perf_counter()
        hist, acc = [], []
        tau_max, s_tau, converged = float("inf"), 0, False
        while True:
            for _ in range(4):
                ch = seg(state)
                hist.append(ch.positions)
                acc.append(ch.n_accepted)
                state = ch.state
            jax.block_until_ready(state.positions)
            wall = time.perf_counter() - t0
            pos = np.concatenate([np.asarray(h) for h in hist])
            s_tau = pos.shape[0]
            tau_max = float(integrated_autocorr_time(pos).max())
            converged = s_tau >= 20.0 * tau_max
            if converged or wall > wall_cap:
                break
        rate = s_tau * n_walkers / wall
        ess_s = n_walkers * s_tau / (tau_max * wall)
        acc_frac = float(np.sum(np.stack(acc)) / (s_tau * n_walkers))
        results[move] = {
            "walker_steps_per_sec": round(rate, 1),
            "tau_max_steps": round(tau_max, 1),
            "s_over_tau": round(s_tau / tau_max, 1),
            "converged": converged,
            "ess_per_sec": round(ess_s, 2),
            "acceptance": round(acc_frac, 3),
            "steps": s_tau, "wall_s": round(wall, 1)}
        print(f"{move:>8}: {rate:8.0f} w-steps/s, tau_max {tau_max:6.1f} "
              f"(S/tau {s_tau / tau_max:5.1f}{'' if converged else ' CAP'}),"
              f" acc {acc_frac:.2f} -> {ess_s:8.1f} ESS/s", flush=True)

    winner = max(results, key=lambda m: results[m]["ess_per_sec"])
    out = {"config": {"walkers": n_walkers, "draws": n_draws,
                      "runs": 4, "sampling": "counts",
                      "backend": jax.default_backend()},
           "results": results, "winner": winner}
    art = os.path.join(REPO, "artifacts")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "move_ess_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"winner: {winner}; wrote {art}/move_ess_ab.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
