"""Posterior-level A/B gate for the bf16 A operator at the oneBD
-hardcore scale.

The hardcore (400x20) e0grid contraction streams a 131 MB A matrix per
half-ensemble eval; a_dtype='bfloat16' halves those bytes (its speed on
the H100 is not yet measured).  The rounding is NOT free — the
cubic-reconstruction cancellation amplifies bf16 eps by ~16x (median
grid error ~1.6%, tests/test_e0grid.py) and the error is systematic.
This study runs the COMPLETE hardcore fit twice (identical observed
data, seeds, config; only a_dtype differs) and compares the posterior
quantiles; the preset default may flip only if worst |dz| stays well
inside the advisory threshold.

Usage: python tools/hardcore_a_dtype_ab.py [--walkers W] [--steps S]
Writes artifacts/hardcore_a_dtype_ab.json.
"""
from __future__ import annotations

import dataclasses
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
    n_burn = _arg("--burnin", 400)
    n_main = _arg("--steps", 400)

    import jax
    import jax.numpy as jnp  # noqa: F401

    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    from mcmctoffitting_tpu.models import onebd
    from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                            run_mcmc)
    from mcmctoffitting_tpu.utils import data_io

    key = jax.random.PRNGKey(0)
    truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4, 20.0, 20.0, 20.0])
    names = ["E0", "sigma0", "skew0", "N1", "N2", "N3",
             "BG1", "BG2", "BG3"]

    quantiles = {}
    for a_dtype in ("float32", "bfloat16"):
        spec = onebd.default_spec(n_samples=200_000, hardcore=True,
                                  sampling="counts")
        spec = dataclasses.replace(spec, a_dtype=a_dtype,
                                   bg_mode="expected")
        problem = onebd.OneBDProblem(spec, n_runs=3, likelihood="poisson")
        observed = data_io.synthesize_observed(jax.random.fold_in(key, 9),
                                               problem, truth)
        lb = make_logp_batch(problem.make_log_prob_fn(observed))
        p0 = problem.initial_walkers_from_observed(
            jax.random.fold_in(key, 1), n_walkers, observed)
        t0 = time.time()
        state = init_state(jax.random.fold_in(key, 2), p0, lb)
        seg = jax.jit(lambda s, n=100: run_mcmc(s, n, lb))
        seg = seg.lower(state).compile()
        for _ in range(n_burn // 100):
            state = seg(state).state
        hist = []
        for _ in range(n_main // 100):
            ch = seg(state)
            hist.append(np.asarray(ch.positions))
            state = ch.state
        flat = np.concatenate(hist).reshape(-1, len(truth))
        q = np.percentile(flat, [16, 50, 84], axis=0)
        quantiles[a_dtype] = q
        print(f"{a_dtype}: fit in {time.time() - t0:.0f}s; medians "
              f"{np.array2string(q[1], precision=4)}", flush=True)

    qa, qb = quantiles["float32"], quantiles["bfloat16"]
    rows, worst = [], 0.0
    for d, name in enumerate(names):
        sa = 0.5 * (qa[2, d] - qa[0, d])
        sb = 0.5 * (qb[2, d] - qb[0, d])
        pooled = np.sqrt(0.5 * (sa ** 2 + sb ** 2))
        dz = (qb[1, d] - qa[1, d]) / pooled if pooled > 0 else np.inf
        worst = max(worst, abs(dz))
        rows.append({"param": name, "f32_med": float(qa[1, d]),
                     "f32_sig": float(sa), "bf16_med": float(qb[1, d]),
                     "bf16_sig": float(sb), "dz": round(float(dz), 3)})
        print(f"{name:>7}: f32 {qa[1, d]:10.4g} +-{sa:8.3g} | "
              f"bf16 {qb[1, d]:10.4g} +-{sb:8.3g} | dz {dz:5.2f}",
              flush=True)
    ok = worst < 0.5
    print(f"worst |dz| = {worst:.2f} -> {'PASS' if ok else 'REVIEW'} "
          "(threshold 0.5: the rounding is systematic, so the gate is "
          "tighter than the cross-code parity advisory 1.0)")
    art = os.path.join(REPO, "artifacts")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "hardcore_a_dtype_ab.json"), "w") as f:
        json.dump({"ok": bool(ok), "worst_dz": round(float(worst), 3),
                   "walkers": n_walkers, "burnin": n_burn, "main": n_main,
                   "rows": rows}, f, indent=1)
    print(f"wrote {art}/hardcore_a_dtype_ab.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
