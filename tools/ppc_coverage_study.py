"""PPC calibration study under the recommended production configuration.

The reference's PPC tooling (``utilities/ppcTools.py:generatePPC``,
``tests/testPPC.py``) draws posterior samples, pushes them through the
forward model and *plots* credible bands — it never quantifies whether the
bands actually cover the data at their nominal rate.  This study does:
using the round-3 full-fit chains (out/fullfit_r3, `-sampling counts
-likelihood poisson`), it rebuilds the exact posterior-predictive
distribution the corrected likelihood asserts,

    theta ~ posterior chain tail,   y_rep | theta ~ Poisson(model(theta)),

and reports

  * central-interval coverage: the fraction of observed TOF bins inside
    the empirical 68% / 95% posterior-predictive intervals (discreteness
    makes these slightly conservative at low counts — noted per run), and
  * an omnibus Bayesian p-value per run with the chi-square discrepancy
    T(y) = sum_b (y_b - E_b)^2 / (E_b + 1): p = P(T(y_rep) >= T(y_obs)).
    Calibrated fits give p in (0.05, 0.95); p -> 0 is misfit, p -> 1 is
    overdispersion of the model vs the data.

Usage (CPU is fine; counts mode is O(F) per eval):
    JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python tools/ppc_coverage_study.py
        [--model simult|onebd] [--chain PATH] [--entries 200] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_problem(model: str):
    """The exact problem the round-3 full fits sampled (cli defaults +
    `-sampling counts -likelihood poisson` (+ `-deterministicBG` oneBD))."""
    from mcmctoffitting_tpu.models import onebd, simult

    if model == "simult":
        spec = simult.default_spec(n_samples=200_000, sampling="counts")
        problem = simult.SimultFitProblem(spec, n_runs=4,
                                          likelihood="poisson")
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    else:
        spec = onebd.default_spec(n_samples=200_000, sampling="counts")
        spec = dataclasses.replace(spec, bg_mode="expected")
        problem = onebd.OneBDProblem(spec, n_runs=3, likelihood="poisson")
        truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4,
                          20.0, 20.0, 20.0])
    return problem, truth


def coverage_and_pvalue(observed: np.ndarray, spectra: np.ndarray,
                        rng: np.random.Generator) -> dict:
    """observed: (B,) counts; spectra: (N, B) model expectations (one per
    posterior draw).  Poissonize each draw and measure calibration."""
    lam = np.maximum(np.asarray(spectra, np.float64), 0.0)
    y_rep = rng.poisson(lam)                                   # (N, B)
    lo68, hi68 = np.percentile(y_rep, [16.0, 84.0], axis=0)
    lo95, hi95 = np.percentile(y_rep, [2.5, 97.5], axis=0)
    obs = np.asarray(observed, np.float64)
    cov68 = float(np.mean((obs >= lo68) & (obs <= hi68)))
    cov95 = float(np.mean((obs >= lo95) & (obs <= hi95)))
    # omnibus chi-square discrepancy vs the posterior-mean expectation
    e = lam.mean(axis=0)
    t_obs = float(np.sum((obs - e) ** 2 / (e + 1.0)))
    t_rep = np.sum((y_rep - e[None, :]) ** 2 / (e[None, :] + 1.0), axis=1)
    p = float(np.mean(t_rep >= t_obs))
    return {"n_bins": int(obs.size), "coverage68": cov68,
            "coverage95": cov95, "t_obs": t_obs,
            "t_rep_med": float(np.median(t_rep)), "p_value": p}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=["simult", "onebd"], default="simult")
    ap.add_argument("--chain", default=None,
                    help="chain file (default: out/fullfit_r3 main chain)")
    ap.add_argument("--entries", type=int, default=200,
                    help="posterior draws pushed through the forward model")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    chain_path = args.chain or os.path.join(
        REPO, "out", "fullfit_r3",
        {"simult": "simult_countsmainchain.dat",
         "onebd": "onebd_countsmainchain.dat"}[args.model])
    if not os.path.exists(chain_path):
        sys.exit(f"error: chain file not found: {chain_path} "
                 "(run the full fits first)")

    import jax

    from mcmctoffitting_tpu.utils import chain_io, data_io
    from mcmctoffitting_tpu.utils.ppc import PPCSampler

    problem, truth = build_problem(args.model)
    # the observed data the fit targeted (cli seed default 0, fold_in 99)
    observed = data_io.synthesize_observed(
        jax.random.fold_in(jax.random.PRNGKey(0), 99), problem, truth)

    chain, probs, n_params, n_walkers, n_steps = \
        chain_io.read_chain_text(chain_path)
    print(f"chain: {n_steps} steps x {n_walkers} walkers x {n_params} params")

    sampler = PPCSampler(problem, chain, probs)
    result = sampler.generate(jax.random.PRNGKey(7), args.entries)

    rng = np.random.default_rng(7)
    report = {"model": args.model, "chain": os.path.relpath(chain_path, REPO),
              "entries": args.entries, "runs": []}
    print(f"{'run':>4} {'bins':>5} {'cov68':>7} {'cov95':>7} "
          f"{'T_obs':>9} {'T_rep~':>9} {'p':>6}")
    for run, spectra in enumerate(result.tof_spectra):
        r = coverage_and_pvalue(observed[run], spectra, rng)
        report["runs"].append(r)
        print(f"{run:>4} {r['n_bins']:>5} {r['coverage68']:>7.3f} "
              f"{r['coverage95']:>7.3f} {r['t_obs']:>9.1f} "
              f"{r['t_rep_med']:>9.1f} {r['p_value']:>6.3f}")

    all68 = float(np.mean([r["coverage68"] for r in report["runs"]]))
    all95 = float(np.mean([r["coverage95"] for r in report["runs"]]))
    report["coverage68"] = all68
    report["coverage95"] = all95
    pvals = [r["p_value"] for r in report["runs"]]
    ok = (all68 >= 0.60 and all95 >= 0.88
          and all(0.02 < p < 0.995 for p in pvals))
    report["ok"] = bool(ok)
    print(f"overall: cov68={all68:.3f} cov95={all95:.3f} "
          f"p-values={['%.3f' % p for p in pvals]} -> "
          f"{'PASS' if ok else 'FAIL'}")

    out_path = args.out or os.path.join(
        REPO, "out", f"ppc_coverage_{args.model}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    main()
