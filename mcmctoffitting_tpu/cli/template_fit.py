"""CLI driver: non-parametric template unfolding (35-dim fit).

Rebuild of ``python tests/devShapeTemplates.py``: generate (or load from
CSV cache) 32 monoenergetic-slice templates per standoff, then fit
3 run-scales + 32 coefficients with the wide-Gaussian likelihood.

Run: ``python -m mcmctoffitting_tpu.cli.template_fit --debug``
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    from ..utils import compile_cache
    compile_cache.enable()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-filename", default=None, type=str,
                   help="observed multistandoff TSV (default: synthesize)")
    p.add_argument("-templateFile", default="templates.csv", type=str)
    p.add_argument("-nDraws", default=200_000, type=int)
    p.add_argument("-nWalkers", default=500, type=int)
    p.add_argument("-nBurnin", default=10_000, type=int)
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("--debug", action="store_true")
    p.add_argument("-outputPrefix", default="tmpl_", type=str)
    p.add_argument("-doML", action="store_true",
                   help="run a bounded SLSQP maximum-likelihood fit first "
                        "and start the walkers from its optimum (the "
                        "reference's doML option, "
                        "tests/devShapeTemplates.py:508-518)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..models import templates as T
    from ..sampler import sample
    from ..utils import chain_io, data_io

    n_draws = 5000 if args.debug else args.nDraws
    n_walkers = 80 if args.debug else args.nWalkers
    n_steps = 30 if args.debug else args.nBurnin

    spec = T.default_spec(n_samples=n_draws)
    problem = T.TemplateFitProblem(n_runs=4)
    key = jax.random.PRNGKey(args.seed)

    if os.path.exists(args.templateFile):
        print(f"loading templates from {args.templateFile}")
        templates = T.load_templates_csv(args.templateFile, 4)
    else:
        print("generating templates (4 standoffs x 32 slices)...")
        t0 = time.time()
        templates = T.generate_templates(jax.random.fold_in(key, 0), spec)
        T.save_templates_csv(args.templateFile, templates)
        print(f"templates done in {time.time() - t0:.1f}s "
              f"-> {args.templateFile}")

    coeff_guess = problem.initial_guess_model()
    if args.filename:
        tof_data = data_io.read_multi_standoff_tof_data(args.filename, 4)
        observed = [data_io.select_window(tof_data, i, w.lo, w.hi)[0]
                    for i, w in enumerate(problem.windows)]
    else:
        true_scales = [1.0, 1.1, 0.6, 1.5]
        observed = [np.asarray(T.build_model_tof(
            true_scales[r], coeff_guess, templates[r]))
            for r in range(4)]
        observed = [np.random.default_rng(r).poisson(np.maximum(o, 0.0))
                    for r, o in enumerate(observed)]
        print("using synthetic observed data from guess-model coefficients")

    logp = problem.make_log_prob_fn(observed, templates)
    guess = np.concatenate([[1.1, 0.6, 1.5], coeff_guess])
    lo = np.concatenate([[lim[0] for lim in T.SCALE_LIMS],
                         np.zeros(T.N_TEMPLATES)])
    hi = np.concatenate([[lim[1] for lim in T.SCALE_LIMS],
                         np.full(T.N_TEMPLATES, T.COEFF_LIM[1])])
    if args.doML:
        # bounded SLSQP ML fit preceding the MCMC; the template likelihood
        # is deterministic, so no common-random-number handling is needed
        from ..utils.optimize import minimize_nll
        res = minimize_nll(logp, guess, key=jax.random.fold_in(key, 9),
                           method="SLSQP",
                           bounds=list(zip(lo.tolist(), hi.tolist())),
                           maxiter=10_000)
        print(f"SLSQP ML fit: nll {res.fun:.6g} success={res.success}")
        print("optimized coefficients that will be used:",
              np.round(res.x, 4).tolist())
        guess = np.asarray(res.x)
    noise = jax.random.uniform(jax.random.fold_in(key, 1),
                               (n_walkers, problem.n_dim))
    p0 = jnp.asarray(np.clip(guess * (0.9 + 0.2 * np.asarray(noise)),
                             lo + 1e-6, hi - 1e-6))

    t0 = time.time()
    chain = sample(jax.random.fold_in(key, 2), p0, n_steps, logp,
                   stochastic=True)
    jax.block_until_ready(chain.positions)
    elapsed = time.time() - t0
    chain_io.append_chain_text(args.outputPrefix + "burninchain.dat",
                               np.asarray(chain.positions[::10]),
                               np.asarray(chain.log_probs[::10]), mode="w")

    keep = max(n_steps * 3 // 5, 1)
    samples = np.asarray(chain.positions[keep:]).reshape(-1, problem.n_dim)
    q = np.percentile(samples, [16, 50, 84], axis=0)
    print("recovered run scales (median):", np.round(q[1, :3], 3).tolist())
    rate = n_steps * n_walkers / elapsed
    print(json.dumps({"walker_steps_per_sec": rate,
                      "acceptance": float(np.asarray(
                          chain.acceptance_fraction).mean())}))

    try:
        from ..utils.plotting import trace_plot, unfolded_spectrum_plot
        trace_plot(np.asarray(chain.positions), None,
                   args.outputPrefix + "trace.png", max_params=6)
        # the reference's closing posterior visualization: unfolded
        # spectrum band + run-scale histograms with quantile lines
        # (tests/devShapeTemplates.py:584-631)
        centers = 0.5 * (T.TEMPLATE_BOUNDS[:-1] + T.TEMPLATE_BOUNDS[1:])
        unfolded_spectrum_plot(
            centers, samples,
            filename=args.outputPrefix + "unfolded_spectrum.png")
        print(f"unfolded-spectrum plot -> "
              f"{args.outputPrefix}unfolded_spectrum.png")
    except Exception as e:
        print(f"plotting skipped: {e}")
    return {"scales_median": q[1, :3].tolist(),
            "coeffs_median": q[1, 3:].tolist(),
            "walker_steps_per_sec": rate}


if __name__ == "__main__":
    main()
