"""CLI driver: simultaneous multi-standoff fit (flagship #1).

Rebuild of ``python tests/simultFit.py`` (``tests/simultFit.py:42-63``
argparse surface).  Differences by design:

* ``-nThreads`` / ``-mpi`` are accepted-and-ignored — walker parallelism is
  a sharded array axis over all visible devices (``-mesh`` to cap); no
  process pools.
* ``-datafile`` defaults to synthetic data generated at the reference's
  guess parameters instead of a hard-coded private home path
  (``tests/simultFit.py:47``); pass a real multistandoff TSV to fit data.
* chains stream to ``burninchain.dat`` / ``mainchain.dat`` in the
  emcee-compatible text format plus a ``.npz`` checkpoint for exact resume.

Run: ``python -m mcmctoffitting_tpu.cli.simult_fit -nRuns 4 -debug 1``
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ._driver import add_common_flags

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-nRuns", choices=[1, 2, 3, 4, 5], default=4, type=int)
    p.add_argument("-datafile", default=None, type=str,
                   help="multistandoff TSV (default: synthesize)")
    add_common_flags(p, {
        "check_eval": "tests/simultFit.py:474-512",
        "nthreads": "tests/simultFit.py:46",
        "mpi": "tests/simultFit.py:688-706",
        "fine_defaults": "256 mc / 512 counts (1024 below 100k draws)",
    })
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ._driver import (build_logp_batch, common_setup, load_resume_state,
                          posterior_fingerprint, resolve_sampling,
                          run_phases_profiled)
    jax = common_setup(args)

    from ..models import simult
    from ..sampler import init_state
    from ..utils import chain_io, data_io

    key = jax.random.PRNGKey(args.seed)
    # debug shrinks the ensemble unless -nWalkers was given explicitly
    n_walkers = (2 * 9 if args.debug and args.nWalkers == 256
                 else args.nWalkers)
    burnin_steps = 10 if args.debug else args.nBurninSteps
    main_steps = 10 if args.debug else args.nMainSteps
    n_draws = 5000 if args.debug else args.nDrawsPerEval

    sampling, fine_grid = resolve_sampling(args)
    spec = simult.default_spec(
        n_samples=n_draws,
        fine_grid=fine_grid,
        xs_mode="e0grid" if sampling != "mc" else args.gridMode,
        sampling=sampling)
    if args.momentClosure != "exact" or args.aDtype:
        import dataclasses
        spec = dataclasses.replace(spec, moment_closure=args.momentClosure,
                                   a_dtype=args.aDtype or spec.a_dtype)
    from ._driver import resolve_run_axis
    spec = resolve_run_axis(args, spec, n_walkers)
    if args.sampler != "ensemble":
        from ._driver import resolve_gradient_spec
        spec = resolve_gradient_spec(args, spec)
    problem = simult.SimultFitProblem(spec, n_runs=args.nRuns,
                                      likelihood=args.likelihood)

    if args.datafile:
        tof_data = data_io.read_multi_standoff_tof_data(args.datafile,
                                                        args.nRuns)
        observed = tuple(
            data_io.select_window(tof_data, i, w.lo, w.hi)[0]
            for i, w in enumerate(problem.windows))
    else:
        truth = np.concatenate([simult.GUESS_SHARED,
                                np.full(args.nRuns, 5.0e4)])
        observed = data_io.synthesize_observed(
            jax.random.fold_in(key, 99), problem, truth)
        print("using synthetic observed data at guess parameters")

    if args.quitEarly:
        print("quitEarly: setup complete")
        return {"status": "quitEarly"}

    if args.checkLikelihoodEval:
        from ._driver import check_likelihood_eval
        total = check_likelihood_eval(problem, observed,
                                      jax.random.fold_in(key, 3),
                                      prefix=args.outputPrefix,
                                      batch=bool(args.batch))
        return {"status": "checkLikelihoodEval", "total_loglike": total}

    names = ["beamE", "eLoss", "scale", "s"] + [
        f"N{i + 1}" for i in range(args.nRuns)]
    if args.sampler != "ensemble":
        from ._driver import run_gradient_sampler
        return run_gradient_sampler(args, problem, observed, names=names)

    logp_batch = build_logp_batch(problem.make_log_prob_fn(observed), args,
                                  n_walkers=n_walkers)

    prefix = args.outputPrefix
    burnin_path = prefix + "burninchain.dat"
    main_path = prefix + "mainchain.dat"
    fingerprint = posterior_fingerprint(problem, observed)
    if args.resume:
        state = load_resume_state(args.resume, problem, observed, logp_batch)
        print(f"resumed from {args.resume} at step {int(state.step)}")
        phases = (("main", main_path, main_steps, False),)
    else:
        p0 = problem.initial_walkers_from_observed(
            jax.random.fold_in(key, 1), n_walkers, observed)
        state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
        phases = (("burn-in", burnin_path, burnin_steps, True),
                  ("main", main_path, main_steps, True))

    state, total_steps, elapsed = run_phases_profiled(
        args, state, phases, logp_batch, n_walkers=n_walkers,
        fingerprint=fingerprint)
    # report quantiles over the main chain
    from ._driver import report_quantiles
    main_chain, _, n_params, _, _ = chain_io.read_chain_text(main_path)
    result = report_quantiles(main_chain.reshape(-1, n_params), names)

    rate = total_steps * int(state.positions.shape[0]) / elapsed
    print(json.dumps({"walker_steps_per_sec": rate, "elapsed_s": elapsed}))

    if not args.batch:
        try:
            from ..utils.plotting import trace_plot
            trace_plot(main_chain, names,
                       prefix + "runSampleChainsOut.png")
        except Exception as e:  # matplotlib optional
            print(f"plotting skipped: {e}")
    return {"quantiles": result, "walker_steps_per_sec": rate}


if __name__ == "__main__":
    main()
