"""CLI driver: csi_oneBD fit (flagship #2).

Rebuild of ``python tests/csi_oneBD.py`` (``tests/csi_oneBD.py:58-76``
argparse surface): fixed beam reference energy, per-run scale + Poisson
background, spline-table stopping, cell attenuation, -qnd/-quickish/
-hardcore sampling presets, -shiftTOF systematic.  Threads/MPI flags are
replaced by device-mesh walker sharding.

Run: ``python -m mcmctoffitting_tpu.cli.csi_onebd -debug 1``
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ._driver import add_common_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-run", choices=[0, 1, 2, 3], default=0, type=int,
                   help="accepted for surface parity; vestigial in the "
                        "reference (its window selection is immediately "
                        "overwritten, tests/csi_oneBD.py:178-183)")
    p.add_argument("-inputDataFilename", default=None, type=str)
    # the reference spells these as int choices (-qnd 1,
    # tests/csi_oneBD.py:71-73); accept both that and bare-flag style
    p.add_argument("-qnd", type=int, choices=[0, 1], nargs="?", const=1,
                   default=0, help="quick and dirty: 60k draws")
    p.add_argument("-quickish", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0, help="100k draws")
    p.add_argument("-hardcore", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0, help="400 eD x 20 x binning")
    p.add_argument("-shiftTOF", default=0, type=int,
                   help="shift observed spectra by whole bins (systematic)")
    p.add_argument("-deterministicBG", action="store_true",
                   help="add the expected background level instead of a "
                        "fresh Poisson draw per eval (statistically clean; "
                        "default is the reference-faithful pseudo-marginal "
                        "draw, tests/csi_oneBD.py:521)")
    add_common_flags(p, {
        "check_eval": "tests/csi_oneBD.py:654-712",
        "nthreads": "tests/csi_oneBD.py:62",
        "mpi": "tests/csi_oneBD.py:61",
        "fine_defaults": "512 mc / 1024 hardcore / 1024 counts "
                         "(2048 below 100k draws)",
    })
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ._driver import (build_logp_batch, common_setup, load_resume_state,
                          posterior_fingerprint, resolve_sampling,
                          run_phases_profiled)
    jax = common_setup(args)

    import dataclasses

    from ..models import onebd
    from ..sampler import init_state
    from ..utils import chain_io, data_io

    key = jax.random.PRNGKey(args.seed)
    n_draws = args.nDrawsPerEval
    if args.quickish:
        n_draws = 100_000
    if args.qnd:
        n_draws = 60_000
    if args.debug:
        n_draws = 5000
    # debug shrinks the ensemble unless -nWalkers was given explicitly
    n_walkers = (2 * 9 if args.debug and args.nWalkers == 256
                 else args.nWalkers)
    burnin_steps = 10 if args.debug else args.nBurninSteps
    main_steps = 10 if args.debug else args.nMainSteps

    sampling, fine_grid = resolve_sampling(args)
    spec = onebd.default_spec(
        n_samples=n_draws, hardcore=args.hardcore,
        fine_grid=fine_grid,
        xs_mode="e0grid" if sampling != "mc" else args.gridMode,
        sampling=sampling)
    if args.deterministicBG:
        spec = dataclasses.replace(spec, bg_mode="expected")
    if args.momentClosure != "exact" or args.aDtype:
        spec = dataclasses.replace(spec, moment_closure=args.momentClosure,
                                   a_dtype=args.aDtype or spec.a_dtype)
    from ._driver import resolve_run_axis
    spec = resolve_run_axis(args, spec, n_walkers)
    if args.sampler != "ensemble":
        from ._driver import resolve_gradient_spec
        spec = resolve_gradient_spec(args, spec)
    problem = onebd.OneBDProblem(spec, n_runs=3,
                                 likelihood=args.likelihood)

    if args.inputDataFilename:
        tof_data = data_io.read_multi_standoff_tof_data(
            args.inputDataFilename, 3)
        # -shiftTOF relabels the count rows against the time axis by whole
        # bins BEFORE window selection (tests/csi_oneBD.py:698-706)
        shift = args.shiftTOF
        if shift > 0:
            edges = tof_data[:-shift, 0]
            tof_data = tof_data[shift:].copy()
            tof_data[:, 0] = edges
        elif shift < 0:
            edges = tof_data[-shift:, 0]
            tof_data = tof_data[:shift].copy()
            tof_data[:, 0] = edges
        observed = tuple(
            data_io.select_window(tof_data, i, w.lo, w.hi)[0]
            for i, w in enumerate(problem.windows))
    else:
        truth = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4,
                          20.0, 20.0, 20.0])
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

    names = (["eLoss", "scale", "s"] + [f"N{i+1}" for i in range(3)]
             + [f"BG{i+1}" for i in range(3)])
    if args.sampler != "ensemble":
        from ._driver import run_gradient_sampler
        return run_gradient_sampler(args, problem, observed, names=names)

    logp_batch = build_logp_batch(problem.make_log_prob_fn(observed), args,
                                  n_walkers=n_walkers)

    prefix = args.outputPrefix
    fingerprint = posterior_fingerprint(problem, observed)
    if args.resume:
        state = load_resume_state(args.resume, problem, observed, logp_batch)
        print(f"resumed from {args.resume} at step {int(state.step)}")
        phases = (("main", prefix + "mainchain.dat", main_steps, False),)
    else:
        p0 = problem.initial_walkers_from_observed(
            jax.random.fold_in(key, 1), n_walkers, observed)
        state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
        phases = (("burn-in", prefix + "burninchain.dat", burnin_steps, True),
                  ("main", prefix + "mainchain.dat", main_steps, True))

    state, total_steps, elapsed = run_phases_profiled(
        args, state, phases, logp_batch, n_walkers=n_walkers,
        fingerprint=fingerprint)

    from ._driver import report_quantiles
    main_chain, _, n_params, _, _ = chain_io.read_chain_text(
        prefix + "mainchain.dat")
    result = report_quantiles(main_chain.reshape(-1, n_params), names)

    rate = total_steps * int(state.positions.shape[0]) / elapsed
    print(json.dumps({"walker_steps_per_sec": rate, "elapsed_s": elapsed}))

    if not args.batch:
        try:
            from ..utils.plotting import trace_plot
            trace_plot(main_chain, names, prefix + "runSampleChainsOut.png")
        except Exception as e:
            print(f"plotting skipped: {e}")
    return {"quantiles": result, "walker_steps_per_sec": rate}


if __name__ == "__main__":
    main()
