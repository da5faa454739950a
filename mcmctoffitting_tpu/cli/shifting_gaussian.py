"""CLI driver: shifting-Gaussian analytic study + parallel tempering.

Rebuild of ``python tests/shiftingGaussian_brute.py``: synthesize y ~
N(m x + b, sigma) with x marginalized over [0, 10] (truth sigma=0.4,
m=-0.3, b=5; ``tests/shiftingGaussian_brute.py:150-160``), then

1. plain ensemble fit with the numeric projected-pdf likelihood
   (100 walkers x 500 steps, ``:295-304``), acceptance-fraction
   diagnostics (``:329-334``);
2. the PTSampler configuration: 20 temperatures x 100 walkers,
   1000 burn-in + 10000 main steps thinned by 10 (``:349-360``),
   reporting the cold (beta=1) chain, per-rung swap acceptance, and the
   thermodynamic-integration log-evidence ln Z (the method emcee 2's
   PTSampler exposes on the sampler the reference configures).

``-model tof`` instead runs PT on a REDUCED TOF POSTERIOR (simultFit,
2 runs, corrected likelihood, counts forward): the beamE-eLoss direction
is a long degeneracy ridge — the tempered ladder's hot
rungs traverse it freely and replica exchange carries that mobility to the
cold chain.  Reported: cold-chain beamE span + swap acceptances.

Run: ``python -m mcmctoffitting_tpu.cli.shifting_gaussian --debug``
"""
from __future__ import annotations

import argparse
import json

import numpy as np

TRUTH = (0.4, -0.3, 5.0)   # sigma, m, b (tests/shiftingGaussian_brute.py)


def main(argv=None) -> dict:
    from ..utils import compile_cache
    compile_cache.enable()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-model", choices=["analytic", "tof"],
                   default="analytic")
    p.add_argument("-nSamples", default=500, type=int,
                   help="observed y draws (reference :157)")
    p.add_argument("-nWalkers", default=100, type=int)
    p.add_argument("-nSteps", default=500, type=int)
    p.add_argument("-nTemps", default=20, type=int)
    p.add_argument("-ptWalkers", default=100, type=int)
    p.add_argument("-ptBurnin", default=1000, type=int)
    p.add_argument("-ptSteps", default=10_000, type=int)
    p.add_argument("-thin", default=10, type=int)
    p.add_argument("-skipEnsemble", action="store_true")
    p.add_argument("-move", choices=["stretch", "de", "mixed"],
                   default="stretch",
                   help="proposal family for BOTH the ensemble and the "
                        "PT rungs (stretch = reference-faithful)")
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("--debug", action="store_true",
                   help="shrink every phase for a fast smoke run")
    p.add_argument("-outputPrefix", default="sg_", type=str)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..sampler.pt import sample_pt
    from ..utils import chain_io

    if args.debug:
        args.nSteps, args.nTemps, args.ptWalkers = 60, 4, 32
        args.ptBurnin, args.ptSteps, args.thin = 40, 80, 2
        args.nWalkers = 32

    key = jax.random.PRNGKey(args.seed)
    result = {}

    if args.model == "tof":
        return _run_tof_pt(args, key)

    from ..models import shifting_gaussian as sg

    data = sg.generate_data(jax.random.fold_in(key, 0), args.nSamples,
                            *TRUTH)
    print(f"synthesized {args.nSamples} observations at truth "
          f"sigma={TRUTH[0]}, m={TRUTH[1]}, b={TRUTH[2]}")

    names = ["sigma", "m", "b"]
    if not args.skipEnsemble:
        from ..sampler import sample
        logp = sg.make_log_prob_fn(data, numeric=True)
        p0 = (jnp.asarray(TRUTH)
              + 1e-4 * jax.random.normal(jax.random.fold_in(key, 1),
                                         (args.nWalkers, 3)))
        chain = sample(jax.random.fold_in(key, 2), p0, args.nSteps, logp,
                       move=args.move,
                       stochastic=True)
        jax.block_until_ready(chain.positions)
        acc = np.asarray(chain.acceptance_fraction)
        keep = args.nSteps * 2 // 5
        flat = np.asarray(chain.positions[keep:]).reshape(-1, 3)
        q = np.percentile(flat, [16, 50, 84], axis=0)
        print(f"ensemble: acceptance mean {acc.mean():.3f} "
              f"(min {acc.min():.3f}, max {acc.max():.3f})")
        for d, n in enumerate(names):
            print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
                  f"-{q[1, d] - q[0, d]:.3g} (truth {TRUTH[d]})")
        chain_io.append_chain_text(
            args.outputPrefix + "chain.dat",
            np.asarray(chain.positions), np.asarray(chain.log_probs),
            mode="w")
        result["ensemble"] = {n: float(q[1, d])
                              for d, n in enumerate(names)}

    # --- parallel tempering (PTSampler configuration, :349-360)
    loglike, logprior = sg.make_pt_fns(data, numeric=True)
    p0 = (jnp.asarray(TRUTH)
          + 1e-3 * jax.random.normal(jax.random.fold_in(key, 3),
                                     (args.nTemps, args.ptWalkers, 3)))
    burn = sample_pt(jax.random.fold_in(key, 4), p0, args.ptBurnin,
                     loglike, logprior, move=args.move)
    main_chain = sample_pt(jax.random.fold_in(key, 5),
                           burn.state.positions, args.ptSteps,
                           loglike, logprior, thin=args.thin,
                           move=args.move)
    jax.block_until_ready(main_chain.positions)
    cold = np.asarray(main_chain.cold_chain).reshape(-1, 3)
    q = np.percentile(cold, [16, 50, 84], axis=0)
    swaps = np.asarray(main_chain.n_swaps_accepted) / args.ptSteps \
        / args.ptWalkers
    # the model-comparison payoff of tempered sampling, same method as
    # emcee 2's PTSampler.thermodynamic_integration_log_evidence (the
    # sampler the reference configures, tests/shiftingGaussian_brute.py:352);
    # the chain carries the ladder it was sampled at (PTChain.betas)
    ln_z, d_ln_z = main_chain.thermodynamic_integration_log_evidence()
    print(f"PT ({args.nTemps} temps x {args.ptWalkers} walkers, "
          f"{args.ptBurnin}+{args.ptSteps} steps thin {args.thin}):")
    print(f"  swap acceptance per rung: {np.round(swaps, 3).tolist()}")
    print(f"  ln Z (thermodynamic integration) = {ln_z:.3f} +- {d_ln_z:.3f}")
    for d, n in enumerate(names):
        print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
              f"-{q[1, d] - q[0, d]:.3g} (truth {TRUTH[d]})")
    chain_io.append_chain_text(
        args.outputPrefix + "pt_coldchain.dat",
        np.asarray(main_chain.cold_chain),
        np.asarray(main_chain.log_like[:, 0] + main_chain.log_prior[:, 0]),
        mode="w")
    result["pt"] = {n: float(q[1, d]) for d, n in enumerate(names)}
    result["pt_swap_acceptance"] = swaps.tolist()
    result["pt_ln_evidence"] = [float(ln_z), float(d_ln_z)]
    print(json.dumps({"pt_cold_medians": result["pt"]}))
    return result


def _run_tof_pt(args, key) -> dict:
    """PT on a reduced TOF posterior (simultFit, 2 runs): demonstrate the
    tempered ladder carrying walkers along the beamE-eLoss ridge."""
    import jax
    import jax.numpy as jnp

    from ..models import simult
    from ..ops.likelihoods import box_lnprior
    from ..sampler.pt import sample_pt
    from ..utils import data_io

    n_runs = 2
    spec = simult.default_spec(n_samples=50_000, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=n_runs,
                                      likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(n_runs, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 9),
                                           problem, truth)
    obs = tuple(jnp.asarray(o, jnp.float32) for o in observed)

    def loglike(theta, k):
        return problem.log_like(theta, k, obs)

    def logprior(theta, k):
        del k
        return box_lnprior(theta, problem.param_lo, problem.param_hi,
                           inclusive=True)

    p0 = problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 1),
        args.nTemps * args.ptWalkers, observed).reshape(
            args.nTemps, args.ptWalkers, problem.n_dim)
    burn = sample_pt(jax.random.fold_in(key, 2), p0, args.ptBurnin,
                     loglike, logprior, stochastic=True, move=args.move)
    chain = sample_pt(jax.random.fold_in(key, 3), burn.state.positions,
                      args.ptSteps, loglike, logprior, thin=args.thin,
                      stochastic=True, move=args.move)
    jax.block_until_ready(chain.positions)
    cold = np.asarray(chain.cold_chain).reshape(-1, problem.n_dim)
    swaps = np.asarray(chain.n_swaps_accepted) / args.ptSteps \
        / args.ptWalkers
    names = ["beamE", "eLoss", "scale", "s"] + [
        f"N{i + 1}" for i in range(n_runs)]
    q = np.percentile(cold, [16, 50, 84], axis=0)
    span = np.percentile(cold[:, 0], [2.5, 97.5])
    print(f"PT on reduced TOF posterior ({args.nTemps} temps x "
          f"{args.ptWalkers} walkers):")
    print(f"  swap acceptance per rung: {np.round(swaps, 3).tolist()}")
    for d, n in enumerate(names):
        print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
              f"-{q[1, d] - q[0, d]:.3g}")
    print(f"  cold-chain beamE 95% span: [{span[0]:.1f}, {span[1]:.1f}] "
          f"({span[1] - span[0]:.1f} keV of ridge traversed)")
    # ln Z of the TOF posterior by thermodynamic integration.  NOTE: under
    # the pseudo-marginal (stochastic) likelihood this is approximate and
    # biased LOW — E[ln L-hat] <= ln E[L-hat] = ln L (Jensen), so each
    # rung's <ln L>_beta is depressed by ~Var[ln L-hat]/2; report it as a
    # lower bound (an unbiased ln Z would need a non-stochastic — e.g.
    # expected-forward — likelihood evaluation along the ladder)
    ln_z, d_ln_z = chain.thermodynamic_integration_log_evidence()
    print(f"  ln Z (thermodynamic integration) = {ln_z:.3f} +- {d_ln_z:.3f}")
    print(json.dumps({"beamE_span_keV": float(span[1] - span[0]),
                      "swap_acceptance": swaps.tolist()}))
    return {"beamE_span_keV": float(span[1] - span[0]),
            "swap_acceptance": swaps.tolist(),
            "pt_ln_evidence": [float(ln_z), float(d_ln_z)]}


if __name__ == "__main__":
    main()
