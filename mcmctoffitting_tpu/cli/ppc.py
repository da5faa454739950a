"""CLI driver: posterior-predictive checks + SDEF export.

Rebuild of ``python tests/testPPC.py`` / ``tests/ppcPlotting_oneBD.py``:
load a chain file (emcee text format or native .npz checkpoint), sample the
posterior tail, push draws through the forward model, and produce
16/50/84% credible-band plots, neutron/deuteron spectrum bands, an MCNP
SDEF card, and a corner plot.

Run: ``python -m mcmctoffitting_tpu.cli.ppc -chainFilename mainchain.dat``
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    from ..utils import compile_cache
    compile_cache.enable()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-chainFilename", required=True, type=str)
    p.add_argument("-model", choices=["simult", "onebd", "csi2016"],
                   default="simult",
                   help="csi2016 = ppcTools-era skewnorm-parameterized "
                        "chains (theta = e0, sigma0, skew0, scaleFactor)")
    p.add_argument("-nRuns", default=4, type=int)
    p.add_argument("-nSamplesFromTOF", default=50_000, type=int,
                   help="MC draws per PPC forward eval")
    p.add_argument("-nChainEntries", default=100, type=int,
                   help="number of posterior draws")
    p.add_argument("-lnprobcut", default=None, type=float,
                   help="discard chain samples below this lnprob "
                        "(ppcTools_oneBD behavior)")
    p.add_argument("-observedData", default=None, type=str,
                   help="multistandoff TSV for band overlay plots")
    p.add_argument("-outputPrefix", default="ppc_", type=str)
    p.add_argument("-sdefDistNumber", default=100, type=int)
    p.add_argument("-seed", default=0, type=int)
    args = p.parse_args(argv)

    import jax

    from ..models import csi2016, onebd, simult
    from ..utils import chain_io, data_io
    from ..utils.ppc import (PPCSampler, collapse_neutron_spectrum,
                             make_sdef_sia_cumulative, percentile_bands)

    import os
    import sys
    if not os.path.exists(args.chainFilename):
        sys.exit(f"error: chain file not found: {args.chainFilename}")
    try:
        chain, probs, n_params, n_walkers, n_steps = \
            chain_io.read_chain_text(args.chainFilename)
    except Exception as e:
        sys.exit(f"error: could not parse chain file "
                 f"{args.chainFilename}: {e}")
    print(f"chain: {n_steps} steps x {n_walkers} walkers x {n_params} params")

    if args.model == "simult":
        spec = simult.default_spec(n_samples=args.nSamplesFromTOF)
        problem = simult.SimultFitProblem(spec, n_runs=args.nRuns)
    elif args.model == "csi2016":
        spec = csi2016.default_spec(n_samples=args.nSamplesFromTOF)
        problem = csi2016.Csi2016Problem(spec, n_runs=args.nRuns)
    else:
        spec = onebd.default_spec(n_samples=args.nSamplesFromTOF)
        problem = onebd.OneBDProblem(spec, n_runs=3)

    sampler = PPCSampler(problem, chain, probs)
    key = jax.random.PRNGKey(args.seed)
    result = sampler.generate(key, args.nChainEntries,
                              lnprob_cut=args.lnprobcut)

    out = {}
    for run, spectra in enumerate(result.tof_spectra):
        bands = percentile_bands(spectra)
        out[f"run{run}_bands"] = bands
        np.savetxt(f"{args.outputPrefix}run{run}_bands.txt", bands)

    # neutron spectrum summed over draws + cell length -> SDEF card
    neutron_spectrum = collapse_neutron_spectrum(result.neutron_spectra)
    sdef = make_sdef_sia_cumulative(problem.spec.en_centers(),
                                    neutron_spectrum, args.sdefDistNumber)
    with open(args.outputPrefix + "sdef.txt", "w") as f:
        f.write(sdef["si"] + "\n" + sdef["sp"] + "\n")
    print(f"wrote {args.outputPrefix}sdef.txt")

    try:
        from ..utils.plotting import corner_plot, ppc_band_plot
        corner_plot(chain[-50:], filename=args.outputPrefix + "corner.png")
        if args.observedData:
            tof_data = data_io.read_multi_standoff_tof_data(
                args.observedData, len(problem.windows))
            for run, w in enumerate(problem.windows):
                obs, _ = data_io.select_window(tof_data, run, w.lo, w.hi)
                ppc_band_plot(obs, out[f"run{run}_bands"],
                              filename=f"{args.outputPrefix}run{run}.png")
        print("wrote PPC plots")
    except Exception as e:
        print(f"plotting skipped: {e}")
    return {"n_draws": args.nChainEntries, "sdef": sdef}


if __name__ == "__main__":
    main()
