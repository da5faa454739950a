"""CLI driver: the historical simple-model family (v0-v2.5).

One driver covering four reference scripts:
  --model v0   -> tests/simpleTOFmodel.py   (E0+E1 x, 3 params, fake data)
  --model v1   -> tests/simpleTOFfit.py     (cubic E(x), 5 params)
  --model v2   -> tests/intermediateTOFfit.py (6 params, XS weights + conv)
  --model v2.5 -> tests/intermediateTOFmodel.py (Bethe transport, 2 params)

v0 runs the reference's closure experiment: generate fake data at the truth
(E0=1100, E1=-100, sigma=50; tests/simpleTOFmodel.py:124-126), fit, print
recovered quantiles vs truth.  v1/v2 accept a real TSV via --datafile.

Run: ``python -m mcmctoffitting_tpu.cli.simple_tof --model v0``
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

MODEL_CONFIGS = {
    # poly_order, sigma_growth, xs, conv, bethe, window, truth, lo, hi
    "v0": dict(poly_order=1, n_dim=3,
               truth=(1100.0, -100.0, 50.0),
               lo=(800.0, -200.0, 10.0), hi=(1200.0, 0.0, 100.0),
               n_walkers=50, n_steps=500),
    "v1": dict(poly_order=3, n_dim=5,
               truth=(900.0, -50.0, -10.0, -5.0, 60.0),
               lo=(800.0, -150.0, -30.0, -10.0, 40.0),
               hi=(1100.0, 0.0, 0.0, 0.0, 100.0),
               n_walkers=100, n_steps=500),
    "v2": dict(poly_order=3, n_dim=6, sigma_growth=True, xs=True, conv=True,
               truth=(900.0, -50.0, -10.0, -5.0, 0.05, 0.01),
               lo=(800.0, -150.0, -30.0, -10.0, 0.005, 0.0),
               hi=(1100.0, 0.0, 0.0, 0.0, 0.2, 0.1),
               n_walkers=100, n_steps=500),
    "v2.5": dict(poly_order=0, n_dim=2, bethe=True, xs=True, conv=True,
                 truth=(900.0, 0.05),
                 lo=(500.0, 0.005), hi=(1300.0, 0.5),
                 n_walkers=100, n_steps=500),
}


def main(argv=None) -> dict:
    from ..utils import compile_cache
    compile_cache.enable()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=list(MODEL_CONFIGS), default="v0")
    p.add_argument("--datafile", default=None,
                   help="observed TOF TSV (default: synthesize at truth)")
    p.add_argument("--nDraws", default=200_000, type=int)
    p.add_argument("--nWalkers", default=0, type=int)
    p.add_argument("--nSteps", default=0, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--outputPrefix", default="", type=str)
    p.add_argument("--minimizeSeed", action="store_true",
                   help="seed the walkers from a bounded TNC fit of the "
                        "NLL first (the v1 reference behavior, "
                        "tests/simpleTOFfit.py:267-271; common random "
                        "numbers make the stochastic NLL deterministic)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..constants import TUNL_SSA_CSI, TofWindow
    from ..models.simple import SimpleProblem, SimpleSpec, sample_tof
    from ..ops.stopping import d2_gas_stopping
    from ..sampler import sample
    from ..utils import chain_io

    cfg = MODEL_CONFIGS[args.model]
    n_walkers = args.nWalkers or cfg["n_walkers"]
    n_steps = args.nSteps or cfg["n_steps"]
    n_draws = args.nDraws
    if args.debug:
        # keep draws high enough that the multinomial likelihood rarely
        # sees zero-model bins (-inf) — acceptance stays healthy
        n_walkers, n_steps, n_draws = 16, 40, 100_000

    window = (TofWindow(175.0, 200.0, 25) if args.model == "v0"
              else TofWindow(175.0, 225.0, 50))
    spec = SimpleSpec(
        window=window,
        poly_order=cfg.get("poly_order", 1),
        sigma_growth=cfg.get("sigma_growth", False),
        xs_weighting=cfg.get("xs", False),
        convolve_beam=cfg.get("conv", False),
        bethe_transport=cfg.get("bethe", False),
        # the v2.5 driver's own gas density (tests/intermediateTOFmodel.py:92)
        # — NOT the simultFit red-notebook 8.565e-5 default
        stopping=d2_gas_stopping(rho=8.37e-5) if cfg.get("bethe") else None,
        add_half_zero_deg=args.model != "v0",
        n_samples=n_draws,
    )
    standoff = (TUNL_SSA_CSI.cell_to_zero if args.model == "v0"
                else TUNL_SSA_CSI.standoff_mid)
    problem = SimpleProblem(spec=spec, standoff=standoff,
                            param_lo=cfg["lo"], param_hi=cfg["hi"])

    key = jax.random.PRNGKey(args.seed)
    truth = np.asarray(cfg["truth"])
    if args.datafile:
        from ..utils import data_io
        tof_data = data_io.read_multi_standoff_tof_data(args.datafile, 1)
        observed, _ = data_io.select_window(tof_data, 0, window.lo,
                                            window.hi)
    else:
        tofs, _, _, _ = sample_tof(jax.random.fold_in(key, 0),
                                   jnp.asarray(truth), spec, standoff)
        observed, _ = np.histogram(np.asarray(tofs)[:10_000],
                                   window.n_bins, window.range)
        print(f"synthesized fake data at truth {truth.tolist()}")

    logp = problem.make_log_prob_fn(observed.astype(np.float64))
    center = jnp.asarray(truth) * 1.02
    if args.minimizeSeed:
        # bounded TNC fit of the NLL, walkers seeded from its optimum
        # (tests/simpleTOFfit.py:267-283: minimize -> p0 around .x)
        from ..utils.optimize import minimize_nll
        res = minimize_nll(logp, np.asarray(center),
                           key=jax.random.fold_in(key, 3), method="TNC",
                           bounds=list(zip(cfg["lo"], cfg["hi"])), tol=1.0)
        print(f"TNC seed: nll {res.fun:.6g} at "
              f"{np.round(res.x, 4).tolist()} (success={res.success})")
        center = jnp.asarray(res.x, jnp.float32)
    p0 = (center
          + 1e-2 * jax.random.normal(jax.random.fold_in(key, 1),
                                     (n_walkers, cfg["n_dim"])))
    t0 = time.time()
    chain = sample(jax.random.fold_in(key, 2), p0, n_steps, logp,
                   stochastic=True)
    jax.block_until_ready(chain.positions)
    elapsed = time.time() - t0

    chain_io.append_chain_text(args.outputPrefix + "mainchain.dat",
                               np.asarray(chain.positions),
                               np.asarray(chain.log_probs), mode="w")
    keep = n_steps * 3 // 5
    samples = np.asarray(chain.positions[keep:]).reshape(-1, cfg["n_dim"])
    q = np.percentile(samples, [16, 50, 84], axis=0)
    print("MCMC result (median +sigma -sigma vs truth):")
    result = {}
    for d in range(cfg["n_dim"]):
        med, lo, hi = q[1, d], q[1, d] - q[0, d], q[2, d] - q[1, d]
        t = truth[d] if d < len(truth) else float("nan")
        print(f"  theta[{d}] = {med:.4g} +{hi:.3g} -{lo:.3g} (truth {t})")
        result[f"theta{d}"] = [float(med), float(hi), float(lo)]
    rate = n_steps * n_walkers / elapsed
    acc = float(np.asarray(chain.acceptance_fraction).mean())
    print(json.dumps({"walker_steps_per_sec": rate, "acceptance": acc}))
    return {"quantiles": result, "walker_steps_per_sec": rate,
            "acceptance": acc}


if __name__ == "__main__":
    main()
