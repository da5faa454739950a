"""NUTS statistical validation on the flagship posterior.

The gradient samplers are correctness-tested on analytic targets
(tests/test_nuts.py); this study runs the dz-table protocol (as in
artifacts/parity_poisson*) on the DIFFERENTIABLE flagship posterior:
``-sampler nuts`` vs long stretch-move chains, both on the identical
expected-forward simultFit posterior (corrected Poisson likelihood,
rint off — cli/_driver.resolve_gradient_spec semantics).  Both samplers
target the same distribution, so per-parameter medians must agree within
pooled posterior-sigma units.  Reference moral equivalent: the pymc3
NUTS/Metropolis cross-check, ``tests/testSimpleNested.py:181-220``.

Usage: [JAX_PLATFORMS=cpu] python tools/nuts_parity.py
       [--walkers W] [--burnin B] [--main M] [--chains C]
       [--warmup U] [--steps S]
Writes artifacts/parity_nuts_report.txt + parity_nuts_summary.json.
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

N_RUNS = 2
N_DRAWS = 50_000
NAMES = ["beamE", "eLoss", "scale", "s"] + [f"N{i+1}" for i in range(N_RUNS)]


def _arg(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


def build_problem():
    import jax

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.utils import data_io

    # the gradient-safe configuration (cli/_driver.resolve_gradient_spec):
    # closed-form expected forward, corrected Poisson logpmf, rint off
    spec = dataclasses.replace(
        simult.default_spec(n_samples=N_DRAWS, sampling="expected"),
        rint_draws=False)
    problem = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                      likelihood="poisson")
    key = jax.random.PRNGKey(0)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 99),
                                           problem, truth)
    return problem, observed, key


def run_stretch(problem, observed, key, n_walkers, n_burnin, n_main):
    import jax

    from mcmctoffitting_tpu.sampler import sample

    logp = problem.make_log_prob_fn(observed)
    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               n_walkers, observed)
    t0 = time.time()
    burn = sample(jax.random.fold_in(key, 2), p0, n_burnin, logp,
                  stochastic=True)
    from mcmctoffitting_tpu.sampler import make_logp_batch, run_mcmc
    main = run_mcmc(burn.state, n_main, make_logp_batch(logp))
    jax.block_until_ready(main.positions)
    elapsed = time.time() - t0
    flat = np.asarray(main.positions).reshape(-1, problem.n_dim)
    acc = float(np.mean(np.asarray(main.acceptance_fraction)))
    return flat, acc, elapsed


def run_nuts(problem, observed, key, n_chains, n_warmup, n_steps):
    """Mirrors cli/_driver.run_gradient_sampler: box-logit coordinates
    (sampler/transforms.py — the round-5 reparameterization that removed
    the 46% divergence rate of the linear standardization)."""
    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.sampler import nuts_sample
    from mcmctoffitting_tpu.sampler.transforms import BoxLogitTransform

    logp_full = problem.make_log_prob_fn(observed)
    key0 = jax.random.fold_in(key, 7)   # unused: deterministic likelihood
    cloud = np.asarray(problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 3), max(256, n_chains), observed))
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi)
    logp_u = tr.wrap_logp(lambda theta: logp_full(theta, key0))

    p0 = tr.to_u(jnp.asarray(cloud[:n_chains], jnp.float32))
    t0 = time.time()
    chain = nuts_sample(jax.random.fold_in(key, 2), p0, n_steps, logp_u,
                        n_warmup=n_warmup)
    jax.block_until_ready(chain.positions)
    elapsed = time.time() - t0
    positions = np.asarray(tr.to_theta(chain.positions))
    flat = positions.reshape(-1, problem.n_dim)
    accept = float(np.mean(np.asarray(chain.accept_stat)))
    n_div = int(np.sum(np.asarray(chain.diverging)))
    return flat, accept, n_div, elapsed


def main() -> int:
    n_walkers = _arg("--walkers", 32)
    n_burnin = _arg("--burnin", 400)
    n_main = _arg("--main", 2500)
    n_chains = _arg("--chains", 8)
    n_warmup = _arg("--warmup", 500)
    n_steps = _arg("--steps", 1500)

    problem, observed, key = build_problem()
    print(f"stretch side: {n_walkers} walkers x {n_burnin}+{n_main} steps",
          flush=True)
    s_flat, s_acc, s_dt = run_stretch(problem, observed, key, n_walkers,
                                      n_burnin, n_main)
    print(f"stretch: {s_dt:.0f}s acc={s_acc:.2f}", flush=True)
    print(f"nuts side: {n_chains} chains x {n_warmup}+{n_steps}",
          flush=True)
    n_flat, n_acc, n_div, n_dt = run_nuts(problem, observed, key, n_chains,
                                          n_warmup, n_steps)
    print(f"nuts: {n_dt:.0f}s accept-stat={n_acc:.2f} "
          f"divergences={n_div}", flush=True)

    lines = [f"NUTS posterior parity [expected forward, poisson], "
             f"{N_RUNS} runs x {N_DRAWS} draws scale, shared data",
             f"stretch: {n_walkers}w x {n_burnin}+{n_main} steps, "
             f"{s_dt:.0f}s acc={s_acc:.2f} | nuts: {n_chains}c x "
             f"{n_warmup}+{n_steps}, {n_dt:.0f}s accept={n_acc:.2f} "
             f"div={n_div}/{n_chains * n_steps} "
             f"({100.0 * n_div / (n_chains * n_steps):.1f}% post-warmup, "
             "box-logit coordinates)",
             f" param {'stretch med':>12} {'stretch sig':>11} "
             f"{'nuts med':>11} {'nuts sig':>9} {'dz':>6}"]
    worst = 0.0
    for d, name in enumerate(NAMES):
        sq = np.percentile(s_flat[:, d], [16, 50, 84])
        nq = np.percentile(n_flat[:, d], [16, 50, 84])
        ss = (sq[2] - sq[0]) / 2
        ns = (nq[2] - nq[0]) / 2
        pooled = np.hypot(ss, ns) / np.sqrt(2)
        dz = (nq[1] - sq[1]) / pooled if pooled > 0 else np.inf
        worst = max(worst, abs(dz))
        lines.append(f"{name:>6} {sq[1]:12.4g} {ss:11.3g} "
                     f"{nq[1]:11.4g} {ns:9.3g} {dz:6.2f}")
    verdict = "PASS" if worst < 1.0 else "FAIL"
    lines.append(f"worst |dz| = {worst:.2f} (medians in pooled "
                 f"posterior-sigma units) -> {verdict} (threshold 1.0, "
                 "same protocol as artifacts/parity_poisson*)")
    report = "\n".join(lines)
    print(report)
    art = os.path.join(REPO, "artifacts")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "parity_nuts_report.txt"), "w") as f:
        f.write(report + "\n")
    with open(os.path.join(art, "parity_nuts_summary.json"), "w") as f:
        json.dump({"worst_dz": worst, "divergences": n_div,
                   "divergence_rate": n_div / (n_chains * n_steps),
                   "stretch": {"walkers": n_walkers, "burnin": n_burnin,
                               "main": n_main, "acc": s_acc},
                   "nuts": {"chains": n_chains, "warmup": n_warmup,
                            "steps": n_steps, "accept_stat": n_acc}},
                  f, indent=1)
    print(f"wrote {art}/parity_nuts_report.txt")
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
