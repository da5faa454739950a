"""Posterior parity study: reference physics + emcee-equivalent sampler
vs this package, on IDENTICAL observed data (BASELINE.md protocol:
"report ... posterior parity against those locally-generated chains").

Reference side: lnprob orchestrated from the REFERENCE'S OWN kernels
imported from /root/reference (exactly as tools/measure_reference_baseline
does, = tests/simultFit.py:223-300,380-469 incl. per-run scale factors and
the box prior), sampled with the independent numpy Goodman-Weare stretch
sampler (same algorithm/constants as emcee; emcee itself is not installed
— parity of that implementation is pinned by tests/test_sampler_parity).

Our side: the flagship SimultFitProblem at the same draw count, walkers
and steps, on whatever jax backend is active.

Usage:
  python tools/reference_posterior_parity.py prepare   # synth shared data
  python tools/reference_posterior_parity.py reference # CPU, ~30-60 min
  python tools/reference_posterior_parity.py ours      # GPU/CPU, fast
  python tools/reference_posterior_parity.py report
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"
# PARITY_LIKELIHOOD=reference (faithful sawtooth form; sticky chains,
# loose medians) | poisson (correct logpmf BOTH sides; sharp comparison)
LIKELIHOOD = os.environ.get("PARITY_LIKELIHOOD", "reference")
# PARITY_SAMPLING=mc|counts: OUR side's forward estimator ('counts' =
# the Poissonized Rao-Blackwell production mode).  The reference side is
# always its own per-sample pipeline; a counts run reuses the mc study's
# observed data + reference chain (copied into its own out dir).
SAMPLING = os.environ.get("PARITY_SAMPLING", "mc")
# PARITY_CLOSURE=exact|cell: OUR side's moment closure (counts/expected
# forward only; ops/e0grid.expected_moments)
CLOSURE = os.environ.get("PARITY_CLOSURE", "exact")
OUT = os.path.join(REPO, "out",
                   "parity" if LIKELIHOOD == "reference"
                   else f"parity_{LIKELIHOOD}")
BASE_OUT = OUT
if SAMPLING != "mc":
    OUT += f"_{SAMPLING}"
if CLOSURE != "exact":
    OUT += f"_{CLOSURE}"
if os.environ.get("PARITY_RUNS") or os.environ.get("PARITY_DRAWS"):
    suffix = (f"_r{os.environ.get('PARITY_RUNS', '4')}"
              f"_d{os.environ.get('PARITY_DRAWS', '10000')}")
    OUT += suffix
    BASE_OUT += suffix


def _seed_from_base():
    """counts study inherits the mc study's shared inputs/reference."""
    if OUT == BASE_OUT:
        return
    import shutil
    os.makedirs(OUT, exist_ok=True)
    for name in ("observed.npz", "reference_chain.npz"):
        dst = os.path.join(OUT, name)
        src = os.path.join(BASE_OUT, name)
        if not os.path.exists(dst) and os.path.exists(src):
            shutil.copy(src, dst)

N_RUNS = int(os.environ.get("PARITY_RUNS", "4"))
N_DRAWS = int(os.environ.get("PARITY_DRAWS", "10000"))
N_WALKERS = 18
# Step-count overrides: the reference side costs ~1.5 s/eval/2-runs at
# 50k draws on this host's single core, so the 4-run joint study trims
# the phase lengths to keep its reference chain to ~2 h (18 walkers x
# 160 steps still gives ~1600 retained samples after report()'s
# N_MAIN//4 discard).
N_BURNIN = int(os.environ.get("PARITY_BURNIN", "60"))
N_MAIN = int(os.environ.get("PARITY_MAIN", "200"))
# Norms 10x below the flagship default: the reference's idiosyncratic
# likelihood has pseudo-marginal logp noise that grows with the observed
# count scale (measured sigma ~ 7e4 at 5e4 norms, ~5e3 at 5e3 norms,
# nearly draw-count-INdependent).  Ensemble acceptance decays as the
# ensemble tightens (record statistics of the per-eval noise) for BOTH
# samplers equally; see _initial_walkers for how the comparison handles
# that.
TRUTH = np.concatenate([[1878.4, 850.0, 170.0, 0.5], [5e3] * N_RUNS])
PARAM_NAMES = (["beamE", "eLoss", "scale", "s"]
               + [f"N{i + 1}" for i in range(N_RUNS)])


def _load_reference_modules():
    sys.path.insert(0, REFERENCE)
    import importlib
    return {
        "constants": importlib.import_module("constants.constants"),
        "utilities": importlib.import_module("utilities.utilities"),
        "ionStopping": importlib.import_module("utilities.ionStopping"),
    }


def make_reference_lnprob(ref, observed):
    """lnprob(theta) using the reference's own kernels
    (tests/simultFit.py:223-300 generateModelData, :380-409 lnlike,
    :412-442 compoundLnlike + box prior, :444-469 lnprob)."""
    from scipy.integrate import ode
    from scipy.special import gammaln
    from scipy.stats import lognorm

    consts = ref["constants"]
    distances, masses = consts.distances, consts.masses
    tofW = consts.tofWindows()

    ddnXS = ref["utilities"].ddnXSinterpolator()
    ref_np = ref["utilities"].np
    orig_linspace = ref_np.linspace
    ref_np.linspace = lambda a, b, n, *args, **kw: orig_linspace(
        a, b, int(n), *args, **kw)
    try:
        beamTiming = ref["utilities"].beamTimingShape()
    finally:
        ref_np.linspace = orig_linspace
    zeroDeg = ref["utilities"].zeroDegreeTimingSpread()
    stopping = ref["ionStopping"].ionStopping.simpleBethe([1])
    stopping.addMaterial([1, 2, 8.565e-5, 19.2e-3])
    getTOF = ref["utilities"].getTOF
    getDDn = ref["utilities"].getDDneutronEnergy

    eD_bins, eD_lo, eD_hi = 50, 200.0, 1200.0
    x_bins = 10
    L = distances.tunlSSA_CsI.cellLength
    x_centers = np.linspace(L / 20, L - L / 20, x_bins)
    eD_centers = np.linspace(eD_lo + 10, eD_hi - 10, eD_bins)
    eN_centers = getDDn(eD_centers)
    eD_binSize, x_binSize = (eD_hi - eD_lo) / eD_bins, L / x_bins

    standoffs = [distances.tunlSSA_CsI.standoffMid,
                 distances.tunlSSA_CsI.standoffClose,
                 distances.tunlSSA_CsI.standoffClose,
                 distances.tunlSSA_CsI.standoffFar,
                 distances.tunlSSA_CsI.standoff_TUNLruns][:N_RUNS]
    run_names = ["mid", "close", "close", "far", "production"][:N_RUNS]

    # parameter bounds (tests/simultFit.py:425-435)
    lo_b = np.array([1825.0, 600.0, 40.0, 0.1] + [0.0] * N_RUNS)
    hi_b = np.array([1925.0, 1000.0, 300.0, 1.2] + [1.0e6] * N_RUNS)

    # precompute zero-degree spread per eD bin (reference rebuilds per
    # cell; identical values, same getTimesAndWeights call)
    zd = [zeroDeg.getTimesAndWeights(eN_centers[j]) for j in range(eD_bins)]

    def lnprob(theta):
        if np.any(theta < lo_b) or np.any(theta > hi_b):
            return -np.inf
        total = 0.0
        for run in range(N_RUNS):
            name = run_names[run]
            lo, hi = tofW.minRange[name], tofW.maxRange[name]
            nb = tofW.nBins[name]
            obs = observed[run]

            data_hist = np.zeros((x_bins, eD_bins))
            ez = np.repeat(theta[0], N_DRAWS) - lognorm.rvs(
                s=theta[3], loc=theta[1], scale=theta[2], size=N_DRAWS)
            while True:
                bad = np.where(ez <= 0.0)[0]
                if bad.size == 0:
                    break
                ez[bad] = theta[0] - lognorm.rvs(
                    s=theta[3], loc=theta[1], scale=theta[2],
                    size=bad.size)
            solver = ode(lambda x, y: stopping.dEdx(energy=y, x=x))
            solver.set_integrator("dopri5").set_initial_value(ez)
            for i, x in enumerate(x_centers):
                sol = solver.integrate(x)
                w = ddnXS.evaluate(sol)
                h, _ = np.histogram(sol, eD_bins, (eD_lo, eD_hi),
                                    weights=w)
                data_hist[i] += h
            s_hist = np.sum(data_hist * eD_binSize * x_binSize)
            if s_hist <= 0:
                return -np.inf
            data_hist /= s_hist
            e0mean = float(np.mean(ez))
            draw2d = np.rint(data_hist * N_DRAWS).astype(int)
            tofs, tofWs = [], []
            for idx, weight in np.ndenumerate(draw2d):
                cell = x_centers[idx[0]]
                eff = (e0mean + eD_centers[idx[1]]) / 2
                tof_d = getTOF(masses.deuteron, eff, cell)
                ndist = L - cell + standoffs[run]
                tof_n = getTOF(masses.neutron, eN_centers[idx[1]], ndist)
                zt, zw = zd[idx[1]]
                tofs.append(tof_d + tof_n + zt)
                tofWs.append(weight * zw)
            tof_hist, _ = np.histogram(tofs, nb, (lo, hi), weights=tofWs,
                                       density=True)
            model = theta[4 + run] * beamTiming.applySpreading(tof_hist)

            ll = 0.0
            if LIKELIHOOD == "poisson":
                # correct Poisson logpmf, exactly mirroring
                # ops.likelihoods.poisson_logpmf_loglike (incl. the
                # 1e-3-count rate floor for hard-zero MC tail bins)
                for b in range(nb):
                    o, m = obs[b], max(model[b], 1e-3)
                    ll += o * np.log(m) - m - gammaln(o + 1.0)
            else:
                for b in range(nb):
                    o = obs[b] if obs[b] != 0 else 1.0
                    m = model[b] if model[b] != 0 else 1.0
                    p = -o - gammaln(int(m) + 1)
                    if m > 0:
                        p += m * np.log(o)
                    ll += o * p
            if np.isnan(ll):
                return -np.inf
            total += ll
        return total

    return lnprob


def numpy_stretch_sampler(rng, logp, p0, n_steps, a=2.0, label="",
                          lp0=None):
    """Independent Goodman-Weare stretch sampler (emcee semantics; same
    implementation as tests/test_sampler_parity.py's oracle).  ``lp0``
    carries retained log-probs across phases — matching our sampler's
    continued EnsembleState (re-evaluating would hand the sticky
    pseudo-marginal chain a free refresh at the phase boundary)."""
    pos = np.array(p0, dtype=np.float64)
    n_walkers, n_dim = pos.shape
    lp = (np.array([logp(x) for x in pos]) if lp0 is None
          else np.array(lp0, dtype=np.float64))
    chain = np.empty((n_steps, n_walkers, n_dim))
    lps = np.empty((n_steps, n_walkers))
    n_acc = 0
    t0 = time.time()
    for step in range(n_steps):
        for parity in (0, 1):
            active_idx = np.arange(parity, n_walkers, 2)
            passive_idx = np.arange(1 - parity, n_walkers, 2)
            nh = len(active_idx)
            z = ((a - 1.0) * rng.random(nh) + 1.0) ** 2 / a
            partners = pos[rng.choice(passive_idx, nh)]
            prop = partners + z[:, None] * (pos[active_idx] - partners)
            lp_prop = np.array([logp(x) for x in prop])
            log_ratio = (n_dim - 1) * np.log(z) + lp_prop - lp[active_idx]
            acc = np.log(rng.random(nh)) < log_ratio
            pos[active_idx[acc]] = prop[acc]
            lp[active_idx[acc]] = lp_prop[acc]
            n_acc += acc.sum()
        chain[step] = pos
        lps[step] = lp
        if (step + 1) % 5 == 0:
            rate = (step + 1) * n_walkers / (time.time() - t0)
            print(f"{label}step {step + 1}/{n_steps} "
                  f"({rate:.2f} walker-steps/s)", flush=True)
    return chain, lps, n_acc / (n_steps * n_walkers)


def _initial_walkers(rng, observed):
    """The reference's own init (tests/simultFit.py:679-684), identically
    for both samplers.  NOTE on mixing: this pseudo-marginal estimator's
    logp noise makes ensemble acceptance decay as the ensemble tightens
    (record statistics of the per-eval noise); both samplers share the
    estimator so the comparison stays apples-to-apples, but median
    standard errors are large there — report() prints an ADVISORY
    verdict only (no hard gate); the sharp comparison is the
    PARITY_LIKELIHOOD=poisson mode (see module docstring)."""
    guesses = np.concatenate([TRUTH[:4],
                              [float(np.sum(o)) for o in observed]])
    agit = np.concatenate([[10.0, 50.0, 20.0, 0.1], 0.15 * guesses[4:]])
    return guesses + agit * rng.standard_normal((N_WALKERS, 4 + N_RUNS))


def prepare():
    os.makedirs(OUT, exist_ok=True)
    sys.path.insert(0, REPO)
    import jax
    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.utils import data_io
    spec = simult.default_spec(n_samples=200_000)
    problem = simult.SimultFitProblem(spec, n_runs=N_RUNS)
    observed = data_io.synthesize_observed(jax.random.PRNGKey(99), problem,
                                           TRUTH)
    np.savez(os.path.join(OUT, "observed.npz"),
             **{f"run{i}": np.asarray(o) for i, o in enumerate(observed)})
    print("observed data written:", [int(np.sum(o)) for o in observed])


def _load_observed():
    d = np.load(os.path.join(OUT, "observed.npz"))
    return [d[f"run{i}"].astype(float) for i in range(N_RUNS)]


def run_reference():
    observed = _load_observed()
    ref = _load_reference_modules()
    lnprob = make_reference_lnprob(ref, observed)
    rng = np.random.default_rng(7)
    p0 = _initial_walkers(rng, observed)
    t0 = time.time()
    _burn, _blps, acc_b = numpy_stretch_sampler(rng, lnprob, p0, N_BURNIN,
                                                label="ref burn-in: ")
    chain, lps, acc = numpy_stretch_sampler(rng, lnprob, _burn[-1], N_MAIN,
                                            label="ref main: ",
                                            lp0=_blps[-1])
    np.savez(os.path.join(OUT, "reference_chain.npz"), chain=chain,
             lps=lps, acc=acc, elapsed=time.time() - t0)
    print(f"reference done in {time.time() - t0:.0f}s, acc={acc:.2f}")


def run_reference_extend():
    """Continue the stored reference chain by PARITY_EXTEND more steps.

    The 4-run joint posterior is tighter than the 2-run study's (ref
    acc 0.19 vs 0.40), so the trimmed 120-step main chain left the
    reference ensemble visibly under-decorrelated (beamE ref sigma
    0.687 vs ours 7.35 — a frozen-ensemble artifact).  RNG state is not
    stored; a fresh seeded generator is statistically equivalent for
    chain continuation."""
    n_extend = int(os.environ.get("PARITY_EXTEND", "60"))
    observed = _load_observed()
    ref = _load_reference_modules()
    lnprob = make_reference_lnprob(ref, observed)
    d = np.load(os.path.join(OUT, "reference_chain.npz"))
    chain, lps = d["chain"], d["lps"]
    rng = np.random.default_rng(1007 + chain.shape[0])
    t0 = time.time()
    ext, elps, acc = numpy_stretch_sampler(rng, lnprob, chain[-1], n_extend,
                                           label="ref extend: ",
                                           lp0=lps[-1])
    np.savez(os.path.join(OUT, "reference_chain.npz"),
             chain=np.concatenate([chain, ext]),
             lps=np.concatenate([lps, elps]), acc=acc,
             elapsed=float(d["elapsed"]) + time.time() - t0)
    print(f"reference extended to {chain.shape[0] + n_extend} steps "
          f"in {time.time() - t0:.0f}s, acc={acc:.2f}")


def run_ours():
    _seed_from_base()
    observed = _load_observed()
    sys.path.insert(0, REPO)
    import jax
    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp
    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                            run_mcmc)
    spec = simult.default_spec(n_samples=N_DRAWS, sampling=SAMPLING)
    if CLOSURE != "exact":
        import dataclasses
        spec = dataclasses.replace(spec, moment_closure=CLOSURE)
    problem = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                      likelihood=LIKELIHOOD)
    logp = problem.make_log_prob_fn(observed)
    lb = make_logp_batch(logp)
    rng = np.random.default_rng(17)
    p0 = jnp.asarray(_initial_walkers(rng, observed), jnp.float32)
    t0 = time.time()
    state = init_state(jax.random.PRNGKey(3), p0, lb)
    state = run_mcmc(state, N_BURNIN, lb).state
    chain = run_mcmc(state, N_MAIN, lb)
    np.savez(os.path.join(OUT, "ours_chain.npz"),
             chain=np.asarray(chain.positions),
             lps=np.asarray(chain.log_probs),
             acc=float(chain.acceptance_fraction.mean()),
             elapsed=time.time() - t0)
    print(f"ours done in {time.time() - t0:.0f}s, "
          f"acc={float(chain.acceptance_fraction.mean()):.2f}")


def _median_se(walker_chain):
    """Standard error of the median of an autocorrelated ensemble chain.

    walker_chain: (S, W) one parameter.  ESS = S * W / tau with tau the
    ensemble-mean integrated autocorrelation time (the package's own
    estimator); SE(median) ~ 1.2533 * sigma / sqrt(ESS) (the asymptotic
    normal-median factor).  This is what makes the finite-chain
    comparison fair: a frozen ensemble (tiny sigma, huge tau) gets a
    LARGE median SE instead of feigning precision."""
    sys.path.insert(0, REPO)
    from mcmctoffitting_tpu.utils.diagnostics import \
        integrated_autocorr_time
    s, w = walker_chain.shape
    tau = float(integrated_autocorr_time(
        walker_chain[:, :, None]).max())
    ess = s * w / max(tau, 1.0)
    q = np.percentile(walker_chain.reshape(-1), [16, 84])
    sigma = 0.5 * (q[1] - q[0])
    return 1.2533 * sigma / np.sqrt(max(ess, 1.0)), ess


def report():
    ref = np.load(os.path.join(OUT, "reference_chain.npz"))
    ours = np.load(os.path.join(OUT, "ours_chain.npz"))
    n_main_ref = ref["chain"].shape[0]
    lines = [f"Posterior parity [{LIKELIHOOD}, ours={SAMPLING}], "
             f"{N_RUNS} runs x "
             f"{N_WALKERS} walkers x {n_main_ref} main steps, shared data",
             f"reference: {float(ref['elapsed']):.0f}s "
             f"acc={float(ref['acc']):.2f} | ours: "
             f"{float(ours['elapsed']):.0f}s acc={float(ours['acc']):.2f}",
             f"{'param':>6} {'ref med':>11} {'ref sig':>9} "
             f"{'ours med':>11} {'ours sig':>9} {'dz':>6} {'z_se':>6}"]
    burn = N_MAIN // 4
    rch = ref["chain"][burn:]
    och = ours["chain"][burn:]
    rflat = rch.reshape(-1, 4 + N_RUNS)
    oflat = och.reshape(-1, 4 + N_RUNS)
    worst = 0.0
    worst_se = 0.0
    ess_min = np.inf
    for d, name in enumerate(PARAM_NAMES[: 4 + N_RUNS]):
        rq = np.percentile(rflat[:, d], [16, 50, 84])
        oq = np.percentile(oflat[:, d], [16, 50, 84])
        rs = 0.5 * (rq[2] - rq[0])
        os_ = 0.5 * (oq[2] - oq[0])
        pooled = np.sqrt(0.5 * (rs ** 2 + os_ ** 2))
        dz = (oq[1] - rq[1]) / pooled if pooled > 0 else np.inf
        worst = max(worst, abs(dz))
        # finite-chain-aware statistic: medians differ by how many of
        # their own standard errors (tau-corrected on both sides)
        se_r, ess_r = _median_se(rch[:, :, d])
        se_o, ess_o = _median_se(och[:, :, d])
        ess_min = min(ess_min, ess_r, ess_o)
        z_se = (oq[1] - rq[1]) / np.sqrt(se_r ** 2 + se_o ** 2)
        worst_se = max(worst_se, abs(z_se))
        lines.append(f"{name:>6} {rq[1]:11.4g} {rs:9.3g} "
                     f"{oq[1]:11.4g} {os_:9.3g} {dz:6.2f} {z_se:6.2f}")
    verdict = "PASS" if worst < 1.0 else "REVIEW"
    verdict_se = "PASS" if worst_se < 3.0 else "REVIEW"
    lines.append(f"worst |dz| = {worst:.2f} "
                 "(medians in pooled posterior-sigma units) -> "
                 f"{verdict} (advisory threshold 1.0; under the faithful "
                 "sawtooth likelihood the frozen-ensemble sigmas make dz "
                 "overly strict — see README "Statistical findings")")
    lines.append(f"worst |z_se| = {worst_se:.2f} "
                 f"(median-difference / tau-corrected median SEs; "
                 f"min per-param ESS {ess_min:.0f}) -> {verdict_se} "
                 "(threshold 3.0: the location test that stays "
                 "calibrated when either finite chain is "
                 "under-decorrelated)")
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(OUT, "report.txt"), "w") as f:
        f.write(text + "\n")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"worst_dz": worst, "worst_z_se": worst_se,
                   "min_ess": float(ess_min), "main_steps": int(n_main_ref),
                   "sampling": SAMPLING}, f)


if __name__ == "__main__":
    phase = sys.argv[1] if len(sys.argv) > 1 else "report"
    {"prepare": prepare, "reference": run_reference,
     "reference-extend": run_reference_extend, "ours": run_ours,
     "report": report}[phase]()
