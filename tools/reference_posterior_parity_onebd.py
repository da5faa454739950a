"""Posterior parity study for the csi_oneBD flagship (VERDICT r2 item 4).

Same protocol as tools/reference_posterior_parity.py (simultFit), for the
oneBD pipeline: spline-table stopping (betheApprox), cell attenuation,
per-run Poisson background, gaussian beam timing, expo zero-degree kernel.

Reference side: lnprob orchestrated from the REFERENCE'S OWN kernels
(``tests/csi_oneBD.py:415-521`` generateModelData, ``:528-586`` lnlike /
compoundLnlike, ``:590-649`` prior/lnprob), faithful to its quirks:
untruncated draws (the redraw loop is commented out, ``:440-447``), the
in-place zero-observed->1 mutation, density-normalized TOF histograms, and
the post-scale Poisson background draw.  The only change is evaluating the
SAME RectBivariateSpline pointwise over the sample vector instead of a
per-sample Python loop (identical values; the loop would make the study
infeasible).  Sampled with the independent numpy Goodman-Weare stretch
sampler shared with the simult tool.

Env knobs: PARITY_LIKELIHOOD=reference|poisson (default poisson — the
sharp comparison; the faithful sawtooth's noise makes dz advisory),
PARITY_RUNS (default 3), PARITY_DRAWS (default 10000),
PARITY_SAMPLING=mc|counts (OUR side's forward estimator — 'counts'
validates the Poissonized Rao-Blackwell mode against the reference's own
kernels end-to-end).

Usage:
  python tools/reference_posterior_parity_onebd.py prepare
  python tools/reference_posterior_parity_onebd.py reference   # CPU, slow
  python tools/reference_posterior_parity_onebd.py ours
  python tools/reference_posterior_parity_onebd.py report
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_posterior_parity import numpy_stretch_sampler  # noqa: E402

LIKELIHOOD = os.environ.get("PARITY_LIKELIHOOD", "poisson")
SAMPLING = os.environ.get("PARITY_SAMPLING", "mc")
CLOSURE = os.environ.get("PARITY_CLOSURE", "exact")
# background model for BOTH sides: the per-eval Poisson bg draw
# (tests/csi_oneBD.py:521) is itself a major pseudo-marginal noise source
# (it froze both samplers at acc ~ 0.1 in the first study); the sharp
# poisson-likelihood instrument defaults to the deterministic expectation
# (the -deterministicBG production mode), the faithful mode keeps draws
BG_MODE = os.environ.get(
    "PARITY_BG", "expected" if LIKELIHOOD == "poisson" else "poisson")
N_RUNS = int(os.environ.get("PARITY_RUNS", "3"))
N_DRAWS = int(os.environ.get("PARITY_DRAWS", "10000"))
N_WALKERS = 20
N_BURNIN = int(os.environ.get("PARITY_BURNIN", "60"))
N_MAIN = int(os.environ.get("PARITY_MAIN", "200"))

OUT = os.path.join(REPO, "out", "parity_onebd")
if LIKELIHOOD != "poisson":
    OUT += f"_{LIKELIHOOD}"
if SAMPLING != "mc":
    OUT += f"_{SAMPLING}"
if CLOSURE != "exact":
    OUT += f"_{CLOSURE}"
if os.environ.get("PARITY_RUNS") or os.environ.get("PARITY_DRAWS"):
    OUT += f"_r{N_RUNS}_d{N_DRAWS}"

# norms well below the flagship 5e4 so the sawtooth-regime noise stays
# manageable (see the simult tool's notes); bg at the synthesis level 20
TRUTH = np.concatenate([[1300.0, 80.0, 0.6], [5e3] * N_RUNS,
                        [20.0] * N_RUNS])
PARAM_NAMES = (["eLoss", "scale", "s"]
               + [f"N{i + 1}" for i in range(N_RUNS)]
               + [f"BG{i + 1}" for i in range(N_RUNS)])


def _load_reference_modules():
    sys.path.insert(0, REFERENCE)
    import importlib
    return {
        "constants": importlib.import_module("constants.constants"),
        "utilities": importlib.import_module("utilities.utilities"),
        "ionStopping": importlib.import_module("utilities.ionStopping"),
        "initialization": importlib.import_module("initialization"),
    }


def make_reference_forward(ref, rng):
    """(gen_model, windows, standoffs) from the reference's own oneBD
    kernels (``tests/csi_oneBD.py:415-521``)."""
    from scipy.stats import lognorm

    consts = ref["constants"]
    distances, masses = consts.distances, consts.masses
    tofW = consts.tofWindows.csi_oneBD()
    beam_ref_e = consts.experimentConsts.csi_oneBD.beamReferenceEnergy

    init = ref["initialization"].initialize_oneBD
    eD_bins, eD_range, eD_binSize, eD_centers = init.setupDeuteronBinning(100)
    x_bins, x_range, x_binSize, x_centers = init.setupXbinning(10)
    atten = init.getCellAttenuationCoeffs(x_centers)
    eD_lo, eD_hi = eD_range

    ddnXS = ref["utilities"].ddnXSinterpolator()
    ref_np = ref["utilities"].np
    orig_linspace = ref_np.linspace
    ref_np.linspace = lambda a, b, n, *args, **kw: orig_linspace(
        a, b, int(n), *args, **kw)
    try:
        beamTiming = ref["utilities"].beamTimingShape.gaussianTiming(2.7, 4)
    finally:
        ref_np.linspace = orig_linspace
    getTOF = ref["utilities"].getTOF
    getDDn = ref["utilities"].getDDneutronEnergy
    eN_centers = getDDn(eD_centers)

    stopping = ref["ionStopping"].ionStopping.simpleBethe(
        [1, 2, 4 * 8.565e-5, 1, 19.2e-3])
    approx = ref["ionStopping"].ionStopping.betheApprox(
        stopping, (100, 2400, 100), x_centers)
    spline = approx.stoppingSpline

    # zero-degree expo kernel (tests/csi_oneBD.py:406-408)
    zd_centers = np.linspace(0, 24, 7, True)
    zd_vals = np.exp(-zd_centers / 2.0)
    zd_vals /= zd_vals.sum()

    run_names = ["close", "mid", "far"][:N_RUNS]
    standoffs = [getattr(distances.tunlSSA_CsI_oneBD,
                         f"standoff{n.capitalize()}") for n in run_names]
    windows = [(tofW.minRange[n], tofW.maxRange[n], tofW.nBins[n])
               for n in run_names]
    L = distances.tunlSSA_CsI.cellLength  # the reference's own constant

    xx = np.tile(x_centers, N_DRAWS)

    def gen_model(eLoss, scale, s, scaleFactor, bgLevel, standoff, window):
        lo, hi, nb = window
        ez = beam_ref_e - lognorm.rvs(s=s, loc=eLoss, scale=scale,
                                      size=N_DRAWS, random_state=rng)
        # identical spline, pointwise over (sample, x) pairs
        sol = spline(np.repeat(ez, x_bins), xx, grid=False).reshape(
            N_DRAWS, x_bins)
        data_hist = np.zeros((x_bins, eD_bins))
        for i in range(x_bins):
            w = ddnXS.evaluate(sol[:, i]) * atten[i]
            data_hist[i], _ = np.histogram(sol[:, i], eD_bins,
                                           (eD_lo, eD_hi), weights=w)
        e0mean = float(np.mean(ez))
        draw2d = np.rint(data_hist * N_DRAWS).astype(int)
        eff = (e0mean + eD_centers) / 2.0
        tof_d = getTOF(masses.deuteron, eff[None, :], x_centers[:, None])
        ndist = L - x_centers[:, None] + standoff
        tof_n = getTOF(masses.neutron, eN_centers[None, :], ndist)
        tofs = tof_d + tof_n
        hist, _ = np.histogram(tofs.ravel(), nb, (lo, hi),
                               weights=draw2d.ravel().astype(float),
                               density=True)
        hist = np.convolve(hist, zd_vals, "full")[: -len(zd_centers) + 1]
        bg = (bgLevel if BG_MODE == "expected"
              else rng.poisson(bgLevel, nb))
        return scaleFactor * beamTiming.applySpreading(hist) + bg

    return gen_model, windows, standoffs


def make_reference_lnprob(ref, observed, rng):
    """lnprob(theta) from the reference's own oneBD kernels
    (``tests/csi_oneBD.py:528-649``)."""
    from scipy.special import gammaln

    gen_model, windows, standoffs = make_reference_forward(ref, rng)

    lo_b = np.array([200.0, 10.0, 0.05] + [1e3] * N_RUNS + [0.0] * N_RUNS)
    hi_b = np.array([2000.0, 700.0, 3.0] + [1e8] * N_RUNS + [1e3] * N_RUNS)

    # the reference mutates observed zeros to 1 in place on first eval
    # (tests/csi_oneBD.py:558-559); apply once up front
    observed = [np.where(o == 0, 1.0, o) for o in observed]

    def lnprob(theta):
        if np.any(theta < lo_b) or np.any(theta > hi_b):
            return -np.inf
        total = 0.0
        for run in range(N_RUNS):
            model = gen_model(theta[0], theta[1], theta[2], theta[3 + run],
                              theta[3 + N_RUNS + run], standoffs[run],
                              windows[run])
            obs = observed[run]
            nb = windows[run][2]
            ll = 0.0
            if LIKELIHOOD == "poisson":
                for b in range(nb):
                    o, m = obs[b], max(model[b], 1e-3)
                    ll += o * np.log(m) - m - gammaln(o + 1.0)
            else:
                for b in range(nb):
                    if np.isnan(model[b]):
                        return -np.inf
                    o = obs[b]
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


def _initial_walkers(rng, observed):
    """Reference-style init: guesses + agitators (tests/csi_oneBD.py:
    737-752), norm guesses from the observed totals."""
    guesses = np.concatenate([TRUTH[:3],
                              [float(np.sum(o)) for o in observed],
                              [20.0] * N_RUNS])
    agit = np.concatenate([[100.0, 10.0, 0.05], 0.15 * guesses[3:3 + N_RUNS],
                           [5.0] * N_RUNS])
    return guesses + agit * rng.standard_normal((N_WALKERS, 3 + 2 * N_RUNS))


def prepare():
    os.makedirs(OUT, exist_ok=True)
    sys.path.insert(0, REPO)
    import jax
    from mcmctoffitting_tpu.models import onebd
    from mcmctoffitting_tpu.utils import data_io
    spec = onebd.default_spec(n_samples=200_000)
    problem = onebd.OneBDProblem(spec, n_runs=N_RUNS)
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
    rng = np.random.default_rng(7)
    lnprob = make_reference_lnprob(ref, observed, rng)
    p0 = _initial_walkers(rng, observed)
    t0 = time.time()
    burn, blps, _ = numpy_stretch_sampler(rng, lnprob, p0, N_BURNIN,
                                          label="ref burn-in: ")
    chain, lps, acc = numpy_stretch_sampler(rng, lnprob, burn[-1], N_MAIN,
                                            label="ref main: ",
                                            lp0=blps[-1])
    np.savez(os.path.join(OUT, "reference_chain.npz"), chain=chain,
             lps=lps, acc=acc, elapsed=time.time() - t0)
    print(f"reference done in {time.time() - t0:.0f}s, acc={acc:.2f}")


def run_ours():
    observed = _load_observed()
    sys.path.insert(0, REPO)
    import jax
    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp
    from mcmctoffitting_tpu.models import onebd
    from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                            run_mcmc)
    import dataclasses
    spec = onebd.default_spec(n_samples=N_DRAWS, sampling=SAMPLING)
    if BG_MODE == "expected":
        spec = dataclasses.replace(spec, bg_mode="expected")
    if CLOSURE != "exact":
        spec = dataclasses.replace(spec, moment_closure=CLOSURE)
    problem = onebd.OneBDProblem(spec, n_runs=N_RUNS,
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
    print(f"ours[{SAMPLING}] done in {time.time() - t0:.0f}s, "
          f"acc={float(chain.acceptance_fraction.mean()):.2f}")


def forward_compare():
    """Direct forward-model parity: our oneBD tof_spectrum vs the
    reference's own generateModelData at the same theta (truth), averaged
    over keys to suppress MC noise, compared as normalized shapes.

    Localizes any posterior-level disagreement: if the L1 here is at the
    MC-noise floor, the forwards agree and residual dz is sampler
    convergence, not model difference.
    """
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    from mcmctoffitting_tpu.models import onebd
    from mcmctoffitting_tpu.models.forward import tof_spectrum

    ref = _load_reference_modules()
    rng = np.random.default_rng(3)
    gen_model, windows, standoffs = make_reference_forward(ref, rng)
    eLoss, scale, s = TRUTH[:3]
    k_avg = 20

    spec = onebd.default_spec(n_samples=N_DRAWS)
    problem = onebd.OneBDProblem(spec, n_runs=N_RUNS)
    fwd = jax.jit(lambda k: tof_spectrum(
        k, jnp.asarray([2490.0, eLoss, scale, s], jnp.float32), spec,
        problem.standoffs[0], problem.windows[0], get_pdf=True, scale=1.0))

    ref_acc = None
    ours_acc = None
    for i in range(k_avg):
        r = gen_model(eLoss, scale, s, 1.0, 0.0, standoffs[0], windows[0])
        o = np.asarray(fwd(jax.random.PRNGKey(100 + i)))
        ref_acc = r if ref_acc is None else ref_acc + r
        ours_acc = o if ours_acc is None else ours_acc + o
    a = ref_acc / ref_acc.sum()
    b = ours_acc / ours_acc.sum()
    l1 = float(np.abs(a - b).sum())
    print(f"forward shape L1 (ref vs ours, {k_avg}-key avg, "
          f"{N_DRAWS} draws): {l1:.4f}")
    print("per-bin ref:", np.round(a, 4).tolist())
    print("per-bin ours:", np.round(b, 4).tolist())
    with open(os.path.join(OUT, "forward_compare.json"), "w") as f:
        json.dump({"l1": l1, "ref": a.tolist(), "ours": b.tolist()}, f)
    return l1


def report():
    ref = np.load(os.path.join(OUT, "reference_chain.npz"))
    ours = np.load(os.path.join(OUT, "ours_chain.npz"))
    n_dim = 3 + 2 * N_RUNS
    lines = [f"oneBD posterior parity [{LIKELIHOOD}, bg={BG_MODE}, "
             f"ours={SAMPLING}], "
             f"{N_RUNS} runs x {N_WALKERS} walkers x {N_MAIN} main steps, "
             "shared data",
             f"reference: {float(ref['elapsed']):.0f}s "
             f"acc={float(ref['acc']):.2f} | ours: "
             f"{float(ours['elapsed']):.0f}s acc={float(ours['acc']):.2f}",
             f"{'param':>6} {'ref med':>11} {'ref sig':>9} "
             f"{'ours med':>11} {'ours sig':>9} {'dz':>6}"]
    burn = N_MAIN // 4
    rflat = ref["chain"][burn:].reshape(-1, n_dim)
    oflat = ours["chain"][burn:].reshape(-1, n_dim)
    worst = 0.0
    for d, name in enumerate(PARAM_NAMES[:n_dim]):
        rq = np.percentile(rflat[:, d], [16, 50, 84])
        oq = np.percentile(oflat[:, d], [16, 50, 84])
        rs = 0.5 * (rq[2] - rq[0])
        os_ = 0.5 * (oq[2] - oq[0])
        pooled = np.sqrt(0.5 * (rs ** 2 + os_ ** 2))
        dz = (oq[1] - rq[1]) / pooled if pooled > 0 else np.inf
        worst = max(worst, abs(dz))
        lines.append(f"{name:>6} {rq[1]:11.4g} {rs:9.3g} "
                     f"{oq[1]:11.4g} {os_:9.3g} {dz:6.2f}")
    verdict = "PASS" if worst < 1.0 else "REVIEW"
    lines.append(f"worst |dz| = {worst:.2f} "
                 "(medians in pooled posterior-sigma units) -> "
                 f"{verdict} (threshold 1.0)")
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(OUT, "report.txt"), "w") as f:
        f.write(text + "\n")
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"worst_dz": worst, "likelihood": LIKELIHOOD,
                   "sampling": SAMPLING}, f)


if __name__ == "__main__":
    phase = sys.argv[1] if len(sys.argv) > 1 else "report"
    {"prepare": prepare, "reference": run_reference, "ours": run_ours,
     "forward": forward_compare, "report": report}[phase]()
