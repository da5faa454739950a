"""Benchmark: simultFit ensemble walker-steps/sec on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device": {"platform", "kind", "count"}, ...}.  Exits non-zero, printing
no result, when JAX finds no GPU.

Workload = the reference's headline configuration (BASELINE.md): the
simultFit joint fit with 256 walkers x 9 params, 4 standoff runs and 200k
Monte-Carlo draws per likelihood eval (``tests/simultFit.py:52-54,673``).
We time full stretch-move ensemble steps (each = 2 half-steps = 256 lnprob
evals, each lnprob = 4 forward models of 200k transported samples).

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is the reference's own lnprob evaluated on this machine's CPU
(methodology + measured value in BASELINE_MEASURED.json; re-measured here
live when the file is absent and the reference tree is available).
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# 256 = the reference flagship default; BENCH_WALKERS sweeps ensemble size
N_WALKERS = int(os.environ.get("BENCH_WALKERS", "256"))
N_RUNS = 4
N_DRAWS = 200_000
# Segment length for the timed program: long enough to amortize the
# per-dispatch host overhead.  Production runs 50-100+-step segments.
N_STEPS_MEASURE = int(os.environ.get("BENCH_SEGMENT_STEPS", "200"))
# lnprob evals per vmap block (memory cap); overridable for chunk sweeps.
# Per-mode defaults: the per-sample mc path holds O(n_samples)
# intermediates per walker and is capped at 64; counts/expected
# per-walker state is O(F), so the full 128-walker half-batch vmaps
# directly.  Neither value is measured on the H100 yet.
WALKER_CHUNK = os.environ.get("BENCH_WALKER_CHUNK", "")
# forward-model grid strategy A/B knob ('e0grid' default | 'taylor'
# literal path); see ForwardSpec.xs_mode
XS_MODE = os.environ.get("BENCH_XS_MODE", "e0grid")
# 'mc' (faithful per-sample pseudo-marginal) | 'counts' (Poissonized
# Rao-Blackwell MC: same unbiased estimator, equal-or-lower per-eval noise,
# O(F) cost — the recommended production MC mode) |
# 'expected' (closed-form limit).  Unset: measure counts (headline) AND
# mc (faithful secondary) in one invocation.
SAMPLING = os.environ.get("BENCH_SAMPLING", "")
# shard the walker axis over this many devices (0 = all visible); on a
# single-chip host this is a no-op, so the knob is always safe to set
MESH = int(os.environ.get("BENCH_MESH", "0"))
# PRNG implementation A/B ('threefry2x32' default | 'rbg', JAX's
# alternative generator)
PRNG = os.environ.get("BENCH_PRNG", "")
# within-cell moment closure A/B ('exact' default | 'cell' = 2-row ndtr
# chain + analytic h^2/12 closure; ForwardSpec.moment_closure)
CLOSURE = os.environ.get("BENCH_CLOSURE", "")
# ensemble proposal A/B ('de' default | 'stretch' | 'mixed').  'de' is
# the CLI default: tau_max 39.4 vs stretch's 126.6 at equal
# per-step device cost on the corrected-likelihood flagship (3.2x ESS
# per step, artifacts/move_ess_ab.json); per-step rate is move-
# insensitive (+-3% measured), so the headline stays comparable
MOVE = os.environ.get("BENCH_MOVE", "")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _setup(sampling: str, likelihood: str | None = None):
    """Shared problem/evaluator/initial-state construction (all knobs)."""
    import jax
    import numpy as np

    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    if PRNG:
        jax.config.update("jax_default_prng_impl", PRNG)

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.sampler import init_state, make_logp_batch
    from mcmctoffitting_tpu.utils import data_io

    # "" -> per-mode default; 0 -> unchunked (matching BENCH_MESH=0 = all)
    walker_chunk = (64 if sampling == "mc" else None)
    if WALKER_CHUNK:
        walker_chunk = int(WALKER_CHUNK) or None

    spec = simult.default_spec(n_samples=N_DRAWS, xs_mode=XS_MODE,
                               sampling=sampling)
    if CLOSURE:
        import dataclasses
        spec = dataclasses.replace(spec, moment_closure=CLOSURE)
    hist_chunk = int(os.environ.get("BENCH_HIST_CHUNK", "0"))
    if hist_chunk:
        import dataclasses
        spec = dataclasses.replace(spec, histogram_chunk=hist_chunk)
    # radix-factorized TOF-synthesis one-hot (ForwardSpec.tof_hist_radix)
    tof_radix = int(os.environ.get("BENCH_TOF_RADIX", "0"))
    if tof_radix:
        import dataclasses
        spec = dataclasses.replace(spec, tof_hist_radix=tof_radix)
    # run-axis A/B (ForwardSpec.run_axis: 'sequential' preset default /
    # 'batched'); unset, apply the CLI's auto policy (cli/_driver.
    # resolve_run_axis) so the headline measures what the production
    # driver actually runs — batched at <= 512 walkers/device in counts
    # mode, sequential above
    run_axis = os.environ.get("BENCH_RUN_AXIS", "")
    if run_axis:
        import dataclasses
        spec = dataclasses.replace(spec, run_axis=run_axis)
    elif sampling == "counts":
        import dataclasses
        from mcmctoffitting_tpu.cli._driver import RUN_AXIS_CROSSOVER_WALKERS
        n_dev = MESH or len(jax.devices())
        axis = ("batched" if N_WALKERS / max(1, n_dev)
                <= RUN_AXIS_CROSSOVER_WALKERS else "sequential")
        spec = dataclasses.replace(spec, run_axis=axis)
    fine = int(os.environ.get("BENCH_FINE", "0"))
    if fine and spec.xs_mode == "e0grid":
        import dataclasses
        from mcmctoffitting_tpu.ops.e0grid import cached_e0_grid_table
        from mcmctoffitting_tpu.ops.xs import ddn_xs_uniform
        spec = dataclasses.replace(
            spec, e0_grid_fine=fine,
            e0_grid_table=cached_e0_grid_table(
                spec.stopping_table, spec.ed_binning, ddn_xs_uniform, fine))
    problem = (simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood)
               if likelihood else
               simult.SimultFitProblem(spec, n_runs=N_RUNS))
    key = jax.random.PRNGKey(0)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    # observed-data synthesis needs jax.random.poisson (threefry-only);
    # only the TIMED sampling path below runs under BENCH_PRNG
    synth_key = jax.random.key(0, impl="threefry2x32")
    observed = data_io.synthesize_observed(jax.random.fold_in(synth_key, 9),
                                           problem, truth)
    logp = problem.make_log_prob_fn(observed)
    devices = jax.devices()
    if MESH:
        devices = devices[:MESH]
    if len(devices) > 1:
        from mcmctoffitting_tpu.parallel import (make_mesh,
                                                 make_sharded_logp_batch)
        logp_batch = make_sharded_logp_batch(
            logp, make_mesh(devices), chunk=walker_chunk)
        _log(f"bench: walker axis sharded over {len(devices)} devices")
    else:
        logp_batch = make_logp_batch(logp, chunk=walker_chunk)
    p0 = problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 1), N_WALKERS, observed)

    _log(f"bench: init {N_WALKERS} walkers x {N_RUNS} runs x {N_DRAWS} draws")
    state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
    jax.block_until_ready(state.log_probs)
    return spec, logp_batch, state, len(devices)


def measure_segment(sampling: str = "counts") -> tuple[float, int]:
    """(walker-steps/s over the best of two timed segments, devices)."""
    import jax

    from mcmctoffitting_tpu.sampler import run_mcmc

    _, logp_batch, state, n_devices = _setup(sampling)
    n_steps = N_STEPS_MEASURE

    def segment(s):
        chain = run_mcmc(s, n_steps, logp_batch,
                         move=MOVE or "de")
        return chain.positions, chain.state  # pytree outputs only

    _log("bench: compiling the segment program")
    compiled = jax.jit(segment).lower(state).compile()

    _log("bench: warm-up segment")
    positions, state = compiled(state)
    jax.block_until_ready(positions)

    _log("bench: measuring (best of 2 segments)")
    best_dt = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        positions, state = compiled(state)
        jax.block_until_ready(positions)
        dt = time.perf_counter() - t0
        _log(f"bench: segment {rep}: {n_steps} steps in {dt:.2f}s")
        best_dt = min(best_dt, dt)
    return n_steps * N_WALKERS / best_dt, n_devices


def measure_full_fit(sampling: str) -> dict:
    """Time-to-posterior metrics.

    * ``full_fit_wall_s``: warm wall clock of the reference-default FULL
      fit — 400 burn-in + 100 main steps at the flagship workload — run
      as 100-step scan segments (one compiled program, production shape).
    * ``ess_per_sec`` / ``ess_tau_max_steps`` / ``ess_s_over_tau``: a
      SEPARATE chain under the corrected Poisson likelihood
      (``ess_likelihood`` in the JSON) is equilibrated 400 steps and
      continued in 100-step segments UNTIL the accumulated sample count
      satisfies S >= 20 * tau_max(S) (the autocorrelation estimator is
      only trustworthy at S >> tau) or a wall-clock cap is hit
      (BENCH_TAU_WALL_S, default 900 s).  The corrected likelihood is
      the only flagship chain with a STATIONARY ESS: under the faithful
      sawtooth the ensemble's acceptance decays toward zero as it
      tightens and tau grows linearly with S (measured S/tau pinned at
      ~9.7 from 2k to 17k steps) — there is no number to converge
      to, which is also why the move-family A/B runs on the corrected
      chain (tools/move_ess_ab.py).  ESS/s = W * S / (tau_max * wall),
      with the achieved S/tau in the JSON; ``ess_converged`` records a
      cap-limited estimate.
    """
    import jax
    import numpy as np

    from mcmctoffitting_tpu.sampler import run_mcmc
    from mcmctoffitting_tpu.utils.diagnostics import \
        integrated_autocorr_time

    _, logp_batch, state, _ = _setup(sampling)

    def segment(s):
        return run_mcmc(s, 100, logp_batch, move=MOVE or "de")

    _log(f"bench[{sampling}]: compiling the 100-step full-fit segment")
    compiled = jax.jit(segment).lower(state).compile()

    # warm full fit: 4 burn-in segments + 1 main segment, timed end to end
    t0 = time.perf_counter()
    st = state
    for _ in range(4):
        st = compiled(st).state
    main = compiled(st)
    jax.block_until_ready(main.positions)
    full_fit_wall = time.perf_counter() - t0
    _log(f"bench[{sampling}]: warm 400+100 full fit in "
         f"{full_fit_wall:.2f}s")

    # mixing continuation on the corrected-likelihood chain (the only
    # stationary one — see docstring): equilibrate 400 steps, then run
    # until the tau estimate is self-consistently converged
    # (S >= 20 tau) or the wall cap is hit
    _, logp_batch_p, state_p, _ = _setup(sampling, likelihood="poisson")

    def segment_p(s):
        return run_mcmc(s, 100, logp_batch_p, move=MOVE or "de")

    compiled_p = jax.jit(segment_p).lower(state_p).compile()
    st = state_p
    for _ in range(4):
        st = compiled_p(st).state
    jax.block_until_ready(st.positions)
    wall_cap = float(os.environ.get("BENCH_TAU_WALL_S", "900"))
    t0 = time.perf_counter()
    hist = []
    tau_max, s_tau, converged = float("inf"), 0, False
    while True:
        for _ in range(4):            # 400 steps between tau checks
            ch = compiled_p(st)
            hist.append(ch.positions)
            st = ch.state
        jax.block_until_ready(st.positions)
        tau_wall = time.perf_counter() - t0
        pos = np.concatenate([np.asarray(h) for h in hist])  # (S, W, D)
        s_tau = pos.shape[0]
        tau_max = float(integrated_autocorr_time(pos).max())
        converged = s_tau >= 20.0 * tau_max
        _log(f"bench[{sampling}]: tau_max {tau_max:.1f} over {s_tau} "
             f"steps (S/tau {s_tau / tau_max:.1f}, {tau_wall:.0f}s)")
        if converged or tau_wall > wall_cap:
            break
    n_w = pos.shape[1]
    ess_per_sec = n_w * s_tau / (tau_max * tau_wall)
    if not converged:
        _log(f"bench[{sampling}]: WALL CAP hit before S >= 20 tau — "
             "ess_per_sec is an under-sampled estimate")
    return {"full_fit_wall_s": round(full_fit_wall, 2),
            "ess_per_sec": round(ess_per_sec, 2),
            "ess_tau_max_steps": round(tau_max, 1),
            "ess_s_over_tau": round(s_tau / tau_max, 1),
            "ess_converged": converged,
            "ess_likelihood": "poisson"}


def reference_baseline() -> float | None:
    """walker-steps/sec equivalent of the reference on CPU.

    One reference lnprob (4 runs x 200k draws) == one walker-step's worth of
    likelihood work; reference rate = n_threads_effective / t_lnprob, at
    the reference's default 3 threads (``tests/simultFit.py:46``).  The
    value and its methodology are in BASELINE_MEASURED.json.
    """
    path = os.path.join(REPO, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["walker_steps_per_sec_3threads"]


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: no GPU (JAX backend {jax.default_backend()!r}); "
                 "nothing measured")
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    headline = SAMPLING or "counts"
    value, n_dev = measure_segment(headline)
    baseline = reference_baseline()
    out = {
        "metric": "simultFit_walker_steps_per_sec",
        "value": round(value, 3),
        "unit": (f"walker-steps/s ({N_WALKERS} walkers, {N_RUNS} runs, "
                 "200k draws/eval)"),
        "vs_baseline": round(value / baseline, 2) if baseline else None,
        "sampling": headline,
        "n_devices": n_dev,
        "device": device,
    }
    if MOVE:
        out["move"] = MOVE
    # time-to-posterior metrics (warm full-fit wall clock + ESS/s);
    # BENCH_FULLFIT=0 opts out for quick sweep invocations
    with_fullfit = os.environ.get("BENCH_FULLFIT", "1") != "0"
    if with_fullfit:
        out.update(measure_full_fit(headline))
    if not SAMPLING:
        # also record the faithful per-sample path (the reference-literal
        # estimator): step rate AND time-to-posterior
        mc_value, _ = measure_segment("mc")
        out["faithful_mc_walker_steps_per_sec"] = round(mc_value, 3)
        out["faithful_mc_vs_baseline"] = (round(mc_value / baseline, 2)
                                          if baseline else None)
        if with_fullfit:
            out.update({f"faithful_mc_{k}": v for k, v in
                        measure_full_fit("mc").items()})
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
