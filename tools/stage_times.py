"""Stage timings on the GPU: TOF-synthesis histogram paths, the counts-mode
Poisson stage, the A-contraction precision, and the TOF path's end-to-end
effect on the simult counts fit.

Run on a machine with one GPU:  ``python tools/stage_times.py``
Writes ``chiprun_out/stage_times.json`` (and a profiler trace of the
Poisson stage under ``chiprun_out/trace_poisson``) and prints one line per
measurement.  Device times are host-clock times of jitted programs that
repeat the stage ``REPS`` times inside one dispatch (``lax.fori_loop``
with a carried dependence, so nothing is hoisted), divided by ``REPS``;
the best of three dispatches is kept.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "chiprun_out")
REPS = 50
W = 128                       # half of the 256-walker reference ensemble
E2E_STEPS = 100               # steps per timed segment of the fit


def log(msg):
    print(msg, flush=True)


def timed_reps(fn, *args, reps=REPS):
    """Per-call device time of ``fn(*args)`` (one output array)."""
    import jax
    import jax.numpy as jnp

    def loop(*a):
        def body(i, acc):
            # a carried, numerically-null dependence defeats hoisting
            bump = acc * 1e-30
            out = fn(a[0] + bump, *a[1:])
            return jnp.sum(out).astype(jnp.float32)
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    run = jax.jit(loop)
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        best = min(best, time.perf_counter() - t0)
    return best / reps, compile_s


def tof_inputs(problem, n_walkers):
    """Real lattices (per-walker jittered e0 mean) and real draw grids."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models import forward

    spec = problem.spec
    keys = jax.random.split(jax.random.PRNGKey(0), n_walkers)
    theta = np.asarray(problem.guess_theta(
        [np.full(w.n_bins, 100.0) for w in problem.windows]), np.float32)
    params = problem.shared_params(jnp.asarray(theta))
    grid, e0m = forward.grid_and_mean(
        dataclasses.replace(spec, sampling="expected", xs_mode="e0grid"),
        params, keys[0])
    area = spec.ed_binning.width * spec.x_binning.width
    draws1 = jnp.rint(grid / (jnp.sum(grid) * area) * spec.n_samples)
    jit = jax.random.normal(keys[1], (n_walkers,)) * 2.0
    base = jnp.stack([
        jax.vmap(lambda d: forward.cell_tof_lattice(spec, so, e0m + d))(jit)
        for so in problem.standoffs], axis=1)             # (W, R, M, Be)
    draws = jnp.broadcast_to(draws1, base.shape)
    zt, zw = forward._tof_spread(spec)
    return spec, base, draws, zt, zw


def scatter_hist(spec, base, draws, zt, zw, windows):
    """XLA scatter-add variant of the same stage (same index math)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    n_runs = base.shape[-3]
    v = (base[..., None] + zt).reshape(n_runs, -1)
    w_ = (draws[..., None] * zw).reshape(n_runs, -1)
    n_pad = max(w.n_bins for w in windows)
    los = np.asarray([w.lo for w in windows], np.float32)[:, None]
    his = np.asarray([w.hi for w in windows], np.float32)[:, None]
    sc = np.asarray([w.n_bins / (w.hi - w.lo) for w in windows],
                    np.float32)[:, None]
    nb1 = np.asarray([w.n_bins - 1 for w in windows], np.int32)[:, None]
    idx = jnp.minimum(jnp.clip(jnp.floor((v - los) * sc).astype(jnp.int32),
                               0, n_pad - 1), nb1)
    w_ = jnp.where((v >= los) & (v <= his), w_, 0.0)
    return jax.vmap(lambda i, x: jnp.zeros(n_pad, jnp.float32)
                    .at[i].add(x))(idx, w_)


def tof_stage(results):
    import jax
    import numpy as np

    from mcmctoffitting_tpu.models import forward, onebd, simult
    from mcmctoffitting_tpu.ops.reference_np import tof_hist_np

    cells = {
        "simult": simult.SimultFitProblem(simult.default_spec()),
        "onebd": onebd.OneBDProblem(onebd.default_spec()),
        "onebd_hardcore": onebd.OneBDProblem(
            onebd.default_spec(hardcore=True)),
    }
    for name, prob in cells.items():
        spec, base, draws, zt, zw = tof_inputs(prob, W)
        wins = prob.windows
        paths = {
            "xla": forward.tof_histogram_xla,
            "kernel": forward.tof_histogram_kernel,
            "scatter": scatter_hist,
        }
        oracle = tof_hist_np(np.asarray(base[3]), np.asarray(draws[3]),
                             np.asarray(zt), np.asarray(zw), wins)
        for pname, fn in paths.items():
            stage = jax.vmap(lambda b, d, fn=fn: fn(spec, b, d, zt, zw,
                                                    wins))
            key = f"tof_{name}_{pname}"
            try:
                out = np.asarray(jax.jit(stage)(base, draws))
                err = float(np.abs(out[3] - oracle).max()
                            / np.abs(oracle).max())
                dt, comp = timed_reps(stage, base, draws)
                results[key] = {"us_per_call": dt * 1e6, "compile_s": comp,
                                "max_rel_err_vs_f64": err,
                                "shape": list(base.shape)}
                log(f"{key}: {dt * 1e6:.2f} us/call (W={W}, "
                    f"R={base.shape[1]}, lattice {base.shape[2]}x"
                    f"{base.shape[3]}, K={zt.shape[1]}), max rel err vs "
                    f"f64 {err:.3g}, compile {comp:.1f} s")
            except Exception as e:       # report and go on to the next
                results[key] = {"error": f"{type(e).__name__}: {e}"[:2000]}
                log(f"{key}: FAILED {type(e).__name__}: {str(e)[:1500]}")


def tof_kernel_sweep(results):
    """Partial-sum block size x warps of the TOF kernel."""
    import jax

    from mcmctoffitting_tpu.models import onebd, simult
    from mcmctoffitting_tpu.ops import pallas_tof

    best = {}
    tile = pallas_tof._tile
    for name, prob in (
            ("simult", simult.SimultFitProblem(simult.default_spec())),
            ("onebd_hardcore", onebd.OneBDProblem(
                onebd.default_spec(hardcore=True)))):
        spec, base, draws, zt, zw = tof_inputs(prob, W)
        for acc in (2048, 4096, 8192, 16384):
            for nw in (2, 4, 8):
                # the kernel's block sizing, patched for this point
                pallas_tof._tile = (lambda nb, acc=acc, nw=nw:
                                    (max(16, acc // nb), nw))
                pallas_tof.make_tof_hist_segments.cache_clear()
                fn = pallas_tof.make_tof_hist_segments(
                    tuple(prob.windows), base.shape[-2], base.shape[-1],
                    zt.shape[-1])
                stage = jax.vmap(lambda b, d, fn=fn: fn(b, d, zt, zw))
                key = f"tof_sweep_{name}_acc{acc}_w{nw}"
                try:
                    dt, _ = timed_reps(stage, base, draws)
                    results[key] = dt * 1e6
                    log(f"{key}: {dt * 1e6:.2f} us/call")
                    if dt < best.get(name, (float("inf"),))[0]:
                        best[name] = (dt, acc, nw)
                except Exception as e:
                    results[key] = f"{type(e).__name__}: {e}"[:500]
                    log(f"{key}: FAILED {str(e)[:300]}")
    pallas_tof._tile = tile
    pallas_tof.make_tof_hist_segments.cache_clear()
    results["tof_sweep_best"] = {k: [v[0] * 1e6, v[1], v[2]]
                                 for k, v in best.items()}
    log(f"tof kernel sweep best: {results['tof_sweep_best']}")


def poisson_stage(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.ops.e0grid import expected_moments
    from mcmctoffitting_tpu.ops.poisson import poisson_ptrs

    spec = simult.default_spec(sampling="counts")
    tab = spec.e0_grid_table
    sbar, _ = expected_moments(tab, 1878.4, 850.0, 170.0, 0.5,
                               spec.n_samples, True)
    lam1 = jnp.concatenate([jnp.maximum(sbar[0], 0.0),
                            jnp.asarray([50.0, 5.0])])     # F + 2 = 514
    lam = jnp.broadcast_to(lam1, (W, 4, lam1.shape[0]))
    keys = jax.random.split(jax.random.PRNGKey(1), W * 4).reshape(W, 4, -1)

    def stage(lam, keys):
        return jax.vmap(jax.vmap(poisson_ptrs))(keys, lam)

    dt, comp = timed_reps(lambda l, k: stage(l, k), lam, keys)
    n_lam = int(np.prod(lam.shape))
    results["poisson_counts"] = {
        "us_per_call": dt * 1e6, "compile_s": comp,
        "shape": list(lam.shape),
        "frac_lanes_small": float(np.mean(np.asarray(lam1) < 10.0))}
    log(f"poisson_counts: {dt * 1e6:.2f} us/call for {n_lam} draws "
        f"({list(lam.shape)}), compile {comp:.1f} s")

    # one traced call: the while_loop's rounds and per-round cost
    run = jax.jit(stage)
    jax.block_until_ready(run(lam, keys))
    tdir = os.path.join(OUT, "trace_poisson")
    with jax.profiler.trace(tdir):
        for _ in range(3):
            jax.block_until_ready(run(lam, keys))
    results["poisson_trace"] = summarize_trace(tdir)
    log("poisson trace: " + json.dumps(results["poisson_trace"])[:3000])


def summarize_trace(tdir):
    """Event name -> (count, total us) on the device planes, top 25."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return {"error": "no trace"}
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    agg = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                c, t = agg.get(ev.name, (0, 0.0))
                agg[ev.name] = (c + 1, t + ev.duration_ns / 1e3)
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:25]
    return {k: {"count": c, "total_us": round(t, 3)} for k, (c, t) in top}


def a_contraction_precision(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models import onebd, simult
    from mcmctoffitting_tpu.ops.e0grid import expected_moments

    for name, spec, theta in (
            ("simult_counts", simult.default_spec(sampling="counts"),
             (1878.4, 850.0, 170.0, 0.5)),
            ("onebd_hardcore", onebd.default_spec(hardcore=True,
                                                  sampling="counts"),
             (2490.0, 1300.0, 80.0, 0.6))):
        tab = spec.e0_grid_table
        sc = np.linspace(0.8, 1.2, W, dtype=np.float32)
        mom = jax.vmap(lambda s: expected_moments(
            tab, theta[0], theta[1], theta[2] * s, theta[3],
            spec.n_samples, True)[0])(jnp.asarray(sc))   # (W, 4, F)
        mom = mom.reshape(W, -1)
        a32 = jnp.asarray(tab.a_matrix, jnp.float32)
        ref = np.asarray(mom, np.float64) @ tab.a_matrix.astype(np.float64)
        row = {}
        for prec in ("highest", "tensorfloat32", "default", "bfloat16"):
            p = None if prec == "default" else prec
            got = np.asarray(jax.jit(lambda m, a: jnp.dot(
                m, a, precision=p,
                preferred_element_type=jnp.float32))(mom, a32))
            err = float((np.abs(got - ref).max(axis=1)
                         / np.abs(ref).max(axis=1)).max())
            row[prec] = err
        results[f"a_contraction_{name}"] = row
        log(f"a_contraction {name}: max row-relative err vs f64 " +
            ", ".join(f"{k} {v:.3g}" for k, v in row.items()))


def e2e_counts(results):
    """simult counts fit, 256 walkers, 100-step segments: TOF path A/B."""
    import jax
    import numpy as np

    from mcmctoffitting_tpu.models import forward, simult
    from mcmctoffitting_tpu.sampler import init_state, make_logp_batch, \
        run_mcmc
    from mcmctoffitting_tpu.utils import data_io

    spec = dataclasses.replace(simult.default_spec(sampling="counts"),
                               run_axis="batched")
    prob = simult.SimultFitProblem(spec, likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    obs = data_io.synthesize_observed(jax.random.PRNGKey(9), prob, truth)
    p0 = prob.initial_walkers_from_observed(jax.random.PRNGKey(1), 2 * W,
                                            obs)
    dispatch = forward.tof_histogram
    compiled = {}
    for path, impl in (("xla", forward.tof_histogram_xla),
                       ("kernel", forward.tof_histogram_kernel)):
        forward.tof_histogram = impl
        lb = make_logp_batch(prob.make_log_prob_fn(obs))
        st = init_state(jax.random.PRNGKey(2), p0, lb)
        t0 = time.perf_counter()
        c = jax.jit(lambda s, lb=lb: run_mcmc(s, E2E_STEPS, lb, move="de")
                    ).lower(st).compile()
        comp = time.perf_counter() - t0
        jax.block_until_ready(c(st).positions)
        compiled[path] = (c, st, comp)
    forward.tof_histogram = dispatch
    rates = {"xla": [], "kernel": []}
    for path in ("xla", "kernel", "kernel", "xla", "xla", "kernel"):
        c, st, _ = compiled[path]
        t0 = time.perf_counter()
        ch = c(st)
        jax.block_until_ready(ch.positions)
        rates[path].append(E2E_STEPS * 2 * W / (time.perf_counter() - t0))
        acc = float(np.sum(np.asarray(ch.n_accepted))) / (E2E_STEPS * 2 * W)
        log(f"e2e simult counts [{path}]: {rates[path][-1]:.1f} "
            f"walker-steps/s (acc {acc:.3f})")
    results["e2e_simult_counts"] = {
        k: {"walker_steps_per_s": v, "compile_s": compiled[k][2]}
        for k, v in rates.items()}


def main():
    import jax

    os.makedirs(OUT, exist_ok=True)
    from mcmctoffitting_tpu.utils import compile_cache
    results = {"cache_dir": compile_cache.enable()}
    if jax.default_backend() != "gpu":
        sys.exit("stage_times.py needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    results["nvidia_smi"] = smi
    results["device_kind"] = jax.devices()[0].device_kind
    log(f"{smi} | {jax.devices()[0].device_kind} | jax {jax.__version__}")
    steps = [tof_stage, tof_kernel_sweep, a_contraction_precision,
             poisson_stage, e2e_counts]
    only = sys.argv[1:]
    for step in steps:
        if only and step.__name__ not in only:
            continue
        try:
            step(results)
        except Exception as e:
            import traceback
            traceback.print_exc()
            results[step.__name__ + "_error"] = f"{type(e).__name__}: {e}"
        with open(os.path.join(OUT, "stage_times.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
