"""Smoke test of the main path on one GPU, at the flagship's full width.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py          # phases 0-3, one card
    python chip_smoke.py --four   # the four-card sharded path, and only it

Phases (any failure ends the run with a non-zero exit; none is caught):

0. device: nvidia-smi's name and power limit, the JAX version, the device
   kind and the compile-cache directory; fails unless JAX runs on a GPU.
1. stages vs plain references at real widths: the TOF-synthesis histogram
   as the GPU runs it vs an f64 ``np.histogram``; the e0-grid A
   contraction vs f64 (and a TF32 run of it, which must fail the same
   tolerance); the counts-mode Poisson sampler vs scipy's moments.
2. forward vs the f64 host reference (``ops/reference_np.py``) for the
   four flagship configurations: simult mc, simult counts, oneBD default,
   oneBD -hardcore — grid, TOF lattice and spectra at 200k draws.
3. fits through each CLI's ``main()``: simult counts + Poisson
   likelihood, simult faithful mc, oneBD -hardcore counts (256 walkers,
   50 + 50 steps) and NUTS on the expected forward; each chain is read
   back and checked (finite log-probs, acceptance band).

``--four`` runs only the sharded path: the simult counts fit with
``-mesh 4`` vs ``-mesh 1`` (256 walkers, 200k draws, 30 + 30 steps), one
log-prob evaluation sharded vs on one device, and the parallel-tempering
batch sharded vs local (2 temperatures x 256 walkers, 5 steps), plus a
trace of where the sharded evaluation ran and which collectives it used.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke_out")
W = 128                    # half of the 256-walker reference ensemble
W_FWD = 32                 # walkers compared one by one in phase 2

# Tolerances (each against an f64 reference of the same semantics):
# TOF histogram, f32 weights and sums over <= 8192 products per run
TOL_TOF = 1e-5
# A contraction at precision='highest' (f32); a TF32 run of the same
# contraction errs ~1e-2 here (the reconstruction cancels with condition
# ~16), so this tolerance separates the two by orders of magnitude
TOL_A = 5e-5
# grid from raw draws: the one-hot moment dot runs at default precision
# (TF32 channel values on the GPU), amplified ~16x by the reconstruction
TOL_GRID_MC = 2e-3
# TOF lattice: f32 kinematics (sqrt, divisions) vs f64
TOL_LATTICE = 2e-6
# spectra from the same grids and lattices: rint ties at f32 move whole
# draw counts (a few counts ~ 2.5e-4 of a peak bin) plus f32 summation
TOL_SPECTRA = 5e-4
# sharded vs one-device log-probs of the same walker at the same point
# and key: the same evaluation on another device layout, apart only by
# f32 reassociation of the likelihood's sums of ~230 per-bin terms of up
# to ~5e4: 1.0e-4 to 3.1e-4 measured on four H100s (two fits, one
# evaluation under three key sets, the PT batch).  Two independent
# evaluations (other keys) are apart by the pseudo-marginal noise: at the
# fit's 256 initial walkers and 200k draws, median 2.9e-3 and max 2.4e-2
# on the same cards.  four_card_logp reads both sides in every run and
# fails unless the tolerance lies between them.
TOL_SHARD_LOGP = 1e-3
# acceptance band for the 50 + 50-step ensemble fits: outside it the
# ensemble is stuck (nothing accepted) or the likelihood is flat
ACC_BAND = (0.02, 0.8)


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The final line the run prints on success."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def max_rel_err(got, want, axis=None):
    """max |got - want| / max |want| (per slice along ``axis`` if given)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=axis)
    scale = np.where(scale > 0, scale, 1.0)      # all-zero: absolute error
    return float((np.abs(got - want).max(axis=axis) / scale).max())


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max rel err {err:.3g} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3g} above {tol:g}")


# ---------------------------------------------------------------- phase 0
def phase_device(expect_count: int):
    import jax

    from mcmctoffitting_tpu.utils import compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (backend "
                         f"{jax.default_backend()!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    devs = jax.devices()
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s)")
    log(f"compile cache: {compile_cache.enable()}")
    if len(devs) < expect_count:
        raise SystemExit(f"chip_smoke: need {expect_count} GPUs, "
                         f"found {len(devs)}")
    return devs


# ---------------------------------------------------------------- phase 1
def problems(n_draws: int = 200_000):
    """The four flagship configurations at their production widths."""
    from mcmctoffitting_tpu.models import onebd, simult

    return {
        "simult mc": simult.SimultFitProblem(
            simult.default_spec(n_draws)),
        "simult counts": simult.SimultFitProblem(
            simult.default_spec(n_draws, sampling="counts"),
            likelihood="poisson"),
        "oneBD default": onebd.OneBDProblem(onebd.default_spec(n_draws)),
        "oneBD hardcore": onebd.OneBDProblem(
            onebd.default_spec(n_draws, hardcore=True, sampling="counts")),
    }


def tof_inputs(problem, n_walkers: int, seed: int = 0):
    """Real TOF lattices (per-walker e0-mean jitter) and draw grids.

    Returns (base_tof, draws) of shape (W, R, M, Be) and the (Be, K)
    spread tables.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models import forward

    spec = problem.spec
    key = jax.random.PRNGKey(seed)
    observed = [np.full(w.n_bins, 100.0) for w in problem.windows]
    params = problem.shared_params(
        jnp.asarray(problem.guess_theta(observed), jnp.float32))
    grid, e0m = forward.grid_and_mean(
        dataclasses.replace(spec, sampling="expected"), params, key)
    area = spec.ed_binning.width * spec.x_binning.width
    draws1 = jnp.rint(grid / (jnp.sum(grid) * area) * spec.n_samples)
    jitter = 2.0 * jax.random.normal(jax.random.fold_in(key, 1),
                                     (n_walkers, len(problem.standoffs)))
    base = jax.vmap(jax.vmap(
        lambda so, d: forward.cell_tof_lattice(spec, so, e0m + d),
        in_axes=(0, 0)), in_axes=(None, 0))(
            jnp.asarray(problem.standoffs, jnp.float32), jitter)
    draws = jnp.broadcast_to(draws1, base.shape)
    zt, zw = forward._tof_spread(spec)
    return base, draws, zt, zw


def check_tof_stage(problem, name: str, n_walkers: int = W) -> float:
    """The TOF histogram as this backend runs it vs f64 np.histogram."""
    import jax
    import numpy as np

    from mcmctoffitting_tpu.models import forward
    from mcmctoffitting_tpu.ops.reference_np import tof_hist_np

    spec, wins = problem.spec, problem.windows
    base, draws, zt, zw = tof_inputs(problem, n_walkers)
    got = np.asarray(jax.jit(jax.vmap(
        lambda b, d: forward.tof_histogram(spec, b, d, zt, zw, wins)))(
            base, draws))
    base, draws = np.asarray(base), np.asarray(draws)
    zt, zw = np.asarray(zt, np.float64), np.asarray(zw, np.float64)
    err = max(max_rel_err(got[w], tof_hist_np(base[w], draws[w], zt, zw,
                                              wins))
              for w in range(n_walkers))
    check(f"TOF histogram, {name} ({n_walkers} walkers x "
          f"{len(wins)} runs x {base.shape[2]}x{base.shape[3]} lattice x "
          f"{zt.shape[1]} segments)", err, TOL_TOF)
    return err


def _tof_path() -> str:
    import jax

    from mcmctoffitting_tpu.ops.pallas_tof import MAX_BINS

    return (f"Pallas-Triton kernel for windows <= {MAX_BINS} bins"
            if jax.default_backend() == "gpu" else "XLA one-hot")


def check_a_contraction(problem, name: str, n_walkers: int = W):
    """A contraction at 'highest' vs f64; a TF32 run must fail TOL_A."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models.forward import _e0grid_contract
    from mcmctoffitting_tpu.ops.e0grid import expected_moments
    from mcmctoffitting_tpu.ops.reference_np import a_matrix_np

    spec = problem.spec
    tab = spec.e0_grid_table
    beam = (1878.4, 850.0, 170.0, 0.5) if "simult" in name else \
        (2490.0, 1300.0, 80.0, 0.6)
    scales = jnp.linspace(0.8, 1.2, n_walkers) * beam[2]
    mom = jax.jit(jax.vmap(lambda s: expected_moments(
        tab, beam[0], beam[1], s, beam[3], spec.n_samples, True)[0]))(
            scales)                                       # (W, 4, F)
    got = jax.jit(jax.vmap(lambda m: _e0grid_contract(spec, m)))(mom)
    want = (np.asarray(mom, np.float64).reshape(n_walkers, -1)
            @ a_matrix_np(spec))
    err = max_rel_err(np.asarray(got).reshape(n_walkers, -1), want, axis=1)
    check(f"A contraction, {name} ({n_walkers} x {4 * tab.n_fine} @ "
          f"{4 * tab.n_fine} x {tab.n_x * tab.n_ed}, a_dtype "
          f"{spec.a_dtype})", err, TOL_A)
    a32 = jnp.asarray(a_matrix_np(spec), jnp.float32)
    tf32 = jax.jit(lambda m: jnp.dot(
        m.reshape(n_walkers, -1), a32, precision="tensorfloat32",
        preferred_element_type=jnp.float32))(mom)
    err_tf32 = max_rel_err(tf32, want, axis=1)
    log(f"  A contraction in TF32, {name}: max rel err {err_tf32:.3g} "
        f"(must exceed {TOL_A:g})")
    if jax.default_backend() == "gpu" and not err_tf32 > TOL_A:
        raise AssertionError("the A tolerance does not reject TF32")
    return err, err_tf32


def check_poisson(n_walkers: int = W, lams=(2.5, 40.0, 2.0e4)):
    """poisson_ptrs at the counts-cell shape (W, 4 runs, F + 2 = 514)
    vs scipy's Poisson mean and variance, one rate per regime."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy import stats

    from mcmctoffitting_tpu.ops.poisson import poisson_ptrs

    shape = (n_walkers, 4, 514)
    keys = jax.random.split(jax.random.PRNGKey(5), n_walkers * 4)
    keys = keys.reshape(n_walkers, 4, -1)
    draw = jax.jit(jax.vmap(jax.vmap(poisson_ptrs)))
    zs = {}
    for lam in lams:
        x = np.asarray(draw(keys, jnp.full(shape, lam, jnp.float32)),
                       np.float64).ravel()
        mean, var = stats.poisson(lam).stats(moments="mv")
        n = x.size
        # standard errors of the sample mean and variance (mu4 of Poisson)
        z_mean = (x.mean() - mean) / np.sqrt(var / n)
        mu4 = lam * (1.0 + 3.0 * lam)
        z_var = (x.var(ddof=1) - var) / np.sqrt((mu4 - var ** 2) / n)
        zs[lam] = (float(z_mean), float(z_var))
        log(f"  Poisson lam={lam:g} ({n} draws, shape {shape}): z(mean) "
            f"{z_mean:.2f}, z(var) {z_var:.2f} (|z| <= 5)")
        if not (abs(z_mean) <= 5.0 and abs(z_var) <= 5.0):
            raise AssertionError(f"Poisson moments off at lam={lam}")
    return zs


def phase_stages():
    log("phase 1: stages vs plain references at real widths "
        "(TOF histogram path on this backend: "
        f"{_tof_path()})")
    probs = problems()
    check_tof_stage(probs["simult counts"], "simult")
    check_tof_stage(probs["oneBD default"], "oneBD default")
    check_tof_stage(probs["oneBD hardcore"], "oneBD hardcore")
    check_a_contraction(probs["simult counts"], "simult counts")
    check_a_contraction(probs["oneBD hardcore"], "oneBD hardcore")
    check_poisson()


# ---------------------------------------------------------------- phase 2
def check_forward(problem, name: str, n_walkers: int = W_FWD,
                  seed: int = 0) -> dict:
    """Device forward vs the f64 host reference, stage by stage.

    The random part (beam draws for mc, Poisson cell counts for counts)
    is drawn on the device and handed to both sides as data; a Poisson
    background is replaced by its expectation.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.models import forward
    from mcmctoffitting_tpu.ops import reference_np as ref
    from mcmctoffitting_tpu.ops.e0grid import poissonized_moments

    spec = dataclasses.replace(problem.spec, bg_mode="expected")
    tab = spec.e0_grid_table
    n_runs = len(problem.standoffs)
    key = jax.random.PRNGKey(seed)
    observed = [np.full(w.n_bins, 100.0) for w in problem.windows]
    thetas = problem.initial_walkers_from_observed(key, n_walkers, observed)
    params = jax.vmap(problem.shared_params)(thetas)      # (W, 4)
    keys = jax.random.split(jax.random.fold_in(key, 1),
                            n_walkers * n_runs).reshape(n_walkers, n_runs,
                                                        -1)
    per_wr = lambda f: jax.jit(jax.vmap(jax.vmap(f, in_axes=(None, 0)),
                                        in_axes=(0, 0)))
    truncated = spec.n_redraw_rounds != 0
    if spec.sampling == "mc":
        e0 = per_wr(lambda p, k: forward.sample_beam_energies(k, spec, p))(
            params, keys)                                 # (W, R, N)
        grids = jax.jit(jax.vmap(jax.vmap(
            lambda e: forward.energy_weight_grid(spec, e))))(e0)
        e0_means = jnp.mean(e0, axis=-1)
        want = ref.grid_np(spec, e0=np.asarray(e0))
        tol_grid = TOL_GRID_MC
    else:
        mom, e0_means = per_wr(lambda p, k: poissonized_moments(
            k, tab, p[0], p[1], p[2], p[3], spec.n_samples, truncated,
            spec.moment_closure))(params, keys)           # (W, R, 4, F)
        grids = jax.jit(jax.vmap(jax.vmap(
            lambda m: forward._e0grid_contract(spec, m))))(mom)
        if spec.cell_attenuation:
            grids = jax.jit(jax.vmap(jax.vmap(
                lambda g: forward._apply_attenuation(spec, g))))(grids)
        want = ref.grid_np(spec, moments=np.asarray(mom))
        tol_grid = TOL_A
    grids_h = np.asarray(grids, np.float64)
    err_grid = max_rel_err(grids_h.reshape(n_walkers * n_runs, -1),
                           want.reshape(n_walkers * n_runs, -1), axis=1)

    so = jnp.asarray(problem.standoffs, jnp.float32)
    base = jax.jit(jax.vmap(jax.vmap(
        lambda s, m: forward.cell_tof_lattice(spec, s, m))))(
            jnp.broadcast_to(so, e0_means.shape), e0_means)
    base_h = np.asarray(base, np.float64)
    means_h = np.asarray(e0_means, np.float64)
    err_lat = max(max_rel_err(base_h[w, r], ref.lattice_np(
        spec, problem.standoffs[r], means_h[w, r]))
        for w in range(n_walkers) for r in range(n_runs))
    spread = tuple(np.asarray(t) for t in forward._tof_spread(spec))
    err_lat = max([err_lat] + [max_rel_err(d, h) for d, h in
                               zip(spread, ref.spread_np(spec))])

    # per-run scales follow the shared parameters; oneBD adds backgrounds
    n_shared = problem.n_dim - n_runs * (2 if spec.cell_attenuation else 1)
    th = np.asarray(thetas)
    scales = th[:, n_shared:n_shared + n_runs]
    bgs = th[:, n_shared + n_runs:] if spec.cell_attenuation else None
    spectra = jax.jit(jax.vmap(lambda g, b, s, bg: jnp.concatenate(
        forward.spectra_from_grids(spec, g, b, problem.windows, s, bg))))(
            grids, base, jnp.asarray(scales, jnp.float32),
            None if bgs is None else jnp.asarray(bgs, jnp.float32))
    spectra = np.asarray(spectra, np.float64)
    err_spec = max(max_rel_err(spectra[w], np.concatenate(ref.spectra_np(
        spec, grids_h[w], base_h[w], problem.windows, scales[w],
        None if bgs is None else bgs[w], spread=spread)))
        for w in range(n_walkers))
    if not np.all(np.isfinite(spectra)):
        raise AssertionError(f"{name}: non-finite spectra")
    width = (f"{n_walkers} walkers x {n_runs} runs x "
             f"{spec.n_samples} draws, F={tab.n_fine}")
    check(f"{name} grid ({width})", err_grid, tol_grid)
    check(f"{name} TOF lattice and transit spread", err_lat, TOL_LATTICE)
    check(f"{name} spectra", err_spec, TOL_SPECTRA)
    return {"grid": err_grid, "lattice": err_lat, "spectra": err_spec}


def phase_forward():
    log("phase 2: forward vs the f64 host reference")
    for name, prob in problems().items():
        check_forward(prob, name)


# ---------------------------------------------------------------- phase 3
def acceptance(chain) -> float:
    """Fraction of (step, walker) moves that changed the position."""
    import numpy as np

    moved = np.any(chain[1:] != chain[:-1], axis=-1)
    return float(moved.mean())


def run_fit(name: str, cli: str, argv: list, *, ensemble: bool = True,
            out_dir: str = OUT) -> dict:
    import importlib

    import numpy as np

    from mcmctoffitting_tpu.utils import chain_io

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, name.replace(" ", "_") + "_")
    module = importlib.import_module(f"mcmctoffitting_tpu.cli.{cli}")
    t0 = time.perf_counter()
    res = module.main(argv + ["-batch", "1", "-outputPrefix", prefix])
    wall = time.perf_counter() - t0
    chain, lnp, _, n_walkers, n_steps = chain_io.read_chain_text(
        prefix + "mainchain.dat")
    if not np.all(np.isfinite(lnp)):
        raise AssertionError(f"{name}: non-finite log-probs in the chain")
    out = {"walkers": n_walkers, "steps": n_steps, "wall_s": wall,
           "walker_steps_per_s": res["walker_steps_per_sec"]}
    msg = (f"  {name}: main chain {n_steps} steps x {n_walkers} walkers "
           f"read back, log-probs finite; "
           f"{res['walker_steps_per_sec']:.1f} walker-steps/s "
           f"(information only), wall {wall:.1f} s incl. compile")
    if ensemble:
        out["acceptance"] = acc = acceptance(chain)
        msg += f"; acceptance {acc:.3f} (band {ACC_BAND})"
        if not ACC_BAND[0] <= acc <= ACC_BAND[1]:
            raise AssertionError(f"{name}: acceptance {acc:.3f} outside "
                                 f"{ACC_BAND}")
    log(msg)
    return out


FIT_STEPS = ["-nBurninSteps", "50", "-nMainSteps", "50"]


def phase_fits():
    log("phase 3: fits through the CLIs (256 walkers, 200k draws/eval)")
    run_fit("simult counts", "simult_fit",
            ["-sampling", "counts", "-likelihood", "poisson"] + FIT_STEPS)
    run_fit("simult mc", "simult_fit", ["-sampling", "mc"] + FIT_STEPS)
    run_fit("oneBD hardcore counts", "csi_onebd",
            ["-sampling", "counts", "-hardcore"] + FIT_STEPS)
    run_fit("simult NUTS expected", "simult_fit",
            ["-sampler", "nuts", "-expectedForward", "-likelihood",
             "poisson", "-nChains", "4", "-maxDepth", "6",
             "-nBurninSteps", "30", "-nMainSteps", "10"], ensemble=False)


# ---------------------------------------------------------------- --four
def four_card_phase(n_dev: int = 4, *, n_walkers: int = 256,
                    n_draws: int = 200_000, steps: int = 30,
                    pt_temps: int = 2, pt_steps: int = 5,
                    out_dir: str = OUT) -> dict:
    """Walker sharding over ``n_dev`` devices vs one device: the fit
    (:func:`four_card_fits`), the log-prob of one evaluation
    (:func:`four_card_logp`) and the PT batch (:func:`four_card_pt`)."""
    import jax

    if len(jax.devices()) < n_dev:
        raise SystemExit(f"chip_smoke: need {n_dev} devices")
    for d in jax.devices()[:n_dev]:
        log(f"  device {d.id}: {d.device_kind}")
    out = four_card_fits(n_dev, n_walkers=n_walkers, n_draws=n_draws,
                         steps=steps, out_dir=out_dir)
    prob, obs = counts_problem(n_draws)
    out.update(four_card_logp(n_dev, prob, obs, n_walkers=n_walkers))
    out.update(four_card_pt(n_dev, prob, obs, n_walkers=n_walkers,
                            steps=pt_steps, pt_temps=pt_temps))
    return out


def counts_problem(n_draws: int):
    """The simult counts + Poisson-likelihood problem and the synthetic
    observed spectra the CLI fits when given no data file (seed 0)."""
    import jax
    import numpy as np

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.utils import data_io

    spec = simult.default_spec(n_samples=n_draws, sampling="counts")
    prob = simult.SimultFitProblem(spec, likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED,
                            np.full(len(prob.standoffs), 5.0e4)])
    obs = data_io.synthesize_observed(
        jax.random.fold_in(jax.random.PRNGKey(0), 99), prob, truth)
    return prob, obs


def rel_diff(a, b):
    """|a - b| / max(|b|, 1), elementwise, in f64."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def four_card_fits(n_dev: int, *, n_walkers: int, n_draws: int,
                   steps: int, out_dir: str) -> dict:
    """The simult counts fit through the CLI with ``-mesh n_dev`` and
    ``-mesh 1`` (same seed).  Sharding changes only where each walker's
    log-prob is evaluated; the chains are compared bitwise and, where
    positions agree, their log-probs to TOL_SHARD_LOGP."""
    import numpy as np

    from mcmctoffitting_tpu.utils import chain_io

    args = ["-sampling", "counts", "-likelihood", "poisson",
            "-nWalkers", str(n_walkers), "-nDrawsPerEval", str(n_draws),
            "-nBurninSteps", str(steps), "-nMainSteps", str(steps),
            "-segment", str(steps)]
    chains = {}
    for mesh in (n_dev, 1):
        name = f"simult counts mesh{mesh}"
        run_fit(name, "simult_fit", args + ["-mesh", str(mesh)],
                out_dir=out_dir)
        prefix = os.path.join(out_dir, name.replace(" ", "_") + "_")
        chains[mesh] = [chain_io.read_chain_text(prefix + f)[:2]
                        for f in ("burninchain.dat", "mainchain.dat")]
    pos_s = np.concatenate([c[0] for c in chains[n_dev]])
    pos_l = np.concatenate([c[0] for c in chains[1]])
    lp_s = np.concatenate([c[1] for c in chains[n_dev]])
    lp_l = np.concatenate([c[1] for c in chains[1]])
    same_pos = np.all(pos_s == pos_l, axis=-1)            # (S, W)
    same = same_pos.all(axis=1)
    first = int(np.argmin(same)) if not same.all() else None
    # where a walker sits at the same position in both runs, its log-prob
    # is the same evaluation (same point, same key) on another device
    # layout: equal up to f32 reassociation of the likelihood's sums
    rel = rel_diff(lp_s, lp_l)[same_pos]
    rel = rel if rel.size else np.zeros(1)
    out = {"fit_bitwise": bool(same.all() and np.array_equal(lp_s, lp_l)),
           "fit_first_diff_step": first,
           "fit_same_position_frac": float(same_pos.mean()),
           "fit_logp_max_rel_same_position": float(rel.max())}
    log(f"  sharded vs one-device fit ({len(same)} steps x "
        f"{pos_s.shape[1]} walkers): bitwise {out['fit_bitwise']}; "
        f"positions equal in {100 * same_pos.mean():.2f}% of walker-steps"
        + ("" if first is None else f" (first difference at step {first})")
        + f"; log-prob max rel diff where positions agree "
        f"{rel.max():.3g} (tolerance {TOL_SHARD_LOGP:g})")
    if not rel.max() <= TOL_SHARD_LOGP:
        raise AssertionError("sharded log-probs disagree with one device")
    return out


def four_card_logp(n_dev: int, prob, obs, *, n_walkers: int,
                   n_keys: int = 3) -> dict:
    """The two readings TOL_SHARD_LOGP sits between, at the fit's initial
    walkers: the same evaluation (same points, same keys) sharded vs on
    one device, repeated for ``n_keys`` key sets, must stay within it; two
    independent evaluations on one device (other keys: the
    pseudo-marginal noise a wrong key or draw would bring) must exceed it,
    or the check could not tell them apart."""
    import jax
    import numpy as np

    from mcmctoffitting_tpu.parallel import make_mesh, make_sharded_logp_batch
    from mcmctoffitting_tpu.sampler import make_logp_batch

    logp = prob.make_log_prob_fn(obs)
    local = jax.jit(make_logp_batch(logp))
    sharded = jax.jit(make_sharded_logp_batch(
        logp, make_mesh(jax.devices()[:n_dev])))
    thetas = prob.initial_walkers_from_observed(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), n_walkers, obs)
    same, lps = [], []
    for k in range(n_keys):
        keys = jax.random.split(jax.random.PRNGKey(100 + k), n_walkers)
        lp_l = np.asarray(local(thetas, keys))
        same.append(float(rel_diff(sharded(thetas, keys), lp_l).max()))
        lps.append(lp_l)
    if not np.all(np.isfinite(lps)):
        raise AssertionError("non-finite log-probs at the initial walkers")
    indep = rel_diff(lps[1], lps[0])
    out = {"logp_same_eval_max_rel": same,
           "logp_indep_eval_rel_median": float(np.median(indep)),
           "logp_indep_eval_rel_max": float(indep.max())}
    log(f"  same evaluation sharded vs one device ({n_walkers} walkers, "
        f"{n_keys} key sets): max rel diff "
        + ", ".join(f"{s:.3g}" for s in same)
        + f" (tolerance {TOL_SHARD_LOGP:g}); independent evaluations: "
        f"median {np.median(indep):.3g}, max {indep.max():.3g} (max must "
        f"exceed {TOL_SHARD_LOGP:g})")
    if not max(same) <= TOL_SHARD_LOGP:
        raise AssertionError("sharded log-probs disagree with one device")
    if not indep.max() > TOL_SHARD_LOGP:
        raise AssertionError("TOL_SHARD_LOGP does not separate a different "
                             "evaluation from the same one")
    return out


def four_card_pt(n_dev: int, prob, obs, *, n_walkers: int, steps: int,
                 pt_temps: int) -> dict:
    """The parallel-tempering (T, W) batch with the walker axis sharded
    over ``n_dev`` devices vs local: positions compared bitwise and, where
    they agree, log-likelihoods to TOL_SHARD_LOGP; on the GPU also where
    the work ran and which collectives moved it
    (:func:`trace_placement`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmctoffitting_tpu.ops.likelihoods import box_lnprior
    from mcmctoffitting_tpu.parallel import make_mesh, make_sharded_pt_batch
    from mcmctoffitting_tpu.sampler import sample_pt

    out = {}
    obs_j = tuple(jnp.asarray(o, jnp.float32) for o in obs)

    def loglike(theta, k):
        return prob.log_like(theta, k, obs_j)

    def logprior(theta, k):
        del k
        return box_lnprior(theta, prob.param_lo, prob.param_hi,
                           inclusive=True)

    p0 = prob.initial_walkers_from_observed(
        jax.random.PRNGKey(8), pt_temps * n_walkers, obs).reshape(
            pt_temps, n_walkers, prob.n_dim)
    mesh = make_mesh(jax.devices()[:n_dev])
    pt_l = sample_pt(jax.random.PRNGKey(9), p0, steps, loglike, logprior,
                     stochastic=True)
    pt_s = sample_pt(jax.random.PRNGKey(9), p0, steps, loglike, logprior,
                     stochastic=True,
                     loglike_batch=make_sharded_pt_batch(loglike, mesh),
                     logprior_batch=make_sharded_pt_batch(logprior, mesh))
    ps, pl_ = np.asarray(pt_s.positions), np.asarray(pt_l.positions)
    ll_s, ll_l = np.asarray(pt_s.log_like), np.asarray(pt_l.log_like)
    if not (np.all(np.isfinite(ll_s)) and np.all(np.isfinite(ll_l))):
        raise AssertionError("PT: non-finite log-likelihoods")
    same_pos = np.all(ps == pl_, axis=-1)                 # (S, T, W)
    same_pt = same_pos.reshape(len(same_pos), -1).all(axis=1)
    rel = rel_diff(ll_s, ll_l)[same_pos]
    rel = rel if rel.size else np.zeros(1)
    out["pt_bitwise"] = bool(same_pt.all() and np.array_equal(ll_s, ll_l))
    out["pt_first_diff_step"] = (None if same_pt.all()
                                 else int(np.argmin(same_pt)))
    out["pt_same_position_frac"] = float(same_pos.mean())
    out["pt_loglike_max_rel_same_position"] = float(rel.max())
    log(f"  sharded vs local PT ({pt_temps} temperatures x {n_walkers} "
        f"walkers, {steps} steps): bitwise {out['pt_bitwise']}; positions "
        f"equal in {100 * same_pos.mean():.2f}% of walker-steps"
        + ("" if same_pt.all() else
           f" (first difference at step {out['pt_first_diff_step']})")
        + f"; log-like max rel diff where positions agree {rel.max():.3g} "
        f"(tolerance {TOL_SHARD_LOGP:g})")
    if not rel.max() <= TOL_SHARD_LOGP:
        raise AssertionError("sharded PT log-likes disagree with local")

    if jax.default_backend() == "gpu":
        out.update(trace_placement(prob, obs_j, mesh, n_walkers))
    return out


def trace_placement(prob, obs_j, mesh, n_walkers: int) -> dict:
    """Trace one sharded half-ensemble evaluation: on which devices did
    work run, and which collective kernels moved the results."""
    import glob
    import tempfile

    import jax

    from mcmctoffitting_tpu.parallel import make_sharded_logp_batch

    lb = jax.jit(make_sharded_logp_batch(prob.make_log_prob_fn(obs_j),
                                         mesh))
    obs = [o for o in obs_j]
    thetas = prob.initial_walkers_from_observed(
        jax.random.PRNGKey(3), n_walkers // 2, obs)
    keys = jax.random.split(jax.random.PRNGKey(4), n_walkers // 2)
    jax.block_until_ready(lb(thetas, keys))
    os.makedirs(OUT, exist_ok=True)
    tdir = tempfile.mkdtemp(dir=OUT)
    with jax.profiler.trace(tdir):
        jax.block_until_ready(lb(thetas, keys))
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    busy, nccl = {}, set()
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                busy[plane.name] = busy.get(plane.name, 0.0) \
                    + ev.duration_ns / 1e3
                if "nccl" in ev.name.lower():
                    nccl.add(ev.name)
    log(f"  device busy us per GPU plane: "
        + ", ".join(f"{k}: {v:.1f}" for k, v in sorted(busy.items())))
    log(f"  collective kernels: {sorted(nccl)[:6]}")
    if len([v for v in busy.values() if v > 0]) < mesh.devices.size:
        raise AssertionError("sharded evaluation did not run on every GPU")
    if not nccl:
        raise AssertionError("no NCCL collective in the sharded program")
    return {"busy_us": busy, "nccl_kernels": sorted(nccl)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    devs = phase_device(4 if four else 1)
    t0 = time.perf_counter()
    if four:
        log("four-card phase: walker sharding over 4 GPUs vs 1")
        four_card_phase(4)
        count = 4
    else:
        for phase in (phase_stages, phase_forward, phase_fits):
            t1 = time.perf_counter()
            phase()
            log(f"  ({phase.__name__}: {time.perf_counter() - t1:.1f} s)")
        count = 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(devs[0].platform, devs[0].device_kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
