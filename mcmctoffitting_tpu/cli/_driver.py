"""Shared plumbing for the fit CLIs: phase loop + resume fingerprints.

The reference drivers duplicate their burn-in/main sampling loops
(``tests/simultFit.py:733-786``, ``tests/csi_oneBD.py:869-939``); here both
flagship CLIs share one loop that streams chain segments to the emcee-text
file, checkpoints after each phase, and reports walker-steps/s.
"""
from __future__ import annotations

import hashlib
import os
import time

import numpy as np


def posterior_fingerprint(problem, observed) -> np.ndarray:
    """Digest identifying the posterior a checkpoint was sampled from.

    Captures what a ``-resume`` mismatch would silently corrupt: the model
    family and dimension, the Monte-Carlo draw count (the pseudo-marginal
    likelihood's variance), and the observed histograms themselves.
    Returned as a uint8 array so it rides the .npz checkpoint extras.
    """
    h = hashlib.sha256()
    h.update(type(problem).__name__.encode())
    h.update(np.int64(problem.n_dim).tobytes())
    h.update(np.int64(problem.spec.n_samples).tobytes())
    # likelihood-shaping modes (a stale log-prob under a different forward
    # strategy or background model would bias acceptance on resume)
    h.update(problem.spec.sampling.encode())
    h.update(problem.spec.xs_mode.encode())
    h.update(problem.spec.bg_mode.encode())
    # e0_mean_mode moves the whole TOF lattice, so it changes log-probs too
    h.update(problem.spec.e0_mean_mode.encode())
    # the moment closure reshapes the closed-form/counts forward grid
    h.update(problem.spec.moment_closure.encode())
    # the A-operator dtype perturbs the grid (bf16 hardcore preset)
    h.update(problem.spec.a_dtype.encode())
    h.update(getattr(problem, "likelihood", "reference").encode())
    # forward binnings (a -hardcore checkpoint resumed without -hardcore
    # has identical windows/observed but a different forward grid)
    for b in (problem.spec.ed_binning, problem.spec.x_binning):
        h.update(np.float64([b.lo, b.hi, b.n]).tobytes())
    h.update(np.int64(problem.spec.e0_grid_fine).tobytes())
    for o in observed:
        h.update(np.ascontiguousarray(np.asarray(o, np.float64)).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def check_likelihood_eval(problem, observed, key, *, prefix: str = "",
                          batch: bool = False) -> float:
    """Verbose per-bin likelihood table at the guess point.

    The reference defines ``checkLikelihoodEval`` in both flagships
    (``tests/simultFit.py:474-512``, ``tests/csi_oneBD.py:654-712``) and
    drives it from commented-out debug lines; this is the wired version.
    One difference by design: the reference helper prints an ad-hoc
    double-Gaussian bin score unrelated to the likelihood its sampler
    uses, while this table prints the ACTIVE likelihood's per-bin
    contributions, so the printed total is exactly the number the sampler
    would see at this theta (minus the flat in-box prior).

    Prints per-bin obs/model/loglike per run, writes the reference's
    overlay+residual figure per run (unless ``batch``), and returns the
    total log-likelihood.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.likelihoods import poisson_binned_terms, poisson_logpmf_terms

    theta = jnp.asarray(problem.guess_theta(observed), jnp.float32)
    spectra = jax.jit(problem.run_spectra)(theta, key)
    terms_fn = (poisson_binned_terms
                if getattr(problem, "likelihood", "reference") == "reference"
                else poisson_logpmf_terms)
    with np.printoptions(precision=4, suppress=True):
        print(f"checkLikelihoodEval at guess theta = {np.asarray(theta)}")
    total = 0.0
    for run, (model, obs) in enumerate(zip(spectra, observed)):
        model = np.asarray(model, np.float64)
        obs = np.asarray(obs, np.float64)
        terms = np.asarray(terms_fn(model, obs), np.float64)
        for b in range(len(obs)):
            print(f"run {run} bin {b}: obs {obs[b]:9.1f}  "
                  f"model {model[b]:10.2f}  loglike {terms[b]:12.4f}")
        run_total = float(terms.sum())
        total += run_total
        print(f"run {run} likelihood: {run_total:.4f}")
        if not batch:
            try:
                from ..utils.plotting import model_overlay_plot
                model_overlay_plot(
                    obs, model,
                    f"{prefix}likelihoodCheck_run{run}.png")
            except Exception as e:  # matplotlib optional
                print(f"plotting skipped: {e}")
    print(f"total likelihood is {total:.4f}")
    return total


def load_resume_state(path, problem, observed, logp_batch):
    """Load a checkpoint for -resume, re-evaluating log-probs if the
    posterior fingerprint differs from this invocation's.

    A checkpoint stores log-probs computed under a specific likelihood; if
    the rebuilt one differs (different data / nDrawsPerEval / nRuns), the
    stale values would bias acceptance until overwritten, so they are
    recomputed at the restored positions instead.
    """
    import sys

    import jax

    from ..sampler import init_state
    from ..utils import chain_io

    if not os.path.exists(path):
        sys.exit(f"error: -resume checkpoint not found: {path}")
    try:
        state, extra = chain_io.load_checkpoint(path)
    except Exception as e:
        sys.exit(f"error: could not load -resume checkpoint {path}: {e}")
    fp = posterior_fingerprint(problem, observed)
    old = extra.get("posterior_fp")
    if old is None or not np.array_equal(np.asarray(old, np.uint8), fp):
        print("WARNING: checkpoint posterior fingerprint does not match "
              "this invocation (different data, -nDrawsPerEval or run "
              "count?); re-evaluating log-probs at the restored positions")
        state = init_state(jax.random.fold_in(state.key, 0x5e5),
                           state.positions, logp_batch)
    return state


def run_phases(state, phases, logp_batch, *, n_walkers: int = 0,
               segment: int, prefix: str, fingerprint=None,
               adaptive_phase: str | None = None, tau_factor: float = 50.0,
               tau_rtol: float = 0.02, move: str = "stretch"):
    """Drive the sampler through (name, chain_path, n_steps, truncate)
    phases, streaming chain text per segment and checkpointing per phase.

    ``adaptive_phase`` names a phase whose ``n_steps`` is a CAP rather than
    a target: sampling stops early once the chain is long enough to trust
    — every parameter's integrated autocorrelation time tau satisfies
    S >= tau_factor * tau AND the tau estimate moved < tau_rtol between
    consecutive checks (emcee's documented convergence recipe).  The
    reference hard-codes chain lengths per driver, which under-samples
    degenerate ridges by ~10x; this closes that loop.

    Returns (final_state, total_steps, elapsed_s).
    """
    import jax

    from ..sampler import run_mcmc
    from ..utils import chain_io

    # jit one program per distinct segment length (an eager lax.scan
    # re-traces its body on EVERY call — 1-2 s of host time per segment on
    # the big models)
    jitted = {}

    def run_segment(s, seg):
        fn = jitted.get(seg)
        if fn is None:
            def segment_fn(st):
                ch = run_mcmc(st, seg, logp_batch, move=move)
                return ch.positions, ch.log_probs, ch.n_accepted, ch.state
            fn = jax.jit(segment_fn)
            jitted[seg] = fn
        return fn(s)

    # the authoritative walker count is the state's (a resumed checkpoint
    # may carry a different ensemble size than this invocation's flags)
    n_walkers = int(state.positions.shape[0])
    extra = None if fingerprint is None else {"posterior_fp": fingerprint}
    t0 = time.time()
    total_steps = 0
    for phase, path, n_steps, truncate in phases:
        if truncate:
            open(path, "w").close()
        adaptive = phase == adaptive_phase
        pos_acc: list[np.ndarray] = []
        tau_prev = None
        # first tau check after a fixed ~80-step warmup (tau estimates
        # below that are unstable), NOT tied to the flush segment size —
        # the segment default moved 10 -> 50 and 8*segment would push the
        # first check past the default -nMainSteps 100 cap entirely.
        # Geometric 1.2x backoff after that: the full-history FFT tau
        # estimate is O(S log S), so re-estimating every segment would
        # cost O(S^2 log S) over a long run (emcee's practice).
        next_check = max(80, 2 * segment)
        done = 0
        phase_accepted = 0.0
        pending = None   # one segment's un-flushed device outputs

        def flush(pend):
            # host work for a finished segment: fetch + chain-text append
            # + progress line.  Called AFTER the next segment has been
            # dispatched, so this transfer/IO overlaps device compute
            # (jax dispatch is async; only the np.asarray calls block) —
            # the fetch + text IO of one segment no longer stalls the
            # device.
            nonlocal phase_accepted
            positions, log_probs, n_acc, done_s = pend
            positions = np.asarray(positions)
            chain_io.append_chain_text(path, positions,
                                       np.asarray(log_probs))
            phase_accepted += float(np.sum(np.asarray(n_acc)))
            rate = (done_s + total_done0) * n_walkers / (time.time() - t0)
            acc = phase_accepted / (done_s * n_walkers)
            print(f"{phase}: step {done_s}/{n_steps} "
                  f"({rate:.1f} walker-steps/s, acc {acc:.2f})", flush=True)
            if adaptive:
                pos_acc.append(positions)

        total_done0 = total_steps
        # the finally guarantees a fully computed segment is never lost:
        # the pipelined order defers segment k's write past segment k+1's
        # dispatch, so an interrupt mid-run must still persist the pending
        # results (the pre-pipelining code flushed synchronously)
        try:
            while done < n_steps:
                seg = min(segment, n_steps - done)
                positions, log_probs, n_acc, state = run_segment(state, seg)
                prev, pending = pending, None
                done += seg
                total_steps += seg
                if prev is not None:
                    flush(prev)   # overlaps the segment dispatched above
                pending = (positions, log_probs, n_acc, done)
                if adaptive:
                    from ..utils.diagnostics import \
                        integrated_autocorr_time

                    if done < next_check:   # between backoff points
                        continue
                    flush(pending)      # the tau check needs this segment
                    pending = None
                    next_check = max(done + seg, int(1.2 * done))
                    tau = integrated_autocorr_time(np.concatenate(pos_acc))
                    tau_max = float(tau.max())
                    stable = tau_prev is not None and bool(
                        np.all(np.abs(tau - tau_prev) <= tau_rtol * tau))
                    print(f"{phase}: tau_max {tau_max:.1f} "
                          f"(S/tau {done / tau_max:.1f}, need "
                          f">= {tau_factor:.0f}"
                          f"{', tau stable' if stable else ''})", flush=True)
                    if done >= tau_factor * tau_max and stable:
                        print(f"{phase}: converged at step {done} "
                              f"(S >= {tau_factor:.0f} tau and tau drift "
                              f"< {100 * tau_rtol:.0f}%)", flush=True)
                        break
                    tau_prev = tau
        finally:
            if pending is not None:   # final or interrupted segment
                flush(pending)
                pending = None
        chain_io.save_checkpoint(
            prefix + f"{phase.replace('-', '')}.ckpt.npz", state,
            extra=extra)
        _print_diagnostics(phase, path)
    return state, total_steps, time.time() - t0


def resolve_gradient_spec(args, spec):
    """Validate + finalize the spec for ``-sampler nuts|hmc``.

    Gradient-based sampling needs the DIFFERENTIABLE posterior
    configuration (cross-validation study): the closed-form
    expected forward (the MC estimators re-draw per eval), the correct
    Poisson logpmf (the reference's int()-cast sawtooth has zero gradient
    a.e.), and ``rint_draws`` off (rint has zero gradient).  The first
    two are explicit user choices and are REQUIRED rather than silently
    flipped; rint has no CLI flag and is turned off here with a note.
    """
    import sys

    if args.sampler == "ensemble":
        return spec
    if spec.sampling != "expected":
        sys.exit(f"error: -sampler {args.sampler} requires the closed-form "
                 "forward (-expectedForward / -sampling expected) — the "
                 "gradient flows only through it; the MC estimators "
                 "re-draw per eval")
    if args.likelihood != "poisson":
        sys.exit(f"error: -sampler {args.sampler} requires -likelihood "
                 "poisson (the reference's int()-cast likelihood has zero "
                 "gradient almost everywhere)")
    if args.resume:
        sys.exit(f"error: -resume is not supported with -sampler "
                 f"{args.sampler} (ensemble checkpoints only)")
    if spec.bg_mode != "expected" and getattr(args, "deterministicBG",
                                              True) is False:
        sys.exit(f"error: -sampler {args.sampler} requires "
                 "-deterministicBG (the per-eval Poisson background draw "
                 "is discrete)")
    import dataclasses
    print(f"-sampler {args.sampler}: rint draw rounding disabled "
          "(zero-gradient op; the forward stays the exact closed form)")
    return dataclasses.replace(spec, rint_draws=False)


def run_gradient_sampler(args, problem, observed, *, names):
    """``-sampler nuts|hmc``: gradient-based sampling of the flagship
    posterior — beyond the reference, whose MC + sawtooth likelihood has
    no usable gradient anywhere.  See :func:`resolve_gradient_spec`.

    Chains run in box-logit coordinates (sampler/transforms.py: the
    Stan-style constrained-parameter transform — prior-box faces at
    infinity, O(1) per-dimension scale); NUTS additionally adapts a
    diagonal metric during warm-up (Stan-style windows, sampler/nuts.py).
    The main chain lands in the same emcee-text format as the ensemble
    path, so plot_chain / ppc / the diagnostics report work unchanged.
    """
    import json

    import jax
    import jax.numpy as jnp

    from ..utils import chain_io

    from ..sampler.transforms import BoxLogitTransform

    logp_full = problem.make_log_prob_fn(observed)
    key = jax.random.PRNGKey(args.seed)
    key0 = jax.random.fold_in(key, 7)   # unused: deterministic likelihood
    # Box-logit coordinates (sampler/transforms.py): the prior box's
    # faces move to infinity (no more -inf leapfrog cliffs — the linear
    # standardization this replaces ran the flagship at a 46% divergence
    # rate) and each dimension is O(1) regardless of the five-decade
    # span of the norm boxes.  NUTS's warm-up metric refines the rest.
    n_chains = args.nChains
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi)
    logp_u = tr.wrap_logp(lambda theta: logp_full(theta, key0))
    cloud = np.asarray(problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 3), max(256, n_chains), observed))

    n_warmup = 10 if args.debug else args.nBurninSteps
    n_steps = 10 if args.debug else args.nMainSteps
    # start from the problem's initial-walker law, transformed
    p0 = tr.to_u(jnp.asarray(cloud[: n_chains], jnp.float32))
    print(f"{args.sampler}: {n_chains} chains x {n_warmup} warmup "
          f"+ {n_steps} steps (box-logit coordinates)")
    import contextlib

    from ..utils import profiling
    prof = (profiling.trace(args.profile) if args.profile
            else contextlib.nullcontext())
    t0 = time.time()
    with prof:
        if args.sampler == "nuts":
            from ..sampler.nuts import nuts_sample
            chain = nuts_sample(jax.random.fold_in(key, 2), p0, n_steps,
                                logp_u, n_warmup=n_warmup,
                                max_depth=args.maxDepth)
            accept = np.asarray(chain.accept_stat)
            n_div = int(np.sum(np.asarray(chain.diverging)))
            extra = (f"nuts: step_size {chain.step_size:.4g}, "
                     f"mean tree depth "
                     f"{float(np.mean(np.asarray(chain.tree_depth))):.1f}, "
                     f"divergences {n_div}/{accept.size}")
        else:
            from ..sampler.hmc import hmc_sample
            chain = hmc_sample(jax.random.fold_in(key, 2), p0, n_steps,
                               logp_u, n_warmup=n_warmup)
            accept = np.asarray(chain.accept_prob)
            extra = f"hmc: step_size {chain.step_size:.4g}"
        positions = np.asarray(tr.to_theta(chain.positions))
    elapsed = time.time() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(f"{extra}, mean accept stat {float(accept.mean()):.2f}")

    path = args.outputPrefix + "mainchain.dat"
    open(path, "w").close()
    chain_io.append_chain_text(path, positions,
                               np.asarray(chain.log_probs))
    _print_diagnostics("main", path)

    result = report_quantiles(positions.reshape(-1, len(names)), names)
    # rate counts warm-up + kept transitions over the full elapsed time,
    # matching the ensemble path's (burnin+main)*walkers/elapsed metric
    rate = (n_warmup + n_steps) * n_chains / elapsed
    print(json.dumps({"walker_steps_per_sec": rate, "elapsed_s": elapsed}))
    return {"quantiles": result, "walker_steps_per_sec": rate}


def report_quantiles(flat, names):
    """Print the shared 16/50/84 quantile table; return {name: [med, +s,
    -s]} (the dict both flagship CLIs and the gradient path return)."""
    q = np.percentile(flat, [16, 50, 84], axis=0)
    print("MCMC result (median +sigma -sigma):")
    result = {}
    for d, name in enumerate(names):
        med, lo_, hi_ = q[1, d], q[1, d] - q[0, d], q[2, d] - q[1, d]
        print(f"  {name} = {med:.4g} +{hi_:.3g} -{lo_:.3g}")
        result[name] = [float(med), float(hi_), float(lo_)]
    return result


def _print_diagnostics(phase: str, chain_path: str) -> None:
    """End-of-phase convergence report (tau / ESS / split R-hat).

    The reference never shipped this (its ``sampler.acor`` printout is
    commented out, ``tests/shiftingGaussian_brute.py:324-326``) and its
    hard-coded chain lengths under-sample degenerate ridges by up to ~10x
    Host-side numpy on the streamed chain file; skipped
    silently for chains too short to window.
    """
    from ..utils import chain_io
    from ..utils.diagnostics import chain_summary, format_summary

    try:
        chain, _, _, _, n_steps = chain_io.read_chain_text(chain_path)
        if n_steps < 8:
            return
        print(f"{phase}: {format_summary(chain_summary(chain))}", flush=True)
    except Exception as e:  # diagnostics must never kill a finished fit
        print(f"{phase}: diagnostics skipped ({e})", flush=True)


def add_common_flags(p, refs: dict) -> None:
    """Flags both flagship CLIs share, defined once so their documented
    semantics stay in lockstep (the two parsers had begun to drift).

    ``refs`` parameterizes the per-driver reference citations and
    per-mode defaults quoted in the help strings:
    ``check_eval`` / ``nthreads`` / ``mpi`` (reference file:line),
    ``fine_defaults`` (per-mode F defaults string).
    """
    p.add_argument("-debug", choices=[0, 1], default=0, type=int)
    p.add_argument("-quitEarly", choices=[0, 1], default=0, type=int)
    p.add_argument("-checkLikelihoodEval", choices=[0, 1], default=0,
                   type=int,
                   help="print the per-bin likelihood table + overlay/"
                        "residual figure at the guess point and exit (the "
                        "reference's checkLikelihoodEval debug helper, "
                        f"{refs['check_eval']}, wired to a flag)")
    p.add_argument("-batch", choices=[0, 1], default=0, type=int,
                   help="suppress plots")
    p.add_argument("-forceCustomPDF", choices=[0, 1], default=0, type=int,
                   help="accepted for surface parity; this build always "
                        "uses its own skew-normal (ops/pdfs.py), which IS "
                        "the reference's custom pdf (utilities/pdfs.py)")
    p.add_argument("-nDrawsPerEval", default=200_000, type=int)
    p.add_argument("-nBurninSteps", default=400, type=int)
    p.add_argument("-nMainSteps", default=100, type=int)
    p.add_argument("-nWalkers", default=256, type=int)
    p.add_argument("-outputPrefix", default="", type=str)
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("-mesh", default=0, type=int,
                   help="max devices for walker sharding (0 = all)")
    p.add_argument("-chunkWalkers", default=0, type=int,
                   help="eval walkers in chunks of this size (memory cap)")
    p.add_argument("-segment", default=50, type=int,
                   help="steps per device->host chain flush (one "
                        "dispatch and one chain-text append per flush; "
                        "-convergeMain's first tau check sits at "
                        "max(80, 2*segment) steps)")
    p.add_argument("-convergeMain", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0,
                   help="treat -nMainSteps as a CAP and stop the main "
                        "phase early once S >= tauFactor * tau for every "
                        "parameter with a stable tau estimate (emcee's "
                        "convergence recipe; the reference hard-codes "
                        "chain lengths)")
    p.add_argument("-tauFactor", default=50.0, type=float,
                   help="chain-length multiple of the integrated "
                        "autocorrelation time required by -convergeMain")
    p.add_argument("-move", choices=["stretch", "de", "mixed"],
                   default="de",
                   help="ensemble proposal.  Default 'de' (ter Braak "
                        "DE-MC): measured tau_max 39.4 vs stretch's "
                        "126.6 at equal per-step device cost on the "
                        "corrected-likelihood flagship -> 3.2x the ESS "
                        "per step (artifacts/move_ess_ab.json), and "
                        "still >= stretch under the faithful sawtooth "
                        "(tau 394 vs 463).  '-move stretch' restores "
                        "emcee-verbatim proposal semantics (the library "
                        "API default, sampler/stretch.py)")
    p.add_argument("-resume", default="", type=str,
                   help="resume the MAIN phase from a .ckpt.npz checkpoint "
                        "(skips burn-in; exact continuation incl. PRNG)")
    p.add_argument("-runAxis", choices=["auto", "sequential", "batched"],
                   default="auto",
                   help="multi-run forward execution (ForwardSpec."
                        "run_axis): sequential lax.map (best at "
                        "saturating ensemble widths — the A-operator "
                        "contraction reuses better streamed) or one "
                        "vmapped batched program (best at small "
                        "ensembles, where per-stage dispatches dominate)."
                        "  auto picks by walkers/device (counts mode)")
    p.add_argument("-gridMode", choices=["e0grid", "taylor"],
                   default="e0grid",
                   help="e0grid (default): static e0-space preimage grid "
                        "(fast; sub-rint approximation, ops/e0grid.py); "
                        "taylor: per-sample transport + per-slice moments")
    p.add_argument("-expectedForward", action="store_true",
                   help="closed-form expected forward model (the exact "
                        "infinite-draw limit; no pseudo-marginal noise); "
                        "alias for -sampling expected")
    p.add_argument("-sampling", choices=["mc", "counts", "expected"],
                   default="mc",
                   help="mc: faithful per-sample Monte Carlo (reference "
                        "semantics); counts: Poissonized Rao-Blackwell MC "
                        "— same unbiased estimator at equal-or-lower "
                        "per-eval noise, O(F) cost (recommended for "
                        "production MC); expected: closed-form limit")
    p.add_argument("-likelihood", choices=["reference", "poisson"],
                   default="reference",
                   help="reference: the faithful int()-cast form, whose "
                        "sawtooth IS the dominant pseudo-marginal noise "
                        "(sigma~7e4 measured); poisson: correct Poisson "
                        "logpmf (sigma~2) — recommended for production")
    p.add_argument("-sampler", choices=["ensemble", "nuts", "hmc"],
                   default="ensemble",
                   help="ensemble: Goodman-Weare stretch (reference "
                        "semantics).  nuts / hmc: GRADIENT-based sampling "
                        "of the differentiable configuration — requires "
                        "-expectedForward -likelihood poisson (oneBD also "
                        "-deterministicBG); impossible in the reference "
                        "(MC + sawtooth likelihood).  Writes the same "
                        "chain format")
    p.add_argument("-nChains", default=4, type=int,
                   help="parallel chains for -sampler nuts/hmc "
                        "(vectorized on-device; -nWalkers governs "
                        "ensemble mode)")
    p.add_argument("-maxDepth", default=8, type=int,
                   help="NUTS maximum tree doublings per step")
    p.add_argument("-momentClosure", choices=["exact", "cell"],
                   default="exact",
                   help="counts/expected forward only — exact: full 4-row "
                        "ndtr partial-moment chain; cell: 2-row chain + "
                        "analytic within-cell closure for the t^2/t^3 "
                        "channels, at half the transcendental cost "
                        "(ops/e0grid.py).  Runs at the per-mode default "
                        "grid; posterior A/B vs exact at the production "
                        "config passes both flagships "
                        "(artifacts/counts_f_posterior_ab_*_closure.json)")
    p.add_argument("-fineGrid", default=0, type=int,
                   help="override the e0-preimage fine-grid size F "
                        f"(default: per-mode — {refs['fine_defaults']}).  "
                        "Pure throughput/fidelity knob; the posterior-"
                        "level logp shift is <0.06 sigma for any F >= 512 "
                        "and the halved counts grids pass posterior A/B "
                        "at |dz| <= 0.12 (artifacts/counts_f_posterior_ab_"
                        "*.json)")
    p.add_argument("-aDtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="dtype of the static e0grid A operator "
                        "(models/forward._e0grid_contract).  bfloat16 "
                        "halves the bytes the contraction streams — only "
                        "material at the oneBD -hardcore scale, where A "
                        "is 131 MB.  Default: per-preset "
                        "(bfloat16 for -hardcore counts, "
                        "posterior A/B worst |dz| = 0.22 — artifacts/"
                        "hardcore_a_dtype_ab.json; float32 elsewhere); "
                        "pass float32 to force the exact contraction")
    p.add_argument("-nThreads", default=0, type=int,
                   help="accepted for surface parity and ignored: walker "
                        "parallelism is a device-mesh array axis here, not "
                        f"a process pool (reference {refs['nthreads']})")
    p.add_argument("-mpi", default=0, type=int,
                   help="accepted for surface parity and ignored: the MPI "
                        "pool is replaced by jax.distributed + mesh "
                        f"sharding (reference {refs['mpi']})")
    p.add_argument("-profile", default="", type=str, metavar="DIR",
                   help="capture a jax.profiler device trace of the "
                        "sampling phases into DIR (TensorBoard-compatible; "
                        "utils/profiling.py).  The reference has no "
                        "profiler at all (SURVEY.md §5)")
    p.add_argument("-prng", choices=["threefry2x32", "rbg"], default=None,
                   help="PRNG implementation (default: jax's). Every "
                        "sampler in the package is impl-agnostic "
                        "(ops/poisson.py "
                        "replaces the threefry-only jax.random.poisson). "
                        "Changes draw streams, not distributions.")


def common_setup(args):
    """Compile cache + PRNG impl selection; returns the jax module."""
    from ..utils import compile_cache
    compile_cache.enable()
    import jax

    if args.prng:
        jax.config.update("jax_default_prng_impl", args.prng)
    return jax


def resolve_sampling(args):
    """(sampling, fine_grid) from the flag pair.

    The cell closure runs at the same per-mode default grids as the
    exact chain.  History: the
    closure initially kept the finer grid its first accuracy evidence
    was collected at; posterior A/Bs at the PRODUCTION configuration
    (200k draws, halved grids; cell vs exact, only the closure differs)
    then passed on both flagships — worst |dz| = 0.06 simult / 0.24
    oneBD (artifacts/counts_f_posterior_ab_*_closure.json) — and the
    per-eval logp noise matches the exact chain's
    (tools/counts_f_study.py --closure cell), so the guard was dropped
    and the closure's measured throughput win applies at the defaults.
    """
    sampling = "expected" if args.expectedForward else args.sampling
    return sampling, args.fineGrid or None


# total-walkers-per-device crossover for the counts run axis: below this,
# one batched 4-run program beats the sequential lax.map (per-stage
# dispatch overhead dominates the half-ensemble's small kernels); above
# it, streaming runs through the shared A operator wins.  The value 512
# is not yet measured on the H100 (the reference-default 256-walker
# ensemble runs batched under it).
RUN_AXIS_CROSSOVER_WALKERS = 512


def resolve_run_axis(args, spec, n_walkers):
    """Finalize ForwardSpec.run_axis (-runAxis auto|sequential|batched).

    auto applies only to the counts estimator — mc's batched run axis
    holds an O(n_samples)-per-run working set (R times the sequential
    form's) and the expected forward computes
    ONE shared grid where the run axis never materializes.
    """
    import dataclasses

    if args.runAxis != "auto":
        if spec.run_axis == args.runAxis:
            return spec
        return dataclasses.replace(spec, run_axis=args.runAxis)
    if spec.sampling != "counts":
        return spec
    import jax
    n_devices = len(jax.devices())
    if getattr(args, "mesh", 0):
        n_devices = min(n_devices, args.mesh)
    per_device = n_walkers / max(1, n_devices)
    axis = ("batched" if per_device <= RUN_AXIS_CROSSOVER_WALKERS
            else "sequential")
    if spec.run_axis == axis:
        return spec
    return dataclasses.replace(spec, run_axis=axis)


def build_logp_batch(logp, args, n_walkers=None):
    """Walker-batch evaluator: sharded over the device mesh when >1
    device is visible (-mesh caps), vmapped locally otherwise.

    With ``n_walkers`` given, the mesh shrinks to the largest device
    count that divides the half-ensemble (the red-black move evaluates
    walkers/2 at a time) instead of erroring — tiny debug ensembles on
    big meshes just use fewer devices.
    """
    import jax

    from ..parallel import make_mesh, make_sharded_logp_batch
    from ..sampler import make_logp_batch

    devices = jax.devices()
    if args.mesh:
        devices = devices[: args.mesh]
    if n_walkers is not None:
        n_fit = len(devices)
        while n_fit > 1 and (n_walkers // 2) % n_fit:
            n_fit -= 1
        if n_fit < len(devices):
            # loud: the old behavior was a divisibility ERROR; silently
            # running -walkers 1022 on 1 of 8 chips is a huge slowdown
            per = (n_walkers // 2 // n_fit) * 2 * len(devices)
            print(f"WARNING: half-ensemble ({n_walkers}/2 walkers) does "
                  f"not divide across {len(devices)} devices; using "
                  f"{n_fit} and idling {len(devices) - n_fit} — pick a "
                  f"walker count divisible by 2*{len(devices)} (e.g. "
                  f"-walkers {max(per, 2 * len(devices))}) to use the "
                  "full mesh")
        devices = devices[:n_fit]
    chunk = args.chunkWalkers or None
    if len(devices) > 1:
        lb = make_sharded_logp_batch(logp, make_mesh(devices), chunk=chunk)
        print(f"walker axis sharded over {len(devices)} devices")
        return lb
    return make_logp_batch(logp, chunk=chunk)


def run_phases_profiled(args, state, phases, logp_batch, *, n_walkers,
                        fingerprint):
    """run_phases under an optional jax.profiler trace (-profile DIR)."""
    import contextlib

    from ..utils import profiling

    prof = (profiling.trace(args.profile) if args.profile
            else contextlib.nullcontext())
    with prof:
        out = run_phases(
            state, phases, logp_batch, n_walkers=n_walkers,
            segment=args.segment, prefix=args.outputPrefix,
            fingerprint=fingerprint,
            adaptive_phase="main" if args.convergeMain else None,
            tau_factor=args.tauFactor, move=args.move)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    return out
