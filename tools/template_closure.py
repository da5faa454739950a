"""Template-fit statistical closure (VERDICT r4 item 5).

Protocol (the reference's own endpoint, ``tests/devShapeTemplates.py:
554-631``, at reduced-but-honest scale): generate REAL physics templates
(32 monoenergetic slices x 4 standoffs via the shared forward pipeline),
synthesize observed spectra from KNOWN truth (3 run scales + 32
coefficients = the reference's Gaussian-mixture guess model) under the
LIKELIHOOD'S OWN noise law (6.34% relative — see the inline note: a
Poisson generator measures the wide-Gaussian likelihood's
misspecification, not the sampler), run the full 35-dim fit, and assert
the recovered coefficient quantiles bracket the truth.  Default sampler
is NUTS in box-logit coordinates (the tight 35-dim posterior collapses
ensemble acceptance to ~0.05; --sampler ensemble keeps the
reference-shaped fit for the record).  Writes the unfolded-spectrum
credible-band artifact from the real fit (the reference's final plot,
``:616-621``).

Usage: [JAX_PLATFORMS=cpu] python tools/template_closure.py
       [--draws N] [--walkers W] [--steps S] [--sampler nuts|ensemble]
       [--chains C] [--warmup W]
Writes artifacts/template_closure_report.txt, _summary.json, and
artifacts/template_closure_unfolded.png.
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _arg(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


def main() -> int:
    n_draws = _arg("--draws", 50_000)
    n_walkers = _arg("--walkers", 256)
    n_steps = _arg("--steps", 6_000)

    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    from mcmctoffitting_tpu.models import templates as T
    from mcmctoffitting_tpu.sampler import (init_state, make_logp_batch,
                                            run_mcmc)

    spec = T.default_spec(n_samples=n_draws)
    problem = T.TemplateFitProblem(n_runs=4)
    key = jax.random.PRNGKey(42)

    cache = os.path.join(REPO, "out", f"templates_closure_d{n_draws}.csv")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        print(f"loading cached templates: {cache}", flush=True)
        templates = T.load_templates_csv(cache, 4)
    else:
        print("generating 4x32 physics templates "
              f"({n_draws} draws each)...", flush=True)
        t0 = time.time()
        templates = T.generate_templates(jax.random.fold_in(key, 0), spec)
        T.save_templates_csv(cache, templates)
        print(f"templates in {time.time() - t0:.0f}s", flush=True)

    # truth: the reference's own guess-model coefficient shape (smooth,
    # positive, physically scaled) + in-box run scales
    true_coeffs = problem.initial_guess_model()
    true_scales = [1.0, 1.1, 0.6, 1.5]          # run 1 pinned to 1.0
    rng = np.random.default_rng(7)
    # Noise law MATCHES the likelihood's assumption: the reference's
    # wide-Gaussian lnlike asserts 7%/15% RELATIVE errors per bin
    # (ops/likelihoods.template_gaussian_loglike; combined effective
    # sigma = (0.07^-2 + 0.15^-2)^-1/2 = 6.34% of the bin).  Only a
    # generator with that law yields calibrated posterior quantiles —
    # Poisson counts are ~sqrt(m)/0.0634m = 45x overdispersed relative
    # to the assumed error at m ~ 100 counts, and a closure against
    # them measures likelihood MIS-specification, not the sampler
    # (measured: converged NUTS and 40k-step ensemble chains agreed,
    # both excluding truth for ~10 of 35 params).  Sub-count bins are
    # left empty, matching the clamp convention.
    sigma_rel = (0.07 ** -2 + 0.15 ** -2) ** -0.5
    observed = []
    for r in range(4):
        model = np.asarray(T.build_model_tof(true_scales[r], true_coeffs,
                                             templates[r]))
        noisy = model * (1.0 + sigma_rel * rng.standard_normal(model.shape))
        observed.append(np.where(model >= 1.0, np.maximum(noisy, 0.0), 0.0))

    logp = problem.make_log_prob_fn(observed, templates)
    lb = make_logp_batch(logp)
    guess = np.concatenate([[1.1, 0.6, 1.5], true_coeffs])
    lo = np.concatenate([[l0 for (l0, _) in T.SCALE_LIMS],
                         np.zeros(T.N_TEMPLATES)])
    hi = np.concatenate([[h0 for (_, h0) in T.SCALE_LIMS],
                         np.full(T.N_TEMPLATES, T.COEFF_LIM[1])])
    # the reference's init: guess * U(0.9, 1.1) per walker (:558-562)
    u = rng.uniform(0.9, 1.1, (n_walkers, problem.n_dim))
    p0 = jnp.asarray(np.clip(guess * u, lo + 1e-6, hi - 1e-6), jnp.float32)

    sampler = _arg("--sampler", "nuts", str)
    t0 = time.time()
    if sampler == "nuts":
        # The cleaned template posterior (sub-count clamp,
        # ops/likelihoods.py) is tight in 35 dimensions: the ensemble
        # moves' acceptance collapses to ~0.05 and tau exceeds any
        # affordable chain (measured: 40k steps x 512 walkers left 10
        # params outside their 98% intervals).  The posterior is
        # deterministic and differentiable, so the framework's NUTS in
        # box-logit coordinates is the production answer — the reference
        # could never do this (its emcee fit is the same collapsing
        # ensemble; tests/devShapeTemplates.py:554-631).
        from mcmctoffitting_tpu.sampler.nuts import nuts_sample
        from mcmctoffitting_tpu.sampler.transforms import BoxLogitTransform

        n_chains = _arg("--chains", 8)
        n_warmup = _arg("--warmup", 1000)
        n_keep = max(1000, n_steps // 8)
        tr = BoxLogitTransform(jnp.asarray(lo, jnp.float32),
                               jnp.asarray(hi, jnp.float32))
        logp_u = tr.wrap_logp(lambda th: logp(th, None))
        u0 = tr.to_u(p0[: n_chains])
        seg = 64 if jax.default_backend() != "cpu" else 0
        print(f"fit: NUTS {n_chains} chains x {n_warmup} warmup + "
              f"{n_keep} steps (35-dim, box-logit)", flush=True)
        chain = nuts_sample(jax.random.fold_in(key, 2), u0, n_keep,
                            logp_u, n_warmup=n_warmup, max_depth=10,
                            segment_steps=seg)
        n_div = int(np.sum(np.asarray(chain.diverging)))
        print(f"  divergences {n_div}/{n_keep * n_chains}, mean accept "
              f"{float(np.mean(np.asarray(chain.accept_stat))):.2f}",
              flush=True)
        samples = np.asarray(tr.to_theta(chain.positions)).reshape(
            -1, problem.n_dim)
        elapsed = time.time() - t0
        n_walkers, n_steps = n_chains, n_keep  # for the report header
    else:
        print(f"fit: {n_walkers} walkers x {n_steps} steps (35-dim)",
              flush=True)
        state = init_state(jax.random.fold_in(key, 2), p0, lb)
        seg = jax.jit(lambda s: run_mcmc(s, n_steps // 4, lb,
                                         move="mixed"))
        chains = []
        for i in range(4):
            ch = seg(state)
            chains.append(np.asarray(ch.positions[:: 5]))
            state = ch.state
            print(f"  segment {i + 1}/4 done (acc="
                  f"{float(np.mean(np.asarray(ch.acceptance_fraction))):.2f})",
                  flush=True)
        elapsed = time.time() - t0
        # keep the last half (post burn-in)
        samples = np.concatenate(chains[2:]).reshape(-1, problem.n_dim)
    print(f"fit in {elapsed:.0f}s; {samples.shape[0]} kept draws",
          flush=True)

    # --- closure assertions -------------------------------------------
    truth = np.concatenate([true_scales[1:], true_coeffs])
    names = (["scale2", "scale3", "scale4"]
             + [f"c{i}" for i in range(T.N_TEMPLATES)])
    q = np.percentile(samples, [1, 16, 50, 84, 99], axis=0)
    sig = 0.5 * (q[3] - q[1])
    z = (q[2] - truth) / np.maximum(sig, 1e-12)
    in98 = (truth >= q[0]) & (truth <= q[4])

    lines = [f"Template-fit closure: 4 runs x 32 physics templates "
             f"({n_draws} draws each), truth = guess-model coefficients "
             f"+ scales {true_scales}, 6.34% relative noise "
             f"(the likelihood's own error law)",
             f"fit: {sampler} {n_walkers} chains/walkers x {n_steps} steps, "
             f"{elapsed:.0f}s, {samples.shape[0]} kept draws",
             f"{'param':>7} {'truth':>10} {'med':>10} {'sig':>9} "
             f"{'z':>6} {'in98%':>6}"]
    for d, name in enumerate(names):
        lines.append(f"{name:>7} {truth[d]:10.4g} {q[2, d]:10.4g} "
                     f"{sig[d]:9.3g} {z[d]:6.2f} "
                     f"{'yes' if in98[d] else 'NO':>6}")
    n_in = int(in98.sum())
    n_z3 = int((np.abs(z) < 3.0).sum())
    # 35 params at a 98% interval: expect ~34.3 in; allow 2 misses
    ok = n_in >= len(truth) - 2 and n_z3 >= len(truth) - 2
    lines.append(f"{n_in}/{len(truth)} params inside the 1-99% interval, "
                 f"{n_z3}/{len(truth)} with |z| < 3 -> "
                 f"{'PASS' if ok else 'FAIL'} (allow 2 misses)")
    report = "\n".join(lines)
    print(report)

    art = os.path.join(REPO, "artifacts")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "template_closure_report.txt"), "w") as f:
        f.write(report + "\n")
    with open(os.path.join(art, "template_closure_summary.json"), "w") as f:
        json.dump({"ok": bool(ok), "n_in98": n_in, "n_z_lt3": n_z3,
                   "n_params": len(truth), "worst_abs_z": float(
                       np.max(np.abs(z))),
                   "draws": n_draws, "walkers": n_walkers,
                   "steps": n_steps, "sampler": sampler}, f, indent=1)

    # the reference's final artifact: unfolded spectrum credible band
    try:
        from mcmctoffitting_tpu.utils.plotting import unfolded_spectrum_plot
        centers = (T.TEMPLATE_BOUNDS[:-1] + T.TEMPLATE_BOUNDS[1:]) / 2
        unfolded_spectrum_plot(
            centers, samples,
            run_names=["run2", "run3", "run4"],
            filename=os.path.join(art, "template_closure_unfolded.png"))
        print(f"wrote {art}/template_closure_unfolded.png")
    except Exception as e:   # plotting must not fail the closure verdict
        print(f"unfolded plot failed: {type(e).__name__}: {e}")

    print(f"wrote {art}/template_closure_report.txt")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
