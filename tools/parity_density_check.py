"""Direct density parity: logp_ours(theta) - logp_ref(theta) over the
posterior region (the decisive complement to chain-vs-chain dz).

The 4-run chain comparison (tools/reference_posterior_parity.py) leaves
~1.5-1.8 pooled-sigma median offsets confined to the degenerate
(eLoss, scale, s) ridge, where an 18-walker stretch ensemble at
acc ~0.2 mixes slowest — chain-level statistics cannot distinguish
"the samplers haven't traversed the ridge" from "the codes disagree".
This check removes the samplers entirely: evaluate BOTH codes' joint
log-posterior at the SAME thetas (drawn from both chains' retained
samples, i.e. spanning the disputed region).  If the two
implementations define the same posterior density, the difference
Delta(theta) = logp_ours - logp_ref is CONSTANT in theta (additive
normalization aside); its centered spread measures real density
disagreement in nats, against the reference side's own Monte-Carlo
repeat-eval noise as the floor.

Ours side: the closed-form 'expected' forward (the exact infinite-draw
limit of the shared estimator family) with the same corrected Poisson
likelihood the parity study uses on both sides.

Usage (after the parity study's prepare/reference/ours stages):
  PARITY_LIKELIHOOD=poisson PARITY_RUNS=4 PARITY_DRAWS=50000 \
    python tools/parity_density_check.py [--thetas N] [--repeats K]
Writes artifacts/parity_density_check_r{N_RUNS}runs.json.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import reference_posterior_parity as P  # noqa: E402  (tools/ sibling)


def _arg(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


def main() -> int:
    n_thetas = _arg("--thetas", 48)
    n_rep = _arg("--repeats", 6)

    observed = P._load_observed()

    # thetas spanning both chains' retained regions (incl. the ridge)
    ref_chain = np.load(os.path.join(P.OUT, "reference_chain.npz"))["chain"]
    ours_chain = np.load(os.path.join(P.OUT, "ours_chain.npz"))["chain"]
    burn = P.N_MAIN // 4
    rng = np.random.default_rng(11)
    pool = np.concatenate([ref_chain[burn:].reshape(-1, 4 + P.N_RUNS),
                           ours_chain[burn:].reshape(-1, 4 + P.N_RUNS)])
    thetas = pool[rng.choice(len(pool), n_thetas, replace=False)]

    # ---- reference side: its own kernels, repeat evals for the noise
    ref = P._load_reference_modules()
    lnprob_ref = P.make_reference_lnprob(ref, observed)
    print(f"reference lnprob at {n_thetas} thetas "
          f"(+{n_rep} repeats at one theta)...", flush=True)
    ref_vals = np.array([lnprob_ref(t) for t in thetas])
    ref_noise = np.std([lnprob_ref(thetas[0]) for _ in range(n_rep)],
                       ddof=1)

    # ---- ours: closed-form expected forward, same corrected likelihood
    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    from mcmctoffitting_tpu.models import simult

    spec = simult.default_spec(n_samples=P.N_DRAWS, sampling="expected")
    problem = simult.SimultFitProblem(spec, n_runs=P.N_RUNS,
                                      likelihood=P.LIKELIHOOD)
    logp = problem.make_log_prob_fn(observed)
    f = jax.jit(lambda t: logp(t, jax.random.PRNGKey(0)))
    ours_vals = np.array([float(f(jnp.asarray(t, jnp.float32)))
                          for t in thetas])

    delta = ours_vals - ref_vals
    finite = np.isfinite(delta)
    d = delta[finite]
    spread = float(np.std(d, ddof=1))
    # correlation of the residual with each parameter: a code
    # disagreement CONFINED to the ridge would show up here even if the
    # overall spread were small
    corrs = {}
    for i, name in enumerate(P.PARAM_NAMES):
        c = np.corrcoef(thetas[finite][:, i], d)[0, 1]
        corrs[name] = round(float(c), 3)
    ok = spread < max(5.0 * ref_noise, 1.0)
    lines = [
        f"Density parity, {P.N_RUNS} runs x {P.N_DRAWS} draws "
        f"[{P.LIKELIHOOD}]: logp_ours(expected) - logp_ref(own kernels) "
        f"at {int(finite.sum())}/{n_thetas} finite thetas from both "
        "chains' posterior samples",
        f"mean offset {float(np.mean(d)):+.2f} nats (normalization; "
        "irrelevant), centered spread "
        f"{spread:.3f} nats",
        f"reference repeat-eval MC noise at one theta: "
        f"{ref_noise:.3f} nats (the floor)",
        f"per-parameter residual correlations: {corrs}",
        f"-> {'PASS' if ok else 'REVIEW'} (spread < max(5x ref MC noise, "
        "1 nat): the two codes define the same posterior density; "
        "remaining chain-level dz is finite-chain mixing)",
    ]
    text = "\n".join(lines)
    print(text)
    art = os.path.join(REPO, "artifacts")
    os.makedirs(art, exist_ok=True)
    out = os.path.join(art, f"parity_density_check_r{P.N_RUNS}runs.json")
    with open(out, "w") as fjson:
        json.dump({"ok": bool(ok), "spread_nats": spread,
                   "ref_mc_noise_nats": float(ref_noise),
                   "mean_offset_nats": float(np.mean(d)),
                   "n_thetas": int(finite.sum()),
                   "correlations": corrs, "report": text}, fjson, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
