"""Sharded FULL-FIT posterior parity: complete simultFit, mesh vs local.

VERDICT r3 item 3 — beyond per-step sharding checks (tests/
test_sharding.py), run one reduced-but-complete simultaneous fit
(burn-in phase -> checkpoint -> resume -> main phase, counts estimator)
twice with identical seeds: walker axis sharded over the virtual 8-device
CPU mesh, and unsharded on one device.  The stretch move's bookkeeping is
replicated and only the per-walker log-prob evaluation is sharded, so the
two chains must be IDENTICAL (bitwise); posterior quantiles of the main
phase are recorded as the soundness artifact (SURVEY.md §2.4's walker
parallelism requirement).

Default config mirrors the VERDICT ask: 64 walkers, 200 burn-in + 100
main steps, counts sampling, 4 runs.  Reference pathway being replaced:
the MPI full-fit loop ``/root/reference/tests/mpiTOFmodel.py:199-236``.

Run:  python tools/sharded_fullfit_parity.py
Writes: artifacts/sharded_fullfit_parity.json
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

# self-provision the virtual mesh BEFORE jax import.  FORCE cpu: on a
# one-GPU host the study would silently degrade to a 1-device mesh
# (sharded == local trivially).  Under pytest the conftest already did
# both.
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

PARAM_NAMES = ["beamE", "eLoss", "scale", "s"]


def run_protocol(n_walkers: int = 64, n_burnin: int = 200,
                 n_main: int = 100, n_draws: int = 200_000,
                 n_runs: int = 4, seed: int = 0) -> dict:
    # n_draws default = the flagship 200k: counts-mode cost is O(F),
    # INDEPENDENT of the draw count, while the pseudo-marginal logp noise
    # shrinks with it — the full-scale config is no slower than a tiny one
    """Run the complete fit sharded AND local; return the parity record.

    Both phases advance under ``lax.scan``; between them the state round-
    trips through a ``.npz`` checkpoint (the resume path).  Raises
    AssertionError on any sharded/local divergence.
    """
    import jax

    # jax may have been imported before this module's env overrides ran
    # (under pytest, by a plugin) — override the already-read config
    # directly; backends initialize lazily so this still takes effect
    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", False)

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.parallel import (make_mesh,
                                             make_sharded_logp_batch)
    from mcmctoffitting_tpu.sampler import init_state, run_mcmc
    from mcmctoffitting_tpu.sampler.stretch import make_logp_batch
    from mcmctoffitting_tpu.utils import chain_io, data_io

    mesh = make_mesh(jax.devices())
    n_dev = mesh.devices.size
    if n_dev < 2:
        raise RuntimeError(
            f"only {n_dev} device(s) visible — the sharded-vs-local "
            "comparison would be vacuous; run with the virtual CPU mesh "
            "(the module header provisions it when run as a script)")

    spec = simult.default_spec(n_samples=n_draws, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=n_runs,
                                      likelihood="poisson")
    key = jax.random.PRNGKey(seed)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(n_runs, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 99),
                                           problem, truth)
    logp = problem.make_log_prob_fn(observed)
    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               n_walkers, observed)

    def full_fit(logp_batch):
        """burn-in -> checkpoint -> resume -> main, one evaluator."""
        seg = jax.jit(lambda s, n: run_mcmc(s, n, logp_batch),
                      static_argnums=1)
        state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
        burn = seg(state, n_burnin)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "fit.ckpt.npz")
            chain_io.save_checkpoint(ckpt, burn.state)
            resumed, _ = chain_io.load_checkpoint(ckpt)
        main = seg(resumed, n_main)
        jax.block_until_ready((burn.positions, main.positions))
        return burn, main

    t0 = time.time()
    burn_l, main_l = full_fit(make_logp_batch(logp))
    t_local = time.time() - t0
    t0 = time.time()
    burn_s, main_s = full_fit(make_sharded_logp_batch(logp, mesh))
    t_shard = time.time() - t0

    record = {"n_devices": int(n_dev), "n_walkers": n_walkers,
              "n_burnin": n_burnin, "n_main": n_main, "n_draws": n_draws,
              "n_runs": n_runs, "sampling": "counts",
              "likelihood": "poisson", "seed": seed,
              "wall_s_local": round(t_local, 2),
              "wall_s_sharded": round(t_shard, 2)}

    for phase, c_l, c_s in (("burnin", burn_l, burn_s),
                            ("main", main_l, main_s)):
        lp = np.asarray(c_s.log_probs)
        assert np.all(np.isfinite(lp)), f"{phase}: non-finite sharded logp"
        assert np.array_equal(np.asarray(c_l.positions),
                              np.asarray(c_s.positions)), (
            f"{phase}: sharded chain != local chain")
        record[f"{phase}_bitwise"] = True
        record[f"{phase}_acceptance_mean"] = round(
            float(np.mean(np.asarray(c_s.acceptance_fraction))), 4)

    names = PARAM_NAMES + [f"N{i + 1}" for i in range(n_runs)]
    flat = np.asarray(main_s.positions).reshape(-1, problem.n_dim)
    q = np.percentile(flat, [16, 50, 84], axis=0)
    record["main_quantiles"] = {
        n: [float(q[0, d]), float(q[1, d]), float(q[2, d])]
        for d, n in enumerate(names)}
    record["truth"] = {n: float(truth[d]) for d, n in enumerate(names)}
    return record


def main(argv=None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nWalkers", type=int, default=64)
    p.add_argument("--nBurnin", type=int, default=200)
    p.add_argument("--nMain", type=int, default=100)
    p.add_argument("--nDraws", type=int, default=200_000)
    p.add_argument("--nRuns", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "artifacts",
        "sharded_fullfit_parity.json"))
    args = p.parse_args(argv)

    rec = run_protocol(args.nWalkers, args.nBurnin, args.nMain,
                       args.nDraws, args.nRuns, args.seed)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
