"""Multi-device walker sharding, end to end, on any machine.

The reference scales walker evaluation with a thread pool or MPI
(``tests/simultFit.py:688-718``); here the walker axis is a device-mesh
array axis — `shard_map` splits the per-walker likelihood evaluations
across every visible chip and XLA inserts the one tiny all-gather the
stretch move needs.  The SAME code runs on 1 GPU, the 4 GPUs of a host, or —
as below — a virtual 8-device CPU mesh, so you can validate sharded
programs anywhere:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python examples/sharded_fit.py

On a multi-GPU host drop both env vars.  On the CPU mesh, sharded and
local chains are bitwise identical (tests/test_sharding.py pins this).
"""
import jax
import jax.numpy as jnp
import numpy as np

from mcmctoffitting_tpu.models import simult
from mcmctoffitting_tpu.parallel import make_mesh, make_sharded_logp_batch
from mcmctoffitting_tpu.sampler import init_state, run_mcmc
from mcmctoffitting_tpu.utils import data_io


def main():
    key = jax.random.PRNGKey(0)
    devices = jax.devices()
    mesh = make_mesh(devices)
    # walker count must divide evenly over the mesh
    n_walkers = 8 * len(devices)
    n_steps, n_runs = 40, 2

    spec = simult.default_spec(n_samples=20_000, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=n_runs,
                                      likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(n_runs, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 0),
                                           problem, truth)

    # the ONLY sharding-specific line: wrap the scalar logp into a batch
    # evaluator whose walker axis lives on the mesh
    logp_batch = make_sharded_logp_batch(problem.make_log_prob_fn(observed),
                                         mesh)

    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               n_walkers, observed)
    state = init_state(jax.random.fold_in(key, 2), p0, logp_batch)
    chain = run_mcmc(state, n_steps, logp_batch)

    samples = np.asarray(chain.positions[n_steps // 2:]).reshape(
        -1, problem.n_dim)
    med = np.median(samples, axis=0)
    print(f"devices: {len(devices)} x {devices[0].platform}; "
          f"{n_walkers} walkers sharded over the mesh")
    print("posterior medians vs truth:")
    for name, m, t in zip(["beamE", "eLoss", "scale", "s", "N1", "N2"],
                          med, truth):
        print(f"  {name:>6} = {m:10.4g}   (truth {t:g})")


if __name__ == "__main__":
    main()
