"""Quickstart: fit a synthetic multi-standoff dataset end-to-end.

Mirrors the README library example at demo sizes (runs in ~1 min on CPU):

    PYTHONPATH=. python examples/quickstart.py

For the real workloads use the CLI drivers (see README):
    python -m mcmctoffitting_tpu.cli.simult_fit --help
"""
import sys

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from mcmctoffitting_tpu.models import simult
from mcmctoffitting_tpu.sampler import sample
from mcmctoffitting_tpu.utils import chain_io, data_io
from mcmctoffitting_tpu.utils.diagnostics import effective_sample_size


def main():
    key = jax.random.PRNGKey(0)
    n_walkers, n_steps, n_draws, n_runs = 32, 40, 20_000, 2

    # 1. problem: the simultFit flagship at demo sizes
    spec = simult.default_spec(n_samples=n_draws)
    problem = simult.SimultFitProblem(spec, n_runs=n_runs)

    # 2. synthetic observed data at known truth
    truth = np.concatenate([simult.GUESS_SHARED, np.full(n_runs, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 0),
                                           problem, truth)

    # 3. sample the joint posterior with the native stretch-move ensemble
    logp = problem.make_log_prob_fn(observed)
    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               n_walkers, observed)
    chain = sample(jax.random.fold_in(key, 2), p0, n_steps, logp)

    # 4. report
    names = ["beamE", "eLoss", "scale", "s"] + [
        f"N{i+1}" for i in range(n_runs)]
    samples = np.asarray(chain.positions[n_steps // 2:]).reshape(
        -1, problem.n_dim)
    q = np.percentile(samples, [16, 50, 84], axis=0)
    print("posterior (median +sigma -sigma) vs truth:")
    for d, name in enumerate(names):
        print(f"  {name:>6} = {q[1, d]:10.4g} "
              f"+{q[2, d] - q[1, d]:.3g} -{q[1, d] - q[0, d]:.3g}"
              f"   (truth {truth[d]:g})")
    print(f"acceptance: {float(np.mean(chain.acceptance_fraction)):.3f}")
    print("ESS:", [int(v) for v in
                   effective_sample_size(np.asarray(chain.positions))])

    # 5. persist: emcee-compatible text + exact-resume checkpoint
    chain_io.append_chain_text("quickstart_chain.dat",
                               np.asarray(chain.positions),
                               np.asarray(chain.log_probs), mode="w")
    chain_io.save_checkpoint("quickstart.ckpt.npz", chain.state)
    print("wrote quickstart_chain.dat + quickstart.ckpt.npz")


if __name__ == "__main__":
    main()
