"""Summarize the oneBD background-mode A/B: posterior z-scores vs truth.

Reads the chains written by onebd_convergence_study.sh and prints, for
each mode and parameter, the posterior median, the +/- 1 sigma interval,
and the z-score of the synthesis truth.  numpy-only (no jax) so it can
run alongside a GPU job without opening the card.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mcmctoffitting_tpu.utils import chain_io

TRUTH = {"eLoss": 1300.0, "scale": 80.0, "s": 0.6,
         "N1": 5e4, "N2": 5e4, "N3": 5e4,
         "BG1": 20.0, "BG2": 20.0, "BG3": 20.0}


def report(prefix: str) -> dict:
    chain, probs, n_params, n_walkers, n_steps = chain_io.read_chain_text(
        prefix + "mainchain.dat")
    flat = chain.reshape(-1, n_params)
    q = np.percentile(flat, [16, 50, 84], axis=0)
    out = {}
    print(f"\n{prefix}: {n_steps} main steps x {n_walkers} walkers")
    print(f"{'param':>6} {'median':>12} {'+sig':>10} {'-sig':>10} "
          f"{'truth':>10} {'z':>7}")
    for d, name in enumerate(TRUTH):
        med = q[1, d]
        hi = q[2, d] - q[1, d]
        lo = q[1, d] - q[0, d]
        sigma = 0.5 * (hi + lo)
        z = (med - TRUTH[name]) / sigma if sigma > 0 else float("inf")
        out[name] = z
        print(f"{name:>6} {med:12.4g} {hi:10.3g} {lo:10.3g} "
              f"{TRUTH[name]:10.4g} {z:7.2f}")
    worst = max(out, key=lambda k: abs(out[k]))
    print(f"worst |z|: {worst} = {out[worst]:.2f}")
    return out


if __name__ == "__main__":
    base = sys.argv[1] if len(sys.argv) > 1 else "out/detbg_study"
    for mode in ("detbg_", "faithful_"):
        p = os.path.join(base, mode)
        if os.path.exists(p + "mainchain.dat"):
            report(p)
        else:
            print(f"(missing {p}mainchain.dat — run the study first)")
