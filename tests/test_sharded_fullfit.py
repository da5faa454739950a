"""Sharded full-fit posterior parity.

A complete (burn-in -> checkpoint -> resume -> main) simultFit on the
virtual 8-device mesh must produce chains IDENTICAL to the single-device
run with the same seeds — the soundness requirement for walker-axis data
parallelism (SURVEY.md §2.4; the reference's moral equivalent is the
full MPI fit loop, ``tests/mpiTOFmodel.py:199-236``).

The committed artifact ``artifacts/sharded_fullfit_parity.json`` records
the full-scale run (64 walkers, 200+100 steps); this in-suite version
shrinks the step counts to stay fast while exercising every phase of the
same protocol via the same code path.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from sharded_fullfit_parity import run_protocol  # noqa: E402


def test_sharded_fullfit_bitwise_and_quantiles():
    # 200k draws: counts-mode cost is O(F) (draw-independent) and the
    # lower pseudo-marginal noise keeps the short chain live
    rec = run_protocol(n_walkers=64, n_burnin=40, n_main=20,
                       n_draws=200_000, n_runs=2, seed=0)
    # run_protocol asserts bitwise parity internally; re-assert the record
    assert rec["burnin_bitwise"] and rec["main_bitwise"]
    # the chain is live (walkers actually move) and quantiles are sane
    assert rec["main_acceptance_mean"] > 0.05
    q = rec["main_quantiles"]
    assert set(q) == {"beamE", "eLoss", "scale", "s", "N1", "N2"}
    for name, (lo, med, hi) in q.items():
        assert np.isfinite([lo, med, hi]).all()
        assert lo <= med <= hi
    # a 60-step chain from the guess cloud stays in the physical box
    assert 1700.0 <= q["beamE"][1] <= 2100.0
