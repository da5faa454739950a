"""Fast e2e smoke of both flagship ``main()``s in the default suite.

The full CLI wiring (arg parsing -> spec/problem build
-> synthetic data -> burn-in + main phases -> chain files -> quantile
report) must be exercised WITHOUT ``-m slow``, so a driver regression is
caught on every run.  Tiny everything: 4 walkers, 5+5 steps, 2k draws,
counts estimator.  The statistically meaningful e2e checks live in the
slow-marked ``test_tsv_e2e.py`` / ``test_e2e_simple.py``.
"""
import numpy as np


def _smoke_args(prefix):
    return ["-nWalkers", "4", "-nBurninSteps", "5", "-nMainSteps", "5",
            "-nDrawsPerEval", "2000", "-sampling", "counts",
            "-likelihood", "poisson", "-batch", "1", "-segment", "5",
            "-outputPrefix", prefix]


def _check(out, tmp_path, prefix, expected_params):
    from mcmctoffitting_tpu.utils import chain_io

    q = out["quantiles"]
    assert set(q) == expected_params
    assert all(np.isfinite(v).all() for v in q.values())
    assert np.isfinite(out["walker_steps_per_sec"])
    for phase, n_steps in (("burninchain", 5), ("mainchain", 5)):
        chain, probs, n_params, n_walkers, got_steps = \
            chain_io.read_chain_text(str(tmp_path / f"{prefix}{phase}.dat"))
        assert (n_walkers, got_steps) == (4, n_steps)
        assert n_params == len(expected_params)
        assert np.isfinite(probs).all()


def test_simult_fit_main_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from mcmctoffitting_tpu.cli.simult_fit import main

    out = main(["-nRuns", "2"] + _smoke_args("smoke_"))
    _check(out, tmp_path, "smoke_",
           {"beamE", "eLoss", "scale", "s", "N1", "N2"})


def test_csi_onebd_main_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from mcmctoffitting_tpu.cli.csi_onebd import main

    out = main(_smoke_args("smoke_"))
    _check(out, tmp_path, "smoke_",
           {"eLoss", "scale", "s", "N1", "N2", "N3", "BG1", "BG2", "BG3"})
