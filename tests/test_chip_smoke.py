"""chip_smoke.py's contract and its checks, rehearsed on the CPU.

The checks run here at reduced draws / walker counts with the XLA paths
(and the TOF kernel in interpret mode); ``python chip_smoke.py`` runs the
same functions on the GPU at the flagship's full width.  Tests that need
the card carry the ``chip`` marker and skip here.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from mcmctoffitting_tpu.constants import tof_windows, tof_windows_onebd
from mcmctoffitting_tpu.models import forward, onebd, simult
from mcmctoffitting_tpu.ops.pallas_tof import make_tof_hist_segments
from mcmctoffitting_tpu.ops.reference_np import tof_hist_np

REPO = cs.REPO


def test_exits_nonzero_without_gpu():
    """Under JAX_PLATFORMS=cpu the smoke refuses: non-zero exit and no
    ``ok`` line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_result_line_format():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


_WINDOWS = ([("simult", name) for name in
             ("close", "mid", "far", "production")]
            + [("onebd", name) for name in ("close", "mid", "far")])


@pytest.mark.parametrize("preset,window", _WINDOWS)
def test_tof_stage_matches_histogram_reference(preset, window):
    """Each production TOF window: the XLA stage and the kernel (interpret
    mode) vs the f64-summed np.histogram reference, on real lattices."""
    if preset == "simult":
        spec = simult.default_spec(n_samples=20_000)
        win = tof_windows[window]
        standoff = spec.geometry.standoff(window)
        e0m = 1000.0
    else:
        spec = onebd.default_spec(n_samples=20_000)
        win = tof_windows_onebd[window]
        standoff = spec.geometry.standoff(window)
        e0m = 1100.0
    rng = np.random.default_rng(len(window))
    base = np.stack([np.asarray(forward.cell_tof_lattice(
        spec, standoff, jnp.float32(e0m + d))) for d in (-3.0, 4.0)])
    draws = np.rint(rng.uniform(0.0, 400.0, base.shape)).astype(np.float32)
    zt, zw = (np.asarray(t) for t in forward._tof_spread(spec))
    want = np.stack([tof_hist_np(b[None], d[None], zt, zw, (win,))
                     for b, d in zip(base, draws)])
    assert want.sum() > 0, "lattice misses the window"
    xla = jax.vmap(lambda b, d: forward.tof_histogram_xla(
        spec, b[None], d[None], zt, zw, (win,)))(base, draws)
    kern = make_tof_hist_segments((win,), base.shape[1], base.shape[2],
                                  zt.shape[1], interpret=True)
    got_k = jax.vmap(lambda b, d: kern(b[None], d[None], zt, zw))(
        base, draws)
    for got in (xla, got_k):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                   atol=1e-6 * want.max())


@pytest.mark.parametrize("lam", [2.5, 40.0, 2.0e4])
def test_poisson_ptrs_moments_counts_shape(lam):
    """poisson_ptrs at the counts-cell shape (W, 4 runs, F + 2 = 514):
    inversion branch, PTRS, and large-rate PTRS, vs scipy's moments."""
    zs = cs.check_poisson(n_walkers=4, lams=(lam,))
    z_mean, z_var = zs[lam]
    assert abs(z_mean) <= 5.0 and abs(z_var) <= 5.0


@pytest.mark.parametrize("config", ["simult mc", "simult counts",
                                    "oneBD default", "oneBD hardcore"])
def test_forward_matches_f64_reference(config):
    """The four flagship configurations at reduced draws: grid, lattice
    and spectra vs the f64 host reference, under chip_smoke's
    tolerances."""
    problem = cs.problems(n_draws=4096)[config]
    errs = cs.check_forward(problem, config, n_walkers=2)
    assert errs["grid"] <= (cs.TOL_GRID_MC
                            if problem.spec.sampling == "mc" else cs.TOL_A)
    assert errs["lattice"] <= cs.TOL_LATTICE
    assert errs["spectra"] <= cs.TOL_SPECTRA


def test_a_contraction_check_runs_at_reduced_width():
    """Phase 1's A-contraction check (f32 exact on the CPU backend)."""
    problem = cs.problems(n_draws=4096)["simult counts"]
    err, _ = cs.check_a_contraction(problem, "simult counts", n_walkers=4)
    assert err <= cs.TOL_A


@pytest.mark.chip
def test_tof_kernel_compiled_matches_reference(gpu):
    """The compiled Triton kernel at the simult flagship width."""
    problem = cs.problems()["simult counts"]
    assert cs.check_tof_stage(problem, "simult") <= cs.TOL_TOF
