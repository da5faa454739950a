"""One-hot matmul histogram vs np.histogram semantics."""
import jax
import numpy as np
import pytest

from mcmctoffitting_tpu.ops.histogram import (histogram_density,
                                              weighted_histogram)


@pytest.mark.parametrize("method", ["onehot", "scatter"])
def test_matches_numpy_histogram(method):
    rng = np.random.default_rng(11)
    vals = rng.uniform(-1.0, 11.0, 5000).astype(np.float32)  # incl. out-of-range
    w = rng.uniform(0.0, 3.0, 5000).astype(np.float32)
    got = np.asarray(weighted_histogram(vals, 0.0, 10.0, 25, w,
                                        method=method, chunk=512))
    want, _ = np.histogram(vals, bins=25, range=(0.0, 10.0), weights=w)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-5,
                               atol=1e-3)


def test_unweighted_counts():
    rng = np.random.default_rng(5)
    vals = rng.normal(5, 2, 4097).astype(np.float32)
    got = np.asarray(weighted_histogram(vals, 0.0, 10.0, 20))
    want, _ = np.histogram(vals, bins=20, range=(0.0, 10.0))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_right_edge_in_last_bin():
    vals = np.array([10.0, 0.0, 9.9999], dtype=np.float32)
    got = np.asarray(weighted_histogram(vals, 0.0, 10.0, 10))
    assert got[-1] == 2.0  # value == hi included (np.histogram semantics)
    assert got[0] == 1.0


def test_batched_leading_dims():
    rng = np.random.default_rng(2)
    vals = rng.uniform(0, 1, (3, 4, 1000)).astype(np.float32)
    w = rng.uniform(0, 1, (3, 4, 1000)).astype(np.float32)
    got = np.asarray(weighted_histogram(vals, 0.0, 1.0, 16, w, chunk=128))
    assert got.shape == (3, 4, 16)
    for i in range(3):
        for j in range(4):
            want, _ = np.histogram(vals[i, j], 16, (0.0, 1.0),
                                   weights=w[i, j])
            np.testing.assert_allclose(got[i, j], want, rtol=1e-4, atol=1e-3)


def test_density_conversion():
    rng = np.random.default_rng(8)
    vals = rng.uniform(0, 10, 2000).astype(np.float32)
    h = weighted_histogram(vals, 0.0, 10.0, 25)
    d = np.asarray(histogram_density(h, 0.0, 10.0))
    want, _ = np.histogram(vals, 25, (0.0, 10.0), density=True)
    np.testing.assert_allclose(d, want, rtol=1e-4)
    np.testing.assert_allclose(d.sum() * (10.0 / 25), 1.0, rtol=1e-5)


def test_jittable_and_grad_safe():
    f = jax.jit(lambda v, w: weighted_histogram(v, 0.0, 1.0, 8, w, chunk=64))
    v = np.random.default_rng(0).uniform(0, 1, 300).astype(np.float32)
    w = np.ones(300, np.float32)
    out = np.asarray(f(v, w))
    want, _ = np.histogram(v, 8, (0.0, 1.0), weights=w)
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_delta_moment_histogram_matches_manual():
    from mcmctoffitting_tpu.ops.histogram import delta_moment_histogram
    rng = np.random.default_rng(7)
    v = rng.uniform(-0.2, 1.2, (3, 5000)).astype(np.float32)
    lo, hi, nb = 0.0, 1.0, 20
    got = np.asarray(delta_moment_histogram(v, lo, hi, nb, n_moments=4,
                                            chunk=512))
    assert got.shape == (3, 4, nb)
    w = (hi - lo) / nb
    for r in range(3):
        vr = v[r]
        inr = (vr >= lo) & (vr <= hi)
        idx = np.clip(((vr - lo) / w).astype(int), 0, nb - 1)
        delta = (vr - lo) / w - idx - 0.5
        for p in range(4):
            want = np.bincount(idx[inr], weights=(delta ** p)[inr],
                               minlength=nb)
            np.testing.assert_allclose(got[r, p], want, rtol=2e-4,
                                       atol=2e-3)


def test_delta_moment_histogram_extra_weight():
    from mcmctoffitting_tpu.ops.histogram import delta_moment_histogram
    rng = np.random.default_rng(8)
    v = rng.uniform(0, 1, (2, 1000)).astype(np.float32)
    ew = rng.uniform(0, 3, (2, 1000)).astype(np.float32)
    got = np.asarray(delta_moment_histogram(v, 0.0, 1.0, 10, n_moments=2,
                                            chunk=256, extra_weight=ew))
    for r in range(2):
        idx = np.clip((v[r] * 10).astype(int), 0, 9)
        want0 = np.bincount(idx, weights=ew[r], minlength=10)
        np.testing.assert_allclose(got[r, 0], want0, rtol=2e-4, atol=1e-2)


def test_delta_moment_zeroth_equals_counts():
    from mcmctoffitting_tpu.ops.histogram import delta_moment_histogram
    rng = np.random.default_rng(9)
    v = rng.uniform(0, 1, (1, 3000)).astype(np.float32)
    got = np.asarray(delta_moment_histogram(v, 0.0, 1.0, 25))
    want, _ = np.histogram(v[0], 25, (0.0, 1.0))
    np.testing.assert_array_equal(got[0, 0], want.astype(np.float32))


def test_multi_window_matches_per_run_np_histogram():
    """Heterogeneous static windows binned in one one-hot pass must match
    np.histogram run-by-run (incl. the value == hi last-bin rule)."""
    from mcmctoffitting_tpu.constants import TofWindow
    from mcmctoffitting_tpu.ops.histogram import (
        weighted_histogram_multi_window)
    windows = (TofWindow(130.0, 175.0, 45), TofWindow(175.0, 225.0, 50),
               TofWindow(190.0, 260.0, 70), TofWindow(195.0, 260.0, 65))
    rng = np.random.default_rng(10)
    v = rng.uniform(100.0, 280.0, (4, 777)).astype(np.float32)
    # plant exact hi-edge and out-of-range values
    v[:, 0] = [w.hi for w in windows]
    v[:, 1] = [w.lo for w in windows]
    v[:, 2] = [w.hi + 1.0 for w in windows]
    w_ = rng.uniform(0.0, 5.0, (4, 777)).astype(np.float32)
    got = np.asarray(weighted_histogram_multi_window(v, windows, w_,
                                                     chunk=128))
    assert got.shape == (4, 70)
    for r, win in enumerate(windows):
        want, _ = np.histogram(v[r], win.n_bins, (win.lo, win.hi),
                               weights=w_[r])
        np.testing.assert_allclose(got[r, : win.n_bins], want, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(got[r, win.n_bins:], 0.0)


@pytest.mark.parametrize("radix", [4, 8, 16])
def test_radix_factorization_matches_direct(radix):
    """The idx = q*L + r factorized one-hot (ForwardSpec.tof_hist_radix)
    is the same histogram: each sample hits exactly one (q, r) cell, so
    only the f32 summation tree differs from the direct path."""
    rng = np.random.default_rng(31)
    vals = rng.uniform(-1.0, 11.0, 5003).astype(np.float32)
    w = rng.uniform(0.0, 3.0, 5003).astype(np.float32)
    # 25 bins: not divisible by any of the radices (exercises the
    # ceil(n/L) padding + final slice)
    direct = np.asarray(weighted_histogram(vals, 0.0, 10.0, 25, w,
                                           chunk=512))
    fact = np.asarray(weighted_histogram(vals, 0.0, 10.0, 25, w,
                                         chunk=512, radix=radix))
    np.testing.assert_allclose(fact, direct, rtol=2e-6, atol=1e-3)
    want, _ = np.histogram(vals, bins=25, range=(0.0, 10.0), weights=w)
    np.testing.assert_allclose(fact, want.astype(np.float32), rtol=2e-5,
                               atol=1e-3)


def test_radix_multi_window_and_batched():
    """Radix engine under the multi-window padded path + leading batch
    dims (the actual TOF-synthesis shape: walkers x runs x samples)."""
    from mcmctoffitting_tpu.constants import TofWindow
    from mcmctoffitting_tpu.ops.histogram import (
        weighted_histogram_multi_window)
    windows = (TofWindow(130.0, 175.0, 45), TofWindow(190.0, 260.0, 70))
    rng = np.random.default_rng(12)
    v = rng.uniform(100.0, 280.0, (2, 600)).astype(np.float32)
    v[:, 0] = [w.hi for w in windows]          # hi-edge -> last true bin
    w_ = rng.uniform(0.0, 5.0, (2, 600)).astype(np.float32)
    direct = np.asarray(weighted_histogram_multi_window(v, windows, w_,
                                                        chunk=128))
    fact = np.asarray(weighted_histogram_multi_window(v, windows, w_,
                                                      chunk=128, radix=8))
    np.testing.assert_allclose(fact, direct, rtol=2e-6, atol=1e-4)
    np.testing.assert_array_equal(fact[0, 45:], 0.0)   # padding stays zero

    # leading batch dims through weighted_histogram
    vb = rng.uniform(0, 1, (3, 2, 257)).astype(np.float32)
    wb = rng.uniform(0, 1, (3, 2, 257)).astype(np.float32)
    d = np.asarray(weighted_histogram(vb, 0.0, 1.0, 16, wb, chunk=64))
    f = np.asarray(weighted_histogram(vb, 0.0, 1.0, 16, wb, chunk=64,
                                      radix=8))
    np.testing.assert_allclose(f, d, rtol=2e-6, atol=1e-4)


def test_tof_hist_radix_spec_knob():
    """tof_spectrum under tof_hist_radix reproduces the direct-engine
    spectrum (same draws, same lattice; only the histogram engine
    changes).  The direct path is pinned explicitly — the simult preset
    now DEFAULTS to radix 16, so both engines are exercised end to end."""
    import dataclasses

    import jax.numpy as jnp

    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.models.forward import tof_spectrum

    spec0 = simult.default_spec(n_samples=2000)
    spec = dataclasses.replace(spec0, tof_hist_radix=0)     # direct
    problem = simult.SimultFitProblem(spec, n_runs=1)
    theta = jnp.asarray([1878.4, 850.0, 170.0, 0.5], jnp.float32)
    key = jax.random.PRNGKey(7)
    base = np.asarray(tof_spectrum(key, theta, spec, problem.standoffs[0],
                                   problem.windows[0], get_pdf=True))
    for radix in (8, 16):
        spec_r = dataclasses.replace(spec, tof_hist_radix=radix)
        got = np.asarray(tof_spectrum(key, theta, spec_r,
                                      problem.standoffs[0],
                                      problem.windows[0], get_pdf=True))
        np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-7)
