"""Fused TOF-synthesis Pallas-Triton kernel (interpret mode on CPU).

The kernel is deterministic (no PRNG, no atomics), so interpret mode pins
its full semantics here: equivalence with the f64 histogram reference,
parity with the XLA expand-then-contract path, the np.histogram edge
cases, the (nested-)vmap collapse rule and the gradient rule.  The
compiled kernel is compared with the same reference on the GPU by
``chip_smoke.py`` (phase 1); its times are in PERF.md.

Reference semantics: the TOF-synthesis loop ``tests/simultFit.py:286-296``
under the 10-segment zero-degree spread (``utilities/utilities.py:154``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mcmctoffitting_tpu.constants import TofWindow
from mcmctoffitting_tpu.ops.histogram import (
    weighted_histogram_multi_window)
from mcmctoffitting_tpu.ops.pallas_tof import make_tof_hist_segments
from mcmctoffitting_tpu.ops.reference_np import tof_hist_np

WINDOWS = (TofWindow(175.0, 225.0, 50), TofWindow(130.0, 175.0, 45),
           TofWindow(190.0, 260.0, 70))
M, BE, K = 7, 23, 5


def _problem(seed, w_batch=None):
    rng = np.random.default_rng(seed)
    shape = (len(WINDOWS), M, BE)
    if w_batch is not None:
        shape = (w_batch,) + shape
    base = rng.uniform(120.0, 270.0, shape).astype(np.float32)
    draws = rng.uniform(0.0, 50.0, shape).astype(np.float32)
    zt = rng.uniform(-6.0, 6.0, (BE, K)).astype(np.float32)
    zw = rng.uniform(0.0, 1.0, (BE, K)).astype(np.float32)
    return base, draws, zt, zw


def _oracle(base, draws, zt, zw):
    """f64-summed histogram of the expanded (M, Be, K) samples, per run."""
    return tof_hist_np(base, draws, zt, zw, WINDOWS)


def _fn():
    return make_tof_hist_segments(WINDOWS, M, BE, K, interpret=True)


def test_matches_histogram_oracle():
    base, draws, zt, zw = _problem(0)
    got = np.asarray(_fn()(base, draws, jnp.asarray(zt), jnp.asarray(zw)))
    want = _oracle(base, draws, zt, zw)
    # f32 weights and f32 sums of <= a few hundred products per bin
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * want.max())


def test_matches_xla_backend_closely():
    """Same binning as the XLA radix path (exact f32 on the CPU backend):
    the two paths agree to f32 summation order."""
    base, draws, zt, zw = _problem(1)
    got = np.asarray(_fn()(base, draws, jnp.asarray(zt), jnp.asarray(zw)))
    values = base[..., None] + zt
    weights = draws[..., None] * zw
    xla = np.asarray(weighted_histogram_multi_window(
        values.reshape(len(WINDOWS), -1), WINDOWS,
        weights.reshape(len(WINDOWS), -1), chunk=4096, radix=16))
    np.testing.assert_allclose(got, xla, rtol=1e-5,
                               atol=1e-6 * xla.max())


def test_histogram_edge_semantics():
    """value == hi lands in the last bin; out-of-range drops; padding
    bins beyond each window's n_bins stay exactly zero."""
    win = WINDOWS[1]
    base = np.zeros((len(WINDOWS), M, BE), np.float32)
    draws = np.zeros_like(base)
    # run 1, cell (0, 0): the K segment offsets are 0 -> v == base value
    base[1, 0, 0] = win.hi              # exactly the top edge
    base[1, 0, 1] = win.hi + 0.5        # just above: dropped
    base[1, 0, 2] = win.lo              # bottom edge: first bin
    base[1, 0, 3] = win.lo - 0.5        # just below: dropped
    draws[1, 0, :4] = 1.0
    zt = np.zeros((BE, K), np.float32)
    zw = np.zeros((BE, K), np.float32)
    zw[:4, 0] = 1.0                     # one unit-weight segment
    got = np.asarray(_fn()(base, draws, jnp.asarray(zt), jnp.asarray(zw)))
    n_pad = max(w.n_bins for w in WINDOWS)
    want = np.zeros((len(WINDOWS), n_pad), np.float32)
    want[1, win.n_bins - 1] = 1.0
    want[1, 0] = 1.0
    np.testing.assert_array_equal(got, want)


def test_vmap_collapses_batch_axes():
    base, draws, zt, zw = _problem(2, w_batch=6)
    fn = _fn()
    zt, zw = jnp.asarray(zt), jnp.asarray(zw)
    batched = np.asarray(jax.vmap(lambda b, d: fn(b, d, zt, zw))(
        jnp.asarray(base), jnp.asarray(draws)))
    looped = np.stack([np.asarray(fn(base[i], draws[i], zt, zw))
                       for i in range(6)])
    np.testing.assert_allclose(batched, looped, rtol=1e-6, atol=1e-6)

    # nested vmap (the batched-run-axis shape): (2, 3, R, M, Be)
    b2 = jnp.asarray(base.reshape(2, 3, *base.shape[1:]))
    d2 = jnp.asarray(draws.reshape(2, 3, *draws.shape[1:]))
    nested = np.asarray(
        jax.vmap(jax.vmap(lambda b, d: fn(b, d, zt, zw)))(b2, d2))
    np.testing.assert_allclose(nested.reshape(looped.shape), looped,
                               rtol=1e-6, atol=1e-6)


def test_walker_padding_rows_do_not_leak():
    """Padding of the M*Be lattice up to whole kernel slices must not
    perturb any walker's row (padding cells sit out of every window and
    carry zero weight)."""
    base, draws, zt, zw = _problem(3, w_batch=3)   # 161 cells -> 192
    fn = _fn()
    zt, zw = jnp.asarray(zt), jnp.asarray(zw)
    got = np.asarray(fn(jnp.asarray(base), jnp.asarray(draws), zt, zw))
    want = _oracle(base[1], draws[1], np.asarray(zt), np.asarray(zw))
    np.testing.assert_allclose(got[1], want, rtol=1e-5,
                               atol=1e-6 * want.max())


def test_dispatch_stays_xla_on_cpu():
    """forward.tof_histogram on CPU is the XLA path, bitwise (the CPU
    validation suites' mesh-vs-local guarantees rely on it)."""
    assert jax.default_backend() == "cpu"
    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.models.forward import (tof_histogram,
                                                   tof_histogram_xla,
                                                   tof_spectra_multi)

    base, draws, zt, zw = _problem(6)
    spec0 = simult.default_spec(n_samples=2000)
    np.testing.assert_array_equal(
        np.asarray(tof_histogram(spec0, base, draws, zt, zw, WINDOWS)),
        np.asarray(tof_histogram_xla(spec0, base, draws, zt, zw, WINDOWS)))

    spec = simult.default_spec(n_samples=2000, sampling="counts")
    problem = simult.SimultFitProblem(spec)
    keys = jax.random.split(jax.random.PRNGKey(0), problem.n_runs)
    params = jnp.asarray([1878.4, 850.0, 170.0, 0.5], jnp.float32)
    scales = jnp.full((problem.n_runs,), 5.0e4)
    out = tof_spectra_multi(keys, params, spec, problem.standoffs,
                            problem.windows, scales)
    assert all(bool(jnp.all(jnp.isfinite(s))) for s in out)


def test_bin_capacity_guard():
    with pytest.raises(ValueError):
        make_tof_hist_segments((TofWindow(0.0, 1.0, 129),), M, BE, K)


def test_gradient_matches_xla_path():
    """The custom VJP: gradient flows only through the draws weights
    (bin assignment is a.e.-constant), matching the XLA path's gradient
    to f32 summation order."""
    base, draws, zt, zw = _problem(4)
    fn = _fn()
    zt_j, zw_j = jnp.asarray(zt), jnp.asarray(zw)
    rng = np.random.default_rng(11)
    n_pad = max(w.n_bins for w in WINDOWS)
    cvec = jnp.asarray(rng.standard_normal((len(WINDOWS), n_pad)),
                       jnp.float32)

    def loss_pallas(d):
        return jnp.sum(fn(jnp.asarray(base), d, zt_j, zw_j) * cvec)

    def loss_xla(d):
        values = jnp.asarray(base)[..., None] + zt_j
        weights = d[..., None] * zw_j
        h = weighted_histogram_multi_window(
            values.reshape(len(WINDOWS), -1), WINDOWS,
            weights.reshape(len(WINDOWS), -1), chunk=4096, radix=16)
        return jnp.sum(h * cvec)

    g_pallas = np.asarray(jax.grad(loss_pallas)(jnp.asarray(draws)))
    g_xla = np.asarray(jax.grad(loss_xla)(jnp.asarray(draws)))
    scale = np.abs(g_xla).max()
    np.testing.assert_allclose(g_pallas, g_xla, rtol=1e-5,
                               atol=1e-6 * scale)
    # base_tof / spread tables: a.e.-zero gradient by construction
    gb = np.asarray(jax.grad(
        lambda b: jnp.sum(fn(b, jnp.asarray(draws), zt_j, zw_j)))(
            jnp.asarray(base)))
    assert np.all(gb == 0.0)


def test_gradient_under_vmap():
    """grad-of-vmap — the NUTS usage shape (chain batch of walkers)."""
    base, draws, zt, zw = _problem(5, w_batch=4)
    fn = _fn()
    zt_j, zw_j = jnp.asarray(zt), jnp.asarray(zw)

    def loss(d):
        out = jax.vmap(lambda b, dd: fn(b, dd, zt_j, zw_j))(
            jnp.asarray(base), d)
        return jnp.sum(out ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(draws)))
    assert g.shape == draws.shape
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0.0
