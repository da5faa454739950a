"""xs_mode='e0grid': static e0-space preimage factorization (ops/e0grid.py).

Validates the three claims the design rests on:
1. the compiled A-operator reproduces the EXACT per-sample
   transport->XS-weight->histogram grid (the reference semantics,
   ``tests/csi_oneBD.py:452-465``) to well below the reference's own
   rint() rounding of +-0.5 counts per grid cell;
2. the device (jit, f32, one-hot matmul) moment path matches the host f64
   reference of the same operator;
3. the full forward spectrum under 'e0grid' matches the 'taylor' production
   path at the spectrum level.
"""
import jax
import numpy as np
import pytest

from mcmctoffitting_tpu.models import onebd, simult
from mcmctoffitting_tpu.models.forward import energy_weight_grid, tof_spectrum
from mcmctoffitting_tpu.ops.e0grid import (_eval_table_np, e0grid_apply_np)
from mcmctoffitting_tpu.ops.xs import ddn_xs_uniform


def _exact_grid_np(table, ed_binning, e0):
    """Reference semantics, host f64: transport every sample to every
    x-slice, weight by sigma(E), histogram into eD bins (closed top edge)."""
    e_at_x = _eval_table_np(table, e0)                     # (N, M)
    w = ddn_xs_uniform.eval_np(e_at_x.reshape(-1)).reshape(e_at_x.shape)
    lo, hi, nb = ed_binning.lo, ed_binning.hi, ed_binning.n
    grid = np.zeros((e_at_x.shape[1], nb))
    inv = nb / (hi - lo)
    for m in range(e_at_x.shape[1]):
        e = e_at_x[:, m]
        sel = (e >= lo) & (e <= hi)
        idx = np.clip(((e[sel] - lo) * inv).astype(np.int64), 0, nb - 1)
        grid[m] = np.bincount(idx, weights=w[sel, m], minlength=nb)
    return grid


def _draws(seed, n, beam_e=1878.4, e_loss=850.0, scale=170.0, s=0.5):
    rng = np.random.default_rng(seed)
    return beam_e - (e_loss + scale * np.exp(s * rng.standard_normal(n)))


@pytest.mark.parametrize("preset,max_counts",
                         [("simult", 1.0), ("onebd", 1.2),
                          ("onebd_hardcore", 4.0)])
def test_operator_matches_exact_grid(preset, max_counts):
    n = 100_000
    if preset == "simult":
        spec = simult.default_spec(n_samples=n, xs_mode="e0grid")
        e0 = _draws(0, n)
    elif preset == "onebd":
        spec = onebd.default_spec(n_samples=n, xs_mode="e0grid")
        e0 = _draws(1, n, beam_e=2490.0, e_loss=1300.0, scale=80.0, s=0.6)
    else:
        spec = onebd.default_spec(n_samples=n, hardcore=True,
                                  xs_mode="e0grid")
        e0 = _draws(2, n, beam_e=2490.0, e_loss=1300.0, scale=80.0, s=0.6)

    tab = spec.e0_grid_table
    exact = _exact_grid_np(spec.stopping_table, spec.ed_binning, e0)
    approx = e0grid_apply_np(tab, e0)

    # total mass: exactly conserved by construction (up to f32 A rounding)
    assert np.isclose(approx.sum(), exact.sum(), rtol=5e-5)

    # Per-cell error in units of DRAW COUNTS after the reference's
    # normalization (draws = grid * n / (sum * area) before rint).  The
    # residual is the boundary split's conditional mis-assignment noise:
    # samples inside a ~keV fine cell are apportioned by a linear-density
    # model instead of individually, a zero-mean-across-keys error of
    # O(sqrt(k_boundary)) counts — measured ~<=10% of each bin's OWN
    # Poisson/MC noise (sqrt(count)), and of the same order as the
    # reference's deterministic rint() rounding of +-0.5 per cell.
    area = spec.ed_binning.width * spec.x_binning.width
    to_counts = n / (exact.sum() * area)
    err_counts = np.abs(approx - exact) * to_counts
    exact_counts = exact * to_counts
    assert err_counts.max() < max_counts, (
        f"max per-cell error {err_counts.max():.3f} counts "
        f"(cell peak {exact_counts.max():.1f})")
    # every cell's error stays a small fraction of that cell's MC noise
    noise = np.sqrt(np.maximum(exact_counts, 1.0))
    assert (err_counts / noise).max() < 0.3
    # aggregate: tiny relative to the spectrum mass
    assert err_counts.sum() / max(exact_counts.sum(), 1.0) < 5e-3


def test_device_matches_host_reference():
    n = 50_000
    spec = simult.default_spec(n_samples=n, xs_mode="e0grid")
    e0 = _draws(3, n).astype(np.float32)
    grid_dev = jax.jit(lambda e: energy_weight_grid(spec, e))(e0)
    grid_host = e0grid_apply_np(spec.e0_grid_table, e0)
    np.testing.assert_allclose(np.asarray(grid_dev), grid_host,
                               rtol=2e-4, atol=2e-3 * grid_host.max())


def test_device_onebd_attenuation_applied():
    n = 50_000
    spec = onebd.default_spec(n_samples=n, xs_mode="e0grid")
    spec_plain = onebd.default_spec(n_samples=n, xs_mode="taylor")
    assert spec.cell_attenuation and spec_plain.cell_attenuation
    e0 = _draws(4, n, beam_e=2490.0, e_loss=1300.0, scale=80.0,
                s=0.6).astype(np.float32)
    g_new = jax.jit(lambda e: energy_weight_grid(spec, e))(e0)
    g_old = jax.jit(lambda e: energy_weight_grid(spec_plain, e))(e0)
    g_new, g_old = np.asarray(g_new), np.asarray(g_old)
    # same attenuation profile, near-equal weighted grids
    mask = g_old > 1e-3 * g_old.max()
    rel = np.abs(g_new[mask] - g_old[mask]) / g_old[mask].max()
    assert rel.max() < 5e-3


def test_mismatched_table_rejected():
    """A table compiled for other binnings must be rejected even when the
    SHAPES coincidentally match (it would silently shift every energy)."""
    import dataclasses
    spec = simult.default_spec(n_samples=1000, xs_mode="e0grid")
    shifted = dataclasses.replace(
        spec, ed_binning=dataclasses.replace(spec.ed_binning,
                                             lo=spec.ed_binning.lo + 100.0,
                                             hi=spec.ed_binning.hi + 100.0))
    with pytest.raises(ValueError, match="built for"):
        energy_weight_grid(shifted, np.zeros(8, np.float32))
    stripped = dataclasses.replace(spec, e0_grid_table=None)
    with pytest.raises(ValueError, match="requires e0_grid_table"):
        energy_weight_grid(stripped, np.zeros(8, np.float32))


@pytest.mark.parametrize("truncated", [True, False])
@pytest.mark.parametrize("theta", [
    (1878.4, 850.0, 170.0, 0.55),
    (2490.0, 1300.0, 80.0, 0.6),
    (1878.4, 850.0, 40.0, 0.1),      # narrow density: few occupied cells
    (1878.4, 850.0, 300.0, 2.0),     # huge s: heavy tail past the grid
    (1878.4, 1900.0, 170.0, 0.5),    # e_loss > beam_e: all w < 0, clamped
])
def test_expected_moments_vs_percell_oracle(theta, truncated):
    """The production (4, F+1) shared-edge ndtr evaluation must equal the
    straightforward per-cell formula E[W^j; w_lo < W < w_hi] evaluated
    independently in f64 (scipy ndtr).  Guards the edge-sharing rewrite."""
    from scipy.special import ndtr as ndtr64
    from mcmctoffitting_tpu.ops.e0grid import expected_moments

    beam_e, e_loss, scale, s = theta
    spec = simult.default_spec(n_samples=1000, xs_mode="e0grid")
    tab = spec.e0_grid_table
    n_samples = 2.0e5

    S, e0_mean = expected_moments(tab, beam_e, e_loss, scale, s,
                                  n_samples, truncated)
    S = np.asarray(S, np.float64)

    # independent per-cell oracle, f64
    f = tab.n_fine
    edges = tab.e0_lo + (tab.e0_hi - tab.e0_lo) / f * np.arange(f + 1)
    w_hi = (beam_e - edges[:-1] - e_loss) / scale
    w_lo = (beam_e - edges[1:] - e_loss) / scale
    if truncated:
        w_max = (beam_e - 0.0 - e_loss) / scale
        w_lo, w_hi = np.minimum(w_lo, w_max), np.minimum(w_hi, w_max)

    def partial(j, lo, hi):
        lo_c, hi_c = np.maximum(lo, 1e-30), np.maximum(hi, 1e-30)
        amt = ndtr64(np.log(hi_c) / s - j * s) - ndtr64(np.log(lo_c) / s - j * s)
        return np.exp(0.5 * j * j * s * s) * np.maximum(amt, 0.0)

    p = [partial(j, w_lo, w_hi) for j in range(4)]
    a_c = (beam_e - tab.t_ref - e_loss) / tab.t_scale
    b_c = scale / tab.t_scale
    ref = np.stack([
        p[0],
        a_c * p[0] - b_c * p[1],
        a_c ** 2 * p[0] - 2 * a_c * b_c * p[1] + b_c ** 2 * p[2],
        (a_c ** 3 * p[0] - 3 * a_c ** 2 * b_c * p[1]
         + 3 * a_c * b_c ** 2 * p[2] - b_c ** 3 * p[3]),
    ])
    if truncated:
        norm = partial(0, 0.0, w_max)
        if norm == 0.0:
            # conditioning on e0 > 0 with P(e0 > 0) = 0: the production
            # guard returns all-zero moments (norm -> 1); mirror it
            ref[:] = 0.0
            norm, mean_w = 1.0, partial(1, 0.0, w_max)
        else:
            mean_w = partial(1, 0.0, w_max) / norm
    else:
        norm, mean_w = 1.0, np.exp(0.5 * s * s)
    ref *= n_samples / norm

    # f32 device values vs the f64 oracle: agreement to f32 resolution of
    # the dominant moment magnitude per row
    for k in range(4):
        tol = 1e-5 * np.abs(ref[k]).max() + 1e-6 * n_samples
        np.testing.assert_allclose(S[k], ref[k], atol=tol)
    ref_mean = beam_e - e_loss - scale * mean_w
    assert abs(float(e0_mean) - ref_mean) < 1e-3 * abs(ref_mean)


def test_expected_moments_degenerate_params_zeroed():
    """scale<=0 / s<=0 (reachable under traced walker proposals) must yield
    zero moments, not NaN."""
    from mcmctoffitting_tpu.ops.e0grid import expected_moments
    spec = simult.default_spec(n_samples=1000, xs_mode="e0grid")
    for scale, s in [(-1.0, 0.5), (170.0, -0.2), (0.0, 0.0)]:
        S, _ = expected_moments(spec.e0_grid_table, 1878.4, 850.0,
                                scale, s, 1.0e5, True)
        S = np.asarray(S)
        assert np.all(np.isfinite(S)) and np.all(S == 0.0)


@pytest.mark.parametrize("preset", ["simult", "onebd"])
def test_forward_spectrum_equivalence(preset):
    """Full tof_spectrum: e0grid vs the production taylor path."""
    n = 100_000
    key = jax.random.PRNGKey(7)
    if preset == "simult":
        spec_a = simult.default_spec(n_samples=n, xs_mode="taylor")
        spec_b = simult.default_spec(n_samples=n, xs_mode="e0grid")
        prob = simult.SimultFitProblem(spec_a, n_runs=1)
        params = np.asarray(simult.GUESS_SHARED, np.float32)
        kwargs = {}
    else:
        spec_a = onebd.default_spec(n_samples=n, xs_mode="taylor")
        spec_b = onebd.default_spec(n_samples=n, xs_mode="e0grid")
        prob = onebd.OneBDProblem(spec_a, n_runs=1)
        params = np.asarray([2490.0, 1300.0, 80.0, 0.6], np.float32)
        kwargs = {}
    standoff, window = prob.standoffs[0], prob.windows[0]

    sa = tof_spectrum(key, params, spec_a, standoff, window,
                      get_pdf=True, scale=5.0e4, **kwargs)
    sb = tof_spectrum(key, params, spec_b, standoff, window,
                      get_pdf=True, scale=5.0e4, **kwargs)
    sa, sb = np.asarray(sa), np.asarray(sb)
    # identical draws; grids differ only by sub-rint approximation, so the
    # spectra agree to a fraction of a percent of the peak
    assert np.abs(sa - sb).max() < 5e-3 * sa.max()
    assert np.abs(sa - sb).sum() < 2e-3 * sa.sum()


@pytest.mark.parametrize("truncated", [True, False])
def test_cell_closure_matches_oracle_like_exact(truncated):
    """moment_closure='cell' (2-row ndtr chain + linear within-cell
    closure): rows 0/1 and e0_mean are the SAME expression tree (bitwise);
    the closed t^2/t^3 channels sit as close to the independent f64
    per-cell oracle as the exact 4-row f32 chain does — i.e. the closure's
    analytic error (O(h^5) within-cell curvature at the F=1024 production
    grid) is below both paths' shared f32 rounding."""
    from scipy.special import ndtr as ndtr64

    from mcmctoffitting_tpu.ops.e0grid import expected_moments

    spec = simult.default_spec(n_samples=1000, sampling="counts")  # F=1024
    tab = spec.e0_grid_table
    f = tab.n_fine
    n_samples = 2.0e5
    for theta in [(1878.4, 850.0, 170.0, 0.55),
                  (2490.0, 1300.0, 80.0, 0.6),
                  (1878.4, 850.0, 40.0, 0.1)]:
        beam_e, e_loss, scale, s = theta
        exact, mean_e = expected_moments(tab, *theta, n_samples, truncated,
                                         "exact")
        cell, mean_c = expected_moments(tab, *theta, n_samples, truncated,
                                        "cell")
        exact = np.asarray(exact, np.float64)
        cell = np.asarray(cell, np.float64)
        # mass + conditional-mean channels: identical expression tree
        np.testing.assert_array_equal(exact[:2], cell[:2])
        assert float(mean_e) == float(mean_c)

        # f64 per-cell oracle for the t^2/t^3 rows
        edges = tab.e0_lo + (tab.e0_hi - tab.e0_lo) / f * np.arange(f + 1)
        w_hi = (beam_e - edges[:-1] - e_loss) / scale
        w_lo = (beam_e - edges[1:] - e_loss) / scale
        w_max = (beam_e - e_loss) / scale
        if truncated:
            w_lo, w_hi = np.minimum(w_lo, w_max), np.minimum(w_hi, w_max)

        def partial(j, lo, hi):
            lo_c = np.maximum(lo, 1e-300)
            hi_c = np.maximum(hi, 1e-300)
            amt = (ndtr64(np.log(hi_c) / s - j * s)
                   - ndtr64(np.log(lo_c) / s - j * s))
            return np.exp(0.5 * j * j * s * s) * np.maximum(amt, 0.0)

        p = [partial(j, w_lo, w_hi) for j in range(4)]
        a_c = (beam_e - tab.t_ref - e_loss) / tab.t_scale
        b_c = scale / tab.t_scale
        s2 = a_c ** 2 * p[0] - 2 * a_c * b_c * p[1] + b_c ** 2 * p[2]
        s3 = (a_c ** 3 * p[0] - 3 * a_c ** 2 * b_c * p[1]
              + 3 * a_c * b_c ** 2 * p[2] - b_c ** 3 * p[3])
        norm = partial(0, 0.0, w_max) if truncated else 1.0
        if norm == 0.0:
            continue  # fully truncated: production zeroes everything
        for k, ref in ((2, s2 * n_samples / norm), (3, s3 * n_samples / norm)):
            err_exact = np.abs(exact[k] - ref).max()
            err_cell = np.abs(cell[k] - ref).max()
            # as accurate as the exact f32 path (2x headroom for rounding
            # luck), never worse than f32 resolution of the row scale
            assert err_cell <= 2.0 * err_exact + 1e-6 * np.abs(ref).max(), (
                theta, k, err_cell, err_exact)


def test_cell_closure_logp_shift_below_f_margin():
    """Posterior-level guard for moment_closure='cell'.

    With the reference-faithful rint() ON, the closure is logp-IDENTICAL
    at almost every theta; at rare bin-edge-poised thetas the +-1e-4
    channel difference flips a rint outcome — the same discrete
    sensitivity class the exact path's own compile-order noise exhibits
    (measured here: eager-vs-jit of the exact program steps ~0.5 at such
    thetas).  With rint OFF the response surface is smooth and the
    closure's reweighting is bounded below the pinned fine-grid margin
    (|delta logp| std 0.052 between F=512 and F=4096,
    artifacts/hardcore_f_logp_shift.json)."""
    import dataclasses

    from mcmctoffitting_tpu.utils import data_io

    spec = simult.default_spec(n_samples=50_000, sampling="counts")
    spec_e = dataclasses.replace(spec, sampling="expected",
                                 rint_draws=False)
    spec_c = dataclasses.replace(spec_e, moment_closure="cell")
    pe = simult.SimultFitProblem(spec_e, n_runs=2, likelihood="poisson")
    pc = simult.SimultFitProblem(spec_c, n_runs=2, likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(2, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.PRNGKey(3), pe, truth)
    logp_exact = jax.jit(pe.make_log_prob_fn(observed))
    logp_cell = jax.jit(pc.make_log_prob_fn(observed))

    rng = np.random.default_rng(7)
    # posterior-typical scatter around truth (widths ~ the measured ridge)
    sig = np.array([30.0, 30.0, 15.0, 0.05, 2e3, 2e3])
    key = jax.random.PRNGKey(0)
    deltas = []
    for i in range(24):
        th = truth + rng.normal(size=truth.size) * sig
        a = float(logp_exact(jax.numpy.asarray(th, jax.numpy.float32), key))
        b = float(logp_cell(jax.numpy.asarray(th, jax.numpy.float32), key))
        if np.isfinite(a) and np.isfinite(b):
            deltas.append(b - a)
    deltas = np.asarray(deltas)
    assert deltas.size >= 16
    # measured 2026-08-18: max 0.094, std 0.039 — below the 0.052 margin
    assert np.abs(deltas).max() < 0.2
    assert deltas.std() < 0.052


def test_fine_grid_override():
    """fine_grid= overrides the per-mode F default and rebuilds the table.

    The CLI -fineGrid knob rides this; the posterior-level fidelity of any
    F >= 512 is pinned by the logp-shift study (hardcore
    frontier: std <= 0.06 for F in {512, 1024, 2048}).
    """
    from mcmctoffitting_tpu.models import onebd, simult

    s = simult.default_spec(n_samples=1000, sampling="counts",
                            fine_grid=128)
    assert s.e0_grid_fine == 128
    assert s.e0_grid_table.n_fine == 128
    assert s.e0_grid_table.a_matrix.shape[0] == 4 * 128
    o = onebd.default_spec(n_samples=1000, sampling="counts", fine_grid=256)
    assert o.e0_grid_fine == 256
    # defaults are draw-count aware: the halved grids are measured
    # equivalent at the 200k-draw production scale, but
    # below ~100k draws the within-cell rint granularity needs the finer
    # grid (counts noise 1.8x mc at 50k draws/F=512 vs 1.2x at F=1024)
    assert simult.default_spec(n_samples=200_000,
                               sampling="counts").e0_grid_fine == 512
    assert simult.default_spec(n_samples=50_000,
                               sampling="counts").e0_grid_fine == 1024
    assert onebd.default_spec(n_samples=200_000,
                              sampling="counts").e0_grid_fine == 1024
    assert onebd.default_spec(n_samples=50_000,
                              sampling="counts").e0_grid_fine == 2048


def test_fine_grid_cli_flag():
    from mcmctoffitting_tpu.cli.csi_onebd import build_parser as onebd_p
    from mcmctoffitting_tpu.cli.simult_fit import build_parser as simult_p
    assert simult_p().parse_args(["-fineGrid", "512"]).fineGrid == 512
    assert onebd_p().parse_args(["-fineGrid", "512"]).fineGrid == 512
    assert simult_p().parse_args([]).fineGrid == 0


def test_bf16_a_operator_accuracy_and_flag():
    """a_dtype='bfloat16' stores only the static A operator in bf16.

    The knob exists for the oneBD -hardcore scale where A is 131 MB and
    the half-ensemble matmul streams all of it.  Accuracy is NOT
    ~bf16 eps: the contraction reconstructs a cubic from global
    t-moments, cancelling across the four channel rows with condition
    ~16 — measured median grid error ~1.6%, max ~6% of the dominant
    scale (this test pins those bounds).  Below the hardcore counts
    path's ~9% per-cell Poisson noise, but systematic — only the
    -hardcore counts preset uses it, after a posterior A/B
    (artifacts/hardcore_a_dtype_ab.json).
    """
    import dataclasses

    from mcmctoffitting_tpu.models.forward import grid_and_mean

    spec32 = simult.default_spec(n_samples=10_000, sampling="expected")
    spec16 = dataclasses.replace(spec32, a_dtype="bfloat16")
    theta = np.array([1878.4, 850.0, 170.0, 0.5], np.float32)
    g32, _ = jax.jit(lambda p: grid_and_mean(spec32, p, None))(theta)
    g16, _ = jax.jit(lambda p: grid_and_mean(spec16, p, None))(theta)
    g32, g16 = np.asarray(g32), np.asarray(g16)
    assert np.all(np.isfinite(g16))
    scale = np.abs(g32).max()
    # condition ~16 x bf16 eps: measured 6.3% max / 1.6% median
    assert np.abs(g16 - g32).max() <= 8e-2 * scale
    rel = np.abs(g16 - g32)[g32 > 1e-3 * scale] / g32[g32 > 1e-3 * scale]
    assert np.median(rel) < 3e-2

    from mcmctoffitting_tpu.cli.csi_onebd import build_parser as onebd_p
    from mcmctoffitting_tpu.cli.simult_fit import build_parser as simult_p
    assert simult_p().parse_args(["-aDtype", "bfloat16"]).aDtype == "bfloat16"
    # None sentinel: unset keeps the per-preset default (bf16 for the
    # hardcore counts preset, f32 everywhere else)
    assert onebd_p().parse_args([]).aDtype is None
    import dataclasses as _dc  # noqa: F401
    from mcmctoffitting_tpu.models import onebd as _onebd
    assert _onebd.default_spec(n_samples=1000, hardcore=True,
                               sampling="counts").a_dtype == "bfloat16"
    assert _onebd.default_spec(n_samples=1000,
                               sampling="counts").a_dtype == "float32"
    assert _onebd.default_spec(n_samples=1000, hardcore=True,
                               sampling="mc").a_dtype == "float32"
