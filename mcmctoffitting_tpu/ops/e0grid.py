"""Gather-free (x, eD) weight grid via static e0-space preimages.

The forward model's hot stage bins XS-weighted TRANSPORTED energies into an
(x_bins, eD_bins) grid (``tests/simultFit.py:256-265``,
``tests/csi_oneBD.py:452-465``).  The one-hot-moment path in
``models/forward.py`` does that with M * Be compares per sample (plus a
per-sample transport-table lookup).  This module removes both, using a
structural fact of the physics: **the transport map E(e0, x) does not depend
on the sampled parameters** — theta only moves the initial-energy draw.  So:

1. (build time, host, f64) For every x-slice m, invert the stopping table:
   the eD bin edges pull back to static *preimage edges* z[m, b] in
   e0-space.  A sample lands in (m, b) iff e0 is in [z[m,b], z[m,b+1]).
2. (build time) Lay a uniform fine grid of F cells over the union of the
   preimage ranges.  Within each fine cell, the composite weight function
   g_m(e0) = sigma_DDN(E(e0, x_m)) is fit by a cubic (in a globally
   normalized variable t), and every (cell x slice) overlap with a preimage
   interval is compiled into one static linear map A from fine-cell raw
   t-moments (S0..S3) to grid cells.
3. (run time, device) Per sample: ONE arithmetic fine-cell index + one-hot
   moment accumulation shared by ALL x-slices (F compares per sample instead
   of M * Be + transport), then grid = S @ A — a single static matmul.

Accuracy: interior fine cells are exact up to the cubic fit of g_m over a
~1-2 keV cell (error O(h^4 g''''), orders below the XS table's 1%).  Fine
cells straddling a preimage edge are split by a linear-density model matched
to the cell's observed (S0, S1) — the split is mass- and mean-conserving by
construction (the two sides sum to the exact cell contraction), so the only
approximation is *where inside a ~keV-wide cell* the boundary samples sit.
The resulting per-cell error is far below the reference's own
``rint(dataHist * nSamples)`` rounding of +-0.5 counts per grid cell
(``tests/simultFit.py:283``); see tests/test_e0grid.py for measured bounds.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _eval_table_np(table, e0):
    """Host f64 mirror of ``StoppingTable.eval_stopped`` (clip + Horner).

    e0: (K,) -> (K, M) transported energies at each x column, including the
    same clamped-segment extrapolation behavior as the device lookup.
    """
    e0 = np.asarray(e0, dtype=np.float64)
    lo = float(table.e0_grid[0])
    step = float(table.e0_grid[1] - table.e0_grid[0])
    n_seg = table.e0_grid.shape[0] - 1
    idx = np.clip(((e0 - lo) / step).astype(np.int64), 0, n_seg - 1)
    dt = (e0 - (lo + step * idx))[:, None]
    c3, c2, c1, c0 = (table.coeffs[k][idx] for k in range(4))  # (K, M)
    return ((c3 * dt + c2) * dt + c1) * dt + c0


@dataclasses.dataclass(frozen=True)
class E0GridTable:
    """Static e0-space grid operator: fine-cell moments -> (M, Be) grid.

    ``e0_lo``/``e0_hi``/``n_fine``: the uniform fine grid (F cells) whose
    per-cell raw t-moments the device accumulates.
    ``t_ref``/``t_scale``: global normalization t = (e0 - t_ref) / t_scale
    (keeps moment magnitudes O(1) so the f32 accumulation stays accurate).
    ``a_matrix``: (4*F, M*Be) f32 operator.  Row layout is CHANNEL-MAJOR:
    channel k of fine cell f lives at row ``k * F + f`` — exactly the
    row-major flattening of the device's (4, F) moment array, so
    ``grid = moments.reshape(4*F) @ a_matrix``.  Column layout is
    ``m * Be + b`` (x-slice-major).
    ``ed_lo``/``ed_hi``: the eD histogram range the operator was compiled
    for (validated against the spec at trace time).
    """

    e0_lo: float
    e0_hi: float
    n_fine: int
    t_ref: float
    t_scale: float
    a_matrix: np.ndarray      # (4 * F, M * Be) f32
    n_x: int
    n_ed: int
    ed_lo: float = 0.0
    ed_hi: float = 0.0

    def __post_init__(self):
        object.__setattr__(
            self, "_hash",
            hash((self.e0_lo, self.e0_hi, self.n_fine, self.t_ref,
                  self.t_scale, self.n_x, self.n_ed, self.ed_lo,
                  self.ed_hi, self.a_matrix.tobytes())))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, E0GridTable)
                and self._hash == other._hash
                and np.array_equal(self.a_matrix, other.a_matrix))


def build_e0_grid_table(stopping_table, ed_binning, xs,
                        n_fine: int = 1024,
                        n_invert: int = 20001) -> E0GridTable:
    """Compile (stopping table, eD binning, XS spline) into an E0GridTable.

    ``stopping_table``: ops.stopping.StoppingTable (transport surrogate —
    the reference's own ``betheApprox`` strategy,
    ``utilities/ionStopping.py:102-136``).
    ``ed_binning``: config.Binning of the eD histogram axis.
    ``xs``: spline with a f64 ``eval_np`` (ops.xs.ddn_xs / ddn_xs_uniform).
    ``n_fine``: fine-cell count F.  Resolution rule of thumb: the fine cell
    should be a fraction of the narrowest eD-bin preimage; tests measure the
    resulting per-cell error against the exact path.
    """
    table = stopping_table
    eb = ed_binning
    n_x = int(table.x_centers.shape[0])
    n_ed = int(eb.n)

    # --- 1. preimage edges z[m, b] by monotone inversion of E(., x_m)
    e0_dense = np.linspace(float(table.e0_grid[0]),
                           float(table.e0_grid[-1]), n_invert)
    e_dense = _eval_table_np(table, e0_dense)              # (K, M)
    ed_edges = np.asarray(eb.edges, dtype=np.float64)      # (Be + 1,)
    z = np.empty((n_x, n_ed + 1))
    for m in range(n_x):
        col = e_dense[:, m]
        d = np.diff(col)
        if not np.all(d > 0):
            # the physical map is strictly increasing; tolerate flat spots
            # from the energy floor by nudging monotone
            col = np.maximum.accumulate(col)
            col = col + np.arange(col.size) * 1e-9
        z[m] = np.interp(ed_edges, col, e0_dense)

    lo = float(z.min())
    hi = float(z.max())
    span = hi - lo
    lo -= 1e-6 * span
    hi += 1e-6 * span
    cell_w = (hi - lo) / n_fine
    t_ref = 0.5 * (lo + hi)
    t_scale = 0.5 * (hi - lo)

    def to_t(e0):
        return (np.asarray(e0) - t_ref) / t_scale

    cell_edges = lo + cell_w * np.arange(n_fine + 1)
    cell_edges_t = to_t(cell_edges)
    h_t = cell_edges_t[1] - cell_edges_t[0]

    # --- 2. per-(slice, cell) cubic fits of g_m(e0) = sigma(E(e0, x_m))
    # 4 Chebyshev nodes per cell, Vandermonde solve in the global t variable
    cheb = 0.5 * (1.0 + np.cos(np.pi * (2 * np.arange(4) + 1) / 8.0))[::-1]
    nodes = cell_edges[:-1, None] + cell_w * cheb[None, :]   # (F, 4)
    nodes_t = to_t(nodes)
    e_nodes = _eval_table_np(table, nodes.reshape(-1))       # (F*4, M)
    g_nodes = xs.eval_np(e_nodes.T.reshape(-1)).reshape(n_x, n_fine, 4)
    vand = nodes_t[:, :, None] ** np.arange(4)[None, None, :]  # (F, 4, 4)
    # c[m, f, k]: g_m(t) ~= sum_k c[m,f,k] t^k on cell f
    c = np.linalg.solve(np.broadcast_to(vand, (n_x, n_fine, 4, 4)),
                        g_nodes[..., None])[..., 0]          # (M, F, 4)

    # --- 3. assemble A: for every (m, cell, overlapping bin) segment
    # moments of a segment [s0, s1] (t units) under the linear-density
    # model rho(t) = a + b (t - tc), a = S0/h, b = 12 (S1 - tc S0) / h^3:
    #   M_k = a I_k + b J_k,  I_k = int t^k,  J_k = int (t - tc) t^k
    a_mat = np.zeros((4, n_fine, n_x, n_ed))

    z_t = to_t(z)                                            # (M, Be+1)
    pows = np.arange(1, 6, dtype=np.float64)                 # k+1 for k=0..4

    def ikjk(s0, s1, tc):
        """I_k and J_k for k = 0..3 over [s0, s1] (vectorized over segs)."""
        p0 = s0[..., None] ** pows
        p1 = s1[..., None] ** pows
        ints = (p1 - p0) / pows                              # int t^k, k=0..4
        i_k = ints[..., :4]
        j_k = ints[..., 1:5] - tc[..., None] * ints[..., :4]
        return i_k, j_k

    for m in range(n_x):
        zt = z_t[m]                                          # (Be+1,)
        # for every bin b, the range of fine cells it touches
        f_lo = np.clip(np.floor((zt[:-1] - cell_edges_t[0]) / h_t
                                ).astype(np.int64), 0, n_fine - 1)
        f_hi = np.clip(np.floor((zt[1:] - cell_edges_t[0]) / h_t
                                ).astype(np.int64), 0, n_fine - 1)
        for b in range(n_ed):
            if zt[b + 1] <= zt[b]:
                continue
            fa, fb = int(f_lo[b]), int(f_hi[b])
            # full cells strictly inside (fa, fb): exact 4-channel rows
            if fb - fa >= 2:
                full = np.arange(fa + 1, fb)
                a_mat[:, full, m, b] += c[m, full, :].T      # (4, n_full)
            # boundary (or single) cells: linear-density split
            for f in range(fa, fb + 1):
                if fa < f < fb:
                    continue
                s0 = max(zt[b], cell_edges_t[f])
                s1 = min(zt[b + 1], cell_edges_t[f + 1])
                if s1 <= s0:
                    continue
                if (s0 <= cell_edges_t[f] + 1e-12 * abs(h_t)
                        and s1 >= cell_edges_t[f + 1] - 1e-12 * abs(h_t)):
                    # segment covers the whole cell: exact channels
                    a_mat[:, f, m, b] += c[m, f, :]
                    continue
                tc = 0.5 * (cell_edges_t[f] + cell_edges_t[f + 1])
                i_k, j_k = ikjk(np.asarray(s0), np.asarray(s1),
                                np.asarray(tc))
                alpha = float(np.dot(c[m, f],
                                     i_k / h_t - 12.0 * tc * j_k / h_t ** 3))
                beta = float(np.dot(c[m, f], 12.0 * j_k / h_t ** 3))
                a_mat[0, f, m, b] += alpha
                a_mat[1, f, m, b] += beta

    a_flat = a_mat.reshape(4 * n_fine, n_x * n_ed).astype(np.float32)
    return E0GridTable(lo, hi, n_fine, t_ref, t_scale, a_flat, n_x, n_ed,
                       float(eb.lo), float(eb.hi))


@functools.lru_cache(maxsize=8)
def cached_e0_grid_table(stopping_table, ed_binning, xs,
                         n_fine: int) -> E0GridTable:
    """lru-cached builder (all arguments are hashable frozen objects)."""
    return build_e0_grid_table(stopping_table, ed_binning, xs,
                               n_fine=n_fine)


def _lognorm_w_machinery(beam_e, e_loss, scale, s):
    """Shared guards + partial-moment closures for the lognormal beam law.

    Both estimators (:func:`expected_moments`, :func:`poissonized_moments`)
    must evaluate E[W^j; lo < W < hi] from the SAME expression tree — the
    counts estimator's unbiasedness argument compares its overflow-cell
    lambdas against the in-grid closed form bit for bit.  Keeping one copy
    here makes that identity structural instead of a maintenance promise.

    Returns (valid, safe_scale, safe_s, w_of, partial) where
    ``w_of(e0) = (beamE - e0 - eLoss)/scale`` and ``partial(j, lo, hi)``
    is the j-th partial raw moment of W = exp(s Z) on (lo, hi); ``hi=None``
    means +inf.
    """
    import jax.numpy as jnp
    from jax.scipy.special import ndtr

    valid = (scale > 0.0) & (s > 0.0)
    safe_scale = jnp.where(scale > 0.0, scale, 1.0)
    safe_s = jnp.where(s > 0.0, s, 1.0)

    def w_of(e0):
        return (beam_e - e0 - e_loss) / safe_scale

    def partial(j, lo, hi):
        """E[W^j; lo < W < hi] (0 where the interval is empty/negative)."""
        lo_c = jnp.maximum(lo, 1e-30)
        top = 1.0 if hi is None else ndtr(
            jnp.log(jnp.maximum(hi, 1e-30)) / safe_s - j * safe_s)
        amt = top - ndtr(jnp.log(lo_c) / safe_s - j * safe_s)
        return (jnp.exp(0.5 * j * j * safe_s * safe_s)
                * jnp.maximum(amt, 0.0))

    return valid, safe_scale, safe_s, w_of, partial


def expected_moments(table: E0GridTable, beam_e, e_loss, scale, s,
                     n_samples: float, truncated: bool,
                     closure: str = "exact"):
    """CLOSED-FORM fine-cell moments under the lognormal beam density.

    The MC forward model exists in the reference purely as a numerical
    integrator: each lnlike re-draws e0 ~ beamE - lognorm(s, loc=eLoss,
    scale) and histograms transported samples (``tests/simultFit.py:243-265``).
    With the e0grid operator the per-sample statistics enter ONLY through
    the per-fine-cell raw moments S_k = sum t^k — and the lognormal has
    closed-form partial moments against polynomials:

        E[W^j; w1 < W < w2] = exp(j^2 s^2 / 2)
                              * (ndtr(ln(w2)/s - j s) - ndtr(ln(w1)/s - j s)),
        W = exp(s Z),  Y = eLoss + scale W,  e0 = beamE - Y.

    t = (e0 - t_ref)/t_scale is affine in W, so every S_k expands in the
    P_j via the binomial theorem.  Cost: ~4 (F+1) ndtr evaluations per call
    — independent of n_samples — replacing the entire per-sample pipeline.
    This is the exact N -> infinity limit of the reference's estimator
    (the pseudo-marginal noise goes to zero; see ForwardSpec.sampling).

    ``truncated``: condition on e0 > 0 (the reference's
    redraw-until-positive loop, ``tests/simultFit.py:245-252``); False
    mirrors the oneBD driver that disabled the loop
    (``tests/csi_oneBD.py:440-447``) — negative-e0 mass simply falls
    outside every fine cell, as it falls outside the histogram range there.

    ``closure`` (ForwardSpec.moment_closure): how the t^2/t^3 channels are
    obtained.  'exact' evaluates the full (4, F+1) ndtr chain.  'cell'
    evaluates only j in {0, 1} (mass + conditional mean — the channels
    that carry the spectrum) and closes the within-cell second/third
    moments analytically: s2 = s0 (m1^2 + v), s3 = s0 m1 (m1^2 + 3 v)
    with v = h^2/12 the exact variance of a uniform density on a width-h
    cell.  The neglected corrections are the within-cell density tilt's
    effect on v (O(h^4)) and the within-cell third central moment
    (O(h^4)); at F = 1024, h ~ 1e-3 in t units, both sit below f32
    rounding of the contraction — measured |delta logp| ~ 1e-3 across
    posterior-typical thetas (tests/test_e0grid.py), ~50x below the
    pinned F-margin (artifacts/hardcore_f_logp_shift.json).  Cost:
    halves the ndtr chain, the dominant counts-mode stage.

    Returns (S, e0_mean): S is (4, F) expected moments scaled to
    ``n_samples`` draws; e0_mean is the matching expected draw mean.
    """
    import jax.numpy as jnp
    from jax.scipy.special import ndtr

    f = table.n_fine
    edges = table.e0_lo + (table.e0_hi - table.e0_lo) / f * np.arange(f + 1)
    edges = jnp.asarray(edges, jnp.float32)               # (F+1,) ascending

    # guard degenerate traced parameters like ops.pdfs.beam_energy_rvs
    valid, safe_scale, safe_s, w_of, partial = _lognorm_w_machinery(
        beam_e, e_loss, scale, s)

    # e0 cell [a, b] -> W interval [w_lo, w_hi] (map is decreasing in W)
    w_edges = w_of(edges)                                 # (F+1,) decreasing
    if truncated:
        # condition on e0 > 0  <=>  W < w_max
        w_max = w_of(0.0)
        w_edges = jnp.minimum(w_edges, w_max)

    # adjacent cells SHARE an edge: evaluate the ndtr chain once on the
    # (n_rows, F+1) edge grid and difference, instead of per-cell lo/hi
    # pairs (which XLA does not CSE across the overlapping slices) —
    # halves the dominant transcendental stage.  Same expression tree per edge as partial(), so values are
    # unchanged.
    if closure not in ("exact", "cell"):
        raise ValueError(f"unknown moment closure {closure!r} "
                         "(expected 'exact' or 'cell')")
    n_rows = 4 if closure == "exact" else 2
    js = jnp.arange(n_rows, dtype=jnp.float32)
    logw = jnp.log(jnp.maximum(w_edges, 1e-30)) / safe_s  # (F+1,)
    nd = ndtr(logw[None, :] - js[:, None] * safe_s)       # (n_rows, F+1)
    amt = jnp.maximum(nd[:, :-1] - nd[:, 1:], 0.0)        # hi - lo, (·, F)
    pm = jnp.exp(0.5 * js * js * safe_s * safe_s)[:, None] * amt

    # t = A - B W with A = (beamE - t_ref - eLoss)/t_scale, B = scale/t_scale
    a_c = (beam_e - table.t_ref - e_loss) / table.t_scale
    b_c = safe_scale / table.t_scale
    s0 = pm[0]
    s1 = a_c * pm[0] - b_c * pm[1]
    if closure == "exact":
        s2 = a_c * a_c * pm[0] - 2.0 * a_c * b_c * pm[1] + b_c * b_c * pm[2]
        s3 = (a_c ** 3 * pm[0] - 3.0 * a_c * a_c * b_c * pm[1]
              + 3.0 * a_c * b_c * b_c * pm[2] - b_c ** 3 * pm[3])
    else:
        # within-cell closure: the conditional mean m1 = s1/s0 is exact;
        # close t^2/t^3 with the LINEAR density model the mean itself
        # pins.  For f(x) = 1/h + b x on a width-h cell (x centered),
        # the mean offset dm = E[x] = b h^3/12 determines b, giving
        #   Var  = h^2/12 - dm^2,
        #   mu3  = E[x^3] - 3 dm E[x^2] + 2 dm^3 = -0.1 dm h^2 + 2 dm^3.
        # Residual error is the within-cell CURVATURE, O(h^5 rho''/rho)
        # per cell.  m1 is clamped to its own cell (where s0 underflows,
        # s1/s0 is unreliable; the clamp pins it to a physical value and
        # the s0 factor zeroes the contribution anyway), which bounds
        # |dm| <= h/2; v is floored at 0 for the truncation-edge cell
        # where the linear model can overshoot.
        t_edges = (edges - table.t_ref) / table.t_scale   # (F+1,) ascending
        h = (table.e0_hi - table.e0_lo) / (f * table.t_scale)
        t_c = 0.5 * (t_edges[:-1] + t_edges[1:])
        m1 = jnp.clip(s1 / jnp.maximum(s0, 1e-12),
                      t_edges[:-1], t_edges[1:])
        dm = m1 - t_c
        v = jnp.maximum(h * h / 12.0 - dm * dm, 0.0)
        mu3 = (2.0 * dm * dm - 0.1 * h * h) * dm
        s2 = s0 * (m1 * m1 + v)
        s3 = s0 * (m1 * (m1 * m1 + 3.0 * v) + mu3)
    moments = jnp.stack([s0, s1, s2, s3])                 # (4, F)

    if truncated:
        w_max = w_of(0.0)
        norm = partial(0, jnp.zeros(()), w_max)
        mean_w = partial(1, jnp.zeros(()), w_max)
        norm = jnp.where(valid & (norm > 0), norm, 1.0)
    else:
        norm = jnp.asarray(1.0)
        mean_w = jnp.exp(0.5 * safe_s * safe_s)

    moments = jnp.where(valid, moments * (n_samples / norm), 0.0)
    e0_mean = beam_e - e_loss - safe_scale * mean_w / norm
    return moments, e0_mean


def poissonized_moments(key, table: E0GridTable, beam_e, e_loss, scale, s,
                        n_samples: float, truncated: bool,
                        closure: str = "exact"):
    """Poissonized Rao-Blackwell MC moments (``sampling='counts'``).

    The faithful MC estimator's per-fine-cell moment sums decompose as
    S_k[f] = count_f * m_k[f] + within-cell fluctuation, where count_f is
    the cell occupancy and m_k[f] = E[t^k | cell f].  The per-sample
    pipeline that produces them (threefry + ndtri + exp draws, then the
    F-wide one-hot and its 4-row dot) costs O(N * F) per eval.  This
    estimator keeps the count
    randomness and replaces the within-cell part with its conditional
    expectation (both closed-form, from the same partial-moment machinery
    as :func:`expected_moments`):

        count_f ~ Poisson(lambda_f),   lambda_f = E[count_f] = Sbar_0[f]
        S_k[f]  = count_f * Sbar_k[f] / Sbar_0[f]

    Statistics: unbiased for exactly the same limit as the reference's
    estimator (E[count_f] * m_k = Sbar_k), with per-cell variance
    m_k^2 Var(count) vs MC's m_k^2 Var(count) + E[count] Var(t^k | f) —
    i.e. *strictly smaller* (Rao-Blackwell); the dropped within-cell term
    is O((cell width / t_scale)^2) ~ 1e-5 of the kept one.  Poisson counts
    differ from the multinomial of a fixed-N draw only through the total
    (Poisson(N) vs N); the forward model normalizes the grid, so the
    shared total fluctuation cancels (and the reference's own
    redraw/range-mask machinery makes its effective N fluctuate too).
    Validated against the MC path in tests/test_counts_forward.py
    (matching per-cell mean AND variance) and by posterior parity.

    Cost: O(F) ndtr + F + 2 Poisson draws per run eval — independent of
    ``n_samples``, replacing O(N) transcendentals + the O(N * F) one-hot.

    Returns (moments (4, F), e0_mean) with e0_mean carrying the faithful
    per-eval sample-mean jitter: it is computed from the same Poisson
    counts extended with two overflow cells (draws falling below/above the
    fine grid, closed-form conditional means), mirroring how the
    reference's lattice mean averages over ALL draws
    (``tests/simultFit.py:288``).
    """
    import jax.numpy as jnp

    from .poisson import poisson_ptrs

    sbar, _ = expected_moments(table, beam_e, e_loss, scale, s,
                               n_samples, truncated, closure)  # (4, F)
    lam = jnp.where(jnp.isfinite(sbar[0]), jnp.maximum(sbar[0], 0.0), 0.0)
    m = sbar / jnp.maximum(sbar[0], 1e-12)[None, :]           # m[0] == 1

    # overflow cells (e0 below/above the fine grid) for the sample mean
    valid, safe_scale, safe_s, w_of, partial = _lognorm_w_machinery(
        beam_e, e_loss, scale, s)

    if truncated:
        w_max = w_of(0.0)
        norm = partial(0, jnp.zeros(()), w_max)
        norm = jnp.where(valid & (norm > 0), norm, 1.0)
        # below grid: e0 < e0_lo, truncated at e0 > 0
        p0_below = partial(0, w_of(table.e0_lo), w_max)
        p1_below = partial(1, w_of(table.e0_lo), w_max)
    else:
        norm = jnp.asarray(1.0)
        p0_below = partial(0, w_of(table.e0_lo), None)
        p1_below = partial(1, w_of(table.e0_lo), None)
    p0_above = partial(0, jnp.zeros(()), w_of(table.e0_hi))
    p1_above = partial(1, jnp.zeros(()), w_of(table.e0_hi))

    def cond_mean_e0(p0, p1):
        return jnp.where(p0 > 1e-30,
                         beam_e - e_loss
                         - safe_scale * p1 / jnp.maximum(p0, 1e-30), 0.0)

    lam_below = jnp.where(valid, n_samples * p0_below / norm, 0.0)
    lam_above = jnp.where(valid, n_samples * p0_above / norm, 0.0)

    lam_all = jnp.concatenate(
        [lam, lam_below[None], lam_above[None]])
    # exact uniforms-only sampler (PRNG-impl-agnostic; ops/poisson.py)
    counts = poisson_ptrs(key, lam_all).astype(jnp.float32)
    moments = counts[None, : table.n_fine] * jnp.where(
        lam[None, :] > 0, m, 0.0)                             # (4, F)

    cell_mean_e0 = table.t_ref + table.t_scale * m[1]
    e0_sum = (jnp.sum(counts[: table.n_fine] * cell_mean_e0)
              + counts[table.n_fine] * cond_mean_e0(p0_below, p1_below)
              + counts[table.n_fine + 1] * cond_mean_e0(p0_above, p1_above))
    total = jnp.sum(counts)
    e0_mean = jnp.where(
        total > 0, e0_sum / jnp.maximum(total, 1.0),
        expected_e0_mean(beam_e, e_loss, scale, s, truncated))
    return moments, e0_mean


def expected_e0_mean(beam_e, e_loss, scale, s, truncated: bool):
    """Closed-form mean of the beam-energy draw distribution.

    The infinite-draw limit of the per-eval sample mean the reference
    feeds into its TOF lattice (``tests/simultFit.py:288``).  Measured:
    the SAMPLE mean's jitter is the dominant pseudo-marginal noise source
    — it rigidly shifts the whole TOF lattice, and heavy (x, eD) cells
    sitting near TOF-bin edges flip bins, jumping the log-likelihood by
    O(1e4) (see RESULTS notes); the expectation removes exactly that.
    """
    import jax.numpy as jnp
    from jax.scipy.special import ndtr

    valid = (scale > 0.0) & (s > 0.0)
    safe_scale = jnp.where(scale > 0.0, scale, 1.0)
    safe_s = jnp.where(s > 0.0, s, 1.0)
    if truncated:
        w_max = jnp.maximum((beam_e - e_loss) / safe_scale, 1e-30)
        zmax = jnp.log(w_max) / safe_s
        norm = ndtr(zmax)
        norm = jnp.where(valid & (norm > 0), norm, 1.0)
        mean_w = (jnp.exp(0.5 * safe_s * safe_s)
                  * ndtr(zmax - safe_s)) / norm
    else:
        mean_w = jnp.exp(0.5 * safe_s * safe_s)
    return beam_e - e_loss - safe_scale * mean_w


def e0grid_moments_np(table: E0GridTable, e0):
    """Host f64 reference of the device moment accumulation (for tests)."""
    e0 = np.asarray(e0, dtype=np.float64)
    in_range = (e0 >= table.e0_lo) & (e0 <= table.e0_hi)
    cell_w = (table.e0_hi - table.e0_lo) / table.n_fine
    idx = np.clip(((e0 - table.e0_lo) / cell_w).astype(np.int64),
                  0, table.n_fine - 1)
    t = (e0 - table.t_ref) / table.t_scale
    base = in_range.astype(np.float64)
    chans = np.stack([base, base * t, base * t * t, base * t ** 3])  # (4, N)
    s = np.zeros((4, table.n_fine))
    for k in range(4):
        s[k] = np.bincount(idx, weights=chans[k], minlength=table.n_fine)
    return s


def e0grid_apply_np(table: E0GridTable, e0):
    """Host reference: full grid from raw draws (for tests)."""
    s = e0grid_moments_np(table, e0)
    return (s.reshape(-1) @ table.a_matrix.astype(np.float64)).reshape(
        table.n_x, table.n_ed)
