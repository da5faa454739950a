"""Spline/interpolation primitives.

Host-side (numpy, f64) coefficient construction + device-side (jnp, f32)
evaluation.  This split is deliberate accelerator design: spline *fitting*
is a tiny tridiagonal solve done once at model-build time on the host;
spline *evaluation* is the hot path and lowers to a gather + fused Horner
polynomial, with no data-dependent control flow.

Replaces the reference's ``scipy.interpolate.interp1d(kind='cubic')``
(``utilities/utilities.py:412``) and the 1-D sections of
``RectBivariateSpline`` (``utilities/ionStopping.py:130``).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


def cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Not-a-knot interpolating cubic spline coefficients.

    Returns ``c`` of shape (4, n-1) such that on interval [x[i], x[i+1]]:
        f(t) = c[0,i]*(t-x[i])^3 + c[1,i]*(t-x[i])^2 + c[2,i]*(t-x[i]) + c[3,i]

    Matches scipy ``CubicSpline(x, y, bc_type='not-a-knot')`` (which is what
    ``interp1d(kind='cubic')`` computes) to f64 round-off.  ``y`` may have
    trailing batch dims: shape (n, ...) -> c shape (4, n-1, ...).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 4:
        raise ValueError("not-a-knot spline needs >= 4 points")
    h = np.diff(x)  # (n-1,)

    y2 = y.reshape(n, -1)  # (n, m)
    m = y2.shape[1]
    slope = np.diff(y2, axis=0) / h[:, None]  # (n-1, m)

    # Solve for first derivatives s_i with the not-a-knot banded system.
    A = np.zeros((n, n))
    b = np.zeros((n, m))
    for i in range(1, n - 1):
        A[i, i - 1] = h[i]
        A[i, i] = 2.0 * (h[i] + h[i - 1])
        A[i, i + 1] = h[i - 1]
        b[i] = 3.0 * (h[i] * slope[i - 1] + h[i - 1] * slope[i])
    # not-a-knot end conditions (Moler splinetx formulation: third
    # derivative continuous across x[1] and x[n-2])
    A[0, 0] = h[1]
    A[0, 1] = h[0] + h[1]
    b[0] = ((h[0] + 2.0 * (h[0] + h[1])) * h[1] * slope[0]
            + h[0] * h[0] * slope[1]) / (h[0] + h[1])
    A[-1, -2] = h[-1] + h[-2]
    A[-1, -1] = h[-2]
    b[-1] = ((h[-1] * h[-1] * slope[-2]
              + (2.0 * (h[-1] + h[-2]) + h[-1]) * h[-2] * slope[-1])
             / (h[-1] + h[-2]))

    s = np.linalg.solve(A, b)  # (n, m) first derivatives at knots

    # Convert to per-interval polynomial coefficients.
    s0 = s[:-1]
    s1 = s[1:]
    hh = h[:, None]
    c3 = (s0 + s1 - 2.0 * slope) / (hh * hh)
    c2 = (3.0 * slope - 2.0 * s0 - s1) / hh
    c1 = s0
    c0 = y2[:-1]
    coeffs = np.stack([c3, c2, c1, c0])  # (4, n-1, m)
    return coeffs.reshape((4, n - 1) + y.shape[1:])


@dataclasses.dataclass(frozen=True)
class CubicSpline1D:
    """Device-evaluable cubic spline (knots + per-interval coefficients).

    ``clamp``: evaluate-time clamping of queries into [lo_clamp, hi_clamp]
    (reference clamps XS queries to [20, 10000] keV,
    ``utilities/utilities.py:415-429``).
    """

    knots: np.ndarray        # (n,)
    coeffs: np.ndarray       # (4, n-1)
    lo_clamp: float | None = None
    hi_clamp: float | None = None

    @classmethod
    def build(cls, x, y, lo_clamp=None, hi_clamp=None) -> "CubicSpline1D":
        x = np.asarray(x, dtype=np.float64)
        return cls(x, cubic_spline_coeffs(x, np.asarray(y, dtype=np.float64)),
                   lo_clamp, hi_clamp)

    def __call__(self, t):
        """Evaluate on device. t: jnp array of any shape."""
        t = jnp.asarray(t)
        if self.lo_clamp is not None or self.hi_clamp is not None:
            t = jnp.clip(t, self.lo_clamp, self.hi_clamp)
        knots = jnp.asarray(self.knots, dtype=t.dtype)
        c = jnp.asarray(self.coeffs, dtype=t.dtype)
        idx = jnp.clip(jnp.searchsorted(knots, t, side="right") - 1,
                       0, knots.shape[0] - 2)
        dt = t - knots[idx]
        # Horner: ((c3*dt + c2)*dt + c1)*dt + c0
        return ((c[0][idx] * dt + c[1][idx]) * dt + c[2][idx]) * dt + c[3][idx]

    def eval_np(self, t, *, derivatives: bool = False):
        """Host-side f64 evaluation (optionally with 1st-3rd derivatives).

        Used to bake per-bin-center (sigma, sigma', sigma'', sigma''')
        constants into jitted programs for the gather-free Taylor-moment
        cross-section weighting (models/forward.py).
        """
        t = np.asarray(t, dtype=np.float64)
        tc = np.clip(t, self.lo_clamp, self.hi_clamp) \
            if (self.lo_clamp is not None or self.hi_clamp is not None) else t
        idx = np.clip(np.searchsorted(self.knots, tc, side="right") - 1,
                      0, len(self.knots) - 2)
        dt = tc - self.knots[idx]
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        val = ((c3 * dt + c2) * dt + c1) * dt + c0
        if not derivatives:
            return val
        d1 = (3 * c3 * dt + 2 * c2) * dt + c1
        d2 = 6 * c3 * dt + 2 * c2
        d3 = 6 * c3
        # clamped regions are constants
        if self.lo_clamp is not None:
            const = (t < self.lo_clamp) | (t > self.hi_clamp)
            d1, d2, d3 = (np.where(const, 0.0, d) for d in (d1, d2, d3))
        return val, d1, d2, d3

    def __hash__(self):
        return hash((self.knots.tobytes(), self.coeffs.tobytes(),
                     self.lo_clamp, self.hi_clamp))

    def __eq__(self, other):
        return (isinstance(other, CubicSpline1D)
                and np.array_equal(self.knots, other.knots)
                and np.array_equal(self.coeffs, other.coeffs)
                and self.lo_clamp == other.lo_clamp
                and self.hi_clamp == other.hi_clamp)


def linear_interp(xq, xp, fp):
    """jnp.interp wrapper (uniform API with CubicSpline1D)."""
    return jnp.interp(jnp.asarray(xq), jnp.asarray(xp), jnp.asarray(fp))


@dataclasses.dataclass(frozen=True)
class UniformCubicSpline1D:
    """Cubic spline re-parameterized onto a UNIFORM knot grid.

    Piecewise-cubic functions are closed under re-segmentation: each uniform
    cell stores the coefficients of the original spline segment containing
    it, re-centered at the cell start.  Evaluation then needs NO
    ``searchsorted`` — the segment index is pure arithmetic
    (``floor((t - lo)/step)``), leaving one small-table gather + Horner.
    This avoids the binary-search while-loop/gather chain entirely.
    Values are exactly equal to the source spline (up to f64 re-centering
    round-off).
    """

    lo: float
    step: float
    coeffs: np.ndarray       # (4, n_cells)
    lo_clamp: float | None = None
    hi_clamp: float | None = None

    @classmethod
    def from_spline(cls, spline: "CubicSpline1D", n_cells: int | None = None,
                    step: float | None = None) -> "UniformCubicSpline1D":
        """Re-segment.  Exactness requires that no uniform cell crosses a
        source knot — pass a ``step`` that divides every knot spacing (e.g.
        10 keV for the DDN table whose spacings are 10/50/100/500); with a
        free ``n_cells`` the result is exact only away from knots."""
        knots = spline.knots
        lo, hi = float(knots[0]), float(knots[-1])
        if step is not None:
            n_cells = int(round((hi - lo) / step))
            if abs(lo + n_cells * step - hi) > 1e-9 * (hi - lo):
                raise ValueError("step must evenly divide the knot range")
        else:
            step = (hi - lo) / n_cells
        starts = lo + step * np.arange(n_cells)
        # guard against fp landing exactly on a knot from the left
        starts = starts + 1e-9 * step
        seg = np.clip(np.searchsorted(knots, starts, side="right") - 1,
                      0, len(knots) - 2)
        starts = lo + step * np.arange(n_cells)  # exact cell starts
        d = starts - knots[seg]  # offset of cell start inside source segment
        c3, c2, c1, c0 = (spline.coeffs[k][seg] for k in range(4))
        # re-center: f(x0 + u) with x0 = cell start, u in [0, step)
        n3 = c3
        n2 = 3 * c3 * d + c2
        n1 = 3 * c3 * d * d + 2 * c2 * d + c1
        n0 = ((c3 * d + c2) * d + c1) * d + c0
        return cls(lo, step, np.stack([n3, n2, n1, n0]),
                   spline.lo_clamp, spline.hi_clamp)

    def __call__(self, t):
        t = jnp.asarray(t)
        if self.lo_clamp is not None or self.hi_clamp is not None:
            t = jnp.clip(t, self.lo_clamp, self.hi_clamp)
        c = jnp.asarray(self.coeffs, dtype=t.dtype)
        n_cells = self.coeffs.shape[1]
        idx = jnp.clip(((t - self.lo) / self.step).astype(jnp.int32),
                       0, n_cells - 1)
        dt = t - (self.lo + self.step * idx.astype(t.dtype))
        return ((c[0][idx] * dt + c[1][idx]) * dt + c[2][idx]) * dt + c[3][idx]

    def eval_np(self, t, *, derivatives: bool = False):
        """Host-side f64 evaluation with optional 1st-3rd derivatives."""
        t = np.asarray(t, dtype=np.float64)
        tc = np.clip(t, self.lo_clamp, self.hi_clamp) \
            if (self.lo_clamp is not None or self.hi_clamp is not None) else t
        n_cells = self.coeffs.shape[1]
        idx = np.clip(((tc - self.lo) / self.step).astype(np.int64),
                      0, n_cells - 1)
        dt = tc - (self.lo + self.step * idx)
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        val = ((c3 * dt + c2) * dt + c1) * dt + c0
        if not derivatives:
            return val
        d1 = (3 * c3 * dt + 2 * c2) * dt + c1
        d2 = 6 * c3 * dt + 2 * c2
        d3 = 6 * c3
        if self.lo_clamp is not None:
            const = (t < self.lo_clamp) | (t > self.hi_clamp)
            d1, d2, d3 = (np.where(const, 0.0, d) for d in (d1, d2, d3))
        return val, d1, d2, d3

    def __hash__(self):
        return hash((self.lo, self.step, self.coeffs.tobytes(),
                     self.lo_clamp, self.hi_clamp))

    def __eq__(self, other):
        return (isinstance(other, UniformCubicSpline1D)
                and self.lo == other.lo and self.step == other.step
                and np.array_equal(self.coeffs, other.coeffs))
