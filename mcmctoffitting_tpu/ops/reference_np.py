"""Float64 host reference of the forward model's deterministic stages.

A plain numpy re-statement of what ``models/forward.py`` computes after
the Monte-Carlo (or Poisson) draws:

* the e0-grid operator applied to raw draws or to fine-cell moments
  (``grid_np``), with the A operator rounded exactly as the spec stores it.
  This stage reuses the program's own host-built A table and fine-cell
  moments (``e0grid_moments_np``), so it checks the device's numerics
  against that operator, not the operator itself; the operator is checked
  against the transport -> cross-section -> histogram path in
  ``tests/test_e0grid.py``;
* the (x-bin, eD-bin) TOF lattice (``lattice_np``) and the zero-degree
  transit spread (``spread_np``);
* draw counts, the per-run TOF histograms (np.histogram's binning rule),
  the density normalization, the transit and beam-timing convolutions,
  the scale and the expected background (``spectra_np``).

Reference semantics: ``tests/simultFit.py:279-300`` and
``tests/csi_oneBD.py:452-521``.  The tests and ``chip_smoke.py`` compare
the device forward against these functions.
"""
from __future__ import annotations

import numpy as np

from ..config import cell_attenuation_coeffs
from ..constants import masses, physics
from .e0grid import e0grid_moments_np
from .kinematics import dd_neutron_energy_np
from .timing import ZeroDegreeTimingSpread, zero_degree_expo_kernel


def _tof_np(mass, energy, distance):
    return distance / (physics.speed_of_light * np.sqrt(2.0 * energy / mass))


def bf16_round_np(x):
    """Round float32 values to bfloat16 (nearest, ties to even), as f64."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32).astype(np.float64)


def a_matrix_np(spec):
    """The spec's A operator in f64, rounded the way the device stores it."""
    a = spec.e0_grid_table.a_matrix
    if spec.a_dtype == "bfloat16":
        return bf16_round_np(a)
    return np.asarray(a, np.float32).astype(np.float64)


def grid_np(spec, *, e0=None, moments=None):
    """(..., M, Be) XS-weighted grids from raw e0 draws (..., N) or from
    fine-cell moments (..., 4, F), batched over leading axes."""
    tab = spec.e0_grid_table
    if moments is None:
        e0 = np.asarray(e0)
        moments = np.stack([e0grid_moments_np(tab, row)
                            for row in e0.reshape(-1, e0.shape[-1])])
        moments = moments.reshape(e0.shape[:-1] + moments.shape[-2:])
    moments = np.asarray(moments, np.float64)
    lead = moments.shape[:-2]
    grid = (moments.reshape(-1, 4 * tab.n_fine) @ a_matrix_np(spec))
    grid = grid.reshape(lead + (tab.n_x, tab.n_ed))
    if spec.cell_attenuation:
        grid = grid * cell_attenuation_coeffs(spec.x_binning.centers)[:, None]
    return grid


def lattice_np(spec, standoff, e0_mean):
    """(M, Be) closed-form TOF of every lattice cell (``cell_tof_lattice``)."""
    x = np.asarray(spec.x_binning.centers, np.float64)[:, None]
    ed = np.asarray(spec.ed_binning.centers, np.float64)[None, :]
    en = dd_neutron_energy_np(spec.ed_binning.centers)[None, :]
    n_dist = spec.geometry.cell_length - x + standoff
    if spec.add_half_zero_deg:
        n_dist = n_dist + spec.geometry.zero_deg_length / 2.0
    return (_tof_np(masses.deuteron, (float(e0_mean) + ed) / 2.0, x)
            + _tof_np(masses.neutron, en, n_dist))


def spread_np(spec):
    """(times, weights), each (Be, K), of the zero-degree transit spread."""
    n_ed = spec.ed_binning.n
    if spec.zero_degree != "segments":
        return np.zeros((n_ed, 1)), np.ones((n_ed, 1))
    zd = ZeroDegreeTimingSpread(length=spec.geometry.zero_deg_length)
    e = dd_neutron_energy_np(spec.ed_binning.centers)[:, None]
    x = zd.x_locs[None, :]
    xs = (4.83 / np.sqrt(e / 1000.0) - 0.578) * 1e-24
    w = np.exp(-xs * zd.density_h * x)
    return _tof_np(masses.neutron, e, x), w / w.sum(axis=-1, keepdims=True)


def tof_hist_np(base, draws, zt, zw, windows):
    """(R, n_pad) histograms of every lattice cell spread over K segments.

    np.histogram's rule (half-open bins, ``v == hi`` in the last bin,
    out-of-range dropped), applied to the float32 sample values and
    weights the device forms (``base + zt``, ``draws * zw``) with the
    device's float32 bin-index arithmetic — so a value within an ulp of
    an edge lands where the device puts it — and summed in float64.
    """
    f32 = np.float32
    n_pad = max(w.n_bins for w in windows)
    out = np.zeros((len(windows), n_pad))
    zt, zw = np.asarray(zt, f32)[None], np.asarray(zw, f32)[None]
    for r, win in enumerate(windows):
        v = (np.asarray(base[r], f32)[:, :, None] + zt).ravel()
        w_ = (np.asarray(draws[r], f32)[:, :, None] * zw).ravel()
        lo, hi = f32(win.lo), f32(win.hi)
        scale = f32(win.n_bins / (win.hi - win.lo))
        idx = np.clip(np.floor((v - lo) * scale).astype(np.int64), 0,
                      win.n_bins - 1)
        ok = (v >= lo) & (v <= hi)
        out[r, :win.n_bins] = np.bincount(
            idx[ok], weights=w_[ok].astype(np.float64),
            minlength=win.n_bins)
    return out


def spectra_np(spec, grids, base_tof, windows, scales, bg_levels=None, *,
               spread=None, get_pdf: bool = True):
    """R spectra from (R, M, Be) grids and lattices (``spectra_from_grids``).

    ``spread``: the (times, weights) tables to bin with (default
    :func:`spread_np`); pass the device's to compare binning on equal
    float32 inputs.  The background is its expectation
    (``bg_mode='expected'``); a Poisson background is a random draw and
    has no deterministic reference.
    """
    if bg_levels is not None and spec.bg_mode != "expected":
        raise ValueError("the reference adds the expected background only")
    area = spec.ed_binning.width * spec.x_binning.width
    grids = np.asarray(grids, np.float64)
    grids = grids / (grids.sum(axis=(1, 2), keepdims=True) * area)
    draws = grids * spec.n_samples
    if spec.rint_draws:
        draws = np.rint(draws)
    zt, zw = spread_np(spec) if spread is None else spread
    hist = tof_hist_np(base_tof, draws, zt, zw, windows)
    out = []
    for r, win in enumerate(windows):
        h = hist[r, :win.n_bins]
        if get_pdf:
            h = h / (h.sum() * (win.hi - win.lo) / win.n_bins)
        if spec.zero_degree == "expo":
            k = zero_degree_expo_kernel()
            h = np.convolve(h, k, mode="full")[: -(len(k) - 1)]
        h = np.convolve(h, spec.beam_timing.kernel, mode="same")
        h = float(scales[r]) * h
        if bg_levels is not None:
            h = h + float(bg_levels[r])
        out.append(h)
    return out
