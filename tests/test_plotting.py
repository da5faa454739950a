"""Content asserts for the visualization layer.

Not just import checks: each figure's plotted DATA is verified against
the math it claims to show (analytic pdf values, posterior quantiles),
so a broken parameterization or a transposed axis fails loudly.
"""
import os

import numpy as np
import pytest

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

from mcmctoffitting_tpu.utils.plotting import (  # noqa: E402
    initial_energy_plot, unfolded_spectrum_plot)


def test_initial_energy_plot_pdf_matches_scipy(tmp_path):
    """The analytic overlay must BE lognorm.pdf(beamE - E) and the sampled
    histogram must agree with it (utilities/dumbPlotting.py:32-49)."""
    from scipy.stats import lognorm as sp_lognorm

    beam_e, e_loss, scale, s = 2450.0, 1400.0, 50.0, 0.4
    out = tmp_path / "ie.png"
    fig = initial_energy_plot(beam_e, e_loss, scale, s, str(out))
    assert out.exists() and os.path.getsize(out) > 5_000

    ax = fig.axes[0]
    # the analytic curve: y == lognorm.pdf(beamE - x, s, loc, scale)
    (line,) = ax.lines
    x, y = line.get_data()
    np.testing.assert_allclose(
        y, sp_lognorm.pdf(beam_e - np.asarray(x), s, e_loss, scale),
        rtol=1e-6)
    # the density histogram tracks the pdf where there is real mass
    heights = np.array([p.get_height() for p in ax.patches])
    lefts = np.array([p.get_x() for p in ax.patches])
    widths = np.array([p.get_width() for p in ax.patches])
    centers = lefts + widths / 2
    pdf_at_centers = sp_lognorm.pdf(beam_e - centers, s, e_loss, scale)
    core = pdf_at_centers > 0.2 * pdf_at_centers.max()
    assert core.sum() > 3
    np.testing.assert_allclose(heights[core], pdf_at_centers[core],
                               rtol=0.15)
    # the histogram is a (near-)density: total mass within the range ~ 1
    assert abs(np.sum(heights * widths) - 1.0) < 0.05


def test_unfolded_spectrum_plot_band_is_posterior_quantiles(tmp_path):
    """The band/median must be the 16/50/84 quantiles of the coefficient
    samples (tests/devShapeTemplates.py:584-631 rebuild)."""
    rng = np.random.default_rng(0)
    energies = np.linspace(450.0, 1150.0, 8)
    true_coeffs = 100.0 * np.exp(-0.5 * ((energies - 800.0) / 150.0) ** 2)
    n = 600
    samples = np.concatenate([
        rng.normal([1.1, 0.6, 1.5], 0.05, size=(n, 3)),          # scales
        rng.normal(true_coeffs, 5.0, size=(n, 8)),               # coeffs
    ], axis=1)

    out = tmp_path / "unfolded.png"
    fig = unfolded_spectrum_plot(energies, samples, filename=str(out))
    assert out.exists() and os.path.getsize(out) > 5_000

    # 1 spectrum panel + 3 run-scale panels
    assert len(fig.axes) == 4
    ax = fig.axes[0]
    q = np.percentile(samples[:, 3:], [16, 50, 84], axis=0)
    # median curve: the first Line2D with 8 points
    med_line = next(ln for ln in ax.lines if len(ln.get_xdata()) == 8)
    np.testing.assert_allclose(med_line.get_xdata(), energies)
    np.testing.assert_allclose(med_line.get_ydata(), q[1], rtol=1e-6)
    # credible band: the fill_between polygon spans [q16, q84]
    # (errorbar adds LineCollections; the band is the PolyCollection)
    from matplotlib.collections import PolyCollection
    (band,) = [c for c in ax.collections
               if isinstance(c, PolyCollection)]
    verts = band.get_paths()[0].vertices
    assert verts[:, 1].min() == pytest.approx(q[0].min(), rel=1e-5)
    assert verts[:, 1].max() == pytest.approx(q[2].max(), rel=1e-5)
    # run-scale panels carry the quantile lines (dashed median + dotted)
    for r, axr in enumerate(fig.axes[1:]):
        vline_xs = sorted(ln.get_xdata()[0] for ln in axr.lines)
        np.testing.assert_allclose(
            vline_xs, np.percentile(samples[:, r], [16, 50, 84]),
            rtol=1e-6)


def test_unfolded_spectrum_plot_rejects_bad_layout():
    with pytest.raises(ValueError, match="run-scale"):
        unfolded_spectrum_plot(np.arange(8.0), np.zeros((10, 8)))
