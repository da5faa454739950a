"""Non-parametric template-fitting model (spectrum unfolding).

Rebuild of ``tests/devShapeTemplates.py``: 32 monoenergetic-slice TOF
templates per standoff (eZeros ~ Uniform over each 25 keV slice of
[400, 1200] keV, ``:246-253,406-435``), model spectrum = scale x sum of
coefficient-weighted templates (``buildModelTOF :256-267``), 35-dim theta =
(3 run scales, 32 template coefficients), wide-Gaussian likelihood
(``lnlike_wide :272-294``), compound over 4 standoffs with the first run's
scale pinned to 1 (``compoundLnlike :336-346``), box prior with per-run
scale limits (``:350-366``).

Design notes: template generation reuses the shared forward-model
pipeline (transport + one-hot histograms) with a Uniform source; the
model build is literally a (runs, n_bins, 32) x (32,) matvec.
Templates cache to CSV like the reference (``:406-450``).
"""
from __future__ import annotations

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Binning
from ..constants import TUNL_SSA_CSI, TofWindow, tof_windows
from ..ops.histogram import histogram_density, weighted_histogram
from ..ops.likelihoods import template_gaussian_loglike
from ..ops.stopping import d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from .forward import ForwardSpec, cell_tof_lattice, energy_weight_grid

N_TEMPLATES = 32
TEMPLATE_E_RANGE = (400.0, 1200.0)
TEMPLATE_BOUNDS = np.linspace(*TEMPLATE_E_RANGE, N_TEMPLATES + 1)

RUN_LAYOUT = ("mid", "close", "close", "far")
SCALE_LIMS = ((0.8, 2.0), (0.25, 1.0), (1.3, 1.9))  # runs 2-4 (:350)
COEFF_LIM = (0.0, 25_000.0)


def default_spec(n_samples: int = 200_000) -> ForwardSpec:
    """devShapeTemplates binning: 150 eD bins over [200, 1700], 100 x bins."""
    return ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=Binning(200.0, 1700.0, 150),
        x_binning=Binning(0.0, TUNL_SSA_CSI.cell_length, 100),
        stopping=d2_gas_stopping(rho=8.565e-5),
        transport="rk4",
        beam_timing=ExGaussianTiming(),
        zero_degree="none",
        add_half_zero_deg=True,   # devShapeTemplates keeps the half-length
        n_samples=n_samples,
    )


def template_spectrum(key, e_lo: float, e_hi: float, spec: ForwardSpec,
                      standoff: float, window: TofWindow) -> jax.Array:
    """One monoenergetic-slice template (``generateModelData`` of
    devShapeTemplates: uniform source over [e_lo, e_hi], no scale, no
    zero-degree spread, density-normalized, beam-timing convolved)."""
    e_zeros = jax.random.uniform(key, (spec.n_samples,), minval=e_lo,
                                 maxval=e_hi)
    grid = energy_weight_grid(spec, e_zeros)
    area = spec.ed_binning.width * spec.x_binning.width
    grid = grid / (jnp.sum(grid) * area)
    draws = jnp.rint(grid * spec.n_samples)
    # reference uses the slice LOWER BOUND as the e0 of the effective
    # deuteron energy (devShapeTemplates 'e0, e1 = params'; eff=(e0+eD)/2)
    base_tof = cell_tof_lattice(spec, standoff, jnp.float32(e_lo))
    hist = weighted_histogram(base_tof.reshape(-1), window.lo, window.hi,
                              window.n_bins, draws.reshape(-1))
    pdf = histogram_density(hist, window.lo, window.hi)
    return spec.beam_timing.apply_spreading(pdf)


def generate_templates(key, spec: ForwardSpec, *, n_runs: int = 4):
    """All (run, slice) templates; returns list over runs of (32, n_bins)."""
    standoffs = [spec.geometry.standoff(n) for n in RUN_LAYOUT[:n_runs]]
    windows = [tof_windows[n] for n in RUN_LAYOUT[:n_runs]]
    out = []
    # e_lo/e_hi are pure VALUES in template_spectrum (uniform bounds +
    # the effective-energy base), so they trace: ONE compile per run
    # window instead of one per (run, slice) — 4 programs, not 128
    # (material under remote-compile transports).
    fn = jax.jit(template_spectrum,
                 static_argnames=("spec", "standoff", "window"))
    for run, (standoff, window) in enumerate(zip(standoffs, windows)):
        rows = []
        for t in range(N_TEMPLATES):
            k = jax.random.fold_in(key, run * N_TEMPLATES + t)
            rows.append(np.asarray(fn(
                k, jnp.float32(TEMPLATE_BOUNDS[t]),
                jnp.float32(TEMPLATE_BOUNDS[t + 1]),
                spec, standoff, window)))
        out.append(np.stack(rows))
    return out


def save_templates_csv(path: str, templates) -> None:
    """Reference-compatible CSV cache: one row per (run, slice) template
    (``tests/devShapeTemplates.py:410-424``)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for run_templates in templates:
            for row in np.asarray(run_templates):
                w.writerow([repr(float(v)) for v in row])


def load_templates_csv(path: str, n_runs: int = 4):
    """Load the CSV cache (``tests/devShapeTemplates.py:426-450``)."""
    rows = []
    with open(path, newline="") as f:
        for line in csv.reader(f):
            rows.append(np.array([float(v) for v in line]))
    out = []
    i = 0
    for _ in range(n_runs):
        out.append(np.stack(rows[i: i + N_TEMPLATES]))
        i += N_TEMPLATES
    return out


def build_model_tof(scale, coeffs, templates_run):
    """scale * (coeffs @ templates): ``buildModelTOF`` as one matvec."""
    return scale * (jnp.asarray(coeffs) @ jnp.asarray(templates_run))


@dataclasses.dataclass(frozen=True)
class TemplateFitProblem:
    """35-dim template unfolding fit over 4 standoffs."""

    n_runs: int = 4

    @property
    def n_dim(self) -> int:
        return 3 + N_TEMPLATES

    @property
    def windows(self):
        return tuple(tof_windows[n] for n in RUN_LAYOUT[: self.n_runs])

    def log_prob(self, theta, key, observed, templates) -> jax.Array:
        """lnprob (``tests/devShapeTemplates.py:368-380``): run 1 has scale
        pinned to 1; runs 2..4 use theta[0:3]; coeffs are theta[3:]."""
        del key  # deterministic likelihood (templates are fixed)
        coeffs = theta[3:]
        # prior (:350-366)
        ok = jnp.asarray(True)
        for i in range(min(3, self.n_runs - 1)):
            lo, hi = SCALE_LIMS[i]
            ok = ok & (theta[i] >= lo) & (theta[i] <= hi)
        ok = ok & jnp.all((coeffs >= COEFF_LIM[0]) & (coeffs <= COEFF_LIM[1]))

        total = jnp.asarray(0.0)
        for run in range(self.n_runs):
            scale = jnp.asarray(1.0) if run == 0 else theta[run - 1]
            model = build_model_tof(scale, coeffs,
                                    jnp.asarray(templates[run]))
            total = total + template_gaussian_loglike(
                model, jnp.asarray(observed[run]))
        total = jnp.where(jnp.isnan(total), -jnp.inf, total)
        return jnp.where(ok, total, -jnp.inf)

    def make_log_prob_fn(self, observed, templates):
        obs = tuple(jnp.asarray(o, dtype=jnp.float32) for o in observed)
        tmpl = tuple(jnp.asarray(t, dtype=jnp.float32) for t in templates)

        def logp(theta, key):
            return self.log_prob(theta, key, obs, tmpl)

        return logp

    def initial_guess_model(self) -> np.ndarray:
        """Gaussian-mixture kernel guess for the coefficients
        (``getGuessParams_model``, ``tests/devShapeTemplates.py:173-180``)."""
        centers = (TEMPLATE_BOUNDS[:-1] + TEMPLATE_BOUNDS[1:]) / 2
        width = (centers[1] - centers[0]) / 2.0

        def norm_pdf(x, loc, scale):
            return (np.exp(-((x - loc) / scale) ** 2 / 2)
                    / (scale * np.sqrt(2 * np.pi)))

        return 8 * (37_500 * norm_pdf(centers, 820.0, 75.0) * width
                    + 20_000 * norm_pdf(centers, 730.0, 125.0) * width)
