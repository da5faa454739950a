"""The "simple" model family (historical models v0-v3).

Covers the early reference drivers with one configurable model:

* v0 ``tests/simpleTOFmodel.py``  — E(x) = E0 + E1 x, fixed sigma, unbinned
  sample-based histogram PDF, multinomial likelihood, 3 params.
* v1 ``tests/simpleTOFfit.py``    — cubic polynomial E(x), fixed sigma,
  5 params.
* v2 ``tests/intermediateTOFfit.py`` — cubic E(x) + linearly growing
  fractional sigma, DDN XS weighting, beam-timing convolution, 6 params.
* v2.5/v3 ``tests/intermediateTOFmodel.py`` / ``advIntermediateTOFmodel.py``
  — E0 ~ N(e0, e0*sigma0frac) transported by the Bethe ODE, 2 params.

All share one device path: draw (x, E_d) samples, compute per-sample TOF
closed-form, weighted-histogram by one-hot matmul.  Unlike the flagship models the
sample axis is the histogram axis directly (no (x, eD) lattice resampling).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..constants import TUNL_SSA_CSI, CellGeometry, TofWindow, masses
from ..ops.histogram import histogram_density, weighted_histogram
from ..ops.kinematics import dd_neutron_energy, tof
from ..ops.likelihoods import box_lnprior, multinomial_loglike
from ..ops.stopping import BetheStopping, rk4_transport
from ..ops.timing import ExGaussianTiming
from ..ops.xs import ddn_xs

# v0 truth parameters and binning (tests/simpleTOFmodel.py:24-28,124-126)
V0_WINDOW = TofWindow(175.0, 200.0, 25)
V0_TRUTH = (1100.0, -100.0, 50.0)
V0_LO = (800.0, -200.0, 10.0)
V0_HI = (1200.0, 0.0, 100.0)


@dataclasses.dataclass(frozen=True)
class SimpleSpec:
    """Static config for the simple family."""

    geometry: CellGeometry = TUNL_SSA_CSI
    window: TofWindow = V0_WINDOW
    poly_order: int = 1           # 1 (v0), 3 (v1/v2)
    sigma_growth: bool = False    # v2: sigma(x) = sigma0 + sigma1 * x
    xs_weighting: bool = False    # v2+: weight samples by DDN XS
    convolve_beam: bool = False   # v2+: exGaussian spreading
    # v2.5: E0 gaussian at cell entrance + Bethe transport instead of poly
    bethe_transport: bool = False
    stopping: Optional[BetheStopping] = None
    # v0 uses cellToZero as the standoff and no detector half-length;
    # v1+ pass standoff explicitly and add zeroDegLength/2
    add_half_zero_deg: bool = False
    n_samples: int = 100_000
    rk4_substeps: int = 4
    n_transport_bins: int = 10   # x resolution for the v2.5 ODE path


def sample_tof(key, params, spec: SimpleSpec, standoff: float):
    """Draw (x, E_d, E_n, tof[, weight]) samples from the model.

    Mirrors generateModelData of the v0-v2.5 drivers
    (``tests/simpleTOFmodel.py:57-76``, ``tests/simpleTOFfit.py:94-116``,
    ``tests/intermediateTOFfit.py:102-141``,
    ``tests/intermediateTOFmodel.py:115-161``).
    Returns (tof_values (N,), weights (N,) or None, e_d, x).
    """
    params = jnp.asarray(params)
    kx, ke = jax.random.split(key)
    n = spec.n_samples
    length = spec.geometry.cell_length
    x = jax.random.uniform(kx, (n,), minval=0.0, maxval=length)

    if spec.bethe_transport:
        # v2.5: E0 ~ N(e0, e0*sigma0frac); transport to each sample's x by
        # binning x (energy loss is smooth; per-bin transport like the
        # reference's odeint over x_binCenters)
        e0, sigma0 = params[0], params[1]
        e_init = e0 + e0 * sigma0 * jax.random.normal(ke, (n,))
        import numpy as np
        x_centers = np.linspace(length / (2 * spec.n_transport_bins),
                                length * (1 - 1 / (2 * spec.n_transport_bins)),
                                spec.n_transport_bins)
        e_at_x = rk4_transport(spec.stopping.dedx, e_init, x_centers,
                               n_substeps=spec.rk4_substeps)  # (M, N)
        bin_idx = jnp.clip((x / length * spec.n_transport_bins).astype(
            jnp.int32), 0, spec.n_transport_bins - 1)
        e_d = jnp.take_along_axis(e_at_x, bin_idx[None, :], axis=0)[0]
        e_source = e0
    else:
        # polynomial mean energy: E(x) = p0 + p1 x + ... (order static)
        mean_e = params[0]
        for k in range(1, spec.poly_order + 1):
            mean_e = mean_e + params[k] * x ** k
        if spec.sigma_growth:
            # v2: sigma(x) = meanE(x) * (sigma0 + sigma1 * x) — fractional
            # of the LOCAL mean energy (tests/intermediateTOFfit.py:113-116)
            sigma0, sigma1 = params[spec.poly_order + 1], params[
                spec.poly_order + 2]
            sigma = mean_e * (sigma0 + sigma1 * x)
        else:
            sigma = params[spec.poly_order + 1]
        e_d = mean_e + sigma * jax.random.normal(ke, (n,))
        e_source = params[0]

    e_n = dd_neutron_energy(e_d)
    n_dist = standoff + (length - x)
    if spec.add_half_zero_deg:
        n_dist = n_dist + spec.geometry.zero_deg_length / 2.0
    tof_n = tof(masses.neutron, e_n, n_dist)
    eff_ed = (e_source + e_d) / 2.0
    tof_d = tof(masses.deuteron, eff_ed, x)
    tofs = tof_n + tof_d

    weights = ddn_xs(e_d) if spec.xs_weighting else None
    return tofs, weights, e_d, x


def model_pdf(key, params, spec: SimpleSpec, standoff: float):
    """Binned TOF PDF for the likelihood (density-normalized histogram)."""
    tofs, weights, _, _ = sample_tof(key, params, spec, standoff)
    w = spec.window
    hist = weighted_histogram(tofs, w.lo, w.hi, w.n_bins, weights)
    pdf = histogram_density(hist, w.lo, w.hi)
    if spec.convolve_beam:
        pdf = ExGaussianTiming().apply_spreading(pdf)
    return pdf


@dataclasses.dataclass(frozen=True)
class SimpleProblem:
    """v0-style closure-test problem: multinomial likelihood + box prior.

    Defaults reproduce simpleTOFmodel (``tests/simpleTOFmodel.py:106-120``):
    strict box prior, standoff = cellToZero, 3 params.
    """

    spec: SimpleSpec = SimpleSpec()
    standoff: float = TUNL_SSA_CSI.cell_to_zero
    param_lo: tuple = V0_LO
    param_hi: tuple = V0_HI

    def log_prob(self, theta, key, observed) -> jax.Array:
        prior = box_lnprior(theta, jnp.asarray(self.param_lo),
                            jnp.asarray(self.param_hi), inclusive=False)
        pdf = model_pdf(key, theta, self.spec, self.standoff)
        ll = multinomial_loglike(pdf, observed)
        return jnp.where(jnp.isneginf(prior), -jnp.inf, prior + ll)

    def make_log_prob_fn(self, observed):
        obs = jnp.asarray(observed, dtype=jnp.float32)

        def logp(theta, key):
            return self.log_prob(theta, key, obs)

        return logp
