"""Instrument timing-response kernels and their convolutions.

JAX rebuild of the reference timing subsystem:

* :class:`ExGaussianTiming` — exponentially-modified-Gaussian beam pulse
  shape with the roofit-fitted sigma=1.1910 ns, tau=1.0110 ns
  (``utilities/utilities.py:219-281``).
* :class:`GaussianTiming` — the oneBD Gaussian gamma-peak spread
  (``utilities/utilities.py:283-329``; instantiated
  ``tests/csi_oneBD.py:266`` as ``gaussianTiming(2.7, 4)``).
* :func:`zero_degree_expo_kernel` — oneBD 7-point exponential 0-degree
  transit kernel + its 'full'-mode trim (``tests/csi_oneBD.py:406-408,519``).
* :class:`ZeroDegreeTimingSpread` — the older 10-segment detector-transit
  model with Marion+Young n-p elastic cross section
  (``utilities/utilities.py:154-192``).

All kernels are tiny fixed arrays; convolution is ``jnp.convolve`` which XLA
lowers to a small fused conv — negligible next to the forward model.
"""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import erfc

from ..constants import TUNL_SSA_CSI, masses
from .kinematics import tof


def exgaussian_shape(time, sigma: float, tau: float):
    """Unnormalized exGaussian timing density at `time` (ns from t0).

    exp(sigma^2/(2 tau^2) - t/tau) * erfc((sigma^2 - t tau) /
    (sqrt(2) sigma tau))  (``utilities/utilities.py:265-273``; the reference
    writes ``1 - erf`` — we use erfc, which is the same function but avoids
    catastrophic cancellation in f32 on the early-time tail).
    """
    t = jnp.asarray(time)
    exp_arg = sigma ** 2 / (2.0 * tau ** 2) - t / tau
    erf_arg = (sigma ** 2 - t * tau) / (np.sqrt(2.0) * sigma * tau)
    return jnp.exp(exp_arg) * erfc(erf_arg)


def _exgaussian_np(t, sigma: float, tau: float) -> np.ndarray:
    """Host-side f64 exGaussian for one-time kernel builds."""
    t = np.asarray(t, dtype=np.float64)
    exp_arg = sigma ** 2 / (2.0 * tau ** 2) - t / tau
    erf_arg = (sigma ** 2 - t * tau) / (np.sqrt(2.0) * sigma * tau)
    return np.exp(exp_arg) * np.array([math.erfc(a) for a in erf_arg])


def _convolve_same(spectrum, kernel):
    return jnp.convolve(jnp.asarray(spectrum), jnp.asarray(kernel),
                        mode="same", precision="highest")


@dataclasses.dataclass(frozen=True)
class ExGaussianTiming:
    """Normalized binned exGaussian kernel (``utilities/utilities.py:232-262``).

    Window: [ceil(-5 sigma), ceil(10 tau)] with 1 ns bins; the kernel is the
    shape evaluated at bin centers and normalized to unit sum.
    """

    sigma: float = 1.1910
    tau: float = 1.0110
    bin_width: float = 1.0

    @property
    def kernel(self) -> np.ndarray:
        lo = np.ceil(-5.0 * self.sigma)
        hi = np.ceil(10.0 * self.tau)
        n = int(hi - lo)
        centers = np.linspace(lo + self.bin_width / 2,
                              hi - self.bin_width / 2, n)
        vals = _exgaussian_np(centers, self.sigma, self.tau)
        return vals / vals.sum()

    def apply_spreading(self, tof_spectrum):
        """'same'-mode convolution (``utilities/utilities.py:275-281``)."""
        return _convolve_same(tof_spectrum, self.kernel)

    def __hash__(self):
        return hash((self.sigma, self.tau, self.bin_width))


@dataclasses.dataclass(frozen=True)
class GaussianTiming:
    """Gaussian timing spread, oneBD style (``utilities/utilities.py:283-329``).

    NOTE: the reference hard-codes the kernel support to
    ``linspace(-20, 20, 11)`` regardless of sigma/bin width
    (``utilities/utilities.py:303``); we reproduce that for parity.
    """

    sigma: float = 1.0
    bin_width: float = 1.0

    @property
    def kernel(self) -> np.ndarray:
        centers = np.linspace(-20.0, 20.0, 11)
        vals = np.exp(-((centers / self.sigma) ** 2) / 2.0)
        return vals / vals.sum()

    def apply_spreading(self, tof_spectrum):
        return _convolve_same(tof_spectrum, self.kernel)

    def __hash__(self):
        return hash((self.sigma, self.bin_width))


def zero_degree_expo_kernel() -> np.ndarray:
    """oneBD 0-degree transit kernel: exp(-t/2) at t = linspace(0, 24, 7),
    normalized (``tests/csi_oneBD.py:406-408``)."""
    centers = np.linspace(0.0, 24.0, 7)
    vals = np.exp(-centers / 2.0)
    return vals / vals.sum()


def apply_zero_degree_expo(tof_spectrum, kernel=None):
    """'full'-mode convolution trimmed back to the input length
    (``tests/csi_oneBD.py:519``): keeps the causal tail only."""
    k = zero_degree_expo_kernel() if kernel is None else np.asarray(kernel)
    full = jnp.convolve(jnp.asarray(tof_spectrum), jnp.asarray(k),
                        mode="full", precision="highest")
    return full[: -(len(k) - 1)]


@dataclasses.dataclass(frozen=True)
class ZeroDegreeTimingSpread:
    """10-segment transit-time spread across the 0-degree detector
    (``utilities/utilities.py:154-192``)."""

    density_h: float = 4.82e22           # protons / cm^3
    length: float = TUNL_SSA_CSI.zero_deg_length
    n_segments: int = 10

    @property
    def x_locs(self) -> np.ndarray:
        seg = self.length / self.n_segments
        return np.linspace(seg / 2, self.length - seg / 2, self.n_segments)

    def np_elastic_xs(self, neutron_energy):
        """Marion+Young sigma_np in cm^2, E in keV
        (``utilities/utilities.py:167-172``)."""
        e = jnp.asarray(neutron_energy)
        return (4.83 / jnp.sqrt(e / 1000.0) - 0.578) * 1e-24

    def observation_pdf(self, length, neutron_energy):
        xs = self.np_elastic_xs(neutron_energy)
        return jnp.exp(-xs * self.density_h * length)

    def times_and_weights(self, neutron_energy):
        """Per-segment (tofs, weights) to add to each synthesized TOF.

        Batched: neutron_energy (...,) -> tofs/weights (..., n_segments).
        Matches ``getTimesAndWeights`` (``utilities/utilities.py:181-192``).
        """
        e = jnp.asarray(neutron_energy)[..., None]
        x = jnp.asarray(self.x_locs)
        tofs = tof(masses.neutron, e, x)
        weights = self.observation_pdf(x, e)
        weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
        return tofs, weights

    def __hash__(self):
        return hash((self.density_h, self.length, self.n_segments))
