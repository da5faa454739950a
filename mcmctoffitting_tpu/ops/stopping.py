"""Ion stopping power (Bethe) and deuteron energy-loss transport.

JAX rebuild of ``utilities/ionStopping.py``:

* :class:`BetheStopping` — the multi-material simple Bethe dE/dx
  (``utilities/ionStopping.py:34-97``), as a frozen dataclass whose materials
  are baked into jnp constants; evaluation is pure elementwise work.
* :func:`rk4_transport` — fixed-step RK4 integration of dE/dx over the gas
  cell for an entire batch of samples at once.  Replaces the reference's
  per-call ``scipy.integrate.ode('dopri5')`` (``tests/simultFit.py:256-258``)
  with compiler-friendly ``lax.scan`` control flow: all N samples propagate
  through all x bins in one fused program (the ODE is smooth and 1-D, so a
  few RK4 substeps per x-bin match dopri5 to < 1e-3 keV).
* :class:`StoppingTable` — the ``betheApprox`` fast path
  (``utilities/ionStopping.py:102-136``): E(E0, x) precomputed on an
  (E0-grid x x-bin-centers) table, queried per sample by a cubic spline in
  the E0 direction (the x query points coincide with the table's x columns,
  so the reference's RectBivariateSpline reduces to exactly this 1-D spline
  family along each grid line).
* :func:`havar_stopping` — the 8-element Havar foil alloy
  (``utilities/ionStopping.py:138-184``, SRIM atomic fractions).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import masses, physics
from .interp import cubic_spline_coeffs

AVOGADRO = 6.02214076e23

# (e^2 / 4 pi eps0)^2 in the keV-cm-ns unit system
# (reference ``utilities/ionStopping.py:69``).
FIXED_FACTOR = 1.67489e-14


@dataclasses.dataclass(frozen=True)
class BetheStopping:
    """Multi-material simple Bethe stopping model.

    ``materials``: tuple of (Z, A, rho_g_cm3, mean_excitation_keV).
    ``ion_charge``: charge of the incident ion (deuteron: 1).
    ``ion_mass``: mass of incident ion in keV/c^2 (the reference hard-codes
    the deuteron mass in ``dEdx``, ``utilities/ionStopping.py:82``).
    """

    materials: tuple[tuple[float, float, float, float], ...]
    ion_charge: float = 1.0
    ion_mass: float = masses.deuteron

    def with_material(self, Z, A, rho, excitation_keV) -> "BetheStopping":
        """Functional ``addMaterial`` (``utilities/ionStopping.py:71-76``)."""
        return dataclasses.replace(
            self, materials=self.materials + ((Z, A, rho, excitation_keV),))

    def _electron_densities(self) -> np.ndarray:
        return np.array([
            AVOGADRO * Z * rho / (A * physics.molar_mass_constant)
            for (Z, A, rho, _) in self.materials
        ])

    def dedx(self, energy):
        """Stopping power dE/dx in keV/cm at deuteron energy keV (negative).

        Bit-compatible (in f64) with ``simpleBethe.dEdx``
        (``utilities/ionStopping.py:78-97``).
        """
        e = jnp.asarray(energy)
        v2 = 2.0 * e / self.ion_mass * physics.speed_of_light ** 2
        leading = (4.0 * jnp.pi * self.ion_charge ** 2
                   / (masses.electron * physics.speed_of_light ** 2 * v2))
        n_e = self._electron_densities()
        excitations = np.array([m[3] for m in self.materials])
        log_arg = (2.0 * masses.electron / physics.speed_of_light ** 2
                   * v2[..., None] / excitations)
        contributions = jnp.sum(n_e * jnp.log(log_arg), axis=-1)
        return -leading * FIXED_FACTOR * contributions

    def __hash__(self):
        return hash((self.materials, self.ion_charge, self.ion_mass))


def d2_gas_stopping(rho: float = 8.565e-5) -> BetheStopping:
    """Deuterium gas cell medium.

    rho = 8.565e-5 g/cm^3 at 0.5 atm ("red notebook p157",
    ``tests/simultFit.py:193``); the oneBD run at 2 atm uses 4x that
    (``tests/csi_oneBD.py:273``).  Mean excitation 19.2 eV (PDG).
    """
    return BetheStopping(materials=((1.0, 2.0, rho, 19.2e-3),))


# Havar alloy: (Z, atomic mass, SRIM atomic fraction, excitation keV)
# (reference ``utilities/ionStopping.py:140-176``), bulk density 8.3 g/cm^3.
_HAVAR_COMPONENTS = (
    (27.0, 58.933195, 0.417829, 0.2970),
    (24.0, 51.9961, 0.222858, 0.2570),
    (28.0, 58.6934, 0.128336, 0.3110),
    (74.0, 183.84, 0.008824, 0.7270),
    (42.0, 95.94, 0.014494, 0.4240),
    (25.0, 54.938045, 0.016874, 0.2720),
    (26.0, 55.845, 0.181139, 0.2860),
    (6.0, 12.011, 0.009648, 0.078),
)


def havar_stopping() -> BetheStopping:
    """Havar foil stopping model (``utilities/ionStopping.py:138-184``)."""
    mats = tuple((Z, A, 8.3 * frac, exc) for (Z, A, frac, exc) in _HAVAR_COMPONENTS)
    return BetheStopping(materials=mats)


def rk4_transport(dedx_fn, e0, x_eval, n_substeps: int = 4,
                  x_start: float = 0.0, energy_floor: float = 20.0):
    """Transport initial energies through the medium with fixed-step RK4.

    Args:
      dedx_fn: vectorized dE/dx function of energy (keV/cm).
      e0: (...,) initial energies at ``x_start``.
      x_eval: static 1-D array of M increasing evaluation depths (cm).
      n_substeps: RK4 substeps per x interval (static).
      energy_floor: samples whose energy falls to this floor are frozen
        there.  The Bethe formula becomes unphysical (dE/dx changes sign)
        near E ~ I*m_d/(4 m_e) ~ 18 keV; the floor defaults to the bottom of
        the DDN cross-section table (20 keV), below which samples carry the
        clamped minimum weight and typically fall outside the eD histogram
        range anyway.  The reference's dopri5 integrates into that region
        unguarded; freezing keeps the batch NaN-free under jit.

    Returns:
      (M, ...) energies at each depth; row j is E(e0, x_eval[j]).

    Replaces per-likelihood dopri5 calls (``tests/simultFit.py:256-258``).
    Static shapes + ``lax.scan`` keep everything in one XLA program.
    """
    x_eval = np.asarray(x_eval, dtype=np.float64)
    xs_prev = np.concatenate([[x_start], x_eval[:-1]])
    spans = jnp.asarray((x_eval - xs_prev), dtype=jnp.result_type(e0))

    def rk4_span(e, span):
        h = span / n_substeps

        def substep(e, _):
            stopped = e <= energy_floor
            e_safe = jnp.maximum(e, energy_floor)
            k1 = dedx_fn(e_safe)
            k2 = dedx_fn(jnp.maximum(e_safe + 0.5 * h * k1, energy_floor))
            k3 = dedx_fn(jnp.maximum(e_safe + 0.5 * h * k2, energy_floor))
            k4 = dedx_fn(jnp.maximum(e_safe + h * k3, energy_floor))
            e_new = e_safe + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            e_new = jnp.maximum(e_new, energy_floor)
            return jnp.where(stopped, e, e_new), None

        e_next, _ = jax.lax.scan(substep, e, None, length=n_substeps)
        return e_next, e_next

    _, e_at_x = jax.lax.scan(rk4_span, jnp.asarray(e0), spans)
    return e_at_x


@dataclasses.dataclass(frozen=True)
class StoppingTable:
    """Precomputed E(E0, x) transport table with cubic-spline E0 lookup.

    Device-side ``betheApprox`` (``utilities/ionStopping.py:102-136``): the
    table is built once (host, f64, dense RK4) on the same grid the reference
    uses — ``np.arange(lo, hi, step)`` E0 rows by x-bin-center columns — and
    per-sample evaluation is a not-a-knot cubic spline in E0 for every x
    column at once (one gather + Horner, batched over samples AND columns).
    """

    e0_grid: np.ndarray       # (G,)
    x_centers: np.ndarray     # (M,)
    table: np.ndarray         # (G, M)
    coeffs: np.ndarray        # (4, G-1, M) spline coeffs along E0 per x col

    @classmethod
    def build(cls, stopping: BetheStopping, e0_bin_info, x_centers,
              n_substeps: int = 64,
              energy_floor: float | None = None) -> "StoppingTable":
        """e0_bin_info = (minE, maxE, step) as in ``tests/csi_oneBD.py:293``.

        ``energy_floor``: freeze rows at this energy during the build like
        ``rk4_transport`` does (None = integrate unguarded, matching the
        reference ``betheApprox`` exactly; the Bethe formula is unphysical
        below ~18 keV, so grid rows that stop inside the cell then carry
        junk — harmless when, as in oneBD, those rows sit far below the
        histogram range, but the floored build keeps the whole table
        physical)."""
        lo, hi, step = e0_bin_info
        e0_grid = np.arange(lo, hi, step, dtype=np.float64)
        x_centers = np.asarray(x_centers, dtype=np.float64)
        # Host-side f64 RK4 (numpy mirror of rk4_transport) for the tiny grid.
        table = _rk4_transport_np(stopping, e0_grid, x_centers, n_substeps,
                                  energy_floor=energy_floor)
        coeffs = cubic_spline_coeffs(e0_grid, table)  # (4, G-1, M)
        return cls(e0_grid, x_centers, table.T.copy().T, coeffs)

    def eval_stopped(self, e_zero, method: str = "onehot"):
        """E at every x column for each sample: (N,) -> (N, M).

        Mirrors ``betheApprox.evalStopped`` (``utilities/ionStopping.py:132``)
        but batched over all samples in one shot.

        method='onehot' (default): the per-sample spline-coefficient lookup
        is a one-hot matmul against the (segments, 4*M) coefficient
        matrix (chosen on the earlier accelerator, where gathers were
        slow; not yet re-decided on the H100), and with exactly one
        nonzero per one-hot row the matmul is bit-identical to the gather.
        method='gather': the direct lookup (CPU/debug path).
        """
        e = jnp.asarray(e_zero)
        c = jnp.asarray(self.coeffs, dtype=e.dtype)  # (4, G-1, M)
        # the E0 grid is uniform (np.arange) -> arithmetic segment index,
        # no searchsorted (no binary-search loop of gathers)
        lo = float(self.e0_grid[0])
        step = float(self.e0_grid[1] - self.e0_grid[0])
        n_seg = self.e0_grid.shape[0] - 1
        idx = jnp.clip(((e - lo) / step).astype(jnp.int32), 0, n_seg - 1)
        dt = (e - (lo + step * idx.astype(e.dtype)))[..., None]  # (N, 1)
        if method == "onehot":
            onehot = (idx[..., None]
                      == jnp.arange(n_seg, dtype=jnp.int32)).astype(e.dtype)
            m = self.x_centers.shape[0]
            # (N, G-1) @ (G-1, 4*M) -> (N, 4, M)
            cmat = jnp.moveaxis(c, 0, 1).reshape(n_seg, 4 * m)
            # precision='highest': a default-precision f32 matmul runs in
            # TF32 on the GPU (bf16 elsewhere), which would round the
            # keV-scale constant coefficients (keV-scale error); at full
            # f32 the single-nonzero rows make this bit-identical to the
            # gather
            c3, c2, c1, c0 = jnp.moveaxis(
                jnp.dot(onehot, cmat, precision="highest",
                        preferred_element_type=jnp.float32).reshape(
                            e.shape + (4, m)), -2, 0)
        else:
            c3, c2, c1, c0 = c[0][idx], c[1][idx], c[2][idx], c[3][idx]
        return ((c3 * dt + c2) * dt + c1) * dt + c0

    def __hash__(self):
        return hash((self.e0_grid.tobytes(), self.x_centers.tobytes(),
                     self.table.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, StoppingTable)
                and np.array_equal(self.e0_grid, other.e0_grid)
                and np.array_equal(self.x_centers, other.x_centers)
                and np.array_equal(self.table, other.table))


def _rk4_transport_np(stopping: BetheStopping, e0, x_eval, n_substeps,
                      energy_floor: float | None = None):
    """Host/f64 RK4 used for one-time table builds (no jax dependency)."""
    n_e = stopping._electron_densities()
    excitations = np.array([m[3] for m in stopping.materials])

    def dedx(e):
        v2 = 2.0 * e / stopping.ion_mass * physics.speed_of_light ** 2
        leading = (4.0 * np.pi * stopping.ion_charge ** 2
                   / (masses.electron * physics.speed_of_light ** 2 * v2))
        log_arg = (2.0 * masses.electron / physics.speed_of_light ** 2
                   * v2[..., None] / excitations)
        return -leading * FIXED_FACTOR * np.sum(n_e * np.log(log_arg), axis=-1)

    e = np.array(e0, dtype=np.float64)
    out = np.empty((len(e), len(x_eval)))
    x_prev = 0.0
    for j, x in enumerate(x_eval):
        h = (x - x_prev) / n_substeps
        for _ in range(n_substeps):
            if energy_floor is None:
                k1 = dedx(e)
                k2 = dedx(e + 0.5 * h * k1)
                k3 = dedx(e + 0.5 * h * k2)
                k4 = dedx(e + h * k3)
                e = e + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            else:
                f = energy_floor
                stopped = e <= f
                e_safe = np.maximum(e, f)
                k1 = dedx(e_safe)
                k2 = dedx(np.maximum(e_safe + 0.5 * h * k1, f))
                k3 = dedx(np.maximum(e_safe + 0.5 * h * k2, f))
                k4 = dedx(np.maximum(e_safe + h * k3, f))
                e_new = np.maximum(
                    e_safe + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), f)
                e = np.where(stopped, e, e_new)
        out[:, j] = e
        x_prev = x
    return out
