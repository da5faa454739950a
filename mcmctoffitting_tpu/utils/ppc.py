"""Posterior-predictive checks, spectrum extraction, and MCNP SDEF export.

JAX rebuild of ``utilities/ppcTools.py`` / ``ppcTools_oneBD.py``:
instead of looping posterior draws through a Python generateModelData
(``utilities/ppcTools.py:283-330``), draws are stacked and the forward model
is evaluated per draw under jit (vmap is avoided on purpose: each PPC draw
is already a large batched program; scanning keeps peak memory flat).

Provides:
* :class:`PPCSampler` — posterior draws -> model spectra + neutron/deuteron
  spectra (reference ``generatePPC``), with the oneBD ``lnprobcut`` filter
  (``utilities/ppcTools_oneBD.py:279-289``).
* :func:`percentile_bands` — 16/50/84% credible bands
  (``tests/testPPC.py:110-139``).
* :func:`sample_initial_energy_dist` — beam-energy posterior samples
  (``utilities/ppcTools.py:334-354``).
* :func:`make_sdef_sia_cumulative` — MCNP 'si a'/'sp' source card strings
  (``utilities/ppcTools.py:397-422``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class PPCResult:
    """Stacked PPC draws."""

    tof_spectra: list          # per run: (n_draws, n_bins)
    neutron_spectra: np.ndarray  # (n_draws, x_bins, eD_bins) weight grids
    thetas: np.ndarray         # (n_draws, D) parameter draws used


class PPCSampler:
    """Sample the posterior chain and push draws through the forward model.

    ``problem``: a SimultFitProblem / OneBDProblem (anything exposing
    run_spectrum + windows + spec).
    ``chain``: (S, W, D) array; ``log_probs``: (S, W) (for lnprob_cut).
    """

    def __init__(self, problem, chain, log_probs=None, *,
                 n_steps_to_include: int = 50):
        self.problem = problem
        self.chain = np.asarray(chain)
        self.log_probs = None if log_probs is None else np.asarray(log_probs)
        tail = self.chain[-n_steps_to_include:]
        self.flat = tail.reshape(-1, tail.shape[-1])
        if self.log_probs is not None:
            self.flat_lp = self.log_probs[-n_steps_to_include:].reshape(-1)
        else:
            self.flat_lp = None

    def draw_thetas(self, key, n_draws: int,
                    lnprob_cut: Optional[float] = None) -> np.ndarray:
        """Random posterior draws from the chain tail (with replacement,
        like ``np.random.randint`` in ``utilities/ppcTools.py:295``);
        optional lnprob floor (``utilities/ppcTools_oneBD.py:279-289``)."""
        flat = self.flat
        if lnprob_cut is not None and self.flat_lp is not None:
            mask = self.flat_lp > lnprob_cut
            if mask.sum() == 0:
                raise ValueError("lnprob_cut removed every sample")
            flat = flat[mask]
        idx = np.asarray(jax.random.randint(key, (n_draws,), 0, len(flat)))
        return flat[idx]

    def generate(self, key, n_draws: int = 500,
                 lnprob_cut: Optional[float] = None) -> PPCResult:
        """The reference ``generatePPC``: per draw, per run, generate a
        model spectrum (+ the neutron-yield weight grid).

        One jit dispatch per run (and one for the weight grids), each a
        ``lax.map`` over draws — the reference's 500-draw default
        (``utilities/ppcTools.py:283``) costs 4-5 dispatches total instead
        of draws x runs; lax.map (not vmap) keeps the peak footprint at one
        draw's forward model."""
        thetas = self.draw_thetas(jax.random.fold_in(key, 0), n_draws,
                                  lnprob_cut)
        thetas_j = jnp.asarray(thetas, dtype=jnp.float32)
        d_idx = jnp.arange(n_draws)

        @functools.partial(jax.jit, static_argnums=0)
        def run_spectra(run):
            def one(args):
                d, theta = args
                k_d = jax.random.fold_in(key, 1 + d)
                return self.problem.run_spectrum(
                    jax.random.fold_in(k_d, run), theta, run, get_pdf=True)
            return jax.lax.map(one, (d_idx, thetas_j))

        per_run = [np.asarray(run_spectra(run))
                   for run in range(len(self.problem.windows))]
        grids = np.asarray(self._weight_grids(key, d_idx, thetas_j))
        return PPCResult(per_run, grids, thetas)

    @functools.partial(jax.jit, static_argnums=0)
    def _weight_grids(self, key, d_idx, thetas):
        """Neutron-yield (x, eD) grids, one per draw (the eN/eD spectra the
        reference accumulates alongside, ``utilities/ppcTools.py:164-187``)."""
        from ..models.forward import energy_weight_grid, sample_beam_energies
        spec = self.problem.spec

        def one(args):
            d, theta = args
            k_d = jax.random.fold_in(key, 1 + d)
            ez = sample_beam_energies(k_d, spec, self._shared4(theta))
            grid = energy_weight_grid(spec, ez)
            return grid

        return jax.lax.map(one, (d_idx, thetas))

    def _shared4(self, theta):
        """(beamE, eLoss, scale, s) from a theta of either flagship model."""
        if hasattr(self.problem, "shared_params"):
            return self.problem.shared_params(theta)
        return jnp.asarray(theta)[..., :4]


def get_dtof_distribution(key, sampler: PPCSampler, *,
                          n_draws: int = 1, n_samples_per: int = 1000,
                          n_tof_bins: int = 100):
    """Deuteron time-of-flight-through-cell distribution from the PPC.

    Equivalent of ``utilities/ppcTools.py:358-394`` (getDTOFdistribution),
    which samples one posterior theta, transports 1000 beam draws through
    the cell and returns the transported energies at each x bin center —
    but its promised dTOF histogram (``dtofHist``) is allocated and never
    filled.  Here the computation is finished: per posterior draw,

      e_at_x[m, i] = E(e0_i, x_m)                     (transport)
      dtof[m, i]   = sum_{k<=m} dx / v(E(e0_i, x_k))  (cumulative transit)

    with v from the same non-relativistic kinematics as the TOF lattice
    (``utilities/utilities.py:64-73``).  Returns a dict with
    ``x_centers`` (M,), ``e_at_x`` (n_draws, M, N), ``dtof``
    (n_draws, M, N) cumulative deuteron transit times (ns), and
    ``dtof_hist`` (M, n_tof_bins) — the per-x-slice histogram the
    reference left unfilled — over all draws pooled.
    """
    from ..constants import masses, physics
    from ..models.forward import _transport_all, sample_beam_energies

    spec = sampler.problem.spec
    x = np.asarray(spec.x_binning.centers, np.float64)
    dx = np.diff(np.concatenate([[0.0], x]))      # slice widths up to x_m
    thetas = sampler.draw_thetas(jax.random.fold_in(key, 0), n_draws)

    @jax.jit
    def one(k, theta4):
        ez = sample_beam_energies(k, spec, theta4, n=n_samples_per)
        e_at_x = _transport_all(spec, ez)                      # (M, N)
        v = physics.speed_of_light * jnp.sqrt(
            2.0 * e_at_x / masses.deuteron)                    # cm/ns
        dt = jnp.asarray(dx, jnp.float32)[:, None] / v
        return e_at_x, jnp.cumsum(dt, axis=0)

    e_list, t_list = [], []
    for i, theta in enumerate(thetas):
        p4 = sampler._shared4(jnp.asarray(theta, jnp.float32))
        e_at_x, dtof = one(jax.random.fold_in(key, 1 + i), p4)
        e_list.append(np.asarray(e_at_x))
        t_list.append(np.asarray(dtof))
    e_all = np.stack(e_list)                                   # (D, M, N)
    t_all = np.stack(t_list)
    t_max = float(t_all.max()) or 1.0
    hist = np.stack([
        np.histogram(t_all[:, m, :].reshape(-1), n_tof_bins,
                     (0.0, t_max))[0]
        for m in range(x.shape[0])])                           # (M, bins)
    return {"x_centers": x, "e_at_x": e_all, "dtof": t_all,
            "dtof_hist": hist, "thetas": thetas}


def percentile_bands(stacked: np.ndarray,
                     q: Sequence[float] = (16, 50, 84)) -> np.ndarray:
    """(n_draws, n_bins) -> (len(q), n_bins) credible bands
    (``tests/testPPC.py:47-54``)."""
    return np.percentile(np.asarray(stacked), list(q), axis=0)


def sample_initial_energy_dist(key, sampler: PPCSampler, *,
                               n_samples: int = 100,
                               n_draws_per: int = 10_000,
                               normed: bool = False) -> np.ndarray:
    """Posterior samples of the initial deuteron-energy distribution
    (``utilities/ppcTools.py:334-354``).  Returns (n_samples, eD_bins)."""
    from ..models.forward import sample_beam_energies
    spec = sampler.problem.spec
    eb = spec.ed_binning
    thetas = sampler.draw_thetas(jax.random.fold_in(key, 0), n_samples)
    out = np.zeros((n_samples, eb.n))
    for i, theta in enumerate(thetas):
        p4 = sampler._shared4(jnp.asarray(theta, jnp.float32))
        k = jax.random.fold_in(key, 1 + i)
        e = sample_beam_energies(k, spec, p4, n=n_draws_per)
        hist, _ = np.histogram(np.asarray(e), eb.n, (eb.lo, eb.hi),
                               density=normed)
        out[i] = hist * (eb.width if normed else 1.0)
    return out


def make_sdef_sia_cumulative(en_centers_keV: np.ndarray,
                             neutron_spectrum: np.ndarray,
                             dist_number: int = 100) -> dict:
    """MCNP SDEF 'si a' / 'sp' card strings, energies in MeV
    (``utilities/ppcTools.py:397-422``)."""
    si = [f"si{dist_number} a"]
    sp = [f"sp{dist_number}"]
    for en, counts in zip(np.asarray(en_centers_keV),
                          np.asarray(neutron_spectrum)):
        si.append(" {:.3f}".format(en / 1000.0))
        sp.append(" {:.0f}".format(counts))
    return {"si": "".join(si), "sp": "".join(sp)}


def collapse_neutron_spectrum(grids: np.ndarray) -> np.ndarray:
    """Sum PPC weight grids over draws and cell length -> eD/eN spectrum
    (``utilities/ppcTools.py:405-411``)."""
    return np.asarray(grids).sum(axis=(0, 1))


def rebin(spectrum: np.ndarray, factor: int) -> np.ndarray:
    """Sum-preserving rebin by an integer factor
    (``tests/ppcPlotting_oneBD.py:195-230`` rebins spectra before SDEF/CSV
    export); trailing remainder bins are dropped like the reference's
    integer reshape."""
    spectrum = np.asarray(spectrum)
    n = (spectrum.shape[-1] // factor) * factor
    return spectrum[..., :n].reshape(
        spectrum.shape[:-1] + (n // factor, factor)).sum(axis=-1)


def export_spectrum_csv(path: str, centers: np.ndarray,
                        spectrum: np.ndarray) -> None:
    """CSV export of (energy, counts) rows (``tests/ppcPlotting_oneBD.py``)."""
    import csv as csvlib
    with open(path, "w", newline="") as f:
        w = csvlib.writer(f)
        for c, v in zip(np.asarray(centers), np.asarray(spectrum)):
            w.writerow([float(c), float(v)])
