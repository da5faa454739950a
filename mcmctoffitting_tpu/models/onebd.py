"""The csi_oneBD flagship model: most-evolved fitter, 9 parameters.

Preset mirroring ``tests/csi_oneBD.py``: fixed beam reference energy
2490 keV (``:426``, ``constants/constants.py:128``), theta = (eLoss, scale,
s, N_1..N_3, BG_1..BG_3); spline-table stopping (betheApprox grid
(100, 2400, 100), ``:293-295``), cell attenuation weights, Gaussian beam
timing (sigma=2.7, 4 ns bins, ``:266``), exponential 0-degree transit kernel
(``:406-408``), per-run Poisson background (``:521``), binning presets
default (100 eD x 10 x) and -hardcore (400 x 20) (``:199-205``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import deuteron_binning_onebd, x_binning_onebd
from ..constants import (TUNL_SSA_CSI_ONEBD, TofWindow, onebd_consts,
                         tof_windows_onebd)
from ..ops.likelihoods import (box_lnprior, poisson_binned_loglike,
                               poisson_logpmf_loglike)
from ..ops.stopping import StoppingTable, d2_gas_stopping
from ..ops.timing import GaussianTiming
from .forward import ForwardSpec, tof_spectra_multi, tof_spectrum

RUN_LAYOUT = ("close", "mid", "far")

# parameter bounds (tests/csi_oneBD.py:595-606)
ELOSS_LO, ELOSS_HI = 200.0, 2000.0
SCALE_LO, SCALE_HI = 10.0, 700.0
S_LO, S_HI = 0.05, 3.0
NORM_LO, NORM_HI = 1e3, 1.0e8
BG_LO, BG_HI = 0.0, 1e3

STOPPING_TABLE_BINNING = (100.0, 2400.0, 100.0)


@functools.lru_cache(maxsize=8)
def _build_table(rho: float, x_binning_n: int) -> StoppingTable:
    stopping = d2_gas_stopping(rho=rho)
    return StoppingTable.build(stopping, STOPPING_TABLE_BINNING,
                               x_binning_onebd(x_binning_n).centers)


def default_spec(n_samples: int = 200_000, *,
                 fine_grid: int | None = None,
                 hardcore: bool = False,
                 xs_mode: str = "e0grid",
                 sampling: str = "mc") -> ForwardSpec:
    """oneBD forward spec; density 4x (2 atm run, tests/csi_oneBD.py:273).

    xs_mode='e0grid': static preimage factorization (ops/e0grid.py) — the
    per-sample transport lookup + per-slice one-hot histograms collapse
    into one shared fine-grid moment pass.
    """
    rho = 4 * 8.565e-5
    if sampling in ("expected", "counts"):
        xs_mode = "e0grid"  # the closed-form moments ride the A operator
    ed_bins, x_bins = (400, 20) if hardcore else (100, 10)
    e0_grid_table = None
    # default F=512: boundary-split error stays noise-dominated (see
    # tests/test_e0grid.py); hardcore F=1024 keeps the mis-assignment
    # noise at <=25% of each bin's own MC noise (+3% effective per-bin
    # sigma) — measured barely better at 2048 (0.18 vs 0.25 ratio) for
    # 2x the moment-dot cost.  counts mode costs O(F), so it takes the
    # finer grid outright (see simult.default_spec)
    if sampling == "counts":
        # F=1024 measured equivalent to 2048 at the 200k-draw production
        # scale on all three instruments (operator logp shift 0.051 vs
        # 0.053, per-eval noise 0.130 vs 0.121, posterior A/B worst
        # |dz| = 0.09) at ~1.7x the sampling speed
        # (tools/counts_f_study.py, tools/counts_f_posterior_ab.py);
        # small-draw runs keep the finer grid (see simult.default_spec)
        e0_grid_fine = 1024 if n_samples >= 100_000 else 2048
    else:
        e0_grid_fine = 1024 if hardcore else 512
    if fine_grid is not None:
        e0_grid_fine = int(fine_grid)
    if xs_mode == "e0grid":
        from ..ops.e0grid import cached_e0_grid_table
        from ..ops.xs import ddn_xs_uniform
        e0_grid_table = cached_e0_grid_table(
            _build_table(rho, x_bins), deuteron_binning_onebd(ed_bins),
            ddn_xs_uniform, e0_grid_fine)
    return ForwardSpec(
        geometry=TUNL_SSA_CSI_ONEBD,
        ed_binning=deuteron_binning_onebd(ed_bins),
        x_binning=x_binning_onebd(x_bins),
        stopping=d2_gas_stopping(rho=rho),
        transport="table",
        stopping_table=_build_table(rho, x_bins),
        beam_timing=GaussianTiming(2.7, 4),
        zero_degree="expo",
        cell_attenuation=True,
        # see simult.default_spec: sequential run axis (not yet measured
        # on the H100)
        run_axis="sequential",
        n_samples=n_samples,
        # the oneBD driver disabled the redraw loop (tests/csi_oneBD.py:440)
        n_redraw_rounds=0,
        # see simult.default_spec: bound the batched one-hot block; oneBD
        # has 100 (default) / 400 (-hardcore) eD bins vs simult's 50, so the
        # chunk is half/eighth to keep the same peak footprint
        histogram_chunk=512 if hardcore else 2048,
        # hardcore counts: the (4F=4096, M*Be=8000) = 131 MB A operator is
        # stored in bf16, halving the bytes each contraction streams; the
        # full-fit posterior A/B passed at worst |dz| = 0.22
        # (artifacts/hardcore_a_dtype_ab.json).  Chosen by timing on the
        # earlier accelerator; not yet measured on the H100.  -aDtype
        # float32 restores exact contraction; non-hardcore shapes keep
        # f32 (A is ~4-16 MB there).
        a_dtype=("bfloat16" if hardcore and sampling == "counts"
                 else "float32"),
        xs_mode=xs_mode,
        e0_grid_table=e0_grid_table,
        e0_grid_fine=e0_grid_fine,
        sampling=sampling,
    )


@dataclasses.dataclass(frozen=True)
class OneBDProblem:
    """Static joint-fit problem for the oneBD campaign."""

    spec: ForwardSpec
    n_runs: int = 3
    # 'reference' = the faithful "poor man's logpmf" (tests/simultFit.py:
    # 389-409).  Its int()-cast gammaln makes the log-likelihood a SAWTOOTH
    # in the model counts: measured pseudo-marginal logp noise sigma ~ 7e4
    # at the flagship scale (nearly draw-count-independent) — the dominant
    # source of ensemble acceptance decay.  'poisson' = the correct
    # Poisson(obs | rate=model) logpmf: same posterior information, logp
    # noise sigma ~ 2 at 200k draws (measured).
    likelihood: str = "reference"

    @property
    def standoffs(self) -> tuple[float, ...]:
        g = self.spec.geometry
        return tuple(g.standoff(name) for name in RUN_LAYOUT[: self.n_runs])

    @property
    def windows(self) -> tuple[TofWindow, ...]:
        return tuple(tof_windows_onebd[name]
                     for name in RUN_LAYOUT[: self.n_runs])

    @property
    def n_dim(self) -> int:
        return 3 + 2 * self.n_runs

    @property
    def param_lo(self) -> np.ndarray:
        return np.concatenate([[ELOSS_LO, SCALE_LO, S_LO],
                               np.full(self.n_runs, NORM_LO),
                               np.full(self.n_runs, BG_LO)])

    @property
    def param_hi(self) -> np.ndarray:
        return np.concatenate([[ELOSS_HI, SCALE_HI, S_HI],
                               np.full(self.n_runs, NORM_HI),
                               np.full(self.n_runs, BG_HI)])

    def guess_theta(self, observed, guesses=(700.0, 100.0, 0.5),
                    bg_guess: float = 10.0) -> np.ndarray:
        """The reference's guess point (tests/csi_oneBD.py:731-752: eLoss
        700 'based on SRIM ish', scale 100, s 0.5, bg 10, norms
        5*sum(observedTOF)).  The model spectrum is scale * density-pdf
        (pdf sums to 1/binwidth = 1/4 for 4 ns bins), so the true per-run
        scale is ~4-5x the observed total; the reference seeds with
        5*sum(observedTOF) (tests/csi_oneBD.py:741)."""
        norm_guesses = np.array([5.0 * float(np.sum(o)) for o in observed])
        return np.concatenate([np.asarray(guesses), norm_guesses,
                               np.full(self.n_runs, bg_guess)])

    def initial_walkers_from_observed(self, key, n_walkers, observed,
                                      guesses=(700.0, 100.0, 0.5),
                                      bg_guess: float = 10.0):
        # guesses + agitators * randn around the reference guess point
        g = self.guess_theta(observed, guesses, bg_guess)
        norm_guesses = g[3: 3 + self.n_runs]
        agit = np.concatenate([[50.0, 10.0, 0.05], 0.15 * norm_guesses,
                               np.full(self.n_runs, 2.0)])
        noise = jax.random.normal(key, (n_walkers, self.n_dim))
        p0 = jnp.asarray(g) + jnp.asarray(agit) * noise
        return jnp.clip(p0, jnp.asarray(self.param_lo) + 1e-3,
                        jnp.asarray(self.param_hi) - 1e-3)

    def shared_params(self, theta):
        """(beamE, eLoss, scale, s) with the fixed reference beam energy
        prepended (for PPC tooling).  Traceable: works on concrete and
        jit-traced thetas alike."""
        theta = jnp.asarray(theta)
        beam = jnp.asarray([onebd_consts.beam_reference_energy],
                           theta.dtype)
        return jnp.concatenate([beam, theta[:3]])

    def run_spectrum(self, key, theta, run: int, *, get_pdf: bool = True):
        """Model spectrum for one run: fixed beam reference energy, per-run
        scale + Poisson background (tests/csi_oneBD.py:415-521)."""
        beam_e = onebd_consts.beam_reference_energy
        params = jnp.stack([jnp.asarray(beam_e, jnp.float32), theta[0],
                            theta[1], theta[2]])
        return tof_spectrum(key, params, self.spec, self.standoffs[run],
                            self.windows[run], get_pdf=get_pdf,
                            scale=theta[3 + run],
                            bg_level=theta[3 + self.n_runs + run])

    def run_spectra(self, theta, key):
        """Per-run model spectra exactly as the likelihood sees them
        (one fold_in key per run; the batched multi-run forward)."""
        beam_e = onebd_consts.beam_reference_energy
        params = jnp.stack([jnp.asarray(beam_e, jnp.float32), theta[0],
                            theta[1], theta[2]])
        run_keys = [jax.random.fold_in(key, run)
                    for run in range(self.n_runs)]
        return tof_spectra_multi(
            run_keys, params, self.spec, self.standoffs, self.windows,
            theta[3: 3 + self.n_runs],
            theta[3 + self.n_runs: 3 + 2 * self.n_runs])

    def log_prob(self, theta, key, observed) -> jax.Array:
        prior = box_lnprior(theta, self.param_lo, self.param_hi,
                            inclusive=True)
        spectra = self.run_spectra(theta, key)
        loglike = (poisson_binned_loglike if self.likelihood == "reference"
                   else poisson_logpmf_loglike)
        total = prior
        for run in range(self.n_runs):
            total = total + loglike(
                spectra[run], jnp.asarray(observed[run]))
        return jnp.where(jnp.isneginf(prior), -jnp.inf,
                         jnp.where(jnp.isnan(total), -jnp.inf, total))

    def make_log_prob_fn(self, observed):
        obs = tuple(jnp.asarray(o, dtype=jnp.float32) for o in observed)

        def logp(theta, key):
            return self.log_prob(theta, key, obs)

        return logp
