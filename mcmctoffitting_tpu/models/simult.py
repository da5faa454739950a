"""The simultFit flagship model: joint multi-standoff fit, 9 parameters.

Preset mirroring ``tests/simultFit.py``: theta = (beamE, eLoss, scale, s,
N_1..N_nruns); per-run forward spectra at (mid, close, close, far,
production) standoffs with the 2016 CsI TOF windows; per-run binned-Poisson
likelihood summed over runs (``compoundLnlike``, ``tests/simultFit.py:412-420``);
table-driven box prior (``:424-442``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import functools

from ..config import SIMULTFIT_ED_BINNING, SIMULTFIT_X_BINNING
from ..constants import TUNL_SSA_CSI, TofWindow, tof_windows
from ..ops.likelihoods import (box_lnprior, poisson_binned_loglike,
                               poisson_logpmf_loglike)
from ..ops.stopping import StoppingTable, d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from .forward import ForwardSpec, tof_spectra_multi, tof_spectrum

# run index -> (standoff name, window name); tests/simultFit.py:121-156
RUN_LAYOUT = ("mid", "close", "close", "far", "production")

# parameter bounds (tests/simultFit.py:425-435)
PARAM_LO_SHARED = np.array([1825.0, 600.0, 40.0, 0.1])
PARAM_HI_SHARED = np.array([1925.0, 1000.0, 300.0, 1.2])
SCALE_LO, SCALE_HI = 0.0, 1.0e6

# initial guesses (tests/simultFit.py:535-547, 679-684)
GUESS_SHARED = np.array([1878.4, 850.0, 170.0, 0.5])
AGITATORS_SHARED = np.array([10.0, 50.0, 20.0, 0.1])


# simult's own betheApprox-style grid: wider than oneBD's (100, 2400, 100)
# so the whole physical beam range incl. the low-energy lognorm tail
# interpolates (never extrapolates).  25 keV rows keep the spline within
# 0.1 keV of the ODE over the histogram range (E >= 200 keV) — 0.5% of an
# eD bin — while the per-sample one-hot lookup stays ~96 segments wide
# (10 keV rows measured 2e-3 keV but cost 2.5x the VPU compares).
SIMULT_TABLE_BINNING = (20.0, 2420.0, 25.0)


@functools.lru_cache(maxsize=4)
def _build_table(rho: float) -> StoppingTable:
    # energy_floor matches rk4_transport's guard so table == ODE everywhere
    return StoppingTable.build(d2_gas_stopping(rho=rho),
                               SIMULT_TABLE_BINNING,
                               SIMULTFIT_X_BINNING.centers,
                               energy_floor=20.0)


def default_spec(n_samples: int = 200_000, *,
                 fine_grid: int | None = None,
                 transport: str = "table",
                 xs_mode: str = "e0grid",
                 sampling: str = "mc") -> ForwardSpec:
    """Forward spec for the simultFit campaign.

    transport='table' (default): precomputed E(E0, x) spline table — the
    reference developed exactly this surrogate for its ODE transport
    (``betheApprox``, validated in ``tests/testStoppingApproximation.py``)
    and adopted it for oneBD; here it matches the RK4/dopri5 path to
    < 2e-3 keV over the physical beam range (test_stopping.py) while
    skipping ~40 transcendental dE/dx evals per sample.
    transport='rk4': the literal ODE path (``tests/simultFit.py:256-258``).
    xs_mode='e0grid': static preimage factorization (ops/e0grid.py) — the
    per-sample transport + per-slice histograms collapse into one shared
    fine-grid moment pass (requires transport='table').
    """
    rho = 8.565e-5
    if sampling in ("expected", "counts"):
        if transport != "table":
            raise ValueError(f"sampling='{sampling}' requires "
                             "transport='table' (the closed-form moments "
                             "ride the e0grid preimage operator)")
        xs_mode = "e0grid"  # the closed-form moments ride the A operator
    e0_grid_table = None
    # F=256 measured: max per-cell error 8.7% of the bin's own MC noise at
    # the 200k-draw default (the ratio is N-independent); the moment dot
    # is F-proportional, so the coarser grid is the cheaper one.
    # counts mode costs O(F) instead of O(N*F), so it affords a finer
    # grid — which also shrinks the within-cell granularity that made the
    # coarse-F counts estimator noisier under rint.
    # F=512 measured equivalent to 1024 at the 200k-draw production scale
    # on all three instruments (operator logp shift 0.69 vs 0.66, per-eval
    # noise 1.02 vs 1.01, posterior A/B worst |dz| = 0.12;
    # tools/counts_f_study.py, tools/counts_f_posterior_ab.py) at half the
    # F-proportional work.  Below ~100k draws the within-cell rint
    # granularity is no longer buried under the per-cell count noise
    # (measured 1.8x mc's per-eval noise at 50k draws/F=512 vs 1.2x at
    # F=1024), so small-draw runs keep the finer grid.
    if sampling == "counts":
        e0_grid_fine = 512 if n_samples >= 100_000 else 1024
    else:
        e0_grid_fine = 256
    if fine_grid is not None:
        e0_grid_fine = int(fine_grid)
    if xs_mode == "e0grid" and transport != "table":
        xs_mode = "taylor"  # the e0grid preimages invert the stopping table
    if xs_mode == "e0grid":
        from ..ops.e0grid import cached_e0_grid_table
        from ..ops.xs import ddn_xs_uniform
        e0_grid_table = cached_e0_grid_table(
            _build_table(rho), SIMULTFIT_ED_BINNING, ddn_xs_uniform,
            e0_grid_fine)
    return ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=SIMULTFIT_ED_BINNING,
        x_binning=SIMULTFIT_X_BINNING,
        stopping=d2_gas_stopping(rho=rho),
        transport=transport,
        stopping_table=(_build_table(rho) if transport == "table"
                        else None),
        # 1 substep matches dopri5 to ~1e-3 keV over this x grid (below any
        # physical relevance; 2 is the f32 floor); see test_stopping.py
        rk4_substeps=1,
        beam_timing=ExGaussianTiming(),
        zero_degree="segments",
        cell_attenuation=False,
        # sequential run axis: the 4-run x 200k-draw batched working set
        # is R times the sequential one (counts mode switches by ensemble
        # size, cli/_driver.resolve_run_axis).  Chosen by timing on the
        # earlier accelerator; not yet measured on the H100.
        run_axis="sequential",
        # radix-factorized one-hot of the XLA TOF-histogram path: the
        # 10-segment zero-degree spread expands the TOF histogram to
        # M*Be*K = 5k values per run; L + ceil(n_bins/L) compares per
        # sample instead of n_bins.  Exact semantics.  Chosen by timing on
        # the earlier accelerator; not yet measured on the H100 (the GPU
        # runs the fused kernel, ops/pallas_tof.py, for these windows).
        tof_hist_radix=16,
        n_samples=n_samples,
        # one-hot block peak memory scales as walker_chunk * n_runs * x_bins
        # * histogram_chunk * eD_bins; 4096 keeps the fully batched joint
        # likelihood (32 walkers x 4 runs) under ~4 GB of HBM
        histogram_chunk=4096,
        xs_mode=xs_mode,
        e0_grid_table=e0_grid_table,
        e0_grid_fine=e0_grid_fine,
        sampling=sampling,
    )


@dataclasses.dataclass(frozen=True)
class SimultFitProblem:
    """Static joint-fit problem: spec + per-run geometry/windows/bounds."""

    spec: ForwardSpec
    n_runs: int = 4
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
        return tuple(tof_windows[name] for name in RUN_LAYOUT[: self.n_runs])

    @property
    def n_dim(self) -> int:
        return 4 + self.n_runs

    @property
    def param_lo(self) -> np.ndarray:
        return np.concatenate([PARAM_LO_SHARED,
                               np.full(self.n_runs, SCALE_LO)])

    @property
    def param_hi(self) -> np.ndarray:
        return np.concatenate([PARAM_HI_SHARED,
                               np.full(self.n_runs, SCALE_HI)])

    def guess_theta(self, observed) -> np.ndarray:
        """The reference's guess point: shared guesses + per-run scale =
        observed totals (tests/simultFit.py:535-547)."""
        scale_guesses = np.array([float(np.sum(o)) for o in observed])
        return np.concatenate([GUESS_SHARED, scale_guesses])

    def initial_walkers_from_observed(self, key, n_walkers, observed):
        """guesses + agitators * randn (tests/simultFit.py:679-684); per-run
        scale guesses/agitators come from the observed totals, as in the
        reference (tests/simultFit.py:543-546).  Clipped into the prior box
        (same as the oneBD problem): the raw normal agitation can land a
        walker outside the box (e.g. eLoss sigma=50 vs the 600..1000
        bounds), where lnprior = -inf DETERMINISTICALLY — the reference
        waits for emcee to walk it back in, wasting its early steps; we
        start every walker at a valid point instead."""
        guesses = self.guess_theta(observed)
        agitators = np.concatenate([AGITATORS_SHARED,
                                    0.15 * guesses[4: 4 + self.n_runs]])
        noise = jax.random.normal(key, (n_walkers, self.n_dim))
        p0 = jnp.asarray(guesses) + jnp.asarray(agitators) * noise
        return jnp.clip(p0, jnp.asarray(self.param_lo) + 1e-3,
                        jnp.asarray(self.param_hi) - 1e-3)

    def shared_params(self, theta):
        """(beamE, eLoss, scale, s) from a full theta (for PPC tooling).
        Traceable: works on concrete and jit-traced thetas alike."""
        return jnp.asarray(theta)[..., :4]

    def run_spectrum(self, key, theta, run: int, *, get_pdf: bool = True):
        """Model spectrum for one run (generateModelData equivalent)."""
        return tof_spectrum(key, theta[:4], self.spec, self.standoffs[run],
                            self.windows[run], get_pdf=get_pdf,
                            scale=theta[4 + run])

    def run_spectra(self, theta, key):
        """Per-run model spectra exactly as the likelihood sees them
        (one fold_in key per run; the batched multi-run forward)."""
        run_keys = [jax.random.fold_in(key, run)
                    for run in range(self.n_runs)]
        return tof_spectra_multi(run_keys, theta[:4], self.spec,
                                 self.standoffs, self.windows,
                                 theta[4: 4 + self.n_runs])

    def log_like(self, theta, key, observed) -> jax.Array:
        """Joint log-likelihood alone (``compoundLnlike``,
        ``tests/simultFit.py:412-420``) — the temperable part for the
        parallel-tempering driver (prior stays untempered there)."""
        spectra = self.run_spectra(theta, key)
        loglike = (poisson_binned_loglike if self.likelihood == "reference"
                   else poisson_logpmf_loglike)
        total = jnp.asarray(0.0)
        for run in range(self.n_runs):
            total = total + loglike(
                spectra[run], jnp.asarray(observed[run]))
        return jnp.where(jnp.isnan(total), -jnp.inf, total)

    def log_prob(self, theta, key, observed) -> jax.Array:
        """lnprob(theta) = box prior + sum of per-run Poisson loglikes.

        ``observed``: tuple of per-run count histograms (static shapes).
        Mirrors ``tests/simultFit.py:444-469`` with the -inf-prior shortcut
        expressed as a multiplicative gate (XLA evaluates both branches; the
        forward model is NaN-safe for out-of-range theta because the
        likelihood maps NaN -> -inf).
        """
        prior = box_lnprior(theta, self.param_lo, self.param_hi,
                            inclusive=True)
        total = prior + self.log_like(theta, key, observed)
        return jnp.where(jnp.isneginf(prior), -jnp.inf,
                         jnp.where(jnp.isnan(total), -jnp.inf, total))

    def make_log_prob_fn(self, observed):
        """Closure (theta, key) -> logp for the sampler."""
        obs = tuple(jnp.asarray(o, dtype=jnp.float32) for o in observed)

        def logp(theta, key):
            return self.log_prob(theta, key, obs)

        return logp
