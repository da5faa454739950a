"""Ensemble-chain convergence diagnostics: autocorrelation time, ESS, R-hat.

The reference intended these and never shipped them — its PTSampler driver
has the ``sampler.acor`` printout commented out
(``tests/shiftingGaussian_brute.py:324-326``), and every chain-length
choice in the reference is a hard-coded guess.  The round-2/3 parity
studies showed why that matters: short ensemble chains on the degenerate
eLoss/scale/s ridge report posterior widths up to ~10x too narrow
(artifacts/parity_onebd_report.txt).  These host-side metrics make
under-sampling visible at the end of every fit.

Implementation notes (all numpy; chains are (S, W, D) = steps x walkers x
params, the shape run_phases streams):

* ``integrated_autocorr_time`` follows the Goodman-Weare practice used by
  emcee: per-walker FFT autocorrelation averaged over walkers, then
  Sokal's adaptive window  M = min{m : m >= c * tau_hat(m)}  with c = 5.
  tau is in units of ensemble steps; effective sample size uses S*W/tau
  (walkers are exchangeable but correlated through the ensemble move,
  which the walker-averaged autocorrelation captures).
* ``split_rhat`` is the classic Gelman-Rubin potential scale reduction on
  the first/second half of every walker trace (2W half-chains).  For
  ensemble samplers R-hat can read clean while tau is still large, so
  both are reported; tau is the authoritative one.
"""
from __future__ import annotations

import numpy as np

__all__ = ["integrated_autocorr_time", "effective_sample_size",
           "split_rhat", "chain_summary", "format_summary"]


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def integrated_autocorr_time(chain: np.ndarray, *, c: float = 5.0
                             ) -> np.ndarray:
    """Per-parameter integrated autocorrelation time tau (ensemble steps).

    ``chain``: (S, W, D).  Returns (D,).  tau ~ S means "chain too short
    to estimate" (the Sokal window never closed); callers should compare
    S against ~50 * tau for a trustworthy posterior.
    """
    chain = np.asarray(chain, np.float64)
    s, w, d = chain.shape
    # one batched FFT autocorrelation over all (walker, param) traces
    x = chain - chain.mean(axis=0)
    f = np.fft.rfft(x, n=2 * _next_pow_two(s), axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), axis=0)[:s]     # (S, W, D)
    norm = acf[0]                                           # (W, D)
    # constant series (stuck walker): define rho = 1 at every lag.  Detect
    # by max==min (exact), not acf[0] <= 0 — mean-subtraction roundoff can
    # leave acf[0] ~ 1e-25 on a constant trace, whose rho would be noise.
    const = chain.max(axis=0) == chain.min(axis=0)          # (W, D)
    safe = np.where(const, 1.0, norm)
    rho = np.where(const, 1.0, acf / safe)
    rho = rho.mean(axis=1)                                  # (S, D)
    # mean autocorrelation over walkers (emcee's estimator) + Sokal window
    tau_hat = 2.0 * np.cumsum(rho, axis=0) - 1.0            # (S, D)
    window = np.arange(s)[:, None] >= c * tau_hat
    m = np.where(window.any(axis=0), np.argmax(window, axis=0), s - 1)
    return np.maximum(tau_hat[m, np.arange(d)], 1.0)


def effective_sample_size(chain: np.ndarray, *, c: float = 5.0
                          ) -> np.ndarray:
    """Per-parameter ESS = S * W / tau for an (S, W, D) chain."""
    s, w, _ = np.asarray(chain).shape
    return s * w / integrated_autocorr_time(chain, c=c)


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """Split Gelman-Rubin R-hat per parameter for an (S, W, D) chain."""
    chain = np.asarray(chain, np.float64)
    s, w, d = chain.shape
    half = s // 2
    if half < 2:
        return np.full(d, np.nan)
    # 2W half-chains of length `half`
    parts = np.concatenate([chain[:half], chain[s - half:]], axis=1)
    m, n = parts.shape[1], half
    means = parts.mean(axis=0)                      # (2W, D)
    vars_ = parts.var(axis=0, ddof=1)               # (2W, D)
    b = n * means.var(axis=0, ddof=1)               # between
    w_ = vars_.mean(axis=0)                         # within
    var_plus = (n - 1) / n * w_ + b / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / w_)
    return rhat


def chain_summary(chain: np.ndarray, *, c: float = 5.0) -> dict:
    """tau / ESS / R-hat plus a short-chain flag, for end-of-fit printing."""
    chain = np.asarray(chain)
    s = chain.shape[0]
    tau = integrated_autocorr_time(chain, c=c)
    ess = s * chain.shape[1] / tau
    rhat = split_rhat(chain)
    return {"n_steps": int(s), "tau": tau, "ess": ess, "rhat": rhat,
            # emcee's reliability rule of thumb: S >= 50 * tau
            "converged": bool(s >= 50 * np.max(tau))}


def format_summary(summary: dict) -> str:
    tau, ess, rhat = summary["tau"], summary["ess"], summary["rhat"]
    worst = int(np.argmax(tau))
    line = (f"diagnostics: tau = {np.max(tau):.1f} steps (param {worst}), "
            f"min ESS = {np.min(ess):.0f}, max R-hat = {np.nanmax(rhat):.3f}")
    if not summary["converged"]:
        line += (f"  [WARNING: chain has {summary['n_steps']} steps "
                 f"< 50*tau = {50 * np.max(tau):.0f} — posterior widths "
                 "may be underestimated]")
    return line
