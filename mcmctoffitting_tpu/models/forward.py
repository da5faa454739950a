"""The unified, jitted TOF forward model.

The reference duplicates ``generateModelData`` in ~9 driver scripts
(canonical versions: ``tests/simultFit.py:223-300`` (ODE transport path) and
``tests/csi_oneBD.py:415-521`` (spline-table path); PPC variant
``utilities/ppcTools.py:113-193``).  Here there is ONE forward model,
``tof_spectrum``, configured by a frozen (hashable -> jit-static)
:class:`ForwardSpec`; the historical variants are spec presets in
``models/simult.py`` / ``models/onebd.py``.

Structure (one fused XLA program, no host round-trips):

  1. sample N initial deuteron energies (beamE - lognorm, masked redraw);
  2. transport ALL samples through ALL x-bin centers at once
     (fixed-step RK4 batch, or one gather+Horner spline-table lookup —
     replacing per-call dopri5 / per-sample Python spline loops);
  3. cross-section (+ cell-attenuation) weights and the per-x-bin energy
     histograms as one-hot matmuls (ops/histogram.py) — replacing
     numpy histogram loops;
  4. TOF synthesis on the (x-bin, eD-bin[, zero-degree-segment]) lattice as
     a closed-form broadcast — replacing the ``np.ndenumerate`` Python loop
     (``tests/simultFit.py:286-296``);
  5. TOF histogram, timing convolutions, scale, optional Poisson background.

Everything has static shapes; per-run bin-count differences are handled by
compiling one program per (spec, window) pair.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Binning, cell_attenuation_coeffs
from ..constants import CellGeometry, TofWindow, masses
from ..ops.histogram import (histogram_density, weighted_histogram,
                             weighted_histogram_multi_window)
from ..ops.kinematics import dd_neutron_energy_np, tof
from ..ops.pdfs import beam_energy_rvs, skewnorm_rvs
from ..ops.stopping import BetheStopping, StoppingTable, rk4_transport
from ..ops.timing import (ExGaussianTiming, ZeroDegreeTimingSpread,
                          apply_zero_degree_expo)
from ..ops.xs import ddn_xs_uniform


@dataclasses.dataclass(frozen=True)
class ForwardSpec:
    """Static configuration of the forward model (jit-static argument).

    Fields map 1:1 onto the knobs scattered through the reference drivers;
    see the preset builders in ``models/simult.py`` and ``models/onebd.py``.
    """

    geometry: CellGeometry
    ed_binning: Binning
    x_binning: Binning
    stopping: BetheStopping
    xs: object = ddn_xs_uniform  # CubicSpline1D or UniformCubicSpline1D
    # 'rk4' = batch RK4 transport (reference ODE path);
    # 'table' = StoppingTable lookup (reference betheApprox path)
    transport: str = "rk4"
    stopping_table: Optional[StoppingTable] = None
    rk4_substeps: int = 4
    # timing response applied to the binned TOF spectrum
    beam_timing: object = ExGaussianTiming()
    # zero-degree detector transit: 'segments' (10-segment analytic spread,
    # simultFit era), 'expo' (7-point exponential kernel, oneBD era), 'none'
    zero_degree: str = "segments"
    # multiply per-x weights by exp(-x/20cm) beam attenuation (oneBD)
    cell_attenuation: bool = False
    # add the detector half-length to the neutron flight path (the v1-era
    # models; simultFit dropped it: tests/simultFit.py:290-292)
    add_half_zero_deg: bool = False
    # initial-energy distribution family; see sample_beam_energies
    beam_source: str = "lognorm"
    # background model: 'poisson' draws fresh Poisson counts per eval
    # (reference-faithful pseudo-marginal, tests/csi_oneBD.py:521);
    # 'expected' adds the expectation bg_level itself — statistically clean
    # (no pseudo-marginal stickiness; see RESULTS notes on the BG bias)
    bg_mode: str = "poisson"
    n_samples: int = 200_000
    # round the normalized (x, eD) weight grid to integer draw counts like
    # the reference's rint(dataHist * nSamples) (tests/simultFit.py:283)
    rint_draws: bool = True
    # -1 = exact truncated redraw (statistically identical to the
    # reference's redraw-until-positive loop; see ops/pdfs.beam_energy_rvs);
    # >= 0 = fixed-budget masked redraw rounds
    n_redraw_rounds: int = -1
    histogram_chunk: int = 16384
    # cross-section weighting strategy:
    #   'taylor' — gather-free Taylor-moment weighting:
    #     accumulate per-bin moment histograms (1, d, d^2, d^3) of the
    #     within-bin offset d and contract with (sigma, sigma', sigma'',
    #     sigma''') at the bin centers.  Exact for every bin whose interior
    #     contains no spline knot (the cubic IS its own 3rd-order Taylor),
    #     and accurate to O(knot jump in sigma''' * binwidth^3) otherwise —
    #     orders of magnitude below the XS table's own 1% precision.
    #     Rationale: per-sample spline evaluation needs a gather per
    #     sample; the moment form needs none.
    #   'exact' — per-sample spline evaluation (reference-literal path).
    #   'e0grid' — static e0-space preimage factorization (ops/e0grid.py):
    #     the parameter-INdependent transport map is inverted at build time,
    #     so the per-sample work collapses to one fine-grid moment one-hot
    #     shared by every x-slice (F compares/sample instead of
    #     M*Be + transport) plus one static matmul.  Requires
    #     transport='table' (the preimages invert the stopping table) and
    #     ``e0_grid_table``.  Accuracy: boundary fine cells are split by a
    #     mass/mean-conserving linear-density model; per-grid-cell error is
    #     measured (tests/test_e0grid.py) far below the reference's own
    #     rint() rounding of +-0.5 counts per cell.
    xs_mode: str = "taylor"
    # static E0GridTable for xs_mode='e0grid' (ops/e0grid.py)
    e0_grid_table: object = None
    # fine-cell count F for the e0grid build (used by model presets)
    e0_grid_fine: int = 1024
    # forward-model integration strategy:
    #   'mc' — Monte-Carlo draws per eval (reference-faithful
    #     pseudo-marginal likelihood, fresh samples per lnlike,
    #     tests/simultFit.py:386-388);
    #   'expected' — closed-form lognormal partial moments
    #     (ops/e0grid.expected_moments): the exact N->infinity limit of the
    #     MC estimator — zero pseudo-marginal noise, ~4F transcendentals
    #     per eval instead of per-sample work.  Requires xs_mode='e0grid'
    #     and beam_source='lognorm'.  Statistically this is a *different
    #     (cleaner) likelihood* the same way bg_mode='expected' is; the
    #     faithful default stays 'mc'.
    #   'counts' — Poissonized Rao-Blackwell MC
    #     (ops/e0grid.poissonized_moments): per-fine-cell Poisson counts at
    #     the closed-form expected occupancies x conditional moments.  An
    #     unbiased estimator of the same limit with per-cell variance
    #     measurably equal to (strictly below) the 'mc' path's, at O(F)
    #     cost per eval instead of O(N) — the recommended production MC
    #     mode (parity: artifacts/parity_*counts*).  Same
    #     requirements as 'expected'.
    sampling: str = "mc"
    # which e0 mean feeds the TOF lattice (tests/simultFit.py:288):
    #   'sample' — the per-eval draw mean (reference-faithful).  Its jitter
    #     rigidly shifts the whole lattice; heavy (x, eD) cells near TOF-bin
    #     edges then FLIP bins between evals, which measures as the DOMINANT
    #     pseudo-marginal logp noise (sigma ~ 7e4 at flagship scale, nearly
    #     draw-count-independent) and drives late-chain acceptance decay.
    #   'expected' — the closed-form distribution mean (lognorm source
    #     only): removes exactly that noise while the grid stays MC.
    e0_mean_mode: str = "sample"
    # within-cell moment closure for the closed-form/counts estimators
    # (ops/e0grid.expected_moments):
    #   'exact' — full (4, F+1) ndtr chain (exact lognormal partial
    #     moments in every channel);
    #   'cell'  — 2-row chain (mass + conditional mean) with the t^2/t^3
    #     channels closed by the exact-uniform within-cell variance
    #     h^2/12; per-cell error O(h^4) ~ f32 rounding at F=1024,
    #     measured |delta logp| ~1e-3 over posterior-typical thetas —
    #     ~50x below the pinned fine-grid margin — for half the
    #     dominant transcendental stage.
    moment_closure: str = "exact"
    # dtype of the one-hot/moment-channel contraction.  If bf16, the final
    # weighted grid differs from f32 by <1e-5 relative (the sigma*M0 term
    # dominates) — far below Monte-Carlo noise.  Speed not yet measured
    # on the H100.
    moment_dtype: str = "float32"
    # dtype of the static A operator in the e0grid contraction
    # (_e0grid_contract).  At the default simult shapes A is ~4 MB and
    # f32 is free; at the oneBD -hardcore scale A is (4F=4096,
    # M*Be=8000) = 131 MB, and bf16 storage halves the bytes the
    # per-half-ensemble contraction streams.  Whether that pays on the
    # H100 is not yet measured (the hardcore preset keeps bf16).
    # Accuracy (measured, tests/test_e0grid.py): the contraction
    # reconstructs a cubic from GLOBAL t-moments, which cancels across
    # the four channel rows with condition ~16, so rounding A costs
    # ~16x bf16 eps: median grid error ~1.6%, max ~6% of the grid's
    # dominant scale.  That is below the hardcore counts estimator's
    # ~9% per-cell Poisson noise but is a systematic perturbation, not
    # noise: only the -hardcore counts preset turns it on, after a
    # posterior-level A/B (artifacts/hardcore_a_dtype_ab.json, worst
    # |dz| = 0.22).  A cancellation-free bf16 path needs the A build
    # re-expressed in per-cell CENTERED moments.
    a_dtype: str = "float32"
    # radix factorization of the moment one-hot: 0 = direct (..== bins over
    # all Be columns); L > 0 decomposes idx = q*L + r and contracts via a
    # (4L x chunk) x (chunk x ceil(Be/L)) matmul — the compare count per
    # sample drops from M*Be to M*(L + ceil(Be/L) + 4L) (a ~4x cut at
    # Be=400) and the matmul grows from 4 rows to 4L.  Exact: one-hot
    # factor matrices have a single 1 per row.  Default off; not yet
    # measured on the H100.
    moment_radix: int = 0
    # radix factorization of the TOF-synthesis histogram one-hot
    # (ops/histogram._scan_onehot): 0 = direct (n_bins compares/sample);
    # L > 0 factorizes idx = q*L + r into two small one-hots (L + ceil(
    # n_bins/L) compares/sample, ~4x fewer at the 45-70-bin TOF windows).
    # Exact (same weight rounding class as the direct path).  Applies to
    # the XLA TOF path only (the GPU kernel, ops/pallas_tof.py, bins
    # directly); the simult preset's 16 is not yet measured on the H100.
    tof_hist_radix: int = 0
    # run-axis execution in tof_spectra_multi: 'batched' vmaps the run
    # axis through draw+grid, 'sequential' lax.maps it — the per-(walker,
    # run) working set at 200k draws is R times smaller sequentially
    run_axis: str = "batched"

    def en_centers(self) -> np.ndarray:
        return dd_neutron_energy_np(self.ed_binning.centers)


def sample_beam_energies(key, spec: ForwardSpec, params, n: int = 0):
    """Step 1: initial deuteron-energy draws under ``spec.beam_source``.

    * ``'lognorm'`` (simultFit/oneBD era): params = (beamE, eLoss, scale, s);
      eZeros = beamE - lognorm(s, loc=eLoss, scale) with masked redraw
      (``tests/simultFit.py:243-252``).
    * ``'skewnorm'`` (ppcTools-era chains): params = (e0, sigma0, skew0, ..);
      eZeros = skewnorm(a=skew0, loc=e0, scale=e0*sigma0), with the
      reference's ValueError-fallback to a plain normal when the scale is
      non-positive (``utilities/ppcTools.py:213-217``).
    * ``'gaussian'`` (v2.5 era, ``tests/intermediateTOFmodel.py:128``):
      params = (e0, sigma0, ..); eZeros = Normal(e0, e0*sigma0).

    ``n`` overrides ``spec.n_samples`` (0 = use the spec's).
    """
    n = n or spec.n_samples
    if spec.beam_source == "lognorm":
        return beam_energy_rvs(key, n, params[0], params[1], params[2],
                               params[3], spec.n_redraw_rounds)
    if spec.beam_source == "skewnorm":
        e0, sigma0, skew0 = params[0], params[1], params[2]
        scale = e0 * sigma0
        k0, k1 = jax.random.split(key)
        safe = jnp.where(scale > 0, scale, 1.0)
        sn = skewnorm_rvs(k0, (n,), a=skew0, loc=e0, scale=safe)
        fallback = e0 + safe * jax.random.normal(k1, (n,))
        return jnp.where(scale > 0, sn, fallback)
    if spec.beam_source == "gaussian":
        e0, sigma0 = params[0], params[1]
        return e0 + e0 * sigma0 * jax.random.normal(key, (n,))
    raise ValueError(f"unknown beam_source {spec.beam_source!r}")


def _transport_all(spec: ForwardSpec, e_zeros):
    """(N,) initial energies -> (x_bins, N) energies at each x-bin center."""
    if spec.transport == "table":
        if spec.stopping_table is None:
            raise ValueError("transport='table' requires stopping_table")
        return spec.stopping_table.eval_stopped(e_zeros).T  # (M, N)
    return rk4_transport(spec.stopping.dedx, e_zeros,
                         spec.x_binning.centers,
                         n_substeps=spec.rk4_substeps)


def _taylor_coeffs(spec: ForwardSpec) -> np.ndarray:
    """(4, Be) contraction constants: (sigma, sigma' w, sigma'' w^2/2,
    sigma''' w^3/6) at the eD bin centers."""
    eb = spec.ed_binning
    s0, s1, s2, s3 = spec.xs.eval_np(eb.centers, derivatives=True)
    w = eb.width
    return np.stack([s0, s1 * w, 0.5 * s2 * w * w,
                     (1.0 / 6.0) * s3 * w ** 3])


def _chunk_with_mask(values, chunk_size: int, fill: float):
    """Pad a (N,) sample vector to a whole number of chunks.

    Returns ((n_chunks, chunk) values, (n_chunks, chunk) validity mask).
    Padded slots carry ``fill`` and mask 0 — the mask is the authoritative
    exclusion; fill values must still be finite so downstream arithmetic
    stays NaN-free.
    """
    n = values.shape[-1]
    chunk = min(chunk_size, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    v = jnp.asarray(values, jnp.float32)
    valid = jnp.ones_like(v)
    if pad:
        v = jnp.concatenate([v, jnp.full((pad,), fill, v.dtype)], axis=-1)
        valid = jnp.concatenate(
            [valid, jnp.zeros((pad,), valid.dtype)], axis=-1)
    return v.reshape(n_chunks, chunk), valid.reshape(n_chunks, chunk)


def _apply_attenuation(spec: ForwardSpec, grid):
    """Multiply per-x-slice exp(-x/20cm) beam attenuation (oneBD,
    ``initialization.py:39-43``)."""
    atten = jnp.asarray(cell_attenuation_coeffs(spec.x_binning.centers),
                        dtype=grid.dtype)
    return grid * atten[:, None]


def _e0grid_weight_grid(spec: ForwardSpec, e_zeros):
    """xs_mode='e0grid' hot path (see ops/e0grid.py for the construction).

    Per sample-chunk: arithmetic fine-cell index + one one-hot moment
    dot SHARED across all x-slices; after the scan, one static matmul maps
    the (4, F) moments to the (M, Be) grid.  No transport lookups, no
    per-slice one-hots, no gathers.
    """
    tab = spec.e0_grid_table
    # fill sits strictly below e0_lo so padded slots ALSO fail in_range;
    # the valid mask remains the authoritative exclusion either way
    e0_c, valid_c = _chunk_with_mask(e_zeros, spec.histogram_chunk,
                                     tab.e0_lo - 1.0)

    n_fine = tab.n_fine
    cells = jnp.arange(n_fine, dtype=jnp.int32)
    inv_cell = n_fine / (tab.e0_hi - tab.e0_lo)
    inv_tscale = 1.0 / tab.t_scale
    mdtype = jnp.bfloat16 if spec.moment_dtype == "bfloat16" else jnp.float32

    def body(acc, inputs):
        e0_blk, valid_blk = inputs
        u = (e0_blk - tab.e0_lo) * inv_cell
        idx = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, n_fine - 1)
        in_range = (e0_blk >= tab.e0_lo) & (e0_blk <= tab.e0_hi)
        base = jnp.where(in_range, valid_blk, 0.0)
        t = (e0_blk - tab.t_ref) * inv_tscale
        t2 = t * t
        chans = jnp.stack([base, base * t, base * t2, base * t2 * t],
                          axis=-2).astype(mdtype)           # (4, chunk)
        onehot = (idx[:, None] == cells).astype(mdtype)      # (chunk, F)
        contrib = jax.lax.dot_general(
            chans, onehot,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)              # (4, F)
        return acc + contrib, None

    acc0 = jnp.zeros((4, n_fine), jnp.float32)
    moments, _ = jax.lax.scan(body, acc0, (e0_c, valid_c))
    return _e0grid_contract(spec, moments)


def _e0grid_contract(spec: ForwardSpec, moments):
    """(4, F) fine-cell moments -> (M, Be) grid via the static A operator.

    precision='highest' is load-bearing: the cubic reconstruction cancels
    across the four channel rows with condition ~16, and a default-
    precision f32 matmul on the GPU runs in TF32 (10-bit mantissa),
    whose rounding of A that cancellation would amplify ~16x.
    """
    tab = spec.e0_grid_table
    if spec.a_dtype == "bfloat16":
        # A lives in HBM as bf16 (halved stream bytes); the convert to
        # f32 fuses into the dot's operand read and the MOMENTS stay f32
        # — the cubic reconstruction cancels across the four channel
        # rows, so rounding S itself is destructive (measured 6.5% grid
        # error vs <=1% with A-only rounding).
        a = jnp.asarray(tab.a_matrix).astype(jnp.bfloat16)   # (4F, M*Be)
        grid = jnp.dot(moments.reshape(-1), a.astype(jnp.float32),
                       precision="highest",
                       preferred_element_type=jnp.float32)
    else:
        a = jnp.asarray(tab.a_matrix)                        # (4F, M*Be)
        grid = jnp.dot(moments.reshape(-1), a, precision="highest",
                       preferred_element_type=jnp.float32)
    return grid.reshape(tab.n_x, tab.n_ed)


def grid_and_mean(spec: ForwardSpec, params, key):
    """(XS-weighted grid incl. attenuation, e0 mean) for one run.

    sampling='mc': draw -> moment/histogram pipeline (reference semantics).
    sampling='expected': closed-form moments (ops/e0grid.expected_moments)
    — no draws at all; ``key`` is unused.
    """
    if spec.sampling == "expected":
        if spec.xs_mode != "e0grid":
            raise ValueError("sampling='expected' requires xs_mode='e0grid'")
        _validate_e0grid_table(spec)
        if spec.beam_source != "lognorm":
            raise ValueError("sampling='expected' requires the lognorm "
                             "beam source")
        from ..ops.e0grid import expected_moments
        truncated = spec.n_redraw_rounds != 0
        moments, e0_mean = expected_moments(
            spec.e0_grid_table, params[0], params[1], params[2], params[3],
            spec.n_samples, truncated, spec.moment_closure)
        grid = _e0grid_contract(spec, moments)
        if spec.cell_attenuation:
            grid = _apply_attenuation(spec, grid)
        return grid, e0_mean
    if spec.sampling == "counts":
        if spec.xs_mode != "e0grid":
            raise ValueError("sampling='counts' requires xs_mode='e0grid'")
        _validate_e0grid_table(spec)
        if spec.beam_source != "lognorm":
            raise ValueError("sampling='counts' requires the lognorm "
                             "beam source")
        from ..ops.e0grid import expected_e0_mean, poissonized_moments
        truncated = spec.n_redraw_rounds != 0
        moments, e0_mean = poissonized_moments(
            key, spec.e0_grid_table, params[0], params[1], params[2],
            params[3], spec.n_samples, truncated, spec.moment_closure)
        grid = _e0grid_contract(spec, moments)
        if spec.cell_attenuation:
            grid = _apply_attenuation(spec, grid)
        if spec.e0_mean_mode == "expected":
            e0_mean = expected_e0_mean(params[0], params[1], params[2],
                                       params[3], truncated)
        return grid, e0_mean
    if spec.sampling != "mc":
        raise ValueError(f"unknown sampling mode {spec.sampling!r} "
                         "(expected 'mc', 'counts' or 'expected')")
    e_zeros = sample_beam_energies(key, spec, params)
    grid = energy_weight_grid(spec, e_zeros)
    if spec.e0_mean_mode == "expected":
        if spec.beam_source != "lognorm":
            raise ValueError("e0_mean_mode='expected' requires the "
                             "lognorm beam source")
        from ..ops.e0grid import expected_e0_mean
        e0_mean = expected_e0_mean(params[0], params[1], params[2],
                                   params[3], spec.n_redraw_rounds != 0)
        return grid, e0_mean
    if spec.e0_mean_mode != "sample":
        raise ValueError(f"unknown e0_mean_mode {spec.e0_mean_mode!r}")
    return grid, jnp.mean(e_zeros)


def energy_weight_grid(spec: ForwardSpec, e_zeros):
    """Steps 2-3: initial energies -> XS-weighted (x_bins, eD_bins) grid.

    Mirrors the per-x-bin weighted histograms of the reference
    (``tests/simultFit.py:256-265``, ``tests/csi_oneBD.py:452-465``).

    Default path ('taylor') STREAMS: a ``lax.scan`` over sample chunks
    transports each chunk through all x-bin centers and immediately reduces
    it into within-bin offset moment histograms (1, d, d^2, d^3) with a
    one-hot dot — the (x_bins, N) transported-energy array is never
    materialized (peak memory O(x_bins * chunk), which is what lets the
    walker-and-run-batched joint likelihood fit in HBM).  The moments are
    then contracted with the cross-section spline's value/derivatives at
    the bin centers — no per-sample spline gathers (see
    ForwardSpec.xs_mode for the accuracy argument).
    """
    eb = spec.ed_binning

    if spec.xs_mode == "e0grid":
        _validate_e0grid_table(spec)
        grid = _e0grid_weight_grid(spec, e_zeros)
    elif spec.xs_mode == "taylor" and hasattr(spec.xs, "eval_np"):
        e0_c, valid_c = _chunk_with_mask(e_zeros, spec.histogram_chunk,
                                         eb.lo)
        bins = jnp.arange(eb.n, dtype=jnp.int32)
        inv_width = eb.n / (eb.hi - eb.lo)
        n_x = spec.x_binning.n
        mdtype = jnp.bfloat16 if spec.moment_dtype == "bfloat16" \
            else jnp.float32

        radix = spec.moment_radix
        n_q = -(-eb.n // radix) if radix else 0

        def body(acc, inputs):
            e0_blk, valid_blk = inputs
            e_at_x = _transport_all(spec, e0_blk)        # (M, chunk)
            u = (e_at_x - eb.lo) * inv_width
            idx = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, eb.n - 1)
            in_range = (e_at_x >= eb.lo) & (e_at_x <= eb.hi)
            delta = u - idx.astype(u.dtype) - 0.5
            base = jnp.where(in_range, valid_blk[None, :], 0.0)
            d2 = delta * delta
            chans = jnp.stack([base, base * delta, base * d2,
                               base * d2 * delta],
                              axis=-2).astype(mdtype)    # (M, 4, chunk)
            if radix:
                # idx = q*L + r; contract channels*onehot(r) against
                # onehot(q) — see ForwardSpec.moment_radix
                q, r = jnp.divmod(idx, radix)
                oh_r = (r[:, :, None]
                        == jnp.arange(radix, dtype=jnp.int32)
                        ).astype(mdtype)                 # (M, chunk, L)
                oh_q = (q[:, :, None]
                        == jnp.arange(n_q, dtype=jnp.int32)
                        ).astype(mdtype)                 # (M, chunk, Q)
                chans_r = (chans[:, :, None, :]
                           * jnp.moveaxis(oh_r, -1, -2)[:, None])
                contrib = jax.lax.dot_general(
                    chans_r.reshape(n_x, 4 * radix, -1), oh_q,
                    dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)  # (M, 4L, Q)
                contrib = jnp.moveaxis(
                    contrib.reshape(n_x, 4, radix, n_q), -1, -2
                ).reshape(n_x, 4, n_q * radix)[..., : eb.n]
            else:
                onehot = (idx[:, :, None] == bins).astype(mdtype)
                contrib = jax.lax.dot_general(
                    chans, onehot,
                    dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)  # (M, 4, Be)
            return acc + contrib, None

        acc0 = jnp.zeros((n_x, 4, eb.n), jnp.float32)
        moments, _ = jax.lax.scan(body, acc0, (e0_c, valid_c))
        taylor = _taylor_coeffs(spec)
        grid = jnp.sum(moments * jnp.asarray(taylor, jnp.float32),
                       axis=-2)                          # (M, Be)
    else:
        e_at_x = _transport_all(spec, e_zeros)  # (M, N)
        w = spec.xs(e_at_x)
        grid = weighted_histogram(e_at_x, eb.lo, eb.hi, eb.n, w,
                                  chunk=spec.histogram_chunk)  # (M, Be)

    if spec.cell_attenuation:
        grid = _apply_attenuation(spec, grid)
    return grid


def _validate_e0grid_table(spec: ForwardSpec) -> None:
    """Reject a spec whose e0_grid_table was compiled for other binnings.

    The A operator bakes in the stopping-table preimages and eD bin edges;
    a mismatched table with coincidentally matching SHAPES would silently
    attribute every bin's weight to shifted energies.
    """
    tab = spec.e0_grid_table
    if tab is None:
        raise ValueError("xs_mode='e0grid' requires e0_grid_table "
                         "(ops.e0grid.build_e0_grid_table)")
    if spec.transport != "table":
        raise ValueError("xs_mode='e0grid' requires transport='table' "
                         "(the preimages invert the stopping table)")
    eb, xb = spec.ed_binning, spec.x_binning
    if (tab.n_x != xb.n or tab.n_ed != eb.n
            or getattr(tab, "ed_lo", eb.lo) != eb.lo
            or getattr(tab, "ed_hi", eb.hi) != eb.hi):
        raise ValueError(
            f"e0_grid_table was built for a ({tab.n_x} x, {tab.n_ed} eD, "
            f"[{getattr(tab, 'ed_lo', '?')}, {getattr(tab, 'ed_hi', '?')}] "
            f"keV) grid; spec has ({xb.n} x, {eb.n} eD, "
            f"[{eb.lo}, {eb.hi}] keV)")


def _zero_degree_spread(spec: ForwardSpec):
    """(times, weights) of the 10-segment zero-degree transit spread at
    every eN bin center (simultFit era, ``utilities/utilities.py:154``)."""
    zd = ZeroDegreeTimingSpread(length=spec.geometry.zero_deg_length)
    return zd.times_and_weights(
        jnp.asarray(spec.en_centers(), dtype=jnp.float32))  # (Be, K) x2


def _add_background(spec: ForwardSpec, spectrum, bg_level, key, n_bins):
    """Per-run background: fresh Poisson draw (faithful,
    ``tests/csi_oneBD.py:521``) or its expectation (bg_mode='expected')."""
    if spec.bg_mode == "expected":
        return spectrum + bg_level
    from ..ops.poisson import poisson_ptrs
    return spectrum + poisson_ptrs(
        key, jnp.full((n_bins,), bg_level)).astype(spectrum.dtype)


def _tof_spread(spec: ForwardSpec):
    """(times, weights), each (Be, K), of the zero-degree transit spread
    the TOF-synthesis histogram applies: the 10-segment analytic spread
    (simult era) or a single zero-offset unit segment ('expo'/'none',
    where the transit is applied to the binned spectrum instead)."""
    if spec.zero_degree == "segments":
        return _zero_degree_spread(spec)
    zeros = jnp.zeros((spec.ed_binning.n, 1), jnp.float32)
    return zeros, jnp.ones_like(zeros)


def tof_histogram_xla(spec: ForwardSpec, base_tof, draws, zt, zw, windows):
    """TOF-synthesis histogram, XLA path: expand the (R, M*Be*K) samples,
    then the scanned one-hot contraction of ops/histogram.py."""
    n_runs = base_tof.shape[-3]
    values = base_tof[..., None] + zt                    # (R, M, Be, K)
    weights = draws[..., None] * zw
    return weighted_histogram_multi_window(
        values.reshape(n_runs, -1), windows, weights.reshape(n_runs, -1),
        chunk=spec.histogram_chunk, radix=spec.tof_hist_radix)


def tof_histogram_kernel(spec: ForwardSpec, base_tof, draws, zt, zw,
                         windows):
    """TOF-synthesis histogram, fused GPU kernel (ops/pallas_tof.py)."""
    del spec
    from ..ops.pallas_tof import make_tof_hist_segments
    fn = make_tof_hist_segments(
        tuple(windows), int(base_tof.shape[-2]), int(base_tof.shape[-1]),
        int(zt.shape[-1]))
    return fn(base_tof, draws, zt, zw)


def tof_histogram(spec: ForwardSpec, base_tof, draws, zt, zw, windows):
    """Step 5a: per-run TOF histograms of the spread lattice.

    base_tof/draws: (R, M, Be); zt/zw: (Be, K).  Returns (R, n_pad).
    On the GPU the fused kernel runs (windows up to its 128-bin
    register budget); elsewhere, and for wider windows, the XLA path.
    Same np.histogram semantics either way; the kernel keeps f32 weights
    where the XLA path's default-precision dot may round them to TF32, so
    the two agree to that rounding, not bitwise.
    """
    from ..ops.pallas_tof import MAX_BINS
    n_pad = max(w.n_bins for w in windows)
    if jax.default_backend() == "gpu" and n_pad <= MAX_BINS:
        return tof_histogram_kernel(spec, base_tof, draws, zt, zw, windows)
    return tof_histogram_xla(spec, base_tof, draws, zt, zw, windows)


def cell_tof_lattice(spec: ForwardSpec, standoff: float, e0_mean):
    """Step 4: closed-form TOF value for every (x-bin, eD-bin) lattice cell.

    tof = tof_d((e0_mean + eD_j)/2, x_i) + tof_n(eN_j, L - x_i + standoff)
    (``tests/simultFit.py:286-296``).  Only the deuteron leg depends on the
    (traced) e0_mean; the neutron leg is a trace-time constant.
    """
    x = jnp.asarray(spec.x_binning.centers, dtype=jnp.float32)        # (M,)
    ed = jnp.asarray(spec.ed_binning.centers, dtype=jnp.float32)      # (Be,)
    en = jnp.asarray(spec.en_centers(), dtype=jnp.float32)            # (Be,)
    eff_ed = (e0_mean + ed) / 2.0                                     # (Be,)
    tof_d = tof(masses.deuteron, eff_ed[None, :], x[:, None])         # (M,Be)
    n_dist = spec.geometry.cell_length - x[:, None] + standoff
    if spec.add_half_zero_deg:
        n_dist = n_dist + spec.geometry.zero_deg_length / 2.0
    tof_n = tof(masses.neutron, en[None, :], n_dist)                  # (M,Be)
    return tof_d + tof_n


def tof_spectrum(key, params, spec: ForwardSpec, standoff: float,
                 window: TofWindow, *, get_pdf: bool = False,
                 scale: float | jax.Array = 1.0,
                 bg_level: Optional[jax.Array] = None,
                 return_spectra: bool = False):
    """Generate one model TOF spectrum (the reference ``generateModelData``).

    Args:
      key: PRNG key (pseudo-marginal likelihood: fresh draws per eval,
        as in the reference where every lnlike call re-samples).
      params: (beam_e, e_loss, scale_lognorm, s) beam-energy parameters.
      spec: static ForwardSpec.
      standoff: detector standoff distance (cm), static or traced.
      window: static TofWindow (bin count fixes output shape).
      get_pdf: density-normalize the TOF histogram before scaling
        (reference getPDF flag).
      scale: per-run scale factor (theta component).
      bg_level: if not None, adds Poisson(bg_level)-distributed counts per
        bin (oneBD background, ``tests/csi_oneBD.py:521``).
      return_spectra: also return (eD weight grid, eN spectrum vs x) for
        PPC (``utilities/ppcTools.py:113-193`` returns these alongside).

    Returns: (n_bins,) spectrum, or (spectrum, grid, eN_at_x) tuple.
    """
    k_draw, k_bg = jax.random.split(key)
    grid, e0_mean = grid_and_mean(spec, params, k_draw)  # (M, Be)

    # normalize to a PDF over the (x, eD) area then convert to draw counts
    # (tests/simultFit.py:279-283)
    area = spec.ed_binning.width * spec.x_binning.width
    grid = grid / (jnp.sum(grid) * area)
    draws = grid * spec.n_samples
    if spec.rint_draws:
        draws = jnp.rint(draws)

    base_tof = cell_tof_lattice(spec, standoff, e0_mean)  # (M, Be)

    zt, zw = _tof_spread(spec)                            # (Be, K) x2
    hist = tof_histogram(spec, base_tof[None], draws[None], zt, zw,
                         (window,))[0]
    if get_pdf:
        hist = histogram_density(hist, window.lo, window.hi)

    if spec.zero_degree == "expo":
        hist = apply_zero_degree_expo(hist)

    out = scale * spec.beam_timing.apply_spreading(hist)
    if bg_level is not None:
        out = _add_background(spec, out, bg_level, k_bg, window.n_bins)

    if return_spectra:
        en_at_x = draws  # weight per (x, eD) cell == neutron yield spectrum
        return out, grid, en_at_x
    return out


def tof_spectra_multi(run_keys, params, spec: ForwardSpec,
                      standoffs: tuple, windows: tuple, scales,
                      bg_levels=None, *, get_pdf: bool = True):
    """All runs of a joint fit in one program, sharing the batched hot path.

    Statistically identical to calling :func:`tof_spectrum` once per run
    with ``run_keys[r]`` (independent draws per run, independent e0_mean,
    reference semantics) — but the expensive stages (beam sampling,
    transport, moment histograms) execute batched over the run axis, so a
    4-run likelihood costs ~1 batched forward instead of 4 sequential ones.
    Only the cheap per-run TOF stage (different window bin counts) loops.

    run_keys: (R,) keys; scales: (R,); bg_levels: (R,) or None.
    Returns a tuple of R spectra.
    """
    n_runs = len(standoffs)

    draw_keys = []
    bg_keys = []
    for r in range(n_runs):
        kd, kb = jax.random.split(run_keys[r])
        draw_keys.append(kd)
        bg_keys.append(kb)
    if spec.sampling == "expected":
        # deterministic: every run shares ONE closed-form grid/mean
        grid_1, mean_1 = grid_and_mean(spec, params, draw_keys[0])
        grids = jnp.broadcast_to(grid_1, (n_runs,) + grid_1.shape)
        e0_means = jnp.broadcast_to(mean_1, (n_runs,))
    elif spec.run_axis == "sequential":
        # the presets' default; counts mode switches to the batched
        # branch below at small ensembles (cli/_driver.resolve_run_axis)
        grids, e0_means = jax.lax.map(
            lambda k: grid_and_mean(spec, params, k), jnp.stack(draw_keys))
    elif spec.sampling == "counts":
        # batched run axis: per-run state is O(F) so memory is no concern;
        # each run still draws independent Poisson cell counts (faithful
        # per-run randomness), just as one wide vmapped program
        grids, e0_means = jax.vmap(
            lambda k: grid_and_mean(spec, params, k))(jnp.stack(draw_keys))
    else:
        e_zeros = jax.vmap(lambda k: sample_beam_energies(
            k, spec, params))(jnp.stack(draw_keys))       # (R, N)
        grids = jax.vmap(lambda e: energy_weight_grid(spec, e))(e_zeros)
        e0_means = jnp.mean(e_zeros, axis=-1)             # (R,)
    base_tof = jax.vmap(lambda so, e0m: cell_tof_lattice(spec, so, e0m))(
        jnp.asarray(standoffs, jnp.float32), e0_means)    # (R, M, Be)
    return spectra_from_grids(spec, grids, base_tof, windows, scales,
                              bg_levels, bg_keys, get_pdf=get_pdf)


def spectra_from_grids(spec: ForwardSpec, grids, base_tof, windows: tuple,
                       scales, bg_levels=None, bg_keys=None, *,
                       get_pdf: bool = True):
    """Steps 4-5 for all runs: (R, M, Be) weight grids + TOF lattices ->
    R spectra (draw counts, TOF histogram, timing, scale, background).

    The deterministic tail of :func:`tof_spectra_multi`, split out so the
    forward can be compared stage by stage with the f64 host reference
    (``ops/reference_np.py``).  ``bg_keys`` is needed only for
    ``bg_mode='poisson'``.
    """
    n_runs = len(windows)
    area = spec.ed_binning.width * spec.x_binning.width
    grids = grids / (jnp.sum(grids, axis=(1, 2), keepdims=True) * area)
    draws = grids * spec.n_samples
    if spec.rint_draws:
        draws = jnp.rint(draws)

    # --- batched TOF stage: all runs share one histogram/convolution
    # program (windows differ per run; see tof_histogram)
    zt, zw = _tof_spread(spec)                            # (Be, K) x2
    hist = tof_histogram(spec, base_tof, draws, zt, zw, windows)  # (R, n_pad)
    if get_pdf:
        bin_widths = np.asarray([(w.hi - w.lo) / w.n_bins for w in windows],
                                np.float32)[:, None]
        hist = hist / (jnp.sum(hist, axis=-1, keepdims=True) * bin_widths)
    if spec.zero_degree == "expo":
        hist = jax.vmap(apply_zero_degree_expo)(hist)
        # the expo tail bleeds into padding bins; re-zero them so the
        # 'same'-mode beam-timing conv sees the unpadded boundary
        n_pad = hist.shape[-1]
        pad_mask = np.asarray([[j < w.n_bins for j in range(n_pad)]
                               for w in windows], np.float32)
        hist = hist * pad_mask
    hist = jax.vmap(spec.beam_timing.apply_spreading)(hist)

    out = []
    for r in range(n_runs):
        win = windows[r]
        spectrum = scales[r] * hist[r, : win.n_bins]
        if bg_levels is not None:
            spectrum = _add_background(
                spec, spectrum, bg_levels[r],
                None if bg_keys is None else bg_keys[r], win.n_bins)
        out.append(spectrum)
    return tuple(out)
