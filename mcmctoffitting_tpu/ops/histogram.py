"""Fixed-range weighted histograms as one-hot matmuls.

The reference's hot loops are numpy histograms over 1e4-2e5 Monte-Carlo
samples (``tests/simultFit.py:263-265``, ``tests/csi_oneBD.py:463``) plus a
Python ``ndenumerate`` TOF-synthesis loop (``tests/simultFit.py:286-296``).
Here the histogram is a **one-hot matmul**: bin indices -> one-hot block
(chunk x n_bins) contracted against the weights, chunked by ``lax.scan``
to bound the block's memory.  The design was chosen on the earlier
accelerator, where scatter-adds serialized; on the H100 the TOF stage's
XLA scatter-add measured faster (PERF.md), and picking one path per stage
is open work (ROADMAP Speed 2).

Semantics match ``np.histogram(values, bins=n, range=(lo, hi), weights=w)``:
out-of-range samples are dropped, and values exactly equal to ``hi`` land in
the last bin.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _scan_onehot(idx, w, n_bins: int, chunk: int, radix: int = 0):
    """Chunked one-hot contraction: (..., N) indices + weights ->
    (..., n_bins) histogram.  Shared engine of the histogram ops.

    Precision note: the dot runs at DEFAULT matmul precision — on the GPU
    an f32 dot then runs in TF32 (10-bit mantissa, f32 accumulation).
    One-hot entries are exact; only the weights are rounded (<= 2^-11
    relative per weight), far below the Monte-Carlo noise of the sampled
    spectra.
    Deterministic keV-scale lookups must NOT use this path (see
    StoppingTable.eval_stopped, which pins precision='highest').

    ``radix`` L > 0 factorizes the one-hot: idx = q * L + r, and the
    histogram becomes the (..., Q, L) outer contraction of two SMALL
    one-hots (oh_q: Q = ceil(n_bins/L) compares/sample, oh_r: L
    compares/sample) instead of one n_bins-wide block — the compare /
    materialization cost per sample drops from n_bins to L + Q (~4x at
    n_bins = 70, L = 8).  Exact: each sample hits exactly one (q, r)
    cell, and the weight enters one rounded product exactly as in the
    direct path.  The single-channel sibling of
    ``ForwardSpec.moment_radix`` (see ForwardSpec.tof_hist_radix)."""
    n = idx.shape[-1]
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        idx = jnp.concatenate(
            [idx, jnp.zeros(idx.shape[:-1] + (pad,), idx.dtype)], axis=-1)
        w = jnp.concatenate(
            [w, jnp.zeros(w.shape[:-1] + (pad,), w.dtype)], axis=-1)
    # (..., K, chunk) -> scan over K accumulating (..., n_bins)
    idx_c = jnp.moveaxis(
        idx.reshape(idx.shape[:-1] + (n_chunks, chunk)), -2, 0)
    w_c = jnp.moveaxis(w.reshape(w.shape[:-1] + (n_chunks, chunk)), -2, 0)

    if radix:
        n_q = -(-n_bins // radix)
        qs = jnp.arange(n_q, dtype=jnp.int32)
        rs = jnp.arange(radix, dtype=jnp.int32)

        def body(acc, inputs):
            i_blk, w_blk = inputs                        # (..., chunk)
            q, r = jnp.divmod(i_blk, radix)
            oh_r = (r[..., None] == rs).astype(w_blk.dtype)   # (..., c, L)
            oh_q = (q[..., None] == qs).astype(w_blk.dtype)   # (..., c, Q)
            a = oh_q * w_blk[..., None]                       # (..., c, Q)
            batch_nd = i_blk.ndim - 1
            # contract the chunk axis: (..., Q, L)
            contrib = jax.lax.dot_general(
                jnp.swapaxes(a, -1, -2), oh_r,
                dimension_numbers=(((a.ndim - 1,), (oh_r.ndim - 2,)),
                                   (tuple(range(batch_nd)),
                                    tuple(range(batch_nd)))),
                preferred_element_type=jnp.float32)
            return acc + contrib, None

        acc0 = jnp.zeros(idx.shape[:-1] + (n_q, radix), jnp.float32)
        out, _ = jax.lax.scan(body, acc0, (idx_c, w_c))
        return out.reshape(idx.shape[:-1] + (n_q * radix,))[..., :n_bins]

    bins = jnp.arange(n_bins, dtype=jnp.int32)

    def body(acc, inputs):
        i_blk, w_blk = inputs  # (..., chunk)
        onehot = (i_blk[..., None] == bins).astype(w_blk.dtype)
        # (..., chunk) x (..., chunk, n_bins) -> (..., n_bins)
        acc = acc + jax.lax.dot_general(
            w_blk[..., None, :], onehot,
            dimension_numbers=(((w_blk.ndim,), (onehot.ndim - 2,)),
                               (tuple(range(w_blk.ndim - 1)),
                                tuple(range(onehot.ndim - 2)))),
            preferred_element_type=jnp.float32,
        )[..., 0, :]
        return acc, None

    acc0 = jnp.zeros(idx.shape[:-1] + (n_bins,), jnp.float32)
    out, _ = jax.lax.scan(body, acc0, (idx_c, w_c))
    return out


def bin_index(values, lo: float, hi: float, n_bins: int):
    """np.histogram-compatible bin index; returns (idx, in_range_mask)."""
    v = jnp.asarray(values)
    scaled = (v - lo) * (n_bins / (hi - lo))
    idx = jnp.clip(jnp.floor(scaled).astype(jnp.int32), 0, n_bins - 1)
    in_range = (v >= lo) & (v <= hi)
    return idx, in_range


def weighted_histogram(values, lo: float, hi: float, n_bins: int,
                       weights=None, *, chunk: int = 8192,
                       method: str = "onehot", radix: int = 0):
    """Weighted histogram over the trailing axis.

    Args:
      values: (..., N) sample values.
      weights: (..., N) or None (counts).
      chunk: static chunk length for the scanned one-hot matmul.
      method: 'onehot' (matmul, default) or 'scatter' (XLA scatter-add,
        kept for cross-checking; not on the production path).
      radix: 0 = direct one-hot; L > 0 = factorized one-hot (see
        ``_scan_onehot``).

    Returns: (..., n_bins) float32 histogram.
    """
    v = jnp.asarray(values)
    if weights is None:
        w = jnp.ones(v.shape, dtype=jnp.float32)
    else:
        w = jnp.asarray(weights, dtype=jnp.float32)
        w = jnp.broadcast_to(w, v.shape)
    idx, in_range = bin_index(v, lo, hi, n_bins)
    w = jnp.where(in_range, w, 0.0)

    if method == "scatter":
        flat_batch = int(jnp.size(v) // v.shape[-1]) if v.ndim > 1 else 1
        idx2 = idx.reshape(flat_batch, v.shape[-1])
        w2 = w.reshape(flat_batch, v.shape[-1])
        out = jax.vmap(
            lambda i, x: jnp.zeros(n_bins, jnp.float32).at[i].add(x)
        )(idx2, w2)
        return out.reshape(v.shape[:-1] + (n_bins,))

    return _scan_onehot(idx, w, n_bins, chunk, radix)


def weighted_histogram_multi_window(values, windows, weights, *,
                                    chunk: int = 8192, radix: int = 0):
    """Per-window histograms over heterogeneous STATIC windows in one pass.

    The joint fits bin each run against its own TOF window (different
    ranges and bin counts, ``constants/constants.py:97-124``); looping runs
    serializes R small histogram programs.  Here every row of ``values``
    (R, N) is binned against its own window inside ONE shared one-hot block
    padded to max(n_bins): per-row lo/scale shift the indices, per-row
    hi-edge handling matches np.histogram (value == hi -> last true bin),
    and padding bins stay exactly zero.

    Returns (R, max_bins) float32; slice row r to ``windows[r].n_bins``.
    """
    n_pad = max(w.n_bins for w in windows)
    los = np.asarray([w.lo for w in windows], np.float32)[:, None]
    his = np.asarray([w.hi for w in windows], np.float32)[:, None]
    scale = np.asarray([w.n_bins / (w.hi - w.lo) for w in windows],
                       np.float32)[:, None]
    nb1 = np.asarray([w.n_bins - 1 for w in windows], np.int32)[:, None]

    v = jnp.asarray(values)
    w_ = jnp.asarray(weights, jnp.float32)
    w_ = jnp.broadcast_to(w_, v.shape)
    scaled = (v - los) * scale
    idx = jnp.clip(jnp.floor(scaled).astype(jnp.int32), 0, n_pad - 1)
    idx = jnp.minimum(idx, nb1)
    in_range = (v >= los) & (v <= his)
    w_ = jnp.where(in_range, w_, 0.0)
    return _scan_onehot(idx, w_, n_pad, chunk, radix)


def delta_moment_histogram(values, lo: float, hi: float, n_bins: int,
                           n_moments: int = 4, *, chunk: int = 8192,
                           extra_weight=None):
    """Within-bin-offset moment histograms, one matmul per chunk.

    For each bin j accumulates M_p[j] = sum_{s in bin j} delta_s^p for
    p = 0..n_moments-1, where delta_s = (v_s - center_j)/binwidth in
    [-0.5, 0.5).  Moment channels are built INSIDE the chunk loop (never
    materialized at full length) and contracted against the chunk's one-hot
    block in a single dot.  Out-of-range samples contribute nothing; values
    exactly equal to ``hi`` land in the last bin (np.histogram semantics).

    values: (..., N) -> (..., n_moments, n_bins) float32.
    ``extra_weight``: optional (..., N) multiplier on every channel (e.g. a
    per-sample prior weight).

    This is the engine of the gather-free Taylor cross-section weighting
    (``models/forward.py``): contract the result with the spline's
    (sigma, sigma' w, sigma'' w^2/2, sigma''' w^3/6) at the bin centers.
    """
    v = jnp.asarray(values, jnp.float32)
    n = v.shape[-1]
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        # pad with an out-of-range sentinel so padded lanes drop out
        v = jnp.concatenate(
            [v, jnp.full(v.shape[:-1] + (pad,), lo - 1.0, v.dtype)], axis=-1)
        if extra_weight is not None:
            extra_weight = jnp.concatenate(
                [jnp.asarray(extra_weight, jnp.float32),
                 jnp.zeros(extra_weight.shape[:-1] + (pad,), jnp.float32)],
                axis=-1)
    v_c = jnp.moveaxis(v.reshape(v.shape[:-1] + (n_chunks, chunk)), -2, 0)
    if extra_weight is not None:
        w_c = jnp.moveaxis(
            jnp.asarray(extra_weight, jnp.float32).reshape(
                v.shape[:-1] + (n_chunks, chunk)), -2, 0)
    else:
        w_c = None

    bins = jnp.arange(n_bins, dtype=jnp.int32)
    inv_width = n_bins / (hi - lo)

    def body(acc, inputs):
        if w_c is None:
            v_blk = inputs
            w_blk = None
        else:
            v_blk, w_blk = inputs
        u = (v_blk - lo) * inv_width
        idx = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, n_bins - 1)
        in_range = (v_blk >= lo) & (v_blk <= hi)
        delta = u - idx.astype(u.dtype) - 0.5
        base = jnp.where(in_range, 1.0, 0.0)
        if w_blk is not None:
            base = base * w_blk
        chans = [base]
        for _ in range(n_moments - 1):
            chans.append(chans[-1] * delta)
        c_blk = jnp.stack(chans, axis=-2)  # (..., C, chunk)
        onehot = (idx[..., None] == bins).astype(v_blk.dtype)
        batch_nd = v_blk.ndim - 1
        contrib = jax.lax.dot_general(
            c_blk, onehot,
            dimension_numbers=(((c_blk.ndim - 1,), (onehot.ndim - 2,)),
                               (tuple(range(batch_nd)),
                                tuple(range(batch_nd)))),
            preferred_element_type=jnp.float32)
        return acc + contrib, None

    acc0 = jnp.zeros(v.shape[:-1] + (n_moments, n_bins), jnp.float32)
    xs_in = v_c if w_c is None else (v_c, w_c)
    out, _ = jax.lax.scan(body, acc0, xs_in)
    return out


def histogram_density(hist, lo: float, hi: float):
    """Convert a count/weight histogram to np.histogram(density=True) form."""
    h = jnp.asarray(hist)
    n_bins = h.shape[-1]
    width = (hi - lo) / n_bins
    total = jnp.sum(h, axis=-1, keepdims=True)
    return h / (total * width)
