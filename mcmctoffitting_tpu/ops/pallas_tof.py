"""Pallas (Triton) kernel: fused TOF-synthesis histograms on the GPU.

The TOF-synthesis stage bins every (x-bin, eD-bin) lattice cell, spread
over K zero-degree transit segments, into each run's TOF window:

  for each run r (static window), lattice cell s, segment k:
      v   = base_tof[r, s] + zt[s, k]     # zero-degree transit offset
      w   = draws[r, s] * zw[s, k]        # segment weight
      hist[r, bin(v)] += w                # np.histogram semantics

XLA's path (``ops/histogram.weighted_histogram_multi_window``) first
expands the (R, M*Be*K) sample tensor, then contracts scanned one-hot
blocks; both round-trip device memory.  This kernel reads only
``base_tof`` and ``draws`` (2 x R x M x Be f32 per walker) plus the
shared (K, M*Be) spread tables, and writes the (R, n_pad) histograms.

Layout: one program per (walker, run) — blocks run in parallel and in
no order, so nothing carries across the grid.  Inside a program the
lattice is walked in ``blk``-sample slices; for each slice the K-segment
loop is unrolled and a (blk, <= 128-bin) block of partial sums is
accumulated in registers by compare-select (one per sample and bin), then
reduced over the slice axis once at the end — no atomics, so the result
is deterministic.

Numerics: identical bin-index arithmetic and np.histogram edge semantics
as the XLA path (same f32 ``(v - lo) * scale``, clip to the last true
bin, ``v == hi`` lands in the last bin, out-of-range weights dropped).
Weights and sums stay f32 — the XLA path's default-precision one-hot dot
may round the weights to TF32 (10-bit mantissa) on the GPU — so the two
agree to that rounding, and the kernel agrees with an f64 np.histogram to
f32 summation error.

Reference semantics being reproduced: the TOF-synthesis ndenumerate loop
``tests/simultFit.py:286-296`` with the 10-segment zero-degree spread of
``utilities/utilities.py:154``; oneBD's expo-kernel presets are the K = 1
case.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_BINS = 128    # widest TOF window one program accumulates in registers
# (blk, nb) partial-sum block per program, and one warp per 32 slice rows
# (2..8): the best of a slice x warps sweep on an H100 at both the simult
# (nb = 128) and the oneBD -hardcore (nb = 32) shapes (PERF.md)
_ACC_ELEMS = 8192


def _tile(nb: int):
    """(blk, num_warps) for an ``nb``-bin window."""
    blk = max(16, _ACC_ELEMS // nb)
    return blk, min(8, max(2, blk // 32))


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _win_scalar(r, values, dtype):
    """Select ``values[r]`` for a traced run index (static, short list)."""
    out = jnp.asarray(values[0], dtype)
    for i in range(1, len(values)):
        out = jnp.where(r == i, jnp.asarray(values[i], dtype), out)
    return out


def _tof_kernel(base_ref, draws_ref, zt_ref, zw_ref, out_ref, *,
                win_consts, n_seg, sp, blk, nb):
    """One (walker, run) program: (sp,) lattice -> (nb,) histogram."""
    r = pl.program_id(1)
    lo = _win_scalar(r, [c[0] for c in win_consts], jnp.float32)
    hi = _win_scalar(r, [c[1] for c in win_consts], jnp.float32)
    scale = _win_scalar(r, [c[2] for c in win_consts], jnp.float32)
    nb1 = _win_scalar(r, [c[3] for c in win_consts], jnp.int32)
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, nb), 1)

    def body(j, acc):
        start = pl.multiple_of(j * blk, blk)
        base = base_ref[pl.ds(start, blk)]
        w0 = draws_ref[pl.ds(start, blk)]
        for k in range(n_seg):
            v = base + zt_ref[pl.ds(k * sp + start, blk)]
            wt = w0 * zw_ref[pl.ds(k * sp + start, blk)]
            idx = jnp.clip(jnp.floor((v - lo) * scale).astype(jnp.int32),
                           0, nb1)
            wt = jnp.where((v >= lo) & (v <= hi), wt, 0.0)
            hit = idx[:, None] == bins                   # (blk, nb)
            acc = acc + jnp.where(hit, wt[:, None], 0.0)
        return acc

    # the (blk, nb) partial sums stay thread-local across the whole walk;
    # the one cross-thread reduction over the slice axis comes last
    acc = jax.lax.fori_loop(0, sp // blk, body,
                            jnp.zeros((blk, nb), jnp.float32))
    out_ref[...] = jnp.sum(acc, axis=0)


@functools.partial(jax.jit, static_argnames=("win_consts", "n_seg", "sp",
                                             "blk", "nb", "interpret",
                                             "num_warps"))
def _tof_hist_pallas(base, draws, zt_flat, zw_flat, *, win_consts, n_seg,
                     sp, blk, nb, interpret, num_warps):
    """base/draws (W, R, sp) f32; zt/zw (K*sp,) -> (W, R, nb) f32."""
    n_w, n_runs = base.shape[0], base.shape[1]
    kern = functools.partial(_tof_kernel, win_consts=win_consts,
                             n_seg=n_seg, sp=sp, blk=blk, nb=nb)
    row = pl.BlockSpec((None, None, sp), lambda w, r: (w, r, 0))
    table = pl.BlockSpec((n_seg * sp,), lambda w, r: (0,))
    return pl.pallas_call(
        kern,
        grid=(n_w, n_runs),
        in_specs=[row, row, table, table],
        out_specs=pl.BlockSpec((None, None, nb), lambda w, r: (w, r, 0)),
        out_shape=jax.ShapeDtypeStruct((n_w, n_runs, nb), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="tof_hist_segments",
    )(base, draws, zt_flat, zw_flat)


@functools.lru_cache(maxsize=None)
def make_tof_hist_segments(windows, m_bins: int, be_bins: int,
                           n_seg: int, *, interpret: bool = False):
    """Build the (cached, vmap-collapsing, differentiable) fused op.

    windows: static tuple of TofWindow (per run; max n_bins <= 128).
    m_bins/be_bins: x / eD lattice sizes; n_seg: zero-degree segments.

    Returns ``fn(base_tof, draws, zt, zw) -> (R, n_pad)`` where
    base_tof/draws are (R, m_bins, be_bins) f32 and zt/zw are the
    (be_bins, n_seg) spread tables.  Under ``vmap`` (the sampler's
    walker batch — or nested batches) every leading axis collapses into
    the kernel's walker grid axis.
    """
    n_runs = len(windows)
    n_pad = max(w.n_bins for w in windows)
    if n_pad > MAX_BINS:
        raise ValueError(f"fused TOF kernel covers <= {MAX_BINS} bins, "
                         f"got {n_pad}")
    nb = max(16, _next_pow2(n_pad))
    blk, num_warps = _tile(nb)
    n0 = m_bins * be_bins
    sp = -(-n0 // blk) * blk
    win_consts = tuple(
        (float(np.float32(w.lo)), float(np.float32(w.hi)),
         float(np.float32(w.n_bins / (w.hi - w.lo))), int(w.n_bins - 1))
        for w in windows)

    def _pack(arr, fill):
        # (W, R, M, Be) -> (W, R, sp); the fill puts padding cells out of
        # every window (base) or gives them zero weight (draws)
        flat = arr.reshape(arr.shape[0], n_runs, n0)
        if sp != n0:
            flat = jnp.pad(flat, ((0, 0), (0, 0), (0, sp - n0)),
                           constant_values=fill)
        return flat

    def _lane_table(t):
        # (Be, K) -> (K * sp,): entry k*sp + m*Be + b carries t[b, k]
        full = jnp.tile(t.T, (1, m_bins))                # (K, M*Be)
        if sp != n0:
            full = jnp.pad(full, ((0, 0), (0, sp - n0)))
        return full.astype(jnp.float32).reshape(-1)

    @jax.custom_batching.custom_vmap
    def fn(base_tof, draws, zt, zw):
        squeeze = base_tof.ndim == 3
        if squeeze:
            base_tof = base_tof[None]
            draws = draws[None]
        out = _tof_hist_pallas(
            _pack(base_tof.astype(jnp.float32), 1.0e9),
            _pack(draws.astype(jnp.float32), 0.0),
            _lane_table(zt), _lane_table(zw),
            win_consts=win_consts, n_seg=n_seg, sp=sp, blk=blk, nb=nb,
            interpret=interpret, num_warps=num_warps)[..., :n_pad]
        return out[0] if squeeze else out

    @fn.def_vmap
    def _fn_vmap(axis_size, in_batched, base_tof, draws, zt, zw):
        bb, db, zb, wb = in_batched
        if not bb:
            base_tof = jnp.broadcast_to(base_tof,
                                        (axis_size,) + base_tof.shape)
        if not db:
            draws = jnp.broadcast_to(draws, (axis_size,) + draws.shape)
        # the spread tables are spec-static (identical across any batch);
        # a batched axis would just be axis_size copies — take one
        if zb:
            zt = jax.lax.index_in_dim(zt, 0, 0, keepdims=False)
        if wb:
            zw = jax.lax.index_in_dim(zw, 0, 0, keepdims=False)
        # collapse ALL leading axes into the walker grid axis and recurse
        # through the custom-vmap function so nested vmaps collapse too
        flat_b = base_tof.reshape((-1,) + base_tof.shape[-3:])
        flat_d = draws.reshape((-1,) + draws.shape[-3:])
        out = fn(flat_b, flat_d, zt, zw)                 # (Wtot, R, n_pad)
        out = out.reshape(base_tof.shape[:-3] + out.shape[-2:])
        return out, True

    # --- autodiff: the histogram is LINEAR in the draws weights, and its
    # bin assignment (floor/compare of base_tof + zt) has zero gradient
    # a.e. — exactly the gradient the XLA expand-then-contract path gets,
    # where the one-hot comparisons are non-differentiable constants.  A
    # custom VJP (forward = the kernel, backward = one gather of the
    # output cotangent at each sample's bin) makes the fused stage usable
    # under the gradient samplers (-sampler nuts|hmc on the expected
    # forward), which reverse-differentiate the whole spectrum.
    @jax.custom_vjp
    def fn_ad(base_tof, draws, zt, zw):
        return fn(base_tof, draws, zt, zw)

    def _fn_fwd(base_tof, draws, zt, zw):
        return fn(base_tof, draws, zt, zw), (base_tof, zt, zw)

    def _fn_bwd(res, gbar):
        base_tof, zt, zw = res
        # shapes here are the UNBATCHED contract — (R, M, Be) / (R, n_pad)
        # — because vmap batches custom_vjp rules itself
        grads = []
        for r in range(n_runs):
            lo, hi, scale, nb1 = win_consts[r]
            v = base_tof[r][:, :, None] + zt[None, :, :]   # (M, Be, K)
            idx = jnp.clip(jnp.floor((v - lo) * scale).astype(jnp.int32),
                           0, nb1)
            ok = jnp.logical_and(v >= lo, v <= hi)
            g = jnp.where(ok, jnp.take(gbar[r], idx, axis=0), 0.0)
            grads.append(jnp.sum(g * zw[None, :, :], axis=-1))
        grad_draws = jnp.stack(grads).astype(base_tof.dtype)
        return (jnp.zeros_like(base_tof), grad_draws,
                jnp.zeros_like(zt), jnp.zeros_like(zw))

    fn_ad.defvjp(_fn_fwd, _fn_bwd)
    return fn_ad
