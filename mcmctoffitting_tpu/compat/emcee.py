"""emcee 2.x API shim over the package's compiled samplers.

The reference's drivers are written directly against emcee 2's classes —
``emcee.EnsembleSampler(nWalkers, nDim, lnprob, kwargs={...}, threads=N)``
with the ``for pos, prob, rstate in sampler.sample(...)`` segment loop
(``/root/reference/tests/simultFit.py:701-790``,
``tests/csi_oneBD.py:863-947``) and ``emcee.PTSampler(ntemps, nwalkers,
ndim, logl, logp, threads=10, loglkwargs=...)`` with
``for p, lnp, lnl in ptSampler.sample(...)``
(``tests/shiftingGaussian_brute.py:352-363``).  This module reproduces
those classes' construction, generator, attribute and layout conventions
so such scripts run unmodified, while the moves execute on this package's
samplers.

Two execution backends, selected automatically per log-probability
function:

* ``jax`` — the function is JAX-traceable: walkers become a vmapped array
  axis and each ensemble step is one compiled XLA program
  (``sampler/stretch.py`` / ``sampler/pt.py`` machinery), so existing
  emcee driver loops get device-batched evaluation for free;
* ``host`` — arbitrary Python/numpy functions (the literal reference use
  case): a plain numpy implementation of the same red-black stretch move
  evaluates walkers in a host loop, exactly like emcee's
  ``threads=1`` path.

``threads=`` / ``pool=`` are accepted and ignored: the walker axis is the
parallel axis here (vmap/mesh), not a process pool.

Deliberate deviations from emcee 2 (documented, all small):

* randomness comes from an explicit ``seed=`` (default 0) instead of the
  global numpy state; ``rstate`` yielded/accepted is this shim's opaque
  PRNG object;
* the ensemble is split red-black (even/odd index) rather than
  first-half/second-half — same detailed-balance argument, same
  stationary distribution;
* ``nwalkers`` must be even (emcee asserts the same).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..sampler import stretch as _stretch
from ..sampler import pt as _pt
from ..utils.diagnostics import integrated_autocorr_time

__all__ = ["EnsembleSampler", "PTSampler", "default_beta_ladder"]

default_beta_ladder = _pt.default_beta_ladder


def _wrap(fn: Callable, args, kwargs) -> Callable:
    args = tuple(args or ())
    kwargs = dict(kwargs or {})
    if not args and not kwargs:
        return fn
    return lambda theta: fn(theta, *args, **kwargs)


def _host_stretch_halves(pos, lp, call, rng, a):
    """One numpy red-black stretch step in place; returns accept mask (W,)."""
    n_walkers, n_dim = pos.shape
    n_half = n_walkers // 2
    acc = np.zeros(n_walkers, bool)
    for parity in (0, 1):
        active = np.arange(parity, n_walkers, 2)
        passive = np.arange(1 - parity, n_walkers, 2)
        z = ((a - 1.0) * rng.random(n_half) + 1.0) ** 2 / a
        j = rng.integers(0, n_half, n_half)
        partners = pos[passive[j]]
        prop = partners + z[:, None] * (pos[active] - partners)
        lp_prop = np.array([float(call(p)) for p in prop])
        log_ratio = (n_dim - 1.0) * np.log(z) + lp_prop - lp[active]
        ok = np.log(rng.random(n_half)) < log_ratio
        pos[active[ok]] = prop[ok]
        lp[active[ok]] = lp_prop[ok]
        acc[active] = ok
    return acc



def _stack_cached(obj, name, steps, axis):
    """Stack a step list once per length: reference drivers read .chain
    inside their per-iteration progress loops, and emcee 2 hands back a
    preallocated ndarray there — an uncached np.stack would make those
    loops O(S^2) in chain length."""
    cache = getattr(obj, "_stack_cache", None)
    if cache is None:
        cache = {}
        obj._stack_cache = cache
    hit = cache.get(name)
    if hit is not None and hit[0] == len(steps):
        return hit[1]
    arr = np.stack(steps, axis=axis)
    cache[name] = (len(steps), arr)
    return arr


class EnsembleSampler:
    """emcee-2-compatible affine-invariant ensemble sampler.

    Matches the surface the reference drives: ``.sample()`` generator
    yielding ``(pos, lnprob, rstate)``, ``.run_mcmc()``, ``.chain``
    (nwalkers, nsteps, ndim), ``.flatchain``, ``.lnprobability``,
    ``.acceptance_fraction``, ``.acor`` / ``.get_autocorr_time()``,
    ``.reset()``.
    """

    def __init__(self, nwalkers: int, dim: int, lnpostfn: Callable, *,
                 a: float = 2.0, args=None, kwargs=None,
                 threads: int = 1, pool: Any = None,
                 live_dangerously: bool = False,
                 runtime_sortingfn: Any = None,
                 seed: int = 0, backend: str = "auto"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if nwalkers < 2 * dim and not live_dangerously:
            warnings.warn("nwalkers < 2*dim degrades the stretch move "
                          "(emcee raises here)")
        del threads, pool, runtime_sortingfn  # walker axis is the pool
        if backend not in ("auto", "jax", "host"):
            raise ValueError(f"backend must be auto|jax|host, got {backend}")
        self.nwalkers, self.dim, self.a = nwalkers, dim, a
        self._call = _wrap(lnpostfn, args, kwargs)
        self._backend_req = backend
        self.backend: Optional[str] = None   # resolved at first sample()
        self._key = jax.random.key(seed)
        self._rng = np.random.default_rng(seed)
        self._state = None                   # jax EnsembleState
        self._step_c = None                  # jitted step
        self.reset()

    # -- emcee surface -------------------------------------------------
    def reset(self):
        """Clear the stored chain and counters (keeps the random state)."""
        self._stack_cache = {}   # same-length reuse after reset = stale
        self._pos_steps: list[np.ndarray] = []
        self._lp_steps: list[np.ndarray] = []
        self._naccepted = np.zeros(self.nwalkers)
        self.iterations = 0
        self._last = None

    @property
    def chain(self) -> np.ndarray:
        """(nwalkers, nsteps, ndim) — emcee's walker-major layout."""
        if not self._pos_steps:
            return np.empty((self.nwalkers, 0, self.dim))
        return _stack_cached(self, "pos", self._pos_steps, 1)

    @property
    def flatchain(self) -> np.ndarray:
        return self.chain.reshape(-1, self.dim)

    @property
    def lnprobability(self) -> np.ndarray:
        """(nwalkers, nsteps)."""
        if not self._lp_steps:
            return np.empty((self.nwalkers, 0))
        return _stack_cached(self, "lp", self._lp_steps, 1)

    @property
    def flatlnprobability(self) -> np.ndarray:
        return self.lnprobability.reshape(-1)

    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self._naccepted / max(self.iterations, 1)

    def get_autocorr_time(self, **kwargs) -> np.ndarray:
        """Per-parameter integrated autocorrelation time (D,)."""
        chain_swd = self.chain.transpose(1, 0, 2)   # -> (S, W, D)
        return integrated_autocorr_time(chain_swd)

    @property
    def acor(self) -> np.ndarray:
        return self.get_autocorr_time()

    def get_lnprob(self, p) -> float:
        return float(self._call(np.asarray(p)))

    # -- backends --------------------------------------------------------
    def _resolve_backend(self, p0, lnprob0):
        if self._backend_req in ("auto", "jax"):
            try:
                logp_batch = _stretch.make_logp_batch(
                    self._call, stochastic=False)
                self._key, k_init = jax.random.split(self._key)
                state = _stretch.init_state(k_init, p0, logp_batch)
                step = _stretch.make_step(logp_batch, self.a)
                step_c = jax.jit(lambda s: step(s, None))
                # force compilation now so tracing failures fall back here
                jax.block_until_ready(step_c(state)[0].positions)
                self._state, self._step_c = state, step_c
                self.backend = "jax"
                return
            except Exception as exc:  # noqa: BLE001 — any tracing failure
                if self._backend_req == "jax":
                    raise
                warnings.warn(
                    f"log-probability is not JAX-traceable ({type(exc).__name__}); "
                    "falling back to the host (numpy) backend")
        self.backend = "host"

    def _set_state(self, p0, lnprob0):
        p0 = np.asarray(p0, np.float64)
        if self.backend == "jax":
            st = self._state
            pos = jnp.asarray(p0, jnp.float32)
            if lnprob0 is not None:
                lp = jnp.asarray(lnprob0, jnp.float32)
            else:
                kdum = jax.random.split(st.key, self.nwalkers)
                lp = None  # recomputed below
            if lp is None:
                logp_batch = _stretch.make_logp_batch(
                    self._call, stochastic=False)
                lp = logp_batch(pos, kdum)
            self._state = _stretch.EnsembleState(pos, lp, st.key, st.step)
        else:
            self._host_pos = p0.copy()
            if lnprob0 is not None:
                self._host_lp = np.asarray(lnprob0, np.float64).copy()
            else:
                self._host_lp = np.array(
                    [float(self._call(p)) for p in self._host_pos])

    def sample(self, p0, lnprob0=None, rstate0=None, *, iterations: int = 1,
               thin: int = 1, storechain: bool = True):
        """Generator: advance the ensemble, yielding (pos, lnprob, rstate)
        after every iteration — emcee 2's segment-loop contract."""
        if self.backend is None:
            self._resolve_backend(np.asarray(p0, np.float64), lnprob0)
        if rstate0 is not None:
            if self.backend == "jax":
                self._state = self._state._replace(key=rstate0) \
                    if self._state is not None else None
                self._key = rstate0
            else:
                self._rng = rstate0
        self._set_state(p0, lnprob0)

        for i in range(int(iterations)):
            if self.backend == "jax":
                self._state, (pos_j, lp_j, acc_j) = self._step_c(self._state)
                pos = np.asarray(pos_j, np.float64)
                lp = np.asarray(lp_j, np.float64)
                acc = np.asarray(acc_j)
                rstate = self._state.key
            else:
                acc = _host_stretch_halves(self._host_pos, self._host_lp,
                                           self._call, self._rng, self.a)
                pos, lp = self._host_pos.copy(), self._host_lp.copy()
                rstate = self._rng
            self._naccepted += acc
            self.iterations += 1
            if storechain and i % thin == 0:
                # emcee 2 stores iterations 0, thin, 2*thin, ... —
                # ceil(iterations/thin) rows, NOT (i+1) % thin
                # (which drops the first stored step and changes
                # chain length when thin does not divide iterations)
                self._pos_steps.append(pos)
                self._lp_steps.append(lp)
            self._last = (pos, lp, rstate)
            yield pos, lp, rstate

    def run_mcmc(self, pos0, N, *, rstate0=None, lnprob0=None, **kwargs):
        """Run ``N`` steps, returning the final ``(pos, lnprob, rstate)``."""
        if pos0 is None:
            if self._last is None:
                raise ValueError("run_mcmc(None, ...) needs a previous run")
            pos0, lnprob0, rstate0 = self._last
        result = None
        for result in self.sample(pos0, lnprob0, rstate0,
                                  iterations=N, **kwargs):
            pass
        return result


class PTSampler:
    """emcee-2-compatible parallel-tempering sampler.

    Construction and generator semantics match the reference's use
    (``tests/shiftingGaussian_brute.py:352-363``): ``PTSampler(ntemps,
    nwalkers, dim, logl, logp, loglkwargs=...)``, ``.sample(p0,
    lnprob0=, lnlike0=, iterations=, thin=)`` yielding ``(p, lnprob,
    lnlike)``, ``.reset()``, ``.chain`` (ntemps, nwalkers, steps, dim),
    plus ``thermodynamic_integration_log_evidence``.
    """

    def __init__(self, ntemps: int, nwalkers: int, dim: int,
                 logl: Callable, logp: Callable, *,
                 a: float = 2.0, betas=None,
                 threads: int = 1, pool: Any = None,
                 loglargs=None, logpargs=None,
                 loglkwargs=None, logpkwargs=None,
                 seed: int = 0, backend: str = "auto"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        del threads, pool
        if backend not in ("auto", "jax", "host"):
            raise ValueError(f"backend must be auto|jax|host, got {backend}")
        self.ntemps, self.nwalkers, self.dim, self.a = (ntemps, nwalkers,
                                                        dim, a)
        self.betas = np.asarray(
            default_beta_ladder(ntemps) if betas is None else betas,
            np.float64)
        if self.betas.shape != (ntemps,):
            raise ValueError("betas must have shape (ntemps,)")
        self._logl = _wrap(logl, loglargs, loglkwargs)
        self._logp = _wrap(logp, logpargs, logpkwargs)
        self._backend_req = backend
        self.backend: Optional[str] = None
        self._key = jax.random.key(seed)
        self._rng = np.random.default_rng(seed)
        self._step_c = None
        self.reset()

    def reset(self):
        self._stack_cache = {}   # same-length reuse after reset = stale
        self._pos_steps: list[np.ndarray] = []    # each (T, W, D)
        self._ll_steps: list[np.ndarray] = []     # each (T, W)
        self._lp_steps: list[np.ndarray] = []     # tempered lnprob (T, W)
        self._naccepted = np.zeros((self.ntemps, self.nwalkers))
        self._nswap = np.zeros(self.ntemps)
        self._nswap_accepted = np.zeros(self.ntemps)
        self.iterations = 0

    # -- emcee surface -------------------------------------------------
    @property
    def chain(self) -> np.ndarray:
        """(ntemps, nwalkers, nsteps, ndim)."""
        if not self._pos_steps:
            return np.empty((self.ntemps, self.nwalkers, 0, self.dim))
        return _stack_cached(self, "pos", self._pos_steps, 2)

    @property
    def lnlikelihood(self) -> np.ndarray:
        if not self._ll_steps:
            return np.empty((self.ntemps, self.nwalkers, 0))
        return _stack_cached(self, "ll", self._ll_steps, 2)

    @property
    def lnprobability(self) -> np.ndarray:
        if not self._lp_steps:
            return np.empty((self.ntemps, self.nwalkers, 0))
        return _stack_cached(self, "lp", self._lp_steps, 2)

    @property
    def flatchain(self) -> np.ndarray:
        return self.chain.reshape(self.ntemps, -1, self.dim)

    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self._naccepted / max(self.iterations, 1)

    @property
    def tswap_acceptance_fraction(self) -> np.ndarray:
        """(ntemps,) — emcee's per-temperature attribution: each adjacent
        pair's attempts/accepts are credited to both participating rungs."""
        with np.errstate(invalid="ignore"):
            return np.where(self._nswap > 0,
                            self._nswap_accepted / self._nswap, np.nan)

    def thermodynamic_integration_log_evidence(self, fburnin: float = 0.1):
        """(ln Z, d ln Z) from the stored tempered log-likelihood chain."""
        ll_stw = self.lnlikelihood.transpose(2, 0, 1)   # -> (S, T, W)
        return _pt.thermodynamic_integration_log_evidence(
            ll_stw, self.betas, fburnin=fburnin)

    # -- backends --------------------------------------------------------
    def _resolve_backend(self, p0):
        if self._backend_req in ("auto", "jax"):
            try:
                llb = _pt._make_batched(self._logl, stochastic=False)
                lpb = _pt._make_batched(self._logp, stochastic=False)
                self._key, k_init = jax.random.split(self._key)
                state = _pt.init_pt_state(k_init, p0, llb, lpb)
                step = _pt.make_pt_step(llb, lpb, self.betas, self.a)
                step_c = jax.jit(lambda s: step(s, None))
                jax.block_until_ready(step_c(state)[0].positions)
                self._llb, self._lpb = llb, lpb
                self._jstate, self._step_c = state, step_c
                self.backend = "jax"
                return
            except Exception as exc:  # noqa: BLE001
                if self._backend_req == "jax":
                    raise
                warnings.warn(
                    f"logl/logp not JAX-traceable ({type(exc).__name__}); "
                    "falling back to the host (numpy) backend")
        self.backend = "host"

    def _set_state(self, p0, lnprob0, lnlike0):
        p0 = np.asarray(p0, np.float64)
        if lnlike0 is not None:
            ll = np.asarray(lnlike0, np.float64)
            if lnprob0 is not None:
                lp = np.asarray(lnprob0, np.float64) \
                    - self.betas[:, None] * ll
            else:
                lp = np.array([[float(self._logp(w)) for w in rung]
                               for rung in p0])
        else:
            ll = np.array([[float(self._logl(w)) for w in rung]
                           for rung in p0]) if self.backend == "host" else None
            lp = np.array([[float(self._logp(w)) for w in rung]
                           for rung in p0]) if self.backend == "host" else None
        if self.backend == "jax":
            st = self._jstate
            pos = jnp.asarray(p0, jnp.float32)
            if ll is None:
                t, w = self.ntemps, self.nwalkers
                keys = jax.random.split(st.key, t * w).reshape(t, w, -1)
                ll_j = self._llb(pos, keys)
                lp_j = self._lpb(pos, keys)
            else:
                ll_j = jnp.asarray(ll, jnp.float32)
                lp_j = jnp.asarray(lp, jnp.float32)
            self._jstate = _pt.PTState(pos, ll_j, lp_j, st.key, st.step)
        else:
            self._host_pos = p0.copy()
            self._host_ll, self._host_lp = ll.copy(), lp.copy()

    def _host_step(self):
        """Numpy tempered stretch + adjacent replica exchange."""
        pos, ll, lp = self._host_pos, self._host_ll, self._host_lp
        n_dim = self.dim
        acc_all = np.zeros((self.ntemps, self.nwalkers), bool)
        for t in range(self.ntemps):
            beta = self.betas[t]
            # tempered target: logp + beta * logl; track both components
            n_half = self.nwalkers // 2
            for parity in (0, 1):
                active = np.arange(parity, self.nwalkers, 2)
                passive = np.arange(1 - parity, self.nwalkers, 2)
                z = ((self.a - 1.0) * self._rng.random(n_half) + 1.0) ** 2 \
                    / self.a
                j = self._rng.integers(0, n_half, n_half)
                partners = pos[t][passive[j]]
                prop = partners + z[:, None] * (pos[t][active] - partners)
                ll_prop = np.array([float(self._logl(p)) for p in prop])
                lp_prop = np.array([float(self._logp(p)) for p in prop])
                new = lp_prop + beta * ll_prop
                old = lp[t][active] + beta * ll[t][active]
                ok = np.log(self._rng.random(n_half)) \
                    < (n_dim - 1.0) * np.log(z) + new - old
                idx = active[ok]
                pos[t][idx] = prop[ok]
                ll[t][idx] = ll_prop[ok]
                lp[t][idx] = lp_prop[ok]
                acc_all[t][active] = ok
        # replica exchange, coldest pair last (matches sampler/pt.py)
        for i in range(self.ntemps - 2, -1, -1):
            perm = self._rng.permutation(self.nwalkers)
            ll_hot = ll[i + 1][perm]
            log_ratio = (self.betas[i] - self.betas[i + 1]) \
                * (ll_hot - ll[i])
            ok = np.log(self._rng.random(self.nwalkers)) < log_ratio
            sw = perm[ok]
            (pos[i][ok], pos[i + 1][sw]) = (pos[i + 1][sw].copy(),
                                            pos[i][ok].copy())
            (ll[i][ok], ll[i + 1][sw]) = (ll[i + 1][sw].copy(),
                                          ll[i][ok].copy())
            (lp[i][ok], lp[i + 1][sw]) = (lp[i + 1][sw].copy(),
                                          lp[i][ok].copy())
            n_ok = int(ok.sum())
            for rung in (i, i + 1):
                self._nswap[rung] += self.nwalkers
                self._nswap_accepted[rung] += n_ok
        return acc_all

    def sample(self, p0, lnprob0=None, lnlike0=None, *, iterations: int = 1,
               thin: int = 1, storechain: bool = True):
        """Generator yielding (p, lnprob, lnlike) each iteration."""
        if self.backend is None:
            self._resolve_backend(np.asarray(p0, np.float64))
        self._set_state(p0, lnprob0, lnlike0)

        for i in range(int(iterations)):
            if self.backend == "jax":
                self._jstate, (pos_j, ll_j, lp_j, acc_j, swaps_j) = \
                    self._step_c(self._jstate)
                pos = np.asarray(pos_j, np.float64)
                ll = np.asarray(ll_j, np.float64)
                lp = np.asarray(lp_j, np.float64)
                acc = np.asarray(acc_j, bool)
                pair = np.asarray(swaps_j, np.float64)      # (T-1,)
                for r in range(self.ntemps - 1):
                    for rung in (r, r + 1):
                        self._nswap[rung] += self.nwalkers
                        self._nswap_accepted[rung] += pair[r]
            else:
                acc = self._host_step()
                pos = self._host_pos.copy()
                ll = self._host_ll.copy()
                lp = self._host_lp.copy()
            self._naccepted += acc
            self.iterations += 1
            lnprob = lp + self.betas[:, None] * ll
            if storechain and i % thin == 0:
                # emcee 2 stores iterations 0, thin, 2*thin, ... —
                # ceil(iterations/thin) rows, NOT (i+1) % thin
                # (which drops the first stored step and changes
                # chain length when thin does not divide iterations)
                self._pos_steps.append(pos)
                self._ll_steps.append(ll)
                self._lp_steps.append(lnprob)
            yield pos, lnprob, ll
