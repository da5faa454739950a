"""Box-logit reparameterization for the gradient samplers.

The flagship posteriors are supported on a box prior
(``tests/simultFit.py:424-442``-style uniform boxes).  In linear
coordinates every leapfrog step that crosses a box face lands on
log p = -inf — an automatic NUTS "divergence" — and the (eLoss, scale,
s) lognorm ridge is sharply anisotropic, so a linear standardization
left the round-4 flagship NUTS run at a 46% divergence rate
(artifacts/parity_nuts_report.txt).

The standard fix (Stan's constrained-parameter transform): sample the
unconstrained u in R^D with

    theta(u)   = lo + (hi - lo) * sigmoid(u)
    log|J|(u)  = sum_d [ log(hi_d - lo_d) + log_sigmoid(u_d)
                         + log_sigmoid(-u_d) ]

so the box posterior becomes a smooth density on all of R^D (the
Jacobian term replaces the flat box prior exactly), boundaries are at
infinity, and the log-scale geometry of the ridge is substantially
relaxed by the sigmoid's compression near the faces.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class BoxLogitTransform:
    """u in R^D  <->  theta in (lo, hi), with the exact log-Jacobian."""

    def __init__(self, lo, hi):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        if not np.all(hi > lo):
            raise ValueError("box bounds must satisfy hi > lo elementwise")
        self.lo = jnp.asarray(lo)
        self.hi = jnp.asarray(hi)
        self.width = jnp.asarray(hi - lo)
        self._log_width_sum = float(np.sum(np.log(hi - lo)))

    def to_theta(self, u):
        return self.lo + self.width * jax.nn.sigmoid(u)

    def log_det_jacobian(self, u):
        # log sigmoid(u) + log sigmoid(-u) = -softplus(-u) - softplus(u)
        return (self._log_width_sum
                + jnp.sum(jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u),
                          axis=-1))

    def to_u(self, theta, *, eps: float = 1e-5):
        """Inverse (for initial positions); clips into the open box so
        walkers seeded exactly on a face map to finite u."""
        p = jnp.clip((jnp.asarray(theta, jnp.float32) - self.lo)
                     / self.width, eps, 1.0 - eps)
        return jnp.log(p) - jnp.log1p(-p)

    def wrap_logp(self, logp_theta):
        """logp over u for a (deterministic) logp over theta."""
        def logp_u(u):
            return logp_theta(self.to_theta(u)) + self.log_det_jacobian(u)
        return logp_u
