"""Drop-in API compatibility layers for the libraries the reference drives.

``compat.emcee`` mirrors the emcee 2.x classes the reference scripts are
written against (``EnsembleSampler``, ``PTSampler``) on top of this
package's compiled samplers, so a reference user's own driver code runs
unmodified:

    from mcmctoffitting_tpu.compat import emcee
    sampler = emcee.EnsembleSampler(nWalkers, nDim, lnprob, kwargs={...})
    for pos, prob, rstate in sampler.sample(p0, iterations=n):
        ...
"""
from . import emcee

__all__ = ["emcee"]
