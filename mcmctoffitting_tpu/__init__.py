"""mcmctoffitting_tpu — neutron TOF-spectrum Bayesian fitting on the GPU.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
gcrich/mcmcTOFfitting: simulation-based binned likelihoods for neutron
time-of-flight spectra, a native affine-invariant ensemble sampler (vmapped
walkers, shardable across a device mesh), and posterior-predictive tooling.

Layering (mirrors SURVEY.md §1):
  constants/config  ->  ops (physics kernels)  ->  models (forward + lnprob)
  ->  sampler (stretch-move / PT, lax.scan)  ->  parallel (mesh sharding)
  ->  utils (chain IO, PPC, plotting, data IO)
"""

__version__ = "0.1.0"

from . import constants, config  # noqa: F401
