"""Fast v0 forward parity vs the reference's own generateModelData.

The full five-family study lives in
``tools/reference_forward_compare_simple.py``; this
test keeps the lightest row (v0, reduced draws) in the suite so a forward
regression against the reference semantics is caught in CI.  Skipped when
the reference tree is not present.
"""
import os

import numpy as np
import pytest

REFERENCE = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REFERENCE, "tests")),
    reason="reference tree not available")


def test_v0_forward_matches_reference():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    sys.path.insert(0, REFERENCE)
    from reference_forward_compare_simple import extract_driver

    import jax
    import jax.numpy as jnp

    from mcmctoffitting_tpu.constants import TUNL_SSA_CSI, TofWindow
    from mcmctoffitting_tpu.models.simple import SimpleSpec, model_pdf

    v0 = extract_driver(os.path.join(REFERENCE, "tests/simpleTOFmodel.py"))
    theta = (1100.0, -100.0, 50.0)
    n, reps = 50_000, 6
    rng = np.random.default_rng(0)
    ref = []
    for _ in range(reps):
        np.random.seed(rng.integers(2**31))
        d = v0["generateModelData"](theta, n)
        h, _ = np.histogram(d[:, 3], v0["tof_nBins"], v0["tof_range"])
        ref.append(h)

    spec = SimpleSpec(window=TofWindow(v0["tof_minRange"],
                                       v0["tof_maxRange"],
                                       v0["tof_nBins"]),
                      poly_order=1, n_samples=n)
    key = jax.random.PRNGKey(0)
    f = jax.jit(lambda k: model_pdf(k, jnp.asarray(theta, jnp.float32),
                                    spec, TUNL_SSA_CSI.cell_to_zero))
    ours = [np.asarray(f(jax.random.fold_in(key, i))) for i in range(reps)]

    def norm(h):
        h = np.asarray(np.mean(h, axis=0), np.float64)
        return h / h.sum()

    l1 = np.abs(norm(ref) - norm(ours)).sum()
    # MC floor at 50k x 6 is ~0.007; 3x margin
    assert l1 < 0.02, l1
