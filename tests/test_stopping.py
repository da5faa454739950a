"""Bethe stopping + transport vs scipy dopri5 / f64 oracles."""
import numpy as np
import scipy.constants as sc
from scipy.integrate import ode
from scipy.interpolate import RectBivariateSpline

from mcmctoffitting_tpu.config import SIMULTFIT_X_BINNING, x_binning_onebd
from mcmctoffitting_tpu.constants import masses, physics
from mcmctoffitting_tpu.ops.stopping import (FIXED_FACTOR, BetheStopping,
                                             StoppingTable, d2_gas_stopping,
                                             havar_stopping, rk4_transport)


def oracle_dedx_d2(e, rho=8.565e-5, excitation=19.2e-3):
    """f64 oracle of the reference simpleBethe.dEdx for the D2 gas cell
    (utilities/ionStopping.py:78-97), written independently here."""
    n_e = sc.Avogadro * 1 * rho / (2 * 1.0)
    v = np.sqrt(2 * e / masses.deuteron) * physics.speed_of_light
    leading = 4 * np.pi * 1 ** 2 / (masses.electron
                                    * physics.speed_of_light ** 2 * v ** 2)
    log_arg = (2 * masses.electron / physics.speed_of_light ** 2 * v ** 2
               / excitation)
    return -leading * FIXED_FACTOR * n_e * np.log(log_arg)


def test_dedx_matches_oracle():
    model = d2_gas_stopping()
    e = np.linspace(200.0, 2400.0, 45)
    got = np.asarray(model.dedx(e.astype(np.float64)))
    np.testing.assert_allclose(got, oracle_dedx_d2(e), rtol=5e-5)  # f32 eval


def test_dedx_magnitude_sane():
    # deuterons in 0.5 atm D2: stopping of order -1 to -60 keV/cm
    model = d2_gas_stopping()
    val = float(model.dedx(np.array(900.0)))
    assert -100.0 < val < -0.1


def test_havar_is_multimaterial():
    h = havar_stopping()
    assert len(h.materials) == 8
    # much denser than gas -> stopping orders of magnitude larger
    assert float(h.dedx(np.array(900.0))) < 1e4 * float(
        d2_gas_stopping().dedx(np.array(900.0)))


def test_rk4_transport_matches_dopri5():
    model = d2_gas_stopping()
    x_centers = SIMULTFIT_X_BINNING.centers  # 10 bins over 2.86 cm
    # physical region: E0 < ~430 keV plunges into the unphysical Bethe
    # minimum (~18 keV) before the cell exit, where both integrators are
    # meaningless (the device path freezes such samples at the 20 keV floor)
    e0 = np.linspace(450.0, 1200.0, 64)

    # scipy dopri5 oracle with the vector ODE state, like simultFit.py:256-258
    solver = ode(lambda x, y: oracle_dedx_d2(y)).set_integrator("dopri5")
    solver.set_initial_value(e0)
    want = np.stack([solver.integrate(x) for x in x_centers])

    got = np.asarray(rk4_transport(model.dedx, e0.astype(np.float64),
                                   x_centers, n_substeps=4))
    # f32 device eval; energies are O(1000) keV -> allow ~0.05 keV absolute
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)


def test_stopping_table_matches_rectbivariatespline():
    """StoppingTable.eval_stopped vs the reference betheApprox construction
    (utilities/ionStopping.py:102-136) built with scipy, both against the
    same grid config as tests/csi_oneBD.py:293-295."""
    model = d2_gas_stopping(rho=4 * 8.565e-5)
    x_centers = x_binning_onebd(10).centers
    table = StoppingTable.build(model, (100.0, 2400.0, 100.0), x_centers)

    # scipy oracle: dopri5 rows + RectBivariateSpline, like the reference
    e0_grid = np.arange(100.0, 2400.0, 100.0)
    rows = []
    for ez in e0_grid:
        solver = ode(lambda x, y: oracle_dedx_d2(y, rho=4 * 8.565e-5))
        solver.set_integrator("dopri5").set_initial_value([ez])
        rows.append([solver.integrate(x)[0] for x in x_centers])
    z = np.array(rows)
    spline = RectBivariateSpline(e0_grid, x_centers, z)

    queries = np.linspace(150.0, 2250.0, 31)
    got = np.asarray(table.eval_stopped(queries.astype(np.float64)))
    want = np.stack([spline(q, x_centers)[0] for q in queries])
    # two independent spline families over the same data; sub-eV agreement
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-3)


def test_transport_is_monotone_in_e0():
    model = d2_gas_stopping()
    out = np.asarray(rk4_transport(model.dedx,
                                   np.array([500.0, 800.0, 1100.0]),
                                   SIMULTFIT_X_BINNING.centers))
    # higher E0 stays higher; energy decreases with depth
    assert np.all(np.diff(out, axis=1) > 0)
    assert np.all(np.diff(out, axis=0) < 0)


def test_bethe_with_material_functional():
    base = BetheStopping(materials=())
    m = base.with_material(1.0, 2.0, 8.565e-5, 19.2e-3)
    assert len(base.materials) == 0 and len(m.materials) == 1


def test_simult_table_matches_rk4_transport():
    """The simult table fast path must reproduce the RK4/ODE transport to
    well below physical relevance over the physical beam-energy range
    (the reference's own betheApprox validation strategy,
    tests/testStoppingApproximation.py:117-144)."""
    import jax.numpy as jnp
    from mcmctoffitting_tpu.models import simult
    from mcmctoffitting_tpu.ops.stopping import rk4_transport

    spec = simult.default_spec(n_samples=16)
    assert spec.transport == "table" and spec.stopping_table is not None
    e0 = jnp.linspace(25.0, 1925.0, 4001)
    want = np.asarray(rk4_transport(spec.stopping.dedx, e0,
                                    spec.x_binning.centers, n_substeps=4))
    got = np.asarray(spec.stopping_table.eval_stopped(e0)).T  # (M, N)
    err = np.abs(got - want)
    # inside the eD histogram range the surrogate must be exact for
    # physics purposes; below it (the near-stopping region, where dE/dx
    # steepens toward the 20 keV floor and every sample is dropped by the
    # 200 keV histogram floor anyway) a ~keV spline ripple is tolerated
    assert err[want >= 200.0].max() < 0.15, err[want >= 200.0].max()
    assert err.max() < 10.0, err.max()
