"""Physical constants and experiment geometry registry.

JAX rebuild of the reference constants layer
(``constants/constants.py:10-132`` in gcrich/mcmcTOFfitting). All numeric
values are carried over verbatim; the class-namespace style of the reference
is replaced by frozen dataclasses so geometries are immutable, hashable
(usable as static args under ``jax.jit``) and registrable in a lookup table.

Units follow the reference convention throughout: keV, cm, ns
(``utilities/ionStopping.py:67``, ``constants/constants.py:13``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Physics:
    """Physics constants (reference ``constants/constants.py:10-15``)."""

    speed_of_light: float = 29.9792  # cm/ns
    # scipy.constants.epsilon_0 * 1e-2, in F/cm
    epsilon_0: float = 8.8541878188e-12 * 1e-2
    molar_mass_constant: float = 1.0  # g/mol


@dataclasses.dataclass(frozen=True)
class Masses:
    """Particle masses in keV/c^2 (reference ``constants/constants.py:18-31``)."""

    electron: float = 511.0
    deuteron: float = 1.8756e06
    neutron: float = 939565.0
    proton: float = 938272.084
    he3: float = 2.809414e6
    li7: float = 6535365.77
    be7: float = 6536227.67


@dataclasses.dataclass(frozen=True)
class QValues:
    """Reaction Q values in keV (reference ``constants/constants.py:90-94``)."""

    ddn: float = 3268.914
    lipn: float = -1644.24


@dataclasses.dataclass(frozen=True)
class CellGeometry:
    """Gas-cell + detector geometry for one experimental campaign.

    Mirrors the per-campaign distance namespaces of the reference
    (``constants/constants.py:34-81``).  All distances in cm.
    """

    cell_to_zero: float
    cell_length: float
    zero_deg_length: float
    tip_to_colli: float
    colli_to_zero: float
    delta1: float
    delta2: float
    colli_to_csi: float = 59.45
    csi_to_zero: float = 355.7
    csi_diameter: float = 2.341
    # When set, overrides tip_to_colli + colli_to_zero as the close standoff
    # (the oneBD campaign re-measured it; ``constants/constants.py:74``).
    standoff_close_override: float | None = None

    @property
    def standoff_close(self) -> float:
        if self.standoff_close_override is not None:
            return self.standoff_close_override
        return self.tip_to_colli + self.colli_to_zero

    @property
    def standoff_mid(self) -> float:
        return self.standoff_close + self.delta1

    @property
    def standoff_far(self) -> float:
        return self.standoff_mid + self.delta2

    @property
    def standoff_tunl_runs(self) -> float:
        """'production' standoff (reference ``constants/constants.py:57``)."""
        return (self.colli_to_csi + self.csi_to_zero + self.csi_diameter
                + self.tip_to_colli)

    def standoff(self, name: str) -> float:
        return {
            "close": self.standoff_close,
            "mid": self.standoff_mid,
            "far": self.standoff_far,
            "production": self.standoff_tunl_runs,
        }[name]


# Jan 2016 CsI QF run at TUNL SSA (``constants/constants.py:37-57``)
TUNL_SSA_CSI = CellGeometry(
    cell_to_zero=518.055,
    cell_length=2.86,
    zero_deg_length=3.81,
    tip_to_colli=148.4,
    colli_to_zero=233.8,
    delta1=131.09,
    delta2=52.39,
)

# "one-BD" CsI QF run at TUNL SSA (``constants/constants.py:59-81``)
TUNL_SSA_CSI_ONEBD = CellGeometry(
    cell_to_zero=518.055,
    cell_length=2.86,
    zero_deg_length=3.81,
    tip_to_colli=148.4,
    colli_to_zero=233.8,
    delta1=412.3 - 351.3,
    delta2=444.5 - 412.3,
    standoff_close_override=351.3,
)


@dataclasses.dataclass(frozen=True)
class TofWindow:
    """TOF histogram window for one standoff (min, max in ns; bin count)."""

    lo: float
    hi: float
    n_bins: int

    @property
    def range(self) -> tuple[float, float]:
        return (self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class TofWindows:
    """2016 COHERENT CsI windows (reference ``constants/constants.py:97-107``)."""

    close: TofWindow = TofWindow(130.0, 175.0, 45)
    mid: TofWindow = TofWindow(175.0, 225.0, 50)
    far: TofWindow = TofWindow(190.0, 260.0, 70)
    production: TofWindow = TofWindow(195.0, 260.0, 65)

    def __getitem__(self, name: str) -> TofWindow:
        return getattr(self, name)


def _onebd_window(lo: float, hi: float) -> TofWindow:
    # nBins = int((max - min) / 4)  (reference ``constants/constants.py:121-123``)
    return TofWindow(lo, hi, int((hi - lo) / 4))


@dataclasses.dataclass(frozen=True)
class TofWindowsOneBD:
    """CsI[Na] one-BD windows (reference ``constants/constants.py:109-124``)."""

    close: TofWindow = _onebd_window(80.0, 180.0)
    mid: TofWindow = _onebd_window(100.0, 200.0)
    far: TofWindow = _onebd_window(120.0, 220.0)

    def __getitem__(self, name: str) -> TofWindow:
        return getattr(self, name)


@dataclasses.dataclass(frozen=True)
class OneBDExperimentConsts:
    """one-BD campaign constants (reference ``constants/constants.py:126-132``)."""

    beam_reference_energy: float = 2490.0  # keV
    gas_cell_attenuation_length: float = 20.0  # cm (~10% flux drop over cell)


physics = Physics()
masses = Masses()
q_values = QValues()
tof_windows = TofWindows()
tof_windows_onebd = TofWindowsOneBD()
onebd_consts = OneBDExperimentConsts()

GEOMETRIES = {
    "tunlSSA_CsI": TUNL_SSA_CSI,
    "tunlSSA_CsI_oneBD": TUNL_SSA_CSI_ONEBD,
}
