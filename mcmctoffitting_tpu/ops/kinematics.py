"""Two-body reaction kinematics and time-of-flight primitives.

JAX-native (pure jnp, shape-polymorphic, f32-friendly) equivalents of the
reference kernels ``getDDneutronEnergy`` (``utilities/utilities.py:48-62``)
and ``getTOF`` (``utilities/utilities.py:64-73``).  Both are closed-form and
fully vectorized; under jit they fuse into surrounding elementwise chains on
the VPU.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..constants import masses, physics, q_values


def dd_neutron_energy(deuteron_energy, lab_angle_deg=0.0):
    """Energy (keV) of neutrons from d(d,n)3He at a lab angle.

    Iliadis r/s form: En = (r + sqrt(r^2 + s))^2 with
    r = sqrt(m_d m_n E_d) cos(theta) / (m_n + m_He3),
    s = (E_d (m_He3 - m_d) + Q m_He3) / (m_n + m_He3).
    Matches reference ``utilities/utilities.py:48-62`` bit-for-bit in f64.
    """
    e_d = jnp.asarray(deuteron_energy)
    theta = lab_angle_deg * jnp.pi / 180.0
    r = (jnp.sqrt(masses.deuteron * masses.neutron * e_d)
         / (masses.neutron + masses.he3) * jnp.cos(theta))
    s = ((e_d * (masses.he3 - masses.deuteron) + q_values.ddn * masses.he3)
         / (masses.neutron + masses.he3))
    sqrt_en = r + jnp.sqrt(r * r + s)
    return sqrt_en * sqrt_en


def tof(mass, energy, distance):
    """Non-relativistic time of flight in ns.

    mass in keV/c^2, energy in keV, distance in cm
    (reference ``utilities/utilities.py:64-73``): v = c sqrt(2E/m), t = d/v.
    """
    velocity = physics.speed_of_light * jnp.sqrt(2.0 * jnp.asarray(energy) / mass)
    return distance / velocity


def velocity_from_energy(mass, energy):
    """Non-relativistic speed in cm/ns for mass keV/c^2, energy keV."""
    return physics.speed_of_light * jnp.sqrt(2.0 * jnp.asarray(energy) / mass)


def dd_neutron_energy_np(deuteron_energy, lab_angle_deg=0.0):
    """Host-side f64 numpy twin of :func:`dd_neutron_energy` for trace-time
    constants (e.g. bin-center tables baked into jitted programs)."""
    import numpy as np
    e_d = np.asarray(deuteron_energy, dtype=np.float64)
    theta = lab_angle_deg * np.pi / 180.0
    r = (np.sqrt(masses.deuteron * masses.neutron * e_d)
         / (masses.neutron + masses.he3) * np.cos(theta))
    s = ((e_d * (masses.he3 - masses.deuteron) + q_values.ddn * masses.he3)
         / (masses.neutron + masses.he3))
    return (r + np.sqrt(r * r + s)) ** 2
