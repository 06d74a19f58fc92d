"""Physical constants (the same values as ``lynx_tpu.constants``).

Two subtly different electron rest energies are kept, as in the JAX
package, so that numerical parity holds:

* ``REST_ENERGY_EV``   = m_e c^2 / e, used by the R-matrix functions;
* ``ELECTRON_MASS_EV`` = CODATA "electron mass energy equivalent in MeV" * 1e6,
  used by beam relativistics.
"""

from scipy import constants
from scipy.constants import physical_constants

#: Electron rest energy in eV, computed from m_e c^2 / e.
REST_ENERGY_EV: float = (
    constants.electron_mass
    * constants.speed_of_light**2
    / constants.elementary_charge
)

#: Electron rest energy in eV from the CODATA table.
ELECTRON_MASS_EV: float = (
    physical_constants["electron mass energy equivalent in MeV"][0] * 1e6
)

#: Speed of light in m/s.
SPEED_OF_LIGHT: float = constants.speed_of_light
