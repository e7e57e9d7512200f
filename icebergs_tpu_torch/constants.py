"""Physical constants of the iceberg model.

A copy of ``icebergs_tpu/constants.py`` (the parameter block of the
reference, ``src/icebergs.F90:68-81``): importing the JAX package would
import jax.  Values are bit-identical.
"""

import math

PI = math.pi
PI_180 = PI / 180.0          # degrees -> radians        (icebergs.F90:68)
R180_PI = 180.0 / PI         # radians -> degrees        (icebergs.F90:69)

RHO_ICE = 916.7              # fresh ice density @0C, kg/m^3   (icebergs.F90:71)
RHO_WATER = 999.8            # fresh water density, kg/m^3     (icebergs.F90:72)
RHO_AIR = 1.1                # air density, kg/m^3             (icebergs.F90:73)
RHO_SEAWATER = 1025.0        # surface seawater density        (icebergs.F90:74)
GRAVITY = 9.8                # m/s^2                           (icebergs.F90:75)

CD_AV = 1.3                  # vertical berg/atmos drag        (icebergs.F90:76)
CD_AH = 0.0055               # horizontal berg/atmos drag      (icebergs.F90:77)
CD_WV = 0.9                  # vertical berg/ocean drag        (icebergs.F90:78)
CD_WH = 0.0012               # horizontal berg/ocean drag      (icebergs.F90:79)
CD_IV = 0.9                  # vertical berg/sea-ice drag      (icebergs.F90:80)

# FMS constants used by the reference (fms/constants): Earth's rotation rate
# and latent heat of fusion.
OMEGA = 7.292e-5             # Earth's rotation rate, 1/s
HLF = 3.34e5                 # latent heat of fusion, J/kg (FMS constants value)

# Driver-visible defaults
REARTH_DEFAULT = 6360000.0   # namelist default Rearth (icebergs_framework.F90)
