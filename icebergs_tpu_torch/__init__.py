"""icebergs_tpu_torch: the iceberg model on PyTorch and CUDA.

A port of ``icebergs_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch, with the TPU's Pallas kernels rewritten as CUDA
kernels for NVIDIA Hopper (``csrc/``, built by :mod:`.cuda_build` at
first use).  Ported so far: the coupled entry
:class:`~.api.IcebergsModel` (``icebergs_run``: calving buckets and
spawning, footloose calving, the budgets and checksums of :mod:`.diag`);
behind :func:`make_multi_step` the production fast lane (the
persistent-sorted coupling step with contacts, thermodynamics and
spreading), the per-step path (``make_step``; the ``fused3``, ``fused``,
``buckets`` and ``sorted`` contact searches, bonded springs, footloose),
the MTS/DEM step of bonded conglomerates (Part-1 fused search or the
candidate tables, force convergence, the substep loop as one kernel or
as the scan with the frozen pair list, outer-step fracture), and the
options of those modules: Verlet and RK4 stepping, the table,
sorted-frame and per-field (``interp_flds``) interpolations with coastal
and tidal drift, K2's in-kernel pair epilogue, every slot-sum method of
the reproducing spreading and the plain scatters without it, and the
re-sort's transport knobs.  Every path runs on Cartesian, regular
lat-lon (periodic in ``Lx``, latitude-dependent Coriolis, the polar
tangent plane) and curvilinear or tripolar grids
(:func:`make_curvilinear_grid`, :func:`make_tripolar_grid`; the
point-in-quad walk of :mod:`.geometry`).  The stand-alone driver
(``python -m icebergs_tpu_torch.driver``) reads the reference's
namelists and restarts and writes restarts, trajectories and the
diagnostics' history file (:mod:`.io`, :mod:`.diagnostics`), with the
A68 hindcast's forcing files.  Hexagonal elements (the hexagon spreading
of :mod:`.ops.hexagon`, the bond-oriented hexagons and the hexagonal DEM
faces) run on every path.  The multi-device layer (:mod:`.parallel`)
runs the tiled coupling step and run and the tiled MTS step in 1-D and
2-D layouts: tiles with their halos, particle migration and halo copies
through a ring that rotates a list of tiles in one process or sends
between ``torch.distributed`` ranks, conglomerates replicated to every
tile they overlap, the replicas' state refreshed at every substep, and
the tripolar fold; the tiled restart and trajectory files are
:mod:`.io`'s.
Module names mirror the JAX package; each module names its counterpart.

Importing this package imports torch and never jax.  On CPU tensors
every kernel runs as its plain PyTorch version; on CUDA tensors the
kernels launch.
"""

from .api import IcebergsModel, ModelState, RunOutputs, prepare_forcing
from .config import NCLASSES, IcebergsConfig, check_ported
from .convert import (config_from_dict, forcing_from_numpy,
                      grid_from_numpy, state_from_numpy, to_numpy)
from .forcing import (Forcing, forcing_from_arrays, swirl_forcing,
                      uniform_forcing)
from .grid import (Grid, make_curvilinear_grid, make_tripolar_grid,
                   make_uniform_grid, pos_to_cell)
from .model import (StepDiags, interp_to_bergs, make_multi_step,
                    make_persistent_multi_step, make_step, step_dynamics)
from .state import (BergState, allocate_slots, create_bergs, empty_state,
                    grow_capacity)

__all__ = [
    "IcebergsModel", "ModelState", "RunOutputs", "prepare_forcing",
    "IcebergsConfig", "NCLASSES", "check_ported", "config_from_dict",
    "forcing_from_numpy", "grid_from_numpy", "state_from_numpy",
    "to_numpy", "Forcing", "forcing_from_arrays", "swirl_forcing",
    "uniform_forcing", "Grid", "make_curvilinear_grid",
    "make_tripolar_grid", "make_uniform_grid", "pos_to_cell", "StepDiags",
    "interp_to_bergs", "make_multi_step", "make_persistent_multi_step",
    "make_step", "step_dynamics", "BergState", "allocate_slots",
    "create_bergs", "empty_state", "grow_capacity",
]
