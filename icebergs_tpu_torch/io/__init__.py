"""File I/O of the port: namelists, restarts, trajectories and the A68
forcing files (counterpart of ``icebergs_tpu/io``)."""
