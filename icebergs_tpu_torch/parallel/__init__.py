"""The multi-device layer: tiles, halos, particle migration and the
tiled coupling step and run (:mod:`.domain`), and the process group
(:mod:`.multihost`).  Counterpart of ``icebergs_tpu/parallel/``."""
