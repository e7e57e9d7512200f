"""The benchmark of the PyTorch and CUDA port (``icebergs_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything is found by name: a configuration in
``configs/<config>.json``, a traffic mix in ``traffic/<traffic>.json``
(its entry and episode), a cell's limits in
``workloads/<cell>.json``, an entry's stepping in ``entries/<entry>.py``, a
metric's reader in ``metrics/<metric>.py`` (or the file of the name's
stem), the inputs of the world a configuration names in
``worlds/<world>.py`` and the plain reference of an entry in
``reference/<entry>.py``.  Nothing here imports JAX or the JAX package,
and the reference imports nothing of the port.
"""
