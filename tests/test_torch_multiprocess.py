"""The port's tiled step and run across ranks: 2 ``gloo`` processes
(``torch.multiprocessing``, ``tcp://127.0.0.1:<free port>``), one tile
each, against 2 tiles in one process, bit for bit.

The ranks join through :func:`icebergs_tpu_torch.parallel.multihost.
initialize_multihost` and build their worlds from
``tests/torch_parallel_worlds.py``; the ring sends the exchange buffers by
``dist.batch_isend_irecv`` and gathers the tiles' sums by
``dist.all_gather``, adding them in tile order as one process does.
Compared: every field of every slot of each rank's tile after a halo
fill and 8 ``fused3`` steps of the colliding world, the owned count and
mass and every exchange counter; then after 12 steps of the tiled run on
the calving world, the tile, the budgets, the spawn counts and the
interval scalars.  Each rank writes the restart file of its own tile
after the steps (``write_restart_bergs_tiled`` with the rank's ring, the
file half of ``tests/test_multiprocess.py``): the two ranks' files are
byte for byte the one-process files and read back into the whole state.
The test joins the ranks with its own 120 s limit, then terminates them
and fails.
"""

import os
import socket

import numpy as np
import pytest
import torch

import torch_parallel_worlds as W

STEPS, RUN_STEPS = 8, 12
LIMIT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scenario(restart_dir):
    """The step and the run on this process's tiles: per local tile its
    fields, and the sums and counters as numpy; the step's tiles' restart
    files written into ``restart_dir``."""
    from icebergs_tpu_torch.io import restart as rio
    from icebergs_tpu_torch.parallel import domain as dd
    cfg, grid, frc = W.world(W.INTERACTIVE, dict(uo=0.4, sst=2.0))
    st = W.bergs(grid, *W.pair_positions())
    tiles, nb, tm, ovs = W.tiled_steps(cfg, frc, st, (2,), STEPS,
                                       **W.FUSED3_STEP)
    out = dict(step_tiles=W.tile_fields(tiles), nbergs=int(nb),
               total_mass=tm.numpy(), step_overflow=[o.numpy() for o in ovs],
               restarts=rio.write_restart_bergs_tiled(
                   os.path.join(restart_dir, "icebergs.res.nc"), tiles, cfg,
                   ring=dd.Ring((2,))))
    cfg, grid, frc = W.world(W.CALVING, dict(uo=0.2, sst=1.0))
    import icebergs_tpu_torch as ibp
    ms, outs, ovs = W.tiled_run(cfg, frc, ibp.empty_state(96, device=W.CPU),
                                (2,), RUN_STEPS, calving=W.calving_field(),
                                cap=48, seed=3)
    out.update(run_tiles=W.tile_fields([m.bergs for m in ms]),
               run_overflow=[o.numpy() for o in ovs],
               run_scalars=[{f: getattr(o, f).numpy() for f in (
                   "nbergs", "nbergs_calved", "net_calving_used",
                   "calving_to_bergs", "net_melt_kg", "contact_overflow")}
                   for o in outs],
               budgets=[{f: v.numpy() for f, v in o.budgets._asdict().items()
                         if v is not None} for o in outs],
               spread_mass=[o.spread_mass.numpy() for o in outs])
    return out


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from icebergs_tpu_torch.parallel import multihost as mh
    assert mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank,
                                   backend="gloo") == 2
    try:
        ring = mh.make_global_mesh()
        assert ring.tiles == [rank] and mh.local_tile_range(ring) == (
            rank, rank + 1)
        torch.save(_scenario(os.path.join(out_dir, "ranks")),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_match_one_process(tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    (tmp_path / "ranks").mkdir()
    (tmp_path / "one").mkdir()
    procs = [ctx.Process(target=_rank, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(LIMIT_S)
        hung = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not hung, f"ranks {hung} still running after {LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]

    torch.set_num_threads(1)
    one = _scenario(str(tmp_path / "one"))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for r, got in enumerate(ranks):
        for key in ("step_tiles", "run_tiles"):
            assert len(got[key]) == 1
            W.assert_bitwise(got[key][0], one[key][r])
        assert got["nbergs"] == one["nbergs"] == 10
        assert got["total_mass"].tobytes() == one["total_mass"].tobytes()
        for key in ("step_overflow", "run_overflow"):
            for a, b in zip(got[key], one[key]):
                np.testing.assert_array_equal(a[0], b[r])
                assert not b.any()
        for a, b in zip(got["run_scalars"] + got["budgets"],
                        one["run_scalars"] + one["budgets"]):
            for f in b:
                assert a[f].tobytes() == b[f].tobytes(), f
        for a, b in zip(got["spread_mass"], one["spread_mass"]):
            assert np.array_equal(a[0], b[r])
    assert sum(int(s["nbergs_calved"]) for s in one["run_scalars"]) > 0
    # each rank wrote its own tile's file; their union is the state
    names = [[os.path.basename(p) for p in r["restarts"]] for r in ranks]
    assert names == [["icebergs.res.nc.0000"], ["icebergs.res.nc.0001"]]
    assert [os.path.basename(p) for p in one["restarts"]] == sum(names, [])
    for name in sum(names, []):
        assert ((tmp_path / "ranks" / name).read_bytes()
                == (tmp_path / "one" / name).read_bytes()), name
    from icebergs_tpu_torch.io import restart as rio
    cfg, grid, _ = W.world(W.INTERACTIVE, {})
    back = rio.read_restart_bergs_tiled(
        str(tmp_path / "ranks" / "icebergs.res.nc"), 64, grid, cfg,
        device=W.CPU)
    assert int(back.alive.sum()) == one["nbergs"] == 10
