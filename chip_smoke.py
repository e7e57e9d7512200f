#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``icebergs_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile-out DIR]

Phases, one line each:

1. environment: a CUDA device must be present (exit 1 otherwise); prints
   the card's name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from ``icebergs_tpu_torch/csrc``;
3. kernels: K1 (column permute), K2 (contact extraction) and K3 (spread
   segment sums) against their plain PyTorch versions on the card, at the
   shapes the headline world gives them, with both times;
4. cross-check: a 50k-berg world runs 2 steps on the card and, with the
   plain versions, on a CPU copy; integer outputs must match exactly,
   floats within a stated tolerance;
5. the slice: the headline world of ``bench.py`` (1M bergs, 512x512 grid
   of 2 km cells, contacts, melt, rolling, reproducible spreading, swirl
   forcing) through ``make_multi_step`` for 8 steps after a warm-up,
   timed over 3 windows, with every kernel's launch count.

The last two lines are a JSON object with each kernel's numbers and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without them.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
N_HEAD, NX_HEAD, DXY = 1_000_000, 512, 2000.0
N_CROSS, NX_CROSS = 50_000, 128
INNER = 8
# float tolerance of the card-vs-CPU cross-check: both sides round every
# multiply and add separately (the kernels are built with -fmad=false),
# so they differ only where the CPU and CUDA libraries round sin/cos/pow
# differently (~1 ulp), amplified at most ~100x over 2 steps by the
# contact springs
CROSS_RTOL, CROSS_ATOL_SCALE = 1e-5, 2e-5


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def require(cond, msg: str):
    if not cond:
        fail(msg)


def headline_world(ibp, torch, n, nx, device, seed=0):
    """The world of bench.py:43-72 at n bergs on an nx x nx grid."""
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=45.0,
        dt=600.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
        use_new_predictive_corrective=True, allow_bergs_to_roll=True,
        fused_fallback_cap=2048)
    grid = ibp.make_uniform_grid(nx, nx, 0., 0., DXY, DXY,
                                 grid_is_latlon=False, device=device)
    frc = ibp.swirl_forcing(nx, nx, DXY, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                            device=device)
    import numpy as np
    rng = np.random.RandomState(seed)
    lon = rng.uniform(2 * DXY, (nx - 2) * DXY, n)
    lat = rng.uniform(2 * DXY, (nx - 2) * DXY, n)
    st = ibp.create_bergs(n, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(torch, x, y):
    if x.dtype == torch.int32:
        return float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
    return float((x.to(torch.float64) - y.to(torch.float64)).abs().max())


def phase_kernels(ibp, torch, device):
    """Each kernel against its plain version at headline shapes."""
    from icebergs_tpu_torch.ops import pack, extract, segment_spread as ss
    from icebergs_tpu_torch.ops import sorted as srt, thermo
    from icebergs_tpu_torch.ops.fused_contact import contact_features
    from icebergs_tpu_torch.ops.interp_table import interp_cell_table
    import dataclasses

    cfg, grid, frc, st0 = headline_world(ibp, torch, N_HEAD, NX_HEAD,
                                         device)
    ncells = grid.nx * grid.ny
    # K1 at the re-sort's shape: every non-uniform column of the
    # unsorted state moved by the (cell, id) order
    key = torch.where(st0.alive, st0.jne * grid.nx + st0.ine,
                      ncells).to(torch.int32)
    order = srt.lex_cell_id_order(key, st0.id_cnt, st0.id_ij)
    skip = set(srt.uniform_state_fields(cfg)) | {"id_cnt", "id_ij",
                                                 "alive"}
    R = torch.stack([pack.to_bits(getattr(st0, f.name))
                     for f in dataclasses.fields(st0)
                     if f.name not in skip])
    k1 = pack.permute_cols_u32(R, order)
    k1p = pack.permute_cols_u32_plain(R, order)
    require(torch.equal(k1, k1p), "K1 differs from R[:, idx] (re-sort)")
    # ... and at the table interpolation's shape
    tbl = interp_cell_table(grid, frc, cfg)
    tbl = torch.cat([tbl, tbl.new_zeros(tbl.shape[0], 1)], 1)
    tbits = tbl.view(torch.int32)
    require(torch.equal(pack.permute_cols_u32(tbits, key),
                        pack.permute_cols_u32_plain(tbits, key)),
            "K1 differs from R[:, idx] (table)")
    res = {"permute_cols_u32": dict(
        err=max_abs_err(torch, k1, k1p),
        ms=cuda_ms(torch, lambda: pack.permute_cols_u32(R, order)),
        plain_ms=cuda_ms(torch, lambda: pack.permute_cols_u32_plain(
            R, order), reps=5),
        note=(f"C={R.shape[0]} N={R.shape[1]}; table C=64: "
              f"{cuda_ms(torch, lambda: pack.permute_cols_u32(tbits, key)):.3f}"
              f" ms"))}

    # K2 on the sorted slab
    st, cs = srt.sort_state_by_cell(st0, grid)
    PT, key_s = contact_features(st, grid, cfg)
    out, bad_block = extract.extract_sorted(
        PT, key_s, cs, grid, cfg, block_n=128, window=cfg.fused_window)
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, 128,
                                           cfg.fused_window)
    outp = extract.extract_sorted_plain(PT, cs, c_lo, c_hi, bad, 128,
                                        float(cfg.contact_distance))
    ints = [extract.EX_CNT, extract.EX_VMIN, extract.EX_VMAX]
    require(torch.equal(out[ints], outp[ints]),
            "K2 count / min / max slot differ from the plain version")
    good = ~bad_block
    require(torch.equal(out[:, good], outp[:, good]),
            "K2 features differ from the plain version")
    res["extract_sorted"] = dict(
        err=max_abs_err(torch, out, outp),
        ms=cuda_ms(torch, lambda: extract.extract_sorted(
            PT, key_s, cs, grid, cfg, block_n=128,
            window=cfg.fused_window)),
        plain_ms=cuda_ms(torch, lambda: extract.extract_sorted_plain(
            PT, cs, c_lo, c_hi, bad, 128, 0.0), reps=2),
        note=(f"N={N_HEAD} bad_blocks={int(bad.sum())}/{bad.numel()} "
              f"engaged_rows={int((outp[extract.EX_CNT] > 0).sum())}"))

    # K3 on the sorted slab with the thermodynamics' melt columns
    st_t, melt = thermo.thermodynamics(st, grid, frc, cfg)
    _, rows = ss.build_rows(st_t, grid, frc, cfg, melt.deferred_cols[:3],
                            key_alive=st.alive)
    rows_s = torch.stack(rows)
    tblc = ss.cell_tables(grid)
    S, sbad = ss.segment_spread_sums(rows_s, cs, tblc, cfg, 3)
    Sp = ss.segment_spread_sums_plain(rows_s, cs, tblc, cfg)
    require(torch.equal(S, Sp), "K3 sums differ from the plain version")
    res["segment_spread_sums"] = dict(
        err=max_abs_err(torch, S, Sp),
        ms=cuda_ms(torch, lambda: ss.segment_spread_sums(
            rows_s, cs, tblc, cfg, 3)),
        plain_ms=cuda_ms(torch, lambda: ss.segment_spread_sums_plain(
            rows_s, cs, tblc, cfg), reps=5),
        note=(f"ncells={ncells} R={rows_s.shape[0]} window_bad="
              f"{int(sbad.sum())} max_occupancy="
              f"{int((cs[1:] - cs[:-1]).max())}"))
    return res


def phase_cross(ibp, torch, device):
    """2 steps of a mid-size world on the card and on a CPU copy."""
    import numpy as np
    from icebergs_tpu_torch.ops.sorted import starts_from_sorted_key

    cfg, grid, frc, st = headline_world(ibp, torch, N_CROSS, NX_CROSS,
                                        device, seed=1)
    cpu = torch.device("cpu")
    outs = {}
    for dev in (device, cpu):
        multi = ibp.make_multi_step(grid.to(dev), cfg, 2, with_stats=True)
        s, ov, fb, acc = multi(st.to(dev), frc.to(dev))
        outs[dev.type] = (ibp.to_numpy(s), int(ov), int(fb),
                          acc.cpu().numpy())
    (g, gov, gfb, gacc), (c, cov, cfb, cacc) = outs["cuda"], outs["cpu"]
    require((gov, gfb) == (cov, cfb),
            f"counters differ: card {(gov, gfb)} cpu {(cov, cfb)}")
    for name in ("alive", "id_cnt", "id_ij", "ine", "jne"):
        require(np.array_equal(g[name], c[name]),
                f"{name} differs between the card and the CPU")
    ncells = grid.nx * grid.ny
    keys = [np.where(x["alive"], x["jne"] * grid.nx + x["ine"], ncells)
            for x in (g, c)]
    starts = [starts_from_sorted_key(torch.as_tensor(k).int(), ncells)
              for k in keys]
    require(torch.equal(*starts), "cell_starts differ")
    alive = g["alive"]
    worst = 0.0
    for name, gv in g.items():
        if gv.dtype.kind != "f":
            continue
        a, b = gv[alive].astype(np.float64), c[name][alive]
        scale = max(np.abs(b).max(), 1e-30) if b.size else 1.0
        tol = CROSS_RTOL * np.abs(b) + CROSS_ATOL_SCALE * scale
        require(np.all(np.abs(a - b) <= tol), f"{name} beyond tolerance")
        worst = max(worst, float((np.abs(a - b) / scale).max())
                    if b.size else 0.0)
    acc_err = float(np.abs(gacc - cacc).max() / max(np.abs(cacc).max(),
                                                    1e-30))
    require(acc_err <= CROSS_ATOL_SCALE, f"coupler fields rel {acc_err}")
    return dict(n=N_CROSS, overflow=gov, fallback=gfb,
                worst_scaled_err=worst, coupler_rel_err=acc_err)


def phase_slice(ibp, torch, device, kernels, profile_out):
    """The headline world through make_multi_step."""
    from icebergs_tpu_torch.diag import berg_chksum

    cfg, grid, frc, st = headline_world(ibp, torch, N_HEAD, NX_HEAD, device)
    mass0 = float(torch.where(st.alive, st.mass * st.mass_scaling,
                              0.).double().sum())
    for _ in range(4):
        multi = ibp.make_multi_step(grid, cfg, INNER, with_stats=True)
        out = multi(st, frc)                        # warm-up
        torch.cuda.synchronize()
        if int(out[1]) == 0:
            break
        cap = min(4 * cfg.fused_fallback_cap, N_HEAD)
        print(f"slice: fallback cap overran (dropped={int(out[1])}); "
              f"growing to {cap}")
        cfg = cfg.replace(fused_fallback_cap=cap)
    require(int(out[1]) == 0, f"contact_overflow {int(out[1])} != 0")

    for fn in kernels.values():
        fn.launches = 0
    times = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = multi(st, frc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / INNER)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
    s, ov, fb, acc = out
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the main path")

    # host syncs inside one step (torch's sync debug mode warns on each)
    step = ibp.make_multi_step(grid, cfg, 1, with_stats=True)
    s1 = step(s, frc)[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        step(s1, frc)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    floats = [getattr(s, f) for f in ("lon", "lat", "uvel", "vvel", "mass",
                                       "thickness", "width", "length",
                                       "xi", "yj")]
    finite = all(bool(torch.isfinite(x[s.alive]).all()) for x in floats)
    require(finite, "non-finite state")
    require(bool(torch.isfinite(acc).all()), "non-finite coupler fields")
    mass1 = float(torch.where(s.alive, s.mass * s.mass_scaling,
                              0.).double().sum())
    require(mass1 <= mass0, f"total mass grew {mass0} -> {mass1}")
    chk, n_alive = berg_chksum(s)
    require(int(n_alive) > 0, "no bergs alive")
    syncs = sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                    for r in rec})
    res = dict(ms_per_step=statistics.median(times), windows_ms=times,
               contact_overflow=int(ov), contact_fallback=int(fb),
               berg_chksum=int(chk), alive=int(n_alive), mass0=mass0,
               mass1=mass1, host_syncs_per_step=len(rec),
               sync_kinds=syncs,
               fallback_cap=cfg.fused_fallback_cap,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile_out:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            multi(st, frc)
            torch.cuda.synchronize()
        pathlib.Path(profile_out).mkdir(parents=True, exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        (pathlib.Path(profile_out) / "slice_profile.txt").write_text(table)
        prof.export_chrome_trace(str(pathlib.Path(profile_out)
                                     / "slice_trace.json"))
    return res, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-out", default=None,
                    help="directory for a profiler table and trace")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import icebergs_tpu_torch as ibp
    from icebergs_tpu_torch import cuda_build
    from icebergs_tpu_torch.ops import extract, pack, segment_spread
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[1 env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.library()
    log = cuda_build.library_path().with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    print(f"[2 build] {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.library_path().name}); " + " | ".join(regs))

    kres = phase_kernels(ibp, torch, device)
    for name, r in kres.items():
        print(f"[3 kernel] {name}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, max_abs_err {r['err']} "
              f"({r['note']})")

    cres = phase_cross(ibp, torch, device)
    print(f"[4 cross-check] {json.dumps(cres)}")

    kernels = {"permute_cols_u32": pack.permute_cols_u32,
               "extract_sorted": extract.extract_sorted,
               "segment_spread_sums": segment_spread.segment_spread_sums}
    sres, launches = phase_slice(ibp, torch, device, kernels,
                                 args.profile_out)
    print(f"[5 slice] {json.dumps(sres)}")

    source = {"permute_cols_u32": ("permute_cols.cu",
                                   "icebergs_tpu/ops/pallas_pack.py:30"),
              "extract_sorted": ("extract_sorted.cu",
                                 "icebergs_tpu/ops/pallas_prepass.py:625"),
              "segment_spread_sums": ("segment_spread.cu",
                                      "icebergs_tpu/ops/pallas_spread.py:136")}
    rows = [{"name": k, "route": "cuda",
             "source": f"icebergs_tpu_torch/csrc/{source[k][0]}",
             "replaces": source[k][1], "launches": launches[k],
             "max_abs_err": kres[k]["err"], "ms": kres[k]["ms"],
             "plain_ms": kres[k]["plain_ms"]} for k in kernels]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
