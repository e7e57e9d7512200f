"""Time the build of the PyTorch port's CUDA kernel library.

Compiles ``icebergs_tpu_torch/csrc/*.cu`` two ways, each into a fresh
directory so that no built library is reused: one ``nvcc -c`` at a time
followed by the link ("serial"), and as
:func:`icebergs_tpu_torch.cuda_build.build` does it, one ``nvcc -c`` per
source all started together, then the link ("parallel").  Runs the two
in the order parallel, serial, serial, parallel and prints one JSON line
with every time.  Needs ``nvcc``; run from anywhere:

    python3 tools/time_kernel_build.py
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from icebergs_tpu_torch import cuda_build as cb  # noqa: E402


def serial(out: pathlib.Path) -> None:
    objs = []
    for p in (p for p in cb._sources() if p.suffix == ".cu"):
        objs.append(str(out / f"{p.stem}.o"))
        subprocess.run([cb._nvcc(), *cb.COMPILE_FLAGS, "-c", "-o", objs[-1],
                        str(p)], check=True, capture_output=True)
    subprocess.run([cb._nvcc(), *cb.ARCH_FLAGS, "-shared", "-o",
                    str(out / "lib.so"), *objs], check=True,
                   capture_output=True)


def parallel(out: pathlib.Path) -> None:
    cb.BUILD_DIR = out
    cb.build()


def main() -> int:
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    base = cb.BUILD_DIR
    times = {"serial_s": [], "parallel_s": []}
    for name, fn in (("parallel", parallel), ("serial", serial),
                     ("serial", serial), ("parallel", parallel)):
        with tempfile.TemporaryDirectory(dir=base) as d:
            t0 = time.perf_counter()
            fn(pathlib.Path(d))
            times[f"{name}_s"].append(time.perf_counter() - t0)
    cb.BUILD_DIR = base
    n = sum(p.suffix == ".cu" for p in cb._sources())
    print(json.dumps({"sources": n, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
