"""Run one cell of the port's benchmark once:

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs the CUDA card(s) the cell asks for; without
them it exits with a non-zero code and prints no result. Every cache the run
builds stays inside the checkout: the kernel libraries under
``build/repro_torch_kernels/`` (the program's own), CUDA's JIT cache under
``build/portbench-cuda-cache/``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "portbench-cuda-cache")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
