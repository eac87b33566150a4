"""One CSV of every bench's rows, PyTorch port of ``benchmarks/run.py``:
``name,us_per_call,derived`` in the reference's order (the paper tables,
the kernels, the planner, the workload scenarios, the fleet scale, the
roofline records).

The kernel rows are timed on the card. With ``--device cpu`` the kernel
section prints one row, ``kernel/NOT_MEASURED,0,needs the card``, as the
roofline section prints ``roofline/NO_DRYRUN_RECORDS`` without records.

  python -m repro_torch.benchmarks.run                          (on the card)
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from repro_torch.benchmarks import (fleet_scale_bench, kernel_bench, paper_tables,
                                        planner_bench, roofline_table, workload_bench)
    from repro_torch.runtime.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu, which "
                         "leaves the kernel rows unmeasured")
    args = ap.parse_args(argv)
    on_card = resolve_device(args.device).type == "cuda"

    print("name,us_per_call,derived")
    for fn in paper_tables.ALL:
        for name, us, derived in fn():
            print(f"{name},{us:.2f},{derived}")
    if on_card:
        for name, us, derived in kernel_bench.rows():
            print(f"{name},{us:.2f},{derived}")
    else:
        print("kernel/NOT_MEASURED,0,needs the card")
    for name, us, derived in planner_bench.rows():
        print(f"{name},{us:.2f},{derived}")
    for name, us, derived in workload_bench.rows():
        print(f"{name},{us:.2f},{derived}")
    for name, us, derived in fleet_scale_bench.rows():
        print(f"{name},{us:.2f},{derived}")
    rl = roofline_table.rows()
    if not rl:
        print("roofline/NO_DRYRUN_RECORDS,0,run `python -m repro_torch.launch.dryrun --all`")
    for name, us, derived in rl:
        print(f"{name},{us:.2f},{derived}")


if __name__ == '__main__':
    main()
