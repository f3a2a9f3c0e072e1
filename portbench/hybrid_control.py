#!/usr/bin/env python3
"""The control of a hybrid cell's comparison: the plain reference put in
the program's place with its vector leg one precision lower (TF32 for
the configuration's float32), at the cell's own size.

    python3 portbench/hybrid_control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, answers every
query of the pool once with that reference, and judges those answers as
it judges the program's. It prints one JSON line a seed with each
compared number beside its limit; the control has to come out not
correct. The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch                      # noqa: E402

from portbench import hybrid_search, registry  # noqa: E402


def control_reading(cell: registry.Cell, seed: int, dev) -> dict:
    sysmod = registry.system(cell.cfg["system"])
    data = sysmod.make_data(cell.cfg, cell.traffic, seed, dev)
    outputs = hybrid_search.control_outputs(cell.cfg, cell.traffic, data,
                                            dev)
    verdict = sysmod.judge(cell.cfg, cell.traffic, data, outputs, dev)
    return {"workload": cell.name, "seed": seed, "correct": verdict.correct,
            "attempted": verdict.attempted, "failed": verdict.failed,
            "checks": {n: {"value": v, "limit": lim, "op": op}
                       for n, (v, op, lim) in verdict.checks.items()},
            "recall": verdict.values.get("recall")}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("portbench hybrid control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(control_reading(cell, seed, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
