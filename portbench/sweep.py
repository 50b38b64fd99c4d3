"""Read the check's numbers of one cell over many seeds in one process: the
readings that its limits are set from.

    python3 portbench/sweep.py --workload <cell> --seeds 1 2 3 [--control no-ba|no-ratio|tf32] [--device cpu]

Each seed renders its scene and runs one set of the cell's traffic, as a run
of the benchmark does; one JSON line per seed gives every number of the
check beside the cell's limits, and whether the set passes. `--control`
switches the program to one of the check's controls (program.apply_control);
`--device cpu` runs the program on the host, as a second witness. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep(bench, name: str, seeds, control=None, device: str = "cuda"):
    """Yields, for each seed, {"seed", "numbers", "passes", "set_s", "timers"}."""
    from portbench import program
    from portbench.reference import judge, scene as scene_mod

    cell = bench.cell(name)
    config, limits = bench.config(cell), bench.limits(cell)
    if control is not None:
        program.apply_control(control)
    cfg = program.pipeline_config(config.get("pipeline", {}))
    for seed in seeds:
        scene = scene_mod.render(seed=seed, device=device, **config["scene"])
        images, intrinsics = program.inputs(scene.gray, scene.K)
        t0 = time.time()
        try:
            res = program.run_set(images, intrinsics, cfg, device)
        except Exception as exc:  # a set that raises fails; the sweep goes on
            yield {"seed": seed, "error": f"{type(exc).__name__}: {exc}"[:300], "passes": False}
            continue
        set_s = time.time() - t0
        numbers = judge.judge(res.rec, scene)
        yield {
            "seed": seed,
            "numbers": numbers,
            "limits": limits,
            "passes": judge.compare([numbers], limits)[0] == 0,
            "set_s": set_s,
            "judge_s": time.time() - t0 - set_s,
            "timers": res.timers,
            "program": res.counts,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None, help="one of program.CONTROLS")
    ap.add_argument("--device", default="cuda", help="cpu runs the program on the host, as a witness")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import Bench

    for row in sweep(Bench(ROOT), args.workload, args.seeds, args.control, args.device):
        print(json.dumps(dict(row, control=args.control, device=args.device, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
