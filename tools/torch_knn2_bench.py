#!/usr/bin/env python3
"""Time the port's top-2 search kernel (sfm_danpipeline_torch/csrc/knn2.cu)
on a CUDA card, alone or beside the port's first kernel.

    python3 tools/torch_knn2_bench.py [--old OLD.cu] [--profile]

Prints the card's name and power limit, what ptxas reports for each build,
and for the 10-view shape (P = 45) and the 20-view shape (P = 190) at
Ka = Kb = 2048, D = 128 the median time of 10 direct launches (CUDA events,
without the wrapper's input checks), the bound and the share of it. With
--old the versions are timed in turns (old, new, new, old) inside one
process, so they share one card.

  --old OLD.cu  also build and time a source with the first kernel's C
                interface (knn2_launch without scratch arguments), e.g. one
                written out by `git show <commit>:sfm_danpipeline_torch/csrc/knn2.cu`;
                its result is held against the new kernel's.
  --profile     print each of the new source's kernels' device time per
                launch at both shapes (torch.profiler).
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sfm_danpipeline_torch import kernels  # noqa: E402
from sfm_danpipeline_torch.ops import matching  # noqa: E402
from sfm_danpipeline_torch.utils import knn_cases  # noqa: E402


def _report(lines):
    print("".join(f"  {line}\n" for line in lines), end="")


def _build_old(source):
    """Build `source` into a temporary library; returns a launcher with
    `_launch_knn2`'s signature for the first kernel's C interface."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "knn2_old.so")
        proc = subprocess.run(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", out, source],
            capture_output=True, text=True, check=True,
        )
        fn = ctypes.CDLL(out).knn2_launch  # stays mapped once the file is gone
    print(f"build: {source}")
    _report(kernels.ptxas_lines(proc.stdout + proc.stderr))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ] + [ctypes.c_void_p] * 4

    def run(desc, valid, xy, pi, pj, dup_r2):
        _, k, d = desc.shape
        p = pi.numel()
        idx = torch.empty((p, k), dtype=torch.int32, device=desc.device)
        best = torch.empty((p, k), dtype=torch.float32, device=desc.device)
        second = torch.empty_like(best)
        rc = fn(
            desc.data_ptr(), valid.data_ptr(), xy.data_ptr(), pi.data_ptr(),
            pj.data_ptr(), p, k, d, float(dup_r2), idx.data_ptr(), best.data_ptr(),
            second.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"old knn2 launch failed: cudaError {rc}")
        return idx, best, second

    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--old")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_knn2_bench: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    kernels.load("knn2")
    print("build: csrc/knn2.cu")
    _report(kernels.ptxas_report("knn2"))
    versions = {"new": matching._launch_knn2}
    order = ["new", "new"]
    if args.old:
        versions["old"] = _build_old(os.path.abspath(args.old))
        order = ["old", "new", "new", "old"]

    for n_views in (10, 20):
        case = knn_cases.matches_case(n_views, chip_smoke.K, chip_smoke.D, chip_smoke.DUP_R2)
        tensors = knn_cases.to_tensors(case, "cuda")
        n_pairs = case.pair_i.size
        bound = chip_smoke.knn2_bound(n_views, n_pairs, chip_smoke.K, chip_smoke.D)
        if args.old:
            n_mism, err = knn_cases.compare_knn2(
                versions["old"](*tensors, case.dup_r2), versions["new"](*tensors, case.dup_r2),
                *tensors[:2], *tensors[3:],
                rtol=chip_smoke.KNN2_RTOL, atol=chip_smoke.KNN2_ATOL, tie=chip_smoke.KNN2_TIE,
            )
            print(f"P={n_pairs}: old against new: {n_mism} near-tie index mismatches, max |d2 err| {err:.3e}")
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    versions["new"](*tensors, case.dup_r2)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                found = re.search(r"knn2_\w+", ev.key)
                if found:
                    print(
                        f"P={n_pairs}: {found.group()}: "
                        f"{ev.device_time_total / ev.count / 1e3:.4f} ms x {ev.count}"
                    )
        times = {}
        for name in order:
            ms = chip_smoke._median_ms(lambda: versions[name](*tensors, case.dup_r2))
            times.setdefault(name, []).append(ms)
        for name, ms in times.items():
            share = ", ".join(f"{100 * bound['bound_ms'] / t:.1f}%" for t in ms)
            print(
                f"P={n_pairs} Ka=Kb={chip_smoke.K} D={chip_smoke.D}: {name}: "
                f"{', '.join(f'{t:.3f}' for t in ms)} ms; bound {bound['bound_ms']:.3f} ms "
                f"by {bound['bound_by']}; share {share}"
            )


if __name__ == "__main__":
    main()
