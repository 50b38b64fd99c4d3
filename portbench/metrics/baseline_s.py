"""baseline_s: the program's timer `t_baseline` (pair scoring, the epipolar prefilter and the seed bootstrap), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_baseline"] for t in record["timers"] if "t_baseline" in t]
    return sum(times) / record["n_sets"] if times else None
