"""matching_s: the program's timer `t_matching` (Matching (ops/matching.py, csrc/knn2.cu)), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_matching"] for t in record["timers"] if "t_matching" in t]
    return sum(times) / record["n_sets"] if times else None
