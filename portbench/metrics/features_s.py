"""features_s: the program's timer `t_features` (Features (ops/sift.py)), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_features"] for t in record["timers"] if "t_features" in t]
    return sum(times) / record["n_sets"] if times else None
