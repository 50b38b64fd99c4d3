"""incremental_s: the program's timer `t_incremental` (registration of the main component), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_incremental"] for t in record["timers"] if "t_incremental" in t]
    return sum(times) / record["n_sets"] if times else None
