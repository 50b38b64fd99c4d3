"""final_ba_s: the program's timer `t_final_ba` (the rotation-averaging reinit and the final BA), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_final_ba"] for t in record["timers"] if "t_final_ba" in t]
    return sum(times) / record["n_sets"] if times else None
