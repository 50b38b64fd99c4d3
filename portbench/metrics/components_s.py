"""components_s: the program's timer `t_components` (secondary components, their Sim(3) merge and the straggler sweep), summed over the
window's sets and divided by their number (s). None where no set has it."""


def read(record):
    times = [t["t_components"] for t in record["timers"] if "t_components" in t]
    return sum(times) / record["n_sets"] if times else None
