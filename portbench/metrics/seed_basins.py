"""seed_basins: the program's counter `seed_basins` (every (seed pair, basin)
two-view bootstrap `_try_seed` tries), summed over the window's sets and
divided by their number (per set). None where the window's runs cannot be read
from the program (portbench/spans.py)."""
from portbench.spans import count_per_set


def read(record):
    return count_per_set(record, "seed_basins")
