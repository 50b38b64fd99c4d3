"""pnp_attempts: the program's counter `pnp_attempts` (every PnP registration
tried, failed ones too), summed over the window's sets and divided by their
number (per set). None where the window's runs cannot be read from the program
(portbench/spans.py)."""
from portbench.spans import count_per_set


def read(record):
    return count_per_set(record, "pnp_attempts")
