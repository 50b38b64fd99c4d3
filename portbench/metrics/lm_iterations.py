"""lm_iterations: the program's counter `lm_iterations` (the LM iterations of
every BA solve, `ba_step`), summed over the window's sets and divided by their
number (per set). None where the window's runs cannot be read from the program
(portbench/spans.py)."""
from portbench.spans import count_per_set


def read(record):
    return count_per_set(record, "lm_iterations")
