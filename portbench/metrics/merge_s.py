"""merge_s: the program's span `merge` (one Sim(3) merge attempt of a
secondary component into the main one, `merge_attempt_step`: the Sim(3)
RANSAC, the re-triangulation of the cross tracks, the merge's BA and both
gates; inside `components`), summed over the window's sets and divided by
their number (s). None where the window's runs cannot be read from the
program (portbench/spans.py)."""
from portbench.spans import span_per_set


def read(record):
    return span_per_set(record, "merge")
