"""pnp_replays: the program's counter `pnp_graph_replays` (every PnP solve
whose P3P Newton loop and select-refine-accept chain replayed as CUDA
graphs, ops/pnp.py `solve_pnp_ransac`), summed over the window's sets and
divided by their number (per set). None where the window's runs cannot be
read from the program (portbench/spans.py), or where none of them has the
counter: a program that does not count it."""
from portbench.spans import count_per_set, window_runs


def read(record):
    runs = window_runs(record)
    if runs is None or not any("pnp_graph_replays" in run["counters"] for run in runs):
        return None
    return count_per_set(record, "pnp_graph_replays")
