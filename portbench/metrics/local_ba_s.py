"""local_ba_s: the program's spans `ba` whose attribute `local` is true (the
local-window bundle adjustments of registration from the 12th view on: the
new view and its most covisible cameras move, the rest are frozen), summed
over the window's sets and divided by their number (s). None where the
window's runs cannot be read from the program (portbench/spans.py)."""
from portbench.spans import span_s, window_runs


def read(record):
    runs = window_runs(record)
    if runs is None:
        return None
    return sum(
        span_s(s) for run in runs for s in run["spans"] if s["name"] == "ba" and s["attrs"].get("local")
    ) / record["n_sets"]
