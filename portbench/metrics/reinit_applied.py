"""reinit_applied: the program's counter `reinit_applied` (+1 where the
rotation-averaging reinit's polished candidate passes `_accept_reinit` and
replaces the incremental map; written as 0 where the reinit runs and is
reverted or skipped), summed over the window's sets and divided by their
number (per set). None where the window's runs cannot be read from the
program, or no run holds the counter (a program that does not count it)."""
from portbench.spans import window_runs


def read(record):
    runs = window_runs(record)
    if runs is None or not any("reinit_applied" in run["counters"] for run in runs):
        return None
    return sum(run["counters"].get("reinit_applied", 0) for run in runs) / record["n_sets"]
