"""The card's idle share of a steady stretch, %: 1 - (union of its kernel,
copy and fill intervals) / the stretch's wall time, from torch.profiler's
trace of the traced run's first half (the stretch starts after one step
inside the profile). Nothing from a run without a card."""


def read(run):
    p = run.profile
    if run.card is None or not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
