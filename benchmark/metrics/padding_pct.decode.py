"""Padded frames over all frames the offline entry dispatched to the AM
(batch rows times bucket bound), over the window's completed batches: a
count."""


def read(run):
    c = run["counters"]
    if not c.get("dispatched_frames"):
        return None
    return 100.0 * (1.0 - c["real_frames"] / c["dispatched_frames"])
