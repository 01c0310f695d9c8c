"""Completed work over the whole window (host clock)."""


def read(metric, rec):
    return rec["images"] / rec["window_s"] if rec["window_s"] > 0 and rec["images"] else None
