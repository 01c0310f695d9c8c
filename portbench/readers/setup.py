"""Seconds from process start to the first timed batch (host clock)."""


def read(metric, rec):
    return rec["setup_s"]
