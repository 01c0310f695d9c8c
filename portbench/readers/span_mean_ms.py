"""Mean host milliseconds of one benchmark span over the window."""


def read(metric, rec):
    s = rec["spans"].get(metric["args"]["span"])
    return 1e3 * sum(s) / len(s) if s else None
