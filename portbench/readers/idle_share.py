"""The share of the traced window with nothing running on the card, in
percent: 1 - (union of kernel, copy and set intervals) / window."""


def read(metric, rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
