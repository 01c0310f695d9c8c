"""A counter of seconds (``args.counter``) over the window's seconds, in
percent (host clock)."""


def read(metric, rec):
    sec = rec["counters"].get(metric["args"]["counter"])
    return 100.0 * sec / rec["window_s"] if sec is not None and rec["window_s"] > 0 else None
