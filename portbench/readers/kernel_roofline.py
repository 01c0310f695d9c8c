"""Roofline seconds of a kernel group's work in the traced window over the
device seconds of that group, in percent. The work is one forward's calls of
the group (portbench/flops, shapes from the configuration) times the forwards
the window ran: counted by the port's attention launch counter
(``launch_counter: attention``, launches over launches a forward) or by the
benchmark's count of batches handed to the port (``forwards``)."""

from portbench import flops


def read(metric, rec):
    tr, peaks = rec["trace"], rec["peaks"]
    group = metric["args"]["group"]
    if tr is None or not peaks or tr["group_s"].get(group, 0.0) <= 0.0:
        return None
    cfg = rec["spec"].config
    calls = [c for c in flops.module(cfg["arch"]).forward_calls(
        cfg["model"], cfg["serve"]["batch_size"]) if c.group == group]
    if not calls:
        return None
    if metric["args"]["launch_counter"] == "attention":
        launches = sum(rec["counters"].get("attention_launches", {}).values())
        forwards = launches / len(calls)
    else:
        forwards = rec["counters"].get("forwards", 0)
    if not forwards:
        return None
    return 100.0 * forwards * flops.roofline_s(calls, peaks) / tr["group_s"][group]
