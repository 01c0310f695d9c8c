"""Window images x the configuration's FLOP an image (portbench/flops) over
window seconds x the card's bf16 peak, in percent."""

from portbench import flops


def read(metric, rec):
    peak = rec["peaks"].get("bf16")
    if not peak or not rec["images"]:
        return None
    cfg = rec["spec"].config
    gflop = flops.module(cfg["arch"]).gflop_per_image(cfg["model"])
    return 100.0 * rec["images"] * gflop * 1e9 / (rec["window_s"] * peak)
