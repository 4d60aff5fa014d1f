"""The Swin blocks' share of their roofline, in %: the least time of their
calls (max(operations / 67 TFLOP/s, bytes / 3.35 TB/s) each, from the call's
shapes) over the device time under their ranges. None without Swin blocks."""


def read(t):
    ms = t["device_ms"].get("bench.swin_block")
    if not ms or t.get("swin_bound_ms") is None:
        return None
    return 100.0 * t["swin_bound_ms"] / ms
