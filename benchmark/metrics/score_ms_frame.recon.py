"""Device ms a frame under the scoring ranges: LPIPS and the other scores
(``metrics/basic.py``, ``metrics/lpips.py`` through ``eval/driver.py``)."""


def read(t):
    names = [k for k in t["device_ms"] if k == "bench.lpips" or k.startswith("bench.score.")]
    if not names:
        return None
    return sum(t["device_ms"][k] for k in names) / t["frames"]
