"""Device ms a frame under the model's range (``models/bde2vid.py``,
``models/e2vid.py`` over ``models/unet.py``)."""


def read(t):
    ms = t["device_ms"].get("bench.model")
    return None if ms is None else ms / t["frames"]
