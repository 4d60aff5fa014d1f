"""Device ms a step under the clip and Adam's step (``train/trainer.py``,
``train/optim.py``)."""


def read(t):
    ms = t["device_ms"].get("bench.optimizer")
    return None if ms is None else ms / t["steps"]
