"""Json training config with an optional run directory (counterpart of
``bde2vid_tpu/utils/config.py``; reference parse_config.py)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def read_json(path: str) -> Dict:
    with open(path) as fp:
        return json.load(fp)


def write_json(content, path: str) -> None:
    with open(path, "w") as fp:
        json.dump(content, fp, indent=4, sort_keys=False)


class Config:
    """A dict wrapper: ``from_json``, and with ``make_run_dir`` a
    ``runs/<name>/<stamp>`` directory holding a copy of the config (reference
    save_dir, parse_config.py:29-52)."""

    def __init__(self, cfg: Dict, run_dir: Optional[str] = None):
        self.cfg = cfg
        self.run_dir = run_dir

    @classmethod
    def from_json(cls, path: str, make_run_dir: bool = False) -> "Config":
        with open(path) as fp:
            cfg = json.load(fp)
        run_dir = None
        if make_run_dir:
            name = cfg.get("name", os.path.splitext(os.path.basename(path))[0])
            run_dir = os.path.join("runs", name, time.strftime("%m%d_%H%M%S"))
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as fp:
                json.dump(cfg, fp, indent=4)
        return cls(cfg, run_dir)

    def __getitem__(self, key):
        return self.cfg[key]

    def get(self, key, default=None):
        return self.cfg.get(key, default)
