"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``
from the root of the checkout. Cases that need the card are marked
``cuda`` and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a recording small enough for the CPU: the cells' traffic at 48x64, 16 items
TINY_TRAFFIC = {"sensor": [48, 64], "frames": 17, "events_per_frame": [2000, 8000]}
# a training set and batch of the same: 2 recordings of 12 items at 40x56, 4 crops of 32
TINY_TRAIN = {"sequences": 2, "sensor": [40, 56], "frames": 13, "events_per_frame": [2000, 2000], "batch": 4}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test's recordings under its own temporary directory."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# the flagship's training cell, not in BENCHMARK.json yet (PERF.md, open
# questions): its workload and end-to-end metric as a later PR would add them
TRAIN_CELL = {"name": "bde2vid-flagship.train-b16", "config": "bde2vid-flagship", "traffic": "train-b16",
              "chips": 1, "why": "the train CLI's step at batch 16"}
TRAIN_METRIC = {"name": "train_step_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                "source": "host_clock", "workloads": [TRAIN_CELL["name"]]}


def tiny_cell(name: str):
    from benchmark import harness

    harness.ensure_importable()
    bench = harness.benchmark()
    if name == TRAIN_CELL["name"]:
        bench["workloads"].append(TRAIN_CELL)
        bench["end_to_end"].append(TRAIN_METRIC)
    cell = harness.Cell(name, bench)
    if cell.traffic["entry"] == "train":
        cell.traffic.update(TINY_TRAIN)
        cell.traffic["data"] = {**cell.traffic["data"], "crop_size": 32}
    else:
        cell.traffic.update(TINY_TRAFFIC)
    return cell
