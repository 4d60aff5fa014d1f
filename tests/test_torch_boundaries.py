"""The port's boundaries: it imports neither JAX nor the JAX package, and
its entry points refuse to run without CUDA unless the CPU is asked for."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "bde2vid_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax_and_no_jax_package():
    mods = list(_modules())
    assert len(mods) > 20
    assert {"bde2vid_tpu_torch.ops.window_attn_cuda", "bde2vid_tpu_torch.native.evpack",
            "bde2vid_tpu_torch.eval.rec_snn", "bde2vid_tpu_torch.models.evsnn",
            "bde2vid_tpu_torch.nn.spiking", "bde2vid_tpu_torch.utils.png"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'bde2vid_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_port_sources_do_not_name_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "flax" not in stripped, (path, line)
                assert not stripped.startswith(("import bde2vid_tpu ", "import bde2vid_tpu.",
                                                "from bde2vid_tpu ", "from bde2vid_tpu.")), (path, line)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_construction_needs_cuda_unless_cpu_is_asked_for(no_cuda):
    from bde2vid_tpu_torch.models import build_model

    cfg = {"generator": {"basechannels": 4, "num_encoders": 2, "ks": 3, "depths": [1, 1],
                         "num_heads": 2, "window_size": [4, 4], "buffer_index": [-1, 0, 1]}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("BDE2VID", cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("BDE2VID", cfg, device="cuda")
    model = build_model("BDE2VID", cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_cli_needs_cuda_unless_cpu_is_asked_for(no_cuda, tmp_path):
    from bde2vid_tpu_torch.eval.__main__ import main

    args = ["--weights_dir", str(tmp_path), "--data_dir", str(tmp_path), "--datasets", "X"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    # with the CPU asked for it gets past the device check (and finds no data)
    assert main(args + ["--device", "cpu"]) == 1


def test_kernel_wrapper_refuses_other_devices():
    from bde2vid_tpu_torch.ops.window_attn_cuda import fused_swin_block

    x = torch.zeros(3, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_swin_block(x, x[0], None, 2, 1)
