"""The PyTorch port stands alone: it imports with JAX absent, pulls in no
module of the reference package, names neither in its sources, and its
entry points refuse to fall back to the CPU when no GPU is present."""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    names = []
    for dirpath, _dirs, files in os.walk(PORT):
        rel = os.path.relpath(dirpath, SRC).replace(os.sep, ".")
        for f in sorted(files):
            if f == "__init__.py":
                names.append(rel)
            elif f.endswith(".py"):
                names.append(f"{rel}.{f[:-3]}")
    return sorted(names)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "chip_profile.py")]
    for dirpath, _dirs, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cu", ".cpp", ".h"))]
    return sorted(out)


def test_every_module_imports_without_jax_or_the_reference():
    modules = _port_modules()
    assert "repro_torch.tuner.dispatch" in modules
    code = textwrap.dedent(f"""
        import importlib, json, sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.path.insert(0, {SRC!r})
        for name in {modules!r}:
            importlib.import_module(name)
        print(json.dumps(sorted(
            m for m in sys.modules
            if m == "repro" or m.startswith(("repro.", "jax", "jaxlib")))))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # sys.modules["jax"] is the None placeholder; nothing else may appear
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["jax"]


# the measuring half: each package imports all of its modules
MEASURING = ["repro_torch.core.calibration", "repro_torch.core.paper_data",
             "repro_torch.obs", "repro_torch.telemetry",
             "repro_torch.benchmarks.fig1_blas_efficiency"]
# the simulator and what it unblocks
SIMULATOR = ["repro_torch.sim", "repro_torch.telemetry.diagnose",
             "repro_torch.core.lm_model"]
# the rest of the models: MoE, the encoder-decoder, the xLSTM blocks and K6
MODELS = ["repro_torch.models.moe", "repro_torch.models.encdec",
          "repro_torch.models.ssm", "repro_torch.kernels.slstm",
          "repro_torch.launch.prefill"]


@pytest.mark.parametrize("module", MEASURING + SIMULATOR + MODELS)
def test_measuring_modules_import_with_jax_and_the_reference_blocked(module):
    """Each module of the measuring half, of the simulator and of the
    models imports on its own in a process where importing JAX or the
    reference package fails."""
    assert set(MEASURING + SIMULATOR + MODELS) <= set(_port_modules())
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None        # any import of the reference fails
        sys.path.insert(0, {SRC!r})
        importlib.import_module({module!r})
        print(sorted(m for m in sys.modules if m.startswith("repro_torch.")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert module in out.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_neither_jax_nor_the_reference(path):
    with open(path) as f:
        text = f.read()
    assert not re.search(r"\bjax\b", text, re.IGNORECASE), path
    assert not re.search(r"\brepro\.", text), path


@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_default_devices_raise_without_a_gpu(op, monkeypatch, tmp_path):
    from repro_torch import linalg
    from repro_torch.tuner import PlanCache, Tuner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = torch.tensor(np.eye(8), dtype=torch.float32)
    args = (a,) if op == "cholesky" else (a, a)
    tuner = Tuner(cache=PlanCache(str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(linalg, op)(*args, tuner=tuner)
