"""The port's artifact locations (``repro_torch.paths``) against the
reference's.

Every location the port writes to by default is one of its own, neither
inside a reference location nor holding one; the port reads none of the
reference's location variables; and a reference dispatch and a port
dispatch with recording on leave disjoint run stores, plan caches and
reports, although both packages key them by the same fingerprints on a CPU
host.  The dispatches run in subprocesses, so that each package's
process-wide tuner and store are built under the variables given.
"""

import ast
import io
import json
import os
import subprocess
import sys
import textwrap
import tokenize

import pytest

from repro.core import calibration as ref_cal
from repro.obs import export as ref_export
from repro.obs.watch import dashboard as ref_dashboard
from repro.obs.watch import history as ref_history
from repro.sim import result as ref_sim_result
from repro.telemetry import store as ref_store
from repro.tuner import plan as ref_plan
from repro_torch import paths
from repro_torch.examples import train_e2e
from repro_torch.obs import export
from repro_torch.obs.watch import history
from repro_torch.sim import result as sim_result
from repro_torch.telemetry import store
from repro_torch.tuner import plan

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the reference's location variables, which the port must not read
REFERENCE_VARS = ("REPRO_ARTIFACTS", "REPRO_TELEMETRY_DIR", "REPRO_PLAN_DIR",
                  "REPRO_BENCH_HISTORY_DIR")
PORT_VARS = ("REPRO_TORCH_ARTIFACTS", "REPRO_TORCH_TELEMETRY_DIR",
             "REPRO_TORCH_PLAN_DIR", "REPRO_TORCH_BENCH_HISTORY_DIR")
#: the plan of matmul at n 512 on one CPU device, and its run file, are
#: keyed alike in both packages
FINGERPRINT = "e17f1f5e965d"


def _locations():
    """{what: (the port's default, the reference's default)}."""
    import benchmarks.run as ref_run
    ref_root = os.path.abspath(ref_cal.ARTIFACTS_DIR)
    return {
        "run store and report": (store.telemetry_dir(),
                                 ref_store.telemetry_dir()),
        "plan cache": (plan.default_plan_dir(), ref_plan.default_plan_dir()),
        "fitted calibration": (
            paths.hopper_cache("calibration"),
            os.path.join(ref_root, "hopper_calibration.json")),
        "fitted joint context": (paths.hopper_cache("joint"),
                                 os.path.join(ref_root, "hopper_joint.json")),
        "simulator traces": (sim_result.traces_dir(),
                             ref_sim_result.traces_dir()),
        "obs traces": (export.traces_dir(), ref_export.traces_dir()),
        "obs summary": (paths.obs_dir(), os.path.join(ref_root, "obs")),
        "dashboard": (paths.obs_dir(), os.path.dirname(
            os.path.abspath(ref_dashboard.DEFAULT_PATH))),
        "bench history": (history.history_dir(), ref_history.history_dir()),
        "harness JSONs": (paths.bench_dir(), ref_run.OUT),
        "example checkpoints": (
            train_e2e.default_ckpt_dir("qwen1.5-4b", True),
            "/tmp/repro_e2e_ckpt"),
    }


def _inside(path: str, parent: str) -> bool:
    return os.path.commonpath([path, parent]) == parent


@pytest.mark.parametrize("what", sorted(_locations()))
def test_each_default_location_is_the_port_s_own(what, monkeypatch):
    for name in REFERENCE_VARS + PORT_VARS:
        monkeypatch.delenv(name, raising=False)
    port, ref = (os.path.abspath(p) for p in _locations()[what])
    assert port != ref
    assert not _inside(port, ref) and not _inside(ref, port)
    # the same root by default (the checkout's artifacts/), a name of its own
    assert _inside(port, paths.root())


@pytest.mark.parametrize("what,var", [
    ("run store and report", "REPRO_TORCH_TELEMETRY_DIR"),
    ("plan cache", "REPRO_TORCH_PLAN_DIR"),
    ("bench history", "REPRO_TORCH_BENCH_HISTORY_DIR"),
])
def test_each_variable_is_read_at_call_time(what, var, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv(var, str(tmp_path / "own"))
    monkeypatch.setenv(REFERENCE_VARS[PORT_VARS.index(var)],
                       str(tmp_path / "ref"))
    assert _locations()[what][0] == str(tmp_path / "own")
    monkeypatch.delenv(var)
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path / "root"))
    assert _inside(_locations()[what][0], str(tmp_path / "root"))


def _string_literals(path):
    with open(path, "rb") as f:
        for tok in tokenize.tokenize(io.BytesIO(f.read()).readline):
            if tok.type == tokenize.STRING:
                try:
                    yield ast.literal_eval(tok.string)
                except ValueError:      # an f-string
                    yield tok.string


def test_no_port_module_names_a_reference_variable():
    package = os.path.join(SRC, "repro_torch")
    found = []
    for base, _, files in os.walk(package):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                found += [(os.path.relpath(path, package), s)
                          for s in _string_literals(path)
                          if s in REFERENCE_VARS]
    assert found == []


# -- one dispatch of each package, recording on --------------------------------

DISPATCH = {
    "reference": textwrap.dedent(r"""
        import sys
        sys.path.insert(0, sys.argv[1])
        import jax.numpy as jnp
        import numpy as np
        from repro import linalg, telemetry
        a = np.random.default_rng(0).standard_normal((512, 512))
        linalg.matmul(jnp.asarray(a, jnp.float32),
                      jnp.asarray(a, jnp.float32)).block_until_ready()
        print(telemetry.save_report({"package": "repro"}))
    """),
    "port": textwrap.dedent(r"""
        import sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import torch
        from repro_torch import linalg, telemetry
        a = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (512, 512)).astype(np.float32))
        linalg.matmul(a, a, devices=[torch.device("cpu")])
        print(telemetry.save_report({"package": "repro_torch"}))
        print("JAX_IMPORTED", "jax" in sys.modules)
    """),
}


def _env(**dirs):
    env = dict(os.environ, REPRO_TELEMETRY="1", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    for name in REFERENCE_VARS + PORT_VARS:
        env.pop(name, None)
    env.update({k: str(v) for k, v in dirs.items()})
    return env


def _start(package, env):
    return subprocess.Popen([sys.executable, "-c", DISPATCH[package], SRC],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def dispatched(tmp_path_factory):
    """The reference's dispatch, then the port's with both packages'
    variables on separate directories, and the port's with only the
    reference's variables set (its root on a directory of its own, so
    that nothing lands in the checkout)."""
    d = tmp_path_factory.mktemp("artifact_dirs")
    ref = dict(REPRO_TELEMETRY_DIR=d / "ref" / "telemetry",
               REPRO_PLAN_DIR=d / "ref" / "plans",
               REPRO_ARTIFACTS=d / "ref" / "root")
    port = dict(REPRO_TORCH_TELEMETRY_DIR=d / "port" / "telemetry",
                REPRO_TORCH_PLAN_DIR=d / "port" / "plans",
                REPRO_TORCH_ARTIFACTS=d / "port" / "root")
    only = dict(REPRO_TELEMETRY_DIR=d / "only" / "telemetry",
                REPRO_PLAN_DIR=d / "only" / "plans",
                REPRO_ARTIFACTS=d / "only" / "root",
                REPRO_TORCH_ARTIFACTS=d / "only_port_root")
    _finish(_start("reference", _env(**ref, **port)))
    ref_after_ref = _tree(d / "ref")
    procs = [_start("port", _env(**ref, **port)),
             _start("port", _env(**only))]
    outs = [_finish(p) for p in procs]
    return d, ref_after_ref, outs


def test_a_port_dispatch_leaves_the_reference_s_files_alone(dispatched):
    d, ref_after_ref, outs = dispatched
    assert "JAX_IMPORTED False" in outs[0]
    assert sorted(ref_after_ref) == [
        f"plans/{FINGERPRINT}-matmul-n512-p1-float32.json",
        "telemetry/report.json", f"telemetry/runs-{FINGERPRINT}.jsonl"]
    assert _tree(d / "ref") == ref_after_ref
    with open(d / "ref" / "telemetry" / f"runs-{FINGERPRINT}.jsonl") as f:
        assert len(f.readlines()) == 1
    with open(d / "ref" / "telemetry" / "report.json") as f:
        assert json.load(f) == {"package": "repro"}


def test_the_port_s_store_plans_and_report_hold_only_its_own(dispatched):
    d, _, outs = dispatched
    got = _tree(d / "port")
    assert sorted(got) == [
        f"plans/{FINGERPRINT}-matmul-n512-p1-float32.json",
        "telemetry/report.json", f"telemetry/runs-{FINGERPRINT}.jsonl"]
    assert got["telemetry/report.json"] and json.loads(
        got["telemetry/report.json"]) == {"package": "repro_torch"}
    assert len(got[f"telemetry/runs-{FINGERPRINT}.jsonl"].splitlines()) == 1
    assert str(d / "port" / "telemetry" / "report.json") in outs[0]


def test_the_reference_s_variables_alone_do_not_move_the_port(dispatched):
    d, _, outs = dispatched
    assert not (d / "only").exists()
    got = _tree(d / "only_port_root")
    assert sorted(got) == [
        f"plans_torch/{FINGERPRINT}-matmul-n512-p1-float32.json",
        "telemetry_torch/report.json",
        f"telemetry_torch/runs-{FINGERPRINT}.jsonl"]
    assert str(d / "only_port_root" / "telemetry_torch" / "report.json") \
        in outs[1]
