"""The reference's four examples on the port (``repro_torch.examples``), on
the CPU.

Each example runs with ``--device cpu`` in a subprocess in which JAX is
never imported, its locations on a temporary root (the quickstart with
``REPRO_TELEMETRY=1`` and the Hopper joint cache seeded with the joint
fit's starting point, so that it does not fit for two minutes); without a
GPU, ``--device cuda`` exits with the no-GPU message.  Against the
reference: the quickstart's deterministic output line for line (the
reference's ``examples/quickstart.py`` loaded by its path, both on contexts
from the same parameters), the linalg demo's plan and advice, the served
tokens on the reference's parameters, the replay's lines.  The reference
CI's 0.35 bar on the quickstart's report depends on CPU wall times and is
held in a run alone (README), not here.
"""

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import calibration as cal
from repro_torch.examples import quickstart, serve_batched, train_e2e

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")

#: the joint fit's starting point
THETA0 = cal.THETA0
PORT_VARS = ("REPRO_TORCH_ARTIFACTS", "REPRO_TORCH_TELEMETRY_DIR",
             "REPRO_TORCH_PLAN_DIR", "REPRO_TORCH_BENCH_HISTORY_DIR")
EXAMPLES = {
    "quickstart": [],
    "linalg_25d_demo": [],
    "serve_batched": [],
    "train_e2e": ["--smoke", "--steps", "8", "--batch", "4", "--seq", "64"],
}

RUN = textwrap.dedent(r"""
    import runpy, sys
    sys.path.insert(0, sys.argv[1])
    name = sys.argv[2]
    sys.argv = [name] + sys.argv[3:]
    code = 0
    try:
        runpy.run_module("repro_torch.examples." + name, run_name="__main__")
    except SystemExit as e:
        code = e.code
    print("JAX_IMPORTED", "jax" in sys.modules, "EXIT", code)
""")


def seed_joint_cache(root):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "hopper_joint_torch.json"), "w") as f:
        json.dump({"theta": [float(x) for x in THETA0]}, f)


def _env(root, **extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    for name in PORT_VARS + ("REPRO_TELEMETRY", "REPRO_OBS"):
        env.pop(name, None)
    env.update(REPRO_TORCH_ARTIFACTS=str(root), **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (root, stdout)}: each example with ``--device cpu``, and
    {name: (returncode, stderr)} of each with ``--device cuda``; four
    processes at a time."""
    base = tmp_path_factory.mktemp("examples")
    refused = {}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cuda"], cwd=str(base), env=_env(base / "refused"), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for name in EXAMPLES}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        refused[name] = (proc.returncode, err)
    procs = {}
    for name, args in EXAMPLES.items():
        root = base / name
        seed_joint_cache(root)
        extra = {"REPRO_TELEMETRY": "1"} if name == "quickstart" else {}
        procs[name] = (root, subprocess.Popen(
            [sys.executable, "-c", RUN, SRC, name, "--device", "cpu", *args],
            cwd=str(base), env=_env(root, **extra), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = {}
    for name, (root, proc) in procs.items():
        stdout, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = (root, stdout)
    return out, refused


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_each_example_runs_on_the_cpu_without_jax(runs, name):
    root, stdout = runs[0][name]
    assert stdout.strip().splitlines()[-1] == "JAX_IMPORTED False EXIT 0"
    # nothing written relative to the working directory (the examples'
    # roots' parent)
    assert set(os.listdir(root.parent)) <= set(EXAMPLES) | {"refused"}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_cuda_without_a_gpu_exits_with_the_no_gpu_message(runs, name):
    code, err = runs[1][name]
    assert code != 0
    assert "--device cuda: no CUDA device available" in err


# -- the quickstart -------------------------------------------------------------

def test_the_quickstart_s_report_is_its_store_joined_and_refitted(runs):
    from repro_torch import telemetry
    from repro_torch.tuner import build_default_registry
    root, stdout = runs[0]["quickstart"]
    with open(root / "telemetry_torch" / "report.json") as f:
        saved = json.load(f)
    assert saved["overall"]["n_rows"] >= 16
    st = telemetry.RunStore(str(root / "telemetry_torch"))
    runs_ = [r for fp in st.fingerprints() for r in st.load(fp)
             if r.meta.get("agg") == "best5"]
    assert len(runs_) == 16
    registry = build_default_registry()
    rows = telemetry.join(runs_, registry)
    telemetry.refit(rows, registry).apply(registry)
    want = telemetry.accuracy_report(telemetry.join(runs_, registry))
    assert saved == json.loads(json.dumps(want))
    before, after = (float(x) for x in re.search(
        r"mean \|log measured/predicted\|: ([\d.]+) -> ([\d.]+)",
        stdout).groups())
    assert after < before
    assert f"report -> {root / 'telemetry_torch' / 'report.json'}" in stdout
    assert (root / "obs_torch" / "dashboard.html").exists()
    assert (root / "traces_torch" / "summa_2d_ovlp_n32768_p64.json").exists()


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_quickstart_prints_the_reference_s_lines(monkeypatch, capsys,
                                                     tmp_path):
    """Variant choice, Table II, the cost-IR toy, the simulation, the fault
    diagnosis and the LM table: the reference's lines, apart from the
    trace's path and the package the headings name (the measured loop and
    the dashboard are stubbed)."""
    from repro.core import calibration as ref_cal
    ref = _load_reference("quickstart")
    monkeypatch.setattr(ref_cal, "ARTIFACTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path / "port"))
    printed = []
    for mod, ctx, args in ((ref, ref_cal._ctx_from_theta(THETA0), ()),
                           (quickstart, cal._ctx_from_theta(THETA0),
                            (["--device", "cpu"],))):
        monkeypatch.setattr(mod, "hopper_fitted_ctx", lambda ctx=ctx: ctx)
        monkeypatch.setattr(mod, "telemetry_demo", lambda *a: ([], None))
        monkeypatch.setattr(mod, "observatory_demo", lambda *a: None)
        capsys.readouterr()
        mod.main(*args)
        printed.append(capsys.readouterr().out.splitlines())
    want, got = printed
    assert len(got) == len(want) > 30
    traces = {"ref": str(tmp_path / "ref" / "traces"),
              "port": str(tmp_path / "port" / "traces_torch")}
    for g, w in zip(got, want):
        g = g.replace("(repro_torch.", "(repro.")
        if "Chrome trace -> " in w:
            assert g.replace(traces["port"], "") == w.replace(
                traces["ref"], "")
        else:
            assert g == w


# -- the linalg demo -------------------------------------------------------------

def test_the_linalg_demo_s_residuals_plan_and_advice(runs, tmp_path):
    from repro.core import AlgoContext as RefAlgoContext
    from repro.core import CommModel as RefCommModel
    from repro.core import ComputeModel as RefComputeModel
    from repro.core import TPU_V5E as REF_TPU_V5E
    from repro.core import calibration as ref_cal
    from repro.core.perfmodel import TPU_EFFICIENCY as REF_TPU_EFFICIENCY
    from repro.core.predictor import select as ref_select
    from repro.sim import derive_calibration, v5e_pod_topology
    from repro.tuner import Tuner as RefTuner
    _, stdout = runs[0]["linalg_25d_demo"]
    errs = [float(x) for x in re.findall(r"err ([\d.e+-]+)", stdout)]
    assert len(errs) == 5 and max(errs) < 1e-4
    plan = RefTuner(plan_dir=str(tmp_path)).plan("matmul", 64)
    assert (f"tuner dispatch: {plan.algo}/{plan.variant} p={plan.p} "
            f"c={plan.c} kernel={plan.local_kernel} ") in stdout
    ch = ref_select(ref_cal._ctx_from_theta(THETA0), "cholesky", 65536,
                    4096)
    assert (f"Hopper @24k cores, cholesky n=65536 -> {ch.result.variant} "
            f"(c={ch.result.c}, {ch.pct_peak:.1f}% peak)") in stdout
    v5e = derive_calibration(v5e_pod_topology(), ps=[64, 256],
                             distances=[1, 4, 16])
    ch = ref_select(RefAlgoContext(RefCommModel(REF_TPU_V5E, v5e),
                                   RefComputeModel(REF_TPU_V5E,
                                                   REF_TPU_EFFICIENCY)),
                    "cholesky", 131072, 256)
    assert (f"v5e pod (256 chips), cholesky n=131072 -> {ch.result.variant} "
            f"(c={ch.result.c}, {ch.pct_peak:.1f}% peak)") in stdout


# -- serving -----------------------------------------------------------------------

def test_served_tokens_equal_the_reference_s_on_its_weights():
    import jax
    import jax.numpy as jnp
    from repro import serving as ref_serving
    from repro.configs import get as ref_get
    from repro.models import build_model as ref_build
    from repro_torch.configs import get
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_reference_params
    kw = dict(n_layers=4, d_model=128, n_heads=4, vocab=512)
    ref_model = ref_build(ref_get("xlstm-350m").reduced(**kw))
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(get("xlstm-350m").reduced(**kw))
    net = model.init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    prompts = np.random.default_rng(0).integers(0, 512, size=(4, 8))
    want = ref_serving.Engine(ref_model, params, ref_serving.ServeConfig(
        max_new_tokens=16, max_cache_len=128)).generate(
        jnp.asarray(prompts, jnp.int32))
    got = serve_batched.generate(model, net,
                                 torch.as_tensor(prompts, dtype=torch.int64))
    assert got.shape == (4, 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_the_replay_prints_the_reference_s_lines(runs, capsys):
    ref = _load_reference("serve_batched")
    printed = []
    for mod in (ref, serve_batched):
        capsys.readouterr()
        mod.replay_demo()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[1] in runs[0]["serve_batched"][1]


# -- training ----------------------------------------------------------------------

def test_train_e2e_smoke_runs_its_steps(runs, tmp_path):
    _, stdout = runs[0]["train_e2e"]
    assert "done: 8 steps, 0 restarts" in stdout
    report = train_e2e.main(["--device", "cpu", *EXAMPLES["train_e2e"],
                             "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 8 and report["restarts"] == 0
    assert [h["step"] for h in report["history"]] == list(range(8))
    assert all(math.isfinite(h["loss"]) for h in report["history"])


def test_train_e2e_restarts_after_an_injected_fault(tmp_path, capsys):
    """The checkpoint cadence is max(50, steps // 4), so at the fault
    (step 5) no checkpoint exists: the loop restarts from step 0 on the
    network and moments the five steps left behind (the optimizer's step
    is not rewound, as the reference's), and still runs its 8 steps."""
    from repro_torch.training import latest_step
    report = train_e2e.main(["--device", "cpu", *EXAMPLES["train_e2e"],
                             "--inject-fault-at", "5",
                             "--ckpt-dir", str(tmp_path)])
    assert report["steps"] == 8 and report["restarts"] == 1
    assert [h["step"] for h in report["history"]] == list(range(8))
    assert all(math.isfinite(h["loss"]) for h in report["history"])
    first, again = report["logged"]
    assert first["step"] == again["step"] == 0
    assert again["lr"] > first["lr"] and again["loss"] < first["loss"]
    assert latest_step(str(tmp_path)) == 8
    assert "done: 8 steps, 1 restarts" in capsys.readouterr().out


def test_train_e2e_reruns_its_documented_command_on_the_default_dir(
        tmp_path, monkeypatch, capsys):
    """The default checkpoint directory is under the port's root, one for
    each architecture and size: a second run of the same command finds
    the last step's checkpoint and runs no step, and a longer run resumes
    from it."""
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    for name in PORT_VARS[1:]:
        monkeypatch.delenv(name, raising=False)
    ckpt = train_e2e.default_ckpt_dir("qwen1.5-4b", True)
    assert ckpt == str(tmp_path / "ckpt_torch" / "train_e2e"
                       / "qwen1.5-4b-smoke")
    assert train_e2e.default_ckpt_dir("qwen1.5-4b", False) != ckpt
    argv = ["--device", "cpu", *EXAMPLES["train_e2e"]]
    first = train_e2e.main(argv)
    assert [h["step"] for h in first["history"]] == list(range(8))
    capsys.readouterr()
    again = train_e2e.main(argv)
    assert again["steps"] == 8 and again["history"] == []
    assert (f"no step run: the checkpoint under {ckpt} is at step 8"
            in capsys.readouterr().out)
    longer = train_e2e.main(argv + ["--steps", "12"])
    assert [h["step"] for h in longer["history"]] == list(range(8, 12))
    assert all(math.isfinite(h["loss"]) for h in longer["history"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt_torch"]


class _Built(Exception):
    pass


def _train_config(mod, monkeypatch, call):
    """The ``TrainConfig`` that ``mod``'s ``main`` hands its Trainer."""
    got = []

    def trainer(tc, **_):
        got.append(tc)
        raise _Built

    monkeypatch.setattr(mod, "Trainer", trainer)
    with pytest.raises(_Built):
        call()
    return got[0]


def _fields(cfg):
    """A config dataclass as a dict of plain values, nested ones too."""
    import dataclasses
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


@pytest.mark.parametrize("args", [
    [],
    ["--smoke"],
    ["--smoke", "--steps", "20", "--batch", "4", "--seq", "128"],
    ["--arch", "xlstm-350m", "--steps", "50"],
    ["--arch", "hymba-1.5b", "--steps", "1000", "--batch", "8"],
], ids=["default", "smoke", "smoke-chip", "xlstm", "hymba"])
def test_train_e2e_builds_the_reference_s_train_config(args, monkeypatch,
                                                        tmp_path):
    """``build_100m``, the reduced config, the optimizer's schedule, the
    data and the checkpoint cadence: the reference example's fields, on
    the same arguments (the checkpoint directory apart, whose default is
    the port's own)."""
    ref = _load_reference("train_e2e")
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["train_e2e.py", *args])
    want = _fields(_train_config(ref, monkeypatch, ref.main))
    got = _fields(_train_config(
        train_e2e, monkeypatch,
        lambda: train_e2e.main([*args, "--device", "cpu"])))
    arch = args[args.index("--arch") + 1] if "--arch" in args \
        else "qwen1.5-4b"
    assert want.pop("checkpoint_dir") == "/tmp/repro_e2e_ckpt"
    assert got.pop("checkpoint_dir") == train_e2e.default_ckpt_dir(
        arch, "--smoke" in args)
    assert got == want
    assert _fields(train_e2e.build_100m(arch)) == _fields(
        ref.build_100m(arch))
