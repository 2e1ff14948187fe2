"""The dry run on the CPU: the kernels' counted operators on ``meta``, the
collectives a counting mesh records against a real gloo world's, and the
``launch/dryrun.py`` entry point.

* K4, K5 and K6 (and K6's backward) on ``meta`` tensors give the shape
  and type of their plain versions' CPU outputs, and a flop counter reads
  the formulas PERF.md's bounds use: K4 4 D a kept (query, key) pair, K5
  4 DK DV a step, K6 27 a step and its backward 60.  K4's operand copies
  are decided from strides, so a ``meta`` count sees them.
* A gloo world of four ranks on (1, 2, 2) runs one reduced dense, MoE and
  FSDP train step, and two decode steps of five cases; each rank's
  ``collective_stats()`` by kind (calls and operand bytes) equals the
  count of the same rank's step on ``counting_mesh``, exactly.
  arctic-480b's count gathers no expert bank over ``model``.
* ``python -m repro_torch.launch.dryrun`` writes a record with the
  reference's keys, with ``jax`` never imported, and
  ``benchmarks/roofline_table.py`` reads it; ``--device cuda`` on a host
  without a card exits non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.core import roofline as ref_rl
from repro_torch.configs import get
from repro_torch.core import roofline as rl
from repro_torch.distributed import process_group as pg
from repro_torch.distributed import spawn
from repro_torch.kernels import (flash_attention_cuda, slstm_scan_bwd_cuda,
                                 slstm_scan_cuda, ssm_scan_cuda)
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch.specs import rules_for
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, Trainer

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
META = torch.device("meta")


def _pair(shape, dtype=torch.float32, seed=0):
    """The same shape on the CPU (seeded) and on meta."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).to(dtype)
    return x, torch.empty(shape, dtype=dtype, device=META)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return out, fc.get_total_flops()


# -- the kernels' meta paths and formulas ---------------------------------------

@pytest.mark.parametrize("b,h,kv,s,d,causal,dtype", [
    (2, 4, 2, 256, 64, True, torch.float32),
    (1, 6, 3, 300, 80, False, torch.float32),     # padded to 96
    (2, 4, 4, 256, 128, True, torch.bfloat16),
    (1, 4, 2, 384, 320, True, torch.bfloat16),    # the wide body's pad
])
def test_k4_meta_path_and_formula(b, h, kv, s, d, causal, dtype):
    (q, mq), (k, mk), (v, mv) = (_pair((b, n, s, d), dtype, i)
                                 for i, n in enumerate((h, kv, kv)))
    reset_launches()
    want = flash_attention_cuda(q, k, v, causal=causal)
    got, flops = _flops(lambda: flash_attention_cuda(mq, mk, mv,
                                                     causal=causal))
    assert got.device == META and got.shape == want.shape
    assert got.dtype == want.dtype == dtype
    pairs = s * (s + 1) // 2 if causal else s * s
    assert flops == 4 * b * h * d * pairs
    assert launches()["flash_attention_cuda"] == 0


@pytest.mark.parametrize("b,h,s,dk,dv,dtype", [
    (2, 3, 300, 16, 64, torch.bfloat16),
    (1, 2, 256, 64, 65, torch.float32),           # v with a ones column
])
def test_k5_meta_path_and_formula(b, h, s, dk, dv, dtype):
    (q, mq), (k, mk) = _pair((b, h, s, dk), dtype, 1), _pair((b, h, s, dk),
                                                             dtype, 2)
    v, mv = _pair((b, h, s, dv), dtype, 3)
    la, mla = _pair((b, h, s), torch.float32, 4)
    la = -la.abs()
    want = ssm_scan_cuda(q, k, v, la)
    got, flops = _flops(lambda: ssm_scan_cuda(mq, mk, mv, mla))
    assert got.device == META and got.shape == want.shape
    assert got.dtype == want.dtype
    assert flops == 4 * b * h * s * dk * dv


@pytest.mark.parametrize("states", [False, True])
def test_k6_meta_paths_and_formulas(states):
    b, s, w = 2, 50, 40
    cpu, meta = zip(*(_pair((b, s, w), seed=i) for i in range(4)))
    want = slstm_scan_cuda(*cpu, states=states)
    got, flops = _flops(lambda: slstm_scan_cuda(*meta, states=states))
    want, got = ((want,), (got,)) if not states else (want, got)
    for g, w_ in zip(got, want):
        assert g.device == META and g.shape == w_.shape
        assert g.dtype == w_.dtype == torch.float32
    assert flops == 27 * b * s * w
    if states:
        dy, mdy = _pair((b, s, w), seed=9)
        want_g = slstm_scan_bwd_cuda(*cpu, *want[1:], dy)
        got_g, flops = _flops(lambda: slstm_scan_bwd_cuda(*meta, *got[1:],
                                                          mdy))
        assert [g.shape for g in got_g] == [g.shape for g in want_g]
        assert all(g.device == META for g in got_g)
        assert flops == 60 * b * s * w


def test_the_formulas_are_the_bounds():
    from repro_torch.kernels.flash_attention.ops import flash_attention_flops
    from repro_torch.kernels.slstm.ops import slstm_scan_flops
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_flops
    # chip_smoke.py's K4 bound at starcoder2-3b's prefill shape
    assert flash_attention_flops(4, 24, 4096, 4096, 128, True) == \
        4.0 * 4 * 24 * 128 * (4096 * 4097 // 2)
    assert ssm_scan_flops(100, 4096, 16, 64) == 4.0 * 100 * 4096 * 16 * 64
    assert slstm_scan_flops(4, 4096, 1024) == 27.0 * 4 * 4096 * 1024
    assert slstm_scan_flops(1, 1024, 1024, backward=True) == \
        60.0 * 1024 * 1024


def test_k4_copies_are_decided_from_strides_on_meta():
    """A bf16 operand whose rows are not 16-byte strided is copied before
    the launch on meta as on the card: the count reads and writes it."""
    b, h, s, d = 1, 4, 256, 64
    wide = torch.empty(b, s, h * d + 4, dtype=torch.bfloat16, device=META)
    odd = wide[..., :h * d].unflatten(-1, (h, d)).transpose(1, 2)
    even = torch.empty(b, s, h * d, dtype=torch.bfloat16,
                       device=META).unflatten(-1, (h, d)).transpose(1, 2)
    kv = torch.empty(b, 2, s, d, dtype=torch.bfloat16, device=META)
    counted = [rl.count_step(lambda x=x: flash_attention_cuda(x, kv, kv))
               for x in (even, odd)]
    copy = 2 * b * h * s * d * 2
    assert counted[1].bytes - counted[0].bytes == copy
    assert counted[0].flops_by_type == counted[1].flops_by_type


@pytest.mark.parametrize("kernel", ["k5", "k6"])
def test_the_fp32_workspaces_are_counted_on_meta(kernel):
    """K5's and K6's fp32 workspaces are made before their operators, so a
    count holds them at the size csrc/ssm_scan.cu and csrc/slstm.cu ask:
    the peak is the workspace and the output, and the operator reads the
    workspace."""
    if kernel == "k5":
        b, h, s, dk, dv = 2, 3, 300, 16, 65
        q = torch.empty(b, h, s, dk, device=META)
        v = torch.empty(b, h, s, dv, device=META)
        la = torch.empty(b, h, s, device=META)
        work = b * h * -(-s // 64) * (dk * 68 + 1) * 4
        out = b * h * s * dv * 4
        count = rl.count_step(lambda: ssm_scan_cuda(q, q, v, la))
    else:
        b, s, w = 2, 50, 40
        z = torch.empty(b, s, w, device=META)
        work = 4 * b * -(-s // 32) * w * 4
        out = b * s * w * 4
        count = rl.count_step(lambda: slstm_scan_cuda(z, z, z, z))
    assert count.memory["temp_bytes"] == work + out
    assert count.bytes >= work + out


def test_log_sigmoid_is_counted_as_the_card_runs_it():
    """``log_sigmoid_forward`` fills a buffer for its backward on the CPU
    and returns it empty on the card; its meta kernel makes the CPU's.
    The count takes the card's: one output read and written, no buffer
    held (the mLSTM's and the sLSTM's gates reach it)."""
    x = torch.empty(4, 64, device=META)
    with torch.inference_mode():
        count = rl.count_step(lambda: torch.nn.functional.logsigmoid(x))
    assert count.bytes == 2 * 4 * 64 * 4
    assert count.memory["temp_bytes"] == 4 * 64 * 4
    cpu = torch.randn(4, 64)
    assert torch.ops.aten.log_sigmoid_forward(cpu)[1].numel() == 4 * 64


def test_a_plain_run_on_the_card_skips_the_operators():
    """Operands on CUDA launch straight, out of any dispatch mode; under
    one (a count, a fake-tensor trace) they go through the operator, which
    the mode sees.  CPU and meta operands never launch straight."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.common import launch_directly
    with FakeTensorMode():
        x = torch.empty(4, device="cuda")
        assert x.is_cuda and not launch_directly(x)
    assert launch_directly(x)
    assert not launch_directly(torch.empty(4))
    assert not launch_directly(torch.empty(4, device=META))


# -- collectives: a real world against the counting mesh ----------------------------

BATCH, SEQ, SEED = 4, 32, 0
CASES = [("starcoder2-3b", False), ("qwen2-moe-a2.7b", False),
         ("starcoder2-3b", True)]


#: one train cell a profile of the reference's other two: the dense arch
#: (remat) on the profile's rules
PROFILE_CASES = ("dp_sp", "seq_sp")


def _trainer(arch, mesh, fsdp):
    cfg = dataclasses.replace(get(arch).reduced(),
                              remat=arch == "starcoder2-3b")
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        data=DataConfig(cfg.vocab_size, SEQ, BATCH, seed=SEED), n_steps=1),
        mesh=mesh, seed=SEED, device="cpu", fsdp=fsdp)


#: the decode steps a world counts: a dense arch, its chunked path, the
#: windowed hybrid, xlstm's states by heads, the MoE's experts
DECODE_CASES = [("starcoder2-3b", 1), ("starcoder2-3b", 3), ("hymba-1.5b", 1),
                ("xlstm-350m", 1), ("qwen2-moe-a2.7b", 1)]


def _decode_stats(arch, s1, mesh):
    """The collectives of two decode steps of ``s1`` tokens of the reduced
    ``arch`` on ``mesh`` (zeros for tokens: a counting mesh's collectives
    return zeros, and the step's ops do not depend on the values)."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import make_serve_step
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(SEED, device="cpu")
    model.shard(net, mesh)
    caches = model.init_cache(BATCH, 16, device="cpu", mesh=mesh)
    step = make_serve_step(model, mesh)
    rows = BATCH // mesh.axis_size(mesh.batch_axes)
    pg.reset_collective_stats()
    for _ in range(2):
        _, caches = step(net, torch.zeros((rows, s1), dtype=torch.long),
                         caches)
    st = pg.collective_stats()
    return st["calls_by_kind"], st["bytes_by_kind"]


def _count_rank(rank, world, device, shape):
    from repro_torch.launch.mesh import counting_mesh, make_mesh
    torch.set_num_threads(1)
    real = make_mesh(1, *shape)
    out = {}
    for arch, fsdp in CASES:
        seen = []
        for mesh in (real, counting_mesh(shape, rank)):
            tr = _trainer(arch, mesh, fsdp)
            batch = tr.batch_at(0)
            pg.reset_collective_stats()
            tr.train_step(batch)
            st = pg.collective_stats()
            seen.append((st["calls_by_kind"], st["bytes_by_kind"]))
        out[f"{arch}{'-fsdp' if fsdp else ''}"] = seen
    for arch, s1 in DECODE_CASES:
        out[f"decode-{arch}-{s1}"] = [
            _decode_stats(arch, s1, mesh)
            for mesh in (real, counting_mesh(shape, rank))]
    for profile in PROFILE_CASES:
        rules = rules_for("starcoder2-3b", profile)
        seen = []
        for mesh in (real.with_rules(rules),
                     counting_mesh(shape, rank).with_rules(rules)):
            tr = _trainer("starcoder2-3b", mesh, False)
            batch = tr.batch_at(0)
            pg.reset_collective_stats()
            tr.train_step(batch)
            st = pg.collective_stats()
            seen.append((st["calls_by_kind"], st["bytes_by_kind"]))
        out[f"profile-{profile}"] = seen
    return out


@pytest.fixture(scope="module")
def counted_world(tmp_path_factory):
    return spawn(_count_rank, 4, init_dir=str(
        tmp_path_factory.mktemp("count_world")), timeout_s=600,
        args=((2, 2),))


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", [f"{a}{'-fsdp' if f else ''}"
                                  for a, f in CASES])
def test_counting_mesh_counts_what_the_world_sends(counted_world, case,
                                                   rank):
    real, counted = counted_world[rank][case]
    assert real == counted
    calls, nbytes = real
    assert set(calls) >= {"all-reduce", "all-gather"}
    if case.endswith("fsdp"):
        assert calls.get("reduce-scatter", 0) > 0
    assert all(v > 0 for v in nbytes.values())


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("profile", PROFILE_CASES)
def test_counting_mesh_counts_what_a_profile_sends(counted_world, profile,
                                                   rank):
    """A train step of the dense arch on the (1, 2, 2) world under
    ``dp_sp`` (the gradients averaged over both axes, ZeRO-1 over both)
    and ``seq_sp`` (the rows gathered into each block, the blocks' partial
    sums reduce-scattered) sends what the counting mesh records."""
    real, counted = counted_world[rank][f"profile-{profile}"]
    assert real == counted
    calls, nbytes = real
    assert calls["all-reduce"] > 0 and calls["all-gather"] > 0
    if profile == "seq_sp":
        assert calls["reduce-scatter"] > 0
    else:
        assert "reduce-scatter" not in calls
    assert all(v > 0 for v in nbytes.values())


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", [f"{a}-{s1}" for a, s1 in DECODE_CASES])
def test_counting_mesh_counts_what_a_decode_sends(counted_world, case,
                                                  rank):
    """Two decode steps on the world's (1, 2, 2) mesh send, by kind, the
    calls and operand bytes the counting mesh records for the same rank:
    the combine's all-reduces (max, then sum) where the cache is cut on
    its slots, the heads' all-gathers, and the tensor-parallel blocks'
    partial outputs summed."""
    real, counted = counted_world[rank][f"decode-{case}"]
    assert real == counted
    calls, _ = real
    if case.startswith("xlstm"):
        # no KV cache; a step: the embedding's rows summed, the mLSTM's
        # and the sLSTM's partial outputs summed (both blocks
        # tensor-parallel), the logits gathered
        assert calls["all-gather"] == 2 and calls["all-reduce"] == 2 * 3
    else:
        assert calls.get("all-reduce", 0) >= 2 * 2  # the combine, a layer


def test_arctic_count_gathers_no_expert_bank(monkeypatch, tmp_path):
    """arctic-480b's train step (two layers) and prefill (every layer:
    FSDP) on rank 0 of (16, 16), counted on meta: no all-gather over
    ``model`` takes an expert bank's block (8 of its 128 experts a rank);
    under FSDP the banks are gathered over ``data`` only.  The layout
    choice's plan goes to a temporary cache, not the checkout's."""
    import repro_torch.tuner as tuner_mod
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import counting_mesh
    tuner = tuner_mod.Tuner(plan_dir=str(tmp_path))
    monkeypatch.setattr(tuner_mod, "default_tuner", lambda: tuner)
    mesh = counting_mesh((16, 16))
    seen = []
    orig = pg.all_gather

    def recorded(x, group=None, *, dim=0):
        seen.append((tuple(x.shape), group is mesh.group("model")))
        return orig(x, group, dim=dim)

    monkeypatch.setattr(pg, "all_gather", recorded)
    for shape, layers in (("train_4k", 2), ("prefill_32k", None)):
        with shd.use_mesh(mesh):
            fn, args, _, meta = specs.step_and_specs(
                "arctic-480b", shape, mesh, layers=layers)
        net = args[0]
        banks = {tuple(p.shape) for n, p in net.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("w_up", "w_gate", "w_down")}
        modes = {p.placement.mode for n, p in net.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("w_up", "w_gate", "w_down")}
        assert modes == {"ep"} and meta["fsdp"] is (layers is None)
        seen.clear()
        rl.count_step(lambda: fn(*args), args)
        over_model = {s for s, model in seen if model}
        assert over_model and not over_model & banks
        if meta["fsdp"]:
            # the banks' FSDP blocks gathered over data: 8 experts whole
            assert (8, 7168, 4864) in {s[:1] + (s[1] * 16,) + s[2:]
                                       for s, model in seen
                                       if not model and len(s) == 3}


# -- the entry point ---------------------------------------------------------------

CLI = textwrap.dedent(r"""
    import runpy, sys
    sys.path.insert(0, sys.argv[1])
    sys.argv = ["dryrun"] + sys.argv[2:]
    try:
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
    except SystemExit as e:
        code = e.code
    print("JAX_IMPORTED", "jax" in sys.modules, "EXIT", code)
""")


def _cli(tmp_path, *args):
    env = dict(os.environ)
    env.update(REPRO_TORCH_PLAN_DIR=str(tmp_path / "plans"),
               REPRO_TORCH_ARTIFACTS=str(tmp_path / "art"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", CLI, SRC, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_the_cli_writes_a_record_without_jax(tmp_path):
    t0 = time.perf_counter()
    res = _cli(tmp_path, "--arch", "whisper-tiny", "--shape", "train_4k",
               "--mesh", "pod", "--out", str(tmp_path / "out"))
    wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_IMPORTED False EXIT 0" in res.stdout
    assert wall < 60
    with open(tmp_path / "out" / "pod" / "whisper-tiny@train_4k.json") as f:
        rec = json.load(f)
    ref_keys = set(ref_rl.RooflineTerms.__dataclass_fields__) | {
        "compute_term", "memory_term", "collective_term", "dominant",
        "bound_time", "useful_flops_fraction", "roofline_fraction",
        "arch", "shape", "kind", "fsdp", "opt_state_dtype", "microbatches",
        "grad_accum_dtype", "params", "active_params", "lower_s",
        "compile_s", "fits_hbm"}
    assert ref_keys <= set(rec)
    assert rec["device"] == "meta" and rec["lowered"] and rec["fits_hbm"]
    assert rec["chips"] == 256 and rec["machine"] == "h100-sxm"
    assert set(rec["memory_analysis"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "total_bytes"}
    assert rec["flops"] > 0 and rec["collective_bytes"] > 0
    from repro_torch.benchmarks import roofline_table
    cells = roofline_table.load_cells("pod", str(tmp_path / "out"))
    assert [c["arch"] for c in cells] == ["whisper-tiny"]
    table = roofline_table.markdown_table(cells)
    assert "| whisper-tiny | train_4k |" in table
    agg = roofline_table.main(str(tmp_path / "out"))
    assert agg["pod"]["n_cells"] == 1


def test_the_cli_writes_a_profile_record_without_jax(tmp_path):
    """``--profile seq_sp`` counts the cell under the reference's
    Megatron-SP rules and says so in the record, with JAX absent."""
    res = _cli(tmp_path, "--arch", "whisper-tiny", "--shape", "train_4k",
               "--mesh", "pod", "--profile", "seq_sp", "--out",
               str(tmp_path / "seq"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_IMPORTED False EXIT 0" in res.stdout
    with open(tmp_path / "seq" / "pod" / "whisper-tiny@train_4k.json") as f:
        rec = json.load(f)
    assert rec["profile"] == "seq_sp" and rec["lowered"]
    assert rec["collective_bytes"] > 0


def test_the_roofline_bench_emits_the_records(tmp_path, monkeypatch,
                                             capsys):
    """``run.py --only roofline`` over the dry run's records: one line a
    mesh and one a train cell, and its JSON stamped."""
    from repro_torch.benchmarks import run
    res = _cli(tmp_path, "--arch", "whisper-tiny", "--mesh", "both")
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path / "art"))
    out = run.bench_roofline()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        "roofline_pod", "roofline_multipod",
        "roofline_cell_whisper-tiny@train_4k"]
    assert out["pod"]["n_cells"] == 3 and "n_not_lowered" not in out["pod"]
    with open(tmp_path / "art" / "bench_torch" / "roofline.json") as f:
        assert "_meta" in json.load(f)


def test_a_decode_cell_is_recorded_not_lowered(tmp_path):
    """A decode cell is counted (no longer recorded unlowered): one
    serving step of the rank, with the KV cache's combine over ``model``
    (an all-reduce of the row maxima and one of the sums) in its
    collectives."""
    res = _cli(tmp_path, "--arch", "hymba-1.5b", "--shape", "decode_32k",
               "--mesh", "both", "--out", str(tmp_path / "out"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "EXIT 0" in res.stdout and "2 counted, 0 failed" in res.stdout
    with open(tmp_path / "out" / "multipod" / "hymba-1.5b@decode_32k.json") \
            as f:
        rec = json.load(f)
    assert rec["lowered"] is True and rec["cache_len"] == 1024
    assert "not_lowered" not in rec and rec["chips"] == 512
    assert rec["batch_rows"] == 4 and rec["flops"] > 0
    # two all-reduces a layer in the attention's combine, one in its
    # tensor-parallel output or none (25 heads do not divide 16)
    assert rec["collective_counts"]["all-reduce"] >= 2 * 32
    assert rec["memory_analysis"]["argument_bytes"] > 0


def test_device_cuda_without_a_card_exits_non_zero(tmp_path):
    res = _cli(tmp_path, "--arch", "whisper-tiny", "--shape", "train_4k",
               "--device", "cuda", "--out", str(tmp_path / "out"))
    assert "EXIT 0" not in res.stdout
    assert "needs a GPU" in res.stdout + res.stderr
    assert not (tmp_path / "out" / "pod").exists()
