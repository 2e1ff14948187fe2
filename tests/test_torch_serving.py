"""The port's serving package against the reference's, on the CPU.

The pure-Python parts (block manager, cost model and its refit, policies,
``Tuner.serve_chunk``, simulated scheduling and trace replay, ``obs/watch``)
are copies: the same inputs give the same outputs, compared exactly (1e-12
relative for floating-point results).  The model backend is rewritten for
PyTorch: its greedy tokens are held to the reference's on the reference's
parameters (qwen1.5-4b reduced, fp32), and to its own single-request
generation under join and evict.
"""

import dataclasses
import os
import random
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import serving as ref_serving
from repro import telemetry as ref_tel
from repro import training as ref_training
from repro.configs import ARCHS
from repro.configs import get as ref_get
from repro.core import machine as ref_machine
from repro.models import build_model as ref_build
from repro.tuner import Tuner as RefTuner
from repro_torch import obs, serving, telemetry
from repro_torch.configs import get
from repro_torch.core import machine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params
from repro_torch.serving import (Engine, ModelBackend, ModelGuidedPolicy,
                                 Request, Scheduler, SchedulerConfig,
                                 ServeConfig)
from repro_torch.serving.scheduler import token_int
from repro_torch.tuner import PlanCache, Tuner

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCH = "qwen1.5-4b"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
    for mod in (obs, telemetry, ref_tel):
        mod.reset()
    yield
    for mod in (obs, telemetry, ref_tel):
        mod.reset()


@pytest.fixture(scope="module")
def tiny():
    """(reference model, params, port model, net): reduced qwen1.5-4b,
    the reference's parameters in both."""
    ref_model = ref_build(ref_get(ARCH).reduced())
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(get(ARCH).reduced())
    net = model.init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    return ref_model, params, model, net


def _ref_generate(tiny, prompt, **cfg):
    ref_model, params, _, _ = tiny
    out = ref_serving.Engine(ref_model, params,
                             ref_serving.ServeConfig(**cfg)).generate(
        jnp.asarray(prompt, jnp.int32))
    return np.asarray(out)


def _generate(tiny, prompt, **cfg):
    _, _, model, net = tiny
    return Engine(model, net, ServeConfig(**cfg)).generate(
        torch.as_tensor(np.asarray(prompt), dtype=torch.long)).numpy()


# -- the block manager ---------------------------------------------------------

def _block_ops(bm, seed, num_blocks):
    """One seeded sequence of block-manager operations; returns what each
    step observed (tables, counts, raised errors, defrag maps)."""
    rng = random.Random(seed)
    live, seen = [], []
    for i in range(60):
        op = rng.choice(["alloc", "alloc", "extend", "append", "free",
                         "defrag"])
        res = None
        if op == "alloc":
            rid, need = f"r{seed}-{i}", rng.randint(1, num_blocks * 8)
            try:
                res = bm.allocate(rid, need)
                live.append(rid)
            except RuntimeError as exc:
                res = type(exc).__name__
        elif op == "extend" and live:
            rid, need = rng.choice(live), rng.randint(1, 16)
            try:
                res = bm.extend(rid, need)
            except RuntimeError as exc:
                res = type(exc).__name__
        elif op == "append" and live:
            bm.append_tokens(rng.choice(live), rng.randint(1, 12))
        elif op == "free" and live:
            res = bm.free(live.pop(rng.randrange(len(live))))
        elif op == "defrag":
            res = sorted(bm.defrag().items())
        bm.check()
        seen.append((op, res, bm.free_blocks, bm.utilization(),
                     bm.fragmentation(),
                     {r: (bm.block_table(r), bm.n_tokens(r))
                      for r in bm.requests()}))
    return seen


@given(seed=st.integers(0, 63), num_blocks=st.sampled_from([3, 8, 17]))
@settings(max_examples=24, deadline=None)
def test_block_manager_op_sequences_equal_the_reference(seed, num_blocks):
    got = _block_ops(serving.BlockManager(num_blocks, 8), seed, num_blocks)
    want = _block_ops(ref_serving.BlockManager(num_blocks, 8), seed,
                      num_blocks)
    assert got == want
    assert serving.blocks_for(17, 16) == ref_serving.blocks_for(17, 16) == 2


# -- the cost model, its refit, serve_chunk --------------------------------

MACHINES = ["cpu-host", "tpu-v5e", "h100-sxm"]


def _machines(name):
    port = {m.name: m for m in (machine.CPU_HOST, machine.TPU_V5E,
                                machine.H100_SXM)}[name]
    ref = {m.name: m for m in (ref_machine.CPU_HOST, ref_machine.TPU_V5E)}
    # the reference has no h100-sxm: it gets the port's profile's fields
    return port, ref.get(name) or ref_machine.Machine(
        **{f.name: getattr(port, f.name)
           for f in dataclasses.fields(ref_machine.Machine)})


def _close(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


@pytest.mark.parametrize("name", MACHINES)
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "starcoder2-3b",
                                  "hymba-1.5b", "qwen2-moe-a2.7b"])
def test_cost_model_predictions_equal_the_reference(arch, name):
    port_m, ref_m = _machines(name)
    for reduced in (True, False):
        cfg, ref_cfg = get(arch), ref_get(arch)
        if reduced:
            cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
        got = serving.ServeCostModel(cfg, port_m)
        want = ref_serving.ServeCostModel(ref_cfg, ref_m)
        assert got.scales.to_dict() == want.scales.to_dict()
        for prefill, ctxs in (([(512, 0)], []), ([], [128] * 8),
                              ([(96, 32), (7, 0)], [5, 4000, 77]),
                              ([(4096, 0)], [2048] * 6)):
            _close(got.predict_step(prefill, ctxs).to_dict(),
                   want.predict_step(prefill, ctxs).to_dict())
        assert got.request_prefill_cost(1000) == pytest.approx(
            want.request_prefill_cost(1000), rel=1e-12)
        assert got.request_decode_cost(1000, 32) == pytest.approx(
            want.request_decode_cost(1000, 32), rel=1e-12)


def _serve_records(tel_mod, cm, *, a_pf, a_dc, b):
    recs = []
    rng = np.random.default_rng(0)
    for _ in range(24):
        chunks = [(int(rng.integers(8, 200)), int(rng.integers(0, 64)))]
        ctxs = [int(c) for c in rng.integers(16, 256,
                                             size=int(rng.integers(1, 8)))]
        pred = cm.predict_step(chunks, ctxs)
        recs.append(tel_mod.RunRecord(
            fingerprint="f", machine=cm.machine.name, op="serve_step",
            variant="model", n=chunks[0][0], p=len(ctxs), c=1,
            kind="serve_step",
            phases={"prefill": a_pf * pred.prefill_s + b,
                    "decode": a_dc * pred.decode_s + b},
            predicted={"prefill": pred.prefill_s, "decode": pred.decode_s,
                       "total": pred.total_s}))
    return recs


@pytest.mark.parametrize("a_pf,a_dc,b", [(1.8, 2.6, 2e-4), (1.0, 1.0, 0.0),
                                         (0.5, 3.0, 1e-3)])
def test_refit_serving_equals_the_reference(a_pf, a_dc, b):
    cfg, ref_cfg = get(ARCH).reduced(), ref_get(ARCH).reduced()
    cm = serving.ServeCostModel(cfg, machine.CPU_HOST)
    ref_cm = ref_serving.ServeCostModel(ref_cfg, ref_machine.CPU_HOST)
    got = serving.refit_serving(
        _serve_records(telemetry, cm, a_pf=a_pf, a_dc=a_dc, b=b), cm)
    want = ref_serving.refit_serving(
        _serve_records(ref_tel, ref_cm, a_pf=a_pf, a_dc=a_dc, b=b), ref_cm)
    g, w = got.to_dict(), want.to_dict()
    assert g["n_rows"] == w["n_rows"] == 48
    _close(g["scales"], w["scales"])
    for key in ("mean_rel_err_before", "mean_rel_err_after"):
        assert g[key] == pytest.approx(w[key], rel=1e-12)
    cal = cm.with_scales(got.scales)
    assert cal.decode_step([100] * 4).decode_s == pytest.approx(
        ref_cm.with_scales(want.scales).decode_step([100] * 4).decode_s,
        rel=1e-12)


def test_serve_step_records_self_join_in_both_packages():
    """The scheduler's serve_step records join against their own
    predictions (source "serve") in either package, identically."""
    from repro.telemetry import residuals as ref_res
    from repro_torch.telemetry import residuals
    cm = serving.ServeCostModel(get(ARCH).reduced(), machine.CPU_HOST)
    recs = _serve_records(telemetry, cm, a_pf=1.3, a_dc=0.7, b=1e-5)
    rows = residuals.join(recs)
    ref_rows = ref_res.join([ref_tel.RunRecord.from_dict(r.to_dict())
                             for r in recs])
    assert len(rows) == len(ref_rows) == 48
    assert all(r.source == "serve" for r in rows)
    assert [dataclasses.asdict(r) for r in rows] == \
        [dataclasses.asdict(r) for r in ref_rows]


def test_serve_chunk_equals_the_reference(tmp_path):
    """``Tuner.serve_chunk`` sizes a prefill chunk to a step budget as the
    reference's does, over budgets, granularities and chunks already
    packed into the step."""
    cfg, ref_cfg = get(ARCH).reduced(), ref_get(ARCH).reduced()
    cm = serving.ServeCostModel(cfg, machine.CPU_HOST)
    ref_cm = ref_serving.ServeCostModel(ref_cfg, ref_machine.CPU_HOST)
    port = Tuner(cache=PlanCache(str(tmp_path / "port")))
    ref = RefTuner(cache=__import__("repro.tuner", fromlist=["PlanCache"])
                   .PlanCache(str(tmp_path / "ref")))
    whole = cm.prefill_step([(512, 0)]).prefill_s
    seen = set()
    for budget in (whole * 2, whole, whole / 4, whole / 64, 0.0):
        for g in (1, 8, 32):
            for base in ((), ((64, 0),), ((128, 16), (8, 0))):
                kw = dict(ctx0=3, budget_s=budget, granularity=g,
                          base_prefill=base)
                n = port.serve_chunk(512, cost=cm, **kw)
                assert n == ref.serve_chunk(512, cost=ref_cm, **kw)
                seen.add(n)
    assert 512 in seen and 0 in seen and len(seen) > 3
    assert port.serve_chunk(0, ctx0=0, cost=cm, budget_s=1.0) == 0


# -- simulated scheduling and trace replay ------------------------------------

def test_trace_replay_and_policy_comparison_equal_the_reference():
    """One synthesized trace replayed under both policies on the simulated
    clock: the same requests, the same reports, field by field."""
    tc = dict(n_requests=300, seed=2, arrival_rate=8.0)
    trace = serving.synthesize_trace(serving.TraceConfig(**tc))
    ref_trace = ref_serving.synthesize_trace(ref_serving.TraceConfig(**tc))
    assert [dataclasses.asdict(r) for r in trace] == \
        [dataclasses.asdict(r) for r in ref_trace]
    cm = serving.ServeCostModel(get(ARCH).reduced(), machine.CPU_HOST)
    ref_cm = ref_serving.ServeCostModel(ref_get(ARCH).reduced(),
                                        ref_machine.CPU_HOST)
    got = serving.compare_policies(trace, cm, step_budget_s=0.06)
    want = ref_serving.compare_policies(ref_trace, ref_cm,
                                        step_budget_s=0.06)
    assert set(got) == set(want) == {"fifo", "model"}
    for name in want:
        assert got[name].to_dict() == want[name].to_dict(), name
    assert got["model"].ttft_p95_s < got["fifo"].ttft_p95_s


def test_sim_scheduler_steps_equal_the_reference():
    """The SimBackend scheduler with arrivals, EOS at ``output_len``,
    deadlines and a bounded queue: the same step reports and request
    metrics in both packages."""
    def run(pkg, cfg, mach):
        sched = pkg.Scheduler(
            pkg.SimBackend(), pkg.ServeCostModel(cfg, mach),
            pkg.SchedulerConfig(max_cache_len=256, max_batch=4,
                                max_queue=3))
        for i, (plen, out) in enumerate([(12, 4), (30, 6), (7, 2), (50, 5),
                                         (200, 3), (9, 9), (64, 1)]):
            sched.submit(pkg.Request(
                rid=f"s{i}", prompt_len=plen, max_new_tokens=out,
                output_len=out, eos_id=1, arrival_s=0.01 * (i % 3),
                deadline_s=0.5 if i == 4 else None))
        reps = sched.run()
        steps = [(r.step, r.clock, r.plan.prefill, r.plan.decode,
                  r.admitted, r.finished, r.queue_depth, r.kv_blocks_used)
                 for r in reps]
        return steps, sorted(sched.request_metrics(),
                             key=lambda m: m["rid"]), sched.blocks.free_blocks

    got = run(serving, get(ARCH).reduced(), machine.CPU_HOST)
    want = run(ref_serving, ref_get(ARCH).reduced(), ref_machine.CPU_HOST)
    assert got == want


# -- the model backend -----------------------------------------------------------

def test_join_evict_tokens_equal_the_reference(tiny):
    """Requests joining and leaving the running batch mid-decode: each
    request's tokens equal the reference's greedy tokens for that request
    alone, and the port's own single-request generation; every block
    returns to the pool."""
    _, _, model, net = tiny
    prompts = {"a": [[1, 2, 3, 4, 5]], "b": [[9, 8, 7]],
               "c": [[11, 12, 13, 14, 15, 16, 17]]}
    new_tokens = {"a": 6, "b": 4, "c": 5}
    ref, alone = {}, {}
    for rid, p in prompts.items():
        kw = dict(max_new_tokens=new_tokens[rid], max_cache_len=64)
        ref[rid] = _ref_generate(tiny, p, **kw)[0, len(p[0]):]
        alone[rid] = _generate(tiny, p, **kw)[0, len(p[0]):]
    backend = ModelBackend(model, net, max_cache_len=64)
    cost = serving.cost_model_for(model.cfg, machine.CPU_HOST)
    sched = Scheduler(backend, cost,
                      SchedulerConfig(max_cache_len=64, max_batch=4),
                      policy=ModelGuidedPolicy(step_budget_s=0.05))

    def req(rid):
        return Request(rid=rid, prompt=torch.tensor(prompts[rid]),
                       max_new_tokens=new_tokens[rid])
    sched.submit(req("a"))
    sched.step()                 # a mid-stream before b exists
    sched.step()
    sched.submit(req("b"))
    sched.step()                 # b joins while a decodes
    sched.submit(req("c"))
    reps = sched.run()           # b evicts first, then a, then c
    assert max(r.decode_batch for r in reps) >= 2
    assert sched.idle and not sched.active
    for rid in prompts:
        got = np.asarray([token_int(t) for t in sched.finished[rid].out])
        assert np.array_equal(got, ref[rid]), rid
        assert np.array_equal(got, alone[rid]), rid
    assert sched.blocks.free_blocks == sched.cfg.num_blocks


def test_greedy_generation_equals_the_reference(tiny):
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6]]
    kw = dict(max_new_tokens=8, max_cache_len=64)
    out1, out2 = _generate(tiny, prompts, **kw), _generate(tiny, prompts,
                                                           **kw)
    assert out1.shape == (2, 12) and np.array_equal(out1, out2)
    assert np.array_equal(out1, _ref_generate(tiny, prompts, **kw))


@pytest.mark.parametrize("max_cache_len,chunk", [(64, None), (24, 16)])
def test_chunked_prefill_equals_per_token(tiny, max_cache_len, chunk):
    """Chunked prefill (the tuner's chunk, or 16 with a prompt longer than
    the ring so that chunks stop at its end and the tail goes one token at
    a time) gives the per-token path's tokens, and the reference's."""
    _, _, model, net = tiny
    assert model.supports_chunked_prefill
    s = 21 if chunk is None else 40
    prompts = np.random.default_rng(0 if chunk is None else 1).integers(
        1, model.cfg.vocab_size, (2 if chunk is None else 1, s))
    kw = dict(max_new_tokens=4, max_cache_len=max_cache_len)
    eng = Engine(model, net, ServeConfig(prefill_chunk=chunk, **kw))
    assert eng._prefill_chunk(s) > 1
    per_token = _generate(tiny, prompts, prefill_chunk=1, **kw)
    assert np.array_equal(_generate(tiny, prompts, prefill_chunk=chunk, **kw),
                          per_token)
    assert np.array_equal(per_token, _ref_generate(
        tiny, prompts, prefill_chunk=chunk, **kw))


@pytest.mark.parametrize("s", [21, 45])
def test_moe_prefill_tail_equals_the_reference(s):
    """qwen2-moe at its published capacity factor: a prefill chunk is one
    routing group, so a prompt whose tail is shorter than the tuner's chunk
    (16 for 21 tokens, 32 for 45) must step that tail one token at a time,
    as the reference does; a shorter chunk would drop routed tokens."""
    arch = "qwen2-moe-a2.7b"
    ref_model = ref_build(ref_get(arch).reduced())
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(get(arch).reduced())
    assert model.cfg.moe.capacity_factor == 1.25
    net = model.init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    prompts = np.random.default_rng(s).integers(1, model.cfg.vocab_size,
                                                (2, s))
    kw = dict(max_new_tokens=6, max_cache_len=64)
    assert Engine(model, net, ServeConfig(**kw))._prefill_chunk(s) < s
    got = Engine(model, net, ServeConfig(**kw)).generate(
        torch.as_tensor(prompts, dtype=torch.long)).numpy()
    want = np.asarray(ref_serving.Engine(
        ref_model, params, ref_serving.ServeConfig(**kw)).generate(
        jnp.asarray(prompts, jnp.int32)))
    assert np.array_equal(got, want)


def test_recurrent_arch_takes_one_token_steps():
    model = build_model(get("xlstm-350m").reduced())
    net = model.init(1, device="cpu")
    eng = Engine(model, net, ServeConfig(max_new_tokens=5, max_cache_len=32,
                                         prefill_chunk=8))
    assert not model.supports_chunked_prefill
    assert eng._prefill_chunk(16) == 1
    out = eng.generate(torch.tensor([[5, 6, 7]])).numpy()
    assert out.shape == (1, 8)
    assert ((out >= 0) & (out < model.cfg.vocab_size)).all()


def test_no_wasted_final_decode_step(tiny):
    """m tokens take exactly m - 1 decode token-steps (the first comes from
    the prefill's logits) and the prefill covers the prompt once."""
    _, _, model, net = tiny
    m = 5
    sched = Scheduler(ModelBackend(model, net, max_cache_len=32),
                      serving.cost_model_for(model.cfg, machine.CPU_HOST),
                      SchedulerConfig(max_cache_len=32, max_batch=2))
    sched.submit(Request(rid="x", prompt=torch.tensor([[1, 2, 3, 4]]),
                         max_new_tokens=m))
    reports = sched.run()
    assert sum(len(r.plan.decode) for r in reports) == m - 1
    assert sum(n for r in reports for _, n in r.plan.prefill) == 4
    assert len(sched.finished["x"].out) == m


def test_eos_stops_generation_early_and_pads(tiny):
    prompt = [[3, 1, 4, 1, 5]]
    ref = _generate(tiny, prompt, max_new_tokens=6, max_cache_len=64)
    eos = int(ref[0, 5 + 2])                 # the third generated token
    out = _generate(tiny, prompt, max_new_tokens=6, max_cache_len=64,
                    eos_id=eos)
    assert out.shape == ref.shape
    assert np.array_equal(out[0, :5 + 3], ref[0, :5 + 3])
    assert (out[0, 5 + 3:] == eos).all()
    padded = _generate(tiny, prompt, max_new_tokens=6, max_cache_len=64,
                       stop_ids=(eos,), pad_id=0)
    assert np.array_equal(padded[0, :5 + 3], ref[0, :5 + 3])
    assert (padded[0, 5 + 3:] == 0).all()
    assert np.array_equal(out, _ref_generate(
        tiny, prompt, max_new_tokens=6, max_cache_len=64, eos_id=eos))


def test_seeded_sampling_is_deterministic(tiny):
    """temperature > 0 draws from a generator seeded per request: the same
    seed gives the same tokens, another seed other tokens, and each row of
    a batch draws from its own (seed + row)."""
    _, _, model, net = tiny
    prompts = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4]])
    eng = Engine(model, net, ServeConfig(max_new_tokens=12, max_cache_len=64,
                                         temperature=1.0))
    a = eng.generate(prompts, seed=5).numpy()
    b = eng.generate(prompts, seed=5).numpy()
    c = eng.generate(prompts, seed=6).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(a[1], c[0])          # both drew with seed 6
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a, c)


def test_engine_cfg_default_not_shared(tiny):
    _, _, model, net = tiny
    e1, e2 = Engine(model, net), Engine(model, net)
    assert e1.cfg is not e2.cfg
    e1.cfg.max_new_tokens = 7
    assert e2.cfg.max_new_tokens == 32


def test_serve_step_records_load_in_either_package(tiny, tmp_path):
    """With telemetry on, a generate call records one "serve" run and one
    "serve_step" run a step (measured phases beside the cost model's
    prediction); the reference's store loads the port's records and the
    port's store the reference's, field for field."""
    _, _, model, net = tiny
    store = telemetry.RunStore(str(tmp_path / "port"))
    telemetry.enable(store)
    _generate(tiny, [[1, 2, 3]], max_new_tokens=3, max_cache_len=16)
    telemetry.disable()
    ref_store = ref_tel.RunStore(str(tmp_path / "ref"))
    ref_tel.enable(ref_store)
    _ref_generate(tiny, [[1, 2, 3]], max_new_tokens=3, max_cache_len=16)
    ref_tel.disable()
    for written, other in ((store, ref_tel.RunStore(store.directory)),
                           (ref_store,
                            telemetry.RunStore(ref_store.directory))):
        recs, loaded = written.load(), other.load()
        kinds = sorted(r.kind for r in recs)
        assert kinds == ["serve"] + ["serve_step"] * (len(recs) - 1)
        assert len(recs) == 4                   # prefill + 2 decode steps
        assert [r.to_dict() for r in loaded] == [r.to_dict() for r in recs]
        steps = [r for r in recs if r.kind == "serve_step"]
        assert all(set(r.predicted) == {"prefill", "decode", "total"}
                   for r in steps)
        assert all(v > 0 for r in steps for v in r.phases.values())
    [serve] = [r for r in store.load() if r.kind == "serve"]
    assert serve.machine == "cpu-host" and serve.variant == ARCH


# -- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launch_serve_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [eval(line.split("] ", 1)[1]) for line in lines[:2]]
    assert [len(r) for r in rows] == [9, 9]
    assert all(0 <= t < 256 for r in rows for t in r)
    assert lines[2].startswith(f"serve {arch} B=2 S=6 new=3 on cpu")


def test_launch_serve_refuses_a_checkpoint_dir(tmp_path):
    """A directory that holds no committed checkpoint is refused."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])


def test_launch_serve_from_a_checkpoint_of_the_reference(tmp_path, capsys):
    """``--ckpt-dir`` serves the newest step the reference's trainer wrote:
    the reference's greedy tokens on those parameters."""
    ref_cfg = ref_get(ARCH).reduced()
    tc = ref_training.TrainConfig(
        model=ref_cfg,
        opt=ref_training.AdamWConfig(lr=1e-2, total_steps=3, warmup_steps=1),
        data=ref_training.DataConfig(vocab_size=ref_cfg.vocab_size,
                                     seq_len=16, global_batch=2),
        n_steps=3, checkpoint_dir=str(tmp_path), checkpoint_every=100)
    ref_tr = ref_training.Trainer(tc)
    ref_tr.run()
    batch, plen, new = 2, 6, 5
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", str(batch), "--prompt-len", str(plen),
                       "--new-tokens", str(new), "--ckpt-dir",
                       str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    got = [eval(line.split("] ", 1)[1]) for line in lines[:batch]]
    prompts = np.random.default_rng(0).integers(0, ref_cfg.vocab_size,
                                                (batch, plen))
    want = np.asarray(ref_serving.Engine(
        ref_build(ref_cfg), ref_tr.params, ref_serving.ServeConfig(
            max_new_tokens=new, max_cache_len=plen + new + 8)).generate(
        jnp.asarray(prompts, jnp.int32)))
    assert got == want.tolist()
    # the trained parameters, not the seed's draw
    fresh = np.asarray(ref_serving.Engine(
        ref_build(ref_cfg), ref_build(ref_cfg).init(jax.random.PRNGKey(0)),
        ref_serving.ServeConfig(max_new_tokens=new,
                                max_cache_len=plen + new + 8)).generate(
        jnp.asarray(prompts, jnp.int32)))
    assert got != fresh.tolist()


# -- obs/watch --------------------------------------------------------------------

WATCH_TESTS = os.path.join(ROOT, "tests", "test_watch.py")


def _watch_cases():
    """The reference's obs/watch test cases, as ``Class::test`` ids."""
    cases, cls = [], None
    with open(WATCH_TESTS) as f:
        for line in f:
            m = re.match(r"class (Test\w+)", line)
            if m:
                cls = m.group(1)
            m = re.match(r"    def (test_\w+)", line)
            if m and cls:
                cases.append(f"{cls}::{m.group(1)}")
    return cases


@pytest.fixture(scope="module")
def watch_results(tmp_path_factory):
    """tests/test_watch.py with every import of the reference turned into
    the port's, its benchmark CLI (``benchmarks.run``) into the port's
    (``repro_torch.benchmarks.run``) and the reference's location
    variables into the port's (``REPRO_BENCH_HISTORY_DIR`` ->
    ``REPRO_TORCH_BENCH_HISTORY_DIR``), run in one pytest process: the
    outcome of each case."""
    d = tmp_path_factory.mktemp("watch")
    with open(WATCH_TESTS) as f:
        src = f.read()
    src = re.sub(r"\brepro\b(?=[ .])", "repro_torch", src)
    src = re.sub(r"\bREPRO_(ARTIFACTS|TELEMETRY_DIR|PLAN_DIR|"
                 r"BENCH_HISTORY_DIR)\b", r"REPRO_TORCH_\1", src)
    src = src.replace("import benchmarks.run",
                      "import repro_torch.benchmarks.run")
    assert "from repro " not in src and "repro." not in src
    path = d / "test_watch_on_the_port.py"
    path.write_text(src)
    junit = d / "junit.xml"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_OBS", None)
    env.pop("REPRO_TELEMETRY", None)
    subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                    "no:cacheprovider", "-p", "no:randomly",
                    f"--junitxml={junit}", str(path)],
                   cwd=str(d), env=env, capture_output=True, text=True,
                   timeout=300)
    import xml.etree.ElementTree as ET
    out = {}
    for tc in ET.parse(junit).iter("testcase"):
        name = f"{tc.get('classname').rsplit('.', 1)[-1]}::{tc.get('name')}"
        bad = [c.tag for c in tc if c.tag in ("failure", "error", "skipped")]
        out[name] = bad[0] if bad else "passed"
    return out


@pytest.mark.parametrize("case", _watch_cases())
def test_watch_case_passes_on_the_port(case, watch_results):
    assert watch_results.get(case) == "passed", case


def test_watch_detectors_and_slo_equal_the_reference():
    """The same seeded stream through both packages' detectors and SLO
    watcher: the same firings, the same burn-rate alerts and timeline."""
    from repro.obs import watch as ref_watch
    from repro_torch.obs import watch
    rng = np.random.default_rng(7)
    xs = np.concatenate([rng.normal(1.0, 0.05, 80),
                         rng.normal(1.6, 0.05, 40)]).tolist()
    xs[60] = 5.0                      # one spike for the quantile guard

    def detect(mod):
        out = []
        for cls in (mod.EWMADetector, mod.CUSUMDetector,
                    mod.RollingQuantileDetector):
            det = cls(mod.DetectorConfig())
            out.append([(i, repr(det.update(x))) for i, x in enumerate(xs)])
        return out

    def slo(mod):
        w = mod.SLOWatcher()
        fired = []
        for i in range(400):
            bad = 120 <= i < 260
            w.record_outcomes(float(i), ttft=not bad, tpot=True,
                              goodput=not bad)
            fired += [repr(a) for a in w.check(float(i))]
        return fired, repr(w.summary())

    got = detect(watch)
    assert got == detect(ref_watch)
    assert all(any(f != "None" for _, f in fired) for fired in got)
    fired, timeline = slo(watch)
    assert fired and (fired, timeline) == slo(ref_watch)
