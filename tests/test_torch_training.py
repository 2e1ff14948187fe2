"""The port's training package against the reference's, on the CPU.

The reference's own cases (``tests/test_training.py``: TestOptimizer,
TestData, TestCheckpoint, TestFaultTolerance with the deterministic
restart) run on the port's modules.  Then the port is held to the
reference directly: an AdamW and an Adafactor update on the same stacked
leaves (the reference's granularity: per-layer norm scales decayed, a
stacked (L, D) leaf factored, the RMS clip over the whole leaf) within
1e-6; ``bytes_batch`` exactly; one ``make_train_step`` step of reduced
qwen1.5-4b in fp32 on one numpy batch; checkpoints written by either
package and restored by the other; the launcher on the CPU.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.distributed.sharding import tree_paths as ref_tree_paths
from repro.models import build_model as ref_build
from repro import training as ref_training
from repro.training import checkpoint as ref_ckpt
from repro.training import data as ref_data
from repro_torch import training as port_training
from repro_torch.configs import get
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import (load_reference_params, nest,
                                        to_reference, tree_paths)
from repro_torch.training import (AdamWConfig, DataConfig, DataPipeline,
                                  FaultInjector, RecoveryPlanner,
                                  RescheduleRequested, RestartableLoop,
                                  RestartPolicy, StragglerConfig,
                                  StragglerMonitor, TrainConfig, Trainer,
                                  adamw_update, init_adamw, make_train_step)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression
from repro_torch.training import data as port_data
from repro_torch.training import trainer
from repro_torch.training.trainer import leaf_templates

ARCH = "qwen1.5-4b"


# -- the reference's cases on the port ----------------------------------------

class TestOptimizer:
    def _setup(self, kind="adamw", state_dtype="float32"):
        params = {"w": torch.ones((16, 32)), "b": torch.zeros((32,))}
        cfg = AdamWConfig(lr=1e-2, kind=kind, state_dtype=state_dtype,
                          warmup_steps=0, total_steps=100)
        state = init_adamw(cfg, params)
        grads = {"w": torch.ones((16, 32)) * 0.1,
                 "b": torch.ones((32,)) * 0.1}
        return cfg, params, state, grads

    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_update_moves_params(self, kind):
        cfg, params, state, grads = self._setup(kind)
        before = {k: v.clone() for k, v in params.items()}
        newp, newstate, metrics = adamw_update(cfg, grads, state, params)
        assert float((newp["w"] - before["w"]).abs().max()) > 0
        assert int(newstate.step) == 1
        assert np.isfinite(float(metrics["grad_norm"]))

    def test_adamw_descends_quadratic(self):
        cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, min_lr_ratio=1.0)
        params = {"x": torch.tensor([3.0, -2.0])}
        state = init_adamw(cfg, params)
        for _ in range(150):
            g = {"x": 2 * params["x"]}
            params, state, _ = adamw_update(cfg, g, state, params)
        assert float(params["x"].abs().max()) < 0.2

    def test_adafactor_state_is_factored(self):
        cfg, params, state, grads = self._setup("adafactor")
        leaves = state.nu["w"]
        assert set(leaves) == {"vr", "vc"}
        assert leaves["vr"].shape == (16,)
        assert leaves["vc"].shape == (32,)

    def test_grad_clip(self):
        cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
        params = {"w": torch.zeros((8, 8))}
        state = init_adamw(cfg, params)
        huge = {"w": torch.full((8, 8), 1e6)}
        newp, _, m = adamw_update(cfg, huge, state, params)
        assert torch.isfinite(newp["w"]).all()


class TestData:
    def test_deterministic_and_elastic(self):
        cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=8, seed=7)
        pipe = DataPipeline(cfg)
        b1 = pipe.batch_at(5)
        b2 = pipe.batch_at(5)
        assert torch.equal(b1["tokens"], b2["tokens"])
        b3 = pipe.batch_at(6)
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab_size=500, seq_len=16, global_batch=4)
        b = DataPipeline(cfg).batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (4, 16)
        assert int(b["tokens"].max()) < 500
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_learnable_structure(self):
        """The bigram rule makes labels partially predictable."""
        cfg = DataConfig(vocab_size=128, seq_len=256, global_batch=16)
        b = DataPipeline(cfg).batch_at(0)
        rule = (b["tokens"].numpy() * 31 + 7) % 128
        agree = (rule == b["labels"].numpy()).mean()
        assert agree > 0.3   # ~half the positions follow the rule


class TestCheckpoint:
    def test_roundtrip_and_latest(self):
        with tempfile.TemporaryDirectory() as d:
            trees = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
                     "opt": {"mu": torch.ones((3, 4))}}
            ckpt.save(d, 3, trees, cursor={"step": 3})
            ckpt.save(d, 7, trees, cursor={"step": 7})
            assert ckpt.latest_step(d) == 7
            out, manifest = ckpt.restore(d, trees)
            assert manifest["cursor"]["step"] == 7
            assert torch.equal(out["params"]["w"],
                               torch.arange(12.0).reshape(3, 4))

    def test_gc_keeps_last_k(self):
        with tempfile.TemporaryDirectory() as d:
            trees = {"p": {"w": torch.zeros(4)}}
            for s in range(6):
                ckpt.save(d, s, trees, keep=2)
            steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
            assert len(steps) == 2
            assert ckpt.latest_step(d) == 5

    def test_commit_is_atomic(self):
        """A stale .tmp directory never shadows a committed step."""
        with tempfile.TemporaryDirectory() as d:
            trees = {"p": {"w": torch.zeros(4)}}
            os.makedirs(os.path.join(d, "step_00000009.tmp"))
            ckpt.save(d, 9, trees)
            assert ckpt.latest_step(d) == 9

    def test_shape_mismatch_rejected(self):
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 1, {"p": {"w": torch.zeros((2, 2))}})
            with pytest.raises(ValueError):
                ckpt.restore(d, {"p": {"w": torch.zeros((4, 4))}})


class TestFaultTolerance:
    def test_straggler_monitor_fires(self):
        mon = StragglerMonitor(StragglerConfig(window=10, ratio_threshold=2.0,
                                               sustained=2, min_steps=4))
        event = None
        for i in range(16):
            dt = 1.0 if i < 12 else 5.0
            event = mon.record(dt) or event
        assert event is not None and event["type"] == "straggler"
        assert event["ratio"] > 2.0
        assert mon.online_cmax_over_cavg > 2.0

    def test_straggler_monitor_ignores_single_spike(self):
        mon = StragglerMonitor(StragglerConfig(window=10, ratio_threshold=2.0,
                                               sustained=2, min_steps=4))
        events = [mon.record(5.0 if i == 6 else 1.0) for i in range(20)]
        assert all(e is None for e in events)

    def test_straggler_monitor_default_cfg_not_shared(self):
        a, b = StragglerMonitor(), StragglerMonitor()
        assert a.cfg is not b.cfg

    def test_restartable_loop_resume_never_replays_history(self):
        saved = []
        injector = FaultInjector(fail_at_steps=(7,))

        def step_fn(step):
            injector.maybe_fail(step)
            return {"v": step}

        loop = RestartableLoop(policy=RestartPolicy(max_restarts=2),
                               checkpoint_every=5)
        rep = loop.run(n_steps=12, step_fn=step_fn, save_fn=saved.append,
                       restore_fn=lambda: max(saved, default=0))
        assert rep["steps"] == 12 and rep["restarts"] == 1
        steps = [h["step"] for h in rep["history"]]
        assert steps == sorted(set(steps)) == list(range(12))

    def test_restartable_loop_exhausted_restarts_raises(self):
        class AlwaysFails(RuntimeError):
            pass

        def step_fn(step):
            raise AlwaysFails("boom")

        loop = RestartableLoop(policy=RestartPolicy(max_restarts=2))
        with pytest.raises(AlwaysFails):
            loop.run(n_steps=4, step_fn=step_fn, save_fn=lambda s: None,
                     restore_fn=lambda: 0)

    def test_restartable_loop_default_policy_not_shared(self):
        a, b = RestartableLoop(), RestartableLoop()
        assert a.policy is not b.policy and a.monitor is not b.monitor

    def test_recovery_planner_decisions(self):
        pl = RecoveryPlanner(1.0, restart_overhead_s=20.0, checkpoint_s=2.0,
                             margin=1.25, degraded_threshold=1.5)
        assert pl.decide(1.2, 100).action == "continue"
        assert pl.decide(3.0, 5).action == "checkpoint_now"
        d = pl.decide(4.0, 100)
        assert d.action == "reschedule"
        assert d.reschedule_s * pl.margin < d.continue_s

    def test_restartable_loop_planner_reschedules_after_checkpoint(self):
        mon = StragglerMonitor(StragglerConfig(window=8, ratio_threshold=2.0,
                                               sustained=2, min_steps=4))
        times = iter([1.0] * 8 + [4.0] * 20)
        saved = []
        loop = RestartableLoop(
            monitor=mon,
            planner=RecoveryPlanner(1.0, restart_overhead_s=5.0,
                                    checkpoint_s=1.0),
            checkpoint_every=1000)
        orig = mon.record
        mon.record = lambda _dt: orig(next(times))
        with pytest.raises(RescheduleRequested) as ei:
            loop.run(n_steps=200, step_fn=lambda s: {},
                     save_fn=saved.append, restore_fn=lambda: 0)
        assert ei.value.decision.action == "reschedule"
        assert saved, "must checkpoint before requesting reschedule"
        assert saved[-1] == ei.value.decision.step

    def test_trainer_restart_is_deterministic(self):
        cfg_m = get(ARCH).reduced()
        with tempfile.TemporaryDirectory() as d:
            def run(fault):
                tc = TrainConfig(
                    model=cfg_m,
                    opt=AdamWConfig(lr=1e-3, total_steps=30, warmup_steps=2),
                    data=DataConfig(vocab_size=cfg_m.vocab_size, seq_len=32,
                                    global_batch=4),
                    n_steps=30,
                    checkpoint_dir=os.path.join(d, "a" if fault else "b"),
                    checkpoint_every=10, log_every=30)
                tr = Trainer(tc, device="cpu")
                rep = tr.run(FaultInjector(fail_at_steps=(17,) if fault
                                           else ()))
                return rep, tr
            rep1, tr1 = run(fault=True)
            rep2, tr2 = run(fault=False)
            assert rep1["restarts"] == 1 and rep2["restarts"] == 0
            # bit-identical final params despite the crash/restore
            for p1, p2 in zip(tr1.net.parameters(), tr2.net.parameters()):
                assert torch.equal(p1, p2)


# -- the port against the reference ------------------------------------------

def _stacked_tree(rng):
    """Leaves as the reference stacks them: a (12, 16, 32) layer weight, a
    stacked (12, 16) norm scale (2-D: decayed, and factored by Adafactor
    since 12 >= 8), a stacked (3, 16) bias (decayed, not factored), an
    unstacked (16,) scale (neither) and a (40, 16) embedding."""
    shapes = {"groups/0/0/attn/wq/w": (12, 16, 32),
              "groups/0/0/norm1/scale": (12, 16),
              "groups/1/0/attn/wq/b": (3, 16),
              "final_norm/scale": (16,),
              "embed/w": (40, 16)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _nest_ref(flat):
    """The reference's nested tree of a flat {path: array}."""
    return jax.tree.map(jnp.asarray, nest(flat))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference_on_stacked_leaves(kind):
    """Three steps of each kind on the same stacked leaves and gradients:
    parameters and state within 1e-6."""
    rng = np.random.default_rng(0)
    p_np = _stacked_tree(rng)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, kind=kind)
    ref_cfg, cfg = ref_training.AdamWConfig(**kw), AdamWConfig(**kw)
    ref_p = _nest_ref(p_np)
    ref_s = ref_training.init_adamw(ref_cfg, ref_p)
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    state = init_adamw(cfg, params)
    for _ in range(3):
        g_np = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                for k, v in p_np.items()}
        ref_p, ref_s, ref_m = ref_training.adamw_update(
            ref_cfg, _nest_ref(g_np), ref_s, ref_p)
        params, state, m = adamw_update(
            cfg, {k: torch.from_numpy(v) for k, v in g_np.items()}, state,
            params)
    for path, want in ref_tree_paths(ref_p):
        got = params[path].numpy()
        assert np.abs(got - np.asarray(want)).max() < 1e-6, path
    want_state = {p: np.asarray(v) for p, v in ref_tree_paths(ref_s)}
    got_state = {p: v.numpy() for p, v in tree_paths(state)}
    assert set(got_state) == set(want_state)
    for path, want in want_state.items():
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got_state[path] - want).max() < 1e-6 * scale, path
    if kind == "adafactor":
        assert set(state.nu["groups/0/0/norm1/scale"]) == {"vr", "vc"}
        assert set(state.nu["groups/1/0/attn/wq/b"]) == {"v"}
    assert float(m["lr"]) == pytest.approx(float(ref_m["lr"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(ref_m["grad_norm"]),
                                                  rel=1e-6)


def test_bytes_batch_equals_reference():
    corpus = bytes(np.random.default_rng(1).integers(0, 256, 5000,
                                                     dtype=np.uint8))
    for step in (0, 3, 11):
        kw = dict(vocab_size=256, seq_len=64, global_batch=5, seed=2,
                  kind="bytes", corpus=corpus)
        got = DataPipeline(DataConfig(**kw)).batch_at(step)
        want = ref_data.DataPipeline(ref_data.DataConfig(**kw)).batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_batch_follows_the_rule():
    """Where a label is not the bigram rule's, it is a fresh draw; rank 1
    (token 0) is the most frequent fresh token, as the Zipf law has it."""
    cfg = DataConfig(vocab_size=100, seq_len=512, global_batch=8, seed=3)
    b = port_data.synthetic_batch(cfg, 4)
    tok, lab = b["tokens"].numpy(), b["labels"].numpy()
    rule = (tok * 31 + 7) % 100 == lab
    assert 0.45 < rule.mean() < 0.6
    fresh = lab[~rule]
    assert np.bincount(fresh, minlength=100).argmax() == 0


def _step_pair(kind="adamw", microbatches=1):
    """One make_train_step step of reduced qwen1.5-4b, fp32, on one numpy
    batch, in the reference and in the port from the same parameters.
    AdamW's eps is 1e-3 here: at step 1 Adam moves each parameter by about
    lr * g / (|g| + eps), so with the default 1e-8 a gradient within 1e-8
    of zero (where the two packages' summation orders differ) moves its
    parameter by anything up to lr."""
    ref_cfg, cfg = ref_get(ARCH).reduced(), get(ARCH).reduced()
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    net = build_model(cfg).init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, kind=kind, eps=1e-3)
    ref_opt = ref_training.AdamWConfig(**kw)
    ref_p, _, ref_m = ref_training.make_train_step(
        ref_build(ref_cfg), ref_opt)(
        params, ref_training.init_adamw(ref_opt, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    opt = AdamWConfig(**kw)
    _, state, m = make_train_step(build_model(cfg), opt,
                                  microbatches=microbatches)(
        net, init_adamw(opt, leaf_templates(net)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got = dict(tree_paths(to_reference(dict(net.named_parameters()), net)))
    return got, {p: np.asarray(v) for p, v in ref_tree_paths(ref_p)}, m, ref_m


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_matches_reference(kind):
    """Loss, grad norm and lr within 1e-6 relative; every parameter within
    1e-6 after the step."""
    got, want, m, ref_m = _step_pair(kind)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(ref_m[k]), rel=1e-6), k
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.abs(got[path] - w).max() < 1e-6, path


def test_microbatches_equal_one_batch():
    """Two microbatches (gradients summed in an accumulator) give the step
    of the whole batch, and the reference's."""
    got2, want, m2, ref_m = _step_pair(microbatches=2)
    assert float(m2["loss"]) == pytest.approx(float(ref_m["loss"]),
                                              rel=1e-6)
    for path, w in want.items():
        assert np.abs(got2[path] - w).max() < 1e-6, path


def test_bf16_microbatches_accumulate_in_fp32():
    """bf16 parameters: the microbatches' gradients are summed in fp32
    unless an accumulator type is given, and the step leaves the
    parameters bf16."""
    cfg = dataclasses.replace(get(ARCH).reduced(), dtype="bfloat16")
    model = build_model(cfg)
    net = model.init(0, device="cpu")
    batch = port_data.synthetic_batch(DataConfig(cfg.vocab_size, 16, 4), 0)
    for accum, want in ((None, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
        _, _, grads = trainer._gradients(model, net, batch, 2, accum)
        assert {g.dtype for g in grads.values()} == {want}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    _, _, m = make_train_step(model, opt, microbatches=2)(
        net, init_adamw(opt, leaf_templates(net)), batch)
    assert np.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())


def _train(pkg, cfg_m, d, steps, **kw):
    """``steps`` steps of reduced qwen1.5-4b through ``pkg``'s Trainer,
    checkpointing into ``d`` at the end."""
    tc = pkg.TrainConfig(
        model=cfg_m,
        opt=pkg.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1),
        data=pkg.DataConfig(vocab_size=cfg_m.vocab_size, seq_len=16,
                            global_batch=2),
        n_steps=steps, checkpoint_dir=d, checkpoint_every=100,
        log_every=100)
    tr = pkg.Trainer(tc, **kw)
    tr.run()
    return tr


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    tr = _train(port_training, get(ARCH).reduced(), str(tmp_path), 2,
                device="cpu")
    ref_cfg = ref_get(ARCH).reduced()
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(5))
    opt = ref_training.init_adamw(ref_training.AdamWConfig(), params)
    trees, manifest = ref_ckpt.restore(str(tmp_path),
                                       {"params": params, "opt": opt})
    assert manifest["step"] == 2 and manifest["cursor"]["step"] == 2
    got = dict(tree_paths(to_reference(dict(tr.net.named_parameters()),
                                       tr.net)))
    restored = dict(ref_tree_paths(trees["params"]))
    assert set(got) == set(restored)
    for path, v in restored.items():
        assert np.array_equal(np.asarray(v), got[path]), path
    assert int(trees["opt"].step) == 2
    for path, v in ref_tree_paths(trees["opt"].mu):
        assert np.array_equal(np.asarray(v), tr.opt_state.mu[path].numpy())
    for path, v in ref_tree_paths(trees["opt"].nu):
        assert np.array_equal(np.asarray(v), tr.opt_state.nu[path].numpy())


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    ref_tr = _train(ref_training, ref_get(ARCH).reduced(), str(tmp_path), 2)
    tc = TrainConfig(model=get(ARCH).reduced(), opt=AdamWConfig(),
                     data=DataConfig(256, 16, 2), checkpoint_dir=str(tmp_path))
    tr = Trainer(tc, seed=9, device="cpu")
    assert tr.restore() == 2
    got = dict(tree_paths(to_reference(dict(tr.net.named_parameters()),
                                       tr.net)))
    for path, v in ref_tree_paths(ref_tr.params):
        assert np.array_equal(got[path], np.asarray(v)), path
    assert int(tr.opt_state.step) == 2
    ref_mu = dict(ref_tree_paths(ref_tr.opt_state.mu))
    assert set(ref_mu) == set(tr.opt_state.mu)
    for path, v in ref_mu.items():
        assert np.array_equal(tr.opt_state.mu[path].numpy(), np.asarray(v))
    for path, v in ref_tree_paths(ref_tr.opt_state.nu):
        assert np.array_equal(tr.opt_state.nu[path].numpy(), np.asarray(v))


def test_checkpoint_reads_bf16_written_by_the_reference(tmp_path):
    """The reference writes bf16 leaves as 2-byte records; the port reads
    them as bf16 bits, into a bf16 or an fp32 template."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    ref_ckpt.save(str(tmp_path), 1, {"p": {"w": x}})
    want = np.asarray(x.astype(jnp.float32))
    for dtype in (torch.bfloat16, torch.float32):
        out, _ = ckpt.restore(str(tmp_path),
                              {"p": {"w": torch.zeros((3, 5), dtype=dtype)}})
        assert out["p"]["w"].dtype == dtype
        assert np.array_equal(out["p"]["w"].float().numpy(), want)


def test_compression_one_pod_is_the_identity():
    """Without a mesh, or on a mesh of one pod, the inputs come back; the
    two-pod mean is held to the reference's in test_torch_sharding.py."""
    from repro_torch.distributed.sharding import Mesh
    g = {"w": torch.randn(4, 4)}
    err = compression.init_error_buffers(g)
    assert compression.compress_pod_mean(g, err) == (g, err)
    for shape in ({"data": 2, "model": 2}, {"pod": 1, "data": 4}):
        assert compression.compress_pod_mean(g, err, Mesh(shape)) == (g, err)
    q, scale = compression._quantize(g["w"])
    assert q.dtype == torch.int8
    back = compression._dequantize(q, scale)
    assert float((back - g["w"]).abs().max()) <= float(scale) / 2 + 1e-7


def test_launch_train_on_the_cpu(capsys):
    report = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq",
                                "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "steps=2 restarts=0"
    assert report["steps"] == 2 and np.isfinite(report["logged"][0]["loss"])


@pytest.mark.parametrize("flag", [["--mesh", "1,1,1"], ["--multi-pod"]])
def test_launch_train_refuses_a_mesh(flag, capsys):
    """The launcher no longer refuses these flags: ``--mesh 1,1,1`` trains
    on a world of one rank, and ``--multi-pod`` outside a world of 256
    ranks trains unsharded, as the reference does; either run is the
    unsharded run.  A mesh the ranks cannot fill is still refused."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--seq", "16"]
    report = launch_train.main(argv + flag)
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "steps=1 restarts=0"
    want = launch_train.main(argv)
    assert report["logged"][0]["loss"] == pytest.approx(
        want["logged"][0]["loss"], rel=1e-6)
    with pytest.raises(ValueError, match=">= 1"):
        launch_train.main(argv + ["--mesh", "1,0,1"])
