"""The reference's ``dp_sp`` profile on the port, on the CPU: no tensor
parallelism, the batch over ``("pod", "data", "model")`` where it divides
it, ZeRO-1 (and FSDP) over ``("data", "model")``.

Gloo worlds of four ranks on (1, 2, 2) and (1, 1, 4) train the reduced
configs of seven archs (``torch_profiles.ARCHS``; starcoder2-3b with
remat) for two steps under ``rules_for(arch, "dp_sp")``, one row a rank.
Each is held to the port's unsharded trainer (loss and parameters 1e-6,
each leaf's first-step gradient 1e-5 of its largest entry) and to the
reference's ``make_train_step`` under ``use_mesh(make_mesh(...),
rules=rules_for(arch, "dp_sp"))`` (loss 1e-5, parameters 1e-4).  On
(1, 2, 2) starcoder2-3b also trains with FSDP forced: each rank holds
1/(data * model) of each leaf the zero axes cut.

The decode: the cases of ``test_torch_decode_mesh.py`` (a dense arch, its
chunked path, hymba's window, xlstm's states, whisper's cross-attention,
the MoE) on four rows under ``dp_sp``, each rank decoding its row on its
block of the caches (the rows over ``("data", "model")``: ``kv_seq`` is
dropped as a duplicate axis), against the unsharded decode (logits 1e-5
of their largest value).
"""

import numpy as np
import pytest
import torch

import torch_profiles as tp
from repro_torch.configs import get
from repro_torch.distributed import spawn
from repro_torch.launch.prefill import stub_inputs
from repro_torch.launch.specs import rules_for
from repro_torch.models import build_model
from repro_torch.serving.engine import make_serve_step

PROFILE = "dp_sp"
FSDP_CASE = ("starcoder2-3b", False, True)
CASES = {shape: [(arch, False, False) for arch in tp.ARCHS]
         for shape in tp.MESHES}
CASES[(1, 2, 2)].append(FSDP_CASE)
RUNS = [(shape, case) for shape, cases in CASES.items() for case in cases]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tp.worlds(str(tmp_path_factory.mktemp("dp_worlds")), PROFILE,
                     CASES)


@pytest.fixture(scope="module")
def unsharded():
    return tp.unsharded([c for cases in CASES.values() for c in cases])


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    return tp.reference(str(tmp_path_factory.mktemp("dp_ref")), PROFILE,
                        CASES, unsharded)


def _ids(run):
    shape, case = run
    return f"{tp.case_id(case)}@{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_steps_equal_the_unsharded_port(worlds, unsharded, run):
    shape, case = run
    got = worlds[shape][tp.case_id(case)]["run"]
    tp.check_against_unsharded(
        got, unsharded[tp.case_id((case[0], case[1], False))])


@pytest.mark.parametrize("run", [r for r in RUNS if not r[1][2]], ids=_ids)
def test_steps_equal_the_references_use_mesh(worlds, reference, run):
    shape, case = run
    key = tp.case_id(case)
    tp.check_against_reference(worlds[shape][key]["run"], reference,
                               f"{key}@{','.join(map(str, shape))}")


@pytest.mark.parametrize("shape", tp.MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_no_tensor_parallelism_and_a_row_a_rank(worlds, shape):
    """No block runs tensor- or expert-parallel; the four rows go over
    both axes (``valid_spec`` keeps ``data`` and ``model`` on 4 rows)."""
    for key, w in worlds[shape].items():
        assert w["tp"] == [], key
        assert w["batch_axes"] == ("data", "model"), key


def test_fsdp_cuts_each_leaf_over_data_and_model(worlds):
    """FSDP forced on (1, 2, 2): each leaf the zero axes cut is held a
    quarter a rank where ``("data", "model")`` divides it (most leaves),
    else a half (one of the axes)."""
    shares = worlds[(1, 2, 2)][tp.case_id(FSDP_CASE)]["shares"]
    assert len(shares) >= 8
    quarter = [p for p, (held, whole) in shares.items() if held * 4 == whole]
    assert len(quarter) >= len(shares) // 2
    for path, (held, whole) in shares.items():
        assert held * 4 == whole or held * 2 == whole, path


def test_rules_are_carried_by_the_mesh():
    """``Mesh.rules`` are the profile's over the defaults, fixed to the
    mesh's axes; ``for_batch`` keeps the batch axes that divide."""
    from repro_torch.launch.mesh import counting_mesh
    mesh = counting_mesh((16, 16)).with_rules(rules_for("qwen1.5-4b",
                                                        PROFILE))
    assert mesh.batch_axes == ("data", "model")
    assert mesh.zero_axes == ("data", "model")
    assert mesh.rules["heads"] is None and mesh.rules["kv_seq"] == "model"
    assert mesh.for_batch(256).batch_axes == ("data", "model")
    assert mesh.for_batch(32).batch_axes == ("data",)
    assert mesh.for_batch(1).batch_axes == ()
    pods = counting_mesh((2, 16, 16)).with_rules(rules_for("qwen1.5-4b",
                                                           PROFILE))
    assert pods.for_batch(256).batch_axes == ("pod", "data")
    assert pods.for_batch(512).batch_axes == ("pod", "data", "model")


def test_a_rank_runs_the_microbatches_that_divide_its_rows(monkeypatch,
                                                          tmp_path):
    """granite-20b@train_4k under dp_sp: the record keeps the reference's
    2 microbatches and says that the rank's one row ran as one
    (``microbatches_run``); the baseline's 16 rows run the reference's
    count.  The step refuses a count that does not divide its rows.  The
    layout choice's plans go to a temporary cache, not the checkout's."""
    import repro_torch.tuner as tuner_mod
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import counting_mesh
    from repro_torch.training.trainer import step_gradients, whole_layout
    tuner = tuner_mod.Tuner(plan_dir=str(tmp_path))
    monkeypatch.setattr(tuner_mod, "default_tuner", lambda: tuner)
    mesh = counting_mesh((16, 16))
    *_, meta = specs.step_and_specs(
        "granite-20b", "train_4k", mesh.with_rules(rules_for("granite-20b",
                                                             PROFILE)))
    want, _ = specs.cell_meta(get("granite-20b"), SHAPES["train_4k"],
                              mesh.with_rules(rules_for("granite-20b",
                                                        PROFILE)))
    assert meta["microbatches"] == want["microbatches"] == 2
    assert meta["batch_rows"] == 1 and meta["microbatches_run"] == 1
    *_, meta = specs.step_and_specs("starcoder2-3b", "train_4k", mesh)
    assert meta["batch_rows"] == 16
    assert meta["microbatches_run"] == meta["microbatches"]
    cfg = tp.config("whisper-tiny")
    model = build_model(cfg)
    net = model.init(tp.SEED, device="cpu")
    rows = {k: torch.from_numpy(v) for k, v in tp.batch(cfg).items()}
    with pytest.raises(ValueError, match="do not divide"):
        step_gradients(model, net, rows, whole_layout(net), microbatches=3)


# -- the decode under dp_sp -----------------------------------------------------

#: case -> (arch, tokens a step, steps' tokens, cache slots), as
#: test_torch_decode_mesh.py's
DECODE_CASES = {"dense": ("starcoder2-3b", 1, 12, 16),
                "chunked": ("starcoder2-3b", 3, 12, 16),
                "hymba": ("hymba-1.5b", 1, 24, 32),
                "xlstm": ("xlstm-350m", 1, 8, 16),
                "whisper": ("whisper-tiny", 1, 8, 16),
                "moe": ("qwen2-moe-a2.7b", 1, 8, 16)}
DECODE_BATCH, DECODE_TOL = 4, 1e-5


def _decode_setup(case):
    arch, s1, s, slots = DECODE_CASES[case]
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(tp.SEED, device="cpu")
    stubs = stub_inputs(cfg, DECODE_BATCH, device="cpu")
    with torch.inference_mode():
        memory = model.encode_memory(net, stubs) if stubs else None
    rng = np.random.default_rng(tp.SEED + len(case))
    toks = rng.integers(0, cfg.vocab_size, (DECODE_BATCH, s)).astype(np.int64)
    return cfg, model, net, memory, toks, s1, slots


def _decode(model, net, caches, toks, memory, s1, mesh=None):
    step = make_serve_step(model, mesh)
    outs = []
    for t in range(0, toks.shape[1], s1):
        logits, caches = step(net, torch.from_numpy(toks[:, t:t + s1]),
                              caches, memory)
        outs.append(logits)
    return torch.cat(outs, 1).numpy()


def _decode_rank(rank, world, device, shape):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = {}
    for case in DECODE_CASES:
        cfg, model, net, memory, toks, s1, slots = _decode_setup(case)
        mesh = make_mesh(*shape).with_rules(rules_for(
            DECODE_CASES[case][0], PROFILE)).for_batch(DECODE_BATCH)
        model.shard(net, mesh)
        n = mesh.axis_size(mesh.batch_axes)
        i = mesh.axis_index(mesh.batch_axes)
        rows = slice(i * DECODE_BATCH // n, (i + 1) * DECODE_BATCH // n)
        caches = model.init_cache(DECODE_BATCH, slots, device="cpu",
                                  mesh=mesh)
        kv = next((c["kv"] for c in caches if "kv" in c), None)
        out[case] = {
            "rows": (rows.start, rows.stop),
            "kv_rows": None if kv is None else kv.k.shape[0],
            "kv_seq": kv is not None and hasattr(kv.k, "placement"),
            "logits": _decode(model, net, caches, toks[rows],
                              None if memory is None else memory[rows],
                              s1, mesh)}
    return out


@pytest.fixture(scope="module")
def decode_world(tmp_path_factory):
    return spawn(_decode_rank, 4, init_dir=str(
        tmp_path_factory.mktemp("dp_decode")), timeout_s=600,
        args=((1, 2, 2),))


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_equals_the_unsharded_decode(decode_world, case):
    """Every rank's logits of its row, at every step, within 1e-5 of the
    unsharded decode's largest value; the caches' rows cut four ways, no
    slot cut over ``model``."""
    cfg, model, net, memory, toks, s1, slots = _decode_setup(case)
    want = _decode(model, net, model.init_cache(DECODE_BATCH, slots,
                                                device="cpu"),
                   toks, memory, s1)
    seen = set()
    for r in decode_world:
        got = r[case]
        lo, hi = got["rows"]
        assert hi - lo == 1
        seen.add(lo)
        if got["kv_rows"] is not None:
            assert got["kv_rows"] == 1 and not got["kv_seq"]
        w = want[lo:hi]
        assert np.abs(got["logits"] - w).max() <= DECODE_TOL * np.abs(
            w).max()
    assert seen == set(range(DECODE_BATCH))
