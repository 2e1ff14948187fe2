"""The reference's ``seq_sp`` profile on the port (Megatron-SP), on the
CPU: the baseline's tensor parallelism, with the residual stream between
blocks cut on the sequence over ``model``.

Gloo worlds of four ranks on (1, 2, 2) and (1, 1, 4) train the reduced
configs of seven archs (``torch_profiles.ARCHS``; starcoder2-3b with
remat) for two steps under ``rules_for(arch, "seq_sp")``: 16 and 8
positions of the 32 a rank.  Each is held to the port's unsharded trainer
(loss and parameters 1e-6, each leaf's first-step gradient 1e-5 of its
largest entry: the norms', the embeddings' and the LM head's gradients
are summed over the rows' ranks) and to the reference's
``make_train_step`` under ``use_mesh(make_mesh(...), rules=rules_for(arch,
"seq_sp"))`` (loss 1e-5, parameters 1e-4).  On (1, 1, 4) starcoder2-3b and
whisper-tiny also train with the labels -1 on the last quarter of the
sequence, all of it in the last rank's rows: the mean takes the ranks'
totals and counts summed.

The prefill under ``seq_sp``: every rank returns the last position's
logits (held by the last ``model`` rank), as the unsharded prefill does.
"""

import numpy as np
import pytest
import torch

import torch_profiles as tp
from repro_torch.configs import get
from repro_torch.distributed import spawn
from repro_torch.distributed.sharding import seq_tp, use_mesh
from repro_torch.launch.prefill import make_prefill_step, stub_inputs
from repro_torch.launch.specs import rules_for
from repro_torch.models import build_model

PROFILE = "seq_sp"
MASKED = [("starcoder2-3b", True, False), ("whisper-tiny", True, False)]
CASES = {shape: [(arch, False, False) for arch in tp.ARCHS]
         for shape in tp.MESHES}
CASES[(1, 1, 4)].extend(MASKED)
RUNS = [(shape, case) for shape, cases in CASES.items() for case in cases]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tp.worlds(str(tmp_path_factory.mktemp("seq_worlds")), PROFILE,
                     CASES)


@pytest.fixture(scope="module")
def unsharded():
    return tp.unsharded([c for cases in CASES.values() for c in cases])


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    return tp.reference(str(tmp_path_factory.mktemp("seq_ref")), PROFILE,
                        CASES, unsharded)


def _ids(run):
    shape, case = run
    return f"{tp.case_id(case)}@{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_steps_equal_the_unsharded_port(worlds, unsharded, run):
    shape, case = run
    tp.check_against_unsharded(worlds[shape][tp.case_id(case)]["run"],
                               unsharded[tp.case_id(case)])


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_steps_equal_the_references_use_mesh(worlds, reference, run):
    shape, case = run
    key = tp.case_id(case)
    tp.check_against_reference(worlds[shape][key]["run"], reference,
                               f"{key}@{','.join(map(str, shape))}")


def test_masked_labels_change_the_loss(unsharded):
    """The masked cases' losses differ from the unmasked ones: the last
    quarter's labels count in the one and not in the other."""
    for arch, _, _ in MASKED:
        masked = unsharded[tp.case_id((arch, True, False))][0][0]["ce"]
        plain = unsharded[tp.case_id((arch, False, False))][0][0]["ce"]
        assert abs(masked - plain) > 1e-4 * abs(plain), arch


@pytest.mark.parametrize("shape", tp.MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_the_baseline_blocks_stay_tensor_parallel(worlds, shape):
    """The tensor-parallel blocks are the baseline's (``seq_sp`` changes
    only the activations): starcoder2-3b's attention and MLP, hymba's
    attention and SSD head, xlstm's mLSTM and sLSTM, the cross-attention
    of llama-3.2-vision-11b and whisper-tiny; the batch over ``data``."""
    w = worlds[shape]
    tp_mods = w["starcoder2-3b"]["tp"]
    assert "layers.0.attn" in tp_mods and "layers.0.mlp" in tp_mods
    assert {"layers.0.attn", "layers.0.ssd"} <= set(w["hymba-1.5b"]["tp"])
    assert w["xlstm-350m"]["tp"] == ["layers.0.mlstm", "layers.1.slstm"]
    assert "layers.1.cross" in w["llama-3.2-vision-11b"]["tp"]
    assert "dec_layers.0.cross" in w["whisper-tiny"]["tp"]
    assert w["starcoder2-3b"]["batch_axes"] == ("data",)


def test_seq_tp_needs_the_rule_and_a_dividing_sequence():
    from repro_torch.launch.mesh import counting_mesh
    mesh = counting_mesh((1, 4)).with_rules(rules_for("starcoder2-3b",
                                                      PROFILE))
    with use_mesh(mesh):
        assert seq_tp(32).size == 4 and seq_tp(1) is None
        assert seq_tp(30) is None
    with use_mesh(counting_mesh((1, 4))):
        assert seq_tp(32) is None
    assert seq_tp(32) is None


# -- the prefill ------------------------------------------------------------------

PREFILL_ARCHS = ["starcoder2-3b", "hymba-1.5b", "whisper-tiny"]
PREFILL_BATCH, PREFILL_SEQ = 2, 32


def _prefill_inputs(arch):
    cfg = get(arch).reduced()
    rng = np.random.default_rng(tp.SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ)))
    return cfg, tokens, stub_inputs(cfg, PREFILL_BATCH, device="cpu")


def _prefill_rank(rank, world, device, shape):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = {}
    for arch in PREFILL_ARCHS:
        cfg, tokens, stubs = _prefill_inputs(arch)
        mesh = make_mesh(*shape).with_rules(rules_for(arch, PROFILE))
        model = build_model(cfg)
        net = model.init(tp.SEED, device="cpu")
        model.shard(net, mesh)
        with use_mesh(mesh):
            out[arch] = make_prefill_step(model)(net, tokens,
                                                 **stubs).numpy()
    return out


@pytest.fixture(scope="module")
def prefill_world(tmp_path_factory):
    return spawn(_prefill_rank, 4, init_dir=str(
        tmp_path_factory.mktemp("seq_prefill")), timeout_s=600,
        args=((1, 1, 4),))


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_gives_every_rank_the_last_position(prefill_world, arch):
    """Every rank's (B, 1, V) logits within 1e-5 of the unsharded
    prefill's largest value."""
    cfg, tokens, stubs = _prefill_inputs(arch)
    model = build_model(cfg)
    want = make_prefill_step(model)(model.init(tp.SEED, device="cpu"),
                                    tokens, **stubs).numpy()
    for r in prefill_world:
        got = r[arch]
        assert got.shape == want.shape == (PREFILL_BATCH, 1, cfg.vocab_size)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
