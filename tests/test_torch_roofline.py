"""The three-term roofline of one rank's step (``core/roofline.py``) on
the CPU, against the reference's ``core/roofline.py`` and
``core/hlo.py``.

* The counted FLOPs of a reduced starcoder2-3b cell on a one-rank mesh
  against ``repro.core.hlo.analyze`` of the reference's compiled step (a
  subprocess, ``jit(...).lower().compile()`` on one host device): the
  prefill at S 256 within 1 %, the train step (remat) within 5 %.
* ``RooflineTerms`` fed the same counts and the ``tpu-v5e`` profile gives
  the reference's ``to_dict`` on every key the reference has;
  ``format_table`` and ``collective_term_calibrated`` match under one
  contention calibration.
* The count itself: FLOPs by operand type, views moving no bytes, the
  peak of live bytes, collectives by kind.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.core import perfmodel as ref_perfmodel
from repro.core import roofline as ref_rl
from repro_torch.configs import get
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import perfmodel
from repro_torch.core import roofline as rl
from repro_torch.core.machine import H100_SXM, TPU_V5E
from repro_torch.distributed import process_group as pg
from repro_torch.launch import specs
from repro_torch.launch.mesh import counting_mesh

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
SHAPES = {"prefill": ("prefill", 256, 2, "prefill"),
          "train": ("train", 256, 2, "train")}
#: the bounds on the counted FLOPs' gap to the reference's compiled ones
GAP_BOUND = {"prefill": 0.01, "train": 0.05}

REFERENCE = textwrap.dedent(r"""
    import dataclasses, json, sys
    sys.path.insert(0, sys.argv[1])
    import jax
    from repro.configs import get
    from repro.configs.base import ShapeConfig
    from repro.core import hlo
    from repro.distributed import sharding as shd
    from repro.launch import specs
    from repro.launch.mesh import make_mesh
    cfg = dataclasses.replace(get("starcoder2-3b").reduced(), remat=True)
    specs.get = lambda name: cfg
    specs.SHAPES = {k: ShapeConfig(*v) for k, v in
                    json.loads(sys.argv[2]).items()}
    mesh = make_mesh(1, 1, 1)
    out = {}
    for name in specs.SHAPES:
        with shd.use_mesh(mesh):
            fn, args, mf, meta = specs.step_and_specs("starcoder2-3b", name,
                                                      mesh)
            donate = (0, 1) if meta["kind"] == "train" else ()
            compiled = jax.jit(fn, donate_argnums=donate).lower(
                *args).compile()
        out[name] = {"flops": hlo.analyze(compiled.as_text()).flops,
                     "model_flops": mf}
    print(json.dumps(out))
""")


def _cfg():
    return dataclasses.replace(get("starcoder2-3b").reduced(), remat=True)


@pytest.fixture(scope="module")
def reference_flops(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_hlo")
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", REPRO_PLAN_DIR=str(d / "plans"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC,
                          json.dumps(SHAPES)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_counts(tmp_path_factory):
    """The port's count of the same cells on a one-rank counting mesh."""
    import repro_torch.tuner as tuner_mod
    from repro_torch.tuner import Tuner
    tuner = Tuner(plan_dir=str(tmp_path_factory.mktemp("port_plans")))
    saved = (specs.get, specs.SHAPES, tuner_mod.default_tuner)
    cfg = _cfg()
    specs.get = lambda name: cfg
    specs.SHAPES = {k: ShapeConfig(*v) for k, v in SHAPES.items()}
    tuner_mod.default_tuner = lambda: tuner
    try:
        mesh = counting_mesh((1, 1))
        out = {}
        for name in SHAPES:
            fn, args, mf, meta = specs.step_and_specs("starcoder2-3b", name,
                                                      mesh)
            out[name] = (rl.count_step(lambda: fn(*args), args), mf)
        return out
    finally:
        specs.get, specs.SHAPES, tuner_mod.default_tuner = saved


@pytest.mark.parametrize("name", list(SHAPES))
def test_counted_flops_match_the_compiled_references(reference_flops,
                                                     port_counts, name):
    """Measured here: the prefill's gap is 0 (the same products); the
    train step's 2.5 %, the port counting more by exactly one logits
    product (2 x 512 tokens x 64 x 256): its loss chunk is recomputed in
    the backward (``models/model.py::_chunked_ce``), the reference's
    compiled step keeps it.  The bounds are 1 % and 5 %."""
    count, model_flops = port_counts[name]
    want = reference_flops[name]
    got = sum(count.flops_by_type.values())
    assert set(count.flops_by_type) == {"float32"}
    assert model_flops == want["model_flops"]
    gap = abs(got - want["flops"]) / want["flops"]
    assert gap <= GAP_BOUND[name], (got, want["flops"])


def test_the_train_step_counts_more_than_the_prefill(port_counts):
    """Remat recomputes the forward: a train step of S tokens counts more
    than three forwards (forward, recompute, backward's two products)."""
    train = sum(port_counts["train"][0].flops_by_type.values())
    prefill = sum(port_counts["prefill"][0].flops_by_type.values())
    assert train > 3 * prefill


# -- RooflineTerms against the reference's --------------------------------------

COUNTS = dict(arch="starcoder2-3b", shape="train_4k", mesh="pod", chips=256,
              flops=8.6e14, memory_bytes=3.1e13, collective_bytes=2.5e10,
              collective_breakdown={"all-reduce": 2.4e10,
                                    "all-gather": 1e9},
              collective_counts={"all-reduce": 65.0, "all-gather": 433.0},
              model_flops=2.0e16, raw_cost_analysis={},
              memory_analysis={"argument_bytes": 5e8, "output_bytes": 1e6,
                               "temp_bytes": 8.7e10, "alias_bytes": 0.0,
                               "total_bytes": 8.75e10},
              while_loops=[])


def _pair():
    return (ref_rl.RooflineTerms(**COUNTS),
            rl.RooflineTerms(**COUNTS, machine=TPU_V5E))


def test_to_dict_equals_the_references_on_v5e():
    want, got = (t.to_dict() for t in _pair())
    assert {k: got[k] for k in want} == want
    assert got["machine"] == "tpu-v5e" and "spec-sheet" in got["notes"]


def test_format_table_equals_the_references():
    ref, port = _pair()
    assert rl.format_table([port, port]) == ref_rl.format_table([ref, ref])


@pytest.mark.parametrize("synchronized", [True, False])
def test_calibrated_collective_term_equals_the_references(synchronized):
    ref, port = _pair()
    params = [0.2, 1.1, 0.05, 1.4, 0.8]
    want = ref_rl.collective_term_calibrated(
        ref, ref_perfmodel.ParametricCalibration.from_params(params),
        synchronized=synchronized)
    got = rl.collective_term_calibrated(
        port, perfmodel.ParametricCalibration.from_params(params),
        synchronized=synchronized)
    assert got == pytest.approx(want, rel=1e-12)
    assert rl.collective_term_calibrated(port) == port.collective_term


def test_compute_term_sums_over_operand_types_on_the_h100():
    t = rl.RooflineTerms(**dict(COUNTS, flops=1e15),
                         flops_by_type={"bfloat16": 9.89e14,
                                        "float32": 6.7e12})
    assert t.machine is H100_SXM
    assert t.compute_term == pytest.approx(1.0 + 0.1)
    assert t.memory_term == pytest.approx(3.1e13 / 3.35e12)
    assert t.collective_term == pytest.approx(2.5e10 / 450e9)
    assert t.dominant == "memory"
    assert t.roofline_fraction == pytest.approx(
        2.0e16 / (t.bound_time * 256 * 989e12))
    d = t.to_dict()
    assert d["peaks"] == {"bfloat16": 989e12, "float32": 67e12}


def test_analyze_step_is_the_count_priced():
    a = torch.zeros(128, 64, device="meta", dtype=torch.bfloat16)
    kw = dict(arch="x", shape="y", mesh_name="pod", chips=256,
              model_flops=1e9)
    terms = rl.analyze_step(lambda: a @ a.t(), (a,), **kw)
    want = rl.terms_of(rl.count_step(lambda: a @ a.t(), (a,)), **kw)
    assert terms.to_dict() == want.to_dict()
    assert terms.flops_by_type == {"bfloat16": 2.0 * 128 * 64 * 128}
    assert terms.compute_term == pytest.approx(terms.flops / 989e12)


def test_save_and_load(tmp_path):
    _, port = _pair()
    rl.save_terms(port, tmp_path / "t.json")
    assert rl.load_terms(tmp_path / "t.json") == json.loads(
        json.dumps(port.to_dict()))


# -- the count ----------------------------------------------------------------

def test_count_by_type_bytes_and_views():
    a = torch.zeros(64, 32, device="meta", dtype=torch.bfloat16)
    b = torch.zeros(32, 16, device="meta")

    def step():
        c = a.float() @ b                  # fp32 product, a copy first
        d = a[:, :16].t()                  # views: no bytes
        e = (a.to(torch.bfloat16) @ a.t())   # a bf16 product
        return c, d, e

    count = rl.count_step(step, (a, b))
    assert count.flops_by_type == {"float32": 2 * 64 * 32 * 16,
                                   "bfloat16": 2 * 64 * 32 * 64}
    # the cast reads a, writes fp32 a; the products read operands and
    # write outputs; the views and the no-op cast move nothing
    want = (64 * 32 * 2 + 64 * 32 * 4) + (64 * 32 * 4 + 32 * 16 * 4
                                          + 64 * 16 * 4) \
        + (64 * 32 * 2 * 2 + 64 * 64 * 2)
    assert count.bytes == want
    mem = count.memory
    assert mem["argument_bytes"] == 64 * 32 * 2 + 32 * 16 * 4
    # the cast's copy dies after its product; the outputs live on
    assert mem["output_bytes"] == 64 * 16 * 4 + 64 * 64 * 2
    assert mem["temp_bytes"] == max(64 * 32 * 4 + 64 * 16 * 4,
                                    64 * 16 * 4 + 64 * 64 * 2)
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def test_peak_sees_freed_temporaries():
    x = torch.zeros(1024, device="meta")

    def step():
        ys = []
        for _ in range(3):
            y = x * 2                      # 4 KiB, freed each turn
            del y
        for _ in range(2):
            ys.append(x * 3)               # 4 KiB each, held
        del ys
        return x + 1

    count = rl.count_step(step, (x,))
    assert count.memory["temp_bytes"] == 2 * 4096
    assert count.memory["output_bytes"] == 4096


def test_collectives_are_counted_by_kind():
    mesh = counting_mesh((2, 4, 2), rank=5)
    x = torch.zeros(8, 6, device="meta")

    def step():
        a = pg.all_reduce(x, mesh.group("data"))
        b = pg.all_gather(x, mesh.group("model"), dim=1)
        c = pg.reduce_scatter(x, mesh.group("data"), dim=0)
        d = pg.broadcast(x, 0, mesh.group(("pod", "data")))
        return a, b, c, d

    count = rl.count_step(step, (x,))
    nb = 8 * 6 * 4
    assert count.collective_calls == {"all-reduce": 1, "all-gather": 1,
                                      "reduce-scatter": 1, "broadcast": 1}
    assert count.collective_bytes == {k: nb for k in count.collective_calls}
    stats = pg.collective_stats()
    assert stats["calls"] == 4 and stats["staged_bytes"] == 0
    a, b, c, d = step()
    assert a.shape == (8, 6) and b.shape == (8, 12) and c.shape == (2, 6)
    assert d.shape == (8, 6) and d.device.type == "meta"
    assert mesh.group(("pod", "data")).size == 8
    assert mesh.coords == {"pod": 0, "data": 2, "model": 1}
