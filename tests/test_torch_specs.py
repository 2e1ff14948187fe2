"""The dry run's cells (``launch/specs.py``) and the FSDP parameter layout
they need, on the CPU.

The cells' ``meta`` and ``model_flops`` are held to the reference's
``step_and_specs`` (every cell on the (16, 16) mesh, a sample on the
(2, 16, 16) one), which runs in a subprocess on 512 forced host devices
and lowers nothing (``eval_shape`` only).  Each side consults its own
tuner, with a plan cache of its own under ``tmp_path`` (the FSDP choice of
a train cell is a cached plan).

FSDP: two gloo worlds of four ranks, (1, 2, 2) and (1, 4, 1), train a
reduced dense (remat) and a reduced MoE config for two AdamW steps, and
the dense one for two Adafactor steps (its update on the rank's blocks),
with FSDP forced, and each is held to the unsharded ``Trainer`` within
``test_torch_sharding.py``'s tolerances (loss 1e-6 relative, parameters
1e-6 of the larger of 1 and their largest entry), and to the reference's
``make_train_step`` under ``use_mesh`` with its FSDP specs
(``tree_zero_shardings`` over ``data``, as its dry run lowers) within the
tolerances that file holds the reference to (loss 1e-5, parameters 1e-4);
each rank holds 1/(data * model) of each leaf the layout cuts over both.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_CELLS, SHAPES, get
from repro_torch.distributed import spawn
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import counting_mesh
from repro_torch.models.convert import reference_leaves
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, Trainer
from repro_torch.tuner import Tuner

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
#: the multi-pod sample: both FSDP archs, an FSDP-by-model choice, each
#: cell kind
MULTIPOD = [("qwen1.5-110b", "train_4k"), ("arctic-480b", "train_4k"),
            ("granite-20b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
            ("starcoder2-3b", "prefill_32k"), ("whisper-tiny", "prefill_32k"),
            ("hymba-1.5b", "decode_32k"), ("xlstm-350m", "long_500k")]
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
KEYS = ("fsdp", "microbatches", "grad_accum_dtype", "opt_state_dtype",
        "cache_len", "params", "active_params", "kind")
#: the reference's other sharding profiles; their cells' keys are
#: "<profile>/<mesh>/<arch>@<shape>" (the baseline's "<mesh>/...")
PROFILES = ("dp_sp", "seq_sp")

REFERENCE = textwrap.dedent(r"""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from repro.configs import ALL_CELLS
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import rules_for, step_and_specs
    sample = [tuple(c) for c in json.loads(sys.argv[2])]
    out = {}
    for name, multi in (("pod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for profile in ("baseline", "dp_sp", "seq_sp"):
            pre = "" if profile == "baseline" else profile + "/"
            for arch, shape in (ALL_CELLS if not multi else sample):
                with shd.use_mesh(mesh, rules=rules_for(arch, profile)):
                    _, args, flops, meta = step_and_specs(arch, shape, mesh)
                # the rank's rows: the tokens' block under their sharding
                tok = (args[1] if meta["kind"] == "decode" else
                       args[-1]["tokens"])
                rows = tok.sharding.shard_shape(tok.shape)[0]
                out[f"{pre}{name}/{arch}@{shape}"] = dict(
                    meta, model_flops=flops, rows=rows)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_meta(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_specs")
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", REPRO_PLAN_DIR=str(d / "plans"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC,
                          json.dumps(MULTIPOD)], capture_output=True,
                         text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_meta(tmp_path_factory):
    """The port's (meta, model_flops) of the same cells, through a tuner
    whose plan cache is its own."""
    import repro_torch.tuner as tuner_mod
    tuner = Tuner(plan_dir=str(tmp_path_factory.mktemp("port_plans")))
    saved = tuner_mod.default_tuner
    tuner_mod.default_tuner = lambda: tuner
    try:
        out = {}
        for profile in ("baseline",) + PROFILES:
            pre = "" if profile == "baseline" else profile + "/"
            for name, shape in MESHES.items():
                cells = ALL_CELLS if name == "pod" else MULTIPOD
                for arch, s in cells:
                    mesh = counting_mesh(shape).with_rules(
                        specs.rules_for(arch, profile))
                    meta, flops = specs.cell_meta(get(arch), SHAPES[s], mesh)
                    out[f"{pre}{name}/{arch}@{s}"] = dict(
                        meta, model_flops=flops,
                        rows=specs.batch_rows(SHAPES[s], mesh))
        return out
    finally:
        tuner_mod.default_tuner = saved


def test_every_cell_is_sampled():
    assert len(ALL_CELLS) == 32
    assert set(MULTIPOD) <= set(ALL_CELLS)


_CELL_KEYS = ([f"pod/{a}@{s}" for a, s in ALL_CELLS]
              + [f"multipod/{a}@{s}" for a, s in MULTIPOD])


@pytest.mark.parametrize(
    "key", _CELL_KEYS + [f"{p}/{k}" for p in PROFILES for k in _CELL_KEYS])
def test_meta_equals_the_references(reference_meta, port_meta, key):
    """``fsdp``, ``microbatches``, ``grad_accum_dtype``,
    ``opt_state_dtype``, ``cache_len``, ``params``, ``active_params``, the
    rank's rows of the batch and ``model_flops``, exactly, under the
    baseline's rules and the ``dp_sp`` and ``seq_sp`` profiles'."""
    want, got = reference_meta[key], port_meta[key]
    for k in KEYS:
        assert got.get(k) == want.get(k), k
    assert got["rows"] == want["rows"]
    assert got["model_flops"] == want["model_flops"]


def test_the_fsdp_cells_are_the_references(reference_meta):
    """The layout this slice adds is taken where the reference takes it:
    qwen1.5-110b and arctic-480b by memory, on every train cell."""
    fsdp = {k for k, m in reference_meta.items() if m["fsdp"]}
    assert {"pod/qwen1.5-110b@train_4k", "pod/arctic-480b@train_4k",
            "multipod/qwen1.5-110b@train_4k"} <= fsdp


def test_step_and_specs_builds_the_rank_on_meta():
    """The rank's arguments are meta tensors of its blocks: starcoder2-3b
    train on the pod mesh holds 16 rows, AdamW moments of the ZeRO-1
    blocks, and parameters cut over ``model``; ``meta`` is ``cell_meta``'s
    plus the rank's notes.  A decode cell is lowered: one token a row of
    the rank's 8 rows, its blocks of the caches (hymba's 1024-slot window
    cut over ``model``, its SSD state whole: 25 heads do not divide 16)."""
    mesh = counting_mesh((16, 16))
    fn, (net, opt, batch), flops, meta = specs.step_and_specs(
        "starcoder2-3b", "train_4k", mesh)
    assert all(p.device.type == "meta" for p in net.parameters())
    assert batch["tokens"].shape == (16, 4096) and meta["batch_rows"] == 16
    assert meta["layers"] == 30 and meta["rank"] == 0
    want, want_flops = specs.cell_meta(get("starcoder2-3b"),
                                       SHAPES["train_4k"], mesh)
    assert flops == want_flops
    assert {k: meta[k] for k in want} == want
    w = dict(net.named_parameters())["layers.0.mlp.up.w"]
    assert tuple(w.shape) == (3072, 12288 // 16)
    mu = opt.mu["groups/0/0/mlp/up/w"]
    assert mu.device.type == "meta" and tuple(mu.shape) == (30, 3072 // 16,
                                                            12288 // 16)
    fn, (net, tokens, caches, memory), _, meta = specs.step_and_specs(
        "hymba-1.5b", "decode_32k", mesh)
    assert callable(fn) and memory is None and "not_lowered" not in meta
    assert tokens.shape == (8, 1) and meta["cache_len"] == 1024
    kv, ssm = caches[0]["kv"], caches[0]["ssm"]
    assert kv.k.device.type == "meta" and kv.k.shape == (8, 5, 64, 64)
    assert kv.k.placement.mode == "kv_seq" and kv.length.shape == (8,)
    assert ssm.S.shape == (8, 25, 16, 64)
    assert len(caches) == 32


DECODE_CELLS = [(a, s) for a, s in ALL_CELLS
                if SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("cell", DECODE_CELLS, ids="@".join)
def test_lowered_decode_meta_equals_the_references(reference_meta, cell):
    """The 12 decode cells' ``meta`` from the lowered ``step_and_specs``
    (``cache_len``, ``fsdp``, the parameter counts) and ``model_flops``
    are the reference's on the pod mesh; the rank's caches hold
    ``cache_len`` slots over ``model``."""
    arch, shape = cell
    mesh = counting_mesh((16, 16))
    _, (_, tokens, caches, _), flops, meta = specs.step_and_specs(
        arch, shape, mesh)
    want = reference_meta[f"pod/{arch}@{shape}"]
    for k in KEYS:
        assert meta.get(k) == want.get(k), k
    assert flops == want["model_flops"]
    rows = SHAPES[shape].global_batch
    assert tokens.shape == ((rows // 16 if rows % 16 == 0 else rows), 1)
    kv = next((c["kv"] for c in caches if "kv" in c), None)
    if kv is not None:
        assert kv.k.shape[2] * 16 == meta["cache_len"]


def test_depth_cut():
    mesh = counting_mesh((16, 16))
    _, (net, _), flops, meta = specs.step_and_specs(
        "starcoder2-3b", "prefill_32k", mesh, layers=2)
    assert meta["layers"] == 2 and len(net.layers) == 2
    cfg = dataclasses.replace(get("starcoder2-3b"), n_layers=2)
    assert flops == 2.0 * cfg.param_count() * 32 * 32768


RULES = textwrap.dedent(r"""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from repro.configs import ARCHS
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import PROFILES, rules_for
    out = {"profiles": sorted(PROFILES)}
    for name, multi in (("pod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for profile in PROFILES:
            for arch in ARCHS:
                given = rules_for(arch, profile)
                with shd.use_mesh(mesh, rules=given):
                    fixed = shd.active()[1]
                out[f"{profile}/{arch}"] = given
                out[f"{name}/{profile}/{arch}"] = fixed
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_rules():
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", RULES, SRC],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _as_json(rules):
    return json.loads(json.dumps(rules))


@pytest.mark.parametrize("profile", ["baseline", "dp_sp", "seq_sp"])
def test_profiles_are_the_references(reference_rules, profile):
    """``rules_for`` gives the reference's dict for every arch, and the
    rules a mesh runs under (``Mesh.rules``, as ``use_mesh`` fixes them
    to the mesh's axes) equal the reference's ``use_mesh``'s on (16, 16)
    and (2, 16, 16)."""
    from repro_torch.configs import ARCHS
    assert sorted(specs.PROFILES) == reference_rules["profiles"]
    for arch in ARCHS:
        rules = specs.rules_for(arch, profile)
        assert _as_json(rules) == reference_rules[f"{profile}/{arch}"]
        for name, shape in MESHES.items():
            mesh = counting_mesh(shape).with_rules(rules)
            assert _as_json(mesh.rules) == \
                reference_rules[f"{name}/{profile}/{arch}"], (name, arch)
            with shd.use_mesh(mesh):
                assert shd.active()[1] == mesh.rules


def test_fsdp_spec_keeps_the_layer_axis_whole():
    """Where the reference's ZeRO spec cuts the layer axis of a stacked
    (L, X) leaf, the port cuts X: the same bytes a rank."""
    mesh = counting_mesh((16, 16))
    spec = shd.fsdp_spec("layers/norm1/scale", (80, 8192), mesh, True)
    assert shd.leaf_zero_spec("layers/norm1/scale", (80, 8192),
                              mesh) == shd.P("data", None)
    assert spec == shd.P(None, "data")
    assert shd.fsdp_spec("layers/mlp/up/w", (80, 8192, 49152), mesh,
                         True) == shd.leaf_zero_spec(
        "layers/mlp/up/w", (80, 8192, 49152), mesh)


# -- FSDP against the unsharded trainer ----------------------------------------

FSDP_MESHES = [(1, 2, 2), (1, 4, 1)]
FSDP_CASES = [("starcoder2-3b", "adamw"), ("qwen2-moe-a2.7b", "adamw"),
              ("starcoder2-3b", "adafactor")]
BATCH, SEQ, STEPS, SEED = 4, 32, 2, 0
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)


def _trainer(arch, kind, mesh=None, fsdp=False):
    cfg = dataclasses.replace(get(arch).reduced(),
                              remat=arch == "starcoder2-3b")
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**OPT, kind=kind),
        data=DataConfig(cfg.vocab_size, SEQ, BATCH, seed=SEED),
        n_steps=STEPS), mesh=mesh, seed=SEED, device="cpu", fsdp=fsdp)


def _batch(cfg):
    rng = np.random.default_rng(SEED + 7)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _run(tr):
    losses = []
    for _ in range(STEPS):
        m = tr.train_step({k: torch.from_numpy(v)
                           for k, v in tr.rows(_batch(tr.cfg.model)).items()})
        losses.append({k: float(v) for k, v in m.items()})
    return losses, {p: np.array(v) for p, v in tr._whole_leaves()[0].items()}


def _fsdp_rank(rank, world, device, mesh_shape):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape)
    out = {}
    for arch, kind in FSDP_CASES:
        tr = _trainer(arch, kind, mesh, fsdp=True)
        lay = tr.layout
        params = dict(tr.net.named_parameters())
        share = {}
        for path, leaf in reference_leaves(tr.net).items():
            if not lay.fsdp(path):
                continue
            held = sum(params[n].numel() for n in leaf.names)
            share[path] = (held, math.prod(lay.shapes[path]),
                           lay.cut(path),
                           tr.opt_state.mu is None
                           or tuple(tr.opt_state.mu[path].shape)
                           == shd.block_shape(lay.shapes[path],
                                              lay.specs[path], mesh))
        out[(arch, kind)] = (_run(tr), share)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def fsdp_worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    return {shape: spawn(_fsdp_rank, 4, init_dir=str(root / "".join(
        map(str, shape))), timeout_s=600, args=(shape,))[0]
        for shape in FSDP_MESHES}


@pytest.fixture(scope="module")
def fsdp_unsharded():
    """{case: ((losses, whole params), initial params)}: the unsharded
    trainer's two steps and where they start, as the reference's
    leaves."""
    out = {}
    for case in FSDP_CASES:
        tr = _trainer(*case)
        init = {p: np.array(v) for p, v in tr._whole_leaves()[0].items()}
        out[case] = (_run(tr), init)
    return out


# the reference's FSDP step: ``make_train_step`` under ``use_mesh`` with the
# parameters and the optimizer state placed by ``tree_zero_shardings`` over
# ``data`` (the specs its dry run lowers with, ``launch/specs.py``), on four
# forced host devices
REFERENCE_FSDP = textwrap.dedent(r"""
    import dataclasses, json, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.configs import get
    from repro.distributed import sharding as shd
    from repro.distributed.sharding import tree_paths
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import rules_for
    from repro.models import build_model
    from repro.training import AdamWConfig, init_adamw, make_train_step

    d = sys.argv[2]
    spec = json.load(open(d + "/spec.json"))
    data = np.load(d + "/inputs.npz")

    def nest(flat):
        root = {}
        for path, leaf in flat.items():
            node = root
            *parents, last = path.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = leaf
        def listify(n):
            if not isinstance(n, dict):
                return n
            out = {k: listify(v) for k, v in n.items()}
            if out and all(k.isdigit() for k in out):
                return [out[str(i)] for i in range(len(out))]
            return out
        return listify(root)

    def fsdp(tree, mesh):
        return jax.device_put(tree, shd.tree_zero_shardings(
            mesh, tree, data_axes=("data",)))

    out = {}
    for arch, kind in spec["cases"]:
        cfg = dataclasses.replace(get(arch).reduced(),
                                  remat=arch == "starcoder2-3b")
        model = build_model(cfg)
        pre = arch + "::" + kind + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        for shape in spec["meshes"]:
            mesh = make_mesh(*shape)
            tag = pre + ",".join(map(str, shape))
            with shd.use_mesh(mesh, rules=rules_for(arch)):
                opt = AdamWConfig(**spec["opt"], kind=kind)
                batch = {}
                for k in ("tokens", "labels"):
                    x = jnp.asarray(data["batch::" + arch + "::" + k])
                    batch[k] = jax.device_put(x, NamedSharding(
                        mesh, shd.valid_spec(JP(("pod", "data"), None),
                                             x.shape, mesh)))
                params = fsdp(nest(dict(flat)), mesh)
                state = fsdp(init_adamw(opt, params), mesh)
                step = jax.jit(make_train_step(model, opt))
                for i in range(spec["steps"]):
                    params, state, m = step(params, state, batch)
                    params, state = fsdp(params, mesh), fsdp(state, mesh)
                    out[tag + "::loss" + str(i)] = np.asarray(m["loss"])
            for p, v in tree_paths(params):
                out[tag + "::" + p] = np.asarray(v)
    np.savez(d + "/ref.npz", **out)
""")


@pytest.fixture(scope="module")
def fsdp_reference(tmp_path_factory, fsdp_unsharded):
    d = tmp_path_factory.mktemp("ref_fsdp")
    arrays = {}
    for (arch, kind), (_, init) in fsdp_unsharded.items():
        arrays.update((f"{arch}::{kind}::{p}", v) for p, v in init.items())
        cfg = get(arch).reduced()
        arrays.update((f"batch::{arch}::{k}", v)
                      for k, v in _batch(cfg).items())
    np.savez(d / "inputs.npz", **arrays)
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": FSDP_CASES, "meshes": FSDP_MESHES,
                   "steps": STEPS, "opt": OPT}, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", REPRO_PLAN_DIR=str(d / "plans"))
    res = subprocess.run([sys.executable, "-c", REFERENCE_FSDP, SRC, str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shape", FSDP_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", FSDP_CASES, ids="-".join)
def test_fsdp_steps_equal_the_unsharded_trainer(fsdp_worlds, fsdp_unsharded,
                                                case, shape):
    (losses, params), _ = fsdp_worlds[shape][case]
    (want_l, want_p), _ = fsdp_unsharded[case]
    for got, want in zip(losses, want_l):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert set(params) == set(want_p)
    for path, w in want_p.items():
        err = np.abs(params[path] - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), 1.0), path


#: leaves whose gradient is zero in exact arithmetic: a bias on the keys
#: adds q . b to every score of a query's row, which the softmax cancels.
#: Adafactor's step is g over the RMS of g, so on these leaves it is
#: rounding noise scaled up to the learning rate, on either side and with
#: or without a mesh (the unsharded port is 1.3e-4 of the largest entry
#: from the reference there); AdamW's eps of 1e-3 damps it, so only the
#: AdamW cases compare them with the reference
ZERO_GRADIENT_LEAVES = ("attn/wk/b",)


@pytest.mark.parametrize("shape", FSDP_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", FSDP_CASES, ids="-".join)
def test_fsdp_steps_equal_the_references_fsdp_step(fsdp_worlds,
                                                   fsdp_reference, case,
                                                   shape):
    """The reference's ``make_train_step`` under ``use_mesh(make_mesh(...))``
    with its FSDP specs, from the same parameters on the same batch: loss
    within 1e-5 at each step, every parameter within 1e-4 of its largest
    entry (``test_torch_sharding.py``'s tolerances against the reference),
    but for Adafactor's :data:`ZERO_GRADIENT_LEAVES`."""
    (losses, params), _ = fsdp_worlds[shape][case]
    tag = f"{case[0]}::{case[1]}::{','.join(map(str, shape))}"
    for i, got in enumerate(losses):
        want = float(fsdp_reference[f"{tag}::loss{i}"])
        assert got["loss"] == pytest.approx(want, rel=1e-5), i
    noise = {p for p in params if p.endswith(ZERO_GRADIENT_LEAVES)}
    assert noise, "the config has key biases"
    for path, p in params.items():
        if case[1] == "adafactor" and path in noise:
            continue
        want = fsdp_reference[f"{tag}::{path}"]
        assert np.abs(p - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                    1e-30), path


@pytest.mark.parametrize("shape", FSDP_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", FSDP_CASES, ids="-".join)
def test_each_rank_holds_its_fsdp_share(fsdp_worlds, case, shape):
    """Every FSDP leaf: 1/data of it a rank, 1/(data * model) where the
    leaf is cut over ``model`` too; AdamW's moments are its blocks' shape.
    Most leaves are FSDP leaves."""
    _, share = fsdp_worlds[shape][case]
    data, model = shape[1], shape[2]
    assert len(share) >= 8
    for path, (held, whole, cut, moments) in share.items():
        assert held * data * (model if cut else 1) == whole, path
        assert moments, path
