"""Sharded training: the port's ``distributed/sharding.py``,
``launch/mesh.py`` and the mesh paths of the models, the optimizer
(ZeRO-1), the trainer, the checkpoints and ``compress_pod_mean``, against
the reference, on the CPU.

The reference's rule cases (``tests/test_sharding_and_hlo.py``:
TestValidSpec, TestZeroSpec, TestParamRules) run on the port's copy, and a
hypothesis test holds ``valid_spec``, ``zero_spec`` and
``param_logical_axes`` to the reference's on random shapes, meshes and
leaf paths and on every leaf of the ten reduced configs.

Three gloo worlds of four ranks (``distributed.spawn``, one thread a rank,
a file store under ``tmp_path``) run once per module, on meshes
(1, 2, 2), (2, 2, 1) and (1, 1, 4).  Each trains a dense arch (with remat),
an MoE, hymba and xlstm at reduced width for two steps from one seed on
one numpy batch; the losses and the gathered parameters are held to the
port's unsharded ``Trainer`` (1e-6) and to the reference's
``make_train_step`` under ``use_mesh(make_mesh(...))`` on the converted
parameters (loss 1e-5, parameters 1e-4), which runs in a subprocess with
four forced host devices.  AdamW's eps is 1e-3 there: at step 1 Adam moves
each parameter by about lr * g / (|g| + eps), so with the default 1e-8 a
gradient within 1e-8 of zero, where summation orders differ, moves its
parameter by anything up to lr.  The worlds also check each rank's
blocks against ``valid_spec`` / ``zero_spec`` shapes, ``shard_of`` and
``gather``, the mesh's coordinates against the reference's device order,
``compress_pod_mean`` over two pods, and checkpoints across meshes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import get as ref_get
from repro.distributed import sharding as ref_shd
from repro.distributed.sharding import tree_paths as ref_tree_paths
from repro.models import build_model as ref_build
from repro.training import AdamState as RefAdamState
from repro.training import checkpoint as ref_ckpt
from repro_torch.configs import get
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import spawn
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, Mesh
from repro_torch.models.convert import (nest, reference_leaves,
                                        to_reference, tree_paths)
from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                  Trainer)
from repro_torch.training import compression
from repro_torch.training.trainer import leaf_templates

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = [(1, 2, 2), (2, 2, 1), (1, 1, 4)]
TRAIN_ARCHS = ["starcoder2-3b", "qwen2-moe-a2.7b", "hymba-1.5b",
               "xlstm-350m"]
BATCH, SEQ, STEPS, SEED = 4, 32, 2, 0
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _cfg(arch):
    cfg = get(arch).reduced()
    # the dense arch trains with remat: the gathers run inside the units
    return dataclasses.replace(cfg, remat=arch == "starcoder2-3b")


def _ref_cfg(arch):
    cfg = ref_get(arch).reduced()
    return dataclasses.replace(cfg, remat=arch == "starcoder2-3b")


def _batch(cfg):
    rng = np.random.default_rng(SEED + 7)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _trainer(arch, mesh=None, device="cpu", directory=None, kind="adamw"):
    cfg = _cfg(arch)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**OPT, kind=kind),
        data=DataConfig(cfg.vocab_size, SEQ, BATCH, seed=SEED),
        n_steps=STEPS, checkpoint_dir=directory, checkpoint_every=1),
        mesh=mesh, seed=SEED, device=device)


def _flat_params(tr):
    """The trainer's parameters as ``{reference leaf path: numpy}``,
    whole (gathered over the mesh)."""
    # copies: a CPU tensor's numpy view follows the in-place updates
    return {path: np.array(v) for path, v in tr._whole_leaves()[0].items()}


def _steps(tr, batch):
    losses = []
    for _ in range(STEPS):
        m = tr.train_step({k: torch.from_numpy(v)
                           for k, v in tr.rows(batch).items()})
        losses.append({k: float(v) for k, v in m.items()})
    return losses


# -- the reference's rule cases on the port's copy ----------------------------

class TestValidSpec:
    def test_drops_indivisible(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        s = shd.valid_spec(P("model", None), (20, 64), mesh)
        assert s == P(None, None)

    def test_drops_duplicate_axis(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        s = shd.valid_spec(P("model", "model"), (32, 32), mesh)
        assert s == P("model", None)

    def test_keeps_valid_tuple(self):
        mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
        s = shd.valid_spec(P(("pod", "data"), "model"), (64, 32), mesh)
        assert s == P(("pod", "data"), "model")

    def test_partial_tuple(self):
        mesh = FakeMesh({"pod": 2, "data": 16})
        s = shd.valid_spec(P(("pod", "data"),), (16,), mesh)
        assert s == P("pod") or s == P(("pod",))


class TestZeroSpec:
    def test_prefers_non_leading_dim_for_stacked(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        s = shd.zero_spec(P(None, None, "model"), (80, 8192, 3072), mesh)
        assert s[1] == "data"
        assert s[0] is None

    def test_matrix_takes_first_free(self):
        mesh = FakeMesh({"data": 16})
        s = shd.zero_spec(P(None, None), (64, 32), mesh)
        assert s[0] == "data"


class TestParamRules:
    def test_expert_banks(self):
        axes = shd.param_logical_axes("groups/0/moe/w_up", 4)
        assert axes[1] == "experts"

    def test_kv_cache_rule(self):
        axes = shd.param_logical_axes("0/kv/k", 5)
        assert axes == (None, "batch", None, "kv_seq", None)

    def test_attention(self):
        assert shd.param_logical_axes("layers/attn/wq/w", 2) == (None, "heads")


def test_rules_are_the_references():
    assert shd.DEFAULT_RULES == ref_shd.DEFAULT_RULES
    assert shd._PARAM_RULES == ref_shd._PARAM_RULES


def test_partition_spec_compares_as_a_tuple():
    assert P("model", None) == P("model", None)
    assert P("model", None) != P(None, "model")
    assert tuple(P(("pod", "data"), None)) == (("pod", "data"), None)
    assert shd.constrain(x := torch.ones(3), "batch") is x


# -- the rules against the reference's ---------------------------------------

def _ref(spec):
    return tuple(spec)


def _spec_pair(path, shape, shape_of_mesh):
    """The port's and the reference's valid and ZeRO specs of a leaf,
    the logical axes mapped by the default rules of the mesh."""
    mesh = FakeMesh(shape_of_mesh)
    axes_p = shd.param_logical_axes(path, len(shape))
    axes_r = ref_shd.param_logical_axes(path, len(shape))
    assert tuple(axes_p) == tuple(axes_r), path
    names = set(shape_of_mesh)

    def rule(a):
        v = ref_shd.DEFAULT_RULES.get(a) if a is not None else None
        if isinstance(v, tuple):
            v = tuple(x for x in v if x in names) or None
        elif v is not None and v not in names:
            v = None
        return v

    parts = [rule(a) for a in axes_p]
    got_v = shd.valid_spec(P(*parts), shape, mesh)
    want_v = ref_shd.valid_spec(JP(*parts), shape, mesh)
    got_z = shd.zero_spec(got_v, shape, mesh)
    want_z = ref_shd.zero_spec(want_v, shape, mesh)
    return (tuple(got_v), tuple(got_z)), (_ref(want_v), _ref(want_z))


_MESH_SHAPES = st.one_of(
    st.builds(lambda d, m: {"data": d, "model": m},
              st.sampled_from([1, 2, 3, 4, 8, 16]),
              st.sampled_from([1, 2, 4, 5, 16])),
    st.builds(lambda p, d, m: {"pod": p, "data": d, "model": m},
              st.sampled_from([2, 4]), st.sampled_from([1, 2, 16]),
              st.sampled_from([1, 2, 4, 16])))
_PATHS = st.sampled_from(
    [frag for frag, _ in shd._PARAM_RULES]
    + ["groups/0/0/attn/wq/w", "groups/0/0/attn/wq/b",
       "groups/0/1/slstm/wo/w", "groups/0/0/mlstm/wo_gate/w",
       "groups/0/0/moe/shared/up/w", "groups/0/0/moe/w_down",
       "enc_layers/attn/wk/w", "dec_layers/cross/wv/w", "final_norm/scale",
       "lm_head/w", "embed/w", "enc_pos_table", "router/w"])


@settings(max_examples=200, deadline=None)
@given(path=_PATHS,
       shape=st.lists(st.sampled_from([1, 2, 3, 4, 5, 8, 12, 16, 20, 32, 48,
                                       60, 64, 80, 128]),
                      min_size=1, max_size=4),
       mesh=_MESH_SHAPES)
def test_specs_equal_the_references_on_random_leaves(path, shape, mesh):
    got, want = _spec_pair(path, tuple(shape), mesh)
    assert got == want


def _reference_leaves(arch):
    """(path, shape) of every leaf of the reference's reduced config."""
    cfg = ref_get(arch).reduced()
    tree = jax.eval_shape(ref_build(cfg).init, jax.random.PRNGKey(0))
    return [(p, tuple(x.shape)) for p, x in ref_tree_paths(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references_on_every_reduced_leaf(arch):
    leaves = _reference_leaves(arch)
    assert leaves
    for mesh in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                 {"pod": 2, "data": 2, "model": 1},
                 {"pod": 2, "data": 4, "model": 8}):
        for path, shape in leaves:
            got, want = _spec_pair(path, shape, mesh)
            assert got == want, (arch, mesh, path)


def test_shard_of_covers_the_tensor():
    """Every rank's ``shard_of`` block, put back by the spec's rule (the
    first axis of a tuple major), rebuilds the tensor."""
    x = torch.arange(8 * 12 * 2, dtype=torch.float32).reshape(8, 12, 2)
    shape = {"pod": 2, "data": 2, "model": 3}
    spec = P(("pod", "data"), "model", None)
    out = torch.full_like(x, -1.0)
    for r in range(12):
        m = Mesh(shape, r)
        b = shd.shard_of(x, spec, m)
        assert tuple(b.shape) == shd.block_shape(x.shape, spec, m) == (2, 4, 2)
        i, j = m.axis_index(("pod", "data")), m.coords["model"]
        out[2 * i:2 * i + 2, 4 * j:4 * j + 4] = b
    assert torch.equal(out, x)


def test_a_mesh_without_groups_does_not_communicate():
    m = Mesh({"data": 2, "model": 2}, 3)
    assert m.coords == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="no process groups"):
        m.group("model")
    with pytest.raises(ValueError, match="not in a mesh"):
        Mesh({"data": 2}, 2)


# -- the reference's side: one subprocess, four forced host devices ----------

REFERENCE = textwrap.dedent(r"""
    import dataclasses, json, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from repro.configs import get
    from repro.distributed import sharding as shd
    from repro.distributed.sharding import tree_paths
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.training import AdamWConfig, init_adamw, make_train_step
    from repro.training.compression import compress_pod_mean

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

    out = {}
    for arch in spec["archs"]:
        cfg = dataclasses.replace(get(arch).reduced(),
                                  remat=arch == "starcoder2-3b")
        model = build_model(cfg)
        pre = arch + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        batch = {k: jnp.asarray(data["batch::" + arch + "::" + k])
                 for k in ("tokens", "labels")}
        for shape in spec["meshes"]:
            mesh = make_mesh(*shape)
            tag = arch + "@" + ",".join(map(str, shape))
            with shd.use_mesh(mesh):
                opt = AdamWConfig(**spec["opt"])
                params = nest(dict(flat))
                state = init_adamw(opt, params)
                step = jax.jit(make_train_step(model, opt))
                for i in range(spec["steps"]):
                    params, state, m = step(params, state, batch)
                    out[tag + "::loss" + str(i)] = np.asarray(m["loss"])
            for p, v in tree_paths(params):
                out[tag + "::" + p] = np.asarray(v)
    mesh = make_mesh(2, 1, 2)
    g = {k: jnp.asarray(data["cmp::g::" + k]) for k in ("a", "b")}
    e = {k: jnp.asarray(data["cmp::e::" + k]) for k in ("a", "b")}
    mg, ne = compress_pod_mean(g, e, mesh)
    for k in ("a", "b"):
        out["cmp::mean::" + k] = np.asarray(mg[k])
        out["cmp::err::" + k] = np.asarray(ne[k])
    np.savez(d + "/ref.npz", **out)
""")


def _compression_inputs():
    rng = np.random.default_rng(SEED + 3)
    g = {"a": rng.standard_normal((16, 24)).astype(np.float32),
         "b": (rng.standard_normal((40,)) * 1e-3).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    return g, e


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded runs: {arch: (losses, whole params, initial
    params as the reference's leaves)}."""
    out = {}
    for arch in TRAIN_ARCHS:
        tr = _trainer(arch)
        init = _flat_params(tr)
        losses = _steps(tr, _batch(tr.cfg.model))
        out[arch] = (losses, _flat_params(tr), init)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    d = tmp_path_factory.mktemp("ref_sharding")
    arrays = {}
    for arch, (_, _, init) in unsharded.items():
        arrays.update((f"{arch}::{p}", v) for p, v in init.items())
        for k, v in _batch(_cfg(arch)).items():
            arrays[f"batch::{arch}::{k}"] = v
    g, e = _compression_inputs()
    arrays.update((f"cmp::g::{k}", v) for k, v in g.items())
    arrays.update((f"cmp::e::{k}", v) for k, v in e.items())
    np.savez(d / "inputs.npz", **arrays)
    with open(d / "spec.json", "w") as f:
        json.dump({"archs": TRAIN_ARCHS, "meshes": MESHES, "steps": STEPS,
                   "opt": OPT}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC, str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def test_mesh_order_matches_the_references(tmp_path):
    """Each rank's coordinates are those of device ``rank`` in the
    reference's ``make_mesh`` (8 forced host devices for (2, 2, 2))."""
    code = textwrap.dedent(r"""
        import json, sys
        import numpy as np
        sys.path.insert(0, sys.argv[1])
        from repro.launch.mesh import make_mesh
        out = {}
        for shape in [(2, 2, 2), (1, 2, 2), (2, 2, 1), (1, 1, 4), (1, 8, 1)]:
            mesh = make_mesh(*shape)
            ids = np.vectorize(lambda dv: dv.id)(mesh.devices)
            out[",".join(map(str, shape))] = {
                "axes": list(mesh.shape.keys()),
                "coords": {str(int(ids[i])): list(i)
                           for i in np.ndindex(ids.shape)}}
        print(json.dumps(out))
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", code, SRC],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for key, ref in want.items():
        pods, data, model = (int(x) for x in key.split(","))
        shape = ({"pod": pods, "data": data, "model": model} if pods > 1
                 else {"data": data, "model": model})
        assert list(shape) == ref["axes"]
        n = pods * data * model
        # the reference lays the mesh over the first n of its 8 devices
        for rank in range(n):
            m = Mesh(shape, rank)
            assert [m.coords[a] for a in shape] == ref["coords"][str(rank)]


# -- the port's worlds ----------------------------------------------------------

def _world_rank(rank, world, device, mesh_shape, tasks, d):
    """One rank of a world on ``mesh_shape``: the sharded runs of the
    four archs, and the world's other tasks.  Returns rank-0's results
    (every rank takes part in every collective)."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape)
    out = {"coords": mesh.coords, "train": {}, "blocks_ok": {}}
    for arch in TRAIN_ARCHS:
        tr = _trainer(arch, mesh)
        lay = tr.layout
        ok = []
        params = dict(tr.net.named_parameters())
        for path, leaf in reference_leaves(tr.net).items():
            want = shd.block_shape(lay.shapes[path], lay.specs[path], mesh)
            got = tuple(params[leaf.names[0]].shape)
            ok.append(got == (want[1:] if leaf.stacked else want))
            zs = shd.block_shape(lay.shapes[path], lay.zero[path], mesh)
            ok.append(tuple(tr.opt_state.mu[path].shape) == zs
                      == tuple(tr.opt_state.nu[path].shape))
        losses = _steps(tr, _batch(tr.cfg.model))
        out["train"][arch] = (losses, _flat_params(tr))
        out["blocks_ok"][arch] = all(ok)
        out.setdefault("tp", {})[arch] = sorted(
            n for n, m in tr.net.named_modules() if getattr(m, "tp", None))
        out.setdefault("ep_works", {})[arch] = tr.ep_works
    if "roundtrip" in tasks:
        x = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
        ok = []
        for spec in (P("data", "model", None), P(None, None, "model"),
                     P(("data", "model"), None, None), P(None, None, None)):
            ok.append(torch.equal(shd.gather(shd.shard_of(x, spec, mesh),
                                             spec, mesh), x))
        out["roundtrip"] = ok
        # the collectives on a subgroup: rank r of the model axis holds
        # (r + 1) * x
        from repro_torch.distributed import (all_gather, all_reduce,
                                             reduce_scatter)
        group, m = mesh.group("model"), mesh.shape["model"]
        i = mesh.coords["model"]
        mine = x * (i + 1)
        total = x * (m * (m + 1) // 2)
        small = torch.arange(8.0).reshape(2, 4)    # exact in bf16, summed
        out["collectives"] = [
            torch.equal(all_reduce(mine, group), total),
            torch.equal(all_reduce(mine, group, op="mean"), total / m),
            torch.equal(all_gather(mine, group, dim=1),
                        torch.cat([x * (j + 1) for j in range(m)], dim=1)),
            torch.equal(reduce_scatter(mine, group, dim=1),
                        total.narrow(1, i * 8 // m, 8 // m)),
            torch.equal(all_reduce(small.to(torch.bfloat16) * (i + 1),
                                   group).float(),
                        small * (m * (m + 1) // 2)),
            torch.equal(mine, x * (i + 1))]       # the input is left as it was
    if "compress" in tasks:
        g, e = _compression_inputs()
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        te = {k: torch.from_numpy(v) for k, v in e.items()}
        mg, ne = compression.compress_pod_mean(tg, te, mesh)
        out["compress"] = ({k: v.numpy() for k, v in mg.items()},
                           {k: v.numpy() for k, v in ne.items()})
        # pods with gradients of their own: the mean of each pod's
        # dequantized payload
        pod = mesh.coords["pod"]
        own = {k: v * (1 + pod) for k, v in tg.items()}
        z = compression.init_error_buffers(own)
        mine, _ = compression.compress_pod_mean(own, z, mesh)
        out["compress_own"] = {k: v.numpy() for k, v in mine.items()}
    if "adafactor" in tasks:
        tr = _trainer("starcoder2-3b", mesh, kind="adafactor")
        losses = _steps(tr, _batch(tr.cfg.model))
        out["adafactor"] = (losses, _flat_params(tr))
    if "save" in tasks:
        tr = _trainer("starcoder2-3b", mesh, directory=os.path.join(d, "ck"))
        tr.train_step({k: torch.from_numpy(v)
                       for k, v in tr.rows(_batch(tr.cfg.model)).items()})
        tr.save(1)
        out["saved"] = tr._whole_leaves()
    if "restore" in tasks:
        tr = _trainer("starcoder2-3b", mesh, directory=os.path.join(d, "ck"))
        out["restored_step"] = tr.restore()
        out["restored"] = tr._whole_leaves()
        tr = _trainer("starcoder2-3b", mesh,
                      directory=os.path.join(d, "ref_ck"))
        tr.restore()
        out["from_reference"] = tr._whole_leaves()
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("worlds")
    d = str(root)
    # the reference's checkpoint, restored by the (1, 1, 4) world
    tr = _trainer("starcoder2-3b")
    flat = dict(tree_paths(to_reference(dict(tr.net.named_parameters()),
                                        tr.net)))
    rng = np.random.default_rng(SEED + 5)
    mu = {p: rng.standard_normal(v.shape).astype(np.float32)
          for p, v in flat.items()}
    nu = {p: np.abs(rng.standard_normal(v.shape)).astype(np.float32)
          for p, v in flat.items()}
    ref_ckpt.save(os.path.join(d, "ref_ck"), 3,
                  {"params": nest(flat),
                   "opt": RefAdamState(np.asarray(3, np.int32), nest(mu),
                                       nest(nu))})
    tasks = {(1, 2, 2): ("roundtrip", "save", "adafactor"),
             (2, 2, 1): ("compress",),
             (1, 1, 4): ("roundtrip", "restore")}
    out = {}
    for shape in MESHES:
        res = spawn(_world_rank, 4, init_dir=os.path.join(d, "w" + "".join(
            map(str, shape))), timeout_s=600,
            args=(shape, tasks[shape], d))
        out[shape] = res[0]
    out["ref_ck"] = (flat, mu, nu)
    out["dir"] = os.path.join(d, "ck")
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_steps_equal_the_unsharded_port(worlds, unsharded, arch,
                                                shape):
    """Two steps on the mesh: every rank's loss (the batch ranks' mean)
    within 1e-6 relative, and the gathered parameters within 1e-6 of the
    larger of 1 and their largest entry, of the port's unsharded run."""
    losses, params = worlds[shape]["train"][arch]
    want_l, want_p, _ = unsharded[arch]
    for got, want in zip(losses, want_l):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert set(params) == set(want_p)
    for path, w in want_p.items():
        err = np.abs(params[path] - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), 1.0), path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_steps_equal_the_references_use_mesh(worlds, reference, arch,
                                                     shape):
    """The reference's ``make_train_step`` under ``use_mesh(make_mesh(...))``
    on the converted parameters and the same batch: loss within 1e-5 at
    each step, every parameter within 1e-4 of its largest entry."""
    losses, params = worlds[shape]["train"][arch]
    tag = f"{arch}@{','.join(map(str, shape))}"
    for i, got in enumerate(losses):
        want = float(reference[f"{tag}::loss{i}"])
        assert got["loss"] == pytest.approx(want, rel=1e-5), i
    for path, p in params.items():
        assert _rel(p, reference[f"{tag}::{path}"]) <= 1e-4, path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_each_rank_holds_only_its_blocks(worlds, shape):
    """Every parameter is this rank's ``valid_spec`` block of its leaf
    (without the layer dimension) and every AdamW moment its
    ``zero_spec`` block; the tensor-parallel blocks and the MoE's
    expert-parallel fact as the mesh gives them."""
    w = worlds[shape]
    assert all(w["blocks_ok"].values()), w["blocks_ok"]
    model = shape[2]
    tp = w["tp"]["starcoder2-3b"]
    if model == 1:
        assert tp == []
    else:
        # q heads divide 2 and 4; the MLP's d_ff too
        assert "layers.0.attn" in tp and "layers.0.mlp" in tp
        assert "layers.0.attn" in w["tp"]["hymba-1.5b"]
        assert not any("ssd" in n for n in w["tp"]["hymba-1.5b"])
        assert w["tp"]["xlstm-350m"] == []
    assert w["ep_works"]["qwen2-moe-a2.7b"] is (8 % model == 0)
    assert w["ep_works"]["starcoder2-3b"] is None


def test_kv_heads_cut_within_a_head_are_gathered(worlds):
    """starcoder2's two KV heads on model = 4: the query heads run
    tensor-parallel, ``wk`` / ``wv`` are gathered; on model = 2 both are
    tensor-parallel."""
    w4, w2 = worlds[(1, 1, 4)], worlds[(1, 2, 2)]
    assert w4["train"]["starcoder2-3b"] and w2["train"]["starcoder2-3b"]
    cfg = _cfg("starcoder2-3b")
    assert cfg.n_kv_heads == 2 and cfg.n_heads % 4 == 0


def test_adafactor_on_a_mesh_equals_the_unsharded_port(worlds):
    """Adafactor on (1, 2, 2): each leaf gathered over ``model``, updated
    whole (its statistics whole on every rank) and cut again; two steps
    within 1e-6 of the port's unsharded Adafactor."""
    losses, params = worlds[(1, 2, 2)]["adafactor"]
    tr = _trainer("starcoder2-3b", kind="adafactor")
    want_l = _steps(tr, _batch(tr.cfg.model))
    for got, want in zip(losses, want_l):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    for path, w in _flat_params(tr).items():
        err = np.abs(params[path] - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), 1.0), path


def test_rank_coordinates(worlds):
    assert worlds[(1, 2, 2)]["coords"] == {"data": 0, "model": 0}
    assert worlds[(2, 2, 1)]["coords"] == {"pod": 0, "data": 0, "model": 0}


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_shard_of_then_gather_is_the_identity(worlds, shape):
    assert worlds[shape]["roundtrip"] == [True] * 4


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_collectives_on_the_model_axis(worlds, shape):
    """all_reduce (sum, mean, a bf16 tensor), all_gather along a dimension
    and reduce_scatter on the model subgroup, the input unchanged."""
    assert worlds[shape]["collectives"] == [True] * 6


def test_compress_pod_mean_matches_the_reference(worlds, reference):
    """Two pods of one gradient: the port's int8 payload and mean as the
    reference's (``q`` equal: the means agree within 1e-6), the new error
    within 1e-6."""
    mg, ne = worlds[(2, 2, 1)]["compress"]
    g, e = _compression_inputs()
    for k in g:
        want = reference[f"cmp::mean::{k}"]
        assert np.abs(mg[k] - want).max() <= 1e-6 * max(np.abs(want).max(),
                                                        1.0)
        assert np.abs(ne[k] - reference[f"cmp::err::{k}"]).max() <= 1e-6
        x = torch.from_numpy(g[k] + e[k])
        q, scale = compression._quantize(x)
        ref_scale = (np.abs(g[k] + e[k]).max() + 1e-12) / 127.0
        ref_q = np.clip(np.round((g[k] + e[k]) / ref_scale), -127, 127)
        assert np.array_equal(q.numpy(), ref_q.astype(np.int8))


def test_compress_pod_mean_averages_the_pods(worlds):
    """Pods with gradients of their own (pod p holds (1 + p) g): the mean
    of each pod's dequantized int8 payload."""
    got = worlds[(2, 2, 1)]["compress_own"]
    g, _ = _compression_inputs()
    for k, v in g.items():
        want = 0.0
        for pod in (0, 1):
            x = torch.from_numpy(v * (1 + pod))
            q, s = compression._quantize(x)
            want = want + compression._dequantize(q, s).numpy()
        assert np.abs(got[k] - want / 2).max() <= 1e-6


def test_checkpoint_saved_on_one_mesh_restores_on_another(worlds, tmp_path):
    """Saved on (1, 2, 2); restored on (1, 1, 4), on one rank and by the
    reference's ``restore``: the same parameters and moments."""
    params, mu, nu = worlds[(1, 2, 2)]["saved"]
    r_params, r_mu, r_nu = worlds[(1, 1, 4)]["restored"]
    assert worlds[(1, 1, 4)]["restored_step"] == 1
    for a, b in ((params, r_params), (mu, r_mu), (nu, r_nu)):
        assert set(a) == set(b)
        for path in a:
            assert np.array_equal(a[path], b[path]), path
    ck = worlds["dir"]
    one = _trainer("starcoder2-3b", directory=ck)
    assert one.restore() == 1
    got = dict(tree_paths(to_reference(dict(one.net.named_parameters()),
                                       one.net)))
    for path, v in params.items():
        assert np.array_equal(got[path], v), path
    for path, v in mu.items():
        assert np.array_equal(one.opt_state.mu[path].numpy(), v), path
    tmpl = {"params": nest({p: np.zeros_like(v) for p, v in params.items()})}
    trees, manifest = ref_ckpt.restore(ck, tmpl)
    assert manifest["extra"]["mesh"] == {"data": 2, "model": 2}
    for path, v in ref_tree_paths(trees["params"]):
        assert np.array_equal(np.asarray(v), params[path]), path


def test_reference_checkpoint_restores_onto_a_mesh(worlds):
    """A checkpoint the reference wrote (whole leaves) cut onto the
    (1, 1, 4) mesh and gathered back: equal leaves."""
    flat, mu, nu = worlds["ref_ck"]
    params, r_mu, r_nu = worlds[(1, 1, 4)]["from_reference"]
    for a, b in ((flat, params), (mu, r_mu), (nu, r_nu)):
        for path in a:
            assert np.array_equal(a[path], b[path]), path


def test_launcher_mesh_2_2_2_on_eight_ranks(capsys):
    """``launch/train.py --mesh 2,2,2`` spawns 8 gloo ranks on the CPU and
    prints ``steps=3 restarts=0``; its step-0 ``ce`` is within 1e-5 of the
    unsharded run's on the same weights and batch."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "8", "--seq", "32"]
    sharded = launch_train.main(argv + ["--mesh", "2,2,2"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "steps=3 restarts=0"
    assert sharded["steps"] == 3 and sharded["restarts"] == 0
    whole = launch_train.main(argv)
    assert sharded["logged"][0]["ce"] == pytest.approx(
        whole["logged"][0]["ce"], rel=1e-5)
