"""The sharded decode step (the reference's cache rules) against the
reference's ``decode_step`` under ``use_mesh`` and the port's unsharded
decode, on the CPU.

The caches follow the reference's rules: a KV cache's slots over
``model`` (``("batch", None, "kv_seq", None)``), the recurrent states'
heads over ``model``, the rows over the batch axes.  Each case's reduced
config is drawn from one seed; gloo worlds of four ranks on (1, 2, 2)
and (1, 1, 4) decode the same numpy tokens, each rank on its rows and its
blocks of the caches (``Model.init_cache(..., mesh=)``), through
``make_serve_step(model, mesh)``.  The reference runs its ``decode_step``
jitted under ``use_mesh(make_mesh(...))``, its parameters and caches
placed by ``tree_shardings``, on the port's parameters and memory, in a
subprocess with four forced host devices.  Logits within 1e-5 of their
largest value of both, every step; the caches gathered back equal the
reference's and the unsharded port's within 1e-5 of their largest entry.

The cases: a dense arch with a full cache; the chunked path (three
tokens a step, so chunks straddle the ranks' slots); hymba, whose window
of 16 slots wraps across the ranks (4 a rank on ``model`` = 4: for the
first 12 tokens rank 3 holds no valid slot, and must add nothing);
xlstm (the mLSTM's and the sLSTM's states by heads, both blocks
tensor-parallel); whisper (a tensor-parallel cross-attention against the
encoder's states, whose layout is the batch axes only); the reduced
qwen2-moe (one token a routing group: the experts' own slice of it on
each rank); the VLM (its self-attention layer's KV cache and its
tensor-parallel cross layer against the image embeddings).

Caches carried across (``models/convert.py``): the unsharded decode's
caches as the reference's tree, loaded into each rank's blocks and
gathered back, are the same tree, and the decode goes on from them.

The cache specs: every arch's, at its decode_32k cell, equal the
reference's ``tree_shardings`` of its ``init_decode_cache`` on (16, 16)
and (2, 16, 16) (512 forced host devices).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.distributed import spawn
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import counting_mesh
from repro_torch.launch.prefill import stub_inputs
from repro_torch.models import build_model
from repro_torch.models.convert import (cache_paths, cache_to_reference,
                                        load_reference_cache, to_reference,
                                        tree_paths)
from repro_torch.serving.engine import make_serve_step

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = [(1, 2, 2), (1, 1, 4)]
#: case -> (arch, tokens a step, steps' tokens, cache slots)
CASES = {"dense": ("starcoder2-3b", 1, 12, 16),
         "chunked": ("starcoder2-3b", 3, 12, 16),
         "hymba": ("hymba-1.5b", 1, 24, 32),
         "xlstm": ("xlstm-350m", 1, 8, 16),
         "whisper": ("whisper-tiny", 1, 8, 16),
         "moe": ("qwen2-moe-a2.7b", 1, 8, 16),
         "vlm": ("llama-3.2-vision-11b", 1, 8, 16)}
BATCH, SEED, TOL = 2, 0, 1e-5


def _tokens(cfg, case):
    _, _, s, _ = CASES[case]
    rng = np.random.default_rng(SEED + len(case))
    return rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int64)


def _decode(model, net, caches, toks, memory, s1, mesh=None):
    step = make_serve_step(model, mesh)
    outs = []
    for t in range(0, toks.shape[1], s1):
        logits, caches = step(net, torch.from_numpy(toks[:, t:t + s1]),
                              caches, memory)
        outs.append(logits)
    return torch.cat(outs, 1).numpy(), caches


def _setup(case):
    arch, s1, _, slots = CASES[case]
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(SEED, device="cpu")
    stubs = stub_inputs(cfg, BATCH, device="cpu")
    with torch.inference_mode():
        memory = model.encode_memory(net, stubs) if stubs else None
    return cfg, model, net, memory, s1, slots


def _world_rank(rank, world, device, mesh_shape):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape)
    out = {"coords": mesh.coords}
    for case in CASES:
        cfg, model, net, memory, s1, slots = _setup(case)
        toks = _tokens(cfg, case)
        model.shard(net, mesh)
        n = mesh.axis_size(mesh.batch_axes)
        i = mesh.axis_index(mesh.batch_axes)
        rows = slice(i * BATCH // n, (i + 1) * BATCH // n)
        caches = model.init_cache(BATCH, slots, device="cpu", mesh=mesh)
        blocks = {f"{j}/{key}/{f}": tuple(getattr(st, f).shape)
                  for j, layer in enumerate(caches)
                  for key, st in layer.items() for f in st._fields}
        logits, caches = _decode(model, net, caches, toks[rows],
                                 None if memory is None else memory[rows],
                                 s1, mesh)
        whole = model.init_cache(BATCH, slots, device="meta")
        out[case] = {"logits": logits, "rows": (rows.start, rows.stop),
                     "blocks": blocks,
                     "caches": dict(tree_paths(cache_to_reference(
                         caches, cfg, mesh, whole)))}
        out[case]["carried"] = _carried(case, model, net, mesh, rows,
                                        memory, toks, whole)
    return out


def _carried(case, model, net, mesh, rows, memory, toks, whole):
    """The unsharded decode's caches after the first half of the tokens,
    as the reference's tree, loaded into the rank's blocks
    (``load_reference_cache``) and gathered back; then the second half
    decoded on the blocks.  Returns (the tree, the tree gathered back,
    the second half's logits)."""
    cfg = model.cfg
    _, s1, s, slots = CASES[case]
    half = s // 2 // s1 * s1
    plain = build_model(cfg)
    unsharded = plain.init(SEED, device="cpu")
    _, caches = _decode(plain, unsharded, plain.init_cache(
        BATCH, slots, device="cpu"), toks[:, :half], memory, s1)
    tree = cache_to_reference(caches, cfg)
    blocks = load_reference_cache(model.init_cache(
        BATCH, slots, device="cpu", mesh=mesh), tree, cfg, mesh)
    back = cache_to_reference(blocks, cfg, mesh, whole)
    logits, _ = _decode(model, net, blocks, toks[rows, half:],
                        None if memory is None else memory[rows], s1, mesh)
    return dict(tree_paths(tree)), dict(tree_paths(back)), logits


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode_mesh")
    return {shape: spawn(_world_rank, 4, init_dir=str(root / "".join(
        map(str, shape))), timeout_s=600, args=(shape,))
        for shape in MESHES}


@pytest.fixture(scope="module")
def unsharded():
    """{case: (logits, caches as the reference's leaves, params as the
    reference's tree, memory)} of the port's unsharded decode."""
    out = {}
    for case in CASES:
        cfg, model, net, memory, s1, slots = _setup(case)
        params = to_reference(dict(net.named_parameters()), net)
        logits, caches = _decode(model, net,
                                 model.init_cache(BATCH, slots,
                                                  device="cpu"),
                                 _tokens(cfg, case), memory, s1)
        out[case] = (logits, dict(tree_paths(cache_to_reference(caches,
                                                                cfg))),
                     params, None if memory is None else memory.numpy())
    return out


REFERENCE = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from repro.configs import get
    from repro.distributed import sharding as shd
    from repro.distributed.sharding import tree_paths
    from repro.launch.mesh import make_mesh
    from repro.models import build_model

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
    for case, (arch, s1, s, slots) in spec["cases"].items():
        model = build_model(get(arch).reduced())
        pre = case + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        toks = jnp.asarray(data["tokens::" + case], jnp.int32)
        mem = ("memory::" + case) in data.files
        memory = jnp.asarray(data["memory::" + case]) if mem else None
        for shape in spec["meshes"]:
            mesh = make_mesh(*shape)
            tag = case + "@" + ",".join(map(str, shape))
            with shd.use_mesh(mesh):
                params = nest(dict(flat))
                params = jax.device_put(params,
                                        shd.tree_shardings(mesh, params))
                cache = model.init_cache(toks.shape[0], slots)
                cache = jax.device_put(cache, shd.tree_shardings(mesh, cache))
                step = jax.jit(model.decode_step)
                logits = []
                for t in range(0, s, s1):
                    lg, cache = step(params, toks[:, t:t + s1], cache, memory)
                    logits.append(np.asarray(lg))
            out[tag + "::logits"] = np.concatenate(logits, 1)
            for p, v in tree_paths(cache):
                out[tag + "::cache::" + p] = np.asarray(v)
    np.savez(d + "/ref.npz", **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    d = tmp_path_factory.mktemp("ref_decode_mesh")
    arrays = {}
    for case, (_, _, params, memory) in unsharded.items():
        arrays.update((f"{case}::{p}", np.asarray(v))
                      for p, v in tree_paths(params))
        arrays[f"tokens::{case}"] = _tokens(get(CASES[case][0]).reduced(),
                                            case)
        if memory is not None:
            arrays[f"memory::{case}"] = memory
    np.savez(d / "inputs.npz", **arrays)
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": CASES, "meshes": MESHES}, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC, str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _logits(world, case):
    """Every row's logits, from the ranks that hold them."""
    out = np.zeros_like(world[0][case]["logits"], shape=(
        BATCH,) + world[0][case]["logits"].shape[1:])
    for r in world:
        lo, hi = r[case]["rows"]
        out[lo:hi] = r[case]["logits"]
    return out


_IDS = dict(ids=lambda s: "x".join(map(str, s)))


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_equals_the_references(worlds, reference, case,
                                              shape):
    """Every step's logits within 1e-5 of the reference's largest, and
    the caches after the last step, gathered, within 1e-5 of the
    reference's (lengths equal)."""
    tag = f"{case}@{','.join(map(str, shape))}"
    got = _logits(worlds[shape], case)
    assert np.isfinite(got).all()
    assert _rel(got, reference[f"{tag}::logits"]) < TOL
    caches = worlds[shape][0][case]["caches"]
    assert caches
    for path, v in caches.items():
        want = reference[f"{tag}::cache::{path}"]
        if path.endswith("length"):
            assert np.array_equal(v, want), path
        else:
            assert _rel(v, want) < TOL, path


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_equals_the_unsharded_port(worlds, unsharded, case,
                                                  shape):
    """The logits within 1e-5 of the unsharded decode's largest, with the
    same argmax, and the gathered caches within 1e-5."""
    want, want_c, _, _ = unsharded[case]
    got = _logits(worlds[shape], case)
    assert _rel(got, want) < TOL
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    caches = worlds[shape][0][case]["caches"]
    assert set(caches) == set(want_c)
    for path, w in want_c.items():
        assert _rel(caches[path], w) < TOL or not np.abs(w).max(), path


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_caches_carried_from_the_reference_tree(worlds, unsharded, case,
                                                shape):
    """A cache tree in the reference's layout (stacked leaves, a scalar
    length a layer) loaded into every rank's blocks and gathered back is
    the same tree; decoding on from the loaded blocks gives the unsharded
    decode's logits (1e-5)."""
    _, s1, s, _ = CASES[case]
    half = s // 2 // s1 * s1
    want, _, _, _ = unsharded[case]
    for r in worlds[shape]:
        tree, back, logits = r[case]["carried"]
        assert set(tree) == set(back)
        for path, v in tree.items():
            assert np.array_equal(back[path], v), path
        lo, hi = r[case]["rows"]
        assert _rel(logits, want[lo:hi, half:]) < TOL


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_cache_blocks(worlds, case, shape):
    """Each rank's cache leaves are its blocks: a KV cache its rows and
    ``1/model`` of the slots, a recurrent state its rows and heads where
    they divide ``model``; the lengths its rows."""
    arch, _, _, slots = CASES[case]
    cfg = get(arch).reduced()
    data, model = shape[1], shape[2]
    whole = build_model(cfg).init_cache(BATCH, slots, device="meta")
    for r in worlds[shape]:
        blocks = r[case]["blocks"]
        for j, layer in enumerate(whole):
            for key, st in layer.items():
                for f in st._fields:
                    shape_w = tuple(getattr(st, f).shape)
                    got = blocks[f"{j}/{key}/{f}"]
                    want = list(shape_w)
                    want[0] //= data
                    if f in ("k", "v"):
                        want[2] //= model
                    elif f != "length" and shape_w[1] % model == 0:
                        want[1] //= model
                    assert got == tuple(want), (j, key, f)


# -- the cache specs against the reference's ------------------------------------

SPECS = textwrap.dedent(r"""
    import functools, json, sys
    sys.path.insert(0, sys.argv[1])
    import jax
    from repro.configs import ARCHS, SHAPES, get
    from repro.distributed import sharding as shd
    from repro.distributed.sharding import tree_paths
    from repro.launch.mesh import make_production_mesh
    from repro.models import build_model
    out = {}
    shape = SHAPES["decode_32k"]
    for name, multi in (("pod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in sorted(ARCHS):
            cfg = get(arch)
            slots = (min(shape.seq_len, cfg.sliding_window)
                     if cfg.sliding_window else shape.seq_len)
            tree = jax.eval_shape(functools.partial(
                build_model(cfg).init_cache, shape.global_batch, slots))
            with shd.use_mesh(mesh):
                sh = shd.tree_shardings(mesh, tree)
            out[name + "/" + arch] = {
                p: [list(a) if isinstance(a, tuple) else a
                    for a in s.spec]
                for (p, _), (_, s) in zip(tree_paths(tree), tree_paths(sh))}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SPECS, SRC],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _plain(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_references(reference_specs, arch,
                                          mesh_name):
    """The spec of every leaf of the reference's stacked cache tree at the
    arch's decode_32k cell, computed by the port's copied rules
    (``sharding.leaf_spec``), is the reference's ``tree_shardings``'."""
    cfg = get(arch)
    shape = SHAPES["decode_32k"]
    slots = (min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window
             else shape.seq_len)
    mesh = counting_mesh((16, 16) if mesh_name == "pod" else (2, 16, 16))
    whole = build_model(cfg).init_cache(shape.global_batch, slots,
                                        device="meta")
    got = {}
    for layer, (prefix, n, _) in zip(whole, cache_paths(cfg)):
        for key, st in layer.items():
            for f in st._fields:
                path = "/".join(x for x in (prefix, key, f) if x)
                t = getattr(st, f)
                # the reference keeps one length a layer
                full = (n,) + (() if f == "length" else tuple(t.shape))
                got[path] = _plain(shd.leaf_spec(path, full, mesh))
    want = reference_specs[f"{mesh_name}/{arch}"]
    assert got == {p: s + [None] * (len(got[p]) - len(s))
                   for p, s in want.items()}


def test_the_slstm_normaliser_takes_its_siblings_layout():
    """The reference's ``n`` rule, written for the SSM's (B, H, DK)
    normaliser, lands one dimension early on the sLSTM's stacked (L, B, W)
    ``n``; the port's block of it is laid out as ``c`` and ``m``."""
    mesh = counting_mesh((2, 16, 16))
    shape = (12, 128, 1024)
    assert shd.leaf_spec("0/1/sl/n", shape, mesh) == shd.P("pod", "model",
                                                            None)
    assert shd.leaf_spec("0/1/sl/c", shape, mesh) == shd.P(
        None, ("pod", "data"), "model")
    assert shd.cache_block_spec("0/1/sl/n", shape, mesh) == \
        shd.cache_block_spec("0/1/sl/c", shape, mesh) == shd.P(
            ("pod", "data"), "model")
