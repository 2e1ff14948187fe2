"""The MoE's expert-parallel layout (``models/moe.py`` on a mesh), against
the reference's ``use_mesh`` train step and the port's unsharded one, on
the CPU.

Three reduced configs, each trained for two AdamW steps from one seed on
one numpy batch in gloo worlds of four ranks on (1, 2, 2), (2, 2, 1) and
(1, 1, 4):

* the reduced qwen2-moe (8 experts): they divide ``model`` = 2 and 4, so
  the banks take ``"ep"`` (each rank runs its own experts);
* the same with 6 experts: they divide 2 (``"ep"``) but not 4, where the
  banks are cut on the experts' ``ff`` dimension (``"tp"``) and the
  dispatch and combine one-hots on the routing group's tokens (the
  reference's ``tok_constrain``);
* the reduced arctic (8 experts, top-2, a dense residual MLP): ``"ep"``.

Each is held to the reference's ``make_train_step`` under
``use_mesh(make_mesh(...))`` on the converted parameters (loss 1e-5,
parameters 1e-4 of their largest entry; AdamW's eps 1e-3, as
``tests/test_torch_sharding.py`` takes it), which runs in a subprocess
with four forced host devices, and to the port's unsharded ``Trainer``
(1e-6).  Every rank's bank leaves carry the mode their spec gives, and no
all-gather over ``model`` in the step has a bank's block as its operand.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.distributed import spawn
from repro_torch.distributed import sharding as shd
from repro_torch.models.convert import reference_leaves
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, Trainer

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = [(1, 2, 2), (2, 2, 1), (1, 1, 4)]
#: case -> (arch, changes to the reduced config's MoE)
CASES = {"qwen2-moe": ("qwen2-moe-a2.7b", {}),
         "six-experts": ("qwen2-moe-a2.7b", {"n_experts": 6}),
         "arctic": ("arctic-480b", {})}
BATCH, SEQ, STEPS, SEED = 4, 32, 2, 0
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
BANKS = ("w_up", "w_gate", "w_down")


def _cfg(case):
    arch, changes = CASES[case]
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **changes))


def _batch(cfg):
    rng = np.random.default_rng(SEED + 7)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _trainer(case, mesh=None):
    cfg = _cfg(case)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**OPT),
        data=DataConfig(cfg.vocab_size, SEQ, BATCH, seed=SEED),
        n_steps=STEPS), mesh=mesh, seed=SEED, device="cpu")


def _steps(tr):
    batch = _batch(tr.cfg.model)
    losses = []
    for _ in range(STEPS):
        m = tr.train_step({k: torch.from_numpy(v)
                           for k, v in tr.rows(batch).items()})
        losses.append(float(m["loss"]))
    return losses


def _whole(tr):
    return {p: np.array(v) for p, v in tr._whole_leaves()[0].items()}


class _ModelGathers:
    """Records the operand shape of every all-gather over ``model`` while
    installed (the collectives the sharding module calls)."""

    def __init__(self, mesh):
        self.group = mesh.group("model") if mesh.shape["model"] > 1 else None
        self.shapes = []

    def __enter__(self):
        from repro_torch.distributed import process_group as pg
        self._pg, self._orig = pg, pg.all_gather

        def recorded(x, group=None, *, dim=0):
            if group is not None and group is self.group:
                self.shapes.append(tuple(x.shape))
            return self._orig(x, group, dim=dim)

        pg.all_gather = recorded
        return self

    def __exit__(self, *exc):
        self._pg.all_gather = self._orig
        return False


def _world_rank(rank, world, device, mesh_shape):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape)
    out = {}
    for case in CASES:
        tr = _trainer(case, mesh)
        params = dict(tr.net.named_parameters())
        banks = {}
        for path, leaf in reference_leaves(tr.net).items():
            if path.split("/")[-1] not in BANKS:
                continue
            p = params[leaf.names[0]]
            where = getattr(p, "placement", None)
            banks[path] = (where.mode if where is not None else None,
                           where.dim if where is not None else None,
                           tuple(p.shape))
        with _ModelGathers(mesh) as seen:
            losses = _steps(tr)
        out[case] = {"losses": losses, "params": _whole(tr),
                     "banks": banks, "gathers": seen.shapes,
                     "specs": {p: tuple(tr.layout.specs[p]) for p in banks},
                     "shapes": {p: tr.layout.shapes[p] for p in banks},
                     "tp": tr.net.layers[0].moe.tp is not None,
                     "ep_works": tr.ep_works}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_ep")
    return {shape: spawn(_world_rank, 4, init_dir=str(root / "".join(
        map(str, shape))), timeout_s=600, args=(shape,))
        for shape in MESHES}


@pytest.fixture(scope="module")
def unsharded():
    """{case: (losses, whole params after, initial params)}."""
    out = {}
    for case in CASES:
        tr = _trainer(case)
        init = _whole(tr)
        out[case] = (_steps(tr), _whole(tr), init)
    return out


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
    for case, (arch, changes) in spec["cases"].items():
        cfg = get(arch).reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **changes))
        model = build_model(cfg)
        pre = case + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        batch = {k: jnp.asarray(data["batch::" + case + "::" + k])
                 for k in ("tokens", "labels")}
        for shape in spec["meshes"]:
            mesh = make_mesh(*shape)
            tag = case + "@" + ",".join(map(str, shape))
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
    np.savez(d + "/ref.npz", **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    d = tmp_path_factory.mktemp("ref_moe_ep")
    arrays = {}
    for case, (_, _, init) in unsharded.items():
        arrays.update((f"{case}::{p}", v) for p, v in init.items())
        arrays.update((f"batch::{case}::{k}", v)
                      for k, v in _batch(_cfg(case)).items())
    np.savez(d / "inputs.npz", **arrays)
    with open(d / "spec.json", "w") as f:
        json.dump({"cases": CASES, "meshes": MESHES, "steps": STEPS,
                   "opt": OPT}, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC, str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


_IDS = dict(ids=lambda s: "x".join(map(str, s)))


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_steps_equal_the_references_use_mesh(worlds, reference, case,
                                             shape):
    """Every rank's loss within 1e-5 of the reference's at each step, and
    every gathered parameter within 1e-4 of its largest entry."""
    tag = f"{case}@{','.join(map(str, shape))}"
    for r in worlds[shape]:
        got = r[case]
        for i, loss in enumerate(got["losses"]):
            want = float(reference[f"{tag}::loss{i}"])
            assert loss == pytest.approx(want, rel=1e-5), i
    for path, p in worlds[shape][0][case]["params"].items():
        want = reference[f"{tag}::{path}"]
        assert np.abs(p - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                    1e-30), path


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_steps_equal_the_unsharded_port(worlds, unsharded, case, shape):
    """The losses within 1e-6 relative and the gathered parameters within
    1e-6 of the larger of 1 and their largest entry."""
    want_l, want_p, _ = unsharded[case]
    got = worlds[shape][0][case]
    for loss, want in zip(got["losses"], want_l):
        assert loss == pytest.approx(want, rel=1e-6)
    assert set(got["params"]) == set(want_p)
    for path, w in want_p.items():
        err = np.abs(got["params"][path] - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), 1.0), path


def _mode_of(path, spec, model):
    """The mode the bank leaf's spec gives: ``"ep"`` where it cuts the
    experts (dim 1 of the stacked leaf), ``"tp"`` where it cuts their
    ``ff`` dimension, None where it cuts nothing over ``model`` (an axis
    of one rank cuts nothing)."""
    dims = shd.dims_over(spec, "model") if model > 1 else ()
    if not dims:
        return None, None
    leaf = path.split("/")[-1]
    ff = 2 if leaf == "w_down" else 3
    assert dims in ((1,), (ff,)), (path, spec)
    return ("ep" if dims == (1,) else "tp"), dims[0] - 1


@pytest.mark.parametrize("shape", MESHES, **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_bank_modes_are_what_the_spec_gives(worlds, case, shape):
    """Each bank leaf's ``Placement.mode`` and dimension are what its
    spec on the mesh gives, its block the spec's, and the experts' test
    (``ep_works``) picks ``"ep"``; no bank takes ``"gather"``."""
    model = shape[2]
    n_experts = _cfg(case).moe.n_experts
    for r in worlds[shape]:
        got = r[case]
        assert got["banks"]
        assert got["ep_works"] is (n_experts % model == 0)
        for path, (mode, dim, block) in got["banks"].items():
            spec = shd.P(*got["specs"][path])
            want_mode, want_dim = _mode_of(path, spec, model)
            assert (mode, dim) == (want_mode, want_dim), path
            whole = got["shapes"][path]
            mesh = shd.Mesh(dict(zip(("pod", "data", "model"), shape)))
            assert block == shd.block_shape(whole, spec, mesh)[1:], path
        modes = {m for m, _, _ in got["banks"].values()}
        if model == 1:
            assert modes == {None} and not got["tp"]
        elif n_experts % model == 0:
            assert modes == {"ep"}
        else:
            assert modes == {"tp"}


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)], **_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_no_bank_is_gathered_over_model(worlds, case, shape):
    """No all-gather over ``model`` in the two steps (forward, remat,
    backward, update) takes a bank's block; the token-cut branch (6
    experts on ``model`` = 4) gathers the combined rows instead."""
    for r in worlds[shape]:
        got = r[case]
        blocks = {b for _, _, b in got["banks"].values()}
        assert got["gathers"], "the vocabulary leaves are gathered"
        assert not blocks & set(got["gathers"]), blocks
        if case == "six-experts" and shape == (1, 1, 4):
            # one (G, s/4, D) gather of the outputs' rows a layer and step
            rows = [g for g in got["gathers"]
                    if g == (BATCH * SEQ // SEQ, SEQ // 4, 64)]
            assert len(rows) == 2 * _cfg(case).n_layers


def test_the_active_mesh_is_seen_by_other_threads():
    """The autograd engine runs a CUDA backward, and the recompute of a
    checkpointed unit in it, on a thread of its own: the mesh the forward
    ran under must be the active one there too (the MoE's batch means and
    its branch read it), or a remat unit's recompute takes the mean of its
    own rows only."""
    import threading
    mesh = shd.Mesh({"data": 2, "model": 2})
    seen = []
    with shd.use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(shd.active()))
        t.start()
        t.join()
        assert seen[0] is shd.active() and seen[0][0] is mesh
    assert shd.active() is None
