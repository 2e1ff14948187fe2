"""Head-parallel training blocks on the CPU: the cross-attention, the
mLSTM and the sLSTM run tensor-parallel where the reference's rules cut
their projections on whole heads (the sLSTM: on its features, one
recurrence a feature), and keep the gather path where they do not.

Gloo worlds of four ranks on (1, 2, 2) and (1, 1, 4) train, under the
baseline rules, the reduced llama-3.2-vision-11b (its cross layer with
whole query and KV heads), the same with two KV heads on (1, 1, 4) (the
query heads whole, the KV leaves gathered: the full-width ``model = 16``
case), whisper-tiny (its encoder's and decoder's self-attention and the
cross-attention all tensor-parallel) and xlstm-350m with two heads on
(1, 1, 4) (the mLSTM's projections cut within a head, so gathered; the
sLSTM on a quarter of its features: the full-width ``model = 16``
layout).  A case's config fields are replaced alike on the port's side
and on the reference's.  Each case trains two AdamW steps (eps 1e-3, as
``torch_profiles``) from one seed on one numpy batch, and is held to the
port's unsharded trainer (loss and parameters 1e-6, each leaf's
first-step gradient 1e-5 of its largest entry: a gate leaf that every
rank holds whole, used on the rank's columns, must come back whole) and
to the reference's ``make_train_step`` under ``use_mesh(make_mesh(...))``
on the converted parameters (loss 1e-5, parameters 1e-4), in a
subprocess with four forced host devices.  Each rank's blocks are their
specs' blocks, the tensor-parallel modules and the leaves' modes are the
layout's, and no all-gather over ``model`` takes a ``"tp"`` leaf.
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

import torch_profiles as tp
from repro_torch.distributed import process_group as pg
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spawn
from repro_torch.models.convert import reference_leaves
from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                  Trainer)
from repro_torch.training.trainer import step_gradients

#: case -> (arch, config fields replaced, meshes)
CASES = {
    "vlm": ("llama-3.2-vision-11b", {}, tp.MESHES),
    "vlm-kv2": ("llama-3.2-vision-11b", {"n_kv_heads": 2}, [(1, 1, 4)]),
    "whisper": ("whisper-tiny", {}, tp.MESHES),
    "xlstm-h2": ("xlstm-350m", {"n_heads": 2, "n_kv_heads": 2},
                 [(1, 1, 4)]),
}
RUNS = [(case, shape) for case, (_, _, meshes) in CASES.items()
        for shape in meshes]
#: the modules each case runs tensor-parallel (on every mesh it runs on),
#: with ``kv_tp`` for the attention blocks
TP_MODULES = {
    "vlm": {"layers.0.attn": True, "layers.0.mlp": None,
            "layers.1.cross": True, "layers.1.mlp": None},
    "vlm-kv2": {"layers.0.attn": False, "layers.0.mlp": None,
                "layers.1.cross": False, "layers.1.mlp": None},
    "whisper": {f"{side}_layers.{i}.{m}": (True if m != "mlp" else None)
                for i in range(2)
                for side, ms in (("enc", ("attn", "mlp")),
                                 ("dec", ("attn", "cross", "mlp")))
                for m in ms},
    "xlstm-h2": {"layers.1.slstm": None},
}


def config(case):
    arch, changes, _ = CASES[case]
    return dataclasses.replace(tp.config(arch), **changes)


def trainer(case, mesh=None):
    cfg = config(case)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**tp.OPT),
        data=DataConfig(cfg.vocab_size, tp.SEQ, tp.BATCH, seed=tp.SEED),
        n_steps=tp.STEPS), mesh=mesh, seed=tp.SEED, device="cpu")


class _ModelGathers:
    """The parameters of ``net`` (updated in place) that an all-gather
    over the ``model`` axis of ``mesh`` takes while installed."""

    def __init__(self, mesh, net):
        self.group, self.names = mesh.group("model"), set()
        self.by_ptr = {p.data_ptr(): n for n, p in net.named_parameters()}

    def __enter__(self):
        self._orig = pg.all_gather

        def recorded(x, group=None, *, dim=0):
            if group is self.group and x.data_ptr() in self.by_ptr:
                self.names.add(self.by_ptr[x.data_ptr()])
            return self._orig(x, group, dim=dim)

        pg.all_gather = recorded
        return self

    def __exit__(self, *exc):
        pg.all_gather = self._orig
        return False


def _world_rank(rank, world, device, shape, cases):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        mesh = make_mesh(*shape)
        tr = trainer(case, mesh)
        params = dict(tr.net.named_parameters())
        blocks_ok = []
        for path, leaf in reference_leaves(tr.net).items():
            want = shd.block_shape(tr.layout.shapes[path],
                                   tr.layout.specs[path], mesh)
            got = tuple(params[leaf.names[0]].shape)
            blocks_ok.append(got == (want[1:] if leaf.stacked else want))
        modes = {n: p.placement.mode for n, p in params.items()
                 if getattr(p, "placement", None) is not None}
        # tp.run's steps, the gathers of the results (the gradients and
        # the parameters whole) left out of the record
        batch, gathers = tp.batch(tr.cfg.model), _ModelGathers(mesh, tr.net)

        def rows():
            return {k: torch.from_numpy(v) for k, v in tr.rows(batch).items()}

        with gathers:
            grads = step_gradients(tr.model, tr.net, rows(), tr.layout)[1]
        grads, losses = tr.whole(grads), []
        with gathers:
            for _ in range(tp.STEPS):
                m = tr.train_step(rows())
                losses.append({k: float(v) for k, v in m.items()})
        whole = tp.whole_params(tr)         # every rank takes part
        out[case] = {
            "run": (losses, grads, whole) if rank == 0 else None,
            "blocks_ok": all(blocks_ok), "modes": modes,
            "gathered": sorted(gathers.names),
            "tp": {n: (getattr(m, "kv_tp", None) if hasattr(m, "kv_tp")
                       else None)
                   for n, m in tr.net.named_modules()
                   if getattr(m, "tp", None) is not None}}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("head_parallel")
    return {shape: spawn(_world_rank, 4, init_dir=str(root / "".join(
        map(str, shape))), timeout_s=600,
        args=(shape, [c for c, s in RUNS if s == shape]))
        for shape in tp.MESHES}


@pytest.fixture(scope="module")
def unsharded():
    """{case: (losses, first-step gradients, parameters after, initial
    parameters)} of the port's unsharded trainer."""
    out = {}
    for case in CASES:
        tr = trainer(case)
        init = tp.whole_params(tr)
        out[case] = (*tp.run(tr), init)
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
    for case, arch, changes, shape in spec["runs"]:
        cfg = dataclasses.replace(get(arch).reduced(), remat=False,
                                  **changes)
        model = build_model(cfg)
        pre = case + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        b = {k[len("batch::" + pre):]: jnp.asarray(data[k])
             for k in data.files if k.startswith("batch::" + pre)}
        tag = case + "@" + ",".join(map(str, shape))
        with shd.use_mesh(make_mesh(*shape)):
            opt = AdamWConfig(**spec["opt"])
            params = nest(dict(flat))
            state = init_adamw(opt, params)
            step = jax.jit(make_train_step(model, opt))
            for i in range(spec["steps"]):
                params, state, m = step(params, state, b)
                out[tag + "::loss" + str(i)] = np.asarray(m["loss"])
        for p, v in tree_paths(params):
            out[tag + "::" + p] = np.asarray(v)
    np.savez(d + "/ref.npz", **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory, unsharded):
    d = str(tmp_path_factory.mktemp("head_parallel_ref"))
    arrays, runs = {}, []
    for case, (arch, changes, meshes) in CASES.items():
        arrays.update((f"{case}::{p}", v)
                      for p, v in unsharded[case][3].items())
        arrays.update((f"batch::{case}::{k}", v)
                      for k, v in tp.batch(config(case)).items())
        runs.extend((case, arch, changes, list(s)) for s in meshes)
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({"runs": runs, "steps": tp.STEPS, "opt": tp.OPT}, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, tp.SRC, d],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(os.path.join(d, "ref.npz")) as z:
        return {k: z[k] for k in z.files}


def _ids(run):
    case, shape = run
    return f"{case}@{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_steps_equal_the_unsharded_port(worlds, unsharded, run):
    case, shape = run
    tp.check_against_unsharded(worlds[shape][0][case]["run"],
                               unsharded[case])


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_steps_equal_the_references_use_mesh(worlds, reference, run):
    case, shape = run
    tp.check_against_reference(worlds[shape][0][case]["run"], reference,
                               f"{case}@{','.join(map(str, shape))}")


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_the_blocks_run_on_whole_heads_where_they_divide(worlds, run):
    """The tensor-parallel modules (and whether their KV heads are the
    rank's) are the case's; every rank's parameters are its spec's
    blocks; a tensor-parallel module's cut leaves are ``"tp"`` (but for
    KV leaves cut within a head), every other leaf cut over ``model``
    ``"gather"``."""
    case, shape = run
    want = TP_MODULES[case]
    for r in worlds[shape]:
        got = r[case]
        assert got["tp"] == want
        assert got["blocks_ok"]
        for name, mode in got["modes"].items():
            module, leaf = (name.rsplit(".", 2) + [None])[:2]
            kv_gathered = leaf in ("wk", "wv") and want.get(module) is False
            assert mode == ("tp" if module in want and not kv_gathered
                            else "gather"), name


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_no_tp_leaf_is_gathered_over_model(worlds, run):
    """No all-gather over ``model`` takes a ``"tp"`` leaf; the leaves the
    layout gathers (the KV projections cut within a head, the mLSTM's
    projections cut within a head, the vocabulary) are gathered."""
    case, shape = run
    for r in worlds[shape]:
        got = r[case]
        tp_leaves = {n for n, m in got["modes"].items() if m == "tp"}
        assert tp_leaves and not tp_leaves & set(got["gathered"])
        assert set(got["gathered"]) <= {
            n for n, m in got["modes"].items() if m == "gather"}
        if case == "vlm-kv2":
            assert "layers.1.cross.wk.w" in got["gathered"]
        if case == "xlstm-h2":
            assert "layers.0.mlstm.wq.w" in got["gathered"]
