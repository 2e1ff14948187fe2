"""What ``test_torch_profile_dp.py`` and ``test_torch_profile_seq.py``
share: gloo worlds of four ranks that train the reduced configs under one
of the reference's sharding profiles (``launch/specs.py::rules_for``), the
port's unsharded runs of the same cases, and the reference's
``make_train_step`` under ``use_mesh(make_mesh(...), rules=rules_for(arch,
profile))`` in a subprocess with four forced host devices.

A case is (arch, labels masked, FSDP): each trains two AdamW steps (eps
1e-3, as ``test_torch_sharding.py``: a gradient within 1e-8 of zero,
where summation orders differ, would move its parameter by up to the
learning rate) from one seed on one numpy batch, and records its losses,
its first step's gradients (``trainer.step_gradients``, gathered whole by
``Trainer.whole``) and its parameters after the two steps (gathered
whole).  A masked case's labels are -1 on the last quarter of the
sequence: those positions lie in the last ``model`` rank's rows under
``seq_sp``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.distributed import spawn
from repro_torch.launch.specs import rules_for
from repro_torch.models.convert import reference_leaves
from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                  Trainer)
from repro_torch.training.trainer import step_gradients

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = [(1, 2, 2), (1, 1, 4)]
ARCHS = ["starcoder2-3b", "qwen2-moe-a2.7b", "arctic-480b", "hymba-1.5b",
         "xlstm-350m", "llama-3.2-vision-11b", "whisper-tiny"]
BATCH, SEQ, STEPS, SEED = 4, 32, 2, 0
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
#: the tolerances: against the unsharded port (loss relative, parameters
#: of the larger of 1 and their largest entry, each leaf's first-step
#: gradient of its largest entry), and against the reference's step
PORT_LOSS, PORT_PARAM, PORT_GRAD = 1e-6, 1e-6, 1e-5
REF_LOSS, REF_PARAM = 1e-5, 1e-4


def case_id(case) -> str:
    arch, masked, fsdp = case
    return arch + "-masked" * masked + "-fsdp" * fsdp


def config(arch):
    # the dense arch trains with remat: the collectives run inside the units
    return dataclasses.replace(get(arch).reduced(),
                               remat=arch == "starcoder2-3b")


def batch(cfg, masked=False):
    """BATCH rows of SEQ tokens and next-token labels (-1 on the last
    quarter where ``masked``), and the stub inputs the arch takes."""
    rng = np.random.default_rng(SEED + 7)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    if masked:
        out["labels"][:, -SEQ // 4:] = -1
    if cfg.block_pattern == "encdec":
        out["frames"] = (rng.standard_normal(
            (BATCH, cfg.encoder.n_frames, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    if cfg.block_pattern == "vlm":
        out["images"] = (rng.standard_normal(
            (BATCH, cfg.vision.n_image_tokens, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    return out


def trainer(arch, mesh=None, fsdp=False):
    cfg = config(arch)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**OPT),
        data=DataConfig(cfg.vocab_size, SEQ, BATCH, seed=SEED),
        n_steps=STEPS), mesh=mesh, seed=SEED, device="cpu", fsdp=fsdp)


def whole_params(tr):
    # copies: a CPU tensor's numpy view follows the in-place updates
    return {p: np.array(v) for p, v in tr._whole_leaves()[0].items()}


def run(tr, masked=False):
    """(losses of STEPS steps, first-step gradients, parameters after),
    whole; every rank of a mesh takes part."""
    b = batch(tr.cfg.model, masked)

    def rows():
        return {k: torch.from_numpy(v) for k, v in tr.rows(b).items()}

    grads = tr.whole(step_gradients(tr.model, tr.net, rows(), tr.layout)[1])
    losses = []
    for _ in range(STEPS):
        m = tr.train_step(rows())
        losses.append({k: float(v) for k, v in m.items()})
    return losses, grads, whole_params(tr)


def fsdp_shares(tr):
    """{leaf path: (elements this rank holds, the whole leaf's)} of every
    leaf the layout cuts over the zero axes (FSDP)."""
    lay, params = tr.layout, dict(tr.net.named_parameters())
    return {path: (sum(params[n].numel() for n in leaf.names),
                   int(np.prod(lay.shapes[path])))
            for path, leaf in reference_leaves(tr.net).items()
            if lay.fsdp(path)}


def _world_rank(rank, world, device, shape, profile, cases):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = {}
    for arch, masked, fsdp in cases:
        mesh = make_mesh(*shape).with_rules(rules_for(arch, profile))
        tr = trainer(arch, mesh, fsdp)
        out[case_id((arch, masked, fsdp))] = {
            "run": run(tr, masked), "shares": fsdp_shares(tr),
            "batch_axes": tr.mesh.batch_axes,
            "tp": sorted(n for n, m in tr.net.named_modules()
                         if getattr(m, "tp", None))}
    return out if rank == 0 else None


def worlds(root, profile, cases_of_mesh):
    """{mesh shape: rank 0's {case id: results}} of a world a mesh."""
    return {shape: spawn(_world_rank, 4, init_dir=os.path.join(
        root, profile + "".join(map(str, shape))), timeout_s=600,
        args=(shape, profile, cases))[0]
        for shape, cases in cases_of_mesh.items()}


def unsharded(cases):
    """{case id: (losses, first-step gradients, parameters after, initial
    parameters)} of the port's unsharded trainer."""
    out = {}
    for arch, masked, _ in cases:
        key = case_id((arch, masked, False))
        if key not in out:
            tr = trainer(arch)
            init = whole_params(tr)
            out[key] = (*run(tr, masked), init)
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

    out = {}
    for key, arch, shape in spec["runs"]:
        cfg = dataclasses.replace(get(arch).reduced(),
                                  remat=arch == "starcoder2-3b")
        model = build_model(cfg)
        pre = key + "::"
        flat = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(pre)}
        b = {k[len("batch::" + pre):]: jnp.asarray(data[k])
             for k in data.files if k.startswith("batch::" + pre)}
        mesh = make_mesh(*shape)
        tag = key + "@" + ",".join(map(str, shape))
        with shd.use_mesh(mesh, rules=rules_for(arch, spec["profile"])):
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


def reference(d, profile, cases_of_mesh, plain):
    """The reference's runs of every (case, mesh) but the FSDP ones, from
    the unsharded port's initial parameters (``plain``) on the same
    batch: {f"{case id}@{mesh}::loss{i}" or "::{leaf path}": array}."""
    arrays, runs = {}, []
    for shape, cases in cases_of_mesh.items():
        for arch, masked, fsdp in cases:
            if fsdp:
                continue
            key = case_id((arch, masked, False))
            if f"{key}::embed/w" not in arrays:
                arrays.update((f"{key}::{p}", v)
                              for p, v in plain[key][3].items())
                arrays.update((f"batch::{key}::{k}", v) for k, v in
                              batch(config(arch), masked).items())
            runs.append((key, arch, list(shape)))
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump({"runs": runs, "profile": profile, "steps": STEPS,
                   "opt": OPT}, f)
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, SRC, d],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(os.path.join(d, "ref.npz")) as z:
        return {k: z[k] for k in z.files}


def rel(a, b, floor=1e-30):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def check_against_unsharded(got, want):
    """A world's run of a case against the unsharded port's: the metrics
    at each step, the parameters after, each leaf's first-step
    gradient."""
    losses, grads, params = got
    want_l, want_g, want_p, _ = want
    for g, w in zip(losses, want_l):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= PORT_LOSS * abs(w[k]) + 1e-7, k
    assert set(params) == set(want_p) == set(grads) == set(want_g)
    for path, w in want_p.items():
        assert rel(params[path], w, 1.0) <= PORT_PARAM, path
    for path, w in want_g.items():
        assert rel(grads[path], w) <= PORT_GRAD, path


def check_against_reference(got, ref, tag):
    losses, _, params = got
    for i, g in enumerate(losses):
        want = float(ref[f"{tag}::loss{i}"])
        assert abs(g["loss"] - want) <= REF_LOSS * abs(want), i
    for path, p in params.items():
        assert rel(p, ref[f"{tag}::{path}"]) <= REF_PARAM, path
