"""The port's loss and its gradients against the reference's, on the CPU.

The reference's parameters (``Model.init(PRNGKey(0))`` on reduced configs)
are carried into the port by ``models/convert.py``; one numpy batch (tokens,
labels, and whisper's frames or the VLM's images) goes through
``jax.value_and_grad(model.loss, has_aux=True)`` and through the port's
``Model.loss`` and ``torch.autograd.grad``.  The port's gradients are
mapped back to the reference's tree (``convert.to_reference``, each group's
layers stacked again) and compared leaf by leaf.

Tolerances, fp32: the loss within 1e-5 relative; each leaf's gradient
within 1e-4 of its largest entry.  Only summation orders differ: the
forward runs the kernels' plain versions (sequential scans, the full
softmax) where the reference runs its chunked twins; the backward of
the K5 site goes through the same twin as the reference's gradient, and
K6's through the plain version of its backward kernel (the reverse of the
reference's scan).  The three differentiable kernel sites are held on CPU tensors
to autograd straight through the kernels' plain versions (1e-5 of the
largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get as ref_get
from repro.distributed.sharding import tree_paths as ref_tree_paths
from repro.models import build_model as ref_build
from repro.models import ssm as ref_ssm
from repro_torch.configs import get
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.slstm.ref import slstm_scan_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.launch import prefill
from repro_torch.models import attention, build_model, ssm, transformer
from repro_torch.models import model as model_mod
from repro_torch.models.convert import (load_reference_params, to_reference,
                                        tree_paths)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 64


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch(cfg, *, b=B, s=S, seed=0):
    """One numpy batch: next-token labels of seeded tokens, and the stub
    inputs whisper and the VLM take."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    for name, shape in prefill.stub_shapes(cfg).items():
        batch[name] = (rng.standard_normal((b,) + shape)
                       * 0.1).astype(np.float32)
    return batch


def _pair(arch, **changes):
    """(reference config, its params, port config, the port's net loaded
    with those params)."""
    ref_cfg = dataclasses.replace(ref_get(arch).reduced(), **changes)
    cfg = dataclasses.replace(get(arch).reduced(), **changes)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    net = build_model(cfg).init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    return ref_cfg, params, cfg, net


def _ref_loss(ref_cfg, params, batch):
    (loss, metrics), grads = jax.value_and_grad(
        ref_build(ref_cfg).loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), metrics, {p: np.asarray(g)
                                  for p, g in ref_tree_paths(grads)}


def _port_loss(cfg, net, batch):
    """(loss, metrics, gradients as {reference path: array})."""
    names, params = zip(*net.named_parameters())
    loss, metrics = build_model(cfg).loss(
        net, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params)
    return (float(loss.detach()), metrics,
            dict(tree_paths(to_reference(dict(zip(names, grads)), net))))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_reference(arch):
    ref_cfg, params, cfg, net = _pair(arch)
    batch = _batch(cfg)
    want, want_m, want_g = _ref_loss(ref_cfg, params, batch)
    got, got_m, got_g = _port_loss(cfg, net, batch)
    assert abs(got - want) / abs(want) < LOSS_TOL
    assert abs(float(got_m["ce"]) - float(want_m["ce"])) < LOSS_TOL * want
    assert abs(float(got_m["aux"]) - float(want_m["aux"])) < LOSS_TOL * want
    if cfg.moe:
        assert float(got_m["aux"]) > 0
    assert set(got_g) == set(want_g)
    for path, g in want_g.items():
        assert got_g[path].shape == g.shape, path
        assert _rel(got_g[path], g) < GRAD_TOL, path


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_remat_equals_no_remat(arch):
    """Checkpointing each unit (each decoder layer for whisper) changes
    neither the loss nor any gradient."""
    _, _, cfg, net = _pair(arch)
    batch = _batch(cfg)
    loss, _, grads = _port_loss(cfg, net, batch)
    net_remat = build_model(dataclasses.replace(cfg, remat=True)).init(
        2, device="cpu")
    net_remat.load_state_dict(net.state_dict())
    loss_r, _, grads_r = _port_loss(dataclasses.replace(cfg, remat=True),
                                    net_remat, batch)
    assert loss_r == pytest.approx(loss, rel=1e-6)
    for path, g in grads.items():
        assert _rel(grads_r[path], g) < 1e-6, path


def test_remat_recomputes_the_kernel_sites(monkeypatch):
    """With remat the K5 and K6 sites run twice a step (the forward, and
    its recompute inside the backward), without it once."""
    calls = {"ssm": 0, "slstm": 0}
    orig_ssm, orig_slstm = ssm.SSMScan.forward, ssm.SLSTMScan.forward

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return staticmethod(wrapped)

    monkeypatch.setattr(ssm.SSMScan, "forward", count("ssm", orig_ssm))
    monkeypatch.setattr(ssm.SLSTMScan, "forward", count("slstm", orig_slstm))
    _, _, cfg, net = _pair("xlstm-350m")
    batch = _batch(cfg)
    for remat, want in ((False, 1), (True, 2)):
        calls.update(ssm=0, slstm=0)
        _port_loss(dataclasses.replace(cfg, remat=remat), net, batch)
        assert calls == {"ssm": want * cfg.n_layers // 2,
                         "slstm": want * cfg.n_layers // 2}, remat


def test_negative_labels_are_ignored():
    ref_cfg, params, cfg, net = _pair("qwen1.5-4b")
    batch = _batch(cfg)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :20] = -1
    batch["labels"][1, 50:] = -100
    want, _, want_g = _ref_loss(ref_cfg, params, batch)
    got, _, got_g = _port_loss(cfg, net, batch)
    assert abs(got - want) / want < LOSS_TOL
    for path, g in want_g.items():
        assert _rel(got_g[path], g) < GRAD_TOL, path
    # the mean over the valid tokens only
    with torch.no_grad():
        h, _ = transformer.decoder_forward_train(
            net, cfg, torch.from_numpy(batch["tokens"]))
        logits = transformer.lm_logits(net, cfg, h).float()
    labels = torch.from_numpy(batch["labels"]).long()
    valid = labels >= 0
    ce = torch.nn.functional.cross_entropy(logits[valid], labels[valid])
    assert got == pytest.approx(float(ce), rel=1e-5)
    # no valid label: the loss is 0, not nan (the count is at least 1)
    batch["labels"][:] = -1
    got, _, _ = _port_loss(cfg, net, batch)
    assert got == 0.0


@pytest.mark.parametrize("chunk,n_chunks", [(0, 1), (16, 4), (40, 32),
                                            (96, 1)])
def test_logits_chunk_halves_until_it_divides(chunk, n_chunks, monkeypatch):
    """``logits_chunk`` is capped at S and halved until it divides S, as in
    the reference (40 -> 20 -> 10 -> 5 -> 2 at S = 64); the loss and the
    gradients equal the reference's at the same setting."""
    ref_cfg, params, cfg, net = _pair("qwen1.5-4b", logits_chunk=chunk)
    batch = _batch(cfg)
    seen = []
    orig = model_mod._ce_chunk

    def counted(net_, cfg_, h, y, w):
        seen.append(h.shape[1])
        return orig(net_, cfg_, h, y, w)

    monkeypatch.setattr(model_mod, "_ce_chunk", counted)
    want, _, want_g = _ref_loss(ref_cfg, params, batch)
    got, _, got_g = _port_loss(cfg, net, batch)
    # each chunk runs once in the forward and once more in its recompute
    assert len(seen) == 2 * n_chunks and set(seen) == {S // n_chunks}
    assert abs(got - want) / want < LOSS_TOL
    for path, g in want_g.items():
        assert _rel(got_g[path], g) < GRAD_TOL, path


# -- the differentiable kernel sites on CPU tensors --------------------------

def _inputs(shapes, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=dtype,
                         requires_grad=True) for s in shapes]


def _against_plain(apply, plain, ins, seed):
    """The Function's forward equals the plain version's, and its gradients
    equal autograd straight through the plain version."""
    out = apply(*ins)
    want = plain(*ins)
    assert torch.allclose(out, want, rtol=0,
                          atol=1e-6 * float(want.abs().max()))
    w = torch.tensor(np.random.default_rng(seed).standard_normal(
        tuple(out.shape)), dtype=out.dtype)
    got_g = torch.autograd.grad((out * w).sum(), ins)
    want_g = torch.autograd.grad((want * w).sum(), ins)
    for g, h in zip(got_g, want_g):
        assert _rel(g.numpy(), h.numpy()) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_against_plain(causal):
    """K4's site at S = 2304 (above CHUNKED_ATTN_THRESHOLD), GQA 2/1,
    d = 8: the backward recomputes through ``_sdpa_chunked``."""
    s = attention.CHUNKED_ATTN_THRESHOLD + 256
    q, k, v = _inputs([(1, 2, s, 8), (1, 1, s, 8), (1, 1, s, 8)], 0)

    def plain(q, k, v):
        return flash_attention_ref(q[0], k[0].expand(2, s, 8),
                                   v[0].expand(2, s, 8),
                                   causal=causal)[None]

    _against_plain(lambda q, k, v: attention.FlashAttention.apply(
        q, k, v, causal), plain, [q, k, v], 1)


def test_attention_train_reaches_the_flash_function():
    """Above the threshold with no window, a graph goes through
    ``FlashAttention``; under inference mode the wrapper is called as it
    is and nothing is recorded."""
    cfg = dataclasses.replace(get("starcoder2-3b").reduced(), n_heads=2,
                              n_kv_heads=1, d_model=16, head_dim=8)
    net = build_model(cfg).init(0, device="cpu")
    p = net.layers[0].attn
    s = attention.CHUNKED_ATTN_THRESHOLD + 128
    x = torch.randn(1, s, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(s)[None]
    out = attention.attention_train(p, cfg, x, pos)
    seen, stack = {}, [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and id(fn) not in seen:
            seen[id(fn)] = fn.name()
            stack.extend(f for f, _ in fn.next_functions)
    assert "FlashAttentionBackward" in seen.values()
    with torch.inference_mode():
        assert attention.attention_train(p, cfg, x, pos).grad_fn is None


@pytest.mark.parametrize("dk,dv", [(16, 32), (8, 17)])
def test_ssm_scan_function_against_plain(dk, dv):
    """K5's site (hymba's DK 16; an mLSTM-like DV = DK + 1 + 8): the
    backward recomputes through ``decayed_linear_attention``."""
    b, h, s = 2, 3, 160
    q, k, v = _inputs([(b, h, s, dk), (b, h, s, dk), (b, h, s, dv)], 2)
    la = torch.tensor(-np.random.default_rng(3).uniform(0.01, 0.5,
                                                         (b, h, s)),
                      dtype=torch.float32, requires_grad=True)

    def plain(q, k, v, la):
        return ssm_scan_ref(q.reshape(b * h, s, dk), k.reshape(b * h, s, dk),
                            v.reshape(b * h, s, dv),
                            la.reshape(b * h, s)).reshape(b, h, s, dv)

    _against_plain(lambda *a: ssm.SSMScan.apply(*a, 32), plain,
                   [q, k, v, la], 4)


def test_slstm_scan_function_against_plain():
    """K6's site: the forward keeps the per-step states and the backward
    is K6's backward kernel, here its plain version
    (``slstm_scan_bwd_ref``, the reverse loop), against autograd through
    the step loop of ``slstm_scan_ref``."""
    ins = _inputs([(2, 40, 24)] * 4, 5)
    _against_plain(ssm.SLSTMScan.apply, slstm_scan_ref, ins, 6)


@pytest.mark.parametrize("dk,dv,chunk", [(256, 257, 32), (16, 64, 32),
                                         (16, 24, 48)])
def test_decayed_linear_attention_matches_reference(dk, dv, chunk):
    """The port's chunked twin against the reference's: xlstm's mLSTM state
    (DK 256, DV 257) and hymba's DK 16, a chunk that halves (48 -> 24 at
    S = 96): outputs, final state and the gradients of a weighted sum."""
    b, h, s = 1, 2, 96
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((b, h, s, dk)).astype(np.float32) * 0.2
            for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    la = -rng.uniform(0.01, 0.3, (b, h, s)).astype(np.float32)
    w = rng.standard_normal((b, h, s, dv)).astype(np.float32)

    def ref_f(q, k, v, la):
        y, st = ref_ssm.decayed_linear_attention(q, k, v, la, chunk=chunk)
        return jnp.sum(y * w), (y, st)

    (_, (y_ref, st_ref)), g_ref = jax.value_and_grad(
        ref_f, argnums=(0, 1, 2, 3), has_aux=True)(q, k, v, la)
    ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v, la)]
    y, st = ssm.decayed_linear_attention(*ins, chunk=chunk)
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ins)
    assert _rel(y.detach().numpy(), y_ref) < 1e-5
    assert _rel(st.detach().numpy(), st_ref) < 1e-5
    for got, want in zip(g, g_ref):
        assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-350m",
                                  "whisper-tiny"])
def test_inference_mode_builds_no_graph(arch):
    """The prefill step and the forward under ``inference_mode`` record
    nothing, although the parameters are trainable."""
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(0, device="cpu")
    assert all(p.requires_grad for p in net.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    stubs = {k: batch[k] for k in prefill.stub_shapes(cfg)}
    logits = prefill.make_prefill_step(model)(net, batch["tokens"], **stubs)
    assert logits.grad_fn is None and not logits.requires_grad
    with torch.inference_mode():
        loss, _ = model.loss(net, batch)
    assert loss.grad_fn is None and torch.is_inference(loss)
