"""The port's decode path against the reference's, on the CPU.

The reference's parameters (``Model.init(PRNGKey(0))`` on reduced configs)
go into the port through ``models/convert.py``; the same numpy-seeded
tokens (and, for whisper and the VLM, the same stub frame or image
embeddings) then go through both packages' ``decode_step``, one token at a
time and, where the architecture takes them, in chunks.  fp32 throughout:
the port's decode sums in other orders than the reference's jitted step
(its einsums, softmax and matmuls), which stays near 1e-6 of the logits'
largest value, so the tolerance is 1e-5 relative.

The port's caches carry one length a row where the reference keeps one
cache a request with a scalar length and maps its step over the requests:
rows at different lengths are held to the reference step run on each row
alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get as ref_get
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import encdec as ref_ed
from repro.models import transformer as ref_tf
from repro_torch.configs import get
from repro_torch.launch.prefill import stub_inputs
from repro_torch.models import attention, build_model, encdec, transformer
from repro_torch.models.convert import load_reference_params
from repro_torch.serving.scheduler import row_of, stack_caches

TOL = 1e-5
ALL = sorted(ARCHS)
CHUNKED = [a for a in ALL if a not in ("hymba-1.5b", "xlstm-350m")]

_CACHE = {}


def _pair(arch, **changes):
    """(reference model, params, port model, net) for a reduced arch with
    ``changes`` to its config, built once per (arch, changes)."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _CACHE:
        ref_cfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
        if changes:
            ref_cfg = dataclasses.replace(ref_cfg, **changes)
            cfg = dataclasses.replace(cfg, **changes)
        ref_model, model = ref_build(ref_cfg), build_model(cfg)
        params = ref_model.init(jax.random.PRNGKey(0))
        net = model.init(1, device="cpu")
        load_reference_params(net, jax.tree.map(np.asarray, params))
        _CACHE[key] = (ref_model, params, model, net,
                       jax.jit(ref_model.decode_step))
    return _CACHE[key]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _memories(ref_model, params, model, net, b):
    """The cross-attention memory of both packages (None for the archs
    without one), from the same seeded stub inputs."""
    stubs = stub_inputs(model.cfg, b, device="cpu")
    if not stubs:
        return None, None
    ref_mem = ref_model.encode_memory(
        params, {k: v.numpy() for k, v in stubs.items()})
    with torch.inference_mode():
        mem = model.encode_memory(net, stubs)
    return ref_mem, mem


def _rel(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)


def _run_both(arch, toks, s1, max_len=32, **changes):
    """Both packages' decode logits over ``toks`` (B, S) in steps of
    ``s1`` tokens, concatenated along the sequence."""
    ref_model, params, model, net, ref_step = _pair(arch, **changes)
    b, s = toks.shape
    ref_mem, mem = _memories(ref_model, params, model, net, b)
    rc = ref_model.init_cache(b, max_len)
    pc = model.init_cache(b, max_len, device="cpu")
    ref_out, out = [], []
    with torch.inference_mode():
        for t in range(0, s, s1):
            rl, rc = ref_step(params, toks[:, t:t + s1], rc, ref_mem)
            pl, pc = model.decode_step(net, torch.from_numpy(
                toks[:, t:t + s1]), pc, mem)
            ref_out.append(np.asarray(rl))
            out.append(pl.numpy())
    return np.concatenate(out, 1), np.concatenate(ref_out, 1), pc


@pytest.mark.parametrize("arch", ALL)
def test_per_token_decode_matches_the_reference(arch):
    cfg = get(arch).reduced()
    got, want, caches = _run_both(arch, _tokens(cfg, 2, 12), 1)
    assert got.shape == (2, 12, cfg.vocab_size)
    assert _rel(got, want) < TOL, arch
    assert transformer.caches_length(caches).tolist() == [12, 12] \
        or cfg.block_pattern == "encdec"
    ref_model, _, model, _, _ = _pair(arch)
    assert model.supports_chunked_prefill == \
        ref_model.supports_chunked_prefill


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunked_decode_matches_the_reference(arch):
    """s1 = 4: the chunk is written contiguously and masked causally within
    itself, in both packages."""
    cfg = get(arch).reduced()
    assert build_model(cfg).supports_chunked_prefill
    got, want, _ = _run_both(arch, _tokens(cfg, 2, 12, seed=1), 4)
    assert _rel(got, want) < TOL, arch


def _teacher_forced(model, net, toks, mem):
    """The port's full-sequence logits over ``toks``."""
    cfg = model.cfg
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        if cfg.block_pattern == "encdec":
            hidden, _ = encdec.encdec_forward_train(
                net, cfg, stub_inputs(cfg, toks.shape[0])["frames"], t)
        else:
            hidden, _ = transformer.decoder_forward_train(net, cfg, t,
                                                          memory=mem)
        return transformer.lm_logits(net, cfg, hidden).numpy()


@pytest.mark.parametrize("arch", ALL)
def test_decode_matches_teacher_forcing(arch):
    """Feeding tokens one by one through the port's decode reproduces its
    own full-sequence logits, at the reference's bound for the same check
    (tests/test_models.py: 5e-2 of the largest logit).  The MoE's capacity
    factor is 8, so that routing drops nothing in either path."""
    cfg = get(arch).reduced()
    changes = {}
    if cfg.moe:
        changes["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    ref_model, params, model, net, _ = _pair(arch, **changes)
    toks = (np.arange(12).reshape(1, 12) * 7 % 101).astype(np.int32)
    _, mem = _memories(ref_model, params, model, net, 1)
    full = _teacher_forced(model, net, toks, mem)
    caches = model.init_cache(1, 32, device="cpu")
    outs = []
    with torch.inference_mode():
        for t in range(12):
            lg, caches = model.decode_step(
                net, torch.from_numpy(toks[:, t:t + 1]), caches, mem)
            outs.append(lg.numpy())
    assert _rel(np.concatenate(outs, 1), full) < 5e-2, arch


def test_hymba_decode_across_the_window():
    """hymba with its window shrunk to 8: the KV ring of 8 slots wraps
    after 8 tokens; over 20 tokens the port's decode equals the
    reference's, and its own full-sequence forward with the same window
    (the last 8 positions visible to each query)."""
    arch = "hymba-1.5b"
    cfg = dataclasses.replace(get(arch).reduced(), sliding_window=8)
    toks = _tokens(cfg, 2, 20, seed=2)
    got, want, caches = _run_both(arch, toks, 1, sliding_window=8)
    assert caches[0]["kv"].k.shape[2] == 8          # min(max_len, window)
    assert caches[0]["kv"].length.tolist() == [20, 20]
    assert _rel(got, want) < TOL
    _, _, model, net, _ = _pair(arch, sliding_window=8)
    full = _teacher_forced(model, net, toks, None)
    assert _rel(got, full) < TOL


@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-350m",
                                  "hymba-1.5b", "qwen2-moe-a2.7b"])
def test_rows_at_different_lengths_equal_each_row_alone(arch):
    """Two requests at different lengths, their caches stacked into one
    batch, take one decode step: each row's logits and caches equal that
    request's own step, and the reference's step on that request alone."""
    ref_model, params, model, net, ref_step = _pair(arch)
    cfg = model.cfg
    lens = (3, 7)
    prompts = [_tokens(cfg, 1, n, seed=10 + n) for n in lens]
    nxt = _tokens(cfg, 2, 1, seed=3)
    caches, ref_logits = [], []
    with torch.inference_mode():
        for prompt, tok in zip(prompts, nxt):
            pc = model.init_cache(1, 16, device="cpu")
            rc = ref_model.init_cache(1, 16)
            for t in range(prompt.shape[1]):
                _, pc = model.decode_step(
                    net, torch.from_numpy(prompt[:, t:t + 1]), pc)
                _, rc = ref_step(params, prompt[:, t:t + 1], rc, None)
            caches.append(pc)
            ref_logits.append(np.asarray(ref_step(params, tok[None], rc,
                                                  None)[0]))
        stacked = stack_caches(caches)
        assert transformer.caches_length(stacked).tolist() == list(lens)
        logits, new = model.decode_step(net, torch.from_numpy(nxt), stacked)
        for i, pc in enumerate(caches):
            alone, alone_c = model.decode_step(
                net, torch.from_numpy(nxt[i:i + 1]), pc)
            assert _rel(logits[i:i + 1].numpy(), alone.numpy()) < TOL
            assert _rel(logits[i:i + 1].numpy(), ref_logits[i]) < TOL
            for got_l, want_l in zip(row_of(new, i), alone_c):
                for key in want_l:
                    for g, w in zip(got_l[key], want_l[key]):
                        assert torch.allclose(g.float(), w.float(),
                                              rtol=0, atol=1e-5)


# -- the two clamps of the reference's dynamic slices -----------------------

def _attn_pair():
    """One attention layer of reduced starcoder2 in both packages."""
    ref_model, params, model, net, _ = _pair("starcoder2-3b")
    p = jax.tree.map(lambda a: a[0], params["groups"][0][0]["attn"])
    return ref_model.cfg, p, model.cfg, net.layers[0].attn


def test_chunk_past_the_ring_end_is_written_at_the_clamped_start():
    """A chunk of 4 at length 14 of a 16-slot cache: the reference's
    ``dynamic_update_slice`` clamps its start to 16 - 4 = 12 (and keeps the
    unclamped write index in the mask); the port writes and masks the
    same."""
    ref_cfg, p, cfg, layer = _attn_pair()
    rng = np.random.default_rng(4)
    b, kv, smax, hd = 2, cfg.n_kv_heads, 16, cfg.hd
    k0, v0 = (rng.standard_normal((b, kv, smax, hd)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((b, 4, cfg.d_model)).astype(np.float32)
    ref_out, ref_cache = ref_attn.attention_decode(
        p, ref_cfg, x, ref_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                                        jnp.asarray(14, jnp.int32)))
    cache = attention.KVCache(torch.tensor(k0), torch.tensor(v0),
                              torch.full((b,), 14, dtype=torch.long))
    with torch.inference_mode():
        out, new = attention.attention_decode(layer, cfg,
                                              torch.tensor(x), cache)
    assert _rel(out.numpy(), ref_out) < TOL
    assert _rel(new.k.numpy(), ref_cache.k) < TOL
    assert _rel(new.v.numpy(), ref_cache.v) < TOL
    assert new.length.tolist() == [18, 18] and int(ref_cache.length) == 18
    # slots 0..11 untouched, 12..15 rewritten
    assert np.array_equal(new.k[:, :, :12].numpy(), k0[:, :, :12])
    assert not np.array_equal(new.k[:, :, 12:].numpy(), k0[:, :, 12:])


def test_learned_positions_past_the_table_clamp_as_the_reference():
    """whisper with a position table of 16 rows: a chunk of 4 at length 14
    reads rows 12..15 (the reference's ``dynamic_slice`` clamps its start
    to 16 - 4), in both packages."""
    arch = "whisper-tiny"
    ref_model, params, model, net, ref_step = _pair(arch, max_position=16)
    cfg = model.cfg
    toks = _tokens(cfg, 1, 18, seed=5)
    ref_mem, mem = _memories(ref_model, params, model, net, 1)
    rc = ref_model.init_cache(1, 32)
    pc = model.init_cache(1, 32, device="cpu")
    with torch.inference_mode():
        for t in range(14):
            _, rc = ref_step(params, toks[:, t:t + 1], rc, ref_mem)
            _, pc = model.decode_step(net, torch.from_numpy(
                toks[:, t:t + 1]), pc, mem)
        rl, _ = ref_step(params, toks[:, 14:18], rc, ref_mem)
        pl, _ = model.decode_step(net, torch.from_numpy(toks[:, 14:18]), pc,
                                  mem)
        rows = transformer.position_rows(net.pos_table,
                                         torch.tensor([14]), 4)
    assert torch.equal(rows[0], net.pos_table[12:16])
    assert _rel(pl.numpy(), rl) < TOL


# -- the paged bridge ----------------------------------------------------------

@pytest.mark.parametrize("s,table", [(24, [4, 1, 3]), (11, [2, 0])])
def test_paged_bridge_round_trip_equals_the_reference(s, table):
    """Scatter a request's cache into non-contiguous pool blocks and gather
    it back: exact, the pool's untouched blocks stay zero, a short cache
    is zero-padded into its last block, and both pools and the gathered
    cache equal the reference's."""
    kvh, bs, hd = 2, 8, 4
    rng = np.random.default_rng(s)
    k = rng.standard_normal((1, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((1, kvh, s, hd)).astype(np.float32)
    ref_pools = ref_attn.scatter_block_kv(
        *ref_attn.paged_kv_pool(6, bs, kvh, hd),
        ref_attn.KVCache(jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(s, jnp.int32)), table)
    ref_back = ref_attn.gather_block_kv(*ref_pools, table, s)
    pool_k, pool_v = attention.paged_kv_pool(6, bs, kvh, hd)
    cache = attention.KVCache(torch.tensor(k), torch.tensor(v),
                              torch.tensor([s]))
    pools = attention.scatter_block_kv(pool_k, pool_v, cache, table)
    assert float(pool_k.abs().sum()) == 0.0          # the input pool kept
    back = attention.gather_block_kv(*pools, table, s)
    for got, want in zip(pools, ref_pools):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(back.k.numpy(), np.asarray(ref_back.k))
    assert np.array_equal(back.v.numpy(), np.asarray(ref_back.v))
    assert back.k.shape == (1, kvh, len(table) * bs, hd)
    assert np.array_equal(back.k[:, :, :s].numpy(), k)
    assert float(back.k[:, :, s:].abs().sum()) == 0.0
    assert back.length.tolist() == [s] == [int(ref_back.length)]
    unused = sorted(set(range(6)) - set(table))
    assert float(pools[0][unused].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="exceeds table capacity"):
        attention.scatter_block_kv(pool_k, pool_v, cache, table[:1])


def test_init_cache_without_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get("starcoder2-3b").reduced()).init_cache(1, 8)
