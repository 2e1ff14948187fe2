"""The port's LM prefill path against the reference's, on the CPU.

The reference's parameters (``Model.init(PRNGKey(0))`` on reduced configs)
are carried into the port by ``models/convert.py``; the same numpy-seeded
tokens (and, for whisper and the VLM, the same stub frame or image
embeddings) then go through both forward paths.  S = 64 takes ``_sdpa`` and
the scans' plain versions; S = 2304 (above CHUNKED_ATTN_THRESHOLD) takes
the K4 wrapper (starcoder2, the MoE and VLM self layers, whisper's
decoder), the plain chunked loop (hymba's window), the K5 wrapper (hymba's
SSD, xlstm's mLSTM) and the K6 wrapper (xlstm's sLSTM), whose CPU paths
are the plain versions.  Cross-attention takes ``_sdpa`` at every length.
Tolerance 1e-4 relative in fp32: the reference's chunked sums and the
port's full softmax and sequential scans sum in other orders, and that
stays well inside it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import encdec as ref_ed
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch.configs import get
from repro_torch.launch import prefill
from repro_torch.models import (attention, build_model, encdec, moe, ssm,
                                transformer)
from repro_torch.models.convert import flatten_reference, load_reference_params

ARCHS = ["starcoder2-3b", "starcoder2-3b-gqa4", "hymba-1.5b", "xlstm-350m",
         "qwen2-moe-a2.7b", "arctic-480b", "llama-3.2-vision-11b",
         "whisper-tiny"]


@pytest.fixture(autouse=True)
def _forward_only():
    """These are checks of the forward path, as the prefill runs it: no
    graph is built, so the outputs carry no gradient.  (The parameters are
    trainable; the loss and its gradients: tests/test_torch_loss.py.)"""
    with torch.no_grad():
        yield


def _cfgs(arch, s=64):
    """(reference config, port config) for a reduced arch.  reduced()
    gives starcoder2 GQA 4/2 already; '-gqa4' widens the group to 4.
    reduced() caps learned position tables at 512 rows, so for whisper at
    S above that both configs get ``max_position = S``."""
    name = arch.removesuffix("-gqa4")
    ref_cfg, cfg = ref_get(name).reduced(), get(name).reduced()
    kw = {}
    if arch.endswith("-gqa4"):
        kw = dict(n_heads=8, n_kv_heads=2, head_dim=8)
    if cfg.positions == "learned" and s > cfg.max_position:
        kw["max_position"] = s
    if kw:
        ref_cfg = dataclasses.replace(ref_cfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    return ref_cfg, cfg


_CACHE = {}


def _pair(arch, s=64):
    """Reference params (numpy leaves) and the port's net loaded with
    them, built once per arch (and position table length)."""
    ref_cfg, cfg = _cfgs(arch, s)
    key = (arch, cfg.max_position)
    if key not in _CACHE:
        params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
        params_np = jax.tree.map(np.asarray, params)
        net = build_model(cfg).init(1, device="cpu")
        load_reference_params(net, params_np)
        _CACHE[key] = (ref_cfg, cfg, params, params_np, net)
    return _CACHE[key]


def _rel(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _layer(params, cfg, i):
    """The reference's parameters of decoder layer ``i`` (its row of the
    stacked group), and its kind."""
    (_, _, kinds), = ref_tf.stack_plan(cfg)
    unit = params["groups"][0][i % len(kinds)]
    return jax.tree.map(lambda a: a[i // len(kinds)], unit), \
        kinds[i % len(kinds)]


def _ref_forward(params, ref_cfg, tokens, stubs):
    """The reference's (hidden, aux) on numpy tokens and stub inputs."""
    if ref_cfg.block_pattern == "encdec":
        return ref_ed.encdec_forward_train(params, ref_cfg,
                                           stubs["frames"].numpy(), tokens)
    memory = stubs["images"].numpy() if "images" in stubs else None
    return ref_tf.decoder_forward_train(params, ref_cfg, tokens,
                                        memory=memory)


def _port_forward(net, cfg, tokens, stubs):
    tokens = torch.from_numpy(tokens)
    if cfg.block_pattern == "encdec":
        return encdec.encdec_forward_train(net, cfg, stubs["frames"], tokens)
    memory = build_model(cfg).encode_memory(net, stubs)
    return transformer.decoder_forward_train(net, cfg, tokens, memory=memory)


# -- convert ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    ref_cfg, cfg, _, params_np, net = _pair(arch)
    flat = flatten_reference(params_np, cfg)
    own = dict(net.named_parameters())
    assert set(flat) == set(own)
    for name, p in own.items():
        assert np.array_equal(p.detach().numpy(), np.asarray(flat[name])), name
    # a layer leaf is row i of the reference's stacked layers
    if cfg.block_pattern == "encdec":
        assert len(net.enc_layers) == cfg.encoder.n_layers
        assert len(net.dec_layers) == cfg.n_layers
        for stack in ("enc_layers", "dec_layers"):
            stacked = params_np[stack]["attn"]["wq"]["w"]
            assert np.array_equal(own[f"{stack}.1.attn.wq.w"].detach().numpy(),
                                  stacked[1])
        return
    assert len(net.layers) == cfg.n_layers
    layer, kind = _layer(params_np, cfg, 1)
    assert kind == net.kinds[1]
    mixer = kind if kind in ("mlstm", "slstm", "cross") else "attn"
    assert np.array_equal(own[f"layers.1.{mixer}.wo.w"].detach().numpy(),
                          layer[mixer]["wo"]["w"])


def test_convert_refuses_missing_extra_and_misshaped_keys():
    ref_cfg, cfg, _, params_np, net = _pair("starcoder2-3b")
    missing = {k: v for k, v in params_np.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        load_reference_params(net, missing)
    extra = dict(params_np, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_reference_params(net, extra)
    bad = dict(params_np, final_norm={"scale": np.ones(cfg.d_model + 1,
                                                       np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_reference_params(net, bad)


def test_convert_refuses_missing_and_extra_names_for_encdec():
    """The encoder-decoder's tree: a leaf missing from a stacked layer, a
    stray top-level leaf and a missing stack are refused."""
    ref_cfg, cfg, _, params_np, net = _pair("whisper-tiny")
    dec = {k: v for k, v in params_np["dec_layers"].items() if k != "norm_x"}
    with pytest.raises(KeyError, match="norm_x"):
        load_reference_params(net, dict(params_np, dec_layers=dec))
    extra = dict(params_np, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_reference_params(net, extra)
    with pytest.raises(KeyError, match="enc_layers"):
        load_reference_params(net, {k: v for k, v in params_np.items()
                                    if k != "enc_layers"})
    short = jax.tree.map(lambda a: a[:1], params_np["enc_layers"])
    with pytest.raises(ValueError, match="leading axis"):
        load_reference_params(net, dict(params_np, enc_layers=short))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "hymba-1.5b"])
def test_convert_refuses_a_different_type(arch):
    """A bf16 reference tree loads into a bf16 port model exactly and is
    refused by an fp32 one: the configs' types differ."""
    ref_cfg, cfg = _cfgs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    params_np = jax.tree.map(np.asarray,
                             ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    net = build_model(dataclasses.replace(cfg, dtype="bfloat16")).init(
        1, device="cpu")
    load_reference_params(net, params_np)
    assert net.embed.w.dtype == torch.bfloat16
    assert np.array_equal(net.embed.w.detach().float().numpy(),
                          params_np["embed"]["w"].astype(np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        load_reference_params(build_model(cfg).init(1, device="cpu"),
                              params_np)


# -- the modules that hold a kernel -------------------------------------------

@pytest.mark.parametrize("s,window", [(64, 0), (64, 16), (2304, 0),
                                      (2304, 16)])
def test_attention_train_matches_reference(s, window):
    ref_cfg, cfg, params, _, net = _pair("starcoder2-3b")
    rng = np.random.default_rng(s + window)
    x = rng.standard_normal((1, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (1, s))
    layer = jax.tree.map(lambda a: a[0], params["groups"][0][0])
    want = ref_attn.attention_train(layer["attn"], ref_cfg, x, pos,
                                    causal=True, window=window)
    got = attention.attention_train(net.layers[0].attn, cfg,
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()),
                                    causal=True, window=window)
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("s", [64, 300])
def test_ssd_train_matches_reference(s):
    ref_cfg, cfg, params, _, net = _pair("hymba-1.5b")
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[1], params["groups"][0][0])
    want = ref_ssm.ssd_train(layer["ssd"], ref_cfg, x,
                             chunk=ref_cfg.ssm.chunk)
    got = ssm.ssd_train(net.layers[1].ssd, cfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("s", [64, 300])
def test_mlstm_train_matches_reference(s):
    ref_cfg, cfg, params, _, net = _pair("xlstm-350m")
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    layer, kind = _layer(params, ref_cfg, 0)
    assert kind == "mlstm"
    want = ref_ssm.mlstm_train(layer["mlstm"], ref_cfg, x,
                               chunk=ref_cfg.ssm.chunk)
    got = ssm.mlstm_train(net.layers[0].mlstm, cfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("s", [64, 300])
def test_slstm_train_matches_reference(s):
    ref_cfg, cfg, params, _, net = _pair("xlstm-350m")
    x = np.random.default_rng(s + 1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    layer, kind = _layer(params, ref_cfg, 1)
    assert kind == "slstm"
    want = ref_ssm.slstm_train(layer["slstm"], ref_cfg, x)
    got = ssm.slstm_train(net.layers[1].slstm, cfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-4


def _ref_keep(p, cfg, x):
    """The reference's kept-token mask and top-k experts: the routing lines
    of ``repro.models.moe.moe_block`` (which returns neither)."""
    m = cfg.moe
    bsz, seq, d = x.shape
    gs = min(ref_moe.GROUP_SIZE, seq)
    while seq % gs != 0:
        gs //= 2
    x = x.reshape(bsz * (seq // gs), gs, d)
    b, s, _ = x.shape
    capacity = max(1, int(s * m.top_k * m.capacity_factor / m.n_experts))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]["w"]),
                           axis=-1)
    _, gate_idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(gate_idx, m.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(b, s * m.top_k, m.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.einsum("bske,bske->bsk", pos, onehot)
    return np.asarray(pos < capacity), np.asarray(gate_idx)


@pytest.mark.parametrize("s,capacity_factor", [(64, 1.25), (300, 1.25),
                                               (2304, 1.25), (64, 0.5)])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_block_matches_reference(arch, s, capacity_factor):
    """Output, load-balance loss and routing (the top-k experts and the
    kept mask) of qwen2-moe's shared experts and arctic's dense residual;
    tokens past an expert's capacity are dropped, the same ones, and at a
    capacity factor of 0.5 certainly some."""
    ref_cfg, cfg, params, _, net = _pair(arch)
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    layer, _ = _layer(params, ref_cfg, 0)
    want, want_aux = ref_moe.moe_block(layer["moe"], ref_cfg, x)
    got, got_aux = moe.moe_block(net.layers[0].moe, cfg, torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-4
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)
    keep, gate_idx = _ref_keep(layer["moe"], ref_cfg, x)
    gs = moe.group_size(s)
    r = moe.route(net.layers[0].moe, cfg,
                  torch.from_numpy(x).reshape(-1, gs, cfg.d_model))
    assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    assert np.array_equal(r.keep.numpy(), keep)
    if capacity_factor < 1:
        assert not keep.all()


def test_moe_groups_and_capacity_as_the_reference():
    cfg = get("qwen2-moe-a2.7b")
    assert moe.GROUP_SIZE == ref_moe.GROUP_SIZE
    assert [moe.group_size(s) for s in (64, 2048, 2304, 4096)] == [
        64, 2048, 256, 2048]
    assert moe.capacity(cfg, 2048) == int(2048 * 4 * 1.25 / 60) == 170


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_attention_matches_reference(arch):
    ref_cfg, cfg, params, _, net = _pair(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    if cfg.block_pattern == "encdec":
        p = jax.tree.map(lambda a: a[0], params["dec_layers"])["cross"]
        mod = net.dec_layers[0].cross
    else:
        layer, kind = _layer(params, ref_cfg, 1)
        assert kind == "cross"
        p, mod = layer["cross"], net.layers[1].cross
    want = ref_attn.cross_attention(p, ref_cfg, x, mem)
    got = attention.cross_attention(mod, cfg, torch.from_numpy(x),
                                    torch.from_numpy(mem))
    assert _rel(got.numpy(), want) < 1e-4


def test_encode_matches_reference():
    ref_cfg, cfg, params, _, net = _pair("whisper-tiny")
    frames = prefill.stub_inputs(cfg, 2, seed=3)["frames"]
    want = ref_ed.encode(params, ref_cfg, frames.numpy())
    got = encdec.encode(net, cfg, frames)
    assert got.shape == (2, cfg.encoder.n_frames, cfg.d_model)
    assert _rel(got.numpy(), want) < 1e-4
    assert _rel(build_model(cfg).encode_memory(net, {"frames": frames}),
                want) < 1e-4


@pytest.mark.parametrize("s", [64, 2304])
def test_encdec_forward_train_matches_reference(s):
    ref_cfg, cfg, params, _, net = _pair("whisper-tiny", s)
    tokens = _tokens(cfg, 1, s, seed=5)
    frames = prefill.stub_inputs(cfg, 1, seed=5)["frames"]
    want, want_aux = ref_ed.encdec_forward_train(params, ref_cfg,
                                                 frames.numpy(), tokens)
    got, got_aux = encdec.encdec_forward_train(net, cfg, frames,
                                               torch.from_numpy(tokens))
    assert _rel(got.numpy(), want) < 1e-4
    assert float(got_aux) == float(want_aux) == 0.0


# -- the slice as a whole -----------------------------------------------------

@pytest.mark.parametrize("b,s", [(2, 64), (1, 2304)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, b, s):
    ref_cfg, cfg, params, _, net = _pair(arch, s)
    tokens = _tokens(cfg, b, s)
    stubs = prefill.stub_inputs(cfg, b, seed=1)
    hidden, aux = _ref_forward(params, ref_cfg, tokens, stubs)
    want_logits = ref_tf.lm_logits(params, ref_cfg, hidden[:, -1:, :])
    got_hidden, got_aux = _port_forward(net, cfg, tokens, stubs)
    assert _rel(got_hidden.numpy(), hidden) < 1e-4
    if cfg.moe:
        assert float(got_aux) == pytest.approx(float(aux), rel=1e-5)
        assert float(aux) > 0.0
    else:
        assert float(got_aux) == float(aux) == 0.0
    logits = prefill.make_prefill_step(build_model(cfg))(
        net, torch.from_numpy(tokens), **stubs)
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert _rel(logits.numpy(), want_logits) < 1e-4
    assert np.array_equal(logits.numpy().argmax(-1),
                          np.asarray(want_logits).argmax(-1))


def test_decoder_with_learned_positions_matches_reference():
    """A decoder-only config with a learned position table (no registry
    arch has one; whisper's tables are the encoder-decoder's) adds the
    table's first S rows to the embeddings, as the reference does."""
    kw = dict(positions="learned", max_position=128)
    ref_cfg = dataclasses.replace(ref_get("starcoder2-3b").reduced(), **kw)
    cfg = dataclasses.replace(get("starcoder2-3b").reduced(), **kw)
    params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    net = build_model(cfg).init(1, device="cpu")
    load_reference_params(net, jax.tree.map(np.asarray, params))
    assert net.pos_table.shape == (128, cfg.d_model)
    tokens = _tokens(cfg, 2, 64)
    want, _ = ref_tf.decoder_forward_train(params, ref_cfg, tokens)
    got, _ = transformer.decoder_forward_train(net, cfg,
                                               torch.from_numpy(tokens))
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("arch,route", [("starcoder2-3b", "flash_attention"),
                                        ("hymba-1.5b", "_sdpa_chunked")])
def test_long_prefill_routes_as_the_reference(arch, route, monkeypatch):
    """At S > 2048 attention goes to K4 without a window and to the plain
    chunked loop with one; hymba's SSD heads go to K5; nothing calls the
    library's attention."""
    _, cfg, _, _, net = _pair(arch)
    calls = {"flash_attention": 0, "_sdpa_chunked": 0, "ssm_scan": 0}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(attention, "flash_attention")
    spy(attention, "_sdpa_chunked")
    spy(ssm, "ssm_scan")

    def forbidden(*a, **kw):
        raise AssertionError("library attention called")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        forbidden)
    prefill.make_prefill_step(build_model(cfg))(
        net, torch.from_numpy(_tokens(cfg, 1, 2112)))
    assert calls[route] == cfg.n_layers
    other = ({"flash_attention", "_sdpa_chunked"} - {route}).pop()
    assert calls[other] == 0
    assert calls["ssm_scan"] == (cfg.n_layers if arch == "hymba-1.5b" else 0)


# (arch, the wrappers the reduced model's long prefill calls and how often):
# K4 in every causal self-attention layer, K5 in every mLSTM, K6 in every
# sLSTM; cross-attention and whisper's encoder (16 frames) take _sdpa
LONG_ROUTES = [
    ("xlstm-350m", {"ssm_scan": 1, "slstm_scan": 1, "flash_attention": 0}),
    ("qwen2-moe-a2.7b", {"flash_attention": 2, "ssm_scan": 0,
                         "slstm_scan": 0}),
    ("arctic-480b", {"flash_attention": 2, "ssm_scan": 0, "slstm_scan": 0}),
    ("llama-3.2-vision-11b", {"flash_attention": 1, "ssm_scan": 0,
                              "slstm_scan": 0}),
    ("whisper-tiny", {"flash_attention": 2, "ssm_scan": 0,
                      "slstm_scan": 0}),
]


@pytest.mark.parametrize("arch,want", LONG_ROUTES)
def test_long_prefill_of_the_new_kinds_routes_as_the_reference(
        arch, want, monkeypatch):
    ref_cfg, cfg, _, _, net = _pair(arch, 2112)
    calls = dict.fromkeys(want, 0)
    calls["_sdpa_chunked"] = 0

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(attention, "flash_attention")
    spy(attention, "_sdpa_chunked")
    spy(ssm, "ssm_scan")
    spy(ssm, "slstm_scan")
    stubs = prefill.stub_inputs(cfg, 1)
    prefill.make_prefill_step(build_model(cfg))(
        net, torch.from_numpy(_tokens(cfg, 1, 2112)), **stubs)
    assert calls == dict(want, _sdpa_chunked=0)


# -- what the slice does not do yet, and where it runs ------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_unported_kinds_raise(arch):
    """The four block kinds whose decode came last (the xLSTM pair, the
    MoE, the VLM's cross layers, whisper's decoder) no longer raise: their
    caches build and one decode step gives finite logits of the right
    shape, with the stub memory where the kind attends to one."""
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(0, device="cpu")
    caches = model.init_cache(2, 16, device="cpu")
    memory = model.encode_memory(net, prefill.stub_inputs(cfg, 2))
    with torch.inference_mode():
        logits, caches = model.decode_step(
            net, torch.zeros((2, 1), dtype=torch.long), caches, memory)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert transformer.caches_length(caches).tolist() == [1, 1]


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny",
                                  "starcoder2-3b"])
def test_prefill_step_refuses_missing_or_stray_stub_inputs(arch):
    cfg = get(arch).reduced()
    model = build_model(cfg)
    net = model.init(0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 1, 8))
    step = prefill.make_prefill_step(model)
    stubs = prefill.stub_inputs(cfg, 1)
    wrong = ({} if stubs else
             {"images": torch.zeros(1, 3, cfg.d_model)})
    with pytest.raises(ValueError, match="stub inputs"):
        step(net, tokens, **wrong)
    assert step(net, tokens, **stubs).shape == (1, 1, cfg.vocab_size)


def test_init_without_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get("starcoder2-3b").reduced()).init()


def test_init_draws_from_the_seed():
    cfg = get("hymba-1.5b").reduced()
    a = build_model(cfg).init(3, device="cpu")
    b = build_model(cfg).init(3, device="cpu")
    c = build_model(cfg).init(4, device="cpu")
    assert torch.equal(a.layers[0].ssd.wB.w, b.layers[0].ssd.wB.w)
    assert not torch.equal(a.layers[0].ssd.wB.w, c.layers[0].ssd.wB.w)
    assert a.layers[0].ssd.wdt.w.dtype == torch.float32
    assert float(a.embed.w.std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "starcoder2-3b",
                                  "xlstm-350m", "qwen2-moe-a2.7b",
                                  "arctic-480b", "llama-3.2-vision-11b",
                                  "whisper-tiny", "granite-20b",
                                  "qwen1.5-4b", "qwen1.5-110b"])
def test_prefill_main_runs_on_the_cpu(arch, capsys):
    """Every architecture of the registry builds and prefills at
    reduced() on the CPU."""
    prefill.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out[:4]] == ["[0]", "[1]", "[2]",
                                                    "[3]"]
    assert out[-1].startswith(f"prefill {arch} B=4 S=8 on cpu")


@pytest.mark.parametrize("d_model,n_heads", [(512, 4), (1024, 8)])
def test_bf16_prefill_stays_near_fp32(d_model, n_heads):
    """chip_smoke.py holds the card's bf16 starcoder2-3b prefill (depth 2,
    S = 2304, K4's tensor-core body) to the CPU's fp32 run of the same
    bf16-valued weights within 2e-2 of the largest logit.  The CPU's own
    bf16 run of that path at reduced widths (head dim 128 as on the card,
    the full vocabulary), which rounds the activations at every layer as
    the card does, lands within 1e-2: the tolerance leaves room for the
    card's other summation orders and P's rounding in K4."""
    base = get("starcoder2-3b")
    cfg = dataclasses.replace(
        base.reduced(d_model=d_model, n_heads=n_heads,
                     vocab=base.vocab_size), dtype="bfloat16")
    assert cfg.hd == 128
    model = build_model(cfg)
    net = model.init(0, device="cpu")
    net32 = transformer.Decoder(dataclasses.replace(cfg, dtype="float32"),
                                device="cpu")
    net32.load_state_dict({k: v.float() for k, v in net.state_dict().items()})
    tokens = torch.from_numpy(np.random.default_rng(d_model).integers(
        0, cfg.vocab_size, (1, 2304)))
    step = prefill.make_prefill_step(model)
    got = step(net, tokens)
    want = step(net32, tokens)
    assert got.dtype == torch.bfloat16
    rel = float((got.float() - want).abs().max() / want.abs().max())
    assert rel < 1e-2
