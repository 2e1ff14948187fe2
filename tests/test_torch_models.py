"""The port's LM prefill path against the reference's, on the CPU.

The reference's parameters (``Model.init(PRNGKey(0))`` on reduced configs)
are carried into the port by ``models/convert.py``; the same numpy-seeded
tokens then go through both forward paths.  S = 64 takes ``_sdpa`` and the
scan's plain version; S = 2304 (above CHUNKED_ATTN_THRESHOLD) takes the K4
wrapper (starcoder2), the plain chunked loop (hymba's window) and the K5
wrapper, whose CPU path is the step-by-step recurrence.  Tolerance 1e-4
relative in fp32: the reference's chunked sums and the port's full softmax
and sequential scan sum in other orders, and that stays well inside it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch.configs import get
from repro_torch.launch import prefill
from repro_torch.models import attention, build_model, ssm, transformer
from repro_torch.models.convert import flatten_reference, load_reference_params

ARCHS = ["starcoder2-3b", "starcoder2-3b-gqa4", "hymba-1.5b"]


def _cfgs(arch):
    """(reference config, port config) for a reduced arch.  reduced()
    gives starcoder2 GQA 4/2 already; '-gqa4' widens the group to 4."""
    name = arch.removesuffix("-gqa4")
    ref_cfg, cfg = ref_get(name).reduced(), get(name).reduced()
    if arch.endswith("-gqa4"):
        kw = dict(n_heads=8, n_kv_heads=2, head_dim=8)
        ref_cfg = dataclasses.replace(ref_cfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    return ref_cfg, cfg


_CACHE = {}


def _pair(arch):
    """Reference params (numpy leaves) and the port's net loaded with
    them, built once per arch."""
    if arch not in _CACHE:
        ref_cfg, cfg = _cfgs(arch)
        params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
        params_np = jax.tree.map(np.asarray, params)
        net = build_model(cfg).init(1, device="cpu")
        load_reference_params(net, params_np)
        _CACHE[arch] = (ref_cfg, cfg, params, params_np, net)
    return _CACHE[arch]


def _rel(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


# -- convert ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    ref_cfg, cfg, _, params_np, net = _pair(arch)
    flat = flatten_reference(params_np, cfg)
    own = dict(net.named_parameters())
    assert set(flat) == set(own)
    assert len(net.layers) == cfg.n_layers
    for name, p in own.items():
        assert np.array_equal(p.numpy(), np.asarray(flat[name])), name
    # a layer leaf is row i of the reference's stacked group
    stacked = params_np["groups"][0][0]["attn"]["wq"]["w"]
    assert np.array_equal(own["layers.1.attn.wq.w"].numpy(), stacked[1])


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
    assert np.array_equal(net.embed.w.float().numpy(),
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


# -- the slice as a whole -----------------------------------------------------

@pytest.mark.parametrize("b,s", [(2, 64), (1, 2304)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, b, s):
    ref_cfg, cfg, params, _, net = _pair(arch)
    tokens = _tokens(cfg, b, s)
    hidden, aux = ref_tf.decoder_forward_train(params, ref_cfg, tokens)
    want_logits = ref_tf.lm_logits(params, ref_cfg, hidden[:, -1:, :])
    got_hidden, got_aux = transformer.decoder_forward_train(
        net, cfg, torch.from_numpy(tokens))
    assert _rel(got_hidden.numpy(), hidden) < 1e-4
    assert float(got_aux) == float(aux) == 0.0
    logits = prefill.make_prefill_step(build_model(cfg))(
        net, torch.from_numpy(tokens))
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert _rel(logits.numpy(), want_logits) < 1e-4
    assert np.array_equal(logits.numpy().argmax(-1),
                          np.asarray(want_logits).argmax(-1))


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


# -- what the slice does not do yet, and where it runs ------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_unported_kinds_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(get(arch).reduced()).init(0, device="cpu")


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


@pytest.mark.parametrize("arch", ["hymba-1.5b", "starcoder2-3b"])
def test_prefill_main_runs_on_the_cpu(arch, capsys):
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
