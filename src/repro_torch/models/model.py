"""Model facade: ``build_model(cfg).init(seed, device=...)`` builds the
network with its parameters drawn on the device (a ``Decoder``, or an
``EncDec`` for whisper), and the forward path takes that module as the
reference's functions take their parameter tree.

    net = build_model(cfg).init(0, device="cuda")
    memory = build_model(cfg).encode_memory(net, batch)
    hidden, aux = transformer.decoder_forward_train(net, cfg, tokens,
                                                    memory=memory)
    hidden, aux = encdec.encdec_forward_train(net, cfg, frames, tokens)

    loss, metrics = build_model(cfg).loss(net, batch)   # {"ce", "aux"}

    caches = build_model(cfg).init_cache(batch, max_len, device=...)
    logits, caches = build_model(cfg).decode_step(net, tokens, caches,
                                                  memory)

Batches are dicts: tokens / labels (LM), frames (whisper), images (vlm).
The loss computes cross-entropy in sequence chunks (``cfg.logits_chunk``),
each chunk's (B, chunk, V) logits recomputed in the backward, so the whole
logits tensor is never held.  Without ``device=`` the module and the caches
go on the current GPU, and without a GPU ``init`` and ``init_cache`` raise:
the caller names the CPU to run the plain versions.

Under a mesh, ``Model.shard(net, mesh)`` cuts the network's parameters to
this rank's blocks (``distributed/sharding.py``) and sets the dense blocks'
tensor parallelism; ``loss`` then gives the rank's mean over its own rows
of the batch, which the trainer averages over the batch ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from ..distributed.sharding import P, TP, Placement, dims_over, leaf_spec
from . import encdec as ed
from . import transformer as tf
from .attention import Attention
from .convert import reference_leaves
from .layers import MLP, REMAT


def _ce_chunk(net, cfg, h, y, w):
    """(sum of the token losses, count of valid labels) of one chunk, with
    ``w`` the LM head's weight; labels < 0 are ignored."""
    logits = tf.lm_logits(net, cfg, h, w).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    valid = y >= 0
    gold = torch.gather(logits, -1,
                        torch.where(valid, y, 0)[..., None])[..., 0]
    valid = valid.to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _chunked_ce(net, cfg, hidden, labels, chunk: int):
    """Mean cross-entropy over the valid tokens, chunk by chunk along the
    sequence: the chunk is ``chunk or S``, at most S, halved until it
    divides S; each chunk's body is recomputed in the backward.  The LM
    head's weight is taken once for every chunk (under a mesh, one gather
    a loss: the recomputed chunks reuse it)."""
    s = hidden.shape[1]
    chunk = min(chunk or s, s)
    while s % chunk != 0:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    w = tf.lm_head_weight(net, cfg)
    for c0 in range(0, s, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk].long()
        if torch.is_grad_enabled():
            t, n = checkpoint(_ce_chunk, net, cfg, h, y, w, **REMAT)
        else:
            t, n = _ce_chunk(net, cfg, h, y, w)
        total, count = total + t, count + n
    return total / torch.clamp(count, min=1.0)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, *,
             device=None) -> Union[tf.Decoder, ed.EncDec]:
        """The network with parameters drawn from ``torch.Generator``
        seeded with ``seed`` on ``device`` (default: the current GPU)."""
        device = (default_devices()[0] if device is None
                  else canonical(device))
        gen = torch.Generator(device=device).manual_seed(seed)
        if self.cfg.block_pattern == "encdec":
            return ed.EncDec(self.cfg, device=device, generator=gen)
        return tf.Decoder(self.cfg, device=device, generator=gen)

    def shard(self, net, mesh) -> Dict[str, P]:
        """Cut ``net``'s parameters in place to this rank's blocks under
        ``mesh`` and return ``{reference leaf path: spec}``.

        A leaf's spec is :func:`sharding.leaf_spec` of the reference's
        stacked leaf.  The self-attention blocks (``attn``) whose ``wq`` /
        ``wo`` are cut on whole query heads run tensor-parallel, with
        ``wk`` / ``wv`` too where the KV heads divide; the MLPs whose
        ``up`` / ``gate`` / ``down`` are cut on ``d_ff`` run
        tensor-parallel; every other leaf cut over ``model`` is gathered
        where it is used.  Each cut parameter carries its ``placement``."""
        m = mesh.shape.get("model", 1)
        params = dict(net.named_parameters())
        specs, cut = {}, {}
        for path, leaf in reference_leaves(net).items():
            p0 = params[leaf.names[0]]
            shape = (len(leaf.names),) * leaf.stacked + tuple(p0.shape)
            specs[path] = spec = leaf_spec(path, shape, mesh)
            dims = dims_over(spec, "model")
            for name in leaf.names:
                cut[name] = dims[0] - leaf.stacked if dims else None
        if m == 1:
            return specs
        tp = TP(mesh.group("model"), m, mesh.axis_index("model"))
        mode = {}
        for mname, mod in net.named_modules():
            pre = f"{mname}." if mname else ""
            if isinstance(mod, Attention) and mname.endswith("attn"):
                q_whole = (cut[pre + "wq.w"] == 1 and cut[pre + "wo.w"] == 0
                           and self.cfg.n_heads % m == 0)
                if not q_whole:
                    continue
                mod.tp = tp
                mod.kv_tp = (cut[pre + "wk.w"] == 1
                             and self.cfg.n_kv_heads % m == 0)
                names = ["wq", "wo"] + (["wk", "wv"] if mod.kv_tp else [])
                mode.update((f"{pre}{n}.{w}", "tp") for n in names
                            for w in ("w", "b"))
            elif isinstance(mod, MLP):
                lins = ["up", "down"] + (["gate"] if mod.gate is not None
                                         else [])
                want = {"up": 1, "gate": 1, "down": 0}
                if all(cut[f"{pre}{n}.w"] == want[n] for n in lins):
                    mod.tp = tp
                    mode.update((f"{pre}{n}.w", "tp") for n in lins)
        with torch.no_grad():
            for name, p in params.items():
                dim = cut[name]
                if dim is None:
                    continue
                size = p.shape[dim] // m
                p.data = p.data.narrow(dim, tp.index * size, size).clone()
                p.placement = Placement(dim, mode.get(name, "gather"), mesh)
        return specs

    def loss(self, net, batch: Mapping[str, torch.Tensor]):
        """(loss, {"ce", "aux"}): the mean cross-entropy of
        ``batch["labels"]`` (< 0 ignored) plus the MoE layers' load-balance
        losses."""
        cfg = self.cfg
        if cfg.block_pattern == "encdec":
            hidden, aux = ed.encdec_forward_train(
                net, cfg, batch["frames"], batch["tokens"])
        else:
            hidden, aux = tf.decoder_forward_train(
                net, cfg, batch["tokens"],
                memory=self.encode_memory(net, batch))
        ce = _chunked_ce(net, cfg, hidden, batch["labels"], cfg.logits_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    def encode_memory(self, net, batch: Mapping[str, torch.Tensor]
                      ) -> Optional[torch.Tensor]:
        """What the cross-attention layers attend to: the encoder's states
        for encdec (from ``batch["frames"]``), the precomputed patch
        embeddings ``batch["images"]`` for vlm (the patch frontend is a
        stub), None otherwise."""
        if self.cfg.block_pattern == "encdec":
            return ed.encode(net, self.cfg, batch["frames"])
        if self.cfg.block_pattern == "vlm":
            return batch["images"]
        return None

    def init_cache(self, batch: int, max_len: int, *, device=None):
        """Empty decode caches for ``batch`` rows of up to ``max_len``
        tokens (a list with one dict a layer), on ``device`` (default: the
        current GPU)."""
        device = (default_devices()[0] if device is None
                  else canonical(device))
        if self.cfg.block_pattern == "encdec":
            return ed.init_encdec_cache(self.cfg, batch, max_len, device)
        return tf.init_decode_cache(self.cfg, batch, max_len, device)

    def decode_step(self, net, tokens, caches, memory=None):
        """tokens (B, s1) -> (logits (B, s1, V), new caches).  The KV
        caches are written in place."""
        if self.cfg.block_pattern == "encdec":
            return ed.encdec_decode_step(net, self.cfg, tokens, caches,
                                         memory)
        return tf.decoder_decode_step(net, self.cfg, tokens, caches,
                                      memory=memory)

    @property
    def supports_chunked_prefill(self) -> bool:
        """True when decode_step takes multi-token chunks: every layer is
        attention-shaped (the recurrent SSM / LSTM decode paths take one
        token) and the KV ring cannot wrap inside a chunk (no sliding
        window)."""
        if self.cfg.sliding_window:
            return False
        if self.cfg.block_pattern == "encdec":
            return True
        return set(tf.layer_kinds(self.cfg)) <= {"dense", "vlm_self", "moe",
                                                 "cross"}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
