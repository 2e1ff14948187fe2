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
    caches = build_model(cfg).init_cache(batch, max_len, mesh=mesh)
    with use_mesh(mesh):                 # a rank's step on its blocks
        logits, caches = build_model(cfg).decode_step(net, tokens, caches)

Batches are dicts: tokens / labels (LM), frames (whisper), images (vlm).
The loss computes cross-entropy in sequence chunks (``cfg.logits_chunk``),
each chunk's (B, chunk, V) logits recomputed in the backward, so the whole
logits tensor is never held.  Without ``device=`` the module and the caches
go on the current GPU, and without a GPU ``init`` and ``init_cache`` raise:
the caller names the CPU to run the plain versions.

Under a mesh, ``Model.shard(net, mesh, fsdp=)`` cuts the network's
parameters to this rank's blocks (``distributed/sharding.py``, under the
mesh's rules; with ``fsdp`` over the rules' ``zero`` axes too) and sets
the tensor parallelism of the blocks whose heads (the sLSTM's features)
divide ``model`` and the MoE layers' expert (or expert-``ff``)
parallelism; ``loss`` then gives the rank's mean over its
own rows of the batch, which the trainer averages over the batch ranks
(under ``seq_sp`` the mean over the rows' whole sequences: the ``model``
ranks' totals summed).  ``init_cache(..., mesh=)`` builds the
rank's blocks of the decode caches, on which ``decode_step`` runs under
``use_mesh(mesh)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from ..distributed import process_group as pg
from ..distributed.sharding import (P, Placement, dims_over, fsdp_spec,
                                    leaf_spec, seq_tp, shard_of, tp_exit,
                                    tp_of, use_mesh, zero_cut)
from . import encdec as ed
from . import transformer as tf
from .attention import Attention
from .convert import reference_leaves, shard_caches
from .layers import MLP, REMAT
from .moe import MoE, ep_works
from .ssm import MLSTM, SLSTM, SSD

#: the SSM and xLSTM blocks run tensor-parallel: (the units a rank holds
#: whole: the heads, or the sLSTM's features, its recurrence one scalar a
#: feature; the leaves cut on the dimension given, columns 1 and rows 0).
#: Their gates ``wf`` / ``wdt`` stay whole on every rank
_HEAD_CUTS = {
    MLSTM: (lambda cfg: cfg.n_heads,
            {"wq": 1, "wk": 1, "wv": 1, "wo_gate": 1, "wi": 1, "wo": 0}),
    SSD: (lambda cfg: cfg.ssm.n_ssm_heads or cfg.n_heads,
          {"wB": 1, "wC": 1, "wx": 1, "wo": 0}),
    SLSTM: (lambda cfg: cfg.n_heads * cfg.hd,
            {"wz": 1, "wi": 1, "wog": 1, "wo": 0}),
}


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


def _chunked_ce(net, cfg, hidden, labels, chunk: int, sp=None):
    """Mean cross-entropy over the valid tokens, chunk by chunk along the
    sequence: the chunk is ``chunk or S``, at most S, halved until it
    divides S; each chunk's body is recomputed in the backward.  The LM
    head's weight is taken once for every chunk (under a mesh, one gather
    a loss: the recomputed chunks reuse it).  ``sp``
    (``sharding.seq_tp``): ``hidden`` and ``labels`` are the rank's rows
    of the sequence; the ranks' totals and counts are summed over
    ``model`` before the division (each rank's backward takes its rows)."""
    s = hidden.shape[1]
    chunk = min(chunk or s, s)
    while s % chunk != 0:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    w = tf.lm_head_weight(net, cfg, sp)
    for c0 in range(0, s, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk].long()
        if torch.is_grad_enabled():
            t, n = checkpoint(_ce_chunk, net, cfg, h, y, w, **REMAT)
        else:
            t, n = _ce_chunk(net, cfg, h, y, w)
        total, count = total + t, count + n
    if sp is not None:
        total = tp_exit(total, sp)
        count = pg.all_reduce(count, sp.group)
    return total / torch.clamp(count, min=1.0)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: Optional[int] = 0, *,
             device=None) -> Union[tf.Decoder, ed.EncDec]:
        """The network with parameters drawn from ``torch.Generator``
        seeded with ``seed`` on ``device`` (default: the current GPU);
        with ``seed=None`` left undrawn (the ``meta`` device's network of a
        counted run, or one a state dict is loaded into)."""
        device = (default_devices()[0] if device is None
                  else canonical(device))
        gen = (None if seed is None
               else torch.Generator(device=device).manual_seed(seed))
        if self.cfg.block_pattern == "encdec":
            return ed.EncDec(self.cfg, device=device, generator=gen)
        return tf.Decoder(self.cfg, device=device, generator=gen)

    def shard(self, net, mesh, *, fsdp: bool = False) -> Dict[str, P]:
        """Cut ``net``'s parameters in place to this rank's blocks under
        ``mesh`` and return ``{reference leaf path: spec}``.

        A leaf's spec is :func:`sharding.leaf_spec` of the reference's
        stacked leaf under the mesh's rules, or with ``fsdp`` its
        :func:`sharding.fsdp_spec` (cut over the rules' ``zero`` axes too).  The
        self- and cross-attention blocks whose ``wq`` / ``wo`` are cut on
        whole query heads run tensor-parallel, with ``wk`` / ``wv`` too
        where the KV heads divide; the MLPs whose ``up`` / ``gate`` /
        ``down`` are cut on ``d_ff``, the mLSTM and SSD blocks whose
        projections are cut on whole heads and the sLSTM blocks whose
        projections are cut on the features (``_HEAD_CUTS``) run
        tensor-parallel; the MoE layers whose expert banks are cut on
        their experts run expert-parallel (``"ep"``), and those cut on
        the experts' ``ff`` dimension tensor-parallel (``"tp"``); every
        other leaf cut over ``model`` is gathered where it is used, as is
        every leaf's ``data`` block under FSDP.  Each cut parameter carries its ``placement``."""
        m = mesh.shape.get("model", 1)
        params = dict(net.named_parameters())
        specs, cut, fcut, layer_spec = {}, {}, {}, {}
        for path, leaf in reference_leaves(net).items():
            p0 = params[leaf.names[0]]
            shape = (len(leaf.names),) * leaf.stacked + tuple(p0.shape)
            tspec = leaf_spec(path, shape, mesh)
            specs[path] = spec = (
                fsdp_spec(path, shape, mesh, leaf.stacked) if fsdp
                else tspec)
            # the tensor-parallel cut over model (an axis of one rank cuts
            # nothing), and FSDP's over the zero axes
            dims = dims_over(tspec, "model") if m > 1 else ()
            zc = zero_cut(tspec, spec, mesh)
            for name in leaf.names:
                cut[name] = dims[0] - leaf.stacked if dims else None
                fcut[name] = (None if zc is None
                              else (zc[0] - leaf.stacked, zc[1]))
                layer_spec[name] = P(*spec[leaf.stacked:])
        mode = {}
        if m > 1:
            tp = tp_of(mesh)
            for mname, mod in net.named_modules():
                pre = f"{mname}." if mname else ""
                if isinstance(mod, Attention):
                    q_whole = (cut[pre + "wq.w"] == 1
                               and cut[pre + "wo.w"] == 0
                               and self.cfg.n_heads % m == 0)
                    if not q_whole:
                        continue
                    mod.tp = tp
                    mod.kv_tp = (cut[pre + "wk.w"] == 1
                                 and self.cfg.n_kv_heads % m == 0)
                    names = ["wq", "wo"] + (["wk", "wv"] if mod.kv_tp
                                            else [])
                    mode.update((f"{pre}{n}.{w}", "tp") for n in names
                                for w in ("w", "b"))
                elif isinstance(mod, MLP):
                    lins = ["up", "down"] + (["gate"] if mod.gate is not None
                                             else [])
                    want = {"up": 1, "gate": 1, "down": 0}
                    if all(cut[f"{pre}{n}.w"] == want[n] for n in lins):
                        mod.tp = tp
                        mode.update((f"{pre}{n}.w", "tp") for n in lins)
                elif type(mod) in _HEAD_CUTS:
                    units, want = _HEAD_CUTS[type(mod)]
                    if (units(self.cfg) % m == 0
                            and all(cut[f"{pre}{n}.w"] == d
                                    for n, d in want.items())):
                        mod.tp = tp
                        mode.update((f"{pre}{n}.w", "tp") for n in want)
                elif isinstance(mod, MoE):
                    banks = ["w_up", "w_down"] + (
                        ["w_gate"] if mod.w_gate is not None else [])
                    with use_mesh(mesh):
                        ep = ep_works(self.cfg)
                    # experts (dim 0), else the experts' ff dimension
                    want = ({b: 0 for b in banks} if ep else
                            {"w_up": 2, "w_gate": 2, "w_down": 1})
                    if all(cut[pre + b] == want[b] for b in banks):
                        mod.tp, mod.mode = tp, "ep" if ep else "tp"
                        mode.update((pre + b, mod.mode) for b in banks)
        with torch.no_grad():
            for name, p in params.items():
                dim, fz = cut[name], fcut[name]
                if dim is None and fz is None:
                    continue
                p.data = shard_of(p.data, layer_spec[name], mesh)
                p.placement = Placement(
                    dim, None if dim is None else mode.get(name, "gather"),
                    mesh, *(() if fz is None else fz))
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
        labels = batch["labels"]
        sp = seq_tp(labels.shape[1])
        if sp is not None:
            # the hidden states are the rank's rows of the sequence
            n = labels.shape[1] // sp.size
            labels = labels[:, sp.index * n:(sp.index + 1) * n]
        ce = _chunked_ce(net, cfg, hidden, labels, cfg.logits_chunk, sp)
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

    def init_cache(self, batch: int, max_len: int, *, device=None,
                   mesh=None):
        """Empty decode caches for ``batch`` rows of up to ``max_len``
        tokens (a list with one dict a layer), on ``device`` (default: the
        current GPU).  Under ``mesh`` this rank's blocks of them, as the
        reference's cache rules place the leaves (``convert.shard_caches``),
        made at their own size."""
        device = (default_devices()[0] if device is None
                  else canonical(device))
        if mesh is not None:
            whole = self.init_cache(batch, max_len, device="meta")
            return shard_caches(whole, self.cfg, mesh, device)
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
