"""Model facade: ``build_model(cfg).init(seed, device=...)`` builds the
network with its parameters drawn on the device (a ``Decoder``, or an
``EncDec`` for whisper), and the forward path takes that module as the
reference's functions take their parameter tree.

    net = build_model(cfg).init(0, device="cuda")
    memory = build_model(cfg).encode_memory(net, batch)
    hidden, aux = transformer.decoder_forward_train(net, cfg, tokens,
                                                    memory=memory)
    hidden, aux = encdec.encdec_forward_train(net, cfg, frames, tokens)

    caches = build_model(cfg).init_cache(batch, max_len, device=...)
    logits, caches = build_model(cfg).decode_step(net, tokens, caches,
                                                  memory)

Without ``device=`` the module and the caches go on the current GPU, and
without a GPU ``init`` and ``init_cache`` raise: the caller names the CPU to
run the plain versions.  The loss comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from . import encdec as ed
from . import transformer as tf


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
