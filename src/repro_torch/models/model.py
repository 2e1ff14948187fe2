"""Model facade: ``build_model(cfg).init(seed, device=...)`` builds the
network with its parameters drawn on the device (a ``Decoder``, or an
``EncDec`` for whisper), and the forward path takes that module as the
reference's functions take their parameter tree.

    net = build_model(cfg).init(0, device="cuda")
    memory = build_model(cfg).encode_memory(net, batch)
    hidden, aux = transformer.decoder_forward_train(net, cfg, tokens,
                                                    memory=memory)
    hidden, aux = encdec.encdec_forward_train(net, cfg, frames, tokens)

Without ``device=`` the module goes on the current GPU, and without a GPU
``init`` raises: the caller names the CPU to run the plain versions.  The
loss and the decode caches come with later slices: ``init_cache`` and
``decode_step`` raise ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from . import encdec as ed
from . import transformer as tf

_SERVING = ("is not ported yet; it comes with the serving slice of the "
            "port (decode caches and one-step decode)")


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

    def init_cache(self, batch: int, max_len: int):
        raise NotImplementedError(f"init_cache {_SERVING}")

    def decode_step(self, net, tokens, caches, memory=None):
        raise NotImplementedError(f"decode_step {_SERVING}")


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
