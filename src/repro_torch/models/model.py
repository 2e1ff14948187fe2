"""Model facade: ``build_model(cfg).init(seed, device=...)`` builds the
decoder with its parameters drawn on the device, and the forward path takes
that module as the reference's functions take their parameter tree.

    net = build_model(cfg).init(0, device="cuda")
    hidden, aux = transformer.decoder_forward_train(net, cfg, tokens)

Without ``device=`` the module goes on the current GPU, and without a GPU
``init`` raises: the caller names the CPU to run the plain versions.  The
loss, the decode caches and the encoder-decoder come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from . import transformer as tf


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, *, device=None) -> tf.Decoder:
        """The decoder with parameters drawn from ``torch.Generator``
        seeded with ``seed`` on ``device`` (default: the current GPU)."""
        device = (default_devices()[0] if device is None
                  else canonical(device))
        gen = torch.Generator(device=device).manual_seed(seed)
        return tf.Decoder(self.cfg, device=device, generator=gen)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
