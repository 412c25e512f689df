"""Step builders for serving: prefill and one-token decode (counterpart
of the serving half of `repro.launch.steps`; the train-step builders
come with the training slice).

* prefill_step -- forward, last-position logits only.
* serve_step   -- one-token decode against the KV caches.
"""

from __future__ import annotations

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

#: On the card this is the CUDA flash attention kernel in prefill and the
#: flash-decode kernel in decode. (The reference defaults to "chunked",
#: its XLA lowering path; the port's counterpart of the TPU kernel path
#: is "kernel".)
DEFAULT_IMPL = "kernel"


def make_prefill_step(cfg: ModelConfig, *, impl: str = DEFAULT_IMPL):
    def prefill_step(params, batch):
        # serving prefill: only the last position's logits are unembedded
        logits, _ = tf.forward(params, cfg, batch["tokens"],
                               prefix_embeds=batch.get("prefix_embeds"),
                               impl=impl, last_only=True)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode through DEFAULT_IMPL: on the card, the CUDA
    flash-decode kernel. (The reference's serve step decodes with its
    plain attention and never reaches its decode kernel.)"""
    def serve_step(params, tokens, state):
        return tf.decode_step(params, cfg, tokens, state, impl=DEFAULT_IMPL)

    return serve_step
