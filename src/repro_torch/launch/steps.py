"""Step builders for serving: prefill and one-token decode (counterpart
of the serving half of `repro.launch.steps`; the train-step builders
come with the training slice).

* prefill_step -- forward, last-position logits only.
* serve_step   -- one-token decode against the caches (KV caches, and the
  recurrent SSM and conv states of the ssm and hybrid families).

Both serve every ported family: dense (yi-9b, qwen2), ssm (mamba2) and
hybrid (zamba2).
"""

from __future__ import annotations

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

#: On the card this is the CUDA `ssd_scan` kernel in every Mamba2 layer
#: and the CUDA flash attention kernel in every attention layer (zamba2's
#: shared block included) in prefill, and the flash-decode kernel in
#: decode; the Mamba2 decode step is plain PyTorch. (The reference
#: defaults to "chunked", its XLA lowering path; the port's counterpart
#: of the TPU kernel path is "kernel".)
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
    flash-decode kernel for every attention layer. (The reference's serve
    step decodes with its plain attention and never reaches its decode
    kernel.)"""
    def serve_step(params, tokens, state):
        return tf.decode_step(params, cfg, tokens, state, impl=DEFAULT_IMPL)

    return serve_step
