"""Continuous-batching serving engine (counterpart of
`repro.serving.engine`; token-level scheduling).

A fixed pool of `max_slots` decode slots shares ONE decode step. Requests
join mid-flight: a freed slot is reset (per-slot KV rows / SSM-state rows
zeroed in place, per-slot position rewound) and the new request's prompt
streams through the same decode path one token per engine step
(token-level chunked prefill — every step advances every active slot by
exactly one token, so prefilling requests never stall decoding ones).
Scheduling, sampling and the invariant the tests enforce (a request's
output is IDENTICAL whatever other traffic shares the batch) are the
reference's.

The step is `launch.steps.make_serve_step`'s: `transformer.decode_step`
with the port's DEFAULT_IMPL and its positions kept on the device (the
engine checks their range on the host before every step, where
`decode_step` would read them back), so on the card every attention
layer runs the hand-written `decode_attention` kernel, and on the CPU
its plain version. Where the reference compiles its step once with
`jax.jit`, the engine on the card captures it once as a CUDA graph: the
step reads its tokens and positions from static device buffers and
writes its logits to
a static output, and the caches keep their addresses for the engine's
lifetime (they are zeroed in place, never reallocated, also by
`reset`). Each later step copies the host's tokens and positions into
the buffers, replays the graph and samples from the static logits.
`captures` counts the captures (the reference's trace count): one per
engine, whatever the number of steps, slot reuses and resets.
`cuda_graph=False` runs the same step eagerly on the card, the oracle of
the captured one; the CPU always runs it eagerly (it has no graphs).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

#: eager steps on a side stream before the capture (lazy library set-up)
WARMUP_STEPS = 2


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    # filled by the engine:
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def total_budget(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    fed: int = 0  # prompt tokens already fed

    @property
    def free(self) -> bool:
        return self.request is None


def _cache_leaves(caches) -> list[torch.Tensor]:
    if isinstance(caches, dict):
        return [t for v in caches.values() for t in _cache_leaves(v)]
    if isinstance(caches, list):
        return [t for v in caches for t in _cache_leaves(v)]
    return [caches]


def _zero_slot_caches(caches, slot: int) -> None:
    """Zero every per-slot row of the decode caches in place (the batch
    axis is 1 for every cache kind: KV (L,B,S,H,hd), ssm (L,B,...))."""
    for a in _cache_leaves(caches):
        if a.dim() >= 2:
            a[:, slot].zero_()


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 128, dtype=torch.float32,
                 sample: Callable | None = None, device=None,
                 cuda_graph: bool = True):
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: deque[Request] = deque()
        self._rid = itertools.count()
        self.completed: list[Request] = []

        self.caches = tf.init_decode_state(cfg, max_slots, max_seq,
                                           dtype=dtype,
                                           device=self.device).caches
        self.positions = np.zeros((max_slots,), np.int64)
        cuda = self.device.type == "cuda"
        # tokens and positions: staged on the host, read by the step
        # from one static device buffer
        self._host_in = torch.zeros((2, max_slots), dtype=torch.int64,
                                    pin_memory=cuda)
        self._dev_in = torch.zeros((2, max_slots), dtype=torch.int64,
                                   device=self.device)
        self._serve = make_serve_step(cfg, device_positions=True)
        self._sample = sample or (lambda logits: torch.argmax(logits, -1))
        self.cuda_graph = cuda_graph and cuda
        self._graph: torch.cuda.CUDAGraph | None = None
        self._logits: torch.Tensor | None = None
        self.captures = 0
        self.steps = 0  # decode steps run; each a replay once captured

    def reset(self) -> None:
        """Drop every queued/active/completed request and zero the
        decode state in place; the captured step survives, so a load
        sweep (serving/traffic.py) pays its capture once per engine."""
        self.slots = [_Slot() for _ in range(self.max_slots)]
        self.queue.clear()
        self.completed = []
        self._rid = itertools.count()
        self._zero_state()

    def _zero_state(self) -> None:
        for a in _cache_leaves(self.caches):
            a.zero_()
        self.positions[:] = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.rid = next(self._rid)
        if req.total_budget > self.max_seq:
            raise ValueError("request exceeds max_seq")
        if len(req.prompt) < 1:
            raise ValueError("request has an empty prompt")
        self.queue.append(req)
        return req.rid

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.popleft()
                slot.request = req
                slot.fed = 0
                _zero_slot_caches(self.caches, i)
                self.positions[i] = 0

    # ------------------------------------------------------------------
    def _forward(self) -> torch.Tensor:
        """The decode step on the static buffers: (B, 1, V) logits."""
        state = tf.DecodeState(caches=self.caches, position=self._dev_in[1])
        logits, _ = self._serve(self.params, self._dev_in[0][:, None], state)
        return logits

    def _capture(self) -> None:
        """Warm up on a side stream, zero what the warm-up wrote, and
        capture the step. Runs before any request is admitted, so no
        slot's state is disturbed."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._forward()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._zero_state()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._logits = self._forward()
        self._graph = graph
        self.captures += 1

    def _run_step(self, tokens: np.ndarray) -> np.ndarray:
        if self.positions.min() < 0 or self.positions.max() >= self.max_seq:
            raise RuntimeError(f"positions {self.positions} outside "
                               f"0..{self.max_seq - 1}")
        self._host_in[0] = torch.from_numpy(tokens)
        self._host_in[1] = torch.from_numpy(self.positions)
        self._dev_in.copy_(self._host_in, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            logits = self._logits
        else:
            logits = self._forward()
        self.steps += 1
        return np.asarray(self._sample(logits[:, -1, :]).cpu())

    @torch.no_grad()
    def step(self) -> bool:
        """One engine step: every active slot advances by one token.

        Returns False when idle (no active slots and empty queue)."""
        if self.cuda_graph and self._graph is None:
            self._capture()
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return bool(self.queue)

        tokens = np.zeros((self.max_slots,), np.int64)
        for i in active:
            slot = self.slots[i]
            req = slot.request
            if slot.fed < len(req.prompt):
                tokens[i] = req.prompt[slot.fed]  # chunked prefill
            else:
                tokens[i] = req.output[-1]        # autoregressive
        next_tok = self._run_step(tokens)

        for i in active:
            slot = self.slots[i]
            req = slot.request
            self.positions[i] += 1
            if slot.fed < len(req.prompt) - 1:
                slot.fed += 1  # still prefilling; ignore the logits
                continue
            if slot.fed == len(req.prompt) - 1:
                slot.fed += 1  # prompt complete: this step's logits are
                # the first generation position
            req.output.append(int(next_tok[i]))
            if (len(req.output) >= req.max_new_tokens or
                    (req.eos_id is not None and
                     req.output[-1] == req.eos_id)):
                req.done = True
                self.completed.append(req)
                slot.request = None
        return True

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until every submitted request completes."""
        for _ in range(max_steps):
            if not self.step() and not any(
                    not s.free for s in self.slots):
                break
        return self.completed

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        return sum(not s.free for s in self.slots) / self.max_slots
