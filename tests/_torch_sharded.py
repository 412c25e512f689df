"""Shared set-up of the sharded-program tests (`test_torch_sharded_*.py`):
one architecture's reduced config, cut to one layer, on a (2, 2)
("data", "model") mesh of 4 gloo processes on the CPU against the same
steps unsharded (in rank 0) and against the reference's steps
(`repro.launch.steps`, jitted), all from the reference's parameters
(`params_from_reference`).

What is held, per architecture, in fp32:
  * prefill logits (impl "chunked") within 1e-5 relative L2 of both;
  * one train step (AdamW 1e-4, chunked, remat): the loss within 1e-5
    relative of both; the gathered parameters within 1e-5 relative L2 of
    both (all leaves as one vector; the step itself moves them by 2.5e-4
    to 1.6e-3 of their norm), each leaf within 1e-4 of its own norm of
    the unsharded step's (a zero-initialised leaf, mamba2's dt_bias, is
    the update alone, and AdamW's first step turns the last bits of a
    gradient near 0, summed in another order across ranks, into a few
    percent of that entry's step), and within the port's own tolerance
    of the reference's (rtol / atol 5e-4, `test_torch_train_step.py`'s:
    the port and XLA round differently); the update itself (parameters
    after less before) of each leaf within 5e-3 relative L2 of both
    steps' updates (the same AdamW effect: up to 1.7e-3 between the
    unsharded port and the reference at yi-9b's MLP; a step that
    applied no update is 1 off);
  * decode, 2 teacher-forced then 2 greedy tokens from empty caches:
    the same tokens as both, logits within 1e-5 relative L2 of the
    unsharded step's; optionally also on the sequence-sharded cache
    layout (kv_seq_shard: flash decoding over "model"), where the kernel
    route must refuse.

The processes run with a deadline: a hang fails the test instead of
holding up the suite. The reference runs in the test's own process
meanwhile.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.models import transformer as ptf

WORLD = 4
DEADLINE_S = 300
LAYERS = 1
B, S, DECODE_LEN, PROMPT, GREEDY = 4, 32, 16, 2, 2
LOGITS_RTOL = 1e-5
LR = 1e-4
LEAF_RTOL = 1e-4
REF_TOL = 5e-4
UPDATE_RTOL = 5e-3


def _batch(vocab: int, seed: int = 1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _decode(step, params, state, prompt, put):
    """PROMPT teacher-forced then GREEDY greedy tokens: (tokens, logits)."""
    toks, logits = [], []
    tok = prompt[:, :1]
    for t in range(PROMPT + GREEDY):
        lg, state = step(params, put(tok), state)
        lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        logits.append(lg[:, -1])
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        toks.append(nxt)
        tok = prompt[:, t + 1:t + 2] if t + 1 < PROMPT else nxt
    return torch.cat(toks, 1), torch.stack(logits)


def _cfg(configs, arch):
    """The reduced config cut to LAYERS layers (either package's)."""
    return dataclasses.replace(configs.reduce(configs.get_config(arch)),
                               num_layers=LAYERS)


def _worker(rank, port, tmp, arch, seq_layouts):
    """Every rank runs the sharded steps; rank 0 also the unsharded ones,
    and saves both."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import shard_ctx
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
        P = sh.P
        cfg = _cfg(configs, arch)
        params = torch.load(f"{tmp}/{arch}.pt")
        batch = {k: torch.from_numpy(v) for k, v in
                 _batch(cfg.vocab_size).items()}
        dparams = sh.shard_tree(params, mesh,
                                sh.param_specs(cfg, params, mesh=mesh))
        dbatch = {k: sh.shard_of(v, mesh, P("data", None))
                  for k, v in batch.items()}

        def put(t):
            return sh.shard_of(t, mesh, P("data", None))

        res = {}
        with implicit_replication():
            shard_ctx.set_specs(act=P("data", None, None),
                                channels=P("data", None, "model"),
                                heads=P("data", None, "model", None),
                                mesh=mesh)
            prefill = make_prefill_step(cfg, impl="chunked")
            got = prefill(dparams, {"tokens": dbatch["tokens"]})
            res["prefill"] = (got.full_tensor(), rank == 0 and prefill(
                params, {"tokens": batch["tokens"]}))
            opt = adamw(LR)
            train = make_train_step(cfg, opt)
            l1, p1, _ = train(dparams, opt.init(dparams), dbatch)
            res["train"] = ((l1.full_tensor(), sh.gather_tree(p1)),
                            rank == 0 and train(params, opt.init(params),
                                                batch)[:2])
            shard_ctx.clear()  # decode runs without anchors
            step = make_serve_step(cfg, impl="chunked")
            for kv_seq in (False, True) if seq_layouts else (False,):
                def state():
                    return ptf.init_decode_state(cfg, B, DECODE_LEN,
                                                 dtype=torch.float32,
                                                 device="cpu")
                specs = sh.decode_cache_specs(
                    cfg, state(), batch=B, multi_pod=False, mesh=mesh,
                    kv_seq_shard=kv_seq)
                res[f"decode/{kv_seq}"] = (
                    _decode(step, dparams, sh.shard_tree(state(), mesh,
                                                         specs),
                            batch["tokens"], put),
                    rank == 0 and _decode(step, params, state(),
                                          batch["tokens"], lambda t: t))
                if kv_seq:
                    try:
                        make_serve_step(cfg, impl="kernel")(
                            dparams, put(batch["tokens"][:, :1]),
                            sh.shard_tree(state(), mesh, specs))
                        res["kernel_refused"] = ""
                    except ValueError as e:
                        res["kernel_refused"] = str(e)
        if rank == 0:
            torch.save(res, f"{tmp}/results.pt")
    finally:
        shard_ctx.clear()
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference(arch, rparams):
    """The reference's prefill logits, train step and decode on rparams."""
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import optim as roptim
    from repro.launch import steps as rsteps
    from repro.models import transformer as rtf

    cfg = _cfg(rconfigs, arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
    out = {"init": jax.device_get(rparams), "prefill": np.asarray(jax.jit(rsteps.make_prefill_step(cfg))(
        rparams, {"tokens": batch["tokens"]}))}
    opt = roptim.adamw(LR)
    loss, params, _ = jax.jit(rsteps.make_train_step(cfg, opt))(
        rparams, opt.init(rparams), batch)
    out["train"] = (float(loss), jax.device_get(params))
    step = jax.jit(rsteps.make_serve_step(cfg))
    state = rtf.init_decode_state(cfg, B, DECODE_LEN, dtype=jnp.float32)
    tok, toks = batch["tokens"][:, :1], []
    for t in range(PROMPT + GREEDY):
        lg, state = step(rparams, tok, state)
        nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(nxt))
        tok = batch["tokens"][:, t + 1:t + 2] if t + 1 < PROMPT else nxt
    out["decode"] = np.concatenate(toks, 1)
    return out


def run(tmp, arch: str, seed: int, seq_layouts: bool = False):
    """(the rank-0 results, the reference's) for one architecture."""
    import jax

    from repro import configs as rconfigs
    from repro.models import transformer as rtf

    cfg = _cfg(rconfigs, arch)
    rparams = rtf.init_params(cfg, jax.random.PRNGKey(seed))
    torch.save(ptf.params_from_reference(jax.device_get(rparams)),
               tmp / f"{arch}.pt")
    ctx = mp.start_processes(
        _worker, args=(_free_port(), str(tmp), arch, seq_layouts),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        ref = _reference(arch, rparams)
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the sharded runs did not finish in "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(tmp / "results.pt"), ref


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got)).double()
    want = torch.as_tensor(np.array(want)).double()
    return float((got - want).norm() / want.norm())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, torch.as_tensor(np.asarray(tree))


def check_prefill(got, ref):
    sharded, plain = got["prefill"]
    assert _rel(sharded, plain) <= LOGITS_RTOL
    assert _rel(sharded, ref["prefill"]) <= LOGITS_RTOL


def check_train(got, ref):
    (l1, p1), (l0, p0) = got["train"]
    rloss, rparams = ref["train"]
    assert abs(float(l1) - float(l0)) <= LOGITS_RTOL * abs(float(l0))
    assert abs(float(l1) - rloss) <= LOGITS_RTOL * abs(rloss)
    flat = [torch.cat([x.flatten().float() for _, x in _leaves(t)])
            for t in (p1, p0, rparams)]
    assert _rel(flat[0], flat[1]) <= LOGITS_RTOL
    assert _rel(flat[0], flat[2]) <= LOGITS_RTOL
    for (name, a), (_, b), (_, r), (_, i) in zip(
            _leaves(p1), _leaves(p0), _leaves(rparams), _leaves(ref["init"])):
        assert _rel(a, b) <= LEAF_RTOL, name
        np.testing.assert_allclose(a.numpy(), r.float().numpy(),
                                   rtol=REF_TOL, atol=REF_TOL, err_msg=name)
        i = i.double()
        assert _rel(a.double() - i, b.double() - i) <= UPDATE_RTOL, name
        assert _rel(a.double() - i, r.double() - i) <= UPDATE_RTOL, name


def check_decode(got, ref, seq_sharded: bool = False):
    (toks, logits), (ptoks, plogits) = got[f"decode/{seq_sharded}"]
    assert torch.equal(toks, ptoks)
    assert np.array_equal(toks.numpy(), ref["decode"])
    assert _rel(logits, plogits) <= LOGITS_RTOL
    if seq_sharded:
        msg = got["kernel_refused"]
        assert "shards the sequence" in msg and "model" in msg
