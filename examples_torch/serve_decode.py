"""Serving example: batched greedy decode with a reduced assigned arch —
exercises the same decode step the serving engine captures, including
sliding-window ring-buffer KV caches (gemma3) and SSM recurrent states
(mamba2/zamba2). The PyTorch port's copy of `examples/serve_decode.py`.

On the card every attention layer's step against its cache launches the
hand-written `decode_attention` kernel (``impl="kernel"``); on the CPU
the same call takes the kernel's plain version. Weights are drawn from a
CPU generator seeded 0 and moved to the device, so card and host runs
start from the same model. Without a card the script raises unless
``--device`` names another device.

    PYTHONPATH=src python examples_torch/serve_decode.py [--arch gemma3-27b] \
        [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import tree_map
from repro_torch.models import transformer as tf


def main(argv=None, params=None) -> dict:
    """``params``: the model's weights on the CPU (default: `init_params`
    from a CPU generator seeded 0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce(get_config(args.arch))
    if params is None:
        params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params = tree_map(lambda x: x.to(device), params)
    state = tf.init_decode_state(cfg, args.batch, max_seq=64,
                                 dtype=torch.float32, device=device)

    tok = torch.zeros((args.batch, 1), dtype=torch.int64, device=device)
    outs, logits_seen = [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    for _ in range(args.steps):
        logits, state = tf.decode_step(params, cfg, tok, state, impl="kernel")
        tok = torch.argmax(logits[:, -1:], -1)
        outs.append(tok[:, 0])
        logits_seen.append(logits[:, -1])
    seqs = torch.stack(outs, dim=1).cpu()
    dt = time.time() - t0
    label = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else device.type.upper())
    print(f"arch={cfg.name} family={cfg.family}")
    print(f"decoded {args.steps} steps x batch {args.batch} "
          f"in {dt:.2f}s ({args.steps * args.batch / dt:.1f} tok/s on "
          f"{label})")
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {list(map(int, seqs[b][:16]))}")
    return {"cfg": cfg, "tokens": seqs,
            "logits": torch.stack(logits_seen).cpu()}


if __name__ == "__main__":
    main()
