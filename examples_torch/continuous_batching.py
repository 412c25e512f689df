"""Serving example #2: continuous batching with the ServingEngine (the
PyTorch port's copy of `examples/continuous_batching.py`).

Requests of different lengths arrive over time; freed slots are reused
mid-flight; every request decodes EXACTLY what it would have decoded
alone (the engine's core invariant, see tests/test_torch_serving.py).
On the card the engine captures its decode step once as a CUDA graph,
with the hand-written `decode_attention` kernel inside it, and replays
it every step. Weights are drawn from a CPU generator seeded 0 and moved
to the device. Without a card the script raises unless ``--device``
names another device.

    PYTHONPATH=src python examples_torch/continuous_batching.py \
        [--arch yi-9b] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import tree_map
from repro_torch.models import transformer as tf
from repro_torch.serving import Request, ServingEngine

WORKLOAD = (([5, 9, 2], 8), ([1, 2, 3, 4, 5, 6], 4), ([7, 7], 12),
            ([3, 1, 4, 1, 5, 9, 2, 6], 6), ([8], 10))


def main(argv=None, params=None) -> dict:
    """``params``: the model's weights on the CPU (default: `init_params`
    from a CPU generator seeded 0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce(get_config(args.arch))
    if params is None:
        params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params = tree_map(lambda x: x.to(device), params)
    eng = ServingEngine(cfg, params, max_slots=args.slots, max_seq=96,
                        device=device)

    for prompt, new in WORKLOAD:
        eng.submit(Request(prompt=list(prompt), max_new_tokens=new))

    t0 = time.time()
    steps = 0
    while eng.step() or any(not s.free for s in eng.slots):
        steps += 1
        if steps % 5 == 0:
            print(f"step {steps:3d}  utilization {eng.utilization():.2f}  "
                  f"queued {len(eng.queue)}  done {len(eng.completed)}")
        if steps > 500:
            break
    dt = time.time() - t0

    label = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else device.type.upper())
    print(f"\n{len(eng.completed)} requests in {steps} engine steps "
          f"({dt:.1f}s on {label})")
    done = sorted(eng.completed, key=lambda r: r.rid)
    for r in done:
        print(f"  req{r.rid}: prompt={r.prompt} -> {r.output}")
    return {"engine": eng, "steps": steps,
            "outputs": [r.output for r in done]}


if __name__ == "__main__":
    main()
