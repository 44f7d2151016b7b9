#!/usr/bin/env python3
"""Whether two ranks can share one card over gloo with CUDA tensors.

    python3 tools/probe_torch_gloo_card.py

NCCL refuses two ranks on one card. This starts two processes on the one
card, joins them in a gloo process group (a ``file://`` rendezvous in a
temporary directory) and tries, on CUDA tensors: ``all_reduce`` (SUM and
MAX), ``all_gather``, ``broadcast``, ``barrier`` and the data axis's
autograd gather (``parallel.mesh.DataAxis.gather``) forward and backward,
each checked against the expected values. Prints the card's name and power
limit, one line a collective with its outcome or error, and a JSON summary
last. Exits non-zero without a card or when a collective failed.
"""

import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank, world, tmp):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    results = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            results[name] = "ok"
        except Exception as exc:  # noqa: BLE001 -- the probe reports every refusal
            results[name] = f"{type(exc).__name__}: {exc}".splitlines()[0][:300]
            traceback.print_exc()

    def all_reduce():
        x = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        assert torch.equal(x, torch.full_like(x, 3.0)), x[:4]
        m = torch.full((4,), float(rank), device="cuda")
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        assert torch.equal(m, torch.ones_like(m)), m

    def all_gather():
        x = torch.arange(6.0, device="cuda") + 10 * rank
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert torch.equal(torch.cat(parts), torch.cat([torch.arange(6.0, device="cuda"),
                                                        torch.arange(6.0, device="cuda") + 10]))

    def broadcast():
        x = torch.full((8,), float(rank), device="cuda")
        dist.broadcast(x, src=0)
        assert torch.equal(x, torch.zeros_like(x))

    def gather_autograd():
        from ovmr_tpu_torch.parallel import DataAxis

        axis = DataAxis.from_process_group()
        x = torch.full((3, 4), float(rank + 1), device="cuda", requires_grad=True)
        y = axis.gather([x])
        assert y.shape == (6, 4)
        (y * (rank + 1)).sum().backward()
        assert torch.equal(x.grad, torch.full_like(x, 3.0)), x.grad

    attempt("all_reduce", all_reduce)
    attempt("all_gather", all_gather)
    attempt("broadcast", broadcast)
    attempt("barrier", dist.barrier)
    attempt("gather_autograd", gather_autograd)
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_gloo_card: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(_rank, args=(2, tmp), nprocs=2, join=True)
        except Exception as exc:  # noqa: BLE001
            print(f"spawn failed: {type(exc).__name__}: {exc}")
        ranks = []
        for r in range(2):
            path = f"{tmp}/rank{r}.json"
            ranks.append(json.load(open(path)) if os.path.exists(path) else {"spawn": "failed"})
    for r, res in enumerate(ranks):
        for name, outcome in res.items():
            print(f"rank {r} {name}: {outcome}")
    ok = all(v == "ok" for res in ranks for v in res.values())
    print(json.dumps({"gloo_two_ranks_one_card": ok, "ranks": ranks}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
