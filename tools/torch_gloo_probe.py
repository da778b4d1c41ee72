"""Which functional collectives work over ``gloo`` on CUDA tensors in
this PyTorch build: the transport question of ``chip_smoke.py``'s phase
8i, whose two processes share one card over a gloo group.

Each op runs in a pair of processes of its own (a crash ends only its
pair), on a (3, 4) float32 tensor on ``--device``, as DTensor and the
port issue it: the ``_c10d_functional`` op (``_dtensor`` for DTensor's
all-to-all) followed by ``wait_tensor`` and a synchronize.  Each rank
reports the values against the answer computed on the host and the work
registry's size after the wait (0: every work was waited for, nothing
left for the exit's "unwaited collective" warning).  One JSON line an
op: {"op", "verdict": "ok" | "wrong values" | "unwaited" | "crashed" |
"timed out", "ranks": [...]}; the exit code is 0 whatever the verdicts.

    python3 tools/torch_gloo_probe.py                # the card
    python3 tools/torch_gloo_probe.py --device cpu   # host tensors
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import tempfile
import time

OPS = ("all_reduce", "all_reduce_", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "shard_dim_alltoall")


def _issue(op: str, x, group: str):
    """(the op's result, waited for; the answer from both ranks' inputs,
    rank r's ``arange(12) + 100 * r`` as (3, 4), on the host)."""
    import torch
    c10d = torch.ops._c10d_functional
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    xs = [base, base + 100]
    if op == "all_reduce":
        y, want = c10d.all_reduce(x, "sum", group), xs[0] + xs[1]
    elif op == "all_reduce_":
        y, want = c10d.all_reduce_(x, "sum", group), xs[0] + xs[1]
    elif op == "all_gather_into_tensor":
        y, want = c10d.all_gather_into_tensor(x, 2, group), torch.cat(xs)
    elif op == "reduce_scatter_tensor":
        y = c10d.reduce_scatter_tensor(x.reshape(4, 3), "sum", 2, group)
        want = (xs[0] + xs[1]).reshape(4, 3)
    elif op == "all_to_all_single":
        y = c10d.all_to_all_single(x.reshape(4, 3), [2, 2], [2, 2], group)
        want = [t.reshape(4, 3) for t in xs]
    else:   # DTensor's Shard(0) -> Shard(1) of a (4, 6) tensor
        y = torch.ops._dtensor.shard_dim_alltoall(
            x.reshape(2, 6), 0, 1, group)
        want = [t.reshape(2, 6) for t in xs]
    y = c10d.wait_tensor(y)
    return y, want


def _rank(op: str, rank: int, store: str, device: str, q) -> None:
    import torch
    import torch.distributed as dist
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=30))
        group = dist.group.WORLD.group_name
        x = (torch.arange(12, dtype=torch.float32) + 100 * rank).reshape(
            3, 4).to(device)
        y, want = _issue(op, x, group)
        if device == "cuda":
            torch.cuda.synchronize()
        got = y.cpu()
        if isinstance(want, list):   # a rank's part of the exchange
            if op == "all_to_all_single":
                want = torch.cat([want[0][2 * rank:2 * rank + 2],
                                  want[1][2 * rank:2 * rank + 2]])
            else:
                want = torch.cat([want[0][:, 3 * rank:3 * rank + 3],
                                  want[1][:, 3 * rank:3 * rank + 3]])
        elif op == "reduce_scatter_tensor":
            want = want[2 * rank:2 * rank + 2]
        registry = torch._C._distributed_c10d._get_work_registry_size()
        q.put((rank, bool(torch.equal(got, want)), registry))
        dist.destroy_process_group()
    except BaseException as e:   # reported, not raised: the pair goes on
        q.put((rank, f"{type(e).__name__}: {str(e)[:200]}", None))


def probe(op: str, device: str, timeout: float) -> dict:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(
            op, r, os.path.join(tmp, "store"), device, q)) for r in (0, 1)]
        for p in procs:
            p.start()
        ranks, deadline = {}, time.monotonic() + timeout
        while len(ranks) < 2 and time.monotonic() < deadline:
            try:
                r, equal, registry = q.get(timeout=1)
                ranks[r] = {"equal": equal, "registry": registry}
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and q.empty():
                    break           # both gone without a word
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
    if len(ranks) < 2:
        verdict = "crashed" if any(c and c < 0 for c in codes) \
            else "timed out"
    elif not all(v["equal"] is True for v in ranks.values()):
        verdict = "wrong values"
    elif any(v["registry"] for v in ranks.values()):
        verdict = "unwaited"
    else:
        verdict = "ok"
    return {"op": op, "device": device, "verdict": verdict,
            "ranks": [ranks.get(r) for r in (0, 1)], "exit_codes": codes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds to wait for an op's pair")
    ap.add_argument("--op", action="append", choices=OPS,
                    help="an op (repeatable; default: all)")
    args = ap.parse_args(argv)
    for op in args.op or OPS:
        print(json.dumps(probe(op, args.device, args.timeout)), flush=True)


if __name__ == "__main__":
    main()
