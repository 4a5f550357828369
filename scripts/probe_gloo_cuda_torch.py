"""Which ``torch.distributed`` ops the gloo backend takes on CUDA tensors,
and NCCL at a world of one, on card 0 of the machine it runs on.

    python3 scripts/probe_gloo_cuda_torch.py [--out FILE]

Each op runs in a pair of gloo processes of its own sharing card 0 (NCCL
refuses two ranks of one communicator on one card, so gloo is what a card
shared by several ranks runs; a pair of its own, since gloo can end a
process on a device pointer, ``gloo::IoException``, rather than raise).
The pairs run at once.  Each tries one op ``parallel.mesh.ProcessRing``
or ``parallel.tensor_parallel`` calls on bf16 and f32 CUDA tensors and
checks the result against the op's expected value: ``accepted``,
``wrong``, ``refused: <error>`` (it raised) or ``crashed`` (the process
died or hung).  Then one process joins NCCL alone and runs every op.
Prints one JSON line: torch and CUDA versions, the NCCL version, and each
backend's ops.  ``parallel.mesh.ProcessRing`` stages on gloo only the op
this probe finds refused (the point-to-point hop).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

DTYPES = (torch.bfloat16, torch.float32)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


OPS = ("all_reduce", "all_reduce_max", "all_gather_into_tensor",
       "all_gather", "reduce_scatter_tensor", "all_to_all_single",
       "broadcast", "send_recv", "batch_isend_irecv")


def _ops(rank: int, world: int, dev: torch.device, only=None,
         dtypes=DTYPES) -> dict:
    """Every op (or those in ``only``) on each of ``dtypes``: ``accepted``
    (and right), ``wrong`` or ``refused: ...``."""
    out = {}
    peer_next, peer_prev = (rank + 1) % world, (rank - 1) % world

    def attempt(name, fn):
        try:
            ok = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = "accepted" if ok else "wrong"
        except Exception as e:  # noqa: BLE001 — a probe records refusals
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
        if world > 1:
            # resynchronise on host tensors, whatever the op did
            dist.all_reduce(torch.zeros(1))

    for dt in dtypes:
        tag = str(dt).replace("torch.", "")

        def all_reduce():
            t = torch.full((64,), float(rank + 1), dtype=dt, device=dev)
            dist.all_reduce(t)
            return bool((t == sum(range(1, world + 1))).all())

        def all_gather_into_tensor():
            x = torch.full((4, 8), float(rank), dtype=dt, device=dev)
            o = x.new_empty((4 * world, 8))
            dist.all_gather_into_tensor(o, x)
            return bool((o.view(world, 4, 8) == torch.arange(
                world, device=dev, dtype=dt)[:, None, None]).all())

        def all_gather_list():
            x = torch.full((4,), float(rank), dtype=dt, device=dev)
            os_ = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(os_, x)
            return all(bool((o == r).all()) for r, o in enumerate(os_))

        def reduce_scatter_tensor():
            # rank r contributes r + 1 at every element; chunk j of the
            # sum lands on rank j, marked by its index
            x = (torch.arange(world, dtype=dt, device=dev)[:, None]
                 .expand(world, 4) * 0 + float(rank + 1)).contiguous()
            x += torch.arange(world, dtype=dt, device=dev)[:, None]
            o = x.new_empty((4,))
            fn = getattr(dist, "reduce_scatter_single", None) or \
                dist.reduce_scatter_tensor
            fn(o, x.reshape(-1))
            want = sum(range(1, world + 1)) + world * rank
            return bool((o == want).all())

        def all_to_all_single():
            x = torch.arange(world * 2, dtype=dt, device=dev) + 100 * rank
            o = torch.empty_like(x)
            dist.all_to_all_single(o, x)
            want = torch.cat([torch.arange(2 * rank, 2 * rank + 2,
                                           dtype=dt, device=dev) + 100 * r
                              for r in range(world)])
            return bool((o == want).all())

        def broadcast():
            t = torch.full((8,), float(rank + 7), dtype=dt, device=dev)
            dist.broadcast(t, 0)
            return bool((t == 7).all())

        def send_recv():
            if world == 1:
                return True
            x = torch.full((8,), float(rank), dtype=dt, device=dev)
            o = torch.empty_like(x)
            if rank % 2 == 0:
                dist.send(x, peer_next)
                dist.recv(o, peer_prev)
            else:
                dist.recv(o, peer_prev)
                dist.send(x, peer_next)
            return bool((o == peer_prev).all())

        def batch_isend_irecv():
            x = torch.full((8,), float(rank), dtype=dt, device=dev)
            o = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, peer_next),
                   dist.P2POp(dist.irecv, o, peer_prev)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return bool((o == peer_prev).all())

        def all_reduce_max():
            t = torch.full((8,), float(rank), dtype=dt, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return bool((t == world - 1).all())

        for name, fn in (("all_reduce", all_reduce),
                         ("all_reduce_max", all_reduce_max),
                         ("all_gather_into_tensor", all_gather_into_tensor),
                         ("all_gather", all_gather_list),
                         ("reduce_scatter_tensor", reduce_scatter_tensor),
                         ("all_to_all_single", all_to_all_single),
                         ("broadcast", broadcast),
                         ("send_recv", send_recv),
                         ("batch_isend_irecv", batch_isend_irecv)):
            if only is None or name in only:
                attempt(f"{name}/{tag}", fn)
    return out


def _gloo_rank(rank: int, world: int, port: int, op: str, dt: str,
               out: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        torch.cuda.set_device(0)
        got = _ops(rank, world, torch.device("cuda", 0), (op,),
                   (getattr(torch, dt),))
        with open(f"{out}.{rank}", "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


def _gloo_pairs(tmp: str, timeout_s: float = 150.0) -> dict:
    """op/dtype -> outcome, each in a pair of processes of its own."""
    import time
    ctx = torch.multiprocessing.get_context("spawn")
    procs = {}
    for op in OPS:
        for dt in DTYPES:
            key = f"{op}/{str(dt).replace('torch.', '')}"
            port = _port()
            procs[key] = [ctx.Process(
                target=_gloo_rank, args=(r, 2, port, op, key.split("/")[1],
                                         f"{tmp}/{key.replace('/', '.')}"))
                for r in range(2)]
            for p in procs[key]:
                p.start()
    t0 = time.perf_counter()
    for pair in procs.values():
        for p in pair:
            p.join(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    out = {}
    for key, pair in procs.items():
        for p in pair:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        got = []
        for r in range(2):
            try:
                with open(f"{tmp}/{key.replace('/', '.')}.{r}") as f:
                    got.append(json.load(f)[key])
            except (OSError, ValueError, KeyError):
                got.append(None)
        seen = sorted(set(got) - {None})
        out[key] = f"crashed (exit {[p.exitcode for p in pair]})" \
            if None in got else (seen[0] if len(seen) == 1 else seen)
    return out


def _nccl_alone() -> dict:
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(_port()))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    try:
        out = _ops(0, 1, torch.device("cuda", 0))
        out["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gloo_cuda_torch: no CUDA device", file=sys.stderr)
        return 2
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        gloo = _gloo_pairs(tmp)
    row = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "card": torch.cuda.get_device_name(0),
           "gloo_cuda": gloo,
           "nccl_world_1": _nccl_alone()}
    line = json.dumps(row)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
