"""Which of torch's collective paths run on two gloo ranks of one device.

Each case runs in a fresh world of two processes on one gloo group, both
on ``--device`` (on the card both ranks share ``cuda:0``, as
``chip_smoke.py``'s worlds do), with a ``(1, 2)`` ``DeviceMesh`` named
("data", "model") where the case needs one.  A case that kills its rank
(a segmentation fault is exit -11) takes only its own world down.  Rank
0 checks the result against the value it must have.  One JSON line per
case: the ranks' exit codes, whether the result was right, and the last
lines of rank 0's output (``-X faulthandler`` prints the Python frame a
fatal signal hit).

    python -m repro_torch.launch.collective_probe [--device cpu] [--cases a,b]

Exit code 0 when every case ran on both ranks and was right.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import torch
import torch.distributed as dist

WORLD = 2
TIMEOUT_S = 120
PARALLEL = 4                  # worlds at a time
# case -> what it runs; ``_run_case`` reads the name's parts
CASES = (
    "c10d_all_gather_into_tensor",
    "c10d_all_reduce",
    "c10d_reduce_scatter_tensor",
    "funcol_all_gather",
    "funcol_all_gather_no_wait",
    "funcol_all_gather_mesh_group",
    "funcol_all_gather_noncontiguous",
    "funcol_all_gather_no_set_device",
    "funcol_all_gather_side_stream",
    "funcol_all_reduce",
    "funcol_reduce_scatter",
    "dtensor_shard0_to_replicate",
    "dtensor_shard1_to_replicate",
    "dtensor_partial_to_replicate",
    "dtensor_full_tensor",
    "port_redistribute_shard1_to_replicate",
    "port_redistribute_partial_to_replicate",
    "port_redistribute_partial_to_shard0",
)


def _value(rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s (4, 6) operand: distinct values on every rank."""
    return (torch.arange(24, dtype=torch.float32, device=device)
            .reshape(4, 6) + 100 * rank)


def _run_case(case: str, rank: int, device: str) -> bool:
    """Run ``case`` on this rank; True when the result is right."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = _value(rank, device)
    parts = [_value(r, device) for r in range(WORLD)]
    gathered, total = torch.cat(parts), sum(parts)
    group = dist.group.WORLD
    if "mesh" in case or case.startswith(("dtensor", "port")):
        mesh = init_device_mesh(device, (1, WORLD),
                                mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
    if case == "c10d_all_gather_into_tensor":
        out = torch.empty_like(gathered)
        dist.all_gather_into_tensor(out, x, group=group)
        return torch.equal(out, gathered)
    if case == "c10d_all_reduce":
        dist.all_reduce(x, group=group)
        return torch.equal(x, total)
    if case == "c10d_reduce_scatter_tensor":
        out = torch.empty(2, 6, device=device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return torch.equal(out, total[2 * rank:2 * rank + 2])
    if case.startswith("funcol_all_gather"):
        if case.endswith("noncontiguous"):       # every other column
            x = x[:, ::2]
            gathered = torch.cat([p[:, ::2] for p in parts])
            assert not x.is_contiguous()
        stream = torch.cuda.Stream() if case.endswith("side_stream") \
            and device == "cuda" else None
        with torch.cuda.stream(stream) if stream else nullcontext():
            out = funcol.all_gather_tensor(x, 0, group)
            if not case.endswith("no_wait"):
                out = funcol.wait_tensor(out)
            out = out + 0
        return torch.equal(out, gathered)
    if case == "funcol_all_reduce":
        return torch.equal(funcol.wait_tensor(
            funcol.all_reduce(x, "sum", group)), total)
    if case == "funcol_reduce_scatter":
        return torch.equal(funcol.wait_tensor(funcol.reduce_scatter_tensor(
            x, "sum", 0, group)), total[2 * rank:2 * rank + 2])
    rep = [Replicate(), Replicate()]
    if case == "dtensor_shard0_to_replicate":
        d = DTensor.from_local(x, mesh, [Replicate(), Shard(0)])
        return torch.equal(d.redistribute(mesh, rep).to_local(), gathered)
    if case == "dtensor_shard1_to_replicate":
        d = DTensor.from_local(x, mesh, [Replicate(), Shard(1)])
        return torch.equal(d.redistribute(mesh, rep).to_local(),
                           torch.cat(parts, 1))
    if case == "dtensor_partial_to_replicate":
        d = DTensor.from_local(x, mesh, [Replicate(), Partial()])
        return torch.equal(d.redistribute(mesh, rep).to_local(), total)
    if case == "dtensor_full_tensor":
        d = DTensor.from_local(x, mesh, [Replicate(), Shard(0)])
        return torch.equal(d.full_tensor(), gathered)
    from repro_torch import sharding as S
    if case == "port_redistribute_shard1_to_replicate":
        d = DTensor.from_local(x, mesh, [Replicate(), Shard(1)])
        return torch.equal(S.redistribute(d, rep).to_local(),
                           torch.cat(parts, 1))
    if case == "port_redistribute_partial_to_replicate":
        d = DTensor.from_local(x, mesh, [Replicate(), Partial()])
        return torch.equal(S.redistribute(d, rep).to_local(), total)
    if case == "port_redistribute_partial_to_shard0":
        d = DTensor.from_local(x, mesh, [Replicate(), Partial()])
        return torch.equal(S.redistribute(d, [Replicate(), Shard(0)])
                           .to_local(), total[2 * rank:2 * rank + 2])
    raise ValueError(f"unknown case {case!r}")


def _rank_main(case: str, rank: int, port: int, device: str,
               out: str) -> None:
    if device == "cuda" and not case.endswith("no_set_device"):
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    print("group up", flush=True)
    ok = _run_case(case, rank, device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"case ran: {ok}", flush=True)
    Path(out).write_text(json.dumps({"ok": bool(ok)}))
    dist.barrier()
    dist.destroy_process_group()


def run_case(case: str, device: str) -> dict:
    """``case`` in a fresh world of WORLD processes; every process is
    killed at the timeout."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parents[2]))
    with tempfile.TemporaryDirectory(prefix="collective_probe") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m",
             "repro_torch.launch.collective_probe", "--rank", str(r),
             "--port", str(port), "--cases", case, "--device", device,
             "--out", f"{tmp}/rank{r}.json"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        try:
            outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        except subprocess.TimeoutExpired:
            outs = [""] * WORLD
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        res = Path(f"{tmp}/rank0.json")
        right = json.loads(res.read_text())["ok"] if res.exists() else None
    return {"case": case, "device": device,
            "exit_codes": [p.returncode for p in procs], "right": right,
            "rank0_tail": outs[0].strip().splitlines()[-12:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.cases, args.rank, args.port, args.device, args.out)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    bad = 0
    cases = args.cases.split(",")
    with ThreadPoolExecutor(PARALLEL) as pool:
        for rec in pool.map(lambda c: run_case(c, args.device), cases):
            bad += rec["exit_codes"] != [0] * WORLD \
                or rec["right"] is not True
            print(json.dumps(rec), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
