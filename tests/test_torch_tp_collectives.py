"""The port's mesh collectives: ``sharding.redistribute`` against DTensor's
own ``redistribute``, and tensor-parallel serving that never reaches
torch's functional collectives.

DTensor's redistribution goes through ``torch.distributed.
_functional_collectives``, whose all-gather kills a gloo rank holding CUDA
tensors (``repro_torch.launch.collective_probe`` on the card).  So the
port moves its DTensors itself, with c10d's in-place collectives, on every
backend and device; these tests run that same path on gloo over the CPU.

Four gloo processes form a data 2 x model 2 mesh (the harness of
``tests/test_torch_serve_mesh.py``):
- every transition the rules use (and a few more), in f32 and bf16: the
  forward byte-exact against DTensor's (integer-valued inputs, so that a
  sum is exact in any order), the backward's gradient on the same
  placements with the same values, and no functional-collective call in
  either;
- reduced qwen2-7b, gemma2-9b, recurrentgemma-2b, mixtral-8x7b and
  mamba2-780m under ``serve_rules_for(cfg, "decode_32k")`` (heads, MLP and
  vocab over "model", the caches' "kv_seq" too), a prefill of 12 tokens
  and 4 decode steps on weights drawn from a seed: no call into the
  functional collectives (a wrapper over that module's functions in each
  rank), c10d collectives issued, and, but for the MoE model (each data
  half routes on its own on a mesh), the logits within 2e-5 (f32) of the
  largest of rank 0's unsharded run."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding as S
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models.layers import (tree_flatten, tree_leaves, tree_map,
                                       tree_unflatten)
from test_torch_serve_mesh import _free_port, _rel

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 300
SHAPE = (8, 12)
# (source, target) placements on the (data, model) mesh: S<d> a shard of
# dim d, R replicated, P a partial sum, Pmax a partial max
TRANSITIONS = [
    ("S0,S1", "S0,R"), ("S0,R", "R,R"), ("S0,S0", "R,R"),
    ("S0,S0", "R,S0"), ("S0,S0", "S0,R"), ("R,S1", "R,S0"),
    ("S1,R", "R,S1"), ("R,P", "R,R"), ("P,P", "R,R"), ("R,P", "R,S1"),
    ("S0,P", "S0,S1"), ("P,R", "S0,R"), ("R,R", "S0,S1"),
    ("R,Pmax", "R,R"),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ARCHS = ["qwen2-7b", "gemma2-9b", "recurrentgemma-2b", "mixtral-8x7b",
         "mamba2-780m"]
BATCH, PROMPT, CACHE, STEPS = 4, 12, 16, 4
TOL = 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case in WORLD processes; each rank's results.  The processes
    are killed at the timeout or a failure."""
    workdir = tmp_path_factory.mktemp("tp_collectives")
    port = _free_port()
    code = ("import sys; sys.path[:0] = [%r, %r]; import "
            "test_torch_tp_collectives as t; t._worker(%r)"
            % (str(TESTS), str(SRC), str(workdir)))
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(SRC),
                   REPRO_COORDINATOR=f"127.0.0.1:{port}",
                   REPRO_NUM_PROCESSES=str(WORLD),
                   REPRO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    except BaseException as e:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        if isinstance(e, subprocess.TimeoutExpired):
            pytest.fail(f"mesh did not finish in {GROUP_TIMEOUT_S} s")
        raise
    bad = [(r, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"mesh failed: {bad}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _placements(text: str) -> list:
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for p in text.split(","):
        out.append(Replicate() if p == "R" else Partial("max")
                   if p == "Pmax" else Partial() if p == "P"
                   else Shard(int(p[1:])))
    return out


def _local(placements, mesh, dtype, seed: int) -> torch.Tensor:
    """This rank's block of a tensor of SHAPE on ``placements``: integer
    values, distinct on every rank where a placement is partial."""
    from torch.distributed.tensor import distribute_tensor
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.integers(-16, 16, SHAPE).astype(np.float32))
    even = [pl if not pl.is_partial() else
            _placements("R")[0] for pl in placements]
    local = distribute_tensor(full, mesh, even, src_data_rank=None).to_local()
    if any(pl.is_partial() for pl in placements):
        local = local + torch.distributed.get_rank() * 3
    return local.to(dtype)


def _transition(src, dst, dtype, mesh) -> dict:
    """Forward and backward of one transition, through the port's
    ``redistribute`` and through DTensor's: each side's local result,
    placements and gradient, and the port's functional-collective calls."""
    from torch.distributed.tensor import DTensor
    src_pl, dst_pl = _placements(src), _placements(dst)
    out = {}
    for side in ("port", "dtensor"):
        x = DTensor.from_local(_local(src_pl, mesh, dtype, 1), mesh, src_pl,
                               run_check=False).requires_grad_(True)
        # the gradient arrives on the target's placements, a partial sum
        # where the target is replicated (but over a partial max, which
        # DTensor's backward cannot take a partial sum back to)
        gpl = [_placements("P")[0] if b.is_replicate() and not (
            a.is_partial() and a.reduce_op != "sum") else b
            for a, b in zip(src_pl, dst_pl)]
        g = DTensor.from_local(_local(gpl, mesh, dtype, 2), mesh, gpl,
                               run_check=False)
        with S.CollectiveCount() as count:
            y = S.redistribute(x, dst_pl) if side == "port" \
                else x.redistribute(mesh, dst_pl)
            (gx,) = torch.autograd.grad(y, x, grad_outputs=g)
        out[side] = {"local": y.to_local().detach().clone(),
                     "placements": tuple(y.placements),
                     "grad": gx.to_local().clone(),
                     "grad_placements": tuple(gx.placements),
                     "functional": count.functional,
                     "c10d": sum(count.counts.values())}
    return out


def _serve(arch: str, mesh) -> dict:
    """Prefill and STEPS decode steps of reduced ``arch`` on the mesh in
    f32, counting every collective; rank 0 also runs them unsharded."""
    cfg = reduced(get_config(arch))
    rules = S.serve_rules_for(cfg, "decode_32k")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32))

    def f32(tree):
        return tree_map(lambda x: x.float() if x.is_floating_point()
                        else x, tree)

    def steps(params, caches, place):
        out = []
        with torch.no_grad():
            lg, caches = M.prefill(cfg, params, {"tokens": place(
                toks[:, :PROMPT], ("batch", "seq"))}, caches)
            out.append(lg)
            for i in range(STEPS):
                pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32)
                lg, caches = M.decode_step(
                    cfg, params, place(toks[:, PROMPT + i:PROMPT + i + 1],
                                       ("batch", None)),
                    place(pos, ("batch",)), caches)
                out.append(lg)
        return torch.stack([S.full_tensor(x) for x in out]), caches

    def place(x, axes):
        return S.distribute(x, S.named_sharding(axes, tuple(x.shape), mesh,
                                                rules))
    params = M.init_params(cfg, 0, device="cpu", mesh=mesh, rules=rules)
    params = f32(params)
    csh = M.cache_shardings(cfg, BATCH, CACHE, mesh, rules)
    leaves, treedef = tree_flatten(f32(M.init_caches(cfg, BATCH, CACHE,
                                                     device="cpu")))
    caches = tree_unflatten(treedef, [S.distribute(x, sh) for x, sh in zip(
        leaves, tree_leaves(csh), strict=True)])
    with S.CollectiveCount() as count, S.sharding_ctx(mesh, rules):
        logits, caches = steps(params, caches, place)
    res = {"logits": logits, "functional": count.functional,
           "counts": count.counts,
           "weights_split": [tuple(sh.spec) for sh in tree_leaves(
               M.param_shardings(cfg, mesh, rules))]}
    if torch.distributed.get_rank() == 0 and not cfg.num_experts:
        plain, _ = steps(f32(M.init_params(cfg, 0, device="cpu")),
                         f32(M.init_caches(cfg, BATCH, CACHE, device="cpu")),
                         lambda x, axes: x)
        res["plain"] = plain
    return res


def _worker(workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.distributed import initialize
    torch.set_num_threads(1)
    rank, _ = initialize(device="cpu")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {("transition", src, dst, name): _transition(src, dst, dt, mesh)
           for src, dst in TRANSITIONS for name, dt in DTYPES.items()}
    res.update({("serve", arch): _serve(arch, mesh) for arch in ARCHS})
    torch.save(res, Path(workdir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("src,dst", TRANSITIONS)
def test_redistribute_equals_dtensor(src, dst, dtype, ranks):
    """Forward byte-exact, the gradient on DTensor's placements with its
    values, on every rank; the port's side calls no functional
    collective and, where a mesh dim moves, issues c10d ones."""
    for rank, res in enumerate(ranks):
        r = res["transition", src, dst, dtype]
        port, ref = r["port"], r["dtensor"]
        assert port["placements"] == ref["placements"], rank
        assert port["local"].dtype == ref["local"].dtype
        assert torch.equal(port["local"], ref["local"]), rank
        assert port["grad_placements"] == ref["grad_placements"], rank
        assert torch.equal(port["grad"], ref["grad"]), rank
        assert port["functional"] == {}, (rank, port["functional"])
        assert port["c10d"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_serving_takes_no_functional_collective(arch,
                                                                ranks):
    """Weights split over "model" under the serving rules; no rank
    reaches torch's functional collectives, every rank issues c10d
    all-gathers and all-reduces, and the logits match the unsharded run
    (but for the MoE model, see the module's docstring)."""
    cfg = reduced(get_config(arch))
    for rank, res in enumerate(ranks):
        r = res["serve", arch]
        assert r["functional"] == {}, (rank, r["functional"])
        assert r["counts"]["all-reduce"] > 0, r["counts"]
        assert torch.isfinite(r["logits"]).all()
        assert r["logits"].shape == (STEPS + 1, BATCH,
                                     r["logits"].shape[-1])
        assert any("model" in S.entry_axes(e) for spec in
                   r["weights_split"] for e in spec), arch
    if not cfg.num_experts:
        got, want = ranks[0]["serve", arch]["logits"], \
            ranks[0]["serve", arch]["plain"]
        assert _rel(got, want) < TOL, _rel(got, want)
        for res in ranks[1:]:
            assert torch.equal(res["serve", arch]["logits"], got)


# the probe's cases that the port's path and F5's cause rest on; each runs
# in its own pair of gloo processes on the CPU here (on a card
# ``funcol_all_gather`` and ``dtensor_shard1_to_replicate`` die)
PROBE_CASES = ["c10d_all_gather_into_tensor", "c10d_all_reduce",
               "c10d_reduce_scatter_tensor", "funcol_all_gather",
               "dtensor_shard1_to_replicate",
               "port_redistribute_shard1_to_replicate",
               "port_redistribute_partial_to_replicate",
               "port_redistribute_partial_to_shard0"]


@pytest.fixture(scope="module")
def probed():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import collective_probe
    with ThreadPoolExecutor(collective_probe.PARALLEL) as pool:
        return dict(zip(PROBE_CASES, pool.map(
            lambda c: collective_probe.run_case(c, "cpu"), PROBE_CASES)))


@pytest.mark.parametrize("case", PROBE_CASES)
def test_collective_probe_case_runs_on_the_cpu(case, probed):
    """``launch/collective_probe.py`` runs each case in a fresh world of
    two ranks and reports both exit codes and rank 0's check."""
    rec = probed[case]
    assert rec["case"] == case and rec["device"] == "cpu"
    assert rec["exit_codes"] == [0, 0], rec["rank0_tail"]
    assert rec["right"] is True
