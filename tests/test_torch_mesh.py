"""Real sharding on the CPU: the port's DTensor layer on a world of four
gloo processes, held against the JAX package's unsharded functions on the
same numpy inputs.

Each case group runs once per module in four fresh processes on a free
loopback port (``initialize`` reads ``REPRO_COORDINATOR``,
``REPRO_NUM_PROCESSES`` and ``REPRO_PROCESS_ID``), under its own timeout:
a hung collective kills the group and fails its tests instead of
stalling the suite.  The processes re-import this file, so JAX is
imported only inside the reference fixtures; the JAX weights reach them
as a JAX checkpoint, which the port restores onto its mesh.  Rank 0
writes the results, and the tests below compare them with JAX.

The train cases step at lr 1e-2 from warmup 1 (``TRAIN_OPT``, as
``tests/test_torch_training.py::test_apply_updates_matches_jax``): each
step moves every weight by about 1e-2, far beyond one bf16 step, so an
update left out, of the wrong sign or on another rank's block shows.

Tolerances, each the bound of the unsharded port's own tests except the
optimizer state's, whose reasons are given:
  * a train step of bf16 models (``tests/test_torch_training.py``): loss
    within 2e-2, grad norm within 5e-2 relative;
  * the optimizer state after the steps, per leaf against the reference's
    by the norm of the difference over the reference's norm: m within
    5e-2 (a sum of gradients, so the gradient bound), v within 1e-1 (a
    sum of squared gradients: twice that); the change of the f32 master
    weights within 0.5: Adam's early steps move each element by about
    lr * sign(g), so an element whose gradient lies within rounding noise
    of zero moves either way (2 lr apart half of the time), and 0.5
    admits that on an eighth of a leaf's elements (sqrt(2 / 8)), while a
    missing update, one of the wrong sign or one on another rank's block
    gives 1, 2 or about 1.4 (bf16 gradients summed over ranks round
    otherwise than one matmul's, so a sharded step sees such noise
    against the unsharded one too); the bf16 params equal to their
    master weights cast;
  * the loss alone on f32 logits (``cross_entropy``,
    ``tests/test_torch_training.py``): within 1e-5 of its value, its
    gradient within 1e-5 of the largest;
  * the MoE FFN in f32 (``tests/test_torch_moe.py``): routing equal
    exactly, outputs and gradients within 2e-5 of the largest;
  * checkpoints and layouts: exact."""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding as S
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import tree_flatten, tree_leaves, tree_map
from repro_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 300
BATCH, SEQ = 8, 16
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1)
M_TOL, V_TOL, UPDATE_TOL = 5e-2, 1e-1, 0.5
# the launcher's own schedule (warmup 100): steps at lr 1e-2 .. 4e-2
LAUNCHER_LR = 1.0
# (name, arch, dp_only, grad_accum, steps)
TRAIN_CASES = [("dp", "tinyllama-1.1b", None, 1, 2),
               ("tp", "tinyllama-1.1b", False, 1, 2),
               ("dp_accum2", "tinyllama-1.1b", None, 2, 2),
               ("tp_accum2", "tinyllama-1.1b", False, 2, 2),
               ("mixtral_tp", "mixtral-8x7b", None, 1, 1),
               ("gemma2_tp", "gemma2-9b", None, 1, 1),
               ("mamba2_tp", "mamba2-780m", False, 1, 1),
               ("rglru_tp", "recurrentgemma-2b", False, 1, 1),
               ("seamless_tp", "seamless-m4t-medium", False, 1, 1),
               ("qwen2vl_tp", "qwen2-vl-72b", False, 1, 1)]
# cases whose weights are f32 (the master weights' values): qwen2-vl's key
# bias, which the softmax nearly ignores (only RoPE's rotation reaches its
# gradient), has a gradient at the level of its own bf16 rounding (the
# unsharded bf16 gradient is 1.2 % of its norm from the f32 one, the
# sharded 1.1 %), so Adam's first update, about lr * sign(g), flips on a
# fifth of its elements whichever bf16 run is the reference
F32_CASES = ("qwen2vl_tp",)
# held to JAX's step; the other archs to the port's unsharded step from the
# same JAX weights (itself held to JAX by tests/test_torch_training.py and
# tests/test_torch_recurrent_grads.py), which keeps the file's JAX
# compilations few
JAX_REF_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b")
MOE_CASES = [("mixtral-8x7b", 1.25), ("mixtral-8x7b", 0.5),
             ("dbrx-132b", 1.25), ("dbrx-132b", 0.5)]
MOE_SHAPE = (4, 12)
# cross_entropy on vocab-sharded logits: (vocab size, final softcap); 500
# is padded to 2048, so the bias of the padded entries is cut per rank
XENT_CASES = [(512, 0.0), (512, 30.0), (500, 0.0), (500, 30.0)]


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _spawn(group: str, workdir: Path) -> dict:
    """Run ``group`` in WORLD processes; kill them all at the timeout."""
    port = _free_port()
    code = ("import sys; sys.path[:0] = [%r, %r]; import test_torch_mesh "
            "as t; t._worker(%r, %r)" % (str(TESTS), str(SRC), group,
                                         str(workdir)))
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
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"mesh group {group!r} did not finish in "
                    f"{GROUP_TIMEOUT_S} s")
    bad = [(r, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"mesh group {group!r} failed: {bad}"
    return torch.load(workdir / f"{group}.pt", weights_only=False)


def _worker(group: str, workdir: str) -> None:
    from repro_torch.launch.distributed import initialize
    torch.set_num_threads(1)
    rank, world = initialize(device="cpu")
    assert (rank, world) == (int(os.environ["REPRO_PROCESS_ID"]), WORLD)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_host_topology
    host = make_host_mesh("cpu")
    out = {"rank_world": (rank, world), "backend": dist.get_backend(),
           "host_mesh": (tuple(host.shape), host.mesh_dim_names),
           "host_devices": make_host_topology(8).n_devices}
    out.update(globals()[f"_group_{group}"](Path(workdir)))
    if rank == 0:
        torch.save(out, Path(workdir) / f"{group}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _full(x):
    return x.full_tensor() if S.is_dtensor(x) else x


def _local_shapes_ok(tree, shardings) -> bool:
    return all(
        S.is_dtensor(x) and x.placements == sh.placements
        and tuple(x.to_local().shape) == sh.shard_shape(tuple(x.shape))
        for x, sh in zip(tree_leaves(tree), tree_leaves(shardings),
                         strict=True))


def _template(cfg):
    from repro_torch.training.optimizer import init_opt_state
    params = M.init_params(cfg, 0, device="cpu")
    return {"params": params, "opt": init_opt_state(params)}


# ---------------------------------------------------------------------------
# Worker groups (run in the four processes)
# ---------------------------------------------------------------------------


def _train_batch(cfg, batch: dict) -> dict:
    """The batch and the inputs a family adds: stub frames for the
    encoder (its "src" axis), stub patches over the first tokens and
    (3, B, S) M-RoPE positions whose sections differ (the patches' grid
    rows and columns) for the VLM."""
    rng = np.random.default_rng(13)
    b, s = batch["tokens"].shape
    out = dict(batch)
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_src_len, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        n = cfg.vision_stub_tokens
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1, :, :n], pos[2, :, :n] = np.arange(n) // 2, np.arange(n) % 2
        out["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32))
        out["positions"] = torch.from_numpy(pos)
    return out


def _batch_to_mesh(batch: dict, mesh, rules) -> dict:
    """``launch/train.py``'s ``batch_to_mesh``, with M-RoPE positions
    (3, B, S) placed on (None, "batch", "seq")."""
    from repro_torch.launch.train import batch_to_mesh
    from repro_torch.sharding import named_sharding
    out = batch_to_mesh({k: v for k, v in batch.items()
                         if k != "positions"}, mesh, rules)
    if "positions" in batch:
        pos = batch["positions"]
        out["positions"] = S.distribute(pos, named_sharding(
            (None, "batch", "seq"), tuple(pos.shape), mesh, rules))
    return out


def _case_state(name: str, state: dict) -> dict:
    """The restored state, its params in f32 for ``F32_CASES``."""
    if name in F32_CASES:
        state["params"] = tree_map(lambda x: x.float(), state["params"])
    return state


def _group_train(workdir: Path) -> dict:
    """Every train case on a data 2 x model 2 mesh: the JAX initial state
    restored onto the mesh's placements, then ``make_train_step`` under
    ``sharding_ctx``; then the checkpoint cases (``_ckpt_cases``)."""
    from repro_torch.launch.train import scalar, state_shardings
    from repro_torch.sharding import sharding_ctx, train_rules_for
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    mesh = _mesh((2, 2))
    b = np.load(workdir / "batch.npz")
    tokens = {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
    out = {}
    for name, arch, dp_only, accum, steps in TRAIN_CASES:
        cfg = reduced(get_config(arch))
        batch = _train_batch(cfg, tokens)
        rules = train_rules_for(cfg, dp_only=dp_only)
        target = state_shardings(cfg, mesh, rules)
        state = _case_state(name, ckpt.restore(
            str(workdir / f"jax_{arch}"), 0, _template(cfg),
            placements=target))
        step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                                  grad_accum=accum)
        master0 = _opt_leaves(state)["master"]
        metrics = []
        grad_errs = _grad_errors(cfg, state, batch, mesh, rules)
        with sharding_ctx(mesh, rules):
            for _ in range(steps):
                state, m = step_fn(state, _batch_to_mesh(batch, mesh, rules))
                metrics.append((scalar(m["loss"]), scalar(m["grad_norm"])))
        shapes_ok = all(_local_shapes_ok(state[k] if k == "params"
                                         else state["opt"][k], target[
                                             "params"])
                        for k in ("params", "master", "m", "v"))
        out[name] = {"metrics": metrics, "shapes_ok": shapes_ok,
                     "rules": rules, "grad_errs": grad_errs,
                     "params": [_full(x) for x in
                                tree_leaves(state["params"])],
                     "master0": master0, "opt": _opt_leaves(state)}
        if arch not in JAX_REF_ARCHS:
            out[name]["plain"] = _plain_run(name, arch, cfg, workdir,
                                            batch, accum, steps)
    out["ckpt"] = _ckpt_cases(workdir)
    out["launcher"] = _launcher_case(workdir)
    out["xent"] = _xent_cases(mesh)
    out["embed"] = _embed_cases(mesh)
    return out


def _opt_leaves(state) -> dict:
    """master, m and v of a train state as full f32 numpy leaves, copied
    (the full value of a replicated leaf is its storage, which the next
    step updates in place)."""
    return {k: [_full(x).float().numpy().copy() for x in
                tree_leaves(state["opt"][k])] for k in ("master", "m", "v")}


def _xent_inputs(vocab: int):
    """f32 logits over the padded vocab and labels below ``vocab``."""
    from repro_torch.models.layers import padded_vocab
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=vocab)
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((BATCH, SEQ, padded_vocab(cfg))) * 4
    labels = rng.integers(0, vocab, size=(BATCH, SEQ))
    return logits.astype(np.float32), labels.astype(np.int32)


def _comm_counts(mode) -> dict:
    return {str(k): v for k, v in mode.get_comm_counts().items()}


def _xent_cases(mesh) -> dict:
    """``cross_entropy`` under the tensor-parallel rules (vocab on
    "model"): the loss, its gradient, and the collectives it ran."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.layers import cross_entropy
    from repro_torch.sharding import (named_sharding, sharding_ctx,
                                      train_rules_for)
    out = {}
    for vocab, cap in XENT_CASES:
        cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                                  vocab_size=vocab, final_logit_softcap=cap)
        rules = train_rules_for(cfg, dp_only=False)
        logits, labels = _xent_inputs(vocab)
        lg = S.distribute(torch.from_numpy(logits), named_sharding(
            ("batch", "seq", "vocab"), logits.shape, mesh, rules))
        lg = lg.detach().requires_grad_()
        lb = S.distribute(torch.from_numpy(labels), named_sharding(
            ("batch", "seq"), labels.shape, mesh, rules))
        with sharding_ctx(mesh, rules), CommDebugMode() as comm:
            loss = cross_entropy(cfg, lg, lb)
        loss = _full(loss)
        grad, = torch.autograd.grad(loss, lg)
        out[vocab, cap] = {"loss": float(loss), "grad": _full(grad),
                           "logits_spec": tuple(lg.placements),
                           "comms": _comm_counts(comm)}
    return out


def _embed_cases(mesh) -> dict:
    """``embed_tokens`` under both rule sets: the embedded rows, their
    local block, and the collectives of the lookup beside those of the
    table's gather alone."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.transformer import embed_tokens
    from repro_torch.sharding import (named_sharding, sharding_ctx,
                                      train_rules_for)
    cfg = reduced(get_config("tinyllama-1.1b"))
    table, toks = _embed_inputs(cfg)
    out = {}
    for kind, dp_only in (("dp", None), ("tp", False)):
        rules = train_rules_for(cfg, dp_only=dp_only)
        tab = S.distribute(torch.from_numpy(table).to(torch.bfloat16),
                           named_sharding(("vocab", "w_embed"), table.shape,
                                          mesh, rules))
        ids = S.distribute(torch.from_numpy(toks), named_sharding(
            ("batch", "seq"), toks.shape, mesh, rules))
        with sharding_ctx(mesh, rules):
            with CommDebugMode() as gather:
                S.shard(tab, None, None)
            with CommDebugMode() as fsdp:
                S.shard(tab, "vocab", None)
            with CommDebugMode() as comm:
                x = embed_tokens(cfg, {"tok": tab}, ids)
        want = named_sharding(("batch", "seq", "embed"),
                              tuple(toks.shape) + (cfg.d_model,), mesh, rules)
        out[kind] = {"x": _full(x), "local": tuple(x.to_local().shape),
                     "shard_shape": want.shard_shape(tuple(x.shape)),
                     "placements_ok": x.placements == want.placements,
                     "gather_comms": _comm_counts(gather),
                     "fsdp_comms": _comm_counts(fsdp),
                     "comms": _comm_counts(comm)}
    return out


def _embed_inputs(cfg):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model))
    toks = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ))
    return table.astype(np.float32), toks.astype(np.int32)


def _launcher_case(workdir: Path) -> dict:
    """``launch/train.py``'s ``train(mesh=...)``: two steps with a
    checkpoint, a resume onto the mesh's placements for two more; rank 0
    also trains the same four steps without a mesh."""
    import torch.distributed as dist

    from repro_torch.launch.train import state_shardings, train
    from repro_torch.sharding import train_rules_for
    mesh = _mesh((2, 2))
    kw = dict(batch=4, seq=16, log_every=100, device="cpu",
              lr=LAUNCHER_LR)
    d = str(workdir / "launcher")
    _, first = train("tinyllama-1.1b", steps=2, ckpt_dir=d, ckpt_every=2,
                     mesh=mesh, **kw)
    dist.barrier()                  # rank 0's checkpoint is committed
    state, rest = train("tinyllama-1.1b", steps=4, ckpt_dir=d,
                        ckpt_every=100, resume=True, mesh=mesh, **kw)
    cfg = reduced(get_config("tinyllama-1.1b"))
    target = state_shardings(cfg, mesh, train_rules_for(cfg))
    plain = train("tinyllama-1.1b", steps=4, **kw) \
        if dist.get_rank() == 0 else (None, None)
    return {"losses": first + rest, "step": int(state["opt"]["step"]),
            "shapes_ok": _local_shapes_ok(state["params"], target["params"]),
            "opt": _opt_leaves(state), "plain": plain[1],
            "plain_opt": plain[0] and _opt_leaves(plain[0])}


def _grad_errors(cfg, state, batch, mesh, rules) -> list[float]:
    """Each leaf's gradient on the mesh against the port's unsharded
    gradient of the same weights and batch, as a share of the latter's
    norm (a gradient summed over too few ranks shows as a large share)."""
    from repro_torch.sharding import sharding_ctx
    from repro_torch.training.train_step import value_and_grad
    with sharding_ctx(mesh, rules):
        _, got = value_and_grad(cfg, state["params"],
                                _batch_to_mesh(batch, mesh, rules))
    _, want = value_and_grad(cfg, tree_map(_full, state["params"]), batch)
    return [float((_full(g).float() - w.float()).norm()
                  / (w.float().norm() + 1e-12))
            for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True)]


def _plain_run(name, arch, cfg, workdir, batch, accum, steps) -> dict:
    """The port's unsharded step from the same JAX weights and batch."""
    from repro_torch.launch.train import scalar
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.optimizer import AdamWConfig
    state = _case_state(name, ckpt.restore(str(workdir / f"jax_{arch}"), 0,
                                           _template(cfg)))
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                              grad_accum=accum)
    metrics, lrs = [], []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        metrics.append((scalar(m["loss"]), scalar(m["grad_norm"])))
        lrs.append(float(m["lr"]))
    return {"metrics": metrics, "lr": sum(lrs), "opt": _opt_leaves(state)}


def _moe_cfg(arch, cf):
    full = get_config(arch)
    return dataclasses.replace(
        reduced(full), num_experts=full.num_experts,
        num_experts_per_tok=full.num_experts_per_tok,
        moe_capacity_factor=cf)


def _group_moe(workdir: Path) -> dict:
    """``moe_block`` on data 1 x model 4 (output, routing of the rank's
    tokens, gradients) and on data 2 x model 2 (output), in f32, with the
    weights distributed by ``train_rules_for`` (mixtral's ``tp``
    override, dbrx's ``ep``)."""
    from repro_torch.sharding import (current_ctx, named_sharding,
                                      sharding_ctx, train_rules_for)
    meshes = {"1x4": _mesh((1, 4)), "2x2": _mesh((2, 2))}
    d = np.load(workdir / "moe.npz")
    out = {}
    for arch, cf in MOE_CASES:
        cfg = _moe_cfg(arch, cf)
        rules = train_rules_for(cfg)
        tag = f"{arch}@{cf}"
        for mname, mesh in meshes.items():
            spec = moe.moe_spec(cfg)
            p = {k: S.distribute(torch.from_numpy(d[f"{tag}/{k}"]),
                                 named_sharding(spec[k].axes,
                                                spec[k].shape, mesh, rules))
                 for k in spec}
            x = S.distribute(torch.from_numpy(d[f"{tag}/x"]), named_sharding(
                ("batch", "seq", None), MOE_SHAPE + (cfg.d_model,), mesh,
                rules))
            leaves = [x] + [p[k] for k in sorted(p)]
            leaves = [t.detach().requires_grad_() for t in leaves]
            x, p = leaves[0], dict(zip(sorted(p), leaves[1:]))
            with sharding_ctx(mesh, rules):
                assert current_ctx() is not None
                y = moe.moe_block(cfg, p, x)
                res = {"y": _full(y).detach(),
                       "placements_ok": y.placements == x.placements}
                routes = moe.route(cfg, {"router": p["router"].to_local()},
                                   x.to_local().reshape(-1, cfg.d_model))
                if mname == "1x4":
                    r = S.distribute(torch.from_numpy(d[f"{tag}/r"]),
                                     named_sharding(("batch", "seq", None),
                                                    tuple(y.shape), mesh,
                                                    rules))
                    grads = torch.autograd.grad(_full((y * r).sum()),
                                                leaves)
                    res["grads"] = {n: _full(g) for n, g in zip(
                        ["x"] + sorted(p), grads)}
            # rank 0 sees only its own routing: collect every rank's
            res["all_top_e"] = _gather_objects(
                (mesh.get_local_rank("data"), routes[1]))
            out[(tag, mname)] = res
    return out


def _gather_objects(obj):
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _ckpt_cases(workdir: Path) -> dict:
    """The JAX checkpoint restored onto data 2 x model 2, saved from
    there, restored onto data 4 x model 1 and onto no mesh."""
    from repro_torch.launch.train import state_shardings
    from repro_torch.sharding import train_rules_for
    cfg = reduced(get_config("tinyllama-1.1b"))
    out = {}
    m22, m41 = _mesh((2, 2)), _mesh((4, 1))
    for kind, dp_only in (("dp", None), ("tp", False)):
        rules = train_rules_for(cfg, dp_only=dp_only)
        src, dst = (state_shardings(cfg, m, rules) for m in (m22, m41))
        state = ckpt.restore(str(workdir / "jax_tinyllama-1.1b"), 0,
                             _template(cfg), placements=src)
        before = [_full(x) for x in tree_leaves(state)]
        d = workdir / f"port_{kind}"
        ckpt.save(str(d), 3, state, blocking=False).join()
        import torch.distributed as dist
        dist.barrier()                  # rank 0's write is committed
        on_b = ckpt.restore(str(d), 3, _template(cfg), placements=dst)
        plain = ckpt.restore(str(d), 3, _template(cfg))
        out[kind] = {
            "latest": ckpt.latest(str(d)),
            "src_shapes_ok": _local_shapes_ok(state["params"],
                                              src["params"]),
            "dst_shapes_ok": all(_local_shapes_ok(
                on_b["params"] if k == "params" else on_b["opt"][k],
                dst["params"]) for k in ("params", "master", "m", "v")),
            "onto_mesh_b_equal": all(
                torch.equal(_full(a), b) and a.dtype == b.dtype
                for a, b in zip(tree_leaves(on_b), before, strict=True)),
            "onto_no_mesh_equal": all(
                not S.is_dtensor(a) and torch.equal(a, b)
                and a.dtype == b.dtype
                for a, b in zip(tree_leaves(plain), before, strict=True)),
            "state": before}
    return out


# ---------------------------------------------------------------------------
# JAX references (test process)
# ---------------------------------------------------------------------------


def _jax_init_state(arch):
    import jax

    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import model as JM
    from repro.training import optimizer as JO
    jcfg = jax_reduced(jax_get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, {"params": jp, "opt": JO.init_opt_state(jp)}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def jax_train(workdir):
    """The JAX initial states as JAX checkpoints, the batch, and JAX's
    unsharded ``make_train_step`` over the same steps."""
    import jax

    from repro.training import checkpoint as jax_ckpt
    from repro.training import optimizer as JO
    from repro.training import train_step as JT
    toks = np.random.default_rng(0).integers(
        0, 512, size=(BATCH, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
    np.savez(workdir / "batch.npz", tokens=toks, labels=labels)
    states = {}
    for arch in {c[1] for c in TRAIN_CASES}:
        jcfg, st = _jax_init_state(arch)
        jax_ckpt.save(str(workdir / f"jax_{arch}"), 0, st)
        states[arch] = (jcfg, st)
    runs, ref = {}, {}
    for name, arch, _dp, accum, steps in TRAIN_CASES:
        if arch not in JAX_REF_ARCHS:
            continue
        if (arch, accum, steps) not in runs:      # the rules do not matter
            jcfg, st = states[arch]
            step = jax.jit(JT.make_train_step(
                jcfg, JO.AdamWConfig(**TRAIN_OPT), grad_accum=accum))
            b = {"tokens": jax.numpy.asarray(toks),
                 "labels": jax.numpy.asarray(labels)}
            metrics, lrs = [], []
            for _ in range(steps):
                st, m = step(st, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                lrs.append(float(m["lr"]))
            runs[arch, accum, steps] = {
                "metrics": metrics, "lr": sum(lrs),
                "opt": {k: [np.asarray(x, np.float32) for x in
                            jax.tree.leaves(st["opt"][k])]
                        for k in ("master", "m", "v")}}
        ref[name] = runs[arch, accum, steps]
    return ref


@pytest.fixture(scope="module")
def port_train(jax_train, workdir):
    return _spawn("train", workdir)


@pytest.fixture(scope="module")
def jax_moe(workdir):
    """f32 weights, tokens and a cotangent per case; JAX ``_moe_dense``
    on the whole batch and on each data half, its gradients, and JAX
    ``_moe_shard_map`` on a (1, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from repro import sharding as JS
    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import moe as JMoE
    arrays, ref = {}, {}
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch, cf in MOE_CASES:
        full = jax_get_config(arch)
        jcfg = dataclasses.replace(
            jax_reduced(full), num_experts=full.num_experts,
            num_experts_per_tok=full.num_experts_per_tok,
            moe_capacity_factor=cf)
        rng = np.random.default_rng(7)
        e, dm, ff = jcfg.num_experts, jcfg.d_model, jcfg.d_ff
        p = {"router": rng.standard_normal((dm, e)) / np.sqrt(dm),
             "gate": rng.standard_normal((e, dm, ff)) / np.sqrt(dm),
             "up": rng.standard_normal((e, dm, ff)) / np.sqrt(dm),
             "down": rng.standard_normal((e, ff, dm)) / np.sqrt(ff)}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        x = rng.standard_normal(MOE_SHAPE + (dm,)).astype(np.float32)
        r = rng.standard_normal(MOE_SHAPE + (dm,)).astype(np.float32)
        tag = f"{arch}@{cf}"
        arrays.update({f"{tag}/{k}": v for k, v in p.items()})
        arrays[f"{tag}/x"], arrays[f"{tag}/r"] = x, r
        jp = {k: jnp.asarray(v) for k, v in p.items()}

        dense = jax.jit(lambda jp, x, jcfg=jcfg: JMoE._moe_dense(jcfg, jp,
                                                                 x))

        def loss(x, jp, r=r, dense=dense):
            return (dense(jp, x) * r).sum()
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jp)
        with JS.sharding_ctx(jmesh, JS.train_rules_for(jcfg)):
            y_map = jax.jit(lambda jp, x, jcfg=jcfg: JMoE.moe_block(
                jcfg, jp, x))(jp, jnp.asarray(x))
        xt = jnp.asarray(x).reshape(-1, dm)
        probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
        ref[tag] = {
            "y": np.asarray(dense(jp, jnp.asarray(x))),
            "y_halves": np.concatenate([np.asarray(dense(
                jp, jnp.asarray(h))) for h in np.split(x, 2)]),
            "y_shard_map": np.asarray(y_map),
            "top_e": np.asarray(jax.lax.top_k(
                probs, jcfg.num_experts_per_tok)[1]),
            "grads": {"x": np.asarray(gx),
                      **{k: np.asarray(v) for k, v in gp.items()}}}
    np.savez(workdir / "moe.npz", **arrays)
    return ref


@pytest.fixture(scope="module")
def port_moe(jax_moe, workdir):
    return _spawn("moe", workdir)


@pytest.fixture(scope="module")
def port_ckpt(port_train):
    return port_train["ckpt"]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_initialize_brings_up_the_world_from_the_environment(port_train):
    assert port_train["rank_world"] == (0, WORLD)
    assert port_train["backend"] == "gloo"


def test_initialize_without_a_coordinator_is_a_noop(monkeypatch):
    from repro_torch.launch.distributed import initialize
    from repro_torch.launch.mesh import make_host_topology
    monkeypatch.delenv("REPRO_COORDINATOR", raising=False)
    assert initialize(device="cpu") == (0, 1)
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert make_host_topology(8).budgets == (8,)     # this one device


def test_host_mesh_spans_the_world(port_train):
    assert port_train["host_mesh"] == ((1, WORLD), ("data", "model"))
    assert port_train["host_devices"] == WORLD


def test_tinyllama_trains_dp_only_by_default(port_train):
    assert port_train["dp"]["rules"] == S.DP_ONLY_TRAIN_RULES
    tp = port_train["tp"]["rules"]
    assert tp["heads"] == tp["mlp"] == tp["vocab"] == "model"
    assert tp["w_embed"] == ("pod", "data")


def _norm_rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _opt_errors(got: dict, want: dict, master0: list) -> dict:
    """Per leaf: the master weights' change, m and v against the
    reference's, each as a share of the reference's norm."""
    return {"update": [_norm_rel(g - a, w - a) for g, w, a in zip(
                got["master"], want["master"], master0, strict=True)],
            "m": [_norm_rel(g, w) for g, w in zip(got["m"], want["m"],
                                                  strict=True)],
            "v": [_norm_rel(g, w) for g, w in zip(got["v"], want["v"],
                                                  strict=True)]}


def _assert_opt_close(got: dict, want: dict, master0: list) -> None:
    errs = _opt_errors(got, want, master0)
    assert max(errs["update"]) < UPDATE_TOL, errs["update"]
    assert max(errs["m"]) < M_TOL, errs["m"]
    assert max(errs["v"]) < V_TOL, errs["v"]


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_train_step_matches_jax(case, port_train, jax_train):
    """Against JAX's unsharded step (tinyllama, mixtral), or against the
    port's unsharded step from the same JAX weights (``JAX_REF_ARCHS``),
    both at ``TRAIN_OPT``: the metrics of every step, then each leaf's
    update, m and v; the params are their master weights cast."""
    got = port_train[case]
    want = jax_train[case] if case in jax_train else got["plain"]
    assert want["lr"] == pytest.approx(TRAIN_OPT["lr"] * len(got["metrics"]))
    for (l, g), (jl, jg) in zip(got["metrics"], want["metrics"],
                                strict=True):
        assert abs(l - jl) < 2e-2, (l, jl)
        assert abs(g - jg) / (jg + 1e-9) < 5e-2, (g, jg)
    _assert_opt_close(got["opt"], want["opt"], got["master0"])
    for t, w in zip(got["params"], got["opt"]["master"], strict=True):
        assert t.dtype in (torch.bfloat16, torch.float32)
        assert torch.equal(t, torch.from_numpy(w).to(t.dtype))


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_grads_match_the_unsharded_grads(case, port_train):
    """Every leaf's gradient on the mesh within 5e-2 of its norm of the
    port's unsharded gradient (``tests/test_torch_grads.py``'s bound,
    which holds that one to ``jax.grad``)."""
    errs = port_train[case]["grad_errs"]
    assert max(errs) < 5e-2, errs


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_every_state_leaf_holds_its_shard(case, port_train):
    """params, master, m and v: each a DTensor whose local block has the
    shard shape of its spec (nothing was quietly replicated)."""
    assert port_train[case]["shapes_ok"]


def test_two_way_sharded_embedding_under_tp(port_train):
    """TP rules shard the table on ("vocab", "w_embed"): both mesh dims;
    the vocab-sharded logits reach ``cross_entropy``."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    rules = port_train["tp"]["rules"]
    spec = S.spec_for(("vocab", "w_embed"), (512, cfg.d_model),
                      S.ShardCtx(_FakeMesh({"data": 2, "model": 2}), rules))
    assert tuple(spec) == ("model", "data")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_shard_map_routes_as_jax(arch, cf, mesh, port_moe, jax_moe):
    """Every rank's tokens go to the experts JAX picks for them."""
    res, want = port_moe[(f"{arch}@{cf}", mesh)], jax_moe[f"{arch}@{cf}"]
    rows = MOE_SHAPE[0] // (2 if mesh == "2x2" else 1)
    top = want["top_e"].reshape(MOE_SHAPE[0], -1)
    for data_rank, top_e in res["all_top_e"]:
        mine = top[data_rank * rows:(data_rank + 1) * rows].reshape(
            -1, top_e.shape[-1])
        assert np.array_equal(top_e.numpy(), mine)


@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_shard_map_matches_jax_dense(arch, cf, port_moe, jax_moe):
    res, want = port_moe[(f"{arch}@{cf}", "1x4")], jax_moe[f"{arch}@{cf}"]
    assert res["placements_ok"]
    assert _rel(res["y"], want["y"]) < 2e-5
    assert _rel(res["y"], want["y_shard_map"]) < 2e-5


@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_shard_map_grads_match_jax_grad(arch, cf, port_moe, jax_moe):
    res, want = port_moe[(f"{arch}@{cf}", "1x4")], jax_moe[f"{arch}@{cf}"]
    for name, g in res["grads"].items():
        assert _rel(g, want["grads"][name]) < 2e-5, name


@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_capacity_is_per_data_shard(arch, cf, port_moe, jax_moe):
    """data 2 x model 2: capacity comes from each rank's tokens, so the
    result is JAX's ``_moe_dense`` on each data half."""
    res, want = port_moe[(f"{arch}@{cf}", "2x2")], jax_moe[f"{arch}@{cf}"]
    assert _rel(res["y"], want["y_halves"]) < 2e-5


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_checkpoint_reshards_onto_another_mesh(kind, port_ckpt):
    r = port_ckpt[kind]
    assert r["latest"] == 3
    assert r["src_shapes_ok"] and r["dst_shapes_ok"]
    assert r["onto_mesh_b_equal"] and r["onto_no_mesh_equal"]


def test_jax_checkpoint_restores_onto_the_port_mesh(port_ckpt, jax_train):
    """The state restored from the JAX checkpoint onto data 2 x model 2
    and gathered back equals the JAX state, bit for bit."""
    _jcfg, st = _jax_init_state("tinyllama-1.1b")
    import jax
    want = [np.asarray(x) for x in jax.tree.leaves(st)]
    got = port_ckpt["dp"]["state"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_port_mesh_checkpoint_restores_in_jax(kind, port_ckpt, workdir):
    from repro.training import checkpoint as jax_ckpt
    _jcfg, st = _jax_init_state("tinyllama-1.1b")
    got = jax_ckpt.restore(str(workdir / f"port_{kind}"), 3, st)
    import jax
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(st),
                    strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8))


def test_train_launcher_on_a_mesh_resumes_onto_it(port_train):
    """``train(mesh=...)`` with a checkpoint and ``--resume`` on the mesh,
    at ``LAUNCHER_LR``, gives the unsharded launcher's losses (the bound
    of a train step) and its optimizer state after the four steps (a
    resume that lost m, v or the step count would not)."""
    r = port_train["launcher"]
    assert r["step"] == 4 and r["shapes_ok"]
    assert len(r["losses"]) == len(r["plain"]) == 4
    for a, b in zip(r["losses"], r["plain"]):
        assert abs(a - b) < 2e-2, (r["losses"], r["plain"])
    assert r["losses"][-1] < r["losses"][0] - 0.5, r["losses"]
    cfg = reduced(get_config("tinyllama-1.1b"))
    master0 = [x.float().numpy() for x in
               tree_leaves(M.init_params(cfg, 0, device="cpu"))]
    _assert_opt_close(r["opt"], r["plain_opt"], master0)


@pytest.mark.parametrize("vocab,cap", XENT_CASES)
def test_cross_entropy_keeps_the_vocab_sharded(vocab, cap, port_train):
    """Under the tensor-parallel rules each rank reduces its own block of
    the vocab: the loss and its gradient equal the unsharded
    ``cross_entropy``'s (itself held to JAX by
    ``tests/test_torch_training.py``), and no all-gather ran."""
    from repro_torch.models.layers import cross_entropy
    r = port_train["xent"][vocab, cap]
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=vocab, final_logit_softcap=cap)
    logits, labels = _xent_inputs(vocab)
    lg = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(cfg, lg, torch.from_numpy(labels))
    grad, = torch.autograd.grad(loss, lg)
    loss = float(loss.detach())
    assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
    assert _rel(r["grad"], grad.numpy()) < 1e-5
    assert [type(q).__name__ for q in r["logits_spec"]] == ["Shard"] * 2
    assert r["comms"] and not any("gather" in k for k in r["comms"]), \
        r["comms"]


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_embedding_looks_up_each_ranks_rows(kind, port_train):
    """Each rank embeds only its own block of the batch: the rows equal
    the unsharded lookup, the result is laid out on ("batch", "seq",
    "embed"), and the lookup communicates no more than the table's
    gather: the ids are not gathered, nor is a vocab split over "model"
    (the TP rules'), whose rows are summed over "model" instead, one
    all-reduce; only the FSDP'd d_model dim is gathered."""
    from repro_torch.models.transformer import embed_tokens
    r = port_train["embed"][kind]
    cfg = reduced(get_config("tinyllama-1.1b"))
    table, toks = _embed_inputs(cfg)
    want = embed_tokens(cfg, {"tok": torch.from_numpy(table).to(
        torch.bfloat16)}, torch.from_numpy(toks))
    assert torch.equal(r["x"], want)
    assert r["placements_ok"] and r["local"] == r["shard_shape"]
    assert r["local"][0] < BATCH
    summed = sum(v for k, v in r["comms"].items() if "allreduce_" in k)
    rest = {k: v for k, v in r["comms"].items() if "allreduce_" not in k}
    assert rest == r["fsdp_comms"], (r["comms"], r["fsdp_comms"])
    assert summed == (1 if kind == "tp" else 0), r["comms"]
    if kind == "dp":               # no vocab split: the whole table gather
        assert r["fsdp_comms"] == r["gather_comms"]
    else:
        assert sum(r["fsdp_comms"].values()) \
            < sum(r["gather_comms"].values()), r


def test_restore_without_placements_stays_plain(tmp_path):
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(str(tmp_path), 1, state)
    got = ckpt.restore(str(tmp_path), 1, state, placements={"w": None})
    assert not S.is_dtensor(got["w"]) and torch.equal(got["w"], state["w"])


def test_abstract_params_allocate_nothing():
    cfg = get_config("tinyllama-1.1b")
    tree = M.abstract_params(cfg)
    leaves = tree_leaves(tree)
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) == cfg.param_count()
    assert tree_flatten(tree)[1] == tree_flatten(M.param_specs(cfg))[1]
