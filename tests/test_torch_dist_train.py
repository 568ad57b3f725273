"""Sharded steps of the port (``train.loop.make_sharded_train_step``,
prefill / decode under ``logical_axis_rules``, ``checkpoint.restore(
shardings=)``) against the same steps unsharded, on gloo process groups
on the CPU.

* World 1, a 1x1 mesh (in this process): two sharded train steps equal
  two unsharded ones bit for bit — losses, every parameter and both
  moments — for the reduced dense (minitron-8b, minicpm-2b tied), MoE,
  VLM, SSM, hybrid, encoder-decoder and AR-DiT configs, and with two
  microbatches for minitron-8b and mamba2-780m.  So is
  mamba2-780m's, minitron-8b's and jamba-v0.1-52b's prefill and 4
  decode steps.
* World 4, a 2x2 (data, model) mesh (4 spawned ranks, one job): the
  same train steps within 1e-5 in the losses and the parameters, and
  the gradients within 1e-5 of each leaf's largest magnitude; prefill
  and decode within 1e-5; a checkpoint written by one rank restored
  with ``shardings=`` gives full tensors equal bit for bit, and a
  sharded state saved from the mesh reads back as the same full tensors.
  The learning rate is 1e-4: Adam's normalized update turns the last-bit
  differences of a sharded sum into O(lr) moves of parameters whose
  gradient is near zero.

Spawned ranks meet through ``init_method="file://<tmp_path>/..."`` and
are joined with a deadline of their own (``_SPAWN_TIMEOUT``).  This file
imports no JAX: ``tests/test_torch_dist_cuda.py`` runs its job on NCCL.
"""
import dataclasses
import json
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

TRAIN_ARCHS = ["minitron-8b", "minicpm-2b", "granite-moe-1b-a400m",
               "internvl2-26b", "mamba2-780m", "jamba-v0.1-52b",
               "whisper-medium", "ardit-self-forcing"]
# "<arch>:kv1" has one KV head, so on a mesh with "model" > 1 its cache's
# slots are split over "model" (as minicpm-2b's 36 KV heads over 16 are)
# and decode combines partial softmax statistics; ":ring" adds a sink +
# window ring smaller than the prompt
SERVE_ARCHS = ["mamba2-780m", "minitron-8b", "jamba-v0.1-52b",
               "minitron-8b:kv1", "minitron-8b:kv1:ring"]
_SPAWN_TIMEOUT = 300
LR = 1e-4


def _leaves(tree):
    from repro_torch.train import optimizer as opt
    return dict(opt.leaves_with_path(tree))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _max_diff(a, b):
    return float((a.float() - _full(b).float()).abs().max()) \
        if a.numel() else 0.0


def train_compare(arch, mesh, device, steps=2, microbatches=1):
    """Two train steps unsharded and sharded on ``mesh`` from the same
    init and batches: {losses, param / moment / grad differences}."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.logical import logical_axis_rules
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    from repro_torch.train import loop, optimizer as opt
    cfg = get_config(arch).reduced()
    api = registry.get_api(cfg)
    seq = 24
    if cfg.family == "ardit":
        from repro_torch.models import ardit as A
        seq = 2 * A.chunk_tokens(cfg)
    ocfg = opt.OptConfig(lr=LR, warmup_steps=1)

    def fresh():
        p = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        p = tree_map(lambda t: t.to(device), p)
        return loop.TrainState(p, opt.init_opt_state(p))

    s0 = fresh()
    s1 = loop.distribute_state(fresh(), loop.state_shardings(cfg, mesh))
    step0 = loop.make_train_step(cfg, ocfg, microbatches=microbatches)
    step1 = loop.make_sharded_train_step(cfg, ocfg, mesh,
                                         microbatches=microbatches)
    loss0, loss1 = [], []
    for i in range(steps):
        b = loop.to_device(dp.global_batch(
            cfg, ShapeConfig("t", "train", seq, 4), i), device)
        bd = shd.distribute(b, loop.batch_shardings(cfg, mesh, b))
        s0, m0 = step0(s0, b)
        s1, m1 = step1(s1, bd)
        loss0.append(float(m0["loss"]))
        loss1.append(float(_full(m1["loss"])))
    out = {"loss0": loss0, "loss1": loss1}
    for name, a, b in (("params", s0.params, s1.params),
                       ("m", s0.opt_state.m, s1.opt_state.m),
                       ("v", s0.opt_state.v, s1.opt_state.v)):
        la, lb = _leaves(a), _leaves(b)
        out[name] = max(_max_diff(la[k], lb[k]) for k in la)
    out["step"] = int(_full(s1.opt_state.step)) == int(s0.opt_state.step)
    # gradients of one more batch at the end state, relative to each
    # leaf's largest magnitude
    b = loop.to_device(dp.global_batch(
        cfg, ShapeConfig("t", "train", seq, 4), steps), device)
    bd = shd.distribute(b, loop.batch_shardings(cfg, mesh, b))
    pc = tree_map(torch.clone, s0.params)
    pd = shd.distribute(tree_map(torch.clone, s0.params),
                        shd.param_shardings(pc, mesh))
    _, g0 = loop.value_and_grad(loop.loss_for(cfg), pc, b)
    with logical_axis_rules(mesh, shd.train_rules(mesh)):
        _, g1 = loop.value_and_grad(loop.loss_for(cfg), pd, bd)
    ga, gb = _leaves(g0), _leaves(g1)
    out["grads_rel"] = max(_max_diff(ga[k], gb[k])
                           / max(float(ga[k].abs().max()), 1e-30)
                           for k in ga)
    return out


def serve_compare(arch, mesh, device, steps=4):
    """Prefill of 4 x 32 tokens and ``steps`` greedy decode steps,
    unsharded and on ``mesh`` (params by ``param_shardings(serve=True)``,
    the cache redistributed by ``lowering.cache_shardings``): the
    largest logit and cache differences."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.logical import P, logical_axis_rules
    from repro_torch.launch.lowering import cache_shardings
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    name, *variant = arch.split(":")
    cfg = get_config(name).reduced()
    if "kv1" in variant:
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if "ring" in variant:
        cfg = cfg.with_window(12, 4)
    api = registry.get_api(cfg)
    params = tree_map(lambda t: t.to(device), api.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    rows = shd.NamedSharding(mesh, P("data", None))
    pd = shd.distribute(params, shd.param_shardings(params, mesh,
                                                    serve=True))
    rules = shd.serve_rules(mesh)
    lg0, c0, n0 = api.prefill(cfg, params, tokens, max_len=32 + steps)
    with logical_axis_rules(mesh, rules):
        lg1, c1, _ = api.prefill(cfg, pd, shd.distribute(tokens, rows),
                                 max_len=32 + steps)
    logits = [_max_diff(lg0, lg1)]
    c1 = tree_map(lambda v, sh: v.redistribute(mesh, sh.placements), c1,
                  cache_shardings(cfg, mesh, c1))
    pos = n0.clone()
    tok = torch.argmax(lg0, -1).to(torch.int32)[:, None]
    for _ in range(steps):
        lg0, c0 = api.decode_step(cfg, params, c0, tok, pos)
        with logical_axis_rules(mesh, rules):
            lg1, c1 = api.decode_step(
                cfg, pd, c1, shd.distribute(tok, rows),
                shd.distribute(pos, shd.NamedSharding(mesh, P("data"))))
        logits.append(_max_diff(lg0, lg1))
        tok = torch.argmax(lg0, -1).to(torch.int32)[:, None]
        pos = pos + 1
    la, lb = _leaves(c0), _leaves(c1)
    return {"logits": logits,
            "cache": max(_max_diff(la[k], lb[k]) for k in la)}


def restore_compare(mesh, ckpt_dir, device):
    """A one-rank checkpoint under ``ckpt_dir`` (minicpm-2b reduced,
    step 1) restored onto ``mesh``; then saved from the mesh (step 2)
    and read back unsharded: whether both equal the first bit for
    bit."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt, loop
    from repro_torch.train import optimizer as opt
    cfg = get_config("minicpm-2b").reduced()
    p = registry.get_api(cfg).init(cfg, None, device="meta")
    like = loop.TrainState(p, opt.OptState(
        torch.empty((), dtype=torch.int32, device="meta"),
        opt.tree_map(lambda t: torch.empty(t.shape, device="meta"), p),
        opt.tree_map(lambda t: torch.empty(t.shape, device="meta"), p)))
    plain = ckpt.restore(ckpt_dir, 1, like_on(like, "cpu"))
    sharded = ckpt.restore(ckpt_dir, 1, like,
                           shardings=loop.state_shardings(cfg, mesh))
    ok1 = all(torch.equal(a, _full(b).cpu()) for a, b in zip(
        _flat(plain), _flat(sharded)))
    ckpt.save(ckpt_dir, 2, sharded)
    dist.barrier()
    back = ckpt.restore(ckpt_dir, 2, like_on(like, "cpu"))
    ok2 = all(torch.equal(a, b) for a, b in zip(_flat(plain), _flat(back)))
    return {"restore": ok1, "save": ok2}


def like_on(state, device):
    from repro_torch.models.layers import tree_map
    from repro_torch.train import loop, optimizer as opt
    o = state.opt_state

    def f(t):
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    return loop.TrainState(tree_map(f, state.params), opt.OptState(
        f(o.step), tree_map(f, o.m), tree_map(f, o.v)))


def _flat(state):
    from repro_torch.train import checkpoint as ckpt
    return [t for _, t in ckpt._flatten_with_names(state)]


def job(rank, world, init, out, backend, device, mesh_shape, train_archs,
        serve_archs, ckpt_dir):
    """One rank of a sharded-vs-unsharded job; rank 0 writes the results
    (or each case's error) as JSON to ``out``."""
    import traceback
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    res = {}
    try:
        mesh = init_device_mesh(device, tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        cases = [("train", a, lambda a=a: train_compare(a, mesh, device))
                 for a in train_archs]
        cases += [("serve", a, lambda a=a: serve_compare(a, mesh, device))
                  for a in serve_archs]
        if ckpt_dir:
            cases.append(("restore", "minicpm-2b",
                          lambda: restore_compare(mesh, ckpt_dir, device)))
        for kind, arch, fn in cases:
            try:
                res[f"{kind}/{arch}"] = fn()
            except Exception as e:          # reported per case
                res[f"{kind}/{arch}"] = {
                    "error": f"{type(e).__name__}: {e}"[:400],
                    "traceback": traceback.format_exc()[-2500:]}
    finally:
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()


def run_job(tmp_path, world, backend, device, mesh_shape, train_archs,
            serve_archs, ckpt_dir=None):
    """Spawn ``world`` ranks of ``job``; their results, or a failure past
    ``_SPAWN_TIMEOUT`` seconds (the ranks are killed)."""
    out = str(tmp_path / "results.json")
    ctx = mp.start_processes(
        job, args=(world, f"file://{tmp_path}/pg", out, backend, device,
                   mesh_shape, train_archs, serve_archs, ckpt_dir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + _SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"spawned ranks still running after "
                                   f"{_SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out) as f:
        return json.load(f)


def check(res, key):
    r = res[key]
    assert "error" not in r, r.get("traceback", r.get("error"))
    return r


# ---------------------------------------------------------------------------
# world 1: bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_1x1(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_1x1_bit_for_bit(arch, mesh_1x1):
    r = train_compare(arch, mesh_1x1, "cpu")
    assert r["loss1"] == r["loss0"]
    assert r["params"] == r["m"] == r["v"] == 0.0
    assert r["grads_rel"] == 0.0 and r["step"]


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-780m"])
def test_train_step_1x1_microbatches_bit_for_bit(arch, mesh_1x1):
    """Two microbatches: each the same slice of every rank's batch
    shard (at world 1, the unsharded step's slices)."""
    r = train_compare(arch, mesh_1x1, "cpu", microbatches=2)
    assert r["loss1"] == r["loss0"]
    assert r["params"] == r["m"] == r["v"] == 0.0


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_1x1_bit_for_bit(arch, mesh_1x1):
    r = serve_compare(arch, mesh_1x1, "cpu")
    assert max(r["logits"]) == 0.0 and r["cache"] == 0.0


# ---------------------------------------------------------------------------
# world 4: a 2x2 mesh
# ---------------------------------------------------------------------------

def one_rank_checkpoint(ckpt_dir):
    """Step 1 of a reduced minicpm-2b state with random moments, saved
    by this (unsharded) process under ``ckpt_dir``: ``restore_compare``'s
    input."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt, loop
    from repro_torch.train import optimizer as opt
    cfg = get_config("minicpm-2b").reduced()
    p = registry.get_api(cfg).init(cfg, torch.Generator().manual_seed(5),
                                   device="cpu")
    st = loop.TrainState(p, opt.init_opt_state(p))
    torch.manual_seed(6)
    for t in _flat(st):
        if t.is_floating_point():
            t.add_(torch.randn_like(t))
    ckpt.save(ckpt_dir, 1, st)
    return ckpt_dir


@pytest.fixture(scope="module")
def job_2x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2x2")
    return run_job(tmp, 4, "gloo", "cpu", (2, 2), TRAIN_ARCHS, SERVE_ARCHS,
                   one_rank_checkpoint(str(tmp / "ckpt")))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_2x2_within_1e5(arch, job_2x2):
    r = check(job_2x2, f"train/{arch}")
    for a, b in zip(r["loss0"], r["loss1"]):
        assert abs(a - b) <= 1e-5, (r["loss0"], r["loss1"])
    assert r["params"] <= 1e-5 and r["m"] <= 1e-5 and r["v"] <= 1e-5, r
    assert r["grads_rel"] <= 1e-5 and r["step"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_2x2_within_1e5(arch, job_2x2):
    r = check(job_2x2, f"serve/{arch}")
    assert max(r["logits"]) <= 1e-5 and r["cache"] <= 1e-5, r


def test_restore_one_rank_checkpoint_onto_2x2(job_2x2):
    r = check(job_2x2, "restore/minicpm-2b")
    assert r["restore"] and r["save"]
