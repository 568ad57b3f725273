"""Training in the port (``repro_torch.{data, train, launch.train}`` and
every family's ``train_loss``) against the JAX reference, on the CPU at
the reduced configs (fp32).

* ``data.global_batch`` equals the reference's bit for bit, every family.
* Each family's loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's loss: rtol 1e-5 with an
  absolute limit of 1e-5 of the leaf's largest magnitude (the two
  frameworks differ in summation order only), with and without remat
  (remat changes no value).  The AR-DiT's adaLN gates are opened (the
  same numpy draws on both sides): with the zero gates of a fresh init
  its gradients would barely reach the attention.
* ``bf16_backward`` rounds each layer's output cotangent to bf16.  The
  fp32 cotangents of the two frameworks differ in their last bits, and
  now and then such a pair rounds to neighbouring bf16 values (measured
  on minitron-8b's reduced config: about 1e-4 of a leaf's largest
  magnitude below the first rounding, against 3e-7 above it).  So the
  leaves above the last layer's rounding (``final_norm``, ``lm_head``)
  keep the 1e-5 limit, the rest are held within 2^-9 of each leaf's
  largest magnitude (half a bf16 ulp), and the rounding itself is held
  bit for bit to JAX's on the same cotangent.
* ``adamw_update`` on identical gradients, over three steps and the three
  schedules: 1e-6.  Loss sequences of three train steps (microbatches 1
  and 2): 1e-5 relative.  Parameters after whole steps are not compared
  across frameworks: Adam's first step moves a near-zero gradient by
  +-lr whichever sign it rounds to.
* The reference's ``tests/test_train.py::{TestOptimizer, TestData}`` and
  ``tests/test_models.py::{test_smoke_train_step,
  test_smoke_ardit_train}``, rerun on the port alone; the launcher on the
  CPU, resumed from its checkpoint.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_archs
from repro.data import pipeline as jdp
from repro.distributed.precision import bf16_cotangent as jax_bf16_cotangent
from repro.models import registry as JR
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as dp
from repro_torch.distributed.precision import bf16_cotangent
from repro_torch.launch import train as launch_train
from repro_torch.models import ardit as A
from repro_torch.models import registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import loop, optimizer as opt

pytestmark = pytest.mark.slow     # JAX-differentiating model tests

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
# one config per family (dense untied and tied, QKV biases, MoE, VLM,
# SSM, hybrid, encoder-decoder, AR-DiT)
FAMILY_ARCHS = ["minitron-8b", "minicpm-2b", "qwen1.5-32b",
                "granite-moe-1b-a400m", "internvl2-26b", "mamba2-780m",
                "jamba-v0.1-52b", "whisper-medium", "ardit-self-forcing"]
BF16_ARCHS = ["minitron-8b", "minicpm-2b", "granite-moe-1b-a400m",
              "internvl2-26b"]
SEQ, BATCH = 24, 2


def _shape(cfg, seq=SEQ, batch=BATCH):
    if cfg.family == "ardit":
        seq = 2 * A.chunk_tokens(cfg)              # two chunks
    return seq, batch


def _np_params(arch, jcfg):
    """The reference's fresh params as numpy; the AR-DiT's gates opened
    with numpy draws (``ardit.open_gates``'s scales)."""
    npp = jax.tree_util.tree_map(np.asarray, JR.init_fn(jcfg)(KEY))
    if jcfg.family == "ardit":
        rng = np.random.default_rng(1)

        def rnd(a, scale, shift=0.0):
            return (shift + scale * rng.standard_normal(a.shape)).astype(
                a.dtype)

        npp["layers"]["mod"] = rnd(npp["layers"]["mod"], 0.2)
        npp["layers"]["mod_b"] = rnd(npp["layers"]["mod_b"], 0.2, 0.5)
        npp["final_mod"] = rnd(npp["final_mod"], 0.2)
    return npp


_JAX = {}


def _reference(arch, **replace):
    """(port cfg, JAX cfg, numpy params, batch, JAX loss, JAX grads as a
    {key path: numpy} map), the JAX side computed once per variant."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _JAX:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **replace)
        cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
        npp = _np_params(arch, jcfg)
        seq, batch = _shape(cfg)
        nb = jdp.global_batch(jcfg, JShapeConfig("t", "train", seq, batch), 0)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        api = JR.get_api(jcfg)
        loss, grads = jax.value_and_grad(
            lambda p: api.loss(jcfg, p, jb))(
                jax.tree_util.tree_map(jnp.asarray, npp))
        flat = {tuple(k.key for k in path): np.asarray(g) for path, g in
                jax.tree_util.tree_flatten_with_path(grads)[0]}
        _JAX[key] = (cfg, jcfg, npp, nb, float(loss), flat)
    return _JAX[key]


def _port_grads(cfg, npp, nb, **loss_kw):
    api = registry.get_api(cfg)
    return loop.value_and_grad(
        lambda p, b: api.loss(cfg, p, b, **loss_kw), params_from_numpy(npp),
        loop.to_device(nb, "cpu"))


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(
        float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_global_batch_matches_reference(arch):
    cfg = get_config(arch).reduced()
    seq, batch = _shape(cfg, seq=40, batch=3)
    for step in (0, 5):
        got = dp.global_batch(cfg, ShapeConfig("t", "train", seq, batch),
                              step)
        want = jdp.global_batch(jax_get_config(arch).reduced(),
                                JShapeConfig("t", "train", seq, batch), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    cfg, _, npp, nb, jloss, jgrads = _reference(arch)
    kw = {} if cfg.family == "ardit" else {"remat": remat}
    loss, grads = _port_grads(cfg, npp, nb, **kw)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-5)
    leaves = dict(opt.leaves_with_path(grads))
    assert sorted(leaves) == sorted(jgrads)
    for path, want in jgrads.items():
        assert tuple(leaves[path].shape) == want.shape, path
        _close(leaves[path].numpy(), want, 1e-5)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_backward_grads_match_jax(arch):
    cfg, _, npp, nb, jloss, jgrads = _reference(arch, bf16_backward=True)
    loss, grads = _port_grads(cfg, npp, nb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-5)
    leaves = dict(opt.leaves_with_path(grads))
    for path, want in jgrads.items():
        above = path[0] in ("final_norm", "lm_head")
        _close(leaves[path].numpy(), want, 1e-5 if above else 2.0 ** -9)
    # the lever is live: without it the layers' gradients differ
    *_, plain = _reference(arch)
    assert not np.array_equal(plain[("layers", "attn", "wq")],
                              jgrads[("layers", "attn", "wq")])


def test_bf16_cotangent_rounds_as_jax():
    """Identity forward; the cotangent rounded through bf16, bit for bit
    as JAX's ``bf16_cotangent`` on the same values (float32 and
    float64-free: JAX runs without x64)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    g = (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = bf16_cotangent(xt)
    assert torch.equal(y, xt)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jax_bf16_cotangent, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert not np.array_equal(want, g)


def test_moe_aux_survives_remat():
    """The MoE aux loss read from ``moe_block.last_aux`` is the forward's
    under checkpoint recompute: the loss with remat equals the loss
    without, bit for bit, and so do the router's gradients."""
    cfg, _, npp, nb, _, _ = _reference("granite-moe-1b-a400m")
    l1, g1 = _port_grads(cfg, npp, nb, remat=True)
    l0, g0 = _port_grads(cfg, npp, nb, remat=False)
    assert torch.equal(l1, l0)
    assert torch.equal(g1["layers"]["moe"]["router"],
                       g0["layers"]["moe"]["router"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    """A params-like tree with decayed and undecayed leaves."""
    return {"embed": rng.standard_normal((6, 4)) * scale,
            "final_norm": rng.standard_normal((4,)) * scale,
            "layers": {"attn": {"wq": rng.standard_normal((2, 4, 4)) * scale,
                                "bq": rng.standard_normal((2, 4)) * scale},
                       "attn_norm": rng.standard_normal((2, 4)) * scale,
                       "mamba": {"A_log": rng.standard_normal((2, 3)) * scale,
                                 "D": rng.standard_normal((2, 3)) * scale}}}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_adamw_update_matches_jax(schedule):
    rng = np.random.default_rng(0)
    params = _f32(_tree(rng))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule,
               decay_frac=0.4, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = jopt.OptConfig(**cfg), opt.OptConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init_opt_state(jp)
    tp = params_from_numpy(params)
    tst = opt.init_opt_state(tp)
    for k in range(4):
        # the first step's gradients clip (norm > 1), the rest do not
        grads = _f32(_tree(rng, scale=3.0 if k == 0 else 0.05))
        jp, jst, jm = jopt.adamw_update(
            jcfg, jp, jax.tree_util.tree_map(jnp.asarray, grads), jst)
        tp, tst, tm = opt.adamw_update(tcfg, tp, params_from_numpy(grads),
                                       tst)
        assert int(tst.step) == int(jst.step) == k + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6, atol=1e-6)
        for jt, tt in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
            jflat = dict(opt.leaves_with_path(
                jax.tree_util.tree_map(np.asarray, jt)))
            for path, t in opt.leaves_with_path(tt):
                np.testing.assert_allclose(t.numpy(), jflat[path],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=str((k, path)))


def test_adamw_keeps_param_dtype_and_fp32_moments():
    tp = {"w": torch.ones((3, 2), dtype=torch.bfloat16)}
    st = opt.init_opt_state(tp)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    g = {"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16)}
    p2, st2, _ = opt.adamw_update(opt.OptConfig(lr=0.1, warmup_steps=0), tp,
                                  g, st)
    assert p2["w"].dtype == torch.bfloat16 and st2.m["w"].dtype == \
        torch.float32
    assert p2["w"] is tp["w"]                  # updated in place
    assert float(p2["w"][0, 0]) < 1.0


def _clone_state(state):
    return loop.TrainState(
        opt.tree_map(torch.clone, state.params),
        opt.OptState(state.opt_state.step.clone(),
                     opt.tree_map(torch.clone, state.opt_state.m),
                     opt.tree_map(torch.clone, state.opt_state.v)))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_sequence_matches_jax(microbatches):
    arch = "minicpm-2b"
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    npp = _np_params(arch, jcfg)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.OptConfig(**ocfg),
                                          microbatches=microbatches))
    tstep = loop.make_train_step(cfg, opt.OptConfig(**ocfg),
                                 microbatches=microbatches)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    jst = jloop.TrainState(jp, jopt.init_opt_state(jp))
    tp = params_from_numpy(npp)
    tst = loop.TrainState(tp, opt.init_opt_state(tp))
    for s in range(3):
        nb = jdp.global_batch(jcfg, JShapeConfig("t", "train", 16, 4), s)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in nb.items()})
        tst, tm = tstep(tst, nb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


# ---- the reference's TestOptimizer, on the port --------------------------

def _small_state(arch="minicpm-2b"):
    cfg = get_config(arch).reduced()
    params = registry.get_api(cfg).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, loop.TrainState(params, opt.init_opt_state(params))


def _random_tokens(cfg, b, s, seed=0):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def test_loss_decreases():
    cfg, state = _small_state()
    step = loop.make_train_step(cfg, opt.OptConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=50))
    batch = _random_tokens(cfg, 4, 32)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_microbatch_equivalence():
    """Grad accumulation over 2 microbatches == full batch step."""
    cfg, state = _small_state()
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _random_tokens(cfg, 4, 16)
    s1, m1 = loop.make_train_step(cfg, ocfg, microbatches=1)(
        _clone_state(state), batch)
    s2, m2 = loop.make_train_step(cfg, ocfg, microbatches=2)(
        _clone_state(state), batch)
    # CE normalizes per-microbatch; losses agree, grads within tol
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for (_, a), (_, b) in zip(opt.leaves_with_path(s1.params),
                              opt.leaves_with_path(s2.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-5)


def test_grad_clip():
    g = {"w": torch.full((10,), 100.0)}
    p = {"w": torch.zeros((10,))}
    st = opt.init_opt_state(p)
    cfg = opt.OptConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, total_steps=1)
    _, _, metrics = opt.adamw_update(cfg, p, g, st)
    assert float(metrics["grad_norm"]) > 100.0   # pre-clip norm logged


def test_wsd_schedule_shape():
    cfg = opt.OptConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                        total_steps=100, decay_frac=0.2)
    lrs = [float(opt.lr_at(cfg, torch.tensor(s)))
           for s in [0, 5, 10, 50, 79, 90, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == lrs[3] == pytest.approx(1.0)     # stable phase
    assert lrs[4] == pytest.approx(1.0, abs=0.05)
    assert lrs[5] < 1.0                                # decaying
    assert lrs[6] == pytest.approx(0.1, abs=0.02)     # floor


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_schedule_matches_jax(schedule):
    cfg = dict(lr=3e-4, schedule=schedule, warmup_steps=7, total_steps=60,
               decay_frac=0.25)
    for s in (0, 1, 3, 7, 20, 44, 45, 50, 59, 60, 80):
        np.testing.assert_allclose(
            float(opt.lr_at(opt.OptConfig(**cfg), torch.tensor(s))),
            float(jopt.lr_at(jopt.OptConfig(**cfg), jnp.asarray(s))),
            rtol=1e-6, atol=1e-12)


def test_weight_decay_mask():
    assert opt._decay_mask(["wq"])
    assert not opt._decay_mask(["attn_norm"])
    assert not opt._decay_mask(["dt_bias"])
    assert opt._decay_mask(["layers", "attn", "wq"])
    assert not opt._decay_mask(["layers", "mamba", "A_log"])


# ---- the reference's TestData, on the port -------------------------------

def test_dp_layout_invariance():
    cfg = get_config("minitron-8b").reduced()
    shape = ShapeConfig("t", "train", 16, 8)
    full = dp.global_batch(cfg, shape, step=3)
    parts = [dp.global_batch(cfg, shape, step=3,
                             rows=dp.shard_rows(8, r, 4)) for r in range(4)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([p["tokens"] for p in parts]))


def test_steps_differ():
    cfg = get_config("minitron-8b").reduced()
    shape = ShapeConfig("t", "train", 16, 2)
    a = dp.global_batch(cfg, shape, step=0)
    b = dp.global_batch(cfg, shape, step=1)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_targets_are_shifted_tokens():
    cfg = get_config("minitron-8b").reduced()
    shape = ShapeConfig("t", "train", 16, 2)
    batch = dp.global_batch(cfg, shape, step=0)
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["targets"][:, :-1])


# ---- the reference's model smoke tests, on the port ----------------------

def _batch_for(cfg, b=2, s=24):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    for fam, name in (("vlm", "img_embeds"), ("encdec", "audio_embeds")):
        if cfg.family == fam:
            batch[name] = (0.02 * rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return loop.to_device(batch, "cpu")


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if not a.startswith("ardit")])
def test_smoke_train_step(arch):
    cfg = get_config(arch).reduced()
    api = registry.get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss, grads = loop.value_and_grad(
        lambda p, b: api.loss(cfg, p, b), params, _batch_for(cfg))
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), arch
    for _, leaf in opt.leaves_with_path(grads):
        assert bool(torch.isfinite(leaf).all()), arch


@pytest.mark.parametrize("arch", ["ardit-self-forcing",
                                  "ardit-causal-forcing"])
def test_smoke_ardit_train(arch):
    cfg = get_config(arch).reduced()
    tc = A.chunk_tokens(cfg)
    params = A.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(5)
    batch = {
        "latents": torch.randn((2, 2, tc, A.LATENT_CH), generator=g),
        "cond": torch.randn((2, A.COND_TOKENS, cfg.d_model), generator=g),
        "t": torch.rand((2, 2), generator=g),
        "noise": torch.randn((2, 2, tc, A.LATENT_CH), generator=g),
    }
    loss = A.train_loss(cfg, params, batch)
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``--device cpu``: the step lines, a checkpoint every 2 steps and at
    the end; a rerun with more steps resumes from the latest one and
    continues exactly as an uninterrupted run (same data per step)."""
    base = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2"]
    ckdir = str(tmp_path / "ck")
    first = launch_train.main(base + ["--steps", "3", "--ckpt-dir", ckdir])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "gnorm=" in out and "s/step" in out
    assert "final checkpoint at step 3" in out
    assert len(first["loss"]) == 3
    resumed = launch_train.main(base + ["--steps", "5", "--ckpt-dir", ckdir])
    assert "resumed from step 3" in capsys.readouterr().out
    whole = launch_train.main(base + ["--steps", "5"])
    assert resumed["loss"] == whole["loss"][3:]


def test_launcher_needs_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert launch_train.parse_args([]).device == "cuda"
    assert launch_train.parse_args([]).arch == "minicpm-2b"
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--steps", "1"])
