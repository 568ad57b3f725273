"""The reference's four examples as the port's entry points
(``repro_torch.examples``), on the CPU at the reduced configs.

- quickstart: the BMPR lines and the 100-stream simulator row equal what
  the reference example prints (its sections 1 and 2, run from its own
  source); the two chunks equal JAX's ``serve_chunk`` at 1e-5 from the
  reference's ``init_params`` (adaLN gates opened, so the context
  matters) and the same numpy-seeded conditioning and noise.
- train_small: 4 steps of reduced minicpm-2b; the losses match a JAX run
  of the same steps at 1e-5, the resumed run equals the uninterrupted
  one in every leaf, and the check raises when one leaf of a copy
  differs by one ulp.
- serve_stream: the sequential, ``--batched`` and ``--lanes 2`` sessions
  complete and every stream receives its chunks (no timing compared).
- multi_pod_dryrun: the cell's status is ``ok`` or ``skipped`` and its
  record equals ``launch.dryrun.run_cell(..., multi_pod=True,
  save=False)``'s but for ``lower_s``, the trace's wall time.
"""
import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jdp
from repro.models import ardit as JA
from repro.models import registry as JR
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs.base import get_config
from repro_torch.examples import (multi_pod_dryrun, quickstart, serve_stream,
                                  train_small)
from repro_torch.launch.dryrun import run_cell
from repro_torch.models import ardit as TA
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

from test_batcher import nondegenerate_params

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_quickstart_text():
    """What the reference example prints in its sections 1 (BMPR) and 2
    (the simulated cluster), run from its own source."""
    path = ROOT / "examples" / "quickstart.py"
    source = path.read_text().split("# --- 3. real model")[0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(source, str(path), "exec"),
             {"__file__": str(path), "__name__": "quickstart_reference"})
    return out.getvalue()


def test_quickstart_lines_match_the_reference_example():
    want = _reference_quickstart_text().splitlines()
    assert want and want[0].startswith("Pareto frontier")
    assert quickstart.bmpr_lines() + ["", quickstart.cluster_row()] == want


def test_quickstart_chunks_match_jax():
    jcfg = jax_get_config("ardit-self-forcing").reduced()
    cfg = get_config("ardit-self-forcing").reduced()
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    cond = (0.02 * rng.standard_normal((1, TA.COND_TOKENS, cfg.d_model))
            ).astype(np.float32)
    noise = rng.standard_normal((1, TA.chunk_tokens(cfg), TA.LATENT_CH)
                                ).astype(np.float32)
    got = quickstart.generate_chunks(
        cfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
        torch.from_numpy(cond), torch.from_numpy(noise))
    cache = JA.init_cache(jcfg, jp, jnp.asarray(cond))
    assert [f for f, _, _ in got] == list(quickstart.FIDELITIES)
    for fid, chunk, _ in got:
        want, cache = JA.serve_chunk(jcfg, jp, cache, jnp.asarray(noise),
                                     fid)
        np.testing.assert_allclose(chunk.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("example", [quickstart, serve_stream, train_small])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def _jax_losses(jcfg, npp, steps):
    step = jax.jit(jloop.make_train_step(
        jcfg, jopt.OptConfig(lr=1e-3, schedule="wsd", warmup_steps=4,
                             total_steps=steps),
        microbatches=train_small.MICROBATCHES))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    state = jloop.TrainState(jp, jopt.init_opt_state(jp))
    shape = JShapeConfig("ex", "train", train_small.SHAPE.seq_len,
                         train_small.SHAPE.global_batch)
    losses = []
    for s in range(steps):
        batch = jdp.global_batch(jcfg, shape, s)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses


def test_train_small_matches_jax_and_checks_the_resume(tmp_path):
    steps = 4
    jcfg = jax_get_config("minicpm-2b").reduced()
    cfg = get_config("minicpm-2b").reduced()
    npp = jax.tree_util.tree_map(np.asarray,
                                 JR.init_fn(jcfg)(jax.random.PRNGKey(0)))
    out = train_small.run(cfg, lambda: params_from_numpy(npp), steps,
                          str(tmp_path))
    np.testing.assert_allclose(out["losses"], _jax_losses(jcfg, npp, steps),
                               rtol=1e-5, atol=1e-5)
    assert out["losses"] == out["straight_losses"]

    # a copy of the state with one leaf one ulp off fails the check
    straight = out["straight"]
    o = straight.opt_state
    copy = train_loop.TrainState(
        opt.tree_map(torch.clone, straight.params),
        opt.OptState(o.step.clone(), opt.tree_map(torch.clone, o.m),
                     opt.tree_map(torch.clone, o.v)))
    n = train_small.check_resume(copy, straight)
    assert n == len(train_small.state_leaves(straight))
    leaf = copy.params["final_norm"]
    leaf.view(-1)[0] = torch.nextafter(leaf.view(-1)[0],
                                       torch.tensor(np.inf))
    with pytest.raises(AssertionError, match="params/final_norm"):
        train_small.check_resume(copy, straight)


@pytest.mark.parametrize("argv", [
    ["2", "2"],
    ["--batched", "2", "2"],
    ["--lanes", "2", "--workload", "burst", "--arrival-scale", "0.05", "3",
     "2"],
], ids=["sequential", "batched", "lanes2"])
def test_serve_stream_serves_every_chunk(argv):
    handles, res = serve_stream.main(["--device", "cpu"] + argv)
    assert handles
    for h in handles:
        assert h.done and h.chunks_ready == h.spec.chunks > 0


def test_multi_pod_dryrun_matches_run_cell():
    rec = multi_pod_dryrun.main(["mamba2-780m", "decode_32k"])
    assert rec["status"] in ("ok", "skipped")
    want = run_cell("mamba2-780m", "decode_32k", multi_pod=True, save=False)
    drop = {"lower_s"}
    assert {k: v for k, v in rec.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
