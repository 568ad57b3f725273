"""The port's MoE block (``repro_torch.models.layers``: ``moe_route``,
``_slot_maps``, ``_moe_dispatch``, ``_moe_combine``, ``moe_block``)
against the JAX reference's ``layers.moe_block`` at the reduced
granite-moe-1b-a400m and qwen3-moe-235b-a22b configs (4 experts, top 2,
d 64, expert hidden 64, fp32), at the configs' capacity factor 1.25 and
at 0.5, where capacity drops are forced.

The routing is compared exactly: top-k experts, the slot of every
assignment in its expert's queue (token-major order), which assignments
are dropped, the slot -> token map (against the reference's own
``_slot_maps``) and the dispatch buffer (against its ``_moe_dispatch``:
pure copies, bit for bit).  Gates, output and the aux loss within 1e-5
(rtol and atol): summation order only.  The combine is deterministic:
the same call twice gives the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.slow     # JAX-compiling model tests

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
B, S = 2, 24


def _setup(arch, capacity_factor, seed):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               capacity_factor=capacity_factor)
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tp, jp, x


def _jax_route(jcfg, jp, x):
    """The reference ``moe_block``'s routing lines, on its own arrays."""
    e, k = jcfg.n_experts, jcfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    a_e = idx.reshape(B, S * k)
    oh = jax.nn.one_hot(a_e, e, dtype=jnp.int32)
    slot = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1,
                               a_e[..., None], axis=-1)[..., 0]
    return idx, gate_vals, a_e, slot


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_slots_and_drops_are_the_references(arch, capacity_factor):
    cfg, jcfg, tp, jp, x = _setup(arch, capacity_factor, seed=3)
    e, k = cfg.n_experts, cfg.top_k
    cap = L.moe_capacity(S, cfg)
    assert cap == JL.moe_capacity(S, jcfg)
    probs, idx, gates, slot = L.moe_route(cfg, tp, torch.from_numpy(x))
    jidx, jgates, ja_e, jslot = _jax_route(jcfg, jp, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    kept = (slot < cap).numpy()
    if capacity_factor < 1.0:
        assert not kept.all()            # drops are forced at 0.5
    a_t = jnp.broadcast_to(jnp.repeat(jnp.arange(S), k)[None], (B, S * k))
    jkeep = (jslot < cap).astype(jnp.float32)
    jtok_of, _ = JL._slot_maps(e, cap, S, ja_e, jslot, a_t, jkeep)
    tok_of = L._slot_maps(e, cap, S, idx.reshape(B, S * k), slot, k)
    np.testing.assert_array_equal(tok_of.numpy(), np.asarray(jtok_of))
    buf = L._moe_dispatch(torch.from_numpy(x), tok_of)
    jbuf = JL._moe_dispatch(e, cap, S, jnp.asarray(x), ja_e, jslot, a_t,
                            jkeep)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, capacity_factor):
    cfg, jcfg, tp, jp, x = _setup(arch, capacity_factor, seed=5)
    got = L.moe_block(cfg, tp, torch.from_numpy(x))
    aux = L.moe_block.last_aux
    want = JL.moe_block(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(JL.moe_block.last_aux),
                               **TOL)
    again = L.moe_block(cfg, tp, torch.from_numpy(x))
    assert torch.equal(got, again)


def test_dropped_assignments_add_nothing():
    """At capacity 1 every expert keeps its first assignment only: a
    token all of whose assignments are dropped gets exactly 0, and a
    kept assignment's row is its expert's output times its gate."""
    cfg, _, tp, _, x = _setup(ARCHS[0], 1.25, seed=7)
    cfg = dataclasses.replace(cfg, capacity_factor=1e-6)
    assert L.moe_capacity(S, cfg) == 1
    _, idx, _, slot = L.moe_route(cfg, tp, torch.from_numpy(x))
    kept = (slot < 1).reshape(B, S, cfg.top_k)
    y = L.moe_block(cfg, tp, torch.from_numpy(x))
    dead = ~kept.any(-1)
    assert bool(dead.any())
    assert float(y[dead].abs().max()) == 0.0
    assert bool((y[~dead].abs().sum(-1) > 0).all())
