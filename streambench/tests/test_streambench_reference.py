"""The plain reference against the program's CPU path at the reduced
configuration: the batched executor over the paged pool, mixed fidelities
(sparsity, windows, fp8 pages), compared chunk by chunk and page by page."""
import json
from pathlib import Path

import pytest
import torch

from streambench.lib import check, inputs, serve
from streambench.reference import ardit as ref

TINY = json.loads((Path(__file__).parent / "ardit-tiny.json").read_text())
KEYS = ["S4_r0.0_W7_bf16", "S3_r0.6_W3_bf16", "S2_r0.9_W1_fp8",
        "S4_r0.7_W7_fp8", "S4_r0.0_W3_bf16", "S2_r0.0_W7_bf16",
        "S3_r0.8_W7_bf16", "S4_r0.0_W7_fp8", "S4_r0.6_W7_bf16",
        "S4_r0.0_W7_bf16"]


def serve_tiny(seed):
    """Two streams, ten chunks each, through the program's executor."""
    from repro_torch.models.ardit import FidelityConfig
    from repro_torch.serve.batcher import BatchedChunkExecutor
    dev = torch.device("cpu")
    params = inputs.make_weights(TINY, seed, dev)
    serve.install_inputs(TINY, seed, dev)
    ex = BatchedChunkExecutor(serve.port_config(TINY), params=params,
                              max_streams=4, device=dev)
    sids = [3, 8]
    for sid in sids:
        ex.admit(sid, seed=sid)
    for n in range(len(KEYS)):
        for i, sid in enumerate(sids):
            k = KEYS[(n + i) % len(KEYS)]
            p = ref.parse_key(k)
            ex.begin_chunk(sid, FidelityConfig(p["steps"], p["sparsity"],
                                               p["window"], p["quant"]), 0.0)
        while ex.inflight:
            quants = {}
            for sid in ex.inflight:
                quants.setdefault(ex.inflight[sid].fidelity.quant,
                                  []).append(sid)
            for grp in quants.values():
                ex.run_step(grp)
    return params, ex


@pytest.mark.parametrize("seed", [0, 2**40 + 7])
def test_reference_matches_program(seed):
    params, ex = serve_tiny(seed)
    w = ref.Weights(params, TINY["n_layers"])
    for sid in ex.chunks:
        served = [c.reshape(c.shape[-2], c.shape[-1]) for c in ex.chunks[sid]]
        keys = ex.fidelity_log[sid]
        noises = [inputs.noise(TINY, seed, sid, k, "cpu")[0]
                  for k in range(len(served))]
        out, _ = ref.replay(TINY, w, inputs.cond(TINY, seed, sid, "cpu"),
                            noises, served, keys, range(len(served)))
        for k, (x_ref, x0) in out.items():
            # both sides in float32, summed in other orders: the widest
            # token reads about ten times the rounding of the mean one
            assert check.token_gap(served[k], x_ref, x0) < 1e-4, (sid, k)


def test_pages_match_what_the_pool_holds():
    """The reference's stored first-layer K and V of the last W chunks
    against the pool's pages, e4m3-rounded where the key says fp8."""
    params, ex = serve_tiny(5)
    w = ref.Weights(params, TINY["n_layers"])
    wc = TINY["ardit_window_chunks"]
    for sid in ex.chunks:
        served = [c.reshape(c.shape[-2], c.shape[-1]) for c in ex.chunks[sid]]
        n = len(served)
        noises = [inputs.noise(TINY, 5, sid, k, "cpu")[0]
                  for k in range(n + 1)]
        _, pages = ref.replay(TINY, w, inputs.cond(TINY, 5, sid, "cpu"),
                              noises, served + [served[-1]],
                              ex.fidelity_log[sid] + ["S4_r0.0_W7_bf16"],
                              [n], page_tokens=48)
        table = ex.pool.ledger.tables[sid]
        for c in range(n - wc, n):
            page = int(table[1 + c % wc])
            k_ref, v_ref = pages[c]
            assert torch.allclose(ex.pool.k[0, page, :48], k_ref, atol=1e-5)
            assert torch.allclose(ex.pool.v[0, page, :48], v_ref, atol=1e-5)
