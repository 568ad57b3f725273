"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) on one
full-width cell: minitron-8b's ``train_4k`` on the (16, 16) production
mesh of a fake 256-rank process group traces to the end (``ok``), with
the record keys the reference's dry-run writes, per-device argument
bytes equal to the sum of rank 0's shards of the state and batch, and
no process group left behind.  Its 8 KV heads do not divide over the 16
``model`` ranks, so heads are replicated (counted).
"""
import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.models import registry
from repro_torch.train import loop


def test_minitron_train_4k_pod16x16_ok():
    rec = run_cell("minitron-8b", "train_4k", verbose=False, save=False)
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()
    assert rec["cell"] == "minitron-8b__train_4k__pod16x16"
    assert rec["n_chips"] == 256
    for key in ("model_flops", "flops", "hbm_bytes", "coll_bytes",
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "per_device_bytes", "useful_ratio", "memory_analysis"):
        assert key in rec, key
    assert rec["flops"] >= rec["model_flops"] > 0
    assert rec["coll_by_op"]["all-gather"] > 0       # FSDP's gathers
    assert rec["heads_replicated"] > 0
    # argument bytes: rank 0's shard of every state and batch leaf
    cfg = get_config("minitron-8b")
    sizes = {"data": 16, "model": 16}

    def shard_numel(shape, spec):
        """Elements of rank 0's shard: each dim split (rounded up) over
        the product of its spec entry's axes."""
        n = 1
        for i, d in enumerate(shape):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else (e,) if isinstance(e, str) else e
            k = int(np.prod([sizes[a] for a in axes]))
            n *= -(-d // k)
        return n

    class _Mesh:
        mesh_dim_names = ("data", "model")

    st = loop.state_shardings(cfg, _Mesh)
    specs = registry.param_specs(cfg)
    want = 4                                           # the int32 step
    for path, leaf in loop.opt.leaves_with_path(specs):
        sh = st.params
        for k in path:
            sh = sh[k]
        want += shard_numel(leaf.shape, sh.spec) * (
            leaf.element_size() + 8)                   # param + 2 moments
    batch = registry.input_specs(cfg, SHAPES["train_4k"])
    for k, v in loop.batch_shardings(cfg, _Mesh, batch).items():
        want += shard_numel(batch[k].shape, v.spec) * \
            batch[k].element_size()
    assert rec["memory_analysis"]["argument_bytes"] == want
