"""``correct`` comes out false for each fault a cell can have, planted
under the timed path, and for the control (the program's own fp8 page path
on every chunk, the reference told bfloat16); true for the sound run."""
import itertools

import pytest

from harness import run_tiny

from streambench.calibrate import fp8_pages
from streambench.lib import check


def patch_step(monkeypatch, fault):
    from repro_torch.models import ardit as A
    step = A.denoise_step_paged

    def broken(cfg, p, x, *args):
        x_new, kv = step(cfg, p, x, *args)
        return fault(x, x_new, kv)
    monkeypatch.setattr(A, "denoise_step_paged", broken)


def state_unchanged():
    return lambda x, x_new, kv: (x, kv)


def half_the_batch():
    """Each launch leaves one half of its rows out (they keep their input
    and write zero K and V), the two halves in turn, so that every stream
    is hit whatever row the batcher gives it."""
    launches = itertools.count()

    def fault(x, x_new, kv):
        b = x.shape[0]
        mid = (b + 1) // 2
        rows = slice(0, mid) if next(launches) % 2 == 0 else slice(mid, b)
        out = x_new.clone()
        out[rows] = x[rows]
        kv = {k: v.clone() for k, v in kv.items()}
        for v in kv.values():
            v[:, rows] = 0
        return out, kv
    return fault


def answer_altered():
    def fault(x, x_new, kv):
        out = x_new.clone()
        out[0, 0] += 1.0                 # one latent token of one row
        return out, kv
    return fault


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_fault_fails(monkeypatch, fault):
    patch_step(monkeypatch, fault())
    res, _ = run_tiny(seed=31)
    assert res["correct"] is False


def test_sound_run_passes():
    res, _ = run_tiny(seed=31)
    assert res["correct"] is True


def test_control_fails(monkeypatch):
    """The program serves every chunk over e4m3 pages; the reference is
    told the chunks are bfloat16."""
    orig = check.gaps

    def told_bf16(rec, cfg, seed, device, picks, keys_of=None):
        keys_of = {s.sid: [k.replace("_fp8", "_bf16") for k in s.keys]
                   for s in rec.streams}
        return orig(rec, cfg, seed, device, picks, keys_of=keys_of)
    monkeypatch.setattr(check, "gaps", told_bf16)
    res, checks = run_tiny(seed=33, session_hook=fp8_pages)
    assert res["correct"] is False
    assert not checks["kv_page_gap"]["ok"]


@pytest.mark.cuda
def test_control_on_the_card(cuda, monkeypatch):
    """The same at the reduced size on the card (the CUDA-core paths of
    kernel 1 at head dim 16): sound passes, control fails."""
    from streambench import run as R
    from harness import tiny_cell
    import time

    def go(hook=None):
        args = R.parse(["--workload", "sf-saturate", "--seed", "41",
                        "--seconds", "2", "--trace", "0"])
        return R.run(args, device="cuda", cell=tiny_cell(),
                     session_hook=hook, t_process=time.perf_counter())
    assert go()[0]["correct"] is True
    orig = check.gaps
    monkeypatch.setattr(check, "gaps", lambda rec, cfg, seed, device, picks,
                        keys_of=None: orig(
                            rec, cfg, seed, device, picks,
                            keys_of={s.sid: [k.replace("_fp8", "_bf16")
                                             for k in s.keys]
                                     for s in rec.streams}))
    assert go(fp8_pages)[0]["correct"] is False
