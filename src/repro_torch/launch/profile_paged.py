"""Kernel 1 on the card at the shapes the AR-DiT models give it.

Times ``ops.paged_chunk_attention`` (CUDA events around ``--iters``
calls after a warm-up) beside SDPA over the gathered context plus the
chunk's own keys, at the rows of ``PERF.md``'s kernel table (phase 2 of
``chip_smoke.py`` runs the same shapes and times them the same way): B
2, 2,640 chunk queries, a table of the sink page (77 tokens) and 7 ring
pages of 2,640 tokens, all visible (18,557 tokens):

* ``1``: ardit-self-forcing's heads, 12 of 128, bf16 pages;
* ``1b``: ardit-causal-forcing's, 16 of 96, bf16 pages (the D 96
  instance); ``1b-general``: the same call on the general tensor-core
  instance, which took it before the D 96 instance existed;
* ``1b-h12``: 1b's shape with 12 heads on the general instance (504 row
  tiles: 3.8 waves of 132 blocks against 1b's 5.1), for the waves'
  share of 1b's time;
* ``1-e4m3`` / ``1b-e4m3``: rows 1 and 1b over e4m3 pages.

Each row prints the kernel's ms, the general instance's where the row
takes the D 96 instance, SDPA's, and the bound (operations at 989
TFLOP/s or bytes at 3.35 TB/s).  ``--part-tiles 148`` also times the
D 96 instance with other part lengths (at 1b, 148 key tiles are the
whole context: one part and no merge).  ``--check`` first holds the D 96
instance to the plain version in the cases of
``tests/test_torch_kernel_cuda.py`` (masked pages, a hole row, a row that
sees nothing, GQA 2 and 4, a context cut into parts, with and without the
hint), an 8-head view of a 16-head pool bit for bit with the full
launch's rows and two calls bit for bit.
``--variant NAME=OLD=>NEW[||OLD=>NEW...]`` (repeatable; ``NAME=``
alone: no edit) and ``--ablate NAME,...`` (the edits of ``ABLATIONS``;
``a+b`` applies both) also time copies of
``csrc/paged_chunk_attention.cu`` in turns with the source as it is: a
variant on the D 96 instance at the rows that take it (1b), or, with
``--general`` and for the ablations named ``general-...``, on the
general instance at the rows that name it (1b-general, 1b-h12).
``--burst N``, ``--power``, ``--sass FILE`` and ``--digest`` are
``profile_flash``'s: N rested short-burst rounds in turns; clock and
power while each runs; the SASS order of exponentials against the waits
on the products (for the copies too, in FILE.NAME); a SHA-256 of each
row's m, l and acc instead of timings, to compare two trees on one card
bit for bit (each row's inputs come from a seed of its shape, so 1b and
1b-general see the same ones)::

    PYTHONPATH=src python -m repro_torch.launch.profile_paged [--check]
        [--rows 1,1b,1b-general] [--iters 20] [--part-tiles 148]
        [--ablate no-exp,no-loads,no-merge] [--variant ...] [--general]
        [--burst N] [--power] [--sass FILE] [--digest]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.launch.profile_flash import (HBM, PEAK_BF16, clock_power,
                                              cuda_ms, print_ptxas,
                                              sass_order, variant_libs)

DEV = "cuda"
B, SQ, PAGE, N, SINK = 2, 2640, 2640, 8, 77
CTX = SINK + (N - 1) * PAGE
# name -> (heads, head dim, pages, general: the general tensor-core
# instance rather than the one ops.chunk_instance names)
ROWS = {
    "1": (12, 128, "bf16", False),
    "1b": (16, 96, "bf16", False),
    "1b-general": (16, 96, "bf16", True),
    "1b-h12": (12, 96, "bf16", True),
    "1-e4m3": (12, 128, "e4m3", False),
    "1b-e4m3": (16, 96, "e4m3", False),
}
_GEN_EXP = "s[c] = exp2_approx(fmaf(s[c], p.scale_log2, -m[(c >> 1) & 1]));"
_D96_EXP = "s[c] = exp2_approx(fmaf(s[c], scale, -m[(c >> 1) & 1]));"
_GEN_LOADS = """\
          tma_load_4d(dk, tk, &full[stage], 0, h, t0, pid);
          tma_load_4d(dk + BN * ROW, tk, &full[stage], 64, h, t0, pid);
          tma_load_4d(dv, tv, &full[stage], 0, h, t0, pid);
          tma_load_4d(dv + BN * ROW, tv, &full[stage], 64, h, t0, pid);"""
_D96_LOADS = """\
            tma_load_4d(dk + x * BN * ROW, tk, &full[stage], BOX * x, h, t0,
                        pid);
            tma_load_4d(dk + KV_BYTES + x * BN * ROW, tv, &full[stage],
                        BOX * x, h, t0, pid);"""
# name -> (general, [(old, new), ...]): the ablations of PERF.md (--ablate
# a+b applies the edits of both)
ABLATIONS = {
    # scores rescaled but not exponentiated; the producer arrives on each
    # stage without loading K or V (general-...: the general instance)
    "general-no-exp": (True, [(_GEN_EXP, _GEN_EXP.replace(
        "exp2_approx(", "(", 1))]),
    "general-no-loads": (True, [
        ("mbar_arrive_expect_tx(&full[stage], BYTES);",
         "mbar_arrive(&full[stage]);"), (_GEN_LOADS, "")]),
    "no-exp": (False, [(_D96_EXP, _D96_EXP.replace("exp2_approx(", "(",
                                                   1))]),
    "no-loads": (False, [
        ("mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);",
         "mbar_arrive(&full[stage]);"), (_D96_LOADS, "")]),
    # the last part to finish neither merges the parts nor stores the
    # rows: the merge's share of a context cut into parts
    "no-merge": (False, [("    if (done[cw] != p.n_parts - 1) return;",
                          "    return;")]),
}


def make(row):
    """q, the K and V pools (2 B + 2 pages) and per-row tables of
    distinct pages, on the card, from a seed of the row's heads, head dim
    and pages (rows that differ only in instance get the same inputs)."""
    from repro_torch.models.kvcache import to_fp8_e4m3
    H, D, kv, _ = ROWS[row]
    gen = torch.Generator(device=DEV).manual_seed(
        1000 * H + D + (kv == "e4m3"))
    P = B * N + 2
    q = torch.randn((B, SQ, H, D), generator=gen, device=DEV).bfloat16()
    kp, vp = (torch.randn((P, PAGE, H, D), generator=gen, device=DEV)
              for _ in range(2))
    if kv == "e4m3":
        kp, vp = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    table = torch.randperm(P, generator=gen, device=DEV)[:B * N].view(
        B, N).to(torch.int32)
    return q, kp.contiguous(), vp.contiguous(), table, gen


def bound(H, D, elt):
    """(bound ms, bound_by): 4 x rows x D x visible tokens operations per
    (b, head) at the bf16 rate (e4m3 pages are widened); each input read
    once, each output written once."""
    flops = 4.0 * B * H * SQ * D * CTX
    nbytes = (2 * B * SQ * H * D + 2 * B * CTX * H * D * elt + B * N * 4
              + B * H * SQ * (D + 2) * 4)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sdpa(q, kp, vp, table, gen):
    """SDPA over the gathered visible context plus random chunk keys of
    the same size as the queries (what ``paged_mha`` computes)."""
    H, D = q.shape[2], q.shape[3]
    bt = table.long()
    ck, cv = (torch.randn((B, SQ, H, D), generator=gen, device=DEV)
              .bfloat16() for _ in range(2))
    k_ctx, v_ctx = (torch.cat([p[bt[:, 0], :SINK], p[bt[:, 1:].reshape(-1),
                                                    :PAGE].view(B, -1, H, D)],
                              1).bfloat16() for p in (kp, vp))
    k_all = torch.cat([k_ctx, ck], 1).transpose(1, 2).contiguous()
    v_all = torch.cat([v_ctx, cv], 1).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k_all, v_all)


def lib_call(lib, q, kp, vp, table, general=False, part_tiles=None):
    """One launch of a built copy of the source, as ``ops._launch`` makes
    it for a row's all-visible call with the hint: on the D 96 instance
    (``part_tiles`` key tiles a part, ops.CHUNK_PART_TILES by default),
    or with ``general`` on the general tensor-core instance."""
    from repro_torch.kernels.paged_attention import ops
    b, sq, hq, d = q.shape
    n_total, page, hkv, _ = kp.shape
    n = table.shape[1]
    g = hq // hkv
    m = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=DEV)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=DEV)
    page_any = torch.ones((b, n), dtype=torch.uint8, device=DEV)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            None, page_any.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), b, sq, hq, hkv, d, page, n, SINK, PAGE, 1,
            2 if kp.dtype == torch.float8_e4m3fn else 1, kp.stride(0),
            kp.stride(1), n_total)
    if not general:
        part_tiles, n_blocks, sched, scratch = ops.chunk_buffers(
            b, hkv, sq, g, n, page, SINK, PAGE, torch.device(DEV),
            part_tiles or ops.CHUNK_PART_TILES)
        args += (part_tiles, n_blocks, sched.data_ptr(),
                 None if scratch is None else scratch.data_ptr())

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if general:
            err = lib.paged_chunk_attention_wgmma_launch(*args, stream)
        else:
            sched.zero_()
            err = lib.paged_chunk_attention_wgmma96_launch(*args, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return m, l, acc
    return call


def compare(name, got, want):
    """The card tests' limits: m within 1e-4, l within 1e-4 relative, o =
    acc / l within 2 bf16 ulps at its largest magnitude; rows that see
    nothing exactly (-1e30, 0, 0)."""
    import math
    from repro_torch.kernels.paged_attention import ref
    (m, l, acc), (m0, l0, acc0) = got, want
    dead = m0 == ref.NEG_INF
    live = ~dead
    same_dead = bool(torch.equal(m == ref.NEG_INF, dead)) and bool(
        (l[dead] == 0).all()) and bool((acc[dead] == 0).all())
    dm = float((m - m0)[live].abs().max()) if live.any() else 0.0
    dl = float(((l - l0) / l0)[live].abs().max()) if live.any() else 0.0
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    o0 = acc0 / torch.where(l0 == 0, 1.0, l0)[..., None]
    top = float(o0.abs().max())
    lim = 2 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    do = float((o - o0).abs().max())
    ok = same_dead and dm <= 1e-4 and dl <= 1e-4 and do <= lim
    print(f"  check {name}: |dm| {dm:.3g}  |dl|/l {dl:.3g}  |do| {do:.3g} "
          f"(limit {lim:.3g}), dead rows {int(dead.sum())} exact "
          f"{same_dead}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(name)


# the D 96 instance's cases (those of tests/test_torch_kernel_cuda.py):
# name -> (B, Sq, Hq, Hkv, page, n, sink, masked)
CHECKS = [
    ("main-path pages, masked", 2, 300, 2, 2, 2640, 3, 77, True),
    ("GQA 2, masked, no hint", 3, 150, 8, 4, 200, 4, 0, True),
    ("GQA 4, masked", 2, 130, 16, 4, 150, 3, 140, True),
    ("a context cut into parts", 2, 200, 4, 4, 2640, 8, 77, False),
    ("a context cut into parts, masked", 3, 140, 2, 2, 2640, 8, 77, True),
]


def check():
    """The D 96 instance against the plain version in every case of the
    card tests, two calls bit for bit, and an 8-head view of a 16-head
    pool bit for bit with the full launch's rows."""
    from repro_torch.kernels.paged_attention import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(96)
    fn = ops.paged_chunk_attention
    for name, b, sq, hq, hkv, page, n, sink, masked in CHECKS:
        P = b * n + 3
        q = torch.randn((b, sq, hq, 96), generator=gen,
                        device=DEV).bfloat16()
        kp, vp = (torch.randn((P, page, hkv, 96), generator=gen,
                              device=DEV).bfloat16() for _ in range(2))
        table = torch.randint(0, P, (b, n), generator=gen, device=DEV,
                              dtype=torch.int32)
        hint = dict(sink=sink, chunk_tokens=page) if sink else {}
        mask = None
        if masked:
            mask = torch.rand((b, n, page), generator=gen, device=DEV) < 0.7
            mask[0, 1] = False                     # a fully-masked page
            table[1, -1] = table[1, 0]             # a hole row ...
            mask[1, -1] = False                    # ... that never shows
            if b > 2:
                mask[2] = False                    # a row seeing nothing
            mask = mask.view(b, n * page)
        before = fn.launches_d96
        got = fn(q, kp, vp, table, mask, **hint)
        again = fn(q, kp, vp, table, mask, **hint)
        torch.cuda.synchronize()
        parts = len(ops.chunk_parts(n, page, *(
            (sink, page) if sink else (0, 0))))
        compare(f"D 96 {name} ({parts} part{'s' * (parts > 1)})", got,
                ref.paged_chunk_attention_ref(q, kp, vp, table, mask, **hint))
        if fn.launches_d96 != before + 2 or not all(
                torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two calls differ, or not on the "
                                 f"D 96 instance")
    # an 8-head view of a 16-head pool against the full launch's rows
    q, kp, vp, table, _ = make("1b")
    hint = dict(sink=SINK, chunk_tokens=PAGE)
    full = fn(q, kp, vp, table, None, **hint)
    for lo in (0, 8):
        half = fn(q[:, :, lo:lo + 8].contiguous(), kp[:, :, lo:lo + 8],
                  vp[:, :, lo:lo + 8], table, None, **hint)
        same = all(torch.equal(h, f[:, lo:lo + 8])
                   for h, f in zip(half, full))
        print(f"  check D 96 8-head view at head {lo} of a 16-head pool "
              f"(1b's shape) bit for bit with the full launch: {same}",
              flush=True)
        if not same:
            raise AssertionError("8-head view")
    compare("D 96 1b's shape", full, ref.paged_chunk_attention_ref(
        q, kp, vp, table, None, **hint))


def digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1,1b,1b-general,1-e4m3,1b-e4m3")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--part-tiles", default="",
                    help="other part lengths (key tiles) to time at D 96")
    ap.add_argument("--ablate", default="",
                    help="names of ABLATIONS to build and time")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW, OLD and NEW with \\n for newlines")
    ap.add_argument("--general", action="store_true",
                    help="run the --variant copies on the general instance")
    ap.add_argument("--sass", default=None,
                    help="write the kernels' SASS order here")
    ap.add_argument("--burst", type=int, default=0,
                    help="rounds of rested short-burst timings in turns")
    ap.add_argument("--power", action="store_true",
                    help="sample SM clock and power while kernel / SDPA run")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--digest", action="store_true",
                    help="print each row's m, l, acc digest only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paged needs the card")
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops
    ops._lib()
    print_ptxas(build.BUILD_LOGS.get(str(ops.SOURCE), ""))
    if args.sass:
        sass_order(build._target(ops.SOURCE), args.sass)
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"  card: {card}", flush=True)
    if args.check:
        check()
    specs = {}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        specs[name] = (args.general, [
            tuple(x.replace("\\n", "\n") for x in e.split("=>"))
            for e in rest.split("||")] if rest else [])
    for name in filter(None, args.ablate.split(",")):
        parts = [ABLATIONS[a] for a in name.split("+")]
        specs[name] = (parts[0][0], [e for part in parts for e in part[1]])
    libs = variant_libs(ops.SOURCE, {k: v[1] for k, v in specs.items()},
                        bind=ops.bind) if specs else {}
    if args.sass:
        for name in libs:
            sass_order(build._target(build.build_dir() / (
                f"{ops.SOURCE.stem}_{name}.cu")), f"{args.sass}.{name}")
    hint = dict(sink=SINK, chunk_tokens=PAGE)
    main_lib = ops._lib()
    results = {}
    for row in args.rows.split(","):
        H, D, kv, general = ROWS[row]
        q, kp, vp, table, gen = make(row)
        if general:
            fn = lib_call(main_lib, q, kp, vp, table, general=True)
        else:
            def fn():
                return ops.paged_chunk_attention(q, kp, vp, table, None,
                                                 **hint)
        if args.digest:
            print(f"  digest row {row} {ROWS[row]}: {digest(fn())}",
                  flush=True)
            continue
        fns = {"kernel": fn}
        d96 = not general and ops.chunk_instance(
            q.dtype, kp.dtype, D, 1) == "wgmma96"
        if d96:
            fns["general"] = lib_call(main_lib, q, kp, vp, table,
                                      general=True)
            for pt in filter(None, args.part_tiles.split(",")):
                fns[f"part_tiles_{pt}"] = lib_call(main_lib, q, kp, vp,
                                                   table, part_tiles=int(pt))
        for name, lib in libs.items():
            # a copy's D 96 instance on the rows that take it, its general
            # instance on the rows that name it
            if (not specs[name][0] and d96) or (specs[name][0] and general):
                fns[name] = lib_call(lib, q, kp, vp, table,
                                     general=specs[name][0])
        # which of the others give the kernel's bits (an exact edit of
        # the D 96 instance does; other part lengths, the general
        # instance and the ablations round elsewhere or differ)
        want = fn()
        bits = {name: all(torch.equal(x, y) for x, y in zip(f(), want))
                for name, f in fns.items() if name != "kernel"}
        lib_fn = sdpa(q, kp, vp, table, gen)
        fns["sdpa"] = lib_fn
        bms, by = bound(H, D, 1 if kv == "e4m3" else 2)
        if args.burst:
            times = {name: [] for name in fns}
            for rnd in range(args.burst):
                for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                    time.sleep(1.5)
                    times[name].append(round(cuda_ms(fns[name],
                                                     args.iters), 4))
            print(f"  burst row {row} {ROWS[row]}: " + ", ".join(
                f"{name} {sorted(ts)}" for name, ts in times.items())
                + f"; bound {bms:.4f} ({by}); the kernel's bits: "
                f"{[name for name, same in bits.items() if same]}",
                flush=True)
            results[row] = times
            continue
        res = {}
        for name, f in fns.items():
            res[f"{name}_ms"] = cuda_ms(f, args.iters)
        res["kernel_ms_again"] = cuda_ms(fn, args.iters)
        if args.power:
            res["kernel_mhz"], res["kernel_w"] = clock_power(fn)
            res["sdpa_mhz"], res["sdpa_w"] = clock_power(lib_fn)
        flops = 4.0 * B * H * SQ * D * CTX
        res.update(bound_ms=bms, bound_by=by,
                   tflops=flops / res["kernel_ms"] / 1e9,
                   same_bits=[name for name, same in bits.items() if same])
        results[row] = res
        print(f"  row {row} {ROWS[row]}: " + ", ".join(
            f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
            for a, b in res.items()), flush=True)
        del q, kp, vp, fns, lib_fn
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=card, rows=results),
                                              indent=1))


if __name__ == "__main__":
    main()
