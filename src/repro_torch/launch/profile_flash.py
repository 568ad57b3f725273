"""Kernel 3's forward on the card at the shapes the models give it.

Times ``ops.flash_mha`` (CUDA events around ``--iters`` calls after a
warm-up) beside SDPA on the same q/k/v, at the rows of ``PERF.md``'s
kernel table (phase 3 of ``chip_smoke.py`` runs the same shapes):

* ``3``: ardit-self-forcing's sequential attention, B 1, 2,640 queries
  over 21,197 keys, 12 heads of 128, non-causal;
* ``3b`` / ``3c`` / ``3d``: the causal prefills of granite-moe (D 64),
  minitron-8b (D 128, GQA 4) and Jamba (sink 128 + window 8,192), B 2 x
  32,768;
* ``3e`` / ``3f`` / ``3g``: whisper-medium's encoder (1,500 x 1,500), its
  prefill cross-attention (32,768 x 1,500) and a decode step's (1 x
  1,500), B 2, 16 heads of 64; 3g is also timed on the host clock over
  back-to-back calls (what a decode loop pays a call);
* ``train``: minicpm-2b's training forward (B 2, 4,096 causal, 36 heads
  of 64) writing the lse its backward reads.

Each row prints the kernel's ms, SDPA's, the bound (operations at 989
TFLOP/s or bytes at 3.35 TB/s) and, at D 64, the exponential floor: the
row's exponentials (one per visible (query, key) pair) at 16 a clock an
SM on 132 SMs at the SM clock ``nvidia-smi --query-gpu=clocks.max.sm``
reports.  ``--check`` first holds the D 64 kernel to the plain version
in every mode it takes (non-causal with partial tiles on both axes, Sq
1, causal GQA with q_offset, sink + window, rho, rows that see nothing),
its lse to the plain version's, and two calls bit for bit.
``--variant NAME=OLD=>NEW[||OLD=>NEW...]`` (repeatable; OLD and NEW
hold neither ``=>`` nor ``||``) also times a copy of
``csrc/flash_mha.cu`` with each text OLD replaced by NEW at the D 64
rows, in turns with the source as it is.  ``--digest`` prints a SHA-256
of each row's output and lse instead of timing it, so that two trees
run on one card can be compared bit for bit::

    PYTHONPATH=src python -m repro_torch.launch.profile_flash [--check]
        [--rows 3e,3f] [--iters 20] [--variant ...] [--digest]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

DEV = "cuda"
PEAK_BF16, HBM = 989e12, 3.35e12
EX2_PER_CLOCK_SM, SMS = 16, 132
# name -> (B, Sq, Skv, Hq, Hkv, D, causal, window, sink)
ROWS = {
    "3": (1, 2640, 21197, 12, 12, 128, False, 0, 0),
    "3b": (2, 32768, 32768, 16, 8, 64, True, 0, 0),
    "3c": (2, 32768, 32768, 32, 8, 128, True, 0, 0),
    "3d": (2, 32768, 32768, 32, 8, 128, True, 8192, 128),
    "3e": (2, 1500, 1500, 16, 16, 64, False, 0, 0),
    "3f": (2, 32768, 1500, 16, 16, 64, False, 0, 0),
    "3g": (2, 1, 1500, 16, 16, 64, False, 0, 0),
    "train": (2, 4096, 4096, 36, 36, 64, True, 0, 0),
    # ardit-causal-forcing's heads of 96 (phase 3's case)
    "d96": (1, 660, 2057, 16, 16, 96, False, 0, 0),
}
# the D 64 modes of --check: (name, B, Sq, Skv, Hq, Hkv, keyword args)
CHECKS = [
    ("non-causal 1,500 x 1,500", 2, 1500, 1500, 4, 4, dict(causal=False)),
    ("non-causal Sq 1", 2, 1, 1500, 4, 4, dict(causal=False)),
    ("non-causal 193 x 77", 1, 193, 77, 2, 2, dict(causal=False)),
    ("causal GQA 4, q_offset 700", 2, 768, 1536, 8, 2,
     dict(q_offset=700)),
    ("causal 1,152", 1, 1152, 1152, 4, 4, dict()),
    ("sink 77 + window 256", 1, 1024, 1024, 4, 4, dict(window=256,
                                                        sink=77)),
    ("sink 16 + window 100, rows past the window", 1, 64, 1500, 2, 2,
     dict(window=100, sink=16, q_offset=1436)),
    ("rho 0.7, blocks 96 x 160", 1, 1920, 1920, 4, 4,
     dict(sparsity=0.7, block_q=96, block_kv=160)),
    ("rows that see nothing", 2, 32, 32, 2, 2, dict(q_offset=-8)),
]


def visible_pairs(Sq, Skv, causal, window, sink, q_offset=None):
    """(query, key) pairs a call computes (causal: query i at q_offset +
    i, q_offset Skv - Sq by default)."""
    if not causal:
        return Sq * Skv
    off = Skv - Sq if q_offset is None else q_offset
    total = 0
    for i in range(Sq):
        hi = min(off + i, Skv - 1)
        if hi < 0:
            continue
        n = hi + 1
        if window:
            lo = max(0, off + i - window + 1)
            n = hi - lo + 1 + min(sink, lo)
        total += n
    return total


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip())


def floors(B, Sq, Skv, Hq, Hkv, D, causal, window, sink, mhz):
    """(bound ms, bound_by, exponential floor ms)."""
    pairs = visible_pairs(Sq, Skv, causal, window, sink, q_offset=0)
    flops = 4.0 * B * Hq * pairs * D
    nbytes = 2 * 2 * B * Sq * Hq * D + 2 * 2 * B * Skv * Hkv * D
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
    ex2 = B * Hq * pairs / (EX2_PER_CLOCK_SM * SMS * mhz * 1e6) * 1e3
    return max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes", ex2


def cuda_ms(fn, iters):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def make(row, gen):
    B, Sq, Skv, Hq, Hkv, D, causal, window, sink = ROWS[row]
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device=DEV)
            .bfloat16() for _ in range(2))
    kw = dict(n_kv_heads=Hkv, causal=causal, window=window, sink=sink)
    return q, k, v, kw


def sdpa(q, k, v, kw):
    """SDPA on the same tensors (None for a windowed row: it needs a
    mask and another backend, which phase 3 times)."""
    if kw["window"]:
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)


def print_ptxas(log):
    """Registers and spills of each tensor-core forward in an nvcc log,
    and ptxas's wgmma serialization notes."""
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if "wgmma" in name:
            regs = [ln.strip() for ln in block.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  ptxas {name[-40:]}: {' | '.join(regs)}")
    print(f"  ptxas notes: {log.count('Potential Performance Loss')} "
          f"'Potential Performance Loss'")
    for line in log.splitlines():
        if "Performance Loss" in line:
            print("   ", line.strip()[:200])


def variant_libs(source, variants):
    """Copies of ``source``, one per name in ``variants`` with each of its
    (old, new) edits applied once, built beside the kernels (one nvcc
    each, all started together)."""
    from repro_torch.kernels import build
    paths = {}
    for name, edits in variants.items():
        text = source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} occurs "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        paths[name] = build.build_dir() / f"flash_mha_{name}.cu"
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(text)
    build.build(list(paths.values()))
    libs = {}
    for name, path in paths.items():
        lib = build.load(path)
        print(f"  variant {name}:")
        print_ptxas(build.BUILD_LOGS.get(str(path), ""))
        lib.flash_mha_wgmma_launch.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        lib.flash_mha_wgmma_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def lib_call(lib, q, k, v, kw):
    """One D 64 launch of a built copy, as ``ops._launch`` makes it."""
    from repro_torch.kernels.flash_attention import ops
    b, sq, hq, d = q.shape
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def call():
        err = lib.flash_mha_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            None, b, sq, k.shape[1], hq, k.shape[2], d, int(kw["causal"]),
            0, kw["window"], kw["sink"], 128, 128, 0, 1,
            ops.fwd_blocks(b, sq, hq, n_sm),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: {err}")
        return out
    return call


def check():
    """The D 64 kernel against the plain version in every mode, its lse,
    two calls bit for bit; D 96 and 128 once each."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(64)
    for name, B, Sq, Skv, Hq, Hkv, kw in CHECKS + [
            ("D 96 non-causal", 1, 300, 700, 4, 4, dict(causal=False)),
            ("D 128 causal GQA 2", 1, 512, 900, 4, 2, dict())]:
        D = 96 if name.startswith("D 96") else \
            128 if name.startswith("D 128") else 64
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
        kw = {**dict(block_q=128, block_kv=128), **kw}
        before = ops.flash_mha.launches_tc
        out, lse = ops._launch(q, k, v, Hkv, kw.get("causal", True),
                               kw.get("q_offset", 0), kw.get("window", 0),
                               kw.get("sink", 0), kw.get("sparsity", 0.0),
                               min(kw["block_q"], Sq),
                               min(kw["block_kv"], Skv), with_lse=True)
        again = ops.flash_mha(q, k, v, n_kv_heads=Hkv, **kw)
        torch.cuda.synchronize()
        want, lse_want = ref.flash_mha_ref(q, k, v, n_kv_heads=Hkv,
                                           return_lse=True, **{
                                               **kw, "block_q": min(
                                                   kw["block_q"], Sq),
                                               "block_kv": min(
                                                   kw["block_kv"], Skv)})
        err = float((out.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        limit = 2 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
        fin = torch.isfinite(lse_want)
        lse_err = float((lse - lse_want)[fin].abs().max()) if fin.any() \
            else 0.0
        same_inf = bool(torch.equal(torch.isfinite(lse), fin))
        bits = bool(torch.equal(out.view(torch.int16),
                                again.view(torch.int16)))
        ok = err <= limit and lse_err <= 2e-4 and same_inf and bits and \
            ops.flash_mha.launches_tc == before + 2
        print(f"  check D {D} {name}: |d| {err:.3g} (limit {limit:.3g}), "
              f"lse |d| {lse_err:.3g} (limit 2e-4), two calls bit for bit "
              f"{bits}: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"D {D} {name}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="3,3b,3c,3d,3e,3f,3g,train")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW, OLD and NEW with \\n for newlines")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--digest", action="store_true",
                    help="print each row's output and lse digest only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs the card")
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    ops._lib()
    print_ptxas(build.BUILD_LOGS.get(str(ops.SOURCE), ""))
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mhz = sm_clock_mhz()
    print(f"  card: {card}; clocks.max.sm {mhz:.0f} MHz", flush=True)
    if args.check:
        check()
    specs = {}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        specs[name] = [tuple(x.replace("\\n", "\n") for x in e.split("=>"))
                       for e in rest.split("||")]
    variants = variant_libs(ops.SOURCE, specs) if specs else {}
    gen = torch.Generator(device=DEV).manual_seed(7)
    results = {}
    for row in args.rows.split(","):
        q, k, v, kw = make(row, gen)
        if args.digest:
            out, lse = ops._launch(q, k, v, kw["n_kv_heads"], kw["causal"],
                                   0, kw["window"], kw["sink"], 0.0, 128,
                                   128, with_lse=True)
            h = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
            h.update(lse.cpu().numpy().tobytes())
            print(f"  digest row {row} {ROWS[row]}: {h.hexdigest()}",
                  flush=True)
            continue
        B, Sq, Skv, Hq, Hkv, D, causal, window, sink = ROWS[row]
        bound, by, ex2 = floors(B, Sq, Skv, Hq, Hkv, D, causal, window,
                                sink, mhz)
        iters = args.iters if Sq > 1 else 50 * args.iters
        if row == "train":
            fn = lambda: ops._launch(q, k, v, Hkv, True, 0, 0, 0, 0.0, 128,
                                     128, with_lse=True)
        else:
            fn = lambda: ops.flash_mha(q, k, v, **kw)
        lib = sdpa(q, k, v, kw)
        res = dict(kernel_ms=cuda_ms(fn, iters))
        for name, vlib in variants.items():
            if D == 64 and row != "train":
                call = lib_call(vlib, q, k, v, kw)
                res[name + "_ms"] = cuda_ms(call, iters)
                ref_out = fn()
                res[name + "_bits"] = bool(torch.equal(
                    call().view(torch.int16), ref_out.view(torch.int16)))
                res["kernel_ms_again"] = cuda_ms(fn, iters)
        if lib is not None:
            res["sdpa_ms"] = cuda_ms(lib, iters)
        if Sq == 1:
            res["host_ms"] = host_ms(fn, 50)
        res.update(bound_ms=bound, bound_by=by,
                   ex2_floor_ms=ex2 if D == 64 else None)
        results[row] = res
        print(f"  row {row} {ROWS[row]}: " + ", ".join(
            f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
            for a, b in res.items()), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=card, mhz=mhz,
                                                   rows=results), indent=1))


if __name__ == "__main__":
    main()
