"""Kernel 3's forward on the card at the shapes the models give it.

Times ``ops.flash_mha`` (CUDA events around ``--iters`` calls after a
warm-up) beside SDPA on the same q/k/v, at the rows of ``PERF.md``'s
kernel table (phase 3 of ``chip_smoke.py`` runs the same shapes):

* ``3``: ardit-self-forcing's sequential attention, B 1, 2,640 queries
  over 21,197 keys, 12 heads of 128, non-causal;
* ``3b`` / ``3c`` / ``3d``: the causal prefills of granite-moe (D 64),
  minitron-8b (D 128, GQA 4) and Jamba (sink 128 + window 8,192), B 2 x
  32,768; ``3h``: internvl2-26b's causal prefill, B 1 x 8,192, 48 / 8
  heads of 128;
* ``3e`` / ``3f`` / ``3g``: whisper-medium's encoder (1,500 x 1,500), its
  prefill cross-attention (32,768 x 1,500) and a decode step's (1 x
  1,500), B 2, 16 heads of 64; 3g is also timed on the host clock over
  back-to-back calls (what a decode loop pays a call);
* ``train``: minicpm-2b's training forward (B 2, 4,096 causal, 36 heads
  of 64) writing the lse its backward reads;
* ``3s`` / ``3s-b4`` / ``3s-d96``: the seeded form (``flash_mha_seeded``,
  ``paged_mha``'s in-chunk segment) at ardit-self-forcing's 832x480
  chunk, 4,680 queries over their own 4,680 keys, 12 heads of 128, B 1
  and 4, and at ardit-causal-forcing's, 2,640 x 2,640, 16 heads of 96,
  B 1, from random partials; beside it SDPA over the chunk (its flash
  backend, which also gives each row's log-sum-exp) followed by the plain
  merge with the partials, divide and layout, and the plain version
  (``ref.flash_mha_seeded_ref``), against which the kernel's output is
  checked (2 bf16 ulps at the largest magnitude).

Each row prints the kernel's ms, SDPA's, the bound (operations at 989
TFLOP/s or bytes at 3.35 TB/s) and, at D 64, the exponential floor: the
row's exponentials (one per visible (query, key) pair) at 16 a clock an
SM on 132 SMs at the SM clock ``nvidia-smi --query-gpu=clocks.max.sm``
reports.  ``--check`` first holds the D 64 kernel to the plain version
in every mode it takes (non-causal with partial tiles on both axes, Sq
1, causal GQA with q_offset, sink + window, rho, rows that see nothing)
and the D 128 causal instance in its mode (GQA 4 and 6, q_offset > 0
and < 0, partial tiles, more items than SMs), their lse to the plain
version's, and two calls bit for bit.
``--variant NAME=OLD=>NEW[||OLD=>NEW...]`` (repeatable; OLD and NEW
hold neither ``=>`` nor ``||``; ``NAME=`` alone: no edit) also times a
copy of ``csrc/flash_mha.cu`` with each text OLD replaced by NEW at the
rows of the persistent instances (D 64, D 128 causal), in turns with the
source as it is; with ``--general`` a D 128 row's copy runs on the
general tensor-core kernel instead, to time it and edits of it.
``--burst N`` times each row as ``chip_smoke.py`` does, in short bursts
off a rested card: N rounds of the kernel, each variant and SDPA in
turns (the order reversed every other round), ``--iters`` calls each
after 1.5 s of rest, and prints each one's sorted times.
``--power`` also runs the kernel and SDPA back to back for two seconds
each and prints the mean SM clock and power draw ``nvidia-smi`` sampled
meanwhile (a card at its power limit lowers its clock).
``--sass FILE`` writes the order of each tensor-core forward's products,
waits, barriers and exponentials in the built SASS to FILE and prints,
for each wait on the products (``WARPGROUP.DEPBAR``), the ``MUFU.EX2``
issued since the last one.  ``--digest`` prints a SHA-256 of each row's
output and lse instead of timing it, so that two trees run on one card
can be compared bit for bit::

    PYTHONPATH=src python -m repro_torch.launch.profile_flash [--check]
        [--rows 3e,3f] [--iters 20] [--variant ...] [--general]
        [--burst N] [--power] [--sass FILE] [--digest]
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
    "3h": (1, 8192, 8192, 48, 8, 128, True, 0, 0),
    "3d": (2, 32768, 32768, 32, 8, 128, True, 8192, 128),
    "3e": (2, 1500, 1500, 16, 16, 64, False, 0, 0),
    "3f": (2, 32768, 1500, 16, 16, 64, False, 0, 0),
    "3g": (2, 1, 1500, 16, 16, 64, False, 0, 0),
    "train": (2, 4096, 4096, 36, 36, 64, True, 0, 0),
    # ardit-causal-forcing's heads of 96 (phase 3's case)
    "d96": (1, 660, 2057, 16, 16, 96, False, 0, 0),
}
# the seeded form's rows: name -> (B, Sq = Skv, H, D)
SEEDED_ROWS = {
    "3s": (1, 4680, 12, 128),
    "3s-b4": (4, 4680, 12, 128),
    "3s-d96": (1, 2640, 16, 96),
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
# the D 128 causal instance's modes (tests/test_torch_kernel_cuda.py's
# FLASH_D128_CAUSAL_MODES)
CHECKS_D128 = [
    ("causal GQA 4, 1,024", 2, 1024, 1024, 8, 2, dict()),
    ("causal GQA 6, q_offset 300, partial tiles", 1, 700, 1000, 12, 2,
     dict(q_offset=300, block_q=700)),
    ("q_offset -150: an item that sees nothing", 1, 300, 200, 4, 1,
     dict(q_offset=-150, block_q=300)),
    ("Sq 1 at q_offset 1,499", 2, 1, 1500, 8, 2, dict(q_offset=1499)),
    ("ragged 777, GQA 1", 1, 777, 777, 6, 6, dict(block_q=777)),
    ("more items than SMs", 2, 4096, 4096, 32, 8, dict()),
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


def clock_power(fn, seconds=2.0):
    """(mean SM clock MHz, mean power draw W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for ``seconds`` (the first
    quarter of the samples, the ramp, left out)."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "-i", "0",
                            "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [[float(x) for x in line.split(",")]
            for line in smi.communicate()[0].splitlines() if line.strip()]
    rows = rows[len(rows) // 4:] or [[float("nan")] * 2]
    return (sum(r[0] for r in rows) / len(rows),
            sum(r[1] for r in rows) / len(rows))


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
        if "wgmma" in name or "seeded" in name:
            regs = [ln.strip() for ln in block.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  ptxas {name[-40:]}: {' | '.join(regs)}")
    print(f"  ptxas notes: {log.count('Potential Performance Loss')} "
          f"'Potential Performance Loss'")
    for line in log.splitlines():
        if "Performance Loss" in line:
            print("   ", line.strip()[:200])


def bind_flash(lib):
    """Argument types of a built ``flash_mha.cu``'s tensor-core entry."""
    lib.flash_mha_wgmma_launch.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p] * 2
    lib.flash_mha_wgmma_launch.restype = ctypes.c_int
    return lib


def variant_libs(source, variants, bind=bind_flash):
    """Copies of ``source``, one per name in ``variants`` with each of its
    (old, new) edits applied once, built beside the kernels (one nvcc
    each, all started together), each passed through ``bind`` (which
    sets its entry points' argument types)."""
    from repro_torch.kernels import build
    paths = {}
    for name, edits in variants.items():
        text = source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} occurs "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        paths[name] = build.build_dir() / f"{source.stem}_{name}.cu"
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(text)
    build.build(list(paths.values()))
    libs = {}
    for name, path in paths.items():
        lib = build.load(path)
        print(f"  variant {name}:")
        print_ptxas(build.BUILD_LOGS.get(str(path), ""))
        libs[name] = bind(lib)
    return libs


def persistent(q, kw):
    """The persistent instance a row's calls take, or None."""
    from repro_torch.kernels.flash_attention import ops
    inst = ops.fwd_instance(q.dtype, q.shape[-1], kw["causal"],
                            kw["window"], kw["sink"], 0.0)
    return inst if inst in ops.FWD_ITEM_QUERIES else None


def lib_call(lib, q, k, v, kw, general=False):
    """One launch of a built copy, as ``ops._launch`` makes it on a
    persistent instance's row; ``general``: on the general kernel."""
    from repro_torch.kernels.flash_attention import ops
    b, sq, hq, d = q.shape
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_blocks = 0 if general else ops.fwd_blocks(
        b, sq, hq, n_sm, ops.FWD_ITEM_QUERIES[persistent(q, kw)])
    sched = torch.zeros(1, dtype=torch.int32, device=q.device)

    def call():
        sched.zero_()
        err = lib.flash_mha_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            None, b, sq, k.shape[1], hq, k.shape[2], d, int(kw["causal"]),
            0, kw["window"], kw["sink"], 128, 128, 0, 1, n_blocks,
            sched.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: {err}")
        return out
    return call


def seeded_row(row, gen, iters, mhz):
    """One row of the seeded form: the kernel, SDPA + the plain merge and
    the plain version timed on the same inputs, the kernel's output
    checked against the plain version's, the bound and exponential
    floor."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, H, D = SEEDED_ROWS[row]
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEV)
               .bfloat16() for _ in range(3))
    m = torch.randn((B, H, 1, S), generator=gen, device=DEV)
    l = 1.0 + torch.rand((B, H, 1, S), generator=gen, device=DEV)
    acc = torch.randn((B, H, 1, S, D), generator=gen, device=DEV)
    fn = lambda: ops.flash_mha_seeded(q, k, v, m, l, acc, n_kv_heads=H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    m3, l3, acc3 = m[:, :, 0], l[:, :, 0], acc[:, :, 0]

    def sdpa_merge():
        out, lse = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, False)[:2]
        mx = torch.maximum(m3, lse)
        c0, c1 = torch.exp(m3 - mx), torch.exp(lse - mx)
        o = (acc3 * c0[..., None] + out.float() * c1[..., None]) \
            / (l3 * c0 + c1)[..., None]
        return o.to(q.dtype).transpose(1, 2).contiguous()

    plain = lambda: ref.flash_mha_seeded_ref(q, k, v, m, l, acc,
                                             n_kv_heads=H)
    got, want, lib = fn(), plain(), sdpa_merge()
    torch.cuda.synchronize()
    top = float(want.float().abs().max())
    limit = 2 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    err = float((got.float() - want.float()).abs().max())
    lib_err = float((lib.float() - want.float()).abs().max())
    flops = 4.0 * B * H * S * S * D
    nbytes = 2 * 4 * B * S * H * D + 4 * B * H * S * (D + 2)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
    res = dict(kernel_ms=cuda_ms(fn, iters),
               sdpa_merge_ms=cuda_ms(sdpa_merge, iters),
               plain_ms=cuda_ms(plain, 3),
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ex2_floor_ms=B * H * S * S / (EX2_PER_CLOCK_SM * SMS * mhz
                                             * 1e6) * 1e3,
               err=err, limit=limit, sdpa_merge_err=lib_err,
               ok=err <= limit)
    res["roofline_pct"] = 100.0 * res["bound_ms"] / res["kernel_ms"]
    print(f"  row {row} {SEEDED_ROWS[row]}: " + ", ".join(
        f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
        for a, b in res.items()), flush=True)
    if not res["ok"]:
        raise AssertionError(f"row {row}: |d| {err} > {limit}")
    return res


def check():
    """The D 64 kernel in every mode and the D 128 causal instance in
    its mode against the plain version, their lse, two calls bit for bit;
    D 96 and D 128's general kernel once each."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(64)
    for name, B, Sq, Skv, Hq, Hkv, kw in CHECKS + [
            ("D 96 non-causal", 1, 300, 700, 4, 4, dict(causal=False)),
            ("D 128 sink 77 + window 256, GQA 2", 1, 512, 900, 4, 2,
             dict(window=256, sink=77))] + [
            ("D 128 " + c[0],) + c[1:] for c in CHECKS_D128]:
        D = 96 if name.startswith("D 96") else \
            128 if name.startswith("D 128") else 64
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
        kw = {**dict(block_q=128, block_kv=128), **kw}
        before = ops.flash_mha.launches_tc
        before128 = ops.flash_mha.launches_d128_causal
        want128 = 2 * int(ops.fwd_instance(
            q.dtype, D, kw.get("causal", True), kw.get("window", 0),
            kw.get("sink", 0), kw.get("sparsity", 0.0)) == "wgmma128_causal")
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
            ops.flash_mha.launches_tc == before + 2 and \
            ops.flash_mha.launches_d128_causal == before128 + want128
        print(f"  check D {D} {name}: |d| {err:.3g} (limit {limit:.3g}), "
              f"lse |d| {lse_err:.3g} (limit 2e-4), two calls bit for bit "
              f"{bits}, D 128 causal instance {want128 > 0}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"D {D} {name}")


def sass_order(path, out_file):
    """Writes, for each tensor-core forward in the library at ``path``,
    its SASS reduced to products (HGMMA), waits on them (WARPGROUP.DEPBAR),
    barriers, branches and runs of exponentials, into ``out_file``; prints
    for each wait how many MUFU.EX2 were issued since the previous one."""
    import re
    import shutil
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    lines = []
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        if "wgmma" not in name:
            continue
        lines.append(f"== {name}")
        waits, n_ex2 = [], 0
        for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", func):
            if "MUFU.EX2" in ins:
                n_ex2 += 1
                continue
            if re.search(r"HGMMA|DEPBAR|BAR\.|SYNCS|\bBRA\b|SETMAXREG|"
                         r"EXIT|STL|LDL", ins):
                lines.append(f"{n_ex2:3d} MUFU.EX2 then {ins[:80]}")
                if "WARPGROUP.DEPBAR" in ins:
                    waits.append(f"{ins.split()[-1]}:{n_ex2}")
                n_ex2 = 0
        print(f"  sass {name[-48:]}: MUFU.EX2 before each WARPGROUP.DEPBAR"
              f" (wait level:count): {' '.join(waits)}", flush=True)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    Path(out_file).write_text("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="3,3b,3c,3d,3e,3f,3g,3h,train")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW, OLD and NEW with \\n for newlines")
    ap.add_argument("--general", action="store_true",
                    help="run the variants' D 128 rows on the general kernel")
    ap.add_argument("--sass", default=None,
                    help="write the forwards' SASS order here")
    ap.add_argument("--burst", type=int, default=0,
                    help="rounds of rested short-burst timings in turns")
    ap.add_argument("--power", action="store_true",
                    help="sample SM clock and power while kernel / SDPA run")
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
    if args.sass:
        sass_order(build._target(ops.SOURCE), args.sass)
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
                       for e in rest.split("||")] if rest else []
    variants = variant_libs(ops.SOURCE, specs) if specs else {}
    gen = torch.Generator(device=DEV).manual_seed(7)
    results = {}
    for row in args.rows.split(","):
        if row in SEEDED_ROWS:
            results[row] = seeded_row(row, gen, args.iters, mhz)
            torch.cuda.empty_cache()
            continue
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
        if args.burst:
            fns = {"kernel": fn, **{
                name: lib_call(vlib, q, k, v, kw,
                               general=args.general and D == 128)
                for name, vlib in variants.items() if persistent(q, kw)}}
            if lib is not None:
                fns["sdpa"] = lib
            times = {name: [] for name in fns}
            for rnd in range(args.burst):
                for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                    time.sleep(1.5)
                    times[name].append(round(cuda_ms(fns[name], iters), 4))
            print(f"  burst row {row} {ROWS[row]}: " + ", ".join(
                f"{name} {sorted(ts)}" for name, ts in times.items()),
                flush=True)
            results[row] = times
            continue
        res = dict(kernel_ms=cuda_ms(fn, iters))
        for name, vlib in variants.items():
            if persistent(q, kw) and row != "train":
                call = lib_call(vlib, q, k, v, kw,
                                general=args.general and D == 128)
                res[name + "_ms"] = cuda_ms(call, iters)
                ref_out = fn()
                res[name + "_bits"] = bool(torch.equal(
                    call().view(torch.int16), ref_out.view(torch.int16)))
                res.setdefault("kernel_ms_again", []).append(
                    round(cuda_ms(fn, iters), 4))
        if lib is not None:
            res["sdpa_ms"] = cuda_ms(lib, iters)
        if args.power:
            res["kernel_mhz"], res["kernel_w"] = clock_power(fn)
            if lib is not None:
                res["sdpa_mhz"], res["sdpa_w"] = clock_power(lib)
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
