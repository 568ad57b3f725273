"""Where the SSD scan's tensor-core kernel spends its time.

Two measurements on the card, bf16 x/B/C at mamba2-780m's (P, N) =
(64, 128), chunk 128, x/B/C as views of one conv output as the model
passes them:

* the kernel's time (CUDA events, 20 calls after a warm-up) at shapes
  that separate the chain across chunks from the work per block: one
  chain (B = 1, one group of 6 heads), a few chains, and the full width
  (B = 2, 48 heads: 16 chains of 256 chunks, 4,096 blocks); each with
  the time per chunk step (kernel time / chunks) and per block slot
  (kernel time x 132 SMs / blocks);
* with ``--phases``, a copy of ``csrc/ssd_scan.cu`` built with a
  ``clock64`` mark after each phase of a head (the X tile ready, y = W X,
  the chunk state, the entering state read, the outgoing state stored and
  its flag raised, the entering state's bf16 tile written, the C state^T
  products, the y store),
  read back after a full-width call: the median cycles of each phase
  over the blocks, heads 1-4.  The marks cost a few cycles each; the
  copy is built next to the kernels (``build.build_dir()``)::

    python -m repro_torch.launch.profile_ssd [--phases]
"""
from __future__ import annotations

import argparse
import ctypes

import torch
import torch.nn.functional as F

SHAPES = ((1, 32768, 6), (2, 32768, 6), (2, 32768, 24), (2, 32768, 48),
          (8, 4096, 48))
P, N, CHUNK, HG, SMS = 64, 128, 128, 6, 132
# the phase marks: (label, line of ssd_wgmma_kernel after which the mark
# goes, slot); a head k's slots are STRIDE k + slot, the CB phase's is 0
MARKS = (("X ready", "    mbar_wait(&bars[1 + k % XS], (k / XS) & 1);", 1),
         ("y = W X", "      fence_regs(yacc);", 2),
         ("chunk state", "      fence_regs(contrib);", 3),
         ("entering state read", "    const float decay = expf(cs[QT - 1]);", 4),
         ("outgoing state, flag", "      if (lane == 0) st_release_gpu(flag, c + 1);"
          "\n    }", 5),
         ("state tile written", "    fence_proxy_async();\n    __syncthreads();"
          "\n\n    // y += exp(cs_i) (C state^T)", 6),
         ("C state^T", "    fence_regs(yi);", 7),
         ("y stored", "      bulk_commit();\n    }", 8))
STRIDE = 10
MAX_BLOCKS = 4096


def inputs(B, S, H, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device=dev).bfloat16()
    xi, Bp, Cp = torch.split(xbc, [H * P, N, N], dim=-1)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev) - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    return (xi.reshape(B, S, H, P), dt, A, Bp.reshape(B, S, 1, N),
            Cp.reshape(B, S, 1, N))


def cuda_ms(fn, iters=20):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def marked_source(src: str) -> str:
    """The kernel's source with a clock64 mark per phase into a device
    array, and a C function that copies the array out."""
    mark = ("  if ((tid & 127) == 0) g_marks[(ticket * 2 + tid / 128) * 64 + "
            "{slot}] = clock64() - t_start;")
    anchor = "  const int ticket = *s_ticket;"
    if anchor not in src:
        raise RuntimeError("ssd_scan.cu changed: the ticket line is gone")
    src = src.replace(anchor, anchor + "\n  const long long t_start = "
                      "clock64();", 1)
    for label, line, slot in (("C B^T", "  fence_regs(cb);", "0"),) + tuple(
            (label, line, f"{STRIDE} * k + {slot}")
            for label, line, slot in MARKS):
        at = src.find(line)
        if at < 0:
            raise RuntimeError(f"ssd_scan.cu changed: no mark for {label}")
        end = src.index("\n", at + len(line)) + 1     # after that line
        src = src[:end] + mark.format(slot=slot) + "\n" + src[end:]
    src = src.replace("using namespace hopper;\n", "using namespace hopper;"
                      f"\n__device__ long long g_marks[{MAX_BLOCKS} * 2 * 64];"
                      "\n", 1)
    return src + ('\nextern "C" int ssd_marks_copy(void* dst, unsigned long '
                  'long bytes) {\n  return static_cast<int>(cudaMemcpyFrom'
                  'Symbol(dst, tc::g_marks, bytes));\n}\n')


def phases(dev) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops

    path = build.build_dir() / "ssd_scan_marked.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(marked_source(ops.SOURCE.read_text()))
    # build.load looks headers up beside the source, then in common/csrc
    lib = build.load(path)
    lib.ssd_marks_copy.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    saved = ops.SOURCE
    ops.SOURCE = path                  # ops._lib() loads the marked copy
    try:
        B, S, H = 2, 32768, 48
        x, dt, A, Bm, Cm = inputs(B, S, H, dev)
        for _ in range(3):
            ops.ssd(x, dt, A, Bm, Cm, chunk=CHUNK)
        torch.cuda.synchronize()
    finally:
        ops.SOURCE = saved
    blocks = B * (S // CHUNK) * (H // HG)
    buf = torch.zeros(MAX_BLOCKS * 2 * 64, dtype=torch.int64, device=dev)
    if lib.ssd_marks_copy(buf.data_ptr(), buf.numel() * 8) != 0:
        raise RuntimeError("could not read the marks")
    marks = buf.view(MAX_BLOCKS, 2, 64)[:blocks, 0].double().cpu()
    print(f"phases of a head at B={B} S={S} H={H}, median cycles over "
          f"{blocks} blocks (warpgroup 0), heads 1-4:")
    print(f"  C B^T (from the block's start): "
          f"{marks[:, 0].median().item():.0f}")
    for i, (label, _, slot) in enumerate(MARKS):
        cycles = []
        for k in range(1, 5):
            # from the previous phase's mark (the first phase: from the
            # previous head's last)
            start = marks[:, STRIDE * (k - 1) + MARKS[-1][2]] if i == 0 \
                else marks[:, STRIDE * k + MARKS[i - 1][2]]
            cycles.append((marks[:, STRIDE * k + slot] - start).median()
                          .item())
        print(f"  {label:26s} {' '.join(f'{c:7.0f}' for c in cycles)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase of a head in a marked copy")
    args = ap.parse_args()
    from repro_torch.kernels.ssd_scan import ops

    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; chunk {CHUNK}, groups of {HG} "
          f"heads, (P, N) = ({P}, {N}), bf16 views")
    for B, S, H in SHAPES:
        x, dt, A, Bm, Cm = inputs(B, S, H, dev)
        if ops.kernel_path(x.dtype, P, N, ops._tma_aligned(x, Bm, Cm)) \
                != "wgmma":
            raise RuntimeError("the shape does not take the tensor cores")
        ms = cuda_ms(lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=CHUNK))
        chunks = S // CHUNK
        blocks = B * chunks * -(-H // HG)
        print(f"  B={B} S={S} H={H}: {ms:.3f} ms, {B * -(-H // HG)} chains "
              f"of {chunks} chunks, {ms * 1e3 / chunks:.2f} us per chunk "
              f"step, {ms * 1e3 * SMS / blocks:.1f} us per block slot")
        del x, dt, A, Bm, Cm
    if args.phases:
        phases(dev)


if __name__ == "__main__":
    main()
