#!/usr/bin/env python3
"""Where a CTA of the flash wgmma kernel spends its time, from %globaltimer.

    python3 scripts/flash_trace.py

Copies ``csrc/flash_attention.cu`` into ``build/flash_trace/`` with
timestamps inserted in ``flash_wgmma_kernel`` (each consumer warpgroup's
first thread: entry, Q landed, each K/V stage landed and released, the
three parts of the second stage's step, the end of the output's store),
builds it with the repository's nvcc flags, and runs it once at the
prefill shapes of both main paths and on [B*H, S, hd] inputs (B = 64, H =
Hkv = 1).  Prints, per shape, the graph-timed time of the repository's
kernel and of the copy with its stamps off, then from one stamped launch:
the kernel's span, when CTAs start, and the mean time of each phase by
the warpgroup's count of K/V stages.  The insertion points are found by
text: the script stops if the source no longer has one.  Needs one card;
imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 16  # per warpgroup: 0 entry, 1 Q, 2 + 2i / 3 + 2i stage i landed / released
            # (i < 4), 10-12 stage 1's S, softmax, P.V done, 14 end, 15 stage count
MAX_WGS = 4096
SHAPES = {"qwen3-0.6b": (4, 256, 16, 8), "jamba-v0.1-52b": (4, 256, 32, 8),
          "[BH, S, hd]": (64, 256, 1, 1)}

STAMPS = r'''
__device__ unsigned long long g_stamp[%(n)d];
__device__ int g_stamp_on = 1;
#define STAMP(i)                                                                       \
  do {                                                                                 \
    if (g_stamp_on && tid < kWgConsumers && tid %% 128 == 0 && blockIdx.x * 2 < %(w)d) { \
      unsigned long long t_;                                                           \
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_));                          \
      g_stamp[(blockIdx.x * 2 + tid / 128) * %(s)d + (i)] = t_;                          \
    }                                                                                  \
  } while (0)
''' % {"n": MAX_WGS * SLOTS, "w": MAX_WGS, "s": SLOTS}

# (anchor, replacement): every anchor must occur exactly once
EDITS = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + STAMPS),
    ("  const int tid = threadIdx.x;\n  if (tid == 0) {\n",
     "  const int tid = threadIdx.x;\n  STAMP(0);\n  if (tid == 0) {\n"),
    ("  mbar_wait(&q_full, 0);\n",
     "  mbar_wait(&q_full, 0);\n  STAMP(1);\n"
     "  if (g_stamp_on && tid % 128 == 0 && blockIdx.x * 2 < MAXW)"
     " g_stamp[(blockIdx.x * 2 + tid / 128) * SLOTS + 15] = n_kv;\n"),
    ("    mbar_wait(&full[s], (i / kWgStages) & 1);\n",
     "    mbar_wait(&full[s], (i / kWgStages) & 1);\n    if (i < 4) STAMP(2 + 2 * i);\n"),
    ("      wg_wait<0>();\n      fence_regs<32>(sc);\n",
     "      wg_wait<0>();\n      fence_regs<32>(sc);\n      if (i == 1) STAMP(10);\n"),
    ("      fence_regs<HD / 2>(acc);\n      wg_fence();\n",
     "      fence_regs<HD / 2>(acc);\n      if (i == 1) STAMP(11);\n      wg_fence();\n"),
    ("      wg_wait<0>();\n      fence_regs<HD / 2>(acc);\n",
     "      wg_wait<0>();\n      fence_regs<HD / 2>(acc);\n      if (i == 1) STAMP(12);\n"),
    ("    if (l == 0) mbar_arrive(&empty[s]);  // this warp no longer reads stage s\n",
     "    if (l == 0) mbar_arrive(&empty[s]);  // this warp no longer reads stage s\n"
     "    if (i < 4) STAMP(3 + 2 * i);\n"),
    ("    tma_store_wait();\n  }\n}\n", "    tma_store_wait();\n  }\n  STAMP(14);\n}\n"),
    ('extern "C" {\n', 'extern "C" {\n'
     "int stamps_read(void* host) {\n"
     "  return cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n"
     "int stamps_on(int on) { return cudaMemcpyToSymbol(g_stamp_on, &on, sizeof(int)); }\n"
     "int stamps_clear() {\n  void* p = nullptr;\n"
     "  const cudaError_t err = cudaGetSymbolAddress(&p, g_stamp);\n"
     "  return err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_stamp));\n}\n"),
]


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"flash_trace.py: anchor not found once: {anchor!r}")
        src = src.replace(anchor, new)
    src = src.replace("MAXW", str(MAX_WGS)).replace("SLOTS + 15", f"{SLOTS} + 15")
    out = _build.BUILD_DIR / "flash_trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_trace.cu").write_text(src)
    so = out / "libflash_trace.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(out / "flash_trace.cu")], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_trace.py: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = build()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    lib.flash_attention.argtypes = fa._lib().flash_attention.argtypes
    lib.stamps_read.argtypes, lib.stamps_on.argtypes, lib.stamps_clear.argtypes = \
        [ctypes.c_void_p], [ctypes.c_int], []
    for fn in (lib.flash_attention, lib.stamps_read, lib.stamps_on, lib.stamps_clear):
        fn.restype = ctypes.c_int

    def ok(err: int) -> None:
        if err:
            raise RuntimeError(f"flash_trace.py: CUDA error {err}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, h, hkv) in SHAPES.items():
        q, k, v = chip_smoke.flash_inputs(b, s, h, hkv, 128, torch.bfloat16, gen)
        out = torch.empty(b, s, h * 128, dtype=torch.bfloat16, device="cuda")

        def stamped():
            ok(lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, hkv, 128,
                *fa._strides(q), *fa._strides(k), *fa._strides(v), 1, 128 ** -0.5, 0,
                torch.cuda.current_stream().cuda_stream))

        kernel_ms = chip_smoke.time_ms(lambda: ops.mha_flash(q, k, v, scale=128 ** -0.5))
        ok(lib.stamps_on(0))
        copy_ms = chip_smoke.time_ms(stamped)
        ok(lib.stamps_on(1))
        ok(lib.stamps_clear())
        stamped()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (MAX_WGS * SLOTS))()
        ok(lib.stamps_read(buf))
        t = np.frombuffer(buf, dtype=np.uint64).reshape(-1, SLOTS).astype(np.int64)
        t = t[(t[:, 0] > 0) & (t[:, 14] > 0)]
        base, n_kv, sub = t[:, 0].min(), t[:, 15], t[:, 10] > 0
        us = (t - base) / 1e3
        print(f"{name}: ops.mha_flash {kernel_ms:.4f} ms, stamped copy with stamps off "
              f"{copy_ms:.4f} ms; one stamped launch spans {us[:, 14].max():.2f} us over "
              f"{len(t)} warpgroups")
        for n in sorted(set(n_kv.tolist())):
            sel, live1 = us[n_kv == n], us[(n_kv == n) & sub]
            steps = [sel[:, 3 + 2 * i] - sel[:, 2 + 2 * i] for i in range(min(n, 4))]
            waits = [sel[:, 2 + 2 * i] - (sel[:, 1] if i == 0 else sel[:, 1 + 2 * i])
                     for i in range(min(n, 4))]
            line = (f"  {n} stages, {len(sel)} warpgroups: start {sel[:, 0].mean():.2f}, "
                    f"Q landed +{(sel[:, 1] - sel[:, 0]).mean():.2f}, stage waits "
                    f"{[round(float(w.mean()), 2) for w in waits]}, steps "
                    f"{[round(float(x.mean()), 2) for x in steps]}")
            if n <= 4:
                line += f", store +{(sel[:, 14] - sel[:, 1 + 2 * n]).mean():.2f}"
            if len(live1):  # warpgroups that computed stage 1
                line += (f"; stage 1: S {(live1[:, 10] - live1[:, 4]).mean():.2f}, softmax "
                         f"{(live1[:, 11] - live1[:, 10]).mean():.2f}, P.V "
                         f"{(live1[:, 12] - live1[:, 11]).mean():.2f}")
            print(line + f"; end {sel[:, 14].mean():.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
