"""Where K3's time goes: ``fused_flat.cu`` built in cut-down variants.

    python -m tdr_torch.tools.flat_variants

Each variant is the kernel's source with one part taken out, built by its
own ``nvcc`` (all in parallel) into ``tdr_torch/csrc/build/variants/``:

* layout ``resident`` (the query tile's depth held in shared memory and
  the ring's bytes that are left for the embeddings: 4 stages for rows of
  up to 512 bytes, 3 for 768; what the library runs for such rows) or
  ``streamed`` (both operands through the 4-stage ring, what it runs for
  deeper rows);
* body ``full``, ``no_epilogue`` (no group-of-8 max and no store),
  ``no_mma`` (no wgmma) or ``loads_only`` (neither).

The full variants are held against the plain version (rtol 1e-5, atol
1e-5, on unit-norm bf16 rows or random int8 codes); the
others compute nothing meaningful and are only timed (CUDA events, the best
of 5 rounds of 20 calls, the variants interleaved).  Shapes: the dense
pass's (Qp 2048, N 268,032, D 384 bf16), the same queries at D 256
(N 262,144) and the bench shape's (Qp 256, N 262,144, D 256, bf16 and
int8).  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from tdr_torch.ops import cuda_build
from tdr_torch.ops import fused_flat as ff

VARIANT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")
_STORE = "      store_group_max(score, out, ng, q_lo, n0 / 8);"
_NO_STORE = "      if (acc[0] == Acc(12345)) out[0] = 1.0f;   // keeps acc live"
_MMA = """          if constexpr (kInt8)
            wgmma_m64n256k32_s8(acc, da, db);
          else
            wgmma_m64n256k16_bf16<0>(acc, da, db);"""
_NO_MMA = "          (void)da; (void)db;"
_RESIDENT = "const bool resident = kt <= hopper::kResidentSlices;"
SHAPES = ((2048, 268_032, 384, torch.bfloat16),
          (2048, 262_144, 256, torch.bfloat16),
          (256, 262_144, 256, torch.bfloat16),
          (256, 262_144, 256, torch.int8))


def variant_sources(src: str) -> dict:
    """{(layout, body): source text}; fails if an anchor moved."""
    for anchor in (_STORE, _MMA, _RESIDENT):
        if src.count(anchor) != 1:
            raise RuntimeError(f"fused_flat.cu: anchor not found once: {anchor!r}")
    out = {}
    for layout in ("resident", "streamed"):
        base = src if layout == "resident" else src.replace(
            _RESIDENT, "const bool resident = false;")
        out[(layout, "full")] = base
        out[(layout, "no_epilogue")] = base.replace(_STORE, _NO_STORE)
        out[(layout, "no_mma")] = base.replace(_MMA, _NO_MMA)
        out[(layout, "loads_only")] = base.replace(_MMA, _NO_MMA).replace(
            _STORE, _NO_STORE)
    return out


def build_variants() -> dict:
    """Compile every variant in parallel; {(layout, body): (bf16, int8)}."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    with open(os.path.join(cuda_build.SRC_DIR, "fused_flat.cu")) as f:
        sources = variant_sources(f.read())
    exe = cuda_build.nvcc()
    procs = {}
    for (layout, body), text in sources.items():
        stem = os.path.join(VARIANT_DIR, f"{layout}_{body}")
        with open(stem + ".cu", "w") as f:
            f.write(text)
        cmd = [exe, *cuda_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-shared", "-I", cuda_build.SRC_DIR, stem + ".cu",
               "-o", stem + ".so"]
        procs[(layout, body)] = (stem + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(so)
        pair = []
        for name in ("tdr_fused_flat_bf16", "tdr_fused_flat_int8"):
            fn = getattr(lib, name)
            fn.argtypes = cuda_build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[key] = tuple(pair)
    return fns


def _operands(Qp, N, D, dtype, gen):
    dev = "cuda"
    if dtype == torch.int8:
        q = torch.randint(-127, 128, (Qp, D), device=dev, generator=gen,
                          dtype=torch.int8)
        e = torch.randint(-127, 128, (N, D), device=dev, generator=gen,
                          dtype=torch.int8)
        scales = (torch.rand(N, device=dev, generator=gen) / 100,
                  torch.rand(Qp, device=dev, generator=gen) / 100)
    else:
        # unit rows, as the bench's embeddings: scores within [-1, 1]
        q = torch.randn((Qp, D), device=dev, generator=gen)
        e = torch.randn((N, D), device=dev, generator=gen)
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        e = (e / e.norm(dim=1, keepdim=True)).to(dtype)
        scales = (None, None)
    bias = torch.randn(N, device=dev, generator=gen) / 100
    return q, e, bias, scales


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flat_variants: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for Qp, N, D, dtype in SHAPES:
        q, e, bias, (dscale, qscale) = _operands(Qp, N, D, dtype, gen)
        out = torch.empty((Qp, N // 8), device="cuda")
        is_int8 = dtype == torch.int8

        def run(key):
            fn = fns[key][1 if is_int8 else 0]
            if is_int8:
                err = fn(q.data_ptr(), e.data_ptr(), bias.data_ptr(),
                         dscale.data_ptr(), qscale.data_ptr(), out.data_ptr(),
                         Qp, D, N, 1.0, stream)
            else:
                err = fn(q.data_ptr(), e.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), Qp, D, N, 1.0, stream)
            cuda_build.check(err, f"fused_flat variant {key}")

        plain = ff.fused_flat_blockmax_plain(q, e, bias, 1.0, dscale, qscale)
        for layout in ("resident", "streamed"):
            run((layout, "full"))
            torch.cuda.synchronize()
            err = (out - plain).abs()
            if not bool((err <= 1e-5 * plain.abs() + 1e-5).all()):
                sys.exit(f"flat_variants: {layout} layout differs from the "
                         f"plain version at Qp={Qp} N={N} D={D} {dtype} (max "
                         f"abs err {err.max().item():.3e})")
        del plain
        best = {}
        for _ in range(5):
            for key in fns:
                for _ in range(3):
                    run(key)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run(key)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                best[key] = min(best.get(key, ms), ms)
        for layout in ("resident", "streamed"):
            print(f"[flat_variants] Qp={Qp} N={N} D={D} {str(dtype)[6:]} "
                  f"{layout}: " + ", ".join(
                      f"{body} {best[(layout, body)]:.5f} ms"
                      for body in ("full", "no_epilogue", "no_mma",
                                   "loads_only")), flush=True)
        print(f"[flat_variants] Qp={Qp} N={N} D={D} {str(dtype)[6:]}: both "
              f"full layouts within rtol 1e-5 of the plain version "
              f"on {card}", flush=True)


if __name__ == "__main__":
    main()
