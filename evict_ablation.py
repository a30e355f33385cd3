#!/usr/bin/env python3
"""Ablations of the eviction-set kernel on one NVIDIA card.

    python3 evict_ablation.py

Builds ``nomad_tpu_torch/csrc/eviction_sets.cu`` and variants of it, each
with one part of the work taken out or one launch constant changed (text
replacements, each checked to apply exactly once), and times them in
turns at ``chip_smoke.py``'s ``PREEMPT_TIMES`` shapes on the same
HBM-cold inputs (``chip_smoke.evict_case``): the profiler's median over
100 launches, twice in each order.  Beside them, the device time of one
fill and one copy of the pass's output bytes: what writing them costs the
card alone.  Prints one JSON line a shape, then the card's name and power
limit.  The variants' outputs are wrong by design; they are only timed.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# name -> [(text of csrc/eviction_sets.cu, its replacement)].
VARIANTS = {
    "full": [],
    # The post-eviction ScoreFit (two divides, two powf) replaced by a sum.
    "no_score": [("g.score[cell] = nomad::score_fit(nd, zero);",
                  "g.score[cell] = nd.used_cpu + nd.used_mem;")],
    # k* = 1 without the search (and so, mostly, no trim).
    "no_search": [("if (!fits0) kstar = first_fit<kA>(cm, need, A);",
                   "if (!fits0) kstar = 1;")],
    # No trim: the prefix is the mask.
    "no_trim": [("const int top = feasible ? (regular ? kstar - 2 : "
                 "kstar - 1) : -1;", "const int top = -1;")],
    # No pair at all: the launch, the staging and the once-a-node pass.
    "no_pairs": [("for (int ul = warp * group + lane / T; ul < uc; "
                  "ul += kWarps * group) {",
                  "for (int ul = warp * group + lane / T; ul < 0; "
                  "ul += kWarps * group) {")],
    # Every output folded into a checksum stored once: the work without
    # its stores.
    "no_stores": [
        ("  const int4 zero = make_int4(0, 0, 0, 0);\n\n  for (int ul",
         "  const int4 zero = make_int4(0, 0, 0, 0);\n  uint32_t acc = 0;\n\n"
         "  for (int ul"),
        ("      store_mask<kA>(mask, bits);", "      acc ^= (uint32_t)bits;"),
        ("    g.feasible[cell] = feasible ? 1 : 0;\n"
         "    g.n_evict[cell] = evict;\n"
         "    g.score[cell] = nomad::score_fit(nd, zero);\n  }\n}",
         "    acc ^= (feasible ? 1u : 0u) ^ (uint32_t)evict ^\n"
         "           __float_as_uint(nomad::score_fit(nd, zero)) ^ "
         "(uint32_t)cell;\n  }\n"
         "  if (acc == 0x9e3779b9u) g.n_evict[0] = (int)acc;\n}")],
    # 64 registers a thread (eight blocks an SM) in place of 80.
    "regs_64": [("constexpr int kMinBlocks = 6;",
                 "constexpr int kMinBlocks = 8;")],
    # Twice the spec chunks: two rounds of blocks, each staging its tile.
    "two_rounds": [("(per_sm > 0 ? per_sm : 1) /\n",
                    "(per_sm > 0 ? per_sm : 1) * 2 /\n")],
}


def variant_sources(src: str) -> dict:
    out = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"evict_ablation: variant {name}: the text "
                                 f"{old!r} is not in the kernel once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(variants: dict) -> dict:
    """nvcc every variant (all started together) with the port's flags;
    name -> its C entry point."""
    from nomad_tpu_torch import device as devmod
    from nomad_tpu_torch.ops import fused_score

    out_dir = os.path.join(REPO, "build", "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [devmod.find_nvcc(), *devmod.NVCC_FLAGS, "-I", str(devmod.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    symbol, argtypes = fused_score._C_API["eviction_sets"]
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"evict_ablation: nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    try:
        import torch
    except ImportError:
        print("evict_ablation: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("evict_ablation: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from nomad_tpu_torch.ops import fused_score

    src_path = os.path.join(REPO, "nomad_tpu_torch", "csrc",
                            "eviction_sets.cu")
    with open(src_path) as f:
        fns = build(variant_sources(f.read()))
    mine = fused_score._fn("eviction_sets")
    try:
        for u, n, a in c.PREEMPT_TIMES:
            call, _, nbytes, nops = c.evict_case("cuda", u, n, a)
            times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]) * 2:
                for name in order:
                    fused_score._FNS["eviction_sets"] = fns[name]
                    times[name].append(c.kernel_device_ms(
                        call, "eviction_sets_kernel", 100))
            out_bytes = u * n * (a + 9)
            dst = torch.empty(out_bytes, dtype=torch.uint8, device="cuda")
            src = torch.empty_like(dst)
            c.emit({"shape": [u, n, a], "bytes": nbytes,
                    "bound_us": c.bound_of(nbytes, nops)[0] * 1e3,
                    "median_us": {k: statistics.median(v) * 1e3
                                  for k, v in times.items()},
                    "spread_us": {k: (max(v) - min(v)) * 1e3
                                  for k, v in times.items()},
                    "output_bytes": out_bytes,
                    "fill_us": c.kernel_device_ms(lambda: dst.fill_(1), "",
                                                  100) * 1e3,
                    "copy_us": c.kernel_device_ms(lambda: dst.copy_(src), "",
                                                  100) * 1e3})
    finally:
        fused_score._FNS["eviction_sets"] = mine
    print(c.smi_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
