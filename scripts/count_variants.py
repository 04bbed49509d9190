"""Time variants of the retrieval-count kernel on one card, on synthetic
inputs at the engines' shapes, beside another tree's kernel.

    mkdir -p _chipcopy/a && git archive <commit> | tar -x -C _chipcopy/a
    python3 scripts/count_variants.py [_chipcopy/a]

Each variant is this tree's ``csrc/retrieval_count.cu`` with one or two of
its constants replaced (the column tile's bounds, the loads in flight, the
R split's cap), built with the port's nvcc flags into a temporary
directory and called through the C entry point (``cuda_counts._call``).
The inputs follow the path shapes of ``chip_smoke.py``'s
``phase_dispatch`` cases with uniform random buckets (90% live) and a 0/1
membership (2% ones); they are not the paths' own data, so the times rank
the variants and do not replace ``scripts/ab_paths.py --cases
anchor_counts``.  Every variant's outputs must equal the first one's.  A
time is the mean of 10 launches by CUDA events, the smaller of two.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from downpore_tpu_torch.ops import _build, cuda_counts  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "retrieval_count.cu")
MIN_TILE = "constexpr int MIN_TILE = 256;"
MAX_TILE = "constexpr int MAX_TILE = 512;"
UNROLL = "constexpr int UNROLL = 4;"
# name -> replacements of this tree's source (none: the source as it is)
VARIANTS = {
    "this tree": (),
    "tiles 128-256": ((MIN_TILE, "constexpr int MIN_TILE = 128;"),
                      (MAX_TILE, "constexpr int MAX_TILE = 256;")),
    "tiles 256": ((MAX_TILE, "constexpr int MAX_TILE = 256;"),),
    "tiles 512": ((MIN_TILE, "constexpr int MIN_TILE = 512;"),),
    "2 loads": ((UNROLL, "constexpr int UNROLL = 2;"),),
    "8 loads": ((UNROLL, "constexpr int UNROLL = 8;"),),
    "no split": (("constexpr int MAX_SPLIT = 8;",
                  "constexpr int MAX_SPLIT = 1;"),),
}
# (name, (M, R, W, H, with first, BB, NB))
CASES = (("map 4.6 Mb flat + first", (8192, 64, 512, 65536, True, 0, 1)),
         ("2 x 2 grid seed shard flat", (4096, 64, 512, 32768, False, 0, 1)),
         ("2 x 1 grid flat + first", (4096, 64, 512, 65536, True, 0, 1)),
         ("64 Mb level 1 flat + first", (8192, 64, 56, 1048576, True, 0, 1)),
         ("64 Mb level 2 binned + first", (8192, 64, 128, 7340032, True, 8,
                                           56)),
         ("overlap flat", (2048, 128, 12288, 131072, False, 0, 1)))


def build(src: str, name: str, tmp: str):
    so = os.path.join(tmp, name + ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    return cuda_counts._bind(ctypes.CDLL(so))


def variant_source(subs, path: str) -> str:
    with open(SOURCE) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"the source has no {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        t = e0.elapsed_time(e1) / reps
        best = t if best is None else min(best, t)
    return best


def inputs(rng, dev, M, R, W, H, first, BB, NB):
    mem = (rng.integers(0, 50, (H, W), dtype=np.uint8) == 0).astype(np.int8)
    b = rng.integers(0, H // NB, (M, R)).astype(np.int32)
    b[rng.random((M, R)) > 0.9] = -1
    f = (b >= 0) & (rng.random((M, R)) < 0.6)
    topbin = np.stack([rng.permutation(NB)[:BB] for _ in range(M)]) \
        if BB else None
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return t(mem), t(b), t(f) if first else None, t(topbin), NB


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="a tree whose kernel is "
                    "timed first, beside this tree's variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("count_variants: needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        if args.other:
            libs[os.path.basename(os.path.normpath(args.other))] = build(
                os.path.join(args.other, "downpore_tpu_torch", "csrc",
                             "retrieval_count.cu"), "other", tmp)
        for i, (name, subs) in enumerate(VARIANTS.items()):
            libs[name] = build(variant_source(
                subs, os.path.join(tmp, f"v{i}.cu")), f"v{i}", tmp)
        rng = np.random.default_rng(0)
        stream = torch.cuda.current_stream().cuda_stream
        for case, spec in CASES:
            a = inputs(rng, dev, *spec)
            ref, row = None, []
            for name, lib in libs.items():
                outs = cuda_counts._outputs(*a[:4])

                def run():
                    if cuda_counts._call(lib, outs, *a, stream=stream):
                        raise SystemExit(f"{name}: launch failed")
                run()
                torch.cuda.synchronize()
                if ref is None:
                    ref = [o.clone() for o in outs]
                elif not all(torch.equal(o, r) for o, r in zip(outs, ref)):
                    raise SystemExit(f"{name} differs at {case}")
                row.append(f"{name} {cuda_ms(run):.4f}")
            print(f"{case} (ms): " + "; ".join(row), flush=True)
            del a, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
