"""fragment_bitmap_batch on the card: against its bound and its yardstick,
its variants, and the host time of a call.

    PYTHONPATH=src python -m repro_torch.kernels.bitmap_probe [--variants] [--paired TREE]

- **kernel** (n = 2^23, 100 ranges, chip_smoke.py's phase-2 masks: a random
  30% of the rows, each mask leaving its own fragments empty), B = 8 and
  32, and at B = 8 over 32,768 ranges: the kernel and ``scatter_reduce_``
  in turns (kernel, yardstick, kernel), the median CUDA-event time of a call
  (host latency included) and its device time (``torch.profiler``, by
  kernel, with the number of device events a call), with the L2 warm and
  evicted before each call, beside the bound (each bucket and mask byte read
  once, each output byte written once, at 3.35 TB/s).
- **variants** (``--variants``): ``csrc/fragment_bitmap_batch.cu`` patched
  (``VARIANTS``), built with the kernels' flags into
  ``build/repro_torch/probe/`` and timed against each other, alternating;
  ``tests/test_torch_kernels.py::test_bitmap_probe_patches_apply`` applies
  every patch on the CPU.  Those in ``TIMING_ONLY`` compute a wrong bitmap on
  purpose.
- **host**: microseconds a call at n = 4,096, B = 8, in a loop with one
  synchronise: the wrapper whole, its allocation and its C call.
- **paired** (``--paired TREE``): the same calls in the checkout at TREE and
  in this tree, each in processes of its own, in turns
  (``measure.paired``).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

from repro_torch.kernels import build
from repro_torch.kernels.filter_probe import build_variants, event_ms, flush_l2
from repro_torch.kernels.measure import device_ms

HBM_BYTES_PER_S = 3.35e12
N = 1 << 23
SOURCE = build.CSRC / "fragment_bitmap_batch.cu"
# (B, ranges) timed
CASES = ((8, 100), (32, 100), (8, 32768))


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"bitmap_probe: the kernel source has {src.count(old)} of {old!r}")
    return src.replace(old, new)


_ANY = "        if (!(w[q][0] | w[q][1] | w[q][2] | w[q][3])) continue;\n"


def _rank0_finishes(src: str) -> str:
    src = _sub(src, """  if (rank == 0 && threadIdx.x == 0) {
    const unsigned clusters = gridDim.x / kCluster * gridDim.y;
    const uint32_t last = atomicAdd(done, 1u) == clusters - 1;
    for (uint32_t c = 0; c < kCluster; ++c) st_shared_cluster(&s_last, c, last);
  }
  cluster_sync();
  if (!s_last) return;""", """  if (rank != 0) return;
  if (threadIdx.x == 0) {
    const unsigned clusters = gridDim.x / kCluster * gridDim.y;
    s_last = atomicAdd(done, 1u) == clusters - 1;
  }
  __syncthreads();
  if (!s_last) return;""")
    src = _sub(src, "k < items; k += kCluster * kThreads) {", "k < items; k += kThreads) {")
    src = _sub(src, "  cluster_sync();\n  const int64_t table_words",
               "  __syncthreads();\n  const int64_t table_words")
    return _sub(src, "r < table_words; r += kCluster * kThreads)", "r < table_words; r += kThreads)")


def _wide_flags(src: str) -> str:
    src = _sub(src, "constexpr int kRun = kThreads * 4;", "constexpr int kRun = 4;")
    src = _sub(src, "    const int64_t first = tile * kTile + threadIdx.x * 4;",
               "    const int64_t first = tile * kTile + threadIdx.x * 16;")
    head = "        uint32_t f[kGroup][4];\n"
    tail = "#pragma unroll\n        for (int q = 0; q < 4; ++q) {\n          uint32_t a = 0;"
    i, j = src.index(head), src.index(tail)
    return src[:i] + head + (
        "#pragma unroll\n"
        "        for (int j = 0; j < kGroup; ++j) {\n"
        "          const uint4 v = g + j < nm ? __ldg(reinterpret_cast<const uint4*>(\n"
        "              base + (int64_t)(g + j) * n + first)) : make_uint4(0u, 0u, 0u, 0u);\n"
        "          f[j][0] = v.x;\n          f[j][1] = v.y;\n          f[j][2] = v.z;\n"
        "          f[j][3] = v.w;\n        }\n") + src[j:]

VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    # Clusters of one block (each block ORs its words into the table).
    "cluster 1": lambda src: _sub(src, "constexpr int kCluster = 8;", "constexpr int kCluster = 1;"),
    # The flags of 4 masks in flight at once, not 8.
    "group 4": lambda src: _sub(src, "constexpr int kGroup = 8;", "constexpr int kGroup = 4;"),
    # Every run's buckets loaded, with no wait for its flags.
    "all buckets": lambda src: _sub(src, _ANY, ""),
    # The flags alone: no bucket loaded, no bit set (the test against a
    # value known only at run time keeps the compiler from dropping them).
    "flags only": lambda src: _sub(src, _ANY, _ANY.replace(
        "if (!(w[q][0] | w[q][1] | w[q][2] | w[q][3]))",
        "if ((w[q][0] | w[q][1] | w[q][2] | w[q][3]) != (uint32_t)n_ranges + 0xdeadbee0u)")),
    # A thread's 16 rows consecutive, each mask's flags one 16-byte load
    # (n = 2^23 and whole tensors keep them 16-byte aligned).
    "16 rows, 16-byte flags": _wide_flags,
    # Registers capped so that 4 blocks of the 8-mask instance fit an SM
    # (3 otherwise: 5 or 6 tiles a block at n = 2^23, not 3 or 4).
    "4 blocks an SM": lambda src: _sub(
        src, "__global__ void __launch_bounds__(kThreads)\nbitmap_batch_kernel(",
        "__global__ void __launch_bounds__(kThreads, kMasks <= 8 ? 4 : 1)\nbitmap_batch_kernel("),
    # The last cluster's rank 0 alone takes the ticket, writes the output and
    # zeroes the table (no broadcast, two cluster barriers fewer).
    "rank 0 finishes": _rank0_finishes,
    # Everything but the last cluster's output (its zeroing kept).
    "no output": lambda src: _sub(src, "k < items; k += kCluster * kThreads) {",
                                  "k < items && n_ranges < 0; k += kCluster * kThreads) {"),
    # The scan alone: no merge, no output.
    "scan only": lambda src: _sub(src, "  // Merge the cluster's words:",
                                  "  if (n_ranges > 0) return;\n  // Merge the cluster's words:"),
}
TIMING_ONLY = {"flags only", "scan only", "no output"}


def all_patches() -> Dict[str, str]:
    """Every variant's source text (raises if a patch lost its anchor)."""
    src = SOURCE.read_text()
    return {name: patch(src) for name, patch in VARIANTS.items()}


def _inputs(torch, b: int, n_ranges: int, seed: int = 9):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bucket = torch.randint(0, n_ranges, (N,), generator=gen, device=dev, dtype=torch.int32)
    provs = torch.rand((b, N), generator=gen, device=dev) < 0.3
    provs &= (bucket[None, :] + torch.arange(b, device=dev)[:, None]) % 7 != 3
    return bucket, provs


def _spread(values: List[float]) -> str:
    return f"median {statistics.median(values):.4f} ({', '.join(f'{v:.4f}' for v in values)})"


def _events(torch, fn, before=None) -> int:
    """Device events (kernels, copies, memsets) of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def kernels(torch) -> None:
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    for b, n_ranges in CASES:
        bucket, provs = _inputs(torch, b, n_ranges)
        index = bucket.long().expand(b, N)  # the yardstick's index, made outside its timing
        provs_i = provs.to(torch.int32)
        fns = {"kernel": lambda: ops.fragment_bitmap_batch(provs, bucket, n_ranges),
               "scatter_reduce_": lambda: torch.zeros((b, n_ranges), dtype=torch.int32,
                                                      device=dev)
               .scatter_reduce_(1, index, provs_i, reduce="amax")}
        bound = (4 * N + b * N + b * n_ranges) / HBM_BYTES_PER_S * 1e3
        events = _events(torch, fns["kernel"])
        for cold in (False, True):
            before = flush_l2(torch) if cold else None
            event: Dict[str, List[float]] = {k: [] for k in fns}
            dev_ms: Dict[str, List[float]] = {k: [] for k in fns}
            parts: Dict[str, Dict[str, float]] = {}
            for who in ("kernel", "scatter_reduce_", "kernel"):
                calls = 20 if who == "kernel" else 3
                event[who].append(event_ms(torch, fns[who], reps=calls, before=before))
                per = device_ms(torch, fns[who], calls=calls, before=before)
                dev_ms[who].append(sum(per.values()))
                parts[who] = per
            for who in fns:
                print(f"[kernels] B={b} n={N} ranges={n_ranges}, {'evicted' if cold else 'warm'}"
                      f" L2, {who}: event ms {_spread(event[who])}; device ms "
                      f"{_spread(dev_ms[who])} ({', '.join(f'{k} {v:.4f}' for k, v in parts[who].items())})"
                      f"; bound {bound:.4f} ms; kernel's device events a call {events}",
                      flush=True)
        del bucket, provs, index, provs_i
        torch.cuda.empty_cache()


def variants(torch) -> None:
    """Every variant at B = 8 and 32 (100 ranges) and at B = 8 over 32,768
    ranges, forwards then backwards, warm and evicted."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import fragment_bitmap as kfb

    libs = build_variants(kfb.BATCH_NAME, all_patches())
    kept = build._LIBS.get(kfb.BATCH_NAME)
    order = list(libs) + list(libs)[::-1]
    try:
        for b, n_ranges in CASES:
            bucket, provs = _inputs(torch, b, n_ranges)
            want = ref.fragment_bitmap_batch_ref(provs, bucket, n_ranges)
            call = lambda: ops.fragment_bitmap_batch(provs, bucket, n_ranges)  # noqa: E731
            for cold in (False, True):
                before = flush_l2(torch) if cold else None
                times: Dict[str, List[float]] = {k: [] for k in libs}
                for variant in order:
                    build._LIBS[kfb.BATCH_NAME] = libs[variant]
                    got = call()
                    assert torch.equal(got, want) or variant in TIMING_ONLY, variant
                    times[variant].append(sum(device_ms(torch, call, before=before).values()))
                print(f"[variants] B={b} ranges={n_ranges}, {'evicted' if cold else 'warm'} L2,"
                      f" device ms: " + "; ".join(f"{k} {_spread(v)}" for k, v in times.items()),
                      flush=True)
            del bucket, provs, want
    finally:
        if kept is None:
            build._LIBS.pop(kfb.BATCH_NAME, None)
        else:
            build._LIBS[kfb.BATCH_NAME] = kept


def host(torch) -> None:
    """Host µs a call at n = 4,096, B = 8: the wrapper whole, its output
    allocation, and scatter_reduce_."""
    from repro_torch.kernels import ops

    dev = torch.device("cuda", torch.cuda.current_device())
    n, b = 4096, 8
    bucket = torch.randint(0, 100, (n,), device=dev, dtype=torch.int32)
    provs = torch.rand((b, n), device=dev) < 0.25
    index = bucket.long().expand(b, n)
    provs_i = provs.to(torch.int32)
    cases = (
        ("fragment_bitmap_batch", lambda: ops.fragment_bitmap_batch(provs, bucket, 100)),
        ("of it the output's allocation",
         lambda: torch.empty((b, 100), dtype=torch.bool, device=dev)),
        ("scatter_reduce_", lambda: torch.zeros((b, 100), dtype=torch.int32, device=dev)
         .scatter_reduce_(1, index, provs_i, reduce="amax")),
    )
    for label, fn in cases:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        print(f"[host] {label}, n={n} B={b}: {(time.perf_counter() - t0) / 2000 * 1e6:.1f} us "
              f"a call", flush=True)


def paired_main(parent: str) -> None:
    from repro_torch.kernels import measure

    cases = [dict(kind="bitmap_batch", label=f"B={b} ranges={r}", b=b, n=N, ranges=r)
             for b, r in CASES]
    here = Path(__file__).resolve().parents[3]
    for tree, per in measure.paired([Path(parent).resolve(), here], cases).items():
        for label, ms in per.items():
            print(f"[paired] {'this tree' if Path(tree) == here else 'parent'}, {label}: "
                  f"device ms warm {', '.join(f'{m[0]:.4f}' for m in ms)}; evicted "
                  f"{', '.join(f'{m[1]:.4f}' for m in ms)}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true", help="also time VARIANTS")
    parser.add_argument("--paired", metavar="TREE",
                        help="time this tree against the checkout at TREE, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bitmap_probe: no CUDA device")
    if args.paired:
        paired_main(args.paired)
    else:
        build.build_all(["fragment_bitmap_batch"])
        kernels(torch)
        if args.variants:
            variants(torch)
        host(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
