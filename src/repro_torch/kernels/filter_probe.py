"""sketch_filter and fragment_bitmap on the card, against their yardsticks
and their variants, in one process.

    PYTHONPATH=src python -m repro_torch.kernels.filter_probe [--variants]

- **kernels** (n = 2^23): the mask at 100 ranges; the mask and its kept
  rows at 5% and 40% kept; the bitmap at 100 and 32,768 ranges, a random
  quarter of the rows in the provenance.  Each in alternating rounds
  (kernel, yardstick, kernel): the median CUDA-event time of a call (host
  latency included) and its device time (``torch.profiler``, every kernel
  and copy of a call summed), each round's value listed, so the spread
  shows, with the L2 warm (the inputs fit in it) and evicted before each
  call; the bound (bytes at 3.35 TB/s, the bitmap's buckets counted by the
  32-byte sectors holding a provenance row) and the yardstick (indexing
  ``bits[bucket]``; ``torch.nonzero`` of it; ``scatter_reduce_``) beside
  them.
- **variants** (with ``--variants``): the variants of the two sources
  (``VARIANTS``: the compaction's status words with release and acquire,
  registers left to the compiler; ``BITMAP_VARIANTS``: bucket loads that do
  not wait for the provenance flags, clusters of one, two and four blocks,
  the scan alone, the merge alone), built with the kernels' flags into
  ``build/repro_torch/probe/`` and timed against each other, alternating.
  Their patches are applied on the CPU by
  ``tests/test_torch_kernels.py::test_filter_probe_patches_apply``.
- **host**: microseconds a call of small launches (n = 4,096) in a loop
  with one synchronise, for each wrapper whole and its parts (the checks,
  the allocations, the C call; the count's copy back for the rows).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import time
from typing import Callable, Dict, List

from repro_torch.kernels import build
from repro_torch.kernels.measure import bitmap_sectors, device_ms

HBM_BYTES_PER_S = 3.35e12
N = 1 << 23
ROUNDS = ("kernel", "yardstick", "kernel")


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    """Replace ``old`` (which must occur ``count`` times) by ``new``."""
    if src.count(old) != count:
        raise ValueError(f"filter_probe: the kernel source has {src.count(old)} of {old!r}")
    return src.replace(old, new)


# Variants of csrc/sketch_filter.cu's compaction, by text.
VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    # Status words published with release and read with acquire.
    "acquire": lambda src: _sub(_sub(src, '"st.relaxed.gpu.global', '"st.release.gpu.global'),
                                '"ld.relaxed.gpu.global', '"ld.acquire.gpu.global'),
    # Registers left to the compiler (no minimum of blocks an SM).
    "no min blocks": lambda src: _sub(src, "constexpr int kMinBlocks = 8;",
                                      "constexpr int kMinBlocks = 1;"),
}

# Variants of csrc/fragment_bitmap.cu, by text.  Those in TIMING_ONLY
# compute a wrong bitmap on purpose and are only timed.
_MERGE_HEAD = "  // Merge the cluster's bitmaps"
_CLUSTER = "constexpr int kCluster = 8;"


def _cluster(size: int) -> Callable[[str], str]:
    return lambda src: _sub(src, _CLUSTER, f"constexpr int kCluster = {size};")


def _no_set(src: str) -> str:
    """Rows loaded but no bit set (the loads kept alive by an XOR)."""
    src = _sub(src, "  if ((unsigned)b >= (unsigned)n_ranges) return;\n  const int w = b >> 5;",
               "  run.bits ^= b;\n  if (n_ranges > 0) return;\n  const int w = b >> 5;")
    return _sub(src, "  if (run.bits && (s_words[run.word]",
                "  if (run.word >= 0 && run.bits && (s_words[run.word]")


BITMAP_VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    # Every bucket run loaded, with no wait for its provenance flags.
    "all buckets": lambda src: _sub(src, "        if (!pw[q]) continue;\n", ""),
    # Clusters of one block (each block ORs its words into the global
    # array), of two and of four.
    "cluster 1": _cluster(1),
    "cluster 2": _cluster(2),
    "cluster 4": _cluster(4),
    # The scan of the rows alone: no merge, no output.
    "scan only": lambda src: _sub(src, _MERGE_HEAD,
                                  "  if (n_words > 0) return;\n" + _MERGE_HEAD),
    "no set": _no_set,
    # The merge and output alone: no row is read.
    "merge only": lambda src: _sub(src, "  const int64_t n_tiles = (n + kTile - 1) / kTile;\n  Run",
                                   "  const int64_t n_tiles = 0;\n  Run"),
}
TIMING_ONLY = {"scan only", "merge only", "no set"}


def all_patches() -> Dict[str, str]:
    """Every variant's source text (raises if a patch lost its anchor)."""
    src = (build.CSRC / "sketch_filter.cu").read_text()
    return {name: patch(src) for name, patch in VARIANTS.items()}


def all_bitmap_patches() -> Dict[str, str]:
    src = (build.CSRC / "fragment_bitmap.cu").read_text()
    return {name: patch(src) for name, patch in BITMAP_VARIANTS.items()}


def build_variants(name: str, sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Every variant of csrc/<name>.cu built at once (-Xptxas -v printed)."""
    jobs = []
    for i, (label, text) in enumerate(sources.items()):
        vdir = build.BUILD_DIR / "probe" / f"{name}_{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / f"{name}.cu").write_text(text)
        so = vdir / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(vdir / f"{name}.cu")]
        jobs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"variant {label}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}, {label}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[label] = lib
    return libs


def _alternate(torch, name: str, libs: Dict[str, ctypes.CDLL], label: str, call: Callable,
               want, kernel: str) -> None:
    """Each variant library of ``name`` in turn, forwards then backwards,
    warm and cold L2: its result checked, its kernel's device time."""
    kept = build._LIBS.get(name)
    order = list(libs) + list(libs)[::-1]
    try:
        for cold in (False, True):
            before = flush_l2(torch) if cold else None
            times: Dict[str, List[float]] = {k: [] for k in libs}
            for variant in order:
                build._LIBS[name] = libs[variant]
                got = call()
                same = (all(torch.equal(a, b) for a, b in zip(got, want))
                        if isinstance(got, tuple) else torch.equal(got, want))
                assert same or variant in TIMING_ONLY, variant
                times[variant].append(device_ms(torch, call, before=before).get(kernel, 0.0))
            print(f"[variants] {label}, {'cold' if cold else 'warm'} L2, {kernel} device ms: "
                  + "; ".join(f"{k} {_spread(v)}" for k, v in times.items()), flush=True)
    finally:
        if kept is None:
            build._LIBS.pop(name, None)
        else:
            build._LIBS[name] = kept


def variants(torch) -> None:
    """The variants at n = 2^23: the compaction at 5% and 40% kept, the
    bitmap at 100 and 32,768 ranges (a quarter of the rows in the
    provenance), alternating."""
    from repro_torch.kernels import fragment_bitmap as kfb
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch_filter as ksf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    bucket = torch.randint(0, 100, (N,), generator=gen, device=dev, dtype=torch.int32)
    libs = build_variants(ksf.NAME, all_patches())
    bits = torch.zeros(100, dtype=torch.bool, device=dev)
    bits[torch.randperm(100, generator=gen, device=dev)[:40]] = True
    _alternate(torch, ksf.NAME, libs, "sketch_filter mask, 40 of 100 ranges",
               lambda: ops.sketch_filter(bucket, bits), ref.sketch_filter_ref(bucket, bits),
               "filter_kernel")
    for share in (5, 40):
        bits = torch.zeros(100, dtype=torch.bool, device=dev)
        bits[torch.randperm(100, generator=gen, device=dev)[:share]] = True
        _alternate(torch, ksf.NAME, libs, f"sketch_filter_rows, {share}% kept",
                   lambda: ops.sketch_filter_rows(bucket, bits),
                   ref.sketch_filter_rows_ref(bucket, bits), "filter_rows_kernel")
    libs = build_variants(kfb.NAME, all_bitmap_patches())
    for label, lib in libs.items():
        print(f"[variants] fragment_bitmap, {label}: {lib.bitmap_clusters(dev.index or 0)} "
              f"resident clusters", flush=True)
    prov = torch.rand(N, generator=gen, device=dev) < 0.25
    for n_ranges in (100, 32768):
        b = torch.randint(0, n_ranges, (N,), generator=gen, device=dev, dtype=torch.int32)
        _alternate(torch, kfb.NAME, libs, f"fragment_bitmap, {n_ranges} ranges",
                   lambda: ops.fragment_bitmap(prov, b, n_ranges),
                   ref.fragment_bitmap_ref(prov, b, n_ranges), "bitmap_kernel")


def event_ms(torch, fn: Callable, reps: int = 20, before: Callable = None) -> float:
    """Median CUDA-event milliseconds of one call, after warm-ups;
    ``before()`` runs ahead of each timed call, outside the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def _spread(values: List[float]) -> str:
    return (f"median {statistics.median(values):.4f} ({', '.join(f'{v:.4f}' for v in values)})")


_FLUSH = []


def flush_l2(torch) -> Callable:
    """A 64 MB device-to-device copy: evicts the 50 MB L2, so the next call
    reads its inputs from device memory (the inputs here, 33.5 MB of
    buckets and 8.4 MB of flags, would otherwise stay in L2 between calls)."""
    if not _FLUSH:
        src = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
        _FLUSH.append((src, torch.empty_like(src)))
    src, dst = _FLUSH[0]
    return lambda: dst.copy_(src)


def _rounds(torch, label: str, fns: Dict[str, Callable], bound_ms: float, extra: str = ""):
    for cold in (False, True):
        _rounds_of(torch, f"{label}, {'cold' if cold else 'warm'} L2", fns, bound_ms, extra,
                   flush_l2(torch) if cold else None)


def _rounds_of(torch, label: str, fns: Dict[str, Callable], bound_ms: float, extra: str,
               before: Callable):
    """Alternate the kernel and its yardstick (``ROUNDS``) and print each
    one's event and device times across its rounds."""
    (yard,) = [k for k in fns if k != "kernel"]
    event: Dict[str, List[float]] = {k: [] for k in fns}
    dev: Dict[str, List[float]] = {k: [] for k in fns}
    parts: Dict[str, Dict[str, float]] = {}
    for who in ROUNDS:
        who = yard if who == "yardstick" else who
        event[who].append(event_ms(torch, fns[who], before=before))
        per = device_ms(torch, fns[who], before=before)
        dev[who].append(sum(per.values()))
        parts[who] = per
    for who in fns:
        print(f"[kernels] {label}, {who}: event ms {_spread(event[who])}; device ms "
              f"{_spread(dev[who])} ({', '.join(f'{k} {v:.4f}' for k, v in parts[who].items())})"
              f"; bound {bound_ms:.4f} ms{extra}", flush=True)


def kernels(torch) -> None:
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    bucket = torch.randint(0, 100, (N,), generator=gen, device=dev, dtype=torch.int32)
    bucket_l = bucket.long()  # the yardsticks' index, made outside their timing
    # The mask at 100 ranges, 40 of them set.
    bits = torch.zeros(100, dtype=torch.bool, device=dev)
    bits[torch.randperm(100, generator=gen, device=dev)[:40]] = True
    fns = {"kernel": lambda: ops.sketch_filter(bucket, bits),
           "indexing": lambda: bits[bucket_l]}
    _rounds(torch, "sketch_filter mask, 100 ranges", fns, 5 * N / HBM_BYTES_PER_S * 1e3)
    # The mask and its rows at 5% and 40% kept.
    for share in (5, 40):
        bits = torch.zeros(100, dtype=torch.bool, device=dev)
        bits[torch.randperm(100, generator=gen, device=dev)[:share]] = True
        k = int(bits[bucket_l].sum())
        fns = {"kernel": lambda: ops.sketch_filter_rows(bucket, bits),
               "torch.nonzero": lambda: torch.nonzero(bits[bucket_l])}
        _rounds(torch, f"sketch_filter mask and rows, {share}% kept (k={k})", fns,
                (5 * N + 8 * k) / HBM_BYTES_PER_S * 1e3)
    # The bitmap: a random quarter of the rows in the provenance (phase 2's).
    prov = torch.rand(N, generator=gen, device=dev) < 0.3
    prov &= bucket % 7 != 3
    prov_i = prov.to(torch.int32)
    sectors = bitmap_sectors(prov)
    nnz = int(prov.sum())
    for n_ranges in (100, 32768):
        b = bucket if n_ranges == 100 else torch.randint(0, n_ranges, (N,), generator=gen,
                                                         device=dev, dtype=torch.int32)
        b_l = b.long()
        fns = {"kernel": lambda: ops.fragment_bitmap(prov, b, n_ranges),
               "scatter_reduce_": lambda: torch.zeros(n_ranges, dtype=torch.int32, device=dev)
               .scatter_reduce_(0, b_l, prov_i, reduce="amax")}
        bound = (N + 32 * sectors + n_ranges) / HBM_BYTES_PER_S * 1e3
        old = (N + 4 * nnz + n_ranges) / HBM_BYTES_PER_S * 1e3
        _rounds(torch, f"fragment_bitmap, {n_ranges} ranges, {nnz} provenance rows", fns, bound,
                f" by sectors ({sectors} of {N // 8}; by 4 bytes a provenance row {old:.5f})")


def host(torch) -> None:
    """Host microseconds a call at n = 4,096: each wrapper whole and its
    parts, and indexing."""
    from repro_torch.kernels import fragment_bitmap as kfb
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch_filter as ksf

    dev = torch.device("cuda", torch.cuda.current_device())
    n = 4096
    bucket = torch.randint(0, 100, (n,), device=dev, dtype=torch.int32)
    bucket_l = bucket.long()
    bits = torch.rand(100, device=dev) < 0.4
    prov = torch.rand(n, device=dev) < 0.25
    ops.sketch_filter_rows(bucket, bits)
    ops.fragment_bitmap(prov, bucket, 100)
    stream = build.stream_handle(dev)
    flib, blib = build.library(ksf.NAME), build.library(kfb.NAME)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    rows = torch.empty(n, dtype=torch.int64, device=dev)
    out = torch.empty(100, dtype=torch.bool, device=dev)
    ws_f = ksf._workspace(dev, stream, 1)
    ws_b = kfb._WORKSPACES[(dev.index, stream)]

    def filter_c():  # parity and prev_tiles kept in step, as the wrapper does
        build.check(flib.filter_rows_launch(dev.index, stream, bucket.data_ptr(),
                                            bits.data_ptr(), n, 100, keep.data_ptr(),
                                            rows.data_ptr(), ws_f.words.data_ptr(), ws_f.cap,
                                            ws_f.parity, ws_f.prev_tiles), "probe")
        ws_f.parity, ws_f.prev_tiles = 1 - ws_f.parity, 1

    cases = (
        ("sketch_filter (mask)", lambda: ops.sketch_filter(bucket, bits)),
        ("sketch_filter_rows", lambda: ops.sketch_filter_rows(bucket, bits)),
        ("of it the checks", lambda: ksf._checked(bucket, bits)),
        ("of it the allocations", lambda: (torch.empty(n, dtype=torch.bool, device=dev),
                                           torch.empty(n, dtype=torch.int64, device=dev))),
        ("of it the C call", filter_c),
        ("of it the count's copy back", lambda: int(ws_f.count)),
        ("fragment_bitmap", lambda: ops.fragment_bitmap(prov, bucket, 100)),
        ("of it the C call", lambda: build.check(blib.bitmap_launch(
            dev.index, stream, bucket.data_ptr(), prov.data_ptr(), n, 100, ws_b.data_ptr(),
            out.data_ptr()), "probe")),
        ("indexing bits[bucket]", lambda: bits[bucket_l]),
    )
    for label, fn in cases:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        print(f"[host] {label}, n={n}: {(time.perf_counter() - t0) / 2000 * 1e6:.1f} us a call",
              flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also time the variants (VARIANTS, BITMAP_VARIANTS)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("filter_probe: no CUDA device")
    t0 = time.perf_counter()
    build.build_all(["sketch_filter", "fragment_bitmap"])
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
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
