"""Where segment_aggregate and segment_aggregate_batch spend their time
above 1,024 groups, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.segagg_probe

Four shapes: kernel 1 at n = 2^23, G = 16,384; kernel 5 at B = 8,
n = 2^20, G = 16,384 and at B = 1, n = 2^23, G = 16,384; and the sharded
engine's fused launch (B = 16, n = 4 x 2^21, G = 4,096), made synthetically
with 28% weighted rows in contiguous runs at the head of each shard slice,
as the stacked cache lays them out, and groups clustered as on a table
clustered on the group-by (see ``_inputs``).

- **variants**: ``csrc/segment_aggregate.cu`` patched to drop one part at a
  time (the merge; the main pass; the adds; everything but the bulk copies
  and the ring's barriers; everything of the filter warps but their
  ballots), or to change one choice (remote arrivals that release at
  cluster scope; no multicast, each block copying whole tiles; no L2
  prefetch ahead of the copies; every run of 32 through add_run's match;
  runs of one group not summed before they are compacted; a ring of two
  stages), each built with the kernels' flags into
  ``build/repro_torch/probe/`` and timed with CUDA events in two
  alternating rounds;
- **device**: at each shape, one call's CUDA-event time (host latency
  included, as ``chip_smoke.py`` times it) beside its device time
  (``torch.profiler``: the kernels it launches, summed, a call), for the
  kernel and for ``index_add_`` over ``gid + b * G`` (the library
  yardstick), so what separates the two is shown, not inferred;
- **host**: microseconds a call of small launches (n = 4,096, G = 4,096,
  unbatched and B = 16) in a loop with one synchronise, beside
  ``index_add_``'s;
- **sections**: ``clock64`` sums in block (0, 0), from an instrumented
  copy: per filter warp the wait for a tile and its filter and compaction;
  per adder warp the wait for the filter warps, the adds (and of them
  add_run) and the release; for the producer the wait for the stage's last
  tile to land, and on the tiles it copies the wait for a free stage and
  issuing the copies.

A patch that no longer finds its text in the source raises; the CPU test
``tests/test_torch_kernels.py::test_segagg_probe_patches_apply`` applies
every patch of this tree's source without building.  The patched kernels
compute wrong results on purpose: nothing here is on any path.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import time
from typing import Callable, Dict

from repro_torch.kernels import build

SOURCE = build.CSRC / "segment_aggregate.cu"
PROBE_DIR = build.BUILD_DIR / "probe"
# label -> (B or 0 for the unbatched kernel, n, G, weighted share or None for
# independent weights of one half)
SHAPES = {
    "k1 n=2^23 G=16384": (0, 1 << 23, 16384, None),
    "k5 B=8 n=2^20 G=16384": (8, 1 << 20, 16384, None),
    "k5 B=1 n=2^23 G=16384": (1, 1 << 23, 16384, None),
    "phase-5 launch B=16 n=4x2^21 G=4096": (16, 4 << 21, 4096, 0.28),
}
SHARDS = 4  # the fused launch's rows are SHARDS slices of n / SHARDS rows


def _sub(src: str, old: str, new: str) -> str:
    """Replace the one occurrence of ``old``; raise if there is not exactly one."""
    if src.count(old) != 1:
        raise ValueError(f"segagg_probe: the kernel source has {src.count(old)} of {old[:60]!r}")
    return src.replace(old, new)


def _cut(src: str, head: str, tail: str, new: str) -> str:
    """Replace the text from ``head`` up to (not including) ``tail``."""
    for mark in (head, tail):
        if src.count(mark) != 1:
            raise ValueError(f"segagg_probe: the kernel source has {src.count(mark)} of "
                             f"{mark[:60]!r}")
    i, j = src.index(head), src.index(tail)
    if j < i:
        raise ValueError(f"segagg_probe: {tail[:40]!r} comes before {head[:40]!r}")
    return src[:i] + new + src[j:]


# ---- patches of the sliced kernel --------------------------------------------

_MERGE = """  segagg_merge<<<dim3((outs + kMergeThreads - 1) / kMergeThreads, batch), kMergeThreads, 0,
                 s>>>(scratch, parts, n_groups, sums, counts);"""


def no_merge(src: str) -> str:
    """The main pass alone: the merge is not launched."""
    return _sub(src, _MERGE, "  (void)outs;")


def merge_only(src: str) -> str:
    """The merge alone, over whatever the scratch holds."""
    return _cut(src, "  err = sliced_config(n_groups, cluster, (size_t)smem, parts, batch, s, cfg, attr);",
                "  if (err != cudaSuccess) return (int)err;\n  err = cudaGetLastError();",
                "  err = cudaSuccess;\n  (void)part_rows;\n")


_ADD = "        add_run_tagged(acc, tags, slice, lane, in ? sg[at] : -1, sv[at], sx[at]);\n"


def no_adds(src: str) -> str:
    """Rows are filtered and compacted, never added."""
    return _sub(src, _ADD, "        (void)in;\n        (void)tags;\n")


def copies_only(src: str) -> str:
    """Filter warps keep nothing and adder warps add nothing: the bulk
    copies and the ring's barriers alone."""
    return _cut(src, "      int32_t g[kRuns];",
                "      if (lane == 0) counts[s * kFilters + warp] = kept;",
                "      int kept = 0;\n      (void)sv;\n      (void)sg;\n      (void)sx;\n"
                "      (void)rows;\n      (void)below;\n")


def cluster_scope_arrive(src: str) -> str:
    """Remote arrivals that release at cluster scope (MEMBAR.ALL.GPU each)."""
    return _sub(src, "mbar_arrive_cluster(empty0 + 8 * s, lane);",
                '{ const uint32_t bar_ = empty0 + 8 * s; asm volatile("{\\n.reg .b32 r_;\\n'
                'mapa.shared::cluster.u32 r_, %0, %1;\\n'
                'mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r_];\\n}\\n" '
                '::"r"(bar_), "r"(lane) : "memory"); }')


_COPIES = """          if (n_ctas == 1) {
            bulk_load(dst, segment(a, i), bytes(a, i), full0 + 8 * s);
          } else {
            bulk_load_multicast(dst, segment(a, i), bytes(a, i), full0 + 8 * s, mask);
          }"""


def no_multicast(src: str) -> str:
    """Each block copies every tile whole into its own ring and asks L2 for
    it (L2 serves the repeats); the barriers are unchanged."""
    src = _sub(src, "        if (turn != rank) continue;\n", "")
    src = _sub(src, "        if (i % n_ctas == rank) prefetch(i);\n", "        prefetch(i);\n")
    return _sub(src, _COPIES, "          bulk_load(dst, segment(a, i), bytes(a, i), full0 + 8 * s);")


def no_prefetch(src: str) -> str:
    """No tile is asked of L2 ahead of its copy."""
    src = _sub(src, "        if (i % n_ctas == rank) prefetch(i);\n", "        (void)0;\n")
    return _sub(src, "        if (i + kPrefetch < n_tiles) prefetch(i + kPrefetch);\n", "")


def no_run_sums(src: str) -> str:
    """Filter warps keep every row of a run of one group (no segmented scan)."""
    return _sub(src, "        if (heads != kFull) {", "        if (false) {")


def no_tags(src: str) -> str:
    """Every run goes through add_run's match, as if some group repeated."""
    return _sub(src, "  if (__any_sync(kFull, k >= 0 && tags[k] != lane)) {", "  if (true) {")


def two_stages(src: str) -> str:
    """A ring of two stages (the launch takes the source's shared bytes)."""
    src = _sub(src, "constexpr int kStages = 3; ", "constexpr int kStages = 2; ")
    return _sub(src, "smem != sliced_smem(slice)) return cudaErrorInvalidValue;",
                "(smem = sliced_smem(slice), false)) return cudaErrorInvalidValue;")


def ballots_only(src: str) -> str:
    """Filter warps find and count their rows but write none, so adder
    warps add nothing."""
    src = _cut(src, "        st_shared3_if(keep, sg + at, (uint32_t)(g[u] - lo), sv + at,",
               "        kept += __popc(m);", "        (void)at;\n")
    return _sub(src, "      if (lane == 0) counts[s * kFilters + warp] = kept;",
                "      if (lane == 0) counts[s * kFilters + warp] = kept & 0;")


# clock64 sections by role: slot -> name; slot 7 counts tiles.
FILTER_SECTIONS = {0: "wait for the tile", 1: "filter and list"}
ADDER_SECTIONS = {0: "wait for the rows", 1: "add", 3: "of it add_run", 2: "release"}
PRODUCER_SECTIONS = {6: "wait for the stage's last tile", 4: "wait for a free stage",
                     5: "issue the copies"}


def sections_of(warp: int, filters: int = 8, adders: int = 2) -> Dict[int, str]:
    """The clock64 sections of warp ``warp`` of a block with ``filters``
    filter and ``adders`` adder warps (the producer last)."""
    if warp < filters:
        return FILTER_SECTIONS
    return ADDER_SECTIONS if warp < filters + adders else PRODUCER_SECTIONS


def instrument(src: str) -> str:
    """A copy whose lane 0 of each warp of block (0, 0) sums clock64 deltas
    over its role's sections and writes them to ``g_probe[warp]``."""
    src = _sub(src, "namespace {\n",
               "__device__ unsigned long long g_probe[16][8];\n"
               "#define MARK(i) { long long t_ = clock64(); probe[i] += t_ - t_prev; "
               "t_prev = t_; }\n"
               "namespace {\n")
    src = _sub(src, "  cluster_sync();  // every block's barriers are set before any copy or arrival\n",
               "  cluster_sync();  // every block's barriers are set before any copy or arrival\n"
               "  unsigned long long probe[8] = {0};\n  long long t_prev = clock64();\n")
    src = _sub(src, "        if (i >= kStages) mbar_wait(full0 + 8 * s, parity);\n",
               "        t_prev = clock64();\n"
               "        if (i >= kStages) mbar_wait(full0 + 8 * s, parity);\n        MARK(6);\n"
               "        probe[7] += 1;\n")
    src = _sub(src, "        if (i >= kStages) mbar_wait(empty0 + 8 * s, parity);\n",
               "        t_prev = clock64();\n"
               "        if (i >= kStages) mbar_wait(empty0 + 8 * s, parity);\n        MARK(4);\n")
    src = _sub(src, "        if (i + kPrefetch < n_tiles) prefetch(i + kPrefetch);\n",
               "        if (i + kPrefetch < n_tiles) prefetch(i + kPrefetch);\n        MARK(5);\n")
    src = _sub(src, "      mbar_wait(full0 + 8 * s, (i / kStages) & 1);\n      int32_t g[kRuns];\n",
               "      t_prev = clock64();\n      mbar_wait(full0 + 8 * s, (i / kStages) & 1);\n"
               "      MARK(0);\n      int32_t g[kRuns];\n")
    src = _sub(src, "      if (lane == 0) mbar_arrive(listed0 + 8 * s);\n",
               "      if (lane == 0) mbar_arrive(listed0 + 8 * s);\n      MARK(1);\n"
               "      probe[7] += 1;\n")
    src = _sub(src, "      mbar_wait(listed0 + 8 * s, (i / kStages) & 1);\n",
               "      t_prev = clock64();\n      mbar_wait(listed0 + 8 * s, (i / kStages) & 1);\n"
               "      MARK(0);\n      probe[7] += 1;\n")
    src = _sub(src, _ADD, "        long long ta_ = clock64();\n" + _ADD
               + "        probe[3] += clock64() - ta_;\n")
    src = _sub(src, "      __syncwarp();  // the warp's reads of the stage are done\n",
               "      MARK(1);\n      __syncwarp();  // the warp's reads of the stage are done\n")
    src = _sub(src, "      if (lane < (int)n_ctas) mbar_arrive_cluster(empty0 + 8 * s, lane);\n",
               "      if (lane < (int)n_ctas) mbar_arrive_cluster(empty0 + 8 * s, lane);\n"
               "      MARK(2);\n")
    src = _sub(src, "  __syncthreads();\n  for (int j = threadIdx.x; j < width; j += blockDim.x) {",
               "  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)\n"
               "    for (int i = 0; i < 8; ++i) g_probe[warp][i] = probe[i];\n"
               "  __syncthreads();\n  for (int j = threadIdx.x; j < width; j += blockDim.x) {")
    return src + ('\nextern "C" int probe_read(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "main pass alone": no_merge,
    "merge alone": merge_only,
    "no adds": no_adds,
    "copies and barriers only": lambda src: no_merge(copies_only(src)),
    "arrive at cluster scope": cluster_scope_arrive,
    "no multicast": no_multicast,
    "no L2 prefetch": no_prefetch,
    "no tags": no_tags,
    "no run sums": no_run_sums,
    "2 stages": two_stages,
    "ballots only": ballots_only,
}

# ---- the few-group path (segagg_private, up to 1,024 groups), --few ---------


def few_no_final(src: str) -> str:
    """No last-cluster merge: each cluster writes its partial set and takes
    its ticket; the last resets the ticket and stops."""
    return _sub(src, "  if (!s_last) return;\n",
                "  if (!s_last) return;\n  if (rank == 0 && threadIdx.x == 0) tickets[row] = 0;\n"
                "  if (n_groups > 0) return;\n")


def few_main_only(src: str) -> str:
    """The main pass and the block's sum of its warps' copies alone: no
    cluster merge, no ticket, no final merge."""
    return _sub(src, "  cluster_sync();  // every block's smem[0, copy) holds its sums\n",
                "  if (n_groups > 0) {\n    if (threadIdx.x == 0) partials[blockIdx.x] = smem[0];\n"
                "    return;\n  }\n  cluster_sync();  // every block's smem[0, copy) holds its sums\n")


def few_no_adds(src: str) -> str:
    """Runs found and joined, never added (a test the compiler cannot fold
    keeps them)."""
    src = _sub(src, "    add_round(acc, tags, gc, lane, copies == 32, ek >= 0 ? ek * copies + copy : -1, ep, ex);\n",
               "    if (ek == -7) acc[lane] += ep + ex;\n")
    return _sub(src, "  if (lane == 31 && ck >= 0) {", "  if (lane == 31 && ck == -7) {")


def few_loads_only(src: str) -> str:
    """Rows loaded and filtered, nothing else (the main pass alone)."""
    src = _sub(src, "    warp_step(acc, tags, gc, copies, my_copy, lane, k, p, x);\n",
               "    if ((k[0] & k[1] & k[2] & k[3]) == -7)\n"
               "      acc[lane] += p[0] + p[1] + p[2] + p[3] + x[0] + x[1] + x[2] + x[3];\n")
    return few_main_only(src)


def _own_smem(src: str) -> str:
    """The launch takes the patched source's shared bytes, not the plan's."""
    return _sub(src, "n_groups > kPrivateGroups || smem != private_smem(n_groups) ||",
                "n_groups > kPrivateGroups || (smem = private_smem(n_groups), false) ||")


def few_one_copy(src: str) -> str:
    """One copy of the sums a warp at every width."""
    return _own_smem(_sub(src, "  while (c < 32 && 2 * c * n_groups <= kCopyGroups) c *= 2;\n",
                          "  while (false) c *= 2;\n"))


def few_copies_1024(src: str) -> str:
    """Copies a warp up to 1,024 groups' worth together (twice as many)."""
    return _own_smem(_sub(src, "constexpr int kCopyGroups = 512;",
                          "constexpr int kCopyGroups = 1024;"))


def _unroll(steps: int) -> Callable[[str], str]:
    return lambda src: _sub(src, "constexpr int kAhead = 1;", f"constexpr int kAhead = {steps};")


FEW_VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "no final merge": few_no_final,
    "main pass alone": few_main_only,
    "no adds": lambda src: few_main_only(few_no_adds(src)),
    "loads only": few_loads_only,
    "no tags": lambda src: _sub(src, "  add_run_tagged(acc, tags, gc, lane, k, p, w);\n",
                                "  add_run(acc, gc, lane, k, p, w);\n"),
    "one copy a warp": few_one_copy,
    "scan every step": lambda src: _sub(
        src, "  if (__ballot_sync(kFull, hk >= 0 && joins) == 0) {", "  if (false) {"),
    "copies to 1,024 groups": few_copies_1024,
    "2 steps ahead": _unroll(2),
    "3 steps ahead": _unroll(3),
}
TIMING_ONLY = {"no final merge", "main pass alone", "no adds", "loads only"}


def all_patches() -> Dict[str, str]:
    """Every patched source of this tree by name (no build): what the CPU
    test applies."""
    src = SOURCE.read_text()
    out = {name: patch(src) for name, patch in VARIANTS.items()}
    out["sections"] = instrument(src)
    return out


def all_few_patches() -> Dict[str, str]:
    """Every patched source of the few-group variants by name (no build)."""
    src = SOURCE.read_text()
    return {name: patch(src) for name, patch in FEW_VARIANTS.items()}


def _build(sources: Dict[str, str], tag: str = "segagg") -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Every patched source, built twice, as the unbatched and the batched
    library (the batched source includes the unbatched one), all at once."""
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        vdir = PROBE_DIR / f"{tag}_{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for dep in build.CSRC.iterdir():
            if dep.suffix in (".cu", ".cuh"):
                shutil.copy(dep, vdir / dep.name)
        (vdir / "segment_aggregate.cu").write_text(text)
        for lib in ("segment_aggregate", "segment_aggregate_batch"):
            so = vdir / f"{lib}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(vdir / f"{lib}.cu")]
            jobs.append((name, lib, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {}
    for name, lib, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name} ({lib}):\n{out}")
        if name == "kernel" and lib == "segment_aggregate":
            for line in out.splitlines():
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    print(f"[build] {line.strip()}", flush=True)
        handle = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES[lib].items():
            f = getattr(handle, fn)
            f.restype, f.argtypes = restype, argtypes
        libs.setdefault(name, {})[lib] = handle
    return libs


def _inputs(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, (b, n, g, share) in SHAPES.items():
        rows = max(b, 1)
        gid = torch.randint(0, g, (rows, n), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.randint(0, 8, (rows, n), generator=gen, device=dev).float()
        if share is None:
            w = (torch.rand((rows, n), generator=gen, device=dev) < 0.5).float()
        else:
            # Each shard slice holds its instance rows first, then weight-0
            # padding (group 0, value 0): runs whose lengths average `share`.
            # The table is clustered on its first group-by attribute, so a
            # third of the sketches group by it alone (one group a run of
            # 65,536 rows), a third by it and one more (50 groups under each)
            # and a third by neither (uniform groups).
            r = n // SHARDS
            m = (torch.rand((rows, SHARDS, 1), generator=gen, device=dev) * 2 * share * r).long()
            w = (torch.arange(r, device=dev)[None, None, :] < m).float().reshape(rows, n)
            cluster = (torch.arange(n, device=dev) // 65536 % 77).int()
            gid[0::3] = cluster
            gid[1::3] = cluster * 50 + gid[1::3] % 50
            gid *= w.int()
            vals *= w
        if b == 0:
            gid, vals, w = gid[0], vals[0], w[0]
        out[label] = (b, vals, gid, w, g)
    return out


def _event_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def _call(b, vals, gid, w, g):
    from repro_torch.kernels import segment_aggregate as ksa

    if b == 0:
        return ksa.segment_aggregate(vals, gid, g, w)
    return ksa.segment_aggregate_batch(vals, gid, g, w)


def _device_ms(torch, fn, calls: int, before: Callable = None) -> Dict[str, float]:
    """Device milliseconds a call of ``fn`` by kernel, from ``torch.profiler``
    over ``calls`` calls after warm-ups: each kernel's duration summed over
    its launches.  Empty if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    per: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        mark = re.search(r"segagg_\w+", e.name)
        name = mark.group(0) if mark else e.name[:48]
        per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in per.items()}


def _device_line(torch, label: str, fn, calls: int) -> str:
    event = _event_ms(torch, fn, reps=calls)
    per = _device_ms(torch, fn, calls)
    total = sum(per.values())
    parts = ", ".join(f"{name} {ms:.4f}" for name, ms in sorted(per.items()))
    return (f"{label}: event {event:.4f} ms, device {total:.4f} ms ({parts or 'no device events'}),"
            f" event - device {event - total:.4f} ms")


# label -> (B or 0, n, G, gid order)
FEW_SHAPES = {
    **{f"k1 n=2^23 G={g} {order}": (0, 1 << 23, g, order)
       for g in (16, 128, 512, 1024) for order in ("random", "sorted")},
    "k5 B=8 n=2^20 G=128 random": (8, 1 << 20, 128, "random"),
}
FEW_HOST = ((0, 4096, 16), (8, 4096, 128))


def _few_inputs(torch, dev):
    """Half the weights zero, integral values; sorted gids stand for a table
    clustered on the group-by."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, (b, n, g, order) in FEW_SHAPES.items():
        rows = max(b, 1)
        gid = torch.randint(0, g, (rows, n), generator=gen, device=dev, dtype=torch.int32)
        if order == "sorted":
            gid = gid.sort(dim=1).values
        vals = torch.randint(0, 8, (rows, n), generator=gen, device=dev).float()
        w = (torch.rand((rows, n), generator=gen, device=dev) < 0.5).float()
        if b == 0:
            gid, vals, w = gid[0], vals[0], w[0]
        out[label] = (b, vals, gid, w, g)
    return out


_FLUSH = []


def _evict(torch):
    """A 64 MB device-to-device copy, which evicts the 50 MB L2."""
    if not _FLUSH:
        src = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
        _FLUSH.append((src, torch.empty_like(src)))
    src, dst = _FLUSH[0]
    dst.copy_(src)


def _split(per: Dict[str, float]) -> str:
    return ", ".join(f"{name} {ms:.4f}" for name, ms in sorted(per.items())) or "no events"


def _timed(torch, fn, cold: bool, calls: int = 20):
    """(event ms, {kernel: device ms}) of a call, L2 warm or evicted."""
    before = (lambda: _evict(torch)) if cold else None
    per = _device_ms(torch, fn, calls, before=before)
    per.pop("Memcpy DtoD (Device -> Device)", None)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        if before:
            before()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[calls // 2], per


def few(torch) -> None:
    """The few-group path: variants, device time split by kernel (warm and
    evicted) beside index_add_'s, host µs a call."""
    dev = torch.device("cuda")
    libs = _build(all_few_patches(), "few")
    data = _few_inputs(torch, dev)
    names = ("segment_aggregate", "segment_aggregate_batch")
    kept_libs = {k: build._LIBS.get(k) for k in names}
    try:
        for rnd in range(2):
            for name in (list(FEW_VARIANTS) if rnd == 0 else list(FEW_VARIANTS)[::-1]):
                build._LIBS.update(libs[name])
                for cold in (False, True):
                    times = []
                    for label, x in data.items():
                        _, per = _timed(torch, lambda: _call(*x), cold)
                        times.append(f"{label} {sum(per.values()):.4f}")
                    print(f"[few variants] round {rnd}, {name}, {'evicted' if cold else 'warm'}"
                          f" L2, device ms: " + "; ".join(times), flush=True)
        build._LIBS.update(libs["kernel"])
        for label, (b, vals, gid, w, g) in data.items():
            rows = max(b, 1)
            flat = (gid.reshape(rows, -1).long()
                    + g * torch.arange(rows, device=dev)[:, None]).reshape(-1)
            vw = torch.stack([(vals * w).reshape(-1), w.reshape(-1)], 1)
            out2 = torch.zeros(rows * g, 2, device=dev)
            for cold in (False, True):
                for who, fn in (("kernel", lambda: _call(b, vals, gid, w, g)),
                                ("index_add_", lambda: out2.index_add_(0, flat, vw))):
                    event, per = _timed(torch, fn, cold, calls=20 if who == "kernel" else 5)
                    print(f"[few device] {label}, {'evicted' if cold else 'warm'} L2, {who}: "
                          f"event {event:.4f} ms, device {sum(per.values()):.4f} ms "
                          f"({_split(per)})", flush=True)
            del flat, vw, out2
    finally:
        for k, v in kept_libs.items():
            if v is None:
                build._LIBS.pop(k, None)
            else:
                build._LIBS[k] = v
    _host(torch, FEW_HOST)


def paired_main(torch, parent: str) -> None:
    """The parent tree at ``parent`` (a checkout's root) and this one in
    turns, each in processes of its own: device ms of the few-group shapes
    and of segagg_sliced's rows (G = 2,048 and 16,384 at n = 2^23, phase
    5's fused launch)."""
    from pathlib import Path

    from repro_torch.kernels import measure

    cases = [dict(kind="segment", label=label, b=b, n=n, g=g, order=order)
             for label, (b, n, g, order) in FEW_SHAPES.items()]
    cases += [dict(kind="segment", label=f"k1 n=2^23 G={g} random", b=0, n=1 << 23, g=g,
                   order="random") for g in (2048, 16384)]
    cases.append(dict(kind="segment", label="phase-5 launch B=16 n=4x2^21 G=4096", b=16,
                      n=4 << 21, g=4096, order="phase5"))
    here = Path(__file__).resolve().parents[3]
    runs = measure.paired([Path(parent).resolve(), here], cases)
    for tree, per in runs.items():
        for label, ms in per.items():
            print(f"[paired] {'this tree' if Path(tree) == here else 'parent'}, {label}: "
                  f"device ms warm {', '.join(f'{m[0]:.4f}' for m in ms)}; evicted "
                  f"{', '.join(f'{m[1]:.4f}' for m in ms)}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--few", action="store_true",
                        help="the few-group path (up to 1,024 groups) instead of the sliced one")
    parser.add_argument("--paired", metavar="TREE",
                        help="time this tree against the checkout at TREE, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segagg_probe: no CUDA device")
    if args.paired:
        paired_main(torch, args.paired)
    elif args.few:
        few(torch)
    else:
        sliced(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


def sliced(torch) -> None:
    dev = torch.device("cuda")
    libs = _build(all_patches())
    data = _inputs(torch, dev)
    names = ("segment_aggregate", "segment_aggregate_batch")
    kept_libs = {k: build._LIBS.get(k) for k in names}
    try:
        for rnd in range(2):
            for name in VARIANTS:
                build._LIBS.update(libs[name])
                times = [f"{label} {_event_ms(torch, lambda: _call(*x)):.4f} ms"
                         for label, x in data.items()]
                print(f"[variants] round {rnd}, {name}: " + "; ".join(times), flush=True)
        lib = libs["sections"]
        build._LIBS.update(lib)
        for label, x in data.items():
            handle = lib["segment_aggregate" if x[0] == 0 else "segment_aggregate_batch"]
            handle.probe_read.argtypes = [ctypes.c_void_p]
            handle.probe_read.restype = ctypes.c_int
            for _ in range(3):
                _call(*x)
            torch.cuda.synchronize()
            rows = 16
            buf = (ctypes.c_ulonglong * (8 * rows))()
            build.check(handle.probe_read(buf), "probe_read")
            per = [list(buf)[8 * w:8 * w + 8] for w in range(rows)]
            line = []
            for w, p in enumerate(per):
                if p[7]:
                    sections = sections_of(w)
                    line.append(f"warp {w} ({p[7]} tiles): " + ", ".join(
                        f"{sections[i]} {p[i] / p[7]:.0f}" for i in sections if p[i]))
            print(f"[sections] {label}, block 0, cycles a tile: " + "; ".join(line), flush=True)
        # Event time against device time, the kernel and index_add_ (over
        # gid + b * G, as chip_smoke.py times it; index built untimed).
        build._LIBS.update(libs["kernel"])
        for label, (b, vals, gid, w, g) in data.items():
            rows = max(b, 1)
            flat = (gid.reshape(rows, -1).long()
                    + g * torch.arange(rows, device=dev)[:, None]).reshape(-1)
            vw = torch.stack([(vals * w).reshape(-1), w.reshape(-1)], 1)
            out2 = torch.zeros(rows * g, 2, device=dev)
            calls = 20 if SHAPES[label][3] is None else 5  # index_add_ is slow there
            print(f"[device] {label}, " + _device_line(
                torch, "kernel", lambda: _call(b, vals, gid, w, g), calls), flush=True)
            print(f"[device] {label}, " + _device_line(
                torch, "index_add_", lambda: out2.index_add_(0, flat, vw), calls), flush=True)
            del flat, vw, out2
    finally:
        for k, v in kept_libs.items():
            if v is None:
                build._LIBS.pop(k, None)
            else:
                build._LIBS[k] = v
    _host(torch, ((0, 4096, 4096), (16, 4096, 4096)))


def _host(torch, shapes) -> None:
    """Host time of a launch: small launches in a loop, one synchronise;
    the wrapper whole, then its parts (the argument checks; the sums and
    counts, one allocation split in two, beside two allocations; the C call
    with its launches), and index_add_."""
    from repro_torch.kernels import segment_aggregate as ksa

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(4)
    for b, n, g in shapes:
        rows = max(b, 1)
        gid = torch.randint(0, g, (rows, n), generator=gen, device=dev, dtype=torch.int32)
        w = torch.ones((rows, n), device=dev)
        x = (b, w, gid, w, g) if b else (0, w[0], gid[0], w[0], g)
        out2 = torch.zeros(rows * g, 2, device=dev)
        flat = (gid.long() + g * torch.arange(rows, device=dev)[:, None]).reshape(-1)
        vw = torch.stack([w.reshape(-1), w.reshape(-1)], 1)
        name = ksa.BATCH_NAME if b else ksa.NAME
        index, plan = ksa._plan_on(dev, name, n, g)
        shape = (b, g) if b else (g,)
        sums, counts = ksa._buffers(dev, shape)
        lib = build.library(name)
        fn = lib.segagg_batch_launch if b else lib.segagg_launch
        sizes = (n, b, g) if b else (n, g)
        ptrs = [t.data_ptr() for t in x[1:4]]

        def c_call():
            return ksa._launch(fn, dev, index, plan, rows, g, sums, counts, *ptrs, *sizes)

        def checks():
            for t in x[1:4]:
                build.check_tensor(t, "t", t.dtype, t.device, t.shape)

        for label, call in (("kernel", lambda: _call(*x)), ("of it the checks", checks),
                            ("of it the allocation", lambda: ksa._buffers(dev, shape)),
                            ("two allocations", lambda: (torch.empty(shape, device=dev),
                                                         torch.empty(shape, device=dev))),
                            ("of it the C call and launches", c_call),
                            ("index_add_", lambda: out2.index_add_(0, flat, vw))):
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                call()
            torch.cuda.synchronize()
            print(f"[host] {label}, B={b or 'unbatched'} n={n} G={g}: "
                  f"{(time.perf_counter() - t0) / 2000 * 1e6:.1f} us a call", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
