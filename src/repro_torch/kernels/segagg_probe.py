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
    return _cut(src, "  if (cluster == 0) {\n    const size_t bytes",
                "  if (err != cudaSuccess) return (int)err;\n  err = cudaGetLastError();",
                "  err = cudaSuccess;\n  (void)smem;\n  (void)part_rows;\n")


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


def all_patches() -> Dict[str, str]:
    """Every patched source of this tree by name (no build): what the CPU
    test applies."""
    src = SOURCE.read_text()
    out = {name: patch(src) for name, patch in VARIANTS.items()}
    out["sections"] = instrument(src)
    return out


def _build() -> Dict[str, Dict[str, ctypes.CDLL]]:
    """Every patched source, built twice, as the unbatched and the batched
    library (the batched source includes the unbatched one), all at once."""
    jobs = []
    for i, (name, text) in enumerate(all_patches().items()):
        vdir = PROBE_DIR / f"segagg_{i}"
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


def _device_ms(torch, fn, calls: int) -> Dict[str, float]:
    """Device milliseconds a call of ``fn`` by kernel, from ``torch.profiler``
    over ``calls`` calls after warm-ups: each kernel's duration summed over
    its launches.  Empty if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
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


def main() -> int:
    import torch

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    dev = torch.device("cuda")
    libs = _build()
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
        # Host time of a launch: small launches in a loop, one synchronise;
        # the wrapper whole, then its parts (the argument checks, the three
        # allocations, the C call with its two launches), and index_add_.
        from repro_torch.kernels import segment_aggregate as ksa

        gen = torch.Generator(device=dev).manual_seed(4)
        for b, n, g in ((0, 4096, 4096), (16, 4096, 4096)):
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
            bufs = ksa._buffers(dev, shape, plan)
            ptrs = [t.data_ptr() for t in (x[1], x[2], x[3], *bufs)]
            tail = (plan.parts, plan.part_rows, plan.cluster, plan.smem)
            stream = build.stream_handle(dev)
            sizes = (n, b, g) if b else (n, g)
            launch = getattr(build.library(name),
                             "segagg_batch_launch" if b else "segagg_launch")

            def c_call():
                return launch(index, stream, *ptrs[:3], *sizes, *ptrs[3:], *tail)

            def checks():
                for t in x[1:4]:
                    build.check_tensor(t, "t", t.dtype, t.device, t.shape)

            for label, fn in (("kernel", lambda: _call(*x)), ("of it the checks", checks),
                              ("of it the allocations", lambda: ksa._buffers(dev, shape, plan)),
                              ("of it the C call and launches", c_call),
                              ("index_add_", lambda: out2.index_add_(0, flat, vw))):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                torch.cuda.synchronize()
                print(f"[host] {label}, B={b or 'unbatched'} n={n} G={g}: "
                      f"{(time.perf_counter() - t0) / 2000 * 1e6:.1f} us a call", flush=True)
    finally:
        for k, v in kept_libs.items():
            if v is None:
                build._LIBS.pop(k, None)
            else:
                build._LIBS[k] = v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
