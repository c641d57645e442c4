#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phase 1 builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once).  Phase 2 holds each kernel against
its plain PyTorch version on the card at the main path's shapes and times
both, the bandwidth bound and one PyTorch library call as a yardstick
(sketch_filter also as the mask and kept rows of one launch at 5% and 40%
kept, fragment_bitmap also at 32,768 ranges and as one kernel a call,
fragment_bitmap_batch as one kernel a call, segment_aggregate at the group
pads 16 to 16,384, with sorted gids beside random ones up to 1,024 groups,
each beside its device time from ``torch.profiler`` by kernel; and the f32
flash-attention kernel and SDPA in turns on the same shapes).
Phase 3 runs ``PBDSEngine.run`` (CB-OPT-GB, 100 ranges, theta 0.05) over a
Chicago-Crime-sized table (6.7M rows x 9 int32 columns on the device),
replaying a generated workload, and checks every result against execution
over the full table; it also times selection's host incidence pass.
Phase 4 drives ``PBDSEngine.run_batch`` and maintenance on the same table
with a fresh engine: bursts of queries that differ only in their HAVING
thresholds, a replay, an append of 1% of the rows, a burst that repairs
every sketch, a delete of one year and another burst; it checks every
result against full-table execution of the current version and every
maintained sketch against a fresh capture; phases 3-5 require every
sketch_filter launch to compact its kept rows on the card, and phases 4
and 5 log the instance build's mask branch step by step.  Phase 5 drives the sharded path
on the same table: a ``ShardedEngine`` over 4 fragment shards placed on the
``community`` partition, a ``run_batch`` burst of three signature groups
(two grouping by ``community``, whose bits the shards maintain, one not,
whose bits the coordinator maintains), a replay served by one fused
``segment_aggregate_batch`` launch, the same replay through the per-shard
host loop and fused again, and an append and a delete each followed by the
burst; after the delete a burst with thresholds taken anew from the current
table and its replay, so that the post-delete check holds real output;
every result is checked against a plain numpy group-by of the full table,
the fused and host-loop results against each other bit for bit, and no
route may be served degraded.  Phase 9 drives shard faults on phase 5's
engine and last burst: a kill of the shard owning the most sketch bits
(its slices served from the coordinator's table inside the one fused
launch), a 1% append while it is dead, its heal (recovery by checkpoint
adopt, delta replay and re-registration, each timed), a partition across a
one-year delete, a flaky shard, a stall past a lowered deadline, and a kill
with ``rebalance`` replayed fused and through the host loop; every result
is checked against a plain group-by of its version, the recovered shard's
maintainers against fresh captures of its rows, the route's
``degraded``/``failed_shards``/``n_retries`` against the fault, and no
step may re-capture.  Phase 10 drives phase 5's configuration again with
its shards as server processes on the card: a ``FailoverCoordinator``
around ``ShardedEngine(..., transport="subprocess")`` (4 shard servers, a
standby process), on phase 3's table and phase 5's first burst: the burst,
fused replays (stacks built over RPC, then cached) and a host-loop one;
phase 5's 1% append and one-year delete with a replay each (peer mirrors
advance); a SIGKILL of the server owning the most sketch bits, a degraded
replay and its heal (recovery from the peer's mirror, timed by part);
``coord_kill`` and ``coord_partition`` (standby takeovers); shutdown.  Every
result must equal phase 5's loopback result of its version bit for bit and
a plain group-by; the recovered maintainers must equal fresh captures, the
zombie coordinator be fenced, the promoted one run on the card and launch
the fused kernel, each server run on the card and launch sketch_filter,
and no server or standby outlive the phase (``nvidia-smi``'s compute
apps); the servers' launches count in the kernels line.  Phase 7 drives the join templates at TPC-H
scale factor 1 (lineitem 6,001,215 rows, orders 1,500,303, part 1,000,202,
from ``make_tpch``'s distributions): ``run`` over three generated Q-AJGH and
a Q-AAJGH, replayed; ``run_batch`` of six Q-AJGH differing in their HAVING
thresholds, a replay, a 1% append, a one-year delete, a one-year delete of
orders (a dimension: the sketches stay, as the reference keeps them), a
second 1% append that re-captures every join sketch, and a burst with
thresholds taken anew; a ``ShardedEngine`` over 4 shards with its fused and
host-loop replays and an orders delete that evicts the join sketches.
Every result is checked against full-table execution of its version and a
plain numpy join and group-by, every maintained sketch against a fresh
capture, the fused results against the host loop's bit for bit, and kernels
1-5 must each launch.  Phase 8 drives every selection strategy of the
paper: on phase 3's crimes table a fresh ``PBDSEngine`` (100 ranges, theta
0.05) for NO-PS and each of the five random, three cost-based strategies
and OPT over three generated queries and their replay, and a ``run_batch``
burst under RAND-GB; Fig. 9's mix (NO-PS, RAND-PK, RAND-GB, CB-OPT-GB,
24 runs of 8 generated queries) over phase 7's TPC-H ``lineitem`` and a
6.7M-row ``make_stars`` table, each engine's maintainer builds and group
encodings timed on the host; and four two-attribute Q-AGH queries
through ``select_composite_gb``, ``capture_composite`` and
``execute_with_composite``.  It checks every result against full-table
execution, every random pick against its candidate pool and a second
engine's, the batch against the sequential runs, each composite sketch
against the single sketches of its parts and the plain bitmap, and that
kernels 1-4 each launch.  Phases run in the order 1-5, 9, 10, 7, 8, 6.  Phase 6 serves ``stablelm-1.6b`` at full
width and depth (24 layers, d_model 2048, 32 heads, vocab 100,352, bf16,
random weights from the seed) through ``launch.serve.serve``: sketch-filtered
admission of 16 requests out of 5,000, a 64-token prefill whose 24 attention
layers run the flash-attention kernel, and 16 greedy tokens; it checks the
admitted requests against the CPU pipeline and a plain numpy evaluation of
the curation query, each layer's attention through the kernel against the
plain chunked loop (float32 copies of the weights, where decode is also
held against prefill, and the bf16 weights themselves at both prompts),
that every bf16 prefill ran the tensor-core kernel, and a 2,048-token
prompt.  Any failed check raises, so the exit code is not 0.

Output: per-phase lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit as ``nvidia-smi`` reports them, and last
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the repository's
``src/`` beside this file; without either it exits non-zero before printing
any result.  Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense, tensor cores
ENVELOPE = float(1 << 24)  # float32 adds integers exactly below this
KERNEL_ROWS = 1 << 23  # 6.7M rows padded to pow2, the executor's row class
ROWS = 6_700_000  # Chicago Crime in the paper's evaluation
UNIQUE, REPLAYS, SEED = 8, 3, 9
SEED_SERVE = 0  # serve.py's default --seed
APPEND_FRAC = 0.01  # phase 4 appends 1% of the rows

# (name, source, TPU kernel it replaces)
KERNELS = (
    ("segment_aggregate", "src/repro_torch/kernels/csrc/segment_aggregate.cu",
     "src/repro/kernels/segment_aggregate.py:119"),
    ("fragment_bitmap", "src/repro_torch/kernels/csrc/fragment_bitmap.cu",
     "src/repro/kernels/fragment_bitmap.py:44"),
    ("sketch_filter", "src/repro_torch/kernels/csrc/sketch_filter.cu",
     "src/repro/kernels/sketch_filter.py:35"),
    ("fragment_bitmap_batch", "src/repro_torch/kernels/csrc/fragment_bitmap_batch.cu",
     "src/repro/kernels/fragment_bitmap.py:99"),
    ("segment_aggregate_batch", "src/repro_torch/kernels/csrc/segment_aggregate_batch.cu",
     "src/repro/kernels/segment_aggregate.py:74"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:89"),
)
N_SHARDS = 4
SHARD_ATTR = "community"  # the partition phase 4's waves chose
# segment_aggregate in phase 2: the executor's group pads, (G, gid order):
# the few-group kernel's at 16 and at the pads the engine's group-bys take
# (128, 512, 1,024), each also with sorted gids (a table clustered on the
# group-by), and the cluster kernel's narrowest width 2,048 and widest
# 16,384; the JSON row is the widest.  segment_aggregate_batch's JSON row:
# (B, n, G) of a fused launch whose group-bys pad to 128.
SEGMENT_CASES = ((16, "random"), (128, "random"), (128, "sorted"), (512, "random"),
                 (512, "sorted"), (1024, "random"), (1024, "sorted"), (2048, "random"),
                 (16384, "random"))
SEGMENT_REPORTED = (16384, "random")
ROWS_COUNTER = "sketch_filter.rows"  # launches that also compact the kept rows
BATCH_REPORTED = (8, 4 << 18, 128)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def require_compacted(label: str, launches: int, rows_launches: int) -> None:
    """Every sketch_filter launch of an engine path compacted its kept rows
    on the card (the instance build's mask branch), none built a bare mask."""
    log(f"[{label}] sketch_filter launches {launches}, of them mask and rows {rows_launches}")
    require(launches == rows_launches,
            f"{label}: {launches - rows_launches} sketch_filter launches did not compact the rows")


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.KERNELS:
        build.library(name)
    log(f"[build] {len(logs)} of {len(build.KERNELS)} kernels compiled in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def phase_kernels(n: int, seed: int) -> dict:
    import torch

    from repro_torch.kernels import measure, ops, ref

    def device_ms(fn):
        return {k: round(v, 5) for k, v in measure.device_ms(torch, fn).items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    # fragment_bitmap: capture at n_ranges = 100, a quarter of the rows in the
    # provenance; logged also at 32,768 ranges (its widest).  One launch a call.
    n_ranges = 100
    bucket = torch.randint(0, n_ranges, (n,), generator=gen, device=dev, dtype=torch.int32)
    drawn = torch.rand(n, generator=gen, device=dev) < 0.3
    for width in (32768, n_ranges):
        b = bucket if width == n_ranges else torch.randint(
            0, width, (n,), generator=gen, device=dev, dtype=torch.int32)
        b_l = b.long()
        # Leave some fragments empty so the bitmap is not all ones.
        prov = drawn & (b % 7 != 3)
        nnz = int(prov.sum())
        sectors = measure.bitmap_sectors(prov)
        prov_i = prov.to(torch.int32)
        got = ops.fragment_bitmap(prov, b, width)
        want = ref.fragment_bitmap_ref(prov, b, width)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fragment_bitmap ({width} ranges) disagrees with its "
                                        f"plain version")
        require(bool(got.any()) and not bool(got.all()), "bitmap test is degenerate")
        per = device_ms(lambda: ops.fragment_bitmap(prov, b, width))
        require(len(per) == 1, f"fragment_bitmap is not one kernel a call: {per}")
        # Buckets are read by 32-byte sectors: those holding a provenance row.
        b_ms, b_by = bound(n + 32 * sectors + width, n)
        row = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: ops.fragment_bitmap(prov, b, width)),
            plain_ms=time_ms(lambda: ref.fragment_bitmap_ref(prov, b, width)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.zeros(width, dtype=torch.int32, device=dev)
                               .scatter_reduce_(0, b_l, prov_i, reduce="amax")),
        )
        log(f"[kernels] fragment_bitmap n={n} n_ranges={width} bit-exact, {nnz} provenance rows "
            f"in {sectors} of {n // 8} bucket sectors; device {sum(per.values()):.4f} ms {per}; "
            f"{row}")
        del b, b_l, prov_i
    # The bound counted 4 bytes a provenance row before; sectors move 32.
    log(f"[kernels] fragment_bitmap bound by 4 bytes a provenance row (not sectors): "
        f"{bound(n + 4 * nnz + n_ranges, n)[0]:.5f} ms")
    rows["fragment_bitmap"] = row

    # sketch_filter: the keep-mask at 100 ranges, 40 of them set; then the
    # mask and its kept rows (the instance build's one launch) at 5% and 40%
    # kept, against torch.nonzero of the indexing; the JSON row is 5%.
    bucket_l = bucket.long()  # the yardsticks' index, made outside their timing
    bits = torch.zeros(n_ranges, dtype=torch.bool, device=dev)
    bits[torch.randperm(n_ranges, generator=gen, device=dev)[:40]] = True
    got = ops.sketch_filter(bucket, bits)
    want = ref.sketch_filter_ref(bucket, bits)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "sketch_filter disagrees with its plain version")
    per = device_ms(lambda: ops.sketch_filter(bucket, bits))
    mask_row = dict(
        ms=time_ms(lambda: ops.sketch_filter(bucket, bits)),
        bound_ms=bound(n * 4 + n_ranges + n * 1, 0)[0],
        library_ms=time_ms(lambda: bits[bucket_l]),
        library_device=sum(device_ms(lambda: bits[bucket_l]).values()))
    log(f"[kernels] sketch_filter mask n={n} n_ranges={n_ranges} bit-exact; device "
        f"{sum(per.values()):.4f} ms {per}; {mask_row}")
    for share in (40, 5):
        bits = torch.zeros(n_ranges, dtype=torch.bool, device=dev)
        bits[torch.randperm(n_ranges, generator=gen, device=dev)[:share]] = True
        keep, kept = ops.sketch_filter_rows(bucket, bits)
        want, want_rows = ref.sketch_filter_rows_ref(bucket, bits)
        torch.cuda.synchronize()
        require(torch.equal(keep, want) and torch.equal(kept, want_rows),
                f"sketch_filter_rows ({share}% kept) disagrees with its plain version")
        again = ops.sketch_filter_rows(bucket, bits)
        require(torch.equal(again[0], keep) and torch.equal(again[1], kept),
                f"sketch_filter_rows ({share}% kept) gave other rows on a rerun")
        k = int(kept.numel())
        per = device_ms(lambda: ops.sketch_filter_rows(bucket, bits))
        yard = device_ms(lambda: torch.nonzero(bits[bucket_l]))
        b_ms, b_by = bound(n * 4 + n_ranges + n * 1 + k * 8, 0)
        row = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: ops.sketch_filter_rows(bucket, bits)),
            plain_ms=time_ms(lambda: ref.sketch_filter_rows_ref(bucket, bits)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.nonzero(bits[bucket_l])),
        )
        log(f"[kernels] sketch_filter_rows n={n} n_ranges={n_ranges} {share}% kept (k={k}) "
            f"bit-exact, rerun equal; device {sum(per.values()):.4f} ms {per}, torch.nonzero "
            f"device {sum(yard.values()):.4f} ms; {row}")
    rows["sketch_filter"] = row
    del keep, kept, want, want_rows, again

    # fragment_bitmap_batch: a wave's capture, B masks over one bucketization,
    # one kernel a call.  The row is B = 8 (a pow2-padded burst of 5-8
    # thresholds); B = 32 is logged.
    for b in (32, 8):
        provs = torch.rand((b, n), generator=gen, device=dev) < 0.3
        # Each mask leaves its own fragments empty, so no two rows are alike.
        provs &= (bucket[None, :] + torch.arange(b, device=dev)[:, None]) % 7 != 3
        got = ops.fragment_bitmap_batch(provs, bucket, n_ranges)
        want = ref.fragment_bitmap_batch_ref(provs, bucket, n_ranges)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"fragment_bitmap_batch (B={b}) disagrees with its plain version")
        for i in range(b):
            require(torch.equal(got[i], ops.fragment_bitmap(provs[i], bucket, n_ranges)),
                    f"fragment_bitmap_batch (B={b}) row {i} disagrees with fragment_bitmap")
        require(bool(got.any()) and not bool(got.all()), "batch bitmap test is degenerate")
        events = measure.device_events(torch, lambda: ops.fragment_bitmap_batch(
            provs, bucket, n_ranges))
        require(events == 1, f"fragment_bitmap_batch (B={b}) is {events} device events a call")
        per = device_ms(lambda: ops.fragment_bitmap_batch(provs, bucket, n_ranges))
        provs_i = provs.to(torch.int32)
        index = bucket_l.expand(b, n)
        b_ms, b_by = bound(n * 4 + b * n + b * n_ranges, 0)
        rows["fragment_bitmap_batch"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: ops.fragment_bitmap_batch(provs, bucket, n_ranges)),
            plain_ms=time_ms(lambda: ref.fragment_bitmap_batch_ref(provs, bucket, n_ranges)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.zeros((b, n_ranges), dtype=torch.int32, device=dev)
                               .scatter_reduce_(1, index, provs_i, reduce="amax")),
        )
        log(f"[kernels] fragment_bitmap_batch n={n} n_ranges={n_ranges} B={b} bit-exact, "
            f"rows equal to fragment_bitmap; {events} kernel a call, device "
            f"{sum(per.values()):.4f} ms {per}; {rows['fragment_bitmap_batch']}")
        del provs, provs_i, index, got, want

    # segment_aggregate: the executor's group pads, integral and normal values
    # (G = 2,048 is the narrowest width of the cluster kernel, one slice),
    # with device time by kernel beside index_add_'s.
    seg_err = 0.0
    for g, order in SEGMENT_CASES:
        gid = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        if order == "sorted":
            gid = gid.sort().values
        w = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.float32)
        integral = torch.randint(0, 8, (n,), generator=gen, device=dev).to(torch.float32)
        s1, c1 = ops.segment_aggregate(integral, gid, g, w)
        s2, c2 = ref.segment_aggregate_ref(integral, gid, g, w)
        torch.cuda.synchronize()
        require(float(s2.max()) < ENVELOPE, "integral test sums left the 2^24 envelope")
        require(torch.equal(s1, s2) and torch.equal(c1, c2),
                f"segment_aggregate (G={g}, {order}) is not bit-exact on integral inputs")
        # Normal values: rounding depends on the order of additions, so both
        # are held against a float64 sum, within 1e-5 of the group's sum of
        # |v * w| (the scale of float32 summation error).
        normal = torch.randn(n, generator=gen, device=dev)
        s1, c1 = ops.segment_aggregate(normal, gid, g, w)
        s2, _ = ref.segment_aggregate_ref(normal, gid, g, w)
        gl = gid.long()
        truth = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
            0, gl, (normal * w).double())
        scale = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
            0, gl, (normal * w).abs().double())
        err_k = float(((s1.double() - truth).abs() / scale.clamp_min(1e-30)).max())
        err_p = float(((s2.double() - truth).abs() / scale.clamp_min(1e-30)).max())
        require(err_k <= 1e-5 and err_p <= 1e-5,
                f"segment_aggregate (G={g}, {order}) normal sums off: kernel {err_k:.2e}, plain "
                f"{err_p:.2e}")
        require(torch.equal(c1, c2), f"segment_aggregate (G={g}, {order}) counts differ")
        # The kernel adds in a fixed order: reruns give the same bits.
        for _ in range(3):
            s3, c3 = ops.segment_aggregate(normal, gid, g, w)
            require(torch.equal(s1, s3) and torch.equal(c1, c3),
                    f"segment_aggregate (G={g}, {order}) gave other bits on a rerun of normal "
                    f"inputs")
        diff = float((s1 - s2).abs().max())
        seg_err = max(seg_err, diff)
        vw2 = torch.stack([integral * w, w], dim=1)
        out2 = torch.zeros(g, 2, dtype=torch.float32, device=dev)
        nnz_w = int((w != 0).sum())
        b_ms, b_by = bound(n * 8 + nnz_w * 4 + g * 8, 3 * nnz_w)
        ms = time_ms(lambda: ops.segment_aggregate(integral, gid, g, w))
        card = card_state()
        per = device_ms(lambda: ops.segment_aggregate(integral, gid, g, w))
        yard = device_ms(lambda: out2.index_add_(0, gl, vw2))
        row = dict(
            max_abs_err=diff, ms=ms,
            plain_ms=time_ms(lambda: ref.segment_aggregate_ref(integral, gid, g, w)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: out2.index_add_(0, gl, vw2)),
        )
        log(f"[kernels] segment_aggregate n={n} G={g} {order} gids integral bit-exact; normal "
            f"rel err kernel {err_k:.2e} plain {err_p:.2e}, max |kernel-plain| {diff:.3e}, "
            f"3 reruns bit-equal; kernel {ms:.4f} ms, device {sum(per.values()):.4f} ms {per}; "
            f"index_add_ {row['library_ms']:.4f} ms, device {sum(yard.values()):.4f} ms "
            f"(SM clock, power after the kernel: {card}); {row}")
        if (g, order) == SEGMENT_REPORTED:
            rows["segment_aggregate"] = row
    rows["segment_aggregate"]["max_abs_err"] = seg_err
    rows["segment_aggregate_batch"] = _kernel_segment_aggregate_batch(n, gen, rows)
    rows["flash_attention"] = _kernel_flash_attention(seed)
    _flash_f32_pairs(seed)
    return rows


def _kernel_segment_aggregate_batch(n: int, gen, rows: dict) -> dict:
    """segment_aggregate_batch at the fused launch's shapes (B sketches of
    S_pad * R_pad = 4 * 2^18 rows, at a narrow, a middle and the widest
    group pad), and at B = 1 over ``n`` rows to compare with the unbatched
    kernel's row.  The reported row is BATCH_REPORTED, picked by its shape
    (phase 5's group-bys pad to 128-512)."""
    import torch

    from repro_torch.kernels import measure, ops, ref

    dev = torch.device("cuda")
    out = None
    for b, n_b, g in ((8, 4 << 18, 16384), (1, n, 16384), (8, 4 << 18, 4096),
                      BATCH_REPORTED):
        gid = torch.randint(0, g, (b, n_b), generator=gen, device=dev, dtype=torch.int32)
        w = (torch.rand((b, n_b), generator=gen, device=dev) < 0.5).to(torch.float32)
        integral = torch.randint(0, 8, (b, n_b), generator=gen, device=dev).to(torch.float32)
        s1, c1 = ops.segment_aggregate_batch(integral, gid, g, w)
        s2, c2 = ref.segment_aggregate_batch_ref(integral, gid, g, w)
        torch.cuda.synchronize()
        require(float(s2.max()) < ENVELOPE, "integral test sums left the 2^24 envelope")
        require(torch.equal(s1, s2) and torch.equal(c1, c2),
                f"segment_aggregate_batch (B={b}, G={g}) is not bit-exact on integral inputs")
        for i in range(b):
            su, cu = ops.segment_aggregate(integral[i], gid[i], g, w[i])
            require(torch.equal(s1[i], su) and torch.equal(c1[i], cu),
                    f"segment_aggregate_batch (B={b}, G={g}) row {i} differs from "
                    f"segment_aggregate")
        normal = torch.randn((b, n_b), generator=gen, device=dev)
        s1, c1 = ops.segment_aggregate_batch(normal, gid, g, w)
        for _ in range(3):
            s3, c3 = ops.segment_aggregate_batch(normal, gid, g, w)
            require(torch.equal(s1, s3) and torch.equal(c1, c3),
                    f"segment_aggregate_batch (B={b}, G={g}) gave other bits on a rerun")
        rows_equal = all(torch.equal(s1[i], ops.segment_aggregate(normal[i], gid[i], g, w[i])[0])
                         for i in range(b))
        require(rows_equal, f"segment_aggregate_batch (B={b}, G={g}): a row of normal values "
                            f"differs from the unbatched kernel")
        s2, _ = ref.segment_aggregate_batch_ref(normal, gid, g, w)
        diff = float((s1 - s2).abs().max())
        flat = (gid.long() + g * torch.arange(b, device=dev)[:, None]).reshape(-1)
        vw2 = torch.stack([(integral * w).reshape(-1), w.reshape(-1)], dim=1)
        out2 = torch.zeros(b * g, 2, dtype=torch.float32, device=dev)
        nnz_w = int((w != 0).sum())
        b_ms, b_by = bound(b * n_b * 8 + nnz_w * 4 + b * g * 8, 3 * nnz_w)
        ms = time_ms(lambda: ops.segment_aggregate_batch(integral, gid, g, w))
        card = card_state()
        per = {k: round(v, 5) for k, v in measure.device_ms(
            torch, lambda: ops.segment_aggregate_batch(integral, gid, g, w)).items()}
        row = dict(
            max_abs_err=diff, ms=ms,
            plain_ms=time_ms(lambda: ref.segment_aggregate_batch_ref(integral, gid, g, w)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: out2.index_add_(0, flat, vw2)),
        )
        log(f"[kernels] segment_aggregate_batch B={b} n={n_b} G={g} integral bit-exact and "
            f"equal to segment_aggregate row by row; normal: 3 reruns bit-equal, rows equal "
            f"to the unbatched kernel, max |kernel-plain| {diff:.3e}; kernel {ms:.4f} ms, "
            f"device {sum(per.values()):.4f} ms {per}; index_add_ {row['library_ms']:.4f} ms "
            f"(SM clock, power after the kernel: {card}); {row}")
        if b == 1:
            log(f"[kernels] segment_aggregate_batch B=1 vs segment_aggregate at n={n} G={g}: "
                f"{row['ms']:.4f} ms vs {rows['segment_aggregate']['ms']:.4f} ms")
        if (b, n_b, g) == BATCH_REPORTED:
            out = row
        del gid, w, integral, normal, flat, vw2, out2
    return out


# flash_attention in phase 2: (B, S, T, Hq, Hkv, D, causal, window, dtype).
# The Pallas kernel's test grid (tests/test_kernels.py:82-97), serving
# prefill at stablelm-1.6b's heads (the 64- and 2,048-token prompts of
# phase 6), gemma3's local layers (32 query heads on 16 kv heads, head dim
# 168, window 1,024) over 4,096 tokens, and internlm2-20b's prefill heads
# (48 query heads on 8 kv heads, head dim 128).  The JSON row is the
# 2,048-token serving prefill.
FLASH_SHAPES = (
    [(2, s, t, 3, 3, 64, causal, window, dtype)
     for dtype in ("float32", "bfloat16")
     for s, t in ((64, 64), (96, 96), (1, 96))
     for causal, window in ((True, 0), (True, 32), (False, 0))]
    + [(16, 64, 64, 32, 32, 64, True, 0, "bfloat16"),
       (1, 4096, 4096, 32, 16, 168, True, 1024, "bfloat16"),
       (4, 2048, 2048, 48, 8, 128, True, 0, "bfloat16"),
       (16, 2048, 2048, 32, 32, 64, True, 0, "bfloat16")]
)
FLASH_REPORTED = FLASH_SHAPES[-1]
# Kernel against plain version: f32 sums in another order (f32); one bf16
# ulp of outputs up to 2 (bf16).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def live_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """Query-key pairs the masks leave live, q rows end-aligned with k."""
    import numpy as np

    pos = np.arange(s, dtype=np.int64) + (t - s)
    hi = pos if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def card_state() -> str:
    """The card's SM clock and power draw now, as ``nvidia-smi`` reads them
    (a flash row's time is read beside it: times of one shape move up to
    1.9x between calls)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def _kernel_flash_attention(seed: int) -> dict:
    """flash_attention against flash_attention_ref at FLASH_SHAPES, on the
    (B, S, H, D) layout gqa_chunked hands it, timed beside the plain version
    and torch's scaled_dot_product_attention (the library yardstick, never on
    the path), with the card's SM clock and power read after each kernel
    timing.  bf16 rows must run the tensor-core kernel, and every row must
    agree bit for bit on a rerun."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import TC_COUNTER, flash_attention
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out, worst = None, 0.0
    for shape in FLASH_SHAPES:
        b, s, t, hq, hkv, d, causal, window, dtype = shape
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dt)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D) views

        def kernel():
            return flash_attention(q, k, v, causal=causal, window=window, layout="bshd")

        def plain():
            return ref.flash_attention_ref(qh, kh, vh, causal, window)

        before_tc = LAUNCH_COUNTS[TC_COUNTER]
        got = kernel().transpose(1, 2)
        again = kernel().transpose(1, 2)
        want = plain()
        torch.cuda.synchronize()
        require(LAUNCH_COUNTS[TC_COUNTER] - before_tc == (2 if dtype == "bfloat16" else 0),
                f"flash_attention {shape} did not run the {dtype} kernel")
        require(torch.equal(got, again), f"flash_attention {shape}: a rerun gave other bits")
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
        require(not bool(bad.any()) and bool(torch.isfinite(got).all()),
                f"flash_attention {shape} disagrees with its plain version: max err {err:.3e}")
        worst = max(worst, err)
        pos = torch.arange(s, device=dev)[:, None] + (t - s)
        kpos = torch.arange(t, device=dev)[None, :]
        mask = torch.ones((s, t), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= pos
        if window > 0:
            mask &= kpos > pos - window
        sdpa_kw = (dict(is_causal=True) if causal and window == 0 and s == t
                   else dict(attn_mask=mask))

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=hkv != hq, **sdpa_kw)

        pairs = live_pairs(s, t, causal, window)
        item = q.element_size()
        b_ms, b_by = bound(item * (2 * b * hq * s * d + 2 * b * hkv * t * d),
                           4 * b * hq * d * pairs,
                           BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S)
        ms = time_ms(kernel)
        card = card_state()
        row = dict(max_abs_err=err, ms=ms, plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library))
        log(f"[kernels] flash_attention B={b} S={s} T={t} Hq={hq} Hkv={hkv} D={d} "
            f"causal={causal} window={window} {dtype}: live pairs {pairs}, within {tol} of "
            f"plain, rerun bit-equal; kernel {ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}; SDPA "
            f"{row['library_ms']:.4f} ms; SM clock, power after it: {card}); {row}")
        if shape == FLASH_REPORTED:
            out = row
        del q, k, v, qh, kh, vh, got, again, want, mask, bad
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


# The f32 flash kernel (flash_fwd_kernel; the per-layer f32 check's) and
# SDPA on the same shapes, in turns: (B, S, T, H, D), causal.  The Pallas
# kernel's test grid's widest, the default serve's prefill and its
# 2,048-token prompt, at stablelm-1.6b's heads.
FLASH_F32_PAIRS = ((2, 96, 96, 3, 64), (16, 64, 64, 32, 64), (1, 2048, 2048, 32, 64))


def _flash_f32_pairs(seed: int) -> None:
    """Each FLASH_F32_PAIRS shape: the kernel within FLASH_TOL of the plain
    version, then kernel, SDPA, kernel, SDPA: CUDA-event ms of a call and
    device ms (``torch.profiler``) each time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import measure, ref
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    for b, s, t, h, d in FLASH_F32_PAIRS:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device=dev) for n in (s, t, t))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        fns = {"kernel": lambda: flash_attention(q, k, v, causal=True, layout="bshd"),
               "SDPA": lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)}
        got = fns["kernel"]().transpose(1, 2)
        want = ref.flash_attention_ref(qh, kh, vh, True, 0)
        tol = FLASH_TOL["float32"]
        require(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
                f"flash_attention f32 {(b, s, t, h, d)} disagrees with its plain version")
        times = {who: [] for who in fns}
        for who in ("kernel", "SDPA", "kernel", "SDPA"):
            per = measure.device_ms(torch, fns[who])
            times[who].append((time_ms(fns[who]), sum(per.values())))
        log(f"[kernels] flash_attention f32 B={b} S={s} T={t} H={h} D={d} causal, in turns "
            f"(event ms, device ms): " + "; ".join(
                f"{who} " + ", ".join(f"({e:.4f}, {d_:.4f})" for e, d_ in vals)
                for who, vals in times.items()) + f"; SM clock, power: {card_state()}")
        del q, k, v, qh, kh, vh, got, want


# ---------------------------------------------------------------------------
# Phase 3: the engine at real scale
# ---------------------------------------------------------------------------


def _result_map(res):
    attrs = sorted(res.group_values)
    return {tuple(float(res.group_values[a][i]) for a in attrs): float(res.values[i])
            for i in range(len(res.values))}


def _same_result(a, b) -> bool:
    """The same groups in the same order with equal values: the fast form
    of equal canonical results."""
    import numpy as np

    return (sorted(a.group_values) == sorted(b.group_values) and len(a.values) == len(b.values)
            and all(np.array_equal(a.group_values[k], b.group_values[k]) for k in a.group_values)
            and np.array_equal(a.values, b.values))


def check_result(q, res, full, envelope_left: bool) -> str:
    """'exact' when ``res`` equals full-table execution; 'within 1e-6' when
    the group sums left the float32 integer envelope and every difference
    is order-of-addition rounding.  Raises otherwise."""
    if _same_result(res, full) or res.canonical() == full.canonical():
        return "exact"
    require(envelope_left, f"{q}: result differs from full-table execution inside "
                           f"the 2^24 envelope")
    a, b = _result_map(res), _result_map(full)
    tau = q.having.value
    for k in set(a) | set(b):
        if k in a and k in b:
            require(abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), f"{q}: group {k} {a[k]} vs {b[k]}")
        else:
            v = a.get(k, b.get(k))
            require(abs(v - tau) <= 1e-6 * abs(tau),
                    f"{q}: group {k} flips HAVING at {v} (threshold {tau})")
    log(f"[engine]   result within rtol 1e-6 of full-table execution "
        f"({len(set(a) ^ set(b))} HAVING flips at the threshold)")
    return "within 1e-6"


# The kernels each engine path launches (phase 3: ``run``; phase 4: ``run_batch``
# and repairs, whose captures are all batched and whose repairs are maintained).
RUN_KERNELS = ("segment_aggregate", "fragment_bitmap", "sketch_filter")
BATCH_KERNELS = ("segment_aggregate", "sketch_filter", "fragment_bitmap_batch")


def phase_engine(n_rows: int, n_unique: int, replays: int, seed: int):
    """Returns the launches of ``run``'s path, the database, the workload and
    each query's full-table result values (phase 4 takes its thresholds from
    them)."""
    import numpy as np
    import torch

    from repro_torch.core import Database, PBDSEngine, default_catalog, execute
    from repro_torch.core.datasets import make_crimes
    from repro_torch.core.strategies import select_attribute
    from repro_torch.core.workload import CRIMES_SPEC, generate_workload
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.prng import PRNGKey
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t0 = time.perf_counter()
    crimes = make_crimes(n_rows, seed=seed, device="cuda")
    db = Database({"crimes": crimes})
    torch.cuda.synchronize()
    mb = sum(v.numel() * v.element_size() for v in crimes.columns.values()) / 1e6
    log(f"[engine] crimes: {crimes.num_rows} rows x {len(crimes.schema)} columns "
        f"({mb:.1f} MB on {crimes.device}), made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    workload = generate_workload(CRIMES_SPEC, db, n_unique, seed=seed)
    log(f"[engine] workload: {len(workload)} unique queries x {replays} replays, "
        f"generated in {time.perf_counter() - t0:.2f} s")
    require(len(workload) == n_unique, "workload generator returned too few queries")

    # Selection's incidence pass runs on the host (the reference runs it on
    # the device): time each call inside t_select.
    from repro_torch.aqp import size_estimation

    incidence = []  # (candidates, pairs, ranges, ms) of each call
    incidence_pass = size_estimation._incidence_pass

    def timed_incidence_pass(frag, valid, p_pair, sizes):
        t0 = time.perf_counter()
        out = incidence_pass(frag, valid, p_pair, sizes)
        incidence.append((*frag.shape, sizes.shape[1], (time.perf_counter() - t0) * 1e3))
        return out

    size_estimation._incidence_pass = timed_incidence_pass

    eng = PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=100, theta=0.05, seed=seed)
    stream = [q for _ in range(replays) for q in workload]
    for name in (*BUILT, ROWS_COUNTER):  # every count, so a stray launch of another kernel shows
        LAUNCH_COUNTS[name] = 0
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    results = []
    for i, q in enumerate(stream):
        t0 = time.perf_counter()
        res, info = eng.run(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append((q, res, info))
        log(f"[engine] q{i:02d} gb={'/'.join(q.groupby)} agg={q.agg.fn} "
            f"{'hit ' if info.reused else 'miss'} created={info.created} attr={info.attr} "
            f"sel={info.selectivity} probe={info.t_probe * 1e3:.2f}ms "
            f"select={info.t_select * 1e3:.1f}ms capture={info.t_capture * 1e3:.1f}ms "
            f"execute={info.t_execute * 1e3:.1f}ms wall={wall * 1e3:.1f}ms "
            f"groups_out={len(res.values)}")
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    require(launches["fragment_bitmap_batch"] == 0, "run launched the batched bitmap")
    require_compacted("engine", launches["sketch_filter"], LAUNCH_COUNTS[ROWS_COUNTER])
    launches = {name: launches[name] for name in RUN_KERNELS}
    t_run = time.perf_counter() - t_run
    created = sum(info.created for _, _, info in results)
    log(f"[engine] {len(stream)} queries in {t_run:.2f} s: index hits {eng.index.hits}, "
        f"misses {eng.index.misses}, sketches created {created}; launches {launches}")

    def log_incidence(what: str) -> None:
        log(f"[engine] host _incidence_pass, {what}: {len(incidence)} calls, (candidates, "
            f"pairs, ranges, ms) {[(c, p, r, round(ms, 3)) for c, p, r, ms in incidence]}")

    log_incidence("main path")
    # The stats prefilter may leave one candidate and skip the estimate; a
    # paper-faithful selection (no prefilter) of the first query ranks all
    # its candidates through the pass.
    incidence.clear()
    t0 = time.perf_counter()
    pick = select_attribute("CB-OPT-GB", PRNGKey(seed), workload[0], db, 100,
                            catalog=eng.catalog)
    log_incidence(f"paper-faithful selection of q00 ({len(pick.candidates)} candidates, "
                  f"picked {pick.attr}, {(time.perf_counter() - t0) * 1e3:.1f} ms in all)")
    size_estimation._incidence_pass = incidence_pass
    require(created >= 1, "no sketch was created")
    require(eng.index.hits >= 1, "no index hit occurred")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # Safety contract: every result equals execution over the full table
    # (through the process-wide catalog, not the engine's).
    check_catalog = default_catalog()
    records = to_host(crimes["records"]).astype(np.float64)
    outcomes = {}
    full_values = {}
    for q, res, _ in results:
        full = execute(q, db, catalog=check_catalog)
        full_values[q.signature()] = full.values
        enc = check_catalog.groups(crimes, q.groupby)
        vals = records if q.agg.fn != "count" else np.ones_like(records)
        left = float(np.bincount(enc.gid, weights=vals, minlength=enc.n_groups).max()) >= ENVELOPE
        outcome = check_result(q, res, full, left)
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
    log(f"[engine] results vs full-table execution: {outcomes}")

    # Where a miss's time goes: the host dictionary encode of its group-by
    # (np.unique over the rows) against the device aggregation it feeds.
    from repro_torch.core.queries import segment_sums_counts
    from repro_torch.core.table import encode_groups

    q = max(workload, key=lambda q: len(q.groupby))
    t0 = time.perf_counter()
    gid, n_groups, _ = encode_groups(crimes, q.groupby)
    t_encode = time.perf_counter() - t0
    gid_dev = torch.from_numpy(gid).to(crimes.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segment_sums_counts(crimes["records"], gid_dev, n_groups)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    log(f"[engine] one miss, group-by {'/'.join(q.groupby)} ({n_groups} groups): host "
        f"encode_groups {t_encode * 1e3:.1f} ms, device segment_sums_counts "
        f"{t_agg * 1e3:.2f} ms; engine catalog {dict(eng.catalog.stats)}")
    return launches, db, workload, full_values


# ---------------------------------------------------------------------------
# Phase 4: run_batch and maintenance at real scale
# ---------------------------------------------------------------------------


def mask_branch_split(label: str, table, ranges, bits_np, catalog, whole, reps: int = 5):
    """The mask branch of an instance build on the card, step by step: the
    kernel (mask and kept rows, its count copied back), the copy of the k
    rows to the host, the gather of the instance's columns; and ``whole()``,
    the branch as the engine runs it.  Logs the medians of ``reps`` (ms)."""
    import torch

    from repro_torch.device import to_host
    from repro_torch.kernels import ops

    bits = torch.from_numpy(bits_np).to(table.device)
    bucket = catalog.bucketize(table, ranges)

    def step(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    times = []
    for _ in range(reps + 1):  # the first warms
        (_, rows), t_kernel = step(lambda: ops.sketch_filter_rows(bucket, bits))
        _, t_copy = step(lambda: to_host(rows))
        _, t_gather = step(lambda: table.gather(rows))
        _, t_whole = step(whole)
        times.append((t_kernel, t_copy, t_gather, t_whole))
    med = [sorted(col)[reps // 2] for col in zip(*times[1:])]
    log(f"[{label}] mask branch of an instance build on {ranges.attr}, {int(rows.numel())} of "
        f"{table.num_rows} rows kept: kernel {med[0]:.3f} ms, rows to host {med[1]:.3f} ms, "
        f"gather of {len(table.schema)} columns {med[2]:.3f} ms; the branch whole "
        f"{med[3]:.3f} ms (medians of {reps})")


def _bursts(workload, full_values, n_groups: int = 2, per_group: int = 6):
    """One burst of queries in ``n_groups`` signature groups: for each group
    (fewest group-by attributes first) whose full-table result has enough
    distinct values, up to ``per_group`` thresholds at quantiles of those
    values, highest first, so that no member subsumes a later one and the
    burst is one admission wave."""
    import dataclasses

    import numpy as np

    from repro_torch.core import Having

    seen, groups = set(), []
    for q in sorted(workload, key=lambda q: len(q.groupby)):
        if q.inner_signature() in seen:
            continue
        seen.add(q.inner_signature())
        vals = np.asarray(full_values[q.signature()], dtype=np.float64)
        if vals.size == 0:
            continue
        taus = np.unique(np.quantile(vals, np.linspace(0.9, 0.2, per_group)))
        if taus.size < 4:
            continue
        groups.append([dataclasses.replace(q, having=Having(q.having.op, float(t)))
                       for t in taus[::-1]])
        if len(groups) == n_groups:
            break
    require(len(groups) == n_groups,
            f"the workload has {len(groups)} signature groups with 4 distinct thresholds")
    return [q for g in groups for q in g]


def _check_version(label, version, db, queries, outputs, entries, catalog, envelope_cache):
    """Every result of a burst equals full-table execution of the table
    ``version`` it ran on (``db`` holds the same rows), and every sketch in
    the index then, current for ``version``, equals a fresh capture over
    ``db`` (its maintainer's bits too)."""
    import numpy as np

    from repro_torch.core import capture_sketch, execute
    from repro_torch.device import to_host

    crimes = db["crimes"]
    outcomes = {}
    for q, (res, _) in zip(queries, outputs):
        full = execute(q, db, catalog=catalog)
        key = (id(crimes), q.groupby, q.agg.fn)
        if key not in envelope_cache:
            enc = catalog.groups(crimes, q.groupby)
            vals = to_host(crimes["records"]).astype(np.float64)
            if q.agg.fn == "count":
                vals = np.ones_like(vals)
            envelope_cache[key] = float(np.bincount(
                enc.gid, weights=vals, minlength=enc.n_groups).max()) >= ENVELOPE
        outcome = check_result(q, res, full, envelope_cache[key])
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
    for q, sketch, maintained_bits in entries:
        require(sketch.current_for(version), f"{label}: a sketch is not current for its version")
        fresh = capture_sketch(q, db, sketch.ranges, catalog=catalog)
        require(np.array_equal(fresh.bits, sketch.bits) and fresh.size_rows == sketch.size_rows,
                f"{label}: the maintained sketch of {q} differs from a fresh capture")
        require(maintained_bits is None or np.array_equal(maintained_bits, sketch.bits),
                f"{label}: maintainer bits differ from the sketch of {q}")
    log(f"[batch] {label}: {len(queries)} results vs full-table execution {outcomes}; "
        f"{len(entries)} sketches equal a fresh capture")


def phase_batch(n_rows: int, seed: int, db=None, workload=None, full_values=None) -> dict:
    """``run_batch`` and maintenance over the crimes table, with a fresh
    engine: burst, replay, append 1%, burst (repairs), delete one year,
    burst (repairs).  Without phase 3's table, workload and full-table
    results it makes its own."""
    import numpy as np
    import torch

    from repro_torch.core import (
        Catalog, ColumnTable, Database, PBDSEngine, default_catalog, execute)
    from repro_torch.core import admission
    from repro_torch.core.datasets import make_crimes
    from repro_torch.core.workload import CRIMES_SPEC, generate_workload
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    if db is None:
        db = Database({"crimes": make_crimes(n_rows, seed=seed, device="cuda")})
    if workload is None:
        workload = generate_workload(CRIMES_SPEC, db, UNIQUE, seed=seed)
    if full_values is None:
        full_values = {q.signature(): execute(q, db, catalog=default_catalog()).values
                       for q in workload}
    burst = _bursts(workload, full_values)
    n_sigs = len({q.inner_signature() for q in burst})
    log(f"[batch] burst of {len(burst)} queries in {n_sigs} signature groups: "
        + "; ".join(f"gb={'/'.join(q.groupby)} {q.agg.fn} > {q.having.value:g}" for q in burst))

    waves = []  # (misses, launches by kernel) of each admission wave
    admit = admission.admit_misses

    def counted_admit(engine, misses):
        before = {k: LAUNCH_COUNTS[k] for k in BUILT}
        out = admit(engine, misses)
        waves.append((len(misses), {k: LAUNCH_COUNTS[k] - before[k] for k in BUILT
                                    if LAUNCH_COUNTS[k] != before[k]}))
        return out

    eng = PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=100, theta=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    steps = []  # (label, db of the version, outputs, index snapshot)
    stats = {}

    def run_burst(label):
        first = len(waves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run_batch(burst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, (q, (res, info)) in enumerate(zip(burst, out)):
            log(f"[batch] {label} q{i:02d} gb={'/'.join(q.groupby)} >{q.having.value:g} "
                f"{'hit ' if info.reused else 'miss'} created={info.created} "
                f"repaired={info.repaired} attr={info.attr} sel={info.selectivity} "
                f"probe={info.t_probe * 1e3:.2f}ms select={info.t_select * 1e3:.1f}ms "
                f"capture={info.t_capture * 1e3:.1f}ms repair={info.t_repair * 1e3:.1f}ms "
                f"execute={info.t_execute * 1e3:.1f}ms total={info.t_total * 1e3:.1f}ms "
                f"groups_out={len(res.values)}")
        log(f"[batch] {label}: {len(burst)} queries in {wall * 1e3:.1f} ms wall, "
            f"{len(waves) - first} admission waves (misses, launches) {waves[first:]}")
        snapshot = [(e.query, e.sketch, None if e.maintainer is None else e.maintainer.bits())
                    for e in eng.index.entries()]
        steps.append((label, eng.db, out, snapshot))
        stats[label] = dict(eng.catalog.stats)
        return out

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[batch] {what}: {ms:.1f} ms wall; crimes now {eng.db['crimes'].num_rows} rows, "
            f"version {eng.db['crimes'].version}")
        return ms

    admission.admit_misses = counted_admit
    try:
        for name in (*BUILT, ROWS_COUNTER):
            LAUNCH_COUNTS[name] = 0
        out = run_burst("burst")
        created = sum(info.created for _, info in out)
        require(created == len(burst), f"the first burst created {created} of {len(burst)} sketches")
        out = run_burst("replay")
        require(all(info.reused and not info.repaired for _, info in out), "replay missed")

        crimes = eng.db["crimes"]
        m = int(round(APPEND_FRAC * crimes.num_rows))
        # Each column's values drawn from its own domain (rows of the table,
        # independently per column, so some group keys are new).
        rows = {a: to_host(crimes[a].index_select(0, torch.from_numpy(
                    rng.integers(0, crimes.num_rows, m)).to(crimes.device)))
                for a in crimes.schema}
        t_append = timed(f"append_rows of {m} rows", lambda: eng.append_rows("crimes", rows))
        out = run_burst("after append")
        require(all(info.reused and info.repaired for _, info in out),
                "the burst after the append did not repair every sketch")

        year = int(np.median(to_host(crimes["year"])))
        mask = to_host(eng.db["crimes"]["year"] == year)
        t_delete = timed(f"delete_rows of year {year} ({int(mask.sum())} rows)",
                         lambda: eng.delete_rows("crimes", mask))
        out = run_burst("after delete")
        require(all(info.reused and info.repaired for _, info in out),
                "the burst after the delete did not repair every sketch")
        launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
        rows_launches = LAUNCH_COUNTS[ROWS_COUNTER]
    finally:
        admission.admit_misses = admit
    t_run = time.perf_counter() - t_phase
    log(f"[batch] driven in {t_run:.1f} s; launches {launches}; append {t_append:.1f} ms, "
        f"delete {t_delete:.1f} ms; engine catalog {stats['after delete']}")

    for name in BATCH_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the run_batch path")
    require_compacted("batch", launches["sketch_filter"], rows_launches)
    require(launches["fragment_bitmap_batch"] < created,
            "fragment_bitmap_batch launched once per sketch, not once per partition")
    before, after_append, after_delete = stats["replay"], stats["after append"], stats["after delete"]
    for counter in ("encode_groups", "bucketize", "fragment_sizes"):
        require(before.get(counter, 0) == after_append.get(counter, 0)
                == after_delete.get(counter, 0),
                f"a mutation caused whole-table work: {counter} "
                f"{before.get(counter, 0)} -> {after_delete.get(counter, 0)}")
    for counter in ("encode_groups_delta", "bucketize_delta", "fragment_sizes_delta"):
        require(before.get(counter, 0) < after_append.get(counter, 0)
                < after_delete.get(counter, 0), f"no delta refresh counted in {counter}")
    require(after_delete.get("sketch_maintained", 0) == 2 * created
            and after_delete.get("sketch_recaptured", 0) == 0,
            f"repairs: {after_delete.get('sketch_maintained', 0)} maintained, "
            f"{after_delete.get('sketch_recaptured', 0)} re-captured of {2 * created}")

    # The mask branch's split, on the widest sketch's instance of the final version.
    from repro_torch.core import sketch as sketch_mod

    entry = max(eng.index.entries(), key=lambda e: e.sketch.size_rows)
    table = eng.db["crimes"]
    mask_branch_split("batch", table, entry.sketch.ranges, entry.sketch.bits, eng.catalog,
                      lambda: sketch_mod._build_instance(entry.sketch, table, eng.catalog))

    # Checks, after the counts were read: version 0 through phase 3's check
    # catalog, each mutated version as a fresh table with a fresh catalog.
    envelope_cache = {}
    check_dbs = {}
    for label, vdb, outputs, snapshot in steps:
        t = vdb["crimes"]
        if t.delta is None:
            cdb, cat = vdb, default_catalog()
        else:
            if id(t) not in check_dbs:
                root = ColumnTable(t.name, dict(t.columns), t.primary_key)
                check_dbs[id(t)] = (t, Database({"crimes": root}), Catalog())
            _, cdb, cat = check_dbs[id(t)]
        _check_version(label, t, cdb, burst, outputs, snapshot, cat, envelope_cache)
    log(f"[batch] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: fragment-sharded serving at real scale
# ---------------------------------------------------------------------------


def _shard_burst(workload, full_values, per_group: int = 4):
    """Two signature groups whose GROUP BY holds ``SHARD_ATTR`` (group-local:
    the shards maintain their bits) and one whose GROUP BY lacks it (the
    coordinator maintains its bits), each with ``per_group`` thresholds at
    high quantiles of its full-table values, highest first (selective
    sketches, so routed hits skip shards)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import Having

    seen, local, spanning = set(), [], []
    for q in sorted(workload, key=lambda q: len(q.groupby)):
        if q.inner_signature() in seen:
            continue
        seen.add(q.inner_signature())
        vals = np.asarray(full_values[q.signature()], dtype=np.float64)
        taus = np.unique(np.quantile(vals, np.linspace(0.95, 0.6, per_group))) if vals.size else []
        if len(taus) < per_group:
            continue
        group = [dataclasses.replace(q, having=Having(q.having.op, float(t))) for t in taus[::-1]]
        (local if SHARD_ATTR in q.groupby else spanning).append(group)
    require(len(local) >= 2 and len(spanning) >= 1,
            f"the workload has {len(local)} {SHARD_ATTR} and {len(spanning)} other signature "
            f"groups with {per_group} distinct thresholds")
    return [q for g in local[:2] + spanning[:1] for q in g]


def _plain_groups(q, cols):
    """Every group of a Q-AGH query's inner block over the full table, by a
    plain numpy group-by (one 1-D ``np.unique`` over a mixed-radix key,
    float64 sums) independent of the engine's executor, catalog and kernels:
    ``(group values, float32 aggregate, whether a sum leaves the float32
    integer envelope)``."""
    import numpy as np

    key = np.zeros(cols[q.groupby[0]].shape[0], dtype=np.int64)
    lows, sizes = [], []
    for a in q.groupby:
        v = cols[a].astype(np.int64)
        lows.append(int(v.min()))
        sizes.append(int(v.max()) - lows[-1] + 1)
        key = key * sizes[-1] + (v - lows[-1])
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    sums = counts if q.agg.fn == "count" else np.bincount(
        inv, weights=cols[q.agg.attr].astype(np.float64), minlength=uniq.shape[0])
    agg = sums.astype(np.float32)
    if q.agg.fn == "avg":
        agg = agg / np.maximum(counts.astype(np.float32), np.float32(1.0))
    group_values, rest = {}, uniq
    for a, lo, size in reversed(list(zip(q.groupby, lows, sizes))):
        group_values[a] = (rest % size + lo).astype(cols[a].dtype)
        rest = rest // size
    return group_values, agg, bool(sums.size) and float(np.abs(sums).max()) >= ENVELOPE


def _rethreshold(burst, cols, levels=(0.97, 0.93, 0.89, 0.85)):
    """The burst's signature groups with thresholds at ``levels`` quantiles
    of the current table's group aggregates (``_plain_groups``), highest
    first: a burst whose answers are not empty after a delete that drops
    every group below the old thresholds."""
    import dataclasses

    import numpy as np

    from repro_torch.core import Having

    out, seen = [], set()
    for q in burst:
        if q.inner_signature() in seen:
            continue
        seen.add(q.inner_signature())
        agg = _plain_groups(q, cols)[1]
        taus = np.unique(np.quantile(agg.astype(np.float64), levels))[::-1]
        out += [dataclasses.replace(q, having=Having(q.having.op, float(t))) for t in taus]
    return out


def _plain_result(q, groups):
    """``q``'s result from ``_plain_groups``: its HAVING over the groups."""
    import numpy as np

    from repro_torch.core import QueryResult

    group_values, agg, _ = groups
    keep = np.asarray(q.having.mask(agg))
    return QueryResult(group_values={a: v[keep] for a, v in group_values.items()},
                       values=agg[keep])


SHARD_KERNELS = ("segment_aggregate_batch", "sketch_filter")


def phase_shard(n_rows: int, seed: int, db=None, workload=None, full_values=None):
    """``ShardedEngine`` over ``N_SHARDS`` fragment shards on the
    ``SHARD_ATTR`` partition: burst (misses), replay (one fused launch),
    replay through the host loop, replay fused again, append 1% and burst,
    delete one year and burst.  Without phase 3's table, workload and full-table results it
    makes its own.  Returns the launches, the engine and its last burst
    (phase 9 drives its faults on them), and what phase 10 repeats over
    subprocess shards: the first burst, each step's results and wall, the
    build's wall, the appended rows and the deleted year."""
    import numpy as np
    import torch

    from repro_torch.core import Database, ShardedEngine, default_catalog, execute
    from repro_torch.core.datasets import make_crimes
    from repro_torch.core.workload import CRIMES_SPEC, generate_workload
    from repro_torch.device import to_host
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    check_db = db
    if db is None:
        db = Database({"crimes": make_crimes(n_rows, seed=seed, device="cuda")})
    if workload is None:
        workload = generate_workload(CRIMES_SPEC, db, UNIQUE, seed=seed)
    if full_values is None:
        full_values = {q.signature(): execute(q, db, catalog=default_catalog()).values
                       for q in workload}
    burst = _shard_burst(workload, full_values)
    log(f"[shard] burst of {len(burst)} queries: "
        + "; ".join(f"gb={'/'.join(q.groupby)} {q.agg.fn} > {q.having.value:g}" for q in burst))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se = ShardedEngine(db, "crimes", SHARD_ATTR, n_shards=N_SHARDS, n_ranges=100,
                       strategy="CB-OPT-GB", theta=0.05, seed=seed)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"[shard] ShardedEngine built in {t_build:.2f} s: "
        f"{se.ranges.n_ranges} fragments on {SHARD_ATTR}, shard rows "
        f"{[int(s.table.num_rows) for s in se.shards]}, fragments per shard "
        f"{[int(se.plan.fragments_of(s).size) for s in range(N_SHARDS)]}")

    steps = []  # (label, table version, its needed columns on the host, queries, outputs)
    walls = {}
    needed = {a for q in burst for a in q.groupby} | {q.agg.attr for q in burst if q.agg.attr}
    launch_log = {}

    def host_cols():
        crimes = se.db["crimes"]
        if steps and steps[-1][1] is crimes:
            return steps[-1][2]
        return {a: to_host(crimes[a]) for a in needed}

    def run_burst(label, expect_hits, expect_repaired=False, queries=burst):
        before = {k: LAUNCH_COUNTS[k] for k in (*BUILT, "fused_partials")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = se.run_batch(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCH_COUNTS[k] - v for k, v in before.items() if LAUNCH_COUNTS[k] != v}
        launch_log[label] = launches
        # A burst with no hit leaves an earlier burst's route behind.
        route = se.last_route if any(info.reused for _, info in out) else None
        for i, (q, (res, info)) in enumerate(zip(queries, out)):
            log(f"[shard] {label} q{i:02d} gb={'/'.join(q.groupby)} >{q.having.value:g} "
                f"{'hit ' if info.reused else 'miss'} created={info.created} "
                f"repaired={info.repaired} attr={info.attr} sel={info.selectivity} "
                f"shards contacted={info.shards_contacted} skipped={info.shards_skipped} "
                f"execute={info.t_execute * 1e3:.2f}ms total={info.t_total * 1e3:.1f}ms "
                f"groups_out={len(res.values)}")
        n_degraded = sum(bool(info.degraded) for _, info in out)
        n_empty = sum(len(res.values) == 0 for res, _ in out)
        log(f"[shard] {label}: {len(queries)} queries in {wall * 1e3:.1f} ms wall; launches "
            f"{launches}; route fused={route.fused if route else None} "
            f"launch={route.t_launch_s * 1e3 if route else 0:.3f}ms "
            f"merge={route.t_merge_s * 1e3 if route else 0:.3f}ms "
            f"degraded={route.degraded if route else None}; results degraded {n_degraded}, "
            f"empty {n_empty} of {len(queries)}; shard health {se.health}; stacked cache "
            f"{se.stacked_bytes() / 1e6:.1f} MB")
        require(n_degraded == 0 and not (route and route.degraded),
                f"{label}: {n_degraded} results were served degraded (a shard missed its "
                f"deadline; health {se.health})")
        if expect_hits:
            require(all(info.reused for _, info in out), f"{label}: a query missed")
            require(all(info.repaired == expect_repaired for _, info in out),
                    f"{label}: repaired is not {expect_repaired} everywhere")
        steps.append((label, se.db["crimes"], host_cols(), queries, out))
        walls[label] = wall
        return out, wall

    for name in (*BUILT, "fused_partials", ROWS_COUNTER):
        LAUNCH_COUNTS[name] = 0
    out, t_burst = run_burst("burst", expect_hits=False)
    created = sum(info.created for _, info in out)
    require(created == len(burst), f"the burst created {created} of {len(burst)} sketches")
    n_local = sum(reg.group_local for reg in se._registered.values())
    log(f"[shard] {len(se._registered)} registered entries, {n_local} group-local; shard "
        f"maintainers {[len(s.maintainers) for s in se.shards]}")
    require(0 < n_local < len(se._registered), "the burst needs both kinds of entries")

    fused_out, t_replay = run_burst("replay", expect_hits=True)
    require(launch_log["replay"].get("fused_partials") == 1
            and launch_log["replay"].get("segment_aggregate_batch") == 1,
            f"the replay took {launch_log['replay']} launches, not one fused launch")
    skipped = [info.shards_skipped for _, info in fused_out]
    require(sum(skipped) > 0, "no routed hit skipped a shard")

    se.fused = False
    loop_out, _ = run_burst("replay, host loop", expect_hits=True)
    se.fused = True
    for i, ((rf, _), (rl, _)) in enumerate(zip(fused_out, loop_out)):
        same = (np.array_equal(rf.values, rl.values)
                and sorted(rf.group_values) == sorted(rl.group_values)
                and all(np.array_equal(rf.group_values[a], rl.group_values[a])
                        for a in rf.group_values))
        require(same, f"q{i:02d}: the fused and host-loop results differ")
    log(f"[shard] fused and host-loop results equal bit for bit ({len(burst)} queries)")
    run_burst("replay, fused again", expect_hits=True)  # stacks cached: the steady state

    rng = np.random.default_rng(seed)
    crimes = se.db["crimes"]
    m = int(round(APPEND_FRAC * crimes.num_rows))
    rows = {a: to_host(crimes[a].index_select(0, torch.from_numpy(
                rng.integers(0, crimes.num_rows, m)).to(crimes.device)))
            for a in crimes.schema}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se.append_rows("crimes", rows)
    t_append = (time.perf_counter() - t0) * 1e3
    log(f"[shard] append_rows of {m} rows: {t_append:.1f} ms wall (shipped, not applied); "
        f"watermark {se.min_watermark()} of {se.version}")
    run_burst("after append", expect_hits=True, expect_repaired=True)
    year = int(np.median(to_host(crimes["year"])))
    mask = to_host(se.db["crimes"]["year"] == year)
    t0 = time.perf_counter()
    se.delete_rows("crimes", mask)
    t_delete = (time.perf_counter() - t0) * 1e3
    log(f"[shard] delete_rows of year {year} ({int(mask.sum())} rows): {t_delete:.1f} ms wall")
    run_burst("after delete", expect_hits=True, expect_repaired=True)
    # The delete drops most groups below the burst's thresholds, so the
    # post-delete version is also read with thresholds taken anew from it:
    # captures on the shrunk table, then a fused replay of them.
    fresh = _rethreshold(burst, host_cols())
    log(f"[shard] new thresholds: "
        + "; ".join(f"gb={'/'.join(q.groupby)} > {q.having.value:g}" for q in fresh))
    run_burst("after delete, new thresholds", expect_hits=False, queries=fresh)
    out, _ = run_burst("after delete, new thresholds, replay", expect_hits=True, queries=fresh)
    require(launch_log["after delete, new thresholds, replay"].get("fused_partials") == 1,
            "the replay after the delete took more than one fused launch")
    n_full = sum(len(res.values) > 0 for res, _ in out)
    require(2 * n_full >= len(fresh),
            f"only {n_full} of {len(fresh)} results after the delete hold a group")
    launches = {name: LAUNCH_COUNTS[name] for name in (*BUILT, "fused_partials")}
    require_compacted("shard", launches["sketch_filter"], LAUNCH_COUNTS[ROWS_COUNTER])
    t_run = time.perf_counter() - t_phase
    require(se.min_watermark() == se.version, "a shard lags the watermark after a read")
    log(f"[shard] driven in {t_run:.1f} s; launches {launches}; stacked cache "
        f"{se.stacked_bytes() / 1e6:.1f} MB in {len(se.engine.catalog._stacked)} entries; "
        f"coordinator catalog {dict(se.engine.catalog.stats)}")
    for name in SHARD_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the sharded path")
    t_route_ms = se.last_route.t_launch_s * 1e3
    # The last burst's one launch, again on its own inputs (after the counts
    # were read): its time on the card and the kernel against its plain
    # version at the main path's shape.
    bkey = ("stacked_batch",) + tuple(dict.fromkeys(
        se.engine.index.lookup_entry(q).reg_id for q in fresh))
    require(bkey in se.engine.catalog._stacked, "the last burst's assembled batch is not cached")
    vals, gid, w, g_pad = se.engine.catalog._stacked[bkey][1]
    k, s_pad, r_pad = vals.shape
    flat = [t.reshape(k, s_pad * r_pad) for t in (vals, gid, w)]
    got = ops.segment_aggregate_batch(*flat[:2], g_pad, flat[2])
    want = ref.segment_aggregate_batch_ref(*flat[:2], g_pad, flat[2])
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "the fused launch's kernel disagrees with its plain version")
    kernel_ms = time_ms(lambda: ops.segment_aggregate_batch(*flat[:2], g_pad, flat[2]))
    nnz_w = int((flat[2] != 0).sum())
    b_ms, b_by = bound(k * s_pad * r_pad * 8 + nnz_w * 4 + k * g_pad * 8, 3 * nnz_w)
    # index_add_ over gid + b * g_pad: the library yardstick, its index and
    # products made before the timed region.
    index = (flat[1].long() + g_pad * torch.arange(k, device=flat[1].device)[:, None]).reshape(-1)
    vw2 = torch.stack([(flat[0] * flat[2]).reshape(-1), flat[2].reshape(-1)], dim=1)
    out2 = torch.zeros(k * g_pad, 2, dtype=torch.float32, device=vw2.device)
    library_ms = time_ms(lambda: out2.index_add_(0, index, vw2), reps=5, warmup=1)
    log(f"[shard] fused launch (K, S_pad, R_pad, g_pad) = {(k, s_pad, r_pad, g_pad)}, "
        f"{nnz_w} weighted rows of {k * s_pad * r_pad}: bit-exact against the plain "
        f"version; kernel {kernel_ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms ({b_by}), "
        f"index_add_ {library_ms:.4f} ms, the route's launch + copy to host "
        f"{t_route_ms:.3f} ms (SM clock, power: {card_state()})")
    del got, want, flat, index, vw2, out2

    # The mask branch's split on the largest shard, for a sketch not on the
    # serving partition (its instance is the kernel's kept rows).
    shard = max(se.shards, key=lambda sh: sh.table.num_rows)
    key, reg = max(((k, r) for k, r in se._registered.items()
                    if r.ranges.key() != se.ranges.key() and se.engine.index.contains(r.entry)),
                   key=lambda kr: kr[1].entry.sketch.size_rows)
    bits_np = reg.entry.sketch.bits

    def rebuild():
        shard._inst.pop(key, None)
        return shard._instance(key, reg.ranges, bits_np)

    mask_branch_split("shard", shard.table, reg.ranges, bits_np, shard.catalog, rebuild)

    # Checks, after the counts were read: every result against a plain
    # group-by of its version's full table (and version 0 also against the
    # executor over phase 3's table, whose encodings its catalog holds).
    outcomes = {}
    for label, crimes, cols, queries, outputs in steps:
        cache = {}
        for q, (res, _) in zip(queries, outputs):
            sig = q.inner_signature()
            if sig not in cache:
                cache[sig] = _plain_groups(q, cols)
            outcome = check_result(q, res, _plain_result(q, cache[sig]), cache[sig][2])
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            if check_db is not None and label == "burst":
                require(res.canonical() == execute(q, check_db, catalog=default_catalog())
                        .canonical(), f"{q}: differs from the executor over the full table")
    log(f"[shard] {sum(outcomes.values())} results vs full-table group-by {outcomes}")
    log(f"[shard] phase done in {time.perf_counter() - t_phase:.1f} s")
    record = dict(burst=burst, build_s=t_build, walls=walls, rows=rows, year=year,
                  outputs={label: [res for res, _ in out]
                           for label, _, _, queries, out in steps if queries is burst})
    return launches, se, fresh, record


# ---------------------------------------------------------------------------
# Phase 9: shard faults on phase 5's engine
# ---------------------------------------------------------------------------

FAULT_KERNELS = ("segment_aggregate", "segment_aggregate_batch")
FAULT_STALL_S, FAULT_DEADLINE_S = 1.0, 0.5  # step 7: a stall past a lowered deadline


def phase_faults(se, burst, seed: int) -> dict:
    """Shard faults on phase 5's ``ShardedEngine``, table and last burst:
    the burst replayed fused; a kill of the shard owning the most set bits
    of the burst's sketches (served coordinator-side inside the one fused
    launch); a 1% append while it is dead; heal (recovery by checkpoint
    adopt, delta replay and re-registration, timed by part); a partition
    across a one-year delete, healed (the lost ships re-shipped from the
    log); a flaky shard (two dropped ops retried away); a stall past a
    lowered op deadline; and a kill with ``rebalance``, replayed fused,
    through the host loop and fused again.  Every result is checked against
    a plain group-by of its version's full table, and no step may
    re-capture (``index.misses`` stays flat)."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core import execute_and_provenance
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    needed = {a for q in burst for a in q.groupby} | {q.agg.attr for q in burst if q.agg.attr}
    cols_cache = {}
    outcomes: dict = {}

    def host_cols():
        crimes = se.db["crimes"]
        if cols_cache.get("table") is not crimes:
            cols_cache.clear()
            cols_cache["table"] = crimes
            cols_cache["cols"] = {a: to_host(crimes[a]) for a in needed}
        return cols_cache["cols"]

    def check(label, out):
        cols, cache = host_cols(), {}
        for q, (res, _) in zip(burst, out):
            sig = q.inner_signature()
            if sig not in cache:
                cache[sig] = _plain_groups(q, cols)
            outcome = check_result(q, res, _plain_result(q, cache[sig]), cache[sig][2])
            outcomes[outcome] = outcomes.get(outcome, 0) + 1

    def replay(label, *, degraded, one_launch=True, repaired=None):
        before = {k: LAUNCH_COUNTS[k] for k in (*BUILT, "fused_partials")}
        misses = se.index.misses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = se.run_batch(burst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCH_COUNTS[k] - v for k, v in before.items() if LAUNCH_COUNTS[k] != v}
        route = se.last_route
        n_empty = sum(len(res.values) == 0 for res, _ in out)
        log(f"[faults] {label}: {len(burst)} queries in {wall * 1e3:.1f} ms wall; launches "
            f"{launches}; route fused={route.fused} degraded={route.degraded} "
            f"failed_shards={route.failed_shards} retries={route.n_retries} "
            f"deltas_applied={route.deltas_applied} launch={route.t_launch_s * 1e3:.3f}ms "
            f"merge={route.t_merge_s * 1e3:.3f}ms; health {se.health}; shard versions "
            f"{[s.version for s in se.shards]} of {se.version}; empty {n_empty}")
        require(all(info.reused for _, info in out), f"{label}: a query missed")
        require(se.index.misses == misses, f"{label}: the index missed (a re-capture)")
        require(route.degraded == degraded and all(info.degraded == degraded for _, info in out),
                f"{label}: degraded is not {degraded} (route {route.failed_shards}, "
                f"health {se.health})")
        if repaired is not None:
            require(all(info.repaired == repaired for _, info in out),
                    f"{label}: repaired is not {repaired} everywhere")
        if one_launch:
            require(launches.get("fused_partials") == 1
                    and launches.get("segment_aggregate_batch") == 1,
                    f"{label}: {launches} launches, not one fused launch")
        check(label, out)
        return out, route, wall

    for name in (*BUILT, "fused_partials", ROWS_COUNTER):
        LAUNCH_COUNTS[name] = 0
    misses0 = se.index.misses
    replay("replay", degraded=False)

    # 2. Kill the shard owning the most set bits of the burst's sketches.
    entries = {e.reg_id: e for e in map(se.index.lookup_entry, burst)
               if e.sketch.ranges.key() == se.ranges.key()}.values()  # on the serving partition
    require(bool(entries), "no sketch of the burst is on the serving partition")
    owned_bits = [sum(int(e.sketch.bits[se.plan.fragments_of(s)].sum()) for e in entries)
                  for s in range(N_SHARDS)]
    victim = int(np.argmax(owned_bits))
    log(f"[faults] set bits of the burst's {len(entries)} sketches on {SHARD_ATTR} by shard "
        f"{owned_bits}: kill shard {victim}")
    se.shards[victim].inject("kill")
    _, route, _ = replay("killed", degraded=True)
    require(victim in route.failed_shards, f"the route names {route.failed_shards}, not {victim}")
    replay("killed, again", degraded=True)
    require(se.health[victim] == "dead", f"shard {victim} is {se.health[victim]}, not dead")

    # 3. A 1% append while the shard is dead: shipped to the others, logged for it.
    rng = np.random.default_rng(seed + 9)
    crimes = se.db["crimes"]
    m = int(round(APPEND_FRAC * crimes.num_rows))
    rows = {a: to_host(crimes[a].index_select(0, torch.from_numpy(
                rng.integers(0, crimes.num_rows, m)).to(crimes.device)))
            for a in crimes.schema}
    t0 = time.perf_counter()
    se.append_rows("crimes", rows)
    log(f"[faults] append_rows of {m} rows while shard {victim} is dead: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; its log holds {len(se._log[victim])} deltas")
    replay("after append, killed", degraded=True, repaired=True)

    # 4. Heal: checkpoint adopt, delta replay, re-registration, each timed
    # on the recovered shard.
    split = collections.defaultdict(float)

    def timed(obj, name, part):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            if obj is se and args[0] != victim:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[part] += time.perf_counter() - t0
        setattr(obj, name, wrapper)

    client = se.shards[victim]
    for obj, name, part in ((client, "restore_checkpoint", "adopt"),
                            (se, "_sync_shard", "replay"),
                            (se, "_reregister_shard", "re-register"),
                            (se, "_recover_shard", "recovery")):
        timed(obj, name, part)
    ckpt_version = se._ckpt[victim].version
    client.heal()
    try:
        _, route, wall = replay("healed", degraded=False, repaired=True)
    finally:
        for obj, name in ((client, "restore_checkpoint"), (se, "_sync_shard"),
                          (se, "_reregister_shard"), (se, "_recover_shard")):
            delattr(obj, name)
    log(f"[faults] recovery of shard {victim} from its checkpoint at version {ckpt_version} to "
        f"{se.version}: {split['recovery'] * 1e3:.1f} ms = adopt {split['adopt'] * 1e3:.1f} + "
        f"delta replay {split['replay'] * 1e3:.1f} + re-registration "
        f"{split['re-register'] * 1e3:.1f} + checkpoint, of the {wall * 1e3:.1f} ms read")
    require(se.health[victim] == "healthy", f"shard {victim} is {se.health[victim]} after heal")
    require(se.shards[victim].version == se.version, "the recovered shard lags the watermark")
    # The recovered maintainers against a fresh capture of the shard's rows:
    # the fragments (of the sketch's partition) holding provenance rows that
    # the shard owns, from the provenance of the full table.  Kernel
    # launches of the check are not the path's.
    counts_before = dict(LAUNCH_COUNTS)
    shard, ctable = se.shards[victim], se.db["crimes"]
    on_victim = se._row_shard == victim
    n_checked = 0
    for key, reg in se._registered.items():
        if not reg.group_local or not se.index.contains(reg.entry):
            continue
        require(shard.has_maintainer(key), f"shard {victim} lacks the maintainer of entry {key}")
        _, prov = execute_and_provenance(reg.entry.query, se.db, catalog=se.engine.catalog)
        bucket = to_host(se.engine.catalog.bucketize(ctable, reg.ranges))
        want = np.zeros(reg.ranges.n_ranges, dtype=bool)
        want[bucket[prov & on_victim]] = True
        require(np.array_equal(shard.bits_for(key), want),
                f"shard {victim}'s maintained bits of entry {key} differ from a fresh capture")
        n_checked += 1
    LAUNCH_COUNTS.clear()
    LAUNCH_COUNTS.update(counts_before)
    require(n_checked > 0, "no group-local entry to check on the recovered shard")
    log(f"[faults] shard {victim}'s {n_checked} maintainers equal fresh captures of its rows")

    # 5. A partition across a one-year delete; the lost ships come from the log.
    part = (victim + 1) % N_SHARDS
    years = to_host(se.db["crimes"]["year"])
    uniq, counts = np.unique(years, return_counts=True)
    year = int(uniq[np.argmin(counts)])
    se.shards[part].inject("partition")
    se.delete_rows("crimes", years == year)
    behind = se.shards[part].version
    log(f"[faults] delete of year {year} ({int(counts.min())} rows) while shard {part} is "
        f"partitioned: it holds version {behind} of {se.version}, health {se.health[part]}, "
        f"its log {len(se._log[part])} deltas")
    require(behind < se.version, "the partitioned shard received the delete")
    se.shards[part].heal()
    replay("partition healed", degraded=False, repaired=True)
    require(se.shards[part].version == se.version and se.shards[part].lag == 0,
            "the healed shard did not catch up from the log")

    # 6. A flaky shard: two dropped ops, retried away.
    se.shards[part].inject("flaky", 2)
    _, route, _ = replay("flaky", degraded=False)
    require(route.n_retries >= 2, f"{route.n_retries} retries for a flaky shard")

    # 7. A stall past a lowered deadline: served coordinator-side.
    stalled = (victim + 2) % N_SHARDS
    require(se._monitors[(stalled, "catch_up")].median() is not None,
            f"shard {stalled}'s catch_up has no timing baseline yet")
    deadline = se.op_deadline_s
    se.op_deadline_s = FAULT_DEADLINE_S
    se.shards[stalled].inject("stall", FAULT_STALL_S)
    try:
        _, route, _ = replay("stalled", degraded=True)
    finally:
        se.shards[stalled].heal()
        se.op_deadline_s = deadline
    require(stalled in route.failed_shards, f"the stalled shard {stalled} was not routed around")
    replay("stall healed", degraded=False)
    require(se.health == ["healthy"] * N_SHARDS, f"health {se.health} after the heals")

    # 8. Kill and rebalance: the survivors take the dead shard's fragments.
    se.shards[victim].inject("kill")
    t0 = time.perf_counter()
    rebuilt = se.rebalance([victim])
    torch.cuda.synchronize()
    log(f"[faults] rebalance away from shard {victim}: rebuilt {rebuilt} in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; fragments per shard "
        f"{[int(se.plan.fragments_of(s).size) for s in range(N_SHARDS)]}, shard rows "
        f"{[None if s.state_lost else int(s.table.num_rows) for s in se.shards]}")
    require(rebuilt and not (se.plan.owner == victim).any(), "rebalance left the dead shard owning")
    fused_out, _, _ = replay("rebalanced", degraded=False)
    se.fused = False
    loop_out, _, _ = replay("rebalanced, host loop", degraded=False, one_launch=False)
    se.fused = True
    for i, ((rf, _), (rl, _)) in enumerate(zip(fused_out, loop_out)):
        require(_same_result(rf, rl), f"q{i:02d}: the fused and host-loop results differ "
                                      f"after the rebalance")
    replay("rebalanced, fused again", degraded=False)
    require(se.index.misses == misses0, "the faults re-captured a sketch")

    launches = {name: LAUNCH_COUNTS[name] for name in (*BUILT, "fused_partials")}
    require_compacted("faults", launches["sketch_filter"], LAUNCH_COUNTS[ROWS_COUNTER])
    for name in FAULT_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the fault path")
    log(f"[faults] launches {launches}; {sum(outcomes.values())} results vs full-table "
        f"group-by {outcomes}")
    log(f"[faults] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: process-boundary shards and standby failover
# ---------------------------------------------------------------------------

# Kernels the coordinator launches in phase 10 (captures of the burst's
# misses in one wave, the fused waves) and each shard server (instances;
# partials on the host loop).
RPC_KERNELS = ("segment_aggregate", "fragment_bitmap_batch", "segment_aggregate_batch")
RPC_SERVER_KERNELS = ("sketch_filter", "segment_aggregate")
RPC_SETTLE_S = 30.0  # how long the card may take to drop a killed server's context


def compute_apps() -> list:
    """``nvidia-smi``'s compute processes on the card: ``[(pid, used memory)]``
    (empty when it lists none)."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi --query-compute-apps failed: {smi.stderr}")
    return [tuple(part.strip() for part in line.split(",", 1))
            for line in smi.stdout.strip().splitlines() if line.strip()]


def _pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def phase_rpc(db, record: dict, seed: int) -> dict:
    """Phase 5's configuration again, its shards now server processes: a
    ``FailoverCoordinator`` around ``ShardedEngine(..., transport=
    "subprocess")`` over ``N_SHARDS`` shard servers on the card, with a
    standby process (``SubprocessReplica``).  On phase 3's table and phase
    5's first burst (``record``, from ``phase_shard``): the burst through
    ``run_batch``, a fused replay (stacks built over RPC), a steady one and
    one through the host loop; phase 5's 1% append and one-year delete, each
    with a replay; a socket drop, two flaky responses and a stall past a
    lowered RPC deadline, each across a replay; a SIGKILL of the server
    owning the most sketch bits and a degraded replay; its heal (recovery
    from the peer's mirror, timed by part); ``coord_kill`` (the takeover
    timed by part, against this phase's own build and burst) and
    ``coord_partition`` (standby takeovers); and shutdown.  Every result must equal phase 5's loopback result of the same
    version bit for bit and a plain group-by of the full table; no replay
    may re-capture; peer mirrors advance without a stale checkpoint; the
    recovered maintainers must equal fresh captures; the zombie coordinator
    is fenced; the promoted one is on the card and launches the fused
    kernel; each server runs on the card and launches the instance kernel;
    no server or standby outlives the phase.  Returns the launches of the
    coordinator and of every server."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core import (
        FailoverCoordinator,
        ShardedEngine,
        StaleEpochError,
        SubprocessReplica,
        execute_and_provenance,
    )
    from repro_torch.core import shard_rpc
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    on_card = db["crimes"].device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    burst = record["burst"]
    needed = {a for q in burst for a in q.groupby} | {q.agg.attr for q in burst if q.agg.attr}
    cols_cache: dict = {}
    outcomes: dict = {}
    apps_before = compute_apps() if on_card else []
    log(f"[rpc] compute apps on the card before the phase: {apps_before}")

    pool = shard_rpc.POOL
    t0 = time.perf_counter()
    pool.prewarm(N_SHARDS)
    for sp in list(pool._spares):
        sp.connect()
        require(sp.request({"op": "ping", "args": (), "ctl": True}, deadline_s=60.0)["ok"],
                "a shard server did not answer")
    t_spawn = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    se = ShardedEngine(db, "crimes", SHARD_ATTR, n_shards=N_SHARDS, n_ranges=100,
                       strategy="CB-OPT-GB", theta=0.05, seed=seed, transport="subprocess")
    sync()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = FailoverCoordinator(se, make_replica=SubprocessReplica)
    t_attach = time.perf_counter() - t0
    require(not se.replica_degraded, "the standby's bootstrap failed (replica degraded)")
    standby_pids = [fc.replica.proc.pid]
    server_pids = {c.pid for c in se.shards}
    del se  # from here the coordinator is whichever engine ``fc`` holds
    log(f"[rpc] {N_SHARDS} shard servers spawned and answering in {t_spawn:.2f} s; the "
        f"subprocess ShardedEngine built in {t_build:.2f} s (phase 5's loopback engine "
        f"{record['build_s']:.2f} s; each server got the {db['crimes'].num_rows}-row clustered "
        f"table); the standby attached (bootstrap) in {t_attach * 1e3:.1f} ms; server pids "
        f"{sorted(server_pids)}, standby pid {standby_pids[0]}")

    expect_device = f"cuda:{torch.cuda.current_device()}" if on_card else "cpu"
    servers: dict = {}  # pid -> (device, last launch counts read)

    def read_servers():
        for c in fc.engine.shards:
            if c.pid is not None and c.reachable:
                got = c.launch_counts()
                servers[got["pid"]] = (got["device"], got["launch_counts"])

    read_servers()
    require(all(dev == expect_device for dev, _ in servers.values()),
            f"server devices {[d for d, _ in servers.values()]}, expected {expect_device}")
    require(all(not counts for _, counts in servers.values()),
            "a server launched a kernel before the path was driven")

    def host_cols():
        crimes = fc.db["crimes"]
        if cols_cache.get("table") is not crimes:
            cols_cache.clear()
            cols_cache["table"] = crimes
            cols_cache["cols"] = {a: to_host(crimes[a]) for a in needed}
        return cols_cache["cols"]

    def run(label, *, want, hits=True, degraded=False, one_launch=False, repaired=None):
        eng = fc.engine
        before = {k: LAUNCH_COUNTS[k] for k in (*BUILT, "fused_partials")}
        misses = eng.index.misses
        sync()
        t0 = time.perf_counter()
        out = fc.run_batch(burst)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCH_COUNTS[k] - v for k, v in before.items() if LAUNCH_COUNTS[k] != v}
        # A wave with no hit leaves an earlier wave's route behind.
        route = eng.last_route if any(info.reused for _, info in out) else None
        log(f"[rpc] {label}: {len(burst)} queries in {wall * 1e3:.1f} ms wall (phase 5's "
            f"loopback: {record['walls'][want] * 1e3:.1f} ms); coordinator launches "
            f"{launches}; "
            + (f"route fused={route.fused} degraded={route.degraded} "
               f"failed_shards={route.failed_shards} retries={route.n_retries} "
               f"stale_checkpoints={route.stale_checkpoints} "
               f"launch={route.t_launch_s * 1e3:.3f}ms merge={route.t_merge_s * 1e3:.3f}ms; "
               if route is not None else "no hit; ")
            + f"health {eng.health}; misses {eng.index.misses}")
        if hits:
            require(all(info.reused for _, info in out), f"{label}: a query missed")
            require(eng.index.misses == misses, f"{label}: the index missed (a re-capture)")
            require(route.degraded == degraded
                    and all(info.degraded == degraded for _, info in out),
                    f"{label}: degraded is not {degraded} (route {route.failed_shards})")
        if repaired is not None:
            require(all(info.repaired == repaired for _, info in out),
                    f"{label}: repaired is not {repaired} everywhere")
        if one_launch and on_card:
            require(launches.get("fused_partials") == 1
                    and launches.get("segment_aggregate_batch") == 1,
                    f"{label}: {launches} launches, not one fused launch")
        cols, cache = host_cols(), {}
        for i, (q, (res, _), loop) in enumerate(zip(burst, out, record["outputs"][want])):
            sig = q.inner_signature()
            if sig not in cache:
                cache[sig] = _plain_groups(q, cols)
            outcome = check_result(q, res, _plain_result(q, cache[sig]), cache[sig][2])
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            require(cache[sig][2] or _same_result(res, loop),
                    f"{label} q{i:02d}: differs from phase 5's loopback result ({want})")
        return out, route, wall

    for name in (*BUILT, "fused_partials", ROWS_COUNTER):
        LAUNCH_COUNTS[name] = 0

    # 1. The burst (misses captured on the coordinator in one wave), fused
    # replays (stacks built over RPC, then cached), the host loop.
    _, _, t_burst = run("burst", want="burst", hits=False)
    _, _, t_replay = run("replay", want="replay", one_launch=True)
    _, _, t_steady = run("replay, fused again", want="replay, fused again", one_launch=True)
    fc.engine.fused = False
    run("replay, host loop", want="replay, host loop")
    fc.engine.fused = True
    log(f"[rpc] RPC overhead of a fused replay: first {t_replay * 1e3:.1f} ms against the "
        f"loopback's {record['walls']['replay'] * 1e3:.1f} ms; steady {t_steady * 1e3:.1f} ms "
        f"against {record['walls']['replay, fused again'] * 1e3:.1f} ms")

    # 2. Phase 5's 1% append and one-year delete: peer mirrors advance.
    for label, mutate in (
            ("after append", lambda: fc.append_rows("crimes", record["rows"])),
            ("after delete", lambda: fc.delete_rows(
                "crimes", to_host(fc.db["crimes"]["year"] == record["year"])))):
        t0 = time.perf_counter()
        mutate()
        t_mut = time.perf_counter() - t0
        run(label, want=label, repaired=True)
        log(f"[rpc] {label.split()[1]}: {t_mut * 1e3:.1f} ms wall (shipped to the servers and "
            f"to the peer mirrors); mirrors current {fc.engine._peer_ok}, stale checkpoints "
            f"{fc.engine.stale_checkpoints}")
        require(all(fc.engine._peer_ok) and sum(fc.engine.stale_checkpoints) == 0,
                f"{label}: a peer mirror fell behind")

    # The burst's set sketch bits by owning shard: the SIGKILL lands on the
    # one owning most, the other faults on the rest (a replay contacts every
    # shard: the burst's pid/ward queries are sketched on another partition).
    eng = fc.engine
    entries = {e.reg_id: e for e in map(eng.index.lookup_entry, burst)
               if e.sketch.ranges.key() == eng.ranges.key()}.values()
    owned_bits = [sum(int(e.sketch.bits[eng.plan.fragments_of(s)].sum()) for e in entries)
                  for s in range(N_SHARDS)]
    victim, cut, flaky, stalled = (int(s) for s in np.argsort(owned_bits, kind="stable")[::-1])

    # 3. A socket drop (the client's; the server and its state stay), two
    # flaky responses (the server's), a stall past a lowered RPC deadline (a
    # real RpcTimeout, retried, then the shard demoted), each across a replay.
    pid_cut, restores = eng.shards[cut].pid, eng.peer_restores
    eng.shards[cut].inject("partition")
    require(_pid_alive(pid_cut), f"shard server {pid_cut} did not survive its partition")
    _, route, _ = run("partitioned", want="after delete", degraded=True)
    require(cut in route.failed_shards, f"the route names {route.failed_shards}, not {cut}")
    eng.shards[cut].heal()
    run("partition healed", want="after delete")
    require(eng.shards[cut].pid == pid_cut and eng.peer_restores == restores
            and eng.health[cut] == "healthy",
            f"the partitioned shard {cut} was rebuilt or is {eng.health[cut]}")
    eng.shards[flaky].inject("flaky", 2)
    _, route, _ = run("flaky x2", want="after delete")
    require(route.n_retries >= 2, f"{route.n_retries} retries for two flaky responses")
    stalled_client = eng.shards[stalled]
    rpc_deadline = stalled_client._deadline_s
    stalled_client._deadline_s = FAULT_DEADLINE_S
    stalled_client.inject("stall", FAULT_STALL_S)
    try:
        _, route, wall = run("stalled", want="after delete", degraded=True)
    finally:
        stalled_client._deadline_s = rpc_deadline
        stalled_client.heal()
    require(stalled in route.failed_shards,
            f"the stalled shard {stalled} was not routed around ({route.failed_shards})")
    run("stall healed", want="after delete")
    require(eng.health == ["healthy"] * N_SHARDS and eng.peer_restores == restores,
            f"health {eng.health}, peer restores {eng.peer_restores} after the heals")
    log(f"[rpc] faults over RPC: shard {cut} partitioned and healed (server {pid_cut} kept), "
        f"shard {flaky} flaky x2, shard {stalled} stalled {FAULT_STALL_S} s past an RPC "
        f"deadline of {FAULT_DEADLINE_S} s ({wall * 1e3:.1f} ms degraded replay); all exact")

    # 4. SIGKILL of the server owning the most set bits of the burst's sketches.
    client = eng.shards[victim]
    read_servers()
    pid0 = client.pid
    client.inject("kill")
    require(not _pid_alive(pid0), f"shard server {pid0} survived its SIGKILL")
    log(f"[rpc] set bits by shard {owned_bits}: SIGKILLed shard {victim}'s server {pid0}")
    _, route, _ = run("killed", want="after delete", degraded=True, one_launch=True)
    require(victim in route.failed_shards, f"the route names {route.failed_shards}, not {victim}")

    # 5. Heal: recovery from the peer's mirror, timed by part; no reship.
    split = collections.defaultdict(float)
    reships = []
    peer = eng.shards[(victim + 1) % N_SHARDS]

    def timed(obj, name, part, only_victim=False):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            if only_victim and args[0] != victim:
                return fn(*args, **kwargs)
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                split[part] += time.perf_counter() - t0
        setattr(obj, name, wrapper)

    def count_reship(name):
        fn = getattr(client, name)

        def wrapper(*args, **kwargs):
            reships.append(name)
            return fn(*args, **kwargs)
        setattr(client, name, wrapper)

    patched = ((peer, "peer_fetch", "peer fetch", False), (client, "build_local", "build_local", False),
               (eng, "_sync_shard", "log replay", True),
               (eng, "_reregister_shard", "re-registration", True),
               (eng, "_recover_shard", "recovery", True))
    for obj, name, part, only in patched:
        timed(obj, name, part, only)
    for name in ("restore_checkpoint", "rebuild"):
        count_reship(name)
    restores = eng.peer_restores
    client.heal()
    try:
        _, _, wall = run("healed", want="after delete", one_launch=True)
    finally:
        for obj, name, _, _ in patched:
            delattr(obj, name)
        for name in ("restore_checkpoint", "rebuild"):
            delattr(client, name)
    server_pids.add(client.pid)
    log(f"[rpc] recovery of shard {victim} into server {client.pid}: "
        f"{split['recovery'] * 1e3:.1f} ms = peer fetch {split['peer fetch'] * 1e3:.1f} + "
        f"build_local {split['build_local'] * 1e3:.1f} + log replay "
        f"{split['log replay'] * 1e3:.1f} + re-registration "
        f"{split['re-registration'] * 1e3:.1f} + checkpoint, of the {wall * 1e3:.1f} ms read")
    require(eng.peer_restores == restores + 1, "the shard did not recover from its peer's mirror")
    require(not reships, f"recovery reshipped the coordinator's table ({reships})")
    require(eng.health[victim] == "healthy" and client.version == eng.version,
            f"shard {victim} is {eng.health[victim]} at version {client.version}")
    counts_before = dict(LAUNCH_COUNTS)
    on_victim, ctable = eng._row_shard == victim, eng.db["crimes"]
    n_checked = 0
    for key, reg in eng._registered.items():
        if not reg.group_local or not eng.index.contains(reg.entry):
            continue
        require(client.has_maintainer(key), f"shard {victim} lacks the maintainer of entry {key}")
        _, prov = execute_and_provenance(reg.entry.query, eng.db, catalog=eng.engine.catalog)
        bucket = to_host(eng.engine.catalog.bucketize(ctable, reg.ranges))
        want = np.zeros(reg.ranges.n_ranges, dtype=bool)
        want[bucket[prov & on_victim]] = True
        require(np.array_equal(client.bits_for(key), want),
                f"shard {victim}'s maintained bits of entry {key} differ from a fresh capture")
        n_checked += 1
    LAUNCH_COUNTS.clear()
    LAUNCH_COUNTS.update(counts_before)
    require(n_checked > 0, "no group-local entry to check on the recovered shard")
    log(f"[rpc] the recovered server's {n_checked} maintainers equal fresh captures")

    # 6. coord_kill: the standby takes over, timed by part: the promotion
    # (snapshot, replay onto the device, catch-up) and the re-arm (a fresh
    # standby spawned and bootstrapped).
    read_servers()
    old_epoch, old_standby = eng.epoch, standby_pids[-1]
    split.clear()

    def timed_call(fn, part):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                split[part] += time.perf_counter() - t0
        return wrapper

    saved = {name: ShardedEngine.__dict__[name]
             for name in ("from_replica", "_catch_up_all", "attach_replica")}
    make_replica = fc._make_replica
    ShardedEngine.from_replica = staticmethod(timed_call(ShardedEngine.from_replica, "replay"))
    ShardedEngine._catch_up_all = timed_call(ShardedEngine._catch_up_all, "catch-up")
    ShardedEngine.attach_replica = timed_call(ShardedEngine.attach_replica, "standby bootstrap")
    fc.replica.snapshot = timed_call(fc.replica.snapshot, "snapshot")
    fc._make_replica = timed_call(make_replica, "standby spawn")
    t0 = time.perf_counter()
    try:
        promoted = fc.inject_coord("coord_kill")
        sync()
    finally:
        for name, attr in saved.items():
            setattr(ShardedEngine, name, attr)
        fc._make_replica = make_replica
    t_takeover = time.perf_counter() - t0
    standby_pids.append(fc.replica.proc.pid)
    del eng, entries, client, peer
    require(not _pid_alive(old_standby), "the used standby process survived the takeover")
    require(promoted.epoch == old_epoch + 1 and fc.zombie is None,
            f"epoch {promoted.epoch} after {old_epoch}")
    require(promoted.device.type == ("cuda" if on_card else "cpu"),
            f"the promoted coordinator runs on {promoted.device}")
    require(not promoted.replica_degraded, "the re-armed standby's bootstrap failed")
    k5 = LAUNCH_COUNTS["segment_aggregate_batch"]
    run("after coord_kill", want="after delete", one_launch=True)
    require(not on_card or LAUNCH_COUNTS["segment_aggregate_batch"] > k5,
            "the promoted coordinator did not launch the fused kernel")
    t_promote = split["snapshot"] + split["replay"] + split["catch-up"]
    t_rearm = split["standby spawn"] + split["standby bootstrap"]
    log(f"[rpc] coord_kill: takeover {t_takeover * 1e3:.1f} ms = promotion "
        f"{t_promote * 1e3:.1f} ms (snapshot {split['snapshot'] * 1e3:.1f} + replay onto "
        f"{promoted.device} adopting the live servers {split['replay'] * 1e3:.1f} + catch-up "
        f"{split['catch-up'] * 1e3:.1f}) + re-arm {t_rearm * 1e3:.1f} ms (standby spawn "
        f"{split['standby spawn'] * 1e3:.1f} + bootstrap "
        f"{split['standby bootstrap'] * 1e3:.1f}) + the rest; against a cold rebuild of this "
        f"configuration {(t_build + t_burst) * 1e3:.1f} ms (this phase's subprocess build "
        f"{t_build * 1e3:.1f} + its burst of misses {t_burst * 1e3:.1f}); epoch {promoted.epoch}")

    # 7. coord_partition: the zombie is fenced at the shard.
    t0 = time.perf_counter()
    fc.inject_coord("coord_partition")
    t_takeover2 = time.perf_counter() - t0
    standby_pids.append(fc.replica.proc.pid)
    zombie = fc.zombie
    try:
        zombie.shards[0].catch_up(zombie.version)
        fenced = False
    except StaleEpochError:
        fenced = True
    require(fenced, "an op of the partitioned coordinator was not fenced")
    run("after coord_partition", want="after delete", one_launch=True)
    log(f"[rpc] coord_partition: takeover {t_takeover2 * 1e3:.1f} ms, epoch "
        f"{fc.engine.epoch}; the zombie's catch_up raised StaleEpochError")
    del zombie, promoted

    # 8. Shutdown: every server and standby gone, nothing left on the card.
    read_servers()
    apps_during = compute_apps() if on_card else []
    log(f"[rpc] compute apps during the phase: {apps_during}")
    # Inside a container ``nvidia-smi`` may list pids of another namespace,
    # so the processes are also counted: the coordinator's and one a live
    # server, none for the standby (it never initializes CUDA).
    n_live = sum(c.pid is not None for c in fc.engine.shards)
    require(not any(a[0] == str(p) for a in apps_during for p in standby_pids)
            and (not apps_before or len(apps_during) <= len(apps_before) + n_live),
            f"{len(apps_during)} compute apps with {n_live} servers alive: the standby "
            f"or a spare holds a CUDA context")
    t_route = time.perf_counter() - t_phase
    fc.shutdown()
    with pool._lock:
        spares = {sp.proc.pid for sp in pool._all}
    pool.shutdown_all()
    seen = sorted(server_pids | set(servers) | set(standby_pids) | spares)
    alive = [p for p in seen if _pid_alive(p)]
    require(not alive, f"processes {alive} outlived the phase")
    apps_after = compute_apps() if on_card else []
    t0 = time.perf_counter()
    while len(apps_after) > len(apps_before) and time.perf_counter() - t0 < RPC_SETTLE_S:
        time.sleep(0.5)
        apps_after = compute_apps()
    log(f"[rpc] compute apps after shutdown ({time.perf_counter() - t0:.1f} s later): "
        f"{apps_after}")
    require(len(apps_after) <= len(apps_before)
            and not any(a[0] == str(p) for a in apps_after for p in seen),
            f"a process of the phase still holds the card: {apps_after}")

    launches = {name: LAUNCH_COUNTS[name] for name in (*BUILT, "fused_partials")}
    require_compacted("rpc", launches["sketch_filter"], LAUNCH_COUNTS[ROWS_COUNTER])
    for pid, (dev, counts) in sorted(servers.items()):
        log(f"[rpc] server {pid} on {dev}: launches {counts}")
        require(dev == expect_device, f"server {pid} ran on {dev}, not {expect_device}")
        require(not on_card or counts.get("sketch_filter", 0) > 0,
                f"server {pid} never launched sketch_filter")
        require(counts.get("sketch_filter", 0) == counts.get(ROWS_COUNTER, 0),
                f"server {pid}: a sketch_filter launch did not compact its rows")
        for name in BUILT:
            launches[name] += counts.get(name, 0)
    if on_card:
        for name in RPC_KERNELS:
            require(LAUNCH_COUNTS[name] > 0, f"the coordinator never launched {name}")
        for name in RPC_SERVER_KERNELS:
            require(sum(c.get(name, 0) for _, c in servers.values()) > 0,
                    f"no server launched {name}")
    log(f"[rpc] launches, coordinator and servers {launches}; {sum(outcomes.values())} results "
        f"vs full-table group-by {outcomes}; driven in {t_route:.1f} s")
    log(f"[rpc] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the join templates at TPC-H scale factor 1
# ---------------------------------------------------------------------------

TPCH_SF1_LINEITEM = 6_001_215  # lineitem rows at scale factor 1 (TPC-H specification)
JOIN_UNIQUE, JOIN_REPLAYS = 3, 2
# The burst: six thresholds halfway between the seven largest distinct
# lineitem counts of a shipdate, highest first, so that each sketch holds
# the few dates at the top (selective) and no member subsumes a later one.
# Counts keep the maintainers exact (an integral aggregate), so every
# maintained sketch must equal a fresh capture.
JOIN_BURST = 6
JOIN_KERNELS = ("segment_aggregate", "fragment_bitmap", "sketch_filter",
                "fragment_bitmap_batch", "segment_aggregate_batch")


def _lineitem_batch(rng, m: int, n_lineitem: int) -> dict:
    """``m`` lineitem rows from ``make_tpch(n_lineitem)``'s distributions
    (its orders = lineitem / 4, part = lineitem / 6 rule), with the table's
    dtypes."""
    import numpy as np

    n_orders, n_part = max(1, n_lineitem // 4), max(1, n_lineitem // 6)
    quantity = rng.integers(1, 51, m)
    shipdate = rng.integers(8036, 10592, m)
    return dict(
        l_orderkey=rng.integers(1, n_orders + 1, m).astype(np.int32),
        l_partkey=rng.integers(1, n_part + 1, m).astype(np.int32),
        l_suppkey=rng.integers(1, max(2, n_part // 10), m).astype(np.int32),
        l_quantity=quantity.astype(np.float32),
        l_extendedprice=(quantity * rng.uniform(900, 105000 / 50, m)).astype(np.float32),
        l_discount=(rng.integers(0, 11, m).astype(np.float32) / 100.0).astype(np.float32),
        l_tax=(rng.integers(0, 9, m).astype(np.float32) / 100.0).astype(np.float32),
        l_shipdate=shipdate.astype(np.int32),
        l_commitdate=(shipdate + rng.integers(-30, 61, m)).astype(np.int32),
        l_receiptdate=(shipdate + rng.integers(1, 31, m)).astype(np.int32),
    )


def _plain_groups_join(cols, attrs, n):
    """Group ids of ``n`` rows by a mixed-radix key over ``attrs`` (one 1-D
    ``np.unique``) and each group's key values."""
    import numpy as np

    key = np.zeros(n, dtype=np.int64)
    lows, sizes = [], []
    for a in attrs:
        v = cols[a].astype(np.int64)
        lows.append(int(v.min()))
        sizes.append(int(v.max()) - lows[-1] + 1)
        key = key * sizes[-1] + (v - lows[-1])
    uniq, inv = np.unique(key, return_inverse=True)
    values, rest = {}, uniq
    for a, lo, size in reversed(list(zip(attrs, lows, sizes))):
        values[a] = rest % size + lo
        rest = rest // size
    return inv.reshape(-1), uniq.shape[0], values


def _plain_aggregate(fn, inv, n_groups, vals):
    import numpy as np

    counts = np.bincount(inv, minlength=n_groups).astype(np.float64)
    if fn == "count":
        return counts
    sums = np.bincount(inv, weights=vals.astype(np.float64), minlength=n_groups)
    return sums / np.maximum(counts, 1.0) if fn == "avg" else sums


def _plain_join_inner(q, li, orders):
    """The inner block of a join query by a plain numpy join and group-by,
    independent of the port's executor, catalog and kernels: each
    ``l_orderkey`` searched in the sorted ``o_orderkey`` (inner join), one
    1-D ``np.unique`` over a mixed-radix group key, float64 ``bincount``
    sums.  Returns (group key values, float64 aggregate per group)."""
    import numpy as np

    rk = orders[q.join.right_key]
    order = np.argsort(rk, kind="stable")
    lk = li[q.join.left_key]
    pos = np.minimum(np.searchsorted(rk[order], lk), rk.shape[0] - 1)
    match = rk[order][pos] == lk
    attrs = set(q.groupby) | ({q.agg.attr} if q.agg.attr else set())
    cols = {a: (li[a][match] if a in li else orders[a][order[pos[match]]]) for a in attrs}
    inv, n_groups, values = _plain_groups_join(cols, q.groupby, int(match.sum()))
    return values, _plain_aggregate(q.agg.fn, inv, n_groups,
                                    None if q.agg.fn == "count" else cols[q.agg.attr])


def _plain_join(q, inner):
    """``q``'s result from ``_plain_join_inner``'s groups: HAVING, then the
    nested outer block.  Returns (group key values, float64 values), groups
    in lexicographic order of the (outer) group-by."""
    import numpy as np

    values, agg = inner
    keep = np.asarray(q.having.mask(agg)) if q.having is not None else np.ones(agg.shape, bool)
    values = {a: v[keep] for a, v in values.items()}
    agg = agg[keep]
    if q.outer_groupby is not None:
        inv, n_groups, values = _plain_groups_join(values, q.outer_groupby, int(keep.sum()))
        agg = _plain_aggregate(q.outer_agg.fn, inv, n_groups, agg)
        keep = (np.asarray(q.outer_having.mask(agg)) if q.outer_having is not None
                else np.ones(n_groups, bool))
        values = {a: v[keep] for a, v in values.items()}
        agg = agg[keep]
    return values, agg


def _check_plain(q, res, plain) -> None:
    """``res`` against ``_plain_join``: equal group sets and values within
    rel 1e-4 (a group on one side only must sit within rel 1e-4 of the
    deciding threshold)."""
    import numpy as np

    values, agg = plain
    got = np.asarray(res.values, dtype=np.float64)
    if len(got) == len(agg) and all(
            np.array_equal(np.asarray(res.group_values[a]).astype(np.int64), v)
            for a, v in values.items()):
        bad = np.nonzero(np.abs(got - agg) > 1e-4 * np.abs(agg))[0]
        require(bad.size == 0, f"{q}: {bad.size} groups differ from the plain join beyond "
                               f"rel 1e-4, the first {got[bad[:1]]} against {agg[bad[:1]]}")
        return
    attrs = sorted(values)
    want = {tuple(float(values[a][i]) for a in attrs): float(agg[i]) for i in range(agg.size)}
    have = _result_map(res)
    tau = (q.outer_having if q.outer_groupby is not None else q.having).value
    for k in set(have) | set(want):
        if k in have and k in want:
            require(abs(have[k] - want[k]) <= 1e-4 * abs(want[k]),
                    f"{q}: group {k} {have[k]} against the plain join's {want[k]}")
        else:
            v = have.get(k, want.get(k))
            require(abs(v - tau) <= 1e-4 * abs(tau),
                    f"{q}: group {k} ({v}) on one side of the plain join only")


def phase_join(n_lineitem: int, seed: int, device: str = "cuda", db=None) -> dict:
    """The join templates on the card at TPC-H scale: ``run`` (generated
    Q-AJGH and a Q-AAJGH, replayed), ``run_batch`` and maintenance (a burst
    of six Q-AJGH, a replay, a 1% append, a one-year delete, a one-year
    delete of orders, another 1% append, each followed by the burst), and a
    ``ShardedEngine`` over 4 shards (burst, fused and host-loop replays, an
    orders delete that evicts the join sketches).  Makes the TPC-H tables
    unless ``db`` holds them (the engines mutate versions of their own, so
    ``db`` is left as it was).  Returns the phase's launches by kernel."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import (Aggregate, Catalog, ColumnTable, Database, Having, JoinSpec,
                                  PBDSEngine, Query, ShardedEngine, capture_sketch,
                                  default_catalog, execute)
    from repro_torch.core.datasets import make_tpch
    from repro_torch.core.queries import segment_sums_counts
    from repro_torch.core.table import encode_groups
    from repro_torch.core.workload import TPCH_JOIN_SPEC, generate_workload
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    made = db is None
    if made:
        db = make_tpch(n_lineitem, seed=seed, device=dev)
    sync()
    log(f"[join] tpch: " + ", ".join(
        f"{t.name} {t.num_rows} rows x {len(t.schema)} columns "
        f"({sum(v.numel() * v.element_size() for v in t.columns.values()) / 1e6:.1f} MB)"
        for t in db.tables.values()) + f" on {dev}"
        + (f", made in {time.perf_counter() - t_phase:.2f} s" if made else ""))
    join = JoinSpec("orders", "l_orderkey", "o_orderkey")
    t0 = time.perf_counter()
    workload = generate_workload(TPCH_JOIN_SPEC, db, JOIN_UNIQUE, seed=seed)
    require(len(workload) == JOIN_UNIQUE, "the join workload generator returned too few queries")
    # The Q-AAJGH of tests/test_shard.py: count over (l_partkey, l_suppkey),
    # outer sum by l_suppkey, outer threshold at the 0.8 quantile.
    aajgh = Query("lineitem", ("l_partkey", "l_suppkey"), Aggregate("count", None), join=join,
                  having=Having(">", 0.0), outer_groupby=("l_suppkey",),
                  outer_agg=Aggregate("sum", None))
    outer_vals = execute(aajgh, db, catalog=default_catalog()).values
    aajgh = dataclasses.replace(
        aajgh, outer_having=Having(">", float(np.quantile(outer_vals, 0.8))))
    queries = workload + [aajgh]
    log(f"[join] workload: {len(queries)} queries x {JOIN_REPLAYS} replays, generated in "
        f"{time.perf_counter() - t0:.2f} s: " + "; ".join(
            f"{q.template} gb={'/'.join(q.groupby)} {q.agg.fn}({q.agg.attr or '*'})"
            for q in queries))

    cols_of = {"lineitem": sorted(db["lineitem"].schema), "orders": sorted(db["orders"].schema)}

    def host(vdb):
        return {n: {a: to_host(vdb[n][a]) for a in cols_of[n]} for n in cols_of}

    def integral(q):
        return q.agg.fn == "count" or q.agg.attr == "l_quantity"

    checks = []  # (label, db of the version, queries, outputs)
    check_dbs = {}

    def check_db(vdb):
        """The version's tables for the checks: the version 0 database with the
        process-wide catalog (generate_workload's encodings), each mutated
        version as fresh root tables with a fresh catalog (no delta path),
        and its columns on the host."""
        key = (id(vdb["lineitem"]), id(vdb["orders"]))
        if key not in check_dbs:
            if vdb["lineitem"].delta is None and vdb["orders"].delta is None:
                cdb, cat = vdb, default_catalog()
            else:
                cdb = Database({n: ColumnTable(n, dict(vdb[n].columns), vdb[n].primary_key)
                                for n in vdb.names})
                cat = Catalog()
            check_dbs[key] = (vdb, cdb, cat, host(vdb))
        return check_dbs[key][1:]

    def check_all():
        """Every recorded result against full-table execution of its version
        and the plain numpy join (each computed once per version and query,
        the plain join's groups once per version and inner block)."""
        outcomes = collections.Counter()
        fulls, inners = {}, {}
        for label, vdb, qs, outs in checks:
            cdb, cat, cols = check_db(vdb)
            version = (id(cdb["lineitem"]), id(cdb["orders"]))
            for q, (res, _) in zip(qs, outs):
                key = (version, q.signature())
                if key not in fulls:
                    fulls[key] = execute(q, cdb, catalog=cat)
                outcomes[check_result(q, res, fulls[key], envelope_left=not integral(q))] += 1
                key = (version, q.inner_signature())
                if key not in inners:
                    inners[key] = _plain_join_inner(q, cols["lineitem"], cols["orders"])
                _check_plain(q, res, _plain_join(q, inners[key]))
            log(f"[join] {label}: {len(qs)} results equal full-table execution {dict(outcomes)} "
                f"and agree with the plain numpy join")
            outcomes.clear()

    for name in (*BUILT, ROWS_COUNTER):
        LAUNCH_COUNTS[name] = 0

    # -- run: misses, then replays served from the index ------------------------
    eng = PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=100, theta=0.05, seed=seed)
    outs = []
    t_run = time.perf_counter()
    for r in range(JOIN_REPLAYS):
        for i, q in enumerate(queries):
            before = {k: eng.catalog.stats.get(k, 0) for k in
                      ("join_materialize", "join_delta", "join_hit")}
            sync()
            t0 = time.perf_counter()
            res, info = eng.run(q)
            sync()
            wall = time.perf_counter() - t0
            outs.append((res, info))
            js = {k: eng.catalog.stats.get(k, 0) - v for k, v in before.items()}
            log(f"[join] run r{r} q{i} {q.template} gb={'/'.join(q.groupby)} {q.agg.fn} "
                f"{'hit ' if info.reused else 'miss'} created={info.created} attr={info.attr} "
                f"sel={info.selectivity} select={info.t_select * 1e3:.1f}ms "
                f"capture={info.t_capture * 1e3:.1f}ms execute={info.t_execute * 1e3:.1f}ms "
                f"wall={wall * 1e3:.1f}ms Catalog.join {js} groups_out={len(res.values)}")
    t_run = time.perf_counter() - t_run
    checks.append(("run", db, queries * JOIN_REPLAYS, outs))
    require(eng.index.hits >= 1, "no join query hit the index")
    require(any(info.created for _, info in outs), "no join sketch was created")
    run_launches = {k: LAUNCH_COUNTS[k] for k in BUILT}
    log(f"[join] run: {len(outs)} queries in {t_run:.1f} s, hits {eng.index.hits}, misses "
        f"{eng.index.misses}; launches {run_launches}; engine catalog {dict(eng.catalog.stats)}")

    # -- run_batch and maintenance ------------------------------------------------
    def burst_at(vdb, catalog):
        """Six Q-AJGH counting a shipdate's lineitems, their thresholds
        halfway between the seven largest distinct counts of ``vdb``."""
        base = Query("lineitem", ("l_shipdate",), Aggregate("count", None), join=join)
        top = np.unique(execute(base, vdb, catalog=catalog).values)[::-1]
        require(top.size > JOIN_BURST, f"shipdates take only {top.size} distinct counts")
        taus = (top[:JOIN_BURST] + top[1:JOIN_BURST + 1]) / 2.0
        log(f"[join] burst: {JOIN_BURST} Q-AJGH gb=l_shipdate count(*) > "
            + ", ".join(f"{t:g}" for t in taus))
        return [dataclasses.replace(base, having=Having(">", float(t))) for t in taus]

    burst = burst_at(db, default_catalog())
    beng = PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=100, theta=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    stats = {}
    captures = []  # (label, db of the version, [(query, sketch)] to equal a fresh capture)

    def run_burst(label, qs, expect, current=None):
        """``qs`` through ``run_batch``; ``current`` lists the queries whose
        sketches describe this version (all, when None)."""
        sync()
        t0 = time.perf_counter()
        out = beng.run_batch(qs)
        sync()
        wall = time.perf_counter() - t0
        for i, (q, (res, info)) in enumerate(zip(qs, out)):
            log(f"[join] {label} q{i} >{q.having.value:g} "
                f"{'hit ' if info.reused else 'miss'} created={info.created} "
                f"repaired={info.repaired} attr={info.attr} sel={info.selectivity} "
                f"select={info.t_select * 1e3:.1f}ms capture={info.t_capture * 1e3:.1f}ms "
                f"repair={info.t_repair * 1e3:.1f}ms execute={info.t_execute * 1e3:.1f}ms "
                f"total={info.t_total * 1e3:.1f}ms groups_out={len(res.values)}")
        st = dict(beng.catalog.stats)
        log(f"[join] {label}: {len(qs)} queries in {wall * 1e3:.1f} ms wall; "
            f"maintained {st.get('sketch_maintained', 0)}, re-captured "
            f"{st.get('sketch_recaptured', 0)}; Catalog.join materialize "
            f"{st.get('join_materialize', 0)}, delta {st.get('join_delta', 0)}, hit "
            f"{st.get('join_hit', 0)}")
        for what, cond in expect.items():
            require(all(cond(info) for _, info in out), f"{label}: not every query {what}")
        stats[label] = st
        checks.append((label, beng.db, qs, out))
        sigs = None if current is None else {q.signature() for q in current}
        captures.append((label, beng.db, [(e.query, e.sketch) for e in beng.index.entries()
                                          if sigs is None or e.query.signature() in sigs]))
        return out

    def timed(what, fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        log(f"[join] {what}: {(time.perf_counter() - t0) * 1e3:.1f} ms wall; lineitem "
            f"{beng.db['lineitem'].num_rows} rows v{beng.db['lineitem'].version}, orders "
            f"{beng.db['orders'].num_rows} rows v{beng.db['orders'].version}")

    missed = {"missed": lambda i: i.created}
    hit = {"hit unrepaired": lambda i: i.reused and not i.repaired}
    repaired = {"was repaired": lambda i: i.reused and i.repaired}
    t_batch = time.perf_counter()
    run_burst("burst", burst, missed)
    run_burst("replay", burst, hit)
    m = int(round(APPEND_FRAC * beng.db["lineitem"].num_rows))
    timed(f"append_rows of {m} lineitem rows",
          lambda: beng.append_rows("lineitem", _lineitem_batch(rng, m, n_lineitem)))
    run_burst("after append", burst, repaired)
    ship = to_host(beng.db["lineitem"]["l_shipdate"])
    lo = 8036 + 365 * 3  # the fourth year of shipdates
    timed(f"delete_rows of l_shipdate year [{lo}, {lo + 365})",
          lambda: beng.delete_rows("lineitem", (ship >= lo) & (ship < lo + 365)))
    run_burst("after delete", burst, repaired)
    require(stats["after delete"].get("sketch_maintained", 0) == 2 * len(burst)
            and stats["after delete"].get("sketch_recaptured", 0) == 0,
            "the fact-table mutations were not all maintained")
    odate = to_host(beng.db["orders"]["o_orderdate"])
    lo = 8036 + 365 * 2  # the third year of orderdates: their lineitems dangle
    timed(f"delete_rows of orders o_orderdate year [{lo}, {lo + 365})",
          lambda: beng.delete_rows("orders", (odate >= lo) & (odate < lo + 365)))
    # The single-node hit path checks the fact table's version only (as the
    # reference's): the sketches stay, and stay sufficient (counts only fall).
    run_burst("after orders delete", burst, hit, current=[])
    recaptured0 = stats["after orders delete"].get("sketch_recaptured", 0)
    timed(f"append_rows of {m} lineitem rows",
          lambda: beng.append_rows("lineitem", _lineitem_batch(rng, m, n_lineitem)))
    # Each join maintainer now meets a moved dimension and refuses, so every
    # repair re-captures.
    run_burst("after second append", burst, repaired)
    recaptured = stats["after second append"].get("sketch_recaptured", 0) - recaptured0
    log(f"[join] the lineitem append after the orders delete re-captured {recaptured} of "
        f"{len(burst)} join sketches")
    require(recaptured == len(burst),
            f"{recaptured} re-captures for {len(burst)} join sketches kept across the orders delete")
    # Every count fell by about a seventh with the orders delete, so the
    # burst's thresholds hold no group now: a burst with thresholds taken
    # anew from this version, and its replay, put real output under the
    # checks.
    fresh = burst_at(beng.db, beng.catalog)
    run_burst("new thresholds", fresh, missed)
    out = run_burst("new thresholds, replay", fresh, hit)
    require(sum(len(res.values) > 0 for res, _ in out) >= len(fresh) // 2,
            "the burst with new thresholds holds too few groups")
    # These sketches were captured over the mutated dimension, so a fact
    # append is maintained, not re-captured: the join maintainers' repairs
    # past a dimension mutation, with real output under the checks.
    timed(f"append_rows of {m} lineitem rows",
          lambda: beng.append_rows("lineitem", _lineitem_batch(rng, m, n_lineitem)))
    out = run_burst("new thresholds, after a third append", fresh, repaired, current=fresh)
    before, after = stats["new thresholds, replay"], stats["new thresholds, after a third append"]
    require(after.get("sketch_maintained", 0) - before.get("sketch_maintained", 0) == len(fresh)
            and after.get("sketch_recaptured", 0) == before.get("sketch_recaptured", 0),
            "the append after the re-capture was not maintained")
    require(sum(len(res.values) > 0 for res, _ in out) >= len(fresh) // 2,
            "the burst after the third append holds too few groups")
    log(f"[join] run_batch and maintenance in {time.perf_counter() - t_batch:.1f} s")
    batch_launches = {k: LAUNCH_COUNTS[k] for k in BUILT}
    attrs = collections.Counter(e.sketch.attr for e in beng.index.entries())
    attr = attrs.most_common(1)[0][0]

    # -- sharded ----------------------------------------------------------------
    sync()
    t0 = time.perf_counter()
    se = ShardedEngine(db, "lineitem", attr, n_shards=N_SHARDS, n_ranges=100,
                       strategy="CB-OPT-GB", theta=0.05, seed=seed)
    sync()
    log(f"[join] ShardedEngine on {attr} built in {time.perf_counter() - t0:.2f} s: shard rows "
        f"{[int(s.table.num_rows) for s in se.shards]}")
    launch_log = {}

    def shard_burst(label, expect, qs=burst):
        before = {k: LAUNCH_COUNTS[k] for k in (*BUILT, "fused_partials")}
        sync()
        t0 = time.perf_counter()
        out = se.run_batch(qs)
        sync()
        wall = time.perf_counter() - t0
        launch_log[label] = {k: LAUNCH_COUNTS[k] - v for k, v in before.items()
                             if LAUNCH_COUNTS[k] != v}
        route = se.last_route if any(info.reused for _, info in out) else None
        for i, (q, (res, info)) in enumerate(zip(qs, out)):
            log(f"[join] {label} q{i} >{q.having.value:g} "
                f"{'hit ' if info.reused else 'miss'} created={info.created} "
                f"shards contacted={info.shards_contacted} skipped={info.shards_skipped} "
                f"total={info.t_total * 1e3:.1f}ms groups_out={len(res.values)}")
        n_degraded = sum(bool(info.degraded) for _, info in out)
        log(f"[join] {label}: {wall * 1e3:.1f} ms wall; launches {launch_log[label]}; route "
            f"fused={route.fused if route else None} "
            f"launch={route.t_launch_s * 1e3 if route else 0:.3f}ms degraded {n_degraded}")
        require(n_degraded == 0 and not (route and route.degraded),
                f"{label}: results were served degraded (health {se.health})")
        for what, cond in expect.items():
            require(all(cond(info) for _, info in out), f"{label}: not every query {what}")
        checks.append((label, se.db, qs, out))
        return out

    shard_burst("sharded burst", {"missed": lambda i: i.created})
    fused_out = shard_burst("sharded replay", {"hit": lambda i: i.reused})
    require(launch_log["sharded replay"].get("fused_partials") == 1
            and launch_log["sharded replay"].get("segment_aggregate_batch") == (
                1 if dev.type == "cuda" else None),
            f"the sharded replay took {launch_log['sharded replay']}, not one fused launch")
    se.fused = False
    loop_out = shard_burst("sharded replay, host loop", {"hit": lambda i: i.reused})
    se.fused = True
    for i, ((rf, _), (rl, _)) in enumerate(zip(fused_out, loop_out)):
        require(np.array_equal(rf.values, rl.values)
                and sorted(rf.group_values) == sorted(rl.group_values)
                and all(np.array_equal(rf.group_values[a], rl.group_values[a])
                        for a in rf.group_values),
                f"q{i}: the fused and host-loop results differ")
    log(f"[join] fused and host-loop results equal bit for bit ({len(burst)} queries)")
    shard_burst("sharded replay, fused again", {"hit": lambda i: i.reused})
    odate = to_host(se.db["orders"]["o_orderdate"])
    lo = 8036 + 365 * 2
    t0 = time.perf_counter()
    se.delete_rows("orders", (odate >= lo) & (odate < lo + 365))
    log(f"[join] sharded orders delete: {(time.perf_counter() - t0) * 1e3:.1f} ms; index "
        f"entries {len(se.engine.index)}, registrations {len(se._registered)}")
    require(len(se.engine.index) == 0 and not se._registered,
            "the orders delete did not evict the join sketches")
    shard_burst("sharded after orders delete", {"re-captured": lambda i: i.created and not i.reused})
    shard_burst("sharded after orders delete, replay", {"hit": lambda i: i.reused})
    # As on one node, the old thresholds hold no group now: thresholds taken
    # anew put the re-captured sharded join under the checks with output.
    sfresh = burst_at(se.db, se.engine.catalog)
    shard_burst("sharded, new thresholds", {"missed": lambda i: i.created}, sfresh)
    out = shard_burst("sharded, new thresholds, replay", {"hit": lambda i: i.reused}, sfresh)
    require(sum(len(res.values) > 0 for res, _ in out) >= len(sfresh) // 2,
            "the sharded burst with new thresholds holds too few groups")
    launches = {k: LAUNCH_COUNTS[k] for k in BUILT}
    rows_launches = LAUNCH_COUNTS[ROWS_COUNTER]
    t_drive = time.perf_counter() - t_phase
    log(f"[join] driven in {t_drive:.1f} s; launches run {run_launches}, with run_batch "
        f"{batch_launches}, all {launches}")

    if dev.type == "cuda":
        for name in JOIN_KERNELS:
            require(launches[name] > 0, f"kernel {name} was not launched in phase 7")
        require_compacted("join", launches["sketch_filter"], rows_launches)

    # Where a join miss's host time goes: the join, the joined table's group
    # encode, against the device aggregation it feeds (after the counts were
    # read: this launch is no request's).
    q = max(workload, key=lambda q: len(q.groupby))
    sync()
    t0 = time.perf_counter()
    flat, _ = Catalog().join(db["lineitem"], db["orders"], join.left_key, join.right_key)
    sync()
    t_join = time.perf_counter() - t0
    t0 = time.perf_counter()
    gid, n_groups, _ = encode_groups(flat, q.groupby)
    t_encode = time.perf_counter() - t0
    gid_dev = torch.from_numpy(gid).to(dev)
    vals = flat[q.agg.attr] if q.agg.attr else torch.ones(flat.num_rows, device=dev)
    sync()
    t0 = time.perf_counter()
    segment_sums_counts(vals, gid_dev, n_groups)
    sync()
    t_agg = time.perf_counter() - t0
    log(f"[join] one join miss, {flat.num_rows} joined rows, group-by {'/'.join(q.groupby)} "
        f"({n_groups} groups): host Catalog.join {t_join * 1e3:.1f} ms, host encode_groups "
        f"{t_encode * 1e3:.1f} ms, device segment_sums_counts {t_agg * 1e3:.2f} ms")
    del flat, gid_dev, vals

    # Checks, after the counts were read.
    t0 = time.perf_counter()
    for label, vdb, entries in captures:
        if not entries:
            continue
        cdb, cat, _ = check_db(vdb)
        for q, sk in entries:
            want = capture_sketch(q, cdb, sk.ranges, catalog=cat)
            require(np.array_equal(want.bits, sk.bits) and want.size_rows == sk.size_rows,
                    f"{label}: the sketch of {q} differs from a fresh capture")
        log(f"[join] {label}: {len(entries)} sketches equal a fresh capture")
    check_all()
    log(f"[join] checks in {time.perf_counter() - t0:.1f} s; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: every selection strategy, Fig. 9's mix and composite sketches
# ---------------------------------------------------------------------------

# 8a: generated CRIMES_SPEC queries, each replayed once (cut from 4 to 3 to
# keep the script inside its limit: 8b's TPC-H misses are slow on the host).
STRATEGY_QUERIES, STRATEGY_SEED = 3, 33
STARS_ROWS = ROWS  # 8b's stars table: generated, at the crimes row count
# 8b: benchmarks/bench_fig9_endtoend.py's draw (8 unique queries at seed 9,
# runs picked by default_rng(9).integers), n_repeat cut from 5 to 3.
FIG9_UNIQUE, FIG9_REPEAT, FIG9_SEED = 8, 3, 9
FIG9_STRATEGIES = ("NO-PS", "RAND-PK", "RAND-GB", "CB-OPT-GB")
COMPOSITE_GROUPBYS = (("district", "year"), ("community", "month"), ("ward", "year"),
                      ("district", "month"))
STRATEGY_KERNELS = ("segment_aggregate", "fragment_bitmap", "sketch_filter",
                    "fragment_bitmap_batch")


def _envelope_left(q, table, catalog, integral_cols: dict) -> bool:
    """Whether a group's float32 aggregate may differ from full execution by
    order-of-addition rounding: always over a non-integral column, else when
    a group's sum of magnitudes (or its count) reaches 2^24."""
    import numpy as np

    from repro_torch.device import to_host

    if q.agg.fn == "count":
        vals = None
    else:
        key = (id(table), q.agg.attr)
        if key not in integral_cols:
            v = to_host(table[q.agg.attr]).astype(np.float64)
            integral_cols[key] = np.abs(v) if np.array_equal(v, np.floor(v)) else None
        vals = integral_cols[key]
        if vals is None:
            return True
    enc = catalog.groups(table, q.groupby)
    sums = np.bincount(enc.gid, weights=vals, minlength=enc.n_groups)
    return float(sums.max()) >= ENVELOPE


def _strategy_line(label: str, out, eng, wall: float) -> None:
    import numpy as np

    infos = [info for _, _, info in out]
    sels = [i.selectivity for i in infos if i.selectivity is not None]
    log(f"[strategies] {label}: mean sketch selectivity "
        f"{float(np.mean(sels)) if sels else None} over {len(sels)} runs, misses "
        f"{eng.index.misses}, hits {eng.index.hits}, created {sum(i.created for i in infos)}, "
        f"attrs {[i.attr and str(i.attr) for i in infos]}; t_select {sum(i.t_select for i in infos):.3f} s, "
        f"t_capture {sum(i.t_capture for i in infos):.3f} s, "
        f"t_execute {sum(i.t_execute for i in infos):.3f} s, wall {wall:.3f} s")


def phase_strategies(n_rows: int, seed: int, crimes_db=None, tpch_db=None,
                     n_lineitem: int = TPCH_SF1_LINEITEM, stars_rows: int = STARS_ROWS,
                     n_queries: int = STRATEGY_QUERIES, device: str = "cuda") -> dict:
    """Every selection strategy of the paper end to end.  8a: a fresh
    ``PBDSEngine`` (100 ranges, theta 0.05) for NO-PS and each of
    ``ALL_STRATEGIES`` over ``n_queries`` generated crimes queries and their
    replay, and one ``run_batch`` burst under RAND-GB; 8b: Fig. 9's mix
    (NO-PS, RAND-PK, RAND-GB, CB-OPT-GB over TPC-H ``lineitem`` and stars,
    24 runs of 8 queries); 8c: four two-attribute Q-AGH queries through
    ``select_composite_gb``, ``capture_composite`` and
    ``execute_with_composite``.  Every result is checked against full-table
    execution, every random pick against its candidate pool and a second
    engine's, the batch against the sequential runs, each composite sketch
    against the single sketches of its parts and the plain bitmap.  Makes
    the tables it is not given.  Returns the phase's launches by kernel."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import (Aggregate, Catalog, Database, Having, PBDSEngine, Query,
                                  capture_composite, capture_sketch, execute,
                                  execute_with_composite, provenance_mask, select_composite_gb)
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.datasets import make_crimes, make_stars, make_tpch
    from repro_torch.core.strategies import (ALL_STRATEGIES, RANDOM_STRATEGIES, candidate_pool,
                                             select_attribute)
    from repro_torch.core.workload import (CRIMES_SPEC, STARS_SPEC, TPCH_SPEC,
                                           generate_workload)
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.prng import PRNGKey
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    if crimes_db is None:
        crimes_db = Database({"crimes": make_crimes(n_rows, seed=seed, device=dev)})
    if tpch_db is None:
        tpch_db = make_tpch(n_lineitem, seed=seed, device=dev)
    stars_db = Database({"stars": make_stars(stars_rows, device=dev)})  # the benchmark's seed
    sync()
    log("[strategies] tables: " + ", ".join(
        f"{t.name} {t.num_rows} rows x {len(t.schema)} columns "
        f"({sum(v.numel() * v.element_size() for v in t.columns.values()) / 1e6:.1f} MB)"
        for t in (crimes_db["crimes"], tpch_db["lineitem"], stars_db["stars"]))
        + f" on {dev}")

    # The workloads (their thresholds come from full executions, before the
    # counts are reset).
    t0 = time.perf_counter()
    crimes_q = generate_workload(CRIMES_SPEC, crimes_db, n_queries, seed=STRATEGY_SEED)
    require(len(crimes_q) == n_queries, "the crimes workload generator returned too few queries")
    fig9 = {}
    for ds, db, spec in (("tpch", tpch_db, TPCH_SPEC), ("stars", stars_db, STARS_SPEC)):
        base = generate_workload(spec, db, FIG9_UNIQUE, seed=FIG9_SEED)
        require(len(base) == FIG9_UNIQUE, f"the {ds} workload generator returned too few queries")
        draw = np.random.default_rng(FIG9_SEED).integers(0, len(base), FIG9_UNIQUE * FIG9_REPEAT)
        fig9[ds] = (db, [base[i] for i in draw])
    check_cats = {name: Catalog() for name in ("crimes", "tpch", "stars")}
    composite_q = []
    for gb in COMPOSITE_GROUPBYS:
        base = Query("crimes", gb, Aggregate("sum", "records"))
        vals = execute(base, crimes_db, catalog=check_cats["crimes"]).values
        composite_q.append(dataclasses.replace(
            base, having=Having(">", float(np.quantile(vals, 0.9)))))
    log(f"[strategies] workloads in {time.perf_counter() - t0:.2f} s: 8a "
        + "; ".join(f"gb={'/'.join(q.groupby)} {q.agg.fn}({q.agg.attr or '*'})" for q in crimes_q)
        + "; 8b " + "; ".join(f"{ds} {len(wl)} runs of {len({q.signature() for q in wl})} "
                              f"queries" for ds, (_, wl) in fig9.items()))

    def drive(eng, q):
        sync()
        t0 = time.perf_counter()
        res, info = eng.run(q)
        sync()
        return res, info, time.perf_counter() - t0

    for name in (*BUILT, ROWS_COUNTER):
        LAUNCH_COUNTS[name] = 0
    t_drive = time.perf_counter()

    # -- 8a: every strategy over the crimes workload and its replay ---------
    runs = {}
    for strat in ("NO-PS",) + ALL_STRATEGIES:
        eng = PBDSEngine(crimes_db, strategy=strat, n_ranges=100, theta=0.05, seed=seed)
        out, wall = [], 0.0
        for q in crimes_q + crimes_q:
            res, info, w = drive(eng, q)
            out.append((q, res, info))
            wall += w
        runs[strat] = out
        _strategy_line(f"8a {strat}", out, eng, wall)
    eng = PBDSEngine(crimes_db, strategy="RAND-GB", n_ranges=100, theta=0.05, seed=seed)
    sync()
    t0 = time.perf_counter()
    batch = eng.run_batch(crimes_q)
    sync()
    log(f"[strategies] 8a run_batch RAND-GB: {len(crimes_q)} queries in "
        f"{time.perf_counter() - t0:.3f} s, created {sum(i.created for _, i in batch)}, "
        f"attrs {[i.attr and str(i.attr) for _, i in batch]}")
    t_8a = time.perf_counter() - t_drive

    # -- 8b: Fig. 9's mix ----------------------------------------------------
    # The misses' host work, split: every maintainer build (inside t_capture)
    # and every Catalog.groups call (cache hits included; a miss is a group
    # encoding), each between two synchronizations.
    host = collections.Counter()

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                host[key] += time.perf_counter() - t0
                host[key + " calls"] += 1
        return wrapper

    t0_8b = time.perf_counter()
    fig9_runs = {}
    build_maintainer, groups = engine_mod.build_maintainer, Catalog.groups
    engine_mod.build_maintainer = timed("maintainer", build_maintainer)
    Catalog.groups = timed("groups", groups)
    try:
        for ds, (db, wl) in fig9.items():
            for strat in FIG9_STRATEGIES:
                eng = PBDSEngine(db, strategy=strat, n_ranges=100, theta=0.05, seed=FIG9_SEED)
                host.clear()
                out, cum = [], 0.0
                for q in wl:
                    res, info, w = drive(eng, q)
                    out.append((q, res, info))
                    cum += w
                fig9_runs[(ds, strat)] = out
                reused = [i.t_execute for _, _, i in out if i.reused]
                t_capture = sum(i.t_capture for _, _, i in out)
                log(f"[strategies] 8b {ds} {strat}: cum_s {cum:.4f}, t_select "
                    f"{sum(i.t_select for _, _, i in out):.4f}, t_capture {t_capture:.4f}, "
                    f"t_execute {sum(i.t_execute for _, _, i in out):.4f}, t_probe "
                    f"{sum(i.t_probe for _, _, i in out):.6f}, reused_exec_mean_s "
                    f"{float(np.mean(reused)) if reused else None} over {len(reused)}, "
                    f"idx_hits {eng.index.hits}, idx_misses {eng.index.misses}")
                log(f"[strategies] 8b {ds} {strat} host split: {host['maintainer calls']} "
                    f"maintainer builds {host['maintainer']:.4f} s "
                    f"({100 * host['maintainer'] / max(cum, 1e-9):.1f}% of cum_s, "
                    f"{100 * host['maintainer'] / max(t_capture, 1e-9):.1f}% of t_capture); "
                    f"{host['groups calls']} Catalog.groups calls {host['groups']:.4f} s "
                    f"({100 * host['groups'] / max(cum, 1e-9):.1f}% of cum_s)")
    finally:
        engine_mod.build_maintainer, Catalog.groups = build_maintainer, groups
    t_8b = time.perf_counter() - t0_8b

    # -- 8c: composite sketches (CB-OPT-GB2) ---------------------------------
    t0_8c = time.perf_counter()
    comp_cat = Catalog()
    composites = []
    for q in composite_q:
        sync()
        t0 = time.perf_counter()
        best, cr, sizes = select_composite_gb(PRNGKey(seed), q, crimes_db, 100, theta=0.05,
                                              catalog=comp_cat)
        t1 = time.perf_counter()
        sk = capture_composite(q, crimes_db, cr, catalog=comp_cat)
        t2 = time.perf_counter()
        res = execute_with_composite(q, crimes_db, sk, catalog=comp_cat)
        sync()
        t3 = time.perf_counter()
        hits = comp_cat.stats["instance_hit"]
        res2 = execute_with_composite(q, crimes_db, sk, catalog=comp_cat)
        sync()
        t4 = time.perf_counter()
        require(comp_cat.stats["instance_hit"] == hits + 1,
                f"8c: the second execution of {q} missed the instance cache")
        composites.append((q, best, cr, sk, res, res2))
        estimates = {"/".join(k): round(v, 6) for k, v in sizes.items()}
        log(f"[strategies] 8c gb={'/'.join(q.groupby)}: best {best} ({cr.n_ranges} fragments), "
            f"estimates {estimates}, "
            f"captured selectivity {sk.selectivity:.6f}; select {(t1 - t0) * 1e3:.1f} ms, "
            f"capture {(t2 - t1) * 1e3:.1f} ms, execute {(t3 - t2) * 1e3:.1f} ms, "
            f"cached execute {(t4 - t3) * 1e3:.1f} ms")
    t_8c = time.perf_counter() - t0_8c

    sync()
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    rows_launches = LAUNCH_COUNTS[ROWS_COUNTER]
    t_drive = time.perf_counter() - t_drive
    log(f"[strategies] driven in {t_drive:.1f} s (8a {t_8a:.1f}, 8b {t_8b:.1f}, 8c {t_8c:.1f}); "
        f"launches {launches}")
    if dev.type == "cuda":
        for name in STRATEGY_KERNELS:
            require(launches[name] > 0, f"kernel {name} was not launched in phase 8")
        require_compacted("strategies", launches["sketch_filter"], rows_launches)

    # -- checks, after the counts were read ----------------------------------
    t0 = time.perf_counter()
    fulls, integral_cols = {}, {}

    def check(name, db, q, res):
        table = db[q.table]
        key = (name, q.signature())
        if key not in fulls:
            fulls[key] = (execute(q, db, catalog=check_cats[name]),
                          _envelope_left(q, table, check_cats[name], integral_cols))
        full, left = fulls[key]
        return check_result(q, res, full, left)

    for strat, out in runs.items():
        outcomes = collections.Counter(check("crimes", crimes_db, q, res) for q, res, _ in out)
        log(f"[strategies] 8a {strat}: {len(out)} results vs full-table execution "
            f"{dict(outcomes)}")
    for strat in RANDOM_STRATEGIES:
        twin = PBDSEngine(crimes_db, strategy=strat, n_ranges=100, theta=0.05, seed=seed)
        n_checked = 0
        for q, _, info in runs[strat][:n_queries]:
            if info.reused:
                continue
            pick = select_attribute(
                strat, twin._select_key(q), q, crimes_db, twin.n_ranges,
                ranges_for=lambda a: twin.ranges_for("crimes", a), catalog=twin.catalog,
                selection=twin.selection, selection_cache=twin.selection_cache).attr
            require(pick == info.attr, f"8a {strat}: a second engine picked {pick} for {q}, "
                                       f"the first {info.attr}")
            pool = candidate_pool(strat, q, crimes_db, twin.n_ranges, catalog=twin.catalog)
            require(info.attr is None or info.attr in pool,
                    f"8a {strat}: pick {info.attr} is not in the pool {pool} of {q}")
            n_checked += 1
        log(f"[strategies] 8a {strat}: {n_checked} picks in their pools and equal to a second "
            f"engine's")
    for (q, res, info), (b_res, b_info) in zip(runs["RAND-GB"], batch):
        require(_same_result(res, b_res) or res.canonical() == b_res.canonical(),
                f"8a run_batch RAND-GB: {q} differs from the sequential run")
        require((b_info.reused, b_info.created, b_info.attr, b_info.selectivity)
                == (info.reused, info.created, info.attr, info.selectivity),
                f"8a run_batch RAND-GB: {q} ran otherwise than sequentially")
    log(f"[strategies] 8a run_batch RAND-GB: {len(batch)} results and picks equal the "
        f"sequential runs'")
    for (ds, strat), out in fig9_runs.items():
        outcomes = collections.Counter(
            check(ds, fig9[ds][0], q, res) for q, res, _ in out)
        log(f"[strategies] 8b {ds} {strat}: {len(out)} results vs full-table execution "
            f"{dict(outcomes)}")
    table = crimes_db["crimes"]
    for q, best, cr, sk, res, res2 in composites:
        outcome = check("crimes", crimes_db, q, res)
        require(_same_result(res, res2), f"8c: the cached execution of {q} differs")
        singles = {p.attr: capture_sketch(q, crimes_db, p, catalog=check_cats["crimes"])
                   for p in cr.parts}
        for attr, single in singles.items():
            require(sk.selectivity <= single.selectivity,
                    f"8c: composite {best} of {q} covers more than its part {attr}")
        prov = torch.from_numpy(provenance_mask(q, crimes_db, catalog=check_cats["crimes"]))
        plain = ref.fragment_bitmap_ref(prov.to(dev), comp_cat.bucketize(table, cr), cr.n_ranges)
        require(np.array_equal(sk.bits, plain.cpu().numpy().astype(bool)),
                f"8c: the composite bits of {q} differ from the plain fragment_bitmap")
        parts = {a: round(s.selectivity, 6) for a, s in singles.items()}
        log(f"[strategies] 8c gb={'/'.join(q.groupby)}: result {outcome}, selectivity "
            f"{sk.selectivity:.6f} <= parts {parts}, bits equal the plain bitmap")
    log(f"[strategies] checks in {time.perf_counter() - t0:.1f} s; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: sketch-filtered LM serving at full width
# ---------------------------------------------------------------------------

SERVE_ARCH = "stablelm-1.6b"  # serve.py's default --arch
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN, SERVE_DOCS = 16, 64, 16, 5_000
LONG_PROMPT = 2048
# Float32, per layer, relative to the layer's output scale: kernel against
# plain attention and decode against prefill sum in other orders (flash
# tiles against the chunk loop; one query row against 64).
SERVE_TOL = 1e-5
# Bf16, per layer, relative to the layer's output scale: the kernel against
# the plain chunked loop on the same bf16 input.  Both round the attention
# output to bf16 (one ulp apart where they straddle a rounding boundary; P's
# rounding to bf16 in the kernel moves each weight by at most 2^-9), and the
# layer rounds x + attn(x) Wo to bf16 again.  One bf16 ulp is up to 2^-7 =
# 7.8e-3 of a value, so two ulps at the top of the scale are 1.56e-2; the
# bound is FLASH_TOL's bf16 fraction, 2e-2.
SERVE_TOL_BF16 = 2e-2


def _plain_admitted(meta_cols, spec) -> "np.ndarray":
    """Doc ids of the curation query evaluated in plain numpy: the docs of
    the (domain, shard) groups whose mean quality passes the threshold."""
    import numpy as np

    keys = np.stack([meta_cols[a].astype(np.int64) for a in spec.groupby], axis=1)
    _, gid = np.unique(keys, axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    sums = np.bincount(gid, weights=meta_cols[spec.agg_attr].astype(np.float64))
    means = sums / np.bincount(gid)
    assert spec.agg == "avg" and spec.having_op == ">"
    return np.sort(meta_cols["doc_id"][means[gid] > spec.having_value])


def _serve_line(label: str, res, prompt_len: int) -> None:
    b = res.prompt.shape[0]
    log(f"[serve] {label}: B={b} prefill({prompt_len} tok)={res.t_prefill_s * 1e3:.1f}ms "
        f"decode={res.per_token_s * 1e3:.2f}ms/tok over {res.n_decode_steps} steps "
        f"throughput={res.tokens_per_s:.0f} tok/s")


def _plain_attention(fn):
    """Run ``fn()`` with ``layers.gqa_chunked`` bound to the plain chunked
    loop on the card's tensors (the kernel's counterpart)."""
    from repro_torch.models import layers

    kernel = layers.gqa_chunked
    layers.gqa_chunked = layers.gqa_chunked_plain
    try:
        return fn()
    finally:
        layers.gqa_chunked = kernel


def _layerwise_check(cfg, params, tokens) -> None:
    """Float32 prefill of ``tokens`` through every layer of ``cfg``.  At each
    layer, on that layer's input: attention through the kernel against the
    plain chunked loop, and one decode step at the last position (its cache
    holding the layer's keys and values of the earlier positions) against
    prefill's last row.  Each within SERVE_TOL of the layer's scale.  The
    end-to-end logits are logged beside a 1e-6 relative perturbation of the
    embeddings: the random model amplifies both into differences of order
    one, so only the per-layer comparison can hold the kernel to a bound."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import lm

    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    worst = {"kernel vs plain": 0.0, "decode vs prefill": 0.0}
    with torch.inference_mode():
        h = lm._embed(cfg, params, tokens)
        for i in range(cfg.n_periods):
            period = lm._period_slice(params["periods"], i)
            for j, (mixer, _) in enumerate(cfg.pattern):
                p = period[f"b{j}"]
                window = cfg.sliding_window if mixer == "swa" else 0
                got = L.attention_train(p["mixer"], cfg, h, window=window)
                want = _plain_attention(lambda: L.attention_train(p["mixer"], cfg, h,
                                                                  window=window))
                _, k, v = L._qkv(p["mixer"], cfg, L.rmsnorm(p["mixer"]["ln"], h))
                cache = {"k": L.rope(k, pos, cfg.rope_theta), "v": v}
                dec, _ = L.attention_decode(p["mixer"], cfg, h[:, -1:], cache, s - 1,
                                            window=window)
                scale = float(want.abs().max())
                for label, x, y in (("kernel vs plain", got, want),
                                    ("decode vs prefill", dec[:, 0], got[:, -1])):
                    err = float((x - y).abs().max())
                    worst[label] = max(worst[label], err / scale)
                    require(err <= SERVE_TOL * scale,
                            f"layer {i}.{j} f32 {label}: max |diff| {err:.3e} at scale {scale:.1f}")
                h = L.mlp(p["ffn"], cfg, got)
        logits = lm.prefill(params, cfg, {"tokens": tokens})
        plain = _plain_attention(lambda: lm.prefill(params, cfg, {"tokens": tokens}))
        gen = torch.Generator(device=tokens.device).manual_seed(1)
        emb = lm._embed(cfg, params, tokens)
        noisy = emb * (1 + 1e-6 * torch.randn(emb.shape, generator=gen, device=emb.device))
        hn = L.rmsnorm(params["final_norm"], _plain_attention(lambda: lm._run_stack(cfg, params,
                                                                                   noisy)))
        perturbed = torch.einsum("bd,dv->bv", hn[:, -1], params["lm_head"]).float()
    log(f"[serve] f32 layer by layer ({cfg.n_layers} layers, B={b}, S={s}): max |diff| / scale "
        f"kernel vs plain attention {worst['kernel vs plain']:.2e}, decode vs prefill "
        f"{worst['decode vs prefill']:.2e} (tolerance {SERVE_TOL})")
    log(f"[serve] f32 end-to-end logits (up to {float(plain.abs().max()):.2f}): kernel vs plain "
        f"max |diff| {float((logits - plain).abs().max()):.3e}; plain vs plain with the "
        f"embeddings perturbed by 1e-6 relative {float((perturbed - plain).abs().max()):.3e}")


def _layerwise_check_bf16(cfg, params, tokens) -> None:
    """Bf16 prefill of ``tokens`` through every layer of ``cfg`` (the
    serving weights): at each layer, on that layer's input, attention through
    the tensor-core kernel against the plain chunked loop, within
    SERVE_TOL_BF16 of the layer's scale."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import lm

    worst = 0.0
    with torch.inference_mode():
        h = lm._embed(cfg, params, tokens)
        for i in range(cfg.n_periods):
            period = lm._period_slice(params["periods"], i)
            for j, (mixer, _) in enumerate(cfg.pattern):
                p = period[f"b{j}"]
                window = cfg.sliding_window if mixer == "swa" else 0
                got = L.attention_train(p["mixer"], cfg, h, window=window)
                want = _plain_attention(lambda: L.attention_train(p["mixer"], cfg, h,
                                                                  window=window))
                scale = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                worst = max(worst, err / scale)
                require(bool(torch.isfinite(got).all()) and err <= SERVE_TOL_BF16 * scale,
                        f"layer {i}.{j} bf16 kernel vs plain: max |diff| {err:.3e} at scale "
                        f"{scale:.1f}")
                h = L.mlp(p["ffn"], cfg, got)
    log(f"[serve] bf16 layer by layer ({cfg.n_layers} layers, B={tokens.shape[0]}, "
        f"S={tokens.shape[1]}): max |diff| / scale kernel vs plain attention {worst:.2e} "
        f"(tolerance {SERVE_TOL_BF16})")


def phase_serve(seed: int = 0) -> dict:
    """Serve stablelm-1.6b at full width and depth on the card; returns the
    main path's launches (the default serve: admission, prefill, decode)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.kernels.flash_attention import COPY_COUNTER, TC_COUNTER
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.params import n_params
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = lm.concrete_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n = n_params(params)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv_heads}), head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}: {n} parameters ({n * 2 / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    # 1. The main path at serve.py's defaults, bf16.
    for name in (*BUILT, TC_COUNTER, COPY_COUNTER):
        LAUNCH_COUNTS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve(cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=seed,
                n_docs=SERVE_DOCS, params=params)
    wall = time.perf_counter() - t0
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    tc_launches, copies = LAUNCH_COUNTS[TC_COUNTER], LAUNCH_COUNTS[COPY_COUNTER]
    log(f"[serve] admission sketch on {res.run_info.attr}: skipping "
        f"{res.skipped_fraction:.1%} of request pool ({len(res.selected_docs)} of "
        f"{SERVE_DOCS} admitted; created={res.run_info.created}, "
        f"select={res.run_info.t_select * 1e3:.1f}ms capture={res.run_info.t_capture * 1e3:.1f}ms "
        f"execute={res.run_info.t_execute * 1e3:.1f}ms)")
    _serve_line("bf16 defaults", res, SERVE_PROMPT)
    log(f"[serve] finite logits: {bool(torch.isfinite(res.last_logits).all())}; serve() wall "
        f"{wall:.2f} s; launches {launches}")
    log(f"[serve] prefill: {tc_launches} tensor-core flash_attention launches, {copies} "
        f"aligned copies of q/k/v (TMA took the projections' outputs as they are)")
    require(launches["flash_attention"] == cfg.n_layers,
            f"prefill launched flash_attention {launches['flash_attention']} times, "
            f"expected {cfg.n_layers}")
    require(tc_launches == cfg.n_layers,
            f"prefill ran the tensor-core kernel {tc_launches} times, expected {cfg.n_layers}")
    require(copies == 0, f"prefill copied {copies} q/k/v views for TMA's alignment")
    require(launches["segment_aggregate"] > 0, "admission did not aggregate on the card")
    require(res.prefill_logits.shape == (SERVE_REQUESTS, cfg.vocab_p)
            and bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.last_logits).all()), "bf16 logits not finite")
    require(res.generated.shape == (SERVE_REQUESTS, SERVE_GEN)
            and int(res.generated.min()) >= 0 and int(res.generated.max()) < cfg.vocab_p,
            "generated tokens out of range")

    # Admission: the card's pipeline admits what the CPU's does, and every
    # doc the curation query selects.
    spec = pipeline.CurationSpec()
    meta = pipeline.make_corpus_metadata(n_docs=SERVE_DOCS, seed=seed, device="cpu")
    cpu_pipe = pipeline.SketchedDataPipeline(meta, spec, SERVE_REQUESTS, SERVE_PROMPT,
                                             cfg.vocab_size, seed=seed, device="cpu")
    require(np.array_equal(res.selected_docs, cpu_pipe.selected_docs),
            "the card admitted other requests than the CPU pipeline")
    plain = _plain_admitted({a: to_host(meta[a]) for a in meta.schema}, spec)
    require(bool(np.isin(plain, res.selected_docs).all()),
            "the sketch dropped requests the curation query selects")
    log(f"[serve] admission: {len(res.selected_docs)} docs equal to the CPU pipeline's, "
        f"containing all {len(plain)} of the plain query's")

    # 2-3. Float32 copies of the same weights, layer by layer: each layer's
    # attention through the kernel against the plain chunked loop, and decode
    # at the last prompt position against prefill, on the same input.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = params.map(lambda x: x.to(torch.float32))
    _layerwise_check(cfg32, params32, res.prompt)
    del params32
    torch.cuda.empty_cache()

    # 4. A long prompt in bf16: one prefill of 2,048 tokens, 24 launches.
    before = LAUNCH_COUNTS["flash_attention"]
    before_tc, before_copies = LAUNCH_COUNTS[TC_COUNTER], LAUNCH_COUNTS[COPY_COUNTER]
    long = serve(cfg, requests=SERVE_REQUESTS, prompt_len=LONG_PROMPT, gen=SERVE_GEN, seed=seed,
                 n_docs=SERVE_DOCS, params=params)
    long_launches = LAUNCH_COUNTS["flash_attention"] - before
    long_tc = LAUNCH_COUNTS[TC_COUNTER] - before_tc
    long_copies = LAUNCH_COUNTS[COPY_COUNTER] - before_copies
    _serve_line("bf16 long prompt", long, LONG_PROMPT)
    finite = all(bool(torch.isfinite(x).all())
                 for x in (long.prefill_logits, long.decode_logits, long.last_logits))
    log(f"[serve] long prompt: flash_attention launches {long_launches} ({long_tc} tensor-core, "
        f"{long_copies} aligned copies), finite logits {finite}")
    require(finite, "long-prompt logits are not finite")
    require(long_launches == cfg.n_layers and long_tc == cfg.n_layers and long_copies == 0,
            f"a 2048-token prefill launched flash_attention {long_launches} times "
            f"({long_tc} tensor-core, {long_copies} copies)")

    # 5. Bf16 layer by layer on the serving weights, at both prompts.
    for tokens in (res.prompt, long.prompt):
        _layerwise_check_bf16(cfg, params, tokens)

    # Warm prefill times (CUDA events; the serve() walls above include first calls).
    with torch.inference_mode():
        for tokens in (res.prompt, long.prompt):
            ms = time_ms(lambda: lm.prefill(params, cfg, {"tokens": tokens}), reps=5, warmup=1)
            log(f"[serve] warm bf16 prefill B={tokens.shape[0]} S={tokens.shape[1]}: {ms:.2f} ms "
                f"({tokens.numel() / ms * 1e3:.0f} tok/s)")
        # The kernel's share: one layer's attention call at this prefill's shapes.
        p0 = lm._period_slice(params["periods"], 0)["b0"]["mixer"]
        x = lm._embed(cfg, params, long.prompt)
        q, k, v = L._qkv(p0, cfg, L.rmsnorm(p0["ln"], x))
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
        ms = time_ms(lambda: L.gqa_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk))
        log(f"[serve] flash_attention in the 2,048-token prefill: {ms:.3f} ms a layer, "
            f"{ms * cfg.n_layers:.1f} ms over {cfg.n_layers} layers")
    log(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"phase done in {time.perf_counter() - t_phase:.1f} s")
    del params, res, long
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a checkout of "
              f"the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.datasets import make_tpch

    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(KERNEL_ROWS, SEED)
    launches, db, workload, full_values = phase_engine(ROWS, UNIQUE, REPLAYS, SEED)
    batch_launches = phase_batch(ROWS, SEED, db, workload, full_values)
    launches["fragment_bitmap_batch"] = batch_launches["fragment_bitmap_batch"]
    shard_launches, sharded, burst, shard_record = phase_shard(ROWS, SEED, db, workload,
                                                               full_values)
    launches["segment_aggregate_batch"] = shard_launches["segment_aggregate_batch"]
    fault_launches = phase_faults(sharded, burst, SEED)
    for name in FAULT_KERNELS:
        launches[name] += fault_launches[name]
    del sharded, burst
    rpc_launches = phase_rpc(db, shard_record, SEED)
    for name, _, _ in KERNELS:
        launches[name] = launches.get(name, 0) + rpc_launches.get(name, 0)
    del workload, full_values, shard_record
    t1 = time.perf_counter()
    tpch = make_tpch(TPCH_SF1_LINEITEM, seed=SEED, device="cuda")  # phases 7 and 8
    torch.cuda.synchronize()
    log(f"[join] tpch made in {time.perf_counter() - t1:.2f} s")
    join_launches = phase_join(TPCH_SF1_LINEITEM, SEED, db=tpch)
    for name in JOIN_KERNELS:
        launches[name] += join_launches[name]
    strategy_launches = phase_strategies(ROWS, SEED, crimes_db=db, tpch_db=tpch)
    for name in STRATEGY_KERNELS:
        launches[name] += strategy_launches[name]
    del db, tpch
    launches["flash_attention"] = phase_serve(SEED_SERVE)["flash_attention"]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], **rows[name])
               for name, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
