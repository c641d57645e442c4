#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phase 1 builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once).  Phase 2 holds each kernel against
its plain PyTorch version on the card at the main path's shapes and times
both, the bandwidth bound and one PyTorch library call as a yardstick
(sketch_filter also as the mask and kept rows of one launch at 5% and 40%
kept, fragment_bitmap also at 32,768 ranges and as one kernel a call, each
beside its device time from ``torch.profiler``).
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
route may be served degraded.  Phase 6 serves ``stablelm-1.6b`` at full
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
# segment_aggregate in phase 2: the executor's group pads (16, the cluster
# kernel's narrowest width 2,048, the widest 16,384); the JSON row is the
# widest.  segment_aggregate_batch's JSON row: (B, n, G) of a fused launch
# whose group-bys pad to 128.
SEGMENT_PADS = (16, 2048, 16384)
SEGMENT_REPORTED = 16384
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

    # fragment_bitmap_batch: a wave's capture, B masks over one bucketization.
    # The row is B = 8 (a pow2-padded burst of 5-8 thresholds); B = 32 is logged.
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
            f"rows equal to fragment_bitmap; {rows['fragment_bitmap_batch']}")
        del provs, provs_i, index, got, want

    # segment_aggregate: the executor's group pads, integral and normal values
    # (G = 2,048 is the narrowest width of the cluster kernel, one slice).
    seg_err = 0.0
    for g in SEGMENT_PADS:
        gid = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        w = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.float32)
        integral = torch.randint(0, 8, (n,), generator=gen, device=dev).to(torch.float32)
        s1, c1 = ops.segment_aggregate(integral, gid, g, w)
        s2, c2 = ref.segment_aggregate_ref(integral, gid, g, w)
        torch.cuda.synchronize()
        require(float(s2.max()) < ENVELOPE, "integral test sums left the 2^24 envelope")
        require(torch.equal(s1, s2) and torch.equal(c1, c2),
                f"segment_aggregate (G={g}) is not bit-exact on integral inputs")
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
                f"segment_aggregate (G={g}) normal sums off: kernel {err_k:.2e}, plain {err_p:.2e}")
        require(torch.equal(c1, c2), f"segment_aggregate (G={g}) counts differ")
        # The kernel adds in a fixed order: reruns give the same bits.
        for _ in range(3):
            s3, c3 = ops.segment_aggregate(normal, gid, g, w)
            require(torch.equal(s1, s3) and torch.equal(c1, c3),
                    f"segment_aggregate (G={g}) gave other bits on a rerun of normal inputs")
        diff = float((s1 - s2).abs().max())
        seg_err = max(seg_err, diff)
        vw2 = torch.stack([integral * w, w], dim=1)
        out2 = torch.zeros(g, 2, dtype=torch.float32, device=dev)
        nnz_w = int((w != 0).sum())
        b_ms, b_by = bound(n * 8 + nnz_w * 4 + g * 8, 3 * nnz_w)
        ms = time_ms(lambda: ops.segment_aggregate(integral, gid, g, w))
        card = card_state()
        row = dict(
            max_abs_err=diff, ms=ms,
            plain_ms=time_ms(lambda: ref.segment_aggregate_ref(integral, gid, g, w)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: out2.index_add_(0, gl, vw2)),
        )
        log(f"[kernels] segment_aggregate n={n} G={g} integral bit-exact; normal "
            f"rel err kernel {err_k:.2e} plain {err_p:.2e}, max |kernel-plain| {diff:.3e}, "
            f"3 reruns bit-equal; kernel {ms:.4f} ms, index_add_ {row['library_ms']:.4f} ms "
            f"(SM clock, power after the kernel: {card}); {row}")
        if g == SEGMENT_REPORTED:
            rows["segment_aggregate"] = row
    rows["segment_aggregate"]["max_abs_err"] = seg_err
    rows["segment_aggregate_batch"] = _kernel_segment_aggregate_batch(n, gen, rows)
    rows["flash_attention"] = _kernel_flash_attention(seed)
    return rows


def _kernel_segment_aggregate_batch(n: int, gen, rows: dict) -> dict:
    """segment_aggregate_batch at the fused launch's shapes (B sketches of
    S_pad * R_pad = 4 * 2^18 rows, at a narrow, a middle and the widest
    group pad), and at B = 1 over ``n`` rows to compare with the unbatched
    kernel's row.  The reported row is BATCH_REPORTED, picked by its shape
    (phase 5's group-bys pad to 128-512)."""
    import torch

    from repro_torch.kernels import ops, ref

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
        row = dict(
            max_abs_err=diff, ms=ms,
            plain_ms=time_ms(lambda: ref.segment_aggregate_batch_ref(integral, gid, g, w)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: out2.index_add_(0, flat, vw2)),
        )
        log(f"[kernels] segment_aggregate_batch B={b} n={n_b} G={g} integral bit-exact and "
            f"equal to segment_aggregate row by row; normal: 3 reruns bit-equal, rows equal "
            f"to the unbatched kernel, max |kernel-plain| {diff:.3e}; kernel {ms:.4f} ms, "
            f"index_add_ {row['library_ms']:.4f} ms (SM clock, power after the kernel: "
            f"{card}); {row}")
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


# ---------------------------------------------------------------------------
# Phase 3: the engine at real scale
# ---------------------------------------------------------------------------


def _result_map(res):
    attrs = sorted(res.group_values)
    return {tuple(float(res.group_values[a][i]) for a in attrs): float(res.values[i])
            for i in range(len(res.values))}


def check_result(q, res, full, envelope_left: bool) -> str:
    """'exact' when ``res`` equals full-table execution; 'within 1e-6' when
    the group sums left the float32 integer envelope and every difference
    is order-of-addition rounding.  Raises otherwise."""
    if res.canonical() == full.canonical():
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


def phase_shard(n_rows: int, seed: int, db=None, workload=None, full_values=None) -> dict:
    """``ShardedEngine`` over ``N_SHARDS`` fragment shards on the
    ``SHARD_ATTR`` partition: burst (misses), replay (one fused launch),
    replay through the host loop, replay fused again, append 1% and burst,
    delete one year and burst.  Without phase 3's table, workload and full-table results it
    makes its own."""
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
    log(f"[shard] ShardedEngine built in {time.perf_counter() - t0:.2f} s: "
        f"{se.ranges.n_ranges} fragments on {SHARD_ATTR}, shard rows "
        f"{[int(s.table.num_rows) for s in se.shards]}, fragments per shard "
        f"{[int(se.plan.fragments_of(s).size) for s in range(N_SHARDS)]}")

    steps = []  # (label, table version, its needed columns on the host, queries, outputs)
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
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(KERNEL_ROWS, SEED)
    launches, db, workload, full_values = phase_engine(ROWS, UNIQUE, REPLAYS, SEED)
    batch_launches = phase_batch(ROWS, SEED, db, workload, full_values)
    launches["fragment_bitmap_batch"] = batch_launches["fragment_bitmap_batch"]
    shard_launches = phase_shard(ROWS, SEED, db, workload, full_values)
    launches["segment_aggregate_batch"] = shard_launches["segment_aggregate_batch"]
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
