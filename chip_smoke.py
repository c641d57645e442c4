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
each beside its device time from ``torch.profiler`` by kernel; the f32
flash-attention kernel and SDPA in turns on the same shapes; and the
flash-attention backward at the training micro-batch, internlm2-20b's GQA
and gemma3's window shapes against its plain version, with equal bits on a
rerun, beside SDPA's backward; and the two recurrent scans at phase 13's
long prefill, jamba-1.5-large's selective scan and xlstm-350m's sLSTM
scan, with equal bits on a rerun, the selective scan also as its gated
entry, bit for bit against the unfused chain it replaces and timed beside
it, with the blocks an SM holds and the issue floor its SASS gives; and
their backward kernels, the sLSTM's at xlstm-350m's training microbatch of
4 rows and at 16, the gated selective scan's at jamba's cut's 1 row and at
16, each from the forward kernel's residuals against the plain backward
within SCAN_GRAD_TOL, with equal bits on a rerun, and the sLSTM's dwr
product timed apart).
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
apps); the servers' launches count in the kernels line.  Phase 7 drives the join templates over
``make_tpch`` at the reference benchmarks' full scale (lineitem 1,000,000
rows, orders 250,000, part 166,666): ``run`` over three generated Q-AJGH and
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
and OPT over two generated queries and their replay, and a ``run_batch``
burst under RAND-GB; Fig. 9's mix (NO-PS, RAND-PK, RAND-GB, CB-OPT-GB,
12 runs of 4 generated queries) over phase 7's TPC-H ``lineitem`` and a
6.7M-row ``make_stars`` table, each engine's maintainer builds and group
encodings timed on the host; and two two-attribute Q-AGH queries
through ``select_composite_gb``, ``capture_composite`` and
``execute_with_composite``.  It checks every result against full-table
execution, every random pick against its candidate pool and a second
engine's, the batch against the sequential runs, each composite sketch
against the single sketches of its parts and the plain bitmap, and that
kernels 1-4 each launch.  Phases run in the order 1-5, 9, 10, 7, 8, 6, 11, 12, 13, 14.  Phase 6 serves ``stablelm-1.6b`` at full
width and depth (24 layers, d_model 2048, 32 heads, vocab 100,352, bf16,
random weights from the seed) through ``launch.serve.serve``: sketch-filtered
admission of 16 requests out of 5,000, a 64-token prefill whose 24 attention
layers run the flash-attention kernel, and 16 greedy tokens; it checks the
admitted requests against the CPU pipeline and a plain numpy evaluation of
the curation query, each layer's attention through the kernel against the
plain chunked loop (float32 copies of the weights, where decode is also
held against prefill, and the bf16 weights themselves at both prompts),
that every bf16 prefill ran the tensor-core kernel, and a 2,048-token
prompt's admission and prefill (no decode through it).  Phase 11 trains ``stablelm-1.6b`` at full width and depth (bf16,
``remat="full"``, batch 8 of 2,048 tokens in 2 microbatches, AdamW with an
f32 master, 6 steps): curation of 20,000 docs as ``launch/train.py`` runs
it, checked against the CPU pipeline and a plain numpy evaluation; every
layer's attention gradients through the forward and backward kernels
against the plain chunked loop's on that layer's input (bf16 weights and
f32 copies); steps 0-5 with an async checkpoint after step 2 (26.3 GB),
then a restore of it and steps 3-5 again, whose losses, grad norms and
final parameters and moments must equal the straight run's bit for bit;
the launch counts of both kernels per step; and the training CLI fresh and
resumed as processes on the card.  Phase 12 serves ``qwen2-moe-a2.7b`` at
full width and depth (24 layers, d_model 2048, 16 heads, 64 experts of
which 60 are real, top-4, a shared expert of 5,632, bf16, 15.15 B random
parameters) through ``launch.serve.serve`` at phase 6's defaults; then, on
every layer's own input at that prompt, attention through the kernel
against the plain chunked loop and ``moe`` against ``moe_plain`` (equal
picks, kept slots and aux; the output within ``MOE_TOL_BF16``); a
2,048-token prompt's prefill (no decode through it), ``moe`` against
``moe_plain`` on its first and last layers and a rerun with equal bits;
each layer's share of picks dropped by capacity, the warm prefill and
decode times beside decode's bound; and ``qwen3-moe-30b-a3b`` at full
width and 2 of its 48 periods (128 experts, top-8, 32 heads on 4) served
and checked layer by layer.  Phase 13 serves ``xlstm-350m`` at full width
and depth (12 periods of mLSTM and sLSTM, d_model 1,024, bf16, 0.455 B
random parameters) and ``jamba-1.5-large-398b`` at full width over the
first four blocks of its period (attention + MoE, then mamba with MLP,
MoE and MLP; 23.0 B parameters) through ``launch.serve.serve`` at phase
6's defaults: the launches of each prefill (12 sLSTM scans; 3 gated
selective scans and 1 tensor-core attention), every scan layer's kernel
against its plain version on that layer's own input with a bit-equal
rerun (at a mamba layer also the gated scan against the unfused chain, bit
for bit), decode
against prefill layer by layer on float32 copies of xlstm's weights, a
2,048-token prefill (its scans checked on the first and last layers),
warm prefill and decode times beside decode's bound, and the peak memory.
Phase 14 trains ``xlstm-350m`` at full width and depth on the card (bf16,
``remat="full"``, phase 11's batch of 8 x 2,048 in 2 microbatches and 6
steps, curation as phase 11's): the sLSTM's gradients at its first and last
layer, each on its own input, through the scan kernels against autograd
through the plain loop (bf16 weights and f32 copies); a checkpoint after
step 3 and a resume to 6 equal to the straight run bit for bit; every loss
finite; exactly 48 sLSTM forwards a step, of them only the 24
recomputations writing residuals, and 24 backward kernels; the training
CLI fresh and resumed; then ``jamba-1.5-large-398b`` cut to one (mamba,
MLP) block at full width (2.09 B parameters): the layer's gradients through
the gated scan's kernels against the plain version's autograd, the first
microbatch's gradients taken twice equal bit for bit, 3 steps of 2 x 2,048
with finite losses and one backward kernel a microbatch.
Any failed check raises, so the exit code is
not 0.

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
# Special-function units: 16 results a clock per SM (the CUDA C++ Programming
# Guide's throughput table, compute capability 9.0) x 132 SMs x 1,980 MHz.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
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
    # No Pallas kernel: the gradient XLA derives for the reference's chunk loop.
    ("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/layers.py:91"),
    # No Pallas kernel: mamba_train's chunked lax.scan pair, and the forward of
    # the sLSTM's custom-VJP lax.scan.
    ("selective_scan", "src/repro_torch/kernels/csrc/selective_scan.cu",
     "src/repro/models/ssm.py:58"),
    ("slstm_scan", "src/repro_torch/kernels/csrc/slstm_scan.cu",
     "src/repro/models/ssm.py:412"),
    # No Pallas kernel: autodiff of mamba_train's scans, and the sLSTM's
    # custom-VJP backward lax.scan.
    ("selective_scan_bwd", "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
     "src/repro/models/ssm.py:58"),
    ("slstm_scan_bwd", "src/repro_torch/kernels/csrc/slstm_scan_bwd.cu",
     "src/repro/models/ssm.py:375"),
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
    rows["flash_attention_bwd"] = _kernel_flash_attention_bwd(seed)
    rows["selective_scan"] = _kernel_selective_scan(seed)
    rows["slstm_scan"] = _kernel_slstm_scan(seed)
    rows["selective_scan_bwd"] = _kernel_selective_scan_bwd(seed)
    rows["slstm_scan_bwd"] = _kernel_slstm_scan_bwd(seed)
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


# flash_attention_bwd in phase 2: (B, S, T, Hq, Hkv, D, causal, window), bf16.
# Phase 11's training micro-batch (stablelm-1.6b, B=4 of its batch of 8 at
# 2,048 tokens), phase 2's internlm2-20b GQA shape and gemma3's window
# shape.  The JSON row is the training micro-batch.
FLASH_BWD_SHAPES = ((4, 2048, 2048, 32, 32, 64, True, 0),
                    (4, 2048, 2048, 48, 8, 128, True, 0),
                    (1, 4096, 4096, 32, 16, 168, True, 1024))
FLASH_BWD_REPORTED = FLASH_BWD_SHAPES[0]


def _kernel_flash_attention_bwd(seed: int) -> dict:
    """flash_attention_bwd against flash_attention_bwd_ref at
    FLASH_BWD_SHAPES (bf16, the (B, S, H, D) layout of the training path,
    from the forward kernel's o and lse), within FLASH_TOL; a rerun gives
    equal bits.  Timed beside the plain version and SDPA's backward (the
    library yardstick: ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``, the backward alone), with the
    device ms of one call by kernel and the bound: 10 B H D flops a live
    query-key pair at 989 TFLOP/s against q, k, v, o, dO, lse in and dq,
    dk, dv out."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import measure, ref
    from repro_torch.kernels.flash_attention import (BWD_COPY_COUNTER, BWD_TC_COUNTER,
                                                     flash_attention, flash_attention_bwd)
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    out, worst = None, 0.0
    tol = FLASH_TOL["bfloat16"]
    for shape in FLASH_BWD_SHAPES:
        b, s, t, hq, hkv, d, causal, window = shape
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, t, hkv, d), generator=gen, device=dev).bfloat16()
                for _ in "kv")
        do = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
        o, lse = flash_attention(q, k, v, causal=causal, window=window, layout="bshd",
                                 return_lse=True)

        def kernel():
            return flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window,
                                       layout="bshd")

        qh, kh, vh, oh, doh = (x.transpose(1, 2) for x in (q, k, v, o, do))

        def plain():
            return ref.flash_attention_bwd_ref(qh, kh, vh, oh, doh, causal, window)

        before_tc, before_copies = LAUNCH_COUNTS[BWD_TC_COUNTER], LAUNCH_COUNTS[BWD_COPY_COUNTER]
        got, again = kernel(), kernel()
        require(LAUNCH_COUNTS[BWD_TC_COUNTER] - before_tc == 2
                and LAUNCH_COUNTS[BWD_COPY_COUNTER] == before_copies,
                f"flash_attention_bwd {shape}: bf16 calls did not run the tensor-core kernels "
                f"alone, without copies")
        want = plain()
        torch.cuda.synchronize()
        err = 0.0
        for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            w = w.transpose(1, 2).float()
            require(torch.equal(g, g2), f"flash_attention_bwd {shape}: {name} of a rerun "
                                        f"differs")
            diff = (g.float() - w).abs()
            require(bool(torch.isfinite(g).all()) and not bool((diff > tol + tol * w.abs()).any()),
                    f"flash_attention_bwd {shape}: {name} disagrees with its plain version "
                    f"(max err {float(diff.max()):.3e})")
            err = max(err, float(diff.max()))
        worst = max(worst, err)
        del got, again, want
        torch.cuda.empty_cache()
        mask = None
        if window > 0 or s != t:
            pos = torch.arange(s, device=dev)[:, None] + (t - s)
            kpos = torch.arange(t, device=dev)[None, :]
            mask = (kpos <= pos) & (kpos > pos - window) if window > 0 else kpos <= pos
        sq, sk, sv = (x.detach().requires_grad_() for x in (qh, kh, vh))
        sdpa = F.scaled_dot_product_attention(
            sq, sk, sv, enable_gqa=hkv != hq,
            **(dict(is_causal=True) if mask is None else dict(attn_mask=mask)))

        def library():
            return torch.autograd.grad(sdpa, (sq, sk, sv), doh, retain_graph=True)

        pairs = live_pairs(s, t, causal, window)
        item = q.element_size()
        n_bytes = (item * (3 * b * hq * s * d + 2 * b * hkv * t * d) + 4 * b * hq * s
                   + item * (b * hq * s * d + 2 * b * hkv * t * d))
        b_ms, b_by = bound(n_bytes, 10 * b * hq * d * pairs, BF16_OPS_PER_S)
        ms = time_ms(kernel, reps=10)
        card = card_state()
        per = {k_: round(v_, 4) for k_, v_ in measure.device_ms(torch, kernel, calls=5).items()}
        row = dict(max_abs_err=err, ms=ms, plain_ms=time_ms(plain, reps=5, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, reps=10))
        log(f"[kernels] flash_attention_bwd B={b} S={s} T={t} Hq={hq} Hkv={hkv} D={d} "
            f"causal={causal} window={window} bf16: live pairs {pairs}, within {tol} of plain, "
            f"rerun bit-equal; kernel {ms:.4f} ms, device {sum(per.values()):.4f} ms {per} "
            f"(bound {b_ms:.4f} ms, {b_by}; SDPA backward {row['library_ms']:.4f} ms; SM clock, "
            f"power after it: {card}); {row}")
        if shape == FLASH_BWD_REPORTED:
            out = row
        del q, k, v, do, o, lse, qh, kh, vh, oh, doh, sq, sk, sv, sdpa, mask
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


# The recurrent scans at phase 13's long prefill: jamba-1.5-large's mamba
# layer (16 rows of 2,048 positions, di 16,384, 16 states, bf16 x1) and
# xlstm-350m's sLSTM layer (16 rows of 2,048, 4 heads of 256 units, bf16).
SCAN_SHAPE = (16, 2048, 16384, 16)
SLSTM_SHAPE = (16, 2048, 4, 256)
# The plain selective scan's chunk here: at the reference's 1,024 its decay
# and drive would take 17.2 GB each at SCAN_SHAPE; the chunk bounds memory
# only (the state crosses chunks unchanged).
SCAN_PLAIN_CHUNK = 128
# Float32, of the output's largest magnitude (derived in
# tests/test_torch_ssm_card.py): selective_scan's states equal the plain
# version's bit for bit and its output's 16-term sum runs in another order
# (at most 1.9e-6 of the terms' absolute sum); slstm_scan's recurrent
# product's 256-term sum runs in another order, which the recurrence does not
# amplify (3.6e-7 of the scale between two float32 orders over 2,048 steps).
SCAN_TOL = 1e-5


def _selective_scan_bound(b: int, s: int, di: int, n: int, x_bytes: int):
    """selective_scan's least ms: its bytes (x1, dt and ys a position and
    channel, b and c a position, a) at 3.35 TB/s against its B S di n
    exponentials at the special-function units' rate."""
    return bound((x_bytes + 8) * b * s * di + 8 * b * s * n + 4 * di * n, b * s * di * n,
                 SFU_OPS_PER_S)


def _gated_scan_bound(b: int, s: int, di: int, n: int, x_bytes: int):
    """selective_scan_gated's least ms: its bytes (x1, the raw dt, z and the
    output a position and channel, b and c a position, a, dd and dt_bias) at
    3.35 TB/s against its B S di (n + 2) exponentials (the states', the
    softplus's and the gate's) at the special-function units' rate."""
    return bound((3 * x_bytes + 4) * b * s * di + 8 * b * s * n + 4 * di * (n + 2),
                 b * s * di * (n + 2), SFU_OPS_PER_S)


def _slstm_scan_bound(b: int, s: int, hh: int, uh: int, x_bytes: int, w_bytes: int):
    """slstm_scan's least ms: the recurrent product's 2 B S H uh 4uh float32
    operations at 67 TFLOP/s against its bytes (xproj, hs, wr and bias)."""
    d = hh * uh
    return bound(x_bytes * b * s * 4 * d + 4 * b * s * d + w_bytes * (hh * uh * 4 * uh + 4 * d),
                 2 * b * s * hh * uh * 4 * uh)


def _scan_row(label: str, kernel, plain, b_ms: float, b_by: str, err: float,
              plain_reps: int = 2, plain_ms: float = None) -> dict:
    """A scan kernel's JSON row: its CUDA-event and device times beside the
    plain version's time (``plain_ms`` where the caller timed it) and the
    bound; no single PyTorch call computes a scan, so ``library_ms`` is
    None."""
    import torch

    from repro_torch.kernels import measure

    ms = time_ms(kernel, reps=10)
    card = card_state()
    per = {k: round(v, 4) for k, v in measure.device_ms(torch, kernel, calls=5).items()}
    if plain_ms is None:
        plain_ms = time_ms(plain, reps=plain_reps, warmup=1)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    log(f"[kernels] {label}: kernel {ms:.4f} ms, device {sum(per.values()):.4f} ms {per} (bound "
        f"{b_ms:.4f} ms, {b_by}; SM clock, power after it: {card}); no single PyTorch call "
        f"computes it; {row}")
    return row


def _kernel_selective_scan(seed: int) -> dict:
    """selective_scan against its plain version at SCAN_SHAPE on random
    gates (a = -e, the model's a_log of ones), equal bits on a rerun; bound
    by the larger of its bytes (x1, dt, ys, b, c) at 3.35 TB/s and its
    B S di n exponentials at the special-function units' rate, beside the
    issue floor its SASS gives (scan_probe.sass_counts) and the blocks an SM
    holds.  Then selective_scan_gated at SCAN_SHAPE (bf16 z, a view of the
    in_proj output, and output) against the same ops around the scan-only
    kernel, bit for bit, timed beside that unfused chain and its bound; its
    numbers go into the row under ``gated``."""
    import ctypes

    import torch

    from repro_torch.kernels import build, ref, scan_probe
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_gated

    b, s, di, n = SCAN_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16))
    dt = ref.softplus(torch.randn((b, s, di), generator=gen, device=dev))
    a = -torch.exp(torch.ones((di, n), device=dev))
    bmat = torch.randn((b, s, n), generator=gen, device=dev)
    cmat = torch.randn((b, s, n), generator=gen, device=dev)
    got = selective_scan(x1, dt, a, bmat, cmat)
    want = ref.selective_scan_plain(x1, dt, a, bmat, cmat, chunk=SCAN_PLAIN_CHUNK)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= SCAN_TOL * scale,
            f"selective_scan {SCAN_SHAPE}: max |kernel - plain| {err:.3e} at scale {scale:.2f}")
    require(torch.equal(got, selective_scan(x1, dt, a, bmat, cmat)),
            "selective_scan gave other bits on a rerun")
    log(f"[kernels] selective_scan B={b} S={s} di={di} n={n} x1 bf16: max |kernel - plain| "
        f"{err:.3e} at scale {scale:.3f} ({err / scale:.2e} of it, tolerance {SCAN_TOL}), rerun "
        f"bit-equal; plain at chunk {SCAN_PLAIN_CHUNK}")
    del want
    lib = build.library("selective_scan")
    plan = {}
    for gated in (0, 1):
        buf = (ctypes.c_int * 5)()
        build.check(lib.selective_scan_occupancy(0, 1, gated, n, buf), "selective_scan_occupancy")
        plan["gated" if gated else "scan"] = list(buf)
    counts = scan_probe.sass_counts(build.library_path("selective_scan"), n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floors = {entry: round(scan_probe.issue_floor_ms(SCAN_SHAPE, c["per_position"], sms), 4)
              for entry, c in counts.items() if c}
    sass = {e: {k: round(v, 2) for k, v in c.items()} for e, c in counts.items()}
    log(f"[kernels] selective_scan plan (bf16, n={n}) [blocks an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs, shared bytes, threads, channels "
        f"a unit]: {plan}; SASS of the loop over positions {sass or 'not counted (no cuobjdump)'}; "
        f"issue floor at {scan_probe.INSTRS_PER_CLOCK} a clock per SM, {scan_probe.CLOCK_HZ / 1e6:.0f} "
        f"MHz: {floors or 'not measured'} ms")
    b_ms, b_by = _selective_scan_bound(b, s, di, n, x1.element_size())
    row = _scan_row(f"selective_scan B={b} S={s} di={di} n={n}",
                    lambda: selective_scan(x1, dt, a, bmat, cmat),
                    lambda: ref.selective_scan_plain(x1, dt, a, bmat, cmat,
                                                     chunk=SCAN_PLAIN_CHUNK), b_ms, b_by, err)
    row["issue_floor_ms"] = floors.get("scan")
    del dt, got
    torch.cuda.empty_cache()

    z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(torch.bfloat16)[..., di:]
    dt_raw = torch.randn((b, s, di), generator=gen, device=dev)
    dt_bias = torch.randn((di,), generator=gen, device=dev) * 0.1
    dd = torch.randn((di,), generator=gen, device=dev)
    args = (x1, z, dt_raw, dt_bias, a, bmat, cmat, dd)
    fused = lambda: selective_scan_gated(*args, torch.bfloat16)
    chain = lambda: ref.selective_scan_gated_plain(*args, torch.bfloat16, scan=selective_scan)
    got, want = fused(), chain()
    require(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()),
            "selective_scan_gated: output not finite bf16")
    require(torch.equal(got, want), f"selective_scan_gated {SCAN_SHAPE}: max |fused - chain| "
                                    f"{float((got.float() - want.float()).abs().max()):.3e}")
    require(torch.equal(got, fused()), "selective_scan_gated gave other bits on a rerun")
    del got, want
    g_ms, g_by = _gated_scan_bound(b, s, di, n, x1.element_size())
    ms = time_ms(fused, reps=10)
    chain_ms = time_ms(chain, reps=3, warmup=1)
    row["gated"] = dict(ms=ms, chain_ms=chain_ms, bound_ms=g_ms, bound_by=g_by, max_abs_err=0.0,
                        issue_floor_ms=floors.get("gated"))
    log(f"[kernels] selective_scan_gated B={b} S={s} di={di} n={n} bf16 x1, z and output: equal "
        f"to the unfused chain (ref.softplus, the scan kernel, skip, gate, cast) bit for bit, "
        f"rerun bit-equal; fused {ms:.4f} ms, the chain {chain_ms:.4f} ms ({chain_ms / ms:.2f}x); "
        f"bound {g_ms:.4f} ms ({g_by}); SM clock, power after it: {card_state()}; {row['gated']}")
    del x1, z, dt_raw, dt_bias, a, bmat, cmat, dd, args
    torch.cuda.empty_cache()
    return row


def _kernel_slstm_scan(seed: int) -> dict:
    """slstm_scan against its plain version at SLSTM_SHAPE (bf16 xproj, wr
    at the model's initial scale 1/sqrt(uh), a random bias), equal bits on
    a rerun; bound by the recurrent product's float32 operations at 67
    TFLOP/s against its bytes."""
    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import slstm_scan as SS
    from repro_torch.kernels.slstm_scan import slstm_scan

    b, s, hh, uh = SLSTM_SHAPE
    d = hh * uh
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn((b, s, 4 * d), generator=gen, device=dev).to(torch.bfloat16)
    wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(torch.bfloat16)
    bias = (torch.randn((4 * d,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    got = slstm_scan(xproj, wr, bias)
    want = ref.slstm_scan_plain(xproj, wr, bias)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= SCAN_TOL * scale,
            f"slstm_scan {SLSTM_SHAPE}: max |kernel - plain| {err:.3e} at scale {scale:.2f}")
    require(torch.equal(got, slstm_scan(xproj, wr, bias)), "slstm_scan gave other bits on a rerun")
    log(f"[kernels] slstm_scan B={b} S={s} H={hh} uh={uh} bf16: max |kernel - plain| {err:.3e} "
        f"at scale {scale:.3f} ({err / scale:.2e} of it, tolerance {SCAN_TOL}), rerun bit-equal")
    p = SS.card_plan(0, 1, 1, b, hh, uh)
    resident = build.library(SS.NAME).slstm_scan_max_clusters(0, 1, 1, b, hh, uh, p.cluster,
                                                               p.groups, p.halves, p.smem)
    log(f"[kernels] slstm_scan plan {p}: {hh * p.groups} clusters of {p.cluster} CTAs, "
        f"{resident} resident at once (cudaOccupancyMaxActiveClusters)")
    del want
    b_ms, b_by = _slstm_scan_bound(b, s, hh, uh, xproj.element_size(), wr.element_size())
    row = _scan_row(f"slstm_scan B={b} S={s} H={hh} uh={uh}",
                    lambda: slstm_scan(xproj, wr, bias),
                    lambda: ref.slstm_scan_plain(xproj, wr, bias), b_ms, b_by, err, plain_reps=1)
    del xproj, wr, bias, got
    torch.cuda.empty_cache()
    return row


# The backward kernels against their plain backwards, float32, of each
# gradient's largest magnitude (phase 11's TRAIN_TOL["float32"]; derived in
# tests/test_torch_ssm_card.py); a bf16 gradient also within one bf16 ulp of
# each element.  The training microbatches: xlstm-350m's 4 rows (phase 14's
# TRAIN_BATCH / TRAIN_MICRO) and jamba's cut's 1 row of 2,048, beside the
# forward rows' 16.
SCAN_GRAD_TOL = 1e-4
SLSTM_BWD_BATCHES = (4, 16)  # the JSON row: the first
SCAN_BWD_BATCHES = (1, 16)  # the JSON row: the first


def _once_ms(fn):
    """``(fn(), its ms)``: one call between CUDA events (a plain backward,
    too slow to time again)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _grads_within(label: str, got, want, names):
    """Each gradient against its plain version within SCAN_GRAD_TOL of its
    scale (bf16 ones also within 2^-7 of each element); returns the largest
    |diff| and the worst |diff| over scale."""
    import torch

    worst = err = 0.0
    for name, g, w in zip(names, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{label}: {name} is not a finite {w.dtype} {tuple(w.shape)}")
        gf, wf = g.float(), w.float()
        scale = max(float(wf.abs().max()), 1e-30)
        diff = (gf - wf).abs()
        slack = SCAN_GRAD_TOL * scale + (2.0 ** -7 * wf.abs() if g.dtype == torch.bfloat16 else 0)
        require(not bool((diff > slack).any()),
                f"{label}: {name} max |kernel - plain| {float(diff.max()):.3e} at scale {scale:.3e}")
        worst = max(worst, float(diff.max()) / scale)
        err = max(err, float(diff.max()))
    return err, worst


def _slstm_bwd_bound(b: int, s: int, hh: int, uh: int, w_bytes: int):
    """slstm_scan_bwd's least ms: the recurrent product's 2 B S H uh 4uh
    float32 operations at 67 TFLOP/s against its bytes (pre, c, n, m, dhs
    and dpre a position and unit, wr)."""
    d = hh * uh
    return bound(48 * b * s * d + w_bytes * hh * uh * 4 * uh, 2 * b * s * hh * uh * 4 * uh)


def _gated_bwd_bound(b: int, s: int, di: int, n: int, x_bytes: int):
    """selective_scan_bwd's least ms (gated): the bytes of the gradient's
    own operands (x1, the raw dt, z, dout, dx1, dz and ddt_raw a position
    and channel; b, c, db and dc a position; a, da, dd, ddd, dt_bias and its
    gradient) at 3.35 TB/s against its B S di n exponentials (each decay
    exp(dt a) once: the walk's decay_t is the recomputed state's) at the
    special-function units' rate.  The states the forward saves for it (n
    bytes a position and channel at one every 4 positions) are the design's
    cost, not the function's, and are not counted."""
    per = 5 * x_bytes + 8
    return bound(per * b * s * di + 16 * b * s * n + 4 * di * (2 * n + 4), b * s * di * n,
                 SFU_OPS_PER_S)


def _kernel_slstm_scan_bwd(seed: int) -> dict:
    """slstm_scan_bwd at xlstm-350m's width (4 heads of 256 units, bf16
    xproj and wr at the model's initial scale) and SLSTM_BWD_BATCHES rows of
    2,048 positions: its gradients from the forward kernel's residuals
    against ref.slstm_scan_bwd_plain's from the plain forward's, within
    SCAN_GRAD_TOL; equal bits on a rerun; the kernel (its dpre) timed beside
    its bound, the plain backward and, as its own line, dwr's float32
    matrix product."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SS
    from repro_torch.kernels.ref import slstm_weight_grads

    _, s, hh, uh = SLSTM_SHAPE
    d = hh * uh
    dev = torch.device("cuda")
    row = None
    for b in SLSTM_BWD_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        xproj = torch.randn((b, s, 4 * d), generator=gen, device=dev).to(torch.bfloat16)
        wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(
            torch.bfloat16)
        bias = (torch.randn((4 * d,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        dhs = torch.randn((b, s, hh, uh), generator=gen, device=dev)
        hs, pre, states = SS.slstm_scan_residuals(xproj, wr, bias)
        got = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
        again = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
        require(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
                f"slstm_scan_bwd B={b}: a rerun gave other bits")
        p_hs, p_pre, p_states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
        plain = lambda: ref.slstm_scan_bwd_plain(xproj, wr, bias, p_pre, p_states, p_hs, dhs)
        want, plain_ms = _once_ms(plain)
        label = f"slstm_scan_bwd B={b} S={s} H={hh} uh={uh} bf16"
        err, rel = _grads_within(label, got, want, ("dxproj", "dwr", "dbias"))
        del got, again, want
        p = SS.card_plan(0, 0, 1, b, hh, uh, backward=True)
        log(f"[kernels] {label}: dxproj, dwr, dbias within {SCAN_GRAD_TOL} of each scale of the "
            f"plain backward (bf16 dxproj also within one bf16 ulp of each element): max "
            f"|diff| {err:.3e}, worst {rel:.2e} of a gradient's scale; rerun bit-equal; plan {p}")
        dpre = SS._launch_bwd(wr, pre, states, dhs).view(b, s, hh, 4 * uh)
        mm_ms = time_ms(lambda: slstm_weight_grads(hs, dpre), reps=10)
        log(f"[kernels] {label}: dwr and dbias (ref.slstm_weight_grads: a float32 torch.matmul "
            f"a head of (uh, B S) by (B S, 4 uh), and a sum) {mm_ms:.4f} ms")
        b_ms, b_by = _slstm_bwd_bound(b, s, hh, uh, wr.element_size())
        r = _scan_row(label + " (the kernel: dpre)", lambda: SS._launch_bwd(wr, pre, states, dhs),
                      plain, b_ms, b_by, err, plain_ms=plain_ms)
        r["weight_grads_ms"] = mm_ms
        row = row or r
        del xproj, wr, bias, dhs, hs, pre, states, p_hs, p_pre, p_states, dpre
        torch.cuda.empty_cache()
    return row


def _kernel_selective_scan_bwd(seed: int) -> dict:
    """selective_scan_gated's backward at jamba-1.5-large's width (di
    16,384, n 16, bf16 x1, z a view of the in_proj output, bf16 dout) and
    SCAN_BWD_BATCHES rows of 2,048 positions: its eight gradients from the
    forward kernel's saved states against
    ref.selective_scan_gated_bwd_plain's, within SCAN_GRAD_TOL; equal bits
    on a rerun; timed beside its bound and the plain backward."""
    import ctypes

    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import selective_scan as SEL

    _, s, di, n = SCAN_SHAPE
    dev = torch.device("cuda")
    row = None
    names = ("dx1", "dz", "ddt_raw", "ddt_bias", "da", "dbmat", "dcmat", "ddd")
    for b in SCAN_BWD_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(seed + 4)
        x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16))
        z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(torch.bfloat16)[..., di:]
        dt_raw = torch.randn((b, s, di), generator=gen, device=dev)
        dt_bias = torch.randn((di,), generator=gen, device=dev) * 0.1
        a = -torch.exp(torch.ones((di, n), device=dev))
        bmat = torch.randn((b, s, n), generator=gen, device=dev)
        cmat = torch.randn((b, s, n), generator=gen, device=dev)
        dd = torch.randn((di,), generator=gen, device=dev)
        dout = torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16)
        args = (x1, z, dt_raw, dt_bias, a, bmat, cmat, dd)
        out, hsave = SEL.selective_scan_states_of(x1, dt_raw, a, bmat, cmat, z, dt_bias, dd)
        require(torch.equal(out, SEL.selective_scan_gated(*args)),
                f"selective_scan_gated B={b}: saving the states changed the output's bits")
        require(torch.equal(hsave, ref.selective_scan_states(x1, ref.softplus(dt_raw + dt_bias),
                                                             a, bmat)),
                f"selective_scan_gated B={b}: the saved states differ from the plain version's")
        del out
        kernel = lambda: SEL.selective_scan_gated_bwd(*args, dout, hsave)
        got, again = kernel(), kernel()
        require(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
                f"selective_scan_bwd B={b}: a rerun gave other bits")
        del again
        plain = lambda: ref.selective_scan_gated_bwd_plain(*args, dout, hsave,
                                                           chunk=SCAN_PLAIN_CHUNK)
        want, plain_ms = _once_ms(plain)
        label = f"selective_scan_bwd (gated) B={b} S={s} di={di} n={n} bf16"
        err, rel = _grads_within(label, got, want, names)
        del got, want
        torch.cuda.empty_cache()
        buf = (ctypes.c_int * 5)()
        build.check(build.library(SEL.BWD_NAME).selective_scan_bwd_occupancy(0, 1, 1, n, buf),
                    "selective_scan_bwd_occupancy")
        log(f"[kernels] {label}: its 8 gradients within {SCAN_GRAD_TOL} of each scale of the "
            f"plain backward (bf16 dx1 and dz also within one bf16 ulp of each element): max "
            f"|diff| {err:.3e}, worst {rel:.2e} of a gradient's scale; rerun bit-equal; saved states (B, {hsave.shape[1]}, "
            f"{n}, {di}) {hsave.numel() * 4 / 1e9:.3f} GB equal to the plain version's; plan "
            f"[blocks an SM, SMs, shared bytes, threads, channels a unit] {list(buf)}")
        b_ms, b_by = _gated_bwd_bound(b, s, di, n, x1.element_size())
        r = _scan_row(label, kernel, plain, b_ms, b_by, err, plain_ms=plain_ms)
        row = row or r
        del x1, z, dt_raw, dt_bias, a, bmat, cmat, dd, dout, args, hsave
        torch.cuda.empty_cache()
    return row


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
# Phase 7: the join templates over TPC-H lineitem, orders and part
# ---------------------------------------------------------------------------

# Phases 7 and 8b: benchmarks/common.py's "full" scale (ROWS["full"], the
# lineitem rows its make_tpch gets).  Scale factor 1 (6,001,215 rows) took
# 197-216 s in phase 7 and 270-289 s in 8b's TPC-H mix (most of the latter
# in the maintainer's host build) and put the script past its time limit.
TPCH_LINEITEM = 1_000_000
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
# keep the script inside its limit: 8b's TPC-H misses are slow on the host;
# and from 3 to 2 when phase 14 came).
STRATEGY_QUERIES, STRATEGY_SEED = 2, 33
STARS_ROWS = ROWS  # 8b's stars table: generated, at the crimes row count
# 8b: benchmarks/bench_fig9_endtoend.py's draw (its 8 unique queries at seed
# 9, cut to 4 when phase 14 came; runs picked by default_rng(9).integers),
# n_repeat cut from 5 to 3.
FIG9_UNIQUE, FIG9_REPEAT, FIG9_SEED = 4, 3, 9
FIG9_STRATEGIES = ("NO-PS", "RAND-PK", "RAND-GB", "CB-OPT-GB")
# 8c: two of the four two-attribute group-bys since phase 14 came.
COMPOSITE_GROUPBYS = (("district", "year"), ("community", "month"))
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
                     n_lineitem: int = TPCH_LINEITEM, stars_rows: int = STARS_ROWS,
                     n_queries: int = STRATEGY_QUERIES, device: str = "cuda") -> dict:
    """Every selection strategy of the paper end to end.  8a: a fresh
    ``PBDSEngine`` (100 ranges, theta 0.05) for NO-PS and each of
    ``ALL_STRATEGIES`` over ``n_queries`` generated crimes queries and their
    replay, and one ``run_batch`` burst under RAND-GB; 8b: Fig. 9's mix
    (NO-PS, RAND-PK, RAND-GB, CB-OPT-GB over TPC-H ``lineitem`` and stars,
    12 runs of 4 queries); 8c: two two-attribute Q-AGH queries through
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
                                                                                   noisy)[0]))
        perturbed = torch.einsum("bd,dv->bv", hn[:, -1], params["lm_head"]).float()
    log(f"[serve] f32 layer by layer ({cfg.n_layers} layers, B={b}, S={s}): max |diff| / scale "
        f"kernel vs plain attention {worst['kernel vs plain']:.2e}, decode vs prefill "
        f"{worst['decode vs prefill']:.2e} (tolerance {SERVE_TOL})")
    log(f"[serve] f32 end-to-end logits (up to {float(plain.abs().max()):.2f}): kernel vs plain "
        f"max |diff| {float((logits - plain).abs().max()):.3e}; plain vs plain with the "
        f"embeddings perturbed by 1e-6 relative {float((perturbed - plain).abs().max()):.3e}")


def _layerwise_check_bf16(cfg, params, tokens, ffn=None, label: str = "[serve]") -> float:
    """Bf16 prefill of ``tokens`` through every layer of ``cfg`` (the
    serving weights): at each layer, on that layer's input, attention through
    the tensor-core kernel against the plain chunked loop, within
    SERVE_TOL_BF16 of the layer's scale; ``ffn(i, p, x)`` gives layer i's
    FFN output (``mlp`` when None).  Returns the worst error over scale."""
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
                        f"{label} layer {i}.{j} bf16 kernel vs plain: max |diff| {err:.3e} at "
                        f"scale {scale:.1f}")
                h = L.mlp(p["ffn"], cfg, got) if ffn is None else ffn(i, p["ffn"], got)
    log(f"{label} bf16 layer by layer ({cfg.n_layers} layers, B={tokens.shape[0]}, "
        f"S={tokens.shape[1]}): max |diff| / scale kernel vs plain attention {worst:.2e} "
        f"(tolerance {SERVE_TOL_BF16})")
    return worst


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
    from repro_torch.launch.serve import admit_requests, serve
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

    # 4. A long prompt in bf16: its admission and one prefill of 2,048 tokens,
    # 24 launches (prefill only: serve()'s 2,063 teacher-forced decode steps
    # through it took about 90 s and checked only their finiteness).
    long_prompt, _ = admit_requests(cfg, requests=SERVE_REQUESTS, prompt_len=LONG_PROMPT,
                                    seed=seed, n_docs=SERVE_DOCS)
    before = LAUNCH_COUNTS["flash_attention"]
    before_tc, before_copies = LAUNCH_COUNTS[TC_COUNTER], LAUNCH_COUNTS[COPY_COUNTER]
    with torch.inference_mode():
        long_logits = lm.prefill(params, cfg, {"tokens": long_prompt})
        torch.cuda.synchronize()
    long_launches = LAUNCH_COUNTS["flash_attention"] - before
    long_tc = LAUNCH_COUNTS[TC_COUNTER] - before_tc
    long_copies = LAUNCH_COUNTS[COPY_COUNTER] - before_copies
    finite = long_logits.shape == (SERVE_REQUESTS, cfg.vocab_p) and bool(
        torch.isfinite(long_logits).all())
    log(f"[serve] long prompt (prefill only): flash_attention launches {long_launches} "
        f"({long_tc} tensor-core, {long_copies} aligned copies), finite logits {finite}")
    require(finite, "long-prompt logits are not finite")
    require(long_launches == cfg.n_layers and long_tc == cfg.n_layers and long_copies == 0,
            f"a 2048-token prefill launched flash_attention {long_launches} times "
            f"({long_tc} tensor-core, {long_copies} copies)")

    # 5. Bf16 layer by layer on the serving weights, at both prompts.
    for tokens in (res.prompt, long_prompt):
        _layerwise_check_bf16(cfg, params, tokens)

    # Warm prefill times (CUDA events; the serve() walls above include first calls).
    with torch.inference_mode():
        for tokens in (res.prompt, long_prompt):
            ms = time_ms(lambda: lm.prefill(params, cfg, {"tokens": tokens}), reps=5, warmup=1)
            log(f"[serve] warm bf16 prefill B={tokens.shape[0]} S={tokens.shape[1]}: {ms:.2f} ms "
                f"({tokens.numel() / ms * 1e3:.0f} tok/s)")
        # The kernel's share: one layer's attention call at this prefill's shapes.
        p0 = lm._period_slice(params["periods"], 0)["b0"]["mixer"]
        x = lm._embed(cfg, params, long_prompt)
        q, k, v = L._qkv(p0, cfg, L.rmsnorm(p0["ln"], x))
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
        ms = time_ms(lambda: L.gqa_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk))
        log(f"[serve] flash_attention in the 2,048-token prefill: {ms:.3f} ms a layer, "
            f"{ms * cfg.n_layers:.1f} ms over {cfg.n_layers} layers")
    log(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"phase done in {time.perf_counter() - t_phase:.1f} s")
    del params, res, long_prompt, long_logits
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: training stablelm-1.6b at full width and depth
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_SAVE = 8, LONG_PROMPT, 2, 6, 3
TRAIN_DOCS, TRAIN_QUALITY = 20_000, 0.55  # launch/train.py's curation
TRAIN_PARAMS = 1.645e9  # stablelm-1.6b, for mfu = 6 N tokens / (wall * 989 TFLOP/s)
# Per layer, relative to the gradient's scale: the kernels' gradients against
# the plain chunked loop's autograd on the same input (FLASH_TOL's bounds).
TRAIN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Check (f): the CLI fresh for 4 steps with a checkpoint every 2, then resumed to 6.
TRAIN_CLI = {"fresh": ("--smoke", "--steps", "4", "--ckpt-every", "2"),
             "resume": ("--smoke", "--steps", "6", "--ckpt-every", "2", "--resume")}


def _layer_grads(cfg, p, h, dy, window: int):
    """Gradients of ``attention_train(p, h)`` against ``dy``, w.r.t. h and
    every attention parameter, through whatever ``gqa_chunked`` is bound to."""
    import torch

    from repro_torch.models import layers as L

    leaves_ = {"x": h.detach().requires_grad_(), "ln": p["ln"]["scale"].detach().requires_grad_()}
    leaves_.update({k: v.detach().requires_grad_() for k, v in p.items() if k != "ln"})
    tree = {**{k: v for k, v in leaves_.items() if k not in ("x", "ln")},
            "ln": {"scale": leaves_["ln"]}}
    with torch.enable_grad():
        y = L.attention_train(tree, cfg, leaves_["x"], window=window)
        grads = torch.autograd.grad(y, list(leaves_.values()), dy)
    return dict(zip(leaves_, grads))


def _train_layerwise_check(cfg, params, tokens) -> dict:
    """Check (b): at every layer, on that layer's own input, the gradients of
    its attention (w.r.t. the input and the attention parameters) through the
    kernels against the plain chunked loop, within TRAIN_TOL of each
    gradient's scale: the bf16 weights, then float32 copies.  The random
    model is chaotic, so each layer is held on its own input."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import BWD_NAME
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    worst = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        ps = params if dtype == cfg.dtype else params.map(lambda x: x.to(torch.float32))
        gen = torch.Generator(device=tokens.device).manual_seed(11)
        before = LAUNCH_COUNTS[BWD_NAME]
        worst[dtype] = 0.0
        with torch.no_grad():
            h = lm._embed(c, ps, tokens)
        for i, pp in enumerate(lm._period_slices(ps["periods"], c.n_periods)):
            for j, (mixer, _) in enumerate(c.pattern):
                p = pp[f"b{j}"]
                window = c.sliding_window if mixer == "swa" else 0
                dy = torch.randn(h.shape, generator=gen, device=h.device).to(h.dtype)
                got = _layer_grads(c, p["mixer"], h, dy, window)
                want = _plain_attention(lambda: _layer_grads(c, p["mixer"], h, dy, window))
                for name, g in got.items():
                    w = want[name].float()
                    scale = float(w.abs().max())
                    err = float((g.float() - w).abs().max())
                    worst[dtype] = max(worst[dtype], err / scale)
                    require(bool(torch.isfinite(g).all()) and err <= TRAIN_TOL[dtype] * scale,
                            f"layer {i}.{j} {dtype} attention gradient {name}: max |diff| "
                            f"{err:.3e} at scale {scale:.3e}")
                with torch.no_grad():
                    h = L.mlp(p["ffn"], c, L.attention_train(p["mixer"], c, h, window=window))
        require(LAUNCH_COUNTS[BWD_NAME] - before == c.n_layers,
                f"{dtype}: the layer check ran the backward kernel "
                f"{LAUNCH_COUNTS[BWD_NAME] - before} times, expected {c.n_layers}")
        del ps
        torch.cuda.empty_cache()
    log(f"[train] attention gradients layer by layer ({cfg.n_layers} layers, "
        f"B={tokens.shape[0]}, S={tokens.shape[1]}): max |diff| / scale kernels vs plain "
        f"{worst['bfloat16']:.2e} (bf16 weights), {worst['float32']:.2e} (f32 copies); "
        f"tolerances {TRAIN_TOL}")
    return worst


def _cli(args, ckpt: str, device: str) -> "subprocess.Popen":
    """``python -m repro_torch.launch.train`` on ``device``, as a process."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args,
                             "--ckpt", ckpt, "--device", device], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _cli_chain(ckpt: str, device: str, arch: str = SERVE_ARCH) -> dict:
    """Check (f), run beside the checkpoint's IO: TRAIN_CLI's runs of
    ``arch`` in turn; returns each run's exit code, output and wall."""
    out = {}
    for label, args in TRAIN_CLI.items():
        t0 = time.perf_counter()
        proc = _cli(("--arch", arch, *args), ckpt, device)
        text, _ = proc.communicate(timeout=600)
        out[label] = (proc.returncode, text, time.perf_counter() - t0)
    return out


def _check_cli(runs: dict, arch: str = SERVE_ARCH, tag: str = "[train]") -> None:
    for label, (rc, text, wall) in runs.items():
        lines = [ln for ln in text.splitlines() if ln.startswith("[train]")]
        log(f"{tag} CLI {label} (exit {rc}, {wall:.1f} s): " + " | ".join(lines))
        require(rc == 0, f"the training CLI ({label}) exited {rc}:\n{text[-3000:]}")
        require(len(lines) >= 4 and lines[0].startswith(f"[train] arch={arch}-smoke params=")
                and lines[1].startswith("[train] curation: strategy=")
                and lines[-1].startswith("[train] done: loss "),
                f"the training CLI ({label}) printed other lines than the reference's")
    fresh = [ln for ln in runs["fresh"][1].splitlines() if ln.startswith("[train]")]
    resumed = [ln for ln in runs["resume"][1].splitlines() if ln.startswith("[train]")]
    require(any(ln.startswith("[train] step=0 ") for ln in fresh)
            and fresh[-1].endswith("ckpts=[2, 4]"), "the fresh CLI run's steps or checkpoints")
    require(resumed[2] == "[train] resumed from step 4"
            and any(ln.startswith("[train] step=5 ") for ln in resumed)
            and resumed[-1].endswith("ckpts=[2, 4, 6]"), "the resumed CLI run did not resume")


def _train_curation(cfg, seed: int, batch: int, seq: int, dev, tag: str):
    """Check (a) of a training phase: curation as launch/train.py runs it,
    on ``dev``, against the CPU pipeline and a plain numpy evaluation of the
    query.  Returns the pipeline and curation's launches by kernel."""
    import numpy as np

    from repro_torch.data import pipeline
    from repro_torch.device import to_host
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    for name in BUILT:
        LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    meta = pipeline.make_corpus_metadata(n_docs=TRAIN_DOCS, seed=seed, device=dev)
    spec_c = pipeline.CurationSpec(having_value=TRAIN_QUALITY)
    pipe = pipeline.SketchedDataPipeline(meta, spec_c, batch, seq, cfg.vocab_size, seed=seed,
                                         device=dev)
    t_cur = time.perf_counter() - t0
    curation = {name: LAUNCH_COUNTS[name] for name in BUILT}
    ri = pipe.run_info
    log(f"{tag} curation: strategy={ri.strategy} attr={ri.attr} created={ri.created} "
        f"skipped={pipe.skipped_fraction:.1%} of {TRAIN_DOCS} docs "
        f"({len(pipe.selected_docs)} admitted) in {t_cur:.2f} s; launches {curation}")
    # The corpus is clustered (fragment-major), so the load is a slice of
    # the surviving fragments: sketch_filter runs only on unclustered tables.
    for name in ("segment_aggregate", "fragment_bitmap"):
        require(curation[name] > 0, f"curation did not launch {name}")
    cpu_meta = pipeline.make_corpus_metadata(n_docs=TRAIN_DOCS, seed=seed, device="cpu")
    cpu_pipe = pipeline.SketchedDataPipeline(cpu_meta, spec_c, batch, seq, cfg.vocab_size,
                                             seed=seed, device="cpu")
    plain = _plain_admitted({a: to_host(cpu_meta[a]) for a in cpu_meta.schema}, spec_c)
    require(np.array_equal(pipe.selected_docs, cpu_pipe.selected_docs),
            "the card admitted other docs than the CPU pipeline")
    require(bool(np.isin(plain, pipe.selected_docs).all()),
            "the sketch dropped docs the curation query selects")
    log(f"{tag} (a) admitted docs equal the CPU pipeline's and contain all {len(plain)} "
        f"of the plain query's")
    return pipe, curation


def _train_state(cfg, seed: int, batch: int, seq: int, dev, tag: str):
    """A training phase's TrainSpec (TRAIN_MICRO microbatches, AdamW over
    TRAIN_STEPS) and state: ``cfg.dtype`` parameters, f32 master, m and v."""
    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import TrainSpec, init_train_state

    spec = TrainSpec(microbatch=TRAIN_MICRO, opt=OptConfig(total_steps=TRAIN_STEPS))
    t0 = time.perf_counter()
    state = init_train_state(cfg, spec, seed=seed, device=dev)
    torch.cuda.synchronize()
    state_gb = sum(x.numel() * x.element_size() for x in tree_leaves(state)) / 1e9
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, remat={cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}; state {state_gb:.2f} GB made in {time.perf_counter() - t0:.2f} s; "
        f"batch {batch} x {seq} tokens in {TRAIN_MICRO} microbatches")
    return spec, state


def _first_microbatch(cfg, pipe, seq: int, dev) -> dict:
    """The pipeline's first batch in TRAIN_MICRO microbatches; the pipeline
    is left at its start."""
    from repro_torch.launch.train import make_batch_for
    from repro_torch.train.step import microbatch_reshape

    pipe.restore({"cursor": 0, "epoch": 0})
    first = microbatch_reshape(make_batch_for(cfg, next(iter(pipe)), seq, dev), TRAIN_MICRO)
    pipe.restore({"cursor": 0, "epoch": 0})
    return first


def _start_cli(cli_dir, device: str, arch: str):
    """Check (f)'s CLI runs of ``arch`` in a thread: (the thread, the dict
    its results go into)."""
    import threading

    cli = {}
    thread = threading.Thread(target=lambda: cli.update(_cli_chain(str(cli_dir), device, arch)))
    thread.start()
    return thread, cli


def _train_run(tag: str, cfg, spec, box: list, pipe, batch: int, seq: int, device: str,
               mfu_params: float, paths, check_launches, ckpt_dir, cli_dir, arch: str,
               t_phase: float, cli=None) -> dict:
    """Checks (c)-(f) of a training phase: TRAIN_STEPS steps of ``box``'s
    one state (taken out of it) from ``pipe`` with an async checkpoint after
    step TRAIN_SAVE; ``check_launches(launches, kinds)`` on the straight
    run's launches by kernel and by the counters ``paths`` (check (e)); the
    CLI of ``arch``'s smoke config fresh and resumed as processes beside the
    checkpoint's IO and the restore (f; ``cli``, a :func:`_start_cli`
    started earlier, instead); the restore and the steps after it
    again, whose losses, grad norms and every leaf must equal the straight
    run's bit for bit (c); every loss and grad norm finite (d).  ``mfu`` =
    6 ``mfu_params`` tokens / (wall x 989 TFLOP/s).  Returns the straight
    run's launches by kernel."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import host_copy
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.launch.train import make_batch_for
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime.guards import LAUNCH_COUNTS
    from repro_torch.train.step import make_train_step, microbatch_reshape

    dev = torch.device(device)
    state = box.pop()
    step_fn = make_train_step(cfg, spec)
    tokens = batch * seq
    pipe.restore({"cursor": 0, "epoch": 0})
    it = iter(pipe)

    def run_step(label, i, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        raw = next(it)
        batch_ = microbatch_reshape(make_batch_for(cfg, raw, seq, dev), TRAIN_MICRO)
        st, met = step_fn(st, batch_)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        wall = time.perf_counter() - t
        mfu = 6 * mfu_params * tokens / (wall * BF16_OPS_PER_S)
        log(f"{tag} {label} step {i}: wall {wall * 1e3:.1f} ms, {tokens / wall:.0f} tok/s, "
            f"loss {loss:.6f}, grad_norm {gnorm:.6f}, lr {float(met['lr']):.3e}, mfu {mfu:.4f}")
        return st, (loss, gnorm, wall)

    # (c) The straight run, with the step-3 checkpoint saved async.
    ckpt_bytes = sum(x.numel() * max(4, x.element_size()) for x in tree_leaves(state))
    for name in (*BUILT, *paths):
        LAUNCH_COUNTS[name] = 0
    straight = []
    ckpt = CheckpointManager(str(ckpt_dir), keep=2)
    for i in range(TRAIN_STEPS):
        state, rec = run_step("straight", i, state)
        straight.append(rec)
        if i + 1 == TRAIN_SAVE:
            free = shutil.disk_usage(ckpt_dir).free
            require(free >= 1.5 * ckpt_bytes, f"{free / 1e9:.1f} GB free for a "
                                              f"{ckpt_bytes / 1e9:.1f} GB checkpoint")
            ckpt.save(TRAIN_SAVE, state, extra={"step": TRAIN_SAVE, "pipeline": pipe.state()})
            log(f"{tag} save({TRAIN_SAVE}): host snapshot of {ckpt_bytes / 1e9:.2f} GB in "
                f"{ckpt.last_snapshot_s:.2f} s ({free / 1e9:.1f} GB free); the IO runs behind "
                f"the next steps")
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    check_launches(launches, {name: LAUNCH_COUNTS[name] for name in paths})

    # (f) The CLI, beside the checkpoint's IO and the restore.
    cli_thread, cli = cli or _start_cli(cli_dir, device, arch)

    t = time.perf_counter()
    ckpt.wait()
    log(f"{tag} save({TRAIN_SAVE}) IO: {ckpt.last_io_s:.2f} s ({time.perf_counter() - t:.2f} s "
        f"of it waited for after step {TRAIN_STEPS - 1})")
    t = time.perf_counter()
    final = [host_copy(x) for x in tree_leaves(state)]
    log(f"{tag} the straight run's final state to the host in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    resumed, extra = ckpt.restore(state, step=TRAIN_SAVE)
    del state
    torch.cuda.synchronize()
    log(f"{tag} restore({TRAIN_SAVE}) into the live structure in {time.perf_counter() - t:.2f} s")
    require(extra["step"] == TRAIN_SAVE, f"the checkpoint's extra says step {extra['step']}")
    pipe.restore(extra["pipeline"])
    it = iter(pipe)
    cli_thread.join()
    _check_cli(cli, arch, tag)

    again = []
    for i in range(TRAIN_SAVE, TRAIN_STEPS):
        resumed, rec = run_step("resumed", i, resumed)
        again.append(rec)
    for i, (a, b) in enumerate(zip(straight[TRAIN_SAVE:], again)):
        require(a[:2] == b[:2], f"step {TRAIN_SAVE + i}: resumed loss/grad_norm {b[:2]} differ "
                                f"from the straight run's {a[:2]}")
    t = time.perf_counter()
    leaves_ = tree_leaves(resumed)
    for j, (want, got) in enumerate(zip(final, leaves_)):
        w = torch.from_numpy(want).to(dev)
        require(torch.equal(got.to(w.dtype), w), f"leaf {j} of the resumed state differs from "
                                                 f"the straight run's")
        del w
    log(f"{tag} (c) resumed steps {TRAIN_SAVE}-{TRAIN_STEPS - 1}: losses, grad norms and all "
        f"{len(leaves_)} leaves (params, master, m, v, step) equal the straight run's bit for "
        f"bit (compared in {time.perf_counter() - t:.2f} s)")
    all_steps = straight + again
    require(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in all_steps),
            "a loss or grad norm is not finite")
    require(int(resumed["opt"]["step"]) == TRAIN_STEPS, f"opt.step is "
                                                        f"{int(resumed['opt']['step'])}")
    log(f"{tag} (d) every loss and grad norm finite, opt.step {TRAIN_STEPS}; losses "
        f"{[round(r[0], 4) for r in straight]}")
    warm = [r[2] for r in straight[1:]]
    log(f"{tag} warm step wall median {sorted(warm)[len(warm) // 2] * 1e3:.1f} ms "
        f"({tokens / sorted(warm)[len(warm) // 2]:.0f} tok/s); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    del resumed, final, leaves_
    for d in (ckpt_dir, cli_dir):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_train(seed: int = 0, cfg=None, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                device: str = "cuda") -> dict:
    """Train stablelm-1.6b at full width and depth on the card (checks (a)-(f)
    of the phase); returns the training path's launches: the straight run's
    six steps and the curation before them.  ``cfg``, ``batch``, ``seq`` and
    ``device`` serve a rehearsal on the CPU at a small size (``cuda``
    calls stubbed, launch checks lenient: no kernel launches off the card)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (BWD_COPY_COUNTER, BWD_NAME, BWD_TC_COUNTER,
                                                     COPY_COUNTER, NAME as FWD_NAME, TC_COUNTER)
    from repro_torch.models import lm
    from repro_torch.models.params import leaves, tree_leaves, tree_unflatten

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or get_config(SERVE_ARCH)
    dev = torch.device(device)
    ckpt_dir = ROOT / "build" / "phase11_ckpt"
    cli_dir = ROOT / "build" / "phase11_cli_ckpt"
    for d in (ckpt_dir, cli_dir):
        shutil.rmtree(d, ignore_errors=True)

    # (a) Curation as launch/train.py runs it, on the card.
    pipe, curation = _train_curation(cfg, seed, batch, seq, dev, "[train]")

    spec, state = _train_state(cfg, seed, batch, seq, dev, "[train]")

    # (b) Attention gradients layer by layer, on the first microbatch.
    t0 = time.perf_counter()
    first = _first_microbatch(cfg, pipe, seq, dev)
    _train_layerwise_check(cfg, state["params"], first["tokens"][0])
    log(f"[train] (b) done in {time.perf_counter() - t0:.1f} s")
    # Where the random model's gradient norm comes from: the first
    # microbatch's gradients through the kernels, through the plain loop
    # (forward and backward, the recomputation included) and through the
    # kernels on float32 copies of the weights.
    def grad_norms(c, params):
        flat = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with torch.enable_grad():
            loss = lm.loss_fn(tree_unflatten(params, flat, dicts=True), c,
                              {"tokens": first["tokens"][0]})
            grads = torch.autograd.grad(loss, flat)
        return float(loss.detach()), {"/".join(path): float(torch.linalg.vector_norm(g.float()))
                                      for (path, _), g in zip(leaves(params), grads)}

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for label, run in (("kernels", lambda: grad_norms(cfg, state["params"])),
                       ("plain loop", lambda: _plain_attention(
                           lambda: grad_norms(cfg, state["params"]))),
                       ("kernels, f32 copies", lambda: grad_norms(
                           cfg32, state["params"].map(lambda x: x.to(torch.float32))))):
        loss, per = run()
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        log(f"[train] microbatch 0 through the {label}: loss {loss:.6f}, grad norm "
            f"{float(np.sqrt(sum(v * v for v in per.values()))):.4e}; largest leaves "
            + ", ".join(f"{k} {v:.3e}" for k, v in top))
        torch.cuda.empty_cache()
    del first

    paths = (TC_COUNTER, COPY_COUNTER, BWD_TC_COUNTER, BWD_COPY_COUNTER)

    def check_launches(launches, kinds):
        log(f"[train] (e) of them: tensor-core forward {kinds[TC_COUNTER]}, tensor-core backward "
            f"{kinds[BWD_TC_COUNTER]}; aligned copies forward {kinds[COPY_COUNTER]}, backward "
            f"{kinds[BWD_COPY_COUNTER]}")
        if cfg.dtype == "bfloat16":
            require(kinds[TC_COUNTER] == launches[FWD_NAME]
                    and kinds[BWD_TC_COUNTER] == launches[BWD_NAME],
                    f"bf16 training ran other than the tensor-core kernels: {kinds}")
        require(kinds[COPY_COUNTER] == 0 and kinds[BWD_COPY_COUNTER] == 0,
                f"the training path's views were copied for TMA: {kinds}")
        per_step = {FWD_NAME: cfg.n_layers * TRAIN_MICRO * 2, BWD_NAME: cfg.n_layers * TRAIN_MICRO}
        log(f"[train] (e) launches over {TRAIN_STEPS} steps {launches}; a step: forward "
            f"{launches[FWD_NAME] / TRAIN_STEPS:g} (remat recompute included), backward "
            f"{launches[BWD_NAME] / TRAIN_STEPS:g}")
        for name, n in per_step.items():
            require(launches[name] == n * TRAIN_STEPS,
                    f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, expected "
                    f"{n * TRAIN_STEPS}")

    box = [state]
    del state  # the run holds the only reference: the restore replaces it
    launches = _train_run("[train]", cfg, spec, box, pipe, batch, seq, device, TRAIN_PARAMS,
                          paths, check_launches, ckpt_dir, cli_dir, SERVE_ARCH, t_phase)
    launches.update({name: launches[name] + curation[name] for name in curation})
    return launches


# ---------------------------------------------------------------------------
# Phase 12: MoE serving, qwen2-moe-a2.7b at full width and depth
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CUT_ARCH, MOE_CUT_PERIODS = "qwen3-moe-30b-a3b", 2  # 2 of its 48 periods
# Bf16, relative to the layer output's scale: moe against moe_plain on the
# same input.  The picks, kept slots and aux are equal, and both copy each
# token into its slots exactly, so the outputs part only where (a) the
# expert products, cuBLAS calls over moe's expert-major slots and over
# moe_plain's one-hot layout, round an element apart, and (b) the combine's
# float32 sums of at most k terms, in other orders, round to bf16 apart:
# one bf16 ulp (2^-7 of a value at most) each, carried unchanged through the
# shared expert's and the residual's adds (rounding is monotone).  So two
# ulps, 2^-6 = 1.56e-2, under SERVE_TOL_BF16.
MOE_TOL_BF16 = 2.0 ** -6
MOE_CHECK_LAYERS = (0, -1)  # the long prompt's moe vs moe_plain layers


def _moe_route_stats(cfg, r) -> tuple:
    """(share of the real positions' picks dropped by capacity, mean distinct
    experts the B rows pick at one position: a decode step's expert reads)."""
    b, k = r.idx.shape[0], cfg.experts_per_token
    keep = r.keep.reshape(b, -1, k)[:, :r.s]
    mask = r.mask.reshape(b, -1, cfg.experts_p)[:, :r.s]
    distinct = float(mask.amax(dim=0).sum(dim=-1).float().mean())
    return 1.0 - float(keep.float().mean()), distinct


def _moe_against_plain(cfg, p, x, label: str) -> float:
    """moe against moe_plain on one layer's FFN input ``x``: equal picks,
    kept slots and aux, the output within MOE_TOL_BF16 of its scale; returns
    the error over the scale."""
    import torch

    from repro_torch.models import layers as L

    h = L.rmsnorm(p["ln"], x)
    _, r = L.moe_route(p, cfg, h)
    _, rp = L.moe_route_plain(p, cfg, h)
    require(torch.equal(r.idx, rp.idx), f"{label}: moe picks other experts than moe_plain")
    require(torch.equal(r.keep, rp.keep)
            and torch.equal(torch.where(r.keep, r.pos, -1), torch.where(rp.keep, rp.pos, -1)),
            f"{label}: moe keeps other slots than moe_plain")
    y, aux = L.moe(p, cfg, x)
    yp, auxp = L.moe_plain(p, cfg, x)
    require(torch.equal(aux, auxp), f"{label}: aux {float(aux)} against moe_plain's {float(auxp)}")
    scale = float(yp.float().abs().max())
    err = float((y.float() - yp.float()).abs().max())
    require(bool(torch.isfinite(y).all()) and err <= MOE_TOL_BF16 * scale,
            f"{label}: moe vs moe_plain max |diff| {err:.3e} at scale {scale:.1f}")
    return err / scale


def _moe_layerwise(cfg, params, tokens, label: str, plain_layers=None) -> dict:
    """:func:`_layerwise_check_bf16` over an MoE config, whose FFN at each
    layer, on that layer's own input, is held against moe_plain (at
    ``plain_layers``, every layer if None); returns each layer's dropped
    share and distinct experts a position (:func:`_moe_route_stats`)."""
    from repro_torch.models import layers as L

    n = cfg.n_periods
    check = set(range(n)) if plain_layers is None else {i % n for i in plain_layers}
    out = {"worst": 0.0, "dropped": [], "distinct": []}

    def ffn(i, p, x):
        _, r = L.moe_route(p, cfg, L.rmsnorm(p["ln"], x))
        dropped, distinct = _moe_route_stats(cfg, r)
        out["dropped"].append(dropped)
        out["distinct"].append(distinct)
        out["cap"] = r.cap
        if i in check:
            out["worst"] = max(out["worst"], _moe_against_plain(cfg, p, x, f"{label} layer {i}"))
        return L.moe(p, cfg, x)[0]

    _layerwise_check_bf16(cfg, params, tokens, ffn=ffn, label=f"[moe] {label}")
    log(f"[moe] {label} moe vs moe_plain (capacity {out['cap']}) max |diff| / scale "
        f"{out['worst']:.2e} over layers {sorted(check)} (tolerance {MOE_TOL_BF16}); picks, "
        f"kept slots and aux equal")
    log(f"[moe] {label} share of routed picks dropped by capacity by layer: "
        f"{' '.join(f'{x:.4f}' for x in out['dropped'])} (mean {sum(out['dropped']) / n:.4f})")
    return out


def _decode_bound_ms(cfg, params, distinct, batch: int, mean_t: float) -> tuple:
    """The least ms of one decode step at 3.35 TB/s: every non-expert weight
    but the embedding table read once (the B embedding rows instead), the
    keys and values of ``mean_t`` cached positions a layer, and the experts'
    three matrices either for every expert (padded ones too, as a step's
    products that read all of them) or for the distinct experts the prompt's
    positions pick on average a layer (``distinct``)."""
    import math

    from repro_torch.models.params import leaves

    expert = 3 * cfg.d_model * cfg.moe_d_ff * 2  # bytes of one expert's matrices
    dense = batch * cfg.d_model * 2
    for path, x in leaves(params):
        if path[0] != "embed" and path[-2:] not in (("ffn", "wg"), ("ffn", "wi"), ("ffn", "wo")):
            dense += math.prod(x.shape) * x.element_size()
    cache = cfg.n_layers * batch * mean_t * 2 * cfg.kv_heads_p * cfg.hd * 2
    every = dense + cache + cfg.n_layers * cfg.experts_p * expert
    picked = dense + cache + sum(distinct) * expert
    return every / HBM_BYTES_PER_S * 1e3, picked / HBM_BYTES_PER_S * 1e3, every, picked


def phase_moe(seed: int = 0, cfg=None, cut_cfg=None, device: str = "cuda") -> dict:
    """Serve qwen2-moe-a2.7b at full width and depth on the card, then
    qwen3-moe-30b-a3b at full width and 2 of its 48 periods; returns the
    main path's launches (qwen2-moe's default serve).  ``cfg``, ``cut_cfg``
    and ``device`` serve a rehearsal on the CPU at the smoke configs
    (``cuda`` calls stubbed, launch checks lenient)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.kernels.flash_attention import COPY_COUNTER, TC_COUNTER
    from repro_torch.launch.serve import admit_requests, serve
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.params import n_params
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on: the router's float32 logits could flip picks between runs")
    cfg = cfg or get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = lm.concrete_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    n = n_params(params)
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv_heads}) of {cfg.hd}, {cfg.experts_p} experts ({cfg.n_experts} real) of "
        f"{cfg.moe_d_ff}, top-{cfg.experts_per_token}, shared {cfg.shared_d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n} parameters ({n * 2 / 1e9:.2f} GB) made on the card "
        f"in {time.perf_counter() - t0:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # 1. The main path at serve.py's defaults.
    counters = (*BUILT, TC_COUNTER, COPY_COUNTER)
    for name in counters:
        LAUNCH_COUNTS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve(cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=seed,
                n_docs=SERVE_DOCS, device=device, params=params)
    wall = time.perf_counter() - t0
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    tc_launches, copies = LAUNCH_COUNTS[TC_COUNTER], LAUNCH_COUNTS[COPY_COUNTER]
    log(f"[moe] admission sketch on {res.run_info.attr}: skipping {res.skipped_fraction:.1%} of "
        f"request pool ({len(res.selected_docs)} of {SERVE_DOCS} admitted)")
    _serve_line("moe bf16 defaults", res, SERVE_PROMPT)
    log(f"[moe] serve() wall {wall:.2f} s; launches {launches}; prefill: {tc_launches} "
        f"tensor-core flash_attention launches, {copies} aligned copies")
    on_card = device == "cuda"
    require(not on_card or launches["flash_attention"] == cfg.n_layers == tc_launches,
            f"prefill launched flash_attention {launches['flash_attention']} times "
            f"({tc_launches} tensor-core), expected {cfg.n_layers}")
    require(copies == 0, f"prefill copied {copies} q/k/v views for TMA's alignment")
    require(not on_card or launches["segment_aggregate"] > 0,
            "admission did not aggregate on the card")
    require(res.prefill_logits.shape == (SERVE_REQUESTS, cfg.vocab_p)
            and bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.last_logits).all()), "moe logits not finite")
    require(res.generated.shape == (SERVE_REQUESTS, SERVE_GEN)
            and int(res.generated.min()) >= 0 and int(res.generated.max()) < cfg.vocab_size,
            "generated tokens out of range")

    # 2. Layer by layer on the serving weights at the 64-token prompt.
    short = _moe_layerwise(cfg, params, res.prompt, f"S={SERVE_PROMPT}")

    # 3. The long prompt: prefill only (no teacher-forced decode through it).
    long_prompt, _ = admit_requests(cfg, requests=SERVE_REQUESTS, prompt_len=LONG_PROMPT,
                                    seed=seed, n_docs=SERVE_DOCS, device=device)
    with torch.inference_mode():
        before = {name: LAUNCH_COUNTS[name] for name in counters}
        logits = lm.prefill(params, cfg, {"tokens": long_prompt})
        torch.cuda.synchronize()
        long_launches = LAUNCH_COUNTS["flash_attention"] - before["flash_attention"]
        long_tc = LAUNCH_COUNTS[TC_COUNTER] - before[TC_COUNTER]
        long_copies = LAUNCH_COUNTS[COPY_COUNTER] - before[COPY_COUNTER]
        require(bool(torch.isfinite(logits).all()), "long-prompt logits are not finite")
        require(not on_card or long_launches == long_tc == cfg.n_layers,
                f"a {LONG_PROMPT}-token prefill launched flash_attention {long_launches} times "
                f"({long_tc} tensor-core)")
        require(long_copies == 0, f"the long prefill copied {long_copies} views")
        for tokens in (res.prompt, long_prompt):
            ms = time_ms(lambda: lm.prefill(params, cfg, {"tokens": tokens}), reps=3, warmup=1)
            log(f"[moe] warm bf16 prefill B={tokens.shape[0]} S={tokens.shape[1]}: {ms:.2f} ms "
                f"({tokens.numel() / ms * 1e3:.0f} tok/s)")
    _moe_layerwise(cfg, params, long_prompt, f"S={LONG_PROMPT}", plain_layers=MOE_CHECK_LAYERS)
    del logits

    # 4. Equal bits on a rerun: layer 0's moe on its input at the long prompt.
    with torch.inference_mode():
        p = lm._period_slice(params["periods"], 0)["b0"]
        x = L.attention_train(p["mixer"], cfg, lm._embed(cfg, params, long_prompt))
        y1, a1 = L.moe(p["ffn"], cfg, x)
        y2, a2 = L.moe(p["ffn"], cfg, x)
        require(torch.equal(y1, y2) and torch.equal(a1, a2), "moe reruns differ")
        log(f"[moe] rerun of layer 0's moe on {tuple(x.shape)}: equal bits")
        del x, y1, y2

        # 5. Decode: the serve's steps, a warm step, and its bound.
        cache = lm.init_cache(cfg, SERVE_REQUESTS, SERVE_PROMPT + SERVE_GEN, device=device)
        tok = res.prompt[:, 0]
        ms = time_ms(lambda: lm.decode_step(params, cfg, cache, tok, SERVE_PROMPT), reps=5,
                     warmup=2)
    mean_t = (SERVE_PROMPT + SERVE_GEN) / 2
    every, picked, every_b, picked_b = _decode_bound_ms(cfg, params, short["distinct"],
                                                         SERVE_REQUESTS, mean_t)
    log(f"[moe] decode B={SERVE_REQUESTS}: {res.per_token_s * 1e3:.2f} ms a step over serve's "
        f"{res.n_decode_steps} steps, a warm step {ms:.2f} ms (CUDA events); bound "
        f"{every:.2f} ms reading every expert ({every_b / 1e9:.2f} GB), {picked:.2f} ms reading "
        f"the {sum(short['distinct']) / cfg.n_layers:.1f} experts a layer the prompt's "
        f"positions pick on average ({picked_b / 1e9:.2f} GB), at 3.35 TB/s")
    del params, res, cache, long_prompt
    torch.cuda.empty_cache()

    # 6. qwen3-moe-30b-a3b at full width, 2 of its 48 periods.
    cut = cut_cfg or dataclasses.replace(get_config(MOE_CUT_ARCH), n_layers=MOE_CUT_PERIODS,
                                         n_periods=MOE_CUT_PERIODS)
    params = lm.concrete_params(cut, seed=seed, device=device)
    before = {name: LAUNCH_COUNTS[name] for name in counters}
    res = serve(cut, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=seed,
                n_docs=SERVE_DOCS, device=device, params=params)
    cut_fa = LAUNCH_COUNTS["flash_attention"] - before["flash_attention"]
    cut_tc = LAUNCH_COUNTS[TC_COUNTER] - before[TC_COUNTER]
    _serve_line(f"{cut.name} ({cut.n_periods} of 48 periods)", res, SERVE_PROMPT)
    require(bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.last_logits).all()), f"{cut.name} logits not finite")
    require(not on_card or cut_fa == cut_tc == cut.n_layers,
            f"{cut.name} prefill launched flash_attention {cut_fa} times ({cut_tc} tensor-core)")
    log(f"[moe] {cut.name}: {n_params(params)} parameters, {cut.experts_p} experts top-"
        f"{cut.experts_per_token}, {cut.n_heads} heads on {cut.n_kv_heads} of {cut.hd}; "
        f"flash_attention {cut_fa} launches, {cut_tc} tensor-core")
    _moe_layerwise(cut, params, res.prompt, f"{cut.name} S={SERVE_PROMPT}")
    del params, res
    torch.cuda.empty_cache()
    log(f"[moe] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; phase done "
        f"in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: SSM serving, xlstm-350m at full width and depth and a full-width
# cut of jamba-1.5-large
# ---------------------------------------------------------------------------

SSM_ARCH = "xlstm-350m"
SSM_CUT_ARCH, SSM_CUT_BLOCKS = "jamba-1.5-large-398b", 4  # its period's first 4 blocks, once
# Float32 copies of the weights, per layer: decode at the last prompt position
# against prefill there, elementwise (tests/test_ssm_numerics.py's bound).
SSM_DECODE_TOL = dict(atol=2e-4, rtol=1e-3)
SSM_SCAN_LAYERS = (0, -1)  # at the long prompt: the first and last layer of each scan kind


def _scan_check(cfg, p, mixer: str, h, label: str, timed: bool = False) -> float:
    """The scan of one mamba or sLSTM layer, on that layer's own input ``h``
    (the serving weights): the kernel against its plain version within
    SCAN_TOL of the output's scale, and a rerun with equal bits; at a mamba
    layer also the gated entry (what ``mamba_train`` runs) against the same
    ops around the scan-only kernel, bit for bit, and its rerun; with
    ``timed``, the kernels' times at these shapes beside their bounds.
    Returns the scan's error over the scale."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_gated
    from repro_torch.kernels.slstm_scan import slstm_scan
    from repro_torch.models import ssm

    if mixer == "mamba":
        args = ssm.mamba_gated_inputs(p, cfg, h)
        x1, _, dt_raw, dt_bias, a, bmat, cmat, _ = args
        dtv = ref.softplus(dt_raw + dt_bias)  # as mamba_scan_inputs gives it
        kernel = lambda: selective_scan(x1, dtv, a, bmat, cmat)
        want = ref.selective_scan_plain(x1, dtv, a, bmat, cmat, chunk=SCAN_PLAIN_CHUNK)
        b_ms, b_by = _selective_scan_bound(*x1.shape, a.shape[1], x1.element_size())
    else:
        xproj = ssm.slstm_scan_input(p, h)
        kernel = lambda: slstm_scan(xproj, p["wr"], p["bias"])
        want = ref.slstm_scan_plain(xproj, p["wr"], p["bias"])
        b_ms, b_by = _slstm_scan_bound(*xproj.shape[:2], *p["wr"].shape[:2],
                                       xproj.element_size(), p["wr"].element_size())
    got = kernel()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()) and err <= SCAN_TOL * scale,
            f"{label}: {mixer} scan kernel vs plain max |diff| {err:.3e} at scale {scale:.3f}")
    require(torch.equal(got, kernel()), f"{label}: the {mixer} scan kernel's rerun differs")
    shape = tuple(got.shape)
    del got, want
    if timed:
        ms = time_ms(kernel, reps=5, warmup=1)
        log(f"[ssm] {label}: the {mixer} scan kernel at {shape}: {ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), {ms / b_ms:.1f}x")
    if mixer == "mamba":
        del dtv
        fused = lambda: selective_scan_gated(*args, h.dtype)
        got = fused()
        want = ref.selective_scan_gated_plain(*args, h.dtype, scan=selective_scan)
        require(torch.equal(got, want), f"{label}: the gated scan differs from the unfused chain "
                                        f"by up to {float((got.float() - want.float()).abs().max()):.3e}")
        require(torch.equal(got, fused()), f"{label}: the gated scan's rerun differs")
        del got, want
        if timed:
            ms = time_ms(fused, reps=5, warmup=1)
            g_ms, g_by = _gated_scan_bound(*x1.shape, a.shape[1], x1.element_size())
            log(f"[ssm] {label}: the gated scan at {shape}, equal to the unfused chain bit for "
                f"bit: {ms:.3f} ms, bound {g_ms:.3f} ms ({g_by}), {ms / g_ms:.1f}x")
    return err / scale


def _ssm_layerwise(cfg, params, tokens, label: str, scan_layers=None) -> dict:
    """Bf16 prefill of ``tokens`` block by block (the serving weights); at
    each mamba or sLSTM layer (the ``scan_layers``-th of its kind, every one
    when None), :func:`_scan_check` on that layer's own input, the first
    checked of each kind timed.  Returns the worst error over scale by
    mixer."""
    import torch

    from repro_torch.models import lm

    require(not cfg.remainder, f"{cfg.name}: the layer walk covers the periods only")
    blocks = [(i, j, blk) for i in range(cfg.n_periods) for j, blk in enumerate(cfg.pattern)]
    kinds = {m: [k for k, (_, _, blk) in enumerate(blocks) if blk[0] == m]
             for m in ("mamba", "slstm")}
    check = {m: (set(ks) if scan_layers is None else {ks[i] for i in scan_layers if ks})
             for m, ks in kinds.items()}
    worst, timed = {}, set()
    with torch.inference_mode():
        h = lm._embed(cfg, params, tokens)
        for k, (i, j, blk) in enumerate(blocks):
            p = lm._period_slice(params["periods"], i)[f"b{j}"]
            mixer = blk[0]
            if k in check.get(mixer, ()):
                e = _scan_check(cfg, p["mixer"], mixer, h, f"{label} layer {k}",
                                timed=mixer not in timed)
                timed.add(mixer)
                worst[mixer] = max(worst.get(mixer, 0.0), e)
            h, _ = lm._apply_block_train(cfg, blk, p, h)
    log(f"[ssm] {label} layer by layer (B={tokens.shape[0]}, S={tokens.shape[1]}): scan kernel "
        f"vs plain max |diff| / scale {worst} over layers "
        f"{ {m: sorted(c) for m, c in check.items() if c} } (tolerance {SCAN_TOL}); "
        f"{'mamba gated scans equal to the unfused chain; ' if 'mamba' in worst else ''}reruns "
        f"bit-equal")
    return worst


def _ssm_decode_check(cfg, params, tokens) -> float:
    """Float32 copies of the weights, layer by layer on each layer's own
    input: the block's decode form fed the prompt one position at a time,
    its output at the last position against the block's prefill output
    there, within SSM_DECODE_TOL.  Returns the worst excess of |diff| over
    rtol |prefill|, relative to atol."""
    import torch

    from repro_torch.models import lm

    b, s = tokens.shape
    worst = 0.0
    with torch.inference_mode():
        h = lm._embed(cfg, params, tokens)
        for i in range(cfg.n_periods):
            pp = lm._period_slice(params["periods"], i)
            for j, blk in enumerate(cfg.pattern):
                p = pp[f"b{j}"]
                out, _ = lm._apply_block_train(cfg, blk, p, h)
                cache = lm._block_cache(cfg, blk, b, s, torch.float32, h.device)
                for t in range(s):
                    dec = lm._apply_block_decode(cfg, blk, p, cache, h[:, t:t + 1], t)
                want = out[:, -1]
                excess = (dec[:, 0] - want).abs() - SSM_DECODE_TOL["rtol"] * want.abs()
                e = float(excess.max()) / SSM_DECODE_TOL["atol"]
                worst = max(worst, e)
                require(e <= 1.0, f"layer {i}.{j} ({blk[0]}) f32 decode vs prefill: "
                                  f"|diff| - rtol |want| reaches {e:.2f} atol")
                h = out
    log(f"[ssm] f32 layer by layer ({cfg.n_layers} layers, B={b}, S={s}): decode at the last "
        f"position vs prefill, worst (|diff| - {SSM_DECODE_TOL['rtol']} |prefill|) / "
        f"{SSM_DECODE_TOL['atol']} = {worst:.3f} (at most 1)")
    return worst


def _ssm_decode_bound_ms(cfg, params, batch: int, total: int, device) -> tuple:
    """The least ms of one decode step at 3.35 TB/s and its bytes: every
    weight but the embedding table read once (the B embedding rows
    instead), every recurrent state read and written, and half the
    attention caches' positions read (the mean over the serve's steps)."""
    import math

    from repro_torch.models import lm
    from repro_torch.models.params import leaves

    n_bytes = batch * cfg.d_model * 2
    for path, x in leaves(params):
        if path[0] != "embed":
            n_bytes += math.prod(x.shape) * x.element_size()
    for path, x in _cache_tensors(lm.init_cache(cfg, batch, total, device=device)):
        size = x.numel() * x.element_size()
        n_bytes += size / 2 if "kv" in path else 2 * size
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def _cache_tensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_tensors(v, path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _cache_tensors(v, path + (str(i),))
    else:
        yield path, tree


def _ssm_serve(cfg, seed: int, device: str, label: str, expect: dict, f32_check: bool) -> dict:
    """One config of phase 13: random bf16 weights, ``serve()`` at phase 6's
    defaults (its launches counted from 0), the scans layer by layer at the
    64-token prompt, the float32 decode check (``f32_check``), a 2,048-token
    prefill with its launches, the scans at its first and last layers, warm
    prefill and decode times beside decode's bound, and the peak memory.
    ``expect`` maps each kernel to its launches a prefill.  Returns the
    serve's launches."""
    import dataclasses

    import torch

    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.kernels.flash_attention import COPY_COUNTER, TC_COUNTER
    from repro_torch.launch.serve import admit_requests, serve
    from repro_torch.models import lm
    from repro_torch.models.params import n_params
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    on_card = device == "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.concrete_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    n = n_params(params)
    mixers = sorted({m for m, _ in cfg.all_blocks})
    log(f"[ssm] {label}: {cfg.n_layers} layers {mixers}, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads (kv {cfg.n_kv_heads}), vocab {cfg.vocab_size}, {cfg.dtype}: {n} parameters "
        f"({n * 2 / 1e9:.2f} GB; param_count() {cfg.param_count()}) made in "
        f"{time.perf_counter() - t0:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # 1. The main path at serve.py's defaults, counted from 0.
    counters = (*BUILT, TC_COUNTER, COPY_COUNTER)
    for name in counters:
        LAUNCH_COUNTS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve(cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT, gen=SERVE_GEN, seed=seed,
                n_docs=SERVE_DOCS, device=device, params=params)
    wall = time.perf_counter() - t0
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    tc, copies = LAUNCH_COUNTS[TC_COUNTER], LAUNCH_COUNTS[COPY_COUNTER]
    log(f"[ssm] {label} admission sketch on {res.run_info.attr}: skipping "
        f"{res.skipped_fraction:.1%} of request pool ({len(res.selected_docs)} of {SERVE_DOCS} "
        f"admitted)")
    _serve_line(f"{label} bf16 defaults", res, SERVE_PROMPT)
    log(f"[ssm] {label} serve() wall {wall:.2f} s; launches {launches}; {tc} tensor-core "
        f"flash_attention launches, {copies} aligned copies")
    for name, want in expect.items():
        require(not on_card or launches[name] == want,
                f"{label}: the serve launched {name} {launches[name]} times, expected {want}")
    require(not on_card or tc == expect.get("flash_attention", 0),
            f"{label}: {tc} tensor-core flash_attention launches")
    require(copies == 0, f"{label}: the prefill copied {copies} views for TMA's alignment")
    require(not on_card or launches["segment_aggregate"] > 0,
            f"{label}: the admission did not aggregate on the card")
    require(res.prefill_logits.shape == (SERVE_REQUESTS, cfg.vocab_p)
            and bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.last_logits).all()), f"{label}: logits not finite")
    require(res.generated.shape == (SERVE_REQUESTS, SERVE_GEN)
            and int(res.generated.min()) >= 0 and int(res.generated.max()) < cfg.vocab_size,
            f"{label}: generated tokens out of range")

    # 2. The scans layer by layer on the serving weights at the 64-token prompt,
    # and (xlstm) decode against prefill on float32 copies.
    _ssm_layerwise(cfg, params, res.prompt, f"{label} S={SERVE_PROMPT}")
    if f32_check:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = params.map(lambda x: x.to(torch.float32))
        _ssm_decode_check(cfg32, params32, res.prompt)
        del params32
        torch.cuda.empty_cache()

    # 3. The long prompt: its admission and one prefill (no decode through it).
    long_prompt, _ = admit_requests(cfg, requests=SERVE_REQUESTS, prompt_len=LONG_PROMPT,
                                    seed=seed, n_docs=SERVE_DOCS, device=device)
    with torch.inference_mode():
        before = {name: LAUNCH_COUNTS[name] for name in counters}
        logits = lm.prefill(params, cfg, {"tokens": long_prompt})
        torch.cuda.synchronize()
        got = {name: LAUNCH_COUNTS[name] - before[name] for name in counters}
        require(logits.shape == (SERVE_REQUESTS, cfg.vocab_p)
                and bool(torch.isfinite(logits).all()), f"{label}: long-prompt logits not finite")
        for name, want in expect.items():
            require(not on_card or got[name] == want,
                    f"{label}: the {LONG_PROMPT}-token prefill launched {name} {got[name]} times")
        require(not on_card or got[TC_COUNTER] == expect.get("flash_attention", 0),
                f"{label}: the long prefill's tensor-core launches {got[TC_COUNTER]}")
        require(got[COPY_COUNTER] == 0, f"{label}: the long prefill copied views")
        log(f"[ssm] {label} {LONG_PROMPT}-token prefill launches "
            f"{ {k: v for k, v in got.items() if v} }, finite logits")
        del logits
        for tokens in (res.prompt, long_prompt):
            ms = time_ms(lambda: lm.prefill(params, cfg, {"tokens": tokens}), reps=3, warmup=1)
            log(f"[ssm] {label} warm bf16 prefill B={tokens.shape[0]} S={tokens.shape[1]}: "
                f"{ms:.2f} ms ({tokens.numel() / ms * 1e3:.0f} tok/s)")
    _ssm_layerwise(cfg, params, long_prompt, f"{label} S={LONG_PROMPT}",
                   scan_layers=SSM_SCAN_LAYERS)

    # 4. Decode: the serve's steps, a warm step, and its bound.
    total = SERVE_PROMPT + SERVE_GEN
    with torch.inference_mode():
        cache = lm.init_cache(cfg, SERVE_REQUESTS, total, device=device)
        tok = res.prompt[:, 0]
        ms = time_ms(lambda: lm.decode_step(params, cfg, cache, tok, SERVE_PROMPT), reps=5,
                     warmup=2)
    b_ms, b_bytes = _ssm_decode_bound_ms(cfg, params, SERVE_REQUESTS, total, device)
    log(f"[ssm] {label} decode B={SERVE_REQUESTS}: {res.per_token_s * 1e3:.2f} ms a step over "
        f"serve's {res.n_decode_steps} steps, a warm step {ms:.2f} ms (CUDA events); bound "
        f"{b_ms:.3f} ms ({b_bytes / 1e9:.3f} GB of weights and states at 3.35 TB/s)")
    log(f"[ssm] {label} peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params, res, cache, long_prompt
    torch.cuda.empty_cache()
    return launches


def phase_ssm(seed: int = 0, cfg=None, cut_cfg=None, device: str = "cuda") -> dict:
    """Serve xlstm-350m at full width and depth on the card, then
    jamba-1.5-large-398b at full width over the first four blocks of its
    period; returns the main path's launches (both default serves, each
    counted from 0).  ``cfg``, ``cut_cfg`` and ``device`` serve a rehearsal
    on the CPU at the smoke configs (``cuda`` calls stubbed, launch checks
    lenient)."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = cfg or get_config(SSM_ARCH)
    n_slstm = sum(1 for m, _ in cfg.all_blocks if m == "slstm")
    launches = _ssm_serve(cfg, seed, device, cfg.name, {"slstm_scan": n_slstm,
                                                        "selective_scan": 0}, f32_check=True)
    if cut_cfg is None:
        full = get_config(SSM_CUT_ARCH)
        cut_cfg = dataclasses.replace(full, n_layers=SSM_CUT_BLOCKS, n_periods=1,
                                      pattern=full.pattern[:SSM_CUT_BLOCKS])
    kinds = [m for m, _ in cut_cfg.all_blocks]
    cut = _ssm_serve(cut_cfg, seed, device,
                     f"{cut_cfg.name} ({len(kinds)} of its 72 blocks)",
                     {"selective_scan": kinds.count("mamba"), "slstm_scan": 0,
                      "flash_attention": kinds.count("attn")}, f32_check=False)
    for name, count in cut.items():
        launches[name] += count
    log(f"[ssm] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: SSM training, xlstm-350m at full width and depth and a one-block
# (mamba, MLP) cut of jamba-1.5-large at full width
# ---------------------------------------------------------------------------

# jamba-1.5-large cut to one (mamba, MLP) block at full width: 2.09 B
# parameters, 41.8 GB of state and accumulator at 20 bytes a parameter; a
# batch of 2 x 2,048 tokens in 2 microbatches, 3 steps, no checkpoint.
SSM_TRAIN_CUT_BATCH, SSM_TRAIN_CUT_STEPS = 2, 3


def _plain_scans(fn):
    """``fn()`` with models/ssm.py's scans bound to their plain versions
    (the plain selective scan at SCAN_PLAIN_CHUNK), so autograd runs through
    the plain loops on the card."""
    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    saved = ssm.slstm_scan, ssm.selective_scan_gated
    ssm.slstm_scan = ref.slstm_scan_plain
    ssm.selective_scan_gated = lambda *args, chunk=1024: ref.selective_scan_gated_plain(
        *args, chunk=SCAN_PLAIN_CHUNK)
    try:
        return fn()
    finally:
        ssm.slstm_scan, ssm.selective_scan_gated = saved


def _mixer_grads(cfg, p, h, dy, mixer: str) -> dict:
    """Gradients of the ``mixer`` block's train form (``slstm_train`` or
    ``mamba_train``) at ``h`` against ``dy``, w.r.t. h and every leaf of the
    layer, through whatever models/ssm.py's scans are bound to."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.models.params import leaves, tree_unflatten

    paths = ["/".join(path) for path, _ in leaves(p)]
    flat = [x.detach().requires_grad_() for _, x in leaves(p)]
    x = h.detach().requires_grad_()
    fn = ssm.slstm_train if mixer == "slstm" else ssm.mamba_train
    with torch.enable_grad():
        y = fn(tree_unflatten(p, flat, dicts=True), cfg, x)
        grads = torch.autograd.grad(y, [x, *flat], dy)
    return dict(zip(["x", *paths], grads))


def _ssm_train_layerwise(cfg, params, tokens, mixer: str, tag: str) -> dict:
    """Check (b): at the first and last ``mixer`` layer (SSM_SCAN_LAYERS),
    each on its own input (the stack run to it), the gradients of the
    mixer's train form w.r.t. its input and every leaf through the scan
    kernels against autograd through the plain versions on the card, within
    TRAIN_TOL of each gradient's scale: the bf16 weights, then float32
    copies.  Returns the worst |diff| / scale by dtype."""
    import dataclasses

    import torch

    from repro_torch.kernels import selective_scan as SEL
    from repro_torch.kernels import slstm_scan as SS
    from repro_torch.models import lm
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    blocks = [(i, j, blk) for i in range(cfg.n_periods) for j, blk in enumerate(cfg.pattern)]
    kinds = [k for k, (_, _, blk) in enumerate(blocks) if blk[0] == mixer]
    check = {kinds[i] for i in SSM_SCAN_LAYERS}
    bwd_name = SS.BWD_NAME if mixer == "slstm" else SEL.BWD_NAME
    worst = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        ps = params if dtype == cfg.dtype else params.map(lambda x: x.to(torch.float32))
        gen = torch.Generator(device=tokens.device).manual_seed(12)
        before = LAUNCH_COUNTS[bwd_name]
        worst[dtype] = 0.0
        with torch.no_grad():
            h = lm._embed(c, ps, tokens)
            for k, (i, j, blk) in enumerate(blocks[:max(check) + 1]):
                p = lm._period_slice(ps["periods"], i)[f"b{j}"]
                if k in check:
                    dy = torch.randn(h.shape, generator=gen, device=h.device).to(h.dtype)
                    got = _mixer_grads(c, p["mixer"], h, dy, mixer)
                    want = _plain_scans(lambda: _mixer_grads(c, p["mixer"], h, dy, mixer))
                    for name, g in got.items():
                        w = want[name].float()
                        scale = max(float(w.abs().max()), 1e-30)
                        err = float((g.float() - w).abs().max())
                        worst[dtype] = max(worst[dtype], err / scale)
                        require(bool(torch.isfinite(g).all()) and err <= TRAIN_TOL[dtype] * scale,
                                f"layer {k} ({mixer}) {dtype} gradient {name}: max |diff| "
                                f"{err:.3e} at scale {scale:.3e}")
                    del got, want
                    torch.cuda.empty_cache()
                h, _ = lm._apply_block_train(c, blk, p, h)
        require(not tokens.is_cuda or LAUNCH_COUNTS[bwd_name] - before == len(check),
                f"{dtype}: the layer check ran {bwd_name} {LAUNCH_COUNTS[bwd_name] - before} "
                f"times, expected {len(check)}")
        del ps, h
        torch.cuda.empty_cache()
    log(f"{tag} (b) {mixer} gradients at layers {sorted(check)} of {len(blocks)} (B="
        f"{tokens.shape[0]}, S={tokens.shape[1]}), input and every leaf: max |diff| / scale "
        f"kernels vs plain {worst['bfloat16']:.2e} (bf16 weights), {worst['float32']:.2e} (f32 "
        f"copies); tolerances {TRAIN_TOL}")
    return worst


def _ssm_train_cut(cut_cfg, seed: int, seq: int, device: str) -> dict:
    """Check (g): ``cut_cfg`` (one (mamba, MLP) block at jamba's full width)
    trained SSM_TRAIN_CUT_STEPS steps of SSM_TRAIN_CUT_BATCH x ``seq`` tokens
    in TRAIN_MICRO microbatches from random tokens: the layer's gradients
    through the kernels against the plain version's autograd, the first
    microbatch's loss gradients taken twice equal bit for bit, every loss
    finite, and selective_scan_bwd once a microbatch.  Returns the steps'
    launches by kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import selective_scan as SEL
    from repro_torch.kernels.build import KERNELS as BUILT
    from repro_torch.models import lm
    from repro_torch.models.params import n_params, tree_leaves, tree_unflatten
    from repro_torch.runtime.guards import LAUNCH_COUNTS
    from repro_torch.train.step import make_train_step

    tag = "[ssm-train] jamba cut"
    dev = torch.device(device)
    on_card = device == "cuda"
    torch.cuda.reset_peak_memory_stats()
    spec, state = _train_state(cut_cfg, seed, SSM_TRAIN_CUT_BATCH, seq, dev, tag)
    n = n_params(state["params"])
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    tokens = torch.randint(0, cut_cfg.vocab_size,
                           (SSM_TRAIN_CUT_STEPS, TRAIN_MICRO, SSM_TRAIN_CUT_BATCH // TRAIN_MICRO,
                            seq), generator=gen, device=dev)
    log(f"{tag}: {n} parameters (param_count() {cut_cfg.param_count()}), "
        f"{n * 20 / 1e9:.1f} GB of state and accumulator at 20 bytes a parameter")
    t0 = time.perf_counter()
    _ssm_train_layerwise(cut_cfg, state["params"], tokens[0, 0], "mamba", tag)
    log(f"{tag} (b) done in {time.perf_counter() - t0:.1f} s")

    def grads():
        flat = [x.detach().requires_grad_() for x in tree_leaves(state["params"])]
        with torch.enable_grad():
            loss = lm.loss_fn(tree_unflatten(state["params"], flat, dicts=True), cut_cfg,
                              {"tokens": tokens[0, 0]})
            return torch.autograd.grad(loss, flat)

    first, again = grads(), grads()
    require(all(torch.equal(g, g2) for g, g2 in zip(first, again)),
            f"{tag}: the first microbatch's gradients differ between two runs")
    log(f"{tag} the first microbatch's gradients of all {len(first)} leaves taken twice: equal "
        f"bit for bit")
    del first, again
    torch.cuda.empty_cache()
    step_fn = make_train_step(cut_cfg, spec)
    for name in BUILT:
        LAUNCH_COUNTS[name] = 0
    losses, walls = [], []
    for i in range(SSM_TRAIN_CUT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step_fn(state, {"tokens": tokens[i]})
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        walls.append(time.perf_counter() - t)
        losses.append((loss, gnorm))
        toks = SSM_TRAIN_CUT_BATCH * seq
        log(f"{tag} step {i}: wall {walls[-1] * 1e3:.1f} ms, {toks / walls[-1]:.0f} tok/s, loss "
            f"{loss:.6f}, grad_norm {gnorm:.6f}, mfu "
            f"{6 * n * toks / (walls[-1] * BF16_OPS_PER_S):.4f}")
    launches = {name: LAUNCH_COUNTS[name] for name in BUILT}
    require(all(np.isfinite(a) and np.isfinite(b) for a, b in losses),
            f"{tag}: a loss or grad norm is not finite")
    n_mamba = sum(1 for m, _ in cut_cfg.all_blocks if m == "mamba")
    want = {SEL.NAME: 2 * n_mamba * TRAIN_MICRO, SEL.BWD_NAME: n_mamba * TRAIN_MICRO}
    for name, per in want.items():
        require(not on_card or launches[name] == per * SSM_TRAIN_CUT_STEPS,
                f"{tag}: {name} launched {launches[name]} times in {SSM_TRAIN_CUT_STEPS} steps, "
                f"expected {per * SSM_TRAIN_CUT_STEPS}")
    log(f"{tag} (g) launches over {SSM_TRAIN_CUT_STEPS} steps {launches}; losses finite; warm "
        f"step wall median {sorted(walls[1:])[len(walls[1:]) // 2] * 1e3:.1f} ms; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del state, tokens
    torch.cuda.empty_cache()
    return launches


def phase_ssm_train(seed: int = 0, cfg=None, cut_cfg=None, batch: int = TRAIN_BATCH,
                    seq: int = TRAIN_SEQ, device: str = "cuda") -> dict:
    """Train xlstm-350m at full width and depth on the card (checks (a)-(f)
    as phase 11's, (b) the sLSTM's gradients at its first and last layer),
    then jamba-1.5-large-398b cut to one (mamba, MLP) block at full width
    (check (g)); returns the training path's launches: xlstm's straight run,
    its curation and the cut's steps.  ``cfg``, ``cut_cfg``, ``batch``,
    ``seq`` and ``device`` serve a rehearsal on the CPU at the smoke configs
    (``cuda`` calls stubbed, launch checks lenient)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as SEL
    from repro_torch.kernels import slstm_scan as SS
    from repro_torch.models.params import n_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tag = "[ssm-train]"
    cfg = cfg or get_config(SSM_ARCH)
    dev = torch.device(device)
    on_card = device == "cuda"
    ckpt_dir = ROOT / "build" / "phase14_ckpt"
    cli_dir = ROOT / "build" / "phase14_cli_ckpt"
    for d in (ckpt_dir, cli_dir):
        shutil.rmtree(d, ignore_errors=True)
    # (f) The CLI's processes, beside the whole run: they work mostly on the
    # host, and the checkpoint's IO is too short to hide them.
    cli = _start_cli(cli_dir, device, SSM_ARCH)

    pipe, curation = _train_curation(cfg, seed, batch, seq, dev, tag)
    spec, state = _train_state(cfg, seed, batch, seq, dev, tag)
    n = n_params(state["params"])
    log(f"{tag} {cfg.name}: {n} parameters (param_count() {cfg.param_count()}: it omits the "
        f"sLSTM's out, the mLSTM's wog and the final norm); mfu counts 6 N tokens with N = {n}, "
        f"without the mLSTM's intra-chunk products")
    t0 = time.perf_counter()
    first = _first_microbatch(cfg, pipe, seq, dev)
    _ssm_train_layerwise(cfg, state["params"], first["tokens"][0], "slstm", tag)
    log(f"{tag} (b) done in {time.perf_counter() - t0:.1f} s")
    del first

    paths = (SS.RESIDUALS_COUNTER, SEL.RESIDUALS_COUNTER)
    n_slstm = sum(1 for m, _ in cfg.all_blocks if m == "slstm")

    def check_launches(launches, kinds):
        per_step = {SS.NAME: n_slstm * TRAIN_MICRO * 2, SS.BWD_NAME: n_slstm * TRAIN_MICRO,
                    SEL.NAME: 0, SEL.BWD_NAME: 0}
        log(f"{tag} (e) launches over {TRAIN_STEPS} steps {launches}; a step: slstm_scan "
            f"{launches[SS.NAME] / TRAIN_STEPS:g} (remat recompute included), of them with "
            f"residuals {kinds[SS.RESIDUALS_COUNTER] / TRAIN_STEPS:g}, slstm_scan_bwd "
            f"{launches[SS.BWD_NAME] / TRAIN_STEPS:g}")
        for name, per in per_step.items():
            require(not on_card or launches[name] == per * TRAIN_STEPS,
                    f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, expected "
                    f"{per * TRAIN_STEPS}")
        require(not on_card or kinds[SS.RESIDUALS_COUNTER] == n_slstm * TRAIN_MICRO * TRAIN_STEPS,
                f"{kinds[SS.RESIDUALS_COUNTER]} sLSTM forwards wrote residuals in {TRAIN_STEPS} "
                f"steps, expected only the {n_slstm * TRAIN_MICRO * TRAIN_STEPS} recomputations")

    box = [state]
    del state
    launches = _train_run(tag, cfg, spec, box, pipe, batch, seq, device, n, paths,
                          check_launches, ckpt_dir, cli_dir, SSM_ARCH, t_phase, cli)
    launches.update({name: launches[name] + curation[name] for name in curation})

    if cut_cfg is None:
        full = get_config(SSM_CUT_ARCH)
        cut_cfg = dataclasses.replace(full, n_layers=1, n_periods=1, pattern=(("mamba", "mlp"),))
    t0 = time.perf_counter()
    cut = _ssm_train_cut(cut_cfg, seed, seq, device)
    log(f"{tag} jamba cut done in {time.perf_counter() - t0:.1f} s")
    for name, count in cut.items():
        launches[name] += count
    log(f"{tag} phase done in {time.perf_counter() - t_phase:.1f} s")
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
    tpch = make_tpch(TPCH_LINEITEM, seed=SEED, device="cuda")  # phases 7 and 8
    torch.cuda.synchronize()
    log(f"[join] tpch made in {time.perf_counter() - t1:.2f} s")
    join_launches = phase_join(TPCH_LINEITEM, SEED, db=tpch)
    for name in JOIN_KERNELS:
        launches[name] += join_launches[name]
    strategy_launches = phase_strategies(ROWS, SEED, crimes_db=db, tpch_db=tpch)
    for name in STRATEGY_KERNELS:
        launches[name] += strategy_launches[name]
    del db, tpch
    launches["flash_attention"] = phase_serve(SEED_SERVE)["flash_attention"]
    train_launches = phase_train(SEED_SERVE)
    moe_launches = phase_moe(SEED_SERVE)
    ssm_launches = phase_ssm(SEED_SERVE)
    ssm_train_launches = phase_ssm_train(SEED_SERVE)
    for name, _, _ in KERNELS:
        launches[name] = (launches.get(name, 0) + train_launches[name] + moe_launches[name]
                          + ssm_launches[name] + ssm_train_launches[name])
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
