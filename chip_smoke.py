#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phase 1 builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once).  Phase 2 holds each kernel against
its plain PyTorch version on the card at the main path's shapes and times
both, the bandwidth bound and one PyTorch library call as a yardstick.
Phase 3 runs ``PBDSEngine.run`` (CB-OPT-GB, 100 ranges, theta 0.05) over a
Chicago-Crime-sized table (6.7M rows x 9 int32 columns on the device),
replaying a generated workload, and checks every result against execution
over the full table; it also times selection's host incidence pass.  Any
failed check raises, so the exit code is not 0.

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
ENVELOPE = float(1 << 24)  # float32 adds integers exactly below this
KERNEL_ROWS = 1 << 23  # 6.7M rows padded to pow2, the executor's row class
ROWS = 6_700_000  # Chicago Crime in the paper's evaluation
UNIQUE, REPLAYS, SEED = 8, 3, 9

# (name, source, TPU kernel it replaces)
KERNELS = (
    ("segment_aggregate", "src/repro_torch/kernels/csrc/segment_aggregate.cu",
     "src/repro/kernels/segment_aggregate.py:119"),
    ("fragment_bitmap", "src/repro_torch/kernels/csrc/fragment_bitmap.cu",
     "src/repro/kernels/fragment_bitmap.py:44"),
    ("sketch_filter", "src/repro_torch/kernels/csrc/sketch_filter.cu",
     "src/repro/kernels/sketch_filter.py:35"),
)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    # fragment_bitmap: capture at n_ranges = 100, a third of the rows in the provenance.
    n_ranges = 100
    bucket = torch.randint(0, n_ranges, (n,), generator=gen, device=dev, dtype=torch.int32)
    prov = torch.rand(n, generator=gen, device=dev) < 0.3
    # Leave some fragments empty so the bitmap is not all ones.
    prov &= bucket % 7 != 3
    got = ops.fragment_bitmap(prov, bucket, n_ranges)
    want = ref.fragment_bitmap_ref(prov, bucket, n_ranges)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "fragment_bitmap disagrees with its plain version")
    bucket_l, prov_i = bucket.long(), prov.to(torch.int32)
    nnz = int(prov.sum())
    b_ms, b_by = bound(n * 1 + nnz * 4 + n_ranges, n)
    rows["fragment_bitmap"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.fragment_bitmap(prov, bucket, n_ranges)),
        plain_ms=time_ms(lambda: ref.fragment_bitmap_ref(prov, bucket, n_ranges)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.zeros(n_ranges, dtype=torch.int32, device=dev)
                           .scatter_reduce_(0, bucket_l, prov_i, reduce="amax")),
    )
    log(f"[kernels] fragment_bitmap n={n} n_ranges={n_ranges} bit-exact; {rows['fragment_bitmap']}")

    # sketch_filter: the instance build's keep-mask over 100 ranges.
    bits = torch.rand(n_ranges, generator=gen, device=dev) < 0.4
    got = ops.sketch_filter(bucket, bits)
    want = ref.sketch_filter_ref(bucket, bits)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "sketch_filter disagrees with its plain version")
    b_ms, b_by = bound(n * 4 + n_ranges + n * 1, 0)
    rows["sketch_filter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.sketch_filter(bucket, bits)),
        plain_ms=time_ms(lambda: ref.sketch_filter_ref(bucket, bits)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: bits[bucket_l]),
    )
    log(f"[kernels] sketch_filter n={n} n_ranges={n_ranges} bit-exact; {rows['sketch_filter']}")

    # segment_aggregate: the executor's group pads, integral and normal values.
    seg_err = 0.0
    for g in (16, 16384):
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
        row = dict(
            max_abs_err=diff,
            ms=time_ms(lambda: ops.segment_aggregate(integral, gid, g, w)),
            plain_ms=time_ms(lambda: ref.segment_aggregate_ref(integral, gid, g, w)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: out2.index_add_(0, gl, vw2)),
        )
        log(f"[kernels] segment_aggregate n={n} G={g} integral bit-exact; normal "
            f"rel err kernel {err_k:.2e} plain {err_p:.2e}, max |kernel-plain| {diff:.3e}, "
            f"3 reruns bit-equal; {row}")
        rows["segment_aggregate"] = row  # the widest pad is the one reported
    rows["segment_aggregate"]["max_abs_err"] = seg_err
    return rows


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


def phase_engine(n_rows: int, n_unique: int, replays: int, seed: int) -> dict:
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
    for name in BUILT:
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
    for q, res, _ in results:
        full = execute(q, db, catalog=check_catalog)
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
    launches = phase_engine(ROWS, UNIQUE, REPLAYS, SEED)
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
