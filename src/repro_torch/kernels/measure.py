"""Device time of a call, its device events and the bitmap's sector count,
shared by ``chip_smoke.py`` and the probes; and one tree's kernels timed
in processes of their own against another's (``paired``)."""
from __future__ import annotations

import re
from typing import Callable, Dict

_NAMES = re.compile(r"(filter_rows_kernel|filter_kernel|bitmap_batch_kernel|bitmap_kernel|"
                    r"segagg_\w+|flash_fwd\w*|bwd_\w+|Memcpy \w+|Memset)")


def device_ms(torch, fn: Callable, calls: int = 20, before: Callable = None) -> Dict[str, float]:
    """Device milliseconds a call by kernel or copy (``torch.profiler``),
    each summed over its launches and divided by ``calls``; empty if no
    trace saw device activity.  ``before()`` runs ahead of each call and
    must launch nothing but device-to-device copies, which are not
    counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            if before is not None:
                before()
            fn()

    per: Dict[str, float] = {}
    for e in _device_trace(torch, run):
        if "Memcpy DtoD" in e.name:
            continue
        mark = _NAMES.search(e.name)
        name = mark.group(0) if mark else e.name[:40]
        per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in per.items()}


def device_events(torch, fn: Callable) -> int:
    """Device events (kernels, copies, memsets) of one call of ``fn``, after
    a warm-up call (``torch.profiler``)."""
    fn()
    torch.cuda.synchronize()
    return len(_device_trace(torch, fn))


def _device_trace(torch, run: Callable, traces: int = 3) -> list:
    """The device events ``torch.profiler`` records while ``run()`` runs.
    A trace that holds no device event at all is taken again, up to
    ``traces`` times: on the H100 a process's first trace has come back
    empty though the call launched its kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def bitmap_sectors(prov) -> int:
    """32-byte sectors of int32 buckets (8 rows) holding a provenance row."""
    n = int(prov.shape[0])
    full = prov[: n - n % 8].view(-1, 8).any(dim=1).sum()
    return int(full) + int(bool(prov[n - n % 8:].any()))


# One tree's kernels timed in a process of their own (see ``paired``): the
# script imports only that tree's public ``repro_torch.kernels.ops``, so it
# runs against any commit whose ops take these calls.  argv[1] is a JSON list
# of cases; it prints one JSON object, each case's device ms a call
# (``torch.profiler``, every kernel and copy summed; 20 calls after 3
# warm-ups) with the L2 warm and evicted by a 64 MB copy before each call.
PAIRED_SCRIPT = r'''
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import ops

dev = torch.device("cuda")
flush = torch.empty(16 << 20, dtype=torch.int32, device=dev)
sink = torch.empty_like(flush)

def device_ms(fn, cold):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            if cold:
                sink.copy_(flush)
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy DtoD" not in e.name:
            total += (e.time_range.end - e.time_range.start) / 1e3
    return total / 20

def segment(case, gen):
    b, n, g = case["b"], case["n"], case["g"]
    rows = max(b, 1)
    gid = torch.randint(0, g, (rows, n), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.randint(0, 8, (rows, n), generator=gen, device=dev).float()
    w = (torch.rand((rows, n), generator=gen, device=dev) < 0.5).float()
    if case.get("order") == "sorted":
        gid = gid.sort(dim=1).values
    if case.get("order") == "phase5":
        # Shard slices of weighted rows then weight-0 padding, groups
        # clustered on the table's first group-by attribute.
        r = n // 4
        m = (torch.rand((rows, 4, 1), generator=gen, device=dev) * 0.56 * r).long()
        w = (torch.arange(r, device=dev)[None, None, :] < m).float().reshape(rows, n)
        cluster = (torch.arange(n, device=dev) // 65536 % 77).int()
        gid[0::3] = cluster
        gid[1::3] = cluster * 50 + gid[1::3] % 50
        gid *= w.int()
        vals *= w
    if b == 0:
        return lambda: ops.segment_aggregate(vals[0], gid[0], g, w[0])
    return lambda: ops.segment_aggregate_batch(vals, gid, g, w)

def bitmap_batch(case, gen):
    b, n, r = case["b"], case["n"], case["ranges"]
    bucket = torch.randint(0, r, (n,), generator=gen, device=dev, dtype=torch.int32)
    provs = torch.rand((b, n), generator=gen, device=dev) < 0.3
    provs &= (bucket[None, :] + torch.arange(b, device=dev)[:, None]) % 7 != 3
    return lambda: ops.fragment_bitmap_batch(provs, bucket, r)

out = {}
for case in json.loads(sys.argv[1]):
    gen = torch.Generator(device=dev).manual_seed(3)
    fn = (bitmap_batch if case["kind"] == "bitmap_batch" else segment)(case, gen)
    out[case["label"]] = [device_ms(fn, False), device_ms(fn, True)]
    del fn
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def paired(trees, cases, rounds: int = 2) -> Dict[str, Dict[str, list]]:
    """Each case's device ms (warm, evicted) in every tree of ``trees`` (the
    root of a checkout each: its ``src`` goes first on the path), run in
    turns ``trees``, then reversed, ``rounds`` times over, each run a
    process of its own on one card.  Returns {tree: {label: [[warm,
    evicted], ...]}}, one entry per run of that tree."""
    import json
    import os
    import subprocess
    import sys

    order = []
    for _ in range(rounds):
        order += list(trees) + list(trees)[::-1]
    out: Dict[str, Dict[str, list]] = {str(t): {} for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree) + "/src")
        proc = subprocess.run([sys.executable, "-c", PAIRED_SCRIPT, json.dumps(cases)],
                              cwd=str(tree), env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"paired run in {tree} failed:\n{proc.stderr[-4000:]}")
        for label, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[str(tree)].setdefault(label, []).append(ms)
    return out
