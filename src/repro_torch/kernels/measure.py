"""Device time of a call and the bitmap's sector count, shared by
``chip_smoke.py`` and ``kernels/filter_probe.py``."""
from __future__ import annotations

import re
from typing import Callable, Dict

_NAMES = re.compile(r"(filter_rows_kernel|filter_kernel|bitmap_kernel|Memcpy \w+|Memset)")


def device_ms(torch, fn: Callable, calls: int = 20, before: Callable = None) -> Dict[str, float]:
    """Device milliseconds a call by kernel or copy (``torch.profiler``),
    each summed over its launches and divided by ``calls``; empty if the
    profiler saw no device activity.  ``before()`` runs ahead of each call
    and must launch nothing but device-to-device copies, which are not
    counted."""
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
        if e.device_type != torch.autograd.DeviceType.CUDA or "Memcpy DtoD" in e.name:
            continue
        mark = _NAMES.search(e.name)
        name = mark.group(0) if mark else e.name[:40]
        per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in per.items()}


def bitmap_sectors(prov) -> int:
    """32-byte sectors of int32 buckets (8 rows) holding a provenance row."""
    n = int(prov.shape[0])
    full = prov[: n - n % 8].view(-1, 8).any(dim=1).sum()
    return int(full) + int(bool(prov[n - n % 8:].any()))
