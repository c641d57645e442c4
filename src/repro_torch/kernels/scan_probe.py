"""Where the sLSTM scan kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.scan_probe [--paired DIR | --plans]

At xlstm-350m's layer (:data:`SHAPES`: 16 rows of 2,048 positions, 4 heads
of 256 units, bf16, ``chip_smoke.SLSTM_SHAPE``), its 64-token prompt and 12
rows of the layer:

- **variants**: ``csrc/slstm_scan.cu`` patched to drop one part at a time
  (the recurrent product; the loads of h in it; h crossing CTAs, each CTA
  delivering to itself only; the cell math; the two-ahead load of x, which
  then loads where it is used), or to keep only the product; each built
  with the kernels' flags into ``build/repro_torch/probe/`` and timed by
  ``torch.profiler`` device time, two rounds;
- **sections**: ``clock64`` sums over one position's sections (the wait for
  h, the wait for the other half's turn, the product, the barrier, the
  reduction and cell, the barrier, the sends) in thread 0 of CTA 0, from an
  instrumented copy.

``--plans`` instead times every plan the source takes (groups of rows,
halves) at :data:`PLAN_SHAPES` by CUDA events, with each plan's resident
clusters, whether its ``hs`` equals the first plan's bit for bit, and the
plan ``slstm_scan.plan`` chooses: what its cost model is fitted to.

``--paired DIR`` instead times this tree against the checkout at ``DIR``
(e.g. the parent commit, unpacked with ``git archive``), each run a process
of its own, in turns (this, DIR, DIR, this, twice): the device ms a call at
the layer and the prompt, and a digest of ``hs`` on the same seeded inputs,
so the two trees' outputs are compared bit for bit.

A patch that no longer finds its text in the source raises; the CPU test
``tests/test_torch_ssm.py::test_scan_probe_patches_apply`` applies every
patch without building.  The patched kernels compute wrong results on
purpose: nothing here is on any path.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List

from repro_torch.kernels import build

SOURCE = build.CSRC / "slstm_scan.cu"
PROBE_DIR = build.BUILD_DIR / "probe"
# (B, S, H, uh), bf16 x, wr and bias: the layer at the long prompt and at
# serve()'s 64-token prompt.
SHAPES = {"layer": (16, 2048, 4, 256), "prompt": (16, 64, 4, 256)}
# The variants also run 12 rows of the layer (two rows a half).
VARIANT_SHAPES = {**SHAPES, "12 rows": (12, 2048, 4, 256)}
# --plans: the layer at 16, 4 and 1 rows, and the prompt.
PLAN_SHAPES = ((16, 2048, 4, 256), (4, 2048, 4, 256), (1, 2048, 4, 256), (16, 64, 4, 256))
SECTIONS = ("wait for h", "wait for the turn", "product", "barrier", "reduction and cell",
            "barrier", "send")


def _sub(src: str, old: str, new: str) -> str:
    """Replace the one occurrence of ``old``; raise if there is not exactly one."""
    if src.count(old) != 1:
        raise ValueError(f"scan_probe: the kernel source has {src.count(old)} of {old[:60]!r}")
    return src.replace(old, new)


def no_product(src: str) -> str:
    """The recurrent product is skipped: every partial sum is 0."""
    src = _sub(src, "  const int u4 = u0 + ((u1 - u0) & ~3);", "  const int u4 = u0;")
    return _sub(src, "      for (int u = u4; u < u1; ++u) {",
                "      for (int u = u1; u < u1; ++u) {")


def no_h_loads(src: str) -> str:
    """The product's h is made in registers: no shared-memory loads of h (the
    weights are still loaded)."""
    return _sub(src, "    for (int r = 0; r < R; ++r) h[r] = *reinterpret_cast<const float4*>"
                     "(hp + r * uh8 + u);",
                "    for (int r = 0; r < R; ++r) h[r] = make_float4(1e-3f * r, 1e-3f * u, 0.5f, "
                "0.25f);")


# The wait for h and the expectation of the next bytes on the same barrier.
_WAIT = ("      wait_cluster(bar, ((t - 1) >> 1) & 1);\n"
         "      if (tid == 0 && t + 2 < seq) mbar_expect_tx(bar, bytes);  // h of position t + 1\n")
_SENDS = "          for (int k = p0; k < cluster; k += stride)\n"


def no_exchange(src: str) -> str:
    """Each CTA delivers its h to itself only and waits for those bytes: no
    h crosses CTAs (the rest of a head's h stays 0)."""
    src = _sub(src, "  const uint32_t bytes = (uint32_t)rows * uh * 4;",
               "  const uint32_t bytes = (uint32_t)rows * n * 4;")
    if src.count(_SENDS) != 2:
        raise ValueError("scan_probe: the sends moved")
    return src.replace(_SENDS, "          for (int k = p0 == 0 ? rank : cluster; k < cluster; "
                               "k = cluster)\n")


_CELL_HEAD = "      const float logf = "
_CELL_TAIL = "      const float h = __fdiv_rn(__fmul_rn(sig, c_st), fmaxf(n_st, 1e-6f));\n"


def no_cell(src: str) -> str:
    """h is a scaled sum of the four pre-activations: no exp, log1p, tanh or
    division."""
    if src.count(_CELL_HEAD) != 1 or src.count(_CELL_TAIL) != 1:
        raise ValueError("scan_probe: the cell's body moved")
    return (src[:src.index(_CELL_HEAD)]
            + "      (void)m_st; (void)n_st; (void)c_st;\n"
            + "      const float h = __fmul_rn(__fadd_rn(__fadd_rn(zt, it), __fadd_rn(ft, ot)), "
              "1e-3f);\n"
            + src[src.index(_CELL_TAIL) + len(_CELL_TAIL):])


def no_prefetch(src: str) -> str:
    """x is loaded where it is used, after the product, not two positions
    ahead."""
    src = _sub(src, "cell && t + 2 < seq ?", "cell && t + 2 < 0 ?")
    return _sub(src, "__fadd_rn(widen(x_cur[q]), rec[q])",
                "__fadd_rn(widen(xq[(size_t)t * x_step + q * uh]), rec[q])")


def _chain(*patches: Callable[[str], str]) -> Callable[[str], str]:
    def apply(src: str) -> str:
        for patch in patches:
            src = patch(src)
        return src
    return apply


VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "no product": no_product,
    "no exchange": no_exchange,
    "no cell": no_cell,
    "no h loads": no_h_loads,
    "no prefetch": no_prefetch,
    "product only": _chain(no_exchange, no_cell),
    "no product, exchange or cell": _chain(no_product, no_exchange, no_cell),
}


_LOOP_END = "    }\n  }\n  cluster_sync();  // no CTA leaves"


def instrument(src: str) -> str:
    """A copy of the source that sums clock64 deltas per section of a
    position; thread 0 of CTA (0, 0) (half 0's) writes them to ``g_probe``
    (slot 7 counts positions)."""
    src = _sub(src, '#include "hopper.cuh"\n',
               '#include "hopper.cuh"\n'
               "__device__ unsigned long long g_probe[8];\n"
               "#define MARK(i) { long long t_ = clock64(); probe[i] += t_ - t_prev; "
               "t_prev = t_; }\n")
    anchor = ("  cluster_sync();  // every CTA's barriers are initialised, its h zeroed and wr "
              "copied\n")
    src = _sub(src, anchor, anchor + "  unsigned long long probe[8] = {0};\n"
                                     "  long long t_prev = clock64();\n")
    anchor = ("      if (tid == 0 && t + 2 < seq) mbar_expect_tx(bar, bytes);  // h of position "
              "t + 1\n    }\n")
    src = _sub(src, anchor, anchor + "    MARK(0);\n")
    anchor = ("    if (turns) named_bar_sync(3 + half, 2 * half_threads);  // the other half's "
              "product is done\n")
    src = _sub(src, anchor, anchor + "    MARK(1);\n")
    anchor = "    named_bar_sync(1 + half, half_threads);  // the partial sums are whole\n"
    src = _sub(src, anchor, "    MARK(2);\n" + anchor + "    MARK(3);\n")
    anchor = "      out_s[cr * n + ci] = h;\n    }\n"
    src = _sub(src, anchor, anchor + "    MARK(4);\n")
    anchor = ("      named_bar_sync(1 + half, half_threads);  // out is whole; the partial "
              "sums are read\n")
    src = _sub(src, anchor, anchor + "      MARK(5);\n")
    src = _sub(src, _LOOP_END,
               "    }\n    MARK(6);\n    probe[7] += 1;\n  }\n"
               "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)\n"
               "    for (int i = 0; i < 8; ++i) g_probe[i] = probe[i];\n"
               "  cluster_sync();  // no CTA leaves")
    return src + ('\nextern "C" int probe_read(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


def all_patches() -> Dict[str, str]:
    """Every patched source by name (no build): what the CPU test applies."""
    src = SOURCE.read_text()
    out = {name: patch(src) for name, patch in VARIANTS.items()}
    out["sections"] = instrument(src)
    return out


def _build(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        cu, so = PROBE_DIR / f"s{i}.cu", PROBE_DIR / f"s{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES["slstm_scan"].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def inputs(torch, shape, seed: int = 9):
    """Seeded bf16 xproj, wr (at the model's 1/sqrt(uh)) and bias on the card,
    as ``chip_smoke._kernel_slstm_scan`` makes them."""
    b, s, hh, uh = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn((b, s, 4 * hh * uh), generator=gen, device=dev).to(torch.bfloat16)
    wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(torch.bfloat16)
    bias = (torch.randn((4 * hh * uh,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    return xproj, wr, bias


# The script each tree runs in ``paired``: it reads only what every commit
# since the scan came has (``slstm_scan``'s signature), makes its inputs as
# ``inputs`` does, and profiles the calls itself.
PAIRED_SCRIPT = """
import hashlib, json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.slstm_scan import slstm_scan
dev = torch.device("cuda")
out = {}
for label, (b, s, hh, uh) in json.loads(sys.argv[1]).items():
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((b, s, 4 * hh * uh), generator=gen, device=dev).to(torch.bfloat16)
    wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(torch.bfloat16)
    bias = (torch.randn((4 * hh * uh,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    hs = slstm_scan(x, wr, bias)
    digest = hashlib.sha256(hs.cpu().numpy().tobytes()).hexdigest()[:16]
    torch.save(hs.cpu(), f"{sys.argv[2]}/{label}-{digest}.pt")
    calls = 5 if s > 256 else 20
    for _ in range(2):
        slstm_scan(x, wr, bias)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            slstm_scan(x, wr, bias)
        torch.cuda.synchronize()
    ms = sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA) / calls
    out[label] = [round(ms, 4), digest]
print(json.dumps(out))
"""


def paired(trees: List[Path], rounds: int = 2) -> Dict[str, Dict[str, list]]:
    """Each shape's [device ms, digest of hs] in every tree (a checkout's
    root each, its ``src`` first on the path), in turns: ``trees``, then
    reversed, ``rounds`` times over, each run a process of its own; each
    distinct hs is kept in PROBE_DIR as ``<label>-<digest>.pt``."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    order: List[Path] = []
    for _ in range(rounds):
        order += list(trees) + list(trees)[::-1]
    out: Dict[str, Dict[str, list]] = {str(t): {} for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        proc = subprocess.run([sys.executable, "-c", PAIRED_SCRIPT, json.dumps(SHAPES),
                               str(PROBE_DIR)],
                              cwd=str(tree), env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"paired run in {tree} failed:\n{proc.stderr[-4000:]}")
        for label, got in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[str(tree)].setdefault(label, []).append(got)
    return out


def time_plans(torch, shape) -> None:
    """Every plan the source takes for ``shape`` (bf16, clusters as
    :func:`slstm_scan.plan` sizes them): CUDA-event ms a call, whether its
    hs equals the first plan's bit for bit, and the plan chosen."""
    from repro_torch.kernels import slstm_scan as SS

    b, s, hh, uh = shape
    x, wr, bias = inputs(torch, shape)
    dev = x.device
    chosen = SS.card_plan(0, 1, 1, b, hh, uh)
    lib = build.library(SS.NAME)
    first = None
    for halves in range(1, SS.MAX_HALVES + 1):
        for groups in range(1, b + 1):
            rows = SS.rows_of(b, groups, halves)
            if b // groups < halves or rows > SS.MAX_ROWS:
                continue
            smem = SS.smem_bytes(uh, chosen.cluster, rows, halves, 2)
            hs = torch.empty((b, s, hh, uh), device=dev)

            def call():
                build.check(lib.slstm_scan_launch(
                    0, build.stream_handle(dev), 1, 1, x.data_ptr(), wr.data_ptr(),
                    bias.data_ptr(), hs.data_ptr(), b, s, hh, uh, chosen.cluster, groups, halves,
                    smem), SS.NAME)

            call()
            torch.cuda.synchronize()
            first = hs.clone() if first is None else first
            same = bool(torch.equal(first, hs))
            resident = lib.slstm_scan_max_clusters(0, 1, 1, b, hh, uh, chosen.cluster, groups,
                                                   halves, smem)
            ms = _event_ms(torch, call, reps=5 if s > 256 else 50)
            print(f"[plans] {shape}: groups {groups}, halves {halves}, rows {rows}, "
                  f"{hh * groups} clusters ({resident} resident): {ms:.4f} ms, hs equal to the "
                  f"first plan's: {same}", flush=True)
    print(f"[plans] {shape}: plan() chooses {chosen}", flush=True)


def _event_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _smi() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels import measure
    from repro_torch.kernels import slstm_scan as SS

    if "--paired" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--paired") + 1]).resolve()
        here = Path(__file__).resolve().parents[3]
        runs = paired([here, other])
        for tree, got in runs.items():
            print(f"[paired] {tree}: {got}", flush=True)
        for label in SHAPES:
            first = [got[label][0][1] for got in runs.values()]
            digests = {d for got in runs.values() for _, d in got[label]}
            a, b = (torch.load(PROBE_DIR / f"{label}-{d}.pt") for d in first)
            print(f"[paired] {label}: hs equal bit for bit across trees and runs: "
                  f"{len(digests) == 1}; max |this - other| {float((a - b).abs().max()):.3e} "
                  f"at scale {float(b.abs().max()):.3f}; reruns of each tree bit-equal: "
                  f"{all(len({d for _, d in got[label]}) == 1 for got in runs.values())}",
                  flush=True)
        _smi()
        return 0

    if "--plans" in sys.argv:
        for shape in PLAN_SHAPES:
            time_plans(torch, shape)
        _smi()
        return 0

    libs = _build(all_patches())
    data = {label: inputs(torch, shape) for label, shape in VARIANT_SHAPES.items()}
    kept = build._LIBS.get(SS.NAME)
    try:
        for label, (x, wr, bias) in data.items():
            p = SS.card_plan(0, 1, 1, x.shape[0], wr.shape[0], wr.shape[1])
            print(f"[plan] {label} {VARIANT_SHAPES[label]}: {p}", flush=True)
        for rnd in range(2):
            for name in VARIANTS:
                build._LIBS[SS.NAME] = libs[name]
                times = []
                for label, (x, wr, bias) in data.items():
                    per = measure.device_ms(torch, lambda: SS.slstm_scan(x, wr, bias),
                                            calls=20 if label == "prompt" else 5)
                    times.append(f"{label} {sum(per.values()):.4f} ms")
                print(f"[variants] round {rnd}, {name}: " + "; ".join(times), flush=True)
        lib = libs["sections"]
        lib.probe_read.argtypes = [ctypes.c_void_p]
        build._LIBS[SS.NAME] = lib
        for label, (x, wr, bias) in data.items():
            SS.slstm_scan(x, wr, bias)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            build.check(lib.probe_read(buf), "probe_read")
            p = list(buf)
            steps = max(p[7], 1)
            print(f"[sections] {label}, CTA 0, thread 0: {p[7]} positions; cycles a position: "
                  + ", ".join(f"{name} {p[i] / steps:.0f}" for i, name in enumerate(SECTIONS))
                  + f"; total {sum(p[:7]) / steps:.0f}", flush=True)
    finally:
        if kept is None:
            build._LIBS.pop(SS.NAME, None)
        else:
            build._LIBS[SS.NAME] = kept
    _smi()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
