"""Where the scan kernels spend their time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.scan_probe [--paired DIR | --plans]
    PYTHONPATH=src python -m repro_torch.kernels.scan_probe --selective [--paired DIR]
    PYTHONPATH=src python -m repro_torch.kernels.scan_probe --bwd [--paired DIR | --plans]
    PYTHONPATH=src python -m repro_torch.kernels.scan_probe --bwd --split [slstm | selective]
        [--tree DIR]

The sLSTM scan (``csrc/slstm_scan.cu``), by default: at xlstm-350m's layer
(:data:`SHAPES`: 16 rows of 2,048 positions, 4 heads of 256 units, bf16,
``chip_smoke.SLSTM_SHAPE``), its 64-token prompt and 12 rows of the layer:

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

``--selective`` probes the selective scan (``csrc/selective_scan.cu``) at
jamba-1.5-large's layer (:data:`SEL_SHAPES`: ``chip_smoke.SCAN_SHAPE``, 16
rows of 2,048 positions, di 16,384, 16 states, bf16 x1 and z, and its
64-token prompt), each build compiling the 16-state instances only:

- **variants** (:data:`SEL_VARIANTS`): the source patched to drop one part
  at a time (the exponential, a multiply in its place; y's sum, and with it
  the loads of c; the loads of b and c, made in registers; the producer's
  copies, the compute warps reading whatever the ring holds; the gated
  entry's softplus and gate), or to take another shape (the positions of a
  stage not unrolled; a register target of 6 or 5 blocks an SM; two
  channels a thread; 8 positions a stage); each one's registers and spills
  (``-Xptxas -v``) and resident blocks, and both entries' ms a call by CUDA
  events around 10 (the layer) or 50 (the prompt) back-to-back calls, two
  rounds;
- **counts**: the SASS (``cuobjdump -sass``) of each
  variant's 16-state bf16 instances: the instructions of the loop over
  positions, per position and per state and position, and the issue floor
  they give at 128 issues a clock per SM and 1,980 MHz on the card's SMs.

``--selective --paired DIR`` times this tree against ``DIR`` in turns, each
run a process of its own, by CUDA events around back-to-back calls (the
profiler's per-kernel sums dropped a launch now and then at these
shapes): the scan-only entry at both shapes, and at the
layer the gated entry where a tree has it, else the ops it replaced
(``ref.softplus``, the scan-only kernel, the skip term, the gate and the
cast: the parent's ``mamba_train``); each with a digest of its output on
the same seeded inputs, so the trees are compared bit for bit.

``--bwd`` times the backward kernels (``csrc/slstm_scan_bwd.cu``,
``csrc/selective_scan_bwd.cu``, gated) at :data:`BWD_SHAPES`: xlstm-350m's
sLSTM layer at its training microbatch (4 rows of 2,048) and at the forward
row's 16 rows, jamba-1.5-large's mamba layer at its cut's training
microbatch (1 row of 2,048) and at ``chip_smoke.SCAN_SHAPE``'s 16, bf16.
For each, by CUDA events: the forward alone, the forward writing the
backward's residuals (what asking for a gradient costs it), the backward
kernel (the sLSTM's dpre; then ``dwr``'s float32 matrix product apart) and
the plain backward once; the kernel's largest |diff| from the plain
backward over each gradient's scale, a rerun's bits and the launch plan.
``--bwd --paired DIR`` runs the same seeded cases in this tree and in
``DIR`` in turns, each run a process of its own: both forwards with no
gradient asked for, with digests of their outputs (the trees compared bit
for bit), and the forward with residuals and the backward where a tree has
them.  ``--bwd --split`` splits both backward kernels (``slstm`` or
``selective`` only one): the source and its patched variants, each built
and timed by CUDA events at xlstm-350m's 4 and 16 rows (the dpre kernel)
and at jamba-1.5-large's 1 and 16 rows (:data:`SEL_BWD_SPLIT_SHAPES`, the
whole call), two rounds, then an instrumented copy's ``clock64`` sections a
position; the selective one also prints each variant's registers, spills,
resident blocks and the SASS count of its loop over stages with the issue
floor it gives.  ``--bwd --plans`` times every sLSTM backward plan.
``--tree DIR`` runs any of these on the checkout at DIR (its package,
sources and build directory) with this probe.

A patch that no longer finds its text in the source raises; the CPU tests
``tests/test_torch_ssm.py::test_scan_probe_patches_apply`` and
``tests/test_torch_ssm_train.py::test_scan_probe_*bwd_patches_apply`` apply
every patch without building.  The patched kernels compute wrong results on
purpose: nothing here is on any path.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
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
    anchor = "        res.m[at] = m_st;\n      }\n    }\n"  # the cell's end
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


def _build(sources: Dict[str, str], kernel: str = "slstm_scan"):
    """Each source built in parallel with the kernels' flags, bound with
    ``kernel``'s signatures: ``(libraries, compiler logs)`` by name."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        cu, so = PROBE_DIR / f"{kernel}{i}.cu", PROBE_DIR / f"{kernel}{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for name, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES[kernel].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        libs[name], logs[name] = lib, out
    return libs, logs


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
                    smem, None, None, None, None), SS.NAME)

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


# ---- the selective scan ----------------------------------------------------

SEL_SOURCE = build.CSRC / "selective_scan.cu"
SEL_NAME = "selective_scan"
# (B, S, di, n), bf16 x1 and z: jamba-1.5-large's layer at the long prompt
# (chip_smoke.SCAN_SHAPE) and at serve()'s 64-token prompt.
SEL_SHAPES = {"layer": (16, 2048, 16384, 16), "prompt": (16, 64, 16384, 16)}
SEL_STATES = 16  # the probe's builds compile this instance only
CLOCK_HZ = 1.98e9  # the H100's SM clock at its maximum
INSTRS_PER_CLOCK = 128  # an SM's thread instructions a clock: 4 schedulers, a warp each


def _sel_patch(old: str, new: str) -> Callable[[str], str]:
    return lambda src: _sub(src, old, new)


_ROLLED = ("#pragma unroll\n      for (int q = 0; q < kSpan; ++q) {",
           "#pragma unroll 1\n      for (int q = 0; q < kSpan; ++q) {")
SEL_VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "positions not unrolled": _sel_patch(*_ROLLED),
    "6 blocks an SM, not unrolled": _chain(
        _sel_patch("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 6;"),
        _sel_patch(*_ROLLED)),
    "6 blocks an SM": _sel_patch("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 6;"),
    "5 blocks an SM": _sel_patch("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;"),
    "two channels a thread": _sel_patch("constexpr int kPer = 1;", "constexpr int kPer = 2;"),
    "8 positions a stage": _sel_patch("constexpr int kSpan = 4;", "constexpr int kSpan = 8;"),
    "no exp": _sel_patch("const float decay = expf(__fmul_rn(d[e], av[e][k]));",
                         "const float decay = __fmul_rn(d[e], av[e][k]);"),
    "no y sum": _sel_patch("y[e] = fmaf(h[e][k], ck[kk], y[e]);", "y[e] = h[e][k];"),
    "no b or c loads": _sel_patch(
        "const float4 b4 = sb[k4], c4 = sc[k4];",
        "const float4 b4 = make_float4(0.5f * q, 0.25f * k4, 0.125f, 0.0625f), c4 = b4; "
        "(void)sb; (void)sc;"),
    "no copies": _chain(
        _sel_patch("if (lane == 0) mbar_expect_tx(full, np * (xb + 4 * cnt + (G ? xb : 0) + 8 * N));",
                   "if (lane == 0) mbar_expect_tx(full, 0);"),
        _sel_patch("if (lane < np) {  // lane q copies", "if (lane < 0) {  // lane q copies"),
        _sel_patch("} else if (lane == 31) {  // the span's b and c rows",
                   "} else if (lane < 0) {  // the span's b and c rows")),
    "no softplus or gate": _chain(
        _sel_patch("d[e] = __fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t))));", "d[e] = t;"),
        _sel_patch("const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-zv[e])));",
                   "const float sig = zv[e];")),
}


def sel_patches() -> Dict[str, str]:
    """Every patched selective-scan source by name (no build)."""
    src = SEL_SOURCE.read_text()
    return {name: patch(src) for name, patch in SEL_VARIANTS.items()}


def _sel_build(sources: Dict[str, str], kernel: str = SEL_NAME) -> Dict[str, tuple]:
    """Each source's 16-state build, in parallel, bound with ``kernel``'s
    signatures: its library, its path and the compiler's log."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        cu, so = PROBE_DIR / f"{kernel}{i}.cu", PROBE_DIR / f"{kernel}{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DSCAN_ONE_STATE_COUNT={SEL_STATES}", "-I",
               str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES[kernel].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        out[name] = (lib, so, log)
    return out


def ptxas_lines(log: str, states: int = SEL_STATES) -> List[str]:
    """The registers and spills ``-Xptxas -v`` reports for each kernel of
    ``states`` states: one line a kernel."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and f"ILi{states}E" in line:
            name = re.search(rf"scan_kernelILi{states}E(\w+?)EEvNS", line)
            info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "registers" in x or "spill" in x)
            out.append(f"{name.group(1) if name else line.strip()}: {info}")
    return out


def _cuobjdump() -> str:
    """``cuobjdump`` from the CUDA toolkit beside ``nvcc`` or on the path, or
    the one Triton's package carries; empty if there is none."""
    cands = [str(Path(build._nvcc()).parent / "cuobjdump"), shutil.which("cuobjdump") or ""]
    try:
        import triton

        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" /
                         "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.path.exists(c)), "")


def sass_functions(so: Path) -> Dict[str, list]:
    """Each kernel's SASS instructions (address, opcode and operands) by
    mangled name, from ``cuobjdump -sass``; empty without it."""
    tool = _cuobjdump()
    if not tool:
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    out: Dict[str, list] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return out


def loop_counts(instrs, states: int, gated: bool, ex2_per_position: float = None) -> dict:
    """The loop over positions: the smallest backward branch's body that
    holds at least ``states`` MUFU.EX2, or given ``ex2_per_position`` (its
    count a position, by default one a state and the softplus's and the
    gate's when gated) that many; its instructions per position and per
    state and position, and its MUFU.EX2 a position."""
    best = None
    for at, text in instrs:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= at:
            continue
        body = [t for a, t in instrs if int(m.group(1), 16) <= a <= at]
        ex2 = sum("MUFU.EX2" in t for t in body)
        if ex2 >= (ex2_per_position or states) and (best is None or len(body) < len(best[0])):
            best = (body, ex2)
    if best is None:
        return {}
    body, ex2 = best
    per_pos = ex2 / (ex2_per_position or states + (2 if gated else 0))
    return dict(instructions=len(body), positions=per_pos,
                per_position=len(body) / per_pos, per_state=len(body) / per_pos / states,
                ex2=ex2 / per_pos, lds=sum(t.startswith("LDS") for t in body) / per_pos)


def sass_counts(so: Path, states: int = SEL_STATES) -> Dict[str, dict]:
    """:func:`loop_counts` of the bf16 instances of ``states`` states in the
    library at ``so``, by entry (``scan``, ``gated``)."""
    out = {}
    for name, instrs in sass_functions(so).items():
        m = re.search(rf"scan_kernelILi{states}E13__nv_bfloat16Lb([01])ELb0E", name)
        if m:
            out["gated" if m.group(1) == "1" else "scan"] = loop_counts(instrs, states,
                                                                         m.group(1) == "1")
    return out


def issue_floor_ms(shape, per_position: float, sms: int) -> float:
    """The schedulers' least ms: B S di positions and channels, each
    ``per_position`` instructions, at INSTRS_PER_CLOCK a clock on ``sms`` SMs."""
    b, s, di, _ = shape
    return b * s * di * per_position / (sms * INSTRS_PER_CLOCK * CLOCK_HZ) * 1e3


def sel_inputs(torch, shape, seed: int = 9):
    """Seeded inputs on the card, as ``chip_smoke._kernel_selective_scan``
    makes them: x1 = silu of bf16 noise, dt = softplus of noise, a = -e,
    b and c noise; for the gated entry z (a view of a (B, S, 2 di) bf16
    tensor), the raw dt (noise), dt_bias and dd."""
    from repro_torch.kernels import ref

    b, s, di, n = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16))
    dt_raw = torch.randn((b, s, di), generator=gen, device=dev)
    a = -torch.exp(torch.ones((di, n), device=dev))
    bmat = torch.randn((b, s, n), generator=gen, device=dev)
    cmat = torch.randn((b, s, n), generator=gen, device=dev)
    z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(torch.bfloat16)[..., di:]
    dt_bias = torch.randn((di,), generator=gen, device=dev) * 0.1
    dd = torch.randn((di,), generator=gen, device=dev)
    return dict(x1=x1, dt=ref.softplus(dt_raw), a=a, bmat=bmat, cmat=cmat, z=z, dt_raw=dt_raw,
                dt_bias=dt_bias, dd=dd)


# The script each tree runs in ``sel_paired``: it reads only what every
# commit since the scan came has (``selective_scan``'s signature, ``ref``'s
# softplus and silu), makes its inputs as ``sel_inputs`` does, and profiles
# the calls itself.  "gated" is the tree's selective_scan_gated where it has
# one, else the parent's mamba_train ops around its scan-only kernel.
SEL_PAIRED_SCRIPT = """
import hashlib, json, sys, torch
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as SS
dev = torch.device("cuda")

def device_ms(fn, calls):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls

def digest(t, label):
    d = hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]
    torch.save(t.cpu(), f"{sys.argv[2]}/sel-{label}-{d}.pt")
    return d

out = {}
for label, (b, s, di, n) in json.loads(sys.argv[1]).items():
    gen = torch.Generator(device=dev).manual_seed(9)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16))
    dt_raw = torch.randn((b, s, di), generator=gen, device=dev)
    a = -torch.exp(torch.ones((di, n), device=dev))
    bm = torch.randn((b, s, n), generator=gen, device=dev)
    cm = torch.randn((b, s, n), generator=gen, device=dev)
    z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(torch.bfloat16)[..., di:]
    bias = torch.randn((di,), generator=gen, device=dev) * 0.1
    dd = torch.randn((di,), generator=gen, device=dev)
    dt = ref.softplus(dt_raw)
    calls = 10 if s > 256 else 50
    scan = lambda: SS.selective_scan(x1, dt, a, bm, cm)
    out["scan " + label] = [round(device_ms(scan, calls), 4), digest(scan(), "scan-" + label)]
    if s <= 256:
        continue
    del dt
    if hasattr(SS, "selective_scan_gated"):
        gated = lambda: SS.selective_scan_gated(x1, z, dt_raw, bias, a, bm, cm, dd, x1.dtype)
        kind = "gated entry"
    else:
        def gated():
            y = SS.selective_scan(x1, ref.softplus(dt_raw + bias), a, bm, cm)
            y = y + dd * x1.to(torch.float32)
            return (y * ref.silu(z.to(torch.float32))).to(x1.dtype)
        kind = "unfused chain"
    out["gated " + label] = [round(device_ms(gated, calls), 4), digest(gated(), "gated-" + label),
                             kind]
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def sel_paired(trees: List[Path], rounds: int = 2) -> Dict[str, Dict[str, list]]:
    """Each case's [device ms, digest(, kind)] in every tree, in turns
    (``trees``, then reversed, ``rounds`` times over), each run a process of
    its own; each distinct output is kept in PROBE_DIR."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    order: List[Path] = []
    for _ in range(rounds):
        order += list(trees) + list(trees)[::-1]
    out: Dict[str, Dict[str, list]] = {str(t): {} for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        proc = subprocess.run([sys.executable, "-c", SEL_PAIRED_SCRIPT, json.dumps(SEL_SHAPES),
                               str(PROBE_DIR)], cwd=str(tree), env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"paired run in {tree} failed:\n{proc.stderr[-4000:]}")
        for label, got in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[str(tree)].setdefault(label, []).append(got)
    return out


def _spread(values: List[float]) -> str:
    return f"{min(values):.4f}-{max(values):.4f} (median {sorted(values)[len(values) // 2]:.4f})"


def selective_main(torch) -> int:
    """``--selective``: the variants and counts, or with ``--paired DIR``
    the paired runs."""
    from repro_torch.kernels import selective_scan as SEL

    if "--paired" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--paired") + 1]).resolve()
        here = Path(__file__).resolve().parents[3]
        runs = sel_paired([here, other])
        for tree, got in runs.items():
            print(f"[sel paired] {tree}: {got}", flush=True)
        mine, theirs = runs[str(here)], runs[str(other)]
        for label in mine:
            a = [ms for ms, *_ in mine[label]]
            b = [ms for ms, *_ in theirs[label]]
            digests = {d for got in runs.values() for _, d, *_ in got[label]}
            reruns = all(len({d for _, d, *_ in got[label]}) == 1 for got in runs.values())
            print(f"[sel paired] {label}: this tree ({mine[label][0][2:] or 'kernel'}) "
                  f"{_spread(a)} ms, other ({theirs[label][0][2:] or 'kernel'}) {_spread(b)} ms, "
                  f"ratio of medians {sorted(a)[len(a) // 2] / sorted(b)[len(b) // 2]:.3f}; "
                  f"outputs equal bit for bit across trees: {len(digests) == 1}; reruns of "
                  f"each tree bit-equal: {reruns}", flush=True)
        _smi()
        return 0

    built = _sel_build(sel_patches())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (lib, so, log) in built.items():
        occ = {}
        for gated in (0, 1):
            buf = (ctypes.c_int * 5)()
            build.check(lib.selective_scan_occupancy(0, 1, gated, SEL_STATES, buf), name)
            occ["gated" if gated else "scan"] = list(buf)
        print(f"[sel build] {name}: {'; '.join(ptxas_lines(log))}; occupancy [blocks an SM, "
              f"SMs, shared bytes, threads, channels a unit] {occ}", flush=True)
        for entry, c in sass_counts(so).items():
            if not c:
                print(f"[sel sass] {name} {entry}: no loop found", flush=True)
                continue
            print(f"[sel sass] {name} {entry}: loop of {c['instructions']} instructions for "
                  f"{c['positions']:g} positions: {c['per_position']:.1f} a position, "
                  f"{c['per_state']:.2f} a state and position ({c['ex2']:g} MUFU.EX2, "
                  f"{c['lds']:g} LDS a position); issue floor at the layer "
                  f"{issue_floor_ms(SEL_SHAPES['layer'], c['per_position'], sms):.3f} ms",
                  flush=True)
    if not _cuobjdump():
        print("[sel sass] no cuobjdump on this machine: the SASS is not counted", flush=True)
    kept = build._LIBS.get(SEL_NAME)
    try:
        for rnd in range(2):
            for label, shape in SEL_SHAPES.items():
                d = sel_inputs(torch, shape)
                calls = 10 if shape[1] > 256 else 50
                scan = lambda: SEL.selective_scan(d["x1"], d["dt"], d["a"], d["bmat"], d["cmat"])
                gated = lambda: SEL.selective_scan_gated(
                    d["x1"], d["z"], d["dt_raw"], d["dt_bias"], d["a"], d["bmat"], d["cmat"],
                    d["dd"])
                for name, (lib, _, _) in built.items():
                    build._LIBS[SEL_NAME] = lib
                    times = {entry: _event_ms(torch, fn, calls)
                             for entry, fn in (("scan", scan), ("gated", gated))}
                    print(f"[sel variants] round {rnd}, {label} {shape}, {name}: scan "
                          f"{times['scan']:.4f} ms, gated {times['gated']:.4f} ms", flush=True)
                del d
                torch.cuda.empty_cache()
    finally:
        if kept is None:
            build._LIBS.pop(SEL_NAME, None)
        else:
            build._LIBS[SEL_NAME] = kept
    _smi()
    return 0


# ---- the backward kernels -------------------------------------------------

BWD_SHAPES = {"slstm train": ("slstm", (4, 2048, 4, 256)),
              "slstm layer": ("slstm", (16, 2048, 4, 256)),
              "gated train": ("gated", (1, 2048, 16384, 16)),
              "gated layer": ("gated", (16, 2048, 16384, 16))}

# The script each tree runs in ``bwd_paired``: inputs as ``bwd_inputs``
# makes them; a tree without residuals (the parent of the backward kernels)
# times its forwards only.
BWD_PAIRED_SCRIPT = """
import hashlib, json, sys, torch
from repro_torch.kernels import scan_probe as P
dev = torch.device("cuda")

def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]

out = {}
for label, (kind, shape) in json.loads(sys.argv[1]).items():
    case = P.bwd_case(torch, kind, shape)
    row = {"forward": [round(P._event_ms(torch, case["forward"], 3), 4),
                       digest([case["forward"]()])]}
    if "residuals" in case:
        row["forward, residuals"] = [round(P._event_ms(torch, case["residuals"], 3), 4),
                                     digest(case["residuals"]()[:1])]
        row["backward"] = [round(P._event_ms(torch, case["backward"], 3), 4),
                           digest(case["backward"]())]
    out[label] = row
    del case
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def bwd_case(torch, kind: str, shape, seed: int = 9) -> dict:
    """One ``--bwd`` case on the card, seeded: ``forward`` (no gradient
    asked for), and where the tree has them ``residuals`` (the forward
    writing what the backward reads: its first output is the forward's),
    ``backward`` (the kernel from those residuals) and ``plain`` (the
    plain backward from the plain forward's residuals)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as SEL
    from repro_torch.kernels import slstm_scan as SS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "slstm":
        b, s, hh, uh = shape
        x = torch.randn((b, s, 4 * hh * uh), generator=gen, device=dev).to(torch.bfloat16)
        wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(
            torch.bfloat16)
        bias = (torch.randn((4 * hh * uh,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        dhs = torch.randn((b, s, hh, uh), generator=gen, device=dev)
        case = {"forward": lambda: SS.slstm_scan(x, wr, bias)}
        if hasattr(SS, "slstm_scan_residuals"):
            res = SS.slstm_scan_residuals(x, wr, bias)
            case["residuals"] = lambda: SS.slstm_scan_residuals(x, wr, bias)
            case["backward"] = lambda: SS.slstm_scan_bwd(x, wr, bias, res[1], res[2], res[0],
                                                         dhs)
            case["dpre"] = lambda: SS._launch_bwd(wr, res[1], res[2], dhs)

            def plain():
                p_hs, p_pre, p_states = ref.slstm_scan_fwd_plain(x, wr, bias)
                return ref.slstm_scan_bwd_plain(x, wr, bias, p_pre, p_states, p_hs, dhs)

            case["plain"] = plain
        return case
    b, s, di, n = shape
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
    case = {"forward": lambda: SEL.selective_scan_gated(*args)}
    if hasattr(SEL, "selective_scan_states_of"):
        res = SEL.selective_scan_states_of(x1, dt_raw, a, bmat, cmat, z, dt_bias, dd)
        case["residuals"] = lambda: SEL.selective_scan_states_of(x1, dt_raw, a, bmat, cmat, z,
                                                                 dt_bias, dd)
        case["backward"] = lambda: SEL.selective_scan_gated_bwd(*args, dout, res[1])
        case["plain"] = lambda: ref.selective_scan_gated_bwd_plain(*args, dout, res[1],
                                                                    chunk=128)
    return case


def bwd_paired(trees: List[Path], rounds: int = 2) -> Dict[str, Dict[str, list]]:
    """Each case's {timing: [ms, digest]} in every tree, in turns
    (``trees``, then reversed, ``rounds`` times over), each run a process of
    its own."""
    order: List[Path] = []
    for _ in range(rounds):
        order += list(trees) + list(trees)[::-1]
    out: Dict[str, Dict[str, list]] = {str(t): {} for t in trees}
    for tree in order:
        # This tree's probe (bwd_case) on the other tree's package: the
        # parent has no --bwd of its own.
        env = dict(os.environ, PYTHONPATH=f"{tree / 'src'}")
        script = BWD_PAIRED_SCRIPT.replace(
            "from repro_torch.kernels import scan_probe as P",
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('probe', {str(Path(__file__))!r})\n"
            "P = importlib.util.module_from_spec(spec); spec.loader.exec_module(P)")
        proc = subprocess.run([sys.executable, "-c", script, json.dumps(BWD_SHAPES)],
                              cwd=str(tree), env=env, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"paired run in {tree} failed:\n{proc.stderr[-4000:]}")
        for label, got in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[str(tree)].setdefault(label, []).append(got)
    return out


# ---- the sLSTM backward's split ---------------------------------------------

BWD_SOURCE = build.CSRC / "slstm_scan_bwd.cu"
# --bwd --split: xlstm-350m's sLSTM layer at its training microbatch and at
# the forward row's 16 rows, bf16.
BWD_SPLIT_SHAPES = {"4 rows": (4, 2048, 4, 256), "16 rows": (16, 2048, 4, 256)}


def _probe_header(src: str, anchor: str) -> str:
    """``g_probe`` (16 slots) and ``MARK`` after ``anchor``."""
    return _sub(src, anchor, anchor + "__device__ unsigned long long g_probe[16];\n"
                "#define MARK(i) { long long t_ = clock64(); probe[i] += t_ - t_prev; "
                "t_prev = t_; }\n")


def _probe_start(src: str, anchor: str) -> str:
    """A thread's sums and clock after ``anchor``."""
    return _sub(src, anchor, anchor + "  unsigned long long probe[16] = {0};\n"
                                      "  long long t_prev = clock64();\n")


# The reduce-scatter design (csrc/slstm_scan_bwd.cu as it stands): its
# sections by (name, the slot counting their positions): the product
# threads' (thread 0 of CTA (0, 0)) and the cell threads' (its first cell
# thread), each a loop of its own.
BWD_SECTIONS = (("product threads: wait for dpre_t", 15), ("wait for the turn", 15),
                ("product", 15), ("barrier", 15), ("reduce-scatter", 15),
                ("cell threads: wait for dh's partials", 14), ("dh's sum and the carried cell", 14),
                ("loads and carry-free terms, under the product", 14))
_FREE_FIRST = ("      f[k] = carry_free(a[k], seq > 1 ? b[k].c : 0.f, seq > 1 ? b[k].n : 0.f,\n"
               "                        seq > 1 ? b[k].m : -1e30f);\n")
_FREE_NEXT = ("        if (has[k]) f[k] = carry_free(a[k], t > 1 ? b[k].c : 0.f, t > 1 ? b[k].n : "
              "0.f,\n                                      t > 1 ? b[k].m : -1e30f);\n")
_AHEAD = ("        a[k] = b[k];\n        b[k] = c[k];\n        c[k] = Res{};\n"
          "        if (has[k] && t >= 3) c[k].load(pre, cs, ns, ms, dhs, prow[k] + (t - 3) * "
          "x_step,\n                                        srow[k] + (t - 3) * s_step, uh);\n")


def bwd_no_product(src: str) -> str:
    """The product is skipped: every partial sum is 0."""
    return _sub(src, "const int rounds = L.slice / 4;", "const int rounds = 0;")


def bwd_no_exchange(src: str) -> str:
    """Each CTA sends only its own units' partial dh (to itself) and waits
    for those bytes: nothing crosses CTAs."""
    src = _sub(src, "  const uint32_t bytes = (uint32_t)rows * cluster * n * 4;",
               "  const uint32_t bytes = (uint32_t)rows * n * 4;")
    return _sub(src, "owner_of[j] = er < rows ? ((u + 1) * cluster - 1) / uh : -1;",
                "owner_of[j] = er < rows && ((u + 1) * cluster - 1) / uh == rank ? rank : -1;")


def bwd_no_cell(src: str) -> str:
    """dpre is a scaled sum of dh and the pre-activations: no carry-free
    terms (no exp, log1p, tanh or division) and no carried cell."""
    src = _sub(_sub(src, _FREE_FIRST, ""), _FREE_NEXT, "")
    return _sub(src, "        carried(f[k], dh, dc[k], dn[k], dm[k], dp);\n",
                "        dp[0] = __fmul_rn(dh, 1e-3f), dp[1] = __fadd_rn(a[k].pr[1], dh);\n"
                "        dp[2] = __fmul_rn(a[k].pr[2], dh), dp[3] = __fsub_rn(a[k].pr[3], dh);\n")


def bwd_no_prefetch(src: str) -> str:
    """A position's residuals are loaded where its carry-free terms use them,
    not three positions ahead."""
    return _sub(src, _AHEAD,
                "        if (has[k]) a[k].load(pre, cs, ns, ms, dhs, prow[k] + (t - 1) * x_step, "
                "srow[k] + (t - 1) * s_step, uh);\n"
                "        if (has[k] && t >= 2) b[k].load(pre, cs, ns, ms, dhs, prow[k] + (t - 2) * "
                "x_step, srow[k] + (t - 2) * s_step, uh);\n")


# A product chunk for the variants below: the kernel's Chunk with its
# weights not loaded (MODE 1) or their bits taken as float32 unwidened
# (MODE 2).
_BWD_XCHUNK = r"""
template <typename TW, int R, int MODE>
struct XChunk {
  W8<TW> w[4];
  float4 h[R];
  __device__ __forceinline__ void load(const TW* wq, int pitch, const float* hp, int uh8, int u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (MODE == 1) w[j] = W8<TW>{};
      else w[j].load(wq + (size_t)j * pitch);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) h[r] = *reinterpret_cast<const float4*>(hp + r * uh8 + u);
  }
  __device__ __forceinline__ void fma(float (&acc)[R][8]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float wf[8];
      if (MODE == 2) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(&w[j]);
#pragma unroll
        for (int c = 0; c < 8; ++c) wf[c] = __uint_as_float(q[c % (sizeof(W8<TW>) / 4)]);
      } else {
        w[j].widen(wf);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = j == 0 ? h[r].x : j == 1 ? h[r].y : j == 2 ? h[r].z : h[r].w;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(hv, wf[c], acc[r][c]);
      }
    }
  }
};
"""


def _bwd_xchunk(mode: int) -> Callable[[str], str]:
    def patch(src: str) -> str:
        src = _sub(src, "namespace {\n\n// The backward's product",
                   "namespace {\n" + _BWD_XCHUNK + "\n// The backward's product")
        return _sub(src, "Chunk<TW, R> ca, cb;", f"XChunk<TW, R, {mode}> ca, cb;")
    return patch


def bwd_float32_weights(src: str) -> str:
    """wr widened to float32 once, into shared memory twice the size: no
    widening in the product, twice its shared-memory bytes (the launch
    takes the larger shared memory itself)."""
    for old, new in (
            ("const BwdLayout L(uh, cluster, R, halves, (int)sizeof(TW));",
             "const BwdLayout L(uh, cluster, R, halves, 4);"),
            ("const TW* w_s = reinterpret_cast<const TW*>(smem + L.w_off);",
             "const float* w_s = reinterpret_cast<const float*>(smem + L.w_off);"),
            ("TW* dst = reinterpret_cast<TW*>(smem + L.w_off);",
             "float* dst = reinterpret_cast<float*>(smem + L.w_off);"),
            ("c < 4 * n && u < uh ? src[(size_t)u * g4 + (c / n) * uh + c % n] : zero<TW>();",
             "c < 4 * n && u < uh ? widen(src[(size_t)u * g4 + (c / n) * uh + c % n]) : 0.f;"),
            ("const TW* wq = w_s + ", "const float* wq = w_s + "),
            ("Chunk<TW, R> ca, cb;", "Chunk<float, R> ca, cb;"),
            ("  auto fn = slstm_bwd_cluster<TW, R>;\n",
             "  auto fn = slstm_bwd_cluster<TW, R>;\n"
             "  smem = bwd_smem_for(uh, cluster, R, halves, 4);\n"),
            ("smem != bwd_smem_for(uh, cluster, rows, halves, w_dtype ? 2 : 4) ||", "false ||")):
        src = _sub(src, old, new)
    return src


def bwd_instrument(src: str) -> str:
    """A copy of the backward that sums clock64 deltas per section of a
    position (BWD_SECTIONS) in each thread; thread 0 of CTA (0, 0) (a
    product thread) and its first cell thread write theirs to ``g_probe``
    (slots 15 and 14 count their positions)."""
    src = _probe_header(src, '#include "slstm_scan.cu"\n')
    src = _probe_start(src, "  cluster_sync();  // every CTA's barriers are initialised, its dpre "
                            "zeroed and wr copied\n")
    marks = (("      named_bar_sync(ready, P + Q);  // dpre_t is whole\n", 0),
             ("      if (turns) named_bar_sync(3 + half, 2 * P);  // the other half's product is "
              "done\n", 1),
             ("        if (q == 0 && it + 2 < seq) mbar_expect_tx(bar, bytes);  // dh of position "
              "t - 2\n      }\n", 5),
             ("      named_bar_arrive(ready, P + Q);  // dpre_t is whole: the product threads go "
              "on\n", 6))
    for anchor, i in marks:
        src = _sub(src, anchor, anchor + f"      MARK({i});\n")
    anchor = "      named_bar_sync(summed, P);  // the partial sums are whole\n"
    src = _sub(src, anchor, "      MARK(2);\n" + anchor + "      MARK(3);\n")
    src = _sub(src, "      }\n    }\n  } else {\n",
               "      }\n      MARK(4);\n      probe[15] += 1;\n    }\n  } else {\n")
    src = _sub(src, "      }\n    }\n  }\n  cluster_sync();  // no CTA leaves",
               "      }\n      MARK(7);\n      probe[14] += 1;\n    }\n  }\n"
               "  if (blockIdx.x == 0 && blockIdx.y == 0 &&\n"
               "      (threadIdx.x == 0 || threadIdx.x == P))\n"
               "    for (int i = 0; i < 16; ++i)\n"
               "      if (probe[i] != 0) g_probe[i] = probe[i];\n"
               "  cluster_sync();  // no CTA leaves")
    return src + ('\nextern "C" int probe_read(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


def bwd_design(src: str) -> dict:
    """The split of a backward source: its variants (name -> patch), its
    instrumented copy's patch and its sections' names."""
    if _AHEAD in src:
        return dict(variants={"kernel": lambda s: s, "no product": bwd_no_product,
                              "no exchange": bwd_no_exchange, "no cell math": bwd_no_cell,
                              "no residual prefetch": bwd_no_prefetch,
                              "no weight loads": _bwd_xchunk(1), "no widening": _bwd_xchunk(2),
                              "float32 weights": bwd_float32_weights},
                    instrument=bwd_instrument, sections=BWD_SECTIONS)
    raise ValueError("scan_probe: the backward source's design is not known here")


def bwd_patches(src: str) -> Dict[str, str]:
    """Every patched backward source by name (no build), and "sections"."""
    design = bwd_design(src)
    out = {name: patch(src) for name, patch in design["variants"].items()}
    out["sections"] = design["instrument"](src)
    return out


def _registers(log: str, kernel: str) -> List[str]:
    """``-Xptxas -v``'s registers and spills of each instance of ``kernel``."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            name = re.search(r"'(\S+)'", line)
            info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "registers" in x or "spill" in x)
            out.append(f"{name.group(1) if name else line.strip()}: {info}")
    return out


def bwd_split(torch) -> None:
    """``--bwd --split``: this tree's backward source and its variants, each
    timed by CUDA events (the dpre kernel alone, 5 calls after 2, two
    rounds) at BWD_SPLIT_SHAPES, then the instrumented copy's clock64
    sections a position in thread 0 of CTA (0, 0)."""
    from repro_torch.kernels import slstm_scan as SS

    src = (build.CSRC / "slstm_scan_bwd.cu").read_text()
    design = bwd_design(src)
    libs, logs = _build(bwd_patches(src), SS.BWD_NAME)
    for line in _registers(logs["kernel"], "slstm_bwd"):
        print(f"[bwd split] ptxas {line}", flush=True)
    cases = {label: bwd_case(torch, "slstm", shape) for label, shape in BWD_SPLIT_SHAPES.items()}
    kept = build._LIBS.get(SS.BWD_NAME)
    try:
        for rnd in range(2):
            for name in SEL_BWD_VARIANTS:
                build._LIBS[SS.BWD_NAME] = libs[name]
                times = [f"{label} {_event_ms(torch, case['dpre'], 5):.4f} ms"
                         for label, case in cases.items()]
                print(f"[bwd split] round {rnd}, {name}: " + "; ".join(times), flush=True)
        lib = libs["sections"]
        lib.probe_read.argtypes = [ctypes.c_void_p]
        build._LIBS[SS.BWD_NAME] = lib
        for label, case in cases.items():
            case["dpre"]()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            build.check(lib.probe_read(buf), "probe_read")
            p = list(buf)
            sections = design["sections"]
            per = [p[i] / max(p[slot], 1) for i, (_, slot) in enumerate(sections)]
            totals = [sum(c for (_, s), c in zip(sections, per) if s == slot)
                      for slot in (15, 14) if p[slot]]
            print(f"[bwd sections] {label}, CTA 0: positions {p[15]} (and {p[14]}); cycles a "
                  "position: " + ", ".join(f"{name} {c:.0f}" for (name, _), c in
                                           zip(sections, per))
                  + "; total " + ", ".join(f"{c:.0f}" for c in totals), flush=True)
    finally:
        if kept is None:
            build._LIBS.pop(SS.BWD_NAME, None)
        else:
            build._LIBS[SS.BWD_NAME] = kept


# ---- the selective backward's split ------------------------------------------

SEL_BWD_SOURCE = build.CSRC / "selective_scan_bwd.cu"
# --bwd --split: jamba-1.5-large's mamba layer at its cut's training
# microbatch and at the forward row's 16 rows, bf16 (BWD_SHAPES' gated rows).
SEL_BWD_SPLIT_SHAPES = {"1 row": (1, 2048, 16384, 16), "16 rows": (16, 2048, 16384, 16)}


def _sel_probe(src: str, start: str, marks, stage_end: str, count: str, finish: str) -> str:
    """A selective-backward source that sums clock64 deltas per section:
    the thread's sums and clock after ``start``, ``MARK(i)`` after the i-th
    anchor of ``marks``, the last mark and slot 15 adding ``count``
    positions before ``stage_end`` (the stage loop's end), thread 0 of
    block 0 writing its sums to ``g_probe`` after ``finish``; and
    ``probe_read``."""
    src = _probe_start(_probe_header(src, '#include "hopper.cuh"\n'), start)
    for i, anchor in enumerate(marks):
        src = _sub(src, anchor, anchor + f"MARK({i});\n")
    src = _sub(src, stage_end, f"MARK({len(marks)});\nprobe[15] += {count};\n" + stage_end)
    src = _sub(src, finish, finish + "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
                                     "    for (int i = 0; i < 16; ++i) g_probe[i] = probe[i];\n")
    return src + ('\nextern "C" int probe_read(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


# The sections of a stage (a lane's position of it, its channel's 4 lanes
# sharing the rest) and MUFU.EX2 a lane and stage (= a channel and
# position): 16 decays, the softplus's (its sigmoid shares it) and the gate's.
SEL_BWD_SECTIONS = ("wait on the ring", "the channel's work of a position", "shuffles of d, dy, dt x",
                "recompute", "walk", "sums over a channel's lanes", "gradients and stores",
                "wait for every thread's dc and db", "channel sums and partials' store")
SEL_BWD_EX2 = 18
_LS_EXP = "            dec[q][kk] = ex2(dq[q] * a2[kk]);\n"


def sel_bwd_instrument(src: str) -> str:
    """The backward with SEL_BWD_SECTIONS' clock64 sums (thread 0 of block
    0: lane group 0 of channel 0, the first position of each stage)."""
    return _sel_probe(
        src, "  T* dzo = static_cast<T*>(p.dz);\n",
        ("      mbar_wait(full0 + 8 * s, (it / kStages) & 1);\n",
         "      const float dtx = valid ? d * xv : 0.f;\n",
         "      // 3. The stage's states and decays from the saved state, in registers.\n",
         "      // 4. The reverse walk; dc and db to this stage's buffer.\n",
         "      mbar_arrive(summed0 + 8 * (it & 1));  // this thread's dc and db are in rb\n",
         "      // 6. The channel's gradients at this lane's position.\n",
         "          p.ddt[at] = ddt;\n        }\n      }\n",
         "      mbar_wait(summed0 + 8 * (it & 1), (it >> 1) & 1);  // every thread's are\n"),
        "    }\n    // The row's own sums over positions", "np",
        "        p.part_bias[i] = bias_acc;\n      }\n    }\n  }\n")


SEL_BWD_VARIANTS: Dict[str, Callable[[str], str]] = {
        "kernel": lambda s: s,
        "no recompute": _sel_patch(
            _LS_EXP + "            hq[q][kk] = fmaf(q ? hq[q - 1][kk] : h0[kk], dec[q][kk], "
                      "xq[q] * bv[kk]);\n",
            "            dec[q][kk] = 0.5f;\n            hq[q][kk] = h0[kk] + bv[kk];\n"),
        "no exponential": _sel_patch(_LS_EXP, "            dec[q][kk] = dq[q] * a2[kk];\n"),
        "expf, not ex2.approx": _sel_patch(_LS_EXP,
                                           "            dec[q][kk] = expf(dq[q] * av[kk]);\n"),
        "no channel work (softplus, sigmoids)": _chain(
            _sel_patch("e = expf(-fabsf(tt)), r = __frcp_rn(1.f + e);", "e = tt, r = tt;"),
            _sel_patch("        d = fmaxf(tt, 0.f) + log1pf(e);\n", "        d = tt;\n"),
            _sel_patch("sig = __frcp_rn(1.f + __expf(-zv));", "sig = zv;")),
        "no shuffles between a channel's lanes": _chain(
            _sel_patch("pair[i][m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);",
                       "pair[i][m] = keep + send;"),
            _sel_patch("tot[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);",
                       "tot[m] = keep + send;")),
        "no channel sums": _chain(
            _sel_patch("acc[jj & 3] += r0[jj * RV];", "acc[jj & 3] = r0[0];"),
            _sel_patch("acc[jj & 3] += r1[jj * RV];", "acc[jj & 3] = r1[0];")),
        "no part stores, no second launch": _chain(
            _sel_patch("        if (summer && hf == 0 && oq < np)",
                       "        if (false && summer && hf == 0 && oq < np)"),
            _sel_patch("  scan_bwd_reduce<<<grid, kReduceThreads, 0, s>>>(",
                       "  if (false) scan_bwd_reduce<<<grid, kReduceThreads, 0, s>>>(")),
        "no saved-state loads": _chain(
            _sel_patch(" + N * 4 * cnt);", ");"),
            _sel_patch("} else if (lane >= 8 && lane < 8 + N) {", "} else if (lane < 0) {")),
        "2 stages in the ring": _sel_patch("constexpr int kStages = 3;",
                                           "constexpr int kStages = 2;"),
        "kMinBlocks 1 (no register cap, one block an SM)": _sel_patch(
            "constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;"),
}


def sel_bwd_patches() -> Dict[str, str]:
    """Every patched selective-backward source by name (no build), and
    "sections"."""
    src = SEL_BWD_SOURCE.read_text()
    out = {name: patch(src) for name, patch in SEL_BWD_VARIANTS.items()}
    out["sections"] = sel_bwd_instrument(src)
    return out


def bwd_sass_counts(so: Path, states: int = SEL_STATES) -> dict:
    """:func:`loop_counts` of the selective backward's bf16 gated instance
    of ``states`` states in the library at ``so``: its loop over stages,
    SEL_BWD_EX2 MUFU.EX2 a lane and stage; empty without ``cuobjdump``."""
    for name, instrs in sass_functions(so).items():
        if re.search(rf"scan_bwd_kernelILi{states}E13__nv_bfloat16Lb1E", name):
            return loop_counts(instrs, states, True, SEL_BWD_EX2)
    return {}


def sel_bwd_split(torch) -> None:
    """``--bwd --split``'s selective half: this tree's selective backward
    and its variants (16-state builds), each with its registers, spills and
    resident blocks and the SASS count of its loop over positions, timed by
    CUDA events (the whole call, 5 after 2, two rounds) at
    SEL_BWD_SPLIT_SHAPES, then the instrumented copy's clock64 sections a
    position in thread 0 of block 0."""
    from repro_torch.kernels import selective_scan as SEL

    built = _sel_build(sel_bwd_patches(), SEL.BWD_NAME)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (lib, so, log) in built.items():
        if name == "sections":
            continue
        buf = (ctypes.c_int * 5)()
        build.check(lib.selective_scan_bwd_occupancy(0, 1, 1, SEL_STATES, buf), name)
        regs = [line for line in _registers(log, "scan_bwd_kernel")
                if f"ILi{SEL_STATES}E13__nv_bfloat16Lb1E" in line]
        print(f"[sel bwd build] {name}: {'; '.join(regs)}; plan [blocks an SM, SMs, shared "
              f"bytes, threads, channels a unit] {list(buf)}", flush=True)
        c = bwd_sass_counts(so)
        if c:
            floors = ", ".join(f"{label} {issue_floor_ms(shape, c['per_position'], sms):.3f} ms"
                               for label, shape in SEL_BWD_SPLIT_SHAPES.items())
            print(f"[sel bwd sass] {name}: loop of {c['instructions']} instructions for "
                  f"{c['positions']:g} channel-positions: {c['per_position']:.1f} a channel and "
                  f"position ({c['ex2']:g} MUFU.EX2, {c['lds']:g} LDS); issue floor {floors}",
                  flush=True)
        else:
            print(f"[sel bwd sass] {name}: no loop found (or no cuobjdump)", flush=True)
    cases = {label: bwd_case(torch, "gated", shape)
             for label, shape in SEL_BWD_SPLIT_SHAPES.items()}
    kept = build._LIBS.get(SEL.BWD_NAME)
    try:
        for rnd in range(2):
            for name in SEL_BWD_VARIANTS:
                build._LIBS[SEL.BWD_NAME] = built[name][0]
                times = [f"{label} {_event_ms(torch, case['backward'], 5):.4f} ms"
                         for label, case in cases.items()]
                print(f"[sel bwd split] round {rnd}, {name}: " + "; ".join(times), flush=True)
        lib = built["sections"][0]
        lib.probe_read.argtypes = [ctypes.c_void_p]
        build._LIBS[SEL.BWD_NAME] = lib
        for label, case in cases.items():
            case["backward"]()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            build.check(lib.probe_read(buf), "probe_read")
            p = list(buf)
            steps = max(p[15], 1)
            per = [p[i] / steps for i in range(len(SEL_BWD_SECTIONS))]
            print(f"[sel bwd sections] {label}, block 0, thread 0: {p[15]} positions; cycles a "
                  "position: " + ", ".join(f"{name} {c:.0f}" for name, c in
                                           zip(SEL_BWD_SECTIONS, per))
                  + f"; total {sum(per):.0f}", flush=True)
    finally:
        if kept is None:
            build._LIBS.pop(SEL.BWD_NAME, None)
        else:
            build._LIBS[SEL.BWD_NAME] = kept


def bwd_time_plans(torch, shape) -> None:
    """Every backward plan the source takes for ``shape`` (bf16; the
    cluster ``slstm_scan.plan`` sizes): CUDA-event ms of the dpre kernel a
    call, its resident clusters, whether its dpre equals the first plan's
    bit for bit, and the plan chosen."""
    from repro_torch.kernels import slstm_scan as SS

    b, s, hh, uh = shape
    x, wr, bias = inputs(torch, shape)
    hs, pre, (c, n, m) = SS.slstm_scan_residuals(x, wr, bias)
    dhs = torch.randn(hs.shape, generator=torch.Generator(device=hs.device).manual_seed(10),
                      device=hs.device)
    chosen = SS.card_plan(0, 0, 1, b, hh, uh, backward=True)
    lib = build.library(SS.BWD_NAME)
    first = None
    for halves in range(1, SS.MAX_HALVES + 1):
        for groups in range(1, b + 1):
            rows = SS.rows_of(b, groups, halves)
            if b // groups < halves or rows > SS.MAX_ROWS:
                continue
            smem = SS.smem_bytes(uh, chosen.cluster, rows, halves, 2, backward=True)
            if smem > SS.MAX_SMEM:
                continue
            dpre = torch.empty_like(pre)

            def call():
                build.check(lib.slstm_scan_bwd_launch(
                    0, build.stream_handle(pre.device), 1, wr.data_ptr(), pre.data_ptr(),
                    c.data_ptr(), n.data_ptr(), m.data_ptr(), dhs.data_ptr(), dpre.data_ptr(), b,
                    s, hh, uh, chosen.cluster, groups, halves, smem), SS.BWD_NAME)

            call()
            torch.cuda.synchronize()
            first = dpre.clone() if first is None else first
            same = bool(torch.equal(first, dpre))
            resident = lib.slstm_scan_bwd_max_clusters(0, 1, b, hh, uh, chosen.cluster, groups,
                                                       halves, smem)
            ms = _event_ms(torch, call, reps=5 if s > 256 else 50)
            print(f"[bwd plans] {shape}: groups {groups}, halves {halves}, rows {rows}, "
                  f"{hh * groups} clusters ({resident} resident): {ms:.4f} ms, dpre equal to the "
                  f"first plan's: {same}", flush=True)
    print(f"[bwd plans] {shape}: plan() chooses {chosen}", flush=True)


def _in_tree(tree: Path, args: List[str]) -> int:
    """This probe's ``main`` with ``args`` on the package of the checkout at
    ``tree`` (its ``src`` on the path, its sources and build directory), in
    a process of its own; its output passes through."""
    script = ("import importlib.util, sys\n"
              f"spec = importlib.util.spec_from_file_location('probe', {str(Path(__file__))!r})\n"
              "P = importlib.util.module_from_spec(spec); spec.loader.exec_module(P)\n"
              "raise SystemExit(P.main())\n")
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.run([sys.executable, "-c", script, *args], cwd=str(tree), env=env,
                          timeout=1800).returncode


def bwd_main(torch) -> int:
    """``--bwd``: the cases' times, errors, reruns and plans, or with
    ``--paired DIR`` the paired runs, ``--split`` the split, ``--plans``
    every backward plan's time (``--tree DIR``: of the checkout at DIR)."""
    from repro_torch.kernels import selective_scan as SEL
    from repro_torch.kernels import slstm_scan as SS
    from repro_torch.kernels.ref import slstm_weight_grads

    if "--tree" in sys.argv:
        at = sys.argv.index("--tree")
        tree = Path(sys.argv[at + 1]).resolve()
        return _in_tree(tree, sys.argv[1:at] + sys.argv[at + 2:])
    if "--split" in sys.argv:
        at = sys.argv.index("--split")
        which = sys.argv[at + 1] if at + 1 < len(sys.argv) else ""
        if which != "selective":
            bwd_split(torch)
        if which != "slstm":
            sel_bwd_split(torch)
        _smi()
        return 0
    if "--plans" in sys.argv:
        for shape in PLAN_SHAPES:
            bwd_time_plans(torch, shape)
        _smi()
        return 0
    if "--paired" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--paired") + 1]).resolve()
        here = Path(__file__).resolve().parents[3]
        runs = bwd_paired([here, other])
        for tree, got in runs.items():
            print(f"[bwd paired] {tree}: {got}", flush=True)
        for label in BWD_SHAPES:
            for timing in runs[str(here)][label][0]:
                a = [r[timing][0] for r in runs[str(here)][label]]
                b = [r[timing][0] for r in runs[str(other)][label] if timing in r]
                digests = {r[timing][1] for got in runs.values() for r in got[label]
                           if timing in r}
                print(f"[bwd paired] {label} {timing}: this tree {_spread(a)} ms, other "
                      f"{_spread(b) if b else 'none'}; outputs equal bit for bit across trees "
                      f"and runs: {len(digests) == 1}", flush=True)
        _smi()
        return 0

    for label, (kind, shape) in BWD_SHAPES.items():
        case = bwd_case(torch, kind, shape)
        got, again = case["backward"](), case["backward"]()
        rerun = all(torch.equal(g, g2) for g, g2 in zip(got, again))
        want = case["plain"]()
        errs = [float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()),
                                                                 1e-30)
                for g, w in zip(got, want)]
        del again, want
        times = {name: _event_ms(torch, case[name], 3) for name in ("forward", "residuals")}
        if kind == "slstm":
            b, _, hh, uh = shape
            p = SS.card_plan(0, 0, 1, b, hh, uh, backward=True)
            times["backward kernel (dpre)"] = _event_ms(torch, case["dpre"], 5)
            dpre = case["dpre"]().view(b, shape[1], hh, 4 * uh)
            hs = case["residuals"]()[0]
            times["dwr and dbias"] = _event_ms(torch, lambda: slstm_weight_grads(hs, dpre), 5)
            del dpre, hs
        else:
            buf = (ctypes.c_int * 5)()
            build.check(build.library(SEL.BWD_NAME).selective_scan_bwd_occupancy(
                0, 1, 1, shape[3], buf), SEL.BWD_NAME)
            p = list(buf)
            times["backward kernel (two launches)"] = _event_ms(torch, case["backward"], 5)
        times["plain backward"] = _event_ms(torch, case["plain"], 1)
        print(f"[bwd] {label} {shape}: plan {p}; rerun bit-equal {rerun}; max |kernel - plain| "
              f"/ scale by gradient {[f'{e:.2e}' for e in errs]}; ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
        del case, got
        torch.cuda.empty_cache()
    _smi()
    return 0


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

    if "--selective" in sys.argv:
        return selective_main(torch)
    if "--bwd" in sys.argv:
        return bwd_main(torch)

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

    libs, _ = _build(all_patches())
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
