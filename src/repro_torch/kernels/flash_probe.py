"""Where the bf16 flash-attention kernels spend their time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_probe [--bwd] [--paired DIR]

Three probes, each at the serving prefill shape (B=16, S=T=2,048, H=32,
D=64, causal) and internlm2-20b's (B=4, H=48 on 8 kv heads, D=128):

- **variants**: ``csrc/flash_attention.cu`` patched to drop one part at a
  time (the softmax; then both products; then the K/V loads), or to read
  every K/V tile from one head's rows (all L2 hits), each built with the
  kernels' flags into ``build/repro_torch/probe/`` and timed with CUDA
  events, two rounds;
- **sections**: ``clock64`` sums over the consumer loop's sections (waits,
  issue, softmax, rescale; per work item the wait for q, the first tile,
  the last P V and the stores) in block 0, from an instrumented copy;
- **host**: host microseconds a call (a loop of launches, one synchronise);
- **quotient**: the kernel against a copy whose epilogue divides by IEEE
  division instead of the reciprocal and Newton step, bit for bit, at both
  shapes and gemma3's (D=168, window 1,024).

``--bwd`` instead probes the backward (``csrc/flash_attention_bwd.cu``) at
``chip_smoke.py``'s three ``FLASH_BWD_SHAPES`` (:data:`BWD_SHAPES`): the
source patched to drop the exps (P = the scaled scores), one product (dK +=
dS^T Q, or dQ += dS K), every product, or the tile loads (the producers
complete each barrier with no bytes), alone and together; each variant's
device ms by kernel (``torch.profiler``: prep, dkdv, dq), two rounds.

``--paired DIR`` instead times this tree against the checkout at ``DIR``
(e.g. the parent commit, unpacked with ``git archive``), each run a process
of its own, in turns (this, DIR, DIR, this, twice): the forward's CUDA-event
ms a call at both shapes (the serving call, and where the tree's wrapper has
it the training call that also stores lse), and the bf16 backward's device
ms by kernel (delta or prep, dkdv, dq; ``torch.profiler``) at
:data:`BWD_SHAPES`.

A patch that no longer finds its text in the source raises; the CPU test
``tests/test_torch_models.py::test_flash_probe_patches_apply`` applies every
patch without building.  The patched kernels compute wrong results on
purpose: nothing here is on any path.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

from repro_torch.kernels import build

SOURCE = build.CSRC / "flash_attention.cu"
BWD_SOURCE = build.CSRC / "flash_attention_bwd.cu"
PROBE_DIR = build.BUILD_DIR / "probe"
SHAPES = {"serving": (16, 2048, 32, 32, 64), "internlm2": (4, 2048, 48, 8, 128)}
GEMMA3 = (1, 4096, 32, 16, 168)  # window 1,024
# chip_smoke.FLASH_BWD_SHAPES: (B, S, T, Hq, Hkv, D, causal, window), bf16.
BWD_SHAPES = {"training": (4, 2048, 2048, 32, 32, 64, True, 0),
              "internlm2": (4, 2048, 2048, 48, 8, 128, True, 0),
              "gemma3": (1, 4096, 4096, 32, 16, 168, True, 1024)}


def _sub(src: str, old: str, new: str) -> str:
    """Replace the one occurrence of ``old``; raise if there is not exactly one."""
    if src.count(old) != 1:
        raise ValueError(f"flash_probe: the kernel source has {src.count(old)} of {old[:60]!r}")
    return src.replace(old, new)


def no_softmax(src: str) -> str:
    """P = the raw scores in bf16: no scale, mask, max, exp or sum."""
    head = "  float mx_a = row.m_a, mx_b = row.m_b;"
    tail = "// The masked and unmasked softmax are separate"
    if head not in src or tail not in src:
        raise ValueError("flash_probe: softmax_tile's body moved")
    return (src[:src.index(head)] + """  alpha_a = 1.f;
  alpha_b = 1.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

""" + src[src.index(tail):])


def _empty_body(src: str, signature: str, body: str) -> str:
    """Replace the body of the function whose declaration has ``signature``."""
    if src.count(signature) != 1:
        raise ValueError(f"flash_probe: the kernel source has {src.count(signature)} of "
                         f"{signature!r}")
    start = src.index("{", src.index(signature)) + 1
    depth, end = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    return src[:start] + f"\n  {body}\n" + src[end - 1:]


def no_products(src: str) -> str:
    """Neither S = Q K^T nor O += P V is issued."""
    src = _empty_body(src, "void issue_qk(", "(void)s; (void)q_wg; (void)k_st;")
    return _empty_body(src, "void issue_pv(", "(void)acc; (void)pa; (void)v_st;")


_K_LOAD = """          mbar_expect_tx(bar_k(st), C::kKVBytes);
          for (int c = 0; c < C::kChunks; ++c)
            load_box(s_k + off + c * BN * 128, &tm_k, k_order, bar_k(st), 64 * c, row0, x.hk,
                     x.b);"""
_V_LOAD = _K_LOAD.replace("bar_k(st)", "bar_v(st)").replace("s_k", "s_v").replace(
    "tm_k, k_order", "tm_v, v_order")


def no_kv_loads(src: str) -> str:
    """The producer completes each K/V barrier with no bytes."""
    src = _sub(src, _K_LOAD, "          mbar_expect_tx(bar_k(st), 0);")
    return _sub(src, _V_LOAD, "          mbar_expect_tx(bar_v(st), 0);")


def one_head_kv(src: str) -> str:
    """Every K/V tile comes from batch 0, kv head 0: L2 hits."""
    src = _sub(src, _K_LOAD, _K_LOAD.replace("row0, x.hk,\n                     x.b);",
                                             "row0, 0, 0);"))
    return _sub(src, _V_LOAD, _V_LOAD.replace("row0, x.hk,\n                     x.b);",
                                              "row0, 0, 0);"))


def _chain(*patches: Callable[[str], str]) -> Callable[[str], str]:
    def apply(src: str) -> str:
        for patch in patches:
            src = patch(src)
        return src
    return apply


def ieee_division(src: str) -> str:
    """The epilogue's quotient by IEEE division: the kernel must match it."""
    return _sub(src, "  const float q = a * inv;\n  return fmaf(fmaf(-den, q, a), inv, q);",
                "  return a / den;")


VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "kernel, one head's K/V": one_head_kv,
    "no softmax": no_softmax,
    "no softmax, no products": _chain(no_softmax, no_products),
    "no softmax, no products, one head's K/V": _chain(no_softmax, no_products, one_head_kv),
    "no softmax, no products, no K/V loads": _chain(no_softmax, no_products, no_kv_loads),
}

# clock64 sections: slot -> name.  Each mark adds the cycles since the
# previous mark to its slot; slots 12 and 13 count loop tiles and items.
LOOP_SECTIONS = ("wait K/V", "issue", "wait S", "softmax", "wait P V", "rescale")
ITEM_SECTIONS = {15: "wait q", 7: "first tile", 8: "last P V", 9: "stores"}


def _mark_after(src: str, anchor: str, mark: str) -> str:
    return _sub(src, anchor, anchor + mark)


def instrument(src: str) -> str:
    """A copy of the source whose consumers sum clock64 deltas per section;
    block 0 writes them (per warpgroup) to ``g_probe``."""
    src = _mark_after(src, '#include "hopper.cuh"\n',
                      "__device__ unsigned long long g_probe[2][16];\n"
                      "#define MARK(i) { long long t_ = clock64(); probe[i] += t_ - t_prev; "
                      "t_prev = t_; }\n")
    src = _mark_after(src, 'setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n',
                      "    unsigned long long probe[16] = {0};\n"
                      "    long long t_prev = clock64();\n")
    src = _mark_after(src, "      mbar_wait(bar_q, item & 1);\n", "      MARK(15);\n")
    loop = "      for (int i = 1; i < x.n_tiles; ++i) {\n"
    src = _sub(src, loop, "      MARK(7);\n" + loop + "        MARK(14);\n")
    src = _mark_after(src, "        mbar_wait(bar_v(prev), ((cur - 1) / kStages) & 1);\n",
                      "        MARK(0);\n")
    src = _sub(src, "        wgmma_commit();\n        wgmma_wait<1>();",
               "        wgmma_commit();\n        MARK(1);\n        wgmma_wait<1>();")
    src = _sub(src, "        mbar_arrive(bar_ke(st));\n        uint32_t pn",
               "        mbar_arrive(bar_ke(st));\n        MARK(2);\n        uint32_t pn")
    src = _mark_after(src, "        fence_reg(alpha_b);\n", "        MARK(3);\n")
    src = _sub(src, "        mbar_arrive(bar_ve(prev));\n",
               "        MARK(4);\n        mbar_arrive(bar_ve(prev));\n")
    src = _mark_after(src, "          for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];\n",
                      "        MARK(5);\n        probe[12] += 1;\n")
    src = _mark_after(src, "      mbar_arrive(bar_ve(last));\n      it += x.n_tiles;\n",
                      "      MARK(8);\n")
    src = _sub(src, """        if (row_b < S) lb[row_b] = (row.m_b + log2f(l_b)) * 0.6931471805599453f;
      }
    }
  }
}
""", """        if (row_b < S) lb[row_b] = (row.m_b + log2f(l_b)) * 0.6931471805599453f;
      }
      MARK(9);
      probe[13] += 1;
    }
    if (blockIdx.x == 0 && threadIdx.x % 128 == 0)
      for (int i = 0; i < 16; ++i) g_probe[wg][i] = probe[i];
  }
}
""")
    return src + ('\nextern "C" int probe_read(void* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


def bwd_no_exps(src: str) -> str:
    """P = the scaled, shifted scores: no exp2 on the special-function unit."""
    return _sub(src, "      float p = exp2_ftz(fmaf(x[4 * j + e], scale_log2, -l[e]));",
                "      float p = fmaf(x[4 * j + e], scale_log2, -l[e]);")


def bwd_no_dk_product(src: str) -> str:
    """bwd_dkdv_tc issues no dK += dS^T Q."""
    return _sub(src, "      if constexpr (kDK) issue_rs<DP, BM>(dk, dsf, q_st);\n", "")


def bwd_no_dq_product(src: str) -> str:
    """bwd_dq_tc issues no dQ += dS K."""
    return _sub(src, "      issue_rs<DP, BN>(acc, dsf, k_st);\n", "")


def bwd_no_products(src: str) -> str:
    """Neither kernel issues any product."""
    src = _empty_body(src, "void issue_ss(", "(void)d; (void)a; (void)b;")
    return _empty_body(src, "void issue_rs(", "(void)acc; (void)a; (void)b;")


_BWD_Q_LOADS = """            mbar_expect_tx(bar_full(st), 2 * L::kQ + 2 * L::kRowBytes);
            for (int c = 0; c < kChunks; ++c)
              load_box(q_st + c * BM * 128, &tm_q, q_order, bar_full(st), 64 * c, q0, h, b);
            for (int c = 0; c < kChunks; ++c)
              load_box(do_st + c * BM * 128, &tm_do, do_order, bar_full(st), 64 * c, q0, h, b);
            bulk_load(rows_st, lse2 + rows + q0, L::kRowBytes, bar_full(st));
            bulk_load(rows_st + L::kRowBytes, delta + rows + q0, L::kRowBytes, bar_full(st));
"""
_BWD_KV_LOADS = """        mbar_expect_tx(bar_full(st), 2 * L::kKV);
        for (int c = 0; c < kChunks; ++c)
          load_box(k_st + c * BN * 128, &tm_k, k_order, bar_full(st), 64 * c, k0, hk, b);
        for (int c = 0; c < kChunks; ++c)
          load_box(v_st + c * BN * 128, &tm_v, v_order, bar_full(st), 64 * c, k0, hk, b);
"""


def bwd_no_loads(src: str) -> str:
    """The producers complete each stage's barrier with no bytes: the q tiles
    of bwd_dkdv_tc and the k tiles of bwd_dq_tc are never loaded (each
    block's own K/V, or Q/dO, tile still is)."""
    src = _sub(src, _BWD_Q_LOADS, "            mbar_expect_tx(bar_full(st), 0);\n"
               "            (void)q_st; (void)do_st; (void)rows_st; (void)rows;\n")
    return _sub(src, _BWD_KV_LOADS, "        mbar_expect_tx(bar_full(st), 0);\n"
                "        (void)k_st; (void)v_st;\n")


BWD_VARIANTS: Dict[str, Callable[[str], str]] = {
    "kernel": lambda src: src,
    "no exps": bwd_no_exps,
    "no dK product": bwd_no_dk_product,
    "no dQ product": bwd_no_dq_product,
    "no products": bwd_no_products,
    "no exps, no products": _chain(bwd_no_exps, bwd_no_products),
    "no exps, no products, no loads": _chain(bwd_no_exps, bwd_no_products, bwd_no_loads),
}


def all_patches() -> Dict[str, str]:
    """Every patched source by name (no build): what the CPU test applies."""
    src = SOURCE.read_text()
    out = {name: patch(src) for name, patch in VARIANTS.items()}
    out["sections"] = instrument(src)
    out["IEEE division"] = ieee_division(src)
    return out


def all_bwd_patches() -> Dict[str, str]:
    """Every patched backward source by name (no build)."""
    src = BWD_SOURCE.read_text()
    return {name: patch(src) for name, patch in BWD_VARIANTS.items()}


def _build(sources: Dict[str, str], kernel: str = "flash_attention",
           tag: str = "v") -> Dict[str, ctypes.CDLL]:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(sources.items()):
        cu, so = PROBE_DIR / f"{tag}{i}.cu", PROBE_DIR / f"{tag}{i}.so"
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
        for fn, (restype, argtypes) in build.SIGNATURES[kernel].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def _inputs(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for label, (b, s, h, hk, d) in SHAPES.items():
        q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        out[label] = (q, k, v)
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


def _restore(name: str, kept) -> None:
    if kept is None:
        build._LIBS.pop(name, None)
    else:
        build._LIBS[name] = kept


def _bwd_inputs(torch, dev, shape):
    """q, k, v, o, dO, lse of one BWD_SHAPES case in the training path's
    (B, S, H, D) layout, o and lse from the forward kernel."""
    from repro_torch.kernels.flash_attention import flash_attention

    b, s, t, hq, hkv, d, causal, window = shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q, do = (torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16() for _ in "qd")
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device=dev).bfloat16() for _ in "kv")
    o, lse = flash_attention(q, k, v, causal=causal, window=window, layout="bshd",
                             return_lse=True)
    return q, k, v, o, do, lse


def _by_kernel(per: Dict[str, float]) -> Dict[str, float]:
    """Device ms by the backward's kernel: delta (or prep), dkdv, dq."""
    out: Dict[str, float] = {}
    for name, ms in per.items():
        part = next((p for p in ("dkdv", "dq", "delta", "prep") if f"bwd_{p}" in name), name)
        part = "delta" if part == "prep" else part
        out[part] = round(out.get(part, 0.0) + ms, 4)
    out["total"] = round(sum(per.values()), 4)
    return out


# The script each tree runs in ``paired``: it reads only what every commit
# since the backward came has (``flash_attention_bwd``'s signature, the
# forward's inputs and event timing), and profiles the backward itself.
PAIRED_SCRIPT = """
import inspect, json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_probe import SHAPES, _event_ms, _inputs
dev = torch.device("cuda")
out = {}
lse = "return_lse" in inspect.signature(FA.flash_attention).parameters
for label, (q, k, v) in _inputs(torch, dev).items():
    out[label] = _event_ms(torch, lambda: FA.flash_attention(q, k, v, layout="bshd"), reps=50)
    if lse:
        out[label + " +lse"] = _event_ms(
            torch, lambda: FA.flash_attention(q, k, v, layout="bshd", return_lse=True), reps=50)
for label, shape in json.loads(sys.argv[1]).items():
    if not hasattr(FA, "flash_attention_bwd"):
        break
    b, s, t, hq, hkv, d, causal, window = shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q, do = (torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16() for _ in "qd")
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device=dev).bfloat16() for _ in "kv")
    o, l = FA.flash_attention(q, k, v, causal=causal, window=window, layout="bshd",
                              return_lse=True)
    call = lambda: FA.flash_attention_bwd(q, k, v, o, do, l, causal=causal, window=window,
                                          layout="bshd")
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((p for p in ("dkdv", "dq", "delta", "prep") if "bwd_" + p in e.name),
                        "other")
            name = "delta" if name == "prep" else name
            per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e4
    per["total"] = sum(per.values())
    out["bwd " + label] = {n: round(ms, 4) for n, ms in per.items()}
    del q, k, v, o, do, l
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def paired(trees: List[Path], rounds: int = 2) -> Dict[str, Dict[str, list]]:
    """Each shape's forward ms in every tree (a checkout's root each, its
    ``src`` first on the path), in turns: ``trees``, then reversed,
    ``rounds`` times over, each run a process of its own."""
    order: List[Path] = []
    for _ in range(rounds):
        order += list(trees) + list(trees)[::-1]
    out: Dict[str, Dict[str, list]] = {str(t): {} for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        proc = subprocess.run([sys.executable, "-c", PAIRED_SCRIPT, json.dumps(BWD_SHAPES)],
                              cwd=str(tree), env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"paired run in {tree} failed:\n{proc.stderr[-4000:]}")
        for label, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            out[str(tree)].setdefault(label, []).append(
                ms if isinstance(ms, dict) else round(ms, 4))
    return out


def _bwd_variants(torch, FA, dev) -> None:
    """Each backward variant's device ms by kernel at every BWD_SHAPES case,
    two rounds, then the card's name and power limit."""
    from repro_torch.kernels import measure

    libs = _build(all_bwd_patches(), FA.BWD_NAME, tag="b")
    kept = build._LIBS.get(FA.BWD_NAME)
    try:
        for label, shape in BWD_SHAPES.items():
            q, k, v, o, do, lse = _bwd_inputs(torch, dev, shape)
            causal, window = shape[6], shape[7]
            for rnd in range(2):
                for name in BWD_VARIANTS:
                    build._LIBS[FA.BWD_NAME] = libs[name]
                    per = measure.device_ms(torch, lambda: FA.flash_attention_bwd(
                        q, k, v, o, do, lse, causal=causal, window=window, layout="bshd"),
                        calls=10)
                    print(f"[bwd variants] {label} {shape}, round {rnd}, {name}: device ms "
                          f"{_by_kernel(per)}", flush=True)
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()
    finally:
        _restore(FA.BWD_NAME, kept)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


def main() -> int:
    import torch

    if "--paired" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--paired") + 1]).resolve()
        here = Path(__file__).resolve().parents[3]
        for tree, times in paired([here, other]).items():
            print(f"[paired] {tree}: {times}", flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip())
        return 0

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    if "--bwd" in sys.argv:
        _bwd_variants(torch, FA, dev)
        return 0
    sources = all_patches()
    libs = _build(sources)
    data = _inputs(torch, dev)
    kept = build._LIBS.get(FA.NAME)
    try:
        for rnd in range(2):
            for name in VARIANTS:
                build._LIBS[FA.NAME] = libs[name]
                times = []
                for label, (q, k, v) in data.items():
                    ms = _event_ms(torch, lambda: FA.flash_attention(q, k, v, layout="bshd"))
                    times.append(f"{label} {ms:.4f} ms")
                print(f"[variants] round {rnd}, {name}: " + "; ".join(times), flush=True)
        lib = libs["sections"]
        lib.probe_read.argtypes = [ctypes.c_void_p]
        build._LIBS[FA.NAME] = lib
        for label, (q, k, v) in data.items():
            for _ in range(3):
                FA.flash_attention(q, k, v, layout="bshd")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            build.check(lib.probe_read(buf), "probe_read")
            for wg in range(2):
                p = list(buf)[16 * wg:16 * wg + 16]
                tiles, items = max(p[12], 1), max(p[13], 1)
                print(f"[sections] {label}, block 0, warpgroup {wg}: {p[13]} items, {p[12]} loop "
                      f"tiles; cycles a loop tile: "
                      + ", ".join(f"{n} {p[i] / tiles:.0f}" for i, n in enumerate(LOOP_SECTIONS))
                      + "; cycles an item: "
                      + ", ".join(f"{n} {p[i] / items:.0f}" for i, n in ITEM_SECTIONS.items()),
                      flush=True)
        gen = torch.Generator(device=dev).manual_seed(2)
        b, s, h, hk, d = GEMMA3
        g3 = (torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16(),
              *(torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
                for _ in range(2)))
        for label, (q, k, v), window in (*((lb, x, 0) for lb, x in data.items()),
                                         ("gemma3", g3, 1024)):
            outs = []
            for name in ("kernel", "IEEE division"):
                build._LIBS[FA.NAME] = libs[name]
                outs.append(FA.flash_attention(q, k, v, window=window, layout="bshd"))
            torch.cuda.synchronize()
            print(f"[quotient] {label}: the kernel equals IEEE division bit for bit: "
                  f"{bool(torch.equal(*outs))} ({int((outs[0] != outs[1]).sum())} of "
                  f"{outs[0].numel()} differ)", flush=True)
        _restore(FA.NAME, kept)  # the host probe times the real library
        q = data["serving"][0][:, :64].contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            x = q.to(dtype)
            call = lambda: FA.flash_attention(x, x, x, layout="bshd")  # noqa: E731
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                call()
            torch.cuda.synchronize()
            print(f"[host] {dtype} B=16 S=T=64 H=32 D=64: "
                  f"{(time.perf_counter() - t0) / 2000 * 1e6:.1f} us a call", flush=True)
    finally:
        _restore(FA.NAME, kept)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
