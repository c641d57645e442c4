"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists), the first time one of its kernels is
launched.  The hash covers the source, the local files it includes and the
flags, so an edited source builds anew.  :func:`build_all` starts one ``nvcc`` per source at once, so
building every kernel takes as long as the slowest one.  It holds an
exclusive lock on the build directory while it compiles, so processes that
start together (the shard servers of one coordinator) compile a missing
library once: the others wait, then load it.

Nothing here runs at import: the CPU test suite imports every module on a
machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

KERNELS: Tuple[str, ...] = ("segment_aggregate", "fragment_bitmap", "sketch_filter",
                            "fragment_bitmap_batch", "segment_aggregate_batch",
                            "flash_attention", "flash_attention_bwd", "selective_scan",
                            "slstm_scan", "selective_scan_bwd", "slstm_scan_bwd")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0 compiles a source's kernels in parallel: the attention
# backward's eight tensor-core kernels are the build's longest job.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

# C signatures of every exported function: (restype, argtypes).  Pointers
# and the stream are c_void_p: ctypes would cut a bare int to 32 bits.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "segment_aggregate": {
        "segagg_launch": (_I, [_I, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _I, _LL, _I, _LL]),
        "segagg_max_clusters": (_I, [_I, _I, _I, _LL]),
    },
    "fragment_bitmap": {
        "bitmap_clusters": (_I, [_I]),
        "bitmap_launch": (_I, [_I, _P, _P, _P, _LL, _I, _P, _P]),
    },
    "sketch_filter": {
        "filter_launch": (_I, [_I, _P, _P, _P, _LL, _I, _P]),
        "filter_rows_launch": (_I, [_I, _P, _P, _P, _LL, _I, _P, _P, _P, _LL, _I, _LL]),
    },
    "fragment_bitmap_batch": {
        "bitmap_batch_clusters": (_I, [_I, _I, _I]),
        "bitmap_batch_launch": (_I, [_I, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _I, _I]),
    },
    "segment_aggregate_batch": {
        "segagg_batch_launch": (_I, [_I, _P, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _I, _LL,
                                     _I, _LL]),
        "segagg_max_clusters": (_I, [_I, _I, _I, _LL]),
    },
    "flash_attention": {
        "flash_attention_block_q": (_I, [_I]),
        "flash_attention_block_k": (_I, [_I, _I]),
        "flash_attention_padded_dim": (_I, [_I, _I]),
        "flash_attention_max_head_dim": (_I, []),
        "flash_attention_f32_launch": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
                                       + [_LL] * 12 + [_I, _I, _F, _P]),
        "flash_attention_bf16_launch": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                             _I, _LL, _LL, _LL, _I, _I, _F, _P]),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_plan": (None, [_I, _P]),
        "flash_attention_bwd_launch": (_I, [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                            _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _F]),
    },
    "selective_scan": {
        "selective_scan_launch": (_I, [_I, _P, _I, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I]),
        "selective_scan_occupancy": (_I, [_I, _I, _I, _I, _P]),
    },
    "slstm_scan": {
        "slstm_scan_launch": (_I, [_I, _P, _I, _I, _P, _P, _P, _P] + [_I] * 8 + [_P] * 4),
        "slstm_scan_max_clusters": (_I, [_I] * 10),
    },
    "selective_scan_bwd": {
        "selective_scan_bwd_launch": (_I, [_I, _P, _I, _I, _P, _P, _LL] + [_P] * 20
                                      + [_I] * 4),
        "selective_scan_bwd_occupancy": (_I, [_I, _I, _I, _I, _P]),
    },
    "slstm_scan_bwd": {
        "slstm_scan_bwd_launch": (_I, [_I, _P, _I] + [_P] * 7 + [_I] * 8),
        "slstm_scan_bwd_max_clusters": (_I, [_I] * 9),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` failed or is missing."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the local files it includes (``#include "x"``),
    and theirs, each once, in the order first included."""
    out = [CSRC / f"{name}.cu"]
    for src in out:  # grows as it goes
        for dep in re.findall(r'^#include "([^"]+)"', src.read_text(), flags=re.M):
            if CSRC / dep not in out:
                out.append(CSRC / dep)
    return out


def library_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(name))
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive ``flock`` on the build directory's lock file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source that has no library yet, all at once.

    Returns the compiler's output per source built (``-Xptxas -v`` lists
    each kernel's registers and shared memory); raises
    :class:`KernelBuildError` with that output if any build fails.
    """
    names = list(names)
    if all(library_path(name).exists() for name in names):
        return {}
    with _build_lock():
        return _build_missing(names)


def _build_missing(names: List[str]) -> Dict[str, str]:
    """``build_all``'s compile, under the lock (a library another process
    built while this one waited is not built again)."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, so))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> int:
    """The current CUDA stream of ``device``, as a pointer (the raw query
    PyTorch's own kernel launchers use, which builds no ``torch.cuda.Stream``
    object: a launch's host time is on every call's path)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check_tensor(t, name: str, dtype, device, shape: Sequence[int] = None) -> None:
    """Validate one argument before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
