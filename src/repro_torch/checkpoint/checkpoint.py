"""Fault-tolerant checkpointing (the port of ``repro/checkpoint/checkpoint.py``).

The reference's on-disk format, so a checkpoint written by either package
restores in the other:
  - ``step_N/shard_host0.npz`` with ``leaf_i`` the i-th leaf in the
    reference's flatten order (sorted dict keys), bf16 leaves upcast to
    float32; ``step_N/meta.json`` with ``step``, ``n_leaves``, ``extra`` and
    ``time``;
  - atomic publish: written to ``step_N.tmp/``, then ``os.replace``;
  - keep-last-k GC and a ``latest`` pointer written last;
  - async save: the caller's thread snapshots the tensors to host memory,
    a background thread does the IO (training continues);
  - the data pipeline's iterator state travels in ``extra``.

A card's tensors reach the host through a pinned staging buffer, a chunk
at a time (a pageable copy of tens of GB runs at a fraction of the link's
rate).  ``restore`` reads each stored npz member straight from the file at
its offset (``np.lib.format.read_array`` on the raw file: no per-chunk CRC
pass), which is what ``np.load`` would return.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_unflatten

STAGE_BYTES = 1 << 28  # the pinned staging buffer of a device's snapshot
_NATIVE = {torch.bool, torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
           torch.float16, torch.float32, torch.float64, torch.complex64, torch.complex128}
_STAGES: Dict[torch.device, torch.Tensor] = {}


def _stage(device: torch.device) -> torch.Tensor:
    buf = _STAGES.get(device)
    if buf is None:
        buf = _STAGES[device] = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
    return buf


def host_copy(x: Any) -> np.ndarray:
    """A numpy copy of one leaf; dtypes numpy lacks (bf16) upcast to
    float32, as the reference stores them."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    x = x.detach()
    if x.dtype not in _NATIVE:
        x = x.to(torch.float32)
    if x.device.type != "cuda":
        return x.numpy().copy()
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype)
    src, dst = x.reshape(-1).view(torch.uint8), out.reshape(-1).view(torch.uint8)
    stage = _stage(x.device)
    stream = torch.cuda.current_stream(x.device)
    for i in range(0, src.numel(), STAGE_BYTES):
        n = min(STAGE_BYTES, src.numel() - i)
        stage[:n].copy_(src[i:i + n], non_blocking=True)
        stream.synchronize()
        dst[i:i + n].copy_(stage[:n])
    return out.numpy()


def _npz_members(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, array) of every member of an npz file, read from the raw file
    at each stored member's data offset."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    yield name, np.lib.format.read_array(member, allow_pickle=False)
                continue
            f.seek(info.header_offset)
            head = f.read(30)
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            yield name, np.lib.format.read_array(f, allow_pickle=False)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.last_snapshot_s = 0.0  # the last save's host snapshot, seconds
        self.last_io_s = 0.0  # and its IO (set when the write ends)
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        # Snapshot to host synchronously, do the IO async.
        t0 = time.perf_counter()
        host_leaves = [host_copy(x) for x in tree_leaves(state)]
        self.last_snapshot_s = time.perf_counter() - t0
        if self._thread is not None:
            self._thread.join()  # one outstanding save at a time

        def _write():
            t_io = time.perf_counter()
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_host0.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            meta = {
                "step": step,
                "n_leaves": len(host_leaves),
                "extra": extra or {},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "latest.tmp"), os.path.join(self.dir, "latest"))
            self._gc()
            self.last_io_s = time.perf_counter() - t_io

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like``: each leaf cast to the
        dtype of ``like``'s leaf and put on that leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        refs = tree_leaves(like)
        out = [None] * len(refs)
        for name, arr in _npz_members(os.path.join(d, "shard_host0.npz")):
            i = int(name[len("leaf_"):])
            if i >= len(refs):
                raise ValueError(f"{d} holds leaf {i}; the structure has {len(refs)}")
            ref = refs[i]
            if isinstance(ref, torch.Tensor):
                out[i] = torch.from_numpy(arr).to(ref.device).to(ref.dtype)
            else:
                out[i] = arr.astype(np.asarray(ref).dtype)
        missing = [i for i, x in enumerate(out) if x is None]
        if missing:
            raise ValueError(f"{d} lacks leaves {missing}")
        return tree_unflatten(like, out), meta["extra"]
