"""The port's kernels against the reference's: on the CPU, each plain PyTorch
version against the jnp oracle (bit-equal: both add in row order) and the
Pallas kernel run in interpret mode, at ``tests/test_kernels.py``'s shapes.
The CUDA kernels themselves run only on the card (``cuda`` marker)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import build, ref
from repro_torch.kernels.segment_aggregate import (
    GLOBAL, GLOBAL_SCRATCH, PRIV_ROWS, PRIV_THREADS, PRIVATE, PRIVATE_LIMIT, SHARED,
    SHARED_LIMIT, STAGE_BYTES, THREADS, TILE_ROWS, grid)
from repro_torch.runtime.guards import LAUNCH_COUNTS

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [17, 1000, 5000])
@pytest.mark.parametrize("n_ranges", [3, 100, 1000])
def test_fragment_bitmap_plain_matches_reference(n, n_ranges):
    bucket = RNG.integers(0, n_ranges, n).astype(np.int32)
    prov = RNG.random(n) < 0.05
    want = np.asarray(jref.fragment_bitmap_ref(jnp.asarray(prov), jnp.asarray(bucket), n_ranges))
    pallas = np.asarray(jops.fragment_bitmap(jnp.asarray(prov), jnp.asarray(bucket), n_ranges,
                                             backend="interpret"))
    got = ops.fragment_bitmap(torch.from_numpy(prov), torch.from_numpy(bucket), n_ranges).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_fragment_bitmap_empty_provenance():
    bucket = torch.from_numpy(RNG.integers(0, 10, 100).astype(np.int32))
    assert not ops.fragment_bitmap(torch.zeros(100, dtype=torch.bool), bucket, 10).any()


@pytest.mark.parametrize("n", [64, 2048, 4097])
@pytest.mark.parametrize("n_ranges", [7, 129, 1000])
def test_sketch_filter_plain_matches_reference(n, n_ranges):
    bucket = RNG.integers(0, n_ranges, n).astype(np.int32)
    bits = RNG.random(n_ranges) < 0.4
    want = np.asarray(jref.sketch_filter_ref(jnp.asarray(bucket), jnp.asarray(bits)))
    pallas = np.asarray(jops.sketch_filter(jnp.asarray(bucket), jnp.asarray(bits),
                                           backend="interpret"))
    got = ops.sketch_filter(torch.from_numpy(bucket), torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,g", [(100, 5), (3000, 700), (2048, 512)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_aggregate_plain_matches_reference(n, g, dtype):
    """Bit-equal to the jnp oracle (row-order float32 sums on both sides);
    against the Pallas one-hot matmul, which reassociates the sums, within
    the reference test's own tolerance."""
    gid = RNG.integers(0, g, n).astype(np.int32)
    vals = RNG.normal(0, 10, n).astype(dtype)
    w = (RNG.random(n) < 0.5).astype(np.float32)
    s_ref, c_ref = jref.segment_aggregate_ref(jnp.asarray(vals), jnp.asarray(gid), g, jnp.asarray(w))
    s_pl, c_pl = jops.segment_aggregate(jnp.asarray(vals), jnp.asarray(gid), g, jnp.asarray(w),
                                        backend="interpret")
    s, c = ops.segment_aggregate(torch.from_numpy(vals), torch.from_numpy(gid), g,
                                 torch.from_numpy(w))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_pl), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_pl), rtol=1e-6)


def test_segment_aggregate_drops_out_of_range_gids():
    """gid -1 (the Pallas kernel's padding) and ids past n_groups add nothing."""
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    gid = torch.tensor([0, -1, 1, 5], dtype=torch.int32)
    s, c = ops.segment_aggregate(vals, gid, 2)
    assert s.tolist() == [1.0, 4.0] and c.tolist() == [1.0, 1.0]


def test_cpu_wrappers_use_plain_versions_without_launching():
    before = dict(LAUNCH_COUNTS)
    bucket = torch.tensor([0, 1, 1], dtype=torch.int32)
    ops.fragment_bitmap(torch.tensor([True, False, True]), bucket, 2)
    ops.sketch_filter(bucket, torch.tensor([False, True]))
    ops.segment_aggregate(torch.ones(3), bucket, 2)
    assert dict(LAUNCH_COUNTS) == before


def test_segment_aggregate_block_shape_matches_source():
    """The wrapper sizes the grid and shared memory from the block shapes
    that the CUDA source fixes."""
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["kPrivThreads"] == PRIV_THREADS
    assert const["kPrivThreads"] * const["kSteps"] == PRIV_ROWS
    threads, rows = const["kThreads"], const["kRows"]
    assert threads == THREADS and threads * rows == TILE_ROWS
    runs = rows * threads // 32
    assert STAGE_BYTES == 4 * (3 * threads * rows + threads // 32 * runs + 32)


@pytest.mark.parametrize("n,g,sms", [(1 << 23, 16, 132), (1 << 23, 1024, 132),
                                     (1 << 23, 2048, 132), (1 << 23, 16384, 132),
                                     (100, 4, 132), (1 << 20, 1 << 16, 132)])
def test_segment_aggregate_grid(n, g, sms):
    """The launch shape: per-warp partials while few groups, one shared copy
    while it fits, bounded global scratch above, and never more blocks than
    the rows need."""
    blocks, mode = grid(n, g, sms)
    part = 8 * g
    assert mode == (PRIVATE if 8 * part <= PRIVATE_LIMIT
                    else SHARED if part <= SHARED_LIMIT else GLOBAL)
    threads, rows = (PRIV_THREADS, PRIV_ROWS) if mode == PRIVATE else (THREADS, TILE_ROWS)
    assert 1 <= blocks <= max(1, -(-n // rows))
    assert blocks * threads <= 2048 * sms  # resident at once
    if mode == PRIVATE:
        assert blocks // sms * 8 * part <= 228 * 1024
    elif mode == SHARED:
        assert blocks // sms * (part + STAGE_BYTES) <= 228 * 1024
    else:
        assert blocks * part <= GLOBAL_SCRATCH


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 16, 700, 16384, 65536])
def test_segment_aggregate_kernel_matches_plain(cuda, g):
    gen = torch.Generator(device=cuda).manual_seed(g)
    n = 100_003
    gid = torch.randint(-1, g, (n,), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randint(0, 50, (n,), generator=gen, device=cuda).float()
    w = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    before = LAUNCH_COUNTS["segment_aggregate"]
    s1, c1 = ops.segment_aggregate(vals, gid, g, w)
    s2, c2 = ref.segment_aggregate_ref(vals, gid, g, w)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2) and torch.equal(c1, c2)  # integral: exact in any order
    assert LAUNCH_COUNTS["segment_aggregate"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", [16, 16384, 65536])
def test_segment_aggregate_kernel_reruns_give_equal_bits(cuda, g):
    """Non-integral sums: the kernel adds in a fixed order, so a rerun on the
    same inputs gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(g)
    n = 1 << 20
    gid = torch.randint(0, g, (n,), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randn(n, generator=gen, device=cuda)
    w = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
    first = ops.segment_aggregate(vals, gid, g, w)
    for _ in range(3):
        again = ops.segment_aggregate(vals, gid, g, w)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 20])
def test_bitmap_and_filter_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    bucket = torch.randint(0, 100, (n,), generator=gen, device=cuda, dtype=torch.int32)
    prov = torch.rand(n, generator=gen, device=cuda) < 0.1
    bits = torch.rand(100, generator=gen, device=cuda) < 0.4
    assert torch.equal(ops.fragment_bitmap(prov, bucket, 100),
                       ref.fragment_bitmap_ref(prov, bucket, 100))
    assert torch.equal(ops.sketch_filter(bucket, bits), ref.sketch_filter_ref(bucket, bits))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_arguments(cuda):
    from repro_torch.kernels.sketch_filter import sketch_filter

    bucket = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        sketch_filter(bucket, torch.ones(4, dtype=torch.bool, device=cuda))
