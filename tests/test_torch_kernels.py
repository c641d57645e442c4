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
from repro_torch.kernels import segment_aggregate as ksa
from repro_torch.kernels.segment_aggregate import (
    BARRIER_BYTES, CLUSTER_MAX, PRIV_CLUSTER, PRIV_THREADS, PRIVATE_GROUPS, RING_BYTES, SLICE_MAX,
    COUNT_BYTES, SMEM_MAX, STAGES, STEP_ROWS, TILE_ROWS, plan, private_smem, sliced_smem)
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
    """The wrapper plans launches and shared memory from the block shapes,
    ring and slice sizes that the CUDA source fixes, and the source's header
    states the shared bytes the plan gives."""
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["kPrivThreads"] == PRIV_THREADS
    assert (const["kStepRows"], const["kPrivCluster"], const["kCopyGroups"],
            const["kPrivMinBlocks"], const["kPrivateGroups"], const["kMinSteps"]) == (
        STEP_ROWS, PRIV_CLUSTER, ksa.COPY_GROUPS, ksa.PRIV_MIN_BLOCKS, PRIVATE_GROUPS,
        ksa.MIN_STEPS)
    assert STEP_ROWS == 32 * 4  # 4 rows a lane: one 16-byte load of each array
    assert (const["kTileRows"], const["kStages"], const["kSliceMax"], const["kClusterMax"],
            const["kBarrierBytes"]) == (TILE_ROWS, STAGES, SLICE_MAX, CLUSTER_MAX, BARRIER_BYTES)
    assert "constexpr int kStageWords = kTileRows + 4;" in src
    assert (const["kFilters"], const["kAdders"]) == (ksa.FILTERS, ksa.ADDERS)
    assert COUNT_BYTES == STAGES * ksa.FILTERS * 4
    assert RING_BYTES == STAGES * 3 * (TILE_ROWS + 4) * 4
    assert 8 * 8 * PRIVATE_GROUPS == 64 * 1024  # 8 warps' copies of 2 * G floats
    # ... and a byte tag a slot unless each lane has its own copy
    assert private_smem(PRIVATE_GROUPS) == 8 * (8 * 1024 + 1024) <= SMEM_MAX
    assert [ksa.copies_of(g) for g in (1, 16, 17, 32, 128, 256, 512, 1024)] == [
        32, 32, 16, 16, 4, 2, 1, 1]
    assert private_smem(16) == 8 * 8 * 16 * 32 and private_smem(128) == 8 * (8 + 1) * 128 * 4
    for bytes_ in (RING_BYTES, sliced_smem(2048), sliced_smem(4096)):
        assert f"{bytes_:,}" in src, bytes_
    assert ksa.WINDOW_GROUPS == CLUSTER_MAX * SLICE_MAX
    assert f"kClusterMax * kSliceMax = {ksa.WINDOW_GROUPS:,} groups" in src


@pytest.mark.parametrize("n,g,sms", [(1 << 23, 16, 132), (1 << 23, 1024, 132),
                                     (1 << 23, 2048, 132), (1 << 23, 16384, 132),
                                     (100, 4, 132), (1 << 20, 1 << 16, 132)])
def test_segment_aggregate_grid(n, g, sms):
    """The launch shape: while few groups, whole clusters of blocks with
    per-warp copies, no more than the card holds at once and no more than
    give every warp a step of rows; above, clusters whose windows of slices
    cover the groups, one per chunk of whole tiles and window, every chunk
    holding rows, no more clusters than the card holds at once."""
    p = plan(n, g, sms)
    if g <= PRIVATE_GROUPS:
        assert p.cluster == 0 and p.windows == 1 and p.smem == private_smem(g)
        assert p.parts % PRIV_CLUSTER == 0 and p.parts >= PRIV_CLUSTER
        steps = -(-n // STEP_ROWS)
        assert p.parts == PRIV_CLUSTER or (p.parts - PRIV_CLUSTER) * 8 < steps
        per_sm = min(ksa.PRIV_MIN_BLOCKS, 2048 // PRIV_THREADS, 228 * 1024 // (p.smem + 1024))
        assert p.parts <= sms * per_sm  # resident at once
        assert p.parts // sms * p.smem <= 228 * 1024
        assert ksa.partial_sets(p) == p.parts // PRIV_CLUSTER
        assert plan(n, g, sms, max_clusters=5).parts <= 5 * PRIV_CLUSTER
        return
    assert 1 <= p.cluster <= CLUSTER_MAX and p.cluster * p.slice * p.windows >= g
    assert p.smem == sliced_smem(p.slice) <= SMEM_MAX
    assert p.part_rows % TILE_ROWS == 0
    assert (p.parts - 1) * p.part_rows < n <= p.parts * p.part_rows
    per_sm = min(2048 // ((ksa.FILTERS + ksa.ADDERS + 1) * 32), 228 * 1024 // (p.smem + 1024))
    assert p.parts * p.windows * p.cluster <= sms * per_sm
    assert plan(n, g, sms, max_clusters=5).parts <= 5


@pytest.mark.parametrize("g", [2048, 4096, 16384, 1 << 16])
@pytest.mark.parametrize("n", [1, 100_003, 1 << 20, 1 << 23])
def test_segment_aggregate_plan_invariants(n, g):
    """Above 1,024 groups: a portable cluster (at most 8 blocks; the source
    sets no non-portable size), windows of slices that cover the groups (at
    most 4,096 a block; one window up to 32,768 groups), two blocks an SM
    at every width, at most 227 KB of shared memory, and a row's partials
    at most a quarter of its input bytes for n >= 2^20."""
    p = plan(n, g, 132)
    assert p.cluster <= 8 and p.cluster * p.slice * p.windows >= g and p.stages == STAGES
    assert p.smem <= 232_448
    assert p.slice <= SLICE_MAX and 2 * (p.smem + 1024) <= 228 * 1024
    assert 2 * (ksa.FILTERS + ksa.ADDERS + 1) * 32 <= 2048
    assert p.windows == (1 if g <= ksa.WINDOW_GROUPS else -(-g // ksa.WINDOW_GROUPS))
    if n >= 1 << 20:
        assert p.parts * 8 * g <= 12 * n // 4
    assert (p.parts - 1) * p.part_rows < max(n, 1) <= p.parts * p.part_rows
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    assert "NonPortableClusterSizeAllowed" not in src


@pytest.mark.parametrize("g", [32768, 32769, 65536, 100_000, 1 << 18, 1 << 24])
def test_segment_aggregate_wide_group_bys_take_windows(g):
    """Any width runs (the executor pads a group-by to the next power of
    two, without a cap): above 32,768 groups the blocks keep the widest
    slice's shape and the grid's z axis adds windows of a full cluster,
    whose slices cover [0, g) once each; a row's partials still scale with
    its rows."""
    cluster, slice_, windows, smem = ksa.slice_shape(g)
    assert (cluster, slice_, smem) == (CLUSTER_MAX, SLICE_MAX, sliced_smem(SLICE_MAX))
    assert windows == -(-g // ksa.WINDOW_GROUPS) <= 65535
    los = [(z * cluster + c) * slice_ for z in range(windows) for c in range(cluster)]
    owned = [max(0, min(slice_, g - lo)) for lo in los]
    assert sum(owned) == g and all(w == slice_ for w in owned[:g // slice_])
    p = plan(1 << 23, g, 132)
    assert p.windows == windows and (p.parts == 1 or p.parts * p.windows * p.cluster <= 132 * 2)
    assert p.parts * 8 * g <= 12 * (1 << 23) // 4 or p.parts == 1
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    assert "(int64_t)blockIdx.z * n_ctas + rank) * slice" in src


@pytest.mark.parametrize("b,n,g", [(1, 100, 5), (4, 700, 130), (3, 2048, 512)])
def test_segment_aggregate_batch_plain_matches_reference(b, n, g):
    """At ``tests/test_kernels.py:53``'s shapes, on integral inputs: the
    batched plain version equals the jnp oracle, the Pallas batch kernel in
    interpret mode, and the unbatched version row by row, bit for bit."""
    gid = RNG.integers(0, g, (b, n)).astype(np.int32)
    vals = RNG.integers(0, 100, (b, n)).astype(np.float32)
    w = (RNG.random((b, n)) < 0.5).astype(np.float32)
    s_ref, c_ref = jref.segment_aggregate_batch_ref(jnp.asarray(vals), jnp.asarray(gid), g,
                                                    jnp.asarray(w))
    s_pl, c_pl = jops.segment_aggregate_batch(jnp.asarray(vals), jnp.asarray(gid), g,
                                              jnp.asarray(w), backend="interpret")
    s, c = ops.segment_aggregate_batch(torch.from_numpy(vals), torch.from_numpy(gid), g,
                                       torch.from_numpy(w))
    for got, want in ((s, s_ref), (c, c_ref), (s, s_pl), (c, c_pl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(b):
        s1, c1 = ops.segment_aggregate(torch.from_numpy(vals[i]), torch.from_numpy(gid[i]), g,
                                       torch.from_numpy(w[i]))
        assert torch.equal(s[i], s1) and torch.equal(c[i], c1)


def test_segment_aggregate_batch_plain_drops_out_of_range_gids_per_row():
    vals = torch.tensor([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]])
    gid = torch.tensor([[0, -1, 2], [1, 1, 0]], dtype=torch.int32)
    s, c = ref.segment_aggregate_batch_ref(vals, gid, 2)
    assert s.tolist() == [[1.0, 0.0], [32.0, 24.0]] and c.tolist() == [[1.0, 0.0], [1.0, 2.0]]


def test_batched_wrapper_on_the_cpu_launches_nothing():
    before = dict(LAUNCH_COUNTS)
    ops.segment_aggregate_batch(torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32), 1)
    assert dict(LAUNCH_COUNTS) == before


@pytest.mark.parametrize("b,n,g", [(1, 1 << 23, 16384), (8, 1 << 20, 128), (8, 1 << 20, 16384),
                                   (16, 1 << 23, 64), (64, 1 << 20, 1 << 16)])
def test_segment_aggregate_batch_grid(b, n, g):
    """A batched launch runs the unbatched plan on every row, whatever B is
    (so each row adds in an unbatched launch's order), and its scratch is B
    rows of that plan's partials: within a quarter of the input bytes above
    1,024 groups."""
    p = plan(n, g, 132)
    sums, counts = ksa._buffers(torch.device("meta"), (b, g))
    assert sums.shape == counts.shape == (b, g)
    if g > PRIVATE_GROUPS:
        assert 4 * b * ksa.partial_sets(p) * 2 * g * 4 <= b * n * 12
    else:
        assert ksa.partial_sets(p) <= 132 * ksa.PRIV_MIN_BLOCKS // PRIV_CLUSTER
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    assert "blockIdx.y" in src and "gridDim.y" not in src  # no row sees the batch size


@pytest.mark.parametrize("g", [1, 16, 128, 255, 256, 512, 1024])
@pytest.mark.parametrize("n", [1, 4096, 100_003, 1 << 20, 1 << 23])
def test_segment_aggregate_private_plan_invariants(n, g):
    """Up to 1,024 groups: one launch of whole clusters, a function of (n, G,
    the card) alone (no batch size enters ``plan``), at most the resident
    clusters; the last cluster's tree gives each of the 2G outputs a
    power-of-two group of threads, at most a warp, within the cluster's
    2,048 threads; copies a warp holding at most COPY_GROUPS groups together
    (or one copy), byte tags unless a lane has a copy of its own."""
    for sms, clusters in ((132, None), (132, 66), (132, 49), (114, None)):
        p = plan(n, g, sms, clusters)
        assert p == plan(n, g, sms, clusters)
        assert p.cluster == 0 and p.part_rows == 0 and p.smem == private_smem(g)
        sets = ksa.partial_sets(p)
        cap = clusters or sms * min(ksa.PRIV_MIN_BLOCKS, 228 * 1024 // (p.smem + 1024)) // 8
        assert 1 <= sets <= cap and p.parts == sets * PRIV_CLUSTER
        if n >= 1 << 23:
            assert sets == cap  # every resident cluster has rows
        # ... each warp at least MIN_STEPS steps of the row, where the rows allow
        assert sets == 1 or (sets - 1) * 64 * ksa.MIN_STEPS * STEP_ROWS < n
        tpo = ksa.merge_threads(g)
        assert tpo & (tpo - 1) == 0 and 1 <= tpo <= 32 and tpo * 2 * g <= 2048
        assert tpo == 32 or 2 * tpo * 2 * g > 2048
    c = ksa.copies_of(g)
    assert c & (c - 1) == 0 and (c * g <= ksa.COPY_GROUPS or c == 1) and (c == 32 or 2 * c * g > 512)
    assert private_smem(g) == 8 * (8 * g * c + (0 if c == 32 else -(-g * c // 16) * 16))
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    assert "while (tpo < 32 && tpo * 2 * copy <= kClusterThreads) tpo *= 2;" in src


def test_segment_aggregate_workspace_grows_and_is_kept():
    """The partial sets and tickets live in one workspace per device and
    stream: a call that needs no more reuses it, a larger one replaces it
    with at least twice the room (tickets zeroed when made)."""
    dev = torch.device("meta")
    key = (dev.index, -1)
    try:
        first = ksa._workspace(dev, -1, 1000, 3)
        assert first.scratch.numel() == 1000 and first.tickets.numel() == 64
        assert first.tickets.dtype == torch.int32
        assert ksa._workspace(dev, -1, 800, 64) is first
        grown = ksa._workspace(dev, -1, 1001, 1)
        assert grown is not first and grown.scratch.numel() == 2000
        assert ksa._workspace(dev, -1, 10, 65).tickets.numel() == 128
    finally:
        ksa._WORKSPACES.pop(key, None)


def test_batched_source_builds_on_the_unbatched_kernels():
    """segment_aggregate_batch.cu includes segment_aggregate.cu (one set of
    kernels, the batch row a grid axis), and its library's hash covers both
    and the Hopper header they include, so an edit of any rebuilds it."""
    csrc = Path(build.__file__).parent / "csrc"
    src = (csrc / "segment_aggregate_batch.cu").read_text()
    assert '#include "segment_aggregate.cu"' in src and "segagg_run(" in src
    assert build._sources("segment_aggregate_batch") == [
        csrc / "segment_aggregate_batch.cu", csrc / "segment_aggregate.cu", csrc / "hopper.cuh"]
    assert "blockIdx.y" in (csrc / "segment_aggregate.cu").read_text()
    assert "segment_aggregate_batch" in build.KERNELS


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 16, 700, 2048, 4096, 16384, 65536, 1 << 18])
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
@pytest.mark.parametrize("g", [16, 4096, 16384, 65536])
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,g", [(1, 100, 5), (4, 700, 130), (3, 2048, 512),
                                   (8, 1 << 18, 128), (8, 1 << 18, 4096), (8, 1 << 18, 16384),
                                   (3, 100_003, 2048), (2, 1 << 16, 65536),
                                   (2, 100_003, 1 << 18)])
def test_segment_aggregate_batch_kernel_matches_plain_and_rows(cuda, b, n, g):
    """Integral inputs: the batched kernel equals its plain version and the
    unbatched kernel row by row, bit for bit, in one launch."""
    gen = torch.Generator(device=cuda).manual_seed(b * n + g)
    gid = torch.randint(-1, g, (b, n), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randint(0, 50, (b, n), generator=gen, device=cuda).float()
    w = (torch.rand((b, n), generator=gen, device=cuda) < 0.5).float()
    before = LAUNCH_COUNTS["segment_aggregate_batch"]
    s, c = ops.segment_aggregate_batch(vals, gid, g, w)
    assert LAUNCH_COUNTS["segment_aggregate_batch"] == before + 1
    s2, c2 = ref.segment_aggregate_batch_ref(vals, gid, g, w)
    torch.cuda.synchronize()
    assert torch.equal(s, s2) and torch.equal(c, c2)
    for i in range(b):
        s1, c1 = ops.segment_aggregate(vals[i].contiguous(), gid[i].contiguous(), g,
                                       w[i].contiguous())
        assert torch.equal(s[i], s1) and torch.equal(c[i], c1), i


@pytest.mark.cuda
@pytest.mark.parametrize("g", [16, 4096, 16384])
def test_segment_aggregate_batch_kernel_reruns_give_equal_bits(cuda, g):
    """Normal inputs: reruns give equal bits, and each row equals the
    unbatched kernel on it (same block count, same order of additions)."""
    gen = torch.Generator(device=cuda).manual_seed(g)
    b, n = 4, 1 << 18
    gid = torch.randint(0, g, (b, n), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randn((b, n), generator=gen, device=cuda)
    w = (torch.rand((b, n), generator=gen, device=cuda) < 0.5).float()
    first = ops.segment_aggregate_batch(vals, gid, g, w)
    for _ in range(3):
        again = ops.segment_aggregate_batch(vals, gid, g, w)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    for i in range(b):
        s1, c1 = ops.segment_aggregate(vals[i].contiguous(), gid[i].contiguous(), g,
                                       w[i].contiguous())
        assert torch.equal(first[0][i], s1) and torch.equal(first[1][i], c1), i


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2048, 16384])
def test_segment_aggregate_kernels_take_views_at_any_4_byte_boundary(cuda, g):
    """Rows of a (b, n) tensor with odd n start at every 4-byte offset of a
    16-byte segment; the bulk copies read the segments around each tile and
    add only its rows: each view, and the batch, equal the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(g + 1)
    b, n = 5, 100_003
    gid = torch.randint(-1, g, (b, n), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randint(0, 50, (b, n), generator=gen, device=cuda).float()
    w = (torch.rand((b, n), generator=gen, device=cuda) < 0.5).float()
    assert {vals[i].data_ptr() % 16 for i in range(b)} == {0, 4, 8, 12}
    s, c = ops.segment_aggregate_batch(vals, gid, g, w)
    s2, c2 = ref.segment_aggregate_batch_ref(vals, gid, g, w)
    assert torch.equal(s, s2) and torch.equal(c, c2)
    for i in range(b):
        s1, c1 = ops.segment_aggregate(vals[i], gid[i], g, w[i])
        assert torch.equal(s1, s2[i]) and torch.equal(c1, c2[i]), i
    # A view that starts and ends inside one 16-byte segment.
    s1, c1 = ops.segment_aggregate(vals[1, 1:3], gid[1, 1:3], g, w[1, 1:3])
    s3, c3 = ref.segment_aggregate_ref(vals[1, 1:3], gid[1, 1:3], g, w[1, 1:3])
    assert torch.equal(s1, s3) and torch.equal(c1, c3)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [4096, 16384])
def test_segment_aggregate_ring_is_not_refilled_early(cuda, g):
    """Many passes of the shared-memory ring in every cluster: each row's
    value and group follow from its index, so a stage refilled before every
    block of the cluster released it (another tile's rows read in its place)
    moves some group's sum or count; integral, so the plain version's bits
    are the truth."""
    n = 1 << 22
    i = torch.arange(n, device=cuda)
    gid = ((i * 7919) % (g + 3) - 3).to(torch.int32)  # 3 of every g + 3 rows outside
    vals = (i % 251 + 1).float()
    w = ((i // 5) % 3 != 0).float()
    for _ in range(3):
        s, c = ops.segment_aggregate(vals, gid, g, w)
        s2, c2 = ref.segment_aggregate_ref(vals, gid, g, w)
        assert torch.equal(s, s2) and torch.equal(c, c2)
    sb, cb = ops.segment_aggregate_batch(torch.stack([vals, vals.flip(0)]),
                                         torch.stack([gid, gid.flip(0)]), g,
                                         torch.stack([w, w.flip(0)]))
    assert torch.equal(sb[0], s2) and torch.equal(cb[0], c2)
    s3, c3 = ref.segment_aggregate_ref(vals.flip(0), gid.flip(0), g, w.flip(0))
    assert torch.equal(sb[1], s3) and torch.equal(cb[1], c3)


def test_segagg_probe_patches_apply():
    """``kernels/segagg_probe.py`` patches the kernel source by text: every
    patch still finds its anchor, each variant differs from the kernel, and
    the instrumented copy marks every section of every role; so does every
    patch of the few-group mode (``--few``)."""
    from repro_torch.kernels import segagg_probe

    few = segagg_probe.all_few_patches()
    assert few.pop("kernel") == segagg_probe.SOURCE.read_text()
    assert set(few) == set(segagg_probe.FEW_VARIANTS) - {"kernel"}
    assert all(text != segagg_probe.SOURCE.read_text() for text in few.values())
    assert segagg_probe.TIMING_ONLY <= set(few)
    sources = segagg_probe.all_patches()
    kernel = sources.pop("kernel")
    assert kernel == segagg_probe.SOURCE.read_text()
    assert set(sources) == set(segagg_probe.VARIANTS) - {"kernel"} | {"sections"}
    assert all(text != kernel for text in sources.values())
    marks = {int(m) for m in re.findall(r"MARK\((\d+)\);", sources["sections"])}
    slots = set(segagg_probe.FILTER_SECTIONS) | set(segagg_probe.ADDER_SECTIONS) | set(
        segagg_probe.PRODUCER_SECTIONS)
    assert marks == slots - {3}  # slot 3 (the adds) is summed around the call, not marked
    assert "probe_read" in sources["sections"]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [4096, 16384])
def test_segment_aggregate_clustered_groups(cuda, g):
    """A table clustered on the group-by: runs of one group, some crossing a
    slice's edge and a run of 32's, are summed in a fixed order before they
    are added: integral sums equal the plain version's, normal ones rerun to
    equal bits, and batch rows equal the unbatched kernel."""
    n = 1 << 20
    i = torch.arange(n, device=cuda)
    gid = ((i // 1000) * 997 % (g + 1) - 1).to(torch.int32)  # runs of 1,000 rows
    gid[::7] = ((i[::7] * 31) % g).to(torch.int32)  # broken by other groups
    vals = (i % 13).float()
    w = ((i // 3) % 5 != 0).float()
    s, c = ops.segment_aggregate(vals, gid, g, w)
    s2, c2 = ref.segment_aggregate_ref(vals, gid, g, w)
    assert torch.equal(s, s2) and torch.equal(c, c2)
    gen = torch.Generator(device=cuda).manual_seed(g)
    normal = torch.randn(n, generator=gen, device=cuda)
    first = ops.segment_aggregate(normal, gid, g, w)
    again = ops.segment_aggregate(normal, gid, g, w)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    sb, cb = ops.segment_aggregate_batch(torch.stack([normal, vals]), torch.stack([gid, gid]), g,
                                         torch.stack([w, w]))
    assert torch.equal(sb[0], first[0]) and torch.equal(cb[0], first[1])
    assert torch.equal(sb[1], s) and torch.equal(cb[1], c)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("g", [1, 16, 128, 512, 1024])
def test_segment_aggregate_private_kernel(cuda, g, order):
    """Up to 1,024 groups, random gids and sorted ones (a table clustered
    on the group-by, whose runs the kernel sums before it adds them), with
    out-of-range gids and weight-0 rows among them: integral inputs give
    the plain version's bits, normal ones rerun to equal bits within 1e-5
    of the float64 sum, and each batch row equals the unbatched kernel."""
    gen = torch.Generator(device=cuda).manual_seed(g + len(order))
    for n in (1, 129, 100_003, 1 << 21):
        gid = torch.randint(-2, g + 2, (n,), generator=gen, device=cuda, dtype=torch.int32)
        if order == "sorted":
            gid = gid.sort().values
        vals = torch.randint(0, 50, (n,), generator=gen, device=cuda).float()
        w = (torch.rand(n, generator=gen, device=cuda) < 0.5).float()
        s, c = ops.segment_aggregate(vals, gid, g, w)
        s2, c2 = ref.segment_aggregate_ref(vals, gid, g, w)
        assert torch.equal(s, s2) and torch.equal(c, c2), n
        normal = torch.randn(n, generator=gen, device=cuda)
        first = ops.segment_aggregate(normal, gid, g, w)
        for _ in range(2):
            again = ops.segment_aggregate(normal, gid, g, w)
            assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]), n
        ok = (gid >= 0) & (gid < g)
        truth = torch.zeros(g, dtype=torch.float64, device=cuda).index_add_(
            0, gid[ok].long(), (normal * w)[ok].double())
        scale = torch.zeros(g, dtype=torch.float64, device=cuda).index_add_(
            0, gid[ok].long(), (normal * w)[ok].abs().double())
        assert float(((first[0].double() - truth).abs() - 1e-5 * scale).max()) <= 0, n
        sb, cb = ops.segment_aggregate_batch(torch.stack([normal, vals, normal]),
                                             torch.stack([gid, gid, gid.flip(0)]), g,
                                             torch.stack([w, w, w]))
        assert torch.equal(sb[0], first[0]) and torch.equal(cb[0], first[1]), n
        assert torch.equal(sb[1], s) and torch.equal(cb[1], c), n
        s3, c3 = ops.segment_aggregate(normal, gid.flip(0).contiguous(), g, w)
        assert torch.equal(sb[2], s3) and torch.equal(cb[2], c3), n


@pytest.mark.cuda
def test_segment_aggregate_back_to_back_calls_see_no_stale_workspace(cuda):
    """Calls on one stream with no wait between them, of other n, G and B
    (the private kernel's tickets and partial sets and the sliced kernel's
    partials share a workspace): each result equals its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    calls = []
    for b, n, g in ((0, 1 << 22, 16), (3, 5000, 1024), (0, 1, 1), (8, 1 << 18, 128),
                    (0, 1 << 20, 4096), (2, 100_003, 512), (0, 1 << 22, 16), (16, 4096, 64)):
        rows = max(b, 1)
        gid = torch.randint(-1, g + 1, (rows, n), generator=gen, device=cuda, dtype=torch.int32)
        vals = torch.randint(0, 20, (rows, n), generator=gen, device=cuda).float()
        w = (torch.rand((rows, n), generator=gen, device=cuda) < 0.7).float()
        calls.append((b, gid, vals, w, g))
    out = [ops.segment_aggregate_batch(vals, gid, g, w) if b
           else ops.segment_aggregate(vals[0], gid[0], g, w[0]) for b, gid, vals, w, g in calls]
    torch.cuda.synchronize()
    for (s, c), (b, gid, vals, w, g) in zip(out, calls):
        s2, c2 = (ref.segment_aggregate_batch_ref(vals, gid, g, w) if b
                  else ref.segment_aggregate_ref(vals[0], gid[0], g, w[0]))
        assert torch.equal(s, s2) and torch.equal(c, c2), (b, g)


# ---- sketch_filter's compaction and the one-launch fragment_bitmap ---------------


@pytest.mark.parametrize("n", [0, 1, 4097, (1 << 16) + 3])
@pytest.mark.parametrize("n_ranges", [1, 100, 4096])
def test_sketch_filter_rows_plain_matches_reference(n, n_ranges):
    """The plain mask and its kept rows against ``np.nonzero`` of the
    reference's Pallas kernel in interpret mode, whose one-hot compare keeps
    no row with a bucket outside [0, n_ranges) (-1 and >= n_ranges are
    drawn); at n = 0, where the Pallas grid is empty, against the jnp
    oracle."""
    rng = np.random.default_rng(7 * n + n_ranges)
    bucket = rng.integers(-1, n_ranges + 2, n).astype(np.int32)
    bits = rng.random(n_ranges) < 0.4
    if n:
        want = np.asarray(jops.sketch_filter(jnp.asarray(bucket), jnp.asarray(bits),
                                             backend="interpret"))
    else:
        want = np.asarray(jref.sketch_filter_ref(jnp.asarray(bucket), jnp.asarray(bits)))
    keep, rows = ops.sketch_filter_rows(torch.from_numpy(bucket), torch.from_numpy(bits))
    assert rows.dtype == torch.int64
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(rows.numpy(), np.nonzero(want)[0])
    np.testing.assert_array_equal(
        ops.sketch_filter(torch.from_numpy(bucket), torch.from_numpy(bits)).numpy(), want)


def test_plain_versions_drop_out_of_range_buckets():
    """Rows whose bucket lies outside [0, n_ranges) are not kept by the
    plain mask and set no bit of the plain bitmap, as in the kernels."""
    bucket = torch.tensor([-1, 0, 3, 2, 7, -5], dtype=torch.int32)
    bits = torch.tensor([True, False, True])
    keep, rows = ref.sketch_filter_rows_ref(bucket, bits)
    assert keep.tolist() == [False, True, False, True, False, False]
    assert rows.tolist() == [1, 3]
    prov = torch.tensor([True, False, True, False, True, True])
    assert ref.fragment_bitmap_ref(prov, bucket, 3).tolist() == [False, False, False]
    prov[3] = True
    assert ref.fragment_bitmap_ref(prov, bucket, 3).tolist() == [False, False, True]


@pytest.mark.parametrize("n", [17, 5000])
@pytest.mark.parametrize("n_ranges", [3, 100, 1000])
def test_fragment_bitmap_plain_drops_out_of_range_as_reference(n, n_ranges):
    """The plain bitmap against the reference's Pallas kernel in interpret
    mode where provenance rows have buckets outside [0, n_ranges): -1,
    n_ranges, values below the kernel's lane-padded width (whose bits it
    computes and slices off) and at or beyond it.  In-range provenance
    only reaches the lower half of the ranges, so a row wrapped or clamped
    into the top range would show."""
    padded = n_ranges + (-n_ranges % 128)
    rng = np.random.default_rng(11 * n + n_ranges)
    bucket = rng.integers(0, n_ranges, n).astype(np.int32)
    spill = rng.random(n) < 0.4
    spill[:2] = True
    outside = np.array([-1, -7, n_ranges, n_ranges + 1, padded - 1, padded, padded + 5],
                       dtype=np.int32)
    bucket[spill] = rng.choice(outside, int(spill.sum()))
    prov = spill | ((rng.random(n) < 0.3) & (bucket >= 0) & (bucket < max(1, n_ranges // 2)))
    pallas = np.asarray(jops.fragment_bitmap(jnp.asarray(prov), jnp.asarray(bucket), n_ranges,
                                             backend="interpret"))
    got = ops.fragment_bitmap(torch.from_numpy(prov), torch.from_numpy(bucket), n_ranges).numpy()
    np.testing.assert_array_equal(got, pallas)
    assert not got[max(1, n_ranges // 2):].any()


def test_bitmap_sectors_counts_sectors_holding_provenance():
    """The bitmap's bound reads the 32-byte sectors (8 int32 buckets) that
    hold a provenance row, the tail's partial sector included."""
    from repro_torch.kernels.measure import bitmap_sectors

    prov = torch.zeros(8 * 5 + 3, dtype=torch.bool)
    assert bitmap_sectors(prov) == 0
    prov[[0, 7, 9, 30, 31]] = True  # sectors 0, 1 and 3
    assert bitmap_sectors(prov) == 3
    prov[41] = True  # the partial tail
    assert bitmap_sectors(prov) == 4


def test_cpu_compaction_launches_nothing():
    before = dict(LAUNCH_COUNTS)
    keep, rows = ops.sketch_filter_rows(torch.tensor([0, 1, 1, 0], dtype=torch.int32),
                                        torch.tensor([False, True]))
    assert keep.tolist() == [False, True, True, False] and rows.tolist() == [1, 2]
    assert dict(LAUNCH_COUNTS) == before


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return int(eval(m.group(1), {}, {"kThreads": 256}))  # noqa: S307 (the source's own literals)


def test_filter_and_bitmap_constants_match_source():
    """The wrappers size workspaces and check ranges with the sources'
    constants."""
    from repro_torch.kernels import fragment_bitmap as kfb
    from repro_torch.kernels import sketch_filter as ksf

    src = (build.CSRC / "sketch_filter.cu").read_text()
    assert _constant(src, "kThreads") * _constant(src, "kRowsPerThread") == ksf.TILE_ROWS
    assert _constant(src, "kHeadWords") == ksf.HEAD_WORDS
    assert _constant(src, "kMaxRanges") == ksf.MAX_RANGES
    src = (build.CSRC / "fragment_bitmap.cu").read_text()
    assert _constant(src, "kMaxRanges") == kfb.MAX_RANGES
    assert _constant(src, "kMaxRanges") // 32 + 1 == kfb.WORKSPACE_WORDS
    assert set(build.SIGNATURES["sketch_filter"]) == {"filter_launch", "filter_rows_launch"}
    for name in ("sketch_filter", "fragment_bitmap"):
        text = (build.CSRC / f"{name}.cu").read_text()
        exported = set(re.findall(r'extern "C" int (\w+)\(', text))
        assert exported == set(build.SIGNATURES[name]), name


CARD_SIZES = [1, 15, 4097, (1 << 20) + 3, 1 << 23]


def _filter_cases(cuda, n: int, n_ranges: int, seed: int):
    """(label, bucket, bits): none kept, about 5% kept, all kept (buckets in
    range), and buckets outside [0, n_ranges) with half the ranges set."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    bucket = torch.randint(0, n_ranges, (n,), generator=gen, device=cuda, dtype=torch.int32)
    wild = torch.randint(-3, n_ranges + 3, (n,), generator=gen, device=cuda, dtype=torch.int32)
    some = torch.rand(n_ranges, generator=gen, device=cuda) < 0.05
    some[0] = True
    half = torch.rand(n_ranges, generator=gen, device=cuda) < 0.5
    return [("none", bucket, torch.zeros(n_ranges, dtype=torch.bool, device=cuda)),
            ("5%", bucket, some), ("all", bucket, torch.ones(n_ranges, dtype=torch.bool,
                                                             device=cuda)),
            ("out of range", wild, half)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_SIZES)
@pytest.mark.parametrize("n_ranges", [1, 100, 4096, 1 << 17])
def test_sketch_filter_kernels_match_plain(cuda, n, n_ranges):
    """Mask and kept rows equal the plain versions bit for bit, and a rerun
    gives the same bits."""
    for label, bucket, bits in _filter_cases(cuda, n, n_ranges, n + n_ranges):
        keep, rows = ops.sketch_filter_rows(bucket, bits)
        want, want_rows = ref.sketch_filter_rows_ref(bucket, bits)
        assert torch.equal(keep, want), label
        assert torch.equal(rows, want_rows), label
        assert torch.equal(ops.sketch_filter(bucket, bits), want), label
        again = ops.sketch_filter_rows(bucket, bits)
        assert torch.equal(again[0], keep) and torch.equal(again[1], rows), label


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_SIZES)
@pytest.mark.parametrize("n_ranges", [1, 100, 4096, 32768])
def test_fragment_bitmap_kernel_matches_plain(cuda, n, n_ranges):
    """No provenance, about 5%, all rows, and buckets out of range: the bits
    equal the plain version's, and a rerun gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n * 3 + n_ranges)
    bucket = torch.randint(0, n_ranges, (n,), generator=gen, device=cuda, dtype=torch.int32)
    wild = torch.randint(-3, n_ranges + 3, (n,), generator=gen, device=cuda, dtype=torch.int32)
    for label, b, prov in (
            ("none", bucket, torch.zeros(n, dtype=torch.bool, device=cuda)),
            ("5%", bucket, torch.rand(n, generator=gen, device=cuda) < 0.05),
            ("all", bucket, torch.ones(n, dtype=torch.bool, device=cuda)),
            ("out of range", wild, torch.rand(n, generator=gen, device=cuda) < 0.5)):
        got = ops.fragment_bitmap(prov, b, n_ranges)
        assert torch.equal(got, ref.fragment_bitmap_ref(prov, b, n_ranges)), label
        assert torch.equal(ops.fragment_bitmap(prov, b, n_ranges), got), label


@pytest.mark.cuda
def test_filter_and_bitmap_take_views_at_a_4_byte_offset(cuda):
    """A view that does not start on a 16-byte boundary is copied once
    (counted) and gives the plain version's result."""
    from repro_torch.kernels import fragment_bitmap as kfb
    from repro_torch.kernels import sketch_filter as ksf

    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 100_003
    base = torch.randint(-1, 101, (n + 4,), generator=gen, device=cuda, dtype=torch.int32)
    bits = torch.rand(100, generator=gen, device=cuda) < 0.3
    provs = torch.rand(n + 4, generator=gen, device=cuda) < 0.2
    for off in (1, 2, 3):
        bucket, prov = base[off:off + n], provs[off:off + n]
        assert bucket.data_ptr() % 16 == 4 * off
        copies = LAUNCH_COUNTS[ksf.COPY_COUNTER]
        keep, rows = ops.sketch_filter_rows(bucket, bits)
        want, want_rows = ref.sketch_filter_rows_ref(bucket, bits)
        assert torch.equal(keep, want) and torch.equal(rows, want_rows)
        assert LAUNCH_COUNTS[ksf.COPY_COUNTER] == copies + 1
        copies = LAUNCH_COUNTS[kfb.COPY_COUNTER]
        assert torch.equal(ops.fragment_bitmap(prov, bucket, 100),
                           ref.fragment_bitmap_ref(prov, bucket, 100))
        assert LAUNCH_COUNTS[kfb.COPY_COUNTER] == copies + 1


@pytest.mark.cuda
def test_back_to_back_calls_see_no_stale_workspace(cuda):
    """Calls on one stream with no wait between them, of other sizes and
    inputs: each result equals its plain version (a workspace not reset,
    or reset late, would carry tickets, status words or bits over)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    inputs = []
    for n, n_ranges in ((1 << 22, 100), (5000, 7), (1 << 20, 4096), (1 << 22, 100), (1, 1),
                        (3 << 20, 32768)):
        bucket = torch.randint(-1, n_ranges + 1, (n,), generator=gen, device=cuda,
                               dtype=torch.int32)
        bits = torch.rand(n_ranges, generator=gen, device=cuda) < 0.3
        prov = torch.rand(n, generator=gen, device=cuda) < 0.1
        inputs.append((bucket, bits, prov, n_ranges))
    out = [(ops.sketch_filter_rows(b, bits), ops.fragment_bitmap(prov, b, r))
           for b, bits, prov, r in inputs]
    torch.cuda.synchronize()
    for ((keep, rows), got), (b, bits, prov, r) in zip(out, inputs):
        want, want_rows = ref.sketch_filter_rows_ref(b, bits)
        assert torch.equal(keep, want) and torch.equal(rows, want_rows)
        assert torch.equal(got, ref.fragment_bitmap_ref(prov, b, r))


@pytest.mark.cuda
def test_each_call_is_one_kernel_launch(cuda):
    """``fragment_bitmap`` is one launch a call (no memset, no compare);
    ``sketch_filter_rows`` one launch and the 8-byte copy of its count."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import sketch_filter as ksf

    gen = torch.Generator(device=cuda).manual_seed(8)
    n = 1 << 20
    bucket = torch.randint(0, 100, (n,), generator=gen, device=cuda, dtype=torch.int32)
    prov = torch.rand(n, generator=gen, device=cuda) < 0.25
    bits = torch.rand(100, generator=gen, device=cuda) < 0.4
    ops.fragment_bitmap(prov, bucket, 100)  # workspaces made outside the profile
    ops.sketch_filter_rows(bucket, bits)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.fragment_bitmap(prov, bucket, 100)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "bitmap_kernel" in names[0], names
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.sketch_filter_rows(bucket, bits)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [x for x in names if not x.startswith("Memcpy")]
    assert len(kernels) == 1 and "filter_rows_kernel" in kernels[0], names
    assert LAUNCH_COUNTS["fragment_bitmap"] == counts.get("fragment_bitmap", 0) + 1
    assert LAUNCH_COUNTS["sketch_filter"] == counts.get("sketch_filter", 0) + 1
    assert LAUNCH_COUNTS[ksf.ROWS_COUNTER] == counts.get(ksf.ROWS_COUNTER, 0) + 1


def test_batch_bitmap_constants_match_source():
    """The batched bitmap's wrapper plans its grid with the source's
    cluster, tile and chunk sizes, and binds every function it exports."""
    from repro_torch.kernels import fragment_bitmap as kfb

    src = (build.CSRC / "fragment_bitmap_batch.cu").read_text()
    assert _constant(src, "kMasksPerChunk") == kfb.MASKS_PER_CHUNK
    assert _constant(src, "kMaxRanges") == kfb.MAX_RANGES
    assert _constant(src, "kCluster") == kfb.BATCH_CLUSTER
    assert _constant(src, "kThreads") * _constant(src, "kRowsPerThread") == kfb.BATCH_TILE_ROWS
    exported = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert exported == set(build.SIGNATURES["fragment_bitmap_batch"])
    assert "unpack_kernel" not in src and "cudaMemset" not in src  # one launch a call


@pytest.mark.parametrize("n", [1, 4096, 4097, 1 << 20, 1 << 23])
@pytest.mark.parametrize("chunks,clusters", [(1, 124), (2, 124), (3, 16), (1, 1)])
def test_batch_bitmap_grid(n, chunks, clusters):
    """Whole clusters, at least one, sharing the resident clusters among the
    chunks of 32 masks, no more than one tile of 4,096 rows a block."""
    from repro_torch.kernels import fragment_bitmap as kfb

    blocks = kfb.batch_blocks(n, chunks, clusters)
    assert blocks % 8 == 0 and blocks >= 8
    assert blocks == 8 or blocks // 8 * chunks <= clusters
    assert blocks == 8 or (blocks - 8) * 4096 < n


def test_batch_bitmap_workspace_grows():
    """The word table and count live in one workspace per device and stream,
    replaced by one of at least twice the words when a call needs more."""
    from repro_torch.kernels import fragment_bitmap as kfb

    dev = torch.device("meta")
    try:
        first = kfb._batch_workspace(dev, -1, 100)
        assert first.table.numel() == 101 and first.table.dtype == torch.int32
        assert first.done == first.ptr + 4 * 100  # the count after the words
        assert kfb._batch_workspace(dev, -1, 64) is first
        assert kfb._batch_workspace(dev, -1, 101).table.numel() == 201
    finally:
        kfb._BATCH_WORKSPACES.pop((dev.index, -1), None)


def test_bitmap_probe_patches_apply():
    """``kernels/bitmap_probe.py`` patches the batched source by text: every
    patch still finds its anchor and each variant differs from the kernel."""
    from repro_torch.kernels import bitmap_probe

    sources = bitmap_probe.all_patches()
    kernel = sources.pop("kernel")
    assert kernel == bitmap_probe.SOURCE.read_text()
    assert sources and all(text != kernel for text in sources.values())
    assert bitmap_probe.TIMING_ONLY <= set(sources)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 33, 64])
@pytest.mark.parametrize("n", [1, 15, 4100, (1 << 20) + 12, 1 << 22])
def test_fragment_bitmap_batch_kernel_cases(cuda, b, n):
    """n not a multiple of 16 (and of 4), all-zero masks and masks of one
    row, buckets out of range: the plain version's bits, each row equal to
    fragment_bitmap's, one launch counted a call."""
    gen = torch.Generator(device=cuda).manual_seed(b * 7 + n)
    for n_ranges in (1, 100, 32768):
        bucket = torch.randint(-2, n_ranges + 2, (n,), generator=gen, device=cuda,
                               dtype=torch.int32)
        provs = torch.rand((b, n), generator=gen, device=cuda) < 0.05
        provs[0] = False  # all zero
        if b > 1:
            provs[1] = False
            provs[1, n // 2] = True  # one row
        before = LAUNCH_COUNTS["fragment_bitmap_batch"]
        got = ops.fragment_bitmap_batch(provs, bucket, n_ranges)
        assert LAUNCH_COUNTS["fragment_bitmap_batch"] == before + 1
        assert torch.equal(got, ref.fragment_bitmap_batch_ref(provs, bucket, n_ranges)), n_ranges
        for i in {0, 1 % b, b - 1}:
            assert torch.equal(got[i], ops.fragment_bitmap(provs[i], bucket, n_ranges)), i


@pytest.mark.cuda
def test_fragment_bitmap_batch_views_and_stale_workspace(cuda):
    """Views at every 4-byte offset (buckets copied once, counted, where the
    16-byte loads need it; masks off a 4-byte boundary loaded row by row), and calls
    of other B, n and ranges back to back on one stream: each equals the
    plain version."""
    from repro_torch.kernels import fragment_bitmap as kfb

    gen = torch.Generator(device=cuda).manual_seed(21)
    n = 100_004
    base = torch.randint(-1, 101, (n + 4,), generator=gen, device=cuda, dtype=torch.int32)
    flat = torch.rand(9 * n + 4, generator=gen, device=cuda) < 0.1
    for b_off, p_off in ((0, 0), (1, 0), (2, 0), (3, 0), (0, 1), (2, 3)):
        bucket, provs = base[b_off:b_off + n], flat[p_off:p_off + 9 * n].view(9, n)
        assert bucket.data_ptr() % 16 == 4 * b_off and provs.data_ptr() % 4 == p_off
        copies = LAUNCH_COUNTS[kfb.BATCH_COPY_COUNTER]
        got = ops.fragment_bitmap_batch(provs, bucket, 100)
        assert torch.equal(got, ref.fragment_bitmap_batch_ref(provs, bucket, 100)), b_off
        copied = p_off == 0 and b_off != 0  # only the 16-byte loads need the copy
        assert LAUNCH_COUNTS[kfb.BATCH_COPY_COUNTER] == copies + copied, (b_off, p_off)
    calls = []
    for b, n, r in ((8, 1 << 22, 100), (40, 5000, 7), (1, 1, 1), (64, 1 << 20, 32768),
                    (8, 1 << 22, 100), (3, 4097, 4096)):
        bucket = torch.randint(-1, r + 1, (n,), generator=gen, device=cuda, dtype=torch.int32)
        provs = torch.rand((b, n), generator=gen, device=cuda) < 0.2
        calls.append((provs, bucket, r))
    out = [ops.fragment_bitmap_batch(*c) for c in calls]
    torch.cuda.synchronize()
    for got, c in zip(out, calls):
        assert torch.equal(got, ref.fragment_bitmap_batch_ref(*c))


@pytest.mark.cuda
def test_fragment_bitmap_batch_is_one_kernel_a_call(cuda):
    """No memset, no unpack: one kernel on the profiler's trace a call."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(22)
    n = 1 << 20
    bucket = torch.randint(0, 100, (n,), generator=gen, device=cuda, dtype=torch.int32)
    for b in (8, 33):
        provs = torch.rand((b, n), generator=gen, device=cuda) < 0.25
        ops.fragment_bitmap_batch(provs, bucket, 100)  # the workspace made outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ops.fragment_bitmap_batch(provs, bucket, 100)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and "bitmap_batch_kernel" in names[0], names


def test_filter_probe_patches_apply():
    """``kernels/filter_probe.py`` patches the two sources by text: every
    patch still finds its anchor and each variant differs from the kernel."""
    from repro_torch.kernels import filter_probe

    for sources, name in ((filter_probe.all_patches(), "sketch_filter"),
                          (filter_probe.all_bitmap_patches(), "fragment_bitmap")):
        kernel = sources.pop("kernel")
        assert kernel == (build.CSRC / f"{name}.cu").read_text()
        assert sources and all(text != kernel for text in sources.values())


@pytest.mark.parametrize("empty_traces,want", [(0, 1), (1, 1), (2, 1), (3, 0)])
def test_device_timing_takes_an_empty_trace_again(monkeypatch, empty_traces, want):
    """``measure.device_ms`` and ``device_events`` trace again when the
    profiler records no device event at all, up to three traces, and report
    nothing when every trace is empty (a fake profiler stands in for the
    card's)."""
    from types import SimpleNamespace

    import torch.profiler

    from repro_torch.kernels import measure

    cuda_type = object()
    traces = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            traces.append(None)

        def events(self):
            if len(traces) <= empty_traces:
                return [SimpleNamespace(device_type="cpu", name="aten::empty")]
            span = SimpleNamespace(start=0.0, end=2000.0 * calls)
            return [SimpleNamespace(device_type=cuda_type, name="void bitmap_kernel<8>(...)",
                                    time_range=span),
                    SimpleNamespace(device_type="cpu", name="aten::empty")]

    fake_torch = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None),
                                 autograd=SimpleNamespace(DeviceType=SimpleNamespace(CUDA=cuda_type)))
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    called = []
    calls = 4
    per = measure.device_ms(fake_torch, lambda: called.append(1), calls=calls)
    assert per == ({"bitmap_kernel": 2.0} if want else {})
    assert len(traces) == min(empty_traces + 1, 3)
    assert len(called) == 3 + calls * len(traces)
    traces.clear()
    calls = 1
    assert measure.device_events(fake_torch, lambda: None) == want
