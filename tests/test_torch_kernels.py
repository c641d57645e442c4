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
    BARRIER_BYTES, CLUSTER_MAX, PRIV_ROWS, PRIV_THREADS, PRIVATE_GROUPS, RING_BYTES, SLICE_MAX,
    COUNT_BYTES, SMEM_MAX, STAGES, TILE_ROWS, plan, sliced_smem)
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
    assert const["kPrivThreads"] * const["kSteps"] == PRIV_ROWS
    assert (const["kTileRows"], const["kStages"], const["kSliceMax"], const["kClusterMax"],
            const["kBarrierBytes"]) == (TILE_ROWS, STAGES, SLICE_MAX, CLUSTER_MAX, BARRIER_BYTES)
    assert "constexpr int kStageWords = kTileRows + 4;" in src
    assert (const["kFilters"], const["kAdders"]) == (ksa.FILTERS, ksa.ADDERS)
    assert COUNT_BYTES == STAGES * ksa.FILTERS * 4
    assert RING_BYTES == STAGES * 3 * (TILE_ROWS + 4) * 4
    assert 8 * 8 * PRIVATE_GROUPS == 64 * 1024  # 8 warps' copies of 2 * G floats
    for bytes_ in (RING_BYTES, sliced_smem(2048), sliced_smem(4096)):
        assert f"{bytes_:,}" in src, bytes_
    assert ksa.WINDOW_GROUPS == CLUSTER_MAX * SLICE_MAX
    assert f"kClusterMax * kSliceMax = {ksa.WINDOW_GROUPS:,} groups" in src


@pytest.mark.parametrize("n,g,sms", [(1 << 23, 16, 132), (1 << 23, 1024, 132),
                                     (1 << 23, 2048, 132), (1 << 23, 16384, 132),
                                     (100, 4, 132), (1 << 20, 1 << 16, 132)])
def test_segment_aggregate_grid(n, g, sms):
    """The launch shape: per-warp partials in blocks that fill the card while
    few groups; above, clusters whose windows of slices cover the groups,
    one per chunk of whole tiles and window, every chunk holding rows, no
    more clusters than the card holds at once."""
    p = plan(n, g, sms)
    if g <= PRIVATE_GROUPS:
        assert p.cluster == 0 and p.windows == 1 and p.smem == 8 * 8 * g
        assert 1 <= p.parts <= max(1, -(-n // PRIV_ROWS))
        assert p.parts * PRIV_THREADS <= 2048 * sms  # resident at once
        assert p.parts // sms * p.smem <= 228 * 1024
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
    sums, counts, scratch = ksa._buffers(torch.device("meta"), (b, g), p)
    assert sums.shape == counts.shape == (b, g)
    assert scratch.numel() == b * p.parts * 2 * g
    if g > PRIVATE_GROUPS:
        assert 4 * scratch.numel() * 4 <= b * n * 12
    src = (Path(build.__file__).parent / "csrc" / "segment_aggregate.cu").read_text()
    assert "blockIdx.y" in src and "gridDim.y" not in src  # no row sees the batch size


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
    the instrumented copy marks every section of every role."""
    from repro_torch.kernels import segagg_probe

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
