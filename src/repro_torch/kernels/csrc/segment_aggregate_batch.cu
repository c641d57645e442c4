// Batched segmented sum and count on Hopper (sm_90a).
//
// Replaces repro/kernels/segment_aggregate.py::segment_aggregate_batch_pallas
// (Pallas body _segagg_batch_kernel): B independent segment problems over
// (B, n) values, gids and weights,
//   sums[b, g]   = sum over i with gid[b, i] == g of values[b, i] * weights[b, i]
//   counts[b, g] = sum over i with gid[b, i] == g of weights[b, i]
// as f32[B, n_groups].  Rows with gid outside [0, n_groups) or weight 0 add
// nothing.  Its caller is the sharded engine's fused launch: B is the
// pow2-padded number of sketches in a hit batch and n = S_pad * R_pad, each
// sketch's shard slices flattened into one row axis.
//
// Bound on an H100: memory bandwidth, as for the unbatched kernel.  Every
// row's gid and weight are read (8 bytes), the value of every weighted row
// (4 bytes), and 8 bytes are written for each of the B * n_groups outputs;
// at B = 8, n = 2^20 that is at most ~100 MB, ~30 us at 3.35 TB/s.
//
// Design: the TPU kernel contracts a (rows x groups) one-hot tile with the
// values on the MXU, B times.  Here the fixed-order kernels of
// segment_aggregate.cu run with the batch row as the grid's y axis: each
// row's blocks (per-warp copies up to 1,024 groups) or clusters (group
// slices, rows streamed by multicast bulk copies, above) sum its rows into
// partials, and the merge adds each row's partials in part order.  The
// plan gives every row the chunks of an unbatched launch over it, whatever
// B is, so each row equals that launch bit for bit; no float atomics, so
// reruns give equal bits on any input.

#include "segment_aggregate.cu"

// batch rows of n rows each, row b at values + b * n (likewise gid and
// weights); sums and counts are (batch, n_groups); scratch and tickets as
// segagg_run sizes them.  The plan's arguments as in segagg_launch.
extern "C" int segagg_batch_launch(int device, void* stream, const float* values,
                                   const int32_t* gid, const float* weights, long long n,
                                   int batch, int n_groups, float* sums, float* counts,
                                   float* scratch, unsigned* tickets, int parts,
                                   long long part_rows, int cluster, long long smem) {
  return segagg_run(device, stream, values, gid, weights, n, batch, n_groups, sums, counts,
                    scratch, tickets, parts, part_rows, cluster, smem);
}
