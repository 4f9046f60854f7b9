// K-means passes: Lloyd statistics, the SuCo build's paired final assignment
// with the IMI occupancy histogram, and nearest-centroid assignment.
//
// Replaces the four TPU kernels of src/repro/kernels/kmeans_assign/kernel.py:
//
// * kmeans_stats_kernel (_accumulate_stats, _stats_kernel,
//   _stats_only_kernel): per codebook b and point p, the nearest centroid
//   a = argmin_j ||x[b,p] - c[b,j]||^2, then sums[b,a] += x, counts[b,a] += 1,
//   inertia[b] += min distance; optionally the assignments themselves.  (The
//   TPU kernel weights padded points 0; here the grid covers exactly n points.)
// * kmeans_pair_assign_hist_kernel (_pair_assign_hist_kernel): argmins of
//   both halves of each subspace (codebooks i and Ns+i) and the IMI
//   occupancy counts[i, a1*k + a2].  At s <= 64 (the build's shape) an FFMA
//   screen with an exact re-check (below); past that, the screened kernel's
//   argmins of all 2 Ns codebooks, then kmeans_pair_hist_kernel.
// * kmeans_assign_batched_kernel (kernel.py:93, pallas_call at :104,
//   _batched_kernel): the argmin of every point against its own codebook,
//   nothing else.
// * kmeans_assign_kernel (kernel.py:52, _kernel): the argmin of one
//   problem, (n, s) against (k, s), at any width s and any k.
//
// The last two share kmeans_assign_streamed_kernel: kernel 6 at one
// codebook, kernel 5 at its wide shapes (s > 64, or a codebook past shared
// memory), kernel 4 at its wide shapes (all 2 Ns codebooks at once).  It is
// a tensor-core screen with an exact re-check (below).  Kernel 3's wide
// variant takes its argmins, and each point's exact best distance d*, from
// it too.  Kernel 5 at s <= 64 is kmeans_assign_narrow_kernel, and kernel 4
// at s <= 64 kmeans_pair_assign_hist_kernel, screens built for narrow
// shapes (below).
//
// Every argmin here is torch.argmin's (and jnp.argmin's): the first NaN
// distance wins, else the lowest index of the minimum.  A NaN distance
// needs a coordinate that is not finite, so the narrow SIMT loop (row 3)
// checks its points and codebook once and takes the NaN-aware comparison
// (takes<true>) only there: always on, it cost row 3 up to 1.7%, and a
// min.NaN minimum 3.3% (an H100; PERF.md).  The screens re-check every
// centroid of a point they do not cover (screen_covers) under a 64-bit key
// that orders NaN first (dist_key).
//
// What bounds the SIMT kernels on an H100: operations.  Each (point,
// centroid) pair costs 3*s fp32 operations (difference, square, sum) against
// 4*s bytes of the point, about 0.75*k operations per byte: ~37 at k=50 and
// ~190 at k=256, above the card's ~20 fp32 operations per byte.  Summed as
// three separate instructions (no FMA), they issue at ~33.5 T/s (132 SMs x
// 128 lanes x 1.98 GHz), so no kernel built that way runs row 6 (1M x 128,
// k = 1,024) below ~11.7 ms.
//
// The narrow stats kernel takes one codebook per grid row (grid: points /
// block_n x codebooks); the codebook's centroids sit in shared memory, where
// every thread reads the same centroid at once (a broadcast); each thread
// takes one point (two for s <= 16), holds it in registers (at most 64
// dims) and scans the centroids in index order with a strict <, so ties go
// to the lowest index as with jnp.argmin / torch.argmin (nearest(): a
// centroid read 16 bytes at a time when s is the instantiation's width).
// These instantiations (MAXS 4..64) take s <= 64 and a codebook that fits in
// shared memory; the wide variant, any other shape, is described next.
//
// Kernel 3, the Lloyd statistics: each point's coordinates are added once.
//   Per chunk of block_n points (a partial row per centroid), sums[j, t] is
//   the chunk's points of centroid j added dim t in index order, from +0,
//   counts[j] their number (exact below 2^24), and the
//   inertia the sum of their best distances in a fixed tree (block_tree_sums
//   over each tile of 256 points, the tiles' sums added in order).
//   * Narrow (kmeans_stats_partial_kernel): points in registers, two a
//     thread for s <= 16, nearest() reading each centroid coordinate from
//     shared memory once for both points, 16 bytes at a time when s is the
//     instantiation's width (those
//     broadcast reads, not the arithmetic, bounded the one-point loop: 8
//     reads against 24 operations a pair at s = 8).  Per tile the points are
//     ranked by (centroid, index) with no atomic deciding an order -- within
//     a warp, __match_any_sync and the popc of the lower lanes; across warps,
//     each warp's byte count of each centroid and an exclusive scan over k
//     of the totals -- and stored in shared memory in that order; thread
//     (j, t) then adds centroid j's run of points to its shared-memory sum of
//     dim t (t == s: the count).  O(s) adds a point, and O(k s) loop
//     overhead and five barriers a tile of 512 (256) points, where the old
//     kernel scanned the whole tile for every (centroid, dim): k (s + 1)
//     iterations a point.
//   * Wide (kmeans_stats_wide_accumulate_kernel): the argmins and d* come
//     from the screened kernel (its re-check makes both the plain version's
//     bits); then each sub-chunk of at most kSub = 4,096 points is ranked by
//     its (centroid, index) keys with a bitonic sort in shared memory (any
//     k), and each warp walks the ranked points of its run of centroids in
//     order, lanes over dims and 8 rows in flight, a centroid's sum in
//     registers: each row of the block's partial is written once, coalesced
//     (zeros for a centroid with no point), and no device-memory sum is read
//     back unless a chunk spans several sub-chunks.  Two to eight blocks
//     share a chunk (each ranks it, each owns a run of centroids) so that
//     the card holds two blocks a multiprocessor.
//   Both variants add the same values in the same order from the same
//   start, so they give the same bits, and so does every run: the ranking
//   is a function of the assignments alone.  A second kernel sums the
//   partials over the blocks in block order.
//   What bounds it: the argmins.  The narrow variant is the SIMT distances
//   (3 k s fp32 operations a point, issued as separate instructions; the
//   ranking and adds are O(s + k s / 512) a point); the wide one the screened
//   kernel's products, then the x rows (read once more) and the partials
//   (nblk k s floats written and read once by the reduction).
//
// Every distance that decides an assignment is summed one dim at a time
// with __fsub_rn/__fmul_rn/__fadd_rn (no FMA contraction): exactly the
// arithmetic of the plain PyTorch versions, so assignments agree bit for
// bit.
//
// kmeans_assign_streamed_kernel: the screen and the re-check.
//   A block takes kBM = 128 points of one codebook and walks the centroids
//   in tiles of kBN = 64, dims in slices of kBK = 32, both staged through
//   shared memory by cp.async in two stages (zeros past s, k and n).  Each
//   operand is split a = big + small, big = cvt.rna.tf32(a), small =
//   cvt.rna.tf32(a - big), and the cross term x.c accumulates in fp32 on the
//   tensor cores (mma.sync m16n8k8 tf32): small x big, big x small, then
//   big x big (3xTF32; one TF32 product alone would widen the margin ~2^10
//   times and send most pairs to the re-check).  The screen distance is
//   a_j = (||x||^2 + ||c_j||^2) - 2 x.c_j, the norms fp32 sums (||c||^2 and
//   each codebook's largest in a prologue kernel, ||x||^2 from the staged
//   slices of the first tile).  Per point the block keeps the running screen
//   minimum m and the exact best (d*, j*) as one 64-bit key, the bits of
//   d >= 0 above j, so an atomicMin takes the lexicographic minimum whatever
//   the order of the re-checks.  After each tile, m takes the tile's minimum,
//   and every j of the tile with a_j <= m + delta_p joins the point's list
//   of kL = 8 candidates (past kL it is re-checked at once); after the last
//   tile, each listed j still within m + delta_p of the final m is
//   re-checked: d_plain(p, j) in the plain order, x and c read from device
//   memory (L2-resident).  Deferring drops the candidates that a later
//   tile's minimum rules out.
//   Fragments are read 16 bytes at a time: in each 16 dims a thread takes
//   dims 4tq, 4tq+1 as its k = tq, tq+4 of the first k-step and 4tq+2, 4tq+3
//   of the second, the same permutation of k for both operands.
//
//   Why it is exact.  Let j* be the plain argmin (lowest index on ties) and
//   |a_j - d_plain(j)| <= E <= delta_p / 8 for every j.  For every i seen so
//   far, a_j* <= d_plain(j*) + E <= d_plain(i) + E <= a_i + 2E, so a_j* <= m
//   + delta_p / 4 whenever m includes j*'s tile: j* joins the list (or is
//   re-checked at once) when its tile is screened, and is still within the
//   margin of the final m, so it is re-checked; the lexicographic minimum
//   over a set that holds j* is j*.  A centroid that ties d* exactly is
//   within the margin too.  (fl(m + delta_p) loses at most u |m + delta_p|,
//   far below the 3/4 of delta_p to spare.)  The bound needs finite inputs
//   whose plain distances do not overflow and whose products are not
//   subnormal: screen_covers() asks 2^-100 <= N_p <= FLT_MAX / 4 in fp32;
//   any other point (NaN or inf among its or its codebook's coordinates
//   included) re-checks every centroid.
//
//   The margin, with u = 2^-24 and N_p = ||x_p||^2 + max_j ||c_j||^2,
//   first order in u, for any fp32 summation order with round-to-nearest:
//   * the plain sum: each term (x-c)^2 within 3u, s - 1 additions of
//     non-negative terms: |d_plain - D| <= (s + 2) u D, D <= 2 N_p;
//   * the norms: s squares, s - 1 additions: s u ||x||^2 + s u ||c||^2;
//   * the split: |a - big| <= 2^-11 |a|, |small| <= 2^-11 |a|, the residual
//     <= 2^-22 |a|, so the three products miss x c by <= 3 * 2^-22 |x c| =
//     12 u |x c| a dim, and sum |x_i c_i| <= N_p / 2: 6 u N_p, doubled in
//     2 x.c;
//   * the accumulation: 3s exact TF32 products (11 x 11 bits) into one fp32
//     sum, sum |terms| <= 1.001 N_p / 2: 1.5 s u N_p, doubled;
//   * the last two roundings (nx + nc, then - 2 x.c): 3 u N_p.
//   Together 6.003 s + 19.04 times u N_p; screen_margin() in
//   kernels/kmeans_assign/kernel.py states it as E_s = (7 s + 20) u N_p (the
//   second-order terms and some slack) and passes mu_s = 8 E_s / N_p: the
//   re-check needs the error within delta_p / 2, so the tensor cores'
//   accumulation, whose rounding is not specified as IEEE, may be 4x worse
//   than the bound.  tests/test_torch_kmeans.py emulates this arithmetic in
//   fp64 and holds it to delta_p / 8; chip_smoke.py measures the card's
//   largest |a - d_plain| / delta_p at the IVF shapes.
//
//   What bounds it: the tensor-core products (3 * 2 n k s over 495 T/s:
//   ~1.6 ms at 1M x 1,024 x 128), then the re-checks (~3 s operations each,
//   few per point on clustered data).  mma.sync issues the products
//   well below that rate; wgmma, TMA and persistent blocks are the next
//   step.  Data whose common offset dwarfs its spread
//   (||x||^2 >> the distances) widens delta_p past every gap: the kernel
//   then re-checks every pair, right and slow.  Nothing gives way to another
//   kernel.  rechecks (null on the path) counts each block's re-checked
//   pairs; the SCREEN instantiation writes every a to device memory.
//
//   best (row 3's wide variant; null elsewhere) takes each point's d*, the
//   high half of its final key: the distance of a plain re-check, so the
//   plain version's minimum distance bit for bit.
//
// kmeans_assign_narrow_kernel: kernel 5 at s <= 64 (PQ8x8's final
//   assignment: B = 8, n = 1M, s = 16, k = 256).
//   What bounds it: 3 * 2 B n k s TF32 products (206 GFLOP at the PQ shape,
//   0.42 ms at 495 T/s), above the bytes (B n s * 4 read, B n * 4 written:
//   0.16 ms).  The SIMT kernel it replaced (nearest(), 3 * B n k s
//   instructions: ~3.1 ms at the SMs' issue rate) could not approach it; the
//   wide screen above, forced onto s = 16, pads every product to 32 dims,
//   restages the centroids every 64 and trades tile minima through shared
//   memory between barriers (5.7 ms against nearest()'s 4.0).
//   Design: the block copies its codebook into shared memory once, split
//   into TF32 big and small halves in fragment order (one 16-byte read per
//   lane, k-step and 8-centroid tile, conflict-free), dims zero-padded to
//   8 KS (one k-step at s <= 8, two at s <= 16, ...), and -||c_j||^2 / 2
//   per centroid (-FLT_MAX past k, in an even number of tiles).  A warp
//   holds the split A fragments of MT * 16 points in registers for the whole
//   codebook (its next points prefetched into L1 meanwhile) and walks its
//   tiles with 3 KS MT mma.sync m16n8k8 (small x big, big x small, big x
//   big), the accumulator starting at -||c_j||^2 / 2, so it ends at t_j =
//   x.c_j - ||c_j||^2 / 2: ||x||^2 - 2 t_j is the distance and the largest t
//   the nearest centroid, with no norm added per pair.  Each lane keeps, per
//   point row, the largest t of its columns (m1, j1) and the second largest
//   (ev): five instructions a pair, no barrier, no shared memory; tiles go
//   in pairs with no branch between one tile's products and the previous
//   one's bookkeeping, which the compiler then schedules into the tensor
//   cores' stalls.  mma.sync issues TF32 at about half the wgmma rate
//   (~9 clocks an m16n8k8 a sub-partition: with the bookkeeping cut to a
//   running max the PQ shape takes ~1.0 ms), so this design cannot reach the
//   bound; the bookkeeping adds ~0.4 ms on top.  After the
//   last tile: T = the quad's largest m1, lim = T - delta_p / 2; the lanes
//   with m1 >= lim hold the candidates, and they are all the candidates
//   unless a lane's ev >= lim too.  One candidate is the argmin (no
//   re-check); several are re-checked in the plain arithmetic (plain_dist),
//   the least key of the quad winning; a point with a candidate its lane
//   did not keep, or one the screen does not cover, has every centroid
//   re-checked by the whole warp (lanes over centroids, the least key).
//   On clustered data nearly every point has one candidate (PQ8x8 on
//   SIFT1M-shaped data: ~0.09% of the points scan all 256 centroids, 0.22
//   re-checked pairs a point).
//   The exactness argument is the one above with a = ||x||^2 - 2 t
//   (||x||^2 exact; it cancels from every comparison).  Its error, first
//   order in u N_p: the plain sum 2 (s + 2); ||c||^2 in fp32 s (halved in
//   t, doubled in a); the split 12; the accumulation of 3s exact products
//   after the -||c||^2 / 2 start, sum |terms| <= 1.001 N_p: 3s, doubled,
//   6.006 s; together 9.006 s + 16.  narrow_margin() in kernel.py states
//   E_s = (10 s + 20) u N_p and passes mu_s = 8 E_s / N_p, as
//   screen_margin() does.  lim's rounding (u |T| <= u N_p in t) and N_p's
//   own fp32 error ((s + 1) u relative) take a sliver of the 3/4 of delta_p
//   to spare.  tests/test_torch_kmeans.py emulates this arithmetic in fp64
//   and holds it to delta_p / 8.
//
// kmeans_pair_assign_hist_kernel: kernel 4 at s <= 64 with both codebooks
//   and the k^2 histogram in shared memory (the SuCo build's final
//   assignment: Ns = 8, n = 1M, s = 8, k = 50).
//   What bounds it: the SMs' issue rate.  The plain arithmetic is 3 s
//   instructions a (point, centroid) pair (no contraction): with the
//   compare, the loop and the centroid's shared-memory reads ~31 at s = 8,
//   ~0.74 ms for the build's 800 M pairs at 33.5 T instructions/s, against
//   0.153 ms to read x once.  The screen issues under half of that (13.7
//   instructions a pair in its SASS loop at s = 8, against the SIMT loop's
//   30.3; tools/time_assign.py, PERF.md).
//   Design: the block copies both codebooks into shared memory, rows padded
//   with zeros to the instantiation's MAXS (4..64), and -||c_j||^2 / 2 per
//   centroid (fp32, dim order).  A thread holds PTS points in registers (8
//   at MAXS <= 8, 4 at 16, 2 at 32, 1 at 64: up to 64 coordinates, so one
//   broadcast 16-byte read of a centroid serves them all; two 256-thread
//   blocks an SM) and walks each codebook in index order, four centroids an
//   iteration: t_j = x.c_j - ||c_j||^2 / 2 as a chain of MAXS fused
//   multiply-adds started at -||c_j||^2 / 2 (the padded dims add exact
//   zeros), then per point the largest t (m1, its first index j1) and the
//   runner-up m2 (five instructions a pair: a compare, a select, three
//   min / max).  ||x||^2 - 2 t_j is the screen distance, the largest t the
//   nearest centroid.  With N_p = ||x||^2 + max_j ||c_j||^2 (fp32; each
//   codebook's largest in the prologue, NaN taken as +inf) and lim = m1 -
//   mu N_p / 2: m2 < lim settles the point at j1; a runner-up at or above
//   lim (ties, equidistant centroids, data whose offset dwarfs its spread),
//   or a point the screen does not cover (screen_covers: a coordinate of the
//   point or its codebook not finite, or N_p out of range), joins the tile's
//   queue in shared memory.  After the tile's screen (a barrier), each warp
//   takes queued (point, half)s in turn and scans every centroid in the
//   plain arithmetic, lanes over centroids j = lane, lane + 32, ..., the
//   least dist_key of the warp winning: nearest_pts<..., NANS>'s answer
//   (index order, strict <, lowest index on ties, the first NaN first), so
//   the warp's lanes never wait on one lane's scan of a whole codebook.
//   Then (a barrier) each point's two centroids go to assign and its cell
//   a1 k + a2 into the block's shared histogram.  A tile is PTS x 256
//   points; the grid is one wave (the card's resident blocks shared among
//   the Ns subspaces), each block a run of whole tiles whatever block_n,
//   so each block adds its histogram into counts once, at its end.
//   Why it is exact: with a = ||x||^2 - 2 t (||x||^2 cancels from every
//   comparison, so it is taken exact), let |a_j - d_plain(j)| <= E <=
//   delta_p / 2 for every j and j* be the plain argmin.  Then a_j* <=
//   d_plain(j*) + E <= d_plain(j1) + E <= a_j1 + 2 E, so t_j* >= m1 - E >=
//   lim: if j* is not j1, the runner-up m2 >= t_j* >= lim and the point is
//   re-checked; a point the screen settles has j1 = j*.
//   The margin, first order in u N_p, any summation order: the plain sum 2
//   (s + 2) (as above); ||c||^2 in fp32 s u ||c||^2, halved in t and doubled
//   in a: s; the chain: s roundings of a partial sum |r| <= ||c||^2 / 2 +
//   sum |x_i c_i| <= ||c||^2 + ||x||^2 / 2 <= N_p, each u |r|, doubled in a:
//   2 s; together 5 s + 4.  narrow_margin() (E_s = (10 s + 20) u N_p, mu_s =
//   8 E_s: delta_p = 8 E_s N_p) covers it with E <= delta_p / 16, twice the
//   delta_p / 8 the screens above are held to; the second-order terms (s^2
//   u^2) and lim's rounding (u |lim| <= u N_p in t) take a sliver of the
//   rest.  No flush to zero (the library is built without -ftz), and the
//   FFMA rounds once, as IEEE fused, so the bound holds on the card as
//   derived.
//   tests/test_torch_kmeans.py emulates this arithmetic in fp64 and holds it
//   to delta_p / 8; the PROBE instantiation writes every t and each block's
//   re-checked (point, half)s, and chip_smoke.py measures the card's
//   largest |a - d_plain| / delta_p at the build's shape.
//
// kmeans_pair_hist_kernel: kernel 4's histogram past the narrow kernel (s >
//   64, or its block past shared memory): the screened kernel gives the
//   argmins of all 2 Ns codebooks in one launch (B = 2 Ns; its re-check
//   makes them the plain version's), then each thread adds cells a1 k + a2
//   of its points straight into counts with device-memory atomics.  A
//   shared histogram flushed once a block was no faster where k^2 fits: at
//   two blocks an SM a block sees about as many points as it would flush
//   cells.
//
// No float atomics, so every result is the same from run to run.  The stats
// kernels write per-block partial sums, counts and inertia in a fixed
// order (above), and a second kernel reduces the partials over the blocks
// in block order.  The pair kernels' histograms use integer atomics (the
// narrow one's in shared memory, then in device memory), which are exact; the screened
// kernel's key atomics take a minimum, which does not depend on their order.
//
// C entry points (each returns cudaGetLastError()):
//   kmeans_stats(..., wide, mu, norms, best, stream),
//   kmeans_pair_assign_hist(..., wide, mu, norms, rechecks, screen, stream),
//   kmeans_assign_batched(..., wide, mu, norms, rechecks, screen, best, stream),
//   kmeans_assign(..., mu, norms, assign, stream); kmeans_stats_smem_bytes,
//   kmeans_pair_smem_bytes and kmeans_assign_narrow_smem_bytes state the
//   narrow blocks' shared memory.

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;

template <int MAXS>
__device__ __forceinline__ void load_point(const float* __restrict__ row, int s, float (&xv)[MAXS]) {
#pragma unroll
    for (int t = 0; t < MAXS; ++t) xv[t] = t < s ? row[t] : 0.f;
}

constexpr int kWarps = kThreads / 32;

// Points a thread of the narrow stats kernel takes per tile: two where they
// fit in registers (s <= 16), so that each centroid coordinate read from
// shared memory serves both -- those reads, not the arithmetic, bound the
// SIMT distances at small s.
__host__ __device__ constexpr int stats_pts(int maxs) { return maxs <= 16 ? 2 : 1; }

// Shared memory of the narrow stats kernel: centroids (k*s), accumulators
// (k*(s+1): each centroid's sums, then its count), the tile's points ranked
// by centroid (pts*kThreads*s coordinates), the warps' inertia sums
// (pts*kWarps), the tile's per-centroid offsets (k+1 ints), the scan's warp
// totals (kWarps ints) and each warp's count of each centroid for each of a
// thread's points (pts*kWarps*k bytes: at most 32 each).
// The op wrapper reads it through kmeans_stats_smem_bytes.
__host__ __device__ inline size_t stats_smem_bytes(int k, int s) {
    const size_t pts = stats_pts(s);
    return sizeof(float) * ((size_t)k * s + (size_t)k * (s + 1) + pts * kThreads * s +
                            pts * kWarps) +
           sizeof(int) * ((size_t)k + 1 + kWarps) + pts * kWarps * k;
}

// The sums over the block of PTS values a thread, each in a fixed order: a
// butterfly in each warp (every lane ends with the same bits, as a + b ==
// b + a), then the warps' sums in a fixed tree.  Every thread gets the same
// bits, in v.  red: PTS*kWarps floats of shared memory, free again only
// after the caller's next __syncthreads.
template <int PTS>
__device__ __forceinline__ void block_tree_sums(float (&v)[PTS], float* red) {
#pragma unroll
    for (int q = 0; q < PTS; ++q)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
    if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int q = 0; q < PTS; ++q) red[q * kWarps + (threadIdx.x >> 5)] = v[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
        float w[kWarps];
#pragma unroll
        for (int i = 0; i < kWarps; ++i) w[i] = red[q * kWarps + i];
#pragma unroll
        for (int h = kWarps / 2; h > 0; h >>= 1)
#pragma unroll
            for (int i = 0; i < h; ++i) w[i] = w[2 * i] + w[2 * i + 1];
        v[q] = w[0];
    }
}

// off[j] <- the tile's points whose centroid is below j, for j in [0, k]
// (off[k]: all of them), from the NV (virtual) warps' counts of each
// centroid (wcnt[v * k + j]), by the whole block: each thread takes a
// contiguous run of j.  wsum: kWarps ints of shared memory.  Ends
// synchronised.
template <int NV>
__device__ __forceinline__ void tile_offsets(const unsigned char* wcnt, int k, int* off,
                                             int* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (k + 1 + kThreads - 1) / kThreads;
    const int lo = min(k + 1, tid * per), hi = min(k + 1, lo + per);
    auto total = [&](int j) {
        int t = 0;
        if (j < k)
#pragma unroll
            for (int v = 0; v < NV; ++v) t += wcnt[v * k + j];
        return t;
    };
    int local = 0;
    for (int j = lo; j < hi; ++j) local += total(j);
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int run = incl - local;
    for (int w = 0; w < warp; ++w) run += wsum[w];
    for (int j = lo; j < hi; ++j) {
        off[j] = run;
        run += total(j);
    }
    __syncthreads();
}

// Whether centroid j (distance acc) replaces the best so far: torch.argmin's
// rule, the first NaN distance wins, else the lowest index of the minimum.
// Without NaN (NANS false: finite inputs, whose distances are never NaN) a
// strict <; with NaN, j is taken while best is not NaN and acc is NaN or
// below it.
template <bool NANS>
__device__ __forceinline__ bool takes(float acc, float best) {
    if (NANS) return best == best && !(acc >= best);
    return acc < best;
}

// Nearest centroid of each of PTS points in registers against the codebook
// cs in shared memory: in index order by takes<NANS>() (lowest index wins
// ties), each distance summed dim by dim without FMA contraction, the plain
// version's arithmetic.  Each centroid coordinate is read from shared memory
// once for all PTS points; VEC (s == MAXS): 16 bytes at a time, the rows
// then lying on 16-byte boundaries.  Call it through nearest().
template <int MAXS, int PTS, bool VEC, bool NANS>
__device__ __forceinline__ void nearest_pts(const float (&xv)[PTS][MAXS], const float* cs, int k,
                                            int s, int (&bi)[PTS], float (&best)[PTS]) {
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
        best[q] = CUDART_INF_F;
        bi[q] = 0;
    }
    for (int j = 0; j < k; ++j) {
        float acc[PTS];
#pragma unroll
        for (int q = 0; q < PTS; ++q) acc[q] = 0.f;
        if (VEC) {
            const float4* cj = reinterpret_cast<const float4*>(cs + j * MAXS);
#pragma unroll
            for (int t4 = 0; t4 < MAXS / 4; ++t4) {
                const float4 cv = cj[t4];
                const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                    for (int q = 0; q < PTS; ++q) {
                        const float d = __fsub_rn(xv[q][4 * t4 + e], c4[e]);
                        acc[q] = __fadd_rn(acc[q], __fmul_rn(d, d));
                    }
            }
        } else {
            const float* cj = cs + j * s;
#pragma unroll
            for (int t = 0; t < MAXS; ++t) {
                if (t < s) {
                    const float c = cj[t];
#pragma unroll
                    for (int q = 0; q < PTS; ++q) {
                        const float d = __fsub_rn(xv[q][t], c);
                        acc[q] = __fadd_rn(acc[q], __fmul_rn(d, d));
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            if (takes<NANS>(acc[q], best[q])) {
                best[q] = acc[q];
                bi[q] = j;
            }
        }
    }
}

// finite: every coordinate of the thread's points and of the codebook is
// finite, so no distance is NaN and the strict < is torch.argmin's rule;
// otherwise (NaN or inf data only) the NaN-aware loop.
template <int MAXS, int PTS>
__device__ __forceinline__ void nearest(const float (&xv)[PTS][MAXS], const float* cs, int k,
                                        int s, bool finite, int (&bi)[PTS], float (&best)[PTS]) {
    if (!finite)
        nearest_pts<MAXS, PTS, false, true>(xv, cs, k, s, bi, best);
    else if (s == MAXS)
        nearest_pts<MAXS, PTS, true, false>(xv, cs, k, s, bi, best);
    else
        nearest_pts<MAXS, PTS, false, false>(xv, cs, k, s, bi, best);
}

// Whether every coordinate of a point in registers is finite.
template <int MAXS, int PTS>
__device__ __forceinline__ bool points_finite(const float (&xv)[PTS][MAXS]) {
    bool ok = true;
#pragma unroll
    for (int q = 0; q < PTS; ++q)
#pragma unroll
        for (int t = 0; t < MAXS; ++t) ok &= (bool)isfinite(xv[q][t]);
    return ok;
}

// Lloyd statistics of one chunk of block_n points (grid: chunks x
// codebooks), narrow: the codebook in shared memory, PTS points a thread in
// registers.  Per tile of PTS*kThreads points (a thread's points kThreads
// apart): each point's nearest centroid (strict < in index order); the
// inertia of each run of kThreads points as block_tree_sums; then the
// points ranked by (centroid, index) -- within a warp by __match_any_sync
// and the lower lanes' popc, across warps by each (virtual) warp's count of
// the centroid in the warps before it, after an exclusive scan over k of
// the centroids' totals -- and stored in that order; then thread (j, t)
// adds centroid j's points to its sum of dim t (t == s: the count), in
// index order.  Each sum thus runs over the chunk's points in index order,
// as the wide kernel's does: the same bits.
template <int MAXS>
__global__ void __launch_bounds__(kThreads)
kmeans_stats_partial_kernel(const float* __restrict__ x,   // (B, n, s)
                            const float* __restrict__ c,   // (B, k, s)
                            int n, int k, int s, int block_n,
                            float* __restrict__ part_sums,     // (B, nblk, k, s)
                            float* __restrict__ part_counts,   // (B, nblk, k)
                            float* __restrict__ part_inertia,  // (B, nblk)
                            int* __restrict__ assign)          // (B, n) or null
{
    constexpr int PTS = stats_pts(MAXS);
    constexpr int kTile = PTS * kThreads;
    extern __shared__ __align__(16) float smem[];
    float* cs = smem;                       // k*s
    float* acc = cs + k * s;                // k*(s+1)
    float* tx = acc + k * (s + 1);          // kTile*s: the tile's points in ranked order
    float* red = tx + kTile * s;            // PTS*kWarps
    int* off = reinterpret_cast<int*>(red + PTS * kWarps);  // k+1: each centroid's first slot
    int* wsum = off + k + 1;                // kWarps
    unsigned char* wcnt = reinterpret_cast<unsigned char*>(wsum + kWarps);  // PTS*kWarps*k

    const int blk = blockIdx.x;
    const int nblk = gridDim.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long xoff = (long long)b * n;

    bool bad = false;  // a coordinate of the codebook that is not finite
    for (int u = tid; u < k * s; u += kThreads) {
        cs[u] = c[(long long)b * k * s + u];
        bad |= !isfinite(cs[u]);
    }
    for (int u = tid; u < k * (s + 1); u += kThreads) acc[u] = 0.f;
    for (int u = tid; u < PTS * kWarps * k; u += kThreads) wcnt[u] = 0;
    const bool cfinite = !__syncthreads_or(bad);

    float inertia = 0.f;  // the same in every thread
    const int start = blk * block_n;
    const int end = min(start + block_n, n);
    for (int t0 = start; t0 < end; t0 += kTile) {
        float xv[PTS][MAXS];
        bool live[PTS];
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            const int p = t0 + q * kThreads + tid;
            live[q] = p < end;
            if (live[q]) {
                load_point<MAXS>(x + (xoff + p) * s, s, xv[q]);
            } else {
#pragma unroll
                for (int t = 0; t < MAXS; ++t) xv[q][t] = 0.f;
            }
        }
        int bi[PTS];  // dead points match only each other
        float best[PTS];
        nearest<MAXS, PTS>(xv, cs, k, s, cfinite && points_finite(xv), bi, best);
        int lrank[PTS];
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            if (!live[q]) {
                bi[q] = -1;
                best[q] = 0.f;
            } else if (assign) {
                assign[xoff + t0 + q * kThreads + tid] = bi[q];
            }
            const unsigned peers = __match_any_sync(0xffffffffu, bi[q]);
            lrank[q] = __popc(peers & ((1u << lane) - 1u));
            if (live[q] && lrank[q] == 0)
                wcnt[(q * kWarps + warp) * k + bi[q]] = (unsigned char)__popc(peers);
        }
        block_tree_sums<PTS>(best, red);  // synchronises: the warps' counts are in
#pragma unroll
        for (int q = 0; q < PTS; ++q) inertia += best[q];
        tile_offsets<PTS * kWarps>(wcnt, k, off, wsum);
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            if (!live[q]) continue;
            int pos = off[bi[q]] + lrank[q];
            for (int v = 0; v < q * kWarps + warp; ++v) pos += wcnt[v * k + bi[q]];
#pragma unroll
            for (int t = 0; t < MAXS; ++t)
                if (t < s) tx[pos * s + t] = xv[q][t];
        }
        __syncthreads();
        for (int u = tid; u < PTS * kWarps * k; u += kThreads) wcnt[u] = 0;  // for the next tile
        for (int u = tid; u < k * (s + 1); u += kThreads) {
            const int j = u / (s + 1);
            const int t = u - j * (s + 1);
            const int lo = off[j], hi = off[j + 1];
            if (lo == hi) continue;
            float a = acc[u];
            if (t < s) {
                for (int i = lo; i < hi; ++i) a += tx[i * s + t];
            } else {
                a += (float)(hi - lo);
            }
            acc[u] = a;
        }
        __syncthreads();
    }

    const long long pb = (long long)b * nblk + blk;
    for (int u = tid; u < k * (s + 1); u += kThreads) {
        const int j = u / (s + 1);
        const int t = u - j * (s + 1);
        if (t < s)
            part_sums[pb * k * s + j * s + t] = acc[u];
        else
            part_counts[pb * k + j] = acc[u];
    }
    if (tid == 0) part_inertia[pb] = inertia;
}

// Sum the per-block partials over the blocks, in block order (grid: slices
// of the k*s + k + 1 outputs x codebooks).
__global__ void __launch_bounds__(kThreads)
kmeans_stats_reduce_kernel(const float* __restrict__ part_sums, const float* __restrict__ part_counts,
                           const float* __restrict__ part_inertia, int nblk, int k, int s,
                           float* __restrict__ sums, float* __restrict__ counts,
                           float* __restrict__ inertia) {
    const int b = blockIdx.y;
    const int ks = k * s;
    for (int u = blockIdx.x * kThreads + threadIdx.x; u < ks + k + 1; u += gridDim.x * kThreads) {
        float a = 0.f;
        if (u < ks) {
#pragma unroll 8
            for (int blk = 0; blk < nblk; ++blk) a += part_sums[((long long)b * nblk + blk) * ks + u];
            sums[(long long)b * ks + u] = a;
        } else if (u < ks + k) {
            const int j = u - ks;
            for (int blk = 0; blk < nblk; ++blk) a += part_counts[((long long)b * nblk + blk) * k + j];
            counts[(long long)b * k + j] = a;
        } else {
            for (int blk = 0; blk < nblk; ++blk) a += part_inertia[(long long)b * nblk + blk];
            inertia[b] = a;
        }
    }
}

// ---- kernels 6 and 5-wide: a tensor-core screen with an exact re-check ----
// (the design and the margin's derivation are in the header)

constexpr int kWM = 4, kWN = 2;  // warps along the points and along the centroids
constexpr int kMT = 2, kNT = 4;  // m16n8k8 tiles per warp along each
constexpr int kBM = kWM * kMT * 16;  // points per block: 128
constexpr int kBN = kWN * kNT * 8;   // centroids per tile: 64
constexpr int kTPP = kThreads / kBM;  // threads per point summing ||x||^2
static_assert(kWM * kWN * 32 == kThreads && kWN == 2 && kThreads % kBM == 0,
              "the screened kernel's warp layout");
constexpr int kBK = 32;        // dims per staged slice
constexpr int kLdS = kBK + 16;  // padded row of a staged slice: 16-byte fragment reads of
                                 // 8 threads (rows g, g + 1) hit 32 distinct banks

// Dynamic shared memory of the screened kernel: two stages of the point and
// centroid slices, then per point: the tile minima of the two column halves,
// the running screen minimum, the margin, the norm, the exact best key and
// the deferred candidates.
constexpr int kL = 8;  // deferred candidates a point keeps (more are re-checked at once)
constexpr size_t kScreenSmem =
    sizeof(float) * (2 * kBM * kLdS + 2 * kBN * kLdS + kWN * kBM + 3 * kBM) +
    sizeof(unsigned long long) * kBM + sizeof(int) * kBM + (sizeof(int) + sizeof(float)) * kBM * kL;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One row-slice of kBK dims into shared memory by cp.async, zero-filled
// past the row count or the width (src-size 0).  VEC = 4: 16-byte copies
// (s % 4 == 0 and 16-byte aligned rows, checked by the launcher); VEC = 1:
// 4-byte copies for any s.  A thread copies the same dims t of rows r0,
// r0 + kStep, ...: src points at row r0 of the slice, dim t; a copy past
// the data reads nothing and takes `safe`, an address inside it.
template <int VEC, int ROWS>
__device__ __forceinline__ void stage_slice(float* dst, const float* src, const float* safe,
                                            int r0, int t, int nrows_left, int s, bool dim_ok) {
    constexpr int kStep = kThreads / (kBK / VEC);  // rows a pass of the block covers
    const long long row_stride = (long long)kStep * s;
#pragma unroll 4
    for (int i = 0; i < ROWS / kStep; ++i) {
        const int r = r0 + i * kStep;
        const bool ok = dim_ok && r < nrows_left;
        const unsigned a = smem_addr(dst + r * kLdS + t);
        const float* g = ok ? src + i * row_stride : safe;
        if (VEC == 4)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g),
                         "r"(ok ? 16 : 0));
        else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(g),
                         "r"(ok ? 4 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The 64-bit key of centroid j at plain distance d, in torch.argmin's
// order: a NaN distance first (high half 0), then d (bits(d) + 1: d >= 0 or
// +inf, whose bits order as integers), then the index.  The minimum key of
// a set of centroids is the plain argmin over it.
__device__ __forceinline__ unsigned long long dist_key(float d, int j) {
    const unsigned hi = d != d ? 0u : __float_as_uint(d) + 1u;
    return (unsigned long long)hi << 32 | (unsigned)j;
}

__device__ __forceinline__ unsigned long long min_key(unsigned long long a, unsigned long long b) {
    return a < b ? a : b;
}

// The distance a key holds.
__device__ __forceinline__ float key_dist(unsigned long long key) {
    const unsigned hi = (unsigned)(key >> 32);
    return hi == 0u ? CUDART_NAN_F : __uint_as_float(hi - 1u);
}

// Whether a screen's error bound holds for a point: N_p = ||x||^2 +
// max_j ||c_j||^2 (fp32) at most FLT_MAX / 4, so no plain distance (at most
// ~2 N_p) overflows and every product is finite, and at least 2^-100, so
// the tensor cores' flushing of subnormal products (each below 2^-126) stays
// far inside the margin.  A NaN or infinite coordinate makes N_p NaN or
// infinite.  A point the screen does not cover re-checks every centroid.
__device__ __forceinline__ bool screen_covers(float np) {
    return np >= 0x1p-100f && np <= FLT_MAX / 4;
}

// d_plain(p, j): the plain version's distance, dim 0..s-1 in order with
// __fsub_rn / __fmul_rn / __fadd_rn, read from device memory (L2-resident).
template <int VEC>
__device__ __forceinline__ float plain_dist(const float* __restrict__ xr,
                                            const float* __restrict__ cr, int s) {
    float acc = 0.f;
    if (VEC == 4) {
#pragma unroll 4
        for (int t = 0; t < s; t += 4) {
            const float4 a = *reinterpret_cast<const float4*>(xr + t);
            const float4 b = *reinterpret_cast<const float4*>(cr + t);
            float e = __fsub_rn(a.x, b.x);
            acc = __fadd_rn(acc, __fmul_rn(e, e));
            e = __fsub_rn(a.y, b.y);
            acc = __fadd_rn(acc, __fmul_rn(e, e));
            e = __fsub_rn(a.z, b.z);
            acc = __fadd_rn(acc, __fmul_rn(e, e));
            e = __fsub_rn(a.w, b.w);
            acc = __fadd_rn(acc, __fmul_rn(e, e));
        }
    } else {
#pragma unroll 4
        for (int t = 0; t < s; ++t) {
            const float e = __fsub_rn(xr[t], cr[t]);
            acc = __fadd_rn(acc, __fmul_rn(e, e));
        }
    }
    return acc;
}

// ||c_j||^2 of every centroid (fp32, in dim order) and each codebook's
// largest, the margin's centroid term (cmax zeroed by the launcher; the
// norms are >= 0, so their bits order as integers; a NaN norm counts as
// +inf, which no point's screen covers).
__global__ void __launch_bounds__(kThreads)
centroid_norms_kernel(const float* __restrict__ c, int B, int k, int s,
                      float* __restrict__ cn, float* __restrict__ cmax) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;  // b * k + j
    if (i >= (long long)B * k) return;
    const float* row = c + i * s;
    float a = 0.f;
    for (int t = 0; t < s; ++t) a = __fadd_rn(a, __fmul_rn(row[t], row[t]));
    cn[i] = a;
    atomicMax(reinterpret_cast<int*>(cmax) + i / k, __float_as_int(a != a ? CUDART_INF_F : a));
}

// Nearest centroid of every point against its own codebook, any width and
// any k, bit-equal to the plain version (grid: tiles of kBM points x
// codebooks).  Kernel 6 is this at B = 1; kernel 5 takes it for its wide
// shapes, and row 3's wide variant its argmins.  8 warps in 4 (rows) x 2
// (centroid columns), each warp a 32 x 32 corner of the kBM x kBN tile as
// 2 x 4 m16n8k8 products.  best (null but for row 3) takes each point's exact
// best distance d*, the high half of its (d*, j*) key: a plain re-check's
// distance, so the plain version's minimum bit for bit.  rechecks (null on
// the path) takes each block's count of re-checked pairs; SCREEN writes the
// screen's distances to screen (B, n, k), for the checks.
template <int VEC, bool SCREEN>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_assign_streamed_kernel(const float* __restrict__ x,     // (B, n, s)
                              const float* __restrict__ c,     // (B, k, s)
                              const float* __restrict__ cn,    // (B, k) ||c||^2
                              const float* __restrict__ cmax,  // (B,) max ||c||^2
                              int n, int k, int s, float mu,
                              int* __restrict__ assign,        // (B, n)
                              int* __restrict__ rechecks,      // (B, blocks) or null
                              float* __restrict__ screen,      // (B, n, k) if SCREEN
                              float* __restrict__ best)        // (B, n) or null
{
    extern __shared__ __align__(16) float tsm[];
    float* xs = tsm;                           // [2][kBM][kLdS]
    float* cs = xs + 2 * kBM * kLdS;           // [2][kBN][kLdS]
    float* tmin = cs + 2 * kBN * kLdS;         // [2][kBM]: the tile's minimum per column half
    float* mrun = tmin + 2 * kBM;              // [kBM]: running screen minimum m
    float* marg = mrun + kBM;                  // [kBM]: the margin delta_p
    float* xn = marg + kBM;                    // [kBM]: ||x_p||^2
    unsigned long long* key = reinterpret_cast<unsigned long long*>(xn + kBM);  // (d*, j*)
    int* lcnt = reinterpret_cast<int*>(key + kBM);  // [kBM]: candidates each point deferred
    int* lj = lcnt + kBM;                           // [kBM][kL]: their indices
    float* la = reinterpret_cast<float*>(lj + kBM * kL);  // [kBM][kL]: their screen distances

    const int b = blockIdx.y;
    const int p0 = blockIdx.x * kBM;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp % kWM, wn = warp / kWM;
    const int g = lane >> 2, tq = lane & 3;
    const float* xb = x + (long long)b * n * s;
    const float* cb = c + (long long)b * k * s;
    const float* cnb = cn + (long long)b * k;

    for (int i = tid; i < kBM; i += kThreads) {
        mrun[i] = CUDART_INF_F;
        key[i] = ~0ull;
        lcnt[i] = 0;
    }
    const int nsl = (s + kBK - 1) / kBK;
    const int ntile = (k + kBN - 1) / kBN;
    const int steps = nsl * ntile;
    float xn_part = 0.f;  // tile 0: this thread's share of point tid / kTPP's slices
    int nre = 0;
    float acc[kMT][kNT][4];

    // this thread's copies: dims t.. of rows r0, r0 + kStep, ... of a slice
    const int r0 = tid / (kBK / VEC), t = tid % (kBK / VEC) * VEC;
    auto stage = [&](int st_, int buf_) {
        const int t1 = st_ / nsl, d0 = (st_ - t1 * nsl) * kBK;
        const bool dim_ok = d0 + t < s;
        const int dt = dim_ok ? d0 + t : 0;
        stage_slice<VEC, kBM>(xs + buf_ * kBM * kLdS, xb + ((long long)p0 + r0) * s + dt, xb, r0,
                              t, n - p0, s, dim_ok);
        stage_slice<VEC, kBN>(cs + buf_ * kBN * kLdS, cb + ((long long)t1 * kBN + r0) * s + dt,
                              cb, r0, t, k - t1 * kBN, s, dim_ok);
    };
    stage(0, 0);
    cp_async_commit();
    for (int st = 0; st < steps; ++st) {
        const int tile = st / nsl, sl = st - tile * nsl;
        const int buf = st & 1;
        if (st + 1 < steps) stage(st + 1, buf ^ 1);  // the next slice into the other stage
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const float* X = xs + buf * kBM * kLdS;
        const float* C = cs + buf * kBN * kLdS;
        if (sl == 0) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
        }
        if (tile == 0) {
            const float* r = X + (tid / kTPP) * kLdS + (tid % kTPP) * (kBK / kTPP);
#pragma unroll
            for (int t = 0; t < kBK / kTPP; ++t)
                xn_part = __fadd_rn(xn_part, __fmul_rn(r[t], r[t]));
        }
        // 16 dims at a time: each thread loads 4 consecutive dims of a row
        // (one 16-byte read) and feeds dims (4tq, 4tq+1) to k-step 0 as the
        // fragment's k = tq and tq + 4, dims (4tq+2, 4tq+3) to k-step 1.  A
        // and B take the same permutation of k, so each product still sums
        // over the same 8 dims.
#pragma unroll
        for (int k16 = 0; k16 < kBK; k16 += 16) {
            float4 xa[kMT][2], cv[kNT];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                const float* r = X + (wm * kMT * 16 + mt * 16 + g) * kLdS + k16 + 4 * tq;
                xa[mt][0] = *reinterpret_cast<const float4*>(r);
                xa[mt][1] = *reinterpret_cast<const float4*>(r + 8 * kLdS);
            }
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
                cv[nt] = *reinterpret_cast<const float4*>(C + (wn * kNT * 8 + nt * 8 + g) * kLdS +
                                                          k16 + 4 * tq);
#pragma unroll
            for (int step = 0; step < 2; ++step) {
                unsigned ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    const float4 r0 = xa[mt][0], r8 = xa[mt][1];
                    split_tf32(step ? r0.z : r0.x, ab[mt][0], as[mt][0]);
                    split_tf32(step ? r8.z : r8.x, ab[mt][1], as[mt][1]);
                    split_tf32(step ? r0.w : r0.y, ab[mt][2], as[mt][2]);
                    split_tf32(step ? r8.w : r8.y, ab[mt][3], as[mt][3]);
                }
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                    split_tf32(step ? cv[nt].z : cv[nt].x, bb[nt][0], bs[nt][0]);
                    split_tf32(step ? cv[nt].w : cv[nt].y, bb[nt][1], bs[nt][1]);
                }
                // the small terms first, then big x big
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
            }
        }

        if (sl == nsl - 1) {  // the tile's cross terms are complete
            if (tile == 0) {  // the points' norms and margins, once
                float v = xn_part;
#pragma unroll
                for (int o = 1; o < kTPP; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
                if (tid % kTPP == 0) {  // +inf: every centroid is a candidate
                    const float np = __fadd_rn(v, cmax[b]);
                    xn[tid / kTPP] = v;
                    marg[tid / kTPP] = screen_covers(np) ? mu * np : CUDART_INF_F;
                }
                __syncthreads();
            }
            const int j0 = tile * kBN;
            // the screen: a = ||x||^2 + ||c||^2 - 2 x.c, +inf past k
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = wm * kMT * 16 + mt * 16 + g + 8 * h;
                    const float nx = xn[row];
                    float lo = CUDART_INF_F;
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int j = j0 + wn * kNT * 8 + nt * 8 + 2 * tq + e;
                            float& a = acc[mt][nt][2 * h + e];
                            a = j < k ? __fsub_rn(__fadd_rn(nx, __ldg(cnb + j)), 2.f * a)
                                      : CUDART_INF_F;
                            lo = fminf(lo, a);
                        }
                    }
                    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
                    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
                    if (tq == 0) tmin[wn * kBM + row] = lo;
                }
            }
            __syncthreads();
            for (int i = tid; i < kBM; i += kThreads)
                mrun[i] = fminf(mrun[i], fminf(tmin[i], tmin[kBM + i]));
            __syncthreads();
            // the exact re-check of every centroid within the margin of m:
            // first a mask of this thread's candidates (bit ((mt*2 + h)*kNT +
            // nt)*2 + e), then one plain distance each
            unsigned long long cand = 0;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = wm * kMT * 16 + mt * 16 + g + 8 * h;
                    const int p = p0 + row;
                    const float lim = mrun[row] + marg[row];
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int j = j0 + wn * kNT * 8 + nt * 8 + 2 * tq + e;
                            const float a = acc[mt][nt][2 * h + e];
                            if (SCREEN && p < n && j < k)
                                screen[((long long)b * n + p) * k + j] = a;
                            if (p < n && j < k && !(a > lim)) {  // defer, or re-check now
                                const int slot = atomicAdd(&lcnt[row], 1);
                                if (slot < kL) {
                                    lj[row * kL + slot] = j;
                                    la[row * kL + slot] = a;
                                } else {
                                    cand |= 1ull << (((mt * 2 + h) * kNT + nt) * 2 + e);
                                }
                            }
                        }
                    }
                }
            }
            while (cand) {
                const int bit = __ffsll((long long)cand) - 1;
                cand &= cand - 1;
                const int e = bit & 1, nt = (bit >> 1) % kNT, mh = (bit >> 1) / kNT;
                const int row = wm * kMT * 16 + (mh >> 1) * 16 + g + 8 * (mh & 1);
                const int j = j0 + wn * kNT * 8 + nt * 8 + 2 * tq + e;
                const float d =
                    plain_dist<VEC>(xb + (long long)(p0 + row) * s, cb + (long long)j * s, s);
                atomicMin(&key[row], dist_key(d, j));
                ++nre;
            }
        }
        __syncthreads();  // every thread is done with this stage before it refills
    }

    // the deferred candidates still within the margin of the final m (a
    // point's first candidates spread over the threads)
    for (int u = tid; u < kBM * kL; u += kThreads) {
        const int row = u % kBM, slot = u / kBM, at = row * kL + slot;
        if (slot < lcnt[row] && !(la[at] > mrun[row] + marg[row])) {
            const int j = lj[at];
            const float d =
                plain_dist<VEC>(xb + (long long)(p0 + row) * s, cb + (long long)j * s, s);
            atomicMin(&key[row], dist_key(d, j));
            ++nre;
        }
    }
    __syncthreads();
    for (int i = tid; i < kBM; i += kThreads) {
        if (p0 + i >= n) continue;
        assign[(long long)b * n + p0 + i] = (int)(unsigned)(key[i] & 0xffffffffu);
        if (best) best[(long long)b * n + p0 + i] = key_dist(key[i]);
    }
    if (rechecks) {
        for (int o = 16; o > 0; o >>= 1) nre += __shfl_xor_sync(0xffffffffu, nre, o);
        int* red = reinterpret_cast<int*>(tmin);
        if (lane == 0) red[warp] = nre;
        __syncthreads();
        if (tid == 0) {
            int tot = 0;
            for (int w = 0; w < kThreads / 32; ++w) tot += red[w];
            rechecks[(long long)b * gridDim.x + blockIdx.x] = tot;
        }
    }
}

template <int VEC, bool SCREEN>
int launch_screened_v(const float* x, const float* c, const float* cn, const float* cmax,
                      int B, int n, int k, int s, float mu, int* assign, int* rechecks,
                      float* screen, float* best, cudaStream_t stream) {
    auto kern = kmeans_assign_streamed_kernel<VEC, SCREEN>;
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScreenSmem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((n + kBM - 1) / kBM, B), kThreads, kScreenSmem, stream>>>(
        x, c, cn, cmax, n, k, s, mu, assign, rechecks, screen, best);
    return (int)cudaGetLastError();
}

// The norms' prologue, then the screened kernel.  norms: B*k + B floats of
// scratch (||c||^2, then each codebook's largest).  screen non-null takes the
// SCREEN instantiation; best non-null takes each point's d*.
int launch_assign_streamed(const float* x, const float* c, int B, int n, int k, int s, float mu,
                           float* norms, int* assign, int* rechecks, float* screen, float* best,
                           cudaStream_t stream) {
    float* cn = norms;
    float* cmax = norms + (size_t)B * k;
    cudaError_t e = cudaMemsetAsync(cmax, 0, sizeof(float) * B, stream);
    if (e != cudaSuccess) return (int)e;
    const long long nc = (long long)B * k;
    centroid_norms_kernel<<<(unsigned)((nc + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        c, B, k, s, cn, cmax);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const bool vec4 = s % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(c) & 15) == 0;
#define REPRO_SCREENED(V, S) \
    return launch_screened_v<V, S>(x, c, cn, cmax, B, n, k, s, mu, assign, rechecks, screen, best, \
                                   stream)
    if (screen) {
        if (vec4) REPRO_SCREENED(4, true);
        REPRO_SCREENED(1, true);
    }
    if (vec4) REPRO_SCREENED(4, false);
    REPRO_SCREENED(1, false);
#undef REPRO_SCREENED
}

// ---- wide variant of kernel 3: any width s and any k --------------------
// Kernel 5's wide variant is kmeans_assign_streamed_kernel above; kernel 3's
// takes its argmins and d* from it, then kmeans_stats_wide_accumulate_kernel.
// (Kernel 4's wide variant, at the end, takes its argmins from it too.)

constexpr int kSub = 4096;  // points the wide stats kernel ranks at once (a power of two)
constexpr int kRowU = 8;    // rows a warp of the wide stats kernel keeps in flight
constexpr int kRowQ = 4;    // dims a lane takes per pass: kRowQ * 32 dims a pass

// keys[0..len) ascending, by the whole block (bitonic; len a power of two).
// Ends synchronised.
__device__ __forceinline__ void block_bitonic_sort(unsigned long long* keys, int len) {
    for (int size = 2; size <= len; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < len / 2; i += kThreads) {
                const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
                const unsigned long long a = keys[lo], b = keys[hi];
                if ((a > b) == ((lo & size) == 0)) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

// The first i in [0, len) whose key's centroid (high half) is >= j, else len.
__device__ __forceinline__ int first_key_of(const unsigned long long* keys, int len, int j) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((long long)(keys[mid] >> 32) < j) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Lloyd statistics from the screened kernel's argmins and d* (wide: any s,
// any k; grid: chunks x `groups` x codebooks).  A chunk's inertia is its
// tiles' block_tree_sums in tile order, as in the narrow kernel.  The
// block ranks each sub-chunk of <= kSub points by its (centroid, index) key
// (bitonic), and each warp takes a run of k / (groups * kWarps) centroids:
// it walks their ranked points in order, lanes over dims, kRowU rows in
// flight, each centroid's sum in registers, and writes each row of its
// partial once, coalesced (a centroid with no point: zeros).  A chunk past
// kSub points carries its sums from sub-chunk to sub-chunk through its own
// partial rows.  Each sum runs over the chunk's points in index order: the
// narrow kernel's bits.
__global__ void __launch_bounds__(kThreads)
kmeans_stats_wide_accumulate_kernel(const float* __restrict__ x,       // (B, n, s)
                                    const int* __restrict__ assign,    // (B, n)
                                    const float* __restrict__ best,    // (B, n) d*
                                    int n, int k, int s, int block_n, int groups,
                                    float* __restrict__ part_sums,     // (B, nblk, k, s)
                                    float* __restrict__ part_counts,   // (B, nblk, k)
                                    float* __restrict__ part_inertia)  // (B, nblk)
{
    __shared__ unsigned long long keys[kSub];
    __shared__ float red[kWarps];
    const int blk = blockIdx.x / groups, g = blockIdx.x - blk * groups;
    const int nblk = gridDim.x / groups;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long xoff = (long long)b * n;
    const long long pb = (long long)b * nblk + blk;
    const int start = blk * block_n;
    const int end = min(start + block_n, n);

    if (g == 0) {
        float inertia = 0.f;
        for (int t0 = start; t0 < end; t0 += kThreads) {
            float v[1] = {t0 + tid < end ? best[xoff + t0 + tid] : 0.f};
            block_tree_sums<1>(v, red);
            inertia += v[0];
            __syncthreads();  // red is read before the next tile writes it
        }
        if (tid == 0) part_inertia[pb] = inertia;
    }

    const int nw = groups * kWarps, gw = g * kWarps + warp;
    const int j0 = (int)((long long)k * gw / nw), j1 = (int)((long long)k * (gw + 1) / nw);
    float* psums = part_sums + pb * k * s;
    float* pcounts = part_counts + pb * k;
    for (int c0 = start; c0 < end; c0 += kSub) {
        const int len = min(kSub, end - c0);
        int plen = 1;
        while (plen < len) plen <<= 1;
        for (int i = tid; i < plen; i += kThreads)
            keys[i] = i < len ? (unsigned long long)(unsigned)assign[xoff + c0 + i] << 32 | (unsigned)i
                              : ~0ull;
        __syncthreads();
        block_bitonic_sort(keys, plen);
        const bool first = c0 == start;  // rows are written, not yet carried
        const int lo = first_key_of(keys, plen, j0), hi = first_key_of(keys, plen, j1);
        for (int d0 = 0; d0 < s; d0 += 32 * kRowQ) {
            float acc[kRowQ];
            int cur = -1, cnt = 0, next = j0;  // next: the first row not yet closed
            // write row cur (and its count, on the first pass over the dims)
            auto close = [&]() {
#pragma unroll
                for (int q = 0; q < kRowQ; ++q)
                    if (d0 + lane + 32 * q < s) psums[(long long)cur * s + d0 + lane + 32 * q] = acc[q];
                if (d0 == 0 && lane == 0) pcounts[cur] = (first ? 0.f : pcounts[cur]) + (float)cnt;
            };
            auto zero_rows = [&](int upto) {  // rows next..upto-1 have no point in the chunk
                for (; next < upto; ++next) {
#pragma unroll
                    for (int q = 0; q < kRowQ; ++q)
                        if (d0 + lane + 32 * q < s) psums[(long long)next * s + d0 + lane + 32 * q] = 0.f;
                    if (d0 == 0 && lane == 0) pcounts[next] = 0.f;
                }
            };
            for (int i0 = lo; i0 < hi; i0 += kRowU) {
                float v[kRowU][kRowQ];
                int aj[kRowU];
#pragma unroll
                for (int u = 0; u < kRowU; ++u) {
                    aj[u] = -1;
                    if (i0 + u < hi) {
                        const unsigned long long key = keys[i0 + u];
                        aj[u] = (int)(key >> 32);
                        const float* row = x + (xoff + c0 + (int)(unsigned)(key & 0xffffffffu)) * s + d0;
#pragma unroll
                        for (int q = 0; q < kRowQ; ++q)
                            v[u][q] = d0 + lane + 32 * q < s ? __ldg(row + lane + 32 * q) : 0.f;
                    }
                }
#pragma unroll
                for (int u = 0; u < kRowU; ++u) {
                    if (aj[u] < 0) break;
                    if (aj[u] != cur) {  // the same for every lane: no divergence
                        if (cur >= 0) close();
                        if (first) zero_rows(aj[u]);
                        cur = aj[u];
                        next = cur + 1;
                        cnt = 0;
#pragma unroll
                        for (int q = 0; q < kRowQ; ++q)
                            acc[q] = first || d0 + lane + 32 * q >= s
                                         ? 0.f : psums[(long long)cur * s + d0 + lane + 32 * q];
                    }
#pragma unroll
                    for (int q = 0; q < kRowQ; ++q) acc[q] += v[u][q];
                    ++cnt;
                }
            }
            if (cur >= 0) close();
            if (first) zero_rows(j1);
        }
        __syncthreads();  // every warp is done with the keys
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The partials summed over the blocks in block order, the k*s + k + 1
// outputs spread over blocks.
int launch_stats_reduce(const float* part_sums, const float* part_counts,
                        const float* part_inertia, int B, int nblk, int k, int s, float* sums,
                        float* counts, float* inertia, cudaStream_t stream) {
    const long long outs = (long long)k * s + k + 1;
    const long long blocks = (outs + kThreads - 1) / kThreads;
    const int gx = (int)(blocks < 1024 ? blocks : 1024);
    kmeans_stats_reduce_kernel<<<dim3(gx, B), kThreads, 0, stream>>>(
        part_sums, part_counts, part_inertia, nblk, k, s, sums, counts, inertia);
    return (int)cudaGetLastError();
}

template <int MAXS>
int launch_stats(const float* x, const float* c, int B, int n, int k, int s,
                 int block_n, float* part_sums, float* part_counts, float* part_inertia,
                 float* sums, float* counts, float* inertia, int* assign, cudaStream_t stream) {
    const int nblk = (n + block_n - 1) / block_n;
    const size_t smem = stats_smem_bytes(k, s);
    cudaError_t e = allow_smem(kmeans_stats_partial_kernel<MAXS>, smem);
    if (e != cudaSuccess) return (int)e;
    kmeans_stats_partial_kernel<MAXS><<<dim3(nblk, B), kThreads, smem, stream>>>(
        x, c, n, k, s, block_n, part_sums, part_counts, part_inertia, assign);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return launch_stats_reduce(part_sums, part_counts, part_inertia, B, nblk, k, s, sums, counts,
                               inertia, stream);
}

// The screened kernel's argmins and d* (into assign and best, (B, n) each),
// then the accumulation over `groups` blocks a chunk: enough blocks for two
// a multiprocessor, at most 8 a chunk.
int launch_stats_wide(const float* x, const float* c, int B, int n, int k, int s, int block_n,
                      float mu, float* norms, float* best, float* part_sums, float* part_counts,
                      float* part_inertia, float* sums, float* counts, float* inertia,
                      int* assign, cudaStream_t stream) {
    int e = launch_assign_streamed(x, c, B, n, k, s, mu, norms, assign, nullptr, nullptr, best,
                                   stream);
    if (e != (int)cudaSuccess) return e;
    int dev = 0, sms = 0;
    cudaError_t ce = cudaGetDevice(&dev);
    if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce != cudaSuccess) return (int)ce;
    const int nblk = (n + block_n - 1) / block_n;
    const long long chunks = (long long)nblk * B;
    const int groups = (int)std::min<long long>(8, std::max<long long>(1, (2LL * sms + chunks - 1) / chunks));
    kmeans_stats_wide_accumulate_kernel<<<dim3(nblk * groups, B), kThreads, 0, stream>>>(
        x, assign, best, n, k, s, block_n, groups, part_sums, part_counts, part_inertia);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return (int)ce;
    return launch_stats_reduce(part_sums, part_counts, part_inertia, B, nblk, k, s, sums, counts,
                               inertia, stream);
}

// ---- kernel 5 narrow: a tensor-core screen with the codebook resident ----
// (the design and its margin are in the header)

constexpr int kNarrowPasses = 8;  // passes of a block's warps over its chunk of points

// The dim that fragment column kf (0..7) of k-step kk carries.  KS >= 2:
// each 16 dims 16G.. feed k-step 2G (dims 16G + 4t, 16G + 4t + 1 as kf = t,
// t + 4) and k-step 2G + 1 (16G + 4t + 2, 16G + 4t + 3), the screened
// kernel's grouping; KS = 1: kf itself.  Points and centroids take the same
// map, so each product still sums over the same dims.
template <int KS>
__host__ __device__ constexpr int frag_dim(int kk, int kf) {
    return KS == 1 ? kf : 16 * (kk >> 1) + 4 * (kf & 3) + 2 * (kk & 1) + (kf >> 2);
}

// k-steps of 8 dims the narrow kernel takes at width s (dims padded with
// zeros to 8 KS), and the m16 tiles of points a warp holds at KS.
__host__ __device__ constexpr int narrow_ks(int s) {
    return s <= 8 ? 1 : s <= 16 ? 2 : s <= 32 ? 4 : 8;
}
__host__ __device__ constexpr int narrow_mt(int ks) { return ks == 8 ? 1 : 2; }

// Dynamic shared memory of a narrow assignment block: per tile of 8
// centroids (an even number of tiles) and k-step, one float4 a lane (its two
// B-fragment values' TF32 big halves, then their small halves), then
// -||c_j||^2 / 2 per centroid (the tiles' 8 slots).  The op wrapper reads it
// through kmeans_assign_narrow_smem_bytes.
__host__ __device__ inline size_t narrow_smem_bytes(int k, int ks) {
    const size_t tiles = ((size_t)k + 15) / 16 * 2;
    return tiles * (sizeof(float4) * 32 * ks + sizeof(float) * 8);
}

// Nearest centroid of every point against its own codebook, s <= 64 and a
// codebook whose split fits in shared memory, bit-equal to the plain version
// (grid: chunks of kNarrowPasses * kWarps * MT * 16 points x codebooks).
// The block splits its codebook into TF32 halves in fragment order, then each
// warp takes MT * 16 points at a time, holds their split A fragments in
// registers and walks every tile of 8 centroids: 3 * KS * MT mma.sync, the
// accumulator started at -||c_j||^2 / 2, so it ends at t_j = x.c_j -
// ||c_j||^2 / 2 (the distance is ||x||^2 - 2 t_j: the largest t is the
// nearest centroid).  Each lane keeps, per point row, the largest t of its
// columns (m1, j1) and the second largest (ev), with no barrier and no
// shared memory in the loop.  At the end of the codebook, per point: T = the
// quad's largest m1 and lim = T - mu N_p / 2; the lanes whose m1 >= lim are
// the candidates.  If some lane's ev >= lim too (a candidate that lane did
// not keep), or the screen does not cover the point (screen_covers), every
// centroid is re-checked by the whole warp in the plain arithmetic;
// otherwise one candidate is the argmin and several are re-checked (their
// keys' quad minimum).  PROBE: rechecks takes each block's re-checked pairs,
// best each point's plain best distance, screen (if not null) every t.
template <int KS, int MT, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_assign_narrow_kernel(const float* __restrict__ x,   // (B, n, s)
                            const float* __restrict__ c,   // (B, k, s)
                            int n, int k, int s, int chunk, float mu,
                            int* __restrict__ assign,      // (B, n)
                            int* __restrict__ rechecks,    // (B, blocks) if PROBE
                            float* __restrict__ screen,    // (B, n, k) or null, if PROBE
                            float* __restrict__ best)      // (B, n) if PROBE
{
    extern __shared__ __align__(16) float4 cfrag[];  // [tiles][KS][32 lanes]
    const int ntile = (k + 15) / 16 * 2;  // tiles of 8 centroids, an even number
    float* ncn = reinterpret_cast<float*>(cfrag + ntile * KS * 32);  // [tiles * 8]
    __shared__ unsigned cmax_bits;  // the codebook's largest ||c||^2 (NaN: +inf)
    __shared__ int red[kWarps];
    const int b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const float* xb = x + (long long)b * n * s;
    const float* cb = c + (long long)b * k * s;

    constexpr int kRows = MT * 16;  // points a warp takes at a time
    const int start = blockIdx.x * chunk;
    const int end = min(start + chunk, n);
    // a warp's next rows into L1 while it works on the current ones (the
    // first rows while the block stages its codebook): kRows * s * 4 <= 4 KB,
    // a 128-byte line a lane
    auto prefetch = [&](int q0) {
        if (q0 < end && lane * 32 < (min(end - q0, kRows) * s)) {
            const float* a = xb + (long long)q0 * s + lane * 32;
            asm volatile("prefetch.global.L1 [%0];" ::"l"(a));
        }
    };
    prefetch(start + warp * kRows);

    if (tid == 0) cmax_bits = 0u;
    for (int u = tid; u < ntile * KS * 32; u += kThreads) {
        const int L = u & 31, kk = (u >> 5) % KS, j = 8 * ((u >> 5) / KS) + (L >> 2);
        const int d0 = frag_dim<KS>(kk, L & 3), d1 = frag_dim<KS>(kk, (L & 3) + 4);
        const float v0 = j < k && d0 < s ? cb[(long long)j * s + d0] : 0.f;
        const float v1 = j < k && d1 < s ? cb[(long long)j * s + d1] : 0.f;
        unsigned b0, s0, b1, s1;
        split_tf32(v0, b0, s0);
        split_tf32(v1, b1, s1);
        cfrag[u] = make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(s0),
                               __uint_as_float(s1));
    }
    __syncthreads();  // cmax_bits is zeroed
    for (int j = tid; j < ntile * 8; j += kThreads) {
        float a = 0.f;
        if (j < k) {
            const float* row = cb + (long long)j * s;
            for (int t = 0; t < s; ++t) a = __fadd_rn(a, __fmul_rn(row[t], row[t]));
            atomicMax(&cmax_bits, __float_as_uint(a != a ? CUDART_INF_F : a));
        }
        ncn[j] = j < k ? -0.5f * a : -FLT_MAX;  // past k: t <= -FLT_MAX / 2, never a candidate
    }
    __syncthreads();
    const float cmax = __uint_as_float(cmax_bits);
    const float hmu = 0.5f * mu;

    int nre = 0;
    for (int p0 = start + warp * kRows; p0 < end; p0 += kWarps * kRows) {
        prefetch(p0 + kWarps * kRows);
        // the points' fragments, split once for the whole codebook, and
        // their norms (any order: they set only the margin)
        unsigned ab[MT][KS][4], as[MT][KS][4];
        float nx[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = p0 + mt * 16 + g + 8 * h;
                const float* row = xb + (long long)p * s;
                float sq = 0.f;
#pragma unroll
                for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int d = frag_dim<KS>(kk, tq + 4 * e);
                        const float v = p < end && d < s ? row[d] : 0.f;
                        split_tf32(v, ab[mt][kk][h + 2 * e], as[mt][kk][h + 2 * e]);
                        sq = __fmaf_rn(v, v, sq);
                    }
                }
                sq += __shfl_xor_sync(0xffffffffu, sq, 1);
                sq += __shfl_xor_sync(0xffffffffu, sq, 2);
                nx[mt][h] = sq;
            }
        }
        // the screen: per row, the largest t of this lane's columns and the
        // second largest
        float m1[MT][2], ev[MT][2];
        int j1[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                m1[mt][h] = -CUDART_INF_F;
                ev[mt][h] = -CUDART_INF_F;
                j1[mt][h] = 0;
            }
        // tile t's products into a (t's -||c||^2 / 2 to start)
        auto products = [&](int t, float (&a)[MT][4]) {
            const float2 nc = *reinterpret_cast<const float2*>(ncn + 8 * t + 2 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                a[mt][0] = nc.x;
                a[mt][1] = nc.y;
                a[mt][2] = nc.x;
                a[mt][3] = nc.y;
            }
            const float4* ft = cfrag + t * KS * 32 + lane;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                const float4 f = ft[kk * 32];
                const unsigned bb[2] = {__float_as_uint(f.x), __float_as_uint(f.y)};
                const unsigned bs[2] = {__float_as_uint(f.z), __float_as_uint(f.w)};
                // the small terms first, then big x big
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_tf32(a[mt], as[mt][kk], bb);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_tf32(a[mt], ab[mt][kk], bs);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_tf32(a[mt], ab[mt][kk], bb);
            }
        };
        // tile t's values into each row's (m1, j1, ev)
        auto keep = [&](int t, const float (&a)[MT][4]) {
            const int jb = 8 * t + 2 * tq;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float v = a[mt][2 * h + e];
                        const bool up = v > m1[mt][h];
                        ev[mt][h] = fmaxf(ev[mt][h], fminf(v, m1[mt][h]));
                        m1[mt][h] = fmaxf(m1[mt][h], v);
                        j1[mt][h] = up ? jb + e : j1[mt][h];
                        if (PROBE && screen) {
                            const int p = p0 + mt * 16 + g + 8 * h;
                            if (p < end && jb + e < k)
                                screen[((long long)b * n + p) * k + jb + e] = v;
                        }
                    }
        };
        // in pairs of tiles, each tile's products issued before the previous
        // tile's values are kept, with no branch between them, so the
        // bookkeeping fills the tensor cores' stalls (ntile is even: a padded
        // tile holds zeros and -FLT_MAX)
        float acc0[MT][4], acc1[MT][4];
        products(0, acc0);
        for (int t = 0; t + 2 < ntile; t += 2) {
            products(t + 1, acc1);
            keep(t, acc0);
            products(t + 2, acc0);
            keep(t + 1, acc1);
        }
        products(ntile - 1, acc1);
        keep(ntile - 2, acc0);
        keep(ntile - 1, acc1);
        // the candidates of each row
        bool whole[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = p0 + mt * 16 + g + 8 * h;
                const bool live = p < end;
                float top = m1[mt][h];
                top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
                top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
                const float np = __fadd_rn(nx[mt][h], cmax);
                const float lim = top - hmu * np;
                const unsigned qc = __ballot_sync(0xffffffffu, m1[mt][h] >= lim) >> (4 * g) & 0xfu;
                const unsigned qa = __ballot_sync(0xffffffffu, ev[mt][h] >= lim) >> (4 * g) & 0xfu;
                whole[mt][h] = live && (!screen_covers(np) || qa != 0u);
                const bool mine = (qc >> tq & 1u) != 0u;
                const bool several = !whole[mt][h] && live && __popc(qc) > 1;
                const float* xr = xb + (long long)p * s;
                if (!whole[mt][h] && live && !several && mine) {  // the one candidate
                    assign[(long long)b * n + p] = j1[mt][h];
                    if (PROBE && best)
                        best[(long long)b * n + p] =
                            plain_dist<1>(xr, cb + (long long)j1[mt][h] * s, s);
                }
                if (__any_sync(0xffffffffu, several)) {
                    unsigned long long key = ~0ull;
                    if (several && mine) {
                        key = dist_key(plain_dist<1>(xr, cb + (long long)j1[mt][h] * s, s),
                                       j1[mt][h]);
                        ++nre;
                    }
                    key = min_key(key, __shfl_xor_sync(0xffffffffu, key, 1));
                    key = min_key(key, __shfl_xor_sync(0xffffffffu, key, 2));
                    if (several && tq == 0) {
                        assign[(long long)b * n + p] = (int)(unsigned)(key & 0xffffffffu);
                        if (PROBE && best) best[(long long)b * n + p] = key_dist(key);
                    }
                }
            }
        }
        // rows the screen does not settle: every centroid, by the whole warp
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                unsigned rows = __ballot_sync(0xffffffffu, whole[mt][h] && tq == 0);
                while (rows) {
                    const int src = __ffs(rows) - 1;
                    rows &= rows - 1;
                    const int p = p0 + mt * 16 + (src >> 2) + 8 * h;
                    const float* xr = xb + (long long)p * s;
                    unsigned long long key = ~0ull;
                    for (int j = lane; j < k; j += 32)
                        key = min_key(key, dist_key(plain_dist<1>(xr, cb + (long long)j * s, s), j));
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        key = min_key(key, __shfl_xor_sync(0xffffffffu, key, o));
                    if (lane == 0) {
                        assign[(long long)b * n + p] = (int)(unsigned)(key & 0xffffffffu);
                        if (PROBE && best) best[(long long)b * n + p] = key_dist(key);
                        nre += k;
                    }
                }
            }
        }
    }
    if (PROBE && rechecks) {
        for (int o = 16; o > 0; o >>= 1) nre += __shfl_xor_sync(0xffffffffu, nre, o);
        if (lane == 0) red[warp] = nre;
        __syncthreads();
        if (tid == 0) {
            int tot = 0;
            for (int w = 0; w < kWarps; ++w) tot += red[w];
            rechecks[(long long)b * gridDim.x + blockIdx.x] = tot;
        }
    }
}

template <int KS, bool PROBE>
int launch_narrow_v(const float* x, const float* c, int B, int n, int k, int s, float mu,
                    int* assign, int* rechecks, float* screen, float* best, cudaStream_t stream) {
    constexpr int MT = narrow_mt(KS);
    constexpr int chunk = kNarrowPasses * kWarps * MT * 16;
    auto kern = kmeans_assign_narrow_kernel<KS, MT, PROBE>;
    const size_t smem = narrow_smem_bytes(k, KS);
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((n + chunk - 1) / chunk, B), kThreads, smem, stream>>>(
        x, c, n, k, s, chunk, mu, assign, rechecks, screen, best);
    return (int)cudaGetLastError();
}

// The narrow kernel at s <= 64 (mu: kernel.narrow_margin); the PROBE
// instantiation when rechecks, screen or best is not null.
int launch_assign_narrow(const float* x, const float* c, int B, int n, int k, int s, float mu,
                         int* assign, int* rechecks, float* screen, float* best,
                         cudaStream_t stream) {
    const bool probe = rechecks || screen || best;
#define REPRO_NARROW(KS)                                                                       \
    return probe ? launch_narrow_v<KS, true>(x, c, B, n, k, s, mu, assign, rechecks, screen,  \
                                             best, stream)                                     \
                 : launch_narrow_v<KS, false>(x, c, B, n, k, s, mu, assign, rechecks, screen, \
                                              best, stream)
    switch (narrow_ks(s)) {
        case 1: REPRO_NARROW(1);
        case 2: REPRO_NARROW(2);
        case 4: REPRO_NARROW(4);
        default: REPRO_NARROW(8);
    }
#undef REPRO_NARROW
    return (int)cudaErrorInvalidValue;
}


// ---- kernel 4: the build's paired assignment and the IMI histogram -------
// (the design and its margin are in the header)

// Points a thread of the narrow pair kernel takes a tile: 64 coordinates in
// registers (at most 8 points), so that each centroid read from shared
// memory serves them all and the loop's overhead is shared among them.
__host__ __device__ constexpr int pair_pts(int maxs) { return maxs <= 8 ? 8 : 64 / maxs; }

// The narrow pair kernel's instantiation (its padded width) at s <= 64.
__host__ __device__ constexpr int pair_maxs(int s) {
    return s <= 4 ? 4 : s <= 8 ? 8 : s <= 16 ? 16 : s <= 32 ? 32 : 64;
}

// Dynamic shared memory of a narrow pair block: both codebooks (rows of
// maxs, zero-padded), -||c_j||^2 / 2 per centroid of each, the k*k
// histogram, each of a tile's points' two centroids and the tile's re-check
// queue (one (point, half) an entry).  The op wrapper reads it through
// kmeans_pair_smem_bytes.
__host__ __device__ inline size_t pair_smem_bytes(int k, int maxs) {
    const size_t tile = (size_t)pair_pts(maxs) * kThreads;
    return sizeof(float) * (2 * (size_t)k * maxs + 2 * (size_t)k) +
           sizeof(int) * ((size_t)k * k + 4 * tile);
}

// The FFMA screen of PTS points in registers against one codebook in shared
// memory (rows of MAXS, zero-padded; hn[j] = -||c_j||^2 / 2), in index
// order: t_j = x.c_j - ||c_j||^2 / 2 as MAXS fused multiply-adds from hn[j];
// per point the largest t (m1; j1 its first index) and the runner-up (m2).
// PROBE: scr[q] (null for a dead point) takes point q's row of t.
template <int MAXS, int PTS, bool PROBE>
__device__ __forceinline__ void pair_screen(const float (&xv)[PTS][MAXS], const float* cs,
                                            const float* hn, int k, float (&m1)[PTS],
                                            float (&m2)[PTS], int (&j1)[PTS],
                                            float* (&scr)[PTS]) {
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
        m1[q] = -CUDART_INF_F;
        m2[q] = -CUDART_INF_F;
        j1[q] = 0;
    }
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
        const float4* cj = reinterpret_cast<const float4*>(cs + j * MAXS);
        float t[PTS];
        const float h = hn[j];
#pragma unroll
        for (int q = 0; q < PTS; ++q) t[q] = h;
#pragma unroll
        for (int t4 = 0; t4 < MAXS / 4; ++t4) {
            const float4 cv = cj[t4];
#pragma unroll
            for (int q = 0; q < PTS; ++q) {
                t[q] = __fmaf_rn(xv[q][4 * t4], cv.x, t[q]);
                t[q] = __fmaf_rn(xv[q][4 * t4 + 1], cv.y, t[q]);
                t[q] = __fmaf_rn(xv[q][4 * t4 + 2], cv.z, t[q]);
                t[q] = __fmaf_rn(xv[q][4 * t4 + 3], cv.w, t[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            const bool up = t[q] > m1[q];
            m2[q] = fmaxf(m2[q], fminf(t[q], m1[q]));
            m1[q] = fmaxf(m1[q], t[q]);
            j1[q] = up ? j : j1[q];
            if (PROBE && scr[q]) scr[q][j] = t[q];
        }
    }
}

// Both halves' argmins of each point and the IMI histogram, s <= 64, both
// codebooks and the k*k histogram in shared memory, bit-equal to the plain
// version (grid: chunks of whole tiles x subspaces; counts zeroed by the
// caller).  Per tile of PTS * kThreads points (a thread's points kThreads
// apart): each half's FFMA screen settles a point at its j1, or queues it;
// the warps re-check the queue in the plain arithmetic; then each point's
// two centroids go to assign and its cell to the shared histogram, which
// the block adds into counts once at its end.  PROBE: rechecks takes each
// block's re-checked (point, half)s, screen (if not null) every t.
template <int MAXS, bool PROBE>
__global__ void __launch_bounds__(kThreads)
kmeans_pair_assign_hist_kernel(const float* __restrict__ x,  // (2ns, n, s)
                               const float* __restrict__ c,  // (2ns, k, s)
                               int ns, int n, int k, int s, int chunk, float mu,
                               int* __restrict__ assign,     // (2ns, n)
                               int* __restrict__ counts,     // (ns, k*k)
                               int* __restrict__ rechecks,   // (ns, blocks) if PROBE
                               float* __restrict__ screen)   // (2ns, n, k) or null, if PROBE
{
    constexpr int PTS = pair_pts(MAXS);
    constexpr int kTile = PTS * kThreads;
    extern __shared__ __align__(16) float smem[];
    float* cs = smem;                                // [2][k][MAXS]
    float* hn = cs + 2 * k * MAXS;                   // [2][k]: -||c_j||^2 / 2
    int* hist = reinterpret_cast<int*>(hn + 2 * k);  // [k*k]
    int* sel = hist + k * k;                         // [2][kTile]: each point's centroid
    int* queue = sel + 2 * kTile;                    // [2 * kTile]: 2 * point + half
    __shared__ unsigned cmax_bits[2];  // each codebook's largest ||c||^2 (NaN: +inf)
    __shared__ int qn[2];              // the queue's length, by the tile's parity

    const int i = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long half0 = (long long)i * n, half1 = (long long)(ns + i) * n;  // first rows
    if (tid < 2) {
        cmax_bits[tid] = 0u;
        qn[tid] = 0;
    }
    for (int u = tid; u < 2 * k * MAXS; u += kThreads) {
        const int r = u / MAXS, t = u - r * MAXS;  // r = h * k + j
        const int h = r / k, j = r - h * k;
        cs[u] = t < s ? c[((long long)(h ? ns + i : i) * k + j) * s + t] : 0.f;
    }
    for (int u = tid; u < k * k; u += kThreads) hist[u] = 0;
    __syncthreads();
    for (int r = tid; r < 2 * k; r += kThreads) {
        const float* row = cs + r * MAXS;
        float a = 0.f;
        for (int t = 0; t < s; ++t) a = __fadd_rn(a, __fmul_rn(row[t], row[t]));
        hn[r] = -0.5f * a;
        atomicMax(&cmax_bits[r / k], __float_as_uint(a != a ? CUDART_INF_F : a));
    }
    __syncthreads();
    const float hmu = 0.5f * mu;

    int nre = 0;
    const int start = blockIdx.x * chunk, end = min(start + chunk, n);
    for (int t0 = start, par = 0; t0 < end; t0 += kTile, par ^= 1) {
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            const long long r0 = h ? half1 : half0;
            float xv[PTS][MAXS], nx[PTS], m1[PTS], m2[PTS];
            float* scr[PTS];
            int j1[PTS];
#pragma unroll
            for (int q = 0; q < PTS; ++q) {
                const int p = t0 + q * kThreads + tid;
                if (p < end) {
                    load_point<MAXS>(x + (r0 + p) * s, s, xv[q]);
                } else {
#pragma unroll
                    for (int t = 0; t < MAXS; ++t) xv[q][t] = 0.f;
                }
                float sq = 0.f;  // any order: it sets only the margin
#pragma unroll
                for (int t = 0; t < MAXS; ++t) sq = __fmaf_rn(xv[q][t], xv[q][t], sq);
                nx[q] = sq;
                scr[q] = PROBE && screen && p < end ? screen + (r0 + p) * k : nullptr;
            }
            pair_screen<MAXS, PTS, PROBE>(xv, cs + h * k * MAXS, hn + h * k, k, m1, m2, j1, scr);
            const float cmax = __uint_as_float(cmax_bits[h]);
#pragma unroll
            for (int q = 0; q < PTS; ++q) {
                const int at = q * kThreads + tid;
                if (t0 + at >= end) continue;
                const float np = __fadd_rn(nx[q], cmax);
                if (screen_covers(np) && !(m2[q] >= m1[q] - hmu * np))
                    sel[h * kTile + at] = j1[q];
                else
                    queue[atomicAdd(&qn[par], 1)] = 2 * at + h;
            }
        }
        __syncthreads();
        if (tid == 0) qn[par ^ 1] = 0;  // the next tile's; last read before this tile began
        const int nq = qn[par];
        // the queue: every centroid of each queued (point, half), by a warp
        for (int e = warp; e < nq; e += kWarps) {
            const int at = queue[e] >> 1, h = queue[e] & 1;
            const float* xr = x + ((h ? half1 : half0) + t0 + at) * s;
            const float* ch = cs + h * k * MAXS;
            unsigned long long key = ~0ull;
            for (int j = lane; j < k; j += 32)
                key = min_key(key, dist_key(plain_dist<1>(xr, ch + j * MAXS, s), j));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                key = min_key(key, __shfl_xor_sync(0xffffffffu, key, o));
            if (lane == 0) sel[h * kTile + at] = (int)(unsigned)(key & 0xffffffffu);
        }
        nre += nq;
        __syncthreads();
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            const int at = q * kThreads + tid, p = t0 + at;
            if (p >= end) continue;
            const int a1 = sel[at], a2 = sel[kTile + at];
            assign[half0 + p] = a1;
            assign[half1 + p] = a2;
            atomicAdd(&hist[a1 * k + a2], 1);
        }
    }
    __syncthreads();
    for (int u = tid; u < k * k; u += kThreads)
        if (hist[u]) atomicAdd(&counts[(long long)i * k * k + u], hist[u]);
    if (PROBE && rechecks && tid == 0) rechecks[(long long)i * gridDim.x + blockIdx.x] = nre;
}

template <int MAXS, bool PROBE>
int launch_pair_v(const float* x, const float* c, int ns, int n, int k, int s, float mu,
                  int* assign, int* counts, int* rechecks, float* screen, cudaStream_t stream) {
    constexpr long long kTile = pair_pts(MAXS) * kThreads;
    auto kern = kmeans_pair_assign_hist_kernel<MAXS, PROBE>;
    const size_t smem = pair_smem_bytes(k, MAXS);
    cudaError_t e = allow_smem(kern, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    // one wave: the card's resident blocks shared among the subspaces, each
    // block a run of whole tiles
    const long long tiles = (n + kTile - 1) / kTile;
    const long long slots = (long long)sms * std::max(per_sm, 1);
    const long long per_sub = std::max(1LL, std::min(tiles, (slots + ns - 1) / ns));
    const long long chunk = (tiles + per_sub - 1) / per_sub * kTile;
    kern<<<dim3((unsigned)((n + chunk - 1) / chunk), ns), kThreads, smem, stream>>>(
        x, c, ns, n, k, s, (int)chunk, mu, assign, counts, rechecks, screen);
    return (int)cudaGetLastError();
}

// The IMI histogram from the argmins of both halves (assign (2ns, n)):
// cells a1 * k + a2 of each subspace into counts (zeroed by the caller)
// with device-memory atomics (grid: blocks x subspaces).
__global__ void __launch_bounds__(kThreads)
kmeans_pair_hist_kernel(const int* __restrict__ assign, int ns, int n, int k,
                        int* __restrict__ counts) {
    const int i = blockIdx.y;
    int* out = counts + i * (long long)k * k;
    const int* a1 = assign + (long long)i * n;
    const int* a2 = assign + (long long)(ns + i) * n;
    for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < n;
         p += (long long)gridDim.x * kThreads)
        atomicAdd(&out[(long long)a1[p] * k + a2[p]], 1);
}

// Kernel 4 past the narrow kernel: the screened kernel's argmins of all 2ns
// codebooks (mu: kernel.screen_margin; norms 2ns*k + 2ns floats of
// scratch), then the histogram, two blocks an SM over the subspaces.
int launch_pair_wide(const float* x, const float* c, int ns, int n, int k, int s, float mu,
                     float* norms, int* assign, int* counts, cudaStream_t stream) {
    int e = launch_assign_streamed(x, c, 2 * ns, n, k, s, mu, norms, assign, nullptr, nullptr,
                                   nullptr, stream);
    if (e != (int)cudaSuccess) return e;
    int dev = 0, sms = 0;
    cudaError_t ce = cudaGetDevice(&dev);
    if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce != cudaSuccess) return (int)ce;
    const long long need = ((long long)n + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)std::min<long long>(need, std::max(1, 2 * sms / ns)), ns);
    kmeans_pair_hist_kernel<<<grid, kThreads, 0, stream>>>(assign, ns, n, k, counts);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of a narrow statistics block, in bytes (at most INT_MAX):
// the op wrapper takes the wide variant past the card's limit.
extern "C" int kmeans_stats_smem_bytes(int k, int s) {
    return (int)std::min<size_t>(stats_smem_bytes(k, s), INT_MAX);
}

// `wide` (chosen by the op wrapper from the shape) takes the screened
// kernel's argmins and d* (mu its margin factor, kernel.screen_margin; norms
// B*k + B floats and best B*n floats of scratch; assign then not null) and
// the ranked accumulation; otherwise the register/shared-memory kernel for
// s <= 64.
extern "C" int kmeans_stats(const float* x, const float* c, int B, int n, int k,
                            int s, int block_n, float* part_sums, float* part_counts,
                            float* part_inertia, float* sums, float* counts, float* inertia,
                            int* assign, int wide, float mu, float* norms, float* best,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide)
        return launch_stats_wide(x, c, B, n, k, s, block_n, mu, norms, best, part_sums,
                                 part_counts, part_inertia, sums, counts, inertia, assign, st);
#define REPRO_STATS(M) \
    return launch_stats<M>(x, c, B, n, k, s, block_n, part_sums, part_counts, part_inertia, \
                           sums, counts, inertia, assign, st)
    if (s <= 4) REPRO_STATS(4);
    if (s <= 8) REPRO_STATS(8);
    if (s <= 16) REPRO_STATS(16);
    if (s <= 32) REPRO_STATS(32);
    if (s <= 64) REPRO_STATS(64);
#undef REPRO_STATS
    return (int)cudaErrorInvalidValue;
}

// Shared memory of a narrow pair block at (k, s <= 64), in bytes (at most
// INT_MAX): the op wrapper takes the wide variant past the card's limit.
extern "C" int kmeans_pair_smem_bytes(int k, int s) {
    return (int)std::min<size_t>(pair_smem_bytes(k, pair_maxs(s)), INT_MAX);
}

// `wide` (chosen by the op wrapper from the shape): the screened kernel's
// argmins and the histogram kernel (mu: kernel.screen_margin; norms 2ns*k +
// 2ns floats of scratch); otherwise the FFMA screen at s <= 64 (mu:
// kernel.narrow_margin), its PROBE instantiation when rechecks or screen is
// not null.  counts zeroed by the caller.
extern "C" int kmeans_pair_assign_hist(const float* x, const float* c, int ns, int n, int k, int s,
                                       int* assign, int* counts, int wide, float mu, float* norms,
                                       int* rechecks, float* screen, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide) return launch_pair_wide(x, c, ns, n, k, s, mu, norms, assign, counts, st);
    if (s > 64) return (int)cudaErrorInvalidValue;
    const bool probe = rechecks || screen;
#define REPRO_PAIR(M)                                                                           \
    return probe ? launch_pair_v<M, true>(x, c, ns, n, k, s, mu, assign, counts, rechecks,      \
                                          screen, st)                                           \
                 : launch_pair_v<M, false>(x, c, ns, n, k, s, mu, assign, counts, rechecks,     \
                                           screen, st)
    switch (pair_maxs(s)) {
        case 4: REPRO_PAIR(4);
        case 8: REPRO_PAIR(8);
        case 16: REPRO_PAIR(16);
        case 32: REPRO_PAIR(32);
        default: REPRO_PAIR(64);
    }
#undef REPRO_PAIR
    return (int)cudaErrorInvalidValue;
}

// wide: the screened kernel (block_n then only bounds the plain version's
// chunks: its blocks take kBM points each); mu is the margin's factor
// (kernel.screen_margin), norms B*k + B floats of scratch, rechecks, screen
// and best null except in the checks.
extern "C" int kmeans_assign_batched(const float* x, const float* c, int B, int n, int k, int s,
                                     int* assign, int wide, float mu, float* norms,
                                     int* rechecks, float* screen, float* best, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide)
        return launch_assign_streamed(x, c, B, n, k, s, mu, norms, assign, rechecks, screen, best,
                                      st);
    if (s > 64) return (int)cudaErrorInvalidValue;
    return launch_assign_narrow(x, c, B, n, k, s, mu, assign, rechecks, screen, best, st);
}

// Shared memory of a narrow assignment block at (k, s <= 64), in bytes (at
// most INT_MAX): the op wrapper takes the screened kernel past the card's
// limit.
extern "C" int kmeans_assign_narrow_smem_bytes(int k, int s) {
    return (int)std::min<size_t>(narrow_smem_bytes(k, narrow_ks(s)), INT_MAX);
}

extern "C" int kmeans_assign(const float* x, const float* c, int n, int k, int s, float mu,
                             float* norms, int* assign, void* stream) {
    return launch_assign_streamed(x, c, 1, n, k, s, mu, norms, assign, nullptr, nullptr, nullptr,
                                  static_cast<cudaStream_t>(stream));
}
