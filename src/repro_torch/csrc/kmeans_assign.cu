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
//   occupancy counts[i, a1*k + a2].
// * kmeans_assign_batched_kernel (kernel.py:93, _batched_kernel): the argmin
//   of every point against its own codebook, nothing else.
// * kmeans_assign_kernel (kernel.py:52, _kernel): the argmin of one
//   problem, (n, s) against (k, s), at any width s and any k.
//
// The last two share kmeans_assign_streamed_kernel: kernel 6 at one
// codebook, kernel 5 at its wide shapes (s > 64, or a codebook past shared
// memory).  It is a tensor-core screen with an exact re-check (below).
//
// What bounds the SIMT kernels on an H100: operations.  Each (point,
// centroid) pair costs 3*s fp32 operations (difference, square, sum) against
// 4*s bytes of the point, about 0.75*k operations per byte: ~37 at k=50 and
// ~190 at k=256, above the card's ~20 fp32 operations per byte.  Summed as
// three separate instructions (no FMA), they issue at ~33.5 T/s (132 SMs x
// 128 lanes x 1.98 GHz), so no kernel built that way runs row 6 (1M x 128,
// k = 1,024) below ~11.7 ms.
//
// The first three take one codebook per grid row (grid: points / block_n x
// codebooks); the codebook's centroids (both halves' for the pair kernel)
// sit in shared memory, where every thread reads the same centroid at once
// (a broadcast); each thread takes one point, holds it in registers (at
// most 64 dims) and scans the centroids in index order with a strict <, so
// ties go to the lowest index as with jnp.argmin / torch.argmin.  These
// narrow instantiations (MAXS 4..64) take s <= 64 and a codebook that fits
// in shared memory.
//
// Beside the stats and pair kernels sits a wide variant, which the op
// wrapper picks for any other shape (s > 64, or k*s -- for the pair kernel
// also k^2 -- past shared memory): it walks its chunk in tiles of 256
// points, one a thread, and finds each point's centroid with
// nearest_streamed: the centroids stream through shared memory in tiles of
// 32 centroids x 32 dims, a thread keeps 32 running sums in registers and
// walks the dim slices in order, so each distance is still summed dim 0, 1,
// ..., s-1 (padded dims add +0); tiles are visited in index order and a
// later centroid wins only on a strict <.  The wide stats kernel keeps its
// per-block partial sums and counts in device memory (only its own block
// writes them), adding each tile's points in index order as the narrow one
// does, so both give the same bits; the wide pair kernel adds its k^2
// histogram straight into device memory with integer atomics.
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
//   far below the 3/4 of delta_p to spare; inputs are finite and their
//   squares do not overflow.)
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
// No float atomics, so every result is the same from run to run.  The stats
// kernel writes per-block partial sums, counts and inertia (each block
// accumulates its tiles in a fixed order, one thread per (centroid, dim)
// pair), and a second kernel reduces the partials over the blocks in block
// order.  The pair kernel's histogram uses integer atomics in shared memory
// and then in device memory, which are exact; the screened kernel's key
// atomics take a minimum, which does not depend on their order.
//
// C entry points (each returns cudaGetLastError()):
//   kmeans_stats(..., wide, stream), kmeans_pair_assign_hist(..., wide, stream),
//   kmeans_assign_batched(..., wide, mu, norms, rechecks, screen, stream),
//   kmeans_assign(..., mu, norms, assign, stream).

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

template <int MAXS>
__device__ __forceinline__ void load_point(const float* __restrict__ row, int s, float (&xv)[MAXS]) {
#pragma unroll
    for (int t = 0; t < MAXS; ++t) xv[t] = t < s ? row[t] : 0.f;
}

// Nearest centroid of one point: strict < in index order (lowest index wins
// ties); each distance summed dim by dim without FMA contraction.
template <int MAXS>
__device__ __forceinline__ int nearest(const float (&xv)[MAXS], const float* cs, int k, int s,
                                       float* best_out) {
    float best = CUDART_INF_F;
    int bi = 0;
    for (int j = 0; j < k; ++j) {
        const float* cj = cs + j * s;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < MAXS; ++t) {
            if (t < s) {
                const float e = __fsub_rn(xv[t], cj[t]);
                acc = __fadd_rn(acc, __fmul_rn(e, e));
            }
        }
        if (acc < best) {
            best = acc;
            bi = j;
        }
    }
    *best_out = best;
    return bi;
}

// Shared memory of the stats kernel: centroids (k*s), accumulators
// (k*(s+1): sums then the count), and one tile of kThreads points
// (best distance, coordinates, assignment).
__host__ __device__ inline size_t stats_smem_bytes(int k, int s) {
    return sizeof(float) * ((size_t)k * s + (size_t)k * (s + 1) + (size_t)kThreads * (s + 1)) +
           sizeof(int) * kThreads;
}

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
    extern __shared__ float smem[];
    float* cs = smem;                      // k*s
    float* acc = cs + k * s;               // k*(s+1)
    float* tbest = acc + k * (s + 1);      // kThreads best distances
    float* tx = tbest + kThreads;          // kThreads*s coordinates
    int* ta = reinterpret_cast<int*>(tx + kThreads * s);  // kThreads assignments

    const int blk = blockIdx.x;
    const int nblk = gridDim.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long long xoff = (long long)b * n;

    for (int u = tid; u < k * s; u += kThreads) cs[u] = c[(long long)b * k * s + u];
    for (int u = tid; u < k * (s + 1); u += kThreads) acc[u] = 0.f;
    __syncthreads();

    float inertia = 0.f;  // thread 0 only
    const int start = blk * block_n;
    const int end = min(start + block_n, n);
    for (int t0 = start; t0 < end; t0 += kThreads) {
        const int p = t0 + tid;
        if (p < end) {
            float xv[MAXS];
            load_point<MAXS>(x + (xoff + p) * s, s, xv);
            float best;
            const int bi = nearest<MAXS>(xv, cs, k, s, &best);
            if (assign) assign[xoff + p] = bi;
            ta[tid] = bi;
            tbest[tid] = best;
#pragma unroll
            for (int t = 0; t < MAXS; ++t)
                if (t < s) tx[tid * s + t] = xv[t];
        }
        __syncthreads();
        const int cnt = min(kThreads, end - t0);  // the tile's points, in order
        for (int u = tid; u < k * (s + 1); u += kThreads) {
            const int j = u / (s + 1);
            const int t = u - j * (s + 1);
            float a = acc[u];
            if (t < s) {
                for (int pp = 0; pp < cnt; ++pp)
                    if (ta[pp] == j) a += tx[pp * s + t];
            } else {
                for (int pp = 0; pp < cnt; ++pp)
                    if (ta[pp] == j) a += 1.f;
            }
            acc[u] = a;
        }
        if (tid == 0)
            for (int pp = 0; pp < cnt; ++pp) inertia += tbest[pp];
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

template <int MAXS>
__global__ void __launch_bounds__(kThreads)
kmeans_pair_assign_hist_kernel(const float* __restrict__ x,  // (2ns, n, s)
                               const float* __restrict__ c,  // (2ns, k, s)
                               int ns, int n, int k, int s, int block_n,
                               int* __restrict__ assign,     // (2ns, n)
                               int* __restrict__ counts)     // (ns, k*k), zeroed by the caller
{
    extern __shared__ float smem[];
    float* c1 = smem;                                   // k*s
    float* c2 = c1 + k * s;                             // k*s
    int* hist = reinterpret_cast<int*>(c2 + k * s);     // k*k

    const int i = blockIdx.y;
    const int tid = threadIdx.x;
    for (int u = tid; u < k * s; u += kThreads) {
        c1[u] = c[(long long)i * k * s + u];
        c2[u] = c[(long long)(ns + i) * k * s + u];
    }
    for (int u = tid; u < k * k; u += kThreads) hist[u] = 0;
    __syncthreads();

    const int start = blockIdx.x * block_n;
    const int end = min(start + block_n, n);
    for (int p = start + tid; p < end; p += kThreads) {
        float xv[MAXS];
        float best;
        load_point<MAXS>(x + ((long long)i * n + p) * s, s, xv);
        const int a1 = nearest<MAXS>(xv, c1, k, s, &best);
        load_point<MAXS>(x + ((long long)(ns + i) * n + p) * s, s, xv);
        const int a2 = nearest<MAXS>(xv, c2, k, s, &best);
        assign[(long long)i * n + p] = a1;
        assign[(long long)(ns + i) * n + p] = a2;
        atomicAdd(&hist[a1 * k + a2], 1);
    }
    __syncthreads();
    for (int u = tid; u < k * k; u += kThreads)
        if (hist[u]) atomicAdd(&counts[(long long)i * k * k + u], hist[u]);
}

template <int MAXS>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_batched_kernel(const float* __restrict__ x,  // (B, n, s)
                             const float* __restrict__ c,  // (B, k, s)
                             int n, int k, int s, int block_n,
                             int* __restrict__ assign)     // (B, n)
{
    extern __shared__ float smem[];
    float* cs = smem;  // k*s
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    for (int u = tid; u < k * s; u += kThreads) cs[u] = c[(long long)b * k * s + u];
    __syncthreads();

    const int start = blockIdx.x * block_n;
    const int end = min(start + block_n, n);
    for (int p = start + tid; p < end; p += kThreads) {
        float xv[MAXS];
        float best;
        load_point<MAXS>(x + ((long long)b * n + p) * s, s, xv);
        assign[(long long)b * n + p] = nearest<MAXS>(xv, cs, k, s, &best);
    }
}

constexpr int kTileK = 32;  // centroids per shared-memory tile of the wide stats / pair kernels
constexpr int kTileS = 32;  // dims per slice

// Nearest centroid of one point of any width against a codebook of any size,
// the centroids streamed through `cs` in tiles of kTileK centroids x kTileS
// dims.  Every thread of the block calls it together (it synchronises); a
// thread whose point is not live (`live` false) computes junk for row 0.
// Distances are summed dim 0..s-1 in order, tiles are visited in index order
// and a later centroid wins only on a strict <: the lowest index wins ties.
__device__ __forceinline__ int nearest_streamed(const float* __restrict__ row, bool live,
                                                const float* __restrict__ c, int k, int s,
                                                float (&cs)[kTileK][kTileS], float* best_out) {
    const int tid = threadIdx.x;
    float best = CUDART_INF_F;
    int bi = 0;
    for (int j0 = 0; j0 < k; j0 += kTileK) {
        float acc[kTileK];
#pragma unroll
        for (int j = 0; j < kTileK; ++j) acc[j] = 0.f;
        for (int d0 = 0; d0 < s; d0 += kTileS) {
            __syncthreads();  // every thread is done with the previous slice
            for (int u = tid; u < kTileK * kTileS; u += kThreads) {
                const int j = u / kTileS;
                const int t = u - j * kTileS;
                cs[j][t] = (j0 + j < k && d0 + t < s) ? c[(long long)(j0 + j) * s + d0 + t] : 0.f;
            }
            __syncthreads();
            float xv[kTileS];
#pragma unroll
            for (int t = 0; t < kTileS; ++t) xv[t] = (live && d0 + t < s) ? row[d0 + t] : 0.f;
#pragma unroll
            for (int j = 0; j < kTileK; ++j) {
#pragma unroll
                for (int t = 0; t < kTileS; ++t) {
                    const float e = __fsub_rn(xv[t], cs[j][t]);
                    acc[j] = __fadd_rn(acc[j], __fmul_rn(e, e));
                }
            }
        }
        const int jn = min(kTileK, k - j0);
#pragma unroll
        for (int j = 0; j < kTileK; ++j) {
            if (j < jn && acc[j] < best) {
                best = acc[j];
                bi = j0 + j;
            }
        }
    }
    *best_out = best;
    return bi;
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

// a = big + small + (a residual below 2^-22 |a|): big = rna_tf32(a), small =
// rna_tf32(a - big); a - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
    const float r = __fsub_rn(a, __uint_as_float(big));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// d += a (16 x 8, row) * b (8 x 8, col) on the tensor cores, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
// norms are >= 0, so their bits order as integers).
__global__ void __launch_bounds__(kThreads)
centroid_norms_kernel(const float* __restrict__ c, int B, int k, int s,
                      float* __restrict__ cn, float* __restrict__ cmax) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;  // b * k + j
    if (i >= (long long)B * k) return;
    const float* row = c + i * s;
    float a = 0.f;
    for (int t = 0; t < s; ++t) a = __fadd_rn(a, __fmul_rn(row[t], row[t]));
    cn[i] = a;
    atomicMax(reinterpret_cast<int*>(cmax) + i / k, __float_as_int(a));
}

// Nearest centroid of every point against its own codebook, any width and
// any k, bit-equal to the plain version (grid: tiles of kBM points x
// codebooks).  Kernel 6 is this at B = 1; kernel 5 takes it for its wide
// shapes.  8 warps in 4 (rows) x 2 (centroid columns), each warp a 32 x 32
// corner of the kBM x kBN tile as 2 x 4 m16n8k8 products.  rechecks (null on
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
                              float* __restrict__ screen)      // (B, n, k) if SCREEN
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
                if (tid % kTPP == 0) {
                    xn[tid / kTPP] = v;
                    marg[tid / kTPP] = mu * __fadd_rn(v, cmax[b]);
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
                            if (p < n && j < k && a <= lim) {  // defer, or re-check now
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
                atomicMin(&key[row], ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)j);
                ++nre;
            }
        }
        __syncthreads();  // every thread is done with this stage before it refills
    }

    // the deferred candidates still within the margin of the final m (a
    // point's first candidates spread over the threads)
    for (int u = tid; u < kBM * kL; u += kThreads) {
        const int row = u % kBM, slot = u / kBM, at = row * kL + slot;
        if (slot < lcnt[row] && la[at] <= mrun[row] + marg[row]) {
            const int j = lj[at];
            const float d =
                plain_dist<VEC>(xb + (long long)(p0 + row) * s, cb + (long long)j * s, s);
            atomicMin(&key[row], ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)j);
            ++nre;
        }
    }
    __syncthreads();
    for (int i = tid; i < kBM; i += kThreads)
        if (p0 + i < n) assign[(long long)b * n + p0 + i] = (int)(unsigned)(key[i] & 0xffffffffu);
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
                      float* screen, cudaStream_t stream) {
    auto kern = kmeans_assign_streamed_kernel<VEC, SCREEN>;
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScreenSmem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3((n + kBM - 1) / kBM, B), kThreads, kScreenSmem, stream>>>(
        x, c, cn, cmax, n, k, s, mu, assign, rechecks, screen);
    return (int)cudaGetLastError();
}

// The norms' prologue, then the screened kernel.  norms: B*k + B floats of
// scratch (||c||^2, then each codebook's largest).  screen non-null takes the
// SCREEN instantiation.
int launch_assign_streamed(const float* x, const float* c, int B, int n, int k, int s, float mu,
                           float* norms, int* assign, int* rechecks, float* screen,
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
    return launch_screened_v<V, S>(x, c, cn, cmax, B, n, k, s, mu, assign, rechecks, screen, stream)
    if (screen) {
        if (vec4) REPRO_SCREENED(4, true);
        REPRO_SCREENED(1, true);
    }
    if (vec4) REPRO_SCREENED(4, false);
    REPRO_SCREENED(1, false);
#undef REPRO_SCREENED
}

// ---- wide variants of kernels 3 and 4: any width s and any k -------------
// Grid and outputs as the narrow kernels (chunks of block_n points x
// codebooks); a block walks its chunk in tiles of kThreads points, one a
// thread, and finds each point's centroid with nearest_streamed.  Kernel 5's
// wide variant is kmeans_assign_streamed_kernel above.

__global__ void __launch_bounds__(kThreads)
kmeans_stats_partial_wide_kernel(const float* __restrict__ x,   // (B, n, s)
                                 const float* __restrict__ c,   // (B, k, s)
                                 int n, int k, int s, int block_n,
                                 float* __restrict__ part_sums,     // (B, nblk, k, s)
                                 float* __restrict__ part_counts,   // (B, nblk, k)
                                 float* __restrict__ part_inertia,  // (B, nblk)
                                 int* __restrict__ assign)          // (B, n) or null
{
    __shared__ float cs[kTileK][kTileS];
    __shared__ float tbest[kThreads];
    __shared__ int ta[kThreads];
    const int blk = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long long xoff = (long long)b * n;
    const float* cb = c + (long long)b * k * s;
    // this block's partials live in device memory (k*s need not fit in
    // shared memory); only this block writes them, so no atomics
    const long long pb = (long long)b * gridDim.x + blk;
    float* psums = part_sums + pb * k * s;
    float* pcounts = part_counts + pb * k;
    for (long long u = tid; u < (long long)k * s; u += kThreads) psums[u] = 0.f;
    for (int u = tid; u < k; u += kThreads) pcounts[u] = 0.f;
    __syncthreads();

    float inertia = 0.f;  // thread 0 only
    const int start = blk * block_n;
    const int end = min(start + block_n, n);
    for (int t0 = start; t0 < end; t0 += kThreads) {
        const int p = t0 + tid;
        const bool live = p < end;
        float best;
        const int bi = nearest_streamed(x + (xoff + (live ? p : start)) * s, live, cb, k, s, cs,
                                        &best);
        if (live) {
            if (assign) assign[xoff + p] = bi;
            ta[tid] = bi;
            tbest[tid] = best;
        }
        __syncthreads();
        // the tile's points in order, as the narrow kernel: thread t owns dim
        // t of every centroid (t == s: the counts), so each sum runs over the
        // points in index order
        const int cnt = min(kThreads, end - t0);
        for (int t = tid; t <= s; t += kThreads) {
            for (int pp = 0; pp < cnt; ++pp) {
                const int j = ta[pp];
                if (t < s)
                    psums[(long long)j * s + t] += x[(xoff + t0 + pp) * s + t];
                else
                    pcounts[j] += 1.f;
            }
        }
        if (tid == 0)
            for (int pp = 0; pp < cnt; ++pp) inertia += tbest[pp];
        __syncthreads();
    }
    if (tid == 0) part_inertia[pb] = inertia;
}

__global__ void __launch_bounds__(kThreads)
kmeans_pair_assign_hist_wide_kernel(const float* __restrict__ x,  // (2ns, n, s)
                                    const float* __restrict__ c,  // (2ns, k, s)
                                    int ns, int n, int k, int s, int block_n,
                                    int* __restrict__ assign,     // (2ns, n)
                                    int* __restrict__ counts)     // (ns, k*k), zeroed by the caller
{
    __shared__ float cs[kTileK][kTileS];
    const int i = blockIdx.y;
    const int tid = threadIdx.x;
    const int start = blockIdx.x * block_n;
    const int end = min(start + block_n, n);
    const float* c1 = c + (long long)i * k * s;
    const float* c2 = c + (long long)(ns + i) * k * s;
    for (int t0 = start; t0 < end; t0 += kThreads) {
        const int p = t0 + tid;
        const bool live = p < end;
        const long long row = live ? p : start;
        float best;
        const int a1 = nearest_streamed(x + ((long long)i * n + row) * s, live, c1, k, s, cs, &best);
        const int a2 = nearest_streamed(x + ((long long)(ns + i) * n + row) * s, live, c2, k, s, cs,
                                        &best);
        if (live) {
            assign[(long long)i * n + p] = a1;
            assign[(long long)(ns + i) * n + p] = a2;
            // the k*k histogram need not fit in shared memory: integer adds
            // in device memory, exact in any order
            atomicAdd(&counts[(long long)i * k * k + (long long)a1 * k + a2], 1);
        }
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
    kmeans_stats_reduce_kernel<<<dim3(1, B), kThreads, 0, stream>>>(
        part_sums, part_counts, part_inertia, nblk, k, s, sums, counts, inertia);
    return (int)cudaGetLastError();
}

int launch_stats_wide(const float* x, const float* c, int B, int n, int k, int s, int block_n,
                      float* part_sums, float* part_counts, float* part_inertia, float* sums,
                      float* counts, float* inertia, int* assign, cudaStream_t stream) {
    const int nblk = (n + block_n - 1) / block_n;
    kmeans_stats_partial_wide_kernel<<<dim3(nblk, B), kThreads, 0, stream>>>(
        x, c, n, k, s, block_n, part_sums, part_counts, part_inertia, assign);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // k*s may be large: spread the reduction's outputs over blocks
    const long long outs = (long long)k * s + k + 1;
    const long long blocks = (outs + kThreads - 1) / kThreads;
    const int gx = (int)(blocks < 1024 ? blocks : 1024);
    kmeans_stats_reduce_kernel<<<dim3(gx, B), kThreads, 0, stream>>>(
        part_sums, part_counts, part_inertia, nblk, k, s, sums, counts, inertia);
    return (int)cudaGetLastError();
}

template <int MAXS>
int launch_pair(const float* x, const float* c, int ns, int n, int k, int s, int block_n,
                int* assign, int* counts, cudaStream_t stream) {
    const int nblk = (n + block_n - 1) / block_n;
    const size_t smem = sizeof(float) * 2 * (size_t)k * s + sizeof(int) * (size_t)k * k;
    const cudaError_t e = allow_smem(kmeans_pair_assign_hist_kernel<MAXS>, smem);
    if (e != cudaSuccess) return (int)e;
    kmeans_pair_assign_hist_kernel<MAXS><<<dim3(nblk, ns), kThreads, smem, stream>>>(
        x, c, ns, n, k, s, block_n, assign, counts);
    return (int)cudaGetLastError();
}

template <int MAXS>
int launch_assign_batched(const float* x, const float* c, int B, int n, int k, int s,
                          int block_n, int* assign, cudaStream_t stream) {
    const int nblk = (n + block_n - 1) / block_n;
    const size_t smem = sizeof(float) * (size_t)k * s;
    const cudaError_t e = allow_smem(kmeans_assign_batched_kernel<MAXS>, smem);
    if (e != cudaSuccess) return (int)e;
    kmeans_assign_batched_kernel<MAXS><<<dim3(nblk, B), kThreads, smem, stream>>>(
        x, c, n, k, s, block_n, assign);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `wide` (chosen by the op wrapper from the shape) takes the streamed
// variant; otherwise the register/shared-memory one for s <= 64.
extern "C" int kmeans_stats(const float* x, const float* c, int B, int n, int k,
                            int s, int block_n, float* part_sums, float* part_counts,
                            float* part_inertia, float* sums, float* counts, float* inertia,
                            int* assign, int wide, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide)
        return launch_stats_wide(x, c, B, n, k, s, block_n, part_sums, part_counts,
                                 part_inertia, sums, counts, inertia, assign, st);
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

extern "C" int kmeans_pair_assign_hist(const float* x, const float* c, int ns, int n, int k, int s,
                                       int block_n, int* assign, int* counts, int wide,
                                       void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide) {
        const int nblk = (n + block_n - 1) / block_n;
        kmeans_pair_assign_hist_wide_kernel<<<dim3(nblk, ns), kThreads, 0, st>>>(
            x, c, ns, n, k, s, block_n, assign, counts);
        return (int)cudaGetLastError();
    }
#define REPRO_PAIR(M) return launch_pair<M>(x, c, ns, n, k, s, block_n, assign, counts, st)
    if (s <= 4) REPRO_PAIR(4);
    if (s <= 8) REPRO_PAIR(8);
    if (s <= 16) REPRO_PAIR(16);
    if (s <= 32) REPRO_PAIR(32);
    if (s <= 64) REPRO_PAIR(64);
#undef REPRO_PAIR
    return (int)cudaErrorInvalidValue;
}

// wide: the screened kernel (block_n then only bounds the plain version's
// chunks: its blocks take kBM points each); mu is the margin's factor
// (kernel.screen_margin), norms B*k + B floats of scratch, rechecks and
// screen null except in the checks.
extern "C" int kmeans_assign_batched(const float* x, const float* c, int B, int n, int k, int s,
                                     int block_n, int* assign, int wide, float mu, float* norms,
                                     int* rechecks, float* screen, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide)
        return launch_assign_streamed(x, c, B, n, k, s, mu, norms, assign, rechecks, screen, st);
#define REPRO_ASSIGN(M) return launch_assign_batched<M>(x, c, B, n, k, s, block_n, assign, st)
    if (s <= 4) REPRO_ASSIGN(4);
    if (s <= 8) REPRO_ASSIGN(8);
    if (s <= 16) REPRO_ASSIGN(16);
    if (s <= 32) REPRO_ASSIGN(32);
    if (s <= 64) REPRO_ASSIGN(64);
#undef REPRO_ASSIGN
    return (int)cudaErrorInvalidValue;
}

extern "C" int kmeans_assign(const float* x, const float* c, int n, int k, int s, float mu,
                             float* norms, int* assign, void* stream) {
    return launch_assign_streamed(x, c, 1, n, k, s, mu, norms, assign, nullptr, nullptr,
                                  static_cast<cudaStream_t>(stream));
}
