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
// * kmeans_assign_batched_kernel (_batched_kernel): the argmin of every
//   point against its own codebook, nothing else.
// * kmeans_assign_kernel (_kernel): the argmin of one problem, (n, s)
//   against (k, s), at any width s and any k: kmeans_assign_streamed_kernel
//   at one codebook.
//
// What bounds them on an H100: operations.  Each (point, centroid) pair
// costs 3*s fp32 operations (difference, square, sum) against 4*s bytes of
// the point, about 0.75*k operations per byte: ~37 at k=50 and ~190 at
// k=256, above the card's ~20 fp32 operations per byte.
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
// Beside each of the three sits a wide variant, which the op wrapper picks
// for any other shape (s > 64, or k*s -- for the pair kernel also k^2 --
// past shared memory): it finds each point's centroid as kernel 6 does
// below (nearest_streamed), walking its chunk in tiles of 256 points.  The
// wide assignment is kernel 6's own kernel, kmeans_assign_streamed_kernel,
// over B codebooks.  The
// wide stats kernel keeps its per-block partial sums and counts in device
// memory (only its own block writes them), adding each tile's points in
// index order as the narrow one does, so both give the same bits; the wide
// pair kernel adds its k^2 histogram straight into device memory with
// integer atomics.
//
// kmeans_assign_streamed_kernel takes a point of any width and a codebook
// of any size, which need not fit in shared memory (k=1024, s=128 is
// 512 KB).  A block walks its points 256 at a time, one a thread; the centroids stream through
// shared memory in tiles of 32 centroids x 32 dims.  For each tile of
// centroids a thread keeps 32 running sums in registers and walks the dim
// slices in order, loading its point's 32 dims of the slice into registers:
// each distance is still summed dim 0, 1, ..., s-1.  (Padded dims of the
// last slice are 0 in both point and centroid and add +0, which leaves a
// sum unchanged.)  Tiles of centroids are visited in index order and a
// thread takes a later centroid only on a strict <, so its (distance,
// index) minimum is the lexicographic one: the lowest index wins ties.
//
// Every distance is summed one dim at a time with __fsub_rn/__fmul_rn/
// __fadd_rn (no FMA contraction): exactly the arithmetic of the plain
// PyTorch versions, so assignments agree bit for bit.
//
// No float atomics, so every result is the same from run to run.  The stats
// kernel writes per-block partial sums, counts and inertia (each block
// accumulates its tiles in a fixed order, one thread per (centroid, dim)
// pair), and a second kernel reduces the partials over the blocks in block
// order.  The pair kernel's histogram uses integer atomics in shared memory
// and then in device memory, which are exact.
//
// C entry points (each returns cudaGetLastError()):
//   kmeans_stats(..., wide, stream), kmeans_pair_assign_hist(..., wide, stream),
//   kmeans_assign_batched(..., wide, stream), kmeans_assign(...).

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

constexpr int kTileK = 32;  // centroids per shared-memory tile of the streamed kernels
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

// Nearest centroid of every point against its own codebook, any width and
// any k (grid: chunks of block_n points x codebooks).  Kernel 6 is this at
// B = 1 and block_n = kThreads; kernel 5 takes it for its wide shapes.
__global__ void __launch_bounds__(kThreads)
kmeans_assign_streamed_kernel(const float* __restrict__ x,  // (B, n, s)
                              const float* __restrict__ c,  // (B, k, s)
                              int n, int k, int s, int block_n,
                              int* __restrict__ assign)     // (B, n)
{
    __shared__ float cs[kTileK][kTileS];
    const int b = blockIdx.y;
    const int start = blockIdx.x * block_n;
    const int end = min(start + block_n, n);
    for (int t0 = start; t0 < end; t0 += kThreads) {
        const int p = t0 + threadIdx.x;
        const bool live = p < end;
        float best;
        const int bi = nearest_streamed(x + ((long long)b * n + (live ? p : start)) * s, live,
                                        c + (long long)b * k * s, k, s, cs, &best);
        if (live) assign[(long long)b * n + p] = bi;
    }
}

int launch_assign_streamed(const float* x, const float* c, int B, int n, int k, int s,
                           int block_n, int* assign, cudaStream_t stream) {
    const int nblk = (n + block_n - 1) / block_n;
    kmeans_assign_streamed_kernel<<<dim3(nblk, B), kThreads, 0, stream>>>(
        x, c, n, k, s, block_n, assign);
    return (int)cudaGetLastError();
}

// ---- wide variants of kernels 3-5: any width s and any k ------------------
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

extern "C" int kmeans_assign_batched(const float* x, const float* c, int B, int n, int k, int s,
                                     int block_n, int* assign, int wide, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide) return launch_assign_streamed(x, c, B, n, k, s, block_n, assign, st);
#define REPRO_ASSIGN(M) return launch_assign_batched<M>(x, c, B, n, k, s, block_n, assign, st)
    if (s <= 4) REPRO_ASSIGN(4);
    if (s <= 8) REPRO_ASSIGN(8);
    if (s <= 16) REPRO_ASSIGN(16);
    if (s <= 32) REPRO_ASSIGN(32);
    if (s <= 64) REPRO_ASSIGN(64);
#undef REPRO_ASSIGN
    return (int)cudaErrorInvalidValue;
}

extern "C" int kmeans_assign(const float* x, const float* c, int n, int k, int s, int* assign,
                             void* stream) {
    return launch_assign_streamed(x, c, 1, n, k, s, kThreads, assign,
                                  static_cast<cudaStream_t>(stream));
}
