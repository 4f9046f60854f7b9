// Batched K-means passes of the SuCo build: Lloyd statistics and the final
// paired assignment with the IMI occupancy histogram.
//
// Replaces two TPU kernels of src/repro/kernels/kmeans_assign/kernel.py:
//
// * kmeans_stats_kernel (_accumulate_stats, _stats_kernel,
//   _stats_only_kernel): per codebook b and point p, the nearest centroid
//   a = argmin_j ||x[b,p] - c[b,j]||^2, then sums[b,a] += x, counts[b,a] += 1,
//   inertia[b] += min distance; optionally the assignments themselves.  (The
//   TPU kernel weights padded points 0; here the grid covers exactly n points.)
// * kmeans_pair_assign_hist_kernel (_pair_assign_hist_kernel): argmins of
//   both halves of each subspace (codebooks i and Ns+i) and the IMI
//   occupancy counts[i, a1*k + a2].
//
// What bounds them on an H100: operations.  Each point does 3*k*s fp32
// operations (difference, square, sum) against 4*s bytes of input, about
// 0.75*k operations per byte: ~37 at k=50, above the card's ~20 fp32
// operations per byte.  Design: grid (points / block_n, codebooks); one
// codebook's centroids (both halves' for the pair kernel) sit in shared
// memory, where every thread reads the same centroid at once (a broadcast);
// each thread takes one point, holds it in registers and scans the
// centroids in index order with a strict <, so ties go to the lowest index
// as with jnp.argmin / torch.argmin.  The distance is summed one dim at a
// time with __fsub_rn/__fmul_rn/__fadd_rn (no FMA contraction): exactly the
// arithmetic of the plain PyTorch version, so assignments agree bit for bit.
//
// No float atomics, so every result is the same from run to run.  The stats
// kernel writes per-block partial sums, counts and inertia (each block
// accumulates its tiles in a fixed order, one thread per (centroid, dim)
// pair), and a second kernel reduces the partials over the blocks in block
// order.  The pair kernel's histogram uses integer atomics in shared memory
// and then in device memory, which are exact.
//
// C entry points (each returns cudaGetLastError(); a point holds at most
// 64 dims in registers, which the op wrapper checks):
//   kmeans_stats(...), kmeans_pair_assign_hist(...).

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

// Sum the per-block partials over the blocks, in block order.
__global__ void __launch_bounds__(kThreads)
kmeans_stats_reduce_kernel(const float* __restrict__ part_sums, const float* __restrict__ part_counts,
                           const float* __restrict__ part_inertia, int nblk, int k, int s,
                           float* __restrict__ sums, float* __restrict__ counts,
                           float* __restrict__ inertia) {
    const int b = blockIdx.x;
    const int ks = k * s;
    for (int u = threadIdx.x; u < ks + k + 1; u += kThreads) {
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
    kmeans_stats_reduce_kernel<<<B, kThreads, 0, stream>>>(part_sums, part_counts, part_inertia,
                                                           nblk, k, s, sums, counts, inertia);
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

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int kmeans_stats(const float* x, const float* c, int B, int n, int k,
                            int s, int block_n, float* part_sums, float* part_counts,
                            float* part_inertia, float* sums, float* counts, float* inertia,
                            int* assign, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
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
                                       int block_n, int* assign, int* counts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAIR(M) return launch_pair<M>(x, c, ns, n, k, s, block_n, assign, counts, st)
    if (s <= 4) REPRO_PAIR(4);
    if (s <= 8) REPRO_PAIR(8);
    if (s <= 16) REPRO_PAIR(16);
    if (s <= 32) REPRO_PAIR(32);
    if (s <= 64) REPRO_PAIR(64);
#undef REPRO_PAIR
    return (int)cudaErrorInvalidValue;
}
