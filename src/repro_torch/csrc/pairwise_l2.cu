// Pairwise squared L2 distances.
//
// Replaces pairwise_sqdist_kernel (src/repro/kernels/pairwise_l2/kernel.py):
// out[a,b] = max(||q_a||^2 + ||x_b||^2 - 2 q_a.x_b, 0), fp32, for q (m, d),
// x (n, d).  SC-Linear's subspace scan runs it once per subspace, at d = s =
// 16 for SIFT's 128 dims in 8 subspaces, and takes each query's threshold
// from its distances; csrc/sc_score_fused.cu then counts the collisions.
//
// Every distance comes from one device function, tile_sqdist: the norms and
// the cross term are summed one dim at a time, in index order, with
// __fmul_rn/__fadd_rn (no FMA contraction), then combined as
// (qn + xn) - 2*cross and clamped at 0.  The plain PyTorch version
// (kernels/pairwise_l2/ref.py) repeats exactly these elementwise operations
// in the same order, so kernel and plain version agree bit for bit, and the
// SC-score kernel, which re-checks near each threshold in the same
// arithmetic, counts exactly the collisions of these distances.
//
// What bounds it on an H100: at SC-Linear's s = 16 it does ~36 fp32
// operations per output against a 4-byte output write (~9 per byte, below
// the card's ~20): bytes, mostly the (m, n) output.  Design: a plain SIMT
// tile.  A block of 256 threads owns a (32 query rows x 128 data rows)
// output tile; each pass stages 16 dims of its q rows and x rows in shared
// memory (x padded by one word per row, so the column reads of a warp hit 32
// different banks), each thread keeps a 4 x 4 sub-tile of cross terms in
// registers, and 160 threads carry the row norms in shared memory.  A warp
// writes 32 neighbouring floats of an output row: coalesced.  Row strides
// are arguments, so the subspace views of a (n, d) array need no copy.
//
// C entry point (returns cudaGetLastError()):
//   pairwise_sqdist(...).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;   // query rows of a tile
constexpr int kBN = 128;  // data rows of a tile
constexpr int kBK = 16;   // dims staged per pass
constexpr int kRM = kBM / (kThreads / 32);  // 4 query rows per thread
constexpr int kRN = kBN / 32;               // 4 data rows per thread

struct TileSmem {
    float q[kBM][kBK];
    float x[kBN][kBK + 1];
    float qn[kBM];
    float xn[kBN];
};

// Distances of the tile at (row0, col0): thread (ty, tx) gets the rows
// row0 + ty + 8r and the columns col0 + tx + 32j.  Out-of-range rows read
// zeros and their results are not written by the callers.
__device__ __forceinline__ void tile_sqdist(const float* __restrict__ q, long long ldq, int m,
                                            const float* __restrict__ x, long long ldx, int n,
                                            int s, int row0, int col0, TileSmem& sm,
                                            float (&dist)[kRM][kRN]) {
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    float cross[kRM][kRN];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kRN; ++j) cross[r][j] = 0.f;
    // Each norm is owned by one thread from here to its last update, and the
    // loop's first barrier orders this zeroing before any other thread reads.
    if (tid < kBM) sm.qn[tid] = 0.f;
    else if (tid < kBM + kBN) sm.xn[tid - kBM] = 0.f;

    for (int k0 = 0; k0 < s; k0 += kBK) {
        const int kk = min(kBK, s - k0);
        for (int e = tid; e < kBM * kBK; e += kThreads) {
            const int r = e / kBK, c = e % kBK, row = row0 + r;
            sm.q[r][c] = (row < m && c < kk) ? q[(long long)row * ldq + k0 + c] : 0.f;
        }
        for (int e = tid; e < kBN * kBK; e += kThreads) {
            const int r = e / kBK, c = e % kBK, col = col0 + r;
            sm.x[r][c] = (col < n && c < kk) ? x[(long long)col * ldx + k0 + c] : 0.f;
        }
        __syncthreads();
        if (tid < kBM) {
            float a = sm.qn[tid];
            for (int c = 0; c < kk; ++c) a = __fadd_rn(a, __fmul_rn(sm.q[tid][c], sm.q[tid][c]));
            sm.qn[tid] = a;
        } else if (tid < kBM + kBN) {
            const int r = tid - kBM;
            float a = sm.xn[r];
            for (int c = 0; c < kk; ++c) a = __fadd_rn(a, __fmul_rn(sm.x[r][c], sm.x[r][c]));
            sm.xn[r] = a;
        }
        for (int c = 0; c < kk; ++c) {
            float qv[kRM], xv[kRN];
#pragma unroll
            for (int r = 0; r < kRM; ++r) qv[r] = sm.q[ty + 8 * r][c];
#pragma unroll
            for (int j = 0; j < kRN; ++j) xv[j] = sm.x[tx + 32 * j][c];
#pragma unroll
            for (int r = 0; r < kRM; ++r)
#pragma unroll
                for (int j = 0; j < kRN; ++j)
                    cross[r][j] = __fadd_rn(cross[r][j], __fmul_rn(qv[r], xv[j]));
        }
        __syncthreads();  // the tiles are overwritten by the next pass
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
            const float t = __fadd_rn(sm.qn[ty + 8 * r], sm.xn[tx + 32 * j]);
            dist[r][j] = fmaxf(__fsub_rn(t, __fmul_rn(2.f, cross[r][j])), 0.f);
        }
    __syncthreads();  // the norms are zeroed again by the next call
}

__global__ void __launch_bounds__(kThreads)
pairwise_sqdist_kernel(const float* __restrict__ q, long long ldq,  // (m, d)
                       const float* __restrict__ x, long long ldx,  // (n, d)
                       int m, int n, int d,
                       float* __restrict__ out)                     // (m, n)
{
    __shared__ TileSmem sm;
    const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
    float dist[kRM][kRN];
    tile_sqdist(q, ldq, m, x, ldx, n, d, row0, col0, sm, dist);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
        const int row = row0 + ty + 8 * r;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
            const int col = col0 + tx + 32 * j;
            if (col < n) out[(long long)row * n + col] = dist[r][j];
        }
    }
}

dim3 tile_grid(int m, int n) { return dim3((n + kBN - 1) / kBN, (m + kBM - 1) / kBM); }

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int pairwise_sqdist(const float* q, long long ldq, const float* x, long long ldx,
                               int m, int n, int d, float* out, void* stream) {
    pairwise_sqdist_kernel<<<tile_grid(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, ldq, x, ldx, m, n, d, out);
    return (int)cudaGetLastError();
}
