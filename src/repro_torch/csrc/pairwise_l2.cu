// Pairwise squared L2 distances: each point read once and held in
// registers, the queries broadcast from shared memory.
//
// Replaces pairwise_sqdist_kernel (src/repro/kernels/pairwise_l2/kernel.py:49,
// its pallas_call at :63): out[a,b] = max(||q_a||^2 + ||x_b||^2 - 2 q_a.x_b, 0),
// fp32, for q (m, d), x (n, d).  SC-Linear's subspace scan runs it once per
// subspace, at d = s = 16 for SIFT's 128 dims in 8 subspaces, and takes each
// query's threshold from its distances; csrc/sc_score_fused.cu then counts
// the collisions, re-checking the pairs near each threshold in this
// arithmetic.
//
// Arithmetic (the plain version's, kernels/pairwise_l2/ref.py, bit for bit):
// the norms and the cross term are summed one dim at a time, in index order
// from +0, with __fmul_rn / __fadd_rn (no FMA contraction), then combined as
// (qn + xn) - 2 cross and clamped at 0 as torch.clamp_min does: a NaN stays
// NaN (fmaxf would turn it into 0), so NaN and inf coordinates give the
// plain version's NaN and inf.
//
// What bounds it on an H100.  At SC-Linear's shape (m = 64, n = 1M, s = 16)
// the bytes: the (m, n) fp32 output written once (256 MB) and x read once
// (64 MB), 0.0955 ms at 3.35 TB/s.  The fixed order forbids FMA, so an output
// costs 16 FMUL + 16 FADD and ~5 instructions to combine and clamp: ~2.4 G
// fp32 instructions, ~0.07 ms at 132 SMs x 128 lanes x 1.98 GHz, three
// quarters of the bytes.  So the arithmetic has to run under the stores, with
// few instructions besides it.  Measured on an H100 (PERF.md), x's 64-byte
// rows, 512 bytes apart in SC-Linear's (n, 128) data, read at ~1.8 TB/s and
// the writes stream at ~2.8 TB/s: this design's copies and stores alone take
// 0.129 ms at m = 64, and the arithmetic adds ~0.02 ms under them.
//
// Design.  A block of kThreads = 128 threads owns kPoints = 512 adjacent
// points and a group of up to kQ = 64 queries (SC-Linear's batch): the work
// index blockIdx.x is tile * groups + group, so the groups of one point tile
// (m > 64) run adjacent and read their x from L2; at m <= 64 every x row is
// read from device memory once.  (The SIMT tile this replaces served 32
// queries a block, so at m = 64 two blocks 7,813 launches apart read each x
// row, and at m = 8 it computed 24 rows of zeros.)
//   A thread owns kP = 4 adjacent points.  It loads their coordinates once
//   into registers (16-byte copies where the view starts on a 16-byte
//   boundary and its row stride is a multiple of 4 floats, VEC = 4; else
//   4-byte copies, VEC = 1) and sums their norms once.  The group's queries
//   are staged in shared memory with their norms (one thread a row, dims in
//   order) behind the block's only barrier; a thread reads them as
//   broadcasts, one 16-byte load feeding 4 dims x 4 points.  No barrier in
//   the main loop: a thread advances kG = 2 queries x 4 points = 8
//   independent sums together (FADD latency covered without FMA, at 120
//   registers without spills; 4 queries spilled at 128 and ran slower), then
//   writes its 4 points of each query with one 16-byte streaming store
//   (n % 4 == 0; else, and in a ragged last tile, 4-byte stores): a warp's
//   store covers 512 contiguous bytes of a row, which the caller's selection
//   reads once.
//   Widths s <= 16 (kK) take one slab: coordinates past s are zeros, whose
//   +0 products change no bit.  Wider subspaces take ceil(s / 16) slabs; the
//   x slab is reloaded for each 2 queries and the query slab read from device
//   memory (L1), so each (query, point) still sums c = 0 .. s - 1 in order.
//   These widths (GIST's s = 120, the tests' 130) need only be exact.
//   (A persistent grid that copied each block's next points into shared
//   memory by cp.async under the arithmetic ran 16% slower on an H100.)
//
// Limits (the op refuses past them before any launch): m <= kMaxRows and
// n <= kMaxPoints keep every row and column index a C int (output offsets are
// 64-bit); a launch takes at most INT_MAX blocks, one a work item (its grid's
// x extent).
//
// C entry point (returns cudaGetLastError(), or cudaErrorInvalidValue past
// the limits):
//   pairwise_sqdist(q, ldq, x, ldx, m, n, d, vec, out, stream).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // threads of a block
constexpr int kP = 4;                   // adjacent points of a thread
constexpr int kPoints = kThreads * kP;  // points of a block: 512
constexpr int kQ = 64;                  // queries of a block (a group)
constexpr int kG = 2;                   // queries a thread advances together
constexpr int kK = 16;                  // dims of a slab
constexpr int kMaxRows = INT_MAX - kQ + 1, kMaxPoints = INT_MAX - kPoints + 1;

// The distance from a (query, point)'s norms and cross term: the plain
// version's (qn + xn) - 2 cross, clamped at 0 as torch.clamp_min does (the
// comparison is false for a NaN, which passes through).
__device__ __forceinline__ float combine(float qn, float xn, float cross) {
    const float d = __fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, cross));
    return d < 0.f ? 0.f : d;
}

// Dims k0 .. k0 + 15 of the points b0 .. b0 + kP - 1 into registers: zeros
// past s and past n.  VEC = 4 copies each 4 dims that lie below s with one
// 16-byte load (the caller has checked the view's alignment).
template <int VEC>
__device__ __forceinline__ void load_slab(const float* __restrict__ x, long long ldx, int n,
                                          int s, int b0, int k0, float (&xv)[kP][kK]) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        const bool live = b0 + p < n;
        const float* row = x + (long long)(b0 + p) * ldx + k0;
#pragma unroll
        for (int c = 0; c < kK; c += 4) {
            if (VEC == 4 && k0 + c + 4 <= s) {
                const float4 v = live ? __ldg(reinterpret_cast<const float4*>(row + c))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
                xv[p][c] = v.x, xv[p][c + 1] = v.y, xv[p][c + 2] = v.z, xv[p][c + 3] = v.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    xv[p][c + e] = (live && k0 + c + e < s) ? __ldg(row + c + e) : 0.f;
            }
        }
    }
}

// Adds dims c .. c + 3 of kG queries (qv) and the thread's points to the
// cross terms, dim by dim: each sum stays in index order.
__device__ __forceinline__ void add_cross(const float4 (&qv)[kG], const float (&xv)[kP][kK],
                                          int c, float (&cross)[kG][kP]) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
        const float qc[4] = {qv[j].x, qv[j].y, qv[j].z, qv[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int p = 0; p < kP; ++p)
                cross[j][p] = __fadd_rn(cross[j][p], __fmul_rn(qc[e], xv[p][c + e]));
    }
}

// Writes the distances of query row `row` (of m) to the thread's points;
// streaming stores (the output is read once, by the caller's selection).
__device__ __forceinline__ void store_row(float* __restrict__ out, int n, long long row, int b0,
                                          float qn, const float (&xn)[kP],
                                          const float (&cross)[kP]) {
    float d[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) d[p] = combine(qn, xn[p], cross[p]);
    float* dst = out + row * n + b0;
    if ((n & 3) == 0 && b0 + kP <= n) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(d[0], d[1], d[2], d[3]));
    } else {
#pragma unroll
        for (int p = 0; p < kP; ++p)
            if (b0 + p < n) dst[p] = d[p];
    }
}

// ONE: s <= kK, one slab, the points' coordinates loaded once and the
// queries staged in shared memory; else ceil(s / kK) slabs.
template <int VEC, bool ONE>
__global__ void __launch_bounds__(kThreads, 4)
pairwise_sqdist_kernel(const float* __restrict__ q, long long ldq,  // (m, s)
                       const float* __restrict__ x, long long ldx,  // (n, s)
                       int m, int n, int s, int groups,
                       float* __restrict__ out)                     // (m, n)
{
    __shared__ __align__(16) float sq[ONE ? kQ : 1][kK];  // the group's rows, zeros past s
    __shared__ float sqn[kQ];                              // their norms
    const int tile = blockIdx.x / groups, group = blockIdx.x % groups;
    const int a0 = group * kQ, rows = min(kQ, m - a0);
    const int b0 = tile * kPoints + threadIdx.x * kP;

    // the points: coordinates (one slab) and norms, summed dim by dim from +0
    float xv[kP][kK], xn[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) xn[p] = 0.f;
    for (int k0 = 0; k0 < s; k0 += kK) {
        load_slab<VEC>(x, ldx, n, s, b0, k0, xv);
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int c = 0; c < kK; ++c) xn[p] = __fadd_rn(xn[p], __fmul_rn(xv[p][c], xv[p][c]));
    }
    // the queries: norms (one thread a row), and for ONE the rows themselves
    for (int r = threadIdx.x; r < kQ; r += kThreads) {
        float a = 0.f;
        if (r < rows) {
            const float* row = q + (long long)(a0 + r) * ldq;
            for (int c = 0; c < s; ++c) a = __fadd_rn(a, __fmul_rn(row[c], row[c]));
        }
        sqn[r] = a;
    }
    if (ONE)
        for (int e = threadIdx.x; e < kQ * kK; e += kThreads) {
            const int r = e / kK, c = e % kK;
            sq[r][c] = (r < rows && c < s) ? q[(long long)(a0 + r) * ldq + c] : 0.f;
        }
    __syncthreads();

    for (int g = 0; g < rows; g += kG) {  // rows past m are zeros and not written
        float cross[kG][kP];
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
            for (int p = 0; p < kP; ++p) cross[j][p] = 0.f;
        if (ONE) {
#pragma unroll
            for (int c = 0; c < kK; c += 4) {
                float4 qv[kG];
#pragma unroll
                for (int j = 0; j < kG; ++j) qv[j] = *reinterpret_cast<const float4*>(&sq[g + j][c]);
                add_cross(qv, xv, c, cross);
            }
        } else {
            for (int k0 = 0; k0 < s; k0 += kK) {
                load_slab<VEC>(x, ldx, n, s, b0, k0, xv);
#pragma unroll
                for (int c = 0; c < kK; c += 4) {
                    float4 qv[kG];
#pragma unroll
                    for (int j = 0; j < kG; ++j) {
                        const float* row = q + (long long)(a0 + min(g + j, rows - 1)) * ldq + k0 + c;
                        float v[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e) v[e] = k0 + c + e < s ? __ldg(row + e) : 0.f;
                        qv[j] = make_float4(v[0], v[1], v[2], v[3]);
                    }
                    add_cross(qv, xv, c, cross);
                }
            }
        }
        if (b0 < n) {
#pragma unroll
            for (int j = 0; j < kG; ++j)
                if (g + j < rows) store_row(out, n, a0 + g + j, b0, sqn[g + j], xn, cross[j]);
        }
    }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int pairwise_sqdist(const float* q, long long ldq, const float* x, long long ldx,
                               int m, int n, int d, int vec, float* out, void* stream) {
    if (m < 1 || n < 1 || d < 1 || m > kMaxRows || n > kMaxPoints || (vec != 1 && vec != 4))
        return (int)cudaErrorInvalidValue;
    const long long groups = (m + kQ - 1) / kQ, tiles = (n + kPoints - 1) / kPoints;
    if (groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const int blocks = (int)(groups * tiles);
    const bool one = d <= kK;
    auto kernel = vec == 4 ? (one ? pairwise_sqdist_kernel<4, true> : pairwise_sqdist_kernel<4, false>)
                           : (one ? pairwise_sqdist_kernel<1, true> : pairwise_sqdist_kernel<1, false>);
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q, ldq, x, ldx, m, n, d,
                                                                      (int)groups, out);
    return (int)cudaGetLastError();
}
