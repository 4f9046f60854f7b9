// The chunked SC-score kernels of SuCo's query: scores alone, scores with the
// Pareto keep mask, and scores with the prefilter and survivor compaction.
//
// Replaces three TPU kernels of src/repro/kernels/sc_score/kernel.py.  For
// each query q and chunk column j all three compute
//   s[q,j] = sum_i [rank[i,q,cells[i,j]] <= cut[i,q]].
//
// * sc_score_cells_kernel (_cells_kernel): the (m, bc) scores, for the
//   streaming query's chunks and the dense query's whole (m, n) matrix.
// * sc_score_cells_prefilter_kernel (_cells_prefilter_kernel): the scores
//   and keep[q,j] = s[q,j] > thr[q], written in the same pass.
// * sc_score_cells_prefilter_compact_kernel (_cells_prefilter_compact_kernel):
//   columns >= limit or dead in keep_cols score -1, the columns with
//   s > thr[q] survive and are compacted in ascending column order into cap
//   slots, and count[q] is the true number of survivors (it may exceed cap).
//   Dead columns neither survive nor count, as in the jnp oracle.
//
// What bounds them on an H100: bytes.  Per query they do Ns compares and
// adds per column against 4*Ns bytes of cell ids and a 4-byte score write,
// far below the card's ~20 operations per byte.  Design: a block serves one
// query row.  It first turns that query's activated set (rank <= cut) into
// an Ns*K-bit bitmap in shared memory (2.5 KB at Ns=8, K=2500), one warp
// ballot per 32 cells, so the column sweep reads cell ids (coalesced, shared
// by all query blocks through L2) and tests bits in shared memory instead of
// gathering int32 ranks.  The scores-only and keep-mask kernels also split
// the columns over blocks (kColsPerBlock each, every block building its own
// bitmap from L2), so a wide dense matrix still fills the card.  The compact
// kernel sweeps its chunk in tiles of the block's width; a block-wide
// exclusive scan (warp shuffles, then a scan of the warp totals) gives each
// survivor its slot, and the running count carries across tiles.  Integers
// only: the results are exact and the same from run to run.  No padding:
// cells is read through its row stride, so a chunk is a column slice of the
// index's (Ns, n) cell ids.
//
// C entry points (each returns cudaGetLastError()):
//   sc_score_cells(...), sc_score_cells_prefilter(...), sc_score_compact(...).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerBlock = 32768;  // columns per block of the scores-only kernels

// The activated set of query q as a bitmap: bit c of row i is
// rank[i,q,c] <= cut[i,q].  The caller synchronises before reading it.
__device__ __forceinline__ void build_bitmap(const int* __restrict__ ranks,
                                             const int* __restrict__ cuts, int ns, int m,
                                             int K, int q, unsigned int* bitmap) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int words = (K + 31) >> 5;
    for (int i = 0; i < ns; ++i) {
        const int cut = cuts[(long long)i * m + q];
        const int* r = ranks + ((long long)i * m + q) * K;
        for (int base = warp * 32; base < words * 32; base += kThreads) {
            const int c = base + lane;
            const bool on = c < K && r[c] <= cut;
            const unsigned int word = __ballot_sync(0xffffffffu, on);
            if (lane == 0) bitmap[i * words + (base >> 5)] = word;
        }
    }
}

// SC-score of chunk column j against the bitmap.
__device__ __forceinline__ int column_score(const int* __restrict__ cells,
                                            long long cells_stride, int ns, int K, int j,
                                            const unsigned int* bitmap) {
    const int words = (K + 31) >> 5;
    int sc = 0;
    for (int i = 0; i < ns; ++i) {
        const unsigned int c = (unsigned int)cells[i * cells_stride + j];
        if (c < (unsigned int)K) sc += (bitmap[i * words + (c >> 5)] >> (c & 31)) & 1u;
    }
    return sc;
}

// Scores of query blockIdx.x over the columns of chunk blockIdx.y; with
// PREFILTER also keep = score > thr[q].
template <bool PREFILTER>
__global__ void __launch_bounds__(kThreads)
sc_score_cells_kernel(const int* __restrict__ ranks,   // (ns, m, K)
                      const int* __restrict__ cuts,    // (ns, m)
                      const int* __restrict__ cells,   // (ns, >=bc), row stride cells_stride
                      long long cells_stride,
                      const int* __restrict__ thr,     // (m,), PREFILTER only
                      int ns, int m, int K, int bc,
                      int* __restrict__ scores,        // (m, bc)
                      uint8_t* __restrict__ keep)      // (m, bc), PREFILTER only
{
    extern __shared__ unsigned int bitmap[];  // ns * words
    const int q = blockIdx.x;
    build_bitmap(ranks, cuts, ns, m, K, q, bitmap);
    __syncthreads();
    const int t_q = PREFILTER ? thr[q] : 0;
    const int j0 = (int)blockIdx.y * kColsPerBlock;
    const int j1 = min(bc, j0 + kColsPerBlock);
    for (int j = j0 + (int)threadIdx.x; j < j1; j += kThreads) {
        const int sc = column_score(cells, cells_stride, ns, K, j, bitmap);
        scores[(long long)q * bc + j] = sc;
        if (PREFILTER) keep[(long long)q * bc + j] = sc > t_q ? 1 : 0;
    }
}

__global__ void __launch_bounds__(kThreads)
sc_score_compact_kernel(const int* __restrict__ ranks,   // (ns, m, K)
                        const int* __restrict__ cuts,    // (ns, m)
                        const int* __restrict__ cells,   // (ns, >=bc), row stride cells_stride
                        long long cells_stride,
                        const int* __restrict__ thr,     // (m,)
                        const uint8_t* __restrict__ keep,  // (bc,) or null
                        int ns, int m, int K, int bc, int limit, int cap,
                        int* __restrict__ scores,        // (m, bc)
                        int* __restrict__ surv_cols,     // (m, cap)
                        int* __restrict__ surv_scores,   // (m, cap)
                        int* __restrict__ count)         // (m,)
{
    extern __shared__ unsigned int bitmap[];  // ns * words
    __shared__ int warp_incl[kWarps];
    __shared__ int tile_total;

    const int q = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    build_bitmap(ranks, cuts, ns, m, K, q, bitmap);
    __syncthreads();

    const int t_q = thr[q];
    int running = 0;
    for (int j0 = 0; j0 < bc; j0 += kThreads) {
        const int j = j0 + tid;
        int sc = -1;
        if (j < bc) {
            if (j < limit && (keep == nullptr || keep[j]))
                sc = column_score(cells, cells_stride, ns, K, j, bitmap);
            scores[(long long)q * bc + j] = sc;
        }
        const int flag = (j < bc && sc > t_q) ? 1 : 0;

        // Block-wide exclusive scan of the survivor flags.
        int v = flag;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += u;
        }
        if (lane == 31) warp_incl[warp] = v;
        __syncthreads();
        if (warp == 0) {
            int w = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(0xffffffffu, w, o);
                if (lane >= o) w += u;
            }
            if (lane < kWarps) warp_incl[lane] = w;
            if (lane == kWarps - 1) tile_total = w;
        }
        __syncthreads();
        const int slot = running + v - flag + (warp > 0 ? warp_incl[warp - 1] : 0);
        if (flag && slot < cap) {
            surv_cols[(long long)q * cap + slot] = j;
            surv_scores[(long long)q * cap + slot] = sc;
        }
        running += tile_total;
        __syncthreads();  // warp_incl and tile_total are reused by the next tile
    }
    for (int slot = min(running, cap) + tid; slot < cap; slot += kThreads) {
        surv_cols[(long long)q * cap + slot] = 0;
        surv_scores[(long long)q * cap + slot] = -1;
    }
    if (tid == 0) count[q] = running;
}

// Raise a kernel's dynamic shared memory limit where its bitmap needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t bitmap_bytes(int ns, int K) { return (size_t)ns * ((K + 31) / 32) * sizeof(unsigned int); }

template <bool PREFILTER>
int launch_cells(const int* ranks, const int* cuts, const int* cells, long long cells_stride,
                 const int* thr, int ns, int m, int K, int bc, int* scores, uint8_t* keep,
                 void* stream) {
    const size_t smem = bitmap_bytes(ns, K);
    const cudaError_t e = allow_smem(sc_score_cells_kernel<PREFILTER>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(m, (bc + kColsPerBlock - 1) / kColsPerBlock);
    sc_score_cells_kernel<PREFILTER><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        ranks, cuts, cells, cells_stride, thr, ns, m, K, bc, scores, keep);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int sc_score_cells(const int* ranks, const int* cuts, const int* cells,
                              long long cells_stride, int ns, int m, int K, int bc, int* scores,
                              void* stream) {
    return launch_cells<false>(ranks, cuts, cells, cells_stride, nullptr, ns, m, K, bc, scores,
                               nullptr, stream);
}

extern "C" int sc_score_cells_prefilter(const int* ranks, const int* cuts, const int* cells,
                                        long long cells_stride, const int* thr, int ns, int m,
                                        int K, int bc, int* scores, uint8_t* keep, void* stream) {
    return launch_cells<true>(ranks, cuts, cells, cells_stride, thr, ns, m, K, bc, scores, keep,
                              stream);
}

extern "C" int sc_score_compact(const int* ranks, const int* cuts, const int* cells,
                                long long cells_stride, const int* thr, const uint8_t* keep,
                                int ns, int m, int K, int bc, int limit, int cap,
                                int* scores, int* surv_cols, int* surv_scores, int* count,
                                void* stream) {
    const size_t smem = bitmap_bytes(ns, K);
    const cudaError_t e = allow_smem(sc_score_compact_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    sc_score_compact_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        ranks, cuts, cells, cells_stride, thr, keep, ns, m, K, bc, limit, cap,
        scores, surv_cols, surv_scores, count);
    return (int)cudaGetLastError();
}
