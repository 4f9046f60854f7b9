// Fused SC-score + Pareto prefilter + survivor compaction for one data chunk.
//
// Replaces the TPU kernel sc_score_cells_prefilter_compact_kernel
// (src/repro/kernels/sc_score/kernel.py, _cells_prefilter_compact_kernel):
// for each query q and chunk column j,
//   s[q,j] = sum_i [rank[i,q,cells[i,j]] <= cut[i,q]],
// columns >= limit or dead in keep_cols score -1, the columns with
// s > thr[q] survive and are compacted in ascending column order into cap
// slots, and count[q] is the true number of survivors (it may exceed cap).
// Dead columns neither survive nor count, as in the jnp oracle.
//
// What bounds it on an H100: bytes.  Per query it does Ns compares and adds
// per column against 4*Ns bytes of cell ids and a 4-byte score write, far
// below the card's ~20 operations per byte.  Design: one block per query
// row.  The block first turns that query's activated set (rank <= cut) into
// an Ns*K-bit bitmap in shared memory (2.5 KB at Ns=8, K=2500), one warp
// ballot per 32 cells, so the column sweep reads cell ids (coalesced, shared
// by all query blocks through L2) and tests bits in shared memory instead of
// gathering int32 ranks.  Columns are swept in tiles of the block's width; a
// block-wide exclusive scan (warp shuffles, then a scan of the warp totals)
// gives each survivor its slot, and the running count carries across tiles.
// Integers only: the result is exact and the same from run to run.
//
// C entry point: sc_score_compact(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
    const int words = (K + 31) >> 5;

    // Activated set of query q as a bitmap: bit c of row i is rank <= cut.
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
    __syncthreads();

    const int t_q = thr[q];
    int running = 0;
    for (int j0 = 0; j0 < bc; j0 += kThreads) {
        const int j = j0 + tid;
        int sc = -1;
        if (j < bc) {
            if (j < limit && (keep == nullptr || keep[j])) {
                sc = 0;
                for (int i = 0; i < ns; ++i) {
                    const unsigned int c = (unsigned int)cells[i * cells_stride + j];
                    if (c < (unsigned int)K) sc += (bitmap[i * words + (c >> 5)] >> (c & 31)) & 1u;
                }
            }
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

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int sc_score_compact(const int* ranks, const int* cuts, const int* cells,
                                long long cells_stride, const int* thr, const uint8_t* keep,
                                int ns, int m, int K, int bc, int limit, int cap,
                                int* scores, int* surv_cols, int* surv_scores, int* count,
                                void* stream) {
    const size_t smem = (size_t)ns * ((K + 31) / 32) * sizeof(unsigned int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sc_score_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    sc_score_compact_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        ranks, cuts, cells, cells_stride, thr, keep, ns, m, K, bc, limit, cap,
        scores, surv_cols, surv_scores, count);
    return (int)cudaGetLastError();
}
