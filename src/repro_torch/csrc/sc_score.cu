// The chunked SC-score kernels of SuCo's query: scores alone, scores with the
// Pareto keep mask, and scores with the prefilter and survivor compaction.
//
// Replaces three TPU kernels of src/repro/kernels/sc_score/kernel.py.  For
// each query q and chunk column j all three compute
//   s[q,j] = sum_i [rank[i,q,cells[i,j]] <= cut[i,q]].
//
// * sc_score_cells_kernel (_cells_kernel, :263): the (m, bc) scores, for the
//   streaming query's chunks and the dense query's whole (m, n) matrix.
// * sc_score_cells_prefilter_kernel (_cells_prefilter_kernel, :218): the
//   scores and keep[q,j] = s[q,j] > thr[q], written in the same pass.
// * sc_score_cells_prefilter_compact_kernel (_cells_prefilter_compact_kernel,
//   :151): columns >= limit or dead in keep_cols score -1, the columns with
//   s > thr[q] survive and are compacted in ascending column order into cap
//   slots, and count[q] is the true number of survivors (it may exceed cap).
//   Dead columns neither survive nor count, as in the jnp oracle.
//
// What bounds them on an H100: bytes.  Per query they do Ns compares and
// adds per column against 4*Ns bytes of cell ids and a 4-byte score write,
// far below the card's ~20 operations per byte.  Integers only: the results
// are exact and the same from run to run.  No padding: cells is read
// through its row stride, so a chunk is a column slice of the index's
// (Ns, n) cell ids.
//
// The scores and the keep mask (rows 7 and 8): two launches from one C
// entry point.
//  (a) sc_bitmap_kernel turns the activated sets into a bitmap in device
//      memory: the (m, Ns, K) bits [rank <= cut], the queries taken in
//      groups of Q (Q in 1, 2, 4, 8, 16) and a group's Q bits of one
//      (subspace, cell) stored side by side.  So a group's bitmap is
//      Ns rows of W*Q words (W = ceil(K/32)), a cell's Q bits lie in one
//      word, and Q = 1 is the plain (m, Ns, W) bitmap.  Each thread builds
//      one 32-bit word: 32/Q cells of Q queries, all 32 rank loads issued
//      before the first test, 16 bytes at a time (8 at Q = 16) where the
//      row allows.  The ranks (4*Ns*m*K bytes, 5.1 MB at the streaming
//      query's m = 64) are read once per call, not once per block.
//  (b) sc_sweep_kernel: a block (256 threads) serves one group of Q
//      queries and a tile of columns.  It copies the group's bitmap
//      (Q*Ns*W*4 bytes: 40 KB at Q = 16, Ns = 8, K = 2,500) into shared
//      memory with cp.async (every copy of a thread in flight at once),
//      loads each column's Ns cell ids once (all in flight before the
//      first lookup), reads each cell's Q bits with one 32-bit shared load,
//      adds them into byte counters (four queries a register: a nibble
//      spread to four bytes by one multiply) and writes Q coalesced scores
//      (and keep).  The cell ids
//      are read ceil(m/Q) times instead of m times; bytes: the ranks once,
//      the bitmap (Q*Ns*W*4 per group) from L2 once per block, cells once
//      per group (from L2 after the first), 4*m*bc of scores (and m*bc of
//      keep).  Q is the largest that fits in shared memory (and does not
//      exceed m rounded up to a power of two); the column tile gives the
//      launch at least two blocks an SM where the columns allow it (both
//      picked by kernels/sc_score/kernel.py::tiling from
//      sc_score_smem_bytes).  Where one query's bitmap does not fit, the
//      launch is refused.  The subspace loop is unrolled for Ns = 4, 8, 16
//      (a loop for the others).
//
// The compact kernel (row 1) keeps its own design: a block per query
// builds that query's bitmap in shared memory, one warp ballot per 32
// cells, then sweeps its chunk in tiles of the block's width; a block-wide
// exclusive scan (warp shuffles, then a scan of the warp totals) gives each
// survivor its slot, and the running count carries across tiles.
//
// C entry points (each returns cudaGetLastError()):
//   sc_score_cells(...), sc_score_cells_prefilter(...), sc_score_compact(...),
//   sc_score_smem_bytes(ns, K, q): a sweep block's shared memory in bytes.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;  // threads of a compact block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 16;             // queries a sweep block serves, at most
constexpr int kBitmapThreads = 128;   // threads of a bitmap block
constexpr int kSweepThreads = 256;    // threads of a sweep block

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

// ---- Rows 7 and 8: (a) the bitmap pass, (b) the query-tiled sweep ----

__host__ __device__ inline int cell_words(int K) { return (K + 31) >> 5; }

// A sweep block's shared memory serving q queries, in bytes: ns rows of
// W*q words, the size of one query group's slab of the bitmap.
__host__ __device__ inline size_t sweep_smem_bytes(int ns, int K, int q) {
    return (size_t)q * ns * cell_words(K) * sizeof(unsigned int);
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x >> 1); }

// (a) Word t of the bitmap, words in (group, subspace, word) order: word w
// of row (g, i) holds cells [w*CPW, (w+1)*CPW) (CPW = 32/Q), cell c's Q bits
// at (c % CPW)*Q, bit b of them query g*Q + b.  Queries past m and cells
// past K are 0.  All 32 rank loads are issued before the first test.
template <int Q>
__global__ void __launch_bounds__(kBitmapThreads)
sc_bitmap_kernel(const int* __restrict__ ranks,   // (ns, m, K)
                 const int* __restrict__ cuts,    // (ns, m)
                 int ns, int m, int K, long long words,
                 unsigned int* __restrict__ bitmap)  // (groups, ns, W*Q)
{
    constexpr int CPW = 32 / Q;             // cells a word
    constexpr int V = CPW >= 4 ? 4 : CPW;   // ints a load: 16 bytes (8 at Q = 16)
    const long long t = (long long)blockIdx.x * kBitmapThreads + threadIdx.x;
    if (t >= words) return;
    const int row_words = cell_words(K) * Q;
    const int w = (int)(t % row_words);
    const long long gi = t / row_words;
    const int i = (int)(gi % ns);
    const int g = (int)(gi / ns);
    const int c0 = w * CPW;
    // whole vectors: every row starts on a V-int boundary and holds the word's cells
    const bool vec = K % V == 0 && c0 + CPW <= K &&
                     (reinterpret_cast<uintptr_t>(ranks) & (4 * V - 1)) == 0;
    int r[32];  // r[b * CPW + k]: rank of cell c0 + k for query g*Q + b
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        const int q = g * Q + b;
        const int* row = ranks + ((long long)i * m + min(q, m - 1)) * K + c0;
        if (vec) {
#pragma unroll
            for (int k = 0; k < CPW / V; ++k) {
                if constexpr (V == 4) {
                    const int4 v = __ldg(reinterpret_cast<const int4*>(row) + k);
                    r[b * CPW + 4 * k] = v.x;
                    r[b * CPW + 4 * k + 1] = v.y;
                    r[b * CPW + 4 * k + 2] = v.z;
                    r[b * CPW + 4 * k + 3] = v.w;
                } else {
                    const int2 v = __ldg(reinterpret_cast<const int2*>(row) + k);
                    r[b * CPW + 2 * k] = v.x;
                    r[b * CPW + 2 * k + 1] = v.y;
                }
            }
        } else {
#pragma unroll
            for (int k = 0; k < CPW; ++k) r[b * CPW + k] = c0 + k < K ? __ldg(row + k) : 0;
        }
    }
    unsigned int word = 0;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        const int q = g * Q + b;
        if (q >= m) continue;
        const int cut = __ldg(cuts + (long long)i * m + q);
#pragma unroll
        for (int k = 0; k < CPW; ++k)
            word |= (unsigned int)(c0 + k < K && r[b * CPW + k] <= cut) << (k * Q + b);
    }
    bitmap[t] = word;
}

// Copy BYTES (4 or 16) from device to shared memory without a register:
// the copies a thread issues are all in flight until cp.async.wait_all.
template <int BYTES>
__device__ __forceinline__ void copy_async(unsigned int* dst, const unsigned int* src) {
    const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// (b) Scores of query group g = blockIdx.x % groups over the column tile
// blockIdx.x / groups; with PREFILTER also keep = score > thr[q].  A cell's
// Q bits come from one shared load and are added into byte counters, four
// queries a register: a nibble times 0x00204081 puts its bit b at 8b.
template <int Q, int NS, bool PREFILTER>
__global__ void __launch_bounds__(kSweepThreads)
sc_sweep_kernel(const unsigned int* __restrict__ bitmap,  // (groups, ns, W*Q)
                const int* __restrict__ cells,   // (ns, >=bc), row stride cells_stride
                long long cells_stride,
                const int* __restrict__ thr,     // (m,), PREFILTER only
                int ns_arg, int m, int K, int bc, int groups, int tile,
                int* __restrict__ scores,        // (m, bc)
                uint8_t* __restrict__ keep)      // (m, bc), PREFILTER only
{
    constexpr int CPW = 32 / Q;
    constexpr int LOG_CPW = log2_of(CPW);
    constexpr int kAcc = (Q + 3) / 4;                      // byte counters
    constexpr int kChunk = NS > 0 && NS < 8 ? NS : 8;     // cell loads in flight
    constexpr unsigned int kNib = Q >= 4 ? 0xFu : (1u << Q) - 1u;
    extern __shared__ __align__(16) unsigned int sbits[];  // (ns, W*Q)
    __shared__ int s_thr[kMaxQ];
    const int ns = NS > 0 ? NS : ns_arg;
    const int row_words = cell_words(K) * Q;
    const int g = (int)(blockIdx.x % (unsigned int)groups);
    const long long j0 = (long long)(blockIdx.x / (unsigned int)groups) * tile;

    // the group's bitmap into shared memory: every copy in flight at once
    const int n = ns * row_words;
    const unsigned int* src = bitmap + (long long)g * n;
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int e = threadIdx.x; e < (n >> 2); e += blockDim.x)
            copy_async<16>(sbits + 4 * e, src + 4 * e);
    } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x) copy_async<4>(sbits + e, src + e);
    }
    if (PREFILTER && threadIdx.x < Q) {
        const int q = g * Q + threadIdx.x;
        s_thr[threadIdx.x] = q < m ? thr[q] : 0;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const long long j1 = min((long long)bc, j0 + tile);
    for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
        unsigned int acc[kAcc];
        int flushed[Q];  // counts taken out of the bytes before they could overflow
#pragma unroll
        for (int a = 0; a < kAcc; ++a) acc[a] = 0;
#pragma unroll
        for (int b = 0; b < Q; ++b) flushed[b] = 0;
        for (int i0 = 0; i0 < ns; i0 += kChunk) {
            unsigned int c[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
                c[k] = NS > 0 || i0 + k < ns
                           ? (unsigned int)__ldg(cells + (long long)(i0 + k) * cells_stride + j)
                           : 0xFFFFFFFFu;
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                if (c[k] < (unsigned int)K) {
                    const unsigned int bits = sbits[(i0 + k) * row_words + (c[k] >> LOG_CPW)] >>
                                              ((c[k] & (CPW - 1)) * Q);
#pragma unroll
                    for (int a = 0; a < kAcc; ++a)
                        acc[a] += (((bits >> (4 * a)) & kNib) * 0x00204081u) & 0x01010101u;
                }
            }
            if (NS == 0 && ns > 255) {  // a byte holds at most 255 hits
#pragma unroll
                for (int b = 0; b < Q; ++b) flushed[b] += (acc[b >> 2] >> (8 * (b & 3))) & 0xFFu;
#pragma unroll
                for (int a = 0; a < kAcc; ++a) acc[a] = 0;
            }
        }
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int q = g * Q + b;
            if (q < m) {
                const int sc = flushed[b] + (int)((acc[b >> 2] >> (8 * (b & 3))) & 0xFFu);
                scores[(long long)q * bc + j] = sc;
                if (PREFILTER) keep[(long long)q * bc + j] = sc > s_thr[b] ? 1 : 0;
            }
        }
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

size_t bitmap_bytes(int ns, int K) { return sweep_smem_bytes(ns, K, 1); }

template <int Q, int NS, bool PREFILTER>
cudaError_t launch_sweep(unsigned int blocks, int threads, size_t smem, cudaStream_t stream,
                         const unsigned int* bitmap, const int* cells, long long cells_stride,
                         const int* thr, int ns, int m, int K, int bc, int groups, int tile,
                         int* scores, uint8_t* keep) {
    const cudaError_t e = allow_smem(sc_sweep_kernel<Q, NS, PREFILTER>, smem);
    if (e != cudaSuccess) {
        cudaGetLastError();  // the refusal is returned here, not left for the next launch
        return e;
    }
    sc_sweep_kernel<Q, NS, PREFILTER><<<blocks, threads, smem, stream>>>(
        bitmap, cells, cells_stride, thr, ns, m, K, bc, groups, tile, scores, keep);
    return cudaGetLastError();
}

template <int Q, bool PREFILTER>
cudaError_t launch_q(const int* ranks, const int* cuts, const int* cells, long long cells_stride,
                     const int* thr, int ns, int m, int K, int bc, int tile,
                     unsigned int* bitmap, int* scores, uint8_t* keep, cudaStream_t stream) {
    const int groups = (m + Q - 1) / Q;
    const long long words = (long long)groups * ns * cell_words(K) * Q;
    const long long bitmap_blocks = (words + kBitmapThreads - 1) / kBitmapThreads;
    const long long blocks = (((long long)bc + tile - 1) / tile) * groups;
    if (bitmap_blocks > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    const size_t smem = sweep_smem_bytes(ns, K, Q);
    sc_bitmap_kernel<Q><<<(unsigned int)bitmap_blocks, kBitmapThreads, 0, stream>>>(
        ranks, cuts, ns, m, K, words, bitmap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const unsigned int nb = (unsigned int)blocks;
    switch (ns) {
        case 4: return launch_sweep<Q, 4, PREFILTER>(nb, kSweepThreads, smem, stream, bitmap, cells,
                                                     cells_stride, thr, ns, m, K, bc, groups,
                                                     tile, scores, keep);
        case 8: return launch_sweep<Q, 8, PREFILTER>(nb, kSweepThreads, smem, stream, bitmap, cells,
                                                     cells_stride, thr, ns, m, K, bc, groups,
                                                     tile, scores, keep);
        case 16: return launch_sweep<Q, 16, PREFILTER>(nb, kSweepThreads, smem, stream, bitmap, cells,
                                                       cells_stride, thr, ns, m, K, bc, groups,
                                                       tile, scores, keep);
        default: return launch_sweep<Q, 0, PREFILTER>(nb, kSweepThreads, smem, stream, bitmap, cells,
                                                      cells_stride, thr, ns, m, K, bc, groups,
                                                      tile, scores, keep);
    }
}

// Both passes of rows 7 and 8 at q queries a sweep block and tile columns a
// block; bitmap is the caller's scratch of ceil(m/q) * ns * W * q words.
template <bool PREFILTER>
int launch_cells(const int* ranks, const int* cuts, const int* cells, long long cells_stride,
                 const int* thr, int ns, int m, int K, int bc, int q, int tile,
                 unsigned int* bitmap, int* scores, uint8_t* keep, void* stream_) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (tile < 1) return (int)cudaErrorInvalidValue;
    switch (q) {
        case 1: return (int)launch_q<1, PREFILTER>(ranks, cuts, cells, cells_stride, thr, ns, m,
                                                   K, bc, tile, bitmap, scores, keep, stream);
        case 2: return (int)launch_q<2, PREFILTER>(ranks, cuts, cells, cells_stride, thr, ns, m,
                                                   K, bc, tile, bitmap, scores, keep, stream);
        case 4: return (int)launch_q<4, PREFILTER>(ranks, cuts, cells, cells_stride, thr, ns, m,
                                                   K, bc, tile, bitmap, scores, keep, stream);
        case 8: return (int)launch_q<8, PREFILTER>(ranks, cuts, cells, cells_stride, thr, ns, m,
                                                   K, bc, tile, bitmap, scores, keep, stream);
        case 16: return (int)launch_q<16, PREFILTER>(ranks, cuts, cells, cells_stride, thr, ns,
                                                     m, K, bc, tile, bitmap, scores, keep,
                                                     stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int sc_score_cells(const int* ranks, const int* cuts, const int* cells,
                              long long cells_stride, int ns, int m, int K, int bc, int q,
                              int tile, unsigned int* bitmap, int* scores, void* stream) {
    return launch_cells<false>(ranks, cuts, cells, cells_stride, nullptr, ns, m, K, bc, q, tile,
                               bitmap, scores, nullptr, stream);
}

extern "C" int sc_score_cells_prefilter(const int* ranks, const int* cuts, const int* cells,
                                        long long cells_stride, const int* thr, int ns, int m,
                                        int K, int bc, int q, int tile, unsigned int* bitmap,
                                        int* scores, uint8_t* keep, void* stream) {
    return launch_cells<true>(ranks, cuts, cells, cells_stride, thr, ns, m, K, bc, q, tile,
                              bitmap, scores, keep, stream);
}

extern "C" int sc_score_smem_bytes(int ns, int K, int q) {
    const size_t b = sweep_smem_bytes(ns, K, q);
    return b > (size_t)INT_MAX ? INT_MAX : (int)b;
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
