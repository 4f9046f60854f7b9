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
// All three run on the same two passes, launched from one C entry point
// each; the compaction adds a third.
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
//      queries and a tile of columns.  It loads each column's Ns cell ids
//      once (all in flight before the first lookup), reads each cell's Q
//      bits with one 32-bit load, adds them into byte counters (four
//      queries a register: a nibble spread to four bytes by one multiply)
//      and writes Q coalesced scores (and keep).  The cell ids are read
//      ceil(m/Q) times instead of m times; bytes: the ranks once, the
//      bitmap (Q*Ns*W*4 per group) from L2 once per block, cells once per
//      group (from L2 after the first), 4*m*bc of scores (and m*bc of
//      keep).  Two routes for the bitmap:
//      - shared: the block first copies its group's slab into shared
//        memory with cp.async (every copy of a thread in flight at once):
//        40 KB at Q = 16, Ns = 8, K = 2,500.  Q is the largest that fits
//        (sc_score_smem_bytes states the bytes).
//      - L2: where one query's slab does not fit in a block's shared
//        memory (Ns*W*4 > 232,448 bytes: Ns = 16 at K = 116,281, Ns = 8 at
//        K = 233,289), the sweep reads the slab in device memory through
//        __ldg, and it stays in L2; Q is then limited by m alone.  Only the
//        generic subspace loop is built for it.
//      Q does not exceed m rounded up to a power of two; the column tile
//      gives the launch at least two blocks an SM where the columns allow
//      it (route, Q and tile from kernels/sc_score/kernel.py::tiling).  The
//      subspace loop is unrolled for Ns = 4, 8, 16 (a loop for the others).
//
// The compaction (row 1) is three launches: (a); (b) with the masks (a
// column >= limit, or dead in keep_cols, scores -1 and loads no cells),
// writing the (m, bc) scores and each (query, tile)'s number of survivors
// (score > thr) into an (m, tiles) scratch; then
//  (c) sc_compact_kernel: a warp per (query, tile) sums its query's counts
//      of the earlier tiles for its first slot, re-reads its tile's scores
//      (still in L2), 8 rows of 32 in flight, and places each row's
//      survivors by a ballot and the count of the lower lanes' flags, so
//      slots follow the columns' order without a barrier; it writes
//      (column, score) where slot < cap, and a warp whose first slot is
//      already >= cap, or whose tile has no survivor, writes nothing.  The
//      warp of a query's first tile writes count[q] (the true total), and
//      the query's warps share out the empty slots [min(count, cap), cap),
//      filled with column 0 and score -1.  Bytes: the scores read once
//      more from L2, 8*m*cap written.
//
// C entry points (each returns cudaGetLastError()):
//   sc_score_cells(...), sc_score_cells_prefilter(...), sc_score_compact(...),
//   sc_score_smem_bytes(ns, K, q): a sweep block's shared memory in bytes
//   on the shared route.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxQ = 16;             // queries a sweep block serves, at most
constexpr int kBitmapThreads = 128;   // threads of a bitmap block
constexpr int kSweepThreads = 256;    // threads of a sweep block
constexpr int kCompactThreads = 256;  // threads of a compaction block
constexpr int kCompactWarps = kCompactThreads / 32;

// What a sweep writes: the scores, with the keep mask, or (row 1) the
// masked scores and each tile's survivor counts.
enum Mode { kScores, kKeep, kCompact };

// ---- (a) the bitmap pass ----

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
// t = blockIdx.x / groups; with kKeep also keep = score > thr[q]; with
// kCompact a column >= limit or dead in keep_cols scores -1, and
// tile_counts[q, t] counts the tile's scores > thr[q].  A cell's Q bits come
// from one load (from shared memory, or with L2 from the device bitmap) and
// are added into byte counters, four queries a register: a nibble times
// 0x00204081 puts its bit b at 8b.
template <int Q, int NS, int MODE, bool L2>
__global__ void __launch_bounds__(kSweepThreads)
sc_sweep_kernel(const unsigned int* __restrict__ bitmap,  // (groups, ns, W*Q)
                const int* __restrict__ cells,   // (ns, >=bc), row stride cells_stride
                long long cells_stride,
                const int* __restrict__ thr,     // (m,), kKeep and kCompact
                const uint8_t* __restrict__ keep_cols,  // (bc,) or null, kCompact
                int ns_arg, int m, int K, int bc, int limit, int groups, int tile,
                int* __restrict__ scores,        // (m, bc)
                uint8_t* __restrict__ keep,      // (m, bc), kKeep
                int* __restrict__ tile_counts)   // (m, tiles), kCompact
{
    constexpr int CPW = 32 / Q;
    constexpr int LOG_CPW = log2_of(CPW);
    constexpr int kAcc = (Q + 3) / 4;                      // byte counters
    constexpr int kChunk = NS > 0 && NS < 8 ? NS : 8;     // cell loads in flight
    constexpr unsigned int kNib = Q >= 4 ? 0xFu : (1u << Q) - 1u;
    extern __shared__ __align__(16) unsigned int sbits[];  // (ns, W*Q), shared route
    __shared__ int s_thr[kMaxQ];
    __shared__ int s_cnt[kMaxQ];
    const int ns = NS > 0 ? NS : ns_arg;
    const int row_words = cell_words(K) * Q;
    const int g = (int)(blockIdx.x % (unsigned int)groups);
    const int t = (int)(blockIdx.x / (unsigned int)groups);
    const long long j0 = (long long)t * tile;

    const int n = ns * row_words;
    const unsigned int* src = bitmap + (long long)g * n;
    if constexpr (!L2) {  // the group's bitmap into shared memory: every copy in flight at once
        if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            for (int e = threadIdx.x; e < (n >> 2); e += blockDim.x)
                copy_async<16>(sbits + 4 * e, src + 4 * e);
        } else {
            for (int e = threadIdx.x; e < n; e += blockDim.x) copy_async<4>(sbits + e, src + e);
        }
    }
    if (MODE != kScores && threadIdx.x < Q) {
        const int q = g * Q + threadIdx.x;
        s_thr[threadIdx.x] = q < m ? thr[q] : 0;
        s_cnt[threadIdx.x] = 0;
    }
    if constexpr (!L2) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    int survivors[MODE == kCompact ? Q : 1];  // this thread's columns scoring > thr
#pragma unroll
    for (int b = 0; b < (MODE == kCompact ? Q : 1); ++b) survivors[b] = 0;
    const long long j1 = min((long long)bc, j0 + tile);
    for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
        const bool live = MODE != kCompact ||
                          (j < limit && (keep_cols == nullptr || keep_cols[j] != 0));
        unsigned int acc[kAcc];
        int flushed[Q];  // counts taken out of the bytes before they could overflow
#pragma unroll
        for (int a = 0; a < kAcc; ++a) acc[a] = 0;
#pragma unroll
        for (int b = 0; b < Q; ++b) flushed[b] = 0;
        for (int i0 = 0; live && i0 < ns; i0 += kChunk) {
            unsigned int c[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
                c[k] = NS > 0 || i0 + k < ns
                           ? (unsigned int)__ldg(cells + (long long)(i0 + k) * cells_stride + j)
                           : 0xFFFFFFFFu;
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                if (c[k] < (unsigned int)K) {
                    const int w = (i0 + k) * row_words + (c[k] >> LOG_CPW);
                    const unsigned int bits =
                        (L2 ? __ldg(src + w) : sbits[w]) >> ((c[k] & (CPW - 1)) * Q);
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
                const int sc = live ? flushed[b] + (int)((acc[b >> 2] >> (8 * (b & 3))) & 0xFFu)
                                    : -1;
                scores[(long long)q * bc + j] = sc;
                if constexpr (MODE == kKeep) keep[(long long)q * bc + j] = sc > s_thr[b] ? 1 : 0;
                if constexpr (MODE == kCompact) survivors[b] += sc > s_thr[b] ? 1 : 0;
            }
        }
    }
    if constexpr (MODE == kCompact) {  // the tile's survivors of each query
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int v = __reduce_add_sync(0xffffffffu, survivors[b]);
            if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&s_cnt[b], v);
        }
        __syncthreads();
        const int tiles = (bc + tile - 1) / tile;
        if (threadIdx.x < Q && g * Q + (int)threadIdx.x < m)
            tile_counts[(long long)(g * Q + threadIdx.x) * tiles + t] = s_cnt[threadIdx.x];
    }
}

// (c) Row 1's survivors of one (query q, column tile t) a warp, item
// blockIdx.x * kCompactWarps + warp = q * tiles + t: in ascending column
// order at the slots after the earlier tiles' survivors.  The warp loads
// kRounds rows of 32 scores at once; a ballot over each row and the count of
// the lower lanes' flags place its survivors, so no barrier is needed.  The
// empty slots [min(count, cap), cap) are shared out among the query's tiles.
__global__ void __launch_bounds__(kCompactThreads)
sc_compact_kernel(const int* __restrict__ scores,       // (m, bc), masked
                  const int* __restrict__ thr,          // (m,)
                  const int* __restrict__ tile_counts,  // (m, tiles)
                  int m, int bc, int tile, int tiles, int cap,
                  int* __restrict__ surv_cols,          // (m, cap)
                  int* __restrict__ surv_scores,        // (m, cap)
                  int* __restrict__ count)              // (m,)
{
    constexpr int kRounds = 8;  // rows of 32 scores a lane has in flight
    const int lane = threadIdx.x & 31;
    const long long item = (long long)blockIdx.x * kCompactWarps + (threadIdx.x >> 5);
    if (item >= (long long)m * tiles) return;
    const int q = (int)(item / tiles);
    const int t = (int)(item % tiles);
    const int* counts = tile_counts + (long long)q * tiles;
    int before = 0, all = 0;
    for (int i = lane; i < tiles; i += 32) {
        const int c = counts[i];
        before += i < t ? c : 0;
        all += c;
    }
    const int base = __reduce_add_sync(0xffffffffu, before);  // the tile's first slot
    const int total = __reduce_add_sync(0xffffffffu, all);    // the query's survivors
    int* cols_q = surv_cols + (long long)q * cap;
    int* scores_q = surv_scores + (long long)q * cap;
    if (t == 0 && lane == 0) count[q] = total;
    const int fill_hi = (int)((long long)cap * (t + 1) / tiles);
    for (int slot = max(min(total, cap), (int)((long long)cap * t / tiles)) + lane;
         slot < fill_hi; slot += 32) {
        cols_q[slot] = 0;
        scores_q[slot] = -1;
    }
    if (base >= cap || counts[t] == 0) return;
    const int t_q = thr[q];
    const int* row = scores + (long long)q * bc;
    const long long j1 = min((long long)bc, (long long)(t + 1) * tile);
    const unsigned int lower = (1u << lane) - 1u;
    int running = base;
    for (long long jb = (long long)t * tile; jb < j1 && running < cap; jb += 32 * kRounds) {
        int sc[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            const long long j = jb + 32 * r + lane;
            sc[r] = j < j1 ? row[j] : 0;
        }
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            const long long j = jb + 32 * r + lane;
            const bool flag = j < j1 && sc[r] > t_q;
            const unsigned int mask = __ballot_sync(0xffffffffu, flag);
            const int slot = running + __popc(mask & lower);
            if (flag && slot < cap) {
                cols_q[slot] = (int)j;
                scores_q[slot] = sc[r];
            }
            running += __popc(mask);
        }
    }
}

// Raise a kernel's dynamic shared memory limit where its bitmap needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// What a sweep reads and writes besides the bitmap.
struct SweepArgs {
    const int* cells;
    long long cells_stride;
    const int* thr;            // kKeep, kCompact
    const uint8_t* keep_cols;  // kCompact, or null
    int ns, m, K, bc, limit;
    int* scores;
    uint8_t* keep;             // kKeep
    int* tile_counts;          // kCompact
};

template <int Q, int NS, int MODE, bool L2>
cudaError_t launch_sweep(unsigned int blocks, size_t smem, cudaStream_t stream,
                         const unsigned int* bitmap, int groups, int tile, const SweepArgs& a) {
    const cudaError_t e = allow_smem(sc_sweep_kernel<Q, NS, MODE, L2>, smem);
    if (e != cudaSuccess) {
        cudaGetLastError();  // the refusal is returned here, not left for the next launch
        return e;
    }
    sc_sweep_kernel<Q, NS, MODE, L2><<<blocks, kSweepThreads, smem, stream>>>(
        bitmap, a.cells, a.cells_stride, a.thr, a.keep_cols, a.ns, a.m, a.K, a.bc, a.limit,
        groups, tile, a.scores, a.keep, a.tile_counts);
    return cudaGetLastError();
}

// Passes (a) and (b) at Q queries a sweep block, tile columns a block; the
// L2 route sweeps from the device bitmap with no shared memory.
template <int Q, int MODE>
cudaError_t launch_q(const int* ranks, const int* cuts, int tile, bool l2, unsigned int* bitmap,
                     const SweepArgs& a, cudaStream_t stream) {
    const int groups = (a.m + Q - 1) / Q;
    const long long words = (long long)groups * a.ns * cell_words(a.K) * Q;
    const long long bitmap_blocks = (words + kBitmapThreads - 1) / kBitmapThreads;
    const long long blocks = (((long long)a.bc + tile - 1) / tile) * groups;
    if (bitmap_blocks > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    sc_bitmap_kernel<Q><<<(unsigned int)bitmap_blocks, kBitmapThreads, 0, stream>>>(
        ranks, cuts, a.ns, a.m, a.K, words, bitmap);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const unsigned int nb = (unsigned int)blocks;
    if (l2) return launch_sweep<Q, 0, MODE, true>(nb, 0, stream, bitmap, groups, tile, a);
    const size_t smem = sweep_smem_bytes(a.ns, a.K, Q);
    switch (a.ns) {
        case 4: return launch_sweep<Q, 4, MODE, false>(nb, smem, stream, bitmap, groups, tile, a);
        case 8: return launch_sweep<Q, 8, MODE, false>(nb, smem, stream, bitmap, groups, tile, a);
        case 16: return launch_sweep<Q, 16, MODE, false>(nb, smem, stream, bitmap, groups, tile, a);
        default: return launch_sweep<Q, 0, MODE, false>(nb, smem, stream, bitmap, groups, tile, a);
    }
}

// Passes (a) and (b) at q queries a sweep block and tile columns a block;
// bitmap is the caller's scratch of ceil(m/q) * ns * W * q words.
template <int MODE>
cudaError_t launch_cells(const int* ranks, const int* cuts, int q, int tile, int l2,
                         unsigned int* bitmap, const SweepArgs& a, cudaStream_t stream) {
    if (tile < 1) return cudaErrorInvalidValue;
    switch (q) {
        case 1: return launch_q<1, MODE>(ranks, cuts, tile, l2 != 0, bitmap, a, stream);
        case 2: return launch_q<2, MODE>(ranks, cuts, tile, l2 != 0, bitmap, a, stream);
        case 4: return launch_q<4, MODE>(ranks, cuts, tile, l2 != 0, bitmap, a, stream);
        case 8: return launch_q<8, MODE>(ranks, cuts, tile, l2 != 0, bitmap, a, stream);
        case 16: return launch_q<16, MODE>(ranks, cuts, tile, l2 != 0, bitmap, a, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int sc_score_cells(const int* ranks, const int* cuts, const int* cells,
                              long long cells_stride, int ns, int m, int K, int bc, int q,
                              int tile, int l2, unsigned int* bitmap, int* scores, void* stream) {
    const SweepArgs a{cells, cells_stride, nullptr, nullptr, ns, m, K, bc, bc,
                      scores, nullptr, nullptr};
    return (int)launch_cells<kScores>(ranks, cuts, q, tile, l2, bitmap, a,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int sc_score_cells_prefilter(const int* ranks, const int* cuts, const int* cells,
                                        long long cells_stride, const int* thr, int ns, int m,
                                        int K, int bc, int q, int tile, int l2,
                                        unsigned int* bitmap, int* scores, uint8_t* keep,
                                        void* stream) {
    const SweepArgs a{cells, cells_stride, thr, nullptr, ns, m, K, bc, bc, scores, keep, nullptr};
    return (int)launch_cells<kKeep>(ranks, cuts, q, tile, l2, bitmap, a,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int sc_score_smem_bytes(int ns, int K, int q) {
    const size_t b = sweep_smem_bytes(ns, K, q);
    return b > (size_t)INT_MAX ? INT_MAX : (int)b;
}

// Row 1: passes (a), (b) and (c); tile_counts is the caller's scratch of
// m * ceil(bc / tile) ints.
extern "C" int sc_score_compact(const int* ranks, const int* cuts, const int* cells,
                                long long cells_stride, const int* thr, const uint8_t* keep_cols,
                                int ns, int m, int K, int bc, int limit, int cap, int q,
                                int tile, int l2, unsigned int* bitmap, int* tile_counts,
                                int* scores, int* surv_cols, int* surv_scores, int* count,
                                void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const SweepArgs a{cells, cells_stride, thr, keep_cols, ns, m, K, bc, limit,
                      scores, nullptr, tile_counts};
    const cudaError_t e = launch_cells<kCompact>(ranks, cuts, q, tile, l2, bitmap, a, st);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = ((long long)bc + tile - 1) / tile;
    const long long blocks = (tiles * m + kCompactWarps - 1) / kCompactWarps;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    sc_compact_kernel<<<(unsigned int)blocks, kCompactThreads, 0, st>>>(
        scores, thr, tile_counts, m, bc, tile, (int)tiles, cap, surv_cols, surv_scores, count);
    return (int)cudaGetLastError();
}
