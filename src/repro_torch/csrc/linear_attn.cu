// Chunked gated linear attention (RWKV6 / GLA / Mamba2-SSD): the outputs o
// and the final state of the recurrence, per head, state S: (dk, dv),
//
//   shift = 1 (rwkv, bonus u):  o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t
//                               S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   shift = 0 (gla / ssd):      S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = q_t S_t
//
// Replaces the TPU kernel linear_attn_kernel of
// src/repro/kernels/linear_attn/kernel.py (pallas_call at :112), in the same
// chunk-parallel log-space form: with lb = cumsum(log clip(w, 1e-6, 1))
// inside a chunk of C tokens and lbq = lb shifted down by `shift` rows,
//
//   inter:  o_t += (q_t * exp(lbq_t)) @ S
//   intra:  A[t, j] = sum_k q_tk k_jk exp(lbq_tk - lb_jk),  j <= t - shift;  o += A @ v
//   bonus:  o_t += (q_t . (u * k_t)) v_t                       (shift = 1)
//   state:  S <- diag(exp(lb_C)) S + (k * exp(lb_C - lb))^T @ v
//
// Sub-blocks.  A is cut into blocks of 16 x 16 (the secondary chunking of
// Gated Linear Attention: Yang et al., ICML 2024, arXiv:2312.06635, sec. 4).
// An off-diagonal block (I, J), J < I, factors its exponent about the
// reference r_I = lb at row 16 I - 1, the last row of block I - 1 (r_0 = 0):
//
//   A_IJ = (q_I * exp(lbq_I - r_I)) @ (k_J * exp(r_I - lb_J))^T.
//
// lb does not increase down a column, so lbq_t <= r_I <= lb_j for every row
// t of block I and column j of block J (shift 1: lbq_t = lb_{t-1} with
// t - 1 >= 16 I - 1; shift 0: lbq_t = lb_t): both factors are <= 1 and
// nothing overflows however small the decay (a factor only underflows in a
// term below ~1e-38 |q_t| |k_j|), and every term of the block is causal.
// (One reference per chunk would overflow: at the clip, w = 1e-6, 64 tokens
// take lb to -884, far past fp32's e^88.7.)  Each row's factor is taken
// once: q becomes q exp(lbq - r_I) in its block I, k becomes k exp(r_{J+1} -
// lb) in its block J (r_{J+1} the reference below block J, lb_C for the
// last), and k exp(r_I - lb) = (k exp(r_{J+1} - lb)) exp(r_I - r_{J+1}), a
// per-dim factor <= 1 of the pair (I, J).  The same rows give the
// inter-chunk and state factors by one more per-dim factor each: q exp(lbq)
// = (q exp(lbq - r_I)) exp(r_I), k exp(lb_C - lb) = (k exp(r_{J+1} - lb))
// exp(lb_C - r_{J+1}).  The diagonal blocks keep the per-term exponent
// exp(lbq_t - lb_j) on the CUDA cores over their 120 entries below the main
// diagonal (8 row pairs (i, 15 - i) of 15 entries, 2 a thread: no masked
// term is taken); the main diagonal's exponent is 0 (shift 0; shift 1
// masks it), so it is the reduction q_t . k_t beside the bonus.
//
// Tensor cores.  The off-diagonal blocks of A, A @ v, (q exp(lbq)) @ S and
// (k exp(lb_C - lb))^T @ v run on mma.sync.m16n8k8 in 3xTF32 (tf32.cuh):
// each fp32 operand is split into a TF32 big part and a TF32 remainder and
// a b is taken as small_a big_b + big_a small_b + big_a big_b, leaving
// under ~3 * 2^-22 of each product (1xTF32 would leave ~2^-11, far past
// the 1e-6 * sum |terms| the outputs are held to).  A bf16 value is exact
// in TF32, so where v is a bf16 input its product is 2 mma, not 3.  Each
// k-step's products go into a fresh tile that is then added to the sum with
// one rounded fp32 add per element, so a sum over k-steps rounds as a
// CUDA-core sum does, not as the tensor core's truncating accumulator.
// Sums keep the plain version's grouping: a chunk's state terms are summed
// apart and added once to the decayed state; A @ v is summed apart and then
// added to the inter-chunk term.
//
// Block.  The TPU kernel carries S in VMEM across the sequential chunk axis
// of its grid.  Hopper runs blocks in no order, so one block of 256 threads
// owns one (head, slice of DVS value columns) pair and walks the chunks in a
// loop, with S[:, slice] in shared memory for the whole sequence (the
// wrapper picks DVS; the dv columns of o and S are independent).  Per chunk
// and slice of 64 dims of k: the q, k and log w tiles are loaded by all
// threads (a thread starts 16 rows' loads before it uses one) and the
// cumulative log-decay is summed down each column in token order from
// registers, as the plain version's cumsum sums it (a scan across threads
// rounds lb otherwise: at Zamba2's decays that alone moved o by 1.2e-6 of
// sum |terms|, past its tolerance); the bonus (or the main diagonal) is a
// reduction over the slice's dims across threads, with u staged once per
// block.  Then A's diagonal blocks (all threads, 64 a block); q and k take
// their sub-block factors in place and the per-dim factors are tabled; A's
// off-diagonal blocks (a warp each), o += (q exp(lbq)) @ S and the state's
// terms on the tensor cores, S updated; after the slices A goes to shared
// memory over q and k and o = inter + A @ v (+ bonus) goes out.  The
// warps share o's tiles as row blocks {i, NB - 1 - i} (the same number of
// A @ v terms for each) and the value n-tiles.  Inputs are bf16 or fp32 and
// are computed in fp32; o is written in the input type, the state in fp32.
// The ragged last chunk is masked as the reference's ops pad it (q = k = v
// = 0, w = 1), so the state is the state after token T - 1.  Widths that
// are not a multiple of 8 (dk, dv) are zero-padded in shared memory.  No
// atomics: every result has the same bits from launch to launch.
//
// Any chunk.  The tile C is a template (16, 32, 64, 128); the chunk c <= C
// is a run-time argument.  The block steps c0 by c and loads cn = min(c,
// T - c0) live rows into the C-row tile; rows cn..C-1 are masked as the
// ragged chunk is (q = k = v = 0, log w = 0), so lb_C = lb_cn, they add
// nothing to A, o or the state, and the tile computes exactly the chunk-c
// recurrence.  The wrapper takes the smallest tile with C >= c.  Tile 16
// has one sub-block (no off-diagonal block); tile 128 has 8 and 28
// off-diagonal blocks.  A chunk above 128 runs as chunks of 128: the same
// recurrence with its sums regrouped, so it is held to its plain version at
// chunk c with the tolerance of every other chunk (fp32 within rtol 1e-4 /
// atol 1e-4, one bf16 ulp in bf16): both are fp32 evaluations of one
// function whose terms are grouped differently, as the kernel's sums already
// are against the plain version's at one chunk.
//
// What bounds it on an H100: bytes.  At the RWKV6 prefill shape (BH = 256,
// T = 2048, dk = dv = 64, C = 64, bf16) it moves ~0.34 GB (0.101 ms at
// 3.35 TB/s); it needs ~0.36 G exponentials and logarithms (per dim and
// chunk: the diagonal blocks' 480 terms, 64 logarithms, 64 q and 64 k
// factors, 15 tabled factors; 0.086 ms at the SFU's 16 a clock per SM),
// ~31 G TF32 operations (0.062 ms at 495 T/s) and ~0.9 G fp32 operations
// on the diagonal blocks (0.013 ms); chip_smoke.py's linear_attn_bound
// counts them from each run's inputs.  The kernel is far from that: each
// block's phases wait at 7 barriers a chunk (one slice) with 16 warps an
// SM to hide latency.  wgmma, TMA and more blocks in flight are for a
// later version.
//
// C entry points:
//   linear_attn(q, k, v, w, u, bh, t, dk, dv, tile, chunk, shift, dvs, bf16, o, state, stream)
//   (tile in {16, 32, 64, 128}, 1 <= chunk <= tile; returns cudaGetLastError())
//   linear_attn_smem_bytes(tile, dk, dvs): a block's shared memory in bytes

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceK = 64;               // dims of k per slice
constexpr int kL = 16;                    // rows of a sub-block
constexpr int kLdK = kSliceK + 4;         // row of the q / k / lb tiles (16-byte rows,
                                          // conflict-free fragment reads)
constexpr int kSeg = kThreads / kSliceK;  // row segments of the q / k / w loads
constexpr int kBatch = 16;                // rows a thread loads before using any
constexpr float kEps = 1e-6f;

__host__ __device__ constexpr int ld_v(int dvs) { return dvs + 8; }  // conflict-free B reads
__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Rows of per-dim factors between a tile's references: exp(r_I) and
// exp(lb_C - r_{J+1}) per sub-block, exp(r_I - r_{J+1}) per off-diagonal
// block (I, J), exp(lb_C).
__host__ __device__ constexpr int n_factors(int c) {
    return 2 * (c / kL) + (c / kL) * (c / kL - 1) / 2 + 1;
}

// Shared memory of one block, in floats (linear_attn_smem_bytes gives it to
// the wrapper).
__host__ __device__ inline size_t smem_floats(int c, int dk, int dvs) {
    return 2 * (size_t)c * kLdK              // q, k (then q exp(lbq), k exp(lb_C - lb); then A)
           + (size_t)(c + 1) * kLdK          // lb, row 0 zeros
           + (size_t)c * ld_v(dvs)           // v
           + (size_t)round8(dk) * ld_v(dvs)  // S[:, slice], rows padded to 8
           + round8(dk)                      // u
           + c                               // the bonus, or A's main diagonal
           + (size_t)n_factors(c) * kSliceK;  // exp(r_I), exp(lb_C - r_J+1), exp(r_I - r_J+1), exp(lb_C)
}

// An operand element as TF32 parts: split in two, or (EXACT: a bf16 value,
// exact in TF32) taken whole.
template <bool EXACT>
__device__ __forceinline__ void tf32_parts(float x, unsigned& big, unsigned& small) {
    if (EXACT) {
        big = __float_as_uint(x);
        small = 0u;
    } else {
        split_tf32(x, big, small);
    }
}

// d += a b in 3xTF32 (2 products when b is exact in TF32): the products go
// into a fresh tile, the small terms first, then the tile is added to d.
template <bool B_EXACT>
__device__ __forceinline__ void mma_3x(float (&d)[4], const unsigned (&ab)[4],
                                       const unsigned (&as)[4], const unsigned (&bb)[2],
                                       const unsigned (&bs)[2]) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, as, bb);
    if (!B_EXACT) mma_tf32(t, ab, bs);
    mma_tf32(t, ab, bb);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// The A fragment (rows r0 + g, r0 + g + 8; columns c0 + tq, c0 + tq + 4) of
// a row-major fp32 tile, each column times scale[column] (when given), split.
__device__ __forceinline__ void a_frag(const float* p, int ld, int r0, int c0, int g, int tq,
                                       const float* scale, unsigned (&ab)[4], unsigned (&as)[4]) {
    const float sa = scale ? scale[c0 + tq] : 1.f, sb = scale ? scale[c0 + tq + 4] : 1.f;
    split_tf32(p[(r0 + g) * ld + c0 + tq] * sa, ab[0], as[0]);
    split_tf32(p[(r0 + g + 8) * ld + c0 + tq] * sa, ab[1], as[1]);
    split_tf32(p[(r0 + g) * ld + c0 + tq + 4] * sb, ab[2], as[2]);
    split_tf32(p[(r0 + g + 8) * ld + c0 + tq + 4] * sb, ab[3], as[3]);
}

// Off-diagonal block p (0-based, in the order (1, 0), (2, 0), (2, 1), ...)
// as its row block bi and column block bj < bi.
__device__ __forceinline__ void off_block(int p, int& bi, int& bj) {
    bi = 1;
    bj = p;
    while (bj >= bi) {
        bj -= bi;
        ++bi;
    }
}

template <typename T, int C, int DVS>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
linear_attn_kernel(const T* __restrict__ q,  // (BH, T, dk)
                   const T* __restrict__ k,  // (BH, T, dk)
                   const T* __restrict__ v,  // (BH, T, dv)
                   const T* __restrict__ w,  // (BH, T, dk)
                   const T* __restrict__ u,  // (BH, 1, dk)
                   int t_len, int dk, int dv, int chunk, int shift,
                   T* __restrict__ o,        // (BH, T, dv)
                   float* __restrict__ state)  // (BH, dk, dv)
{
    constexpr bool kExactV = sizeof(T) == 2;  // bf16 values are exact in TF32
    constexpr int NB = C / kL;                // sub-blocks of the tile
    constexpr int NTV = DVS / 8;              // n-tiles of the value slice
    constexpr int LDV = ld_v(DVS);
    constexpr int LDA = C + 4;
    // o: the warps form NG groups, each owning row blocks {i, NB - 1 - i}
    // (one block when NB = 1), its WPG warps ONT value n-tiles each
    constexpr int RPG = NB > 1 ? 2 : 1;
    constexpr int NG = NB / RPG;
    constexpr int WPG = kWarps / NG;
    constexpr int ONT = NTV / WPG > 0 ? NTV / WPG : 1;
    // the slice's state: 4 m-tiles of 16 dims, each of two warps half the n-tiles
    constexpr int SNT = NTV / 2;
    // off-diagonal blocks of A, round-robin over the warps
    constexpr int NP = NB * (NB - 1) / 2;
    constexpr int OPW = NP > 0 ? (NP + kWarps - 1) / kWarps : 1;
    // diagonal blocks of A: 64 threads a block, DR rounds
    constexpr int DR = (NB * 64 + kThreads - 1) / kThreads;
    constexpr int RS = C / kSeg;                    // rows a thread loads a slice
    constexpr int NBATCH = RS < kBatch ? RS : kBatch;
    constexpr int VPT = C * DVS / kThreads;         // value elements a thread loads
    static_assert(C * DVS % kThreads == 0 && RS % NBATCH == 0, "tile shapes");
    static_assert((size_t)C * LDA <= 2 * (size_t)C * kLdK, "A fits over q and k");

    extern __shared__ __align__(16) float smem[];
    const int dkp = round8(dk);
    float* qs = smem;                    // C x kLdK
    float* ks = qs + C * kLdK;           // C x kLdK
    float* lbs = ks + C * kLdK;          // (C + 1) x kLdK: row t + 1 holds lb_t
    float* vs = lbs + (C + 1) * kLdK;    // C x LDV
    float* ss = vs + C * LDV;            // dkp x LDV
    float* us = ss + dkp * LDV;          // dkp
    float* diag = us + dkp;              // C: the bonus (shift 1) or A's main diagonal (shift 0)
    float* ev = diag + C;                // NB x kSliceK: exp(r_I), r_I = lb_{16 I - 1}, r_0 = 0
    float* fv = ev + NB * kSliceK;       // NB x kSliceK: exp(lb_C - r_{J+1})
    float* dm = fv + NB * kSliceK;       // NP x kSliceK: exp(r_I - r_{J+1}), block (I, J)
    float* dec = dm + NP * kSliceK;      // kSliceK: exp(lb_C)
    float* as = qs;                      // C x LDA, after the slices

    const int bh = blockIdx.x;
    const int v0 = blockIdx.y * DVS;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;  // mma fragment coordinates
    const long long qk_base = (long long)bh * t_len * dk;
    const long long v_base = (long long)bh * t_len * dv;
    // this warp's o tiles: row blocks orow(0), orow(RPG - 1), n-tiles on * ONT ...
    const int og = warp / WPG, on = warp % WPG;
    const bool o_live = on * ONT < NTV;
    auto orow = [&](int r) { return (r == 0 ? og : NB - 1 - og) * kL; };
    // this thread's entries (dt0, dj0), (dt1, dj1) of a diagonal block: its
    // 120 entries below the main diagonal as 8 row pairs (pr, 15 - pr) of 15,
    // 8 threads a pair, 2 entries a thread (the pair's last thread 1)
    const int dpr = (tid % 64) / 8, ds = tid % 8;
    const int dt0 = ds < dpr ? dpr : kL - 1 - dpr, dj0 = ds < dpr ? ds : ds - dpr;
    const int dt1 = kL - 1 - dpr, dj1 = ds < 7 ? ds + 8 - dpr : 0;
    const bool d_two = ds < 7;

    for (int e = tid; e < dkp * LDV; e += kThreads) ss[e] = 0.f;
    for (int e = tid; e < dkp; e += kThreads)
        us[e] = e < dk ? to_f32(u[(long long)bh * dk + e]) : 0.f;

    for (int c0 = 0; c0 < t_len; c0 += chunk) {
        const int cn = min(chunk, t_len - c0);  // live tokens of this chunk (<= C)
        __syncthreads();  // the previous chunk is done with vs, as, diag
        {
            T vr[VPT];
#pragma unroll
            for (int i = 0; i < VPT; ++i) {
                const int e = tid + i * kThreads;
                const int t = e / DVS, col = e - t * DVS;
                vr[i] = (t < cn && v0 + col < dv) ? v[v_base + (long long)(c0 + t) * dv + v0 + col]
                                                  : T(0.f);
            }
#pragma unroll
            for (int i = 0; i < VPT; ++i) {
                const int e = tid + i * kThreads;
                const int t = e / DVS, col = e - t * DVS;
                vs[t * LDV + col] = to_f32(vr[i]);
            }
        }
        if (tid < C) diag[tid] = 0.f;
        float acc_o[RPG][ONT][4] = {};  // (q exp(lbq)) @ S, over the slices
        float acc_d[DR][2] = {};        // this thread's diagonal-block entries of A
        float acc_x[OPW][2][4] = {};    // this warp's off-diagonal blocks of A

        for (int k0 = 0; k0 < dk; k0 += kSliceK) {
            const int kn = min(kSliceK, dk - k0);
            // the previous slice is done with qs, ks, lbs (for the first slice,
            // the barrier at the chunk's start: the last output pass read A there)
            if (k0 > 0) __syncthreads();
            {   // q, k and log w of the slice, every load of a batch started first
                const int kk = tid % kSliceK, seg = tid / kSliceK;
#pragma unroll 1
                for (int b0 = 0; b0 < RS; b0 += NBATCH) {
                    T qr[NBATCH], kr[NBATCH], wr[NBATCH];
#pragma unroll
                    for (int i = 0; i < NBATCH; ++i) {
                        const int t = seg * RS + b0 + i;
                        const bool live = t < cn && kk < kn;
                        const long long gi = qk_base + (long long)(c0 + t) * dk + k0 + kk;
                        qr[i] = live ? q[gi] : T(0.f);
                        kr[i] = live ? k[gi] : T(0.f);
                        wr[i] = live ? w[gi] : T(1.f);  // padded tokens decay by 1 (log 0)
                    }
#pragma unroll
                    for (int i = 0; i < NBATCH; ++i) {
                        const int t = seg * RS + b0 + i;
                        qs[t * kLdK + kk] = to_f32(qr[i]);
                        ks[t * kLdK + kk] = to_f32(kr[i]);
                        lbs[(t + 1) * kLdK + kk] = logf(fminf(fmaxf(to_f32(wr[i]), kEps), 1.f));
                    }
                }
                if (seg == 0) lbs[kk] = 0.f;
            }
            __syncthreads();
            if (tid < kSliceK) {  // lb: the sum down each column in token order, as the
                // plain version's cumsum takes it (another order rounds lb otherwise,
                // and at strong decays that moves a term by more than its tolerance)
                float run = 0.f;
#pragma unroll 1
                for (int b0 = 0; b0 < C; b0 += kBatch) {
                    float x[kBatch];
#pragma unroll
                    for (int i = 0; i < kBatch; ++i) x[i] = b0 + i < C ? lbs[(b0 + i + 1) * kLdK + tid] : 0.f;
#pragma unroll
                    for (int i = 0; i < kBatch; ++i) {
                        run += x[i];
                        if (b0 + i < C) lbs[(b0 + i + 1) * kLdK + tid] = run;
                    }
                }
            }
            __syncthreads();
            {   // the bonus q_t . (u * k_t) (shift 1), or A's main diagonal q_t . k_t,
                // whose exponent is 0 (shift 0): a reduction, TPR threads a row
                constexpr int TPR = kThreads / C;
                const int t = tid / TPR, part = tid % TPR;
                float a = 0.f;
                for (int kk = part; kk < kn; kk += TPR)
                    a += shift ? qs[t * kLdK + kk] * us[k0 + kk] * ks[t * kLdK + kk]
                               : qs[t * kLdK + kk] * ks[t * kLdK + kk];
#pragma unroll
                for (int off = TPR / 2; off > 0; off /= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
                if (part == 0) diag[t] += a;
            }
            // A's diagonal blocks below their main diagonal on the CUDA cores:
            // the per-term exponent exp(lbq_t - lb_j) <= 0, 4 dims a step
#pragma unroll
            for (int r = 0; r < DR; ++r) {
                const int blk = tid / 64 + r * (kThreads / 64);
                if (blk < NB) {
                    const int b0 = blk * kL;
                    const float* qa = qs + (b0 + dt0) * kLdK;
                    const float* la = lbs + (b0 + dt0 + 1 - shift) * kLdK;
                    const float* ka = ks + (b0 + dj0) * kLdK;
                    const float* ma = lbs + (b0 + dj0 + 1) * kLdK;
                    const float* qb = qs + (b0 + dt1) * kLdK;
                    const float* lb1 = lbs + (b0 + dt1 + 1 - shift) * kLdK;
                    const float* kb = ks + (b0 + dj1) * kLdK;
                    const float* mb = lbs + (b0 + dj1 + 1) * kLdK;
                    float s0 = 0.f, s1 = 0.f;
                    for (int kk = 0; kk < kn; kk += 4) {
                        const float4 q4a = ld4(qa + kk), l4a = ld4(la + kk);
                        const float4 k4a = ld4(ka + kk), m4a = ld4(ma + kk);
                        const float4 q4b = ld4(qb + kk), l4b = ld4(lb1 + kk);
                        const float4 k4b = ld4(kb + kk), m4b = ld4(mb + kk);
#define REPRO_LA_TERMS(x)                                      \
    s0 += q4a.x * k4a.x * __expf(l4a.x - m4a.x);               \
    s1 += q4b.x * k4b.x * __expf(l4b.x - m4b.x);
                        REPRO_LA_TERMS(x)
                        REPRO_LA_TERMS(y)
                        REPRO_LA_TERMS(z)
                        REPRO_LA_TERMS(w)
#undef REPRO_LA_TERMS
                    }
                    acc_d[r][0] += s0;
                    acc_d[r][1] += d_two ? s1 : 0.f;
                }
            }
            __syncthreads();
            // in place: q <- q exp(lbq - r_I) in block I, k <- k exp(r_{J+1} - lb)
            // in block J (r_NB = lb_C); both exponents <= 0
            for (int e = tid; e < C * kSliceK; e += kThreads) {
                const int t = e / kSliceK;
                const int kk = e - t * kSliceK;
                const int b0 = t / kL * kL;
                qs[t * kLdK + kk] *= __expf(lbs[(t + 1 - shift) * kLdK + kk] - lbs[b0 * kLdK + kk]);
                ks[t * kLdK + kk] *= __expf(lbs[(b0 + kL) * kLdK + kk] - lbs[(t + 1) * kLdK + kk]);
            }
            // the factors between references, each <= 1
            for (int e = tid; e < n_factors(C) * kSliceK; e += kThreads) {
                const int row = e / kSliceK;
                const int kk = e - row * kSliceK;
                float x;
                if (row < NB) {
                    x = lbs[row * kL * kLdK + kk];
                } else if (row < 2 * NB) {
                    x = lbs[C * kLdK + kk] - lbs[(row - NB + 1) * kL * kLdK + kk];
                } else if (row < 2 * NB + NP) {
                    int bi, bj;
                    off_block(row - 2 * NB, bi, bj);
                    x = lbs[bi * kL * kLdK + kk] - lbs[(bj + 1) * kL * kLdK + kk];
                } else {
                    x = lbs[C * kLdK + kk];
                }
                ev[e] = __expf(x);
            }
            __syncthreads();
            // A's off-diagonal blocks on the tensor cores, factored about r_I:
            // (q exp(lbq - r_I)) @ (k exp(r_{J+1} - lb) exp(r_I - r_{J+1}))^T
            if constexpr (NP > 0) {
#pragma unroll
                for (int i = 0; i < OPW; ++i) {
                    const int p = warp + i * kWarps;
                    if (p < NP) {
                        int bi, bj;
                        off_block(p, bi, bj);
                        const float* dmp = dm + p * kSliceK;
                        for (int k8 = 0; k8 < kn; k8 += 8) {
                            const int ka = k8 + tq, kb = ka + 4;
                            const float da = dmp[ka], db = dmp[kb];
                            unsigned ab[4], as_[4];
                            a_frag(qs, kLdK, bi * kL, k8, g, tq, nullptr, ab, as_);
#pragma unroll
                            for (int nt = 0; nt < 2; ++nt) {
                                const int j = bj * kL + nt * 8 + g;
                                unsigned bb[2], bs[2];
                                split_tf32(ks[j * kLdK + ka] * da, bb[0], bs[0]);
                                split_tf32(ks[j * kLdK + kb] * db, bb[1], bs[1]);
                                mma_3x<false>(acc_x[i][nt], ab, as_, bb, bs);
                            }
                        }
                    }
                }
            }
            // inter-chunk: o += (q exp(lbq)) @ S, S as it stood at the chunk's
            // start; q exp(lbq) = q exp(lbq - r_I) exp(r_I)
            if (o_live) {
                for (int k8 = 0; k8 < kn; k8 += 8) {
                    unsigned sb[ONT][2], sm[ONT][2];
#pragma unroll
                    for (int n = 0; n < ONT; ++n) {
                        const int col = (on * ONT + n) * 8 + g;
                        split_tf32(ss[(k0 + k8 + tq) * LDV + col], sb[n][0], sm[n][0]);
                        split_tf32(ss[(k0 + k8 + tq + 4) * LDV + col], sb[n][1], sm[n][1]);
                    }
#pragma unroll
                    for (int r = 0; r < RPG; ++r) {
                        unsigned ab[4], as_[4];
                        a_frag(qs, kLdK, orow(r), k8, g, tq, ev + orow(r) / kL * kSliceK, ab, as_);
#pragma unroll
                        for (int n = 0; n < ONT; ++n) mma_3x<false>(acc_o[r][n], ab, as_, sb[n], sm[n]);
                    }
                }
            }
            // the slice's state terms (k exp(lb_C - lb))^T @ v, summed apart;
            // k exp(lb_C - lb) = k exp(r_{J+1} - lb) exp(lb_C - r_{J+1})
            const int sm_t = warp % 4, sn = warp / 4;
            float acc_s[SNT][4] = {};
            if (sm_t * 16 < kn) {
                for (int t8 = 0; t8 < C; t8 += 8) {
                    // A = (k exp(lb_C - lb))^T: row = dim, column = token
                    const int kr = sm_t * 16 + g, t_a = t8 + tq, t_b = t_a + 4;
                    const float* fvr = fv + t8 / kL * kSliceK;
                    const float f0 = fvr[kr], f8 = fvr[kr + 8];
                    unsigned ab[4], as_[4];
                    split_tf32(ks[t_a * kLdK + kr] * f0, ab[0], as_[0]);
                    split_tf32(ks[t_a * kLdK + kr + 8] * f8, ab[1], as_[1]);
                    split_tf32(ks[t_b * kLdK + kr] * f0, ab[2], as_[2]);
                    split_tf32(ks[t_b * kLdK + kr + 8] * f8, ab[3], as_[3]);
#pragma unroll
                    for (int n = 0; n < SNT; ++n) {
                        const int col = (sn * SNT + n) * 8 + g;
                        unsigned bb[2], bs[2];
                        tf32_parts<kExactV>(vs[t_a * LDV + col], bb[0], bs[0]);
                        tf32_parts<kExactV>(vs[t_b * LDV + col], bb[1], bs[1]);
                        mma_3x<kExactV>(acc_s[n], ab, as_, bb, bs);
                    }
                }
            }
            __syncthreads();  // every warp is done reading S, q and k
            // S <- diag(exp(lb_C)) S + the slice's terms: added to the decayed
            // state once (one by one, each would round at the state's scale)
            if (sm_t * 16 < kn) {
#pragma unroll
                for (int n = 0; n < SNT; ++n) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int kk = sm_t * 16 + g + 8 * h;
                        if (kk < kn) {
                            float* sp = ss + (k0 + kk) * LDV + (sn * SNT + n) * 8 + 2 * tq;
                            sp[0] = dec[kk] * sp[0] + acc_s[n][2 * h];
                            sp[1] = dec[kk] * sp[1] + acc_s[n][2 * h + 1];
                        }
                    }
                }
            }
        }
        // A into shared memory over q and k (no warp reads them any more):
        // the diagonal blocks masked, the off-diagonal ones, nothing above
#pragma unroll
        for (int r = 0; r < DR; ++r) {
            const int blk = tid / 64 + r * (kThreads / 64);
            if (blk < NB) {  // each entry, its mirror above the diagonal (0), the diagonal
                const int b0 = blk * kL;
                as[(b0 + dt0) * LDA + b0 + dj0] = acc_d[r][0];
                as[(b0 + dj0) * LDA + b0 + dt0] = 0.f;
                if (d_two) {
                    as[(b0 + dt1) * LDA + b0 + dj1] = acc_d[r][1];
                    as[(b0 + dj1) * LDA + b0 + dt1] = 0.f;
                }
                if (ds < 2) {
                    const int tt = b0 + 2 * dpr + ds;
                    as[tt * LDA + tt] = shift ? 0.f : diag[tt];
                }
            }
        }
        if constexpr (NP > 0) {
#pragma unroll
            for (int i = 0; i < OPW; ++i) {
                const int p = warp + i * kWarps;
                if (p < NP) {
                    int bi, bj;
                    off_block(p, bi, bj);
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            float* ap = as + (bi * kL + g + 8 * h) * LDA + bj * kL + nt * 8 + 2 * tq;
                            ap[0] = acc_x[i][nt][2 * h];
                            ap[1] = acc_x[i][nt][2 * h + 1];
                        }
                    }
                }
            }
        }
        __syncthreads();
        // o = (q exp(lbq)) @ S + A @ v (+ the bonus); the chunk's live rows go out
        if (o_live) {
#pragma unroll
            for (int r = 0; r < RPG; ++r) {
                const int t0 = orow(r);
                float av[ONT][4] = {};  // A @ v summed apart, then added, as for the state
                for (int j8 = 0; j8 < t0 + kL; j8 += 8) {
                    unsigned ab[4], as_[4];
                    a_frag(as, LDA, t0, j8, g, tq, nullptr, ab, as_);
#pragma unroll
                    for (int n = 0; n < ONT; ++n) {
                        const int col = (on * ONT + n) * 8 + g;
                        unsigned bb[2], bs[2];
                        tf32_parts<kExactV>(vs[(j8 + tq) * LDV + col], bb[0], bs[0]);
                        tf32_parts<kExactV>(vs[(j8 + tq + 4) * LDV + col], bb[1], bs[1]);
                        mma_3x<kExactV>(av[n], ab, as_, bb, bs);
                    }
                }
#pragma unroll
                for (int n = 0; n < ONT; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int t = t0 + g + 8 * (e / 2);
                        const int col = (on * ONT + n) * 8 + 2 * tq + (e % 2);
                        float a = acc_o[r][n][e] + av[n][e];
                        if (shift) a += diag[t] * vs[t * LDV + col];
                        if (t < cn && v0 + col < dv)
                            store(&o[v_base + (long long)(c0 + t) * dv + v0 + col], a);
                    }
                }
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < dk * DVS; e += kThreads) {
        const int kk = e / DVS;
        const int col = e - kk * DVS;
        if (v0 + col < dv) state[((long long)bh * dk + kk) * dv + v0 + col] = ss[kk * LDV + col];
    }
}

template <typename T, int C, int DVS>
int launch(const void* q, const void* k, const void* v, const void* w, const void* u, int bh,
           int t, int dk, int dv, int chunk, int shift, void* o, float* state,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) * smem_floats(C, dk, DVS);
    auto kern = linear_attn_kernel<T, C, DVS>;
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(bh, (dv + DVS - 1) / DVS);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(u), t, dk, dv, chunk, shift,
        static_cast<T*>(o), state);
    return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_c(const void* q, const void* k, const void* v, const void* w, const void* u, int bh,
             int t, int dk, int dv, int chunk, int shift, int dvs, void* o, float* state,
             cudaStream_t st) {
    if (chunk < 1 || chunk > C) return (int)cudaErrorInvalidValue;
#define REPRO_LA(DVS) \
    return launch<T, C, DVS>(q, k, v, w, u, bh, t, dk, dv, chunk, shift, o, state, st)
    if (dvs == 16) REPRO_LA(16);
    if (dvs == 32) REPRO_LA(32);
    if (dvs == 64) REPRO_LA(64);
#undef REPRO_LA
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* w, const void* u, int bh,
             int t, int dk, int dv, int tile, int chunk, int shift, int dvs, void* o,
             float* state, cudaStream_t st) {
#define REPRO_LA(C) \
    return launch_c<T, C>(q, k, v, w, u, bh, t, dk, dv, chunk, shift, dvs, o, state, st)
    if (tile == 16) REPRO_LA(16);
    if (tile == 32) REPRO_LA(32);
    if (tile == 64) REPRO_LA(64);
    if (tile == 128) REPRO_LA(128);
#undef REPRO_LA
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int linear_attn(const void* q, const void* k, const void* v, const void* w,
                           const void* u, int bh, int t, int dk, int dv, int tile, int chunk,
                           int shift, int dvs, int bf16, void* o, float* state, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return launch_t<__nv_bfloat16>(q, k, v, w, u, bh, t, dk, dv, tile, chunk, shift, dvs, o,
                                       state, st);
    return launch_t<float>(q, k, v, w, u, bh, t, dk, dv, tile, chunk, shift, dvs, o, state, st);
}

extern "C" int linear_attn_smem_bytes(int tile, int dk, int dvs) {
    const size_t bytes = sizeof(float) * smem_floats(tile, dk, dvs);
    return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}
