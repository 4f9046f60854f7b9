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
// Every exponent is a difference of monotone log-decays, <= 0, so nothing
// overflows however small the decay.  The exponent is never factored into
// exp(lbq - r) * exp(r - lb) (which would let tensor cores take the product
// but overflows for small decays).
//
// Design.  The TPU kernel carries S in VMEM across the sequential chunk axis
// of its grid and builds a (C, C, dk) decay tensor.  Hopper runs blocks in
// no order, so one block owns one (head, slice of DVS value columns) pair
// and walks the chunks in a loop, with S[:, slice] in shared memory for the
// whole sequence; the dv columns of o and S are independent, so splitting dv
// fills the card when there are few heads (the wrapper picks DVS).  No decay
// tensor is built: A is summed over k in slices of 64 dims, each term's
// exponent taken on the fly.  256 threads form a 16 x 16 grid; a thread
// owns the (C/16)^2 entries of A and the (C/16) x (DVS/16) entries of o at
// rows ti + 16r and columns tj + 16c, in registers, so rows and columns
// interleave and shared-memory reads are conflict-free (tiles padded to 65
// floats a row).  Inputs are bf16 or fp32 and are computed in fp32; o is
// written in the input type, the state in fp32.  The ragged last chunk is
// masked in the kernel as the reference's ops pad it (q = k = v = 0,
// w = 1), so the state is the state after token T - 1.
//
// Any chunk.  The tile C is a template (16, 32, 64, 128); the chunk c <= C
// is a run-time argument.  The block steps c0 by c and loads cn = min(c,
// T - c0) live rows into the C-row tile; rows cn..C-1 are masked as the
// ragged chunk is (q = k = v = 0, log w = 0), so lb_C = lb_cn, they add
// nothing to A, o or the state, and the tile computes exactly the chunk-c
// recurrence.  The wrapper takes the smallest tile with C >= c, so chunks
// 16, 32 and 64 run the code they always ran (c == C).  A chunk above 128
// runs as chunks of 128: the same recurrence with its sums regrouped, so it
// is held to its plain version at chunk c with the tolerance of every
// other chunk (fp32 within rtol 1e-4 / atol 1e-4, one bf16 ulp in bf16):
// both are fp32 evaluations of one function whose terms are grouped
// differently, as the kernel's sums already are against the plain
// version's at one chunk.
//
// What bounds it on an H100: operations.  At the RWKV6 prefill shape (BH =
// 256, T = 2048, dk = dv = 64, C = 64) it moves ~0.34 GB (0.1 ms at
// 3.35 TB/s) but takes ~C^2/2 * dk exponentials and three C x C x 64
// products per chunk (~16 G operations, ~0.25 ms at 67 T/s); the
// exponentials go to the SFU at 1/8 of the fp32 rate (__expf: with expf
// the kernel was ~10% slower and its error against an fp64 scan no smaller,
// since a term whose exponent is far below 0 adds almost nothing).
// This first version is SIMT fp32 and computes the whole C x C square of
// A (the masked half with its exponent clamped to 0 and discarded) so no
// warp diverges on the causal mask; wgmma and TMA are for a later version.
//
// C entry point (returns cudaGetLastError()):
//   linear_attn(q, k, v, w, u, bh, t, dk, dv, tile, chunk, shift, dvs, bf16, o, state, stream)
//   (tile in {16, 32, 64, 128}, 1 <= chunk <= tile)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;    // the threads form a kGrid x kGrid grid
constexpr int kSliceK = 64;  // dims of k per slice
constexpr int kLd = kSliceK + 1;  // padded row of the q / k / lb tiles
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Shared memory of one block, in floats.
__host__ __device__ inline size_t smem_floats(int c, int dk, int dvs) {
    return 2 * (size_t)c * kLd        // q, k (then q exp(lbq), k exp(lb_C - lb); then A)
           + (size_t)(c + 1) * kLd    // lb, row 0 zeros
           + (size_t)c * dvs          // v
           + (size_t)dk * dvs         // S[:, slice]
           + c + kSliceK;             // bonus diagonal, exp(lb_C)
}

template <typename T, int C, int DVS>
__global__ void __launch_bounds__(kThreads)
linear_attn_kernel(const T* __restrict__ q,  // (BH, T, dk)
                   const T* __restrict__ k,  // (BH, T, dk)
                   const T* __restrict__ v,  // (BH, T, dv)
                   const T* __restrict__ w,  // (BH, T, dk)
                   const T* __restrict__ u,  // (BH, 1, dk)
                   int t_len, int dk, int dv, int chunk, int shift,
                   T* __restrict__ o,        // (BH, T, dv)
                   float* __restrict__ state)  // (BH, dk, dv)
{
    constexpr int R = C / kGrid;         // rows t (and columns j) of A per thread
    constexpr int RV = DVS / kGrid;      // value columns per thread
    constexpr int RK = kSliceK / kGrid;  // state rows per thread and slice
    extern __shared__ float smem[];
    float* qs = smem;                  // C x kLd
    float* ks = qs + C * kLd;          // C x kLd
    float* lbs = ks + C * kLd;         // (C + 1) x kLd: row t + 1 holds lb_t
    float* vs = lbs + (C + 1) * kLd;   // C x DVS
    float* ss = vs + C * DVS;          // dk x DVS
    float* diag = ss + dk * DVS;       // C
    float* dec = diag + C;             // kSliceK
    float* as = qs;                    // C x (C + 1), after the slices

    const int bh = blockIdx.x;
    const int v0 = blockIdx.y * DVS;
    const int tid = threadIdx.x;
    const int ti = tid / kGrid;
    const int tj = tid % kGrid;
    const long long qk_base = (long long)bh * t_len * dk;
    const long long v_base = (long long)bh * t_len * dv;

    for (int e = tid; e < dk * DVS; e += kThreads) ss[e] = 0.f;

    for (int c0 = 0; c0 < t_len; c0 += chunk) {
        const int cn = min(chunk, t_len - c0);  // live tokens of this chunk (<= C)
        __syncthreads();  // the previous chunk is done with vs, as, diag
        for (int e = tid; e < C * DVS; e += kThreads) {
            const int t = e / DVS;
            const int col = e - t * DVS;
            vs[e] = (t < cn && v0 + col < dv)
                        ? to_f32(v[v_base + (long long)(c0 + t) * dv + v0 + col]) : 0.f;
        }
        if (tid < C) diag[tid] = 0.f;
        float acc_a[R][R];
        float acc_o[R][RV];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int c = 0; c < R; ++c) acc_a[r][c] = 0.f;
#pragma unroll
            for (int c = 0; c < RV; ++c) acc_o[r][c] = 0.f;
        }

        for (int k0 = 0; k0 < dk; k0 += kSliceK) {
            const int kn = min(kSliceK, dk - k0);
            __syncthreads();  // the previous slice is done with qs, ks, lbs
            for (int e = tid; e < C * kSliceK; e += kThreads) {
                const int t = e / kSliceK;
                const int kk = e - t * kSliceK;
                const bool live = t < cn && kk < kn;
                const long long g = qk_base + (long long)(c0 + t) * dk + k0 + kk;
                qs[t * kLd + kk] = live ? to_f32(q[g]) : 0.f;
                ks[t * kLd + kk] = live ? to_f32(k[g]) : 0.f;
                // padded tokens decay by 1 (log 0): they leave the state as it is
                lbs[(t + 1) * kLd + kk] = live ? logf(fminf(fmaxf(to_f32(w[g]), kEps), 1.f)) : 0.f;
            }
            if (tid < kSliceK) lbs[tid] = 0.f;
            __syncthreads();
            if (tid < kSliceK) {  // cumulative log decay down each column
                float run = 0.f;
                for (int t = 1; t <= C; ++t) {
                    run += lbs[t * kLd + tid];
                    lbs[t * kLd + tid] = run;
                }
            } else if (shift && tid < kSliceK + C) {  // the bonus diagonal q_t . (u * k_t)
                const int t = tid - kSliceK;
                float a = diag[t];
                for (int kk = 0; kk < kn; ++kk)
                    a += qs[t * kLd + kk] * to_f32(u[(long long)bh * dk + k0 + kk]) * ks[t * kLd + kk];
                diag[t] = a;
            }
            __syncthreads();
            // intra-chunk scores over this slice's dims
#pragma unroll 2
            for (int kk = 0; kk < kn; ++kk) {
                float qv[R], lq[R], kv[R], lk[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int t = ti + kGrid * r;
                    qv[r] = qs[t * kLd + kk];
                    lq[r] = lbs[(t + 1 - shift) * kLd + kk];
                    kv[r] = ks[(tj + kGrid * r) * kLd + kk];
                    lk[r] = lbs[(tj + kGrid * r + 1) * kLd + kk];
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
#pragma unroll
                    for (int c = 0; c < R; ++c)
                        acc_a[r][c] += qv[r] * kv[c] * __expf(fminf(lq[r] - lk[c], 0.f));
                }
            }
            __syncthreads();
            // q <- q exp(lbq), k <- k exp(lb_C - lb); dec = exp(lb_C)
            for (int e = tid; e < C * kSliceK; e += kThreads) {
                const int t = e / kSliceK;
                const int kk = e - t * kSliceK;
                qs[t * kLd + kk] *= __expf(lbs[(t + 1 - shift) * kLd + kk]);
                ks[t * kLd + kk] *= __expf(lbs[C * kLd + kk] - lbs[(t + 1) * kLd + kk]);
            }
            if (tid < kSliceK) dec[tid] = __expf(lbs[C * kLd + tid]);
            __syncthreads();
            // inter-chunk: o += (q exp(lbq)) @ S, S as it stood at the chunk's start
#pragma unroll 2
            for (int kk = 0; kk < kn; ++kk) {
                float qv[R], sv[RV];
#pragma unroll
                for (int r = 0; r < R; ++r) qv[r] = qs[(ti + kGrid * r) * kLd + kk];
#pragma unroll
                for (int c = 0; c < RV; ++c) sv[c] = ss[(k0 + kk) * DVS + tj + kGrid * c];
#pragma unroll
                for (int r = 0; r < R; ++r) {
#pragma unroll
                    for (int c = 0; c < RV; ++c) acc_o[r][c] += qv[r] * sv[c];
                }
            }
            __syncthreads();
            // state: S <- diag(exp(lb_C)) S + (k exp(lb_C - lb))^T @ v
#pragma unroll 1
            for (int r = 0; r < RK; ++r) {
                const int kk = ti + kGrid * r;
                if (kk < kn) {
                    // the chunk's C terms summed apart, then added to the
                    // decayed state once (as the plain version does): added
                    // one by one to the larger state, each would round at
                    // the state's scale
                    float sacc[RV];
#pragma unroll
                    for (int c = 0; c < RV; ++c) sacc[c] = 0.f;
#pragma unroll 4
                    for (int t = 0; t < C; ++t) {
                        const float kt = ks[t * kLd + kk];
#pragma unroll
                        for (int c = 0; c < RV; ++c) sacc[c] += kt * vs[t * DVS + tj + kGrid * c];
                    }
#pragma unroll
                    for (int c = 0; c < RV; ++c) {
                        float* sp = &ss[(k0 + kk) * DVS + tj + kGrid * c];
                        *sp = dec[kk] * *sp + sacc[c];
                    }
                }
            }
        }
        __syncthreads();  // every slice is done with qs: A takes its place
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int t = ti + kGrid * r;
#pragma unroll
            for (int c = 0; c < R; ++c) {
                const int j = tj + kGrid * c;
                as[t * (C + 1) + j] = (j <= t - shift) ? acc_a[r][c] : 0.f;
            }
        }
        __syncthreads();
        // o += A @ v (+ the bonus), then the chunk's live rows go out
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int t = ti + kGrid * r;
#pragma unroll
            for (int c = 0; c < RV; ++c) {
                const int col = tj + kGrid * c;
                float av = 0.f;  // A @ v summed apart, then added, as for the state
#pragma unroll 4
                for (int j = 0; j < C; ++j) av += as[t * (C + 1) + j] * vs[j * DVS + col];
                float a = acc_o[r][c] + av;
                if (shift) a += diag[t] * vs[t * DVS + col];
                if (t < cn && v0 + col < dv)
                    store(&o[v_base + (long long)(c0 + t) * dv + v0 + col], a);
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < dk * DVS; e += kThreads) {
        const int kk = e / DVS;
        const int col = e - kk * DVS;
        if (v0 + col < dv) state[((long long)bh * dk + kk) * dv + v0 + col] = ss[e];
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
