// Exact fp32 squared L2 between gathered candidate rows and their queries.
//
// Replaces the TPU kernel gather_rerank_kernel
// (src/repro/kernels/gather_rerank/kernel.py): out[w] = ||x[ids[w]] - q[w / c]||^2
// over the (query, candidate) list ids (m, c), the rerank of every query
// path (the fused query's in-pass rerank, the dense / streaming / SC-Linear
// reranks, the sharded engine's partial distances, the baselines').  The
// ids are read as the caller holds them, int32 or int64 at any strides (a
// stride-0 view too), and clipped into [0, n - 1] here: candidate lists
// carry sentinels (-1, INT32_MAX) whose distances the caller discards.
//
// What bounds it on an H100: bytes.  Each candidate costs one d-float row,
// read from a position only its id gives, for 3 * d flops.  At the main
// path's d = 128 a row is 512 contiguous bytes; at the sharded dry-run's
// d = 8 it is one 32-byte sector, so the bound there is the card's rate for
// scattered 32-byte reads (csrc/read_probe.cu measures it), and the id read
// before each row is a dependent round trip to memory.
//
// Design.  A group of G lanes takes one candidate, G the power of two at or
// above d / V (at most 32), where V floats (4, 2 or 1) is the widest load
// the rows' alignment allows: at d = 8 G = 2 (16 candidates a warp), at
// d = 64 G = 16, at d = 128 G = 32 with float4s; past 32 * V floats the
// group loops over d.  Each thread carries K = 2 candidates (K = 4
// measured slower at d = 8 and 128 on an H100): it reads their K ids
// (coalesced: the candidates of one k sit side by side), then issues all
// K row loads before any arithmetic, so an SM holds K times the
// bytes in flight of one candidate a warp.  Rows are read once with
// streaming loads (__ldcs: evict first), so they do not push the queries
// out of the caches; a query row is read once for a thread's candidates
// that share it (the common case: c is in the thousands) and otherwise
// from L1.  The group adds its lanes' partial sums by a butterfly of
// __shfl_xor_sync over log2 G steps: a fixed order, so two launches give
// equal bits; the result differs from a sequential sum only by the
// reassociation (relative error at most d * 2^-24).  One candidate per
// (group, k) slot, so no block loops: blocks = ceil(m * c / (8 warps *
// 32 / G * K)).
//
// C entry point: gather_rerank_l2(...) returns cudaGetLastError(), or
// cudaErrorInvalidValue for a (G, V) it was not instantiated at.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 2;  // K, the candidates a thread carries

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float sq(float4 a, float4 b) {
    const float e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z, e3 = a.w - b.w;
    return e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
}
__device__ __forceinline__ float sq(float2 a, float2 b) {
    const float e0 = a.x - b.x, e1 = a.y - b.y;
    return e0 * e0 + e1 * e1;
}
__device__ __forceinline__ float sq(float a, float b) {
    const float e = a - b;
    return e * e;
}
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

template <int G, int V, typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rerank_l2_kernel(const Id* __restrict__ ids,    // (m, c) at strides (s0, s1)
                        long long s0, long long s1,
                        const float* __restrict__ x,   // (n, d)
                        long long n,
                        const float* __restrict__ q,   // (m, d)
                        long long total, int c, int d,
                        float* __restrict__ out)       // (m, c)
{
    using VT = typename Vec<V>::T;
    constexpr int K = kPerThread;
    constexpr int kGroups = 32 / G;  // candidates a warp carries for each k
    const int lane = threadIdx.x & 31;
    const int r = lane % G;
    const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const long long w0 = warp * (kGroups * K) + lane / G;  // slot k is w0 + k * kGroups

    long long row[K], qi[K];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const long long w = w0 + (long long)k * kGroups;
        live[k] = w < total;
        long long i = 0, id = 0;
        if (live[k]) {
            long long j;
            if (total <= 0xffffffffLL) {  // uniform: 32-bit division where it fits
                const unsigned ui = (unsigned)w / (unsigned)c;
                i = ui;
                j = (unsigned)w - ui * (unsigned)c;
            } else {
                i = w / c;
                j = w - i * c;
            }
            id = (long long)ids[i * s0 + j * s1];
            id = id < 0 ? 0 : (id >= n ? n - 1 : id);
        }
        row[k] = id;
        qi[k] = i;
    }

    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    for (int off = r * V; off < d; off += G * V) {
        VT xv[K], qv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {  // every row load before any arithmetic
            if (live[k]) xv[k] = __ldcs(reinterpret_cast<const VT*>(x + row[k] * d + off));
            else zero(xv[k]);
        }
        qv[0] = __ldg(reinterpret_cast<const VT*>(q + qi[0] * d + off));
#pragma unroll
        for (int k = 1; k < K; ++k) {
            if (qi[k] == qi[k - 1]) qv[k] = qv[k - 1];
            else qv[k] = __ldg(reinterpret_cast<const VT*>(q + qi[k] * d + off));
        }
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += sq(xv[k], qv[k]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    if (r == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
            if (live[k]) out[w0 + (long long)k * kGroups] = acc[k];
    }
}

struct Args {
    const void* ids;
    int id64;
    long long s0, s1;
    const float* x;
    long long n;
    const float* q;
    long long total;
    int c, d;
    float* out;
    cudaStream_t stream;
};

template <int G, int V, typename Id>
int launch(const Args& a) {
    constexpr long long per_block = (long long)kWarps * (32 / G) * kPerThread;
    const long long blocks = (a.total + per_block - 1) / per_block;
    gather_rerank_l2_kernel<G, V, Id><<<(unsigned int)blocks, kThreads, 0, a.stream>>>(
        static_cast<const Id*>(a.ids), a.s0, a.s1, a.x, a.n, a.q, a.total, a.c, a.d, a.out);
    return (int)cudaGetLastError();
}

template <int G, int V>
int by_id(const Args& a) {
    return a.id64 ? launch<G, V, long long>(a) : launch<G, V, int>(a);
}

template <int G>
int by_v(const Args& a, int v) {
    switch (v) {
        case 1: return by_id<G, 1>(a);
        case 2: return by_id<G, 2>(a);
        case 4: return by_id<G, 4>(a);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gather_rerank_l2(const void* ids, int id64, long long s0, long long s1,
                                const float* x, long long n, const float* q, long long total,
                                int c, int d, int g, int v, float* out, void* stream) {
    const Args a{ids, id64, s0, s1, x, n, q, total, c, d, out,
                 static_cast<cudaStream_t>(stream)};
    switch (g) {
        case 1: return by_v<1>(a, v);
        case 2: return by_v<2>(a, v);
        case 4: return by_v<4>(a, v);
        case 8: return by_v<8>(a, v);
        case 16: return by_v<16>(a, v);
        case 32: return by_v<32>(a, v);
    }
    return (int)cudaErrorInvalidValue;
}
