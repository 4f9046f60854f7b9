// Exact fp32 squared L2 between gathered candidate rows and their queries.
//
// Replaces the TPU kernel gather_rerank_kernel
// (src/repro/kernels/gather_rerank/kernel.py): out[w] = ||x[ids[w]] - q[w / mc]||^2
// over a flattened (query, candidate) list, the in-pass rerank of the fused
// query.  Ids arrive clipped into [0, n-1] by the op wrapper.
//
// What bounds it on an H100: bytes.  Each candidate costs one d-float row
// read for 3*d flops (0.75 flop per byte).  Design: one warp per (query,
// slot), so a row is read by 32 neighbouring lanes; with d % 4 == 0 (and
// 16-byte aligned rows) each lane loads float4s, the widest load a thread
// can make.  The query row is read the same way and stays in L1/L2 across
// its candidates.  Each lane sums its share of the squared differences and
// a butterfly of warp shuffles adds the 32 partial sums: a fixed order, so
// the result is the same from run to run (it differs from a sequential sum
// only by the reassociation, relative error at most d * 2^-24).
//
// C entry point: gather_rerank_l2(...) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rerank_l2_kernel(const int* __restrict__ ids,   // (total,)
                        const float* __restrict__ x,   // (n, d)
                        const float* __restrict__ q,   // (mq, d)
                        long long total, int mc, int d, int vec4,
                        float* __restrict__ out)       // (total,)
{
    const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (w >= total) return;  // w is uniform across the warp
    const float* xr = x + (long long)ids[w] * d;
    const float* qr = q + (w / mc) * (long long)d;
    float acc = 0.f;
    if (vec4) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* q4 = reinterpret_cast<const float4*>(qr);
        for (int j = lane; j < (d >> 2); j += 32) {
            const float4 a = x4[j];
            const float4 b = q4[j];
            const float e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z, e3 = a.w - b.w;
            acc += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
        }
    } else {
        for (int j = lane; j < d; j += 32) {
            const float e = xr[j] - qr[j];
            acc += e * e;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[w] = acc;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gather_rerank_l2(const int* ids, const float* x, const float* q,
                                long long total, int mc, int d, int vec4, float* out,
                                void* stream) {
    const long long blocks = (total * 32 + kThreads - 1) / kThreads;
    gather_rerank_l2_kernel<<<(unsigned int)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ids, x, q, total, mc, d, vec4, out);
    return (int)cudaGetLastError();
}
