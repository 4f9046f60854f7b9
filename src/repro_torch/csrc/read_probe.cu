// The card's rate for scattered 32-byte reads: the access row 2
// (csrc/gather_rerank.cu) makes at d = 8, where one candidate's row is one
// 32-byte sector at a position given by its id.  A measurement kernel
// beside the port's: no path launches it.  chip_smoke.py and
// tools/time_rerank.py set the rerank's time at d = 8 beside the rate it
// reads here.
//
// C entry point: scattered_read_probe(...) returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned mix32(unsigned h) {
    h ^= h >> 16; h *= 0x7feb352du; h ^= h >> 15; h *= 0x846ca68bu; h ^= h >> 16;
    return h;
}

// Thread t reads R rows of 32 bytes at hashed positions in [0, rows), every
// load issued before any sum, and writes one float so that no load is
// dropped.  R sets the reads each thread keeps in flight.
template <int R>
__global__ void __launch_bounds__(kThreads)
scattered_read_probe_kernel(const float4* __restrict__ x, unsigned rows, long long threads,
                            unsigned seed, float* __restrict__ out)
{
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (t >= threads) return;
    float4 a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const unsigned row = __umulhi(mix32((unsigned)(t * R + r) ^ seed), rows);
        a[r] = __ldcs(x + 2ull * row);
        b[r] = __ldcs(x + 2ull * row + 1);
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
        s += a[r].x + a[r].y + a[r].z + a[r].w + b[r].x + b[r].y + b[r].z + b[r].w;
    out[t] = s;
}

template <int R>
int launch(const float* x, unsigned rows, long long reads, unsigned seed, float* out,
           cudaStream_t stream) {
    const long long threads = reads / R;
    const long long blocks = (threads + kThreads - 1) / kThreads;
    scattered_read_probe_kernel<R><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), rows, threads, seed, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int scattered_read_probe(const float* x, unsigned rows, long long reads,
                                    int per_thread, unsigned seed, float* out, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (per_thread) {
        case 1: return launch<1>(x, rows, reads, seed, out, st);
        case 2: return launch<2>(x, rows, reads, seed, out, st);
        case 4: return launch<4>(x, rows, reads, seed, out, st);
        case 8: return launch<8>(x, rows, reads, seed, out, st);
    }
    return (int)cudaErrorInvalidValue;
}
