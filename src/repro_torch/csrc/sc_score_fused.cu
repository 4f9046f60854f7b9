// SC-scores of raw subspace vectors: a 3xTF32 tensor-core screen with an
// exact re-check near the threshold.
//
// Replaces sc_score_kernel (src/repro/kernels/sc_score/kernel.py:303, its
// pallas_call at :316): out[a,b] = sum_i [d_i(a,b) <= tau[i,a]] for qs
// (Ns, m, s), xs (Ns, n, s), tau (Ns, m), int32 (m, n), where d_i is the
// plain version's distance (kernels/pairwise_l2/ref.py, the arithmetic of
// row 10, csrc/pairwise_l2.cu): the norms and the cross term summed one dim
// at a time in index order from +0 with separate roundings, then
// d = clamp_min(fl(fl(qn + xn) - fl(2 cross)), 0).  SC-Linear takes tau from
// row 10's distances, so every (query, subspace) has a pair exactly at tau.
// The counts must be the plain version's bit for bit, ties included.
//
// What bounds it on an H100.  At SC-Linear's shape (m = 64, n = 1M, Ns = 8,
// s = 16) the bytes: x read once (512 MB) and the int32 output written once
// (256 MB), 0.229 ms at 3.35 TB/s.  The 3xTF32 products (3 * 2 m n Ns s)
// take 0.099 ms at 495 T/s.  In the plain order (no FMA contraction) the
// fp32 work is ~20 G instructions, ~0.6 ms at 132 SMs x 128 lanes x 1.98 GHz:
// no SIMT kernel in that order reaches the bytes.  Hence the screen.
//
// Design.  A block owns a group of kBM = 64 query rows and a tile of kBN =
// 128 points, and walks all Ns subspaces; its counts stay in registers, in
// the accumulator's fragment layout (a thread's two neighbouring columns in
// the 16-bit halves of one register: 16 registers for 32 counts, which
// keeps the kernel at 128 registers without spills), and reach device
// memory once.  So a launch takes at most kMaxNs = 65,535 subspaces; the C
// entry launches once per 65,535, each later launch adding its counts to
// the output.  At m <= 64 each x row is read from device memory once; above, the
// query groups of one point tile are adjacent in launch order (the work
// index blockIdx.x is tile * groups + group), so the later groups read x
// from L2.  The grid has one block a work item (at most 2^31 - 1, its x
// extent: about 2^43 pairs, far past any output the card holds).
//   Each step stages kKC = 16 dims of one subspace -- the tile's 128 x rows
//   and the group's 64 q rows, zero-filled past s, n and m -- by cp.async
//   in a ring of kStages stages, kStages - 1 steps in flight (VEC = 4:
//   16-byte copies, for 16-byte aligned views whose strides are multiples
//   of 4 floats; VEC = 1: 4-byte copies, any view); subspaces of s > 16
//   take ceil(s / 16) steps.  A thread's row pointers are taken once a block
//   and the steps' (subspace, chunk, stage) kept by counters, so a
//   step's copies cost a few instructions.  One barrier opens a step (its
//   stage has landed, and the stage of the step before may be refilled),
//   one more publishes a subspace's norms.  Shared memory is fixed (kSmem,
//   dynamic): nothing is chosen from its size.
//   The norms |q_a|^2 and |x_b|^2 of each subspace are summed by one thread a
//   row from the staged slices, __fmul_rn / __fadd_rn in dim order from +0
//   (the zeros past s add +0, which changes no bit): the plain version's
//   bits, taken once a block.
//   8 warps in 2 (query halves) x 4 (point quarters), each a 32 x 32 corner
//   as 2 x 4 mma.sync m16n8k8 TF32 products (rows: queries, columns:
//   points); a warp whose query rows all lie past m skips its products.  Each
//   operand is split a = big + small by truncation (split_trunc: big = a cut
//   to TF32's 11 significant bits, small = a - big cut the same way; three
//   instructions where cvt.rna.tf32 rounding cost 12% more of the kernel's
//   time on an H100) and the cross term accumulates small x big, big x small,
//   big x big in fp32 (mma_tf32, csrc/tf32.cuh).  Fragments are
//   read 16 bytes at a time: a thread takes dims 4tq .. 4tq + 3 of a row and
//   feeds (4tq, 4tq + 1) to k-step 0 as its k = tq, tq + 4, (4tq + 2, 4tq + 3)
//   to k-step 1: the same permutation of k for both operands.
//
// The screen and the decision.  For each (pair, subspace), with
// t = fl(qn + xn) (the plain version's bits):
//   d~ = max(fl(t - 2 c~), 0)   (one fma: 2 c~ is exact below the guard),
//   delta = fl(mu_s t + eta_s),
//   count it when fl(d~ + delta) <= tau, leave it out when
//   fl(d~ - delta) > tau, and re-check it otherwise.
// The branches are written so that a NaN anywhere -- d~, delta or tau -- makes
// both comparisons false and reaches the re-check.  A norm above the guard
// kNormLimit = 2^125 (or not finite) enters the screen as NaN, so its pairs
// are always re-checked; below it, t <= 2^126 and no intermediate of either
// arithmetic overflows.
//
// The re-check recomputes the pair as the plain version does: the cross
// term __fmul_rn / __fadd_rn in dim order from +0, read from the staged
// slices where the subspace fits one step (s <= 16) and from device memory
// (L2) otherwise; fl(fl(qn + xn) - fl(2 cross)) with the exact norms;
// clamped at 0 with NaN kept (torch's clamp_min, not fmaxf); compared with
// tau.  So a re-checked pair counts exactly as the plain version counts it.
//
// The margin.  u = 2^-24, N = qn + xn, S = sum_k |q_k x_k|, first order in u,
// any fp32 summation order with round-to-nearest:
//   * the plain cross term: s products, s - 1 additions: within s u S of the
//     true one;
//   * the split (truncation): |a - big| < 2^-10 |a|, |small| < 2^-10 |a|, the
//     residual < 2^-20 |a|, so the three products miss q x (by small x
//     small and the two residuals) by < 3 * 2^-20 |q x| = 48 u |q x| a dim:
//     48 u S;
//   * the accumulation: 3s exact TF32 products (11 x 11 bits) into an fp32
//     sum, sum |terms| <= 1.002 S: 3 s u S;
//   * so |c~ - c_plain| <= (4 s + 48) u S, and S <= N / 2 (1 + s u) (each
//     |q_k x_k| <= (q_k^2 + x_k^2) / 2, the fp32 norms within s u);
//   * t is the same in both; the last subtraction adds one rounding to each,
//     <= u |t - 2c| <= 2 u N each; the clamp is 1-Lipschitz.
// Together |d~ - d_plain| <= (4 s + 52) u N.  fused_screen_margin() in
// kernels/sc_score/kernel.py states it as E_s = (5 s + 60) u (the second
// order terms and some slack) and passes mu_s = 8 E_s: exactness needs the
// error within delta / 2 (below), and a safety factor of 4 covers the
// tensor cores' accumulation, whose rounding is not specified as IEEE.
// eta_s = s 2^-119 (fused_screen_floor()) covers what is not relative: a
// product or partial sum the tensor cores may flush below 2^-126 (6 s of
// them, doubled in 2c, < 12 s 2^-126 = 2^-122.4 s) and an operand flushed
// below 2^-126 (|a b| < 2^-126 |b|: below 2^-106 N where |b| >= 2^-20, below
// 2^-146 elsewhere), times the same 2 x 4 (the split itself flushes
// nothing: a cut keeps a's exponent).  tests/test_torch_sc_linear.py
// emulates the screen in fp64 on adversarial inputs and holds it to E_s t;
// chip_smoke.py measures the card's largest |d~ - d_plain| / delta (<= 0.25).
//
// Why the fp32 comparisons cannot cross tau wrongly.  Let e = |d~ - d_plain|
// <= delta* / 2, delta* = mu_s t + eta_s the exact margin, fl(delta*) =
// delta* (1 + r), |r| <= u.  Count branch: fl(d~ + delta) <= tau gives
// d~ + delta <= tau + u |d~ + delta|, so d_plain <= d~ + delta* / 2 <= tau -
// delta* / 2 + u (|d~| + 2 delta*) + u delta*.  As d~ <= 2.01 t and delta* >=
// mu_s t >= 200 u t, u (|d~| + 3 delta*) < delta* / 2: d_plain < tau, and the
// plain version counts it (a NaN d_plain would make t, hence delta, NaN).
// Leave-out branch, the same with the signs turned: d_plain > tau.  Where
// tau < 0 the plain version never counts; the screen gives d~ - delta > tau
// or re-checks.  tau = +inf: every finite pair counts on the first branch,
// as d_plain <= +inf; a NaN tau re-checks every pair.
//
// Data whose common offset dwarfs its spread (N >> the distances) widens
// delta past the gaps near tau: then every pair is re-checked, right and
// slow.  Nothing gives way to another kernel.
//
// Where the time goes on an H100 (PERF.md §6): the copies alone run at 80%
// of the byte bound; the whole kernel at ~3.6x it.  A block's norms,
// splits, products and decisions issue between its two barriers, at 16
// warps an SM (128 registers a thread), so copies and arithmetic overlap
// only across an SM's two blocks.  wgmma with a producer warp is the next
// step.
//
// Instruments (the PROBE instantiation, for the checks only; the path's has
// none and gives the same counts): rechecks[block] counts the pairs each
// block re-checked, and screen (Ns, m, n) takes every d~.
//
// C entry points (each returns cudaGetLastError()):
//   sc_score_fused(qs, qs_s0, qs_s1, xs, xs_s0, xs_s1, tau, ns, m, n, s, mu, eta,
//                  vec, out, rechecks, screen, stream): rechecks and
//                  screen both null on the path, both set for the probe; a
//                  launch per kMaxNs subspaces.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWM = 2, kWN = 4;      // warps along the queries and along the points
constexpr int kMT = 2, kNT = 4;      // m16n8k8 tiles a warp takes along each
constexpr int kBM = kWM * kMT * 16;  // query rows of a group: 64
constexpr int kBN = kWN * kNT * 8;   // points of a tile: 128
constexpr int kKC = 16;              // dims a step stages (rows of 64 bytes: the 16-byte
                                     // fragment reads of 8 threads, rows g and g + 1,
                                     // hit 32 distinct banks)
static_assert(kWM * kWN * 32 == kThreads, "the warp layout");
static_assert(kBN + 2 * kBM <= kThreads, "a thread for each norm and each threshold");
constexpr float kNormLimit = 0x1p125f;  // norms above it enter the screen as NaN
constexpr int kMaxNs = 65535;           // subspaces a launch counts in 16 bits
// The most queries and points: a block's rows a0 .. a0 + 63 and p0 .. p0 + 127 stay ints.
constexpr int kMaxRows = INT_MAX - kBM + 1, kMaxPoints = INT_MAX - kBN + 1;
constexpr int kStages = 3;              // cp.async stages: kStages - 1 steps in flight
constexpr int kStageFloats = (kBN + kBM) * kKC;  // a stage: the x rows, then the q rows
// Dynamic shared memory: the stages, then per row of the tile and of the
// group its norm (exact and as screened) and per query its threshold, then
// the warps' re-check counts.
constexpr size_t kSmem =
    sizeof(float) * (kStages * kStageFloats + 2 * kBN + 3 * kBM) + sizeof(int) * (kThreads / 32);

// a = big + small + (a residual below 2^-20 |a|): big = a cut to TF32 (its 13
// low mantissa bits cleared), small = (a - big), exact in fp32, cut the same
// way.  The tensor cores read the 19 high bits of each, so both are exact
// TF32 operands.
__device__ __forceinline__ void split_trunc(float a, unsigned& big, unsigned& small) {
    big = __float_as_uint(a) & 0xffffe000u;
    small = __float_as_uint(__fsub_rn(a, __uint_as_float(big))) & 0xffffe000u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the last N groups have landed
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's copies of a ROWS x kKC slice into dst (row-major, kKC
// floats a row) by cp.async: rows r0, r0 + kStep, ... (r0 = tid / kPer),
// dims t .. t + VEC - 1 (t = tid % kPer * VEC).  first points at row r0's
// dim t of the slice, rows ld floats apart; rows past rows_left and dims
// past dims_left are zero-filled (src-size short of the copy, or 0 with the
// address `safe`, which lies inside the data).
template <int VEC, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* first, long long ld,
                                           int rows_left, int dims_left, const float* safe) {
    constexpr int kPer = kKC / VEC;          // copies a row
    constexpr int kStep = kThreads / kPer;   // rows between a thread's copies
    static_assert(ROWS % kStep == 0, "whole passes of the block");
    const int r0 = threadIdx.x / kPer, t = threadIdx.x % kPer * VEC;
    const int bytes = 4 * min(VEC, max(0, dims_left - t));
#pragma unroll
    for (int k = 0; k < ROWS / kStep; ++k) {
        const int r = r0 + k * kStep;
        const int valid = r < rows_left ? bytes : 0;
        const float* g = valid > 0 ? first + k * kStep * ld : safe;
        const unsigned a = smem_addr(dst + r * kKC + t);
        if (VEC == 4)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g),
                         "r"(valid));
        else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(g),
                         "r"(valid));
    }
}

// The plain version's distance of one pair, compared with tau: the cross
// term in dim order from +0, then fl(fl(qn + xn) - fl(2 cross)), clamped at 0
// as torch's clamp_min (NaN stays NaN).  qr and xr may point into shared or
// device memory.
__device__ __forceinline__ int plain_count(const float* qr, const float* xr, int s, float qn,
                                           float xn, float tau) {
    float cross = 0.f;
#pragma unroll 4
    for (int k = 0; k < s; ++k) cross = __fadd_rn(cross, __fmul_rn(qr[k], xr[k]));
    float d = __fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, cross));
    d = d < 0.f ? 0.f : d;
    return d <= tau ? 1 : 0;
}

template <int VEC, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
sc_score_fused_kernel(const float* __restrict__ qs, long long qs_s0, long long qs_s1,  // (ns, m, s)
                      const float* __restrict__ xs, long long xs_s0, long long xs_s1,  // (ns, n, s)
                      const float* __restrict__ tau,                                   // (ns, m)
                      int ns, int m, int n, int s, float mu, float eta, bool accumulate,
                      int* __restrict__ out,                                           // (m, n)
                      int* __restrict__ rechecks,                                      // (grid,)
                      float* __restrict__ screen)                                      // (ns, m, n)
{
    extern __shared__ __align__(16) float smem[];  // kStages x [kBN x rows | kBM q rows] x kKC
    float* xn_e = smem + kStages * kStageFloats;  // [kBN] |x|^2 of the subspace, exact
    float* xn_s = xn_e + kBN;                     // [kBN] as screened (NaN past the guard)
    float* qn_e = xn_s + kBN;                     // [kBM]
    float* qn_s = qn_e + kBM;                     // [kBM]
    float* tau_s = qn_s + kBM;                    // [kBM] the group's thresholds
    int* red = reinterpret_cast<int*>(tau_s + kBM);  // [kThreads / 32]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp % kWM, wn = warp / kWM;
    const int g = lane >> 2, tq = lane & 3;
    const int groups = (m + kBM - 1) / kBM;
    const int nch = (s + kKC - 1) / kKC;  // steps a subspace
    const int steps = ns * nch;
    int nre = 0;

    const int a0 = (int)(blockIdx.x % groups) * kBM;  // the group's first query
    const int p0 = (int)(blockIdx.x / groups) * kBN;  // the tile's first point
    // m-tiles of this warp with a live query row (warp-uniform)
    const int live = min(kMT, max(0, (m - a0 - wm * kMT * 16 + 15) / 16));
    int cnt[kMT][kNT][2];  // [h]: column 2tq + e in bits 16e .. 16e + 15
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) cnt[mt][nt][h] = 0;
    float nrm = 0.f;  // the running norm of this thread's row (x: tid, q: tid - kBN)

    // this thread's first x and q rows of the work item (stage_rows), and
    // the next step to stage: its subspace, chunk and stage, by counters
    constexpr int kRow0 = kKC / VEC;
    const float* x_first = xs + (long long)(p0 + tid / kRow0) * xs_s1 + tid % kRow0 * VEC;
    const float* q_first = qs + (long long)(a0 + tid / kRow0) * qs_s1 + tid % kRow0 * VEC;
    int ni = 0, nc = 0, nbuf = 0;
    auto stage_next = [&]() {
        float* dst = smem + nbuf * kStageFloats;
        stage_rows<VEC, kBN>(dst, x_first + ni * xs_s0 + nc * kKC, xs_s1, n - p0,
                             s - nc * kKC, xs);
        stage_rows<VEC, kBM>(dst + kBN * kKC, q_first + ni * qs_s0 + nc * kKC, qs_s1, m - a0,
                             s - nc * kKC, qs);
        if (++nc == nch) {
            nc = 0;
            ++ni;
        }
        if (++nbuf == kStages) nbuf = 0;
    };
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
        if (p < steps) stage_next();
        cp_async_commit();
    }
    int i = 0, c = 0, buf = 0;  // this step's subspace, chunk and stage
    for (int st = 0; st < steps; ++st) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // step st has landed, and every thread is done with step st - 1
        if (st + kStages - 1 < steps) stage_next();  // into step st - 1's stage
        cp_async_commit();
        const float* X = smem + buf * kStageFloats;
        const float* Q = X + kBN * kKC;

        // the norms in the plain order, one thread a row (the dims past s
        // are zeros: adding +0 to a sum >= +0 changes no bit); the thresholds
        if (c == 0) nrm = 0.f;
        if (tid < kBN + kBM) {
            const float* r = tid < kBN ? X + tid * kKC : Q + (tid - kBN) * kKC;
#pragma unroll
            for (int k = 0; k < kKC; k += 4) {
                const float4 v = *reinterpret_cast<const float4*>(r + k);
                nrm = __fadd_rn(nrm, __fmul_rn(v.x, v.x));
                nrm = __fadd_rn(nrm, __fmul_rn(v.y, v.y));
                nrm = __fadd_rn(nrm, __fmul_rn(v.z, v.z));
                nrm = __fadd_rn(nrm, __fmul_rn(v.w, v.w));
            }
        } else if (c == 0 && tid < kBN + 2 * kBM) {
            const int a = tid - kBN - kBM;
            tau_s[a] = a0 + a < m ? tau[(long long)i * m + a0 + a] : 0.f;
        }

        // the cross terms on the tensor cores, 3xTF32
        if (c == 0) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
        }
        if (live > 0) {
            float4 qa[kMT][2], xv[kNT];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                const float* r = Q + (wm * kMT * 16 + mt * 16 + g) * kKC + 4 * tq;
                qa[mt][0] = *reinterpret_cast<const float4*>(r);
                qa[mt][1] = *reinterpret_cast<const float4*>(r + 8 * kKC);
            }
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
                xv[nt] = *reinterpret_cast<const float4*>(X + (wn * kNT * 8 + nt * 8 + g) * kKC +
                                                          4 * tq);
#pragma unroll
            for (int step = 0; step < 2; ++step) {
                unsigned bb[kNT][2], bs[kNT][2];
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                    split_trunc(step ? xv[nt].z : xv[nt].x, bb[nt][0], bs[nt][0]);
                    split_trunc(step ? xv[nt].w : xv[nt].y, bb[nt][1], bs[nt][1]);
                }
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    if (mt >= live) continue;
                    const float4 r0 = qa[mt][0], r8 = qa[mt][1];
                    unsigned ab[4], as[4];
                    split_trunc(step ? r0.z : r0.x, ab[0], as[0]);
                    split_trunc(step ? r8.z : r8.x, ab[1], as[1]);
                    split_trunc(step ? r0.w : r0.y, ab[2], as[2]);
                    split_trunc(step ? r8.w : r8.y, ab[3], as[3]);
                    // the small terms first, then big x big
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], as, bb[nt]);
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab, bs[nt]);
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab, bb[nt]);
                }
            }
        }

        if (c == nch - 1) {  // the subspace's cross terms are complete
            if (tid < kBN + kBM) {
                const float sc = nrm <= kNormLimit ? nrm : CUDART_NAN_F;
                if (tid < kBN) {
                    xn_e[tid] = nrm;
                    xn_s[tid] = sc;
                } else {
                    qn_e[tid - kBN] = nrm;
                    qn_s[tid - kBN] = sc;
                }
            }
            __syncthreads();
            if (live > 0) {
                // count the pairs the screen decides; mark the others (bit
                // ((mt * 2 + h) * kNT + nt) * 2 + e)
                unsigned rc = 0;
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    if (mt >= live) continue;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = wm * kMT * 16 + mt * 16 + g + 8 * h;
                        const bool row_ok = a0 + row < m;
                        const float qsn = qn_s[row], tr = tau_s[row];
#pragma unroll
                        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int col = wn * kNT * 8 + nt * 8 + 2 * tq + e;
                                const float t = __fadd_rn(qsn, xn_s[col]);
                                const float d =
                                    fmaxf(__fmaf_rn(-2.f, acc[mt][nt][2 * h + e], t), 0.f);
                                const float del = __fmaf_rn(mu, t, eta);
                                const float hi = __fadd_rn(d, del), lo = __fsub_rn(d, del);
                                const bool ok = row_ok && p0 + col < n;
                                if (PROBE && ok)
                                    screen[((long long)i * m + a0 + row) * n + p0 + col] = d;
                                if (hi <= tr) {
                                    cnt[mt][nt][h] += 1 << (16 * e);
                                } else if (!(lo > tr) && ok) {
                                    rc |= 1u << (((mt * 2 + h) * kNT + nt) * 2 + e);
                                }
                            }
                        }
                    }
                }
                if (rc) {  // the exact re-checks
                    if (PROBE) nre += __popc(rc);
                    unsigned add = 0;
                    for (unsigned left = rc; left; left &= left - 1) {
                        const int bit = __ffs(left) - 1;
                        const int e = bit & 1, nt = (bit >> 1) % kNT, mh = (bit >> 1) / kNT;
                        const int row = wm * kMT * 16 + (mh >> 1) * 16 + g + 8 * (mh & 1);
                        const int col = wn * kNT * 8 + nt * 8 + 2 * tq + e;
                        const float* qr = nch == 1 ? Q + row * kKC
                                                   : qs + i * qs_s0 + (long long)(a0 + row) * qs_s1;
                        const float* xr = nch == 1 ? X + col * kKC
                                                   : xs + i * xs_s0 + (long long)(p0 + col) * xs_s1;
                        add |= (unsigned)plain_count(qr, xr, s, qn_e[row], xn_e[col],
                                                     tau_s[row]) << bit;
                    }
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                        for (int h = 0; h < 2; ++h)
#pragma unroll
                            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                                for (int e = 0; e < 2; ++e)
                                    cnt[mt][nt][h] +=
                                        ((add >> (((mt * 2 + h) * kNT + nt) * 2 + e)) & 1)
                                        << (16 * e);
                }
            }
        }
        if (++c == nch) {
            c = 0;
            ++i;
        }
        if (++buf == kStages) buf = 0;
    }

    // the counts, once: a thread writes two neighbouring columns of a row
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= live) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int a = a0 + wm * kMT * 16 + mt * 16 + g + 8 * h;
            if (a >= m) continue;
            int* orow = out + (long long)a * n;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
                const int p = p0 + wn * kNT * 8 + nt * 8 + 2 * tq;
                int c0 = cnt[mt][nt][h] & 0xffff, c1 = (unsigned)cnt[mt][nt][h] >> 16;
                if ((n & 1) == 0 && p < n) {
                    int2* o = reinterpret_cast<int2*>(orow + p);
                    if (accumulate) {
                        const int2 was = *o;
                        c0 += was.x;
                        c1 += was.y;
                    }
                    *o = make_int2(c0, c1);
                } else {
                    if (p < n) orow[p] = accumulate ? orow[p] + c0 : c0;
                    if (p + 1 < n) orow[p + 1] = accumulate ? orow[p + 1] + c1 : c1;
                }
            }
        }
    }

    if (PROBE) {
        for (int o = 16; o > 0; o >>= 1) nre += __shfl_xor_sync(0xffffffffu, nre, o);
        if (lane == 0) red[warp] = nre;
        __syncthreads();
        if (tid == 0) {
            int tot = 0;
            for (int k = 0; k < kThreads / 32; ++k) tot += red[k];
            rechecks[blockIdx.x] += tot;
        }
    }
}

template <int VEC, bool PROBE>
int launch(const float* qs, long long qs_s0, long long qs_s1, const float* xs, long long xs_s0,
           long long xs_s1, const float* tau, int ns, int m, int n, int s, float mu, float eta,
           int* out, int* rechecks, float* screen, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((m + kBM - 1) / kBM) * (unsigned)((n + kBN - 1) / kBN);
    auto kern = sc_score_fused_kernel<VEC, PROBE>;
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    for (int i0 = 0; i0 < ns; i0 += kMaxNs) {  // kMaxNs subspaces a launch
        kern<<<blocks, kThreads, kSmem, stream>>>(
            qs + i0 * qs_s0, qs_s0, qs_s1, xs + i0 * xs_s0, xs_s0, xs_s1, tau + (long long)i0 * m,
            min(kMaxNs, ns - i0), m, n, s, mu, eta, i0 > 0, out, rechecks,
            PROBE ? screen + (long long)i0 * m * n : nullptr);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vec: 4 for 16-byte copies (the caller has checked that both views are
// 16-byte aligned with strides that are multiples of 4 floats), else 1.
// rechecks (zeroed by the caller, one int a block) and screen: both null
// (the path), or both set (the probe).  One block a work item, so m <=
// kMaxRows, n <= kMaxPoints and ceil(m / 64) * ceil(n / 128) <= 2^31 - 1;
// one launch per 65,535 subspaces.
extern "C" int sc_score_fused(const float* qs, long long qs_s0, long long qs_s1,
                              const float* xs, long long xs_s0, long long xs_s1,
                              const float* tau, int ns, int m, int n, int s, float mu, float eta,
                              int vec, int* out, int* rechecks, float* screen, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    const bool probe = rechecks != nullptr;
    const long long work = ((long long)m + kBM - 1) / kBM * (((long long)n + kBN - 1) / kBN);
    if (probe != (screen != nullptr) || (vec != 1 && vec != 4) || m < 1 || m > kMaxRows ||
        n < 1 || n > kMaxPoints || work > INT_MAX)
        return (int)cudaErrorInvalidValue;
    if (vec == 4)
        return probe ? launch<4, true>(qs, qs_s0, qs_s1, xs, xs_s0, xs_s1, tau, ns, m, n, s, mu,
                                       eta, out, rechecks, screen, st)
                     : launch<4, false>(qs, qs_s0, qs_s1, xs, xs_s0, xs_s1, tau, ns, m, n, s, mu,
                                        eta, out, rechecks, screen, st);
    return probe ? launch<1, true>(qs, qs_s0, qs_s1, xs, xs_s0, xs_s1, tau, ns, m, n, s, mu, eta,
                                   out, rechecks, screen, st)
                 : launch<1, false>(qs, qs_s0, qs_s1, xs, xs_s0, xs_s1, tau, ns, m, n, s, mu, eta,
                                    out, rechecks, screen, st);
}
