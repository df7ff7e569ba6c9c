// Batched diagonal-GMM log-likelihoods:
//   out[n, p] = logsumexp_{g in pdf p} ( [x_n, x_n^2, 1] . W_g )
//
// Replaces the Pallas kernel old_kaldi_git_tpu/ops/gmm_kernel.py
// (gmm_loglikes_pallas / _gmm_kernel / pack_gmm_weights).  The TPU kernel pads
// every pdf to a power-of-two mixture count (64 for a 2,000-pdf, 2,800-Gaussian
// triphone model: 45.7x the real work) and reduces each pdf's group with
// indicator matmuls, a temperature-8 stabiliser and a bf16x3 split, all to keep
// the MXU busy.  None of that is carried over.
//
// Bound on an H100: operations.  2*N*G*(2D+1) fp32 multiply-adds over the real
// Gaussians G (74.1 GFLOP at N = 167,424, G = 2,800, D = 39: 1.11 ms at
// 67 TFLOP/s) against 4*N*P output bytes (1.34 GB: 0.40 ms at 3.35 TB/s).
// Design: a RAGGED layout, pdf p owning rows[offsets[p] .. offsets[p+1]) of a
// [G, E4] table (E4 = 2D+1 rounded up to 4, zero columns).  One block takes
// kFrames frames x kPdfs pdfs: it stages the frames' [x, x^2, 1, 0..] rows in
// shared memory; each thread owns one pdf for all kFrames frames, streams that
// pdf's Gaussian rows as float4 through the read-only path (the whole table is
// 0.9 MB and stays in L2), and keeps kFrames dot products and an exact online
// logsumexp (running max m, scaled sum s) in fp32 registers.  Every thread of a
// warp reads the same frame row at once (a shared-memory broadcast), and
// neighbouring threads store neighbouring pdfs of one frame, so the [N, P]
// stores coalesce.  Full fp32 throughout: no TF32, no split.  A warp runs as
// long as its pdf with the most Gaussians (divergence); making it fast (pdfs
// balanced across warps, wgmma on 3xTF32 splits) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // = pdfs per block (ops/gmm_kernel.py PDFS_PER_BLOCK)
constexpr int kFrames = 32;    // frames per block (FRAMES_PER_BLOCK)
constexpr int kMaxDynamicSmem = 232448;

__global__ void __launch_bounds__(kThreads)
gmm_loglikes_kernel(const float* __restrict__ feats, const float4* __restrict__ rows,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int N, int D, int E4, int P) {
    extern __shared__ float4 xs4[];  // [kFrames][E4 / 4]
    float* xs = reinterpret_cast<float*>(xs4);
    const int n0 = blockIdx.x * kFrames;
    const int q = E4 / 4;
    for (int i = threadIdx.x; i < kFrames * E4; i += kThreads) {
        const int f = i / E4, k = i - f * E4;
        const int n = n0 + f;
        float v = 0.f;
        if (n < N) {
            if (k < D) {
                v = feats[(size_t)n * D + k];
            } else if (k < 2 * D) {
                const float x = feats[(size_t)n * D + k - D];
                v = x * x;
            } else if (k == 2 * D) {
                v = 1.f;
            }
        }
        xs[i] = v;
    }
    __syncthreads();
    const int p = blockIdx.y * kThreads + threadIdx.x;
    if (p >= P) return;
    const int g0 = offsets[p], g1 = offsets[p + 1];
    float m[kFrames], s[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
        m[f] = -INFINITY;
        s[f] = 0.f;
    }
    for (int g = g0; g < g1; ++g) {
        const float4* w_row = rows + (size_t)g * q;
        float acc[kFrames];
#pragma unroll
        for (int f = 0; f < kFrames; ++f) acc[f] = 0.f;
        for (int k = 0; k < q; ++k) {
            const float4 w = __ldg(w_row + k);
#pragma unroll
            for (int f = 0; f < kFrames; ++f) {
                const float4 x = xs4[f * q + k];
                acc[f] = fmaf(w.x, x.x, acc[f]);
                acc[f] = fmaf(w.y, x.y, acc[f]);
                acc[f] = fmaf(w.z, x.z, acc[f]);
                acc[f] = fmaf(w.w, x.w, acc[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < kFrames; ++f) {
            if (acc[f] > m[f]) {
                s[f] = s[f] * expf(m[f] - acc[f]) + 1.f;
                m[f] = acc[f];
            } else {
                s[f] += expf(acc[f] - m[f]);
            }
        }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
        const int n = n0 + f;
        if (n < N) out[(size_t)n * P + p] = m[f] + logf(s[f]);
    }
}

}  // namespace

// feats [N, D] f32, rows [G, E4] f32 (E4 % 4 == 0, E4 >= 2D+1), offsets [P+1]
// i32, out [N, P] f32, all contiguous device pointers.  Launches on `stream`,
// does not synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int okt_gmm_loglikes(const void* feats, const void* rows,
                                const void* offsets, void* out, int N, int D,
                                int E4, int P, void* stream) {
    if (N <= 0 || P <= 0) return 0;
    if (D <= 0 || E4 % 4 != 0 || E4 < 2 * D + 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kFrames * E4 * sizeof(float);
    if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    const int pdf_blocks = (P + kThreads - 1) / kThreads;
    if (pdf_blocks > 65535) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            gmm_loglikes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((N + kFrames - 1) / kFrames, pdf_blocks);
    gmm_loglikes_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)feats, (const float4*)rows, (const int*)offsets, (float*)out,
        N, D, E4, P);
    return (int)cudaGetLastError();
}
