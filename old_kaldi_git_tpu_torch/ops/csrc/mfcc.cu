// Fused MFCC from windowed frames:
//   [N, W] frames -> DFT (two real products against cos/sin tables [W, F])
//   -> power [N, F] -> mel energies [N, NB] -> log(max(., 1e-30))
//   -> liftered DCT [N, C],   with nothing between the stages in device memory.
//
// Replaces the Pallas kernel old_kaldi_git_tpu/ops/mfcc_kernel.py
// (_mfcc_kernel / fused_mfcc_from_frames).  The TPU kernel pads the mel and DCT
// tables to 128 lanes and tiles 128 frames for its matrix unit; here the tables
// keep their true widths (23 mel bins, 13 cepstra) and a block takes 32 frames.
//
// Bound on an H100: operations.  2*N*W*F*2 + 2*N*F*NB + 2*N*NB*C fp32
// operations against the card's fp32 rate outside the tensor cores; the bytes,
// 4*(N*W + N*C), take about a sixth of that time at W = 256.  Full fp32 on purpose: the
// waves have amplitude ~2500, power bins reach 1e9, and rounding the inputs
// to tf32/bf16 would cost digits in the log.
// Design: the frame tile sits in shared memory; each thread owns one DFT bin
// for 16 frames and keeps their re/im sums in registers, reading four
// samples of a frame with one 16-byte broadcast load per 8 FMAs; the cos/sin
// columns come from L2 (the tables are 128 KB each at W = 256) with coalesced
// loads.  Power, log-mel and the DCT stay in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;                                   // frames per block
constexpr int kBinsPerPass = 128;                            // DFT bins per pass
constexpr int kGroups = kThreads / kBinsPerPass;             // frame groups
constexpr int kFramesPerThread = kTileN / kGroups;           // 16
constexpr int kMaxDynamicSmem = 232448;                      // 227 KB
constexpr float kLogFloor = 1e-30f;

__global__ void __launch_bounds__(kThreads)
fused_mfcc_kernel(const float* __restrict__ frames, const float* __restrict__ c_re,
                  const float* __restrict__ c_im, const float* __restrict__ mel,
                  const float* __restrict__ dct, float* __restrict__ out,
                  int N, int W, int F, int NB, int C) {
    extern __shared__ __align__(16) float smem[];
    float* frames_s = smem;                      // [kTileN][W]
    float* power_s = frames_s + kTileN * W;      // [kTileN][F]
    float* logmel_s = power_s + kTileN * F;      // [kTileN][NB]
    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * kTileN;
    const int rows = min(kTileN, N - n0);

    // 1. the frame tile, zero beyond the ragged edge (W % 4 == 0)
    {
        const float4* src = reinterpret_cast<const float4*>(frames + (size_t)n0 * W);
        float4* dst = reinterpret_cast<float4*>(frames_s);
        const int nvec = kTileN * W / 4;
        const int nvalid = rows * W / 4;
        for (int i = tid; i < nvec; i += kThreads)
            dst[i] = i < nvalid ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // 2. DFT and power: thread = (bin kx of the pass, frame group g)
    {
        const int kx = tid % kBinsPerPass;
        const int g = tid / kBinsPerPass;
        const float* f_base = frames_s + g * kFramesPerThread * W;
        for (int k0 = 0; k0 < F; k0 += kBinsPerPass) {
            const int k = k0 + kx;
            const bool live = k < F;
            float re[kFramesPerThread], im[kFramesPerThread];
#pragma unroll
            for (int i = 0; i < kFramesPerThread; ++i) { re[i] = 0.f; im[i] = 0.f; }
            for (int w = 0; w < W; w += 4) {
                float c[4], s[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    c[q] = live ? __ldg(c_re + (size_t)(w + q) * F + k) : 0.f;
                    s[q] = live ? __ldg(c_im + (size_t)(w + q) * F + k) : 0.f;
                }
#pragma unroll
                for (int i = 0; i < kFramesPerThread; ++i) {
                    const float4 f = *reinterpret_cast<const float4*>(f_base + i * W + w);
                    re[i] = fmaf(f.x, c[0], re[i]);
                    im[i] = fmaf(f.x, s[0], im[i]);
                    re[i] = fmaf(f.y, c[1], re[i]);
                    im[i] = fmaf(f.y, s[1], im[i]);
                    re[i] = fmaf(f.z, c[2], re[i]);
                    im[i] = fmaf(f.z, s[2], im[i]);
                    re[i] = fmaf(f.w, c[3], re[i]);
                    im[i] = fmaf(f.w, s[3], im[i]);
                }
            }
            if (live) {
#pragma unroll
                for (int i = 0; i < kFramesPerThread; ++i)
                    power_s[(g * kFramesPerThread + i) * F + k] =
                        re[i] * re[i] + im[i] * im[i];
            }
        }
    }
    __syncthreads();

    // 3. mel energies against the unpadded [F, NB] filterbank, floored log
    for (int o = tid; o < kTileN * NB; o += kThreads) {
        const int n = o / NB;
        const int m = o - n * NB;
        const float* p = power_s + n * F;
        float acc = 0.f;
        for (int k = 0; k < F; ++k) acc = fmaf(p[k], __ldg(mel + (size_t)k * NB + m), acc);
        logmel_s[o] = logf(fmaxf(acc, kLogFloor));
    }
    __syncthreads();

    // 4. liftered DCT [NB, C]
    for (int o = tid; o < rows * C; o += kThreads) {
        const int n = o / C;
        const int c = o - n * C;
        const float* l = logmel_s + n * NB;
        float acc = 0.f;
        for (int m = 0; m < NB; ++m) acc = fmaf(l[m], __ldg(dct + (size_t)m * C + c), acc);
        out[(size_t)(n0 + n) * C + c] = acc;
    }
}

}  // namespace

// frames [N, W], c_re/c_im [W, F], mel [F, NB], dct [NB, C], out [N, C]:
// contiguous float32 device pointers, frames 16-byte aligned, W % 4 == 0.
// Launches on `stream`, does not synchronise.  Returns cudaGetLastError().
extern "C" int okt_fused_mfcc(const void* frames, const void* c_re,
                              const void* c_im, const void* mel, const void* dct,
                              void* out, int N, int W, int F, int NB, int C,
                              void* stream) {
    if (N <= 0) return 0;
    if (W <= 0 || W % 4 != 0 || F <= 0 || NB <= 0 || C <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kTileN * (W + F + NB) * sizeof(float);
    if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        fused_mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = (N + kTileN - 1) / kTileN;
    fused_mfcc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)frames, (const float*)c_re, (const float*)c_im,
        (const float*)mel, (const float*)dct, (float*)out, N, W, F, NB, C);
    return (int)cudaGetLastError();
}
