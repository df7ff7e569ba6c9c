// Fused MFCC from windowed frames:
//   [N, W] frames -> spectrum -> power [N, W/2] -> mel energies [N, NB]
//   -> log(max(., 1e-30)) -> liftered DCT [N, C],
// with nothing between the stages in device memory.
//
// Replaces the Pallas kernel old_kaldi_git_tpu/ops/mfcc_kernel.py
// (_mfcc_kernel / fused_mfcc_from_frames).  The TPU kernel computes the DFT,
// the mel sums and the DCT as four products padded to 128 lanes for its matrix
// unit.  Here the same function has two routes, chosen by W
// (ops/mfcc_kernel.py mfcc_route):
//
// "fft" (W = 128, 256, 512, 1024; the kernel is a template over W): a
// real-input FFT in float64.  Why float64: the contract is 1e-3 absolute
// against the float32 plain version, whose own error on real frames is
// 7e-4 to 9e-4; a 3xTF32 product or a float32 FFT adds errors of 1e-3 in
// the high cepstra, where the spectrum's small bins lose digits to its
// large ones.  The frame is read as M = W/2 complex points
// z[n] = x[2n] + i x[2n+1]; an M-point complex FFT runs in two or three
// Stockham passes (radices 16x4, 16x8, 16x16, 16x8x4), each thread holding
// 16 points in registers and doing a radix-16, -8 or -4 DFT on them
// (radix-2 decimation in frequency, constants exact in double); the passes
// exchange points through shared memory.  The split
//   X[k] = (Z[k] + Z*[M-k])/2 - i e^{-2 pi i k/W} (Z[k] - Z*[M-k])/2
// gives the bins k < M (the Nyquist bin is dropped, as MelBanks drops it).
// At W = 256 the second pass gives each thread the butterflies j and J - j,
// so it holds bins k and M - k and the split runs in its registers.
// Power, the mel energies (each filter summed over its span of nonzero bins:
// each block finds the spans in the dense [M, NB] table and keeps their
// weights, widened to float64, in shared memory), the floored log and the
// DCT are float64; the output is float32.  Twiddles e^{-2 pi i q/W} come from
// a float64 host table (mfcc_kernel.py twiddles), staged once a block.
// Bound on an H100: bytes.  About 7.2k float64 operations a frame at
// W = 256 (the dense product would be 131k): 0.60 GFLOP at N = 83,712, 18 us
// at 34 TFLOP/s, under the 27 us it takes to read the frames (4*N*W bytes at
// 3.35 TB/s).  Blocks are persistent (two or three an SM), and each walks
// over tiles of frames that arrive by cp.async.bulk on mbarriers, one copy a
// frame row, in a ring of two stages, while the tile before is transformed.
// Layout: a warp's lanes are frames of the tile (16 frames at W = 256, with
// two threads of each), so that every shared-memory access of the FFT, the
// split, the mel sums and the DCT reads consecutive doubles of the
// [point][frame] planes, and the twiddle and weight indices are shared by
// the lanes of a thread group.  The point planes are reused in turn for the
// power, the log mel energies and the outputs, so that three blocks fit an
// SM at W = 256.
// What limits it (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): 0.100 ms at
// N = 83,712, W = 256, 3.7x the bytes bound.  The loads are not what it
// waits for: float64 issue and shared-memory traffic (the points cross
// shared memory twice in float64) in short phases between barriers, with 12
// warps an SM to hide their latency.

// "dft" (any other W, e.g. 400 with round_to_power_of_two=False): the direct
// DFT in float64, X[k] = sum_n x[n] e^{-2 pi i nk/W}, with the twiddles of the
// same float64 table (index nk mod W), then the same float64 tail.  Not on
// the decoders' paths (their windows are powers of two); a block takes 32
// frames, a thread a (bin, frame) pair at a time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kMaxDynamicSmem = 232448;                      // 227 KB

// ------------------------------------------------------ both routes --

constexpr int kMaxBins = 128;  // mel bins the span table holds
constexpr double kLogFloor = 1e-30;

// A block's copy of the filterbank, filter by filter: each filter's span of
// nonzero bins in the dense [M, NB] table and the span's weights back to
// back in shared memory, widened to float64 once (each bin lies in at most
// two triangular filters, so 2M + NB values hold them; the wrapper refuses a
// table whose spans do not fit, and a kernel given one stores NaN).
struct MelTable {
    int* first;   // [kMaxBins] each filter's first nonzero bin
    int* len;     // [kMaxBins] bins from its first to its last nonzero one
    int* off;     // [kMaxBins + 1] where its weights start in w; off[NB] = all
    double* w;    // [2M + NB]
};

__host__ __device__ constexpr int mel_ints() { return 3 * kMaxBins + 4; }
__host__ __device__ constexpr int mel_doubles(int M, int NB) { return (2 * M + NB + 1) / 2 * 2; }

__device__ __forceinline__ MelTable carve_mel(int* at, int M, int NB) {
    return {at, at + kMaxBins, at + 2 * kMaxBins, reinterpret_cast<double*>(at + mel_ints())};
}

// every thread takes some entries of the dense table (coalesced); shared
// atomics find each filter's first and last nonzero bin, one thread lays out
// the spans (all empty if they do not fit: mel_log then stores NaN), then the
// weights are copied.  Ends synchronised.
__device__ __forceinline__ void build_mel(const float* __restrict__ mel, int M, int NB,
                                          MelTable t) {
    for (int m = threadIdx.x; m < NB; m += blockDim.x) {
        t.first[m] = M;
        t.len[m] = -1;  // the last nonzero bin, until the layout
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * NB; i += blockDim.x)
        if (__ldg(mel + i) != 0.f) {
            atomicMin(&t.first[i % NB], i / NB);
            atomicMax(&t.len[i % NB], i / NB);
        }
    __syncthreads();
    if (threadIdx.x == 0) {
        int o = 0;
        for (int m = 0; m < NB; ++m) {
            t.len[m] = max(t.len[m] - t.first[m] + 1, 0);
            t.off[m] = o;
            o += t.len[m];
        }
        t.off[NB] = o;
        if (o > mel_doubles(M, NB))
            for (int m = 0; m < NB; ++m) t.len[m] = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * NB; i += blockDim.x) {
        const int k = i / NB, m = i - k * NB, q = k - t.first[m];
        if (q >= 0 && q < t.len[m]) t.w[t.off[m] + q] = (double)__ldg(mel + i);
    }
    __syncthreads();
}

// power [M][F] -> the mel energies over each filter's span -> floored log
// [NB][F].  Thread (frame g = tid % F, group tid / F) takes filters group,
// group + groups, ...: a warp's lanes are neighbouring frames of one filter,
// so each weight is one broadcast load; four partial sums keep four loads in
// flight
__device__ __forceinline__ void mel_log(const double* pw, double* lm, const MelTable t, int M,
                                        int NB, int F) {
    const int g = threadIdx.x % F, groups = blockDim.x / F;
    const double unfit = t.off[NB] > mel_doubles(M, NB) ? __longlong_as_double(0x7ff8000000000000LL) : 0.0;
    // three filters at a time, their sums and logs interleaved: each is a
    // chain of dependent operations, too short to keep a warp busy alone
    for (int m0 = threadIdx.x / F; m0 < NB; m0 += 3 * groups) {
        int len[3];
        const double* p[3];
        const double* w[3];
        double a[3][2];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int m = min(m0 + i * groups, NB - 1);
            len[i] = m0 + i * groups < NB ? t.len[m] : 0;
            p[i] = pw + t.first[m] * F + g;
            w[i] = t.w + t.off[m];
            a[i][0] = a[i][1] = 0.0;
        }
        const int n = max(len[0], max(len[1], len[2]));
        for (int q = 0; q < n; q += 2) {
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                if (q < len[i]) a[i][0] = fma(p[i][q * F], w[i][q], a[i][0]);
                if (q + 1 < len[i]) a[i][1] = fma(p[i][(q + 1) * F], w[i][q + 1], a[i][1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const double v = log(fmax(a[i][0] + a[i][1], kLogFloor)) + unfit;
            if (m0 + i * groups < NB) lm[(m0 + i * groups) * F + g] = v;
        }
    }
}

// liftered DCT of the tile's first `rows` frames against the block's float64
// copy of the [NB, C] table: thread (frame g, group) takes cepstra in pairs
// (group + 2j*groups, and that + groups), each log-mel value loaded once for
// both; the rows x C outputs gather in out_s, then go to `out` with coalesced
// stores
__device__ __forceinline__ void dct_store(const double* lm, const double* dct_s, float* out_s,
                                          float* __restrict__ out, int rows, int NB, int C,
                                          int F) {
    const int g = threadIdx.x % F, groups = blockDim.x / F;
    for (int c0 = threadIdx.x / F; c0 < C; c0 += 2 * groups) {
        const int c1 = c0 + groups, d1 = min(c1, C - 1);  // an in-bounds read for c1 >= C
        double a0 = 0.0, a1 = 0.0;
#pragma unroll 4
        for (int m = 0; m < NB; ++m) {
            const double l = lm[m * F + g];
            a0 = fma(l, dct_s[m * C + c0], a0);
            a1 = fma(l, dct_s[m * C + d1], a1);
        }
        out_s[g * C + c0] = (float)a0;
        if (c1 < C) out_s[g * C + c1] = (float)a1;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < rows * C; t += blockDim.x) out[t] = out_s[t];
}

namespace fft {

constexpr int kThreads = 128;  // a block; two or three blocks share an SM
constexpr int kPoints = 16;    // complex points a thread holds in a pass
constexpr int kStages = 2;     // frame tiles in flight
constexpr int kRowPad = 4;     // floats after a staged frame row

template <int W>
struct Shape {
    static constexpr int M = W / 2;               // complex points a frame
    static constexpr int Tf = M / kPoints;        // threads a frame
    static constexpr int F = kThreads / Tf;       // frames a tile
    static constexpr int Row = W + kRowPad;       // staged row stride, floats
    // radices of the passes after the first radix-16 pass (1: no pass)
    static constexpr int R2 = W == 128 ? 4 : W == 256 ? 8 : W == 512 ? 16 : 8;
    static constexpr int R3 = W == 1024 ? 4 : 1;
    static_assert(kPoints * R2 * R3 == M, "the passes must cover W/2 points");
    // two passes whose second gives a thread two butterflies (W = 256): the
    // split runs in that pass's registers (last_pass_split)
    static constexpr bool kFusedSplit = R3 == 1 && kPoints / R2 == 2;
};

// bytes of shared memory a block uses
template <int W>
size_t smem_bytes(int NB, int C) {
    using S = Shape<W>;
    return sizeof(double) * (2 * S::M * S::F + 2 * W) +
           sizeof(float) * kStages * S::F * S::Row +
           sizeof(int) * mel_ints() + sizeof(double) * mel_doubles(S::M, NB) +
           sizeof(uint64_t) * kStages + sizeof(double) * (size_t)NB * C;
}

// cos(2 pi t/16) and sin(2 pi t/16) for t = 0..7, correctly rounded
__device__ __forceinline__ constexpr double cos16(int t) {
    return t == 0 ? 1.0
         : t == 1 ? 0.92387953251128674
         : t == 2 ? 0.70710678118654752
         : t == 3 ? 0.38268343236508977
         : t == 4 ? 0.0
         : t == 5 ? -0.38268343236508977
         : t == 6 ? -0.70710678118654752
                  : -0.92387953251128674;
}
__device__ __forceinline__ constexpr double sin16(int t) { return cos16(t <= 4 ? 4 - t : t - 4); }

__host__ __device__ constexpr int log2i(int r) {
    int n = 0;
    while ((1 << n) < r) ++n;
    return n;
}
// k's low `bits` (at most 4) reversed; no loop, so that it folds to a constant
// in the unrolled loops and the register arrays keep constant indices
__host__ __device__ constexpr int bitrev(int k, int bits) {
    return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3)) >> (4 - bits);
}

// one radix-2 stage of an R-point DFT in frequency decimation: butterflies
// of span 2H, then the next stage.  Every loop bound is a template constant,
// so that the loops unroll and the points stay in registers.
template <int R, int H>
__device__ __forceinline__ void dif_stage(double (&re)[kPoints], double (&im)[kPoints],
                                          const int o) {
#pragma unroll
    for (int s = 0; s < R; s += 2 * H) {
#pragma unroll
        for (int q = 0; q < H; ++q) {
            const int a = o + s + q, c = a + H;
            const double ar = re[a], ai = im[a], cr = re[c], ci = im[c];
            re[a] = ar + cr;
            im[a] = ai + ci;
            const double dr = ar - cr, di = ai - ci;
            const int t = q * (16 / (2 * H));  // (dr + i di) e^{-2 pi i t/16}
            if (t == 0) {
                re[c] = dr;
                im[c] = di;
            } else if (t == 4) {
                re[c] = di;
                im[c] = -dr;
            } else {
                re[c] = fma(dr, cos16(t), di * sin16(t));
                im[c] = fma(di, cos16(t), -dr * sin16(t));
            }
        }
    }
    if constexpr (H > 1) dif_stage<R, H / 2>(re, im, o);
}

// an R-point DFT of points o..o+R-1 in place; result k lands at o + bitrev(k)
template <int R>
__device__ __forceinline__ void dft(double (&re)[kPoints], double (&im)[kPoints], const int o) {
    dif_stage<R, R / 2>(re, im, o);
}

// the rest of a Stockham pass of radix R after stride Ns: each of the
// thread's kPoints/R butterflies j = tf + b*Tf takes its points
// (j + r*M/R, already in registers), turns point r by e^{-2 pi i r (j%Ns)/(Ns R)},
// runs the DFT and stores result k at (j/Ns)*Ns*R + j%Ns + k*Ns
template <int W, int R, int Ns>
__device__ __forceinline__ void finish_pass(double (&re)[kPoints], double (&im)[kPoints],
                                            double* zre, double* zim, const double2* tw,
                                            int f, int tf) {
    using S = Shape<W>;
    constexpr int kLog = log2i(R);
#pragma unroll
    for (int b = 0; b < kPoints / R; ++b) {
        const int j = tf + b * S::Tf;
        const int jm = j & (Ns - 1);
        if constexpr (Ns > 1) {
#pragma unroll
            for (int r = 1; r < R; ++r) {
                const double2 w = tw[r * jm * (W / (Ns * R))];
                const double a = re[b * R + r], c = im[b * R + r];
                re[b * R + r] = fma(a, w.x, -c * w.y);
                im[b * R + r] = fma(a, w.y, c * w.x);
            }
        }
        dft<R>(re, im, b * R);
        const int d = (j - jm) * R + jm;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int at = (d + k * Ns) * S::F + f;
            zre[at] = re[b * R + bitrev(k, kLog)];
            zim[at] = im[b * R + bitrev(k, kLog)];
        }
    }
}

// a later pass: load, wait for every thread's loads, transform, store in place
template <int W, int R, int Ns>
__device__ __forceinline__ void pass(double* zre, double* zim, const double2* tw, int f, int tf) {
    using S = Shape<W>;
    constexpr int J = S::M / R;
    double re[kPoints], im[kPoints];
#pragma unroll
    for (int b = 0; b < kPoints / R; ++b) {
        const int j = tf + b * S::Tf;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int at = (j + r * J) * S::F + f;
            re[b * R + r] = zre[at];
            im[b * R + r] = zim[at];
        }
    }
    __syncthreads();
    finish_pass<W, R, Ns>(re, im, zre, zim, tw, f, tf);
    __syncthreads();
}

// the second and last pass when it gives each thread two butterflies, with
// the real-input split and the power in its registers: thread tf takes
// butterflies tf and J - tf (thread 0: 0 and J/2), so that with every bin
// k = j + r*J it holds bin M - k too, and the points never go back to
// shared memory.  Reads the first pass's points, waits for every thread's
// reads, writes the power over them.
template <int W, int R>
__device__ __forceinline__ void last_pass_split(const double* zre, const double* zim, double* pw,
                                                const double2* tw, int f, int tf) {
    using S = Shape<W>;
    constexpr int M = S::M, J = M / R, kLog = log2i(R);
    static_assert(kPoints / R == 2 && J == 2 * S::Tf, "two butterflies a thread");
    const int js[2] = {tf, tf ? J - tf : J / 2};
    double re[kPoints], im[kPoints];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int at = (js[b] + r * J) * S::F + f;
            re[b * R + r] = zre[at];
            im[b * R + r] = zim[at];
        }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int r = 1; r < R; ++r) {  // e^{-2 pi i r j/M}
            const double2 w = tw[2 * r * js[b]];
            const double a = re[b * R + r], c = im[b * R + r];
            re[b * R + r] = fma(a, w.x, -c * w.y);
            im[b * R + r] = fma(a, w.y, c * w.x);
        }
        dft<R>(re, im, b * R);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int k = js[b] + r * J;
            // bin M - k: butterfly 1 - b, result R-1-r; for thread 0 the
            // butterflies pair with themselves (0: result (R-r) mod R)
            const int other = (1 - b) * R + bitrev(R - 1 - r, kLog);
            const int self = b == 0 ? bitrev((R - r) & (R - 1), kLog) : R + bitrev(R - 1 - r, kLog);
            const double ar = re[b * R + bitrev(r, kLog)], ai = im[b * R + bitrev(r, kLog)];
            const double br = tf ? re[other] : re[self], bi = -(tf ? im[other] : im[self]);
            const double2 w = tw[k];
            const double dr = ar - br, di = ai - bi;
            const double xr = 0.5 * (ar + br + fma(w.x, di, w.y * dr));
            const double xi = 0.5 * (ai + bi - fma(w.x, dr, -w.y * di));
            pw[k * S::F + f] = fma(xr, xr, xi * xi);
        }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 3)
mfcc_fft_kernel(const float* __restrict__ frames, const double2* __restrict__ tw_g,
                const float* __restrict__ mel, const float* __restrict__ dct,
                float* __restrict__ out, int N, int NB, int C) {
    using S = Shape<W>;
    constexpr int M = S::M, F = S::F;
    extern __shared__ __align__(16) double smem[];
    // the point planes hold, in turn, the points, then the power (real
    // plane) and the log mel energies (imaginary plane), then the outputs
    double* const zre = smem;            // [M][F] points, real parts; power
    double* const zim = zre + M * F;     // [M][F] imaginary parts; [NB][F] log mel
    double* const pw = zre;
    double* const lm = zim;
    double2* const tw = reinterpret_cast<double2*>(zim + M * F);  // [W]
    float* const ring = reinterpret_cast<float*>(tw + W);         // [kStages][F][Row]
    int* const mel_at = reinterpret_cast<int*>(ring + kStages * F * S::Row);
    const MelTable mt = carve_mel(mel_at, M, NB);
    uint64_t* const full = reinterpret_cast<uint64_t*>(mt.w + mel_doubles(M, NB));
    double* const dct_s = reinterpret_cast<double*>(full + kStages);  // [NB][C]

    const int tid = threadIdx.x;
    const int f = tid % F, tf = tid / F;
    const int num_tiles = (N + F - 1) / F;

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
        mbar_init_fence();
    }
    for (int q = tid; q < W; q += kThreads) tw[q] = tw_g[q];
    for (int q = tid; q < NB * C; q += kThreads) dct_s[q] = (double)__ldg(dct + q);
    build_mel(mel, M, NB, mt);

    // warp 0 brings local tile i (the block's i-th) into stage i % kStages,
    // one bulk copy a frame row
    auto issue = [&](int i) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile >= num_tiles) return;
        const int s = i % kStages, n0 = tile * F, rows = min(F, N - n0);
        if (tid == 0) mbar_expect_tx(&full[s], (uint32_t)(rows * W * sizeof(float)));
        __syncwarp();
        for (int r = tid; r < rows; r += 32)
            bulk_load(ring + (s * F + r) * S::Row, frames + (size_t)(n0 + r) * W,
                      W * sizeof(float), &full[s]);
    };
    if (tid < 32)
        for (int i = 0; i < kStages; ++i) issue(i);

    for (int i = 0, tile = blockIdx.x; tile < num_tiles; ++i, tile += gridDim.x) {
        const int s = i % kStages;
        const int n0 = tile * F, rows = min(F, N - n0);
        mbar_wait(&full[s], (i / kStages) & 1);

        {  // pass 1, radix 16: points tf + r*Tf of the staged frame
            double re[kPoints], im[kPoints];
            const float* x = ring + (s * F + f) * S::Row;
#pragma unroll
            for (int r = 0; r < kPoints; ++r) {
                const float2 v = *reinterpret_cast<const float2*>(x + 2 * (tf + r * S::Tf));
                re[r] = v.x;
                im[r] = v.y;
            }
            finish_pass<W, kPoints, 1>(re, im, zre, zim, tw, f, tf);
        }
        __syncthreads();  // the stage is free, the points are stored
        if (tid < 32) issue(i + kStages);
        if constexpr (S::kFusedSplit) {
            last_pass_split<W, S::R2>(zre, zim, pw, tw, f, tf);
        } else {
            pass<W, S::R2, kPoints>(zre, zim, tw, f, tf);
            if constexpr (S::R3 > 1) pass<W, S::R3, kPoints * S::R2>(zre, zim, tw, f, tf);
            // the real-input split and the power of bins k = tf + q*Tf,
            // written over the points once every thread has read its own
            double power[kPoints];
#pragma unroll
            for (int q = 0; q < kPoints; ++q) {
                const int k = tf + q * S::Tf, kk = (M - k) & (M - 1);
                const double ar = zre[k * F + f], ai = zim[k * F + f];
                const double br = zre[kk * F + f], bi = -zim[kk * F + f];
                const double2 w = tw[k];
                const double dr = ar - br, di = ai - bi;
                const double xr = 0.5 * (ar + br + fma(w.x, di, w.y * dr));
                const double xi = 0.5 * (ai + bi - fma(w.x, dr, -w.y * di));
                power[q] = fma(xr, xr, xi * xi);
            }
            __syncthreads();
#pragma unroll
            for (int q = 0; q < kPoints; ++q) pw[(tf + q * S::Tf) * F + f] = power[q];
        }
        __syncthreads();

        mel_log(pw, lm, mt, M, NB, F);
        __syncthreads();
        dct_store(lm, dct_s, reinterpret_cast<float*>(pw), out + (size_t)n0 * C, rows, NB,
                  C, F);  // the power is spent: its plane gathers the outputs
        __syncthreads();  // the next tile's points go over the log mel and outputs
    }
}

template <int W>
int launch(const float* frames, const double2* tw, const float* mel, const float* dct,
           float* out, int N, int NB, int C, cudaStream_t stream) {
    const size_t smem = smem_bytes<W>(NB, C);
    if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(mfcc_fft_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mfcc_fft_kernel<W>, kThreads,
                                                           smem)) != cudaSuccess)
        return (int)e;
    const int tiles = (N + Shape<W>::F - 1) / Shape<W>::F;
    const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;  // persistent blocks
    mfcc_fft_kernel<W><<<grid, kThreads, smem, stream>>>(frames, tw, mel, dct, out, N, NB, C);
    return (int)cudaGetLastError();
}

}  // namespace fft

// ---------------------------------------------------------------- "dft" --

namespace direct {

constexpr int kThreads = 256;  // a block
constexpr int kFrames = 32;    // frames a block

// bytes of shared memory a block uses
size_t smem_bytes(int W, int NB, int C) {
    return sizeof(double) * ((size_t)(W / 2 + NB) * kFrames + 2 * W) +
           sizeof(float) * (size_t)W * kFrames +
           sizeof(int) * mel_ints() + sizeof(double) * mel_doubles(W / 2, NB) +
           sizeof(double) * (size_t)NB * C;
}

__global__ void __launch_bounds__(kThreads)
mfcc_direct_kernel(const float* __restrict__ frames, const double2* __restrict__ tw_g,
                   const float* __restrict__ mel, const float* __restrict__ dct,
                   float* __restrict__ out, int N, int W, int NB, int C) {
    constexpr int F = kFrames;
    const int M = W / 2;
    extern __shared__ __align__(16) double smem[];
    double* const pw = smem;                                     // [M][F]
    double* const lm = pw + M * F;                               // [NB][F]
    double2* const tw = reinterpret_cast<double2*>(lm + NB * F);  // [W]
    float* const x = reinterpret_cast<float*>(tw + W);          // [W][F]
    const MelTable mt = carve_mel(reinterpret_cast<int*>(x + W * F), M, NB);
    double* const dct_s = mt.w + mel_doubles(M, NB);  // [NB][C]
    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * F, rows = min(F, N - n0);

    for (int q = tid; q < W; q += kThreads) tw[q] = tw_g[q];
    for (int q = tid; q < NB * C; q += kThreads) dct_s[q] = (double)__ldg(dct + q);
    build_mel(mel, M, NB, mt);
    for (int i = tid; i < F * W; i += kThreads) {  // coalesced reads, [sample][frame]
        const int g = i / W, n = i - g * W;
        x[n * F + g] = g < rows ? frames[(size_t)(n0 + g) * W + n] : 0.f;
    }
    __syncthreads();

    for (int t = tid; t < M * F; t += kThreads) {
        const int k = t / F, g = t - k * F;
        double re = 0.0, im = 0.0;
        for (int n = 0, q = 0; n < W; ++n) {  // q = nk mod W
            const double v = x[n * F + g];
            const double2 w = tw[q];
            re = fma(v, w.x, re);
            im = fma(v, w.y, im);
            q += k;
            if (q >= W) q -= W;
        }
        pw[k * F + g] = fma(re, re, im * im);
    }
    __syncthreads();
    mel_log(pw, lm, mt, M, NB, F);
    __syncthreads();
    dct_store(lm, dct_s, reinterpret_cast<float*>(pw), out + (size_t)n0 * C, rows, NB, C, F);
}

}  // namespace direct

}  // namespace

// Shared memory a block of one route needs for a window of W samples, NB
// mel bins and C cepstra (fft != 0: the "fft" route, else "dft"), or -1 when
// that route does not take them.  A launch refuses more than 227 KB.  The
// wrapper asks before it launches, so that this file alone knows the layout.
extern "C" long long okt_fused_mfcc_smem(int fft, int W, int NB, int C) {
    if (NB <= 0 || NB > kMaxBins || C <= 0 || W <= 0 || W % 2 != 0) return -1;
    if (!fft) return (long long)direct::smem_bytes(W, NB, C);
    if (NB > W / 2) return -1;  // the log mel energies go over the points' plane
    switch (W) {
        case 128: return (long long)fft::smem_bytes<128>(NB, C);
        case 256: return (long long)fft::smem_bytes<256>(NB, C);
        case 512: return (long long)fft::smem_bytes<512>(NB, C);
        case 1024: return (long long)fft::smem_bytes<1024>(NB, C);
        default: return -1;
    }
}

// frames [N, W] f32 (16-byte aligned), tw [W] (cos, -sin) f64 pairs,
// mel [W/2, NB], dct [NB, C], out [N, C] f32: contiguous device pointers;
// W one of 128, 256, 512, 1024; NB <= min(128, W/2); the spans of the mel
// filters' nonzero bins hold at most 2*(W/2) + NB bins in all (else NaN
// out).  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError().
extern "C" int okt_fused_mfcc_fft(const void* frames, const void* tw, const void* mel,
                                  const void* dct, void* out, int N, int W, int NB, int C,
                                  void* stream) {
    if (N <= 0) return 0;
    if (okt_fused_mfcc_smem(1, W, NB, C) < 0 || ((uintptr_t)frames & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const float* x = static_cast<const float*>(frames);
    const double2* t = static_cast<const double2*>(tw);
    const float* m = static_cast<const float*>(mel);
    const float* d = static_cast<const float*>(dct);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 128: return fft::launch<128>(x, t, m, d, o, N, NB, C, s);
        case 256: return fft::launch<256>(x, t, m, d, o, N, NB, C, s);
        case 512: return fft::launch<512>(x, t, m, d, o, N, NB, C, s);
        default: return fft::launch<1024>(x, t, m, d, o, N, NB, C, s);
    }
}

// frames [N, W] f32, tw [W] (cos, -sin) f64 pairs, mel [W/2, NB], dct [NB, C],
// out [N, C] f32: contiguous device pointers; W even, NB <= 128, the mel
// spans as for the "fft" route.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError().
extern "C" int okt_fused_mfcc_dft(const void* frames, const void* tw, const void* mel,
                                  const void* dct, void* out, int N, int W, int NB, int C,
                                  void* stream) {
    if (N <= 0) return 0;
    const long long smem = okt_fused_mfcc_smem(0, W, NB, C);
    if (smem < 0 || smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(direct::mfcc_direct_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = (N + direct::kFrames - 1) / direct::kFrames;
    direct::mfcc_direct_kernel<<<grid, direct::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(frames), static_cast<const double2*>(tw),
        static_cast<const float*>(mel), static_cast<const float*>(dct), static_cast<float*>(out),
        N, W, NB, C);
    return (int)cudaGetLastError();
}
