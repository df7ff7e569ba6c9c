// Batched small-table gather:  out[b, j] = table[b, clamp(idx[b, j], 0, P-1)]
//
// Replaces the Pallas one-hot kernel old_kaldi_git_tpu/ops/gather_kernel.py
// (_gather_kernel / _pallas_gather / batched_table_gather).  The TPU kernel
// rebuilt the gather as a compare-select-reduce because that machine's gather
// unit is element-serial; a GPU gathers natively, so nothing of that shape is
// carried over.
//
// Bound on an H100: bytes.  The function must move 4*B*(2E + P) bytes (indices
// in, values out, each table row once); it does no arithmetic worth counting.
// Design: a block takes one batch row and a chunk of 2,048 of its indices
// (8 a thread): 384 blocks at the decoder's [128, 6144], each bringing its
// row's table itself (measured 5-6 % faster than one block per row).  The
// row's table is small (P ~ 2000 pdfs = 8 KB) and goes to shared memory, so
// that the random reads hit shared memory instead of L2/HBM, in one memory
// round trip:
//   - a 16-byte aligned row comes by one cp.async.bulk that completes on an
//     mbarrier; any other row is staged by the block's threads, 16 bytes at a
//     time from its first aligned element, shifted in shared memory by the
//     row's misalignment so that the vector stores stay aligned;
//   - each thread's indices are loaded (16 bytes at a time where E and the
//     row allow) into registers BEFORE the block waits for the table, so
//     that the table copy and the index loads are in flight together;
//   - outputs are stored 16 bytes at a time, with a scalar ragged tail.
// The table is read in place through its row stride (loglikes[:, t] of a
// [B, T, P] tensor needs no copy).  A row that does not fit the 227 KB a
// block may use is read from device memory directly.  The result is
// bit-identical to the plain gather: values are only copied.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                       // E elements per thread
constexpr int kChunk = kThreads * kPerThread;       // E elements per block
constexpr int kMaxDynamicSmem = 232448;             // 227 KB
constexpr int kMaxStagedFloats = kMaxDynamicSmem / 4 - 8;  // room for the shift, the barrier

enum Stage { kBulk, kThreadsCopy, kNone };

__device__ __forceinline__ int clampi(int p, int P) { return p < 0 ? 0 : (p >= P ? P - 1 : p); }

// a vector of 4 indices and of 4 outputs a step (E % 4 == 0 and 16-byte
// aligned rows), else one at a time
template <Stage kStage, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, long long ld,
                   const int* __restrict__ idx, float* __restrict__ out, int P, int E) {
    extern __shared__ __align__(16) float row_s[];
    __shared__ uint64_t bar;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const float* row = table + (size_t)b * ld;
    const int* idx_b = idx + (size_t)b * E;
    float* out_b = out + (size_t)b * E;
    // the staged row starts `shift` floats into row_s, so that a float's
    // place in shared memory has the same 16-byte phase as in device memory
    const int shift = kStage == kThreadsCopy ? (int)(((uintptr_t)row >> 2) & 3) : 0;

    if (kStage == kBulk && tid == 0) {
        mbar_init(&bar, 1);
        mbar_init_fence();
        mbar_expect_tx(&bar, (uint32_t)P * 4u);
        bulk_load(row_s, row, (uint32_t)P * 4u, &bar);
    }

    const int e0 = blockIdx.x * kChunk;

    // this thread's indices, before anything waits for the table
    int p[kPerThread];
    if (kVec) {
#pragma unroll
        for (int v = 0; v < kPerThread / 4; ++v) {
            const int e = e0 + 4 * (v * kThreads + tid);
            int4 q = make_int4(0, 0, 0, 0);
            if (e < E) q = __ldg(reinterpret_cast<const int4*>(idx_b + e));
            p[4 * v] = q.x; p[4 * v + 1] = q.y; p[4 * v + 2] = q.z; p[4 * v + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
            const int e = e0 + i * kThreads + tid;
            p[i] = e < E ? __ldg(idx_b + e) : 0;
        }
    }

    // the table arrives
    if (kStage == kBulk) {
        __syncthreads();  // the barrier's initialisation is visible
        mbar_wait(&bar, 0);
    } else if (kStage == kThreadsCopy) {
        const float* base = row - shift;  // 16-byte aligned
        const int n4 = (P + shift + 3) >> 2;
        for (int q = tid; q < n4; q += kThreads) {
            const int lo = 4 * q - shift;  // the row's element at row_s[4q]
            if (lo >= 0 && lo + 3 < P) {
                reinterpret_cast<float4*>(row_s)[q] =
                    __ldg(reinterpret_cast<const float4*>(base) + q);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (lo + k >= 0 && lo + k < P) row_s[4 * q + k] = __ldg(row + lo + k);
            }
        }
        __syncthreads();
    }

    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
        const int c = clampi(p[i], P);
        v[i] = kStage == kNone ? __ldg(row + c) : row_s[shift + c];
    }
    if (kVec) {
#pragma unroll
        for (int w = 0; w < kPerThread / 4; ++w) {
            const int e = e0 + 4 * (w * kThreads + tid);
            if (e < E)
                *reinterpret_cast<float4*>(out_b + e) =
                    make_float4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
            const int e = e0 + i * kThreads + tid;
            if (e < E) out_b[e] = v[i];
        }
    }
}

template <Stage kStage, bool kVec>
cudaError_t launch(const float* table, long long ld, const int* idx, float* out, int B,
                   int P, int E, size_t smem, cudaStream_t s) {
    auto kernel = gather_rows_kernel<kStage, kVec>;
    if (smem > 48 * 1024) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<dim3((E + kChunk - 1) / kChunk, B), kThreads, smem, s>>>(table, ld, idx, out, P, E);
    return cudaGetLastError();
}

}  // namespace

// table [B, P] f32 with row stride `ld` elements (ld >= P; the row itself
// contiguous), idx [B, E] i32 and out [B, E] f32 contiguous, device pointers.
// Launches on `stream`, does not synchronise.  Returns cudaGetLastError()
// (0 = launched).
extern "C" int okt_batched_table_gather(const void* table, long long ld, const void* idx,
                                        void* out, int B, int P, int E, void* stream) {
    if (B <= 0 || E <= 0) return 0;
    if (P <= 0 || ld < P || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* t = static_cast<const float*>(table);
    const int* ix = static_cast<const int*>(idx);
    float* o = static_cast<float*>(out);
    const bool vec = E % 4 == 0 && ((uintptr_t)ix & 15) == 0 && ((uintptr_t)o & 15) == 0;
    const bool rows_aligned = P % 4 == 0 && ld % 4 == 0 && ((uintptr_t)t & 15) == 0;
    cudaError_t e;
    if (P > kMaxStagedFloats) {
        e = vec ? launch<kNone, true>(t, ld, ix, o, B, P, E, 0, s)
                : launch<kNone, false>(t, ld, ix, o, B, P, E, 0, s);
    } else if (rows_aligned) {
        const size_t smem = (size_t)P * sizeof(float);
        e = vec ? launch<kBulk, true>(t, ld, ix, o, B, P, E, smem, s)
                : launch<kBulk, false>(t, ld, ix, o, B, P, E, smem, s);
    } else {
        const size_t smem = ((size_t)P + 4) * sizeof(float);
        e = vec ? launch<kThreadsCopy, true>(t, ld, ix, o, B, P, E, smem, s)
                : launch<kThreadsCopy, false>(t, ld, ix, o, B, P, E, smem, s);
    }
    return (int)e;
}
