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
// Design: one block per (batch row, chunk of E).  The row's table is small
// (P ~ 2000 pdfs = 8 KB), so the block stages it in shared memory with
// coalesced loads and the random reads then hit shared memory instead of
// L2/HBM; indices and outputs stream through coalesced.  A table row that does
// not fit the 227 KB a block may use is read from device memory directly.
// The result is bit-identical to the plain gather: values are only copied.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                       // E elements per thread
constexpr int kChunk = kThreads * kPerThread;       // E elements per block
constexpr int kMaxDynamicSmem = 232448;             // 227 KB

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int P, int E) {
    extern __shared__ float row_s[];
    const int b = blockIdx.y;
    const float* row = table + (size_t)b * P;
    if (kStage) {
        for (int p = threadIdx.x; p < P; p += kThreads) row_s[p] = row[p];
        __syncthreads();
    }
    const int* idx_b = idx + (size_t)b * E;
    float* out_b = out + (size_t)b * E;
    const int e0 = blockIdx.x * kChunk;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
        const int e = e0 + i * kThreads + threadIdx.x;
        if (e < E) {
            int p = idx_b[e];
            p = p < 0 ? 0 : (p >= P ? P - 1 : p);
            out_b[e] = kStage ? row_s[p] : __ldg(row + p);
        }
    }
}

}  // namespace

// table [B, P] f32, idx [B, E] i32, out [B, E] f32, all contiguous device
// pointers.  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int okt_batched_table_gather(const void* table, const void* idx,
                                        void* out, int B, int P, int E,
                                        void* stream) {
    if (B <= 0 || E <= 0) return 0;
    if (P <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid((E + kChunk - 1) / kChunk, B);
    const size_t smem = (size_t)P * sizeof(float);
    if (smem <= (size_t)kMaxDynamicSmem) {
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                gather_rows_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        gather_rows_kernel<true><<<grid, kThreads, smem, s>>>(
            (const float*)table, (const int*)idx, (float*)out, P, E);
    } else {
        gather_rows_kernel<false><<<grid, kThreads, 0, s>>>(
            (const float*)table, (const int*)idx, (float*)out, P, E);
    }
    return (int)cudaGetLastError();
}
