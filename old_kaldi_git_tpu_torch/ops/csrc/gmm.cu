// Batched diagonal-GMM log-likelihoods on Hopper's tensor cores:
//   out[n, p] = logsumexp_{g in pdf p} ( [x_n, x_n^2, 1] . W_g )
//
// Replaces the Pallas kernel old_kaldi_git_tpu/ops/gmm_kernel.py:125
// (gmm_loglikes_pallas / _gmm_kernel / pack_gmm_weights).  The TPU kernel pads
// every pdf to a power-of-two mixture count (64 for a 2,000-pdf, 2,800-Gaussian
// triphone model: 45.7x the real work) and reduces each pdf's group with
// indicator matmuls, a temperature-8 stabiliser and a bf16x3 split, all to keep
// the MXU busy.  None of that is carried over.
//
// Bound on an H100 (N = 167,424 frames, G = 2,800 Gaussians, D = 39): the
// product is 2*N*G*(2D+1) = 74.1 GFLOP.  It needs about 2^-22 relative
// precision (features reach +-127, scores -6,700 nats), which the tensor cores
// give as three TF32 products: 3 x 74.1 GFLOP at 495 TFLOP/s = 0.449 ms, set
// by operations.  The bytes, almost all of them the [N, P] f32 output
// (1.366 GB at 3.35 TB/s), take 0.408 ms.  (In fp32 on the CUDA cores the same
// product would take 1.106 ms at 67 TFLOP/s.)
//
// Layout (built on the host, ops/gmm_kernel.py pack_gmm_weights): the real
// Gaussians are packed pdf by pdf into tiles of kCols = 64 columns (a pdf is
// split only when it is larger than a tile); the depth 2D+1 is padded to K, a
// multiple of 8; each tile holds hi = tf32(W) then lo = tf32(W - hi), already in
// the canonical K-major layout wgmma reads without swizzle (core matrices of 8
// columns x 4 depths, 128 contiguous bytes), so one bulk copy brings a tile.
// No swizzle: the 128-byte swizzle would need K padded to 96 (20% more
// products), and the operands are read by the tensor cores, not by threads.
// Per tile a list of segments (pdf, first column, end column, flags) says
// which columns each of its pdfs owns and whether the pdf began in an earlier
// tile (CARRY_IN) or runs on into the next (CARRY_OUT), and a work list names
// the segments that need a logsumexp, in two halves of about equal columns.
//
// The kernel: one block takes kRows = 128 frames with two consumer warpgroups
// of 64 rows and one producer warp.  The block stages its frames once as
// [x, x^2, 1, 0..] rows split into hi/lo (cvt.rna.tf32.f32) in shared memory.
// The producer streams every tile's hi/lo through a two-stage ring with
// cp.async.bulk, synchronised by mbarriers (full: bytes arrived; empty: all
// eight consumer warps are done with the stage).  Each warpgroup runs, per
// tile and per k-step of 8, three wgmma m64n64k8 TF32 products into one fp32
// accumulator, the small terms first: lo.hi, hi.lo, then hi.hi.  It issues
// tile t+1's products before it takes tile t's epilogue, with two accumulator
// sets, so that the epilogue and its stores overlap the next tile's products.
// The k-steps are unrolled at compile time (the kernel is built for each K):
// ptxas serialises wgmmas inside a runtime loop.
// Epilogue: the accumulators go to a shared [kCols][kRows] score tile.  Two
// threads own a frame row, one half of the work list each, so that a warp's
// lanes walk the same pdfs and columns: an exact logsumexp over a pdf's
// columns (max, then the sum of exp(score - max), then max + log(sum); four
// columns a step into a running (max, sum) for a pdf wider than four),
// written back at the pdf's first column.  A pdf of one Gaussian needs
// nothing: its score is its loglike (1,497 of tri.mdl's 2,000 pdfs).  A pdf
// that runs on into the next tile keeps its per-frame (max, sum) in shared
// memory until its last column: a carry inside the block, with no second pass
// and no atomics.  A tile's pdfs are consecutive, so each warp store writes
// one run of neighbouring pdfs of one frame (coalesced), gathered from each
// pdf's first column.  exp and log are the SFU's (__expf, __logf): relative
// errors near 2^-21 on sums of at most a few dozen terms near 1, far inside
// the contract.
//
// What this does about the faults of the simpler design it replaces (one
// thread per pdf looping over its Gaussians for 32 frames, fp32 FMAs):
// no divergence, since the products cover a tile's columns whatever the
// pdfs' sizes (97.2% of tri.mdl's columns are real Gaussians) and the lanes
// of a warp share every pdf in the logsumexp; accumulators live in wgmma
// fragments (two sets of 32 floats), 122 registers a thread without spills,
// where 32 sums and 32 (max, sum) pairs a thread took 136; and the products
// run on the tensor cores.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, N = 167,424, tri.mdl): 1.85 ms, 4.1x the bound; the
// one-thread-per-pdf fp32 design took 19.95 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kRows = 128;               // frames per block (FRAMES_PER_BLOCK)
constexpr int kCols = 64;                // Gaussian columns per tile (COLS_PER_TILE)
constexpr int kConsumerThreads = 256;    // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kCarryIn = 1, kCarryOut = 2;  // segment flags (CARRY_IN, CARRY_OUT)

__device__ __forceinline__ float tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return __uint_as_float(r);
}

// float index of (row r, depth k) in an operand of 8-row groups, K-major,
// core matrices of 8 rows x 4 depths
__device__ __forceinline__ int core_index(int r, int k, int K) {
    return (((r >> 3) * (K >> 2) + (k >> 2)) << 5) + ((r & 7) << 2) + (k & 3);
}

// wgmma shared-memory descriptor, no swizzle: the leading byte offset is the
// step between core matrices along K (128 bytes, they are adjacent), the
// stride byte offset the step between groups of 8 rows (K/4 core matrices)
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

// a value the compiler cannot see through: keeps it from hoisting every
// k-step's descriptors out of the loop over tiles into registers
__device__ __forceinline__ uint64_t opaque(uint64_t v) {
    asm volatile("mov.b64 %0, %0;" : "+l"(v));
    return v;
}

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across the
// asynchronous products' issue and wait
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// d[64 x 64] (+)= a[64 x 8] . b[64 x 8]^T, TF32 operands in shared memory,
// fp32 accumulator in the warpgroup's registers
__device__ __forceinline__ void mma_64x64x8(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// The score tile is [kCols][kRows], a column's rows XOR-swizzled inside
// blocks of 32 by a bijection of the column's low five bits, so that the
// three ways it is read and written each hit 32 distinct banks: the
// accumulator fragment (8 rows x 4 column pairs a store), a thread a row at
// one column, and the stores' gather (a lane a pdf's column, one row).
__device__ __forceinline__ int score_at(int c, int r) {
    return c * kRows + (r ^ (((c & 6) << 2) | ((c >> 2) & 6) | (c & 1)));
}

struct Block {
    const float* x_hi;  // [kRows, K] canonical layout
    const float* x_lo;
    float* ring;        // [2 stages][hi, lo][kCols, K] canonical layout
    float* score;       // [kCols][kRows], see score_at
    float* carry_m;     // [2][kRows]: written by tile t at t & 1, read by t + 1
    float* carry_s;     // [2][kRows]
    uint64_t* full;     // [2]
    uint64_t* empty;    // [2]
};

struct Epilogue {
    const int4* __restrict__ segs;
    const int* __restrict__ seg_offsets;
    const int* __restrict__ work;
    const int* __restrict__ work_offsets;
    float* __restrict__ out;
    int n0, N, P;
};

// One warpgroup's three TF32 products of tile t (ring stage t & 1) for its 64
// rows, once the tile has arrived, committed as one group.  The k-steps are
// unrolled at compile time: a loop around wgmma makes ptxas serialise them.
template <int K>
__device__ __forceinline__ void issue_tile(const Block& b, int t, int wg, float (&acc)[32]) {
    constexpr uint32_t lbo = 128, sbo = K * 32;  // bytes
    const float* w = b.ring + (size_t)(t & 1) * 2 * kCols * K;
    const uint64_t a_hi = opaque(make_desc(b.x_hi + wg * 64 * K, lbo, sbo));
    const uint64_t a_lo = opaque(make_desc(b.x_lo + wg * 64 * K, lbo, sbo));
    const uint64_t w_hi = opaque(make_desc(w, lbo, sbo));
    const uint64_t w_lo = opaque(make_desc(w + kCols * K, lbo, sbo));
    mbar_wait(&b.full[t & 1], (t >> 1) & 1);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < K / 8; ++s) {
        const uint64_t o = 16u * s;  // 8 depths = two core matrices = 256 bytes
        mma_64x64x8(acc, a_lo + o, w_hi + o, s > 0);
        mma_64x64x8(acc, a_hi + o, w_lo + o, 1);
        mma_64x64x8(acc, a_hi + o, w_hi + o, 1);
    }
    wgmma_commit();
    fence_operand(acc);
}

// What one warp needs of tile t, loaded before the tile's products are
// waited for, so that the loads' latency hides behind them.  Two threads a
// row: warps 0-1 take the first half of the tile's work list, warps 2-3 the
// second (the host balances their columns); a lane holds entries `lane` and
// `lane + 32` of its half.  The stores: the tile's pdfs are consecutive, all
// but a last one that runs on into the next tile; lane q stores the pdfs q
// and q + 32 (a tile holds at most 64), each read at its first column.
struct TileDesc {
    int wa, wb;  // work entries: first column | end column << 8 | flags << 16
    int nw, nstore, ca, cb, p0;
};

__device__ __forceinline__ TileDesc load_desc(const Epilogue& e, int t, int wtid) {
    TileDesc d;
    const int lane = wtid & 31, half = wtid >> 6;
    const int w0 = e.work_offsets[2 * t + half];
    d.nw = e.work_offsets[2 * t + half + 1] - w0;
    d.wa = lane < d.nw ? __ldg(e.work + w0 + lane) : 0;
    d.wb = lane + 32 < d.nw ? __ldg(e.work + w0 + lane + 32) : 0;
    const int so = e.seg_offsets[t], se = e.seg_offsets[t + 1];
    d.nstore = se - so - ((__ldg(e.segs + se - 1).w & kCarryOut) ? 1 : 0);
    d.ca = lane < d.nstore ? __ldg(e.segs + so + lane).y : 0;
    d.cb = lane + 32 < d.nstore ? __ldg(e.segs + so + lane + 32).y : 0;
    d.p0 = __ldg(e.segs + so).x;
    return d;
}

// Tile t, whose products in `acc` are complete: release its ring stage, then
// the fused per-pdf logsumexp of the warpgroup's 64 rows and the stores.
__device__ __forceinline__ void epilogue(const Block& b, const Epilogue& e, const TileDesc& d,
                                         int t, int wg, int wtid, float (&acc)[32]) {
    fence_operand(acc);
    const int warp = wtid >> 5, lane = wtid & 31;
    __syncwarp();
    if (lane == 0) mbar_arrive(&b.empty[t & 1]);

    // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
    // lane l holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1)
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);
    named_sync(1 + wg);  // the previous tile's stores have read the score tile
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        b.score[score_at(c, r0)] = acc[4 * j];
        b.score[score_at(c + 1, r0)] = acc[4 * j + 1];
        b.score[score_at(c, r0 + 8)] = acc[4 * j + 2];
        b.score[score_at(c + 1, r0 + 8)] = acc[4 * j + 3];
    }
    named_sync(1 + wg);

    // The work list holds the pdfs that are not one Gaussian in this tile
    // alone (a pdf of one Gaussian is done: its score is its loglike).  Each
    // gets an exact logsumexp over its columns, written in place at its own
    // first column, or carried on.  A pdf of at most four columns that is not
    // carried is done in one step (the max of its columns, then the sum of
    // exp(score - max)), two such pdfs at a time for the latency; a longer or
    // a carried one four columns at a time into a running (max, sum).  A tile
    // may both end one carried pdf and begin another: the carry it reads and
    // the one it writes are kept apart.
    const int row = wg * 64 + (wtid & 63);
    const float* cm_in = b.carry_m + ((t + 1) & 1) * kRows;
    const float* cs_in = b.carry_s + ((t + 1) & 1) * kRows;
    float* cm_out = b.carry_m + (t & 1) * kRows;
    float* cs_out = b.carry_s + (t & 1) * kRows;
    auto entry = [&](int i) { return __shfl_sync(0xffffffff, i < 32 ? d.wa : d.wb, i & 31); };
    auto col = [&](int c, int c1) {
        return c < c1 ? b.score[score_at(c, row)] : -INFINITY;
    };
    for (int i = 0; i < d.nw; ++i) {
        const int w = entry(i);
        const int c0 = w & 0xff, c1 = (w >> 8) & 0xff, flags = w >> 16;
        if (!flags && c1 - c0 <= 4 && i + 1 < d.nw) {
            const int w2 = entry(i + 1);
            const int e0 = w2 & 0xff, e1 = (w2 >> 8) & 0xff;
            if (!(w2 >> 16) && e1 - e0 <= 4) {
                const float a0 = col(c0, c1), a1 = col(c0 + 1, c1), a2 = col(c0 + 2, c1),
                            a3 = col(c0 + 3, c1);
                const float b0 = col(e0, e1), b1 = col(e0 + 1, e1), b2 = col(e0 + 2, e1),
                            b3 = col(e0 + 3, e1);
                const float ma = fmaxf(fmaxf(a0, a1), fmaxf(a2, a3));
                const float mb = fmaxf(fmaxf(b0, b1), fmaxf(b2, b3));
                const float sa = (__expf(a0 - ma) + __expf(a1 - ma)) +
                                 (__expf(a2 - ma) + __expf(a3 - ma));
                const float sb = (__expf(b0 - mb) + __expf(b1 - mb)) +
                                 (__expf(b2 - mb) + __expf(b3 - mb));
                b.score[score_at(c0, row)] = ma + __logf(sa);
                b.score[score_at(e0, row)] = mb + __logf(sb);
                ++i;
                continue;
            }
        }
        float m = (flags & kCarryIn) ? cm_in[row] : -INFINITY;
        float s = (flags & kCarryIn) ? cs_in[row] : 0.f;
        for (int c = c0; c < c1; c += 4) {
            const float v0 = col(c, c1), v1 = col(c + 1, c1), v2 = col(c + 2, c1),
                        v3 = col(c + 3, c1);
            const float mn = fmaxf(m, fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)));
            s = s * __expf(m - mn) +
                ((__expf(v0 - mn) + __expf(v1 - mn)) + (__expf(v2 - mn) + __expf(v3 - mn)));
            m = mn;
        }
        if (flags & kCarryOut) {
            cm_out[row] = m;
            cs_out[row] = s;
        } else {
            b.score[score_at(c0, row)] = m + __logf(s);
        }
    }
    named_sync(1 + wg);

    // warp w stores the rows w, w + 4, ..: each store is one run of
    // consecutive pdfs of one frame
    const int rows = min(64, e.N - e.n0 - wg * 64);
    float* o = e.out + (size_t)(e.n0 + wg * 64 + warp) * e.P + d.p0 + lane;
#pragma unroll 4
    for (int f = warp; f < rows; f += 4, o += (size_t)4 * e.P) {
        const int r = wg * 64 + f;
        if (lane < d.nstore) o[0] = b.score[score_at(d.ca, r)];
        if (lane + 32 < d.nstore) o[32] = b.score[score_at(d.cb, r)];
    }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
gmm_loglikes_kernel(const float* __restrict__ feats, const float* __restrict__ tiles,
                    Epilogue e, int D, int T) {
    extern __shared__ __align__(128) float smem[];
    float* const x_hi = smem;
    float* const x_lo = smem + kRows * K;
    Block b;
    b.x_hi = x_hi;
    b.x_lo = x_lo;
    b.ring = x_lo + kRows * K;
    b.score = b.ring + 2 * 2 * kCols * K;
    b.carry_m = b.score + kCols * kRows;
    b.carry_s = b.carry_m + 2 * kRows;
    b.full = reinterpret_cast<uint64_t*>(b.carry_s + 2 * kRows);
    b.empty = b.full + 2;
    const int tid = threadIdx.x;
    e.n0 = blockIdx.x * kRows;
    if (tid == 0) {
        mbar_init(&b.full[0], 1);
        mbar_init(&b.full[1], 1);
        mbar_init(&b.empty[0], kConsumerWarps);
        mbar_init(&b.empty[1], kConsumerWarps);
        mbar_init_fence();
    }
    __syncthreads();

    // 0 and 1: the consumer warpgroups, 2: the producer warp.  Read through a
    // shuffle, so that the compiler knows it is the same for a whole warp.
    const int role = __shfl_sync(0xffffffff, tid / 128, 0);
    constexpr uint32_t tile_bytes = 2u * kCols * K * sizeof(float);
    if (role == 2) {  // the producer warp: one lane streams the tiles
        if (tid == kConsumerThreads) {
            for (int t = 0; t < T; ++t) {
                const int s = t & 1;
                if (t >= 2) mbar_wait(&b.empty[s], ((t >> 1) - 1) & 1);
                mbar_expect_tx(&b.full[s], tile_bytes);
                bulk_load(b.ring + (size_t)s * 2 * kCols * K,
                          tiles + (size_t)t * 2 * kCols * K, tile_bytes, &b.full[s]);
            }
        }
        return;
    }

    // stage this warpgroup's 64 frames as [x, x^2, 1, 0..] rows, split hi/lo
    const int wg = role, wtid = tid & 127;
    for (int i = wtid; i < 64 * K; i += 128) {
        const int r = i / K, k = i - r * K;
        const int row = wg * 64 + r;
        const int n = e.n0 + row;
        float v = 0.f;
        if (n < e.N) {
            if (k < D) {
                v = feats[(size_t)n * D + k];
            } else if (k < 2 * D) {
                const float x = feats[(size_t)n * D + k - D];
                v = x * x;
            } else if (k == 2 * D) {
                v = 1.f;
            }
        }
        const float hi = tf32_rna(v);
        const int at = core_index(row, k, K);
        x_hi[at] = hi;
        x_lo[at] = tf32_rna(v - hi);
    }
    // the generic-proxy stores must be visible to wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg);

    // tile t+1's products are in flight while tile t's epilogue runs; the
    // loop is unrolled by two so that each accumulator set keeps its registers
    float acc0[32], acc1[32];
    issue_tile<K>(b, 0, wg, acc0);
    int t = 0;
    for (; t + 2 < T; t += 2) {
        const TileDesc d0 = load_desc(e, t, wtid);
        issue_tile<K>(b, t + 1, wg, acc1);
        wgmma_wait<1>();
        epilogue(b, e, d0, t, wg, wtid, acc0);
        const TileDesc d1 = load_desc(e, t + 1, wtid);
        issue_tile<K>(b, t + 2, wg, acc0);
        wgmma_wait<1>();
        epilogue(b, e, d1, t + 1, wg, wtid, acc1);
    }
    const TileDesc d0 = load_desc(e, t, wtid);
    if (t + 1 < T) {
        issue_tile<K>(b, t + 1, wg, acc1);
        wgmma_wait<1>();
        epilogue(b, e, d0, t, wg, wtid, acc0);
        const TileDesc d1 = load_desc(e, t + 1, wtid);
        wgmma_wait<0>();
        epilogue(b, e, d1, t + 1, wg, wtid, acc1);
    } else {
        wgmma_wait<0>();
        epilogue(b, e, d0, t, wg, wtid, acc0);
    }
}

size_t smem_bytes(int K) {
    return sizeof(float) * ((size_t)2 * kRows * K + (size_t)2 * 2 * kCols * K +
                            (size_t)kCols * kRows + 4 * kRows) +
           4 * sizeof(uint64_t);
}

template <int K>
int launch(const float* feats, const float* tiles, const Epilogue& e, int D, int T,
           cudaStream_t stream) {
    const size_t smem = smem_bytes(K);
    cudaError_t err = cudaFuncSetAttribute(
        gmm_loglikes_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gmm_loglikes_kernel<K><<<(e.N + kRows - 1) / kRows, kThreads, smem, stream>>>(
        feats, tiles, e, D, T);
    return (int)cudaGetLastError();
}

}  // namespace

// feats [N, D] f32; tiles [T, 2, kCols/8, K/4, 8, 4] f32 (hi, lo); segs [S, 4]
// i32 (pdf, first column, end column, flags), tile t owning
// segs[seg_offsets[t] .. seg_offsets[t+1]); work [W] i32 (first column |
// end column << 8 | flags << 16): the segments that need a logsumexp, tile t's two
// halves work[work_offsets[2t] .. work_offsets[2t+1]) and
// work[work_offsets[2t+1] .. work_offsets[2t+2]); out [N, P] f32; all
// contiguous device pointers; K a multiple of 8 up to 96.  Launches on
// `stream`, does not synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int okt_gmm_loglikes(const void* feats, const void* tiles, const void* segs,
                                const void* seg_offsets, const void* work,
                                const void* work_offsets, void* out, int N, int D, int K,
                                int T, int P, void* stream) {
    if (N <= 0 || P <= 0) return 0;
    if (D <= 0 || T <= 0 || K % 8 != 0 || K < 2 * D + 1 || K > 96 ||
        smem_bytes(K) > (size_t)kMaxDynamicSmem)
        return (int)cudaErrorInvalidValue;
    const Epilogue e{(const int4*)segs, (const int*)seg_offsets, (const int*)work,
                     (const int*)work_offsets, (float*)out, 0, N, P};
    const float* f = (const float*)feats;
    const float* w = (const float*)tiles;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (K / 8) {
        case 1: return launch<8>(f, w, e, D, T, st);
        case 2: return launch<16>(f, w, e, D, T, st);
        case 3: return launch<24>(f, w, e, D, T, st);
        case 4: return launch<32>(f, w, e, D, T, st);
        case 5: return launch<40>(f, w, e, D, T, st);
        case 6: return launch<48>(f, w, e, D, T, st);
        case 7: return launch<56>(f, w, e, D, T, st);
        case 8: return launch<64>(f, w, e, D, T, st);
        case 9: return launch<72>(f, w, e, D, T, st);
        case 10: return launch<80>(f, w, e, D, T, st);
        case 11: return launch<88>(f, w, e, D, T, st);
        default: return launch<96>(f, w, e, D, T, st);
    }
}
