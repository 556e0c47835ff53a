// The two probe kernels: the tensor-core rate probe (P1) and the
// tensor-core / CUDA-core overlap probe (P2).
//
// P1 replaces bench.py `_measure_mm_tf` (its Pallas kernel `kern`): `steps`
// steps, each four bf16 products x[j] @ w ([rows, depth] @ [depth, width],
// f32 accumulate) into slab j of one f32 scratch [rows, 4 width]; the output
// is scratch[0, 0] + scratch[rows-1, 4 width - 1].
// P2 replaces tools/overlap_probe.py `make` (its Pallas kernel `kern`):
// `steps` steps of one product x @ w into a scratch [rows, width] (`mxu`),
// of an independent f32 chain of `rounds` rounds over a slab (`vpu`), or
// of both in that order (`both`); the output is scratch[0, 0] + slab[0]
// (the scratch reads 0 where no product ran).  The chain rounds every
// operation on its own, as its plain version does, so the two slabs agree
// bit for bit.
//
// Bound on the card: tensor-core operations (P1: 16 x 4 x 2 rows depth
// width; P2 `both`: the products, with the chain's f32 operations on the
// CUDA cores beside them).
//
// P1's design, wgmma + TMA: the four products are one [4 rows, depth] x
// [depth, width] product cut into 128 x 256 output tiles, and a
// persistent grid of one block an SM walks the (step, tile) units, so
// the last wave is not a handful of SMs.  Two consumer warpgroups each
// run wgmma m64n256k16 (bf16, f32 accumulators in registers; A = x
// K-major, B = w MN-major through the descriptor's transpose bit), one
// producer thread keeps TMA loads of 64-deep A and B tiles (128-byte
// swizzled) in flight through the 4-stage mbarrier ring of tma_ring.cuh,
// which the product kernels K3, K4b, K4 and K6 share.  The operands
// (5.3 MB at the main shape) stay in L2, so reloading a tile for each
// step is an L2 read.  A unit's first product
// overwrites its accumulators (scale-d 0) as each TPU step overwrites its
// scratch, every wgmma is volatile asm so none is removed, and the last
// step's tiles go to the scratch in device memory.
//
// P2 keeps the weight-stationary WMMA design the TPU probes have: a block
// owns a 128 x 64 tile of the product, stages its A rows (128 x depth)
// and B columns (depth x 64) in shared memory once, and every step runs
// the whole contraction from there (8 warps of 32 x 32, WMMA m16n16k16
// bf16, f32 accumulate).  A step's accumulators start from the previous
// step's times 0 (no compiler may fold a float product by 0), so every
// step's products feed the next and none is dead code.  Its three kinds
// share one launch shape (grid, shared memory, staging), as the TPU
// probe's kernels share their grid machinery; its chain elements are
// spread over every thread of the grid and held in registers across the
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tma_ring.cuh"

using namespace nvcuda;

namespace {

// P1 tiles: 128 x 256 outputs a unit, in the ring's 64-deep stages.
using ring::kBk;
using ring::kBm;
constexpr int kBn = 256;
constexpr uint32_t kStageA = kBm * kBk * 2;   // 16 KB: 128 rows x 128 B
constexpr uint32_t kStageB = kBn / 64 * ring::kBoxB;  // 32 KB: 4 x 8 KB

constexpr int kTm = 128;           // product rows per block
constexpr int kTn = 64;            // product columns per block
constexpr int kThreads = 256;      // 8 warps: 4 (32 rows) x 2 (32 cols)
constexpr int kLdb = kTn + 8;      // bf16 B stride, multiple of 8
constexpr int kMaxPer = 16;        // P2 chain elements per thread, at most

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

size_t smem_bytes(int depth) {
    return (size_t)kTm * (depth + 8) * 2 + (size_t)depth * kLdb * 2;
}

// Stage rows m0.. of a [rows, depth] and columns n0.. of w [depth, width].
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ a,
                                      const __nv_bfloat16* __restrict__ w,
                                      __nv_bfloat16* as, __nv_bfloat16* bs,
                                      int m0, int n0, int depth, int width) {
    const int lda = depth + 8;
    const int a8 = depth / 8;
    for (int e = threadIdx.x; e < kTm * a8; e += kThreads) {
        const int r = e / a8, c8 = e % a8;
        *reinterpret_cast<uint4*>(as + r * lda + c8 * 8) =
            *reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * depth +
                                            c8 * 8);
    }
    for (int e = threadIdx.x; e < depth * (kTn / 8); e += kThreads) {
        const int r = e / (kTn / 8), c8 = e % (kTn / 8);
        *reinterpret_cast<uint4*>(bs + r * kLdb + c8 * 8) =
            *reinterpret_cast<const uint4*>(w + (long long)r * width + n0 +
                                            c8 * 8);
    }
}

// One step: acc = 0 * acc + A B over the whole depth, this warp's 32 x 32.
__device__ __forceinline__ void product_step(Acc (&acc)[2][2],
                                             const __nv_bfloat16* as,
                                             const __nv_bfloat16* bs,
                                             int depth) {
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 1, wc = warp & 1;
    const int lda = depth + 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int t = 0; t < acc[i][j].num_elements; ++t)
                acc[i][j].x[t] = __fmul_rn(acc[i][j].x[t], 0.0f);
    for (int kk = 0; kk < depth; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(af[i], as + (wr * 32 + i * 16) * lda + kk,
                                   lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bf[j], bs + kk * kLdb + wc * 32 + j * 16,
                                   kLdb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
}

// Write this warp's 32 x 32 of the block tile at (m0, n0) of `out` (ld).
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], float* out,
                                           long long ld, int m0, int n0) {
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(
                out + (m0 + wr * 32 + i * 16) * ld + n0 + wc * 32 + j * 16,
                acc[i][j], (unsigned)ld, wmma::mem_row_major);
}

// P1: the (step, tile) units of blockIdx.x, blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(ring::kThreads, 1)
rate_probe_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  float* __restrict__ scratch, float* __restrict__ out,
                  int rows, int depth, int width, int steps) {
    extern __shared__ unsigned char smem_raw[];
    const ring::Ring rg = ring::make(smem_raw, kStageA + kStageB);

    const int mtiles = 4 * rows / kBm, ntiles = width / kBn;
    const int tiles = mtiles * ntiles;
    const long long units = (long long)tiles * steps;
    const int kblocks = depth / kBk;
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            hopper::tma_prefetch_map(&map_x);
            hopper::tma_prefetch_map(&map_w);
            ring::produce(rg, units, 1, kblocks,
                          [&](long long u, int, int kb, unsigned char* st,
                              uint64_t* bar) {
                const int tile = (int)(u % tiles);
                const int mt = tile % mtiles, nt = tile / mtiles;
                hopper::tma_load_2d(st, &map_x, bar, kb * kBk, mt * kBm);
#pragma unroll
                for (int c = 0; c < kBn / 64; ++c)
                    hopper::tma_load_2d(st + kStageA + c * ring::kBoxB,
                                        &map_w, bar, nt * kBn + c * 64,
                                        kb * kBk);
            });
        }
        return;
    }

    // Consumer warpgroup wg: rows wg * 64 .. + 64 of every unit's tile.
    hopper::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool elected = threadIdx.x % 128 == 0;
    float d[128];
    int it = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = (int)(u % tiles);
        const int mt = tile % mtiles, nt = tile / mtiles;
        ring::consume(rg, it, kblocks, elected,
                      [&](const unsigned char* st, int kb) {
#pragma unroll
            for (int kk = 0; kk < kBk / 16; ++kk) {
                // A: K-major, 8-row groups 1024 B apart, 32 B a k16 slice.
                // B: MN-major, 64-column atoms 8 KB apart (leading), 8-row
                // k groups 1024 B apart, 2 KB a k16.
                const uint64_t da =
                    hopper::desc_sw128(st + wg * 8192 + kk * 32, 16, 1024);
                const uint64_t db =
                    hopper::desc_sw128(st + kStageA + kk * 2048, 8192, 1024);
                hopper::wgmma_m64n256k16_bf16_bt(d, da, db, (kb | kk) != 0);
            }
        });
        if (u / tiles != steps - 1) continue;
        // The last step's tile: row_t of the stacked [4 rows] product is
        // row r of product (slab) j.
        const int row_t = mt * kBm + wg * 64 + warp * 16 + lane / 4;
        const int j = row_t / rows, r = row_t % rows;
        const long long ld = 4LL * width;
        float* o = scratch + (long long)r * ld + (long long)j * width +
                   nt * kBn + 2 * (lane % 4);
#pragma unroll
        for (int jn = 0; jn < kBn / 8; ++jn)
#pragma unroll
            for (int i = 0; i < 2; ++i)
                *reinterpret_cast<float2*>(o + i * 8 * ld + 8 * jn) =
                    make_float2(d[4 * jn + 2 * i], d[4 * jn + 2 * i + 1]);
        // Two threads each add one term to the zeroed output; a sum of two
        // terms onto 0 is the same in either order.
        if (row_t == 0 && nt == 0 && lane % 4 == 0) atomicAdd(out, d[0]);
        if (row_t + 8 == 4 * rows - 1 && nt == ntiles - 1 && lane % 4 == 3)
            atomicAdd(out, d[127]);
    }
}

__device__ __forceinline__ float maxp(float a, float b) {
    // torch.maximum / jnp.maximum: NaN if either operand is NaN.
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One round of tools/overlap_probe.py `vpu_chain`, rounded op by op.
__device__ __forceinline__ float chain_round(float a) {
    const float b = __fadd_rn(__fmul_rn(a, 1.0001f), 0.1f);
    const float m = __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
    const float d = __fsub_rn(b, m);
    const float g = __fsqrt_rn(__fadd_rn(
        __fmul_rn(__fmul_rn(maxp(__fadd_rn(a, m), 0.1f), d), d), 1.0f));
    return __fadd_rn(__fmul_rn(0.25f, __fadd_rn(m, g)),
                     __fmul_rn(0.5f, maxp(m, g)));
}

template <bool kMxu, bool kVpu>
__global__ void __launch_bounds__(kThreads)
overlap_probe_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ scratch,
                     const float* __restrict__ v0, float* __restrict__ vs,
                     float* __restrict__ out, int depth, int width, int slab,
                     int steps, int rounds) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* bs = as + kTm * (depth + 8);
    const int m0 = blockIdx.x * kTm, n0 = blockIdx.y * kTn;
    // Every kind stages the operands: the three share their grid, shared
    // memory and staging, as the TPU probe's three kernels do.
    stage(x, w, as, bs, m0, n0, depth, width);
    __syncthreads();
    // This thread's chain elements: e0 + i * stride.
    const int stride = gridDim.x * gridDim.y * kThreads;
    const int e0 = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads +
                   threadIdx.x;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
        const int e = e0 + i * stride;
        v[i] = e < slab ? v0[e] : 0.0f;
    }
    Acc acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);
    for (int t = 0; t < steps; ++t) {
        if (kMxu) product_step(acc, as, bs, depth);
        if (kVpu) {
#pragma unroll
            for (int i = 0; i < kMaxPer; ++i)
                if (e0 + i * stride < slab)
                    for (int r = 0; r < rounds; ++r) v[i] = chain_round(v[i]);
        }
    }
    if (kMxu) store_tile(acc, scratch, width, m0, n0);
    if (kVpu) {
#pragma unroll
        for (int i = 0; i < kMaxPer; ++i) {
            const int e = e0 + i * stride;
            if (e < slab) vs[e] = v[i];
        }
    }
    __syncthreads();
    if (e0 == 0) {                 // block (0, 0) owns scratch[0, 0] too
        const float a = kMxu ? scratch[0] : 0.0f;
        *out = __fadd_rn(a, kVpu ? v[0] : v0[0]);
    }
}

template <bool kMxu, bool kVpu>
int launch_overlap(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   float* scratch, const float* v0, float* vs, float* out,
                   int rows, int depth, int width, int slab, int steps,
                   int rounds, cudaStream_t stream) {
    const size_t smem = smem_bytes(depth);
    cudaError_t err = cudaFuncSetAttribute(
        overlap_probe_kernel<kMxu, kVpu>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rows / kTm, width / kTn);
    overlap_probe_kernel<kMxu, kVpu><<<grid, kThreads, smem, stream>>>(
        x, w, scratch, v0, vs, out, depth, width, slab, steps, rounds);
    return (int)cudaGetLastError();
}

bool shape_ok(int rows, int depth, int width) {
    return rows > 0 && rows % kTm == 0 && width > 0 && width % kTn == 0 &&
           depth > 0 && depth % 16 == 0 && smem_bytes(depth) <= 232448;
}

}  // namespace

extern "C" int grl_rate_probe(const void* x, const void* w, float* scratch,
                              float* out, int rows, int depth, int width,
                              int steps, void* stream) {
    if (rows <= 0 || rows % kBm || width <= 0 || width % kBn || depth <= 0 ||
        depth % kBk || steps <= 0)
        return cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    int err = hopper::make_map_bf16(&map_x, x, 4ULL * rows, depth, kBm, kBk);
    if (err) return err;
    err = hopper::make_map_bf16(&map_w, w, depth, width, kBk, 64);
    if (err) return err;
    const size_t smem = ring::smem_bytes(kStageA + kStageB);
    err = (int)cudaFuncSetAttribute(
        rate_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    int sms = 0;
    err = ring::sm_count(sms);
    if (err) return err;
    const long long units =
        (long long)(4 * rows / kBm) * (width / kBn) * steps;
    const int grid = (int)(units < sms ? units : sms);
    rate_probe_kernel<<<grid, ring::kThreads, smem, (cudaStream_t)stream>>>(
        map_x, map_w, scratch, out, rows, depth, width, steps);
    return (int)cudaGetLastError();
}

// kind: 1 = products only (mxu), 2 = chain only (vpu), 3 = both.
extern "C" int grl_overlap_probe(const void* x, const void* w,
                                 float* scratch, const float* v0, float* vs,
                                 float* out, int rows, int depth, int width,
                                 int slab, int steps, int rounds, int kind,
                                 void* stream) {
    if (!shape_ok(rows, depth, width) || steps <= 0 || rounds < 0 ||
        slab <= 0 || slab > kMaxPer * (rows / kTm) * (width / kTn) * kThreads)
        return cudaErrorInvalidValue;
    const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    const auto* wb = reinterpret_cast<const __nv_bfloat16*>(w);
    const auto s = (cudaStream_t)stream;
    switch (kind) {
        case 1:
            return launch_overlap<true, false>(xb, wb, scratch, v0, vs, out,
                                               rows, depth, width, slab,
                                               steps, rounds, s);
        case 2:
            return launch_overlap<false, true>(xb, wb, scratch, v0, vs, out,
                                               rows, depth, width, slab,
                                               steps, rounds, s);
        case 3:
            return launch_overlap<true, true>(xb, wb, scratch, v0, vs, out,
                                              rows, depth, width, slab,
                                              steps, rounds, s);
        default:
            return cudaErrorInvalidValue;
    }
}
