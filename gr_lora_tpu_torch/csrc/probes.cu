// The two probe kernels: the tensor-core rate probe (P1) and the
// tensor-core / CUDA-core overlap probe (P2).
//
// P1 replaces bench.py `_measure_mm_tf` (its Pallas kernel `kern`): `steps`
// steps, each four bf16 products x[j] @ w ([rows, depth] @ [depth, width],
// f32 accumulate) into slab j of one f32 scratch [rows, 4 width]; the output
// is scratch[0, 0] + scratch[rows-1, 4 width - 1].
// P2 replaces tools/overlap_probe.py `make` (its Pallas kernel `kern`):
// `steps` steps of one product x @ w into a scratch [rows, width] (`mxu`),
// steps x rounds rounds of an independent f32 chain over a slab (`vpu`),
// or both (`both`); the output is scratch[0, 0] + slab[0] (the scratch
// reads 0 where no product ran).  The chain rounds every operation on its
// own, as its plain version does, so the two slabs agree bit for bit.
//
// Bound on the card: tensor-core operations (P1: 16 x 4 x 2 rows depth
// width; P2: 64 x 2 rows depth width, 0.074 ms at the main shape), with
// P2's chain beside them on the CUDA cores (18 f32 operations a round and
// element, 0.011 ms at 67 TFLOP/s).
//
// Both run the same products: a [slabs rows, depth] x [depth, width]
// product (P1 stacks its four x[j], P2 takes x itself) cut into 128 x 256
// output tiles, and a persistent grid of one block an SM walks the (step,
// tile) units, so the last wave is not a handful of SMs.  Two consumer
// warpgroups each run wgmma m64n256k16 (bf16, f32 accumulators in
// registers; A = x K-major, B = w MN-major through the descriptor's
// transpose bit), one producer thread keeps TMA loads of 64-deep A and B
// tiles (128-byte swizzled) in flight through the 4-stage mbarrier ring of
// tma_ring.cuh, which the product kernels K3, K4b, K4 and K6 share.  The
// operands (5.3 MB at the main shape) stay in L2, so reloading a tile for
// each step is an L2 read.  A unit's first product overwrites its
// accumulators (scale-d 0) as each TPU step overwrites its scratch, every
// wgmma is volatile asm so none is removed, and the last step's tiles go
// to the scratch in device memory.
//
// P2's chain runs while its products retire, in the TPU probe's order (the
// dot issued, then the chain): the consumer threads hold the slab in
// registers, at most kChainPer elements a thread (element block * 256 +
// thread + i * 256 grid), and run its rounds between each stage's commit
// and the wait for the group before it, about one round a stage: after s
// of the smax stages that the busiest block takes, total * s / smax
// rounds have run, and a block with fewer stages runs the rest after its
// last.  A round runs over all of a thread's elements before the next.
// Where the units give fewer blocks than the slab needs, the grid grows
// and the blocks past the units run the chain only.  The three kinds
// share the grid, the threads, the element placement and the pacing;
// `vpu` issues no TMA load and no wgmma, so mxu + vpu is the serial sum
// that the overlap efficiency is measured against.
//
// What holds the chain back is latency, not operations: each correctly
// rounded square root is a branch region of its own (its special-case
// path is a call), so a thread's ten chains run one after another.  After
// some 16 of the 128 rounds the chain is inf and then NaN everywhere, as
// the TPU probe's is, and there every square root took that path: sqrt_rn
// keeps +inf, NaN and negative inputs off it (the same results), which
// took `vpu` from 0.27 to 0.20 ms at the main shape on an NVIDIA H100
// 80GB HBM3 at 700 W.  PERF.md records the placements measured and not
// kept (the chain in the producer warpgroup's idle warps, each operation
// of a round over all elements before the next, the chain between the
// wgmma issues) with their times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tma_ring.cuh"

namespace {

// 128 x 256 outputs a unit, in the ring's 64-deep stages.
using ring::kBk;
using ring::kBm;
constexpr int kBn = 256;
constexpr uint32_t kStageA = kBm * kBk * 2;   // 16 KB: 128 rows x 128 B
constexpr uint32_t kStageB = kBn / 64 * ring::kBoxB;  // 32 KB: 4 x 8 KB
constexpr size_t kSmem = ring::smem_bytes(kStageA + kStageB);
// ops/probes.py mirrors these two (CHAIN_THREADS, CHAIN_PER) and the grid
// and pacing below (overlap_grid, chain_split): change them together.
constexpr int kConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kChainPer = 10;     // P2 chain elements a consumer thread

// The (step, tile) units of a probe: `slabs` products x[j] @ w stacked as
// one [slabs rows, depth] A, cut into 128 x 256 tiles, `steps` times; unit
// u is tile u % tiles of step u / tiles.
struct Walk {
    int rows, width, slabs, steps, mtiles, ntiles, tiles, kblocks;
    long long units;
};

__host__ __device__ __forceinline__ Walk make_walk(int rows, int depth,
                                                   int width, int slabs,
                                                   int steps) {
    Walk w;
    w.rows = rows;
    w.width = width;
    w.slabs = slabs;
    w.steps = steps;
    w.mtiles = slabs * rows / kBm;
    w.ntiles = width / kBn;
    w.tiles = w.mtiles * w.ntiles;
    w.kblocks = depth / kBk;
    w.units = (long long)w.tiles * steps;
    return w;
}

// The producer thread: the A box (x, K-major) and four B boxes (w,
// MN-major) of every stage of this block's units.
__device__ __forceinline__ void load_units(const ring::Ring& rg,
                                           const Walk& wk,
                                           const CUtensorMap* map_x,
                                           const CUtensorMap* map_w) {
    hopper::tma_prefetch_map(map_x);
    hopper::tma_prefetch_map(map_w);
    ring::produce(rg, wk.units, 1, wk.kblocks,
                  [&](long long u, int, int kb, unsigned char* st,
                      uint64_t* bar) {
        const int tile = (int)(u % wk.tiles);
        const int mt = tile % wk.mtiles, nt = tile / wk.mtiles;
        hopper::tma_load_2d(st, map_x, bar, kb * kBk, mt * kBm);
#pragma unroll
        for (int c = 0; c < kBn / 64; ++c)
            hopper::tma_load_2d(st + kStageA + c * ring::kBoxB, map_w, bar,
                                nt * kBn + c * 64, kb * kBk);
    });
}

// A consumer warpgroup: the products of this block's units, beside(kb)
// running while each stage's wgmma group is in flight.  The last step's
// tiles go to the f32 scratch [rows, slabs width] (row t of the stacked
// product is row t % rows of slab t / rows); scratch[0, 0], and where
// `corners` is 2 also its last entry, is added to *out.
template <class Beside>
__device__ __forceinline__ void product_units(const ring::Ring& rg,
                                              const Walk& wk,
                                              float* __restrict__ scratch,
                                              float* __restrict__ out,
                                              int corners, Beside&& beside) {
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool elected = threadIdx.x % 128 == 0;
    float d[128];
    int it = 0;
    for (long long u = blockIdx.x; u < wk.units; u += gridDim.x) {
        const int tile = (int)(u % wk.tiles);
        const int mt = tile % wk.mtiles, nt = tile / wk.mtiles;
        ring::consume(rg, it, wk.kblocks, elected,
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
        }, beside);
        if (u / wk.tiles != wk.steps - 1) continue;
        const int row_t = mt * kBm + wg * 64 + warp * 16 + lane / 4;
        const int j = row_t / wk.rows, r = row_t % wk.rows;
        const long long ld = (long long)wk.slabs * wk.width;
        float* o = scratch + (long long)r * ld + (long long)j * wk.width +
                   nt * kBn + 2 * (lane % 4);
#pragma unroll
        for (int jn = 0; jn < kBn / 8; ++jn)
#pragma unroll
            for (int i = 0; i < 2; ++i)
                *reinterpret_cast<float2*>(o + i * 8 * ld + 8 * jn) =
                    make_float2(d[4 * jn + 2 * i], d[4 * jn + 2 * i + 1]);
        // Each term is added to the zeroed output by one thread; a sum of
        // two terms onto 0 is the same in either order.
        if (row_t == 0 && nt == 0 && lane % 4 == 0) atomicAdd(out, d[0]);
        if (corners == 2 && row_t + 8 == wk.slabs * wk.rows - 1 &&
            nt == wk.ntiles - 1 && lane % 4 == 3)
            atomicAdd(out, d[127]);
    }
}

// P1: the (step, tile) units of blockIdx.x, blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(ring::kThreads, 1)
rate_probe_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  float* __restrict__ scratch, float* __restrict__ out,
                  int rows, int depth, int width, int steps) {
    extern __shared__ unsigned char smem_raw[];
    const ring::Ring rg = ring::make(smem_raw, kStageA + kStageB);
    const Walk wk = make_walk(rows, depth, width, 4, steps);
    if (threadIdx.x >= kConsumers) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (threadIdx.x == kConsumers) load_units(rg, wk, &map_x, &map_w);
        return;
    }
    hopper::setmaxnreg_inc<232>();
    product_units(rg, wk, scratch, out, 2, ring::Idle());
}

__device__ __forceinline__ float maxp(float a, float b) {
    // torch.maximum / jnp.maximum: NaN if either operand is NaN.
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// __fsqrt_rn with +inf, NaN and negative inputs kept off its special-case
// path: the same results (inf for +inf, NaN otherwise), and every finite
// input >= 0 still takes __fsqrt_rn itself.
__device__ __forceinline__ float sqrt_rn(float x) {
    const bool plain = x >= 0.0f && x < INFINITY;
    const float r = __fsqrt_rn(plain ? x : 1.0f);
    return plain ? r
                 : (x == INFINITY ? INFINITY : __int_as_float(0x7fffffff));
}

// One round of tools/overlap_probe.py `vpu_chain`, rounded op by op.
__device__ __forceinline__ float chain_round(float a) {
    const float b = __fadd_rn(__fmul_rn(a, 1.0001f), 0.1f);
    const float m = sqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
    const float d = __fsub_rn(b, m);
    const float g = sqrt_rn(__fadd_rn(
        __fmul_rn(__fmul_rn(maxp(__fadd_rn(a, m), 0.1f), d), d), 1.0f));
    return __fadd_rn(__fmul_rn(0.25f, __fadd_rn(m, g)),
                     __fmul_rn(0.5f, maxp(m, g)));
}

// One round over all of a thread's elements.
__device__ __forceinline__ void chain_all(float (&v)[kChainPer]) {
#pragma unroll
    for (int i = 0; i < kChainPer; ++i) v[i] = chain_round(v[i]);
}

template <bool kMxu, bool kVpu>
__global__ void __launch_bounds__(ring::kThreads, 1)
overlap_probe_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     float* __restrict__ scratch,
                     const float* __restrict__ v0, float* __restrict__ vs,
                     float* __restrict__ out, int rows, int depth, int width,
                     int slab, int steps, int rounds) {
    extern __shared__ unsigned char smem_raw[];
    const ring::Ring rg = ring::make(smem_raw, kStageA + kStageB);
    const Walk wk = make_walk(rows, depth, width, 1, steps);
    if (threadIdx.x >= kConsumers) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (kMxu && threadIdx.x == kConsumers)
            load_units(rg, wk, &map_x, &map_w);
        return;
    }
    hopper::setmaxnreg_inc<232>();
    if constexpr (!kVpu) {
        product_units(rg, wk, scratch, out, 1, ring::Idle());
        if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(out, v0[0]);
    } else {
        // This thread's chain elements: e0 + i * stride (those past the
        // slab run on 1 and are not stored).
        const int stride = gridDim.x * kConsumers;
        const int e0 = blockIdx.x * kConsumers + threadIdx.x;
        float v[kChainPer];
#pragma unroll
        for (int i = 0; i < kChainPer; ++i) {
            const int e = e0 + i * stride;
            v[i] = e < slab ? v0[e] : 1.0f;
        }
        // Pacing: after s of the smax stages of the busiest block, total *
        // s / smax rounds have run (`acc` carries total * s mod smax).
        const int total = steps * rounds;
        const int smax =
            (int)((wk.units + gridDim.x - 1) / gridDim.x) * wk.kblocks;
        int acc = 0, done = 0;
        auto pace = [&](int) {
            for (acc += total; acc >= smax; acc -= smax, ++done) chain_all(v);
        };
        if constexpr (kMxu) {
            product_units(rg, wk, scratch, out, 1, pace);
        } else {
            // The same stages, without their products.
            const long long mine =
                blockIdx.x < wk.units
                    ? (wk.units - 1 - blockIdx.x) / gridDim.x + 1
                    : 0;
            for (long long s = 0; s < mine * wk.kblocks; ++s) pace(0);
        }
        for (; done < total; ++done) chain_all(v);
#pragma unroll
        for (int i = 0; i < kChainPer; ++i) {
            const int e = e0 + i * stride;
            if (e < slab) vs[e] = v[i];
        }
        if (e0 == 0) atomicAdd(out, v[0]);
    }
}

bool tiles_ok(int rows, int depth, int width) {
    return rows > 0 && rows % kBm == 0 && width > 0 && width % kBn == 0 &&
           depth > 0 && depth % kBk == 0;
}

// Host: the tensor maps of x [a_rows, depth] and w [depth, width].
int make_maps(CUtensorMap* map_x, CUtensorMap* map_w, const void* x,
              const void* w, long long a_rows, int depth, int width) {
    const int err = hopper::make_map_bf16(map_x, x, a_rows, depth, kBm, kBk);
    return err ? err : hopper::make_map_bf16(map_w, w, depth, width, kBk, 64);
}

template <class Kernel>
int allow_smem(Kernel kernel) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
}

template <bool kMxu, bool kVpu>
int launch_overlap(const CUtensorMap& map_x, const CUtensorMap& map_w,
                   float* scratch, const float* v0, float* vs, float* out,
                   int rows, int depth, int width, int slab, int steps,
                   int rounds, int grid, cudaStream_t stream) {
    auto* kernel = overlap_probe_kernel<kMxu, kVpu>;
    const int err = allow_smem(kernel);
    if (err) return err;
    kernel<<<grid, ring::kThreads, kSmem, stream>>>(
        map_x, map_w, scratch, v0, vs, out, rows, depth, width, slab, steps,
        rounds);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grl_rate_probe(const void* x, const void* w, float* scratch,
                              float* out, int rows, int depth, int width,
                              int steps, void* stream) {
    if (!tiles_ok(rows, depth, width) || steps <= 0)
        return cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    int err = make_maps(&map_x, &map_w, x, w, 4LL * rows, depth, width);
    if (err) return err;
    err = allow_smem(rate_probe_kernel);
    if (err) return err;
    int sms = 0;
    err = ring::sm_count(sms);
    if (err) return err;
    const long long units = make_walk(rows, depth, width, 4, steps).units;
    const int grid = (int)(units < sms ? units : sms);
    rate_probe_kernel<<<grid, ring::kThreads, kSmem, (cudaStream_t)stream>>>(
        map_x, map_w, scratch, out, rows, depth, width, steps);
    return (int)cudaGetLastError();
}

// kind: 1 = products only (mxu), 2 = chain only (vpu), 3 = both.
extern "C" int grl_overlap_probe(const void* x, const void* w,
                                 float* scratch, const float* v0, float* vs,
                                 float* out, int rows, int depth, int width,
                                 int slab, int steps, int rounds, int kind,
                                 void* stream) {
    if (!tiles_ok(rows, depth, width) || steps <= 0 || rounds < 0 ||
        slab <= 0 || kind < 1 || kind > 3)
        return cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    int err = make_maps(&map_x, &map_w, x, w, rows, depth, width);
    if (err) return err;
    int sms = 0;
    err = ring::sm_count(sms);
    if (err) return err;
    // One block an SM for the units, more where the slab needs them.
    const long long units = make_walk(rows, depth, width, 1, steps).units;
    const long long chain_blocks =
        (slab + kConsumers * kChainPer - 1) / (kConsumers * kChainPer);
    long long grid = units < sms ? units : sms;
    if (grid < chain_blocks) grid = chain_blocks;
    const auto s = (cudaStream_t)stream;
    if (kind == 1)
        return launch_overlap<true, false>(map_x, map_w, scratch, v0, vs, out,
                                           rows, depth, width, slab, steps,
                                           rounds, (int)grid, s);
    if (kind == 2)
        return launch_overlap<false, true>(map_x, map_w, scratch, v0, vs, out,
                                           rows, depth, width, slab, steps,
                                           rounds, (int)grid, s);
    return launch_overlap<true, true>(map_x, map_w, scratch, v0, vs, out,
                                      rows, depth, width, slab, steps, rounds,
                                      (int)grid, s);
}
