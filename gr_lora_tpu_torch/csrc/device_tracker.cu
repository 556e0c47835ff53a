// The on-device Pyramid tracker's walk over a [C, H, M] peak lattice block.
//
// Replaces the nested lax.scans of make_device_tracker
// (gr_lora_tpu/models/device_tracker.py:85-531): hops (:527), the peaks of
// a hop (:405), the packet entries of the retired tracks (:447-486) and the
// expiry's assembly (:488-513).  Not a Pallas kernel: it stands where a
// lax.scan stood, and its plain twin is ops/device_tracker.TrackerWalk.
//
// What bounds it: the chain.  A channel's walk is serial: a hop's peaks in
// bin order, each a search of the track pool whose result the next peak
// reads (a track one peak creates, the next may match); each retired track
// a search of the packet pool.  Channels are independent: one block a
// channel, every channel at once.  The bytes (the lattice once, the state
// read and written once) take about a microsecond over 3.35 TB/s, so the
// time is the latency of the busiest channel's chain.
//
// The chain bound, the least time that chain could take: P x L_peak +
// H x L_tail cycles at the card's top SM clock (nvidia-smi
// --query-gpu=clocks.max.sm: 1980 MHz on the H100 SXM), P the valid peaks
// of the busiest channel, H the block's hops.  L_peak, one peak's critical
// path: 6 dependent integer steps in registers (the offset to a slot's
// bin, its magnitude, the tolerance test; the first set bit of the vote,
// the owner's test, its update) and one warp vote, the cheapest warp-wide
// search; L_tail, a hop's where nothing retires or expires: 2 integer
// steps and one vote.  chip_smoke.py (phase 11a) measures the latencies
// on the card (on the H100 SXM: a dependent integer step 4.11 cycles, a
// vote 22.77, redux.sync 42.28, a shuffle 31.74, a shared load 29.74; so
// L_peak 47.4 cycles, L_tail 31.0) and computes the bound from each
// input's P and H.
//
// What the design does about it:
//  * The hot per-slot state lives in registers for the whole launch.  Lane
//    l of the walker warp owns track and packet slots l + 32 i (i < N: 2
//    for pools of up to 64, else 8); the flags are bit masks, the rest
//    arrays indexed by compile-time i only (fully unrolled loops, selects
//    on `si == i`), so none falls to local memory.  The winner's owner
//    updates its own registers; a value the uniform steps need from it (a
//    retired track's count, an expired packet's preamble) comes by one
//    __shfl_sync.  A track's next ring entry (count % R) is a register.
//  * The bulky state (the rings t_ring_* [K, R], t_mid_h [K, 16], the
//    packet entries p_ts / p_bin / p_h [Q, S]) lives in shared memory for
//    the launch (the kShared instance): loaded once (cp.async by both
//    warps), stored once.  Pools whose arrays pass a block's 227 KB run
//    the other instance, which keeps them in global memory;
//    ops/device_tracker picks by footprint.
//  * The hop's peak sort leaves the chain: a second warp stages the
//    lattice 32 hops ahead (coalesced loads into shared memory), sorts
//    each hop's M peaks by the stable key (valid ? bin : k + 1), one hop a
//    lane, and reduces the bins mod k, while the walker consumes the chunk
//    before (two buffers, one block barrier a chunk).  The walker fetches
//    the next peak, or the next hop's first, while it searches the
//    current one.
//  * Searches are votes: one ballot a slot index gives the matching and
//    the free slots; the first set bit is the winner unless two or more
//    tracks match, when two redux.sync take the least (t_seq, slot) -
//    exact for any seq.  The packet match likewise: one ballot, and the
//    lexicographic (phase distance, p_seq, slot) reduction only for two
//    or more eligible packets; the phase distance is finite and >= +0 (a
//    modulo of nonnegative ints over n > 0, folded to [0, 1]), so its
//    bits order as the float does.  No runtime modulo stays on the chain:
//    bin_ref is kept reduced mod k, the clocks step by a conditional
//    subtraction, the owner's stores go through a pointer select (the
//    other lanes write a sink word), so the warp does not diverge.
//  * A hop where no track retires and no packet expires costs one vote
//    and register work.  Retirements are ordered only among the tracks
//    that add packet entries (count >= 2, the kinds of :447-486); a track
//    is classified only in the branch its kind takes; the split groups run
//    one a lane; the assembly's windows run one a lane (a binary search of
//    the sorted entries), their end found by a ballot.
//
// Numerics are the JAX package's bit for bit: every f32 operation rounds
// on its own (__fadd_rn and friends; the file is built with -fmad=false),
// the stable preamble height sums its 16 heights in index order (XLA's CPU
// order) and divides by 16, and the int32 arithmetic takes Python's floor
// division and modulo where an operand can be negative.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// Pools of at most 256 slots (8 a lane), at most 32 retirements a hop
// (lane r keeps the r-th) and 32 split groups (one a lane): the wrapper's
// check() holds F to 32 and G to 16.
constexpr int kMaxSlots = 8;       // slots a lane
constexpr int kNarrowSlots = 2;    // pools of at most 64
constexpr int kImax = 0x7fffffff;
constexpr int kOv = 8;
constexpr int kRing = 2 * kOv;
constexpr int kMidLo = 2 * kOv;
constexpr int kMidN = kOv * (6 - 2) - kMidLo;   // num_preamble 6
constexpr int kPreMin = kOv * (6 - 1) + 2;
constexpr int kDataMax = 2 * kOv;
constexpr int kTtl0 = 6 * kOv;
constexpr int kChunk = 32;         // lattice hops staged at once
constexpr int kThreads = 64;       // the walker warp and the stager warp
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultShared = 48 * 1024;

struct State {
    uint8_t* t_active; int* t_seq; int* t_bin; int* t_count;
    uint8_t* t_updated; int* t_misses;
    int* t_ring_ts; int* t_ring_bin; float* t_ring_h; float* t_ring_hs;
    float* t_mid_h; uint8_t* s_gate;
    uint8_t* p_active; int* p_seq; int* p_ttl; int* p_pre_ts;
    int* p_pre_bin; float* p_pre_h; int* p_count;
    int* p_ts; int* p_bin; float* p_h;
    int* o_count; int* o_len; int* o_pos; int* o_syms;
    int* ts_ref; int* bin_ref; int* tseq; int* pseq;
    int* tracks_dropped; int* packets_dropped;
    int* tracks_overflow_finalized; int* finalize_deferred;
    int* expire_deferred; int* packet_peak_overflow; int* out_overflow;
};
constexpr int kFields = 37;

struct Params {
    int C, H, M, K, Q, S, O, F, E, R, G, n, k, hop, tol, ff, qoff, lo0,
        grace, split, max_track_peaks, ts_mod;
    float thr;
};

struct Lattice {
    const int* bins; const float* h; const float* hs; const uint8_t* valid;
};

// One channel's bulky arrays, indexed from the channel's own origin: in
// shared memory (kShared) or the state's own in global memory.
struct Bulk {
    int* ring_ts; int* ring_bin; float* ring_h; float* ring_hs;
    float* mid_h; int* p_ts; int* p_bin; float* p_h;
};

// Shared scratch: the lattice chunk as loaded (rows of M | 1 entries), the
// sorted chunks (two buffers, `buf` words apart: the one walked, the one
// staged: bins as given and reduced mod k, heights, each hop's walked
// count), the assembly's sorted entries and symbols, and a sink.
struct Work {
    int* r_bin; float* r_h; float* r_hs; uint8_t* r_v;
    int* s_bin; int* s_red; float* s_h; float* s_hs; int* nv;
    int buf;
    int* a_key; int* a_ts; int* a_bin; float* a_dis; int* a_sym;
    int* sink;           // where the lanes that own no winner store
};

__host__ __device__ inline size_t align16(size_t bytes) {
    return (bytes + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the block's dynamic shared memory: the bulk state
// (kShared only), then the chunk, then the assembly scratch, each array on
// 16 bytes; `total` its size (ops/device_tracker.TrackerWalk.shared_bytes
// repeats this sum).
struct Layout {
    size_t ring_ts, ring_bin, ring_h, ring_hs, mid_h, p_ts, p_bin, p_h;
    size_t r_bin, r_h, r_hs, r_v, s_bin, s_red, s_h, s_hs, nv, buf;
    size_t a_key, a_ts, a_bin, a_dis, a_sym, sink, total;
};

template <bool kShared>
__host__ __device__ Layout layout(const Params& p) {
    Layout l = {};
    size_t off = 0;
    auto take = [&](size_t& at, size_t words) {
        at = off;
        off += align16(4 * words);
    };
    if (kShared) {
        const size_t kr = static_cast<size_t>(p.K) * p.R;
        const size_t qs = static_cast<size_t>(p.Q) * p.S;
        take(l.ring_ts, kr); take(l.ring_bin, kr);
        take(l.ring_h, kr); take(l.ring_hs, kr);
        take(l.mid_h, static_cast<size_t>(p.K) * kMidN);
        take(l.p_ts, qs); take(l.p_bin, qs); take(l.p_h, qs);
    }
    const size_t cm = static_cast<size_t>(kChunk) * (p.M | 1);
    take(l.r_bin, cm); take(l.r_h, cm); take(l.r_hs, cm);
    l.r_v = off;                        // bytes
    off += align16(cm);
    // Two sorted buffers of the same five arrays, `buf` bytes apart.
    take(l.s_bin, cm); take(l.s_red, cm); take(l.s_h, cm); take(l.s_hs, cm);
    take(l.nv, kChunk);
    l.buf = off - l.s_bin;
    off += l.buf;
    take(l.a_key, p.S); take(l.a_ts, p.S); take(l.a_bin, p.S);
    take(l.a_dis, p.S); take(l.a_sym, p.S + 1);
    take(l.sink, 4);
    l.total = off;
    return l;
}

__device__ __forceinline__ int pmod(int a, int m) {
    int r = a % m;
    return r < 0 ? r + m : r;
}

// pmod(a, m) without a division where a lies in [-m, 2m).
__device__ __forceinline__ int wrap(int a, int m) {
    if (a >= 0) return a < m ? a : a - m < m ? a - m : pmod(a, m);
    return a >= -m ? a + m : pmod(a, m);
}

__device__ __forceinline__ int pdiv(int a, int b) {   // b > 0
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Phase distance of a timestamp offset (tsd % n) / n folded to [0, 1].
__device__ __forceinline__ float phase(int r, int n) {
    float dt = __fdiv_rn(__int2float_rn(r), __int2float_rn(n));
    return dt > 0.5f ? __fmul_rn(__fsub_rn(1.0f, dt), 2.0f)
                     : __fmul_rn(dt, 2.0f);
}

// x before y in jnp.argmin's order: a NaN first, as numpy's.
__device__ __forceinline__ bool before(float x, float y) {
    return x < y || (isnan(x) && !isnan(y));
}

// n 4-byte words global -> shared by the block's threads: cp.async 16
// bytes a thread where both ends are 16-byte aligned (waited for by
// cp_async_wait), the rest by plain loads.
__device__ __forceinline__ void load_words(void* dst, const void* src,
                                           size_t n, int tid) {
    int* d = static_cast<int*>(dst);
    const int* s = static_cast<const int*>(src);
    size_t head = 0;
    if (((reinterpret_cast<uintptr_t>(dst)
          | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
        for (size_t i = tid; i < n / 4; i += kThreads)
            hopper::cp_async16(d + 4 * i, s + 4 * i);
        head = n / 4 * 4;
    }
    for (size_t i = head + tid; i < n; i += kThreads) d[i] = s[i];
}

// n 4-byte words shared -> global by the block's threads, 16 bytes a
// thread where both ends are 16-byte aligned.
__device__ __forceinline__ void store_words(void* dst, const void* src,
                                            size_t n, int tid) {
    int* d = static_cast<int*>(dst);
    const int* s = static_cast<const int*>(src);
    size_t head = 0;
    if (((reinterpret_cast<uintptr_t>(dst)
          | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
        int4* d4 = static_cast<int4*>(dst);
        const int4* s4 = static_cast<const int4*>(src);
#pragma unroll 4
        for (size_t i = tid; i < n / 4; i += kThreads) d4[i] = s4[i];
        head = n / 4 * 4;
    }
    for (size_t i = head + tid; i < n; i += kThreads) d[i] = s[i];
}

// The stager warp: chunk k of the channel's lattice, loaded (coalesced)
// and each hop's peaks sorted by (valid ? bin : k + 1), stable, one hop a
// lane (:519-528), into sorted buffer `buf`; nv[h]: the hop's peaks
// before the first invalid one in that order (the ones walked).
__device__ __forceinline__ void stage(const Params& p, const Lattice& lat,
                                      const Work& w, int c, int k, int buf,
                                      int lane) {
    const int M = p.M, Mp = M | 1, h0 = k * kChunk;
    const int nh = min(kChunk, p.H - h0);
    const size_t g0 = (static_cast<size_t>(c) * p.H + h0) * M;
    for (int i = lane; i < nh * M; i += 32) {
        const int r = i / M, e = r * Mp + i - r * M;
        w.r_bin[e] = lat.bins[g0 + i];
        w.r_h[e] = lat.h[g0 + i];
        w.r_hs[e] = lat.hs[g0 + i];
        w.r_v[e] = lat.valid[g0 + i];
    }
    __syncwarp();
    if (lane < nh) {
        const int row = lane * Mp;
        int nv = M;
        for (int i = 0; i < M; ++i) {
            const bool vi = w.r_v[row + i];
            const int key = vi ? w.r_bin[row + i] : p.k + 1;
            int rank = 0;
            for (int m = 0; m < M; ++m) {
                const int km = w.r_v[row + m] ? w.r_bin[row + m] : p.k + 1;
                rank += km < key || (km == key && m < i);
            }
            const int e = buf * w.buf + row + rank;
            w.s_bin[e] = w.r_bin[row + i];
            w.s_red[e] = pmod(w.r_bin[row + i], p.k);
            w.s_h[e] = w.r_h[row + i];
            w.s_hs[e] = w.r_hs[row + i];
            if (!vi) nv = min(nv, rank);
        }
        w.nv[buf * w.buf + lane] = nv;
    }
    __syncwarp();                          // the raw rows' reads
}

// One channel's walk: its registers, its lane's slots, its bulk arrays.
template <int N>
struct Chan {
    const Params& p;
    const Bulk b;
    const Work w;
    const int lane;
    int ts_ref, bin_ref, tseq, pseq, o_count;
    int tracks_dropped, packets_dropped, overflow_fin, fin_def, exp_def,
        out_over;
    int peak_over;       // this lane's share: counted by a packet's owner
    bool s_gate;
    // Bit i: slot lane + 32 i exists (t_own, p_own), is active, updated.
    unsigned t_own, p_own, t_act, t_upd, p_act;
    int t_seq[N], t_bin[N], t_cnt[N], t_mis[N];
    int t_pos[N];        // t_cnt % R: the slot's next ring entry
    int p_seq[N], p_ttl[N], p_pts[N], p_pbin[N], p_cnt[N];
    float p_ph[N];

    const int nmask;     // n - 1 where n is a power of two, else -1

    __device__ Chan(const Params& p_, const Bulk& b_, const Work& w_,
                    int lane_)
        : p(p_), b(b_), w(w_), lane(lane_),
          nmask((p_.n & (p_.n - 1)) == 0 ? p_.n - 1 : -1) {}

    // x % n for x >= 0.
    __device__ __forceinline__ int mod_n(int x) const {
        return nmask >= 0 ? x & nmask : x % p.n;
    }

    // Whether retiring a track of `count` peaks adds packet entries (a
    // kind 2 track adds none, unless split's cond_bc can hold).
    __device__ __forceinline__ bool acts(int count) const {
        return count >= 2
               && (count <= kDataMax || count >= kPreMin || p.split);
    }

    // The least slot of a set held as one ballot a slot index (bit l of
    // m[i]: slot l + 32 i), or kImax.
    __device__ __forceinline__ static int first_slot(const unsigned (&m)[N]) {
        int sl = kImax;
#pragma unroll
        for (int i = N - 1; i >= 0; --i)
            if (m[i]) sl = 32 * i + __ffs(static_cast<int>(m[i])) - 1;
        return sl;
    }

    // ---- the state in and out ------------------------------------------
    __device__ __forceinline__ void load(const State& s, int c) {
        // Only bin_ref mod k matters (cur, and bin_ref's own next value).
        ts_ref = s.ts_ref[c]; bin_ref = pmod(s.bin_ref[c], p.k);
        tseq = s.tseq[c]; pseq = s.pseq[c]; o_count = s.o_count[c];
        tracks_dropped = s.tracks_dropped[c];
        packets_dropped = s.packets_dropped[c];
        overflow_fin = s.tracks_overflow_finalized[c];
        fin_def = s.finalize_deferred[c];
        exp_def = s.expire_deferred[c];
        out_over = s.out_overflow[c];
        peak_over = lane == 0 ? s.packet_peak_overflow[c] : 0;
        s_gate = s.s_gate[c];
        t_own = p_own = t_act = t_upd = p_act = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int j = lane + 32 * i;
            t_seq[i] = t_bin[i] = t_cnt[i] = t_mis[i] = t_pos[i] = 0;
            p_seq[i] = p_ttl[i] = p_pts[i] = p_pbin[i] = p_cnt[i] = 0;
            p_ph[i] = 1.0f;
            if (j < p.K) {
                const size_t g = static_cast<size_t>(c) * p.K + j;
                t_own |= 1u << i;
                t_act |= static_cast<unsigned>(s.t_active[g] != 0) << i;
                t_upd |= static_cast<unsigned>(s.t_updated[g] != 0) << i;
                t_seq[i] = s.t_seq[g]; t_bin[i] = s.t_bin[g];
                t_cnt[i] = s.t_count[g]; t_mis[i] = s.t_misses[g];
                t_pos[i] = t_cnt[i] % p.R;
            }
            if (j < p.Q) {
                const size_t g = static_cast<size_t>(c) * p.Q + j;
                p_own |= 1u << i;
                p_act |= static_cast<unsigned>(s.p_active[g] != 0) << i;
                p_seq[i] = s.p_seq[g]; p_ttl[i] = s.p_ttl[g];
                p_pts[i] = s.p_pre_ts[g]; p_pbin[i] = s.p_pre_bin[g];
                p_ph[i] = s.p_pre_h[g]; p_cnt[i] = s.p_count[g];
            }
        }
    }

    __device__ __forceinline__ void store(const State& s, int c) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int j = lane + 32 * i;
            if (j < p.K) {
                const size_t g = static_cast<size_t>(c) * p.K + j;
                s.t_active[g] = (t_act >> i) & 1u;
                s.t_updated[g] = (t_upd >> i) & 1u;
                s.t_seq[g] = t_seq[i]; s.t_bin[g] = t_bin[i];
                s.t_count[g] = t_cnt[i]; s.t_misses[g] = t_mis[i];
            }
            if (j < p.Q) {
                const size_t g = static_cast<size_t>(c) * p.Q + j;
                s.p_active[g] = (p_act >> i) & 1u;
                s.p_seq[g] = p_seq[i]; s.p_ttl[g] = p_ttl[i];
                s.p_pre_ts[g] = p_pts[i]; s.p_pre_bin[g] = p_pbin[i];
                s.p_pre_h[g] = p_ph[i]; s.p_count[g] = p_cnt[i];
            }
        }
        const int over = static_cast<int>(
            __reduce_add_sync(kFull, static_cast<unsigned>(peak_over)));
        if (lane == 0) {
            s.ts_ref[c] = ts_ref; s.bin_ref[c] = bin_ref;
            s.tseq[c] = tseq; s.pseq[c] = pseq; s.o_count[c] = o_count;
            s.tracks_dropped[c] = tracks_dropped;
            s.packets_dropped[c] = packets_dropped;
            s.tracks_overflow_finalized[c] = overflow_fin;
            s.finalize_deferred[c] = fin_def;
            s.expire_deferred[c] = exp_def;
            s.packet_peak_overflow[c] = over;
            s.out_overflow[c] = out_over;
            s.s_gate[c] = s_gate;
        }
    }

    // ---- packets ---------------------------------------------------------
    // Data eligibility (:290-298): the packet the peak joins, or -1; the
    // least (phase distance, p_seq, slot), searched only where two or
    // more packets are eligible.
    __device__ __forceinline__ int match_packet(int ts, float hh) const {
        const int n = p.n, mod = p.ts_mod;
        unsigned elig = 0, em[N];
        int tsd[N], ne = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            tsd[i] = wrap(ts - p_pts[i], mod);
            bool e = ((p_act >> i) & 1u) && tsd[i] > 4 * n
                     && tsd[i] < mod / 2;
            if (e) {
                const float h_dis =
                    __fdiv_rn(fabsf(__fsub_rn(p_ph[i], hh)), p_ph[i]);
                e = h_dis < 0.5f;
            }
            elig |= static_cast<unsigned>(e) << i;
            em[i] = __ballot_sync(kFull, e);
            ne += __popc(em[i]);
        }
        if (ne <= 1) return ne ? first_slot(em) : -1;
        int bdt = kImax, bseq = kImax, bidx = kImax;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if (!((elig >> i) & 1u)) continue;
            const int dt = __float_as_int(phase(mod_n(tsd[i]), n));
            if (bidx == kImax || dt < bdt || (dt == bdt && p_seq[i] < bseq)) {
                bdt = dt; bseq = p_seq[i]; bidx = lane + 32 * i;
            }
        }
        const int gdt = __reduce_min_sync(kFull, bdt);
        const int gseq = __reduce_min_sync(kFull, bdt == gdt ? bseq : kImax);
        return __reduce_min_sync(
            kFull, bdt == gdt && bseq == gseq ? bidx : kImax);
    }

    __device__ __forceinline__ void create(int ts, int bn, float hh) {
        const unsigned fr = ~p_act & p_own;
        const int fi = __reduce_min_sync(
            kFull, fr ? lane + 32 * (__ffs(static_cast<int>(fr)) - 1) : kImax);
        if (fi == kImax) { ++packets_dropped; return; }
        if ((fi & 31) == lane) {
            const int si = fi >> 5;
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (i == si) {
                    p_seq[i] = pseq; p_ttl[i] = kTtl0; p_pts[i] = ts;
                    p_pbin[i] = bn; p_ph[i] = hh; p_cnt[i] = 0;
                }
            p_act |= 1u << si;
        }
        ++pseq;
    }

    // A data peak joins packet qi: its TTL refreshed, the peak stored
    // while there is room (packet_peak_overflow otherwise).  The owner
    // alone acts.
    __device__ __forceinline__ void add_data(int qi, int ts, int bn,
                                             float hh) {
        if ((qi & 31) != lane) return;
        const int si = qi >> 5;
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (i == si) {
                cnt = p_cnt[i];
                p_ttl[i] = kTtl0;
                p_cnt[i] = min(cnt + 1, p.S);
            }
        if (cnt >= p.S) {
            ++peak_over;
        } else {
            const int e = qi * p.S + cnt;
            b.p_ts[e] = ts; b.p_bin[e] = bn; b.p_h[e] = hh;
        }
    }

    // pkt_step (:272-310).
    __device__ __forceinline__ void pkt_step(int kind, int ts, int bn,
                                             float hh) {
        if (kind == 0) {
            create(ts, bn, hh);
        } else if (kind == 1) {
            const int qi = match_packet(ts, hh);
            if (qi >= 0) add_data(qi, ts, bn, hh);
        }
    }

    // pkt_step_split (:319-363).
    __device__ __forceinline__ void pkt_step_split(int ctl, int pts, int pbin,
                                                   float phh, int dts,
                                                   int dbin, float dhh) {
        const int qi = match_packet(dts, dhh);
        const bool any_e = qi >= 0;
        const bool gate = s_gate;
        const bool make = ctl == 1 || (ctl == 3 && !any_e);
        const bool data = any_e && (ctl == 2 || ctl == 3
                                    || (ctl == 4 && gate) || ctl == 5);
        if (ctl == 3) s_gate = any_e;
        if (make) create(pts, pbin, phh);
        if (data) add_data(qi, dts, dbin, dhh);
    }

    // ---- tracks ----------------------------------------------------------
    // find_and_add_peak (:162-194) of a peak at bin b (cur: b relative to
    // bin_ref): the first live track within tolerance by (t_seq, slot),
    // else the first free slot.  One ballot a slot index finds both; the
    // seq search runs only where two or more tracks match.
    __device__ __forceinline__ void peak_step(int cur, int bn, float hv,
                                              float hsv) {
        const int k = p.k, tol = p.tol;
        unsigned match = 0, mt[N], fr[N];
        int nm = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            // pmod(cur - t_bin, k) within tol of 0 or k, both in [0, k).
            const int a = abs(cur - t_bin[i]);
            const bool m = ((t_act >> i) & 1u) && (a <= tol || a >= k - tol);
            match |= static_cast<unsigned>(m) << i;
            mt[i] = __ballot_sync(kFull, m);
            fr[i] = __ballot_sync(kFull, ((t_own & ~t_act) >> i) & 1u);
            nm += __popc(mt[i]);
        }
        const int fm = first_slot(mt), ff = first_slot(fr);
        int sel = nm ? fm : ff;
        if (__builtin_expect(nm > 1, 0)) {
            int mseq = kImax, midx = kImax;
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (((match >> i) & 1u) && (midx == kImax || t_seq[i] < mseq)) {
                    mseq = t_seq[i]; midx = lane + 32 * i;
                }
            const int gseq = __reduce_min_sync(kFull, mseq);
            sel = __reduce_min_sync(kFull, mseq == gseq ? midx : kImax);
        }
        if (__builtin_expect(sel == kImax, 0)) { ++tracks_dropped; return; }
        const bool any_m = nm != 0, mine = (sel & 31) == lane;
        const int si = sel >> 5;
        int cnt0 = 0, pos = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const bool hit = mine && si == i;
            cnt0 = hit && any_m ? t_cnt[i] : cnt0;
            pos = hit && any_m ? t_pos[i] : pos;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const bool hit = mine && si == i, made = hit && !any_m;
            t_seq[i] = made ? tseq : t_seq[i];
            t_bin[i] = made ? cur : t_bin[i];
            t_mis[i] = made ? 0 : t_mis[i];
            t_cnt[i] = hit ? cnt0 + 1 : t_cnt[i];
            t_pos[i] = hit ? (pos + 1 == p.R ? 0 : pos + 1) : t_pos[i];
        }
        const unsigned bit = mine ? 1u << si : 0u;
        t_act |= bit;
        t_upd |= bit;
        // The owner's ring entry (and stable height); every other lane
        // stores to the sink, so the warp does not diverge.
        const int e = sel * p.R + pos;
        const bool mid = mine && cnt0 >= kMidLo && cnt0 < kMidLo + kMidN;
        *(mine ? b.ring_ts + e : w.sink) = ts_ref;
        *(mine ? b.ring_bin + e : w.sink) = bn;
        *(mine ? reinterpret_cast<int*>(b.ring_h + e) : w.sink) =
            __float_as_int(hv);
        *(mine ? reinterpret_cast<int*>(b.ring_hs + e) : w.sink) =
            __float_as_int(hsv);
        *(mid ? reinterpret_cast<int*>(b.mid_h + sel * kMidN + cnt0 - kMidLo)
              : w.sink) = __float_as_int(hv);
        tseq += !any_m;
    }

    // get_central_peak (:197-241) of track slot j with `count` peaks:
    // only the branch of its kind (0 preamble, else data).
    __device__ __forceinline__ void classify(int j, int count, int kind,
                                             int& ats, int& abin,
                                             float& ah) const {
        const int R = p.R;
        const int base = j * R, p0 = pmod(count - kRing, R);
        auto at = [&](int i) {                  // i in [0, kRing]
            return base + (p0 + i < R ? p0 + i : p0 + i - R);
        };
        if (kind != 0) {
            // DATA: the first argmax of h over the valid entries.
            auto hv = [&](int i) {
                return count - kRing + i >= 0 ? b.ring_h[at(i)] : -INFINITY;
            };
            int di = 0;
            float dh = hv(0);
            for (int i = 1; i < kRing; ++i) {
                const float h = hv(i);
                if (h > dh) { dh = h; di = i; }
            }
            ats = b.ring_ts[at(di)];
            abin = b.ring_bin[at(di)];
            ah = b.ring_h[at(di)];
            return;
        }
        // PREAMBLE: the last chirp's apex, walked back (:213-232).
        int r_idx = kRing - kOv;
        float rh = b.ring_h[at(r_idx)];
        for (int i = kRing - kOv + 1; i < kRing; ++i) {
            const float h = b.ring_h[at(i)];
            if (h > rh) { rh = h; r_idx = i; }
        }
        int start = r_idx;
        bool stop = false;
        for (int it = 0; it < kOv / 2; ++it) {
            const bool in_loop = !stop && start > r_idx - kOv / 2;
            const float prev = b.ring_hs[at(max(start - 1, 0))];
            const float here = b.ring_hs[at(start)];
            const bool brk = prev > here || here < p.thr;
            if (in_loop && !brk) --start;
            stop = stop || !in_loop || brk;
        }
        int ai = start;
        float ahs = b.ring_hs[at(start)];
        for (int i = start + 1; i < kRing; ++i) {
            const float h = b.ring_hs[at(i)];
            if (h > ahs) { ahs = h; ai = i; }
        }
        ats = pmod(b.ring_ts[at(ai)] + p.n / 4, p.ts_mod);
        abin = b.ring_bin[at(ai)];
        const float* mid = b.mid_h + j * kMidN;
        float sum = mid[0];
        for (int i = 1; i < kMidN; ++i) sum = __fadd_rn(sum, mid[i]);
        ah = __fdiv_rn(sum, static_cast<float>(kMidN));
    }

    // split_extract (:247-269) of track slot j, one group a lane: lane g
    // (< G) gets group g's snapped entry; returns the groups' ok mask.
    __device__ __forceinline__ unsigned split_extract(int j, int count,
                                                      int& sts, int& sbin,
                                                      float& sh) const {
        const int R = p.R, G = p.G, n = p.n, k = p.k, mod = p.ts_mod;
        const int base = j * R, p0 = pmod(count, R);
        auto at = [&](int i) {                  // i in [0, R)
            return base + (p0 + i < R ? p0 + i : p0 + i - R);
        };
        float hmax = -INFINITY;
        for (int i = 0; i < R; ++i)
            if (count - R + i >= 0) hmax = fmaxf(hmax, b.ring_h[at(i)]);
        const float lim95 = __fmul_rn(0.95f, hmax);
        int ai = 0;
        for (int i = 0; i < R; ++i)
            if (count - R + i >= 0 && b.ring_h[at(i)] >= lim95) {
                ai = i;
                break;
            }
        const int ats = b.ring_ts[at(ai)];
        const int g = lane;
        float bh = -INFINITY;
        int bi = 0;
        bool any = false;
        if (g < G) {
            for (int i = 0; i < R; ++i) {
                if (count - R + i < 0) continue;
                const int rel = wrap(b.ring_ts[at(i)] - ats, mod);
                if (rel > mod / 2 || (rel + n / 2) / n != g) continue;
                const float h = b.ring_h[at(i)];
                if (!any || h > bh) { bh = h; bi = i; }
                any = true;
            }
        }
        const bool ok = g < G && any && bh >= __fmul_rn(0.7f, hmax);
        const int snap = pmod(ats + g * n, mod);
        const int dt = pmod(snap - b.ring_ts[at(bi)] + n / 2, mod) - n / 2;
        sts = snap;
        sbin = pmod(b.ring_bin[at(bi)] + pdiv(dt * k, n), k);
        sh = ok ? b.ring_h[at(bi)] : 0.0f;
        return __ballot_sync(kFull, ok);
    }

    // One retired candidate's packet entries (:447-486); acts(count).
    __device__ __forceinline__ void retire(int j, int count) {
        const int kind = count >= kPreMin ? 0
                         : (count >= 2 && count <= kDataMax) ? 1 : 2;
        int ats, abin;
        float ah;
        classify(j, count, kind, ats, abin, ah);
        if (!p.split) {
            pkt_step(kind, ats, abin, ah);
            return;
        }
        int sts, sbin;
        float sh;
        const unsigned okm = split_extract(j, count, sts, sbin, sh);
        const bool can = __popc(okm) >= 2;
        const bool cond_a = can && kind == 0 && count < p.R;
        const bool cond_bc =
            can && ((kind == 1 && count > kOv + 2 && count < kPreMin)
                    || (kind == 2 && count > kDataMax && count < kPreMin));
        const int fvi = okm ? __ffs(static_cast<int>(okm)) - 1 : 0;
        const int ctl0 = cond_a ? 3 : cond_bc ? 0
                         : kind == 0 ? 1 : kind == 1 ? 2 : 0;
        if (ctl0) {
            const int fts = __shfl_sync(kFull, sts, fvi);
            const int fbin = __shfl_sync(kFull, sbin, fvi);
            const float fh = __shfl_sync(kFull, sh, fvi);
            pkt_step_split(ctl0, ats, abin, ah, cond_a ? fts : ats,
                           cond_a ? fbin : abin, cond_a ? fh : ah);
        }
        for (int g = 0; g < p.G; ++g) {
            const int ctl = !((okm >> g) & 1u) ? 0
                            : (cond_a && g == fvi) ? 0
                            : cond_a ? 4 : cond_bc ? 5 : 0;
            if (ctl)
                pkt_step_split(ctl, ats, abin, ah,
                               __shfl_sync(kFull, sts, g),
                               __shfl_sync(kFull, sbin, g),
                               __shfl_sync(kFull, sh, g));
        }
    }

    // Packet slots of this lane that have expired.
    __device__ __forceinline__ unsigned expiring() const {
        unsigned m = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
            m |= static_cast<unsigned>(((p_act >> i) & 1u) && p_ttl[i] <= 0)
                 << i;
        return m;
    }

    // Assembly (:366-401) of packet slot qj (its count and preamble);
    // returns its length, the symbols of this lane's windows in a_sym.
    __device__ __forceinline__ int assemble(int qj, int cnt, int pre_ts,
                                            int pre_bin, float pre_h) {
        const int n = p.n, k = p.k, W = p.S + 1;
        const int base = qj * p.S;
        __syncwarp();                      // the previous assembly's reads
        for (int i = lane; i < cnt; i += 32)
            w.a_key[i] = wrap(b.p_ts[base + i] - pre_ts, p.ts_mod);
        __syncwarp();
        // Stable sort of the valid entries by (tsn, index).
        for (int i = lane; i < cnt; i += 32) {
            const int key = w.a_key[i];
            int rank = 0;
            for (int m = 0; m < cnt; ++m) {
                const int km = w.a_key[m];
                rank += km < key || (km == key && m < i);
            }
            w.a_ts[rank] = key;
            w.a_bin[rank] = b.p_bin[base + i];
            w.a_dis[rank] = __fadd_rn(
                phase(mod_n(key), n),
                __fdiv_rn(fabsf(__fsub_rn(b.p_h[base + i], pre_h)), pre_h));
        }
        __syncwarp();
        if (cnt == 0) return 0;
        const int last = w.a_ts[cnt - 1];
        // Window w holds the entries lo < ts < hi; the first window that
        // finds none or has none past it ends the packet.
        int first_bad = kImax;
        for (int w0 = 0; w0 < W && first_bad == kImax; w0 += 32) {
            const int wi = w0 + lane;
            bool bad = false;
            if (wi < W) {
                const int lo = p.lo0 + wi * n, hi = lo + n;
                int a = 0, z = cnt;
                while (a < z) {
                    const int mid = (a + z) >> 1;
                    if (w.a_ts[mid] <= lo) a = mid + 1; else z = mid;
                }
                bool found = false;
                float best = INFINITY;
                int bi = 0;
                for (int i = a; i < cnt && w.a_ts[i] < hi; ++i) {
                    if (!found || before(w.a_dis[i], best)) {
                        best = w.a_dis[i]; bi = i;
                    }
                    found = true;
                }
                int sym = 0;
                if (found) {
                    const int shift = mod_n(w.a_ts[bi]) * k / n;
                    sym = ((pmod(w.a_bin[bi] - pre_bin - shift, k) + p.qoff)
                           / p.ff) % (k / p.ff);
                }
                w.a_sym[wi] = sym;
                bad = !(found && last >= hi);
            }
            const unsigned bm = __ballot_sync(kFull, bad);
            if (bm) first_bad = w0 + __ffs(static_cast<int>(bm)) - 1;
        }
        return first_bad == kImax ? W : first_bad + 1;
    }

    // The rest of hop_body (:407-516): retirement, packet entries, expiry
    // and assembly, the clocks.  A hop where no track retires and no
    // packet expires takes one vote and register work.
    __device__ __forceinline__ void hop_tail(const State& s, int c) {
        unsigned over_m = 0, idle_m = 0, keep_m = 0, acts_m = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const bool act = (t_act >> i) & 1u;
            const bool over = act && t_cnt[i] >= p.max_track_peaks;
            const bool graced = t_mis[i] < p.grace && t_cnt[i] > kDataMax;
            const bool idle = act && !over && !((t_upd >> i) & 1u)
                              && !graced;
            over_m |= static_cast<unsigned>(over) << i;
            idle_m |= static_cast<unsigned>(idle) << i;
            keep_m |= static_cast<unsigned>(act && !over && !idle) << i;
        }
        const unsigned exp_m = expiring();
        const bool any = __any_sync(kFull, (over_m | idle_m | exp_m) != 0);
        // Under the vote: age the kept tracks (none of them retires), mark
        // the tracks whose retirement adds packet entries, the clocks.
#pragma unroll
        for (int i = 0; i < N; ++i) {
            if ((keep_m >> i) & 1u)
                t_mis[i] = ((t_upd >> i) & 1u) ? 0 : t_mis[i] + 1;
            acts_m |= static_cast<unsigned>(acts(t_cnt[i])) << i;
        }
        t_upd &= ~keep_m;
        const int ts = ts_ref + p.hop, bn = bin_ref + p.k / kOv;
        ts_ref = static_cast<unsigned>(ts) < 2u * p.ts_mod
                 ? (ts >= p.ts_mod ? ts - p.ts_mod : ts) : pmod(ts, p.ts_mod);
        bin_ref = bn >= p.k ? bn - p.k : bn;   // both terms in [0, k)
        if (__builtin_expect(any, 0))
            retire_and_expire(s, c, over_m, idle_m, acts_m, exp_m);
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (((p_act >> i) & 1u) && p_ttl[i] > 0) --p_ttl[i];
    }

    // The least (t_seq, slot) of this lane's slots in `pool`, reduced over
    // the warp; the winner's count in `cnt`.
    __device__ __forceinline__ int least_track(unsigned pool,
                                               int& cnt) const {
        int lseq = kImax, lidx = kImax, lcnt = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (((pool >> i) & 1u) && (lidx == kImax || t_seq[i] < lseq)) {
                lseq = t_seq[i]; lidx = lane + 32 * i; lcnt = t_cnt[i];
            }
        const int gseq = __reduce_min_sync(kFull, lseq);
        const int gidx = __reduce_min_sync(kFull,
                                           lseq == gseq ? lidx : kImax);
        cnt = __shfl_sync(kFull, lcnt, gidx & 31);
        return gidx;
    }

    __device__ __forceinline__ void retire_and_expire(
            const State& s, int c, unsigned over_m, unsigned idle_m,
            unsigned acts_m, unsigned exp_m) {
        const unsigned counts = __reduce_add_sync(
            kFull, static_cast<unsigned>(__popc(over_m))
                   | static_cast<unsigned>(__popc(idle_m)) << 10
                   | static_cast<unsigned>(__popc(exp_m)) << 20);
        const unsigned acting = __reduce_add_sync(
            kFull, static_cast<unsigned>(__popc(over_m & acts_m))
                   | static_cast<unsigned>(__popc(idle_m & acts_m)) << 10);
        const int n_over = counts & 1023, n_idle = (counts >> 10) & 1023;
        int n_exp = counts >> 20;
        // Retirement candidates (:407-445): over-cap tracks first, then
        // idle ones, each by (t_seq, slot); at most F.  Lane r keeps the
        // r-th retiree that adds packet entries (slot, count), in order.
        const int nc = min(n_over + n_idle, p.F);
        fin_def += max(n_over + n_idle - p.F, 0);
        overflow_fin += min(n_over, nc);
        unsigned taken = 0;
        int nr = 0, cj = 0, cc = 0;
        if (n_over + n_idle <= p.F) {
            // All retire: only those that add packet entries need order.
            taken = over_m | idle_m;
            const int a_over = acting & 1023, a_all = a_over + (acting >> 10);
            if (a_all == 1) {              // the one: its slot by ballot
                unsigned am[N];
                int lcnt = 0;
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    const bool a = ((taken & acts_m) >> i) & 1u;
                    am[i] = __ballot_sync(kFull, a);
                    lcnt = a ? t_cnt[i] : lcnt;
                }
                cj = first_slot(am);
                cc = __shfl_sync(kFull, lcnt, cj & 31);
                nr = 1;
            }
            unsigned done = 0;
            for (; nr < a_all; ++nr) {
                int cnt;
                const int j = least_track(
                    (nr < a_over ? over_m : idle_m) & acts_m & ~done, cnt);
                if ((j & 31) == lane) done |= 1u << (j >> 5);
                if (lane == nr) { cj = j; cc = cnt; }
            }
        } else {
            for (int f = 0; f < nc; ++f) {
                int cnt;
                const int j = least_track(
                    (f < n_over ? over_m : idle_m) & ~taken, cnt);
                if ((j & 31) == lane) taken |= 1u << (j >> 5);
                if (acts(cnt)) {
                    if (lane == nr) { cj = j; cc = cnt; }
                    ++nr;
                }
            }
        }
        t_act &= ~taken;
        unsigned ex = exp_m;
        if (nr) {
            __syncwarp();                  // the rings' stores by owners
            for (int r = 0; r < nr; ++r)
                retire(__shfl_sync(kFull, cj, r), __shfl_sync(kFull, cc, r));
            ex = expiring();
            n_exp = static_cast<int>(__reduce_add_sync(
                kFull, static_cast<unsigned>(__popc(ex))));
        }
        // TTL expiry and assembly (:488-513), at most E by (p_seq, slot).
        const int ne = min(n_exp, p.E);
        exp_def += max(n_exp - p.E, 0);
        if (ne) {
            __syncwarp();                  // the entries' stores by owners
            unsigned done = 0;
            int emitted = 0;
            const int W = p.S + 1;
            for (int e = 0; e < ne; ++e) {
                const unsigned pool = ex & ~done;
                int lseq = kImax, lidx = kImax, li = 0;
#pragma unroll
                for (int i = 0; i < N; ++i)
                    if (((pool >> i) & 1u)
                        && (lidx == kImax || p_seq[i] < lseq)) {
                        lseq = p_seq[i]; lidx = lane + 32 * i; li = i;
                    }
                const int gseq = __reduce_min_sync(kFull, lseq);
                const int qj = __reduce_min_sync(kFull,
                                                 lseq == gseq ? lidx : kImax);
                int cnt = 0, pts = 0, pbin = 0;
                float ph = 0.0f;
#pragma unroll
                for (int i = 0; i < N; ++i)
                    if (i == li) {
                        cnt = p_cnt[i]; pts = p_pts[i]; pbin = p_pbin[i];
                        ph = p_ph[i];
                    }
                const int owner = qj & 31;
                cnt = __shfl_sync(kFull, cnt, owner);
                pts = __shfl_sync(kFull, pts, owner);
                pbin = __shfl_sync(kFull, pbin, owner);
                ph = __shfl_sync(kFull, ph, owner);
                if (owner == lane) done |= 1u << (qj >> 5);
                const int len = assemble(qj, cnt, pts, pbin, ph);
                if (len >= 8) {
                    const int slot = o_count + emitted;
                    if (slot < p.O) {
                        int* out = s.o_syms
                            + (static_cast<size_t>(c) * p.O + slot) * W;
                        for (int wi = lane; wi < W; wi += 32)
                            out[wi] = wi < len ? w.a_sym[wi] : 0;
                        if (lane == 0) {
                            s.o_len[c * p.O + slot] = len;
                            s.o_pos[c * p.O + slot] = pts;
                        }
                    } else {
                        ++out_over;
                    }
                    ++emitted;
                }
            }
            p_act &= ~done;
            o_count = min(o_count + emitted, p.O);
        }
        if (nr || ne) __syncwarp();        // the reads before next stores
    }
};

// A chunk's walk: each hop's valid peaks in bin order, then its tail; the
// next peak (or the next hop's first) fetched while the current one is
// searched.
template <int N>
__device__ __forceinline__ void walk_chunk(Chan<N>& ch, const Params& p,
                                           const Work& w, int buf, int nh,
                                           const State& s, int c) {
    const int Mp = p.M | 1;
    const int* sb = w.s_bin + buf * w.buf;
    const int* sr = w.s_red + buf * w.buf;
    const float* sh = w.s_h + buf * w.buf;
    const float* shs = w.s_hs + buf * w.buf;
    const int* nvs = w.nv + buf * w.buf;
    int bn = sb[0], br = sr[0];
    float hv = sh[0], hsv = shs[0];
    int nv = nvs[0];
    for (int r = 0; r < nh; ++r) {
        const int nxt_hop = r + 1 < nh ? (r + 1) * Mp : 0;
        const int nv_next = nvs[r + 1 < nh ? r + 1 : r];
        for (int m = 0; m < nv; ++m) {
            const int cb = bn, cr = br;
            const float ch_ = hv, chs = hsv;
            const int nx = m + 1 < nv ? r * Mp + m + 1 : nxt_hop;
            bn = sb[nx]; br = sr[nx]; hv = sh[nx]; hsv = shs[nx];
            // pmod(k + b - bin_ref, k) from b mod k and bin_ref in [0, k).
            const int d = cr - ch.bin_ref;
            ch.peak_step(d < 0 ? d + p.k : d, cb, ch_, chs);
        }
        if (nv == 0) {
            bn = sb[nxt_hop]; br = sr[nxt_hop];
            hv = sh[nxt_hop]; hsv = shs[nxt_hop];
        }
        ch.hop_tail(s, c);
        nv = nv_next;
    }
}

// One block a channel: warp 0 walks, warp 1 stages the lattice a chunk
// ahead; both move the bulk state in and out (kShared).
template <int N, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
tracker_kernel(State s, Params p, Lattice lat) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const bool walker = tid < 32;
    const Layout l = layout<kShared>(p);
    const size_t kr = static_cast<size_t>(p.K) * p.R;
    const size_t km = static_cast<size_t>(p.K) * kMidN;
    const size_t qs = static_cast<size_t>(p.Q) * p.S;
    // The channel's bulk arrays in global memory.
    const Bulk glob = {s.t_ring_ts + c * kr, s.t_ring_bin + c * kr,
                       s.t_ring_h + c * kr, s.t_ring_hs + c * kr,
                       s.t_mid_h + c * km, s.p_ts + c * qs,
                       s.p_bin + c * qs, s.p_h + c * qs};
    Bulk bulk = glob;
    if (kShared)
        bulk = {reinterpret_cast<int*>(smem + l.ring_ts),
                reinterpret_cast<int*>(smem + l.ring_bin),
                reinterpret_cast<float*>(smem + l.ring_h),
                reinterpret_cast<float*>(smem + l.ring_hs),
                reinterpret_cast<float*>(smem + l.mid_h),
                reinterpret_cast<int*>(smem + l.p_ts),
                reinterpret_cast<int*>(smem + l.p_bin),
                reinterpret_cast<float*>(smem + l.p_h)};
    Work work;
    work.r_bin = reinterpret_cast<int*>(smem + l.r_bin);
    work.r_h = reinterpret_cast<float*>(smem + l.r_h);
    work.r_hs = reinterpret_cast<float*>(smem + l.r_hs);
    work.r_v = smem + l.r_v;
    work.s_bin = reinterpret_cast<int*>(smem + l.s_bin);
    work.s_red = reinterpret_cast<int*>(smem + l.s_red);
    work.s_h = reinterpret_cast<float*>(smem + l.s_h);
    work.s_hs = reinterpret_cast<float*>(smem + l.s_hs);
    work.nv = reinterpret_cast<int*>(smem + l.nv);
    work.buf = static_cast<int>(l.buf / 4);
    work.a_key = reinterpret_cast<int*>(smem + l.a_key);
    work.a_ts = reinterpret_cast<int*>(smem + l.a_ts);
    work.a_bin = reinterpret_cast<int*>(smem + l.a_bin);
    work.a_dis = reinterpret_cast<float*>(smem + l.a_dis);
    work.a_sym = reinterpret_cast<int*>(smem + l.a_sym);
    work.sink = reinterpret_cast<int*>(smem + l.sink);
    if (kShared) {
        load_words(bulk.ring_ts, glob.ring_ts, kr, tid);
        load_words(bulk.ring_bin, glob.ring_bin, kr, tid);
        load_words(bulk.ring_h, glob.ring_h, kr, tid);
        load_words(bulk.ring_hs, glob.ring_hs, kr, tid);
        load_words(bulk.mid_h, glob.mid_h, km, tid);
        load_words(bulk.p_ts, glob.p_ts, qs, tid);
        load_words(bulk.p_bin, glob.p_bin, qs, tid);
        load_words(bulk.p_h, glob.p_h, qs, tid);
        hopper::cp_async_commit();
    }
    Chan<N> ch(p, bulk, work, lane);
    if (walker)
        ch.load(s, c);
    else
        stage(p, lat, work, c, 0, 0, lane);
    if (kShared) hopper::cp_async_wait<0>();
    __syncthreads();                       // the bulk state, chunk 0
    const int chunks = (p.H + kChunk - 1) / kChunk;
    for (int k = 0; k < chunks; ++k) {
        if (walker)
            walk_chunk(ch, p, work, k & 1, min(kChunk, p.H - k * kChunk), s,
                       c);
        else if (k + 1 < chunks)
            stage(p, lat, work, c, k + 1, (k + 1) & 1, lane);
        __syncthreads();                   // chunk k walked, k + 1 staged
    }
    if (walker) ch.store(s, c);
    if (kShared) {
        store_words(glob.ring_ts, bulk.ring_ts, kr, tid);
        store_words(glob.ring_bin, bulk.ring_bin, kr, tid);
        store_words(glob.ring_h, bulk.ring_h, kr, tid);
        store_words(glob.ring_hs, bulk.ring_hs, kr, tid);
        store_words(glob.mid_h, bulk.mid_h, km, tid);
        store_words(glob.p_ts, bulk.p_ts, qs, tid);
        store_words(glob.p_bin, bulk.p_bin, qs, tid);
        store_words(glob.p_h, bulk.p_h, qs, tid);
    }
}

// ---- the host side ------------------------------------------------------
template <int N, bool kShared>
int launch(const State& s, const Params& p, const Lattice& lat, size_t smem,
           cudaStream_t stream) {
    auto kernel = tracker_kernel<N, kShared>;
    if (smem > kDefaultShared) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            cudaGetLastError();            // not the next launch's error
            return static_cast<int>(err);
        }
    }
    kernel<<<p.C, kThreads, smem, stream>>>(s, p, lat);
    return static_cast<int>(cudaGetLastError());
}

template <bool kShared>
int walk(void* const* fields, const int* params, float thr, const void* bins,
         const void* h, const void* hs, const void* valid, void* stream) {
    State s;
    void** dst = reinterpret_cast<void**>(&s);
    for (int i = 0; i < kFields; ++i) dst[i] = fields[i];
    Params p;
    int* pi = &p.C;
    for (int i = 0; i < 22; ++i) pi[i] = params[i];
    p.thr = thr;
    const Lattice lat = {static_cast<const int*>(bins),
                         static_cast<const float*>(h),
                         static_cast<const float*>(hs),
                         static_cast<const uint8_t*>(valid)};
    const size_t smem = layout<kShared>(p).total;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.K <= 32 * kNarrowSlots && p.Q <= 32 * kNarrowSlots)
        return launch<kNarrowSlots, kShared>(s, p, lat, smem, st);
    return launch<kMaxSlots, kShared>(s, p, lat, smem, st);
}

}  // namespace

// The shared-memory instance: the bulk state in shared memory for the
// launch (pools whose footprint fits a block).
extern "C" int grl_device_tracker(void* const* fields, const int* params,
                                  float thr, const void* bins,
                                  const void* h, const void* hs,
                                  const void* valid, void* stream) {
    return walk<true>(fields, params, thr, bins, h, hs, valid, stream);
}

// The global-memory instance: the bulk state stays in the state's tensors.
extern "C" int grl_device_tracker_global(void* const* fields,
                                         const int* params, float thr,
                                         const void* bins, const void* h,
                                         const void* hs, const void* valid,
                                         void* stream) {
    return walk<false>(fields, params, thr, bins, h, hs, valid, stream);
}
