// The on-device Pyramid tracker's walk over a [C, H, M] peak lattice block.
//
// Replaces the nested lax.scans of make_device_tracker
// (gr_lora_tpu/models/device_tracker.py:85-531): hops (:527), the peaks of
// a hop (:405), the packet entries of the retired tracks (:447-486) and the
// expiry's assembly (:488-513).  Not a Pallas kernel: it stands where a
// lax.scan stood, and its plain twin is ops/device_tracker.TrackerWalk.
//
// Bound on the card: neither bytes nor operations.  A channel's walk is a
// serial chain (a hop's peaks in bin order, each a search of the track
// pool; each retired track a search of the packet pool), so the time is
// the latency of that chain.  Channels are independent: one warp a channel
// (one block of 32 threads), every channel at once.  The design keeps each
// step short: a lane owns the track slots lane + 32 i (i < ceil(K / 32))
// and the packet slots likewise, so "the first matching live track by
// t_seq", "the first free slot", the retirement and expiry orders and the
// packet match are one pass over a lane's slots and a warp shuffle
// reduction; the uniform steps (classification, split extraction, packet
// creation) run on every lane alike from the same loads, and lane 0 writes.
// The state stays in global memory (L1 / L2 resident for a block's walk);
// the counters and clocks live in registers for the whole launch.
//
// Numerics are the JAX package's bit for bit: every f32 operation rounds
// on its own (__fadd_rn and friends; the file is built with -fmad=false),
// the stable preamble height sums its 16 heights in index order (XLA's CPU
// order) and divides by 16, and the int32 arithmetic takes Python's floor
// division and modulo where an operand can be negative.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 8;       // slots a lane: pools of at most 256
constexpr int kMaxFinalize = 32;
constexpr int kMaxGroups = 16;
constexpr int kImax = 0x7fffffff;
constexpr int kOv = 8;
constexpr int kRing = 2 * kOv;
constexpr int kMidLo = 2 * kOv;
constexpr int kMidN = kOv * (6 - 2) - kMidLo;   // num_preamble 6
constexpr int kPreMin = kOv * (6 - 1) + 2;
constexpr int kDataMax = 2 * kOv;
constexpr int kTtl0 = 6 * kOv;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int pmod(int a, int m) {
    int r = a % m;
    return r < 0 ? r + m : r;
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

// Lexicographic warp minima: every lane ends with the winning tuple.
__device__ __forceinline__ void warp_min3(int& a, int& b, int& c) {
    for (int o = 16; o; o >>= 1) {
        const int a2 = __shfl_xor_sync(kFull, a, o);
        const int b2 = __shfl_xor_sync(kFull, b, o);
        const int c2 = __shfl_xor_sync(kFull, c, o);
        if (a2 < a || (a2 == a && (b2 < b || (b2 == b && c2 < c)))) {
            a = a2; b = b2; c = c2;
        }
    }
}

__device__ __forceinline__ void warp_min2(int& a, int& b) {
    int z = 0;
    warp_min3(a, b, z);
}

__device__ __forceinline__ void warp_min3f(float& x, int& a, int& b) {
    for (int o = 16; o; o >>= 1) {
        const float x2 = __shfl_xor_sync(kFull, x, o);
        const int a2 = __shfl_xor_sync(kFull, a, o);
        const int b2 = __shfl_xor_sync(kFull, b, o);
        if (before(x2, x) || ((x2 == x || (isnan(x2) && isnan(x)))
                              && (a2 < a || (a2 == a && b2 < b)))) {
            x = x2; a = a2; b = b2;
        }
    }
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// One channel's pools and registers.
struct Chan {
    State s;
    const Params* p;
    int c, lane;
    int ts_ref, bin_ref, tseq, pseq, o_count;
    int tracks_dropped, packets_dropped, overflow_fin, fin_def, exp_def,
        peak_over, out_over;
    bool s_gate;

    __device__ int t(int j) const { return c * p->K + j; }
    __device__ int q(int j) const { return c * p->Q + j; }

    // ---- packets ---------------------------------------------------------
    // Data eligibility (:290-298): the packet the peak joins, or -1.
    __device__ int match_packet(int ts, float hh) const {
        const int n = p->n, mod = p->ts_mod;
        float best = INFINITY;
        int bseq = kImax, bidx = kImax;
        for (int i = 0; i * 32 < p->Q; ++i) {
            const int j = lane + 32 * i;
            if (j >= p->Q || !s.p_active[q(j)]) continue;
            const int tsd = pmod(ts - s.p_pre_ts[q(j)], mod);
            if (!(tsd > 4 * n && tsd < mod / 2)) continue;
            const float pre_h = s.p_pre_h[q(j)];
            const float h_dis =
                __fdiv_rn(fabsf(__fsub_rn(pre_h, hh)), pre_h);
            if (!(h_dis < 0.5f)) continue;
            const float dt = phase(tsd % n, n);
            const int seq = s.p_seq[q(j)];
            if (dt < best || (dt == best && (seq < bseq
                                             || (seq == bseq && j < bidx)))) {
                best = dt; bseq = seq; bidx = j;
            }
        }
        warp_min3f(best, bseq, bidx);
        return bidx == kImax ? -1 : bidx;
    }

    __device__ int first_free_packet() const {
        int f = kImax, z = 0;
        for (int i = 0; i * 32 < p->Q; ++i) {
            const int j = lane + 32 * i;
            if (j < p->Q && !s.p_active[q(j)] && j < f) f = j;
        }
        warp_min2(f, z);
        return f == kImax ? -1 : f;
    }

    __device__ void create(int ts, int bn, float hh) {
        const int fi = first_free_packet();
        if (fi < 0) { ++packets_dropped; return; }
        if (lane == 0) {
            const int j = q(fi);
            s.p_active[j] = 1; s.p_seq[j] = pseq; s.p_ttl[j] = kTtl0;
            s.p_pre_ts[j] = ts; s.p_pre_bin[j] = bn; s.p_pre_h[j] = hh;
            s.p_count[j] = 0;
        }
        ++pseq;
        __syncwarp();
    }

    // A data peak joins packet qi: its TTL refreshed, the peak stored
    // while there is room (packet_peak_overflow otherwise).
    __device__ void add_data(int qi, int ts, int bn, float hh) {
        const int j = q(qi);
        const int cnt = s.p_count[j];
        if (cnt >= p->S) ++peak_over;
        __syncwarp();
        if (lane == 0) {
            s.p_ttl[j] = kTtl0;
            if (cnt < p->S) {
                const size_t e = (size_t)j * p->S + cnt;
                s.p_ts[e] = ts; s.p_bin[e] = bn; s.p_h[e] = hh;
            }
            s.p_count[j] = min(cnt + 1, p->S);
        }
        __syncwarp();
    }

    // pkt_step (:272-310).
    __device__ void pkt_step(int kind, int ts, int bn, float hh) {
        if (kind == 0) {
            create(ts, bn, hh);
        } else if (kind == 1) {
            const int qi = match_packet(ts, hh);
            if (qi >= 0) add_data(qi, ts, bn, hh);
        }
    }

    // pkt_step_split (:319-363).
    __device__ void pkt_step_split(int ctl, int pts, int pbin, float phh,
                                   int dts, int dbin, float dhh) {
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
    // find_and_add_peak (:162-194).
    __device__ void peak_step(int b, float hv, float hsv) {
        const int k = p->k, tol = p->tol, R = p->R;
        const int cur = pmod(k + b - bin_ref, k);
        int mseq = kImax, midx = kImax, free = kImax;
        for (int i = 0; i * 32 < p->K; ++i) {
            const int j = lane + 32 * i;
            if (j >= p->K) break;
            if (s.t_active[t(j)]) {
                const int d = pmod(cur - s.t_bin[t(j)], k);
                if (d <= tol || d >= k - tol) {
                    const int seq = s.t_seq[t(j)];
                    if (seq < mseq || (seq == mseq && j < midx)) {
                        mseq = seq; midx = j;
                    }
                }
            } else if (j < free) {
                free = j;
            }
        }
        warp_min2(mseq, midx);
        int z = 0;
        warp_min2(free, z);
        const bool any_m = midx != kImax, any_f = free != kImax;
        if (!any_m && !any_f) { ++tracks_dropped; return; }
        const bool creating = !any_m;
        if (lane == 0) {
            const int j = t(any_m ? midx : free);
            int cnt0 = 0;
            if (creating) {
                s.t_seq[j] = tseq; s.t_bin[j] = cur; s.t_misses[j] = 0;
            } else {
                cnt0 = s.t_count[j];
            }
            s.t_active[j] = 1; s.t_updated[j] = 1;
            const size_t e = (size_t)j * R + cnt0 % R;
            s.t_ring_ts[e] = ts_ref; s.t_ring_bin[e] = b;
            s.t_ring_h[e] = hv; s.t_ring_hs[e] = hsv;
            if (cnt0 >= kMidLo && cnt0 < kMidLo + kMidN)
                s.t_mid_h[(size_t)j * kMidN + cnt0 - kMidLo] = hv;
            s.t_count[j] = cnt0 + 1;
        }
        if (creating) ++tseq;
        __syncwarp();
    }

    // get_central_peak (:197-241) of track slot j with `count` peaks.
    __device__ void classify(int j, int count, int& kind, int& ats,
                             int& abin, float& ah) const {
        const int R = p->R;
        const size_t base = (size_t)t(j) * R;
        auto at = [&](int i) { return base + pmod(count - kRing + i, R); };
        // DATA: the first argmax of h over the valid entries.
        auto hv = [&](int i) {
            return count - kRing + i >= 0 ? s.t_ring_h[at(i)] : -INFINITY;
        };
        int di = 0;
        float dh = hv(0);
        for (int i = 1; i < kRing; ++i) {
            const float h = hv(i);
            if (h > dh) { dh = h; di = i; }
        }
        // PREAMBLE: the last chirp's apex, walked back (:213-232).
        int r_idx = kRing - kOv;
        float rh = s.t_ring_h[at(r_idx)];
        for (int i = kRing - kOv + 1; i < kRing; ++i) {
            const float h = s.t_ring_h[at(i)];
            if (h > rh) { rh = h; r_idx = i; }
        }
        int start = r_idx;
        bool stop = false;
        for (int it = 0; it < kOv / 2; ++it) {
            const bool in_loop = !stop && start > r_idx - kOv / 2;
            const float prev = s.t_ring_hs[at(max(start - 1, 0))];
            const float here = s.t_ring_hs[at(start)];
            const bool brk = prev > here || here < p->thr;
            if (in_loop && !brk) --start;
            stop = stop || !in_loop || brk;
        }
        int ai = start;
        float ahs = s.t_ring_hs[at(start)];
        for (int i = start + 1; i < kRing; ++i) {
            const float h = s.t_ring_hs[at(i)];
            if (h > ahs) { ahs = h; ai = i; }
        }
        if (count >= kPreMin) {
            kind = 0;
            ats = pmod(s.t_ring_ts[at(ai)] + p->n / 4, p->ts_mod);
            abin = s.t_ring_bin[at(ai)];
            const float* mid = s.t_mid_h + (size_t)t(j) * kMidN;
            float sum = mid[0];
            for (int i = 1; i < kMidN; ++i) sum = __fadd_rn(sum, mid[i]);
            ah = __fdiv_rn(sum, (float)kMidN);
        } else {
            kind = (count >= 2 && count <= kDataMax) ? 1 : 2;
            ats = s.t_ring_ts[at(di)];
            abin = s.t_ring_bin[at(di)];
            ah = s.t_ring_h[at(di)];
        }
    }

    // split_extract (:247-269) of track slot j; returns m_eff.
    __device__ int split_extract(int j, int count, int* sp_ts, int* sp_bin,
                                 float* sp_h, bool* sp_ok) const {
        const int R = p->R, G = p->G, n = p->n, k = p->k, mod = p->ts_mod;
        const size_t base = (size_t)t(j) * R;
        auto at = [&](int i) { return base + pmod(count - R + i, R); };
        float hmax = -INFINITY;
        for (int i = 0; i < R; ++i)
            if (count - R + i >= 0) hmax = fmaxf(hmax, s.t_ring_h[at(i)]);
        const float lim95 = __fmul_rn(0.95f, hmax);
        int ai = 0;
        for (int i = 0; i < R; ++i)
            if (count - R + i >= 0 && s.t_ring_h[at(i)] >= lim95) {
                ai = i;
                break;
            }
        const int ats = s.t_ring_ts[at(ai)];
        float bh[kMaxGroups];
        int bi[kMaxGroups];
        for (int g = 0; g < G; ++g) { bh[g] = -INFINITY; bi[g] = 0; }
        bool any[kMaxGroups] = {};
        for (int i = 0; i < R; ++i) {
            if (count - R + i < 0) continue;
            const int rel = pmod(s.t_ring_ts[at(i)] - ats, mod);
            const int g = (rel + n / 2) / n;
            if (rel > mod / 2 || g >= G) continue;
            const float h = s.t_ring_h[at(i)];
            if (!any[g] || h > bh[g]) { bh[g] = h; bi[g] = i; }
            any[g] = true;
        }
        const float lim70 = __fmul_rn(0.7f, hmax);
        int m_eff = 0;
        for (int g = 0; g < G; ++g) {
            const bool ok = any[g] && bh[g] >= lim70;
            const int snap = pmod(ats + g * n, mod);
            const int dt = pmod(snap - s.t_ring_ts[at(bi[g])] + n / 2, mod)
                - n / 2;
            sp_ts[g] = snap;
            sp_bin[g] = pmod(s.t_ring_bin[at(bi[g])] + pdiv(dt * k, n), k);
            sp_h[g] = ok ? s.t_ring_h[at(bi[g])] : 0.0f;
            sp_ok[g] = ok;
            m_eff += ok;
        }
        return m_eff;
    }

    // One retired candidate's packet entries (:447-486).
    __device__ void retire(int j, int count) {
        int kind, ats, abin;
        float ah;
        classify(j, count, kind, ats, abin, ah);
        if (!p->split) {
            if (kind != 2) pkt_step(kind, ats, abin, ah);
            return;
        }
        int sp_ts[kMaxGroups], sp_bin[kMaxGroups];
        float sp_h[kMaxGroups];
        bool sp_ok[kMaxGroups];
        const int m_eff = split_extract(j, count, sp_ts, sp_bin, sp_h,
                                        sp_ok);
        const bool can = m_eff >= 2;
        const bool cond_a = can && kind == 0 && count < p->R;
        const bool cond_bc =
            can && ((kind == 1 && count > kOv + 2 && count < kPreMin)
                    || (kind == 2 && count > kDataMax && count < kPreMin));
        int fvi = 0;
        for (int g = 0; g < p->G; ++g)
            if (sp_ok[g]) { fvi = g; break; }
        const int ctl0 = cond_a ? 3 : cond_bc ? 0
                         : kind == 0 ? 1 : kind == 1 ? 2 : 0;
        if (ctl0)
            pkt_step_split(ctl0, ats, abin, ah,
                           cond_a ? sp_ts[fvi] : ats,
                           cond_a ? sp_bin[fvi] : abin,
                           cond_a ? sp_h[fvi] : ah);
        for (int g = 0; g < p->G; ++g) {
            const int ctl = !sp_ok[g] ? 0
                            : (cond_a && g == fvi) ? 0
                            : cond_a ? 4 : cond_bc ? 5 : 0;
            if (ctl)
                pkt_step_split(ctl, ats, abin, ah, sp_ts[g], sp_bin[g],
                               sp_h[g]);
        }
    }
};

// Assembly (:366-401) of packet slot qj into the warp's scratch; returns
// its length.  a_ts / a_bin / a_dis hold the packet's peaks sorted by
// normalised timestamp; a_sym the symbols of its windows.
__device__ int assemble(Chan& ch, int qj, int* a_ts, int* a_bin,
                        float* a_dis, int* a_sym) {
    const Params& p = *ch.p;
    const State& s = ch.s;
    const int n = p.n, k = p.k, S = p.S, lane = ch.lane;
    const int j = ch.q(qj);
    const int cnt = s.p_count[j];
    const int pre_ts = s.p_pre_ts[j], pre_bin = s.p_pre_bin[j];
    const float pre_h = s.p_pre_h[j];
    const size_t base = (size_t)j * S;
    // Stable sort of the valid entries by (tsn, index).
    for (int i = lane; i < cnt; i += 32) {
        const int key = pmod(s.p_ts[base + i] - pre_ts, p.ts_mod);
        int rank = 0;
        for (int m = 0; m < cnt; ++m) {
            const int km = pmod(s.p_ts[base + m] - pre_ts, p.ts_mod);
            rank += km < key || (km == key && m < i);
        }
        a_ts[rank] = key;
        a_bin[rank] = s.p_bin[base + i];
        const float dtf = phase(key % n, n);
        a_dis[rank] = __fadd_rn(
            dtf, __fdiv_rn(fabsf(__fsub_rn(s.p_h[base + i], pre_h)), pre_h));
    }
    __syncwarp();
    if (cnt == 0) return 0;
    int len = 0;
    for (int w = 0; w < S + 1; ++w) {
        const int lo = p.lo0 + w * n, hi = lo + n;
        float best = INFINITY;
        int bidx = kImax, z = 0;
        bool found = false, cont = false;
        for (int i = lane; i < cnt; i += 32) {
            const int ts = a_ts[i];
            if (lo < ts && ts < hi) {
                if (!found || before(a_dis[i], best)) {
                    best = a_dis[i]; bidx = i;
                }
                found = true;
            }
            cont |= ts >= hi;
        }
        found = __any_sync(kFull, found);
        cont = __any_sync(kFull, cont);
        warp_min3f(best, z, bidx);
        if (found && lane == 0) {
            const int bts = a_ts[bidx];
            const int shift = (bts % n) * k / n;
            a_sym[w] = ((pmod(a_bin[bidx] - pre_bin - shift, k) + p.qoff)
                        / p.ff) % (k / p.ff);
        } else if (lane == 0) {
            a_sym[w] = 0;
        }
        len = w + 1;
        if (!(found && cont)) break;
    }
    __syncwarp();
    return len;
}

__global__ void __launch_bounds__(32)
tracker_kernel(State s, Params p, const int* __restrict__ bins,
               const float* __restrict__ hh, const float* __restrict__ hss,
               const uint8_t* __restrict__ valid) {
    extern __shared__ int smem[];
    const int M = p.M, S = p.S;
    int* pk_bin = smem;
    float* pk_h = (float*)(pk_bin + M);
    float* pk_hs = pk_h + M;
    int* pk_v = (int*)(pk_hs + M);
    int* a_ts = pk_v + M;
    int* a_bin = a_ts + S;
    float* a_dis = (float*)(a_bin + S);
    int* a_sym = (int*)(a_dis + S);
    int* cand = a_sym + S + 1;

    Chan ch;
    ch.s = s;
    ch.p = &p;
    ch.c = blockIdx.x;
    ch.lane = threadIdx.x;
    const int c = ch.c, lane = ch.lane;
    ch.ts_ref = s.ts_ref[c]; ch.bin_ref = s.bin_ref[c];
    ch.tseq = s.tseq[c]; ch.pseq = s.pseq[c]; ch.o_count = s.o_count[c];
    ch.tracks_dropped = s.tracks_dropped[c];
    ch.packets_dropped = s.packets_dropped[c];
    ch.overflow_fin = s.tracks_overflow_finalized[c];
    ch.fin_def = s.finalize_deferred[c];
    ch.exp_def = s.expire_deferred[c];
    ch.peak_over = s.packet_peak_overflow[c];
    ch.out_over = s.out_overflow[c];
    ch.s_gate = s.s_gate[c];

    for (int hop = 0; hop < p.H; ++hop) {
        __syncwarp();
        // The hop's peaks in ascending bin order, invalid ones last
        // (a stable sort on bin, k + 1 for an invalid peak: :519-528).
        const size_t row = ((size_t)c * p.H + hop) * M;
        for (int i = lane; i < M; i += 32) {
            const int key = valid[row + i] ? bins[row + i] : p.k + 1;
            int rank = 0;
            for (int m = 0; m < M; ++m) {
                const int km = valid[row + m] ? bins[row + m] : p.k + 1;
                rank += km < key || (km == key && m < i);
            }
            pk_bin[rank] = bins[row + i];
            pk_h[rank] = hh[row + i];
            pk_hs[rank] = hss[row + i];
            pk_v[rank] = valid[row + i];
        }
        __syncwarp();
        for (int m = 0; m < M && pk_v[m]; ++m)
            ch.peak_step(pk_bin[m], pk_h[m], pk_hs[m]);

        // Retirement candidates (:407-445): over-cap tracks first, then
        // idle ones, each by t_seq; at most F.
        unsigned over_m = 0, idle_m = 0, keep_m = 0, upd_m = 0;
        for (int i = 0; i * 32 < p.K && i < kMaxSlots; ++i) {
            const int j = lane + 32 * i;
            if (j >= p.K) break;
            const int tj = ch.t(j);
            const bool act = s.t_active[tj];
            const int cnt = s.t_count[tj];
            const bool upd = s.t_updated[tj];
            const bool over = act && cnt >= p.max_track_peaks;
            const bool graced = s.t_misses[tj] < p.grace && cnt > kDataMax;
            const bool idle = act && !over && !upd && !graced;
            over_m |= (unsigned)over << i;
            idle_m |= (unsigned)idle << i;
            keep_m |= (unsigned)(act && !over && !idle) << i;
            upd_m |= (unsigned)upd << i;
        }
        const int n_over = warp_sum(__popc(over_m));
        const int n_idle = warp_sum(__popc(idle_m));
        const int nc = min(n_over + n_idle, p.F);
        ch.fin_def += max(n_over + n_idle - p.F, 0);
        ch.overflow_fin += min(n_over, nc);
        unsigned taken = 0;
        for (int f = 0; f < nc; ++f) {
            // (over-cap first, t_seq, slot): io then ii of :417-421.
            int cls = kImax, seq = kImax, idx = kImax;
            for (int i = 0; i * 32 < p.K && i < kMaxSlots; ++i) {
                const int j = lane + 32 * i;
                if (j >= p.K) break;
                const unsigned bit = 1u << i;
                if ((taken & bit) || !((over_m | idle_m) & bit)) continue;
                const int c2 = (over_m & bit) ? 0 : 1;
                const int s2 = s.t_seq[ch.t(j)];
                if (c2 < cls || (c2 == cls && (s2 < seq
                                               || (s2 == seq && j < idx)))) {
                    cls = c2; seq = s2; idx = j;
                }
            }
            warp_min3(cls, seq, idx);
            if ((idx & 31) == lane) taken |= 1u << (idx >> 5);
            if (lane == 0) cand[f] = idx;
        }
        // Retire the candidates and age the kept tracks.
        for (int i = 0; i * 32 < p.K && i < kMaxSlots; ++i) {
            const int j = lane + 32 * i;
            if (j >= p.K) break;
            const unsigned bit = 1u << i;
            const int tj = ch.t(j);
            if (taken & bit) s.t_active[tj] = 0;
            if (keep_m & bit) {
                s.t_misses[tj] = (upd_m & bit) ? 0 : s.t_misses[tj] + 1;
                s.t_updated[tj] = 0;
            }
        }
        __syncwarp();
        for (int f = 0; f < nc; ++f) {
            const int j = cand[f];
            ch.retire(j, s.t_count[ch.t(j)]);
        }

        // TTL expiry and assembly (:488-513), at most E by p_seq.
        unsigned exp_m = 0;
        for (int i = 0; i * 32 < p.Q && i < kMaxSlots; ++i) {
            const int j = lane + 32 * i;
            if (j >= p.Q) break;
            exp_m |= (unsigned)(s.p_active[ch.q(j)]
                                && s.p_ttl[ch.q(j)] <= 0) << i;
        }
        const int n_exp = warp_sum(__popc(exp_m));
        const int ne = min(n_exp, p.E);
        ch.exp_def += max(n_exp - p.E, 0);
        unsigned done = 0;
        int emitted = 0;
        for (int e = 0; e < ne; ++e) {
            int key = kImax, idx = kImax;
            for (int i = 0; i * 32 < p.Q && i < kMaxSlots; ++i) {
                const int j = lane + 32 * i;
                if (j >= p.Q) break;
                const unsigned bit = 1u << i;
                if (!(exp_m & bit) || (done & bit)) continue;
                const int seq = s.p_seq[ch.q(j)];
                if (seq < key || (seq == key && j < idx)) {
                    key = seq; idx = j;
                }
            }
            warp_min2(key, idx);
            if ((idx & 31) == lane) done |= 1u << (idx >> 5);
            const int len = assemble(ch, idx, a_ts, a_bin, a_dis, a_sym);
            if (len >= 8) {
                const int slot = ch.o_count + emitted;
                if (slot < p.O) {
                    const int W = S + 1;
                    int* out = s.o_syms + ((size_t)c * p.O + slot) * W;
                    for (int w = lane; w < W; w += 32)
                        out[w] = w < len ? a_sym[w] : 0;
                    if (lane == 0) {
                        s.o_len[c * p.O + slot] = len;
                        s.o_pos[c * p.O + slot] = s.p_pre_ts[ch.q(idx)];
                    }
                } else {
                    ++ch.out_over;
                }
                ++emitted;
            }
            __syncwarp();
        }
        ch.o_count = min(ch.o_count + emitted, p.O);
        for (int i = 0; i * 32 < p.Q && i < kMaxSlots; ++i) {
            const int j = lane + 32 * i;
            if (j >= p.Q) break;
            const int qj = ch.q(j);
            if (done & (1u << i)) s.p_active[qj] = 0;
            if (s.p_active[qj] && s.p_ttl[qj] > 0) --s.p_ttl[qj];
        }
        __syncwarp();
        ch.ts_ref = (ch.ts_ref + p.hop) % p.ts_mod;
        ch.bin_ref = (ch.bin_ref + p.k / kOv) % p.k;
    }
    if (lane == 0) {
        s.ts_ref[c] = ch.ts_ref; s.bin_ref[c] = ch.bin_ref;
        s.tseq[c] = ch.tseq; s.pseq[c] = ch.pseq; s.o_count[c] = ch.o_count;
        s.tracks_dropped[c] = ch.tracks_dropped;
        s.packets_dropped[c] = ch.packets_dropped;
        s.tracks_overflow_finalized[c] = ch.overflow_fin;
        s.finalize_deferred[c] = ch.fin_def;
        s.expire_deferred[c] = ch.exp_def;
        s.packet_peak_overflow[c] = ch.peak_over;
        s.out_overflow[c] = ch.out_over;
        s.s_gate[c] = ch.s_gate;
    }
}

}  // namespace

extern "C" int grl_device_tracker(void* const* fields, const int* params,
                                  float thr, const void* bins,
                                  const void* h, const void* hs,
                                  const void* valid, void* stream) {
    State s;
    void** dst = reinterpret_cast<void**>(&s);
    for (int i = 0; i < kFields; ++i) dst[i] = fields[i];
    Params p;
    int* pi = &p.C;
    for (int i = 0; i < 22; ++i) pi[i] = params[i];
    p.thr = thr;
    const size_t smem = sizeof(int) * (4 * p.M + 4 * p.S + 1 + kMaxFinalize);
    tracker_kernel<<<p.C, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        s, p, static_cast<const int*>(bins), static_cast<const float*>(h),
        static_cast<const float*>(hs), static_cast<const uint8_t*>(valid));
    return (int)cudaGetLastError();
}
