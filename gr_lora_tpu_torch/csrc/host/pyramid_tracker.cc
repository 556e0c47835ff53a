// Pyramid peak-track / packet state machine, host-native fast path.
//
// The port's own copy of native/src/pyramid_tracker.cc, built with the
// host C++ compiler by gr_lora_tpu_torch/native (tests/test_torch_core.py
// holds its drains equal to the JAX package's native tracker's).
//
// Behavior-identical to gr_lora_tpu.models.pyramid.PyramidTracker (the
// Python implementation is the executable spec; both trace to the reference
// algorithm: pyramid_demod_impl.cc:225-525 find/classify/cluster and
// :610-767 TTL-expiry assembly).  Cross-checked peak-for-peak against the
// Python tracker in tests/test_native_pyramid.py.

#include "lora_host.h"

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <deque>
#include <limits>
#include <map>
#include <thread>
#include <vector>

namespace {

constexpr int64_t TS_MOD = 1 << 28;
constexpr int OVERLAPS = 8;
constexpr int NUM_PREAMBLE = 6;

inline int64_t pmod(int64_t x, int64_t n) { return ((x % n) + n) % n; }

struct Peak {
  int64_t ts;
  int32_t bin;
  float h;
  float h_single;
};

struct Track {
  int32_t bin;  // drift-corrected bin at creation
  std::vector<Peak> peaks;
  bool updated = true;
  int32_t misses = 0;  // consecutive idle hops (grace mode)
};

struct Packet {
  std::vector<Peak> peaks;  // [0] is the preamble pseudo-peak
  int32_t ttl;
};

}  // namespace

// Pool bounds: the reference uses fixed pools of 1000 tracks / 40 packets
// and calls exit(-1) on exhaustion (pyramid_demod_impl.cc:111-130,256-260).
// Here exhaustion degrades gracefully (drop + count) and a per-track peak
// cap bounds memory against pathological inputs (e.g. a CW interferer whose
// track never idles, hence never finalizes): a track hitting the cap is
// finalized immediately, exactly as if it had gone idle.
constexpr int MAX_TRACKS = 1000;
constexpr int MAX_PACKETS = 40;
constexpr int MAX_TRACK_PEAKS = 256;

struct lora_pyramid {
  int n;              // samples per symbol
  int k;              // bin_size
  int fft_factor;
  int bin_tolerance;
  float threshold;
  int grace;
  int split_repeats;  // models/pyramid.py split_repeats (opt-in)
  int quantize_round; // 1 = rounded bin->symbol (default); 0 = bit-true
                      // reference floor rule (pyramid_demod_impl.cc:744)
  int ttl0 = 6 * OVERLAPS;
  int hop;
  int64_t ts_ref = 0;
  int32_t bin_ref = 0;
  std::vector<Track> tracks;
  std::vector<Packet> packets;
  std::deque<std::vector<uint16_t>> out;
  std::deque<int64_t> out_ts;  // preamble timestamp (samples) per packet
  // Graceful-degradation counters (visible via lora_pyramid_stats).
  int64_t tracks_dropped = 0;
  int64_t packets_dropped = 0;
  int64_t tracks_overflow_finalized = 0;

  lora_pyramid(int sf, int p, int ff, int ldr, float thr, int grc,
               int spl = 0, int qround = 1)
      : n(p << sf),
        k(ff << sf),
        fft_factor(ff),
        bin_tolerance(ldr ? ff * 2 : ff / 2),
        threshold(thr),
        grace(grc),
        split_repeats(spl),
        quantize_round(qround),
        hop((p << sf) / OVERLAPS) {}

  // find_and_add_peak (:225-272): peaks must arrive sorted by bin.
  void add_peaks(const int32_t* bins, const float* h, const float* hs,
                 int np) {
    for (int i = 0; i < np; i++) {
      const int32_t cur_bin = (int32_t)pmod(k + bins[i] - bin_ref, k);
      Track* match = nullptr;
      for (auto& tr : tracks) {
        const int64_t dis = pmod(k + cur_bin - tr.bin, k);
        if (dis <= bin_tolerance || dis >= k - bin_tolerance) {
          match = &tr;
          tr.updated = true;
          break;
        }
      }
      if (!match) {
        if ((int)tracks.size() >= MAX_TRACKS) {
          tracks_dropped++;
          continue;
        }
        tracks.push_back(Track{cur_bin, {}, true});
        match = &tracks.back();
      }
      match->peaks.push_back(Peak{ts_ref, bins[i], h[i], hs[i]});
    }
    // Peak-cap overflow: finalize as if idle (bounds per-track memory; a
    // normal packet track never exceeds ~50 peaks, only a persistent
    // interferer does).
    for (size_t t = 0; t < tracks.size();) {
      if ((int)tracks[t].peaks.size() >= MAX_TRACK_PEAKS) {
        retire_track(tracks[t]);
        tracks_overflow_finalized++;
        tracks.erase(tracks.begin() + t);
      } else {
        t++;
      }
    }
  }

  // models/pyramid.py _split_repeat_track (split_repeats, opt-in): one
  // merged m-repeat track -> m data peaks at exact one-symbol strides
  // from the rising-edge apex, grouped by whole-symbol ts offset (covers
  // adjacent AND gapped same-value runs), gated on the plateau height.
  void split_repeat_track(const Track& tr, int cap, int floor_,
                          std::vector<Peak>* out) const {
    const auto& pk = tr.peaks;
    const int ln = (int)pk.size();
    out->clear();
    if (ln <= floor_ || ln >= cap) return;
    float hmax = 0;
    for (const auto& p : pk) hmax = std::max(hmax, p.h);
    int apex_idx = 0;
    while (pk[apex_idx].h < 0.95f * hmax) apex_idx++;
    const Peak apex_pk = pk[apex_idx];
    // Each group emits its own best RECORDED peak (self-consistent
    // ts/bin — adjacent-VALUE merges carry the second symbol's true bin
    // only in its own apex); see the Python twin.
    std::map<int, Peak> best;
    for (const auto& p : pk) {
      const int64_t rel = pmod(p.ts - apex_pk.ts, TS_MOD);
      if (rel > TS_MOD / 2) continue;  // rising skirt before the apex
      const int g = (int)((rel + n / 2) / n);  // half-up, as in Python
      auto it = best.find(g);
      if (it == best.end() || p.h > it->second.h) best[g] = p;
    }
    // Snap to exact one-symbol spacing from the apex and rotate the bin
    // by the ts delta (k/n bins per sample) — see the Python twin.
    for (const auto& gb : best) {
      const Peak& p = gb.second;
      if (p.h < 0.7f * hmax) continue;
      const int64_t snap = pmod(apex_pk.ts + (int64_t)gb.first * n, TS_MOD);
      const int64_t dt = pmod(snap - p.ts + n / 2, TS_MOD) - n / 2;
      const int32_t bn =
          (int32_t)pmod(p.bin + dt * (int64_t)k / n, k);
      out->push_back(Peak{snap, bn, p.h, p.h_single});
    }
    if ((int)out->size() < 2) out->clear();
  }

  // models/pyramid.py _retire_track: classification + (opt-in) repeat
  // splitting, incl. the preamble-length-run phase disambiguation and
  // the exactly-2*ov DATA double.
  void retire_track(Track& tr) {
    Peak pk;
    const int st = central_peak(tr, &pk);
    std::vector<Peak> pks;
    const int pre_cap = OVERLAPS * (NUM_PREAMBLE - 1) + 2;
    if (split_repeats && st == 0 &&
        (int)tr.peaks.size() < OVERLAPS * (NUM_PREAMBLE + 1)) {
      split_repeat_track(tr, OVERLAPS * (NUM_PREAMBLE + 1), 2 * OVERLAPS,
                         &pks);
      if (!pks.empty() && add_symbol(pks[0], 1)) {
        for (size_t i = 1; i < pks.size(); i++) add_symbol(pks[i], 1);
        return;
      }
    }
    if (split_repeats && st == 1 && (int)tr.peaks.size() > OVERLAPS + 2) {
      split_repeat_track(tr, pre_cap, OVERLAPS + 2, &pks);
      if ((int)pks.size() >= 2) {
        for (const auto& p : pks) add_symbol(p, 1);
        return;
      }
    }
    if (st == 0 || st == 1) {
      add_symbol(pk, st);
    } else if (split_repeats) {
      split_repeat_track(tr, pre_cap, 2 * OVERLAPS, &pks);
      for (const auto& p : pks) add_symbol(p, 1);
    }
  }

  // get_apex SEGMENT (:274-317).
  static Peak apex(const std::vector<Peak>& pk, size_t lo, bool is_pre) {
    size_t best = lo;
    float bh = is_pre ? pk[lo].h_single : pk[lo].h;
    for (size_t i = lo + 1; i < pk.size(); i++) {
      const float v = is_pre ? pk[i].h_single : pk[i].h;
      if (v > bh) {
        bh = v;
        best = i;
      }
    }
    return Peak{pk[best].ts, pk[best].bin, bh, pk[best].h_single};
  }

  // get_central_peak (:319-391). Returns 0=preamble, 1=data, 2=broken.
  int central_peak(const Track& tr, Peak* out_pk) {
    const auto& pk = tr.peaks;
    const int ln = (int)pk.size();
    if (ln >= OVERLAPS * (NUM_PREAMBLE - 1) + 2) {
      int r_idx = ln - OVERLAPS;
      float max_h = -1;
      for (int i = ln - OVERLAPS; i < ln; i++) {
        if (pk[i].h > max_h) {
          max_h = pk[i].h;
          r_idx = i;
        }
      }
      int start_idx = r_idx;
      while (start_idx > r_idx - OVERLAPS / 2) {
        if (pk[start_idx - 1].h_single > pk[start_idx].h_single ||
            pk[start_idx].h_single < threshold)
          break;
        start_idx--;
      }
      Peak p = apex(pk, start_idx, true);
      p.ts = pmod(p.ts + n / 4, TS_MOD);  // SFD-gap fix (:371)
      double sum = 0;
      for (int i = 2 * OVERLAPS; i < OVERLAPS * (NUM_PREAMBLE - 2); i++)
        sum += pk[i].h;
      p.h = (float)(sum / (OVERLAPS * (NUM_PREAMBLE - 4)));
      *out_pk = p;
      return 0;
    }
    if (ln >= 2 && ln <= 2 * OVERLAPS) {
      *out_pk = apex(pk, 0, false);
      return 1;
    }
    return 2;
  }

  // get_dis (:187-196).
  float get_dis(int64_t ts1, float h1, int64_t ts2, float h2) const {
    float dis = (float)pmod(ts1 - ts2, n) / (float)n;
    dis = dis > 0.5f ? (1 - dis) * 2 : dis * 2;
    dis += std::fabs(h1 - h2) / h2;
    return dis;
  }

  // add_symbol_to_packet (:393-473).
  bool add_symbol(const Peak& pk, int st) {
    if (st == 0) {
      if ((int)packets.size() >= MAX_PACKETS) {
        packets_dropped++;
        return false;
      }
      packets.push_back(Packet{{pk}, ttl0});
      return true;
    }
    Packet* best = nullptr;
    float min_dis = std::numeric_limits<float>::infinity();
    for (auto& packet : packets) {
      const int64_t ts_dis = pmod(pk.ts - packet.peaks[0].ts, TS_MOD);
      if (!(ts_dis > 4 * (int64_t)n && ts_dis < TS_MOD / 2)) continue;
      float dis = (float)pmod(ts_dis, n) / (float)n;
      dis = dis > 0.5f ? (1 - dis) * 2 : dis * 2;
      const float h_dis =
          std::fabs(packet.peaks[0].h - pk.h) / packet.peaks[0].h;
      if (dis < min_dis && h_dis < 0.5f) {
        best = &packet;
        min_dis = dis;
      }
    }
    if (!best) return false;
    best->ttl = ttl0;
    best->peaks.push_back(pk);
    return true;
  }

  // check_and_update_track (:475-525).
  void finish_idle_tracks() {
    std::vector<Track> keep;
    keep.reserve(tracks.size());
    for (auto& tr : tracks) {
      if (tr.updated) {
        tr.updated = false;
        tr.misses = 0;
        keep.push_back(std::move(tr));
        continue;
      }
      // Grace (beyond-reference): only preamble-length tracks may idle.
      if (tr.misses < grace && (int)tr.peaks.size() > 2 * OVERLAPS) {
        tr.misses++;
        keep.push_back(std::move(tr));
        continue;
      }
      retire_track(tr);
    }
    tracks = std::move(keep);
  }

  // TTL-expiry assembly (:610-767).
  void assemble(Packet& packet) {
    auto& pkt = packet.peaks;
    const int64_t pre_ts = pkt[0].ts;
    const int32_t pre_bin = pkt[0].bin;
    const float pre_h = pkt[0].h;
    for (auto& p : pkt) p.ts = pmod(p.ts - pre_ts, TS_MOD);
    std::stable_sort(pkt.begin(), pkt.end(),
                     [](const Peak& a, const Peak& b) { return a.ts < b.ts; });
    std::vector<uint16_t> symbols;
    int64_t lo = 4 * (int64_t)n + n / 2;
    size_t start_idx = 1;
    while (start_idx < pkt.size()) {
      bool is_first = true, found = false;
      size_t end_idx = start_idx;
      while (end_idx < pkt.size()) {
        const bool in_win = pkt[end_idx].ts > lo && pkt[end_idx].ts < lo + n;
        if (is_first) {
          if (in_win) {
            start_idx = end_idx;
            is_first = false;
            found = true;
          }
        } else if (!in_win) {
          break;
        }
        end_idx++;
      }
      if (found) {
        size_t idx = start_idx;
        float min_dis = std::numeric_limits<float>::infinity();
        for (size_t i = start_idx; i < end_idx; i++) {
          const float dis = get_dis(pkt[i].ts, pkt[i].h, 0, pre_h);
          if (dis < min_dis) {
            min_dis = dis;
            idx = i;
          }
        }
        const int64_t bin_shift = pmod(pkt[idx].ts, n) * k / n;
        const int64_t b = pmod(pkt[idx].bin - pre_bin - bin_shift, k);
        // Round, don't floor (deliberate deviation; see the Python twin
        // models/pyramid.py _assemble): absorbs the hop-grid apex
        // quantization error instead of flipping the symbol at ff-bin
        // boundaries.  quantize_round=0 restores the bit-true reference
        // floor rule (pyramid_demod_impl.cc:744).
        const int64_t qoff = quantize_round ? fft_factor / 2 : 0;
        symbols.push_back(
            (uint16_t)(((b + qoff) / fft_factor) % (k / fft_factor)));
      } else {
        symbols.push_back(0);
      }
      start_idx = end_idx;
      lo = pmod(lo + n, TS_MOD);
    }
    if (symbols.size() >= 8) {
      out.push_back(std::move(symbols));
      out_ts.push_back(pre_ts);
    }
  }

  void step(const int32_t* bins, const float* h, const float* hs, int np) {
    add_peaks(bins, h, hs, np);
    finish_idle_tracks();
    std::vector<Packet> live;
    live.reserve(packets.size());
    for (auto& packet : packets) {
      if (packet.ttl <= 0)
        assemble(packet);
      else
        live.push_back(std::move(packet));
    }
    packets = std::move(live);
    for (auto& packet : packets) packet.ttl -= 1;
    ts_ref = pmod(ts_ref + hop, TS_MOD);
    bin_ref = (int32_t)pmod(bin_ref + k / OVERLAPS, k);
  }
};

extern "C" {

lora_pyramid* lora_pyramid_create(int32_t sf, int32_t p, int32_t fft_factor,
                                  int32_t ldr, float threshold,
                                  int32_t grace, int32_t split_repeats,
                                  int32_t quantize_round) {
  return new lora_pyramid(sf, p, fft_factor, ldr, threshold, grace,
                          split_repeats, quantize_round);
}

void lora_pyramid_destroy(lora_pyramid* t) { delete t; }

void lora_pyramid_step(lora_pyramid* t, const int32_t* bins, const float* h,
                       const float* h_single, int32_t npeaks) {
  t->step(bins, h, h_single, npeaks);
}

int32_t lora_pyramid_pending(const lora_pyramid* t) {
  return (int32_t)t->out.size();
}

int32_t lora_pyramid_pop(lora_pyramid* t, uint16_t* dst, int32_t cap) {
  if (t->out.empty()) return -1;
  const auto& s = t->out.front();
  const int32_t nsc = (int32_t)s.size();
  if (nsc > cap) return -2;
  std::memcpy(dst, s.data(), nsc * sizeof(uint16_t));
  t->out.pop_front();
  t->out_ts.pop_front();
  return nsc;
}

/* As lora_pyramid_pop, but also yields the packet's preamble timestamp
 * (absolute sample index modulo TS_MOD; the reference publishes symbol
 * PDUs without position — this is the gateway-side extension). */
int32_t lora_pyramid_pop_ts(lora_pyramid* t, uint16_t* dst, int32_t cap,
                            int64_t* ts) {
  if (t->out.empty()) return -1;
  const auto& s = t->out.front();
  const int32_t nsc = (int32_t)s.size();
  if (nsc > cap) return -2;
  std::memcpy(dst, s.data(), nsc * sizeof(uint16_t));
  if (ts) *ts = t->out_ts.front();
  t->out.pop_front();
  t->out_ts.pop_front();
  return nsc;
}

int32_t lora_pyramid_flush_hops(const lora_pyramid* t) {
  (void)t;
  return (NUM_PREAMBLE + 3) * OVERLAPS + 6 * OVERLAPS + 2;
}

void lora_pyramid_stats(const lora_pyramid* t, int64_t* out3) {
  out3[0] = t->tracks_dropped;
  out3[1] = t->packets_dropped;
  out3[2] = t->tracks_overflow_finalized;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-channel tracker bank: C independent trackers advanced from ONE
// batched device transfer per time block (the per-hop ctypes chatter of a
// Python loop would dominate at gateway channel counts).  Feed layout
// matches models.pyramid.make_peak_lattice output batched over channels.
// ---------------------------------------------------------------------------

struct lora_pyramid_multi {
  std::vector<lora_pyramid> banks;

  lora_pyramid_multi(int ch, int sf, int p, int ff, int ldr, float thr,
                     int grc, int spl, int qround) {
    banks.reserve(ch);
    for (int c = 0; c < ch; c++)
      banks.emplace_back(sf, p, ff, ldr, thr, grc, spl, qround);
  }
};

extern "C" {

lora_pyramid_multi* lora_pyramid_multi_create(int32_t channels, int32_t sf,
                                              int32_t p, int32_t fft_factor,
                                              int32_t ldr, float threshold,
                                              int32_t grace,
                                              int32_t split_repeats,
                                              int32_t quantize_round) {
  return new lora_pyramid_multi(channels, sf, p, fft_factor, ldr, threshold,
                                grace, split_repeats, quantize_round);
}

void lora_pyramid_multi_destroy(lora_pyramid_multi* m) { delete m; }

namespace {

// One channel's tracker walk over a whole block of hops.
void feed_channel(lora_pyramid& bank, const int32_t* bins, const float* h,
                  const float* h_single, const uint8_t* valid, size_t c,
                  int hops, int max_peaks) {
  std::vector<int> idx;
  std::vector<int32_t> sb(max_peaks);
  std::vector<float> sh(max_peaks), ss(max_peaks);
  for (int t = 0; t < hops; t++) {
    const size_t base = (c * hops + t) * max_peaks;
    idx.clear();
    for (int i = 0; i < max_peaks; i++)
      if (valid[base + i]) idx.push_back(i);
    if (idx.empty()) {
      bank.step(nullptr, nullptr, nullptr, 0);
      continue;
    }
    std::sort(idx.begin(), idx.end(), [&](int a, int b) {
      return bins[base + a] < bins[base + b];
    });
    const int np = (int)idx.size();
    for (int i = 0; i < np; i++) {
      sb[i] = bins[base + idx[i]];
      sh[i] = h[base + idx[i]];
      ss[i] = h_single[base + idx[i]];
    }
    bank.step(sb.data(), sh.data(), ss.data(), np);
  }
}

}  // namespace

// bins/h/h_single: [C, H, M] row-major; valid: uint8 [C, H, M].
// Advances every channel's tracker by H hops.  Valid peaks are re-sorted
// ascending by bin per hop (the reference scans bins in ascending order,
// pyramid_demod_impl.cc:227; the lattice emits them height-ordered).
// Channels are embarrassingly parallel (each bank is independent state),
// so the walk fans out over a work-stealing thread team — tracker wall time
// scales with channels / cores instead of linearly with channels.
void lora_pyramid_multi_feed(lora_pyramid_multi* m, const int32_t* bins,
                             const float* h, const float* h_single,
                             const uint8_t* valid, int32_t channels,
                             int32_t hops, int32_t max_peaks) {
  const int nch = std::min<int>(channels, (int)m->banks.size());
  if (nch <= 0) return;
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int nthreads = (int)std::min<unsigned>(hw, (unsigned)nch);
  if (nthreads <= 1) {
    for (int c = 0; c < nch; c++)
      feed_channel(m->banks[c], bins, h, h_single, valid, (size_t)c, hops,
                   max_peaks);
    return;
  }
  // Atomic work queue: channel costs vary (idle vs packet-dense), so
  // dynamic stealing beats static striping.
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int c = next.fetch_add(1, std::memory_order_relaxed);
      if (c >= nch) return;
      feed_channel(m->banks[c], bins, h, h_single, valid, (size_t)c, hops,
                   max_peaks);
    }
  };
  std::vector<std::thread> team;
  team.reserve(nthreads - 1);
  for (int i = 0; i < nthreads - 1; i++) team.emplace_back(worker);
  worker();
  for (auto& t : team) t.join();
}

int32_t lora_pyramid_multi_pending(const lora_pyramid_multi* m,
                                   int32_t channel) {
  if (channel < 0 || channel >= (int32_t)m->banks.size()) return -1;
  return (int32_t)m->banks[channel].out.size();
}

int32_t lora_pyramid_multi_pop(lora_pyramid_multi* m, int32_t channel,
                               uint16_t* dst, int32_t cap) {
  if (channel < 0 || channel >= (int32_t)m->banks.size()) return -1;
  return lora_pyramid_pop(&m->banks[channel], dst, cap);
}

int32_t lora_pyramid_multi_pop_ts(lora_pyramid_multi* m, int32_t channel,
                                  uint16_t* dst, int32_t cap, int64_t* ts) {
  if (channel < 0 || channel >= (int32_t)m->banks.size()) return -1;
  return lora_pyramid_pop_ts(&m->banks[channel], dst, cap, ts);
}

int32_t lora_pyramid_multi_flush_hops(const lora_pyramid_multi* m) {
  return m->banks.empty() ? 0 : lora_pyramid_flush_hops(&m->banks[0]);
}

void lora_pyramid_multi_stats(const lora_pyramid_multi* m, int64_t* out3) {
  out3[0] = out3[1] = out3[2] = 0;
  for (const auto& b : m->banks) {
    out3[0] += b.tracks_dropped;
    out3[1] += b.packets_dropped;
    out3[2] += b.tracks_overflow_finalized;
  }
}

}  // extern "C"
