/* C API of the port's host tracker library (the tracker part of the JAX
 * package's native/include/lora_host.h, unchanged).
 *
 * The card owns the signal-processing compute; this library owns the
 * packet-rate peak tracking around it, as the reference keeps it in C++.
 * Exposed as a flat C ABI for ctypes binding (gr_lora_tpu_torch/native).
 */

#ifndef GR_LORA_TPU_TORCH_LORA_HOST_H
#define GR_LORA_TPU_TORCH_LORA_HOST_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- Pyramid peak-track / packet state machine (host fast path;
 * behavior-identical to the JAX package's models/pyramid.PyramidTracker). ---- */
typedef struct lora_pyramid lora_pyramid;

/* grace: consecutive idle hops a preamble-length track may survive
 * (0 = exact reference behavior).  split_repeats: split merged
 * adjacent-equal-symbol tracks into per-symbol data peaks (opt-in,
 * beyond-reference). */
/* quantize_round: 1 = rounded bin->symbol assembly (product default);
 * 0 = bit-true reference floor rule (pyramid_demod_impl.cc:744). */
lora_pyramid* lora_pyramid_create(int32_t sf, int32_t p, int32_t fft_factor,
                                  int32_t ldr, float threshold,
                                  int32_t grace, int32_t split_repeats,
                                  int32_t quantize_round);
void lora_pyramid_destroy(lora_pyramid* t);
/* Feed one hop's extracted peaks, sorted ascending by bin (pass npeaks=0
 * for an empty hop). */
void lora_pyramid_step(lora_pyramid* t, const int32_t* bins, const float* h,
                       const float* h_single, int32_t npeaks);
int32_t lora_pyramid_pending(const lora_pyramid* t);
/* Pop one finished packet's symbols; returns count, -1 empty, -2 cap. */
int32_t lora_pyramid_pop(lora_pyramid* t, uint16_t* dst, int32_t cap);
/* As pop, also yielding the packet's preamble timestamp (sample index mod
 * 2^28; ts may be NULL). */
int32_t lora_pyramid_pop_ts(lora_pyramid* t, uint16_t* dst, int32_t cap,
                            int64_t* ts);
/* Empty hops needed to retire all tracks and expire all TTLs. */
int32_t lora_pyramid_flush_hops(const lora_pyramid* t);
/* Graceful-degradation counters: {tracks_dropped, packets_dropped,
 * tracks_overflow_finalized}.  The reference exit(-1)s on pool exhaustion
 * (pyramid_demod_impl.cc:256-260); we drop + count instead. */
void lora_pyramid_stats(const lora_pyramid* t, int64_t* out3);

/* ---- Multi-channel tracker bank: C independent trackers advanced from one
 * batched [C, H, M] peak-lattice block per call (gateway-scale path). ---- */
typedef struct lora_pyramid_multi lora_pyramid_multi;

lora_pyramid_multi* lora_pyramid_multi_create(int32_t channels, int32_t sf,
                                              int32_t p, int32_t fft_factor,
                                              int32_t ldr, float threshold,
                                              int32_t grace,
                                              int32_t split_repeats,
                                              int32_t quantize_round);
void lora_pyramid_multi_destroy(lora_pyramid_multi* m);
/* bins/h/h_single float32/int32 [C, H, M] row-major, valid uint8 [C, H, M];
 * advances every channel tracker by H hops. */
void lora_pyramid_multi_feed(lora_pyramid_multi* m, const int32_t* bins,
                             const float* h, const float* h_single,
                             const uint8_t* valid, int32_t channels,
                             int32_t hops, int32_t max_peaks);
int32_t lora_pyramid_multi_pending(const lora_pyramid_multi* m,
                                   int32_t channel);
int32_t lora_pyramid_multi_pop(lora_pyramid_multi* m, int32_t channel,
                               uint16_t* dst, int32_t cap);
int32_t lora_pyramid_multi_pop_ts(lora_pyramid_multi* m, int32_t channel,
                                  uint16_t* dst, int32_t cap, int64_t* ts);
int32_t lora_pyramid_multi_flush_hops(const lora_pyramid_multi* m);
void lora_pyramid_multi_stats(const lora_pyramid_multi* m, int64_t* out3);

#ifdef __cplusplus
}
#endif

#endif /* GR_LORA_TPU_TORCH_LORA_HOST_H */
