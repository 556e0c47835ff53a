// Single-producer single-consumer lock-free byte ring buffer.
//
// The port's own copy of native/src/ring_buffer.cc, built with the host
// C++ compiler by gr_lora_tpu_torch/native; it backs
// gr_lora_tpu_torch/pipeline/ingest.RingIngest.
//
// The host-runtime analog of the GNU Radio stream ring buffers that connect
// blocks in the reference's scheduler (one thread per block).  Acquire/
// release atomics on the read/write cursors make write() safe from one
// thread and read()/peek() from another with no locks.

#include "lora_host.h"

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <cstring>
#include <new>

struct lora_ring {
  uint8_t* buf;
  size_t cap;                       // power of two
  std::atomic<size_t> head{0};      // write cursor (total bytes written)
  std::atomic<size_t> tail{0};      // read cursor (total bytes read)
};

static size_t round_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

extern "C" {

lora_ring* lora_ring_create(size_t capacity_bytes) {
  if (capacity_bytes == 0) return nullptr;
  auto* rb = new (std::nothrow) lora_ring();
  if (!rb) return nullptr;
  rb->cap = round_pow2(capacity_bytes);
  rb->buf = static_cast<uint8_t*>(std::malloc(rb->cap));
  if (!rb->buf) {
    delete rb;
    return nullptr;
  }
  return rb;
}

void lora_ring_destroy(lora_ring* rb) {
  if (!rb) return;
  std::free(rb->buf);
  delete rb;
}

size_t lora_ring_capacity(const lora_ring* rb) { return rb->cap; }

size_t lora_ring_readable(const lora_ring* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

size_t lora_ring_writable(const lora_ring* rb) {
  return rb->cap - lora_ring_readable(rb);
}

size_t lora_ring_write(lora_ring* rb, const uint8_t* data, size_t n) {
  const size_t head = rb->head.load(std::memory_order_relaxed);
  const size_t tail = rb->tail.load(std::memory_order_acquire);
  const size_t space = rb->cap - (head - tail);
  if (n > space) n = space;
  const size_t mask = rb->cap - 1;
  const size_t first = std::min(n, rb->cap - (head & mask));
  std::memcpy(rb->buf + (head & mask), data, first);
  std::memcpy(rb->buf, data + first, n - first);
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

static size_t copy_out(const lora_ring* rb, uint8_t* out, size_t n,
                       size_t tail) {
  const size_t mask = rb->cap - 1;
  const size_t first = std::min(n, rb->cap - (tail & mask));
  std::memcpy(out, rb->buf + (tail & mask), first);
  std::memcpy(out + first, rb->buf, n - first);
  return n;
}

size_t lora_ring_read(lora_ring* rb, uint8_t* out, size_t n) {
  const size_t tail = rb->tail.load(std::memory_order_relaxed);
  const size_t head = rb->head.load(std::memory_order_acquire);
  const size_t avail = head - tail;
  if (n > avail) n = avail;
  copy_out(rb, out, n, tail);
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

size_t lora_ring_peek(const lora_ring* rb, uint8_t* out, size_t n) {
  const size_t tail = rb->tail.load(std::memory_order_relaxed);
  const size_t head = rb->head.load(std::memory_order_acquire);
  const size_t avail = head - tail;
  if (n > avail) n = avail;
  return copy_out(rb, out, n, tail);
}

}  // extern "C"
