// Bit-exact LoRa bit-level codec, host-native path.
//
// The port's own copy of native/src/lora_codec.cc, built with the host
// C++ compiler by gr_lora_tpu_torch/native (tests/test_torch_native_codec.py
// holds it equal to the port's NumPy core and the JAX package's library).
//
// Same wire format as gr_lora_tpu.core.codec (the NumPy implementation is
// the executable spec; both trace to the reference behavior:
// encode_impl.cc:277-359, decode_impl.cc:274-430, utilities.h:74-120,
// lora.h:29-30).  Cross-checked against the Python core over the full
// SF x CR x LDR x header x CRC grid in tests/test_native.py.

#include "lora_host.h"

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// ---- whitening: LFSR x^8 + x^6 + x^5 + x^4 + 1, all-ones seed, 8-bit
// sliding window MSB-first.
struct Whitening {
  uint8_t seq[255];
  Whitening() {
    uint8_t bits[255 + 7];
    for (int i = 0; i < 8; i++) bits[i] = 1;
    for (int n = 8; n < 255 + 7; n++)
      bits[n] = bits[n - 4] ^ bits[n - 5] ^ bits[n - 6] ^ bits[n - 8];
    for (int i = 0; i < 255; i++) {
      uint8_t b = 0;
      for (int j = 0; j < 8; j++) b = (uint8_t)((b << 1) | bits[i + j]);
      seq[i] = b;
    }
  }
};
const Whitening kWhitening;

inline int parity(uint32_t v) { return __builtin_popcount(v) & 1; }

// Encoder parity-generator masks over the data nibble (encode_impl.cc:28-32).
constexpr uint8_t ENC_P1 = 0x0D, ENC_P2 = 0x0B, ENC_P3 = 0x07, ENC_P4 = 0x0F,
                  ENC_P5 = 0x0E;
// Decoder syndrome masks over the codeword + data-bit fixes
// (decode_impl.cc:36-43,197-222).
constexpr uint8_t DEC_P1 = 0x2E, DEC_P2 = 0x4B, DEC_P3 = 0x17;
constexpr uint8_t SYNDROME_FIX[8] = {0, 0, 0, 0x08, 0, 0x04, 0x01, 0x02};

uint8_t hamming_encode_nibble(uint8_t nib, int cr) {
  nib &= 0xF;
  const uint8_t p1 = parity(nib & ENC_P1), p2 = parity(nib & ENC_P2),
                p3 = parity(nib & ENC_P3), p4 = parity(nib & ENC_P4),
                p5 = parity(nib & ENC_P5);
  switch (cr) {
    case 1: return (uint8_t)((p4 << 4) | nib);
    case 2: return (uint8_t)((p5 << 5) | (p3 << 4) | nib);
    case 3: return (uint8_t)((p2 << 6) | (p5 << 5) | (p3 << 4) | nib);
    default:
      return (uint8_t)((p1 << 7) | (p2 << 6) | (p5 << 5) | (p3 << 4) | nib);
  }
}

uint8_t hamming_decode_cw(uint8_t cw, bool correctable) {
  if (correctable) {
    const int s = (parity(cw & DEC_P3) << 2) | (parity(cw & DEC_P2) << 1) |
                  parity(cw & DEC_P1);
    cw ^= SYNDROME_FIX[s];
  }
  return (uint8_t)(cw & 0x0F);
}

inline uint16_t from_gray(uint16_t g) {
  g ^= g >> 8; g ^= g >> 4; g ^= g >> 2; g ^= g >> 1;
  return g;
}
inline uint16_t to_gray(uint16_t v) { return (uint16_t)(v ^ (v >> 1)); }

}  // namespace

extern "C" {

uint16_t lora_data_checksum(const uint8_t* data, int32_t len) {
  // CRC16-CCITT poly 0x1021, zero init; last two bytes XORed in
  // (utilities.h:74-94).
  uint16_t crc = 0;
  for (int32_t j = 0; j < len - 2; j++) {
    uint8_t idx = (uint8_t)((crc >> 8) ^ data[j]);
    uint16_t t = (uint16_t)(idx << 8);
    for (int b = 0; b < 8; b++)
      t = (t & 0x8000) ? (uint16_t)((t << 1) ^ 0x1021) : (uint16_t)(t << 1);
    crc = (uint16_t)((crc << 8) ^ t);
  }
  uint16_t x1 = len >= 1 ? data[len - 1] : 0;
  uint16_t x2 = len >= 2 ? (uint16_t)(data[len - 2] << 8) : 0;
  return (uint16_t)(crc ^ x1 ^ x2);
}

uint8_t lora_header_checksum(uint8_t payload_len, uint8_t cr_crc) {
  int a[4], b[4], c[4];
  for (int k = 0; k < 4; k++) {
    a[k] = (payload_len >> (4 + k)) & 1;
    b[k] = (payload_len >> k) & 1;
    c[k] = (cr_crc >> k) & 1;
  }
  uint8_t res = (uint8_t)((a[0] ^ a[1] ^ a[2] ^ a[3]) << 4);
  res |= (uint8_t)((a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3);
  res |= (uint8_t)((a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2);
  res |= (uint8_t)((a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1);
  res |= (uint8_t)(a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]);
  return res;
}

void lora_whitening_sequence(uint8_t* dst) {
  std::memcpy(dst, kWhitening.seq, 255);
}

int32_t lora_calc_sym_num(const lora_params* prm, int32_t payload_len) {
  const double tmp = 2.0 * payload_len - prm->sf + 7 + 4 * (prm->crc ? 1 : 0) -
                     5 * (prm->explicit_header ? 0 : 1);
  const int denom = prm->sf - 2 * (prm->ldr ? 1 : 0);
  const int blocks = (int)std::ceil(tmp / denom);
  const int extra = (4 + prm->cr) * blocks;
  return 8 + (extra > 0 ? extra : 0);
}

int32_t lora_encode(const lora_params* prm, const uint8_t* payload,
                    int32_t payload_len, uint16_t* out_syms, int32_t out_cap) {
  if (prm->sf < 6 || prm->sf > 12 || prm->cr < 1 || prm->cr > 4) return -1;
  const int sf = prm->sf, cr = prm->cr;
  const bool ldr = prm->ldr, crc = prm->crc, hdr = prm->explicit_header;

  std::vector<uint8_t> data(payload, payload + payload_len);
  if (crc) {
    const uint16_t cks = lora_data_checksum(data.data(), payload_len);
    data.push_back((uint8_t)(cks & 0xFF));
    data.push_back((uint8_t)(cks >> 8));
  }

  const int sym_num = lora_calc_sym_num(prm, payload_len);
  const int nibble_num = sf - 2 + (sym_num - 8) / (cr + 4) * (sf - 2 * (ldr ? 1 : 0));
  const int need_bytes = (nibble_num + 1) / 2;
  while ((int)data.size() < need_bytes) data.push_back(0);

  const int wn = payload_len < 255 ? payload_len : 255;
  for (int i = 0; i < wn && i < (int)data.size(); i++)
    data[i] ^= kWhitening.seq[i];

  std::vector<uint8_t> nibbles;
  if (hdr) {
    const uint8_t cr_crc = (uint8_t)(((cr << 1) | (crc ? 1 : 0)) & 0xFF);
    const uint8_t cks = lora_header_checksum((uint8_t)payload_len, cr_crc);
    nibbles.push_back((uint8_t)(payload_len >> 4));
    nibbles.push_back((uint8_t)(payload_len & 0xF));
    nibbles.push_back(cr_crc);
    nibbles.push_back((uint8_t)(cks >> 4));
    nibbles.push_back((uint8_t)(cks & 0xF));
  }
  for (int i = 0; i < nibble_num; i++)
    nibbles.push_back((i % 2 == 0) ? (uint8_t)(data[i / 2] & 0xF)
                                   : (uint8_t)(data[i / 2] >> 4));

  // Hamming: first sf-2 nibbles always CR 4/8 (encode_impl.cc:217).
  std::vector<uint8_t> cw(nibbles.size());
  for (size_t i = 0; i < nibbles.size(); i++)
    cw[i] = hamming_encode_nibble(nibbles[i], (int)i < sf - 2 ? 4 : cr);

  // Diagonal interleave + Gray/TX-bin map, block by block.
  const uint32_t n = 1u << sf;
  int out = 0, start = 0;
  bool first = true;
  while (true) {
    const int ppm = first ? sf - 2 : sf - 2 * (ldr ? 1 : 0);
    const int bpw = first ? 8 : cr + 4;
    if (start + ppm > (int)cw.size()) break;
    for (int x = 0; x < bpw; x++) {
      uint16_t sym = 0;
      for (int j = 0; j < ppm; j++)
        sym |= (uint16_t)(((cw[start + (j + x) % ppm] >> x) & 1) << j);
      const uint32_t g = from_gray(sym);
      const bool reduced = out < 8 || ldr;
      const uint16_t bin =
          (uint16_t)((reduced ? (g * 4 + 1) : (g + 1)) % n);
      if (out >= out_cap) return -2;
      out_syms[out++] = bin;
    }
    start += ppm;
    first = false;
  }
  return out;
}

int32_t lora_decode(const lora_params* prm, const uint16_t* syms,
                    int32_t nsym, uint8_t* out, int32_t out_cap,
                    int32_t* hdr_valid, int32_t* hdr_payload_len,
                    int32_t* hdr_cr, int32_t* hdr_crc, int32_t* crc_ok) {
  const int sf = prm->sf;
  const bool ldr = prm->ldr, hdr = prm->explicit_header;
  const int n = 1 << sf;
  if (nsym < 8) return -2;

  // Normalize + Gray (decode_impl.cc:299-314).
  std::vector<uint16_t> gray(nsym);
  for (int i = 0; i < nsym; i++) {
    const bool reduced = i < 8 || ldr;
    const int v = syms[i];
    const int norm = reduced ? v / 4 : ((v - 1) % n + n) % n;
    gray[i] = to_gray((uint16_t)norm);
  }

  auto deinterleave_block = [](const uint16_t* s, int ppm, int bpw,
                               uint8_t* dst) {
    for (int y = 0; y < ppm; y++) {
      uint8_t w = 0;
      for (int i = 0; i < bpw; i++)
        w |= (uint8_t)(((s[i] >> (((y - i) % ppm + ppm) % ppm)) & 1) << i);
      dst[y] = w;
    }
  };

  // Header block: ppm = sf-2, rdd = 4.
  std::vector<uint8_t> cw(sf - 2);
  deinterleave_block(gray.data(), sf - 2, 8, cw.data());

  int payload_len = prm->payload_len, cr = prm->cr;
  bool crc = prm->crc;
  if (hdr) {
    uint8_t nib[5];
    for (int i = 0; i < 5 && i < sf - 2; i++)
      nib[i] = hamming_decode_cw(cw[i], true);
    const int plen = (nib[0] << 4) | nib[1];
    const bool pcrc = nib[2] & 1;
    const int pcr = nib[2] >> 1;
    const int cks = (nib[3] << 4) | nib[4];
    const bool valid =
        cks == lora_header_checksum((uint8_t)plen, (uint8_t)(nib[2] & 0xF));
    if (hdr_valid) *hdr_valid = valid;
    if (hdr_payload_len) *hdr_payload_len = plen;
    if (hdr_cr) *hdr_cr = pcr;
    if (hdr_crc) *hdr_crc = pcrc;
    if (!valid) return -1;
    payload_len = plen;
    cr = pcr;
    crc = pcrc;
  } else if (hdr_valid) {
    *hdr_valid = 0;
  }

  // Payload blocks: ppm = ldr ? sf-2 : sf, rdd = cr.
  const int ppm = ldr ? sf - 2 : sf;
  const int bpw = cr + 4;
  const int nblocks = (nsym - 8) / bpw;
  cw.resize(sf - 2 + (size_t)nblocks * ppm);
  for (int k = 0; k < nblocks; k++)
    deinterleave_block(gray.data() + 8 + k * bpw, ppm, bpw,
                       cw.data() + sf - 2 + k * ppm);

  // Explicit header = 2.5 bytes: zero nibble inserted at index 5
  // (decode_impl.cc:371).
  if (hdr) cw.insert(cw.begin() + 5, 0);

  std::vector<uint8_t> nibbles(cw.size());
  for (size_t i = 0; i < cw.size(); i++)
    nibbles[i] = hamming_decode_cw(cw[i], cr > 2 || (int)i < sf - 2);

  const int min_len = payload_len * 2 + (hdr ? 6 : 0) + (crc ? 4 : 0);
  if ((int)nibbles.size() < min_len) return -2;

  const int nbytes = min_len / 2;
  std::vector<uint8_t> bytes(nbytes);
  for (int i = 0; i < nbytes; i++) {
    const uint8_t lo = nibbles[2 * i], hi = nibbles[2 * i + 1];
    // Header bytes pack big-endian-nibble-first (decode_impl.cc:380-390).
    bytes[i] = (hdr && i < 3) ? (uint8_t)((lo << 4) | hi)
                              : (uint8_t)((hi << 4) | lo);
  }

  // Dewhiten: skip 3 header bytes and trailing 2 CRC bytes
  // (decode_impl.cc:135-144).
  const int off = hdr ? 3 : 0;
  const int crc_off = crc ? 2 : 0;
  int wlen = nbytes - crc_off - off;
  if (wlen > 255) wlen = 255;
  for (int i = 0; i < wlen; i++) bytes[off + i] ^= kWhitening.seq[i];

  int total = nbytes;
  if (crc) {
    const int rx = bytes[payload_len + off] |
                   (bytes[payload_len + off + 1] << 8);
    const bool ok =
        rx == lora_data_checksum(bytes.data() + off, payload_len);
    if (crc_ok) *crc_ok = ok;
    total += 1;
    if (total > out_cap) return -3;
    std::memcpy(out, bytes.data(), nbytes);
    out[nbytes] = ok ? 1 : 0;
  } else {
    if (crc_ok) *crc_ok = -1;
    if (total > out_cap) return -3;
    std::memcpy(out, bytes.data(), nbytes);
  }
  return total;
}

}  // extern "C"
