// BLAKE2b compression for the host (RFC 7693), with the absorb rule of
// @noble/hashes that the ceremony's 216-byte midstate depends on: a full
// 128-byte buffer is compressed only when more input arrives, so a state
// exported on a block boundary still holds that block (pos = 128).
//
// Bytes of buf beyond the pending ones are part of the exported midstate,
// so they must be those of the previous block, as in a byte-by-byte absorb.
//
// The state lives in the caller's memory: h[8], buf[128], the count of bytes
// compressed so far, and the count of bytes pending in buf.  Built with g++
// as a plain C library (snarkjs_tpu_torch/_build.py:host_library).

#include <stdint.h>
#include <string.h>

namespace {

const uint64_t IV[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline uint64_t load64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

// t: bytes hashed up to and including this block (below 2^64 here)
void compress(uint64_t h[8], const uint8_t* block, uint64_t t, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = IV[i];
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
#define G(r, i, a, b, c, d)                  \
  a = a + b + m[SIGMA[r][2 * i]];            \
  d = rotr(d ^ a, 32);                       \
  c = c + d;                                 \
  b = rotr(b ^ c, 24);                       \
  a = a + b + m[SIGMA[r][2 * i + 1]];        \
  d = rotr(d ^ a, 16);                       \
  c = c + d;                                 \
  b = rotr(b ^ c, 63);
  for (int r = 0; r < 12; ++r) {
    G(r, 0, v[0], v[4], v[8], v[12]);
    G(r, 1, v[1], v[5], v[9], v[13]);
    G(r, 2, v[2], v[6], v[10], v[14]);
    G(r, 3, v[3], v[7], v[11], v[15]);
    G(r, 4, v[0], v[5], v[10], v[15]);
    G(r, 5, v[1], v[6], v[11], v[12]);
    G(r, 6, v[2], v[7], v[8], v[13]);
    G(r, 7, v[3], v[4], v[9], v[14]);
  }
#undef G
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

}  // namespace

extern "C" {

// Absorb n bytes.  comp: bytes compressed so far; pos: bytes pending in buf.
void snark_blake2b_update(uint64_t* h, uint8_t* buf, uint64_t* comp,
                          uint32_t* pos, const uint8_t* data, uint64_t n) {
  while (n > 0) {
    if (*pos == 128) {
      compress(h, buf, *comp + 128, false);
      *comp += 128;
      *pos = 0;
    }
    if (*pos == 0 && n > 128) {
      // whole blocks straight from the input, keeping the last one pending;
      // the last of them is left in buf, as if each had passed through it
      // (the midstate exports all 128 bytes of buf)
      while (n > 128) {
        compress(h, data, *comp + 128, false);
        *comp += 128;
        data += 128;
        n -= 128;
      }
      memcpy(buf, data - 128, 128);
    }
    uint64_t take = 128 - *pos < n ? 128 - *pos : n;
    memcpy(buf + *pos, data, take);
    *pos += (uint32_t)take;
    data += take;
    n -= take;
  }
}

// The 64-byte digest of the state (the state itself is left as it was).
void snark_blake2b_final(const uint64_t* h, const uint8_t* buf, uint64_t comp,
                         uint32_t pos, uint8_t* out) {
  uint64_t hh[8];
  uint8_t block[128];
  memcpy(hh, h, sizeof hh);
  memset(block, 0, sizeof block);
  memcpy(block, buf, pos);
  compress(hh, block, comp + pos, true);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) out[8 * i + j] = (uint8_t)(hh[i] >> (8 * j));
}

}  // extern "C"
