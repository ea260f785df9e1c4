// huffc — native host runtime for the tpuhuff framework.
//
// C++ equivalents of the reference's Rust hot paths (the task environment has
// no Rust toolchain), exposed through a plain C ABI consumed via ctypes:
//
//   * huffc_hist          — threaded byte histogram
//                           (capability of ByteWeights::threaded_from_bytes,
//                           /root/reference/huff_coding/src/weights.rs:293-319)
//   * huffc_encode        — MSB-first variable-length bit packer
//                           (comp.rs:419-451 semantics), multithreaded with
//                           private buffers + shift-merge stitching (the
//                           *correct* bit-carry the reference's CLI gets wrong
//                           for padding ∉ {0,4}, SURVEY §2 quirk)
//   * huffc_build_dfa     — byte-driven DFA tables from flat tree arrays
//   * huffc_decode        — table-driven decoder, one lookup per 8 compressed
//                           bits (replaces the per-bit pointer chase of
//                           comp.rs:487-519)
//   * huffc_decode_blocks — threaded decode over independent bit ranges
//                           (the .hf2 parallel-decode path)
//
// Design notes: everything operates on flat arrays (no node graphs); all
// bit order is MSB-first within bytes, matching BitVec<Msb0,u8>.

#include <algorithm>
#include <cstdio>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef HUFFC_USE_ZLIB
#include <zlib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// histogram
// ---------------------------------------------------------------------------
static void hist_range(const uint8_t* data, uint64_t n, uint64_t* out256) {
  // 4 sub-tables defeat store-to-load forwarding stalls on repeated bytes
  uint64_t sub[4][256] = {{0}};
  uint64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    sub[0][data[i]]++;
    sub[1][data[i + 1]]++;
    sub[2][data[i + 2]]++;
    sub[3][data[i + 3]]++;
  }
  for (; i < n; ++i) sub[0][data[i]]++;
  for (int b = 0; b < 256; ++b)
    out256[b] = sub[0][b] + sub[1][b] + sub[2][b] + sub[3][b];
}

void huffc_hist(const uint8_t* data, uint64_t n, int num_threads,
                uint64_t* out256) {
  if (num_threads <= 1 || n < (1u << 20)) {
    hist_range(data, n, out256);
    return;
  }
  int t = num_threads;
  std::vector<std::vector<uint64_t>> parts(t, std::vector<uint64_t>(256, 0));
  std::vector<std::thread> threads;
  uint64_t chunk = n / t;
  for (int k = 0; k < t; ++k) {
    uint64_t lo = k * chunk;
    uint64_t hi = (k == t - 1) ? n : lo + chunk;
    threads.emplace_back(
        [&, k, lo, hi] { hist_range(data + lo, hi - lo, parts[k].data()); });
  }
  for (auto& th : threads) th.join();
  std::memset(out256, 0, 256 * sizeof(uint64_t));
  for (int k = 0; k < t; ++k)
    for (int b = 0; b < 256; ++b) out256[b] += parts[k][b];
}

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------
static inline void store_be64(uint8_t* p, uint64_t v) {
  v = __builtin_bswap64(v);
  std::memcpy(p, &v, 8);
}

// Pack data[0..n) into `out` starting at bit 0 of out[0].  `out` must have
// capacity for the stream plus 8 bytes of slack.  Returns bits written.
static uint64_t encode_range(const uint8_t* data, uint64_t n,
                             const uint8_t* len_lut, const uint64_t* code_lut,
                             uint8_t* out) {
  unsigned __int128 acc = 0;  // left-aligned pending bits
  int nbits = 0;
  uint8_t* p = out;
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t b = data[i];
    int len = len_lut[b];
    acc |= ((unsigned __int128)code_lut[b]) << (128 - nbits - len);
    nbits += len;
    if (nbits >= 64) {
      store_be64(p, (uint64_t)(acc >> 64));
      p += 8;
      acc <<= 64;
      nbits -= 64;
    }
  }
  uint64_t total = (uint64_t)(p - out) * 8 + nbits;
  // flush the tail (zero-padded low bits)
  while (nbits > 0) {
    *p++ = (uint8_t)(acc >> 120);
    acc <<= 8;
    nbits -= 8;
  }
  return total;
}

// Two interleaved encode_range streams: each block's left-aligned
// 128-bit accumulator is a serial dependency chain (~4-5 cycles/byte);
// two independent chains overlap for ~1.5x per core.  Semantics and
// output bits identical to encode_range run on each block separately.
static void encode_two(const uint8_t* d0, uint64_t n0, uint8_t* o0,
                       const uint8_t* d1, uint64_t n1, uint8_t* o1,
                       const uint8_t* len_lut, const uint64_t* code_lut) {
  unsigned __int128 acc0 = 0, acc1 = 0;
  int nb0 = 0, nb1 = 0;
  uint8_t* p0 = o0;
  uint8_t* p1 = o1;
  uint64_t m = n0 < n1 ? n0 : n1;
  for (uint64_t i = 0; i < m; ++i) {
    uint8_t b0 = d0[i];
    int l0 = len_lut[b0];
    acc0 |= ((unsigned __int128)code_lut[b0]) << (128 - nb0 - l0);
    nb0 += l0;
    if (nb0 >= 64) {
      store_be64(p0, (uint64_t)(acc0 >> 64));
      p0 += 8;
      acc0 <<= 64;
      nb0 -= 64;
    }
    uint8_t b1 = d1[i];
    int l1 = len_lut[b1];
    acc1 |= ((unsigned __int128)code_lut[b1]) << (128 - nb1 - l1);
    nb1 += l1;
    if (nb1 >= 64) {
      store_be64(p1, (uint64_t)(acc1 >> 64));
      p1 += 8;
      acc1 <<= 64;
      nb1 -= 64;
    }
  }
  for (uint64_t i = m; i < n0; ++i) {
    uint8_t b = d0[i];
    int l = len_lut[b];
    acc0 |= ((unsigned __int128)code_lut[b]) << (128 - nb0 - l);
    nb0 += l;
    if (nb0 >= 64) {
      store_be64(p0, (uint64_t)(acc0 >> 64));
      p0 += 8;
      acc0 <<= 64;
      nb0 -= 64;
    }
  }
  for (uint64_t i = m; i < n1; ++i) {
    uint8_t b = d1[i];
    int l = len_lut[b];
    acc1 |= ((unsigned __int128)code_lut[b]) << (128 - nb1 - l);
    nb1 += l;
    if (nb1 >= 64) {
      store_be64(p1, (uint64_t)(acc1 >> 64));
      p1 += 8;
      acc1 <<= 64;
      nb1 -= 64;
    }
  }
  while (nb0 > 0) {
    *p0++ = (uint8_t)(acc0 >> 120);
    acc0 <<= 8;
    nb0 -= 8;
  }
  while (nb1 > 0) {
    *p1++ = (uint8_t)(acc1 >> 120);
    acc1 <<= 8;
    nb1 -= 8;
  }
}

// OR-copy `src` (src_bits long, starting at bit 0) into `dst` at bit offset
// `dst_bit`.  dst bytes beyond the first touched byte must be zero.
static void or_shift_copy(const uint8_t* src, uint64_t src_bits, uint8_t* dst,
                          uint64_t dst_bit) {
  uint8_t* d = dst + (dst_bit >> 3);
  int shift = (int)(dst_bit & 7);
  uint64_t src_bytes = (src_bits + 7) >> 3;
  // Boundary bytes (the first and last byte a bitstream touches) may be
  // shared with the adjacent bitstream, in EITHER write order (the threaded
  // stitcher writes blocks out of order), so they must OR-merge; interior
  // bytes are exclusively owned and use plain stores.  A zero carry is
  // skipped entirely: the OR would be a no-op but its read-modify-write
  // could race with the genuine writer of that byte on another thread.
  if (src_bytes == 0) return;
  if (shift == 0) {
    d[0] |= src[0];
    if (src_bytes > 2) std::memcpy(d + 1, src + 1, src_bytes - 2);
    if (src_bytes > 1) d[src_bytes - 1] |= src[src_bytes - 1];
    return;
  }
  d[0] |= (uint8_t)(src[0] >> shift);
  uint8_t carry = (uint8_t)(src[0] << (8 - shift));
  for (uint64_t i = 1; i + 1 < src_bytes; ++i) {
    uint8_t s = src[i];
    d[i] = (uint8_t)(carry | (s >> shift));
    carry = (uint8_t)(s << (8 - shift));
  }
  if (src_bytes > 1) {
    uint8_t s = src[src_bytes - 1];
    d[src_bytes - 1] |= (uint8_t)(carry | (s >> shift));
    carry = (uint8_t)(s << (8 - shift));
  }
  if (carry) d[src_bytes] |= carry;
}

// Encode into `out` starting at `start_bit` (earlier bits of the first byte
// are preserved/OR-merged; rest of out must be zeroed by the caller).
// Returns total bits written (excluding start_bit) or -1 on overflow.
int64_t huffc_encode(const uint8_t* data, uint64_t n, const uint8_t* len_lut,
                     const uint64_t* code_lut, uint8_t* out, uint64_t out_cap,
                     uint64_t start_bit, int num_threads) {
  // exact output size via histogram dot lens
  uint64_t hist[256];
  huffc_hist(data, n, num_threads, hist);
  uint64_t total_bits = 0;
  for (int b = 0; b < 256; ++b) {
    if (hist[b] && len_lut[b] == 0) return -2;  // letter not in codes
    total_bits += hist[b] * (uint64_t)len_lut[b];
  }
  if ((start_bit + total_bits + 7) / 8 + 8 > out_cap) return -1;

  if (num_threads <= 1 || n < (1u << 21)) {
    if ((start_bit & 7) == 0) {
      encode_range(data, n, len_lut, code_lut, out + (start_bit >> 3));
    } else {
      std::vector<uint8_t> tmp(total_bits / 8 + 16, 0);
      encode_range(data, n, len_lut, code_lut, tmp.data());
      or_shift_copy(tmp.data(), total_bits, out, start_bit);
    }
    return (int64_t)total_bits;
  }

  int t = num_threads;
  uint64_t chunk = n / t;
  // per-chunk bit offsets
  std::vector<uint64_t> chunk_bits(t, 0), chunk_lo(t), chunk_hi(t);
  std::vector<std::thread> threads;
  for (int k = 0; k < t; ++k) {
    chunk_lo[k] = k * chunk;
    chunk_hi[k] = (k == t - 1) ? n : (k + 1) * chunk;
  }
  std::vector<std::vector<uint8_t>> bufs(t);
  for (int k = 0; k < t; ++k)
    threads.emplace_back([&, k] {
      uint64_t len = chunk_hi[k] - chunk_lo[k];
      uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      uint64_t i = chunk_lo[k];
      for (; i + 4 <= chunk_hi[k]; i += 4) {
        s0 += len_lut[data[i]];
        s1 += len_lut[data[i + 1]];
        s2 += len_lut[data[i + 2]];
        s3 += len_lut[data[i + 3]];
      }
      uint64_t bits = s0 + s1 + s2 + s3;
      for (; i < chunk_hi[k]; ++i) bits += len_lut[data[i]];
      bufs[k].assign(bits / 8 + 16, 0);
      encode_range(data + chunk_lo[k], len, len_lut, code_lut, bufs[k].data());
      chunk_bits[k] = bits;
      (void)len;
    });
  for (auto& th : threads) th.join();
  threads.clear();
  // prefix offsets, then parallel shift-merge (seam bytes are touched by two
  // neighbors; merge serially here since OR on the seam is not atomic)
  std::vector<uint64_t> offs(t + 1);
  offs[0] = start_bit;
  for (int k = 0; k < t; ++k) offs[k + 1] = offs[k] + chunk_bits[k];
  for (int k = 0; k < t; ++k)
    or_shift_copy(bufs[k].data(), chunk_bits[k], out, offs[k]);
  return (int64_t)total_bits;
}

// ---------------------------------------------------------------------------
// DFA build
// ---------------------------------------------------------------------------
int32_t huffc_build_dfa(const int32_t* left, const int32_t* right,
                        const int32_t* letter, int32_t n_nodes, int32_t root,
                        int16_t* next_state, uint8_t* emit_count,
                        uint8_t* emit_syms, uint8_t* last_emit_bit,
                        int16_t* state_of_node) {
  // states: internal nodes, root first then increasing node index
  // (must match HuffTree.decode_dfa in tpuhuff/core/tree.py)
  int32_t S = 0;
  for (int32_t i = 0; i < n_nodes; ++i) state_of_node[i] = -1;
  if (left[root] >= 0) state_of_node[root] = S++;
  for (int32_t i = 0; i < n_nodes; ++i)
    if (i != root && left[i] >= 0) state_of_node[i] = (int16_t)S++;
  if (S == 0) return 0;
  std::vector<int32_t> node_of_state(S);
  for (int32_t i = 0; i < n_nodes; ++i)
    if (state_of_node[i] >= 0) node_of_state[state_of_node[i]] = i;
  for (int32_t s = 0; s < S; ++s) {
    int32_t start = node_of_state[s];
    for (int byte = 0; byte < 256; ++byte) {
      int32_t node = start;
      int count = 0;
      uint64_t idx = (uint64_t)s * 256 + byte;
      uint8_t last_bit = 255;  // bit index (0=MSB) of the last emit, if any
      for (int bit_i = 7; bit_i >= 0; --bit_i) {
        int bit = (byte >> bit_i) & 1;
        node = bit ? right[node] : left[node];
        if (left[node] < 0) {
          emit_syms[idx * 8 + count] = (uint8_t)letter[node];
          ++count;
          node = root;
          last_bit = (uint8_t)(7 - bit_i);
        }
      }
      next_state[idx] = state_of_node[node];
      emit_count[idx] = (uint8_t)count;
      last_emit_bit[idx] = last_bit;
    }
  }
  return S;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------
// Decode the bit range [start_bit, end_bit) of `comp`.  Returns the number of
// letters written, or -1 on out_cap overflow (bounds are exact: never writes
// past out + out_cap, so adjacent output slots can be packed contiguously).
int64_t huffc_decode(const uint8_t* comp, uint64_t start_bit, uint64_t end_bit,
                     const int16_t* next_state, const uint8_t* emit_count,
                     const uint8_t* emit_syms, const uint8_t* last_emit_bit,
                     const int32_t* left, const int32_t* right,
                     const int32_t* letter, const int16_t* state_of_node,
                     const int32_t* node_of_state, int32_t root, uint8_t* out,
                     uint64_t out_cap, uint64_t* resume_bit) {
  uint8_t* p = out;
  uint8_t* out_end = out + out_cap;
  uint64_t last_emit_end = start_bit;  // bit just past the last emitted code
  // degenerate single-leaf tree: every bit emits the root letter
  if (left[root] < 0) {
    uint64_t count = end_bit - start_bit;
    if (count > out_cap) return -1;
    std::memset(out, (uint8_t)letter[root], count);
    if (resume_bit) *resume_bit = end_bit;
    return (int64_t)count;
  }
  int32_t node = root;
  uint64_t bit = start_bit;
  // leading partial byte: per-bit walk
  while (bit < end_bit && (bit & 7) != 0) {
    int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
    node = b ? right[node] : left[node];
    if (left[node] < 0) {
      if (p >= out_end) return -1;
      *p++ = (uint8_t)letter[node];
      node = root;
    }
    ++bit;
  }
  // full bytes: DFA, one lookup per byte, ≤8 letters emitted
  int16_t state = state_of_node[node];
  uint64_t n_full = (end_bit - bit) >> 3;
  const uint8_t* cp = comp + (bit >> 3);
  for (uint64_t i = 0; i < n_full; ++i) {
    uint64_t idx = (uint64_t)state * 256 + cp[i];
    int c = emit_count[idx];
    if (p + 8 <= out_end) {
      std::memcpy(p, emit_syms + idx * 8, 8);  // bulk 8, advance by c
    } else {
      if (p + c > out_end) return -1;
      std::memcpy(p, emit_syms + idx * 8, (size_t)c);  // exact near slot end
    }
    p += c;
    if (c) last_emit_end = bit + i * 8 + last_emit_bit[idx] + 1;
    state = next_state[idx];
  }
  bit += n_full * 8;
  // trailing partial byte: per-bit walk from the DFA's node
  if (bit < end_bit) {
    node = node_of_state[state];
    while (bit < end_bit) {
      int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
      node = b ? right[node] : left[node];
      if (left[node] < 0) {
        if (p >= out_end) return -1;
        *p++ = (uint8_t)letter[node];
        node = root;
        last_emit_end = bit + 1;
      }
      ++bit;
    }
  }
  if (resume_bit) *resume_bit = last_emit_end;
  return (int64_t)(p - out);
}

// Decode the bit range [start_bit, end_bit) while ALSO recording the bit
// offset after every `block_len`-th letter — the fused form of huffc_decode
// + huffc_index_blocks (one DFA pass instead of two).  Powers the
// decode-and-build-sidecar first read of a foreign .hff (the reference
// format carries no block index, huff/README.md:55-65).  Resumable:
// `*inout_in_block` carries the current block's letter count across
// windows; `*resume_bit` returns the offset just past the last complete
// code.  `*out_bounds` receives the boundary count.  Returns letters
// emitted, -1 on out_cap overflow, -3 on boundary-buffer overflow.
int64_t huffc_decode_index(
    const uint8_t* comp, uint64_t start_bit, uint64_t end_bit,
    const int16_t* next_state, const uint8_t* emit_count,
    const uint8_t* emit_syms, const uint8_t* last_emit_bit,
    const int32_t* left, const int32_t* right, const int32_t* letter,
    const int16_t* state_of_node, const int32_t* node_of_state, int32_t root,
    uint8_t* out, uint64_t out_cap, uint64_t* resume_bit, uint64_t block_len,
    uint64_t* boundaries, int64_t max_bounds, uint64_t* inout_in_block,
    int64_t* out_bounds) {
  uint64_t in_block = inout_in_block ? *inout_in_block : 0;
  int64_t nb = 0;
  uint8_t* p = out;
  uint8_t* out_end = out + out_cap;
  uint64_t last_emit_end = start_bit;
  uint64_t bit = start_bit;
  int32_t node = root;
  if (block_len == 0) return -3;
  if (left[root] < 0) {  // degenerate single-leaf tree: one letter per bit
    uint64_t count = end_bit - start_bit;
    if (count > out_cap) return -1;
    std::memset(out, (uint8_t)letter[root], count);
    for (uint64_t b2 = start_bit; b2 < end_bit; ++b2) {
      if (++in_block == block_len) {
        if (nb >= max_bounds) return -3;
        boundaries[nb++] = b2 + 1;
        in_block = 0;
      }
    }
    if (resume_bit) *resume_bit = end_bit;
    if (inout_in_block) *inout_in_block = in_block;
    if (out_bounds) *out_bounds = nb;
    return (int64_t)count;
  }
  bool overflow_out = false, overflow_nb = false;
  // per-bit walk over [bit, stop) with emission + boundary tracking
  auto walk_bits = [&](uint64_t stop) {
    for (; bit < stop; ++bit) {
      int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
      node = b ? right[node] : left[node];
      if (left[node] < 0) {
        if (p >= out_end) { overflow_out = true; return; }
        *p++ = (uint8_t)letter[node];
        node = root;
        last_emit_end = bit + 1;
        if (++in_block == block_len) {
          if (nb >= max_bounds) { overflow_nb = true; return; }
          boundaries[nb++] = bit + 1;
          in_block = 0;
        }
      }
    }
  };
  uint64_t head_stop = end_bit < ((bit + 7) & ~7ull) ? end_bit
                                                     : ((bit + 7) & ~7ull);
  walk_bits(head_stop);
  if (overflow_out) return -1;
  if (overflow_nb) return -3;
  int16_t state = state_of_node[node];
  uint64_t n_full = (end_bit - bit) >> 3;
  const uint8_t* cp = comp + (bit >> 3);
  for (uint64_t i = 0; i < n_full; ++i) {
    uint64_t idx = (uint64_t)state * 256 + cp[i];
    unsigned c = emit_count[idx];
    if (in_block + c < block_len) {  // fast path: no boundary in this byte
      if (p + 8 <= out_end) {
        std::memcpy(p, emit_syms + idx * 8, 8);
      } else {
        if (p + c > out_end) return -1;
        std::memcpy(p, emit_syms + idx * 8, (size_t)c);
      }
      p += c;
      in_block += c;
      if (c) last_emit_end = bit + i * 8 + last_emit_bit[idx] + 1;
      state = next_state[idx];
      continue;
    }
    // boundary inside this byte: re-walk it per bit, emitting
    node = node_of_state[state];
    uint64_t save = bit;
    bit = save + 8 * i;
    walk_bits(bit + 8);
    if (overflow_out) return -1;
    if (overflow_nb) return -3;
    state = state_of_node[node];
    bit = save;
  }
  bit += n_full * 8;
  node = node_of_state[state];
  walk_bits(end_bit);
  if (overflow_out) return -1;
  if (overflow_nb) return -3;
  if (resume_bit) *resume_bit = last_emit_end;
  if (inout_in_block) *inout_in_block = in_block;
  if (out_bounds) *out_bounds = nb;
  return (int64_t)(p - out);
}

// ---------------------------------------------------------------------------
// crc32 (IEEE 802.3 / zlib polynomial, bit-reflected) — slicing-by-8.
// Matches Python's zlib.crc32, so host fallbacks interoperate bit-exactly.
// Integrity is a tpuhuff extension over the reference (.hf2 flags bit 1):
// the reference decodes corrupt payloads to silently-wrong output
// (comp.rs:487-519 walks whatever bits it is given).
// ---------------------------------------------------------------------------
static uint32_t g_crc_tab[8][256];
static bool g_crc_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    g_crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      g_crc_tab[t][i] =
          g_crc_tab[0][g_crc_tab[t - 1][i] & 0xFF] ^ (g_crc_tab[t - 1][i] >> 8);
  return true;
}();

uint32_t huffc_crc32(const uint8_t* data, uint64_t n, uint32_t seed) {
#ifdef HUFFC_USE_ZLIB
  // zlib's crc32 is SIMD-accelerated (~2x the slicing-by-8 below on this
  // host: 3.4 vs 1.8 GB/s/core) and computes the identical checksum; the
  // build links it when libz is present (tpuhuff/native/_build).
  uLong c = seed;
  const uint64_t kChunk = 1u << 30;  // zlib's len param is uInt
  while (n > kChunk) {
    c = crc32(c, data, (unsigned)kChunk);
    data += kChunk;
    n -= kChunk;
  }
  return (uint32_t)crc32(c, data, (unsigned)n);
#else
  uint32_t c = ~seed;
  uint64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= c;
    c = g_crc_tab[7][lo & 0xFF] ^ g_crc_tab[6][(lo >> 8) & 0xFF] ^
        g_crc_tab[5][(lo >> 16) & 0xFF] ^ g_crc_tab[4][lo >> 24] ^
        g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
        g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
  }
  for (; i < n; ++i) c = g_crc_tab[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return ~c;
#endif
}

// Per-span CRC32 of a contiguous buffer: out[k] = crc32(data[k*span ..
// min((k+1)*span, n))).  Threaded over spans (each span independent) —
// verifies a group of decoded .hf2 blocks block-parallel.
void huffc_crc32_blocks(const uint8_t* data, uint64_t n, uint64_t span,
                        uint32_t* out, int num_threads) {
  if (span == 0 || n == 0) return;
  int64_t ns = (int64_t)((n + span - 1) / span);
  auto do_range = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      uint64_t a = (uint64_t)k * span;
      uint64_t b = std::min<uint64_t>(a + span, n);
      out[k] = huffc_crc32(data + a, b - a, 0);
    }
  };
  int t = num_threads > 1 ? num_threads : 1;
  if (t == 1 || ns < 2 * t) {
    do_range(0, ns);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (ns + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    int64_t lo = (int64_t)w * per, hi = std::min<int64_t>(lo + per, ns);
    if (lo < hi) threads.emplace_back([&, lo, hi] { do_range(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// Walk a bit range WITHOUT emitting, recording the bit offset after every
// `block_len`-th letter — the .hff -> .hf2 transcoder's indexer (the index
// is what the reference format lacks for parallel decode).  Resumable like
// huffc_decode: `*inout_in_block` carries the letter count of the current
// (unfinished) block across windows, `*resume_bit` returns the offset just
// past the last complete code.  Returns the number of boundaries written,
// or -1 if `max_bounds` is too small.
int64_t huffc_index_blocks(const uint8_t* comp, uint64_t start_bit,
                           uint64_t end_bit, const int16_t* next_state,
                           const uint8_t* emit_count,
                           const uint8_t* last_emit_bit, const int32_t* left,
                           const int32_t* right,
                           const int16_t* state_of_node,
                           const int32_t* node_of_state, int32_t root,
                           uint64_t block_len, uint64_t* boundaries,
                           int64_t max_bounds, uint64_t* inout_in_block,
                           uint64_t* resume_bit) {
  uint64_t in_block = inout_in_block ? *inout_in_block : 0;
  int64_t nb = 0;
  uint64_t last_emit_end = start_bit;
  uint64_t bit = start_bit;
  int32_t node = root;
  if (left[root] < 0) {  // degenerate: one letter per bit
    for (; bit < end_bit; ++bit) {
      if (++in_block == block_len) {
        if (nb >= max_bounds) return -1;
        boundaries[nb++] = bit + 1;
        in_block = 0;
      }
    }
    if (resume_bit) *resume_bit = end_bit;
    if (inout_in_block) *inout_in_block = in_block;
    return nb;
  }
  // helper lambda: per-bit walk over [bit, stop)
  auto walk_bits = [&](uint64_t stop) -> int64_t {
    for (; bit < stop; ++bit) {
      int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
      node = b ? right[node] : left[node];
      if (left[node] < 0) {
        node = root;
        last_emit_end = bit + 1;
        if (++in_block == block_len) {
          if (nb >= max_bounds) return -1;
          boundaries[nb++] = bit + 1;
          in_block = 0;
        }
      }
    }
    return 0;
  };
  uint64_t head_stop = end_bit < ((bit + 7) & ~7ull) ? end_bit
                                                     : ((bit + 7) & ~7ull);
  if (walk_bits(head_stop) < 0) return -1;
  int16_t state = state_of_node[node];
  uint64_t n_full = (end_bit - bit) >> 3;
  const uint8_t* cp = comp + (bit >> 3);
  for (uint64_t i = 0; i < n_full; ++i) {
    uint64_t idx = (uint64_t)state * 256 + cp[i];
    unsigned c = emit_count[idx];
    if (in_block + c < block_len) {  // fast path: boundary not crossed
      in_block += c;
      if (c) last_emit_end = bit + 8 * i + last_emit_bit[idx] + 1;
      state = next_state[idx];
      continue;
    }
    // boundary inside this byte: re-walk it per bit from the DFA's node
    node = node_of_state[state];
    uint64_t save = bit;
    bit = save + 8 * i;
    if (walk_bits(bit + 8) < 0) return -1;
    state = state_of_node[node];
    bit = save;
  }
  bit += n_full * 8;
  node = node_of_state[state];
  if (walk_bits(end_bit) < 0) return -1;
  if (resume_bit) *resume_bit = last_emit_end;
  if (inout_in_block) *inout_in_block = in_block;
  return nb;
}

// One independent decode stream positioned at its full-byte DFA section
// (head bits already walked).  Used by the dual-stream block decoder.
struct DfaStream {
  const uint8_t* cp;   // first full byte
  uint64_t n_full;     // full bytes to process
  uint8_t* p;          // output cursor
  uint8_t* out_end;
  int16_t state;
  uint64_t done;       // full bytes consumed so far
  uint64_t tail_bit;   // first bit after the full-byte section
  uint64_t end_bit;
  bool overflow;
};

// Walk the leading partial byte and set up the DFA section.  Returns
// false on output overflow.  Mirrors huffc_decode's head logic.
static bool stream_setup(const uint8_t* comp, uint64_t start_bit,
                         uint64_t end_bit, const int32_t* left,
                         const int32_t* right, const int32_t* letter,
                         const int16_t* state_of_node, int32_t root,
                         uint8_t* out, uint64_t out_cap, DfaStream* s) {
  int32_t node = root;
  uint64_t bit = start_bit;
  uint8_t* p = out;
  uint8_t* out_end = out + out_cap;
  while (bit < end_bit && (bit & 7) != 0) {
    int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
    node = b ? right[node] : left[node];
    if (left[node] < 0) {
      if (p >= out_end) return false;
      *p++ = (uint8_t)letter[node];
      node = root;
    }
    ++bit;
  }
  s->cp = comp + (bit >> 3);
  s->n_full = (end_bit - bit) >> 3;
  s->p = p;
  s->out_end = out_end;
  s->state = state_of_node[node];
  s->done = 0;
  s->tail_bit = bit + s->n_full * 8;
  s->end_bit = end_bit;
  s->overflow = false;
  return true;
}

// One DFA step of a stream (returns false when it must stop: exhausted
// or overflow).  Inlined twice in the dual loop.
static inline bool stream_step(DfaStream* s, const int16_t* next_state,
                               const uint8_t* emit_count,
                               const uint8_t* emit_syms) {
  uint64_t idx = (uint64_t)s->state * 256 + s->cp[s->done];
  int c = emit_count[idx];
  if (s->p + 8 <= s->out_end) {
    std::memcpy(s->p, emit_syms + idx * 8, 8);
  } else {
    if (s->p + c > s->out_end) {
      s->overflow = true;
      return false;
    }
    std::memcpy(s->p, emit_syms + idx * 8, (size_t)c);
  }
  s->p += c;
  s->state = next_state[idx];
  return ++s->done < s->n_full;
}

// Walk a stream's trailing partial byte.  Returns letters written in the
// WHOLE stream, or -1 on overflow.
static int64_t stream_finish(DfaStream* s, const uint8_t* comp_base,
                             const int32_t* left, const int32_t* right,
                             const int32_t* letter,
                             const int32_t* node_of_state, int32_t root,
                             uint8_t* out) {
  if (s->overflow) return -1;
  uint64_t bit = s->tail_bit;
  if (bit < s->end_bit) {
    int32_t node = node_of_state[s->state];
    while (bit < s->end_bit) {
      int b = (comp_base[bit >> 3] >> (7 - (bit & 7))) & 1;
      node = b ? right[node] : left[node];
      if (left[node] < 0) {
        if (s->p >= s->out_end) return -1;
        *s->p++ = (uint8_t)letter[node];
        node = root;
      }
      ++bit;
    }
  }
  return (int64_t)(s->p - out);
}

// Threaded decode of `n_blocks` independent bit ranges into pre-assigned
// output slots.  starts/ends in bits; out_offsets/out_caps in bytes.
// Each worker runs TWO blocks' DFA loops interleaved: the per-byte
// `state -> next_state[state*256+byte]` chain is load-latency-bound
// (~10-14 cycles/byte serial); two independent chains overlap their
// table loads for ~1.5x per core.  Bit-exact with the single-stream
// decoder (same tables, same head/tail walks).
// Returns 0 on success; on failure -(block_index+1).
int64_t huffc_decode_blocks(
    const uint8_t* comp, const uint64_t* start_bits, const uint64_t* end_bits,
    int64_t n_blocks, const int16_t* next_state, const uint8_t* emit_count,
    const uint8_t* emit_syms, const uint8_t* last_emit_bit,
    const int32_t* left, const int32_t* right, const int32_t* letter,
    const int16_t* state_of_node, const int32_t* node_of_state, int32_t root,
    uint8_t* out, const uint64_t* out_offsets, const uint64_t* out_caps,
    uint64_t* out_lens, int num_threads) {
  std::atomic<int64_t> next_block(0);
  std::atomic<int64_t> failed(-1);
  constexpr int kWay = 4;  // independent chains per worker (measured
  // sweet spot on 2 cores: 1 -> 0.29, 2 -> 0.34 GB/s with verify; blocks
  // are near-equal length so the drain phase is negligible)
  // interleaved multi-block decode: the streams' DFA loops advance in
  // lockstep so their dependent table loads overlap
  auto decode_group = [&](int64_t k0, int nst) -> int64_t {
    DfaStream s[kWay];
    for (int j = 0; j < nst; ++j) {
      int64_t k = k0 + j;
      if (!stream_setup(comp, start_bits[k], end_bits[k], left, right,
                        letter, state_of_node, root, out + out_offsets[k],
                        out_caps[k], &s[j]))
        return k + 1;
    }
    if (nst == kWay) {
      bool r0 = s[0].n_full > 0, r1 = s[1].n_full > 0;
      bool r2 = s[2].n_full > 0, r3 = s[3].n_full > 0;
      while (r0 & r1 & r2 & r3) {
        r0 = stream_step(&s[0], next_state, emit_count, emit_syms);
        r1 = stream_step(&s[1], next_state, emit_count, emit_syms);
        r2 = stream_step(&s[2], next_state, emit_count, emit_syms);
        r3 = stream_step(&s[3], next_state, emit_count, emit_syms);
      }
      while (r0) r0 = stream_step(&s[0], next_state, emit_count, emit_syms);
      while (r1) r1 = stream_step(&s[1], next_state, emit_count, emit_syms);
      while (r2) r2 = stream_step(&s[2], next_state, emit_count, emit_syms);
      while (r3) r3 = stream_step(&s[3], next_state, emit_count, emit_syms);
    } else {
      for (int j = 0; j < nst; ++j) {
        bool r = s[j].n_full > 0;
        while (r) r = stream_step(&s[j], next_state, emit_count, emit_syms);
      }
    }
    for (int j = 0; j < nst; ++j) {
      int64_t k = k0 + j;
      int64_t lj = stream_finish(&s[j], comp, left, right, letter,
                                 node_of_state, root, out + out_offsets[k]);
      if (lj < 0) return k + 1;
      out_lens[k] = (uint64_t)lj;
    }
    return 0;
  };
  bool leaf_root = left[root] < 0;
  auto worker = [&] {
    for (;;) {
      int64_t k = next_block.fetch_add(kWay);
      if (k >= n_blocks || failed.load() >= 0) break;
      int nst = (int)(n_blocks - k < kWay ? n_blocks - k : kWay);
      if (!leaf_root) {
        int64_t f = decode_group(k, nst);
        if (f) {
          failed.store(f - 1);
          break;
        }
        continue;
      }
      bool bad = false;
      for (int64_t j = k; j < k + nst; ++j) {
        int64_t r = huffc_decode(comp, start_bits[j], end_bits[j],
                                 next_state, emit_count, emit_syms,
                                 last_emit_bit, left, right, letter,
                                 state_of_node, node_of_state, root,
                                 out + out_offsets[j], out_caps[j],
                                 nullptr);
        if (r < 0) {
          failed.store(j);
          bad = true;
          break;
        }
        out_lens[j] = (uint64_t)r;
      }
      if (bad) break;
    }
  };
  int t = num_threads > 1 ? num_threads : 1;
  std::vector<std::thread> threads;
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  int64_t f = failed.load();
  return f >= 0 ? -(f + 1) : 0;
}


// ---------------------------------------------------------------------------
// Speculative parallel indexer (DFA self-synchronization, "chunk resync")
// ---------------------------------------------------------------------------
// A foreign .hff carries no block index, forcing a serial parse.  But a
// byte-driven Huffman DFA self-synchronizes: start parsing ANYWHERE with
// any state and the parse almost always merges with the true parse within
// a few dozen bytes.  So T threads parse byte-aligned chunks
// speculatively from the root state, each recording (state, letters) at
// its first `W` byte boundaries plus a bit-offset "stride" record every
// `kStride` letters after that; a cheap serial reconciliation then walks
// only the seam windows to find where each speculative parse joins the
// true one, fixes up absolute letter counts, and block boundaries are
// resolved from the stride records with <= kStride-letter re-walks.
// Where a seam fails to converge (adversarial tree), that chunk is
// re-walked serially — graceful degradation, never wrong output.
//
// This fulfils the round-1 design note (SURVEY §7 "speculative
// chunk-resync") and makes the FIRST decode of an unindexed container
// scale with cores; steady-state decodes use the sidecar index as before.

}  // extern "C" — the speculative-indexer helpers use templates/C++
// containers and live with C++ linkage; the entry point reopens extern "C"

static const int kSpecWindow = 4096;   // seam search window (bytes)
static const uint64_t kStride = 4096;  // letters between anchor records

struct SpecChunk {
  uint64_t begin_bit = 0, end_bit = 0;  // byte-aligned walk span
  std::vector<int16_t> win_state;       // state at begin+8*j, j in [0, W)
  std::vector<uint32_t> win_letters;    // letters emitted before that byte
  // anchors: a byte boundary shortly after every kStride-th letter —
  // (absolute bit of the boundary, chunk-local letters before it, state)
  std::vector<uint64_t> anchor_bit;
  std::vector<uint64_t> anchor_letters;
  std::vector<int16_t> anchor_state;
  uint64_t letters = 0;          // letters in the speculative parse
  uint64_t last_emit_end = 0;    // bit just past the last emitted code
  int16_t end_state = 0;
  // reconciliation results:
  uint64_t abs_before = 0;       // TRUE absolute letters before begin_bit
  uint64_t true_prefix = 0;      // true letters in [begin, splice byte)
  uint64_t splice_bit = 0;       // byte-aligned bit where parses merge
  uint64_t spec_at_splice = 0;   // chunk-local letters at the splice byte
  bool serial = false;           // seam failed: chunk re-walked serially
};

// Byte-driven walk of a chunk's [begin_bit, end_bit) (byte-aligned),
// from state `st0` — speculative when st0 is a guess.  Records the seam
// window and the anchor list.
static void spec_walk(const uint8_t* comp, SpecChunk* c,
                      const int16_t* next_state, const uint8_t* emit_count,
                      const uint8_t* last_emit_bit, int16_t st0) {
  uint64_t bit = c->begin_bit;
  int16_t state = st0;
  uint64_t letters = 0;
  uint64_t last_end = c->begin_bit;
  uint64_t n_full = (c->end_bit - bit) >> 3;
  const uint8_t* cp = comp + (bit >> 3);
  uint64_t W = std::min<uint64_t>(kSpecWindow, n_full);
  c->win_state.resize((size_t)W);
  c->win_letters.resize((size_t)W);
  uint64_t next_anchor = kStride;
  for (uint64_t j = 0; j < n_full; ++j) {
    if (j < W) {
      c->win_state[(size_t)j] = state;
      c->win_letters[(size_t)j] = (uint32_t)letters;
    }
    if (letters >= next_anchor) {
      c->anchor_bit.push_back(bit + j * 8);
      c->anchor_letters.push_back(letters);
      c->anchor_state.push_back(state);
      next_anchor = (letters / kStride + 1) * kStride;
    }
    uint64_t idx = (uint64_t)state * 256 + cp[j];
    unsigned e = emit_count[idx];
    if (e) {
      letters += e;
      last_end = bit + j * 8 + last_emit_bit[idx] + 1;
    }
    state = next_state[idx];
  }
  c->letters = letters;
  c->last_emit_end = last_end;
  c->end_state = state;
}

// Per-bit tree walk over [bit, stop) from `node`, invoking fn(end_bit)
// for every emitted letter.  Returns the final node.
template <typename Fn>
static int32_t walk_bits_fn(const uint8_t* comp, uint64_t bit, uint64_t stop,
                            const int32_t* left, const int32_t* right,
                            int32_t node, int32_t root, Fn&& fn) {
  for (; bit < stop; ++bit) {
    int b = (comp[bit >> 3] >> (7 - (bit & 7))) & 1;
    node = b ? right[node] : left[node];
    if (left[node] < 0) {
      fn(bit + 1);
      node = root;
    }
  }
  return node;
}

extern "C" {

// Parallel speculative indexer — same contract as huffc_index_blocks
// plus `num_threads`.  Returns the boundary count, -1 on `max_bounds`
// overflow, or -3 when the input shape wants the serial path (degenerate
// single-leaf tree, or a region too small to split).
int64_t huffc_spec_index(const uint8_t* comp, uint64_t start_bit,
                         uint64_t end_bit, const int16_t* next_state,
                         const uint8_t* emit_count,
                         const uint8_t* last_emit_bit, const int32_t* left,
                         const int32_t* right, const int16_t* state_of_node,
                         const int32_t* node_of_state, int32_t root,
                         uint64_t block_len, uint64_t* boundaries,
                         int64_t max_bounds, uint64_t* inout_in_block,
                         uint64_t* resume_bit, int num_threads) {
  if (block_len == 0 || left[root] < 0) return -3;
  int T = num_threads > 1 ? num_threads : 1;
  uint64_t first_full = (start_bit + 7) & ~7ull;
  if (first_full > end_bit) first_full = end_bit;
  uint64_t last_full = end_bit & ~7ull;
  if (last_full < first_full) last_full = first_full;
  uint64_t full_bytes = (last_full - first_full) >> 3;
  if (T == 1 || full_bytes < (uint64_t)T * (256 << 10)) return -3;

  const uint64_t carried = inout_in_block ? *inout_in_block : 0;
  // m-th boundary (1-based) sits after absolute letter m*block_len-carried
  auto bound_slot = [&](uint64_t abs_letters) -> int64_t {
    // number of boundaries at absolute letter counts <= abs_letters
    return (int64_t)((carried + abs_letters) / block_len -
                     carried / block_len);
  };

  // prologue: per-bit walk to the first byte boundary (true parse)
  uint64_t abs_letters = 0;
  uint64_t glob_last_end = start_bit;
  int64_t nb_total = 0;
  bool overflow = false;
  auto emit_boundary_checked = [&](uint64_t endb) {
    ++abs_letters;
    glob_last_end = endb;
    if ((carried + abs_letters) % block_len == 0) {
      int64_t slot = bound_slot(abs_letters) - 1;
      if (slot >= max_bounds) {
        overflow = true;
        return;
      }
      boundaries[slot] = endb;
      if (slot + 1 > nb_total) nb_total = slot + 1;
    }
  };
  int32_t node = walk_bits_fn(comp, start_bit, first_full, left, right,
                              root, root, emit_boundary_checked);
  if (overflow) return -1;

  // phase 1: parallel speculative chunk walks
  std::vector<SpecChunk> chunks((size_t)T);
  uint64_t per = full_bytes / T;
  for (int t = 0; t < T; ++t) {
    chunks[t].begin_bit = first_full + (uint64_t)t * per * 8;
    chunks[t].end_bit = (t == T - 1) ? last_full
                                     : first_full + (uint64_t)(t + 1) * per * 8;
  }
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; ++t) {
      int16_t st0 = (t == 0) ? state_of_node[node] : state_of_node[root];
      threads.emplace_back([&, t, st0] {
        spec_walk(comp, &chunks[t], next_state, emit_count, last_emit_bit,
                  st0);
      });
    }
    for (auto& th : threads) th.join();
  }

  // phase 2: serial seam reconciliation (windows only; full re-walk on a
  // failed seam).  Tracks true absolute letters through the chain.
  chunks[0].abs_before = abs_letters;
  chunks[0].splice_bit = chunks[0].begin_bit;
  chunks[0].spec_at_splice = 0;
  chunks[0].true_prefix = 0;
  int16_t true_state = 0;  // true DFA state at the NEXT chunk's begin
  {
    uint64_t a = abs_letters + chunks[0].letters;
    true_state = chunks[0].end_state;  // chunk 0 walked from truth
    uint64_t prev_last_end =
        chunks[0].letters ? chunks[0].last_emit_end : glob_last_end;
    for (int t = 1; t < T; ++t) {
      SpecChunk& c = chunks[t];
      c.abs_before = a;
      // walk the seam window from the true state, comparing per byte;
      // any block boundaries inside the (true) prefix are placed on the
      // spot (absolute letter counts are known here)
      uint64_t W = c.win_state.size();
      int16_t s = true_state;
      uint64_t letters_prefix = 0;
      uint64_t last_end_prefix = 0;
      int64_t splice = -1;
      const uint8_t* cp = comp + (c.begin_bit >> 3);
      for (uint64_t j = 0; j < W; ++j) {
        if (s == c.win_state[(size_t)j]) {
          splice = (int64_t)j;
          break;
        }
        uint64_t idx = (uint64_t)s * 256 + cp[j];
        unsigned e = emit_count[idx];
        if (e) {
          uint64_t before = a + letters_prefix;
          uint64_t after = before + e;
          if ((carried + before) / block_len !=
              (carried + after) / block_len) {
            int32_t nd = node_of_state[s];
            uint64_t bb = c.begin_bit + j * 8;
            uint64_t cnt = before;
            walk_bits_fn(comp, bb, bb + 8, left, right, nd, root,
                         [&](uint64_t endb) {
                           ++cnt;
                           if ((carried + cnt) % block_len == 0) {
                             int64_t slot = bound_slot(cnt) - 1;
                             if (slot >= max_bounds)
                               overflow = true;
                             else {
                               boundaries[slot] = endb;
                               if (slot + 1 > nb_total) nb_total = slot + 1;
                             }
                           }
                         });
          }
          letters_prefix += e;
          last_end_prefix = c.begin_bit + j * 8 + last_emit_bit[idx] + 1;
        }
        s = next_state[idx];
      }
      if (overflow) return -1;
      if (splice < 0) {
        // adversarial tree: no coalescence — true-walk the whole chunk
        // serially, resolving its boundaries right here (it is excluded
        // from phase 3)
        c.serial = true;
        uint64_t letters2 = 0;
        uint64_t last_end2 = 0;
        int16_t s2 = true_state;
        uint64_t nf = (c.end_bit - c.begin_bit) >> 3;
        for (uint64_t j = 0; j < nf; ++j) {
          uint64_t idx = (uint64_t)s2 * 256 + cp[j];
          unsigned e = emit_count[idx];
          if (e) {
            uint64_t before = a + letters2;
            uint64_t after = before + e;
            if ((carried + before) / block_len !=
                (carried + after) / block_len) {
              int32_t nd = node_of_state[s2];
              uint64_t bb = c.begin_bit + j * 8;
              uint64_t cnt = before;
              walk_bits_fn(comp, bb, bb + 8, left, right, nd, root,
                           [&](uint64_t endb) {
                             ++cnt;
                             if ((carried + cnt) % block_len == 0) {
                               int64_t slot = bound_slot(cnt) - 1;
                               if (slot >= max_bounds)
                                 overflow = true;
                               else {
                                 boundaries[slot] = endb;
                                 if (slot + 1 > nb_total)
                                   nb_total = slot + 1;
                               }
                             }
                           });
            }
            letters2 += e;
            last_end2 = c.begin_bit + j * 8 + last_emit_bit[idx] + 1;
          }
          s2 = next_state[idx];
        }
        if (overflow) return -1;
        c.letters = letters2;
        c.last_emit_end = last_end2 ? last_end2 : prev_last_end;
        c.end_state = s2;
        a += letters2;
        true_state = s2;
        prev_last_end = c.last_emit_end;
        continue;
      }
      // prefix [begin, splice byte) boundaries were placed in the seam
      // walk above (true parse with absolute counts)
      c.true_prefix = letters_prefix;
      c.spec_at_splice = c.win_letters[(size_t)splice];
      c.splice_bit = c.begin_bit + (uint64_t)splice * 8;
      uint64_t after_splice = c.letters - c.spec_at_splice;
      a += letters_prefix + after_splice;
      true_state = c.end_state;  // coalesced => spec end state is true
      if (after_splice)
        prev_last_end = c.last_emit_end;
      else if (letters_prefix)
        prev_last_end = last_end_prefix;
      continue;
    }
    abs_letters = a;
    glob_last_end = prev_last_end;
    node = node_of_state[true_state];
  }

  // phase 3: parallel boundary resolution inside each chunk's spliced
  // region via the anchor lists
  {
    std::atomic<bool> ovf(false);
    std::atomic<int64_t> max_slot(nb_total);
    std::vector<std::thread> threads;
    for (int t = 0; t < T; ++t) {
      threads.emplace_back([&, t] {
        const SpecChunk& c = chunks[t];
        if (c.serial) return;  // boundaries already placed in phase 2
        // absolute letters at the splice point
        uint64_t A = c.abs_before + c.true_prefix;
        uint64_t A_end = A + (c.letters - c.spec_at_splice);
        // boundaries with absolute letter count in (A, A_end]
        uint64_t m_lo = (carried + A) / block_len + 1;
        uint64_t m_hi = (carried + A_end) / block_len;
        for (uint64_t m = m_lo; m <= m_hi; ++m) {
          uint64_t abs_target = m * block_len - carried;
          // chunk-local spec letter index of the target
          uint64_t loc = abs_target - A + c.spec_at_splice;
          // start from the best anchor at or before `loc` (or the splice;
          // anchors before the splice describe the WRONG parse and are
          // rejected by the bit/letters guards)
          uint64_t from_bit = c.splice_bit;
          uint64_t from_letters = c.spec_at_splice;
          int16_t from_state =
              c.win_state[(size_t)((c.splice_bit - c.begin_bit) >> 3)];
          if (!c.anchor_letters.empty()) {
            // last anchor with letters STRICTLY below the target: an
            // anchor at letters == loc is already past the target
            // letter's end (its bit offset is unrecoverable from there)
            size_t lo = 0, hi = c.anchor_letters.size();
            while (lo < hi) {
              size_t mid = (lo + hi) / 2;
              if (c.anchor_letters[mid] < loc)
                lo = mid + 1;
              else
                hi = mid;
            }
            if (lo > 0) {
              size_t k = lo - 1;
              if (c.anchor_bit[k] >= c.splice_bit &&
                  c.anchor_letters[k] >= c.spec_at_splice &&
                  c.anchor_letters[k] >= from_letters) {
                from_bit = c.anchor_bit[k];
                from_letters = c.anchor_letters[k];
                from_state = c.anchor_state[k];
              }
            }
          }
          // byte-walk from the anchor until the target letter's byte
          int16_t s = from_state;
          uint64_t l = from_letters;
          const uint8_t* cp2 = comp + (from_bit >> 3);
          uint64_t j = 0;
          uint64_t found = 0;
          while (from_bit + j * 8 < c.end_bit) {
            uint64_t idx = (uint64_t)s * 256 + cp2[j];
            unsigned e = emit_count[idx];
            if (e && l + e >= loc) {
              // the target letter ends inside this byte: per-bit finish
              int32_t nd = node_of_state[s];
              uint64_t bb = from_bit + j * 8;
              uint64_t cnt = l;
              walk_bits_fn(comp, bb, bb + 8, left, right, nd, root,
                           [&](uint64_t endb) {
                             if (++cnt == loc && !found) found = endb;
                           });
              break;
            }
            l += e;
            s = next_state[idx];
            ++j;
          }
          if (!found) {
#ifdef HUFFC_SPEC_DEBUG
            fprintf(stderr,
                    "specdbg t=%d m=%llu loc=%llu A=%llu Aend=%llu "
                    "from_letters=%llu from_bit=%llu splice_bit=%llu "
                    "spec_at_splice=%llu letters=%llu l=%llu j=%llu\n",
                    t, (unsigned long long)m, (unsigned long long)loc,
                    (unsigned long long)A, (unsigned long long)A_end,
                    (unsigned long long)from_letters,
                    (unsigned long long)from_bit,
                    (unsigned long long)c.splice_bit,
                    (unsigned long long)c.spec_at_splice,
                    (unsigned long long)c.letters, (unsigned long long)l,
                    (unsigned long long)j);
#endif
            ovf.store(true);  // unreachable by construction; fail safe
            return;
          }
          int64_t slot = (int64_t)(m - carried / block_len) - 1;
          if (slot >= max_bounds) {
            ovf.store(true);
            return;
          }
          boundaries[slot] = found;
          int64_t want = slot + 1;
          int64_t cur = max_slot.load();
          while (cur < want && !max_slot.compare_exchange_weak(cur, want)) {
          }
        }
      });
    }
    for (auto& th : threads) th.join();
    if (ovf.load()) return -1;
    nb_total = max_slot.load();
  }

  // tail: per-bit walk of the final partial byte from the true state
  {
    uint64_t cnt = abs_letters;
    node = walk_bits_fn(comp, last_full, end_bit, left, right, node, root,
                        [&](uint64_t endb) {
                          ++cnt;
                          glob_last_end = endb;
                          if ((carried + cnt) % block_len == 0) {
                            int64_t slot = bound_slot(cnt) - 1;
                            if (slot >= max_bounds)
                              overflow = true;
                            else {
                              boundaries[slot] = endb;
                              if (slot + 1 > nb_total) nb_total = slot + 1;
                            }
                          }
                        });
    if (overflow) return -1;
    abs_letters = cnt;
  }
  if (resume_bit) *resume_bit = glob_last_end;
  if (inout_in_block) *inout_in_block = (carried + abs_letters) % block_len;
  return nb_total;
}

// Gather per-block u32 word rows from a packed payload: row k =
// words[starts_w[k] .. starts_w[k]+row_words).  Feeds the device decode
// kernels' (B, W) lane layout; threaded memcpy at memory-bandwidth speed
// (the numpy fancy-index equivalent materializes a B*W int64 index array
// larger than the data itself).  Out-of-range tail words read as zero.
void huffc_extract_rows(const uint32_t* words, uint64_t n_words,
                        const uint64_t* starts_w, int64_t n_rows,
                        int64_t row_words, uint32_t* out, int num_threads) {
  int t = num_threads > 1 ? num_threads : 1;
  if (t == 1 || n_rows < 64) {
    for (int64_t k = 0; k < n_rows; ++k) {
      uint64_t s = starts_w[k];
      uint64_t avail = s < n_words ? n_words - s : 0;
      uint64_t take = avail < (uint64_t)row_words ? avail : (uint64_t)row_words;
      std::memcpy(out + (uint64_t)k * row_words, words + s, take * 4);
      if (take < (uint64_t)row_words)
        std::memset(out + (uint64_t)k * row_words + take, 0,
                    ((uint64_t)row_words - take) * 4);
    }
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rows + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    int64_t lo = (int64_t)w * per, hi = std::min<int64_t>(lo + per, n_rows);
    if (lo >= hi) continue;
    threads.emplace_back([=] {
      huffc_extract_rows(words, n_words, starts_w + lo, hi - lo, row_words,
                         out + (uint64_t)lo * row_words, 1);
    });
  }
  for (auto& th : threads) th.join();
}

// OR-copy a single bit range (exported for host-side stitching).
void huffc_or_copy(const uint8_t* src, uint64_t src_bits, uint8_t* dst,
                   uint64_t dst_bit) {
  or_shift_copy(src, src_bits, dst, dst_bit);
}

// Threaded independent-block encode + bit-carry stitch + per-block index:
// the whole-chunk form of the `.hf2` writer's block loop (one call per
// streaming chunk instead of one FFI call per 64 KiB block — the python
// loop's per-call overhead matched the actual encode cost).  Semantics per
// block match huffc_encode at start_bit = prefix-sum of earlier blocks'
// bit lengths; `bit_lens[k]` receives block k's exact bit count (the
// `.hf2` table entries).  `out` must be zeroed.  Threads own contiguous
// block runs; run-boundary blocks are merged serially afterwards so seam
// bytes (shared by adjacent blocks) are never raced (same ownership rule
// as huffc_stitch_blocks).  Returns total bits, -1 on overflow, -2 on a
// letter with no code (reference CompressError, comp.rs:427-432).
int64_t huffc_encode_blocks(const uint8_t* data, uint64_t n,
                            uint64_t block_len, const uint8_t* len_lut,
                            const uint64_t* code_lut, uint8_t* out,
                            uint64_t out_cap, uint64_t* bit_lens,
                            int num_threads) {
  if (block_len == 0) return -3;
  int64_t nb = (int64_t)((n + block_len - 1) / block_len);
  if (nb == 0) return 0;
  uint64_t hist[256];
  huffc_hist(data, n, num_threads, hist);
  int max_len = 0, min_len = 0;
  for (int b = 0; b < 256; ++b) {
    if (hist[b]) {
      if (len_lut[b] == 0) return -2;
      if (len_lut[b] > max_len) max_len = len_lut[b];
      if (min_len == 0 || len_lut[b] < min_len) min_len = len_lut[b];
    }
  }
  int t = num_threads > 1 ? num_threads : 1;
  if (nb < 2 * t) t = 1;
  // seam-byte ownership (skip each run's first block, merge serially)
  // only prevents cross-thread byte sharing when every FULL block spans
  // >= 8 bits; with tiny blocks or 1-bit codes thread-adjacent blocks
  // could share a seam byte and race the non-atomic |= — serialize then
  if (block_len * (uint64_t)(min_len ? min_len : 1) < 8) t = 1;
  int64_t per = (nb + t - 1) / t;
  // pass 1 (parallel): exact per-block bit lengths
  {
    std::vector<std::thread> threads;
    for (int w = 0; w < t; ++w) {
      int64_t lo = (int64_t)w * per, hi = std::min<int64_t>(lo + per, nb);
      if (lo >= hi) continue;
      threads.emplace_back([=] {
        for (int64_t k = lo; k < hi; ++k) {
          uint64_t a = (uint64_t)k * block_len;
          uint64_t b2 = std::min<uint64_t>(a + block_len, n);
          // 4 accumulators hide the L1 len_lut load latency (the single
          // dependent add chain ran at ~4-5 cycles/byte)
          uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
          uint64_t i = a;
          for (; i + 4 <= b2; i += 4) {
            s0 += len_lut[data[i]];
            s1 += len_lut[data[i + 1]];
            s2 += len_lut[data[i + 2]];
            s3 += len_lut[data[i + 3]];
          }
          uint64_t bits = s0 + s1 + s2 + s3;
          for (; i < b2; ++i) bits += len_lut[data[i]];
          bit_lens[k] = bits;
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  std::vector<uint64_t> offs((size_t)nb + 1);
  offs[0] = 0;
  for (int64_t k = 0; k < nb; ++k) offs[k + 1] = offs[k] + bit_lens[k];
  if ((offs[nb] + 7) / 8 + 8 > out_cap) return -1;
  uint64_t row_bytes = (block_len * (uint64_t)(max_len ? max_len : 1)) / 8 + 16;
  // pass 2 (parallel): pack each block into a reused thread-local scratch
  // row, OR-shift it into place; run-boundary blocks go serially after
  {
    std::vector<std::thread> threads;
    for (int w = 0; w < t; ++w) {
      int64_t lo = (int64_t)w * per, hi = std::min<int64_t>(lo + per, nb);
      if (lo >= hi) continue;
      threads.emplace_back([=] {
        std::vector<uint8_t> sc0(row_bytes, 0), sc1(row_bytes, 0);
        int64_t k = lo + (t > 1 ? 1 : 0);
        while (k < hi) {
          while (k < hi && !bit_lens[k]) ++k;
          if (k >= hi) break;
          int64_t k2 = k + 1;
          while (k2 < hi && !bit_lens[k2]) ++k2;
          uint64_t a0 = (uint64_t)k * block_len;
          uint64_t e0 = std::min<uint64_t>(a0 + block_len, n);
          if (k2 < hi) {
            uint64_t a1 = (uint64_t)k2 * block_len;
            uint64_t e1 = std::min<uint64_t>(a1 + block_len, n);
            encode_two(data + a0, e0 - a0, sc0.data(), data + a1, e1 - a1,
                       sc1.data(), len_lut, code_lut);
            or_shift_copy(sc0.data(), bit_lens[k], out, offs[k]);
            or_shift_copy(sc1.data(), bit_lens[k2], out, offs[k2]);
            std::memset(sc0.data(), 0, (bit_lens[k] + 7) / 8 + 8);
            std::memset(sc1.data(), 0, (bit_lens[k2] + 7) / 8 + 8);
            k = k2 + 1;
          } else {
            encode_range(data + a0, e0 - a0, len_lut, code_lut, sc0.data());
            or_shift_copy(sc0.data(), bit_lens[k], out, offs[k]);
            std::memset(sc0.data(), 0, (bit_lens[k] + 7) / 8 + 8);
            k = k2;
          }
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  if (t > 1) {
    std::vector<uint8_t> scratch(row_bytes, 0);
    for (int w = 0; w < t; ++w) {
      int64_t lo = (int64_t)w * per;
      if (lo >= nb || !bit_lens[lo]) continue;
      uint64_t a = (uint64_t)lo * block_len;
      uint64_t b2 = std::min<uint64_t>(a + block_len, n);
      encode_range(data + a, b2 - a, len_lut, code_lut, scratch.data());
      or_shift_copy(scratch.data(), bit_lens[lo], out, offs[lo]);
      std::memset(scratch.data(), 0, (bit_lens[lo] + 7) / 8 + 8);
    }
  }
  return (int64_t)offs[nb];
}

// Stitch n_blocks bitstreams (rows of `srcs`, row stride `row_bytes`, row k
// holding bit_lens[k] bits) into `dst` starting at start_bit.  The correct
// bit-carry concat of the block outputs — what the reference CLI's seek-back
// stitch should have been (huff/src/comp.rs:187-226, SURVEY §2 quirk).
// dst must be zeroed; returns total bits, or -1 if dst_cap (bytes) too small.
int64_t huffc_stitch_blocks(const uint8_t* srcs, uint64_t row_bytes,
                            const uint64_t* bit_lens, int64_t n_blocks,
                            uint8_t* dst, uint64_t dst_cap, uint64_t start_bit,
                            int num_threads) {
  std::vector<uint64_t> offs((size_t)n_blocks + 1);
  offs[0] = start_bit;
  for (int64_t k = 0; k < n_blocks; ++k) offs[k + 1] = offs[k] + bit_lens[k];
  uint64_t total = offs[n_blocks];
  if ((total + 7) / 8 + 1 > dst_cap) return -1;
  int t = num_threads > 1 ? num_threads : 1;
  if (t == 1 || n_blocks < 4) {
    for (int64_t k = 0; k < n_blocks; ++k)
      if (bit_lens[k])
        or_shift_copy(srcs + (uint64_t)k * row_bytes, bit_lens[k], dst, offs[k]);
    return (int64_t)(total - start_bit);
  }
  // Parallel: every byte write is either to a block's exclusive interior or
  // an OR into a seam byte shared by exactly two ADJACENT blocks.  A thread
  // owns a contiguous run of blocks, so the only cross-thread seams are at
  // run boundaries; those boundary blocks are stitched serially afterwards.
  std::vector<std::thread> threads;
  int64_t per = (n_blocks + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    int64_t lo = (int64_t)w * per, hi = std::min<int64_t>(lo + per, n_blocks);
    if (lo >= hi) continue;
    threads.emplace_back([&, lo, hi] {
      for (int64_t k = lo + 1; k < hi; ++k)
        if (bit_lens[k])
          or_shift_copy(srcs + (uint64_t)k * row_bytes, bit_lens[k], dst,
                        offs[k]);
    });
  }
  for (auto& th : threads) th.join();
  for (int w = 0; w < t; ++w) {
    int64_t lo = (int64_t)w * per;
    if (lo < n_blocks && bit_lens[lo])
      or_shift_copy(srcs + (uint64_t)lo * row_bytes, bit_lens[lo], dst,
                    offs[lo]);
  }
  return (int64_t)(total - start_bit);
}

}  // extern "C"
