// Host-side lossless entropy-coding core.
//
// Re-implementation (from scratch, C++17) of the coding algorithm of the
// reference's lossless layer (kodak_tensorflow/lossless/c++/source/):
// a 16-bit-precision static-probability binary arithmetic coder with
// E1/E2 renormalization and an E3-scaling counter, plus UEG0
// binarization of int16 symbols: a truncated-unary prefix driven through
// the arithmetic coder with per-index probabilities, an Exp-Golomb-0
// suffix and a sign bit written raw to a bypass stream.
//
// Bit-exactness notes (the bpp parity budget is <=1%):
//  * PRECISION = 16; the interval split point is
//    low + floor(p0 * (high - low)) computed in double
//    (reference BinaryArithmeticCoder.cpp:154).
//  * stop_encoding flushes one disambiguation bit plus the queued E3
//    scalings + 1 inverted bits (reference :61-102).
//  * start_decoding preloads 16 bits (reference :104-122).

#pragma once

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace aeic {

// Growable bit buffer with separate read/write cursors (LSB-first within
// each byte). Unlike the reference's fixed-capacity Bitstream, capacity
// grows on demand, so callers need no worst-case sizing. Writes go
// through a 64-bit staging word so the hot path is branch-light (one
// growth check per 64 bits instead of per bit), and runs of bits can be
// appended in one call (push_bits) - the serialized *bit order* is
// identical to bit-by-bit pushes, so bitstreams stay bit-exact with the
// reference coder.
class BitVec {
 public:
  // Pre-sizes the word store (hot callers know the expected stream
  // length; growth still happens automatically past the reservation).
  void reserve_bits(std::uint64_t nb_bits) {
    words_.reserve(static_cast<std::size_t>((nb_bits >> 6) + 1));
  }

  void push(uint8_t bit) {
    staging_ |= static_cast<uint64_t>(bit & 0x1u) << (write_pos_ & 63);
    ++write_pos_;
    if ((write_pos_ & 63) == 0) {
      words_.push_back(staging_);
      staging_ = 0;
    }
  }

  // Appends `n` bits at once; bit i of `value` becomes the i-th pushed
  // bit (bits of `value` at positions >= n must be zero). n <= 57 so
  // the straddle below spills at most one word. The preconditions are
  // asserted so a violating caller fails loudly in test builds instead
  // of silently corrupting the stream.
  void push_bits(uint64_t value, uint32_t n) {
    assert(n <= 57 && (n == 64 || (value >> n) == 0));
    const uint32_t offset = static_cast<uint32_t>(write_pos_ & 63);
    staging_ |= value << offset;
    write_pos_ += n;
    if (offset + n >= 64) {
      words_.push_back(staging_);
      staging_ = (offset == 0) ? 0 : (value >> (64 - offset));
    }
  }

  // Reads one bit; returns 0 past the end (the reference tolerates
  // exhausted streams during decoder renormalization by leaving the
  // shift register's fresh bits at 0).
  uint8_t pull() {
    if (read_pos_ >= write_pos_) return 0;
    const std::size_t word = static_cast<std::size_t>(read_pos_ >> 6);
    const uint64_t source =
        (word < words_.size()) ? words_[word] : staging_;  // tail still staged
    const uint8_t bit = static_cast<uint8_t>((source >> (read_pos_ & 63)) & 0x1u);
    ++read_pos_;
    return bit;
  }

  // Pulls `n` (<= 16) bits with the FIRST pulled bit as the result's
  // MSB (the decoder shift-register order: v = (v<<1)|pull() n times).
  // Past-the-end bits read as 0, like pull().
  uint32_t pull_msb_first(uint32_t n) {
    uint32_t value = 0;
    uint32_t got = 0;
    while (got < n) {
      if (read_pos_ >= write_pos_) {
        return value << (n - got);  // zero-fill the exhausted tail
      }
      const std::size_t word = static_cast<std::size_t>(read_pos_ >> 6);
      const uint64_t source =
          (word < words_.size()) ? words_[word] : staging_;
      const uint32_t offset = static_cast<uint32_t>(read_pos_ & 63);
      uint32_t take = n - got;
      if (take > 64 - offset) take = 64 - offset;
      const std::uint64_t left = write_pos_ - read_pos_;
      if (take > left) take = static_cast<uint32_t>(left);
      const uint32_t chunk = static_cast<uint32_t>(
          (source >> offset) & ((1ull << take) - 1));
      // chunk holds the bits in stored (pull) order at positions
      // 0..take-1; MSB-first append needs them reversed over `take`.
      value = (value << take) |
              (reverse_bits16(chunk) >> (16 - take));
      read_pos_ += take;
      got += take;
    }
    return value;
  }

  bool exhausted() const { return read_pos_ >= write_pos_; }
  std::uint64_t occupancy_in_bits() const { return write_pos_ - read_pos_; }
  std::uint64_t size_in_bits() const { return write_pos_; }

  // Materializes the LSB-first byte image including the partially
  // filled tail (if any). Byte k holds bits [8k, 8k+8) regardless of
  // host endianness.
  std::vector<uint8_t> bytes() const {
    const std::size_t nb_bytes = static_cast<std::size_t>((write_pos_ + 7) >> 3);
    std::vector<uint8_t> out(nb_bytes);
    std::size_t i = 0;
    for (std::size_t w = 0; w < words_.size() && i < nb_bytes; ++w) {
      for (uint32_t b = 0; b < 8 && i < nb_bytes; ++b) {
        out[i++] = static_cast<uint8_t>(words_[w] >> (8 * b));
      }
    }
    for (uint32_t b = 0; b < 8 && i < nb_bytes; ++b) {
      out[i++] = static_cast<uint8_t>(staging_ >> (8 * b));
    }
    return out;
  }

  // Replaces the content with an external byte image. Pushing after a
  // load whose bit count is not byte-aligned is unsupported (decode-
  // only usage).
  void load(const uint8_t* bytes, std::uint64_t nb_bits) {
    const std::size_t nb_bytes = static_cast<std::size_t>((nb_bits + 7) >> 3);
    words_.assign((nb_bytes + 7) >> 3, 0);
    for (std::size_t i = 0; i < nb_bytes; ++i) {
      words_[i >> 3] |= static_cast<uint64_t>(bytes[i]) << (8 * (i & 7));
    }
    write_pos_ = nb_bits;
    read_pos_ = 0;
    staging_ = 0;
  }

 private:
  static uint32_t reverse_bits16(uint32_t x) {
    x = ((x & 0x5555u) << 1) | ((x >> 1) & 0x5555u);
    x = ((x & 0x3333u) << 2) | ((x >> 2) & 0x3333u);
    x = ((x & 0x0F0Fu) << 4) | ((x >> 4) & 0x0F0Fu);
    return ((x & 0x00FFu) << 8) | ((x >> 8) & 0x00FFu);
  }

  std::vector<uint64_t> words_;
  std::uint64_t write_pos_ = 0;
  std::uint64_t read_pos_ = 0;
  uint64_t staging_ = 0;
};

// 16-bit static-probability binary range coder.
class RangeCoder16 {
 public:
  static constexpr uint32_t kPrecision = 16;
  static constexpr uint32_t kRangeMax = (1u << kPrecision) - 1;   // 0xFFFF
  static constexpr uint32_t kHalf = kRangeMax >> 1;               // 0x7FFF
  static constexpr uint32_t kQuarter = kHalf >> 1;                // 0x3FFF
  static constexpr uint32_t kThreeQuarters = 3 * kQuarter;
  static constexpr uint32_t kTopBit = 1u << (kPrecision - 1);

  explicit RangeCoder16(BitVec& stream) : stream_(stream) {}

  // Probability-domain check. Hoisted out of the per-bit hot path by
  // callers whose probability table is fixed for the whole stream
  // (Ueg0Codec validates its table once at construction and then uses
  // the *_unchecked entries).
  static void validate_p0(double p0) {
    if (std::isnan(p0) || p0 <= 0.0 || p0 >= 1.0) {
      throw std::invalid_argument("probability must lie in ]0, 1[");
    }
  }

  // Encodes one binary decision; p0 is the probability the bit is 0.
  void encode(uint8_t bit, double p0) {
    validate_p0(p0);
    encode_unchecked(bit, p0);
  }

  // Same coding behavior as encode() without the per-bit domain check;
  // only for callers that already ran validate_p0 on their table.
  //
  // The E1/E2 renormalization is batched: one iteration of the
  // reference's loop emits one common leading bit of (low, high) and
  // shifts both left (subtracting kHalf+1 before the shift when the
  // bit is set is the same as masking to 16 bits after it), and an E3
  // straddle can never re-create a common leading bit (after an E3
  // shift the tops still differ). So the number of E1/E2 iterations is
  // exactly the common-prefix length of low^high, all its bits can be
  // emitted in one go (queued E3 inversions follow the FIRST emitted
  // bit only - the queue is empty afterwards), and the shifts collapse
  // to one. The emitted bitstream is bit-identical to the per-bit loop
  // (differentially tested against the reference coder).
  void encode_unchecked(uint8_t bit, double p0) {
    split(p0);
    if (bit & 0x1u) {
      low_ = middle_ + 1;
    } else {
      high_ = middle_;
    }
    const uint32_t diff = (low_ ^ high_) & kRangeMax;
    const uint32_t n =
        diff ? static_cast<uint32_t>(__builtin_clz(diff)) - (32 - kPrecision)
             : kPrecision;
    if (n != 0) {
      const uint32_t prefix = low_ >> (kPrecision - n);  // common top bits
      const uint8_t first = static_cast<uint8_t>((prefix >> (n - 1)) & 0x1u);
      stream_.push(first);
      flush_e3(first);
      if (n > 1) {
        // Remaining common bits, MSB-first = low (n-1) bits of the
        // prefix reversed into push order.
        const uint32_t w = n - 1;
        const uint32_t tail = prefix & ((1u << w) - 1);
        stream_.push_bits(reverse_bits(tail) >> (kPrecision - 1 - w), w);
      }
      low_ = (low_ << n) & kRangeMax;
      high_ = ((high_ << n) & kRangeMax) | ((1u << n) - 1);
    }
    while (low_ > kQuarter && high_ <= kThreeQuarters) {
      high_ -= kQuarter + 1;
      low_ -= kQuarter + 1;
      high_ = (high_ << 1) | 0x1u;
      low_ <<= 1;
      ++nb_e3_;
    }
  }

  // Terminates encoding: one disambiguation bit + queued E3 inversions.
  void stop_encoding() {
    ++nb_e3_;
    const uint8_t out = (low_ < kQuarter) ? 0 : 1;
    stream_.push(out);
    flush_e3(out);
    low_ = 0;
    middle_ = kHalf;
    high_ = kRangeMax;
    nb_e3_ = 0;
  }

  // Preloads the decoder shift register with kPrecision bits.
  void start_decoding() {
    code_ = 0;
    for (uint32_t i = 0; i < kPrecision; ++i) {
      code_ = (code_ << 1) | stream_.pull();
    }
  }

  uint8_t decode(double p0) {
    validate_p0(p0);
    return decode_unchecked(p0);
  }

  // Counterpart of encode_unchecked for decoding, with the E1/E2
  // renormalization batched the same way (see encode_unchecked): the
  // E1/E2 iteration count equals the common-prefix length of
  // (low, high), the subtract-then-shift equals shift-then-mask, and
  // code_ refills its shifted-out bits from the stream in one
  // multi-bit read. State trajectory is identical to the per-bit loop.
  uint8_t decode_unchecked(double p0) {
    split(p0);
    uint8_t bit = 0;
    if (code_ >= low_ && code_ <= middle_) {
      high_ = middle_;
      bit = 0;
    } else {
      low_ = middle_ + 1;
      bit = 1;
    }
    const uint32_t diff = (low_ ^ high_) & kRangeMax;
    const uint32_t n =
        diff ? static_cast<uint32_t>(__builtin_clz(diff)) - (32 - kPrecision)
             : kPrecision;
    if (n != 0) {
      low_ = (low_ << n) & kRangeMax;
      high_ = ((high_ << n) & kRangeMax) | ((1u << n) - 1);
      code_ = ((code_ << n) & kRangeMax) | stream_.pull_msb_first(n);
    }
    while (low_ > kQuarter && high_ <= kThreeQuarters) {
      high_ -= kQuarter + 1;
      low_ -= kQuarter + 1;
      code_ -= kQuarter + 1;
      high_ = ((high_ << 1) & kRangeMax) | 0x1u;
      low_ = (low_ << 1) & kRangeMax;
      code_ = ((code_ << 1) & kRangeMax) | stream_.pull();
    }
    return bit;
  }

 private:
  // Bit reversal over kPrecision-1 = 15 bits (the widest possible
  // common-prefix tail after the first emitted bit).
  static uint32_t reverse_bits(uint32_t x) {
    x = ((x & 0x5555u) << 1) | ((x >> 1) & 0x5555u);
    x = ((x & 0x3333u) << 2) | ((x >> 2) & 0x3333u);
    x = ((x & 0x0F0Fu) << 4) | ((x >> 4) & 0x0F0Fu);
    x = ((x & 0x00FFu) << 8) | ((x >> 8) & 0x00FFu);  // reversed over 16
    return x >> 1;                                     // over 15
  }

  void split(double p0) {
    // p0 was validated before the hot loop (validate_p0). The cast's
    // truncation equals std::floor for this non-negative product, so
    // the split point stays bit-identical to the reference's
    // floor-based computation (BinaryArithmeticCoder.cpp:154).
    middle_ = low_ + static_cast<uint32_t>(p0 * static_cast<double>(high_ - low_));
  }

  void flush_e3(uint8_t emitted) {
    // The queued E3 scalings all emit the inversion of the bit that was
    // just written; push them as 32-bit runs (bit order unchanged).
    const uint64_t fill = (emitted & 0x1u) ? 0 : ~0ull;
    uint32_t remaining = nb_e3_;
    while (remaining > 0) {
      const uint32_t chunk = remaining < 32 ? remaining : 32;
      stream_.push_bits(fill & ((1ull << chunk) - 1), chunk);
      remaining -= chunk;
    }
    nb_e3_ = 0;
  }

  BitVec& stream_;
  uint32_t low_ = 0;
  uint32_t middle_ = kHalf;
  uint32_t high_ = kRangeMax;
  uint32_t nb_e3_ = 0;
  uint32_t code_ = 0;
};

// UEG0 symbol codec over a (range coder, bypass stream) pair.
//
// |symbol| is split into a truncated-unary prefix of at most `tu_len`
// ones (each arithmetic-coded with its per-index zero-probability), an
// EG0 suffix of |symbol| - tu_len when the prefix saturates (bypass),
// and a raw sign bit for nonzero symbols (bypass).
class Ueg0Codec {
 public:
  Ueg0Codec(BitVec& bac_stream, BitVec& bypass_stream, uint8_t tu_len,
            const double* probabilities)
      : coder_(bac_stream), bypass_(bypass_stream), tu_len_(tu_len),
        probs_(probabilities, probabilities + tu_len) {
    // One table validation up front instead of one check per coded bit
    // (the per-index probabilities are fixed for the whole stream).
    for (double p0 : probs_) RangeCoder16::validate_p0(p0);
  }

  void write(int16_t symbol) {
    const uint16_t magnitude = static_cast<uint16_t>(std::abs(symbol));
    write_truncated_unary(magnitude);
    if (magnitude >= tu_len_) {
      // EG0 suffix + sign assembled into ONE bypass append (identical
      // bit order to the bit-by-bit writes; magnitude >= tu_len >= 1
      // implies the symbol is nonzero, so the sign always follows).
      const uint32_t value_plus_1 =
          static_cast<uint32_t>(magnitude - tu_len_) + 1;
      uint32_t nb_bits = 0;
      while ((value_plus_1 >> nb_bits) != 0) ++nb_bits;
      const uint32_t k = nb_bits - 1;          // <= 15 for int16 input
      const uint32_t suffix = value_plus_1 - (1u << k);
      uint64_t pattern = (1ull << k) - 1;      // k prefix ones, then a 0
      for (uint32_t i = 0; i < k; ++i) {       // suffix, MSB first
        pattern |= static_cast<uint64_t>((suffix >> (k - 1 - i)) & 0x1u)
                   << (k + 1 + i);
      }
      pattern |= static_cast<uint64_t>(symbol > 0 ? 1 : 0) << (2 * k + 1);
      bypass_.push_bits(pattern, 2 * k + 2);   // <= 33 bits
    } else if (symbol != 0) {
      bypass_.push(symbol > 0 ? 1 : 0);
    }
  }

  int16_t read() {
    uint16_t magnitude = read_truncated_unary();
    if (magnitude == tu_len_) {
      magnitude = static_cast<uint16_t>(magnitude + read_eg0());
    }
    int16_t symbol = static_cast<int16_t>(magnitude);
    if (symbol != 0 && bypass_.pull() == 0) symbol = static_cast<int16_t>(-symbol);
    return symbol;
  }

  void stop_encoding() { coder_.stop_encoding(); }
  void start_decoding() { coder_.start_decoding(); }

 private:
  void write_truncated_unary(uint16_t magnitude) {
    uint16_t i = 0;
    for (; i < magnitude; ++i) {
      coder_.encode_unchecked(1, probs_[i]);
      if (i == static_cast<uint16_t>(tu_len_ - 1)) return;  // saturated prefix
    }
    coder_.encode_unchecked(0, probs_[i]);
  }

  uint16_t read_truncated_unary() {
    uint16_t value = 0;
    for (uint16_t i = 0;; ++i) {
      if (coder_.decode_unchecked(probs_[i]) == 0) break;
      ++value;
      if (i == static_cast<uint16_t>(tu_len_ - 1)) break;
    }
    return value;
  }

  uint16_t read_eg0() {
    uint32_t nb_bits_minus_1 = 0;
    while (bypass_.pull()) ++nb_bits_minus_1;
    uint32_t value = 0;
    for (uint32_t i = 0; i < nb_bits_minus_1; ++i) {
      value = (value << 1) | bypass_.pull();
    }
    return static_cast<uint16_t>(value + (1u << nb_bits_minus_1) - 1);
  }

  RangeCoder16 coder_;
  BitVec& bypass_;
  uint8_t tu_len_;
  std::vector<double> probs_;
};

}  // namespace aeic
