// C ABI for the lossless coding core (consumed from Python via ctypes).
//
// Mirrors the array-level entry point of the reference
// (kodak_tensorflow/lossless/c++/source/compression.cpp: encode the
// whole int16 array, flush, count bits, then decode back into the
// output array in one call), and extends it with:
//  * a batch entry that codes many maps on a std::thread pool - the
//    per-map independence the reference exploits sequentially
//    (lossless/compression.py:67-81) is embarrassingly parallel;
//  * encode-to-buffer / decode-from-buffer entries for real bitstream
//    export (the reference never persists its bitstreams).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include "coder.hpp"

namespace {

// Round-trips one map; returns total bits (bac + bypass occupancy,
// measured after the flush and before decoding - reference
// compression.cpp:49).
uint32_t roundtrip_map(uint32_t size, const int16_t* input, int16_t* output,
                       uint8_t tu_len, const double* probabilities) {
  aeic::BitVec bac_stream;
  aeic::BitVec bypass_stream;
  bac_stream.reserve_bits(static_cast<std::uint64_t>(size) * 4);
  bypass_stream.reserve_bits(size);
  aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probabilities);
  for (uint32_t i = 0; i < size; ++i) codec.write(input[i]);
  codec.stop_encoding();
  const uint32_t nb_bits = static_cast<uint32_t>(
      bac_stream.occupancy_in_bits() + bypass_stream.occupancy_in_bits());
  codec.start_decoding();
  for (uint32_t i = 0; i < size; ++i) output[i] = codec.read();
  return nb_bits;
}

// Encode-only variant: produces the same bitstreams (and therefore the
// same bit count) as roundtrip_map without the verify-decode pass. The
// serving path uses it once a deployment trusts the coder (the
// differential test against the reference coder and the round-trip
// self-tests cover the equivalence); the research/eval paths keep the
// verifying entry.
uint32_t encode_map_bits(uint32_t size, const int16_t* input, uint8_t tu_len,
                         const double* probabilities) {
  aeic::BitVec bac_stream;
  aeic::BitVec bypass_stream;
  bac_stream.reserve_bits(static_cast<std::uint64_t>(size) * 4);
  bypass_stream.reserve_bits(size);
  aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probabilities);
  for (uint32_t i = 0; i < size; ++i) codec.write(input[i]);
  codec.stop_encoding();
  return static_cast<uint32_t>(bac_stream.occupancy_in_bits() +
                               bypass_stream.occupancy_in_bits());
}

}  // namespace

extern "C" {

// Single-map encode+verify-decode. Returns 0 on success, 1 on error.
int aeic_compress_lossless(uint32_t size, const int16_t* input, int16_t* output,
                           uint8_t tu_len, const double* probabilities,
                           uint32_t* nb_bits_out) {
  if (input == nullptr || output == nullptr || probabilities == nullptr ||
      nb_bits_out == nullptr || tu_len == 0) {
    return 1;
  }
  try {
    *nb_bits_out = roundtrip_map(size, input, output, tu_len, probabilities);
  } catch (...) {
    return 1;
  }
  return 0;
}

// Batch coding of `nb_maps` maps of `map_size` symbols, fanned out over
// `nb_threads` workers (0 -> hardware concurrency). probabilities is
// row-major (nb_maps, tu_len); nb_bits_out has nb_maps entries. flags
// bit 0 set = encode-only (no verify-decode; `output` is not written
// and may be null). Returns 0 on success, 1 on error in any map.
int aeic_compress_lossless_batch_ex(uint32_t nb_maps, uint32_t map_size,
                                    const int16_t* input, int16_t* output,
                                    uint8_t tu_len, const double* probabilities,
                                    uint32_t* nb_bits_out, uint32_t nb_threads,
                                    uint32_t flags) {
  const bool encode_only = (flags & 0x1u) != 0;
  if (input == nullptr || (output == nullptr && !encode_only) ||
      probabilities == nullptr || nb_bits_out == nullptr || tu_len == 0) {
    return 1;
  }
  if (nb_threads == 0) {
    nb_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  nb_threads = std::min(nb_threads, nb_maps);
  std::atomic<uint32_t> next{0};
  std::atomic<int> failed{0};
  auto worker = [&]() {
    for (;;) {
      const uint32_t map = next.fetch_add(1);
      if (map >= nb_maps || failed.load()) return;
      try {
        const int16_t* in = input + static_cast<std::size_t>(map) * map_size;
        const double* probs =
            probabilities + static_cast<std::size_t>(map) * tu_len;
        nb_bits_out[map] =
            encode_only
                ? encode_map_bits(map_size, in, tu_len, probs)
                : roundtrip_map(map_size, in,
                                output + static_cast<std::size_t>(map) * map_size,
                                tu_len, probs);
      } catch (...) {
        failed.store(1);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (uint32_t t = 1; t < nb_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failed.load();
}

// Back-compatible verifying batch entry.
int aeic_compress_lossless_batch(uint32_t nb_maps, uint32_t map_size,
                                 const int16_t* input, int16_t* output,
                                 uint8_t tu_len, const double* probabilities,
                                 uint32_t* nb_bits_out, uint32_t nb_threads) {
  return aeic_compress_lossless_batch_ex(nb_maps, map_size, input, output,
                                         tu_len, probabilities, nb_bits_out,
                                         nb_threads, 0);
}

// Encodes one map into caller-provided byte buffers. Returns 0 on
// success, 1 on error, 2 if a buffer is too small. On success
// *bac_bits / *bypass_bits hold the exact bit counts.
int aeic_encode_map(uint32_t size, const int16_t* input, uint8_t tu_len,
                    const double* probabilities,
                    uint8_t* bac_buffer, uint32_t bac_capacity_bytes,
                    uint8_t* bypass_buffer, uint32_t bypass_capacity_bytes,
                    uint32_t* bac_bits, uint32_t* bypass_bits) {
  if (input == nullptr || probabilities == nullptr || bac_buffer == nullptr ||
      bypass_buffer == nullptr || bac_bits == nullptr || bypass_bits == nullptr ||
      tu_len == 0) {
    // tu_len == 0 would read probs_[0] out of bounds in the truncated-
    // unary writer (Ueg0Codec precondition; every C entry enforces it).
    return 1;
  }
  try {
    aeic::BitVec bac_stream;
    aeic::BitVec bypass_stream;
    aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probabilities);
    for (uint32_t i = 0; i < size; ++i) codec.write(input[i]);
    codec.stop_encoding();
    const auto bac_bytes = bac_stream.bytes();
    const auto byp_bytes = bypass_stream.bytes();
    if (bac_bytes.size() > bac_capacity_bytes ||
        byp_bytes.size() > bypass_capacity_bytes) {
      return 2;
    }
    std::copy(bac_bytes.begin(), bac_bytes.end(), bac_buffer);
    std::copy(byp_bytes.begin(), byp_bytes.end(), bypass_buffer);
    *bac_bits = static_cast<uint32_t>(bac_stream.size_in_bits());
    *bypass_bits = static_cast<uint32_t>(bypass_stream.size_in_bits());
  } catch (...) {
    return 1;
  }
  return 0;
}

// Decodes one map from byte buffers produced by aeic_encode_map.
int aeic_decode_map(uint32_t size, int16_t* output, uint8_t tu_len,
                    const double* probabilities,
                    const uint8_t* bac_buffer, uint32_t bac_bits,
                    const uint8_t* bypass_buffer, uint32_t bypass_bits) {
  if (output == nullptr || probabilities == nullptr || bac_buffer == nullptr ||
      bypass_buffer == nullptr || tu_len == 0) {
    return 1;
  }
  try {
    aeic::BitVec bac_stream;
    aeic::BitVec bypass_stream;
    bac_stream.load(bac_buffer, bac_bits);
    bypass_stream.load(bypass_buffer, bypass_bits);
    aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probabilities);
    codec.start_decoding();
    for (uint32_t i = 0; i < size; ++i) output[i] = codec.read();
  } catch (...) {
    return 1;
  }
  return 0;
}

}  // extern "C"
