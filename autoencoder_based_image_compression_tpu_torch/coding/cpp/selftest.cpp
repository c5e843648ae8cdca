// Standalone self-test binary for the lossless coding core.
//
// Equivalent of the reference's test binary
// (kodak_tensorflow/lossless/c++/source/main.cpp + tests.cpp): one
// sub-test per component, exercised with deterministic pseudo-random
// data, hard-asserted (the reference printed expected-vs-computed pairs
// for human inspection; here failures exit nonzero for ctest/CI use).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "coder.hpp"

extern "C" int aeic_compress_lossless(uint32_t, const int16_t*, int16_t*, uint8_t,
                                      const double*, uint32_t*);
extern "C" int aeic_compress_lossless_batch(uint32_t, uint32_t, const int16_t*,
                                            int16_t*, uint8_t, const double*,
                                            uint32_t*, uint32_t);
extern "C" int aeic_compress_lossless_batch_ex(uint32_t, uint32_t, const int16_t*,
                                               int16_t*, uint8_t, const double*,
                                               uint32_t*, uint32_t, uint32_t);

#define CHECK(cond)                                                      \
  do {                                                                   \
    if (!(cond)) {                                                       \
      std::fprintf(stderr, "FAILED %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      std::exit(1);                                                      \
    }                                                                    \
  } while (0)

static void test_bitvec_roundtrip() {
  aeic::BitVec stream;
  std::mt19937 rng(0);
  std::vector<uint8_t> bits(1000);
  for (auto& b : bits) {
    b = static_cast<uint8_t>(rng() & 1u);
    stream.push(b);
  }
  CHECK(stream.occupancy_in_bits() == 1000);
  for (auto b : bits) CHECK(stream.pull() == b);
  CHECK(stream.exhausted());
  CHECK(stream.pull() == 0);  // past-the-end reads yield 0
}

static void test_range_coder_roundtrip() {
  std::mt19937 rng(1);
  std::vector<uint8_t> bits(5000);
  const double p0 = 0.8;
  std::bernoulli_distribution bern(1.0 - p0);
  for (auto& b : bits) b = bern(rng) ? 1 : 0;

  aeic::BitVec stream;
  aeic::RangeCoder16 encoder(stream);
  for (auto b : bits) encoder.encode(b, p0);
  encoder.stop_encoding();

  // Biased bits compress: measured length within 5% of n*H(p).
  const double entropy = -(p0 * std::log2(p0) + (1 - p0) * std::log2(1 - p0));
  const double measured = static_cast<double>(stream.occupancy_in_bits());
  CHECK(measured < 1.05 * 5000 * entropy + 64);

  aeic::RangeCoder16 decoder(stream);
  decoder.start_decoding();
  for (auto b : bits) CHECK(decoder.decode(p0) == b);
}

static void test_range_coder_rejects_bad_probability() {
  aeic::BitVec stream;
  aeic::RangeCoder16 coder(stream);
  bool threw = false;
  try {
    coder.encode(0, 0.0);
  } catch (const std::invalid_argument&) {
    threw = true;
  }
  CHECK(threw);
}

static void test_ueg0_roundtrip() {
  std::mt19937 rng(2);
  std::vector<int16_t> symbols(20000);
  // Laplace-ish symbol distribution including the EG0 tail.
  std::geometric_distribution<int> geom(0.3);
  std::bernoulli_distribution sign(0.5);
  for (auto& s : symbols) {
    int magnitude = geom(rng);
    s = static_cast<int16_t>(sign(rng) ? magnitude : -magnitude);
  }
  const uint8_t tu_len = 10;
  std::vector<double> probs(tu_len, 0.3);

  aeic::BitVec bac_stream, bypass_stream;
  aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probs.data());
  for (auto s : symbols) codec.write(s);
  codec.stop_encoding();
  codec.start_decoding();
  for (auto s : symbols) CHECK(codec.read() == s);
}

static void test_ueg0_extremes() {
  const uint8_t tu_len = 4;
  std::vector<double> probs(tu_len, 0.5);
  std::vector<int16_t> symbols = {0, 1, -1, 3, -3, 4, -4, 5, 100, -100, 32767, -32767};
  aeic::BitVec bac_stream, bypass_stream;
  aeic::Ueg0Codec codec(bac_stream, bypass_stream, tu_len, probs.data());
  for (auto s : symbols) codec.write(s);
  codec.stop_encoding();
  codec.start_decoding();
  for (auto s : symbols) CHECK(codec.read() == s);
}

static void test_compress_lossless_capi() {
  std::mt19937 rng(3);
  const uint32_t size = 48 * 32;
  std::vector<int16_t> input(size), output(size, 999);
  std::geometric_distribution<int> geom(0.4);
  std::bernoulli_distribution sign(0.5);
  for (auto& s : input) {
    int m = geom(rng);
    s = static_cast<int16_t>(sign(rng) ? m : -m);
  }
  const uint8_t tu_len = 10;
  std::vector<double> probs(tu_len, 0.4);
  uint32_t nb_bits = 0;
  CHECK(aeic_compress_lossless(size, input.data(), output.data(), tu_len,
                               probs.data(), &nb_bits) == 0);
  CHECK(nb_bits > 0);
  for (uint32_t i = 0; i < size; ++i) CHECK(input[i] == output[i]);
}

static void test_compress_lossless_batch_matches_single() {
  std::mt19937 rng(4);
  const uint32_t nb_maps = 16, map_size = 32 * 48;
  std::vector<int16_t> input(nb_maps * map_size), batch_out(input.size(), 0),
      single_out(map_size);
  std::geometric_distribution<int> geom(0.35);
  std::bernoulli_distribution sign(0.5);
  for (auto& s : input) {
    int m = geom(rng);
    s = static_cast<int16_t>(sign(rng) ? m : -m);
  }
  const uint8_t tu_len = 10;
  std::vector<double> probs(nb_maps * tu_len);
  for (auto& p : probs) p = 0.2 + 0.5 * (rng() % 100) / 100.0;

  std::vector<uint32_t> batch_bits(nb_maps, 0);
  CHECK(aeic_compress_lossless_batch(nb_maps, map_size, input.data(),
                                     batch_out.data(), tu_len, probs.data(),
                                     batch_bits.data(), 4) == 0);
  for (uint32_t m = 0; m < nb_maps; ++m) {
    uint32_t single_bits = 0;
    CHECK(aeic_compress_lossless(map_size, input.data() + m * map_size,
                                 single_out.data(), tu_len,
                                 probs.data() + m * tu_len, &single_bits) == 0);
    CHECK(single_bits == batch_bits[m]);  // threading must not change the stream
    for (uint32_t i = 0; i < map_size; ++i) {
      CHECK(batch_out[m * map_size + i] == input[m * map_size + i]);
    }
  }
}

static void test_bitvec_push_bits_matches_single_pushes() {
  // push_bits must serialize the exact bit order of bit-by-bit pushes
  // (the multi-bit bypass appends rely on it for bit-exactness).
  std::mt19937 rng(5);
  aeic::BitVec chunked, single;
  std::vector<uint8_t> all_bits;
  for (int round = 0; round < 2000; ++round) {
    const uint32_t n = 1 + rng() % 33;
    uint64_t value = (static_cast<uint64_t>(rng()) << 32) | rng();
    value &= (n == 64) ? ~0ull : ((1ull << n) - 1);
    chunked.push_bits(value, n);
    for (uint32_t i = 0; i < n; ++i) {
      const uint8_t bit = static_cast<uint8_t>((value >> i) & 0x1u);
      single.push(bit);
      all_bits.push_back(bit);
    }
  }
  CHECK(chunked.size_in_bits() == single.size_in_bits());
  const auto bytes_chunked = chunked.bytes();
  const auto bytes_single = single.bytes();
  CHECK(bytes_chunked.size() == bytes_single.size());
  for (std::size_t i = 0; i < bytes_chunked.size(); ++i) {
    CHECK(bytes_chunked[i] == bytes_single[i]);
  }
  for (auto bit : all_bits) CHECK(chunked.pull() == bit);
  CHECK(chunked.exhausted());
}

static void test_bitvec_pull_msb_first_matches_single_pulls() {
  // pull_msb_first(n) must equal n iterations of v = (v<<1)|pull(),
  // including the zero-fill past the end of the stream.
  std::mt19937 rng(7);
  aeic::BitVec a, b;
  const uint32_t total = 4001;  // odd: exercises the exhausted tail
  for (uint32_t i = 0; i < total; ++i) {
    const uint8_t bit = static_cast<uint8_t>(rng() & 1u);
    a.push(bit);
    b.push(bit);
  }
  std::uint64_t consumed = 0;
  while (consumed < total + 32) {  // run past the end
    const uint32_t n = 1 + rng() % 16;
    uint32_t expected = 0;
    for (uint32_t i = 0; i < n; ++i) expected = (expected << 1) | b.pull();
    CHECK(a.pull_msb_first(n) == expected);
    consumed += n;
  }
}

static void test_encode_only_batch_matches_verifying_batch() {
  // flags=1 (encode-only) must report the exact bit counts of the
  // verifying round trip - it is the same encoder, minus the decode.
  std::mt19937 rng(6);
  const uint32_t nb_maps = 12, map_size = 32 * 48;
  std::vector<int16_t> input(nb_maps * map_size), out(input.size(), 0);
  std::geometric_distribution<int> geom(0.35);
  std::bernoulli_distribution sign(0.5);
  for (auto& s : input) {
    int m = geom(rng);
    s = static_cast<int16_t>(sign(rng) ? m : -m);
  }
  const uint8_t tu_len = 10;
  std::vector<double> probs(nb_maps * tu_len);
  for (auto& p : probs) p = 0.2 + 0.5 * (rng() % 100) / 100.0;
  std::vector<uint32_t> bits_verify(nb_maps, 0), bits_encode(nb_maps, 0);
  CHECK(aeic_compress_lossless_batch_ex(nb_maps, map_size, input.data(),
                                        out.data(), tu_len, probs.data(),
                                        bits_verify.data(), 2, 0) == 0);
  CHECK(aeic_compress_lossless_batch_ex(nb_maps, map_size, input.data(),
                                        nullptr, tu_len, probs.data(),
                                        bits_encode.data(), 2, 1) == 0);
  for (uint32_t m = 0; m < nb_maps; ++m) CHECK(bits_verify[m] == bits_encode[m]);
}

int main() {
  test_bitvec_roundtrip();
  test_bitvec_push_bits_matches_single_pushes();
  test_bitvec_pull_msb_first_matches_single_pulls();
  test_encode_only_batch_matches_verifying_batch();
  test_range_coder_roundtrip();
  test_range_coder_rejects_bad_probability();
  test_ueg0_roundtrip();
  test_ueg0_extremes();
  test_compress_lossless_capi();
  test_compress_lossless_batch_matches_single();
  std::printf("all coder self-tests passed\n");
  return 0;
}
