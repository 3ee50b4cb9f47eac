// crc32c (Castagnoli, reflected polynomial 0x82F63B78) on the host, for the
// checkpoint sidecars (gym_tpu_torch/utils/integrity.py). Host code only: no
// kernel. The pure-Python crc32c of the sidecars hashes a few MB/s and a
// GPT-2 base step dir holds 4 GB, so the port hashes through this twin where
// its library is built. x86-64's SSE4.2 crc32 instruction computes exactly
// this CRC (8 bytes an instruction); elsewhere, or on a CPU without it,
// slicing-by-8 tables as in the Python version. Either gives the Python
// version's value: gym_crc32c(data, n, crc) == crc32c(data[:n], crc).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][n] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int n = 0; n < 256; ++n)
        t[k][n] = t[0][t[k - 1][n] & 0xFF] ^ (t[k - 1][n] >> 8);
  }
};

const Tables& tables() {
  static const Tables tab;  // thread-safe one-time initialisation
  return tab;
}

// the register update without the initial and final inversion
uint32_t crc_tables(uint32_t crc, const uint8_t* p, size_t n) {
  const Tables& tab = tables();
  const uint32_t(*t)[256] = tab.t;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
bool have_sse42() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return (c >> 20) & 1u;
}

uint32_t crc_sse42(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    asm("crc32q %1, %0" : "+r"(c) : "rm"(v));
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) {
    uint8_t v = *p++;
    asm("crc32b %1, %0" : "+r"(c32) : "rm"(v));
  }
  return c32;
}
#endif

bool use_hw() {
#if defined(__x86_64__)
  static const bool hw = have_sse42();
  return hw;
#else
  return false;
#endif
}

}  // namespace

// crc32c of n bytes at data, chained from crc (0 for a fresh one), as the
// Python crc32c(data, crc) computes it
extern "C" unsigned int gym_crc32c(const unsigned char* data, long long n,
                                   unsigned int crc) {
  uint32_t c = ~static_cast<uint32_t>(crc);
  size_t len = n > 0 ? static_cast<size_t>(n) : 0;
#if defined(__x86_64__)
  if (use_hw()) return ~crc_sse42(c, data, len);
#endif
  return ~crc_tables(c, data, len);
}

// 1 when gym_crc32c runs on the crc32 instruction, 0 on the tables
extern "C" int gym_crc32c_hw() { return use_hw() ? 1 : 0; }
