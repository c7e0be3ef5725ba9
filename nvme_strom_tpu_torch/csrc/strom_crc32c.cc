// crc32c (Castagnoli, reflected polynomial 0x82F63B78) for the port's
// checkpoint leaves and page checksums, called through ctypes by
// scan/heap.py when the google_crc32c wheel is not installed.
//
// Two implementations of one function:
//   * the SSE4.2 `crc32` instruction, 8 bytes a step, chosen at run time
//     when the CPU has it (x86-64 only);
//   * slicing-by-8 tables everywhere else.
// Both take and return the finalised crc, so strom_crc32c_extend(0, p, n)
// is crc32c(p[0:n]) and extend(extend(0, a), b) == crc32c(a + b).
// strom_crc32c_pages checks a run of heap pages in one call: the crc32c of
// each page with its 4-byte checksum word read as zero.
//
// Built by _build.py's g++ leg: g++ -O2 -std=c++17 -fPIC -pthread -shared.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

uint32_t g_table[8][256];

struct TableInit {
    TableInit() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c >> 1) ^ ((c & 1u) ? 0x82F63B78u : 0u);
            g_table[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; i++)
            for (int t = 1; t < 8; t++)
                g_table[t][i] = (g_table[t - 1][i] >> 8)
                                ^ g_table[0][g_table[t - 1][i] & 0xFF];
    }
} g_table_init;

uint32_t crc_sliced(uint32_t c, const uint8_t* p, size_t n) {
    while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
        c = (c >> 8) ^ g_table[0][(c ^ *p++) & 0xFF];
        n--;
    }
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, p, 8);          // little-endian host
        w ^= c;
        c = g_table[7][w & 0xFF] ^ g_table[6][(w >> 8) & 0xFF]
            ^ g_table[5][(w >> 16) & 0xFF] ^ g_table[4][(w >> 24) & 0xFF]
            ^ g_table[3][(w >> 32) & 0xFF] ^ g_table[2][(w >> 40) & 0xFF]
            ^ g_table[1][(w >> 48) & 0xFF] ^ g_table[0][w >> 56];
        p += 8;
        n -= 8;
    }
    while (n--)
        c = (c >> 8) ^ g_table[0][(c ^ *p++) & 0xFF];
    return c;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc_sse42(uint32_t c, const uint8_t* p, size_t n) {
    while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
        c = __builtin_ia32_crc32qi(c, *p++);
        n--;
    }
    uint64_t c64 = c;
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, p, 8);
        c64 = __builtin_ia32_crc32di(c64, w);
        p += 8;
        n -= 8;
    }
    c = static_cast<uint32_t>(c64);
    while (n--)
        c = __builtin_ia32_crc32qi(c, *p++);
    return c;
}

bool have_sse42() {
    static const bool yes = __builtin_cpu_supports("sse4.2");
    return yes;
}
#endif

}  // namespace

extern "C" {

// 1 when the SSE4.2 instruction runs, 0 for the slicing-by-8 tables.
int strom_crc32c_hw(void) {
#if defined(__x86_64__)
    return have_sse42() ? 1 : 0;
#else
    return 0;
#endif
}

// crc32c of p[0:n] continued from the finalised crc `crc` (0 to start).
// `hw` 1 asks for the instruction where the CPU has it, 0 for the tables.
uint32_t strom_crc32c_extend(uint32_t crc, const uint8_t* p, size_t n,
                             int hw) {
    uint32_t c = ~crc;
#if defined(__x86_64__)
    if (hw && have_sse42())
        return ~crc_sse42(c, p, n);
#else
    (void)hw;
#endif
    return ~crc_sliced(c, p, n);
}

// crc32c of each of the n_pages pages of page_size bytes at p, with the 4
// bytes at zero_off of each page read as zeros (the heap page's checksum
// word), into out[0:n_pages].  `hw` as for strom_crc32c_extend.
void strom_crc32c_pages(const uint8_t* p, size_t n_pages, size_t page_size,
                        size_t zero_off, uint32_t* out, int hw) {
    static const uint8_t zeros[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < n_pages; i++, p += page_size) {
        uint32_t c = strom_crc32c_extend(0, p, zero_off, hw);
        c = strom_crc32c_extend(c, zeros, 4, hw);
        out[i] = strom_crc32c_extend(c, p + zero_off + 4,
                                     page_size - zero_off - 4, hw);
    }
}

}  // extern "C"
