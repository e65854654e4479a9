// CRC64-ECMA (polynomial 0xC96C5795D7870F42, reflected), slice-by-8.
//
// Native counterpart of the reference's WAL frame checksumming
// (reference src/storage/wal.rs:148,239-266 uses a crc crate's CRC64).
// Built as a plain C ABI shared object loaded via ctypes (no pybind11 in
// the build image); turdb_tpu_torch.native.build compiles it on first use and
// falls back to a numpy table-driven implementation if no compiler.

#include <cstdint>
#include <cstddef>

static uint64_t TABLE[8][256];
static bool INIT = false;

static const uint64_t POLY = 0xC96C5795D7870F42ULL;

static void init_tables() {
    for (int i = 0; i < 256; i++) {
        uint64_t crc = (uint64_t)i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? POLY : 0);
        TABLE[0][i] = crc;
    }
    for (int t = 1; t < 8; t++)
        for (int i = 0; i < 256; i++)
            TABLE[t][i] =
                (TABLE[t - 1][i] >> 8) ^ TABLE[0][TABLE[t - 1][i] & 0xFF];
    INIT = true;
}

extern "C" uint64_t turdb_crc64(const uint8_t* data, size_t len, uint64_t seed) {
    if (!INIT) init_tables();
    uint64_t crc = ~seed;
    size_t i = 0;
    for (; i + 8 <= len; i += 8) {
        crc ^= (uint64_t)data[i] | ((uint64_t)data[i + 1] << 8) |
               ((uint64_t)data[i + 2] << 16) | ((uint64_t)data[i + 3] << 24) |
               ((uint64_t)data[i + 4] << 32) | ((uint64_t)data[i + 5] << 40) |
               ((uint64_t)data[i + 6] << 48) | ((uint64_t)data[i + 7] << 56);
        crc = TABLE[7][crc & 0xFF] ^ TABLE[6][(crc >> 8) & 0xFF] ^
              TABLE[5][(crc >> 16) & 0xFF] ^ TABLE[4][(crc >> 24) & 0xFF] ^
              TABLE[3][(crc >> 32) & 0xFF] ^ TABLE[2][(crc >> 40) & 0xFF] ^
              TABLE[1][(crc >> 48) & 0xFF] ^ TABLE[0][(crc >> 56) & 0xFF];
    }
    for (; i < len; i++)
        crc = (crc >> 8) ^ TABLE[0][(crc ^ data[i]) & 0xFF];
    return ~crc;
}
