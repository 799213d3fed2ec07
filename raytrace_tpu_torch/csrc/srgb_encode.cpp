// The port's host sRGB encoder.
//
// Built by the host compiler at first use (io/native.py) and loaded with
// ctypes.  The byte of a linear value v is the smallest i with
// v < SRGB_AVERAGE[i] (the midpoints of the sRGB decode table,
// color.rs:335-600), 255 past the last threshold and for NaN.
//
// One table lookup a value in place of a search over the 255 thresholds:
// the table holds, for each of the 65,536 buckets of float32 values that
// share their top 16 bits, the byte of the bucket's lowest value.  A
// bucket holds at most one threshold (checked when the table is built;
// the thresholds lie 0.9% or more apart, a bucket's values within 0.8% of
// each other), so one compare against that threshold finishes the value.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

namespace {

constexpr int kBuckets = 1 << 16;

double srgb_decode(double c) {
    return c <= 0.04045 ? c / 12.92 : std::pow((c + 0.055) / 1.055, 2.4);
}

float from_bits(uint32_t bits) {
    float v;
    std::memcpy(&v, &bits, sizeof v);
    return v;
}

// v's byte by the definition: the smallest i with v < avg[i], 255 if
// none, searched from ``from``, which is at most that byte
int next_above(const float *avg, float v, int from) {
    int i = from;
    while (i < 255 && !(v < avg[i])) ++i;
    return i;
}

struct Tables {
    // thresholds computed in float64 and rounded to float32, so that ties
    // fall as in the float32 encoders; avg[255] = +inf ends the compare
    float avg[256];
    uint8_t table[kBuckets];
    // the first bucket that holds two thresholds or more, -1 if none
    int64_t fault = -1;

    Tables() {
        double vals[256];
        for (int i = 0; i < 256; ++i)
            vals[i] = srgb_decode(static_cast<double>(i) / 255.0);
        for (int i = 0; i < 255; ++i)
            avg[i] = static_cast<float>(0.5 * (vals[i] + vals[i + 1]));
        avg[255] = std::numeric_limits<float>::infinity();

        // sign bit clear: the buckets' values rise with b, so their bytes
        // are found in one walk up the thresholds
        int first = 0;
        for (uint32_t b = 0; b < kBuckets / 2; ++b) {
            const float lo = from_bits(b << 16);
            const float hi = from_bits((b << 16) | 0xFFFFu);
            if (std::isnan(lo)) {                 // NaNs only
                table[b] = 255;
                continue;
            }
            first = next_above(avg, lo, first);
            table[b] = static_cast<uint8_t>(first);
            // +inf's bucket holds NaNs above +inf
            const int last = next_above(avg, std::isnan(hi) ? lo : hi, first);
            if (last - first > 1 && fault < 0) fault = b;
        }
        // sign bit set: -0 and below, under avg[0], or NaNs
        for (uint32_t b = kBuckets / 2; b < kBuckets; ++b)
            table[b] = std::isnan(from_bits(b << 16)) ? 255 : 0;
    }
};
const Tables kTables;

inline uint8_t encode_srgb(float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, sizeof bits);
    // NaN of either sign; -inf shares its bucket with negative NaNs
    if ((bits & 0x7FFFFFFFu) > 0x7F800000u) return 255;
    unsigned i = kTables.table[bits >> 16];
    // strict <: a value equal to a threshold goes past it
    i += v >= kTables.avg[i];
    return static_cast<uint8_t>(i > 255 ? 255 : i);  // +inf: 256
}

}  // namespace

extern "C" {

// The first bucket of the table that holds two thresholds or more, -1 if
// none; the loader refuses the library unless it reads -1.
int64_t rt_srgb_table_fault(void) { return kTables.fault; }

// Encode n linear floats to sRGB bytes.
void rt_encode_srgb(const float *linear, uint8_t *out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = encode_srgb(linear[i]);
}

}  // extern "C"
