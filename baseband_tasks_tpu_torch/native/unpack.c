/* Fast bit-unpacking for baseband payloads (2/4/8 bits per component).
 *
 * Host decoder of the port's file readers (io/vdif.py, io/mark5b.py):
 * 256-entry lookup tables, so each input byte expands with a single
 * table row copy.  The conventions are those of the device decoders in
 * ops/unpack.py, bit for bit: 8/4-bit offset binary (byte or nibble minus
 * an offset, low nibble first), 2-bit LSB-first crumbs through a 4-level
 * table.
 *
 * Build: cc -O3 -shared -fPIC unpack.c -o libunpack.so (native/__init__.py
 * does this at first use, into build/native/).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* 2-bit: 4 components per byte, values from a 4-level table. */
void unpack_2bit(const uint8_t *in, size_t n_bytes, const float *levels,
                 float *out)
{
    float lut[256][4];
    for (int b = 0; b < 256; b++) {
        lut[b][0] = levels[b & 0x3];
        lut[b][1] = levels[(b >> 2) & 0x3];
        lut[b][2] = levels[(b >> 4) & 0x3];
        lut[b][3] = levels[(b >> 6) & 0x3];
    }
    for (size_t i = 0; i < n_bytes; i++) {
        memcpy(out + 4 * i, lut[in[i]], 4 * sizeof(float));
    }
}

/* 4-bit: 2 components per byte; value = nibble - offset (e.g. 7.5). */
void unpack_4bit(const uint8_t *in, size_t n_bytes, float offset,
                 float *out)
{
    float lut[256][2];
    for (int b = 0; b < 256; b++) {
        lut[b][0] = (float)(b & 0xF) - offset;
        lut[b][1] = (float)(b >> 4) - offset;
    }
    for (size_t i = 0; i < n_bytes; i++) {
        memcpy(out + 2 * i, lut[in[i]], 2 * sizeof(float));
    }
}

/* 8-bit offset-binary: value = byte - offset (e.g. 127.5). */
void unpack_8bit(const uint8_t *in, size_t n_bytes, float offset,
                 float *out)
{
    float lut[256];
    for (int b = 0; b < 256; b++)
        lut[b] = (float)b - offset;
    for (size_t i = 0; i < n_bytes; i++)
        out[i] = lut[in[i]];
}

/* Pack float components to 2-bit with thresholds t0<t1<t2. */
void pack_2bit(const float *in, size_t n, const float *thresholds,
               uint8_t *out)
{
    size_t n_bytes = (n + 3) / 4;
    for (size_t i = 0; i < n_bytes; i++) {
        uint8_t b = 0;
        for (int k = 0; k < 4; k++) {
            size_t j = 4 * i + k;
            /* tail padding is code 0, matching the numpy fallback --
             * 0.0f would quantize through the thresholds instead */
            uint8_t code = 0;
            if (j < n) {
                float v = in[j];
                code = (uint8_t)((v >= thresholds[0])
                                 + (v >= thresholds[1])
                                 + (v >= thresholds[2]));
            }
            b |= (uint8_t)(code << (2 * k));
        }
        out[i] = b;
    }
}
