/* Native host-side kernels for the data-loader path.
 *
 * The reference's generator/loader tier is native (dbgen is C; the Java
 * port runs on a JIT).  These kernels cover the two measured host
 * hot-spots of presto_tpu's spec-faithful TPC-H generator:
 *
 *  - lcg_values / lcg_bounded: the dbgen multiplicative-LCG column
 *    streams (seed' = seed * 16807 mod 2^31-1, O(1) skip-ahead to the
 *    slice start, then one mulmod per row).  The numpy path builds
 *    log-doubling power tables per call (~0.4 s per stream at 6M rows);
 *    here each value is one 64-bit multiply + modulo.
 *  - gather_substrings: comment-column assembly — per-row byte copy out
 *    of the grammar text pool into a fixed-width matrix (the numpy path
 *    materializes a [N, W] int64 index matrix first).
 *
 * Bit-identical with the numpy implementations by construction; parity
 * is asserted in tests/test_native.py.  Built on demand with the system
 * C compiler (see native/__init__.py); everything falls back to numpy
 * when no compiler is available.
 */

#include <stdint.h>
#include <string.h>

#define MODULUS 2147483647LL
#define MULTIPLIER 16807LL

static int64_t pow_mod(int64_t base, int64_t exp) {
    int64_t result = 1, b = base % MODULUS;
    while (exp > 0) {
        if (exp & 1) result = (result * b) % MODULUS;
        b = (b * b) % MODULUS;
        exp >>= 1;
    }
    return result;
}

/* out[i] = seed * 16807^(first_row*uses + i*uses + use_index) mod M */
void lcg_values(int64_t seed, int64_t uses, int64_t use_index,
                int64_t first_row, int64_t n, int64_t *out) {
    int64_t jump = pow_mod(MULTIPLIER, uses);
    int64_t cur = (seed * pow_mod(MULTIPLIER,
                                  first_row * uses + use_index)) % MODULUS;
    for (int64_t i = 0; i < n; i++) {
        out[i] = cur;
        cur = (cur * jump) % MODULUS;   /* both < 2^31: product < 2^62 */
    }
}

/* out[i*uses + u] = draw u+1 of row first_row+i — the whole per-row
 * draw matrix in ONE sequential pass (the numpy path stacks per-use
 * columns, ~0.6 s per stream at 6M rows). */
void lcg_matrix(int64_t seed, int64_t uses, int64_t first_row, int64_t n,
                int64_t *out) {
    int64_t cur = (seed * pow_mod(MULTIPLIER, first_row * uses + 1))
                  % MODULUS;
    int64_t total = n * uses;
    for (int64_t i = 0; i < total; i++) {
        out[i] = cur;
        cur = (cur * MULTIPLIER) % MODULUS;
    }
}

/* dbgen UnifInt: low + (int64)((v / 2147483647.0) * (high-low+1)) —
 * the exact double arithmetic of the C and Java generators. */
void lcg_bounded(int64_t seed, int64_t uses, int64_t use_index,
                 int64_t first_row, int64_t n, int64_t low, int64_t high,
                 int64_t *out) {
    int64_t jump = pow_mod(MULTIPLIER, uses);
    int64_t cur = (seed * pow_mod(MULTIPLIER,
                                  first_row * uses + use_index)) % MODULUS;
    double range = (double)(high - low + 1);
    for (int64_t i = 0; i < n; i++) {
        out[i] = low + (int64_t)(((double)cur / 2147483647.0) * range);
        cur = (cur * jump) % MODULUS;
    }
}

/* values[i, :lengths[i]] = pool[offsets[i] : offsets[i]+lengths[i]],
 * zero-padded to width.  offsets already wrapped by the caller. */
void gather_substrings(const uint8_t *pool, const int64_t *offsets,
                       const int64_t *lengths, int64_t n, int64_t width,
                       uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t len = lengths[i];
        if (len > width) len = width;
        uint8_t *row = out + i * width;
        memcpy(row, pool + offsets[i], (size_t)len);
        if (len < width) memset(row + len, 0, (size_t)(width - len));
    }
}
