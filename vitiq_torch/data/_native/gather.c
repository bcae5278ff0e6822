/* Row gather/scatter memcpy loops for the packed-shard reader
 * (vitiq_torch/data/hdf5.py PackedDataSource.read_rows).
 *
 * A host memcpy, not a device kernel: rows of a memory-mapped shard are
 * copied into a batch buffer one row (an [L, 2] f32 frame) at a time.
 * Built at first use by vitiq_torch/data/native.py with gcc -O3 -shared
 * -fPIC into the checkout's build/ directory; every caller falls back to
 * numpy where the compiler or the build is unavailable.
 */
#include <stdint.h>
#include <string.h>

/* dst[i] = src[rows[i]] for n contiguous destination rows */
void gather_rows(char *dst, const char *src, const int64_t *rows,
                 int64_t n_rows, int64_t row_bytes) {
    for (int64_t i = 0; i < n_rows; ++i) {
        memcpy(dst + i * row_bytes, src + rows[i] * row_bytes, row_bytes);
    }
}

/* dst[dst_rows[i]] = src[src_rows[i]]: scattered destinations (the
 * multi-shard read_rows fill) */
void gather_scatter_rows(char *dst, const int64_t *dst_rows,
                         const char *src, const int64_t *src_rows,
                         int64_t n_rows, int64_t row_bytes) {
    for (int64_t i = 0; i < n_rows; ++i) {
        memcpy(dst + dst_rows[i] * row_bytes,
               src + src_rows[i] * row_bytes, row_bytes);
    }
}
