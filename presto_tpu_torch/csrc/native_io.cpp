// Native IO runtime of presto_tpu_torch: host C++ for the filterbank
// ingest (copied from the JAX package's csrc/native_io.cpp, which the
// port does not import).
//
// The reference implements its raw-data path in C (bit-unpack loops
// psrfits.c:828-866, scale/offset/weight application psrfits.c:805-814
// and :899-908, poln sum/select :887-, plus the block readers behind
// the get_rawblock dispatch boundary backend_common.h:86-87).  This
// library holds the fused unpack + IF-sum + flip decode that hands the
// host feeder float32 blocks ready for the device upload (written
// straight into the caller's buffer: a pinned host tensor on the card
// path), and a pthread double-buffered prefetching file reader so disk
// latency overlaps the decode and the device compute.
//
// Exposed C ABI (ctypes-friendly), no Python.h dependency:
//   pt_unpack_bits        1/2/4-bit -> uint8 (MSB-first within byte)
//   pt_unpack_to_float    1/2/4/8-bit -> float32, fused
//   pt_decode_spectra     filterbank block: unpack + nifs-sum + flip
//   pt_decode_subint      PSRFITS subint: unpack + zero_off + scale/
//                         offset + poln select/sum + weights + flip
//   pt_feeder_*           background prefetching block reader
//
// Build: presto_tpu_torch/cuda_build.py (g++ -O3 -fPIC -shared -pthread)
// into presto_tpu_torch/_build/ at first use; loaded by
// presto_tpu_torch/io/native.py, which has no fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>

extern "C" {

// ---------------------------------------------------------------------------
// Bit unpacking.  MSB-first within each byte (PRESTO convention,
// psrfits.c:828-866): for 4-bit the high nibble is the earlier sample.
// ---------------------------------------------------------------------------

void pt_unpack_bits(const uint8_t *raw, int64_t nbytes, int nbits,
                    uint8_t *out) {
    switch (nbits) {
    case 8:
        memcpy(out, raw, (size_t)nbytes);
        break;
    case 4:
        for (int64_t i = 0; i < nbytes; ++i) {
            out[2 * i] = raw[i] >> 4;
            out[2 * i + 1] = raw[i] & 0x0F;
        }
        break;
    case 2:
        for (int64_t i = 0; i < nbytes; ++i) {
            uint8_t b = raw[i];
            out[4 * i] = (b >> 6) & 0x03;
            out[4 * i + 1] = (b >> 4) & 0x03;
            out[4 * i + 2] = (b >> 2) & 0x03;
            out[4 * i + 3] = b & 0x03;
        }
        break;
    case 1:
        for (int64_t i = 0; i < nbytes; ++i) {
            uint8_t b = raw[i];
            for (int k = 0; k < 8; ++k)
                out[8 * i + k] = (b >> (7 - k)) & 0x01;
        }
        break;
    default:
        // other widths are decoded by io/sigproc's NumPy path
        break;
    }
}

void pt_unpack_to_float(const uint8_t *raw, int64_t nbytes, int nbits,
                        float *out) {
    switch (nbits) {
    case 8:
        for (int64_t i = 0; i < nbytes; ++i)
            out[i] = (float)raw[i];
        break;
    case 4:
        for (int64_t i = 0; i < nbytes; ++i) {
            out[2 * i] = (float)(raw[i] >> 4);
            out[2 * i + 1] = (float)(raw[i] & 0x0F);
        }
        break;
    case 2:
        for (int64_t i = 0; i < nbytes; ++i) {
            uint8_t b = raw[i];
            out[4 * i] = (float)((b >> 6) & 0x03);
            out[4 * i + 1] = (float)((b >> 4) & 0x03);
            out[4 * i + 2] = (float)((b >> 2) & 0x03);
            out[4 * i + 3] = (float)(b & 0x03);
        }
        break;
    case 1:
        for (int64_t i = 0; i < nbytes; ++i) {
            uint8_t b = raw[i];
            for (int k = 0; k < 8; ++k)
                out[8 * i + k] = (float)((b >> (7 - k)) & 0x01);
        }
        break;
    default:
        break;
    }
}

// ---------------------------------------------------------------------------
// Fused filterbank block decode: packed raw -> float32 [nspec, nchan],
// summing nifs IFs and optionally flipping to ascending frequency —
// the work FilterbankFile.read_spectra does per block.
// nbits in {1,2,4,8}; 16/32-bit stay on the NumPy path (cheap there).
// ---------------------------------------------------------------------------

void pt_decode_spectra(const uint8_t *raw, int64_t nspec, int nifs,
                       int nchan, int nbits, int flip, float *out) {
    const int64_t vals_per_spec = (int64_t)nifs * nchan;
    const int64_t spec_bytes = vals_per_spec * nbits / 8;
    float *tmp = (nifs > 1 || nbits < 8)
                     ? (float *)malloc(sizeof(float) * vals_per_spec)
                     : NULL;
    for (int64_t s = 0; s < nspec; ++s) {
        const uint8_t *rp = raw + s * spec_bytes;
        float *op = out + s * nchan;
        const float *vals;
        if (nbits == 8 && nifs == 1) {
            // decode straight into the output row
            for (int c = 0; c < nchan; ++c)
                op[c] = (float)rp[c];
            vals = op;
        } else {
            pt_unpack_to_float(rp, spec_bytes, nbits, tmp);
            vals = tmp;
        }
        if (nifs > 1) {
            for (int c = 0; c < nchan; ++c)
                op[c] = vals[c];
            for (int p = 1; p < nifs; ++p) {
                const float *vp = vals + (int64_t)p * nchan;
                for (int c = 0; c < nchan; ++c)
                    op[c] += vp[c];
            }
        } else if (vals != op) {
            memcpy(op, vals, sizeof(float) * nchan);
        }
        if (flip) {
            for (int c = 0; c < nchan / 2; ++c) {
                float t = op[c];
                op[c] = op[nchan - 1 - c];
                op[nchan - 1 - c] = t;
            }
        }
    }
    free(tmp);
}

// ---------------------------------------------------------------------------
// Fused PSRFITS subint decode (get_PSRFITS_subint analog,
// psrfits.c:789-920): unpack -> subtract ZERO_OFF -> per-(pol,chan)
// scale/offset -> poln select or sum -> per-chan weights -> flip.
//
// pol_mode: >=0 select that pol; -2 sum first two pols; npol==1 pass.
// scl/offs are [npol*nchan] or NULL; wts is [nchan] or NULL.
// out is [nspec, nchan].
// ---------------------------------------------------------------------------

void pt_decode_subint(const uint8_t *raw, int64_t nspec, int npol,
                      int nchan, int nbits, float zero_off,
                      const float *scl, const float *offs,
                      const float *wts, int pol_mode, int flip,
                      float *out) {
    const int64_t vals_per_spec = (int64_t)npol * nchan;
    const int64_t spec_bytes = vals_per_spec * nbits / 8;
    float *tmp = (float *)malloc(sizeof(float) * vals_per_spec);
    for (int64_t s = 0; s < nspec; ++s) {
        pt_unpack_to_float(raw + s * spec_bytes, spec_bytes, nbits, tmp);
        if (zero_off != 0.0f)
            for (int64_t i = 0; i < vals_per_spec; ++i)
                tmp[i] -= zero_off;
        if (scl || offs)
            for (int p = 0; p < npol; ++p) {
                float *vp = tmp + (int64_t)p * nchan;
                const float *sp = scl ? scl + (int64_t)p * nchan : NULL;
                const float *op = offs ? offs + (int64_t)p * nchan : NULL;
                for (int c = 0; c < nchan; ++c) {
                    float v = vp[c];
                    if (sp) v *= sp[c];
                    if (op) v += op[c];
                    vp[c] = v;
                }
            }
        float *orow = out + s * nchan;
        if (npol == 1 || pol_mode >= 0) {
            const float *vp =
                tmp + (pol_mode > 0 ? (int64_t)pol_mode * nchan : 0);
            memcpy(orow, vp, sizeof(float) * nchan);
        } else {  // pol_mode == -2: sum AA+BB
            const float *a = tmp;
            const float *b = tmp + nchan;
            for (int c = 0; c < nchan; ++c)
                orow[c] = a[c] + b[c];
        }
        if (wts)
            for (int c = 0; c < nchan; ++c)
                orow[c] *= wts[c];
        if (flip)
            for (int c = 0; c < nchan / 2; ++c) {
                float t = orow[c];
                orow[c] = orow[nchan - 1 - c];
                orow[nchan - 1 - c] = t;
            }
    }
    free(tmp);
}

// ---------------------------------------------------------------------------
// Prefetching block feeder: a background pthread reads fixed-size
// blocks sequentially into a ring of buffers; the consumer copies the
// next block out.  Keeps the disk ahead of the device feed the way the
// reference's streaming double-buffer keeps the CPU fed.
// ---------------------------------------------------------------------------

struct Feeder {
    FILE *f;
    int64_t block_bytes;
    int nbuf;
    uint8_t **bufs;
    int64_t *sizes;        // bytes valid in each slot
    int head, tail, count; // ring state (filled by reader at head)
    int eof, err, stop;
    // overlap attribution: how often each side waited on the other
    // (consumer_waits = device-feed loop arrived before a block was
    // ready: disk-bound; producer_waits = ring full: compute-bound)
    int64_t n_blocks, consumer_waits, producer_waits;
    pthread_mutex_t mu;
    pthread_cond_t can_fill, can_take;
    pthread_t thread;
};

static void *feeder_main(void *arg) {
    Feeder *fd = (Feeder *)arg;
    for (;;) {
        pthread_mutex_lock(&fd->mu);
        if (fd->count == fd->nbuf && !fd->stop)
            fd->producer_waits++;
        while (fd->count == fd->nbuf && !fd->stop)
            pthread_cond_wait(&fd->can_fill, &fd->mu);
        if (fd->stop) {
            pthread_mutex_unlock(&fd->mu);
            return NULL;
        }
        int slot = fd->head;
        pthread_mutex_unlock(&fd->mu);

        size_t got = fread(fd->bufs[slot], 1, (size_t)fd->block_bytes,
                           fd->f);

        // a short/zero read is clean EOF only if ferror() is clear;
        // otherwise flag the error so the consumer can distinguish a
        // truncated dataset from end-of-file
        int io_error = (got < (size_t)fd->block_bytes && ferror(fd->f));

        pthread_mutex_lock(&fd->mu);
        fd->sizes[slot] = (int64_t)got;
        fd->head = (fd->head + 1) % fd->nbuf;
        fd->count++;
        if (io_error)
            fd->err = 1;
        if (got == 0 || io_error)
            fd->eof = 1;
        pthread_cond_signal(&fd->can_take);
        pthread_mutex_unlock(&fd->mu);
        if (got == 0 || io_error)
            return NULL;
    }
}

void *pt_feeder_open(const char *path, int64_t start_offset,
                     int64_t block_bytes, int nbuf) {
    FILE *f = fopen(path, "rb");
    if (!f)
        return NULL;
    if (start_offset > 0 && fseek(f, (long)start_offset, SEEK_SET) != 0) {
        fclose(f);
        return NULL;
    }
    Feeder *fd = (Feeder *)calloc(1, sizeof(Feeder));
    fd->f = f;
    fd->block_bytes = block_bytes;
    fd->nbuf = nbuf > 1 ? nbuf : 2;
    fd->bufs = (uint8_t **)calloc(fd->nbuf, sizeof(uint8_t *));
    fd->sizes = (int64_t *)calloc(fd->nbuf, sizeof(int64_t));
    for (int i = 0; i < fd->nbuf; ++i)
        fd->bufs[i] = (uint8_t *)malloc((size_t)block_bytes);
    pthread_mutex_init(&fd->mu, NULL);
    pthread_cond_init(&fd->can_fill, NULL);
    pthread_cond_init(&fd->can_take, NULL);
    if (pthread_create(&fd->thread, NULL, feeder_main, fd) != 0) {
        for (int i = 0; i < fd->nbuf; ++i)
            free(fd->bufs[i]);
        free(fd->bufs);
        free(fd->sizes);
        fclose(f);
        free(fd);
        return NULL;
    }
    return fd;
}

// Copies the next block into dst; returns bytes valid, 0 at EOF, or
// -1 when the reader thread hit a file I/O error.
int64_t pt_feeder_next(void *h, uint8_t *dst) {
    Feeder *fd = (Feeder *)h;
    pthread_mutex_lock(&fd->mu);
    if (fd->count == 0 && !fd->eof)
        fd->consumer_waits++;
    while (fd->count == 0 && !fd->eof)
        pthread_cond_wait(&fd->can_take, &fd->mu);
    if (fd->count == 0 && fd->eof) {
        int err = fd->err;
        pthread_mutex_unlock(&fd->mu);
        return err ? -1 : 0;
    }
    int slot = fd->tail;
    int64_t n = fd->sizes[slot];
    if (n > 0)
        memcpy(dst, fd->bufs[slot], (size_t)n);
    fd->tail = (fd->tail + 1) % fd->nbuf;
    fd->count--;
    fd->n_blocks++;
    pthread_cond_signal(&fd->can_fill);
    pthread_mutex_unlock(&fd->mu);
    return n;
}

// Fills out[0..2] with (blocks delivered, consumer waits, producer
// waits) — the ingest-overlap attribution the obs layer reports.
void pt_feeder_stats(void *h, int64_t *out) {
    Feeder *fd = (Feeder *)h;
    pthread_mutex_lock(&fd->mu);
    out[0] = fd->n_blocks;
    out[1] = fd->consumer_waits;
    out[2] = fd->producer_waits;
    pthread_mutex_unlock(&fd->mu);
}

void pt_feeder_close(void *h) {
    Feeder *fd = (Feeder *)h;
    pthread_mutex_lock(&fd->mu);
    fd->stop = 1;
    pthread_cond_broadcast(&fd->can_fill);
    pthread_mutex_unlock(&fd->mu);
    pthread_join(fd->thread, NULL);
    for (int i = 0; i < fd->nbuf; ++i)
        free(fd->bufs[i]);
    free(fd->bufs);
    free(fd->sizes);
    fclose(fd->f);
    pthread_mutex_destroy(&fd->mu);
    pthread_cond_destroy(&fd->can_fill);
    pthread_cond_destroy(&fd->can_take);
    free(fd);
}

}  // extern "C"
