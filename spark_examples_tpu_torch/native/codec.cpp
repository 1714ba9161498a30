// Native host-side codec of the PyTorch port (C ABI, loaded with ctypes).
//
// The host loops that feed the device, in one GIL-released pass each:
//
//   * 2-bit dosage packing    (ingest/bitpack.py pack_dosages)
//   * 2-bit unpack, host side (ingest/bitpack.py unpack_dosages_np)
//   * store chunk decode      (store/codec.py decode_into: inflate +
//                              unpack straight into the caller's buffer)
//   * VCF GT-column parsing   (ingest/vcf.py per record, and
//                              ingest/parallel.py per byte-range shard)
//
// They run in the feed's producer thread, the store's readahead workers
// and the ingest's parse workers. The Python implementations are the
// byte-identical fallbacks and the tests' oracle: the library only
// speeds things up, it never changes a result. This file is the port's
// own copy of the JAX package's native/codec.cpp, entry for entry.
//
// Build: g++ -O3 -march=native -shared -fPIC -Wl,--no-undefined
// codec.cpp -lz (spark_examples_tpu_torch/native/__init__.py builds it
// at first use into spark_examples_tpu_torch/_build/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <zlib.h>

extern "C" {

// (n, v) int8 dosages {-1,0,1,2} -> (n, ceil(v/4)) uint8, 4 codes/byte.
// code 3 = missing; pad columns (v % 4) are filled with code 3, which
// downstream accumulation treats as absent. Returns 0, or 1 if any
// value falls outside [-1, 2] (caller raises — silent truncation would
// corrupt counts).
int pack_dosages_i8(const int8_t* g, int64_t n, int64_t v, uint8_t* out) {
    const int64_t w = (v + 3) / 4;           // packed bytes per row
    const int64_t v4 = v / 4 * 4;            // full-byte prefix
    int bad = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* row = g + i * v;
        uint8_t* orow = out + i * w;
        int64_t j = 0;
        for (; j < v4; j += 4) {
            uint8_t b = 0;
            for (int k = 0; k < 4; ++k) {
                int8_t x = row[j + k];
                bad |= (x < -1) | (x > 2);
                uint8_t code = (x < 0) ? 3u : (uint8_t)x;
                b |= code << (2 * k);
            }
            orow[j >> 2] = b;
        }
        if (j < v) {                          // ragged tail byte
            uint8_t b = 0;
            for (int k = 0; k < 4; ++k) {
                uint8_t code = 3u;            // pad = missing
                if (j + k < v) {
                    int8_t x = row[j + k];
                    bad |= (x < -1) | (x > 2);
                    code = (x < 0) ? 3u : (uint8_t)x;
                }
                b |= code << (2 * k);
            }
            orow[j >> 2] = b;
        }
    }
    return bad;
}

// (n, w) packed uint8 -> (n, 4*w) int8 dosages; code 3 -> -1.
void unpack_dosages_u8(const uint8_t* packed, int64_t n, int64_t w,
                       int8_t* out);  // defined after unpack_clip below

// ---------------------------------------------------------------------------
// Store chunk decode-to-slab (spark_examples_tpu/store).
//
// One GIL-released call from a chunk file's STORED bytes to dense int8
// dosages written straight into a caller-provided buffer (a decode-
// cache entry, a read_range destination, or a prefetch staging-ring
// slab): inflate (when the chunk is compressed) + 2-bit unpack with
// variant clipping, at an arbitrary row stride and column offset —
// the zero-intermediate replacement for the Python hop chain
// (decompress -> bytes object -> full-width unpack -> slice -> copy).

// Unpack variants [v0, v1) of an (n, w)-byte packed payload into
// out[i * stride + (v - v0)]; code 3 -> -1. The aligned body expands a
// whole packed byte through a 256-entry -> 4-code table with one load
// and one 4-byte store (vs four shift+mask+LUT round trips), which is
// what keeps the decode memory-bound instead of ALU-bound.
static const int8_t lut4[4] = {0, 1, 2, -1};

static const uint32_t* byte_table() {
    // C++11 magic static: the guard synchronizes the first concurrent
    // GIL-released callers (the readahead pool's initial decodes race
    // here) — a plain `static bool ready` flag would let one thread
    // observe ready==true before another thread's table stores are
    // visible and expand bytes through a half-built table.
    struct Table {
        uint32_t tbl[256];
        Table() {
            for (int b = 0; b < 256; ++b) {
                int8_t q[4] = {lut4[b & 3], lut4[(b >> 2) & 3],
                               lut4[(b >> 4) & 3], lut4[(b >> 6) & 3]};
                memcpy(&tbl[b], q, 4);
            }
        }
    };
    static const Table t;
    return t.tbl;
}

static void unpack_clip(const uint8_t* packed, int64_t n, int64_t w,
                        int64_t v0, int64_t v1, int8_t* out,
                        int64_t stride) {
    const uint32_t* tbl = byte_table();
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = packed + i * w;
        int8_t* orow = out + i * stride - v0;
        int64_t j = v0;
        for (; j < v1 && (j & 3); ++j)
            orow[j] = lut4[(row[j >> 2] >> (2 * (j & 3))) & 3];
        for (; j + 4 <= v1; j += 4) {               // byte-aligned body
            uint32_t q = tbl[row[j >> 2]];
            memcpy(orow + j, &q, 4);
        }
        for (; j < v1; ++j)
            orow[j] = lut4[(row[j >> 2] >> (2 * (j & 3))) & 3];
    }
}

void unpack_dosages_u8(const uint8_t* packed, int64_t n, int64_t w,
                       int8_t* out) {
    unpack_clip(packed, n, w, 0, 4 * w, out, 4 * w);
}

// Inflate `stored_len` bytes into exactly `raw_size` bytes of `raw`,
// with an optional preset dictionary. Feeds <1 GiB windows (the
// z_stream counters are 32-bit); once the real buffer fills, a spare
// sink distinguishes "trailer still pending" (no further output) from
// genuine overflow. Returns 0 ok, 2 stream error / truncation,
// 3 size mismatch. Accepts (like the Python decompressobj reference
// path) trailing bytes after the stream end — the sha256 verify owns
// exact-byte integrity.
static int inflate_all(const uint8_t* stored, int64_t stored_len,
                       const uint8_t* dict, int64_t dict_len,
                       uint8_t* raw, int64_t raw_size) {
    z_stream strm;
    memset(&strm, 0, sizeof(strm));
    if (inflateInit2(&strm, 15) != Z_OK) return 2;
    const int64_t kWin = 1LL << 30;
    int64_t in_off = 0, out_done = 0;
    uint8_t spare[64];
    int ret = Z_OK;
    for (;;) {
        if (strm.avail_in == 0 && in_off < stored_len) {
            int64_t take = stored_len - in_off;
            if (take > kWin) take = kWin;
            strm.next_in = const_cast<Bytef*>(stored + in_off);
            strm.avail_in = (uInt)take;
            in_off += take;
        }
        int using_spare = 0;
        if (strm.avail_out == 0) {
            if (out_done < raw_size) {
                int64_t give = raw_size - out_done;
                if (give > kWin) give = kWin;
                strm.next_out = raw + out_done;
                strm.avail_out = (uInt)give;
            } else {
                strm.next_out = spare;
                strm.avail_out = (uInt)sizeof(spare);
                using_spare = 1;
            }
        } else if (out_done >= raw_size) {
            using_spare = 1;  // a previously-handed spare window
        }
        uInt before = strm.avail_out;
        ret = inflate(&strm, Z_NO_FLUSH);
        if (ret == Z_NEED_DICT) {
            if (!dict || dict_len <= 0 ||
                inflateSetDictionary(&strm, dict, (uInt)dict_len) != Z_OK) {
                inflateEnd(&strm);
                return 2;
            }
            ret = inflate(&strm, Z_NO_FLUSH);
        }
        uInt produced = before - strm.avail_out;
        if (using_spare) {
            if (produced > 0) {  // more output than the catalog says
                inflateEnd(&strm);
                return 3;
            }
        } else {
            out_done += produced;
        }
        if (ret == Z_STREAM_END) break;
        if (ret == Z_BUF_ERROR && strm.avail_in == 0 &&
            in_off >= stored_len) {
            inflateEnd(&strm);   // truncated stream: no input, no end
            return 2;
        }
        if (ret != Z_OK && ret != Z_BUF_ERROR) {
            inflateEnd(&strm);
            return 2;
        }
    }
    inflateEnd(&strm);
    return out_done == raw_size ? 0 : 3;
}

// Decode variants [v0, v1) of one stored chunk into `out` (row stride
// `out_stride` int8 elements; the caller points `out` at its target
// column). codec: 0 = raw (stored bytes ARE the (n, w_bytes) payload),
// 1 = zlib. Returns 0 ok, 1 unknown codec, 2 inflate/stream error,
// 3 size mismatch, 4 allocation failure.
int store_decode_chunk(const uint8_t* stored, int64_t stored_len,
                       int32_t codec, const uint8_t* dict,
                       int64_t dict_len, int64_t n, int64_t w_bytes,
                       int64_t v0, int64_t v1, int8_t* out,
                       int64_t out_stride) {
    if (codec == 0) {
        if (stored_len != n * w_bytes) return 3;
        unpack_clip(stored, n, w_bytes, v0, v1, out, out_stride);
        return 0;
    }
    if (codec != 1) return 1;
    uint8_t* raw = (uint8_t*)malloc((size_t)(n * w_bytes));
    if (!raw) return 4;
    int rc = inflate_all(stored, stored_len, dict, dict_len, raw,
                         n * w_bytes);
    if (rc == 0) unpack_clip(raw, n, w_bytes, v0, v1, out, out_stride);
    free(raw);
    return rc;
}

// Shared sample-column scan of one record: parse `n_samples` GT
// subfields starting at `p` (the first sample column). Returns samples
// parsed; < n_samples means a short record.
static int64_t parse_samples(const char* p, const char* end,
                             int64_t gt_index, int8_t* out,
                             int64_t n_samples) {
    int64_t s = 0;
    while (s < n_samples) {
        if (p > end) return s;
        const char* fend = p;
        while (fend < end && *fend != '\t') ++fend;
        // Select colon-subfield gt_index within [p, fend).
        const char* g = p;
        for (int64_t c = 0; c < gt_index; ++c) {
            while (g < fend && *g != ':') ++g;
            if (g >= fend) break;             // missing subfield -> empty GT
            ++g;
        }
        const char* gend = g;
        while (gend < fend && *gend != ':') ++gend;
        // Parse alleles.
        int dose = 0, seen = 0;
        const char* a = g;
        while (a <= gend) {
            const char* aend = a;
            while (aend < gend && *aend != '/' && *aend != '|') ++aend;
            int64_t alen = aend - a;
            if (alen > 0 && !(alen == 1 && a[0] == '.')) {
                seen = 1;
                if (!(alen == 1 && a[0] == '0')) ++dose;
            }
            if (aend >= gend) break;
            a = aend + 1;
        }
        out[s++] = seen ? (int8_t)(dose > 2 ? 2 : dose) : (int8_t)-1;
        if (fend >= end) break;
        p = fend + 1;
    }
    return s;
}

// One VCF record's sample columns -> int8 dosages.
//
// `line` spans the whole tab-separated record (no trailing newline
// required); parsing starts after `skip_fields` tabs (9 = the fixed VCF
// columns). Each sample field is split on ':', subfield `gt_index` is
// the GT string; alleles split on '/' or '|'. Semantics identical to
// ingest/vcf.py _dosage: any non-"0" called allele adds 1 (capped at
// 2), "." alleles are skipped, no called allele -> -1 (missing).
// Returns the number of samples parsed (== n_samples on success), or -1
// if the record has fewer sample columns than n_samples.
int64_t vcf_parse_gt(const char* line, int64_t len, int64_t skip_fields,
                     int64_t gt_index, int8_t* out, int64_t n_samples) {
    const char* p = line;
    const char* end = line + len;
    for (int64_t f = 0; f < skip_fields; ++f) {
        while (p < end && *p != '\t') ++p;
        if (p >= end) return -1;
        ++p;                                  // past the tab
    }
    return parse_samples(p, end, gt_index, out, n_samples);
}

// Batch parse: every VCF data line in buf[0, len) in ONE call — the
// whole-shard inner loop of the parallel ingest engine. A single-line
// call pays ctypes marshaling + Python line handling per RECORD (which
// also holds the GIL, so shard worker threads cannot scale); this
// parses a shard's worth per call with the GIL released throughout.
//
// Per accepted record r: out[r, :] = dosages, out_pos[r] = POS, and
// out_coff/out_clen[r] = the contig's byte span inside buf (the caller
// slices the strings; C never allocates). Skip semantics mirror
// ingest/vcf.py parse_record_lines exactly: '#' lines and lines with
// fewer than 10 tab-separated fields are skipped silently, records
// whose FORMAT lacks a GT token are skipped silently, and records with
// fewer than n_samples sample columns are skipped and counted into
// *n_short (the caller warns once). A POS field that is not a plain
// (optionally signed) integer sets *n_reject and aborts the batch —
// the caller falls back to the Python parser so malformed input raises
// exactly the error the serial path raises.
// Returns the number of accepted records (rows of `out` filled).
int64_t vcf_parse_block(const char* buf, int64_t len, int64_t n_samples,
                        int64_t max_records, int8_t* out, int64_t* out_pos,
                        int64_t* out_coff, int64_t* out_clen,
                        int64_t* n_short, int64_t* n_reject) {
    int64_t r = 0;
    const char* p = buf;
    const char* bend = buf + len;
    *n_short = 0;
    *n_reject = 0;
    while (p < bend && r < max_records) {
        const char* line = p;
        const char* nl = (const char*)memchr(p, '\n', bend - p);
        const char* lend = nl ? nl : bend;
        p = nl ? nl + 1 : bend;
        if (lend > line && lend[-1] == '\r') --lend;  // CRLF files raw
        if (lend == line) continue;                   // empty line
        if (line[0] == '#') continue;                 // header
        // Starts of the first 10 tab-separated fields.
        const char* f[10];
        f[0] = line;
        int nf = 1;
        for (const char* q = line; q < lend && nf < 10; ++q) {
            if (*q == '\t') f[nf++] = q + 1;
        }
        if (nf < 10) continue;                        // < 10 fields
        // POS (field 1) — a plain integer, or punt the whole batch.
        const char* d = f[1];
        const char* posend = f[2] - 1;                // the tab after it
        int64_t pos = 0;
        int neg = 0, any = 0;
        if (d < posend && (*d == '-' || *d == '+')) {
            neg = (*d == '-');
            ++d;
        }
        for (; d < posend && *d >= '0' && *d <= '9'; ++d) {
            pos = pos * 10 + (*d - '0');
            any = 1;
        }
        if (!any || d != posend) {
            *n_reject = 1;
            return r;
        }
        if (neg) pos = -pos;
        // FORMAT (field 8): locate the GT token among ':'-separated.
        const char* fm = f[8];
        const char* fmend = f[9] - 1;
        int64_t gt_index = -1, tok = 0;
        for (const char* t = fm; t <= fmend; ++tok) {
            const char* te = t;
            while (te < fmend && *te != ':') ++te;
            if (te - t == 2 && t[0] == 'G' && t[1] == 'T') {
                gt_index = tok;
                break;
            }
            if (te >= fmend) break;
            t = te + 1;
        }
        if (gt_index < 0) continue;                   // no genotypes
        int64_t got = parse_samples(f[9], lend, gt_index,
                                    out + r * n_samples, n_samples);
        if (got < n_samples) {
            ++*n_short;
            continue;
        }
        out_pos[r] = pos;
        out_coff[r] = f[0] - buf;
        out_clen[r] = (f[1] - 1) - f[0];
        ++r;
    }
    if (p < bend && r >= max_records) {
        // Caller under-sized the output (its bound assumes an accepted
        // record spans at least n_samples+9 bytes of tabs) — punt the
        // batch rather than silently dropping the tail records.
        *n_reject = 1;
    }
    return r;
}

}  // extern "C"
