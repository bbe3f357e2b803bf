// bamcore: native BAM decoding hot path for sniffles-tpu.
//
// Replaces the per-read Python work of the reference's hot loops
// (reference: leadprov.py:488-571 per-read fetch/filter loop and
// :602-670 per-CIGAR-op scan — the wall-clock dominant code on a 30x
// genome). The reference gets this from htslib via pysam; this
// environment has no htslib, so the BGZF inflate and record scan are
// implemented here directly against zlib.
//
// Exposed C ABI (loaded from Python via ctypes, io/native.py):
//   bamcore_bgzf_inflate   — decompress a BGZF byte range
//   bamcore_scan_records   — single pass over decompressed alignment
//                            records: per-record geometry, tag extraction
//                            (NM/SA/HP/PS), CIGAR indel/clip events
//
// Build: sniffles_tpu_torch/ops/_build.py (build_host), at first use.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <zlib.h>
#include <dlfcn.h>

// ---------------------------------------------------------------------------
// libdeflate (optional, dlopen'd): raw-deflate decode 2-3x faster than
// zlib inflate. BGZF stores each block's exact uncompressed size (ISIZE),
// which is libdeflate's fastest mode (single-shot, exact output buffer).
// Falls back to zlib when the library is absent at runtime.
// ---------------------------------------------------------------------------

namespace {

typedef void* (*ld_alloc_fn)();
typedef int (*ld_decomp_fn)(void*, const void*, size_t, void*, size_t, size_t*);
typedef void (*ld_free_fn)(void*);

struct LibDeflate {
    ld_alloc_fn alloc_decompressor = nullptr;
    ld_decomp_fn deflate_decompress = nullptr;
    ld_free_fn free_decompressor = nullptr;
    bool ok = false;
    LibDeflate() {
        void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
        if (!h) return;
        alloc_decompressor = (ld_alloc_fn)dlsym(h, "libdeflate_alloc_decompressor");
        deflate_decompress = (ld_decomp_fn)dlsym(h, "libdeflate_deflate_decompress");
        free_decompressor = (ld_free_fn)dlsym(h, "libdeflate_free_decompressor");
        ok = alloc_decompressor && deflate_decompress && free_decompressor;
    }
};

const LibDeflate& libdeflate() {
    static LibDeflate ld;
    return ld;
}

// ISIZE (uncompressed length) from the BGZF block tail.
inline uint32_t bgzf_isize(const uint8_t* raw, int64_t in_off, int32_t bsize) {
    uint32_t isize;
    std::memcpy(&isize, raw + in_off + bsize - 4, 4);
    return isize;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Decompress consecutive BGZF blocks from `raw` into `out`.
// Returns 0 on success; fills *out_len with decompressed size.
// Diagnostic: 1 when the libdeflate fast path is active in this process.
int bamcore_libdeflate_ok(void) {
    return libdeflate().ok ? 1 : 0;
}

int bamcore_bgzf_inflate(const uint8_t* raw, int64_t raw_len,
                         uint8_t* out, int64_t out_cap, int64_t* out_len) {
    int64_t in_off = 0;
    int64_t out_off = 0;
    while (in_off + 18 <= raw_len) {
        if (raw[in_off] != 0x1f || raw[in_off + 1] != 0x8b) return -1;
        uint16_t xlen;
        std::memcpy(&xlen, raw + in_off + 10, 2);
        // find BSIZE in extra subfields
        int64_t ext = in_off + 12;
        int64_t ext_end = ext + xlen;
        int32_t bsize = -1;
        while (ext + 4 <= ext_end) {
            uint8_t si1 = raw[ext], si2 = raw[ext + 1];
            uint16_t slen;
            std::memcpy(&slen, raw + ext + 2, 2);
            if (si1 == 66 && si2 == 67) {
                uint16_t bs;
                std::memcpy(&bs, raw + ext + 4, 2);
                bsize = (int32_t)bs + 1;
                break;
            }
            ext += 4 + slen;
        }
        if (bsize < 0) return -2;
        int64_t cdata_off = in_off + 12 + xlen;
        int64_t cdata_len = bsize - 12 - xlen - 8;
        if (in_off + bsize > raw_len) break;  // truncated tail block

        const LibDeflate& ld = libdeflate();
        static thread_local void* dec = nullptr;
        if (ld.ok && !dec) dec = ld.alloc_decompressor();
        if (ld.ok && dec) {
            uint32_t isize = bgzf_isize(raw, in_off, bsize);
            if (out_off + (int64_t)isize > out_cap) return -5;
            if (isize > 0) {
                size_t actual = 0;
                int ret = ld.deflate_decompress(dec, raw + cdata_off, (size_t)cdata_len,
                                                out + out_off, (size_t)isize, &actual);
                if (ret != 0 || actual != isize) return -4;
            }
            out_off += isize;
        } else {
            z_stream zs;
            std::memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) return -3;
            zs.next_in = const_cast<Bytef*>(raw + cdata_off);
            zs.avail_in = (uInt)cdata_len;
            zs.next_out = out + out_off;
            zs.avail_out = (uInt)(out_cap - out_off);
            int ret = inflate(&zs, Z_FINISH);
            int64_t produced = (int64_t)zs.total_out;
            inflateEnd(&zs);
            if (ret != Z_STREAM_END) return -4;
            out_off += produced;
        }
        in_off += bsize;
    }
    *out_len = out_off;
    return 0;
}

// Walk BGZF block headers without decompressing: fills per-block
// (coffset, bsize, isize) arrays; returns the block count, or -1 on a
// malformed header. Mirrors io/native.py walk_blocks (BSIZE from the BC
// subfield, ISIZE from the trailer) for the hot region-scan path.
int64_t bamcore_bgzf_walk(const uint8_t* raw, int64_t raw_len,
                          int64_t* offs, int32_t* bsizes, int32_t* isizes,
                          int64_t cap) {
    int64_t off = 0, n = 0;
    while (off + 18 <= raw_len && n < cap) {
        if (raw[off] != 0x1f || raw[off + 1] != 0x8b) return -1;
        uint16_t xlen;
        std::memcpy(&xlen, raw + off + 10, 2);
        int64_t ext = off + 12, ext_end = ext + xlen;
        int32_t bsize = -1;
        while (ext + 4 <= ext_end) {
            uint16_t slen;
            std::memcpy(&slen, raw + ext + 2, 2);
            if (raw[ext] == 66 && raw[ext + 1] == 67) {
                uint16_t bs;
                std::memcpy(&bs, raw + ext + 4, 2);
                bsize = (int32_t)bs + 1;
                break;
            }
            ext += 4 + slen;
        }
        if (bsize < 0 || off + bsize > raw_len) break;
        uint32_t isize;
        std::memcpy(&isize, raw + off + bsize - 4, 4);
        offs[n] = off;
        bsizes[n] = bsize;
        isizes[n] = (int32_t)isize;
        n++;
        off += bsize;
    }
    return n;
}

// Multithreaded BGZF inflate: blocks are independent deflate streams, so
// worker threads pull blocks from a shared counter and write into
// precomputed output offsets (from the ISIZE header walk done in Python).
int bamcore_bgzf_inflate_mt(const uint8_t* raw,
                            const int64_t* block_in_off,   // [n_blocks]
                            const int32_t* block_in_len,   // [n_blocks] (BSIZE)
                            const int64_t* block_out_off,  // [n_blocks]
                            int64_t n_blocks,
                            uint8_t* out, int64_t out_cap,
                            int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);

    const LibDeflate& ld = libdeflate();

    auto worker = [&]() {
        void* dec = ld.ok ? ld.alloc_decompressor() : nullptr;
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (!dec && inflateInit2(&zs, -15) != Z_OK) { err.store(-3); return; }
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_blocks || err.load() != 0) break;
            int64_t in_off = block_in_off[i];
            int32_t bsize = block_in_len[i];
            // locate cdata inside the block (12-byte header + xlen extra)
            uint16_t xlen;
            std::memcpy(&xlen, raw + in_off + 10, 2);
            int64_t cdata_off = in_off + 12 + xlen;
            int64_t cdata_len = bsize - 12 - xlen - 8;
            if (block_out_off[i] >= out_cap) { err.store(-5); break; }
            if (dec) {
                uint32_t isize = bgzf_isize(raw, in_off, bsize);
                if (block_out_off[i] + (int64_t)isize > out_cap) { err.store(-5); break; }
                if (isize == 0) continue;
                size_t actual = 0;
                int ret = ld.deflate_decompress(dec, raw + cdata_off, (size_t)cdata_len,
                                                out + block_out_off[i], (size_t)isize,
                                                &actual);
                if (ret != 0 || actual != isize) { err.store(-4); break; }
            } else {
                if (inflateReset(&zs) != Z_OK) { err.store(-3); break; }
                zs.next_in = const_cast<Bytef*>(raw + cdata_off);
                zs.avail_in = (uInt)cdata_len;
                zs.next_out = out + block_out_off[i];
                zs.avail_out = (uInt)(out_cap - block_out_off[i]);
                int ret = inflate(&zs, Z_FINISH);
                if (ret != Z_STREAM_END) { err.store(-4); break; }
            }
        }
        if (dec) ld.free_decompressor(dec);
        else inflateEnd(&zs);
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return err.load();
}

// ---------------------------------------------------------------------------
// Record scan
// ---------------------------------------------------------------------------

// CIGAR op consumption tables (reference: leadprov.py:180-195 OPTAB)
static const int CONSUME_READ[9] = {1, 1, 0, 0, 1, 0, 0, 1, 1};
static const int CONSUME_REF[9] = {1, 0, 1, 1, 0, 0, 0, 1, 1};

enum { OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4, OP_H = 5, OP_P = 6, OP_EQ = 7, OP_X = 8 };

struct RecordCols {
    int64_t* offset;      // byte offset of record body (after block_size)
    int32_t* rec_len;
    int32_t* refid;
    int32_t* pos;
    int32_t* flag;
    int32_t* mapq;
    int32_t* ref_len;     // reference span
    int32_t* qstart;      // leading soft clip
    int32_t* qalen;       // aligned query length (M/I/=/X)
    int32_t* l_seq;
    int32_t* nm;          // NM tag or -1
    int32_t* hp;          // HP tag or 0
    int32_t* ps;          // PS tag or -1 (NULL)
    int64_t* sa_off;      // offset of SA string value, -1 if absent
    int32_t* sa_len;
    int32_t* large_indel_sum;  // sum of ins+del ops > nm_adjust_oplen
    int64_t* name_off;
    int32_t* name_len;
    int64_t* seq_off;     // offset of packed 4-bit seq
};

struct EventCols {
    int32_t* rec_index;
    int32_t* op;       // CIGAR op
    int32_t* oplen;
    int32_t* pos_ref;  // reference position of the event
    int32_t* pos_read; // read position of the event
};

// Scan alignment records from decompressed buffer [data, data+len).
// Emits per-record columns and CIGAR events (I/D/S/H ops with
// oplen >= min_event_len). Returns number of records scanned, or < 0 on
// error. Stops early when capacities are reached (callers size
// generously and retry on the -9 / -10 sentinel).
int64_t bamcore_scan_records(const uint8_t* data, int64_t len,
                             int32_t min_event_len, int32_t nm_adjust_oplen,
                             RecordCols* rc, int64_t rec_cap,
                             EventCols* ec, int64_t ev_cap,
                             int64_t* n_events_out) {
    int64_t off = 0;
    int64_t nrec = 0;
    int64_t nev = 0;

    while (off + 4 <= len) {
        int32_t block_size;
        std::memcpy(&block_size, data + off, 4);
        if (block_size < 32 || off + 4 + block_size > len) break;
        const uint8_t* r = data + off + 4;

        if (nrec >= rec_cap) return -9;

        int32_t refid, pos, l_seq, next_refid, next_pos, tlen;
        std::memcpy(&refid, r, 4);
        std::memcpy(&pos, r + 4, 4);
        uint8_t l_read_name = r[8];
        uint8_t mapq = r[9];
        uint16_t n_cigar, flag;
        std::memcpy(&n_cigar, r + 12, 2);
        std::memcpy(&flag, r + 14, 2);
        std::memcpy(&l_seq, r + 16, 4);
        std::memcpy(&next_refid, r + 20, 4);
        std::memcpy(&next_pos, r + 24, 4);
        std::memcpy(&tlen, r + 28, 4);

        const uint8_t* name = r + 32;
        const uint8_t* cig = name + l_read_name;
        const uint8_t* seq = cig + 4ll * n_cigar;
        int64_t seq_bytes = (l_seq + 1) / 2;
        const uint8_t* qual = seq + seq_bytes;
        const uint8_t* tags = qual + l_seq;
        const uint8_t* rec_end = r + block_size;

        // CIGAR walk: geometry + events
        int32_t ref_len = 0, qstart = 0, qalen = 0;
        int32_t large_sum = 0;
        int32_t pos_read = 0, pos_ref = pos;
        bool seen_aligned = false;
        for (uint32_t ci = 0; ci < n_cigar; ci++) {
            uint32_t cv;
            std::memcpy(&cv, cig + 4ll * ci, 4);
            uint32_t op = cv & 0xF;
            int32_t oplen = (int32_t)(cv >> 4);
            if (op > 8) continue;
            ref_len += CONSUME_REF[op] * oplen;
            if (op == OP_M || op == OP_I || op == OP_EQ || op == OP_X) {
                qalen += oplen;
                seen_aligned = true;
            } else if (op == OP_S && !seen_aligned) {
                qstart += oplen;
            }
            if ((op == OP_I || op == OP_D) && oplen > nm_adjust_oplen)
                large_sum += oplen;
            if ((op == OP_I || op == OP_D || op == OP_S || op == OP_H) && oplen >= min_event_len) {
                if (nev >= ev_cap) return -10;
                ec->rec_index[nev] = (int32_t)nrec;
                ec->op[nev] = (int32_t)op;
                ec->oplen[nev] = oplen;
                ec->pos_ref[nev] = pos_ref;
                ec->pos_read[nev] = pos_read;
                nev++;
            }
            pos_read += CONSUME_READ[op] * oplen;
            pos_ref += CONSUME_REF[op] * oplen;
        }

        // tag walk: NM / SA / HP / PS
        int32_t nm = -1, hp = 0, ps = -1;
        int64_t sa_off = -1;
        int32_t sa_len = 0;
        const uint8_t* t = tags;
        while (t + 3 <= rec_end) {
            char t0 = (char)t[0], t1 = (char)t[1], typ = (char)t[2];
            const uint8_t* v = t + 3;
            int64_t vlen = 0;
            int64_t ival = 0;
            bool is_int = false;
            switch (typ) {
                case 'A': vlen = 1; break;
                case 'c': { int8_t x; std::memcpy(&x, v, 1); ival = x; is_int = true; vlen = 1; break; }
                case 'C': { uint8_t x = *v; ival = x; is_int = true; vlen = 1; break; }
                case 's': { int16_t x; std::memcpy(&x, v, 2); ival = x; is_int = true; vlen = 2; break; }
                case 'S': { uint16_t x; std::memcpy(&x, v, 2); ival = x; is_int = true; vlen = 2; break; }
                case 'i': { int32_t x; std::memcpy(&x, v, 4); ival = x; is_int = true; vlen = 4; break; }
                case 'I': { uint32_t x; std::memcpy(&x, v, 4); ival = (int64_t)x; is_int = true; vlen = 4; break; }
                case 'f': vlen = 4; break;
                case 'Z': case 'H': {
                    const uint8_t* z = v;
                    while (z < rec_end && *z != 0) z++;
                    vlen = (z - v) + 1;
                    break;
                }
                case 'B': {
                    char sub = (char)v[0];
                    uint32_t cnt;
                    std::memcpy(&cnt, v + 1, 4);
                    int esz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
                    vlen = 5 + (int64_t)cnt * esz;
                    break;
                }
                default:
                    vlen = rec_end - v;  // unknown: stop
            }
            if (t0 == 'N' && t1 == 'M' && is_int) nm = (int32_t)ival;
            else if (t0 == 'H' && t1 == 'P' && is_int) hp = (int32_t)ival;
            else if (t0 == 'P' && t1 == 'S' && is_int) ps = (int32_t)ival;
            else if (t0 == 'S' && t1 == 'A' && (typ == 'Z')) {
                sa_off = (v - data);
                sa_len = (int32_t)(vlen - 1);
            }
            t = v + vlen;
        }

        rc->offset[nrec] = off + 4;
        rc->rec_len[nrec] = block_size;
        rc->refid[nrec] = refid;
        rc->pos[nrec] = pos;
        rc->flag[nrec] = flag;
        rc->mapq[nrec] = mapq;
        rc->ref_len[nrec] = ref_len;
        rc->qstart[nrec] = qstart;
        rc->qalen[nrec] = qalen;
        rc->l_seq[nrec] = l_seq;
        rc->nm[nrec] = nm;
        rc->hp[nrec] = hp;
        rc->ps[nrec] = ps;
        rc->sa_off[nrec] = sa_off;
        rc->sa_len[nrec] = sa_len;
        rc->large_indel_sum[nrec] = large_sum;
        rc->name_off[nrec] = (name - data);
        rc->name_len[nrec] = l_read_name - 1;
        rc->seq_off[nrec] = (seq - data);
        nrec++;
        off += 4 + block_size;
    }
    *n_events_out = nev;
    return nrec;
}

// Decode a slice of 4-bit packed sequence into ASCII.
void bamcore_decode_seq(const uint8_t* packed, int64_t l_seq,
                        int64_t start, int64_t end, char* out) {
    static const char NT16[] = "=ACMGRSVTWYHKDBN";
    for (int64_t i = start; i < end && i < l_seq; i++) {
        uint8_t b = packed[i >> 1];
        out[i - start] = NT16[(i & 1) ? (b & 0xF) : (b >> 4)];
    }
}

// Global (NW) Levenshtein distance, Myers bit-parallel over uint64
// blocks. Exact equivalent of the Python big-int implementation in
// ops/edit_distance.py (which replaces edlib for the INS merge gates,
// reference: sv.py:287, snfp.py:103); ~100x faster for kb-scale
// sequences since Python big-int ops are O(words) interpreted.
int64_t bamcore_edit_distance_k(const uint8_t* a, int64_t m,
                                const uint8_t* b, int64_t n, int64_t k);

int64_t bamcore_edit_distance(const uint8_t* a, int64_t m,
                              const uint8_t* b, int64_t n) {
    return bamcore_edit_distance_k(a, m, b, n, -1);
}

// Bounded variant: returns the exact distance when it is <= k, and any
// value > k (k+1) when it exceeds k; k < 0 computes the full distance.
// Two exact shortcuts on top of the Myers scan:
//   * common prefix/suffix trimming (unit edit costs: the distance of
//     the trimmed middles equals the full distance), which collapses
//     the near-identical pairs that dominate population INS merge gates
//     (reference: sv.py:287, snfp.py:103) to O(d^2)-ish work;
//   * per-column abort: the bottom-row score can decrease by at most 1
//     per remaining column, so score - (n - j) > k proves the final
//     distance exceeds k (common for cross-allele pairs, which sit far
//     above the identity threshold).
int64_t bamcore_edit_distance_k(const uint8_t* a, int64_t m,
                                const uint8_t* b, int64_t n, int64_t k) {
    // trim common prefix / suffix
    while (m > 0 && n > 0 && a[0] == b[0]) { a++; b++; m--; n--; }
    while (m > 0 && n > 0 && a[m - 1] == b[n - 1]) { m--; n--; }
    if (k >= 0) {
        const int64_t lb = (m > n) ? (m - n) : (n - m);
        if (lb > k) return k + 1;
    }
    if (m == 0) return n;
    if (n == 0) return m;
    const int64_t kw = (m + 63) / 64;
    const int mbits = (int)(m - 64 * (kw - 1));
    const uint64_t mask_last =
        (mbits == 64) ? ~0ULL : ((1ULL << mbits) - 1ULL);
    const int top = mbits - 1;

    // thread-local scratch; only the symbol rows actually referenced are
    // cleared (DNA alphabets touch ~5 of the 256 rows)
    static thread_local std::vector<uint64_t> peq;
    static thread_local std::vector<uint64_t> state;
    if (peq.size() < (size_t)kw * 256) peq.assign((size_t)kw * 256, 0);
    if (state.size() < (size_t)kw * 2) state.resize((size_t)kw * 2);
    bool seen[256] = {false};
    for (int64_t i = 0; i < m; i++) seen[a[i]] = true;
    for (int64_t j = 0; j < n; j++) seen[b[j]] = true;
    for (int c = 0; c < 256; c++)
        if (seen[c]) memset(&peq[(size_t)kw * c], 0, (size_t)kw * 8);
    for (int64_t i = 0; i < m; i++)
        peq[(size_t)kw * a[i] + (i >> 6)] |= 1ULL << (i & 63);

    uint64_t* pv = &state[0];
    uint64_t* mv = &state[kw];
    for (int64_t w = 0; w < kw; w++) { pv[w] = ~0ULL; mv[w] = 0; }
    pv[kw - 1] = mask_last;
    int64_t score = m;

    // single low-to-high word pass per text char: the add carry and both
    // shift carries all propagate in the same direction
    for (int64_t j = 0; j < n; j++) {
        const uint64_t* eq = &peq[(size_t)kw * b[j]];
        unsigned __int128 addc = 0;
        uint64_t phc = 1, mhc = 0;
        for (int64_t w = 0; w < kw; w++) {
            const uint64_t eqw = eq[w], pvw = pv[w], mvw = mv[w];
            const uint64_t ep = eqw & pvw;
            const unsigned __int128 s = (unsigned __int128)ep + pvw + addc;
            addc = s >> 64;
            const uint64_t xhw = ((uint64_t)s ^ pvw) | eqw;
            const uint64_t xvw = eqw | mvw;
            uint64_t phw = mvw | ~(xhw | pvw);
            const uint64_t mhw = pvw & xhw;
            if (w == kw - 1) {
                phw &= mask_last;
                score += (int64_t)((phw >> top) & 1);
                score -= (int64_t)((mhw >> top) & 1);
            }
            uint64_t ph_sh = (phw << 1) | phc;
            phc = phw >> 63;
            const uint64_t mh_sh = (mhw << 1) | mhc;
            mhc = mhw >> 63;
            if (w == kw - 1) ph_sh &= mask_last;
            mv[w] = ph_sh & xvw;
            uint64_t pvn = mh_sh | ~(xvw | ph_sh);
            if (w == kw - 1) pvn &= mask_last;
            pv[w] = pvn;
        }
        if (k >= 0 && score - (n - 1 - j) > k) return k + 1;
    }
    return score;
}

// Fused coverage accumulation: running prefix sum over a difference
// array, added in place into a uint16 coverage track. Replaces
// numpy's scalar cumsum + astype + += chain (the per-base coverage
// build, reference: leadprov.py:508-515), which is the second-largest
// host cost on wide scans.
void bamcore_prefix_add_u16(const int32_t* diff, uint16_t* cov, int64_t n) {
    int32_t running = 0;
    for (int64_t i = 0; i < n; i++) {
        running += diff[i];
        cov[i] = (uint16_t)(cov[i] + (uint16_t)running);
    }
}

// Fused coverage accumulation straight from read intervals: the
// difference-array build (numpy add.at over a span-sized scratch) plus
// the prefix-add above, in one native pass with a reused scratch
// buffer. Semantics match the numpy chain in leads._iter_region_native:
// indices clamp to [0, hi-lo], the prefix covers cov[lo:hi], uint16
// wraparound.
void bamcore_coverage_add(const int64_t* starts, const int64_t* ends,
                          int64_t n_reads, uint16_t* cov,
                          int64_t lo, int64_t hi) {
    int64_t span = hi - lo;           // cov slice length; diff has span+1
    if (span <= 0) return;
    static thread_local std::vector<int32_t> diff;
    if ((int64_t)diff.size() < span + 1) diff.resize(span + 1);
    std::fill(diff.begin(), diff.begin() + span + 1, 0);
    for (int64_t i = 0; i < n_reads; i++) {
        int64_t s = starts[i] - lo;
        int64_t e = ends[i] - lo;
        if (s < 0) s = 0; else if (s > span) s = span;
        if (e < 0) e = 0; else if (e > span) e = span;
        diff[s] += 1;
        diff[e] -= 1;
    }
    int32_t running = 0;
    for (int64_t i = 0; i < span; i++) {
        running += diff[i];
        cov[i] = (uint16_t)(cov[i] + (uint16_t)running);
    }
}

// One-call chunk measure for the region scan (replaces a Python
// per-block header walk): total ISIZE of blocks starting in [cb, ce)
// plus the ce block when ce_within > 0, the compressed range end, and
// the ISIZE of the block at ce. Returns the block count walked, or -1
// on a malformed header.
int64_t bamcore_bgzf_measure(const uint8_t* raw, int64_t raw_len,
                             int64_t cb, int64_t ce, int32_t ce_within,
                             int64_t* body_isize, int64_t* range_end,
                             int32_t* ce_isize) {
    int64_t off = cb, n = 0, body = 0, rend = ce;
    int32_t ce_is = -1;
    while (off + 18 <= raw_len) {
        if (raw[off] != 0x1f || raw[off + 1] != 0x8b) return -1;
        uint16_t xlen;
        std::memcpy(&xlen, raw + off + 10, 2);
        int64_t ext = off + 12, ext_end = ext + xlen;
        int32_t bsize = -1;
        while (ext + 4 <= ext_end) {
            uint16_t slen;
            std::memcpy(&slen, raw + ext + 2, 2);
            if (raw[ext] == 66 && raw[ext + 1] == 67) {
                uint16_t bs;
                std::memcpy(&bs, raw + ext + 4, 2);
                bsize = (int32_t)bs + 1;
                break;
            }
            ext += 4 + slen;
        }
        if (bsize < 0 || off + bsize > raw_len) break;
        uint32_t isize;
        std::memcpy(&isize, raw + off + bsize - 4, 4);
        if (off < ce) {
            body += (int64_t)isize;
            rend = off + bsize;
        } else if (off == ce) {
            ce_is = (int32_t)isize;
            if (ce_within > 0) {
                body += (int64_t)isize;
                rend = off + bsize;
            }
            n++;
            break;
        } else {
            break;
        }
        n++;
        off += bsize;
    }
    *body_isize = body;
    *range_end = rend;
    *ce_isize = ce_is;
    return n;
}

// ---------------------------------------------------------------------------
// rANS 4x8 (CRAM 3.0 compression method 4). Bitstream-identical to the
// Python implementation in sniffles_tpu_torch/io/cram_codecs.py (which is the
// exactness reference); this is the production codec for CRAM blocks.
// Stream: 1-byte order, u32le compressed size (table+stream), u32le raw
// size, frequency table, interleaved 4-state rANS payload.
// ---------------------------------------------------------------------------

static const uint32_t RANS_L = 1u << 23;
static const int TF_SHIFT = 12;
static const uint32_t TOTFREQ = 1u << TF_SHIFT;

// normalize counts to sum exactly TOTFREQ keeping observed symbols >= 1;
// must match cram_codecs._normalize_freqs (first-max drift fixing)
static int rans_normalize(const uint64_t* counts, uint32_t* freqs) {
    uint64_t total = 0;
    for (int i = 0; i < 256; i++) total += counts[i];
    for (int i = 0; i < 256; i++) freqs[i] = 0;
    if (total == 0) return 0;
    int64_t acc = 0;
    for (int i = 0; i < 256; i++) {
        if (!counts[i]) continue;
        uint64_t f = (counts[i] * TOTFREQ) / total;
        if (f < 1) f = 1;
        freqs[i] = (uint32_t)f;
        acc += (int64_t)f;
    }
    int imax = -1;
    uint32_t fmax = 0;
    for (int i = 0; i < 256; i++)
        if (counts[i] && freqs[i] > fmax) { fmax = freqs[i]; imax = i; }
    int64_t nf = (int64_t)freqs[imax] + ((int64_t)TOTFREQ - acc);
    if (nf >= 1) {
        freqs[imax] = (uint32_t)nf;
    } else {
        int64_t deficit = 1 - nf;
        freqs[imax] = 1;
        for (int i = 0; i < 256 && deficit > 0; i++) {
            if (!counts[i] || freqs[i] <= 1) continue;
            int64_t take = (int64_t)freqs[i] - 1;
            if (take > deficit) take = deficit;
            freqs[i] -= (uint32_t)take;
            deficit -= take;
        }
        if (deficit > 0) return -1;
    }
    return 1;
}

static int64_t rans_write_table(const uint32_t* freqs, uint8_t* out) {
    int64_t n = 0;
    int rle = 0;
    for (int j = 0; j < 256; j++) {
        if (!freqs[j]) continue;
        if (rle) {
            rle--;
        } else {
            out[n++] = (uint8_t)j;
            if (j && freqs[j - 1]) {
                int k = j + 1;
                while (k < 256 && freqs[k]) k++;
                rle = k - (j + 1);
                out[n++] = (uint8_t)rle;
            }
        }
        uint32_t f = freqs[j];
        if (f < 128) {
            out[n++] = (uint8_t)f;
        } else {
            out[n++] = (uint8_t)(0x80 | (f >> 8));
            out[n++] = (uint8_t)(f & 0xFF);
        }
    }
    out[n++] = 0;
    return n;
}

static int64_t rans_read_table(const uint8_t* in, int64_t in_size,
                               uint32_t* freqs, uint32_t* cum) {
    for (int i = 0; i < 256; i++) freqs[i] = 0;
    int64_t off = 0;
    if (off >= in_size) return -1;
    int rle = 0;
    int j = in[off++];
    for (;;) {
        if (off >= in_size) return -1;
        uint32_t f = in[off++];
        if (f >= 128) {
            if (off >= in_size) return -1;
            f = ((f & 0x7F) << 8) | in[off++];
        }
        freqs[j] = f;
        if (!rle && off < in_size && in[off] == j + 1) {
            j = in[off++];
            if (off >= in_size) return -1;
            rle = in[off++];
        } else if (rle) {
            rle--;
            j++;
        } else {
            if (off >= in_size) return -1;
            j = in[off++];
            if (j == 0) break;
        }
        if (j > 255) return -1;
    }
    uint32_t x = 0;
    for (int s = 0; s < 256; s++) { cum[s] = x; x += freqs[s]; }
    // bounds contract for the symbol-LUT fill: frequencies must sum to
    // exactly TOTFREQ (the normalization target); anything else is a
    // corrupt or malicious table and would index past the 4096-slot LUT
    if (x != TOTFREQ) return -1;
    return off;
}

static inline void rans_enc_put(uint64_t* x, uint8_t** rptr,
                                uint32_t start, uint32_t freq) {
    uint64_t xv = *x;
    uint64_t x_max = ((uint64_t)(RANS_L >> TF_SHIFT) << 8) * freq;
    while (xv >= x_max) {
        *--(*rptr) = (uint8_t)(xv & 0xFF);
        xv >>= 8;
    }
    *x = ((xv / freq) << TF_SHIFT) + (xv % freq) + start;
}

static inline void rans_enc_flush(uint64_t* x, uint8_t** rptr) {
    uint8_t* p = *rptr - 4;
    p[0] = (uint8_t)(*x & 0xFF);
    p[1] = (uint8_t)((*x >> 8) & 0xFF);
    p[2] = (uint8_t)((*x >> 16) & 0xFF);
    p[3] = (uint8_t)((*x >> 24) & 0xFF);
    *rptr = p;
}

// Compress in[0..in_size) with the given order (0/1); writes the full
// stream (including the 9-byte header) to out; returns total size or -1.
int64_t bamcore_rans_compress(const uint8_t* in, int64_t in_size, int order,
                              uint8_t* out, int64_t out_cap) {
    if (order == 1 && in_size < 4) order = 0;
    if (out_cap < 9 + 2 * in_size + (order ? 257 * 771 : 771) + 64) return -1;
    uint8_t* body = out + 9;
    int64_t table_len = 0;
    // payload scratch: emit backwards into the tail of `out`
    uint8_t* tail_end = out + out_cap;
    uint8_t* rptr = tail_end;
    uint64_t st[4] = {RANS_L, RANS_L, RANS_L, RANS_L};

    if (order == 0) {
        static thread_local uint64_t counts[256];
        static thread_local uint32_t freqs[256], cum[256];
        memset(counts, 0, sizeof(counts));
        for (int64_t i = 0; i < in_size; i++) counts[in[i]]++;
        if (rans_normalize(counts, freqs) < 0) return -1;
        uint32_t x = 0;
        for (int s = 0; s < 256; s++) { cum[s] = x; x += freqs[s]; }
        table_len = rans_write_table(freqs, body);
        if (in_size > 0) {
            int64_t i = in_size & 3;
            if (i >= 3) { uint8_t s = in[in_size - (i - 2)]; rans_enc_put(&st[2], &rptr, cum[s], freqs[s]); }
            if (i >= 2) { uint8_t s = in[in_size - (i - 1)]; rans_enc_put(&st[1], &rptr, cum[s], freqs[s]); }
            if (i >= 1) { uint8_t s = in[in_size - i]; rans_enc_put(&st[0], &rptr, cum[s], freqs[s]); }
            for (i = in_size & ~3LL; i > 0; i -= 4) {
                for (int k = 3; k >= 0; k--) {
                    uint8_t s = in[i - 4 + k];
                    rans_enc_put(&st[k], &rptr, cum[s], freqs[s]);
                }
            }
            for (int k = 3; k >= 0; k--) rans_enc_flush(&st[k], &rptr);
        }
    } else {
        // order-1: lazy per-context rows (DNA data touches few contexts)
        static thread_local std::vector<uint64_t> counts1;
        static thread_local std::vector<uint32_t> freqs1, cum1;
        if (counts1.size() < 256 * 256) {
            counts1.resize(256 * 256);
            freqs1.resize(256 * 256);
            cum1.resize(256 * 256);
        }
        static thread_local uint64_t totals[256];
        memset(totals, 0, sizeof(totals));
        int64_t isz4 = in_size >> 2;
        // mark+clear used contexts only
        bool used[256] = {false};
        auto bump = [&](uint8_t ctx, uint8_t sym) {
            if (!used[ctx]) {
                used[ctx] = true;
                memset(&counts1[(size_t)ctx << 8], 0, 256 * sizeof(uint64_t));
            }
            counts1[((size_t)ctx << 8) | sym]++;
            totals[ctx]++;
        };
        for (int q = 0; q < 4; q++) bump(0, in[q * isz4]);
        for (int64_t i = 1; i < in_size; i++) bump(in[i - 1], in[i]);

        // serialize outer-RLE table and normalize per context
        int64_t n = 0;
        int rle_i = 0;
        for (int i = 0; i < 256; i++) {
            if (!totals[i]) continue;
            if (rle_i) {
                rle_i--;
            } else {
                body[n++] = (uint8_t)i;
                if (i && totals[i - 1]) {
                    int k = i + 1;
                    while (k < 256 && totals[k]) k++;
                    rle_i = k - (i + 1);
                    body[n++] = (uint8_t)rle_i;
                }
            }
            if (rans_normalize(&counts1[(size_t)i << 8], &freqs1[(size_t)i << 8]) < 0)
                return -1;
            uint32_t x = 0;
            for (int s = 0; s < 256; s++) {
                cum1[((size_t)i << 8) | s] = x;
                x += freqs1[((size_t)i << 8) | s];
            }
            n += rans_write_table(&freqs1[(size_t)i << 8], body + n);
        }
        body[n++] = 0;
        table_len = n;

        int64_t i3 = in_size - 2;
        uint8_t l3 = in[in_size - 1];
        while (i3 > 4 * isz4 - 2) {
            uint8_t ctx = in[i3];
            rans_enc_put(&st[3], &rptr, cum1[((size_t)ctx << 8) | l3],
                         freqs1[((size_t)ctx << 8) | l3]);
            l3 = ctx;
            i3--;
        }
        int64_t idx[4] = {1 * isz4 - 2, 2 * isz4 - 2, 3 * isz4 - 2, i3};
        uint8_t last[4];
        for (int k = 0; k < 4; k++) last[k] = in[idx[k] + 1];
        while (idx[0] >= 0) {
            for (int k = 3; k >= 0; k--) {
                uint8_t ctx = in[idx[k]];
                rans_enc_put(&st[k], &rptr, cum1[((size_t)ctx << 8) | last[k]],
                             freqs1[((size_t)ctx << 8) | last[k]]);
                last[k] = ctx;
                idx[k]--;
            }
        }
        for (int k = 3; k >= 0; k--)
            rans_enc_put(&st[k], &rptr, cum1[last[k]], freqs1[last[k]]);
        for (int k = 3; k >= 0; k--) rans_enc_flush(&st[k], &rptr);
    }

    int64_t payload_len = tail_end - rptr;
    if (body + table_len + payload_len > tail_end) return -1;  // overlap
    memmove(body + table_len, rptr, payload_len);
    int64_t comp_size = table_len + payload_len;
    out[0] = (uint8_t)order;
    uint32_t cs = (uint32_t)comp_size, rs = (uint32_t)in_size;
    memcpy(out + 1, &cs, 4);
    memcpy(out + 5, &rs, 4);
    return 9 + comp_size;
}

// Decompress a full stream (with 9-byte header); returns raw size or -1.
int64_t bamcore_rans_uncompress(const uint8_t* in, int64_t in_size,
                                uint8_t* out, int64_t out_cap) {
    if (in_size < 9) return -1;
    int order = in[0];
    uint32_t raw_size;
    memcpy(&raw_size, in + 5, 4);
    if ((int64_t)raw_size > out_cap) return -1;
    if (raw_size == 0) return 0;
    const uint8_t* p = in + 9;
    int64_t avail = in_size - 9;

    if (order == 0) {
        static thread_local uint32_t freqs[256], cum[256];
        static thread_local uint8_t ssym[TOTFREQ];
        int64_t off = rans_read_table(p, avail, freqs, cum);
        if (off < 0) return -1;
        for (int s = 0; s < 256; s++)
            for (uint32_t k = cum[s]; k < cum[s] + freqs[s]; k++) ssym[k] = (uint8_t)s;
        if (avail - off < 16) return -1;
        uint32_t x[4];
        memcpy(x, p + off, 16);
        const uint8_t* ptr = p + off + 16;
        const uint8_t* pend = p + avail;
        int64_t main_n = raw_size & ~3u;
        int64_t i = 0;
        while (i < main_n) {
            for (int k = 0; k < 4; k++) {
                uint32_t m = x[k] & (TOTFREQ - 1);
                uint8_t s = ssym[m];
                out[i + k] = s;
                x[k] = freqs[s] * (x[k] >> TF_SHIFT) + m - cum[s];
                while (x[k] < RANS_L && ptr < pend) x[k] = (x[k] << 8) | *ptr++;
            }
            i += 4;
        }
        for (int k = 0; i < (int64_t)raw_size; i++, k++) {
            uint32_t m = x[k] & (TOTFREQ - 1);
            uint8_t s = ssym[m];
            out[i] = s;
            x[k] = freqs[s] * (x[k] >> TF_SHIFT) + m - cum[s];
            while (x[k] < RANS_L && ptr < pend) x[k] = (x[k] << 8) | *ptr++;
        }
        return raw_size;
    }

    if (order != 1) return -1;
    static thread_local std::vector<uint32_t> freqs1, cum1;
    static thread_local std::vector<uint8_t> ssym1;
    if (freqs1.size() < 256 * 256) {
        freqs1.resize(256 * 256);
        cum1.resize(256 * 256);
        ssym1.resize((size_t)256 * TOTFREQ);
    }
    int64_t off = 0;
    int rle_i = 0;
    if (avail < 1) return -1;
    int i = p[off++];
    for (;;) {
        int64_t used = rans_read_table(p + off, avail - off,
                                       &freqs1[(size_t)i << 8], &cum1[(size_t)i << 8]);
        if (used < 0) return -1;
        off += used;
        uint8_t* lut = &ssym1[(size_t)i * TOTFREQ];
        const uint32_t* f = &freqs1[(size_t)i << 8];
        const uint32_t* c = &cum1[(size_t)i << 8];
        for (int s = 0; s < 256; s++)
            for (uint32_t k = c[s]; k < c[s] + f[s]; k++) lut[k] = (uint8_t)s;
        if (!rle_i && off < avail && p[off] == i + 1) {
            i = p[off++];
            if (off >= avail) return -1;
            rle_i = p[off++];
        } else if (rle_i) {
            rle_i--;
            i++;
        } else {
            if (off >= avail) return -1;
            i = p[off++];
            if (i == 0) break;
        }
        if (i > 255) return -1;
    }
    if (avail - off < 16) return -1;
    uint32_t x[4];
    memcpy(x, p + off, 16);
    const uint8_t* ptr = p + off + 16;
    const uint8_t* pend = p + avail;
    int64_t isz4 = (int64_t)raw_size >> 2;
    int64_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
    uint8_t last[4] = {0, 0, 0, 0};
    for (int64_t t = 0; t < isz4; t++) {
        for (int k = 0; k < 4; k++) {
            uint32_t m = x[k] & (TOTFREQ - 1);
            uint8_t lk = last[k];
            uint8_t s = ssym1[(size_t)lk * TOTFREQ + m];
            out[pos[k]++] = s;
            x[k] = freqs1[((size_t)lk << 8) | s] * (x[k] >> TF_SHIFT) + m
                 - cum1[((size_t)lk << 8) | s];
            while (x[k] < RANS_L && ptr < pend) x[k] = (x[k] << 8) | *ptr++;
            last[k] = s;
        }
    }
    while (pos[3] < (int64_t)raw_size) {
        uint32_t m = x[3] & (TOTFREQ - 1);
        uint8_t lk = last[3];
        uint8_t s = ssym1[(size_t)lk * TOTFREQ + m];
        out[pos[3]++] = s;
        x[3] = freqs1[((size_t)lk << 8) | s] * (x[3] >> TF_SHIFT) + m
             - cum1[((size_t)lk << 8) | s];
        while (x[3] < RANS_L && ptr < pend) x[3] = (x[3] << 8) | *ptr++;
        last[3] = s;
    }
    return raw_size;
}

// Bulk ITF8 varint tokenizer (CRAM 3.x; spec section 2.3). Parses the
// whole buffer front-to-back, writing decoded int32 values and the end
// byte offset of each token. Returns the token count; a truncated tail
// (fewer bytes than the prefix demands) stops the parse and is left to
// the caller. Semantics mirror cram_codecs.itf8_decode.
int64_t bamcore_itf8_bulk(const uint8_t* buf, int64_t len,
                          int32_t* vals, int32_t* ends, int64_t cap) {
    int64_t off = 0, n = 0;
    while (off < len && n < cap) {
        uint8_t b0 = buf[off];
        uint32_t v;
        int64_t need;
        if (b0 < 0x80) {
            need = 1;
            v = b0;
        } else if (b0 < 0xC0) {
            need = 2;
            if (off + need > len) break;
            v = ((uint32_t)(b0 & 0x7F) << 8) | buf[off + 1];
        } else if (b0 < 0xE0) {
            need = 3;
            if (off + need > len) break;
            v = ((uint32_t)(b0 & 0x3F) << 16) | ((uint32_t)buf[off + 1] << 8)
              | buf[off + 2];
        } else if (b0 < 0xF0) {
            need = 4;
            if (off + need > len) break;
            v = ((uint32_t)(b0 & 0x1F) << 24) | ((uint32_t)buf[off + 1] << 16)
              | ((uint32_t)buf[off + 2] << 8) | buf[off + 3];
        } else {
            need = 5;
            if (off + need > len) break;
            v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)buf[off + 1] << 20)
              | ((uint32_t)buf[off + 2] << 12) | ((uint32_t)buf[off + 3] << 4)
              | (buf[off + 4] & 0x0F);
        }
        off += need;
        vals[n] = (int32_t)v;
        ends[n] = (int32_t)off;
        n++;
    }
    return n;
}

// ---------------------------------------------------------------------------
// INS consensus: k-mer-anchor pseudo-alignment + per-column majority vote
// (reference: consensus.py:280-394 novel_from_reads; constants :286-292).
// Exact-native port of sniffles_tpu_torch/consensus.py::novel_from_reads_spec —
// the per-lead anchor-chain walk, the per-segment identity filter and the
// column vote are sequential scalar scans, which is why this lives here
// rather than in numpy (per-op dispatch overhead dominates at the typical
// 10-lead x few-kb cluster size).
// ---------------------------------------------------------------------------

// Consensus for one INS cluster. `best` is the anchor read's insertion
// sequence (lb bytes); `others` holds the remaining leads' sequences
// concatenated, delimited by off[0..n_leads] (off[n_leads] = total).
// klen <= 8 (kmers are compared as base-256 packed uint64). Writes the
// lb-byte consensus into `out`. Returns 0 on success.
int bamcore_consensus_novel(const uint8_t* best, int64_t lb,
                            const uint8_t* others, const int64_t* off,
                            int32_t n_leads,
                            int32_t klen, int32_t skip, int32_t skip_rep,
                            uint8_t* out) {
    const uint8_t DASH = '-';
    // reference constants (consensus.py:286-292)
    const int consensus_min = 2;
    const int64_t maxshift = klen;
    const double minspan = 0.2, minalns = 0.25, minident = 0.5;
    const int64_t minident_abs = 5;
    const int64_t minbestdiff = 3;

    if (lb <= 0) return 0;
    std::memcpy(out, best, (size_t)lb);  // fallback: the anchor read itself
    if (n_leads <= 0) return 0;
    if (klen <= 0 || klen > 8 || skip < 1 || skip_rep < 1) return -1;

    // anchor map: sampled best-read kmers that occur exactly once in the
    // sample (the reference deletes+taboos on a repeat; net effect is
    // count==1). Open-addressing hash, val: -1 empty / -2 taboo / else pos.
    int64_t n_k = 0;
    for (int64_t i = 0; i < lb - klen; i += skip_rep) n_k++;
    uint64_t tab_size = 16;
    while (tab_size < (uint64_t)(n_k * 2 + 1)) tab_size <<= 1;
    std::vector<uint64_t> tab_key(tab_size);
    std::vector<int64_t> tab_val(tab_size, -1);
    const uint64_t tab_mask = tab_size - 1;

    auto pack = [klen](const uint8_t* p) -> uint64_t {
        uint64_t v = 0;
        for (int32_t k = 0; k < klen; ++k) v = (v << 8) | p[k];
        return v;
    };
    auto slot_of = [&](uint64_t code) -> uint64_t {
        uint64_t s = (code * 0x9E3779B97F4A7C15ULL) & tab_mask;
        while (tab_val[s] != -1 && tab_key[s] != code) s = (s + 1) & tab_mask;
        return s;
    };
    for (int64_t i = 0; i < lb - klen; i += skip_rep) {
        uint64_t code = pack(best + i);
        uint64_t s = slot_of(code);
        if (tab_val[s] == -1) {
            tab_key[s] = code;
            tab_val[s] = i;
        } else if (tab_val[s] >= 0) {
            tab_val[s] = -2;  // repeated kmer: taboo
        }
    }

    std::vector<uint8_t> rowbuf((size_t)n_leads * (size_t)lb);
    std::vector<const uint8_t*> rows;
    rows.reserve(n_leads);

    for (int32_t l = 0; l < n_leads; ++l) {
        const uint8_t* ls = others + off[l];
        const int64_t ll = off[l + 1] - off[l];
        uint8_t* row = rowbuf.data() + (size_t)l * (size_t)lb;
        std::memset(row, DASH, (size_t)lb);
        int64_t last_i = -1, last_j = -1, clen = 0, span = 0;
        for (int64_t j = 0; j < ll - klen; j += skip) {
            uint64_t code = pack(ls + j);
            uint64_t s = slot_of(code);
            int64_t i = tab_val[s];
            if (i < 0) continue;                       // absent or taboo
            int64_t d = i - j;
            if ((d < 0 ? -d : d) > maxshift) continue;
            if (last_i >= 0 && i <= last_i) continue;
            if (last_i < 0) {
                if (j > 0) clen = i;                   // leading gap "-"*i
            } else {
                const int64_t t = j - last_j;          // unclamped fwd_j
                int64_t fwd_j = t;
                if (clen + fwd_j > lb) fwd_j = lb - clen;
                if (i - last_i == fwd_j && fwd_j > 0) {
                    span += t;
                    // identity over lead[last_j+1:j+1] vs the same-length
                    // best slice starting at last_i+1 (reference
                    // consensus.py:341-344), bounds-clamped like the
                    // vectorized diagonal prefix sums
                    int64_t tt = t;
                    if (last_i + 1 + tt > lb) tt = lb - (last_i + 1);
                    if (last_j + 1 + tt > ll) tt = ll - (last_j + 1);
                    int64_t m = 0;
                    const uint8_t* pa = ls + last_j + 1;
                    const uint8_t* pb = best + last_i + 1;
                    for (int64_t k = 0; k < tt; ++k) m += (pa[k] == pb[k]);
                    if ((double)m / (double)t >= minident)
                        std::memcpy(row + clen, ls + last_j, (size_t)fwd_j);
                    clen += fwd_j;
                } else {
                    clen += fwd_j;                     // gap: row is dash
                }
            }
            last_i = i;
            last_j = j;
        }
        if ((double)span / (double)lb <= minspan) continue;  // dropped

        // segment identity filter (reference: consensus.py:360-375)
        int64_t sg = 0;
        while (sg < lb) {
            if (row[sg] == DASH) { sg++; continue; }
            int64_t e = sg, ident = 0;
            while (e < lb && row[e] != DASH) {
                ident += (row[e] == best[e]);
                e++;
            }
            if (!((double)ident / (double)(e - sg) > minident
                  && ident > minident_abs))
                std::memset(row + sg, DASH, (size_t)(e - sg));
            sg = e;
        }
        rows.push_back(row);
    }

    const int64_t n_aln = (int64_t)rows.size();
    if (n_aln == 0) return 0;  // out already holds best
    const double maxal = (double)(n_aln + 1);

    // per-column vote (reference: consensus.py:377-394): dash-excluded
    // symbol counts incl. the anchor base (+1); argmax ties break to the
    // smallest ASCII symbol (np.argmax over ascending-sorted syms)
    int32_t cnt[256];
    std::memset(cnt, 0, sizeof(cnt));
    uint8_t seen[256];
    for (int64_t c = 0; c < lb; ++c) {
        int ns = 0;
        int64_t al = 0;
        for (int64_t r = 0; r < n_aln; ++r) {
            uint8_t ch = rows[r][c];
            if (ch == DASH) continue;
            al++;
            if (cnt[ch]++ == 0) seen[ns++] = ch;
        }
        uint8_t bc = best[c];
        if (cnt[bc]++ == 0) seen[ns++] = bc;
        int64_t top1 = 0, top2 = 0;
        for (int k = 0; k < ns; ++k) {
            int64_t v = cnt[seen[k]];
            if (v > top1) { top2 = top1; top1 = v; }
            else if (v > top2) top2 = v;
        }
        // smallest ASCII symbol holding the max count (np.argmax tie rule)
        uint8_t top_sym = 255;
        for (int k = 0; k < ns; ++k) {
            uint8_t chs = seen[k];
            if (cnt[chs] == top1 && chs < top_sym) top_sym = chs;
        }
        bool use_vote = (al >= consensus_min)
                        && ((double)al / maxal >= minalns)
                        && (top1 - top2 >= minbestdiff);
        out[c] = use_vote ? top_sym : bc;
        for (int k = 0; k < ns; ++k) cnt[seen[k]] = 0;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Split-read chain parsing + classification.
//
// Native equivalent of the per-read Python around SA tags (the largest
// remaining per-read host cost after the columnar record scan): the SA
// chain walk and query-order sort (reference: leadprov.py:227-265), the
// adjacent-pair geometry classification (reference: sv.py:649-782) and
// the BND mate extraction (reference: leadprov.py:57-132). Emits flat
// hint/BND columns; Python materializes Lead objects from them
// (sniffles_tpu_torch/leads.py _iter_region_native). Any parse anomaly sets a
// per-read error flag and Python re-runs its exact fallback for that
// read, reproducing the reference's error messages.
// ---------------------------------------------------------------------------

namespace {

// CIGAR-string analysis for SA entries; replicates leads.CIGAR_analyze
// (reference: leadprov.py:144-176) including its quirks: trailing bare
// digits are silently accepted, any non-[A-Z=] op or malformed structure
// is an error, and the leading clip is the clip total seen before the
// first clip op that FOLLOWS aligned ops.
static int sa_cigar_analyze(const uint8_t* s, int64_t n, int64_t* lead_clip,
                            int64_t* trail_clip, int64_t* refspan,
                            int64_t* readspan) {
    int64_t rs = 0, qs = 0, clip_total = 0, leading = -1;
    int64_t i = 0;
    while (i < n) {
        if (!(s[i] >= '0' && s[i] <= '9')) return -1;
        int64_t v = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') { v = v * 10 + (s[i] - '0'); i++; }
        if (i >= n) break;  // trailing digits without an op: accepted
        char op = (char)s[i];
        i++;
        switch (op) {
            case 'M': case '=': case 'X': qs += v; rs += v; break;
            case 'I': qs += v; break;
            case 'D': case 'N': rs += v; break;
            case 'S': case 'H':
                if (leading < 0 && qs + rs > 0) leading = clip_total;
                clip_total += v;
                break;
            default: return -1;  // unknown (incl. lowercase / P)
        }
    }
    if (leading < 0) leading = clip_total;
    *lead_clip = leading;
    *trail_clip = clip_total - leading;
    *refspan = rs;
    *readspan = qs;
    return 0;
}

struct SplitRecInfo {
    int32_t pos = 0, flag = 0, mapq = 0, l_seq = 0;
    int32_t ref_len = 0, qstart = 0, qalen = 0, qlen = 0;  // qlen incl. soft clips
    int32_t first_op = -1, first_len = 0, last_op = -1, last_len = 0;
    int32_t nm = -1;
    int64_t sa_off = -1;
    int32_t sa_len = 0;
};

// Re-parse one record body for the split path (geometry + SA/NM tags).
// `off` is the record BODY offset (after block_size), `blen` the body
// length — exactly what bamcore_scan_records published per record.
static int split_parse_rec(const uint8_t* data, int64_t off, int32_t blen,
                           SplitRecInfo* ri) {
    const uint8_t* r = data + off;
    std::memcpy(&ri->pos, r + 4, 4);
    uint8_t l_read_name = r[8];
    ri->mapq = r[9];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, r + 12, 2);
    std::memcpy(&flag, r + 14, 2);
    ri->flag = flag;
    std::memcpy(&ri->l_seq, r + 16, 4);

    const uint8_t* cig = r + 32 + l_read_name;
    int32_t ref_len = 0, qstart = 0, qalen = 0, qlen = 0;
    bool seen_aligned = false;
    for (uint32_t ci = 0; ci < n_cigar; ci++) {
        uint32_t cv;
        std::memcpy(&cv, cig + 4ll * ci, 4);
        uint32_t op = cv & 0xF;
        int32_t oplen = (int32_t)(cv >> 4);
        if (op > 8) continue;
        if (ci == 0) { ri->first_op = (int32_t)op; ri->first_len = oplen; }
        ri->last_op = (int32_t)op;
        ri->last_len = oplen;
        ref_len += CONSUME_REF[op] * oplen;
        qlen += CONSUME_READ[op] * oplen;
        if (op == OP_M || op == OP_I || op == OP_EQ || op == OP_X) {
            qalen += oplen;
            seen_aligned = true;
        } else if (op == OP_S && !seen_aligned) {
            qstart += oplen;
        }
    }
    ri->ref_len = ref_len;
    ri->qstart = qstart;
    ri->qalen = qalen;
    ri->qlen = qlen;

    int64_t seq_bytes = ((int64_t)ri->l_seq + 1) / 2;
    const uint8_t* tags = cig + 4ll * n_cigar + seq_bytes + ri->l_seq;
    const uint8_t* rec_end = r + blen;
    const uint8_t* t = tags;
    while (t + 3 <= rec_end) {
        char t0 = (char)t[0], t1 = (char)t[1], typ = (char)t[2];
        const uint8_t* v = t + 3;
        int64_t vlen = 0, ival = 0;
        bool is_int = false;
        switch (typ) {
            case 'A': vlen = 1; break;
            case 'c': { int8_t x; std::memcpy(&x, v, 1); ival = x; is_int = true; vlen = 1; break; }
            case 'C': { uint8_t x = *v; ival = x; is_int = true; vlen = 1; break; }
            case 's': { int16_t x; std::memcpy(&x, v, 2); ival = x; is_int = true; vlen = 2; break; }
            case 'S': { uint16_t x; std::memcpy(&x, v, 2); ival = x; is_int = true; vlen = 2; break; }
            case 'i': { int32_t x; std::memcpy(&x, v, 4); ival = x; is_int = true; vlen = 4; break; }
            case 'I': { uint32_t x; std::memcpy(&x, v, 4); ival = (int64_t)x; is_int = true; vlen = 4; break; }
            case 'f': vlen = 4; break;
            case 'Z': case 'H': {
                const uint8_t* z = v;
                while (z < rec_end && *z != 0) z++;
                vlen = (z - v) + 1;
                break;
            }
            case 'B': {
                char sub = (char)v[0];
                uint32_t cnt;
                std::memcpy(&cnt, v + 1, 4);
                int esz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
                vlen = 5 + (int64_t)cnt * esz;
                break;
            }
            default:
                vlen = rec_end - v;
        }
        if (t0 == 'N' && t1 == 'M' && is_int) ri->nm = (int32_t)ival;
        else if (t0 == 'S' && t1 == 'A' && typ == 'Z') {
            ri->sa_off = (v - data);
            ri->sa_len = (int32_t)(vlen - 1);
        }
        t = v + vlen;
    }
    return 0;
}

struct SaEntry {
    int64_t ctg_off;
    int32_t ctg_len;
    int64_t pos;        // 1-based from the tag
    int8_t strand;      // +1 / -1
    int64_t cig_off;
    int32_t cig_len;
    int64_t mapq;
    int64_t nm;
};

static int split_atoi(const uint8_t* s, int32_t n, int64_t* out) {
    if (n <= 0) return -1;
    int64_t v = 0, i = 0, sign = 1;
    if (s[0] == '-') { sign = -1; i = 1; if (n == 1) return -1; }
    for (; i < n; i++) {
        if (s[i] < '0' || s[i] > '9') return -1;
        v = v * 10 + (s[i] - '0');
    }
    *out = sign * v;
    return 0;
}

// Parse the SA tag string into entries; returns count, or -1 on a
// malformed entry (wrong field count / non-numeric pos/mapq — the
// Python path would raise there, so the caller falls back to it).
static int64_t parse_sa_entries(const uint8_t* data, int64_t sa_off,
                                int32_t sa_len, std::vector<SaEntry>* out) {
    const uint8_t* s = data + sa_off;
    int64_t i = 0;
    while (i < sa_len) {
        int64_t e = i;
        while (e < sa_len && s[e] != ';') e++;
        if (e > i) {  // non-empty entry
            // six comma-separated fields
            int64_t f_start[6], f_len[6];
            int nf = 0;
            int64_t fs = i;
            for (int64_t j = i; j <= e; j++) {
                if (j == e || s[j] == ',') {
                    if (nf >= 6) { nf = 7; break; }
                    f_start[nf] = fs;
                    f_len[nf] = j - fs;
                    nf++;
                    fs = j + 1;
                }
            }
            if (nf != 6) return -1;
            SaEntry ent;
            ent.ctg_off = sa_off + f_start[0];
            ent.ctg_len = (int32_t)f_len[0];
            if (split_atoi(s + f_start[1], (int32_t)f_len[1], &ent.pos) != 0) return -1;
            ent.strand = (f_len[2] == 1 && s[f_start[2]] == '-') ? -1 : 1;
            ent.cig_off = sa_off + f_start[3];
            ent.cig_len = (int32_t)f_len[3];
            if (split_atoi(s + f_start[4], (int32_t)f_len[4], &ent.mapq) != 0) return -1;
            if (split_atoi(s + f_start[5], (int32_t)f_len[5], &ent.nm) != 0) ent.nm = 0;
            out->push_back(ent);
        }
        i = e + 1;
    }
    return (int64_t)out->size();
}

struct ChainAln {
    int64_t ctg_off;    // -1: the region contig (primary alignment)
    int32_t ctg_len;
    int32_t ref_start, ref_end, qry_start, qry_end, mapq;
    int8_t strand;      // +1 / -1
    int8_t is_prim;
};

struct ChainHint {
    int32_t type = -1;  // 0 INS, 1 DEL, 2 DUP, 3 INV, 4 INS-with-None-svlen
    int32_t start = 0;
    int32_t svlen = 0;
    int32_t seq_a = -1, seq_b = -1;
};

static bool same_contig(const uint8_t* data, const char* region_contig,
                        int64_t region_contig_len,
                        const ChainAln& a, const ChainAln& b) {
    const uint8_t* pa = (a.ctg_off < 0) ? (const uint8_t*)region_contig : data + a.ctg_off;
    int64_t la = (a.ctg_off < 0) ? region_contig_len : a.ctg_len;
    const uint8_t* pb = (b.ctg_off < 0) ? (const uint8_t*)region_contig : data + b.ctg_off;
    int64_t lb = (b.ctg_off < 0) ? region_contig_len : b.ctg_len;
    return la == lb && std::memcmp(pa, pb, (size_t)la) == 0;
}

// Adjacent-pair classification (reference: sv.py:665-755). Writes the
// hint for `curr`; returns true when one was produced.
static bool classify_pair(const ChainAln& last, const ChainAln& curr,
                          int32_t minlen, int32_t seq_cap, bool same_strand,
                          ChainHint* h) {
    if (same_strand) {
        const bool forward = curr.strand != -1;
        const int64_t qry_gap = (int64_t)curr.qry_start - last.qry_end;
        const int64_t ref_gap = forward ? ((int64_t)curr.ref_start - last.ref_end)
                                        : ((int64_t)last.ref_start - curr.ref_end);
        const int64_t anchor = forward ? curr.ref_start : last.ref_start;
        if (qry_gap >= minlen && qry_gap - ref_gap >= minlen) {
            h->type = 0;
            h->start = (int32_t)anchor;
            h->svlen = (int32_t)qry_gap;
            if (qry_gap <= seq_cap) { h->seq_a = last.qry_end; h->seq_b = curr.qry_start; }
            return true;
        }
        if (ref_gap >= minlen && ref_gap - qry_gap >= minlen) {
            h->type = 1;
            h->start = (int32_t)anchor;
            h->svlen = (int32_t)(-ref_gap);
            return true;
        }
        if (forward && curr.ref_start <= last.ref_end) {
            const int64_t span = (int64_t)last.ref_end - curr.ref_start;
            if (span >= minlen) {
                h->type = 2;
                h->start = curr.ref_start;
                h->svlen = (int32_t)span;
                return true;
            }
        } else if (!forward && last.ref_start <= curr.ref_end) {
            const int64_t span = (int64_t)curr.ref_end - last.ref_start;
            if (span >= minlen) {
                h->type = 2;
                h->start = last.ref_start;
                h->svlen = (int32_t)span;
                return true;
            }
        }
        return false;
    }
    // strand flip -> INV (reference: sv.py:723-755)
    int64_t a, b;
    if (curr.strand != -1) { a = curr.ref_start; b = last.ref_start; }
    else { a = curr.ref_end; b = last.ref_end; }
    const int64_t span = (a > b) ? (a - b) : (b - a);
    if (span >= minlen) {
        h->type = 3;
        h->start = (int32_t)((a < b) ? a : b);
        h->svlen = (int32_t)span;
        return true;
    }
    return false;
}

// classify_splits on one chain (reference: sv.py:649-782): sort by query
// start, head long-INS hint, pair hints, and the short-pseudo-BND
// refilter retry. Fills `hints` positionally for the FINAL chain and
// returns its length (the chain vector is reordered/filtered in place).
static int64_t classify_chain(std::vector<ChainAln>* chain,
                              std::vector<ChainHint>* hints,
                              const uint8_t* data, const char* region_contig,
                              int64_t region_contig_len,
                              int32_t minlen, double long_ins_half,
                              int32_t seq_cap) {
    for (int attempt = 0; attempt < 2; attempt++) {
        std::stable_sort(chain->begin(), chain->end(),
                         [](const ChainAln& x, const ChainAln& y) {
                             return x.qry_start < y.qry_start;
                         });
        const int64_t n = (int64_t)chain->size();
        hints->assign((size_t)n, ChainHint());
        if ((double)(*chain)[0].qry_start >= long_ins_half) {
            (*hints)[0].type = 4;  // INS with svlen None
            (*hints)[0].start = (*chain)[0].ref_start;
        }
        int64_t pair_hints = 0;
        for (int64_t k = 1; k < n; k++) {
            const ChainAln& last = (*chain)[k - 1];
            const ChainAln& curr = (*chain)[k];
            if (!same_contig(data, region_contig, region_contig_len, last, curr))
                continue;
            if (classify_pair(last, curr, minlen, seq_cap,
                              curr.strand == last.strand, &(*hints)[k]))
                pair_hints++;
        }
        if (attempt == 0 && pair_hints == 0 && n > 2) {
            // filter out short pseudo BND hints (sv.py:731-737): keep the
            // first alignment's contig+strand; retry only when exactly 2
            // alignments remain
            const ChainAln anchor = (*chain)[0];
            std::vector<ChainAln> filtered;
            for (const ChainAln& c : *chain)
                if (c.strand == anchor.strand
                    && same_contig(data, region_contig, region_contig_len, c, anchor))
                    filtered.push_back(c);
            if (filtered.size() == 2) {
                *chain = filtered;
                continue;
            }
        }
        return n;
    }
    return (int64_t)chain->size();  // unreachable
}

}  // namespace

extern "C" {

struct SplitCols {
    // per input read (n_reads rows)
    int32_t* bnd_ok;            // 0 no BND, 1 ok, -1 error -> python fallback
    int32_t* split_err;         // 1 -> python fallback for the split chain
    int32_t* bnd_anchor;
    int32_t* bnd_is_first;
    int32_t* bnd_mate_is_reverse;
    int32_t* bnd_same_strand;
    int64_t* bnd_mate_off;      // SA contig name bytes in `data`
    int32_t* bnd_mate_len;
    int32_t* bnd_mate_anchor;
    int32_t* bnd_sa_nm;
    // hint rows (grouped by read, ascending)
    int32_t* h_read;            // index into the input read subset
    int32_t* h_type;            // 0 INS, 1 DEL, 2 DUP, 3 INV, 4 INS-None
    int32_t* h_start;
    int32_t* h_svlen;
    int64_t* h_ctg_off;         // -1: region contig
    int32_t* h_ctg_len;
    int32_t* h_strand;          // +1/-1
    int32_t* h_mapq;
    int32_t* h_source;          // 0 SPLIT_PRIM, 1 SPLIT_SUP
    int32_t* h_qry_start;
    int32_t* h_qry_end;
    int32_t* h_seq_a;           // [a,b) slice of the primary SEQ, -1 none
    int32_t* h_seq_b;
};

// Parse + classify the SA chains of `n_reads` records (offsets/lengths
// from a prior bamcore_scan_records pass). `want` bit0 requests the BND
// lead, bit1 the split-hint chain (primaries only). Returns the hint
// count, or -9 when hint_cap is too small (caller regrows and retries).
int64_t bamcore_scan_splits(const uint8_t* data, int64_t data_len,
                            const int64_t* rec_off, const int32_t* rec_len,
                            const uint8_t* want, int64_t n_reads,
                            const char* region_contig,
                            int32_t minsvlen, double long_ins_half,
                            int32_t seq_cap, int32_t max_splits_base,
                            double max_splits_kb, int32_t mapq_min,
                            int32_t keep_lowqual,
                            SplitCols* sc, int64_t hint_cap,
                            int64_t* n_hints_out) {
    (void)data_len;
    const int64_t region_contig_len = (int64_t)strlen(region_contig);
    int64_t nh = 0;
    std::vector<SaEntry> sa;
    std::vector<ChainAln> chain;
    std::vector<ChainHint> hints;

    for (int64_t ridx = 0; ridx < n_reads; ridx++) {
        sc->bnd_ok[ridx] = 0;
        sc->split_err[ridx] = 0;
        const uint8_t w = want[ridx];
        if (!w) continue;

        SplitRecInfo ri;
        split_parse_rec(data, rec_off[ridx], rec_len[ridx], &ri);
        if (ri.sa_off < 0) continue;

        sa.clear();
        const int64_t n_sa = parse_sa_entries(data, ri.sa_off, ri.sa_len, &sa);
        if (n_sa < 0) {
            sc->bnd_ok[ridx] = -1;
            sc->split_err[ridx] = 1;
            continue;
        }

        const int8_t own_strand = (ri.flag & 0x10) ? -1 : 1;

        if ((w & 1) && n_sa > 0) {
            // BND lead from the FIRST SA entry (reference: leadprov.py:57-132)
            const bool first_clip = (ri.first_op == OP_S || ri.first_op == OP_H);
            const bool last_clip = (ri.last_op == OP_S || ri.last_op == OP_H);
            const int32_t clip_head = first_clip ? ri.first_len : 0;
            const int32_t clip_tail = last_clip ? ri.last_len : 0;
            int32_t anchor, is_first;
            if (clip_head > clip_tail) { anchor = ri.pos + 1; is_first = 0; }
            else { anchor = ri.pos + ri.ref_len; is_first = 1; }

            const SaEntry& e = sa[0];
            int64_t head_clip, tail_clip, refspan, readspan;
            if (sa_cigar_analyze(data + e.cig_off, e.cig_len, &head_clip,
                                 &tail_clip, &refspan, &readspan) != 0) {
                sc->bnd_ok[ridx] = -1;  // python fallback prints the error
            } else {
                const int64_t mate_start = e.pos - 1;
                const bool mate_is_reverse = tail_clip > head_clip;
                int64_t mate_anchor;
                if (mate_is_reverse) mate_anchor = mate_start + refspan;
                else if (is_first) mate_anchor = mate_start + 1;
                else if (e.strand == own_strand) mate_anchor = mate_start + refspan;
                else mate_anchor = mate_start + 2;

                sc->bnd_ok[ridx] = 1;
                sc->bnd_anchor[ridx] = anchor;
                sc->bnd_is_first[ridx] = is_first;
                sc->bnd_mate_is_reverse[ridx] = mate_is_reverse ? 1 : 0;
                sc->bnd_same_strand[ridx] = (e.strand == own_strand) ? 1 : 0;
                sc->bnd_mate_off[ridx] = e.ctg_off;
                sc->bnd_mate_len[ridx] = e.ctg_len;
                sc->bnd_mate_anchor[ridx] = (int32_t)mate_anchor;
                sc->bnd_sa_nm[ridx] = (int32_t)e.nm;
            }
        }

        if (!(w & 2) || n_sa == 0) continue;

        // split chain (reference: leadprov.py:227-265). query_length is
        // pysam's l_seq (0 when SEQ is not stored), NOT the CIGAR read
        // span — both the splits-allowed bound and the reverse-strand
        // primary query start depend on that exact semantic.
        const int32_t qlen_py = ri.l_seq;
        const double allowed = (double)max_splits_base
                               + max_splits_kb * ((double)qlen_py / 1000.0);
        if ((double)n_sa > allowed) continue;

        chain.clear();
        ChainAln prim;
        prim.ctg_off = -1;
        prim.ctg_len = 0;
        prim.ref_start = ri.pos;
        prim.ref_end = ri.pos + ri.ref_len;
        const int32_t prim_qry_start = (ri.flag & 0x10)
            ? qlen_py - (ri.qstart + ri.qalen) : ri.qstart;
        prim.qry_start = prim_qry_start;
        prim.qry_end = prim_qry_start + ri.qalen;
        prim.strand = own_strand;
        prim.mapq = ri.mapq;
        prim.is_prim = 1;
        chain.push_back(prim);

        bool bad = false;
        for (const SaEntry& e : sa) {
            int64_t clip_fwd, clip_rev, refspan, readspan;
            if (sa_cigar_analyze(data + e.cig_off, e.cig_len, &clip_fwd,
                                 &clip_rev, &refspan, &readspan) != 0) {
                bad = true;
                break;
            }
            ChainAln c;
            c.ctg_off = e.ctg_off;
            c.ctg_len = e.ctg_len;
            c.ref_start = (int32_t)(e.pos - 1);
            c.ref_end = (int32_t)(e.pos - 1 + refspan);
            const int64_t sa_qs = (e.strand == -1) ? clip_rev : clip_fwd;
            c.qry_start = (int32_t)sa_qs;
            c.qry_end = (int32_t)(sa_qs + readspan);
            c.strand = e.strand;
            c.mapq = (int32_t)e.mapq;
            c.is_prim = 0;
            chain.push_back(c);
        }
        if (bad) {
            sc->split_err[ridx] = 1;  // python fallback prints the error
            continue;
        }

        const int64_t n_chain = classify_chain(&chain, &hints, data,
                                               region_contig, region_contig_len,
                                               minsvlen, long_ins_half, seq_cap);

        for (int64_t k = 0; k < n_chain; k++) {
            if (hints[k].type < 0) continue;
            // pair-mapq gate (reference: leadprov.py:285-292)
            const int32_t prev_mapq = chain[(k > 0) ? k - 1 : 0].mapq;
            const int32_t pair_mapq = (chain[k].mapq < prev_mapq)
                ? chain[k].mapq : prev_mapq;
            if (!keep_lowqual && pair_mapq < mapq_min) continue;
            if (nh >= hint_cap) return -9;
            sc->h_read[nh] = (int32_t)ridx;
            sc->h_type[nh] = hints[k].type;
            sc->h_start[nh] = hints[k].start;
            sc->h_svlen[nh] = hints[k].svlen;
            sc->h_ctg_off[nh] = chain[k].ctg_off;
            sc->h_ctg_len[nh] = chain[k].ctg_len;
            sc->h_strand[nh] = chain[k].strand;
            sc->h_mapq[nh] = chain[k].mapq;
            sc->h_source[nh] = chain[k].is_prim ? 0 : 1;
            sc->h_qry_start[nh] = chain[k].qry_start;
            sc->h_qry_end[nh] = chain[k].qry_end;
            sc->h_seq_a[nh] = hints[k].seq_a;
            sc->h_seq_b[nh] = hints[k].seq_b;
            nh++;
        }
    }
    *n_hints_out = nh;
    return n_reads;
}

}  // extern "C"
