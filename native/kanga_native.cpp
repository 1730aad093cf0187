// Native host runtime for biokanga.
//
// The reference's runtime is all C++ (CFasta parsing, CMTqsort suffix
// sorting — libbiokanga/Fasta.cpp, MTqsort.cpp); these are the host-side
// hot paths around the device compute. This library provides:
//   - base-code translation and FASTQ block parsing (input pipeline)
//   - threaded 32-base-key construction + parallel sample-sort of the
//     bounded suffix array (index build; replaces numpy lexsort)
// C ABI, loaded via ctypes (no pybind11 in the image).
//
// Build: biokanga/utils/native.py compiles this file at first use into
// build/ (g++ -O3 -shared -fPIC -std=c++17 -pthread).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- codes --

static int8_t g_ascii2code[256];
static bool g_tbl_init = false;

static void init_tbl() {
    if (g_tbl_init) return;
    memset(g_ascii2code, 4, sizeof(g_ascii2code));
    g_ascii2code['A'] = g_ascii2code['a'] = 0;
    g_ascii2code['C'] = g_ascii2code['c'] = 1;
    g_ascii2code['G'] = g_ascii2code['g'] = 2;
    g_ascii2code['T'] = g_ascii2code['t'] = 3;
    g_ascii2code['U'] = g_ascii2code['u'] = 3;
    g_tbl_init = true;
}

void ascii_to_codes(const uint8_t* in, int64_t n, int8_t* out) {
    init_tbl();
    for (int64_t i = 0; i < n; i++) out[i] = g_ascii2code[in[i]];
}

// ------------------------------------------------------------ FASTQ parse --
//
// Parse a FASTQ buffer into a fixed-width padded block:
//   codes   (max_reads x max_len) int8, pre-filled with 4 by caller
//   lengths (max_reads) int32
//   quals   (max_reads x max_len) uint8 or nullptr
//   name_ofs/name_len (max_reads) -> offsets into buf for read names
// Returns number of reads parsed; *consumed = bytes consumed (so callers
// can stream buffers larger than one block).
int64_t parse_fastq_block(const char* buf, int64_t len,
                          int8_t* codes, int32_t* lengths,
                          uint8_t* quals,
                          int64_t* name_ofs, int32_t* name_len,
                          int64_t max_reads, int64_t max_len,
                          int64_t* consumed) {
    init_tbl();
    int64_t pos = 0, nreads = 0;
    while (pos < len && nreads < max_reads) {
        int64_t rec_start = pos;
        if (buf[pos] != '@') break;
        // header line
        int64_t he = pos;
        while (he < len && buf[he] != '\n') he++;
        if (he >= len) break;
        int64_t ns = pos + 1, ne = ns;
        while (ne < he && buf[ne] != ' ' && buf[ne] != '\t' &&
               buf[ne] != '\r') ne++;
        // sequence line
        int64_t ss = he + 1, se = ss;
        while (se < len && buf[se] != '\n') se++;
        if (se >= len) break;
        int64_t slen = se - ss;
        if (slen > 0 && buf[se - 1] == '\r') slen--;
        // plus line
        int64_t ps = se + 1, pe = ps;
        while (pe < len && buf[pe] != '\n') pe++;
        if (pe >= len) break;
        // qual line
        int64_t qs = pe + 1, qe = qs;
        while (qe < len && buf[qe] != '\n') qe++;
        if (qe >= len && qs + slen > len) break;
        int64_t L = slen < max_len ? slen : max_len;
        int8_t* crow = codes + nreads * max_len;
        for (int64_t i = 0; i < L; i++)
            crow[i] = g_ascii2code[(uint8_t)buf[ss + i]];
        if (quals) {
            uint8_t* qrow = quals + nreads * max_len;
            for (int64_t i = 0; i < L; i++) qrow[i] = (uint8_t)buf[qs + i];
        }
        lengths[nreads] = (int32_t)L;
        name_ofs[nreads] = ns;
        name_len[nreads] = (int32_t)(ne - ns);
        nreads++;
        pos = qe < len ? qe + 1 : len;
        (void)rec_start;
    }
    *consumed = pos;
    return nreads;
}

// -------------------------------------------------- key build + SA sort --

// key_hi[i] packs bases [i, i+16), key_lo[i] = key_hi[i+16]; N packs as 0.
void build_keys(const int8_t* codes, int64_t n, uint32_t* hi, uint32_t* lo,
                int32_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t a = t * chunk, b = std::min(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back([=]() {
            // rolling from the right edge of the chunk: compute key at i
            // from scratch when i == b-1 else roll
            auto base = [&](int64_t p) -> uint32_t {
                if (p >= n) return 0;
                int8_t c = codes[p];
                return (c >= 0 && c < 4) ? (uint32_t)c : 0u;
            };
            uint32_t khi = 0, klo = 0;
            for (int64_t j = 0; j < 16; j++) {
                khi = (khi << 2) | base(b - 1 + j);
                klo = (klo << 2) | base(b - 1 + 16 + j);
            }
            hi[b - 1] = khi;
            lo[b - 1] = klo;
            for (int64_t i = b - 2; i >= a; i--) {
                // roll: khi(i) = base(i)<<30 | khi(i+1)>>2 (and same for lo
                // with base(i+16)) — keys are MSB-first packed
                lo[i] = (lo[i + 1] >> 2) | (base(i + 16) << 30);
                hi[i] = (hi[i + 1] >> 2) | (base(i) << 30);
            }
        });
    }
    for (auto& t : ts) t.join();
}

struct KeyCmp {
    const uint32_t* hi;
    const uint32_t* lo;
    bool operator()(int32_t a, int32_t b) const {
        if (hi[a] != hi[b]) return hi[a] < hi[b];
        if (lo[a] != lo[b]) return lo[a] < lo[b];
        return a < b;  // stable tie-break on position
    }
};

// Parallel sample sort of positions by (hi, lo) keys.
void sort_positions(const uint32_t* hi, const uint32_t* lo, int32_t* pos,
                    int64_t n, int32_t nthreads) {
    for (int64_t i = 0; i < n; i++) pos[i] = (int32_t)i;
    KeyCmp cmp{hi, lo};
    if (nthreads <= 1 || n < (1 << 16)) {
        std::sort(pos, pos + n, cmp);
        return;
    }
    // chunk sort
    int T = nthreads;
    std::vector<std::pair<int64_t, int64_t>> ranges;
    int64_t chunk = (n + T - 1) / T;
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) {
        int64_t a = t * chunk, b = std::min(n, a + chunk);
        if (a >= b) break;
        ranges.push_back({a, b});
        ts.emplace_back([=]() { std::sort(pos + a, pos + b, cmp); });
    }
    for (auto& t : ts) t.join();
    // iterative pairwise merge
    std::vector<int32_t> tmp(n);
    while (ranges.size() > 1) {
        std::vector<std::pair<int64_t, int64_t>> next;
        std::vector<std::thread> ms;
        for (size_t i = 0; i + 1 < ranges.size(); i += 2) {
            auto [a, m] = ranges[i];
            auto [m2, b] = ranges[i + 1];
            next.push_back({a, b});
            ms.emplace_back([=, &tmp]() {
                std::merge(pos + a, pos + m, pos + m2, pos + b,
                           tmp.data() + a, cmp);
                std::copy(tmp.data() + a, tmp.data() + b, pos + a);
            });
        }
        if (ranges.size() % 2) next.push_back(ranges.back());
        for (auto& t : ms) t.join();
        ranges = next;
    }
}

// gather sorted keys: khi_out[i] = hi[pos[i]]
void gather_keys(const uint32_t* hi, const uint32_t* lo, const int32_t* pos,
                 int64_t n, uint32_t* hi_out, uint32_t* lo_out,
                 int32_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t a = t * chunk, b = std::min(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back([=]() {
            for (int64_t i = a; i < b; i++) {
                hi_out[i] = hi[pos[i]];
                lo_out[i] = lo[pos[i]];
            }
        });
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
