// Native GF(2^8) Reed-Solomon matrix apply — the CPU fast path.
//
// The reference's only native component is its vendored SIMD Galois
// arithmetic (galois_amd64.s in klauspost/reedsolomon, SURVEY.md §2 L0):
// per-coefficient multiply via PSHUFB high/low-nibble 16-entry table
// lookups. This is the same classical kernel rebuilt from the algorithm
// (Plank/Greenan/Miller "screaming fast Galois field arithmetic"):
// runtime-dispatched AVX2 / scalar paths behind one C ABI, driven from
// Python over ctypes. It serves two roles: the XLA:CPU-independent host
// fallback, and the AVX2-class baseline the TPU numbers are compared
// against in bench.py.
//
// Build: g++ -O3 -shared -fPIC gf256_rs.cpp -o _gf256_rs.so
// (seaweedfs_tpu/ops/rs_native.py does this on demand).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define GF256_X86 1
#endif

namespace {

uint8_t MUL[256][256];
bool inited = false;

uint8_t gmul(uint8_t a, uint8_t b) {
    // Carry-less multiply mod the field polynomial 0x11D.
    uint8_t p = 0;
    while (b) {
        if (b & 1) p ^= a;
        const bool hi = a & 0x80;
        a = static_cast<uint8_t>(a << 1);
        if (hi) a ^= 0x1D;
        b >>= 1;
    }
    return p;
}

void xor_acc_scalar(const uint8_t* in, uint8_t* out, size_t n) {
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t a, b;
        std::memcpy(&a, in + i, 8);
        std::memcpy(&b, out + i, 8);
        b ^= a;
        std::memcpy(out + i, &b, 8);
    }
    for (; i < n; ++i) out[i] ^= in[i];
}

void mul_acc_scalar(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
                    bool first) {
    const uint8_t* row = MUL[c];
    if (first) {
        for (size_t i = 0; i < n; ++i) out[i] = row[in[i]];
    } else {
        for (size_t i = 0; i < n; ++i) out[i] ^= row[in[i]];
    }
}

#ifdef GF256_X86
__attribute__((target("avx2")))
void mul_acc_avx2(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
                  bool first) {
    alignas(16) uint8_t lo_tab[16], hi_tab[16];
    for (int i = 0; i < 16; ++i) {
        lo_tab[i] = MUL[c][i];
        hi_tab[i] = MUL[c][i << 4];
    }
    const __m256i vlo = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(lo_tab)));
    const __m256i vhi = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(hi_tab)));
    const __m256i nib = _mm256_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 32 <= n; i += 32) {
        const __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(in + i));
        const __m256i l = _mm256_shuffle_epi8(vlo, _mm256_and_si256(x, nib));
        const __m256i h = _mm256_shuffle_epi8(
            vhi, _mm256_and_si256(_mm256_srli_epi64(x, 4), nib));
        __m256i r = _mm256_xor_si256(l, h);
        if (!first)
            r = _mm256_xor_si256(r, _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(out + i)));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), r);
    }
    if (i < n) mul_acc_scalar(c, in + i, out + i, n - i, first);
}

__attribute__((target("avx2")))
void xor_acc_avx2(const uint8_t* in, uint8_t* out, size_t n) {
    size_t i = 0;
    for (; i + 32 <= n; i += 32) {
        const __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(in + i));
        const __m256i y = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(out + i));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                            _mm256_xor_si256(x, y));
    }
    if (i < n) xor_acc_scalar(in + i, out + i, n - i);
}

bool have_avx2() { return __builtin_cpu_supports("avx2"); }

// ---- GFNI + AVX-512: one vgf2p8affineqb per 64 bytes ------------------
//
// Multiplication by a constant c in GF(2^8) is linear over GF(2), so it
// is an 8x8 bit matrix — exactly what VGF2P8AFFINEQB applies to every
// byte of a zmm in ONE instruction (the reference's klauspost codec
// ships the same GFNI path as its fastest amd64 kernel). The bit-layout
// convention of the matrix operand is LEARNED at init by probing the
// instruction with single-bit matrices against single-bit inputs, then
// the built tables are verified against MUL; any mismatch simply leaves
// the AVX2 path in charge — no SDM-convention trust required.

uint64_t MAT64[256];
bool gfni_ready = false;

bool have_gfni512() {
    return __builtin_cpu_supports("gfni")
        && __builtin_cpu_supports("avx512f")
        && __builtin_cpu_supports("avx512bw")
        && __builtin_cpu_supports("avx512vl");
}

__attribute__((target("avx512f,avx512bw,avx512vl,gfni")))
uint8_t gfni_apply_one(uint64_t mat, uint8_t x) {
    const __m128i vx = _mm_set1_epi8(static_cast<char>(x));
    const __m128i vA = _mm_set1_epi64x(static_cast<long long>(mat));
    const __m128i r = _mm_gf2p8affine_epi64_epi8(vx, vA, 0);
    return static_cast<uint8_t>(_mm_extract_epi8(r, 0));
}

void gfni_init() {
    if (!have_gfni512()) return;
    // learn which matrix bit k couples input bit j to output bit i
    int couple_i[64], couple_j[64];
    for (int k = 0; k < 64; ++k) {
        couple_i[k] = couple_j[k] = -1;
        const uint64_t A = 1ull << k;
        for (int j = 0; j < 8; ++j) {
            const uint8_t y = gfni_apply_one(
                A, static_cast<uint8_t>(1u << j));
            if (!y) continue;
            for (int i = 0; i < 8; ++i)
                if (y & (1u << i)) { couple_i[k] = i; couple_j[k] = j; }
        }
    }
    for (int c = 0; c < 256; ++c) {
        uint64_t A = 0;
        for (int k = 0; k < 64; ++k) {
            if (couple_i[k] < 0) continue;
            const uint8_t y = MUL[c][1u << couple_j[k]];
            if (y & (1u << couple_i[k])) A |= 1ull << k;
        }
        MAT64[c] = A;
    }
    static const uint8_t probe[] = {0, 1, 2, 3, 29, 76, 142, 253, 255};
    for (const uint8_t c : probe)
        for (int x = 0; x < 256; ++x)
            if (gfni_apply_one(MAT64[c], static_cast<uint8_t>(x))
                    != MUL[c][x])
                return;  // convention not learned: stay on AVX2
    gfni_ready = true;
}

__attribute__((target("avx512f,avx512bw,gfni")))
void mul_acc_gfni(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
                  bool first) {
    const __m512i A = _mm512_set1_epi64(
        static_cast<long long>(MAT64[c]));
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        const __m512i x = _mm512_loadu_si512(
            reinterpret_cast<const void*>(in + i));
        __m512i r = _mm512_gf2p8affine_epi64_epi8(x, A, 0);
        if (!first)
            r = _mm512_xor_si512(r, _mm512_loadu_si512(
                reinterpret_cast<const void*>(out + i)));
        _mm512_storeu_si512(reinterpret_cast<void*>(out + i), r);
    }
    if (i < n) mul_acc_scalar(c, in + i, out + i, n - i, first);
}

__attribute__((target("avx512f,avx512bw")))
void xor_acc_avx512(const uint8_t* in, uint8_t* out, size_t n) {
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        const __m512i x = _mm512_loadu_si512(
            reinterpret_cast<const void*>(in + i));
        const __m512i y = _mm512_loadu_si512(
            reinterpret_cast<const void*>(out + i));
        _mm512_storeu_si512(reinterpret_cast<void*>(out + i),
                            _mm512_xor_si512(x, y));
    }
    if (i < n) xor_acc_scalar(in + i, out + i, n - i);
}
#else
bool have_avx2() { return false; }
bool gfni_ready = false;
void gfni_init() {}
#endif

void mul_acc(uint8_t c, const uint8_t* in, uint8_t* out, size_t n,
             bool first) {
#ifdef GF256_X86
    if (gfni_ready) {
        mul_acc_gfni(c, in, out, n, first);
        return;
    }
    if (have_avx2()) {
        mul_acc_avx2(c, in, out, n, first);
        return;
    }
#endif
    mul_acc_scalar(c, in, out, n, first);
}

}  // namespace

extern "C" {

void gf256_init() {
    if (inited) return;
    for (int a = 0; a < 256; ++a)
        for (int b = 0; b < 256; ++b)
            MUL[a][b] = gmul(static_cast<uint8_t>(a),
                             static_cast<uint8_t>(b));
    gfni_init();
    inited = true;
}

// 0 = scalar, 2 = AVX2 nibble-LUT, 3 = GFNI+AVX512 affine.
int gf256_simd_level() {
    return gfni_ready ? 3 : (have_avx2() ? 2 : 0);
}

// out[o][s] = XOR_d coefs[o*n_in+d] * in[d][s], with explicit row
// strides so callers can hand out zero-copy column windows of larger
// arrays. The column loop is blocked so every (o, d) coefficient pass
// over a block runs against L1/L2-resident data instead of streaming
// whole shards through DRAM n_out times (klauspost's codeSomeShards
// blocks the same way for the same reason).
void rs_apply(const uint8_t* coefs, int n_out, int n_in,
              const uint8_t* in, size_t in_stride,
              uint8_t* out, size_t out_stride, size_t slen) {
    if (slen == 0) return;
    const size_t BLOCK = 32 * 1024;
    for (size_t col = 0; col < slen; col += BLOCK) {
        const size_t n = slen - col < BLOCK ? slen - col : BLOCK;
        for (int o = 0; o < n_out; ++o) {
            uint8_t* dst = out + static_cast<size_t>(o) * out_stride + col;
            bool first = true;
            for (int d = 0; d < n_in; ++d) {
                const uint8_t c = coefs[o * n_in + d];
                if (c == 0) continue;
                const uint8_t* src =
                    in + static_cast<size_t>(d) * in_stride + col;
                if (c == 1) {
                    if (first) {
                        std::memcpy(dst, src, n);
#ifdef GF256_X86
                    } else if (gfni_ready) {
                        xor_acc_avx512(src, dst, n);
                    } else if (have_avx2()) {
                        xor_acc_avx2(src, dst, n);
#endif
                    } else {
                        xor_acc_scalar(src, dst, n);
                    }
                } else {
                    mul_acc(c, src, dst, n, first);
                }
                first = false;
            }
            if (first) std::memset(dst, 0, n);
        }
    }
}

}  // extern "C"
