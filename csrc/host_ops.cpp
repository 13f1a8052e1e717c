// Native host-side hot loops for the Viterbi framework.
//
// The reference implements BER accounting as a C++ bit loop over the packed
// decoder output (reference: src/main.cpp:151-171).  This library provides
// the equivalent at native speed for 32M-bit-scale messages: the decoded
// words are compared against a re-packed ground-truth word and the error
// count accumulated with popcount.
//
// Output-pack convention (must match the decoder): earliest bit in the MSB
// of each pack (reference: README.md:86-87, main.cpp:160).

#include <cstdint>
#include <cmath>

extern "C" {

// decoded: n_words packs, MSB = earliest bit.
// ref_bits: n_bits ground-truth bits ({0,1} bytes), already offset by extraL.
// Returns the number of differing bits over min(n_words*W, n_bits).
long long count_bit_errors_u32(const uint32_t* decoded, long long n_words,
                               const uint8_t* ref_bits, long long n_bits) {
    long long errors = 0;
    long long full = n_bits / 32 < n_words ? n_bits / 32 : n_words;
    for (long long w = 0; w < full; ++w) {
        uint32_t ref = 0;
        const uint8_t* rb = ref_bits + w * 32;
        for (int i = 0; i < 32; ++i) ref = (ref << 1) | (rb[i] & 1u);
        errors += __builtin_popcount(decoded[w] ^ ref);
    }
    // tail bits (partial last word)
    for (long long i = full * 32; i < n_bits && i / 32 < n_words; ++i) {
        uint32_t bit = (decoded[i / 32] >> (31 - (i % 32))) & 1u;
        errors += (bit != (ref_bits[i] & 1u));
    }
    return errors;
}

long long count_bit_errors_u16(const uint16_t* decoded, long long n_words,
                               const uint8_t* ref_bits, long long n_bits) {
    long long errors = 0;
    long long full = n_bits / 16 < n_words ? n_bits / 16 : n_words;
    for (long long w = 0; w < full; ++w) {
        uint32_t ref = 0;
        const uint8_t* rb = ref_bits + w * 16;
        for (int i = 0; i < 16; ++i) ref = (ref << 1) | (rb[i] & 1u);
        errors += __builtin_popcount((uint32_t)decoded[w] ^ ref);
    }
    for (long long i = full * 16; i < n_bits && i / 16 < n_words; ++i) {
        uint32_t bit = (decoded[i / 16] >> (15 - (i % 16))) & 1u;
        errors += (bit != (ref_bits[i] & 1u));
    }
    return errors;
}

// Host-side quantize + MSB-first pack (reference SoftDecisionPacker,
// src/viterbiDF.h:98-167): v*scale; HARD (width 1): v > 0 -> 1 (strict);
// soft widths: round-to-nearest-even (lrintf in the default FP env,
// viterbiDF.h:110) then saturate to the two's-complement field range and
// mask to the field width; pack MSB = earliest-in-time into int32 words
// (viterbiDF.h:157-163).  Trailing values of a partial word are zero
// fields.  Returns the number of words written.
long long quantize_pack_f32(const float* vals, long long n, float scale,
                            int width, int32_t* out) {
    const int per_word = 32 / width;
    const long long n_words = (n + per_word - 1) / per_word;
    const long long hi = width == 1 ? 1 : (1LL << (width - 1)) - 1;
    const long long lo = width == 1 ? 0 : -(1LL << (width - 1));
    const uint32_t mask = (width == 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
    long long vi = 0;
    for (long long w = 0; w < n_words; ++w) {
        uint32_t b = 0;
        for (int j = 0; j < per_word; ++j, ++vi) {
            uint32_t q = 0;
            if (vi < n) {
                float x = vals[vi] * scale;
                if (width == 1) {
                    q = x > 0.0f ? 1u : 0u;
                } else {
                    long long r;
                    if (x >= (float)hi) r = hi;
                    else if (x <= (float)lo) r = lo;
                    else r = llrintf(x);
                    q = (uint32_t)r & mask;
                }
            }
            // width == 32 would shift by the full type width (UB);
            // per_word == 1 means the field IS the word
            b = (per_word == 1) ? q : ((b << width) | q);
        }
        out[w] = (int32_t)b;
    }
    return n_words;
}

// Packed channel words -> sign-extended int32 soft values (HARD bits map
// to +-1), MSB = earliest (the host-side inverse of the packer; mirrors
// the decode kernel's word unpack in csrc/viterbi_hopper.cu).
void unpack_soft_words(const int32_t* words, long long n_words, int width,
                       int32_t* out) {
    const int per_word = 32 / width;
    for (long long w = 0; w < n_words; ++w) {
        const uint32_t u = (uint32_t)words[w];
        for (int j = 0; j < per_word; ++j) {
            int32_t v;
            if (width == 1) {
                v = (int32_t)((u >> (31 - j)) & 1u) * 2 - 1;
            } else {
                v = (int32_t)(u << (j * width)) >> (32 - width);
            }
            out[w * per_word + j] = v;
        }
    }
}

}  // extern "C"
