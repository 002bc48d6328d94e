// The prover core of the port: 256-bit Montgomery field arithmetic,
// radix-2 NTT, Pippenger G1 MSM, grand products and the quotient kernel
// for the framework's PLONK protocol.
//
// Copied from native/protocol_native.cpp (the reference package's prover
// core), its prover entry points only: the Clos planner that shares that
// file lives in csrc/clos_plan.cpp. Python keeps witness generation and
// protocol orchestration (zk/prover_fast.py); every O(n)/O(n log n)
// polynomial or curve operation crosses this boundary as flat
// little-endian 4x64-bit limb arrays in standard (non-Montgomery) form.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread prover_native.cpp
// (driven by protocol_tpu_torch/native/prover.py, which builds it into
// protocol_tpu_torch/build/ at first use).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#ifdef __linux__
#include <sys/mman.h>
#endif
#ifdef __linux__
#include <sched.h>
#endif
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Fp {
    u64 v[4];
};

// Field context: modulus, -modulus^-1 mod 2^64, R^2 mod p (Montgomery).
struct FieldCtx {
    Fp mod;
    u64 inv;   // -p^{-1} mod 2^64
    Fp r2;     // (2^256)^2 mod p
    Fp one;    // 2^256 mod p (Montgomery 1)
};

static inline bool geq(const Fp &a, const Fp &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

static inline void sub_nored(Fp &out, const Fp &a, const Fp &b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
        out.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void add_mod(Fp &out, const Fp &a, const Fp &b, const FieldCtx &f) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
        out.v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(out, f.mod)) {
        Fp t;
        sub_nored(t, out, f.mod);
        out = t;
    }
}

static inline void sub_mod(Fp &out, const Fp &a, const Fp &b, const FieldCtx &f) {
    u128 borrow = 0;
    Fp t;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - (u64)borrow;
        t.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)t.v[i] + f.mod.v[i] + (u64)carry;
            t.v[i] = (u64)s;
            carry = s >> 64;
        }
    }
    out = t;
}

// CIOS Montgomery multiplication.
static inline void mont_mul(Fp &out, const Fp &a, const Fp &b, const FieldCtx &f) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 c = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + (u64)c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)c;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * f.inv;
        c = ((u128)t[0] + (u128)m * f.mod.v[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 s2 = (u128)t[j] + (u128)m * f.mod.v[j] + (u64)c;
            t[j - 1] = (u64)s2;
            c = s2 >> 64;
        }
        u128 s2 = (u128)t[4] + (u64)c;
        t[3] = (u64)s2;
        t[4] = t[5] + (u64)(s2 >> 64);
        t[5] = 0;
    }
    Fp r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(r, f.mod)) {
        Fp q;
        sub_nored(q, r, f.mod);
        // note: if t[4] set, the true value is r + 2^256 which is < 2p,
        // so one subtraction (mod 2^256 arithmetic) lands in range
        out = q;
    } else {
        out = r;
    }
}

static inline void to_mont(Fp &out, const Fp &a, const FieldCtx &f) {
    mont_mul(out, a, f.r2, f);
}

static inline void from_mont(Fp &out, const Fp &a, const FieldCtx &f) {
    Fp one = {{1, 0, 0, 0}};
    mont_mul(out, a, one, f);
}

static inline void mont_sqr(Fp &out, const Fp &a, const FieldCtx &f) {
    mont_mul(out, a, a, f);
}

static void mont_pow(Fp &out, const Fp &base, const u64 *exp, int exp_words,
                     const FieldCtx &f) {
    Fp acc = f.one;
    Fp b = base;
    for (int w = 0; w < exp_words; ++w) {
        u64 e = exp[w];
        for (int bit = 0; bit < 64; ++bit) {
            if (e & 1) mont_mul(acc, acc, b, f);
            mont_sqr(b, b, f);
            e >>= 1;
        }
    }
    out = acc;
}

static void mont_inv(Fp &out, const Fp &a, const FieldCtx &f) {
    // a^(p-2)
    u64 e[4];
    Fp pm2 = f.mod;
    u128 borrow = 2;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)pm2.v[i] - (u64)borrow;
        e[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    mont_pow(out, a, e, 4, f);
}

// --------------------------------------------------------------------------
// context setup

static FieldCtx make_ctx(const u64 *mod_limbs) {
    FieldCtx f;
    std::memcpy(f.mod.v, mod_limbs, 32);
    // inv = -p^{-1} mod 2^64 (Newton iteration)
    u64 p0 = f.mod.v[0];
    u64 inv = 1;
    for (int i = 0; i < 63; ++i) inv *= 2 - p0 * inv;
    f.inv = ~inv + 1;
    // one = 2^256 mod p: compute by repeated doubling of 1 (256 times)
    Fp one = {{1, 0, 0, 0}};
    Fp acc = one;
    for (int i = 0; i < 256; ++i) add_mod(acc, acc, acc, f);
    f.one = acc;
    // r2 = (2^256)^2 mod p: double 'one' 256 more times
    Fp r2 = acc;
    for (int i = 0; i < 256; ++i) add_mod(r2, r2, r2, f);
    f.r2 = r2;
    return f;
}

extern "C" {

// --- field vector ops (standard-form in/out) ------------------------------

void fr_vec_op(const u64 *mod_limbs, int op, u64 *out, const u64 *a,
               const u64 *b, long n) {
    FieldCtx f = make_ctx(mod_limbs);
    for (long i = 0; i < n; ++i) {
        Fp x, y, r;
        std::memcpy(x.v, a + 4 * i, 32);
        if (b) std::memcpy(y.v, b + 4 * i, 32);
        switch (op) {
        case 0: add_mod(r, x, y, f); break;
        case 1: sub_mod(r, x, y, f); break;
        case 2: {  // mul
            Fp xm, ym;
            to_mont(xm, x, f);
            to_mont(ym, y, f);
            mont_mul(r, xm, ym, f);
            from_mont(r, r, f);
            break;
        }
        default: r = x;
        }
        std::memcpy(out + 4 * i, r.v, 32);
    }
}

// scalar-broadcast variants: b points at ONE field element.
// op 0 add, 1 sub (a - s), 2 mul.
void fr_vec_scalar_op(const u64 *mod_limbs, int op, u64 *out, const u64 *a,
                      const u64 *scalar, long n) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp s, sm;
    std::memcpy(s.v, scalar, 32);
    to_mont(sm, s, f);
    for (long i = 0; i < n; ++i) {
        Fp x, r;
        std::memcpy(x.v, a + 4 * i, 32);
        switch (op) {
        case 0: add_mod(r, x, s, f); break;
        case 1: sub_mod(r, x, s, f); break;
        case 2: {
            Fp xm;
            to_mont(xm, x, f);
            mont_mul(r, xm, sm, f);
            from_mont(r, r, f);
            break;
        }
        default: r = x;
        }
        std::memcpy(out + 4 * i, r.v, 32);
    }
}

// out[i] = acc after synthetic division: (f(X) - f(z)) / (X - z).
// coeffs: n low-first; out: n-1 coefficients.
void fr_poly_divide_linear(const u64 *mod_limbs, const u64 *coeffs, long n,
                           const u64 *z_limbs, u64 *out) {
    FieldCtx f = make_ctx(mod_limbs);
    if (n <= 1) return;
    Fp z;
    std::memcpy(z.v, z_limbs, 32);
    to_mont(z, z, f);
    Fp acc = {{0, 0, 0, 0}};
    for (long i = n - 1; i >= 1; --i) {
        Fp c, t;
        std::memcpy(c.v, coeffs + 4 * i, 32);
        to_mont(c, c, f);
        mont_mul(t, acc, z, f);
        add_mod(acc, t, c, f);
        from_mont(t, acc, f);
        std::memcpy(out + 4 * (i - 1), t.v, 32);
    }
}

// --- NTT ------------------------------------------------------------------

// in-place radix-2 DIT NTT over the subgroup generated by omega (standard
// form in/out). dir=0 forward, dir=1 inverse (uses omega^-1 and scales by
// n^-1).
// radix-2 NTT on a Montgomery-form array in place (internal helper).
// ``tw_ready`` marks the twiddle table as already built for this
// (omega, n) — the four-step path reuses one table across all rows of a
// stage instead of rebuilding it per row.
static void ntt_core(Fp *a, long n, const Fp &omega, const FieldCtx &f,
                     std::vector<Fp> &tw, bool tw_ready = false) {
    // bit reversal
    for (long i = 1, j = 0; i < n; ++i) {
        long bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    if (!tw_ready) {
        if ((long)tw.size() < n / 2) tw.resize(n / 2 > 0 ? n / 2 : 1);
        tw[0] = f.one;
        for (long j = 1; j < n / 2; ++j) mont_mul(tw[j], tw[j - 1], omega, f);
    }
    for (long len = 2; len <= n; len <<= 1) {
        long stride = n / len;
        for (long i = 0; i < n; i += len) {
            for (long j = 0; j < len / 2; ++j) {
                Fp u = a[i + j];
                Fp v;
                mont_mul(v, a[i + j + len / 2], tw[j * stride], f);
                add_mod(a[i + j], u, v, f);
                sub_mod(a[i + j + len / 2], u, v, f);
            }
        }
    }
}

// blocked out-of-place transpose of an A x B Fp matrix
static void fp_transpose(const Fp *src, Fp *dst, long rows, long cols) {
    const long BLK = 32;
    for (long i0 = 0; i0 < rows; i0 += BLK)
        for (long j0 = 0; j0 < cols; j0 += BLK) {
            long i1 = std::min(i0 + BLK, rows), j1 = std::min(j0 + BLK, cols);
            for (long i = i0; i < i1; ++i)
                for (long j = j0; j < j1; ++j)
                    dst[j * rows + i] = src[i * cols + j];
        }
}

void ntt(const u64 *mod_limbs, u64 *data, long n, const u64 *omega_limbs,
         int dir) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp omega_s;
    std::memcpy(omega_s.v, omega_limbs, 32);
    Fp omega;
    to_mont(omega, omega_s, f);
    if (dir) mont_inv(omega, omega, f);

    std::vector<Fp> a(n);
    for (long i = 0; i < n; ++i) {
        Fp x;
        std::memcpy(x.v, data + 4 * i, 32);
        to_mont(a[i], x, f);
    }

    std::vector<Fp> tw;
    if (n <= (1 << 14)) {
        ntt_core(a.data(), n, omega, f, tw);
    } else {
        // cache-blocked four-step: n = A·B, x[j1·B + j2];
        //   X[k1 + k2·A] = Σ_{j2} ω^{A j2 k2} · ( ω^{j2 k1} ·
        //                  Σ_{j1} ω^{B j1 k1} x[j1·B + j2] )
        // inner/outer NTTs are length-A/B rows that fit in cache, the
        // cross-stage twiddle is one running-product multiply per
        // element, and data movement is three blocked transposes.
        int lg = 0;
        while ((1L << lg) < n) ++lg;
        long A = 1L << (lg / 2), B = n / A;
        Fp omega_A, omega_B;
        u64 expB[1] = {(u64)B}, expA[1] = {(u64)A};
        mont_pow(omega_A, omega, expB, 1, f);  // ω^B (order A)
        mont_pow(omega_B, omega, expA, 1, f);  // ω^A (order B)
        std::vector<Fp> t(n);
        // transpose to (B rows of A): t[j2][j1]
        fp_transpose(a.data(), t.data(), A, B);
        // inner A-point NTTs along rows of t, then the cross twiddle:
        // t[j2][k1] *= ω^{j2·k1} via a per-row running power of ω^{j2}
        std::vector<Fp> wrow(B);
        wrow[0] = f.one;
        for (long j2 = 1; j2 < B; ++j2) mont_mul(wrow[j2], wrow[j2 - 1], omega, f);
        for (long j2 = 0; j2 < B; ++j2) {
            Fp *row = &t[j2 * A];
            ntt_core(row, A, omega_A, f, tw, j2 > 0);
            Fp w = wrow[j2], pw = w;
            for (long k1 = 1; k1 < A; ++k1) {
                mont_mul(row[k1], row[k1], pw, f);
                mont_mul(pw, pw, w, f);
            }
        }
        // transpose to (A rows of B): u[k1][j2], outer B-point NTTs
        fp_transpose(t.data(), a.data(), B, A);
        for (long k1 = 0; k1 < A; ++k1)
            ntt_core(&a[k1 * B], B, omega_B, f, tw, k1 > 0);
        // a[k1][k2] holds X[k1 + k2·A]; natural order = transpose
        fp_transpose(a.data(), t.data(), A, B);
        a.swap(t);
    }

    if (dir) {
        // scale by n^{-1}
        Fp n_fp = {{(u64)n, 0, 0, 0}};
        Fp n_mont, n_inv;
        to_mont(n_mont, n_fp, f);
        mont_inv(n_inv, n_mont, f);
        for (long i = 0; i < n; ++i) mont_mul(a[i], a[i], n_inv, f);
    }
    for (long i = 0; i < n; ++i) {
        Fp x;
        from_mont(x, a[i], f);
        std::memcpy(data + 4 * i, x.v, 32);
    }
}

// multiply data[i] by shift^i (coset scaling), standard form
void coset_scale(const u64 *mod_limbs, u64 *data, long n,
                 const u64 *shift_limbs, int invert) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp s;
    std::memcpy(s.v, shift_limbs, 32);
    to_mont(s, s, f);
    if (invert) mont_inv(s, s, f);
    Fp acc = f.one;
    for (long i = 0; i < n; ++i) {
        Fp x;
        std::memcpy(x.v, data + 4 * i, 32);
        to_mont(x, x, f);
        mont_mul(x, x, acc, f);
        from_mont(x, x, f);
        std::memcpy(data + 4 * i, x.v, 32);
        mont_mul(acc, acc, s, f);
    }
}

// Horner evaluation of many polynomials (coeff-major: polys[p][i]) at x.
void poly_eval_many(const u64 *mod_limbs, const u64 *coeffs, long n_polys,
                    long n, const u64 *x_limbs, u64 *out) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp x;
    std::memcpy(x.v, x_limbs, 32);
    to_mont(x, x, f);
    for (long p = 0; p < n_polys; ++p) {
        Fp acc = {{0, 0, 0, 0}};
        const u64 *c = coeffs + p * 4 * n;
        for (long i = n - 1; i >= 0; --i) {
            Fp ci;
            std::memcpy(ci.v, c + 4 * i, 32);
            to_mont(ci, ci, f);
            mont_mul(acc, acc, x, f);
            add_mod(acc, acc, ci, f);
        }
        from_mont(acc, acc, f);
        std::memcpy(out + 4 * p, acc.v, 32);
    }
}

// batch inversion, standard form; zeros stay zero
void batch_inverse(const u64 *mod_limbs, u64 *data, long n) {
    FieldCtx f = make_ctx(mod_limbs);
    std::vector<Fp> vals(n), prefix(n);
    Fp acc = f.one;
    for (long i = 0; i < n; ++i) {
        Fp x;
        std::memcpy(x.v, data + 4 * i, 32);
        to_mont(vals[i], x, f);
        prefix[i] = acc;
        bool zero = !(x.v[0] | x.v[1] | x.v[2] | x.v[3]);
        if (!zero) mont_mul(acc, acc, vals[i], f);
    }
    Fp inv;
    mont_inv(inv, acc, f);
    for (long i = n - 1; i >= 0; --i) {
        Fp x = vals[i];
        bool zero = true;
        for (int k = 0; k < 4; ++k) zero = zero && !x.v[k];
        if (zero) continue;
        Fp r;
        mont_mul(r, inv, prefix[i], f);
        mont_mul(inv, inv, x, f);
        from_mont(r, r, f);
        std::memcpy(data + 4 * i, r.v, 32);
    }
}

// --- G1 (short Weierstrass y^2 = x^3 + b, a=0) ----------------------------

struct JacPoint {
    Fp x, y, z;  // Montgomery form; z=0 => identity
};

static inline bool is_zero_fp(const Fp &a) {
    return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

static void jac_double(JacPoint &r, const JacPoint &p_in, const FieldCtx &f) {
    JacPoint p = p_in;  // r may alias p_in
    if (is_zero_fp(p.z)) { r = p; return; }
    Fp a, bb, c, d, e, g, t;
    mont_sqr(a, p.x, f);                 // A = X^2
    mont_sqr(bb, p.y, f);                // B = Y^2
    mont_sqr(c, bb, f);                  // C = B^2
    add_mod(d, p.x, bb, f);              // (X+B)
    mont_sqr(d, d, f);                   // (X+B)^2
    sub_mod(d, d, a, f);
    sub_mod(d, d, c, f);
    add_mod(d, d, d, f);                 // D = 2((X+B)^2 - A - C)
    add_mod(e, a, a, f);
    add_mod(e, e, a, f);                 // E = 3A
    mont_sqr(g, e, f);                   // G = E^2
    sub_mod(r.x, g, d, f);
    sub_mod(r.x, r.x, d, f);             // X' = G - 2D
    sub_mod(t, d, r.x, f);
    mont_mul(t, t, e, f);
    Fp c8;
    add_mod(c8, c, c, f);
    add_mod(c8, c8, c8, f);
    add_mod(c8, c8, c8, f);              // 8C
    sub_mod(r.y, t, c8, f);              // Y' = E(D - X') - 8C
    mont_mul(r.z, p.y, p.z, f);
    add_mod(r.z, r.z, r.z, f);           // Z' = 2YZ
}

static void jac_add(JacPoint &r, const JacPoint &p_in, const JacPoint &q_in,
                    const FieldCtx &f) {
    JacPoint p = p_in, q = q_in;  // r may alias either input
    if (is_zero_fp(p.z)) { r = q; return; }
    if (is_zero_fp(q.z)) { r = p; return; }
    Fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
    mont_sqr(z1z1, p.z, f);
    mont_sqr(z2z2, q.z, f);
    mont_mul(u1, p.x, z2z2, f);
    mont_mul(u2, q.x, z1z1, f);
    mont_mul(s1, p.y, q.z, f);
    mont_mul(s1, s1, z2z2, f);
    mont_mul(s2, q.y, p.z, f);
    mont_mul(s2, s2, z1z1, f);
    sub_mod(h, u2, u1, f);
    sub_mod(rr, s2, s1, f);
    if (is_zero_fp(h)) {
        if (is_zero_fp(rr)) { jac_double(r, p, f); return; }
        r.x = f.one; r.y = f.one;
        r.z = Fp{{0, 0, 0, 0}};
        return;
    }
    add_mod(rr, rr, rr, f);              // r = 2(S2-S1)
    add_mod(i, h, h, f);
    mont_sqr(i, i, f);                   // I = (2H)^2
    mont_mul(j, h, i, f);                // J = H*I
    mont_mul(v, u1, i, f);               // V = U1*I
    mont_sqr(r.x, rr, f);
    sub_mod(r.x, r.x, j, f);
    sub_mod(r.x, r.x, v, f);
    sub_mod(r.x, r.x, v, f);             // X3 = r^2 - J - 2V
    sub_mod(t, v, r.x, f);
    mont_mul(t, t, rr, f);
    Fp s1j;
    mont_mul(s1j, s1, j, f);
    add_mod(s1j, s1j, s1j, f);
    sub_mod(r.y, t, s1j, f);             // Y3 = r(V - X3) - 2 S1 J
    add_mod(t, p.z, q.z, f);
    mont_sqr(t, t, f);
    sub_mod(t, t, z1z1, f);
    sub_mod(t, t, z2z2, f);
    mont_mul(r.z, t, h, f);              // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
}

// --- Pippenger MSM (signed digits + batch-affine accumulation) -------------

struct AffPt {
    Fp x, y;  // Montgomery form; MSM tracks infinity out-of-band
};

static inline void neg_mod(Fp &out, const Fp &a, const FieldCtx &f) {
    if (is_zero_fp(a)) { out = a; return; }
    sub_nored(out, f.mod, a);
}

// mixed addition r = p(Jac) + q(affine, finite): madd-2007-bl, 7M + 4S
static void jac_add_mixed(JacPoint &r, const JacPoint &p_in, const AffPt &q,
                          const FieldCtx &f) {
    JacPoint p = p_in;
    if (is_zero_fp(p.z)) { r.x = q.x; r.y = q.y; r.z = f.one; return; }
    Fp z1z1, u2, s2, h, hh, i, j, rr, v, t;
    mont_sqr(z1z1, p.z, f);
    mont_mul(u2, q.x, z1z1, f);
    mont_mul(s2, q.y, p.z, f);
    mont_mul(s2, s2, z1z1, f);
    sub_mod(h, u2, p.x, f);
    sub_mod(rr, s2, p.y, f);
    if (is_zero_fp(h)) {
        if (is_zero_fp(rr)) {
            JacPoint qj;
            qj.x = q.x; qj.y = q.y; qj.z = f.one;
            jac_double(r, qj, f);
            return;
        }
        r.z = Fp{{0, 0, 0, 0}};
        return;
    }
    mont_sqr(hh, h, f);                  // HH = H^2
    add_mod(i, hh, hh, f);
    add_mod(i, i, i, f);                 // I = 4*HH
    mont_mul(j, h, i, f);                // J = H*I
    add_mod(rr, rr, rr, f);              // r = 2*(S2-Y1)
    mont_mul(v, p.x, i, f);              // V = X1*I
    mont_sqr(r.x, rr, f);
    sub_mod(r.x, r.x, j, f);
    sub_mod(r.x, r.x, v, f);
    sub_mod(r.x, r.x, v, f);             // X3 = r^2 - J - 2V
    sub_mod(t, v, r.x, f);
    mont_mul(t, t, rr, f);
    Fp y1j;
    mont_mul(y1j, p.y, j, f);
    add_mod(y1j, y1j, y1j, f);
    sub_mod(r.y, t, y1j, f);             // Y3 = r*(V-X3) - 2*Y1*J
    add_mod(t, p.z, h, f);
    mont_sqr(t, t, f);
    sub_mod(t, t, z1z1, f);
    sub_mod(r.z, t, hh, f);              // Z3 = (Z1+H)^2 - Z1Z1 - HH
}

// r += k·p for a small positive k (the sparse bucket-reduction skip)
static void jac_add_small_mul(JacPoint &r, const JacPoint &p, u64 k,
                              const FieldCtx &f) {
    if (!k || is_zero_fp(p.z)) return;
    JacPoint acc;
    acc.z = Fp{{0, 0, 0, 0}};
    int top = 63 - __builtin_clzll(k);
    for (int bit = top; bit >= 0; --bit) {
        jac_double(acc, acc, f);
        if ((k >> bit) & 1) jac_add(acc, acc, p, f);
    }
    jac_add(r, r, acc, f);
}

// ===== AVX-512 IFMA 8-lane batched field engine =========================
//
// The batch-affine bucket accumulation below is mul-bound: ~6 Montgomery
// muls per pair-add, half of them on serial prefix/unwind chains. With
// vpmadd52 (8x52-bit lanes) the muls vectorize 8-wide IF the serial
// chains are split into 8 interleaved per-lane chains whose lane totals
// share one inversion — which is how level_pass_ifma() below is
// structured. Guarded at compile time (-march=native on an IFMA machine)
// and at runtime; every machine without it keeps the scalar path.

#if defined(__AVX512IFMA__) && defined(__AVX512F__)
#define PN_IFMA 1
#include <immintrin.h>

static const u64 MASK52 = (1ULL << 52) - 1;

struct Fp8 {  // 8 field elements, 5x52-bit limbs, lane-parallel
    __m512i l[5];
};

// The 5x52-limb CIOS below reduces by 2^260 per multiply, so the vector
// subsystem lives in the R' = 2^260 Montgomery domain while the scalar
// engine uses R = 2^256. Boundary conversions are one scalar mont_mul:
// x_w = mont_mul(x_s, c_in) (c_in = 2^260 mod p → X·2^260) and
// x_s = mont_mul(x_w, c_out) (c_out = 2^252 mod p → X·2^256).
struct Ctx52 {
    __m512i p[5];
    __m512i n0;     // -mod^{-1} mod 2^52, broadcast
    u64 p52[5];
    Fp c_in;        // 2^260 mod p (plain bits)
    Fp c_out;       // 2^252 mod p (plain bits)
};

static inline void fp_to52(const Fp &a, u64 out[5]) {
    out[0] = a.v[0] & MASK52;
    out[1] = ((a.v[0] >> 52) | (a.v[1] << 12)) & MASK52;
    out[2] = ((a.v[1] >> 40) | (a.v[2] << 24)) & MASK52;
    out[3] = ((a.v[2] >> 28) | (a.v[3] << 36)) & MASK52;
    out[4] = a.v[3] >> 16;
}

static inline void fp_from52(const u64 in[5], Fp &a) {
    a.v[0] = in[0] | (in[1] << 52);
    a.v[1] = (in[1] >> 12) | (in[2] << 40);
    a.v[2] = (in[2] >> 24) | (in[3] << 28);
    a.v[3] = (in[3] >> 36) | (in[4] << 16);
}

static Ctx52 make_ctx52(const FieldCtx &f) {
    Ctx52 c;
    fp_to52(f.mod, c.p52);
    for (int i = 0; i < 5; ++i) c.p[i] = _mm512_set1_epi64((long long)c.p52[i]);
    // the 2-adic inverse mod 2^64 truncates to the inverse mod 2^52
    c.n0 = _mm512_set1_epi64((long long)(f.inv & MASK52));
    // f.one = 2^256 mod p: shift by ±4 doublings/halvings mod p
    c.c_in = f.one;
    for (int i = 0; i < 4; ++i) add_mod(c.c_in, c.c_in, c.c_in, f);
    c.c_out = f.one;
    for (int i = 0; i < 4; ++i) {
        Fp t = c.c_out;
        if (t.v[0] & 1) {  // odd: add p, then halve
            u128 carry = 0;
            for (int j = 0; j < 4; ++j) {
                u128 s = (u128)t.v[j] + f.mod.v[j] + (u64)carry;
                t.v[j] = (u64)s;
                carry = s >> 64;
            }
            for (int j = 0; j < 3; ++j)
                t.v[j] = (t.v[j] >> 1) | (t.v[j + 1] << 63);
            t.v[3] = (t.v[3] >> 1) | ((u64)carry << 63);
        } else {
            for (int j = 0; j < 3; ++j)
                t.v[j] = (t.v[j] >> 1) | (t.v[j + 1] << 63);
            t.v[3] >>= 1;
        }
        c.c_out = t;
    }
    return c;
}

// boundary moves between the scalar (R = 2^256) and vector (R' = 2^260)
// Montgomery domains
static inline void to_w52(u64 out[5], const Fp &s, const Ctx52 &c,
                          const FieldCtx &f) {
    Fp w;
    mont_mul(w, s, c.c_in, f);
    fp_to52(w, out);
}

static inline void from_w52(Fp &out, const u64 in[5], const Ctx52 &c,
                            const FieldCtx &f) {
    Fp w;
    fp_from52(in, w);
    mont_mul(out, w, c.c_out, f);
}

static inline void v_load_lanes(Fp8 &dst, const u64 lanes[5][8]) {
    for (int i = 0; i < 5; ++i)
        dst.l[i] = _mm512_loadu_si512((const void *)lanes[i]);
}

// 8-wide CIOS Montgomery multiply; canonical (< p) in, canonical out.
static inline void v_mont_mul(Fp8 &out, const Fp8 &a, const Fp8 &b,
                              const Ctx52 &c) {
    __m512i acc[10];
    const __m512i zero = _mm512_setzero_si512();
    for (int i = 0; i < 10; ++i) acc[i] = zero;
    for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) {
            acc[i + j] = _mm512_madd52lo_epu64(acc[i + j], a.l[i], b.l[j]);
            acc[i + j + 1] =
                _mm512_madd52hi_epu64(acc[i + j + 1], a.l[i], b.l[j]);
        }
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    for (int i = 0; i < 5; ++i) {
        acc[i + 1] = _mm512_add_epi64(acc[i + 1], _mm512_srli_epi64(acc[i], 52));
        __m512i lo = _mm512_and_si512(acc[i], mask);
        __m512i m = _mm512_madd52lo_epu64(zero, lo, c.n0);
        acc[i] = lo;
        for (int j = 0; j < 5; ++j) {
            acc[i + j] = _mm512_madd52lo_epu64(acc[i + j], m, c.p[j]);
            acc[i + j + 1] =
                _mm512_madd52hi_epu64(acc[i + j + 1], m, c.p[j]);
        }
        // acc[i] ≡ 0 mod 2^52 now; push its (1-bit) carry up
        acc[i + 1] = _mm512_add_epi64(acc[i + 1], _mm512_srli_epi64(acc[i], 52));
    }
    __m512i r[5];
    __m512i carry = zero;
    for (int i = 0; i < 5; ++i) {
        __m512i t = _mm512_add_epi64(acc[5 + i], carry);
        r[i] = _mm512_and_si512(t, mask);
        carry = _mm512_srli_epi64(t, 52);
    }
    // (< 2p; bits fit 5 limbs, so `carry` here is zero) — one
    // conditional subtract lands canonical
    __m512i borrow = zero;
    __m512i d[5];
    for (int i = 0; i < 5; ++i) {
        __m512i t = _mm512_sub_epi64(_mm512_sub_epi64(r[i], c.p[i]), borrow);
        d[i] = _mm512_and_si512(t, mask);
        borrow = _mm512_srli_epi64(t, 63);
    }
    __mmask8 ge = _mm512_cmpeq_epi64_mask(borrow, zero);  // r >= p lanes
    for (int i = 0; i < 5; ++i)
        out.l[i] = _mm512_mask_blend_epi64(ge, r[i], d[i]);
}

// 8-wide modular subtract, canonical in/out.
static inline void v_sub_mod(Fp8 &out, const Fp8 &a, const Fp8 &b,
                             const Ctx52 &c) {
    const __m512i zero = _mm512_setzero_si512();
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    __m512i borrow = zero;
    __m512i d[5];
    for (int i = 0; i < 5; ++i) {
        __m512i t = _mm512_sub_epi64(_mm512_sub_epi64(a.l[i], b.l[i]), borrow);
        d[i] = _mm512_and_si512(t, mask);
        borrow = _mm512_srli_epi64(t, 63);
    }
    __mmask8 neg = _mm512_cmpneq_epi64_mask(borrow, zero);  // a < b lanes
    __m512i carry = zero;
    for (int i = 0; i < 5; ++i) {
        __m512i e = _mm512_add_epi64(_mm512_add_epi64(d[i], c.p[i]), carry);
        carry = _mm512_srli_epi64(e, 52);
        out.l[i] = _mm512_mask_blend_epi64(neg, d[i], _mm512_and_si512(e, mask));
    }
}

static inline bool v_mul_selftest(const FieldCtx &f) {
    // 8 lanes of r2·r2 through the w-domain must round-trip to the
    // scalar product — a boot check of the 52-bit path + conversions
    Ctx52 c = make_ctx52(f);
    u64 lanes[5][8];
    u64 t[5];
    to_w52(t, f.r2, c, f);
    for (int i = 0; i < 5; ++i)
        for (int l = 0; l < 8; ++l) lanes[i][l] = t[i];
    Fp8 a;
    v_load_lanes(a, lanes);
    Fp8 o;
    v_mont_mul(o, a, a, c);
    u64 got[5][8];
    for (int i = 0; i < 5; ++i)
        _mm512_storeu_si512((void *)got[i], o.l[i]);
    Fp expect;
    mont_mul(expect, f.r2, f.r2, f);
    for (int l = 0; l < 8; ++l) {
        u64 g[5] = {got[0][l], got[1][l], got[2][l], got[3][l], got[4][l]};
        Fp back;
        from_w52(back, g, c, f);
        for (int i = 0; i < 4; ++i)
            if (back.v[i] != expect.v[i]) return false;
    }
    return true;
}

static bool ifma_available() {
    static int cached = -1;
    if (cached < 0) {
        __builtin_cpu_init();
        cached = __builtin_cpu_supports("avx512ifma") ? 1 : 0;
    }
    return cached == 1;
}

// gather 8 elements of a 5x52-limb AoS array (40 B stride) by index
static inline void vgather5(Fp8 &dst, const u64 *base, const __m512i idx5) {
    for (int i = 0; i < 5; ++i)
        dst.l[i] = _mm512_i64gather_epi64(
            _mm512_add_epi64(idx5, _mm512_set1_epi64(i)), base, 8);
}

// reusable per-MSM scratch: a fresh allocation per level call costs
// ~170 MB of page faults at 2^20 and swamps the vector math
struct IfmaScratch {
    std::vector<Fp8> prefv, denv, axv, ayv, bxv, byv;
    std::vector<u64> pox, poy;
    std::vector<unsigned char> kind;
    std::vector<long> heads;
    void ensure(long pairs) {
        const long nblk = (pairs + 7) / 8;
        if ((long)prefv.size() < nblk) {
            prefv.resize(nblk);
            denv.resize(nblk);
            axv.resize(nblk);
            ayv.resize(nblk);
            bxv.resize(nblk);
            byv.resize(nblk);
        }
        if ((long)pox.size() < 5 * pairs) {
            pox.resize(5 * (size_t)pairs);
            poy.resize(5 * (size_t)pairs);
        }
        if ((long)kind.size() < pairs) kind.resize(pairs);
        if ((long)heads.size() < pairs) heads.resize(pairs);
    }
};

// One batch-affine level, 8-wide over a 52-bit AoS working set:
// per-lane den chains built forward, lane totals batch-inverted once,
// chains unwound backward, the affine adds evaluated in vector lanes.
// Mirrors the scalar level exactly — same pairing, same edge rules
// (doubling / cancel-to-infinity), same output order. ax52/ay52 hold
// 5x52-bit limbs per element (canonical Montgomery values); abid the
// bucket ids. Pure in→out (callers swap their ping-pong buffers);
// returns the new live count.
static long level_pass_ifma(const FieldCtx &f, const Ctx52 &c52,
                            const u64 *ax52, const u64 *ay52,
                            const int32_t *abid,
                            u64 *nx52, u64 *ny52, int32_t *nbid,
                            const std::vector<unsigned char> &role,
                            long m, long pairs, IfmaScratch &S) {
    S.ensure(pairs);
    std::vector<long> &heads = S.heads;
    {
        long pi = 0;
        for (long i = 0; i < m; ++i)
            if (role[i] == 1) heads[pi++] = i;
    }
    const long nblk = (pairs + 7) / 8;
    // per-block saved state so pass 2 re-reads nothing from the source
    std::vector<Fp8> &prefv = S.prefv, &denv = S.denv, &axv = S.axv,
                     &ayv = S.ayv, &bxv = S.bxv, &byv = S.byv;
    std::vector<unsigned char> &kind = S.kind;
    std::memset(kind.data(), 0, pairs);
    // w-domain multiplicative identity: v_mont_mul(x, e) = x needs
    // e = 2^260 mod p — c_in's bit pattern, not f.one's
    u64 one52[5];
    fp_to52(c52.c_in, one52);

    // DUAL prefix chains (r4): even/odd blocks run two independent
    // den-product chains that merge only at the single batch
    // inversion, keeping two v_mont_muls in flight. Measured ~neutral
    // on this box (the level pass is vgather-bound, not chain-latency
    // bound) but strictly never worse; retained with the scalar-vs-
    // vector equivalence test pinning correctness.
    Fp8 run[2];
    for (int ch = 0; ch < 2; ++ch)
        for (int i = 0; i < 5; ++i)
            run[ch].l[i] = _mm512_set1_epi64((long long)one52[i]);
    const __m512i vzero = _mm512_setzero_si512();

    // pass 1: gather head/tail coords, den = xB − xA, per-lane chains
    for (long b = 0; b < nblk; ++b) {
        int cnt = (int)((b == nblk - 1) ? pairs - 8 * b : 8);
        alignas(64) long long hoff[8];
        for (int l = 0; l < 8; ++l) {
            long h = (l < cnt) ? heads[8 * b + l] : heads[8 * b];  // dup pad
            hoff[l] = 5 * h;
        }
        const __m512i hv = _mm512_load_si512((const void *)hoff);
        const __m512i tv = _mm512_add_epi64(hv, _mm512_set1_epi64(5));
        Fp8 Ax, Ay, Bx, By, den;
        vgather5(Ax, ax52, hv);
        vgather5(Ay, ay52, hv);
        vgather5(Bx, ax52, tv);
        vgather5(By, ay52, tv);
        v_sub_mod(den, Bx, Ax, c52);
        __m512i nz = den.l[0];
        for (int i = 1; i < 5; ++i) nz = _mm512_or_si512(nz, den.l[i]);
        __mmask8 zl = _mm512_cmpeq_epi64_mask(nz, vzero);
        if (cnt < 8) zl = (__mmask8)(zl | (0xFF << cnt));  // pad lanes
        if (zl) {
            u64 dl[5][8], ayl[5][8], byl[5][8];
            for (int i = 0; i < 5; ++i) {
                _mm512_storeu_si512((void *)dl[i], den.l[i]);
                _mm512_storeu_si512((void *)ayl[i], Ay.l[i]);
                _mm512_storeu_si512((void *)byl[i], By.l[i]);
            }
            for (int l = 0; l < 8; ++l) {
                if (!((zl >> l) & 1)) continue;
                u64 t[5];
                if (l >= cnt) {
                    std::memcpy(t, one52, 40);  // pad: den=1, no output
                } else {
                    Fp aY, bY, sy;
                    u64 a5[5] = {ayl[0][l], ayl[1][l], ayl[2][l], ayl[3][l],
                                 ayl[4][l]};
                    u64 b5[5] = {byl[0][l], byl[1][l], byl[2][l], byl[3][l],
                                 byl[4][l]};
                    fp_from52(a5, aY);
                    fp_from52(b5, bY);
                    add_mod(sy, aY, bY, f);
                    if (is_zero_fp(sy)) {
                        kind[8 * b + l] = 2;  // P + (−P): drops out
                        std::memcpy(t, one52, 40);
                    } else {
                        kind[8 * b + l] = 1;  // doubling: den = 2y
                        Fp dd;
                        add_mod(dd, aY, aY, f);
                        fp_to52(dd, t);
                    }
                }
                for (int i = 0; i < 5; ++i) dl[i][l] = t[i];
            }
            v_load_lanes(den, dl);
        }
        const int ch = (int)(b & 1);
        prefv[b] = run[ch];
        denv[b] = den;
        axv[b] = Ax;
        ayv[b] = Ay;
        bxv[b] = Bx;
        byv[b] = By;
        v_mont_mul(run[ch], run[ch], den, c52);
    }

    // lane totals (both chains) -> ONE inversion -> per-chain seeds
    Fp8 inv_vec[2];
    {
        Fp lane_tot[16], pre[16], inv_lane[16];
        u64 lanes[2][5][8];
        for (int ch = 0; ch < 2; ++ch)
            for (int i = 0; i < 5; ++i)
                _mm512_storeu_si512((void *)lanes[ch][i], run[ch].l[i]);
        for (int j = 0; j < 16; ++j) {
            int ch = j >> 3, l = j & 7;
            u64 t[5] = {lanes[ch][0][l], lanes[ch][1][l], lanes[ch][2][l],
                        lanes[ch][3][l], lanes[ch][4][l]};
            from_w52(lane_tot[j], t, c52, f);  // w → s domain
        }
        Fp acc = f.one;
        for (int j = 0; j < 16; ++j) {
            pre[j] = acc;
            mont_mul(acc, acc, lane_tot[j], f);
        }
        Fp tinv;
        mont_inv(tinv, acc, f);
        for (int j = 15; j >= 0; --j) {
            mont_mul(inv_lane[j], tinv, pre[j], f);
            mont_mul(tinv, tinv, lane_tot[j], f);
        }
        u64 t[5];
        for (int j = 0; j < 16; ++j) {
            int ch = j >> 3, l = j & 7;
            to_w52(t, inv_lane[j], c52, f);  // s → w domain
            for (int i = 0; i < 5; ++i) lanes[ch][i][l] = t[i];
        }
        for (int ch = 0; ch < 2; ++ch)
            v_load_lanes(inv_vec[ch], lanes[ch]);
    }

    // pass 2 (backward): unwind chains, evaluate the adds into a dense
    // 52-bit pair-output array
    std::vector<u64> &pox = S.pox, &poy = S.poy;
    for (long b = nblk - 1; b >= 0; --b) {
        int cnt = (int)((b == nblk - 1) ? pairs - 8 * b : 8);
        const int ch = (int)(b & 1);
        Fp8 dinv, num;
        v_mont_mul(dinv, inv_vec[ch], prefv[b], c52);
        v_mont_mul(inv_vec[ch], inv_vec[ch], denv[b], c52);
        const Fp8 &Ax = axv[b], &Ay = ayv[b], &Bx = bxv[b], &By = byv[b];
        v_sub_mod(num, By, Ay, c52);
        bool patch = false;
        for (int l = 0; l < cnt; ++l)
            if (kind[8 * b + l] == 1) patch = true;
        if (patch) {
            u64 lanes[5][8], axl[5][8];
            for (int i = 0; i < 5; ++i) {
                _mm512_storeu_si512((void *)lanes[i], num.l[i]);
                _mm512_storeu_si512((void *)axl[i], Ax.l[i]);
            }
            for (int l = 0; l < cnt; ++l) {
                if (kind[8 * b + l] != 1) continue;
                u64 a5[5] = {axl[0][l], axl[1][l], axl[2][l], axl[3][l],
                             axl[4][l]};
                Fp aX, sq, n3;
                fp_from52(a5, aX);       // raw w-form bits X·2^260
                mont_sqr(sq, aX, f);     // X²·2^264
                mont_mul(sq, sq, c52.c_out, f);  // X²·2^260 — back in w
                add_mod(n3, sq, sq, f);
                add_mod(n3, n3, sq, f);  // 3x²
                u64 t[5];
                fp_to52(n3, t);
                for (int i = 0; i < 5; ++i) lanes[i][l] = t[i];
            }
            v_load_lanes(num, lanes);
        }
        Fp8 lam, x3, y3, t0;
        v_mont_mul(lam, num, dinv, c52);
        v_mont_mul(x3, lam, lam, c52);
        v_sub_mod(x3, x3, Ax, c52);
        v_sub_mod(x3, x3, Bx, c52);
        v_sub_mod(t0, Ax, x3, c52);
        v_mont_mul(y3, lam, t0, c52);
        v_sub_mod(y3, y3, Ay, c52);
        // dense stride-5 scatter of the block's outputs
        alignas(64) long long ooff[8];
        for (int l = 0; l < 8; ++l)
            ooff[l] = 5 * (8 * b + ((l < cnt) ? l : cnt - 1));
        const __m512i ov = _mm512_load_si512((const void *)ooff);
        __mmask8 live = (__mmask8)((1u << cnt) - 1);
        for (int i = 0; i < 5; ++i) {
            _mm512_mask_i64scatter_epi64(
                pox.data(), live,
                _mm512_add_epi64(ov, _mm512_set1_epi64(i)), x3.l[i], 8);
            _mm512_mask_i64scatter_epi64(
                poy.data(), live,
                _mm512_add_epi64(ov, _mm512_set1_epi64(i)), y3.l[i], 8);
        }
    }

    // merge (forward, order-preserving — matches the scalar backward fill)
    long write = 0, pi = 0;
    for (long i = 0; i < m; ++i) {
        if (role[i] == 2) continue;
        if (role[i] == 1) {
            if (kind[pi] != 2) {
                std::memcpy(&nx52[5 * write], &pox[5 * pi], 40);
                std::memcpy(&ny52[5 * write], &poy[5 * pi], 40);
                nbid[write] = abid[i];
                ++write;
            }
            ++pi;
        } else {
            std::memcpy(&nx52[5 * write], &ax52[5 * i], 40);
            std::memcpy(&ny52[5 * write], &ay52[5 * i], 40);
            nbid[write] = abid[i];
            ++write;
        }
    }
    return write;
}
#endif  // PN_IFMA

// Pippenger MSM: bases affine standard-form (x,y) pairs (8 limbs each,
// zero-zero = identity), scalars standard-form 4-limb. Result affine
// standard form written to out (8 limbs; zeros for identity).
//
// Signed-digit windows (buckets halved) with batch-affine bucket
// accumulation: per window, points are counting-sorted by |digit| and
// each bucket's segment is summed level-by-level as independent affine
// additions sharing ONE batched inversion per level (~6M per add vs 16M
// for Jacobian-Jacobian). Windows with no nonzero digit are skipped
// outright, which makes small-scalar MSMs (0/1 selector columns) cost a
// single window pass.
void g1_msm(const u64 *mod_limbs, const u64 *bases, const u64 *scalars,
            long n, u64 *out) {
    FieldCtx f = make_ctx(mod_limbs);
#ifdef PN_IFMA
    const bool use_ifma = !std::getenv("PN_NO_IFMA") && ifma_available() &&
                          v_mul_selftest(f);
    Ctx52 c52;
    if (use_ifma) c52 = make_ctx52(f);
#endif
    int c = 4;
    if (n > 32) c = 8;
    if (n > 1024) c = 12;
    if (n > 131072) c = 15;  // r4 grid on the IFMA box: c=15 beats 16
                             // by ~8% at 2^20 (PN_MSM_C overrides)
    if (const char *cenv = std::getenv("PN_MSM_C")) {
        int cv = std::atoi(cenv);
        if (cv >= 2 && cv <= 20) c = cv;
    }
    const long half = 1L << (c - 1);
    const int windows = (256 + c - 1) / c + 1;  // +1 for the signed carry

    std::vector<AffPt> pts(n);
    std::vector<unsigned char> finite(n);
    long n_finite = 0;
    for (long i = 0; i < n; ++i) {
        Fp x, y;
        std::memcpy(x.v, bases + 8 * i, 32);
        std::memcpy(y.v, bases + 8 * i + 4, 32);
        bool inf = is_zero_fp(x) && is_zero_fp(y);
        finite[i] = !inf;
        if (!inf) {
            to_mont(pts[i].x, x, f);
            to_mont(pts[i].y, y, f);
            ++n_finite;
        }
    }

    // signed-digit recode: scalar = Σ d_w·2^{cw}, d_w ∈ [-2^{c-1}, 2^{c-1}]
    std::vector<int32_t> digits((size_t)windows * n, 0);
    for (long i = 0; i < n; ++i) {
        if (!finite[i]) continue;
        u64 carry = 0;
        for (int w = 0; w < windows; ++w) {
            long bit0 = (long)w * c;
            u64 raw = 0;
            if (bit0 < 256) {
                int word = (int)(bit0 / 64), off = (int)(bit0 % 64);
                raw = scalars[4 * i + word] >> off;
                if (off && word + 1 < 4)
                    raw |= scalars[4 * i + word + 1] << (64 - off);
                raw &= ((u64)1 << c) - 1;
            }
            raw += carry;
            if (raw > (u64)half) {
                digits[(size_t)w * n + i] = (int32_t)raw - (int32_t)(1L << c);
                carry = 1;
            } else {
                digits[(size_t)w * n + i] = (int32_t)raw;
                carry = 0;
            }
        }
    }

    // per-level scratch (ping-pong): x, y, bucket id
    std::vector<Fp> ax(n_finite), ay(n_finite), nx(n_finite), ny(n_finite);
    std::vector<int32_t> abid(n_finite), nbid(n_finite);
    std::vector<long> counts(half + 1);
    std::vector<Fp> dens, prefix;
    dens.reserve(n_finite / 2 + 1);
    prefix.reserve(n_finite / 2 + 1);
#ifdef PN_IFMA
    // 52-bit AoS twins for the vectorized levels (built lazily per
    // window; the tail levels fall back to the scalar path)
    std::vector<u64> x52, y52, nx52, ny52, p52x, p52y, p52yn;
    IfmaScratch ifma_scratch;
    if (use_ifma) {
        x52.resize(5 * (size_t)n_finite);
        y52.resize(5 * (size_t)n_finite);
        nx52.resize(5 * (size_t)n_finite);
        ny52.resize(5 * (size_t)n_finite);
        // per-point w-domain coordinates (and negated y for the signed
        // digits), converted once — window placement is then a memcpy
        p52x.resize(5 * (size_t)n);
        p52y.resize(5 * (size_t)n);
        p52yn.resize(5 * (size_t)n);
        for (long i = 0; i < n; ++i) {
            if (!finite[i]) continue;
            to_w52(&p52x[5 * (size_t)i], pts[i].x, c52, f);
            to_w52(&p52y[5 * (size_t)i], pts[i].y, c52, f);
            Fp yn;
            neg_mod(yn, pts[i].y, f);
            to_w52(&p52yn[5 * (size_t)i], yn, c52, f);
        }
    }
#endif

    // PN_MSM_DEBUG=1: phase timing to stderr (sort/levels/reduction)
    const bool dbg = std::getenv("PN_MSM_DEBUG") != nullptr;
    double t_sort = 0, t_levels = 0, t_reduce = 0, t_dbl = 0;
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto secs = [](auto a, auto b) {
        return std::chrono::duration<double>(b - a).count();
    };

    JacPoint total;
    total.z = Fp{{0, 0, 0, 0}};
    for (int w = windows - 1; w >= 0; --w) {
        auto tw0 = now();
        if (!is_zero_fp(total.z))
            for (int d = 0; d < c; ++d) jac_double(total, total, f);
        t_dbl += secs(tw0, now());
        auto ts0 = now();
        const int32_t *dw = &digits[(size_t)w * n];

        // counting sort by |digit|, sign applied to y on placement
        std::fill(counts.begin(), counts.end(), 0);
        long m = 0;
        for (long i = 0; i < n; ++i)
            if (dw[i]) { ++counts[dw[i] < 0 ? -dw[i] : dw[i]]; ++m; }
        if (!m) continue;
        long acc_off = 0;
        for (long b = 1; b <= half; ++b) {
            long cnt = counts[b];
            counts[b] = acc_off;
            acc_off += cnt;
        }
        for (long i = 0; i < n; ++i) {
            int32_t d = dw[i];
            if (!d) continue;
            long b = d < 0 ? -d : d;
            long pos = counts[b]++;
#ifdef PN_IFMA
            if (use_ifma) {
                std::memcpy(&x52[5 * (size_t)pos], &p52x[5 * (size_t)i], 40);
                std::memcpy(&y52[5 * (size_t)pos],
                            d > 0 ? &p52y[5 * (size_t)i]
                                  : &p52yn[5 * (size_t)i], 40);
                abid[pos] = (int32_t)b;
                continue;
            }
#endif
            ax[pos] = pts[i].x;
            if (d > 0) ay[pos] = pts[i].y;
            else neg_mod(ay[pos], pts[i].y, f);
            abid[pos] = (int32_t)b;
        }

        t_sort += secs(ts0, now());
        auto tl0 = now();
        // level-by-level batch-affine segment sums. Each level pairs
        // adjacent same-bucket entries; all pair additions share one
        // batched inversion (Montgomery trick).
        std::vector<unsigned char> role(n_finite);  // 0=solo 1=pair-first
#ifdef PN_IFMA
        bool in52 = use_ifma;  // placement wrote the w-domain arrays
#else
        bool in52 = false;
#endif
        (void)in52;
        while (true) {
            // fix the pairing once (greedy adjacent within segments) so
            // both passes below agree for odd-length segments
            long pairs = 0;
            for (long i = 0; i < m;) {
                if (i + 1 < m && abid[i + 1] == abid[i]) {
                    role[i] = 1;
                    role[i + 1] = 2;
                    ++pairs;
                    i += 2;
                } else {
                    role[i] = 0;
                    ++i;
                }
            }
            if (!pairs) break;
#ifdef PN_IFMA
            if (use_ifma && in52 && pairs >= 64) {
                m = level_pass_ifma(f, c52, x52.data(), y52.data(),
                                    abid.data(), nx52.data(), ny52.data(),
                                    nbid.data(), role, m, pairs,
                                    ifma_scratch);
                x52.swap(nx52);
                y52.swap(ny52);
                abid.swap(nbid);
                continue;
            }
            if (in52) {  // tail levels: back to the scalar (s) domain
                for (long i = 0; i < m; ++i) {
                    from_w52(ax[i], &x52[5 * (size_t)i], c52, f);
                    from_w52(ay[i], &y52[5 * (size_t)i], c52, f);
                }
                in52 = false;
            }
#endif
            dens.clear();
            prefix.clear();
            // pass 1: denominators + running product
            Fp run = f.one;
            std::vector<unsigned char> kind; // 0=add 1=double 2=infinity
            kind.reserve(pairs);
            for (long i = 0; i < m; ++i) {
                if (role[i] != 1) continue;
                Fp d;
                sub_mod(d, ax[i + 1], ax[i], f);
                if (is_zero_fp(d)) {
                    Fp sy;
                    add_mod(sy, ay[i], ay[i + 1], f);
                    if (is_zero_fp(sy)) { kind.push_back(2); d = f.one; }
                    else { kind.push_back(1); add_mod(d, ay[i], ay[i], f); }
                } else kind.push_back(0);
                dens.push_back(d);
                prefix.push_back(run);
                mont_mul(run, run, d, f);
            }
            Fp inv;
            mont_inv(inv, run, f);
            // count outputs: infinity pairs drop out
            long n_out = m - pairs;
            for (long pi = 0; pi < pairs; ++pi)
                if (kind[pi] == 2) --n_out;
            // pass 2 (backward): per-pair inverse, then the affine add
            long write = n_out;
            long pi = pairs - 1;
            for (long i = m - 1; i >= 0; --i) {
                if (role[i] == 2) continue;  // handled with its pair head
                if (role[i] == 1) {
                    Fp dinv;
                    mont_mul(dinv, inv, prefix[pi], f);
                    mont_mul(inv, inv, dens[pi], f);
                    if (kind[pi] != 2) {
                        long a = i, b = i + 1;
                        Fp lam, num, x3, y3;
                        if (kind[pi] == 1) {
                            mont_sqr(num, ax[a], f);
                            Fp n3;
                            add_mod(n3, num, num, f);
                            add_mod(num, n3, num, f);  // 3x^2
                        } else {
                            sub_mod(num, ay[b], ay[a], f);
                        }
                        mont_mul(lam, num, dinv, f);
                        mont_sqr(x3, lam, f);
                        sub_mod(x3, x3, ax[a], f);
                        sub_mod(x3, x3, ax[b], f);
                        sub_mod(y3, ax[a], x3, f);
                        mont_mul(y3, y3, lam, f);
                        sub_mod(y3, y3, ay[a], f);
                        --write;
                        nx[write] = x3;
                        ny[write] = y3;
                        nbid[write] = abid[i];
                    }
                    --pi;
                } else {
                    --write;
                    nx[write] = ax[i];
                    ny[write] = ay[i];
                    nbid[write] = abid[i];
                }
            }
            m = n_out;
            ax.swap(nx);
            ay.swap(ny);
            abid.swap(nbid);
        }

#ifdef PN_IFMA
        if (in52) {  // vector levels ran last: rebuild the Fp survivors
            for (long i = 0; i < m; ++i) {
                from_w52(ax[i], &x52[5 * (size_t)i], c52, f);
                from_w52(ay[i], &y52[5 * (size_t)i], c52, f);
            }
        }
#endif
        t_levels += secs(tl0, now());
        auto tr0 = now();
        // bucket reduction: one affine point per surviving bucket id,
        // ascending. Walk descending with the running/sum scan; empty
        // gaps advance `sum` by gap·running via a small double-and-add.
        JacPoint running, sum;
        running.z = Fp{{0, 0, 0, 0}};
        sum.z = Fp{{0, 0, 0, 0}};
        long prev_b = half + 1;
        for (long i = m - 1; i >= 0; --i) {
            long b = abid[i];
            jac_add_small_mul(sum, running, (u64)(prev_b - b - 1), f);
            AffPt q;
            q.x = ax[i];
            q.y = ay[i];
            jac_add_mixed(running, running, q, f);
            jac_add(sum, sum, running, f);
            prev_b = b;
        }
        jac_add_small_mul(sum, running, (u64)(prev_b - 1), f);
        jac_add(total, total, sum, f);
        t_reduce += secs(tr0, now());
    }
    if (dbg) {
#ifdef PN_IFMA
        std::fprintf(stderr, "g1_msm ifma=%d\n", (int)use_ifma);
#endif
        std::fprintf(stderr,
                     "g1_msm n=%ld c=%d: dbl %.2fs sort %.2fs levels %.2fs "
                     "reduce %.2fs\n",
                     n, c, t_dbl, t_sort, t_levels, t_reduce);
    }

    // to affine
    if (is_zero_fp(total.z)) {
        std::memset(out, 0, 64);
        return;
    }
    Fp zinv, zinv2, zinv3, axx, ayy;
    mont_inv(zinv, total.z, f);
    mont_sqr(zinv2, zinv, f);
    mont_mul(zinv3, zinv2, zinv, f);
    mont_mul(axx, total.x, zinv2, f);
    mont_mul(ayy, total.y, zinv3, f);
    from_mont(axx, axx, f);
    from_mont(ayy, ayy, f);
    std::memcpy(out, axx.v, 32);
    std::memcpy(out + 4, ayy.v, 32);
}

// ===== multi-column MSM: K commit columns through one engine call =======
//
// The prover's commit wall is K independent g1_msm calls over the SAME
// base array (SRS / Lagrange powers): each call re-parses and
// re-converts every base point, re-recodes into a windows·n digit
// array, and walks cache-hostile monolithic level passes. g1_msm_multi
// restructures the whole path around what the r8 measurements actually
// showed:
//
//   - bases are parsed + Montgomery/w-domain-converted ONCE for all K
//     columns (serial: K times — ~0.35 s/column at 2^20);
//   - windows are processed LSB→MSB with on-the-fly signed recode
//     (carry byte per scalar), so no windows·n digit array is ever
//     materialized or re-streamed;
//   - the batch-affine pairing levels run per BUCKET-RANGE TILE: a
//     tile of TBUK buckets' entries stays L2-resident across ALL of
//     its levels (the monolithic pass streams the whole working set
//     once per level), with pair sums evaluated by affine_pairs_ifma
//     and compacted in place — no role scans, no merge copies, no
//     ping-pong arrays;
//   - the per-window bucket reduction runs 32 group-chains wide in
//     IFMA lanes (reduce_column_ifma) — the serial telescope is the
//     one part of Pippenger a single column cannot vectorize, and it
//     was ~25% of a 2^18 serial MSM;
//   - cross-column sharing INSIDE one window pass (i-outer/k-inner
//     placement feeding K bucket placements per base fetch, K× wider
//     inversion levels) is supported via PN_MSM_KB but measured net
//     NEGATIVE on the r8 box — the chunk·n working set costs more in
//     cache/TLB than the shared reads save — so the default sweeps
//     one column per window pass (see the KB comment in the driver).
//
// Each window's bucket total is shifted by c·w doublings before
// joining its column total. Per column the result is bit-exact with
// g1_msm (canonical affine output); g1_msm itself is left untouched as
// the committed-baseline oracle the BENCH_r08 curve is measured
// against. ``flips`` (optional, K×n bytes) negates a base's y for one
// column only — the scalar-balancing trick (_msm_signed) without K
// private copies of the base array.

#ifdef PN_IFMA

static inline void v_add_mod(Fp8 &out, const Fp8 &a, const Fp8 &b,
                             const Ctx52 &c) {
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    const __m512i zero = _mm512_setzero_si512();
    __m512i carry = zero;
    __m512i s[5];
    for (int i = 0; i < 5; ++i) {
        __m512i t = _mm512_add_epi64(_mm512_add_epi64(a.l[i], b.l[i]),
                                     carry);
        s[i] = _mm512_and_si512(t, mask);
        carry = _mm512_srli_epi64(t, 52);
    }
    // canonical operands: sum < 2p fits 5 limbs — one conditional
    // subtract lands canonical (same pattern as v_mont_mul's tail)
    __m512i borrow = zero;
    __m512i d[5];
    for (int i = 0; i < 5; ++i) {
        __m512i t = _mm512_sub_epi64(_mm512_sub_epi64(s[i], c.p[i]),
                                     borrow);
        d[i] = _mm512_and_si512(t, mask);
        borrow = _mm512_srli_epi64(t, 63);
    }
    __mmask8 ge = _mm512_cmpeq_epi64_mask(borrow, zero);
    for (int i = 0; i < 5; ++i)
        out.l[i] = _mm512_mask_blend_epi64(ge, s[i], d[i]);
}

struct Jac8 {  // 8 Jacobian points, lane-parallel, w-domain 5x52 limbs
    Fp8 x, y, z;
};

static inline __mmask8 v_is_zero5(const Fp8 &a) {
    __m512i nz = a.l[0];
    for (int i = 1; i < 5; ++i) nz = _mm512_or_si512(nz, a.l[i]);
    return _mm512_cmpeq_epi64_mask(nz, _mm512_setzero_si512());
}

static inline void v_blend5(Fp8 &dst, __mmask8 m, const Fp8 &src) {
    for (int i = 0; i < 5; ++i)
        dst.l[i] = _mm512_mask_blend_epi64(m, dst.l[i], src.l[i]);
}

static inline void lane_get5(const Fp8 &a, int l, u64 out[5]) {
    alignas(64) u64 tmp[8];
    for (int i = 0; i < 5; ++i) {
        _mm512_store_si512((void *)tmp, a.l[i]);
        out[i] = tmp[l];
    }
}

static inline void lane_set5(Fp8 &a, int l, const u64 in[5]) {
    alignas(64) u64 tmp[8];
    for (int i = 0; i < 5; ++i) {
        _mm512_store_si512((void *)tmp, a.l[i]);
        tmp[l] = in[i];
        a.l[i] = _mm512_load_si512((const void *)tmp);
    }
}

static void jac_from_lane(const Jac8 &v, int l, JacPoint &p,
                          const Ctx52 &c, const FieldCtx &f) {
    u64 t[5];
    lane_get5(v.x, l, t);
    from_w52(p.x, t, c, f);
    lane_get5(v.y, l, t);
    from_w52(p.y, t, c, f);
    lane_get5(v.z, l, t);
    from_w52(p.z, t, c, f);
}

static void jac_to_lane(Jac8 &v, int l, const JacPoint &p,
                        const Ctx52 &c, const FieldCtx &f) {
    u64 t[5];
    to_w52(t, p.x, c, f);
    lane_set5(v.x, l, t);
    to_w52(t, p.y, c, f);
    lane_set5(v.y, l, t);
    to_w52(t, p.z, c, f);
    lane_set5(v.z, l, t);
}

static inline void vgather5_mask(Fp8 &dst, const u64 *base,
                                 const __m512i idx5, __mmask8 mk) {
    for (int i = 0; i < 5; ++i)
        dst.l[i] = _mm512_mask_i64gather_epi64(
            _mm512_setzero_si512(), mk,
            _mm512_add_epi64(idx5, _mm512_set1_epi64(i)), base, 8);
}

// p[t] += q[t] (q affine, per-lane ``present`` masks) for 4 independent
// Jac8 states at once — madd-2007-bl, the vector twin of jac_add_mixed.
// Every primitive runs 4× back to back on independent chains, so the
// reduction loop is throughput-bound instead of serialized on one
// chain's v_mont_mul latency. Lanes where p is at infinity take q;
// equal-x lanes (doubling / cancel) resolve through the exact scalar
// path, so every input is handled exactly.
#define VJ4(expr) for (int t = 0; t < 4; ++t) { expr; }
static void v_jac_add_mixed4(Jac8 p[4], const Fp8 qx[4], const Fp8 qy[4],
                             const __mmask8 present[4], const Ctx52 &c52,
                             const FieldCtx &f, const Fp8 &onev) {
    __mmask8 pinf[4], gen[4], hz[4];
    Fp8 z1z1[4], u2[4], s2[4], h[4], rr[4], hh[4], i4[4], j[4], v[4],
        t0[4], x3[4], y3[4], z3[4], y1j[4], zh[4];
    VJ4(pinf[t] = (__mmask8)(v_is_zero5(p[t].z) & present[t]))
    VJ4(gen[t] = (__mmask8)(present[t] & ~pinf[t]))
    VJ4(v_mont_mul(z1z1[t], p[t].z, p[t].z, c52))
    VJ4(v_mont_mul(u2[t], qx[t], z1z1[t], c52))
    VJ4(v_mont_mul(s2[t], qy[t], p[t].z, c52))
    VJ4(v_mont_mul(s2[t], s2[t], z1z1[t], c52))
    VJ4(v_sub_mod(h[t], u2[t], p[t].x, c52))
    VJ4(v_sub_mod(rr[t], s2[t], p[t].y, c52))
    VJ4(hz[t] = (__mmask8)(v_is_zero5(h[t]) & gen[t]))
    VJ4(v_mont_mul(hh[t], h[t], h[t], c52))
    VJ4(v_add_mod(i4[t], hh[t], hh[t], c52))
    VJ4(v_add_mod(i4[t], i4[t], i4[t], c52))
    VJ4(v_mont_mul(j[t], h[t], i4[t], c52))
    VJ4(v_add_mod(rr[t], rr[t], rr[t], c52))
    VJ4(v_mont_mul(v[t], p[t].x, i4[t], c52))
    VJ4(v_mont_mul(x3[t], rr[t], rr[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], j[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], v[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], v[t], c52))
    VJ4(v_sub_mod(t0[t], v[t], x3[t], c52))
    VJ4(v_mont_mul(t0[t], t0[t], rr[t], c52))
    VJ4(v_mont_mul(y1j[t], p[t].y, j[t], c52))
    VJ4(v_add_mod(y1j[t], y1j[t], y1j[t], c52))
    VJ4(v_sub_mod(y3[t], t0[t], y1j[t], c52))
    VJ4(v_add_mod(zh[t], p[t].z, h[t], c52))
    VJ4(v_mont_mul(zh[t], zh[t], zh[t], c52))
    VJ4(v_sub_mod(zh[t], zh[t], z1z1[t], c52))
    VJ4(v_sub_mod(z3[t], zh[t], hh[t], c52))
    for (int t = 0; t < 4; ++t) {
        if (!hz[t]) continue;  // rare: exact scalar resolution per lane
        for (int l = 0; l < 8; ++l) {
            if (!((hz[t] >> l) & 1)) continue;
            JacPoint pl, res;
            jac_from_lane(p[t], l, pl, c52, f);
            AffPt q;
            u64 tt[5];
            lane_get5(qx[t], l, tt);
            from_w52(q.x, tt, c52, f);
            lane_get5(qy[t], l, tt);
            from_w52(q.y, tt, c52, f);
            jac_add_mixed(res, pl, q, f);
            Jac8 tmp;  // route through jac_to_lane on a scratch triple
            tmp.x = x3[t];
            tmp.y = y3[t];
            tmp.z = z3[t];
            jac_to_lane(tmp, l, res, c52, f);
            x3[t] = tmp.x;
            y3[t] = tmp.y;
            z3[t] = tmp.z;
        }
    }
    for (int t = 0; t < 4; ++t) {
        v_blend5(p[t].x, gen[t], x3[t]);
        v_blend5(p[t].y, gen[t], y3[t]);
        v_blend5(p[t].z, gen[t], z3[t]);
        v_blend5(p[t].x, pinf[t], qx[t]);
        v_blend5(p[t].y, pinf[t], qy[t]);
        v_blend5(p[t].z, pinf[t], onev);
    }
}

// p[t] += q[t] (both Jacobian) × 4 chains — add-2007-bl, the vector
// twin of jac_add, same 4-wide software pipelining as above. Infinity
// lanes blend (q at ∞ → p unchanged; p at ∞ → q); equal-x lanes
// resolve through the exact scalar path.
static void v_jac_add4(Jac8 p[4], const Jac8 q[4], const Ctx52 &c52,
                       const FieldCtx &f) {
    __mmask8 copy[4], gen[4], hz[4];
    Fp8 z1z1[4], z2z2[4], u1[4], u2[4], s1[4], s2[4], h[4], rr[4],
        i2[4], j[4], v[4], t0[4], x3[4], y3[4], z3[4], s1j[4], zz[4];
    for (int t = 0; t < 4; ++t) {
        __mmask8 act = (__mmask8)~v_is_zero5(q[t].z);
        __mmask8 pinf = v_is_zero5(p[t].z);
        copy[t] = (__mmask8)(act & pinf);
        gen[t] = (__mmask8)(act & ~pinf);
    }
    VJ4(v_mont_mul(z1z1[t], p[t].z, p[t].z, c52))
    VJ4(v_mont_mul(z2z2[t], q[t].z, q[t].z, c52))
    VJ4(v_mont_mul(u1[t], p[t].x, z2z2[t], c52))
    VJ4(v_mont_mul(u2[t], q[t].x, z1z1[t], c52))
    VJ4(v_mont_mul(s1[t], p[t].y, q[t].z, c52))
    VJ4(v_mont_mul(s1[t], s1[t], z2z2[t], c52))
    VJ4(v_mont_mul(s2[t], q[t].y, p[t].z, c52))
    VJ4(v_mont_mul(s2[t], s2[t], z1z1[t], c52))
    VJ4(v_sub_mod(h[t], u2[t], u1[t], c52))
    VJ4(v_sub_mod(rr[t], s2[t], s1[t], c52))
    VJ4(hz[t] = (__mmask8)(v_is_zero5(h[t]) & gen[t]))
    VJ4(v_add_mod(rr[t], rr[t], rr[t], c52))
    VJ4(v_add_mod(i2[t], h[t], h[t], c52))
    VJ4(v_mont_mul(i2[t], i2[t], i2[t], c52))
    VJ4(v_mont_mul(j[t], h[t], i2[t], c52))
    VJ4(v_mont_mul(v[t], u1[t], i2[t], c52))
    VJ4(v_mont_mul(x3[t], rr[t], rr[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], j[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], v[t], c52))
    VJ4(v_sub_mod(x3[t], x3[t], v[t], c52))
    VJ4(v_sub_mod(t0[t], v[t], x3[t], c52))
    VJ4(v_mont_mul(t0[t], t0[t], rr[t], c52))
    VJ4(v_mont_mul(s1j[t], s1[t], j[t], c52))
    VJ4(v_add_mod(s1j[t], s1j[t], s1j[t], c52))
    VJ4(v_sub_mod(y3[t], t0[t], s1j[t], c52))
    VJ4(v_add_mod(zz[t], p[t].z, q[t].z, c52))
    VJ4(v_mont_mul(zz[t], zz[t], zz[t], c52))
    VJ4(v_sub_mod(zz[t], zz[t], z1z1[t], c52))
    VJ4(v_sub_mod(zz[t], zz[t], z2z2[t], c52))
    VJ4(v_mont_mul(z3[t], zz[t], h[t], c52))
    for (int t = 0; t < 4; ++t) {
        if (!hz[t]) continue;
        for (int l = 0; l < 8; ++l) {
            if (!((hz[t] >> l) & 1)) continue;
            JacPoint pl, ql, res;
            jac_from_lane(p[t], l, pl, c52, f);
            jac_from_lane(q[t], l, ql, c52, f);
            jac_add(res, pl, ql, f);
            Jac8 tmp;
            tmp.x = x3[t];
            tmp.y = y3[t];
            tmp.z = z3[t];
            jac_to_lane(tmp, l, res, c52, f);
            x3[t] = tmp.x;
            y3[t] = tmp.y;
            z3[t] = tmp.z;
        }
    }
    for (int t = 0; t < 4; ++t) {
        v_blend5(p[t].x, gen[t], x3[t]);
        v_blend5(p[t].y, gen[t], y3[t]);
        v_blend5(p[t].z, gen[t], z3[t]);
        v_blend5(p[t].x, copy[t], q[t].x);
        v_blend5(p[t].y, copy[t], q[t].y);
        v_blend5(p[t].z, copy[t], q[t].z);
    }
}
#undef VJ4

// Batched independent affine pair sums: for each i < pairs, compute
// entry[heads[i]] + entry[heads[i]+1] into S.pox/S.poy with
// S.kind[i] ∈ {0 add, 1 doubling, 2 cancel-to-∞} — the batch-affine
// primitive (dual den chains, one inversion per 4096-pair batch) with
// the pairing and merge left to the caller. The multi-column kernel
// drives this per bucket-range tile so a tile's entries stay
// L2-resident across ALL its levels, where the monolithic
// level_pass_ifma above (g1_msm's committed serial path, and the
// oracle the multi kernel is measured against) re-streams the whole
// working set once per level. Exact: per-pair dinv is exactly 1/den
// regardless of batch grouping.
static void affine_pairs_ifma(const FieldCtx &f, const Ctx52 &c52,
                              const u64 *ax52, const u64 *ay52,
                              long pairs, IfmaScratch &S) {
    const long TILE = 4096;
    std::vector<long> &heads = S.heads;
    std::vector<Fp8> &prefv = S.prefv, &denv = S.denv, &axv = S.axv,
                     &ayv = S.ayv, &bxv = S.bxv, &byv = S.byv;
    std::vector<unsigned char> &kind = S.kind;
    std::memset(kind.data(), 0, pairs);
    u64 one52[5];
    fp_to52(c52.c_in, one52);
    const __m512i vzero = _mm512_setzero_si512();
    std::vector<u64> &pox = S.pox, &poy = S.poy;

    for (long tp0 = 0; tp0 < pairs; tp0 += TILE) {
        const long tpairs = (TILE < pairs - tp0) ? TILE : pairs - tp0;
        const long nblk = (tpairs + 7) / 8;
        Fp8 run[2];
        for (int ch = 0; ch < 2; ++ch)
            for (int i = 0; i < 5; ++i)
                run[ch].l[i] = _mm512_set1_epi64((long long)one52[i]);

        // pass 1 (tile): gather head/tail coords, den = xB − xA,
        // per-lane chains; saved state indexed tile-locally
        for (long b = 0; b < nblk; ++b) {
            const long p0 = tp0 + 8 * b;
            int cnt = (int)((8 > tpairs - 8 * b) ? tpairs - 8 * b : 8);
            alignas(64) long long hoff[8];
            for (int l = 0; l < 8; ++l) {
                long h = (l < cnt) ? heads[p0 + l] : heads[p0];
                hoff[l] = 5 * h;
            }
            const __m512i hv = _mm512_load_si512((const void *)hoff);
            const __m512i tv = _mm512_add_epi64(hv, _mm512_set1_epi64(5));
            Fp8 Ax, Ay, Bx, By, den;
            vgather5(Ax, ax52, hv);
            vgather5(Ay, ay52, hv);
            vgather5(Bx, ax52, tv);
            vgather5(By, ay52, tv);
            v_sub_mod(den, Bx, Ax, c52);
            __m512i nz = den.l[0];
            for (int i = 1; i < 5; ++i) nz = _mm512_or_si512(nz, den.l[i]);
            __mmask8 zl = _mm512_cmpeq_epi64_mask(nz, vzero);
            if (cnt < 8) zl = (__mmask8)(zl | (0xFF << cnt));
            if (zl) {
                u64 dl[5][8], ayl[5][8], byl[5][8];
                for (int i = 0; i < 5; ++i) {
                    _mm512_storeu_si512((void *)dl[i], den.l[i]);
                    _mm512_storeu_si512((void *)ayl[i], Ay.l[i]);
                    _mm512_storeu_si512((void *)byl[i], By.l[i]);
                }
                for (int l = 0; l < 8; ++l) {
                    if (!((zl >> l) & 1)) continue;
                    u64 t[5];
                    if (l >= cnt) {
                        std::memcpy(t, one52, 40);
                    } else {
                        Fp aY, bY, sy;
                        u64 a5[5] = {ayl[0][l], ayl[1][l], ayl[2][l],
                                     ayl[3][l], ayl[4][l]};
                        u64 b5[5] = {byl[0][l], byl[1][l], byl[2][l],
                                     byl[3][l], byl[4][l]};
                        fp_from52(a5, aY);
                        fp_from52(b5, bY);
                        add_mod(sy, aY, bY, f);
                        if (is_zero_fp(sy)) {
                            kind[p0 + l] = 2;
                            std::memcpy(t, one52, 40);
                        } else {
                            kind[p0 + l] = 1;
                            Fp dd;
                            add_mod(dd, aY, aY, f);
                            fp_to52(dd, t);
                        }
                    }
                    for (int i = 0; i < 5; ++i) dl[i][l] = t[i];
                }
                v_load_lanes(den, dl);
            }
            const int ch = (int)(b & 1);
            prefv[b] = run[ch];
            denv[b] = den;
            axv[b] = Ax;
            ayv[b] = Ay;
            bxv[b] = Bx;
            byv[b] = By;
            v_mont_mul(run[ch], run[ch], den, c52);
        }

        // tile inversion: both chains' lane totals → ONE mont_inv
        Fp8 inv_vec[2];
        {
            Fp lane_tot[16], pre[16], inv_lane[16];
            u64 lanes[2][5][8];
            for (int ch = 0; ch < 2; ++ch)
                for (int i = 0; i < 5; ++i)
                    _mm512_storeu_si512((void *)lanes[ch][i],
                                        run[ch].l[i]);
            for (int jj = 0; jj < 16; ++jj) {
                int ch = jj >> 3, l = jj & 7;
                u64 t[5] = {lanes[ch][0][l], lanes[ch][1][l],
                            lanes[ch][2][l], lanes[ch][3][l],
                            lanes[ch][4][l]};
                from_w52(lane_tot[jj], t, c52, f);
            }
            Fp acc = f.one;
            for (int jj = 0; jj < 16; ++jj) {
                pre[jj] = acc;
                mont_mul(acc, acc, lane_tot[jj], f);
            }
            Fp tinv;
            mont_inv(tinv, acc, f);
            for (int jj = 15; jj >= 0; --jj) {
                mont_mul(inv_lane[jj], tinv, pre[jj], f);
                mont_mul(tinv, tinv, lane_tot[jj], f);
            }
            u64 t[5];
            for (int jj = 0; jj < 16; ++jj) {
                int ch = jj >> 3, l = jj & 7;
                to_w52(t, inv_lane[jj], c52, f);
                for (int i = 0; i < 5; ++i) lanes[ch][i][l] = t[i];
            }
            for (int ch = 0; ch < 2; ++ch)
                v_load_lanes(inv_vec[ch], lanes[ch]);
        }

        // pass 2 (tile, backward): unwind chains, evaluate the adds
        for (long b = nblk - 1; b >= 0; --b) {
            const long p0 = tp0 + 8 * b;
            int cnt = (int)((8 > tpairs - 8 * b) ? tpairs - 8 * b : 8);
            const int ch = (int)(b & 1);
            Fp8 dinv, num;
            v_mont_mul(dinv, inv_vec[ch], prefv[b], c52);
            v_mont_mul(inv_vec[ch], inv_vec[ch], denv[b], c52);
            const Fp8 &Ax = axv[b], &Ay = ayv[b];
            const Fp8 &Bx = bxv[b], &By = byv[b];
            v_sub_mod(num, By, Ay, c52);
            bool patch = false;
            for (int l = 0; l < cnt; ++l)
                if (kind[p0 + l] == 1) patch = true;
            if (patch) {
                u64 lanes[5][8], axl[5][8];
                for (int i = 0; i < 5; ++i) {
                    _mm512_storeu_si512((void *)lanes[i], num.l[i]);
                    _mm512_storeu_si512((void *)axl[i], Ax.l[i]);
                }
                for (int l = 0; l < cnt; ++l) {
                    if (kind[p0 + l] != 1) continue;
                    u64 a5[5] = {axl[0][l], axl[1][l], axl[2][l],
                                 axl[3][l], axl[4][l]};
                    Fp aX, sq, n3;
                    fp_from52(a5, aX);
                    mont_sqr(sq, aX, f);
                    mont_mul(sq, sq, c52.c_out, f);
                    add_mod(n3, sq, sq, f);
                    add_mod(n3, n3, sq, f);
                    u64 t[5];
                    fp_to52(n3, t);
                    for (int i = 0; i < 5; ++i) lanes[i][l] = t[i];
                }
                v_load_lanes(num, lanes);
            }
            Fp8 lam, x3, y3, t0;
            v_mont_mul(lam, num, dinv, c52);
            v_mont_mul(x3, lam, lam, c52);
            v_sub_mod(x3, x3, Ax, c52);
            v_sub_mod(x3, x3, Bx, c52);
            v_sub_mod(t0, Ax, x3, c52);
            v_mont_mul(y3, lam, t0, c52);
            v_sub_mod(y3, y3, Ay, c52);
            alignas(64) long long ooff[8];
            for (int l = 0; l < 8; ++l)
                ooff[l] = 5 * (p0 + ((l < cnt) ? l : cnt - 1));
            const __m512i ov = _mm512_load_si512((const void *)ooff);
            __mmask8 live = (__mmask8)((1u << cnt) - 1);
            for (int i = 0; i < 5; ++i) {
                _mm512_mask_i64scatter_epi64(
                    pox.data(), live,
                    _mm512_add_epi64(ov, _mm512_set1_epi64(i)), x3.l[i],
                    8);
                _mm512_mask_i64scatter_epi64(
                    poy.data(), live,
                    _mm512_add_epi64(ov, _mm512_set1_epi64(i)), y3.l[i],
                    8);
            }
        }
    }

}

// Bucket-weighted suffix telescope of ONE column's window, 32 groups
// wide (8 IFMA lanes × 4 software-pipelined chain blocks): the
// column's ``half`` buckets split into 32 contiguous groups whose
// local telescopes (run += S_j; tot += run) are independent chains —
// the parallelism a single serial Pippenger reduction cannot expose.
// 8 lanes alone leave the loop bound on one chain's v_mont_mul
// LATENCY; 4 chain blocks per step keep the multipliers fed. D is the
// dense per-bucket sum array (10 u64 per bucket: x | y, w-domain),
// ``bitmap`` its occupancy. Result (s-domain Jacobian) = Σ_b b·S_b.
static void reduce_column_ifma(const FieldCtx &f, const Ctx52 &c52,
                               const u64 *D, const u64 *bitmap,
                               long half, JacPoint &out_sum) {
    const long G = half / 32;
    Jac8 run[4], tot[4];
    const __m512i zero = _mm512_setzero_si512();
    for (int t = 0; t < 4; ++t)
        for (int i = 0; i < 5; ++i) {
            run[t].x.l[i] = run[t].y.l[i] = run[t].z.l[i] = zero;
            tot[t].x.l[i] = tot[t].y.l[i] = tot[t].z.l[i] = zero;
        }
    u64 one52[5];
    fp_to52(c52.c_in, one52);
    Fp8 onev;
    for (int i = 0; i < 5; ++i)
        onev.l[i] = _mm512_set1_epi64((long long)one52[i]);
    for (long j = G; j >= 1; --j) {
        __mmask8 present[4];
        Fp8 sx[4], sy[4];
        for (int t = 0; t < 4; ++t) {
            alignas(64) long long off[8];
            __mmask8 pm = 0;
            for (int g = 0; g < 8; ++g) {
                long b = (long)(t * 8 + g) * G + j;
                if (bitmap[b >> 6] & (1ULL << (b & 63)))
                    pm = (__mmask8)(pm | (1u << g));
                off[g] = 10 * b;
            }
            present[t] = pm;
            const __m512i ov = _mm512_load_si512((const void *)off);
            vgather5_mask(sx[t], D, ov, pm);
            vgather5_mask(sy[t], D + 5, ov, pm);
        }
        v_jac_add_mixed4(run, sx, sy, present, c52, f, onev);
        v_jac_add4(tot, run, c52, f);
    }
    out_sum.z = Fp{{0, 0, 0, 0}};
    for (int t = 0; t < 4; ++t)
        for (int g = 0; g < 8; ++g) {
            JacPoint tt, r;
            jac_from_lane(tot[t], g, tt, c52, f);
            jac_from_lane(run[t], g, r, c52, f);
            jac_add(out_sum, out_sum, tt, f);
            jac_add_small_mul(out_sum, r, (u64)((long)(t * 8 + g) * G),
                              f);
        }
}

// Sparse form of the telescope: walk only the OCCUPIED buckets (bitmap
// scan, descending) with the gap-skipping serial chain — cheaper than
// G masked vector steps when a window populated few buckets (small
// columns, 0/1 selector columns).
static void reduce_column_sparse_ifma(const FieldCtx &f, const Ctx52 &c52,
                                      const u64 *D, const u64 *bitmap,
                                      long half, JacPoint &out_sum) {
    JacPoint running;
    running.z = Fp{{0, 0, 0, 0}};
    out_sum.z = Fp{{0, 0, 0, 0}};
    long prev_b = half + 1;
    for (long wq = half >> 6; wq >= 0; --wq) {
        u64 bits = bitmap[wq];
        while (bits) {
            int hi = 63 - __builtin_clzll(bits);
            bits &= ~(1ULL << hi);
            long b = (wq << 6) + hi;
            jac_add_small_mul(out_sum, running, (u64)(prev_b - b - 1), f);
            AffPt q;
            from_w52(q.x, &D[10 * b], c52, f);
            from_w52(q.y, &D[10 * b + 5], c52, f);
            jac_add_mixed(running, running, q, f);
            jac_add(out_sum, out_sum, running, f);
            prev_b = b;
        }
    }
    jac_add_small_mul(out_sum, running, (u64)(prev_b - 1), f);
}
#endif  // PN_IFMA

void g1_msm_multi(const u64 *mod_limbs, const u64 *bases,
                  const u64 *scalars, const unsigned char *flips,
                  long n, long K, u64 *out) {
    FieldCtx f = make_ctx(mod_limbs);
    if (n <= 0 || K <= 0) {
        if (K > 0) std::memset(out, 0, 64 * (size_t)K);
        return;
    }
#ifdef PN_IFMA
    const bool use_ifma = !std::getenv("PN_NO_IFMA") && ifma_available() &&
                          v_mul_selftest(f);
    Ctx52 c52;
    if (use_ifma) c52 = make_ctx52(f);
#endif
    int c = 4;
    if (n > 32) c = 8;
    if (n > 1024) c = 12;
    if (n > 131072) c = 15;  // g1_msm's ladder (the r4 grid)
    if (n > 600000) c = 16;  // the tiled levels + 32-chain vector
                             // reduce move the multi optimum UP at
                             // 2^20 (r8 grid on the IFMA box);
                             // PN_MSM_C_MULTI / PN_MSM_C override
    if (const char *cenv = std::getenv("PN_MSM_C_MULTI")) {
        int cv = std::atoi(cenv);
        if (cv >= 2 && cv <= 20) c = cv;
    } else if (const char *cenv = std::getenv("PN_MSM_C")) {
        int cv = std::atoi(cenv);
        if (cv >= 2 && cv <= 20) c = cv;
    }
    const long half = 1L << (c - 1);
    const int windows = (256 + c - 1) / c + 1;

    std::vector<AffPt> pts(n);
    std::vector<unsigned char> finite(n);
    long n_finite = 0;
    for (long i = 0; i < n; ++i) {
        Fp x, y;
        std::memcpy(x.v, bases + 8 * i, 32);
        std::memcpy(y.v, bases + 8 * i + 4, 32);
        bool inf = is_zero_fp(x) && is_zero_fp(y);
        finite[i] = !inf;
        if (!inf) {
            to_mont(pts[i].x, x, f);
            to_mont(pts[i].y, y, f);
            ++n_finite;
        }
    }
    std::vector<JacPoint> totals(K);
    for (long k = 0; k < K; ++k) totals[k].z = Fp{{0, 0, 0, 0}};
    if (!n_finite) {
        std::memset(out, 0, 64 * (size_t)K);
        return;
    }

    const bool dbg = std::getenv("PN_MSM_DEBUG") != nullptr;
    long dbg_vec_cols = 0, dbg_scal_cols = 0;
    double t_conv = 0, t_sort = 0, t_levels = 0, t_reduce = 0;
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto secs = [](auto a, auto b) {
        return std::chrono::duration<double>(b - a).count();
    };
    auto tc0 = now();

#ifdef PN_IFMA
    // shared per-point table, converted ONCE for all K columns:
    // 15 w-domain limbs per point — x | y | −y (signed digits and
    // per-column flips both index the negated copy)
    std::unique_ptr<u64[]> p15;
    if (use_ifma) {
        p15.reset(new u64[15 * (size_t)n]);
        for (long i = 0; i < n; ++i) {
            if (!finite[i]) continue;
            to_w52(&p15[15 * (size_t)i], pts[i].x, c52, f);
            to_w52(&p15[15 * (size_t)i + 5], pts[i].y, c52, f);
            Fp yn;
            neg_mod(yn, pts[i].y, f);
            to_w52(&p15[15 * (size_t)i + 10], yn, c52, f);
        }
    }
#endif
    t_conv += secs(tc0, now());

    // columns are processed in chunks of KB — the window pass (recode,
    // counting sort, levels) is shared WITHIN a chunk, while the base
    // parse + w-domain conversion are amortized over ALL K columns.
    // Measured on the r8 IFMA box, the cross-column sharing inside a
    // window pass is NET NEGATIVE: the chunk·n working set's cache/TLB
    // cost exceeds the shared-read win at every size tried (2^20 K=4
    // aggregate: 1.59x at KB=1 vs 1.55x/1.52x at KB=2/4; K=8
    // monolithic was 1.38x), so the default processes one column per
    // window sweep and the K-column win comes from the shared
    // conversions + the tiled levels + the vector reduce. PN_MSM_KB
    // re-enables wider sharing for boxes where the balance differs.
    long KB = 1;
    if (const char *kbenv = std::getenv("PN_MSM_KB")) {
        long kv = std::atol(kbenv);
        if (kv >= 1 && kv <= 64) KB = kv;
    }
    if (KB > K) KB = K;
    const size_t mcap = (size_t)n_finite * (size_t)KB;
    std::unique_ptr<int32_t[]> abid_own, nbid_own;
    int32_t *abid = nullptr, *nbid = nullptr;
#ifdef PN_IFMA
    std::unique_ptr<u64[]> x52_own, y52_own;
    u64 *x52 = nullptr, *y52 = nullptr;
    std::unique_ptr<u64[]> Dbuf, Dbitmap;
    IfmaScratch ifma_scratch;
    const bool vec_reduce_ok = use_ifma && half >= 256 &&
                               (half % 32) == 0;
    std::unique_ptr<long[]> bstart;
    if (use_ifma) {
        x52_own.reset(new u64[5 * mcap]);
        y52_own.reset(new u64[5 * mcap]);
        x52 = x52_own.get();
        y52 = y52_own.get();
        Dbuf.reset(new u64[10 * (size_t)(half + 1)]);
        Dbitmap.reset(new u64[(size_t)(half >> 6) + 2]);
        bstart.reset(new long[(size_t)KB * half + 2]);
    }
#endif
    // Fp working set, allocated only when a scalar level/tail runs
    std::unique_ptr<Fp[]> ax_own, ay_own, nx_own, ny_own;
    Fp *ax = nullptr, *ay = nullptr, *nxp = nullptr, *nyp = nullptr;
    auto ensure_fp = [&]() {
        if (!ax_own) {
            ax_own.reset(new Fp[mcap]);
            ay_own.reset(new Fp[mcap]);
            nx_own.reset(new Fp[mcap]);
            ny_own.reset(new Fp[mcap]);
            ax = ax_own.get();
            ay = ay_own.get();
            nxp = nx_own.get();
            nyp = ny_own.get();
        }
    };
    bool scalar_path = true;
#ifdef PN_IFMA
    scalar_path = !use_ifma;
#endif
    std::vector<unsigned char> role;
    std::vector<Fp> dens, prefix;
    if (scalar_path) {  // the Fp pairing-level machinery
        ensure_fp();
        abid_own.reset(new int32_t[mcap]);
        nbid_own.reset(new int32_t[mcap]);
        abid = abid_own.get();
        nbid = nbid_own.get();
        role.resize(mcap);
        dens.reserve(mcap / 2 + 1);
        prefix.reserve(mcap / 2 + 1);
    }

    std::vector<long> counts((size_t)KB * half + 1);
    std::vector<unsigned char> carry((size_t)KB * n);
    std::unique_ptr<int32_t[]> dcur(new int32_t[(size_t)KB * n]);

    // windows ascend (the on-the-fly recode's carries flow LSB→MSB);
    // each window total joins its column shifted by c·w doublings —
    // a few thousand doublings per call, noise next to the levels
    for (long k0 = 0; k0 < K; k0 += KB) {
    const long Kc = (KB < K - k0) ? KB : K - k0;
    std::memset(carry.data(), 0, (size_t)Kc * n);
    for (int w = 0; w < windows; ++w) {
        auto ts0 = now();
        std::fill(counts.begin(), counts.end(), 0);
        long m = 0;
        const long bit0 = (long)w * c;
        for (long k = 0; k < Kc; ++k) {
            const u64 *sc = scalars + 4 * (size_t)n * (k0 + k);
            unsigned char *cy = &carry[(size_t)k * n];
            int32_t *dk = &dcur[(size_t)k * n];
            for (long i = 0; i < n; ++i) {
                if (!finite[i]) {
                    dk[i] = 0;
                    continue;
                }
                u64 raw = 0;
                if (bit0 < 256) {
                    int word = (int)(bit0 / 64), off = (int)(bit0 % 64);
                    raw = sc[4 * i + word] >> off;
                    if (off && word + 1 < 4)
                        raw |= sc[4 * i + word + 1] << (64 - off);
                    raw &= ((u64)1 << c) - 1;
                }
                raw += cy[i];
                int32_t d;
                if (raw > (u64)half) {
                    d = (int32_t)raw - (int32_t)(1L << c);
                    cy[i] = 1;
                } else {
                    d = (int32_t)raw;
                    cy[i] = 0;
                }
                dk[i] = d;
                if (d) {
                    ++counts[(size_t)k * half + (d < 0 ? -d : d)];
                    ++m;
                }
            }
        }
        if (!m) continue;
        long acc_off = 0;
        for (long b = 1; b <= (long)Kc * half; ++b) {
            long cnt = counts[b];
            counts[b] = acc_off;
            acc_off += cnt;
        }
#ifdef PN_IFMA
        if (use_ifma) {
            // bucket start offsets (pre-placement prefix) + sentinel —
            // the tiled levels and the dense reduce read ranges from
            // here instead of carrying a per-entry bucket-id array
            std::memcpy(bstart.get(), counts.data(),
                        sizeof(long) * ((size_t)Kc * half + 1));
            bstart[(size_t)Kc * half + 1] = m;
        }
#endif
        // placement, i-outer / k-inner: ONE walk of the shared base
        // table covers all K columns' bucket placements — point i's
        // coordinates are read once and feed up to K placements while
        // they sit in L1 (the amortized gather; serial calls re-stream
        // the whole table once per column per window).
        for (long i = 0; i < n; ++i) {
            if (!finite[i]) continue;
#ifdef PN_IFMA
            const u64 *src = use_ifma ? &p15[15 * (size_t)i] : nullptr;
#endif
            for (long k = 0; k < Kc; ++k) {
                int32_t d = dcur[(size_t)k * n + i];
                if (!d) continue;
                long b = d < 0 ? -d : d;
                long pos = counts[(size_t)k * half + b]++;
                int neg = d < 0;
                if (flips && flips[(size_t)(k0 + k) * n + i]) neg ^= 1;
#ifdef PN_IFMA
                if (use_ifma) {
                    std::memcpy(&x52[5 * (size_t)pos], src, 40);
                    std::memcpy(&y52[5 * (size_t)pos],
                                src + 5 + 5 * neg, 40);
                    continue;
                }
#endif
                abid[pos] = (int32_t)((size_t)k * half + b);
                ax[pos] = pts[i].x;
                if (neg) neg_mod(ay[pos], pts[i].y, f);
                else ay[pos] = pts[i].y;
            }
        }
        t_sort += secs(ts0, now());

#ifdef PN_IFMA
        if (use_ifma) {
            // Per-column bucket-range-tiled levels: a tile of TB
            // buckets' entries (~TB·avg-count rows, ~1-2 MB dense)
            // stays cache-resident across ALL of its pairing levels —
            // a monolithic level pass re-streams the whole K·n
            // working set once per level instead. Survivors drop
            // straight into the dense per-bucket array D that feeds
            // the 32-group vector telescope; no per-entry bucket-id
            // array, no merge pass, no ping-pong copies.
            const long TB = 256;
            std::vector<long> bloc(TB), bcnt(TB);
            u64 *D = Dbuf.get();
            for (long k = 0; k < Kc; ++k) {
                auto tl0 = now();
                const size_t kbase = (size_t)k * half;
                std::memset(Dbitmap.get(), 0,
                            8 * ((size_t)(half >> 6) + 2));
                long occ = 0;
                for (long tb0 = 0; tb0 < half; tb0 += TB) {
                    const long nb = (TB < half - tb0) ? TB : half - tb0;
                    const long tstart = bstart[kbase + tb0 + 1];
                    const long tend = bstart[kbase + tb0 + nb + 1];
                    if (tend == tstart) continue;
                    for (long t = 0; t < nb; ++t) {
                        bloc[t] = bstart[kbase + tb0 + t + 1];
                        bcnt[t] = bstart[kbase + tb0 + t + 2] - bloc[t];
                    }
                    ifma_scratch.ensure((tend - tstart) / 2 + 8);
                    while (true) {
                        long pairs = 0;
                        for (long t = 0; t < nb; ++t) {
                            long pb = bcnt[t] >> 1;
                            for (long j2 = 0; j2 < pb; ++j2)
                                ifma_scratch.heads[pairs + j2] =
                                    bloc[t] + 2 * j2;
                            pairs += pb;
                        }
                        if (!pairs) break;
                        affine_pairs_ifma(f, c52, x52, y52, pairs,
                                          ifma_scratch);
                        // bucket-aware in-place compaction: survivors
                        // (pair sums + odd tails) pack forward; writes
                        // never pass reads (survivors ≤ entries)
                        long pi = 0, wr = bloc[0];
                        for (long t = 0; t < nb; ++t) {
                            const long cnt = bcnt[t], pb = cnt >> 1;
                            const long ns = wr;
                            for (long j2 = 0; j2 < pb; ++j2, ++pi) {
                                if (ifma_scratch.kind[pi] == 2)
                                    continue;
                                std::memcpy(&x52[5 * wr],
                                            &ifma_scratch.pox[5 * pi],
                                            40);
                                std::memcpy(&y52[5 * wr],
                                            &ifma_scratch.poy[5 * pi],
                                            40);
                                ++wr;
                            }
                            if (cnt & 1) {
                                long src2 = bloc[t] + cnt - 1;
                                if (src2 != wr) {
                                    std::memcpy(&x52[5 * wr],
                                                &x52[5 * src2], 40);
                                    std::memcpy(&y52[5 * wr],
                                                &y52[5 * src2], 40);
                                }
                                ++wr;
                            }
                            bloc[t] = ns;
                            bcnt[t] = wr - ns;
                        }
                    }
                    for (long t = 0; t < nb; ++t) {
                        if (!bcnt[t]) continue;
                        long b = tb0 + t + 1;
                        std::memcpy(&D[10 * b], &x52[5 * bloc[t]], 40);
                        std::memcpy(&D[10 * b + 5], &y52[5 * bloc[t]],
                                    40);
                        Dbitmap[b >> 6] |= 1ULL << (b & 63);
                        ++occ;
                    }
                }
                t_levels += secs(tl0, now());
                auto tr0 = now();
                if (occ) {
                    JacPoint sum;
                    if (vec_reduce_ok && occ * 4 >= half) {
                        reduce_column_ifma(f, c52, D, Dbitmap.get(),
                                           half, sum);
                        if (dbg) ++dbg_vec_cols;
                    } else {
                        reduce_column_sparse_ifma(f, c52, D,
                                                  Dbitmap.get(), half,
                                                  sum);
                        if (dbg) ++dbg_scal_cols;
                    }
                    if (!is_zero_fp(sum.z)) {
                        // shift into place: window w weighs 2^{c·w}
                        for (long d2 = 0; d2 < (long)c * w; ++d2)
                            jac_double(sum, sum, f);
                        jac_add(totals[k0 + k], totals[k0 + k], sum, f);
                    }
                }
                t_reduce += secs(tr0, now());
            }
            continue;  // next window
        }
#endif

        auto tl0 = now();
        // scalar fallback (no IFMA): level-by-level batch-affine
        // segment sums over ALL K columns at once (bucket keys are
        // column-disjoint, so segments never cross columns and one
        // inversion serves K columns' pairs)
        while (true) {
            long pairs = 0;
            for (long i = 0; i < m;) {
                if (i + 1 < m && abid[i + 1] == abid[i]) {
                    role[i] = 1;
                    role[i + 1] = 2;
                    ++pairs;
                    i += 2;
                } else {
                    role[i] = 0;
                    ++i;
                }
            }
            if (!pairs) break;
            dens.clear();
            prefix.clear();
            Fp run = f.one;
            std::vector<unsigned char> kind;
            kind.reserve(pairs);
            for (long i = 0; i < m; ++i) {
                if (role[i] != 1) continue;
                Fp d;
                sub_mod(d, ax[i + 1], ax[i], f);
                if (is_zero_fp(d)) {
                    Fp sy;
                    add_mod(sy, ay[i], ay[i + 1], f);
                    if (is_zero_fp(sy)) {
                        kind.push_back(2);
                        d = f.one;
                    } else {
                        kind.push_back(1);
                        add_mod(d, ay[i], ay[i], f);
                    }
                } else kind.push_back(0);
                dens.push_back(d);
                prefix.push_back(run);
                mont_mul(run, run, d, f);
            }
            Fp inv;
            mont_inv(inv, run, f);
            long n_out = m - pairs;
            for (long pi = 0; pi < pairs; ++pi)
                if (kind[pi] == 2) --n_out;
            long write = n_out;
            long pi = pairs - 1;
            for (long i = m - 1; i >= 0; --i) {
                if (role[i] == 2) continue;
                if (role[i] == 1) {
                    Fp dinv;
                    mont_mul(dinv, inv, prefix[pi], f);
                    mont_mul(inv, inv, dens[pi], f);
                    if (kind[pi] != 2) {
                        long a = i, b = i + 1;
                        Fp lam, num, x3, y3;
                        if (kind[pi] == 1) {
                            mont_sqr(num, ax[a], f);
                            Fp n3;
                            add_mod(n3, num, num, f);
                            add_mod(num, n3, num, f);
                        } else {
                            sub_mod(num, ay[b], ay[a], f);
                        }
                        mont_mul(lam, num, dinv, f);
                        mont_sqr(x3, lam, f);
                        sub_mod(x3, x3, ax[a], f);
                        sub_mod(x3, x3, ax[b], f);
                        sub_mod(y3, ax[a], x3, f);
                        mont_mul(y3, y3, lam, f);
                        sub_mod(y3, y3, ay[a], f);
                        --write;
                        nxp[write] = x3;
                        nyp[write] = y3;
                        nbid[write] = abid[i];
                    }
                    --pi;
                } else {
                    --write;
                    nxp[write] = ax[i];
                    nyp[write] = ay[i];
                    nbid[write] = abid[i];
                }
            }
            m = n_out;
            std::swap(ax, nxp);
            std::swap(ay, nyp);
            std::swap(abid, nbid);
        }
        t_levels += secs(tl0, now());

        auto tr0 = now();
        // per-column bucket reduction (scalar path): survivors sit
        // ascending by (column, bucket); walk columns from the top
        // with the gap-skipping serial telescope.
        long i_top = m - 1;
        for (long k = Kc - 1; k >= 0; --k) {
            const long base = k * half;
            long lo = i_top;
            while (lo >= 0 && abid[lo] > base) --lo;
            // column k's survivors are (lo, i_top]
            if (lo == i_top) continue;
            JacPoint sum;
            sum.z = Fp{{0, 0, 0, 0}};
            JacPoint running;
            running.z = Fp{{0, 0, 0, 0}};
            long prev_b = half + 1;
            for (long i = i_top; i > lo; --i) {
                long b = abid[i] - base;
                jac_add_small_mul(sum, running, (u64)(prev_b - b - 1),
                                  f);
                AffPt q;
                q.x = ax[i];
                q.y = ay[i];
                jac_add_mixed(running, running, q, f);
                jac_add(sum, sum, running, f);
                prev_b = b;
            }
            jac_add_small_mul(sum, running, (u64)(prev_b - 1), f);
            if (dbg) ++dbg_scal_cols;
            if (!is_zero_fp(sum.z)) {
                // shift into place: window w weighs 2^{c·w}
                for (long d = 0; d < (long)c * w; ++d)
                    jac_double(sum, sum, f);
                jac_add(totals[k0 + k], totals[k0 + k], sum, f);
            }
            i_top = lo;
        }
        t_reduce += secs(tr0, now());
    }
    }  // column chunk

    if (dbg) {
#ifdef PN_IFMA
        std::fprintf(stderr, "g1_msm_multi ifma=%d\n", (int)use_ifma);
#endif
        std::fprintf(stderr,
                     "g1_msm_multi n=%ld K=%ld c=%d: conv %.2fs sort "
                     "%.2fs levels %.2fs reduce %.2fs\n",
                     n, K, c, t_conv, t_sort, t_levels, t_reduce);
        std::fprintf(stderr,
                     "g1_msm_multi reduce: vec_cols=%ld scal_cols=%ld\n",
                     dbg_vec_cols, dbg_scal_cols);
    }

    for (long k = 0; k < K; ++k) {
        u64 *ok = out + 8 * (size_t)k;
        if (is_zero_fp(totals[k].z)) {
            std::memset(ok, 0, 64);
            continue;
        }
        Fp zinv, zinv2, zinv3, axx, ayy;
        mont_inv(zinv, totals[k].z, f);
        mont_sqr(zinv2, zinv, f);
        mont_mul(zinv3, zinv2, zinv, f);
        mont_mul(axx, totals[k].x, zinv2, f);
        mont_mul(ayy, totals[k].y, zinv3, f);
        from_mont(axx, axx, f);
        from_mont(ayy, ayy, f);
        std::memcpy(ok, axx.v, 32);
        std::memcpy(ok + 4, ayy.v, 32);
    }
}

// Many scalar multiples of ONE fixed affine base: out[i] = scalars[i]·B.
// 8-bit window table (32 windows x 256 entries), then one batched
// Jacobian->affine normalization. Powers the SRS ("powers of tau") setup,
// where n independent muls of G1 would otherwise dominate.
//
// Unlike the reference's copy, the muls and their normalization run on
// all cores: each thread takes a contiguous range of the outputs and
// normalizes it with its own batched inversion. Affine coordinates are
// unique, so the output is the same bytes whatever the split.
static void fixed_base_range(const JacPoint *table, const u64 *scalars,
                             long lo, long hi, u64 *out,
                             const FieldCtx &f) {
    const int C = 8, WINDOWS = 32, TABLE = 1 << C;
    const long m = hi - lo;
    if (m <= 0) return;
    std::vector<JacPoint> res(m);
    for (long i = lo; i < hi; ++i) {
        JacPoint acc;
        acc.z = Fp{{0, 0, 0, 0}};
        for (int w = 0; w < WINDOWS; ++w) {
            u64 word = scalars[4 * i + w / 8];
            u64 idx = (word >> ((w % 8) * 8)) & 0xff;
            if (idx) jac_add(acc, acc, table[(size_t)w * TABLE + idx], f);
        }
        res[i - lo] = acc;
    }

    // batched normalization: invert all z^1 of the range at once
    std::vector<Fp> zs(m), prefix(m);
    Fp acc = f.one;
    for (long i = 0; i < m; ++i) {
        zs[i] = is_zero_fp(res[i].z) ? f.one : res[i].z;
        prefix[i] = acc;
        mont_mul(acc, acc, zs[i], f);
    }
    Fp inv;
    mont_inv(inv, acc, f);
    for (long i = m - 1; i >= 0; --i) {
        Fp zi;
        mont_mul(zi, inv, prefix[i], f);
        mont_mul(inv, inv, zs[i], f);
        u64 *o = out + 8 * (lo + i);
        if (is_zero_fp(res[i].z)) {
            std::memset(o, 0, 64);
            continue;
        }
        Fp z2, z3, ax, ay;
        mont_sqr(z2, zi, f);
        mont_mul(z3, z2, zi, f);
        mont_mul(ax, res[i].x, z2, f);
        mont_mul(ay, res[i].y, z3, f);
        from_mont(ax, ax, f);
        from_mont(ay, ay, f);
        std::memcpy(o, ax.v, 32);
        std::memcpy(o + 4, ay.v, 32);
    }
}

void g1_fixed_base_muls(const u64 *mod_limbs, const u64 *base_aff,
                        const u64 *scalars, long n, u64 *out) {
    FieldCtx f = make_ctx(mod_limbs);
    JacPoint base;
    std::memcpy(base.x.v, base_aff, 32);
    std::memcpy(base.y.v, base_aff + 4, 32);
    to_mont(base.x, base.x, f);
    to_mont(base.y, base.y, f);
    base.z = f.one;

    const int C = 8, WINDOWS = 32, TABLE = 1 << C;
    // table[w][j] = j * 2^{8w} * B
    std::vector<JacPoint> table((size_t)WINDOWS * TABLE);
    JacPoint win_base = base;
    for (int w = 0; w < WINDOWS; ++w) {
        JacPoint *row = &table[(size_t)w * TABLE];
        row[0].z = Fp{{0, 0, 0, 0}};
        row[1] = win_base;
        for (int j = 2; j < TABLE; ++j) jac_add(row[j], row[j - 1], win_base, f);
        if (w + 1 < WINDOWS) {
            jac_add(win_base, row[TABLE - 1], win_base, f);  // 2^{8(w+1)} B
        }
    }

    // one range per core, none below 4,096 muls (a thread's start-up
    // and its inversion are then a small share of its work)
    long threads = (long)std::thread::hardware_concurrency();
    threads = std::max(1L, std::min(threads, n / 4096));
    std::vector<std::thread> pool;
    for (long t = 1; t < threads; ++t) {
        pool.emplace_back(fixed_base_range, table.data(), scalars,
                          n * t / threads, n * (t + 1) / threads, out,
                          std::cref(f));
    }
    fixed_base_range(table.data(), scalars, 0, n / threads, out, f);
    for (auto &th : pool) th.join();
}

// test shim: affine double + add through the Jacobian path
void g1_test_ops(const u64 *mod_limbs, const u64 *p_aff, const u64 *q_aff,
                 u64 *dbl_out, u64 *add_out) {
    FieldCtx f = make_ctx(mod_limbs);
    JacPoint p, q;
    std::memcpy(p.x.v, p_aff, 32);
    std::memcpy(p.y.v, p_aff + 4, 32);
    to_mont(p.x, p.x, f);
    to_mont(p.y, p.y, f);
    p.z = f.one;
    std::memcpy(q.x.v, q_aff, 32);
    std::memcpy(q.y.v, q_aff + 4, 32);
    to_mont(q.x, q.x, f);
    to_mont(q.y, q.y, f);
    q.z = f.one;
    JacPoint d, s;
    jac_double(d, p, f);
    jac_add(s, p, q, f);
    JacPoint pts[2] = {d, s};
    u64 *outs[2] = {dbl_out, add_out};
    for (int i = 0; i < 2; ++i) {
        Fp zinv, zinv2, zinv3, ax, ay;
        mont_inv(zinv, pts[i].z, f);
        mont_sqr(zinv2, zinv, f);
        mont_mul(zinv3, zinv2, zinv, f);
        mont_mul(ax, pts[i].x, zinv2, f);
        mont_mul(ay, pts[i].y, zinv3, f);
        from_mont(ax, ax, f);
        from_mont(ay, ay, f);
        std::memcpy(outs[i], ax.v, 32);
        std::memcpy(outs[i] + 4, ay.v, 32);
    }
}

// --- PLONK grand products -------------------------------------------------

// permutation grand product z for NUM_WIRES wires.
// wires: [w][i] standard form; sigma_evals likewise; shifts: per-wire
// scalars; omegas: domain elements. Writes z (n values, standard form).
// Returns 0 on success, 1 if the product fails to wrap to 1.
int perm_grand_product(const u64 *mod_limbs, const u64 *wires, int num_wires,
                       const u64 *sigma, const u64 *shifts, const u64 *omegas,
                       const u64 *beta_l, const u64 *gamma_l, long n,
                       u64 *z_out) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp beta, gamma;
    std::memcpy(beta.v, beta_l, 32);
    std::memcpy(gamma.v, gamma_l, 32);
    to_mont(beta, beta, f);
    to_mont(gamma, gamma, f);

    std::vector<Fp> numer(n), denom(n), om_m(n);
    for (long i = 0; i < n; ++i) {
        numer[i] = f.one;
        denom[i] = f.one;
        std::memcpy(om_m[i].v, omegas + 4 * i, 32);
        to_mont(om_m[i], om_m[i], f);
    }
    for (int w = 0; w < num_wires; ++w) {
        Fp kw;
        std::memcpy(kw.v, shifts + 4 * w, 32);
        to_mont(kw, kw, f);
        Fp beta_kw;
        mont_mul(beta_kw, beta, kw, f);
        const u64 *col = wires + (size_t)w * 4 * n;
        const u64 *sg = sigma + (size_t)w * 4 * n;
        for (long i = 0; i < n; ++i) {
            Fp wv, sv, t1, t2;
            std::memcpy(wv.v, col + 4 * i, 32);
            to_mont(wv, wv, f);
            const Fp &om = om_m[i];
            std::memcpy(sv.v, sg + 4 * i, 32);
            to_mont(sv, sv, f);
            mont_mul(t1, beta_kw, om, f);
            add_mod(t1, t1, wv, f);
            add_mod(t1, t1, gamma, f);
            mont_mul(numer[i], numer[i], t1, f);
            mont_mul(t2, beta, sv, f);
            add_mod(t2, t2, wv, f);
            add_mod(t2, t2, gamma, f);
            mont_mul(denom[i], denom[i], t2, f);
        }
    }
    // batch invert denom (all nonzero w.h.p.)
    std::vector<Fp> prefix(n);
    Fp acc = f.one;
    for (long i = 0; i < n; ++i) {
        prefix[i] = acc;
        mont_mul(acc, acc, denom[i], f);
    }
    Fp inv;
    mont_inv(inv, acc, f);
    std::vector<Fp> dinv(n);
    for (long i = n - 1; i >= 0; --i) {
        mont_mul(dinv[i], inv, prefix[i], f);
        mont_mul(inv, inv, denom[i], f);
    }
    Fp z = f.one;
    for (long i = 0; i < n; ++i) {
        Fp out;
        from_mont(out, z, f);
        std::memcpy(z_out + 4 * i, out.v, 32);
        Fp step;
        mont_mul(step, numer[i], dinv[i], f);
        mont_mul(z, z, step, f);
    }
    // wrap check: z after last row must be 1
    Fp z_std;
    from_mont(z_std, z, f);
    Fp one_std = {{1, 0, 0, 0}};
    for (int k = 0; k < 4; ++k)
        if (z_std.v[k] != one_std.v[k]) return 1;
    return 0;
}

// LogUp running sum phi. a_col, table, m: standard form length n.
// Returns 0 ok / 1 if the sum fails to wrap to 0.
int logup_running_sum(const u64 *mod_limbs, const u64 *a_col,
                      const u64 *table, const u64 *m_col,
                      const u64 *beta_l, long n, u64 *phi_out) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp beta;
    std::memcpy(beta.v, beta_l, 32);
    to_mont(beta, beta, f);
    std::vector<Fp> inv_a(n), inv_t(n);
    for (long i = 0; i < n; ++i) {
        Fp a, t;
        std::memcpy(a.v, a_col + 4 * i, 32);
        to_mont(a, a, f);
        add_mod(inv_a[i], a, beta, f);
        std::memcpy(t.v, table + 4 * i, 32);
        to_mont(t, t, f);
        add_mod(inv_t[i], t, beta, f);
    }
    // joint batch inversion
    std::vector<Fp> all(2 * n), prefix(2 * n);
    for (long i = 0; i < n; ++i) { all[i] = inv_a[i]; all[n + i] = inv_t[i]; }
    Fp acc = f.one;
    for (long i = 0; i < 2 * n; ++i) { prefix[i] = acc; mont_mul(acc, acc, all[i], f); }
    Fp inv;
    mont_inv(inv, acc, f);
    for (long i = 2 * n - 1; i >= 0; --i) {
        Fp r;
        mont_mul(r, inv, prefix[i], f);
        mont_mul(inv, inv, all[i], f);
        all[i] = r;
    }
    Fp phi = {{0, 0, 0, 0}};
    for (long i = 0; i < n; ++i) {
        Fp out;
        from_mont(out, phi, f);
        std::memcpy(phi_out + 4 * i, out.v, 32);
        Fp mi, term;
        std::memcpy(mi.v, m_col + 4 * i, 32);
        to_mont(mi, mi, f);
        mont_mul(term, mi, all[n + i], f);
        Fp step;
        sub_mod(step, all[i], term, f);
        add_mod(phi, phi, step, f);
    }
    return is_zero_fp(phi) ? 0 : 1;
}

// --- quotient kernel ------------------------------------------------------

// Evaluate the full PLONK constraint combination over the extended coset
// and divide by Z_H. All arrays are standard-form, length ext_n:
//   wires_e[6], z_e, zw_e, m_e, phi_e, phiw_e, fixed_e[9 in FIXED order],
//   sigma_e[6], pi_e, xs (coset points), zh_inv, l0 (zh*l0_den)
// scalars: beta, gamma, beta_lk, alpha, shifts[6]
// fixed order: q_a q_b q_c q_d q_e q_mul_ab q_mul_cd q_const t_lookup
// z-split quotient identity (r4): the degree-7 permutation constraint
// is decomposed through four partial-product advice columns
// u1 = z·f0·f1, u2 = u1·f2·f3, v1 = z(ωX)·g0·g1, v2 = v1·g2·g3 and the
// link u2·f4·f5 − v2·g4·g5, capping every term at 3 polynomial factors
// so the extension coset is 4n (see zk/plonk.py prove()).
// uv_e: 4 stacked ext arrays in [u1, u2, v1, v2] order.
void quotient_eval2(const u64 *mod_limbs, const u64 *wires_e, const u64 *z_e,
                    const u64 *zw_e, const u64 *m_e, const u64 *phi_e,
                    const u64 *phiw_e, const u64 *uv_e, const u64 *fixed_e,
                    const u64 *sigma_e, const u64 *pi_e, const u64 *xs,
                    const u64 *zh_inv_a, const u64 *l0_a, const u64 *beta_l,
                    const u64 *gamma_l, const u64 *beta_lk_l,
                    const u64 *alpha_l, const u64 *shifts_l, long ext_n,
                    u64 *t_out) {
    FieldCtx f = make_ctx(mod_limbs);
    Fp beta, gamma, beta_lk, alpha, shifts[6];
    std::memcpy(beta.v, beta_l, 32); to_mont(beta, beta, f);
    std::memcpy(gamma.v, gamma_l, 32); to_mont(gamma, gamma, f);
    std::memcpy(beta_lk.v, beta_lk_l, 32); to_mont(beta_lk, beta_lk, f);
    std::memcpy(alpha.v, alpha_l, 32); to_mont(alpha, alpha, f);
    for (int w = 0; w < 6; ++w) {
        std::memcpy(shifts[w].v, shifts_l + 4 * w, 32);
        to_mont(shifts[w], shifts[w], f);
    }
    Fp ap[9];  // ap[k] = alpha^k
    ap[0] = f.one;
    ap[1] = alpha;
    for (int k = 2; k <= 8; ++k) mont_mul(ap[k], ap[k - 1], alpha, f);

    auto load = [&](const u64 *arr, long i, Fp &out_fp) {
        std::memcpy(out_fp.v, arr + 4 * i, 32);
        to_mont(out_fp, out_fp, f);
    };

    for (long i = 0; i < ext_n; ++i) {
        Fp w[6];
        for (int k = 0; k < 6; ++k) load(wires_e + (size_t)k * 4 * ext_n, i, w[k]);
        Fp fx[9];
        for (int k = 0; k < 9; ++k) load(fixed_e + (size_t)k * 4 * ext_n, i, fx[k]);
        Fp sg[6];
        for (int k = 0; k < 6; ++k) load(sigma_e + (size_t)k * 4 * ext_n, i, sg[k]);
        Fp uv[4];
        for (int k = 0; k < 4; ++k) load(uv_e + (size_t)k * 4 * ext_n, i, uv[k]);
        Fp zi, zwi, mi, phii, phiwi, pii, xi, zhi, l0i;
        load(z_e, i, zi); load(zw_e, i, zwi); load(m_e, i, mi);
        load(phi_e, i, phii); load(phiw_e, i, phiwi); load(pi_e, i, pii);
        load(xs, i, xi); load(zh_inv_a, i, zhi); load(l0_a, i, l0i);

        // gate
        Fp gate = {{0, 0, 0, 0}}, t;
        for (int k = 0; k < 5; ++k) {
            mont_mul(t, fx[k], w[k], f);
            add_mod(gate, gate, t, f);
        }
        Fp ab, cd;
        mont_mul(ab, w[0], w[1], f);
        mont_mul(cd, w[2], w[3], f);
        mont_mul(t, fx[5], ab, f);
        add_mod(gate, gate, t, f);
        mont_mul(t, fx[6], cd, f);
        add_mod(gate, gate, t, f);
        add_mod(gate, gate, fx[7], f);
        add_mod(gate, gate, pii, f);

        // permutation wire factors fv/gv
        Fp fv[6], gv[6];
        for (int k = 0; k < 6; ++k) {
            mont_mul(fv[k], beta, shifts[k], f);
            mont_mul(fv[k], fv[k], xi, f);
            add_mod(fv[k], fv[k], w[k], f);
            add_mod(fv[k], fv[k], gamma, f);
            mont_mul(gv[k], beta, sg[k], f);
            add_mod(gv[k], gv[k], w[k], f);
            add_mod(gv[k], gv[k], gamma, f);
        }
        // link: u2·f4·f5 − v2·g4·g5
        Fp link, rhs;
        mont_mul(link, uv[1], fv[4], f);
        mont_mul(link, link, fv[5], f);
        mont_mul(rhs, uv[3], gv[4], f);
        mont_mul(rhs, rhs, gv[5], f);
        sub_mod(link, link, rhs, f);
        // partial-product definition constraints
        Fp c_u1, c_u2, c_v1, c_v2;
        mont_mul(t, zi, fv[0], f);
        mont_mul(t, t, fv[1], f);
        sub_mod(c_u1, uv[0], t, f);
        mont_mul(t, uv[0], fv[2], f);
        mont_mul(t, t, fv[3], f);
        sub_mod(c_u2, uv[1], t, f);
        mont_mul(t, zwi, gv[0], f);
        mont_mul(t, t, gv[1], f);
        sub_mod(c_v1, uv[2], t, f);
        mont_mul(t, uv[2], gv[2], f);
        mont_mul(t, t, gv[3], f);
        sub_mod(c_v2, uv[3], t, f);

        // lookup (LogUp)
        Fp ba, bt, dphi, lk;
        add_mod(ba, beta_lk, w[5], f);
        add_mod(bt, beta_lk, fx[8], f);
        sub_mod(dphi, phiwi, phii, f);
        mont_mul(lk, dphi, ba, f);
        mont_mul(lk, lk, bt, f);
        sub_mod(lk, lk, bt, f);
        Fp mba;
        mont_mul(mba, mi, ba, f);
        add_mod(lk, lk, mba, f);

        // total = gate + α·link + α²·l0·(z−1) + α³·lk + α⁴·l0·φ
        //       + α⁵·c_u1 + α⁶·c_u2 + α⁷·c_v1 + α⁸·c_v2
        Fp total = gate;
        mont_mul(t, ap[1], link, f);
        add_mod(total, total, t, f);
        Fp zm1;
        sub_mod(zm1, zi, f.one, f);
        mont_mul(t, ap[2], l0i, f);
        mont_mul(t, t, zm1, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[3], lk, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[4], l0i, f);
        mont_mul(t, t, phii, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[5], c_u1, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[6], c_u2, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[7], c_v1, f);
        add_mod(total, total, t, f);
        mont_mul(t, ap[8], c_v2, f);
        add_mod(total, total, t, f);

        mont_mul(total, total, zhi, f);
        Fp out_std;
        from_mont(out_std, total, f);
        std::memcpy(t_out + 4 * i, out_std.v, 32);
    }
}

}  // extern "C"
