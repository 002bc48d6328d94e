// Clos-network routing planner: the host-side plan build of the port.
//
// Copied from native/protocol_native.cpp (the clos_planner namespace and
// the extern "C" clos_plan / clos_apply_route entry points), so that
// protocol_tpu_torch builds and binds its own planner. The algorithm and
// its output bytes are unchanged; protocol_tpu_torch/native/__init__.py
// compiles this file with g++ at first use.

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

typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Clos-network routing planner (ops/clos.py's native twin).
//
// Decomposes a static permutation of E = 2^e slots into lane-permutation
// stages executable at streaming speed on TPU (see protocol_tpu/ops/clos.py
// for the network structure). The level decomposition assigns each edge of
// the 128-regular bipartite row multigraph a color (= middle subnetwork) via
// recursive Euler halving; colors give the input/output lane-permutation
// stages and the recursive middle sub-permutations.
//
// The reference has no counterpart (its trust matrix is 4x4); this planner
// exists to make the 10M-peer SpMV run as vector shuffles instead of
// scalar-unit gathers.

namespace clos_planner {

typedef int32_t i32;
typedef int64_t i64;
typedef uint8_t u8;
typedef uint32_t u32;

// Shared scratch, sized once for the top level and reused at every level
// (deeper levels only touch prefixes). The walk arrays are split-local
// (indexed by local edge id) so the Euler chase stays in the smallest
// possible working set.
// Ask the kernel for 2 MB pages on a freshly-reserved buffer: random
// access into the GB-scale walk arrays otherwise pays a 4 KB TLB miss
// + page walk on top of each DRAM miss. Portable best-effort: hosts
// without transparent huge pages accept the advise and ignore it.
static void advise_huge(void *p, size_t bytes) {
#ifdef __linux__
    uintptr_t a = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
    uintptr_t e = ((uintptr_t)p + bytes) & ~(uintptr_t)4095;
    if (e > a && e - a >= (2u << 20))
        madvise((void *)a, e - a, MADV_HUGEPAGE);
#else
    (void)p;
    (void)bytes;
#endif
}

struct ColorScratch {
    std::vector<i32> eids;     // edge ids, partitioned in place
    std::vector<i32> tmp;      // partition buffer
    std::vector<i32> ls, rs;   // pre-gathered endpoints per local edge
    std::vector<i32> ladj, radj;
    std::vector<i32> lpart, rpart, seg_of;
    std::vector<i32> lcur, rcur;
    std::vector<i64> lptr, rptr;
    std::vector<u8> used, side_a;
    // cache-layout fusion for the interleaved walk (r4): the walk's
    // per-step DRAM misses dominate plan wall-clock on 1-core hosts.
    // pairs[j] packs (lpart, rpart) in ONE 8-byte word (one line feeds
    // both involutions) and meta[j] packs (seg<<2 | colored<<1 | side)
    // — ~5-6 dependent misses per step collapse to ~2.
    std::vector<u64> pairs;
    std::vector<u32> meta;
    // lcur/rcur double as the fused build's pend arrays; they hold -1
    // everywhere between euler_split calls (every vertex pairs off —
    // degrees are even), so they are filled ONCE here and only after a
    // cursor-fallback clobber (pend_clean). Refilling the m-sized
    // arrays per small split would dominate deep recursion levels.
    bool pend_clean = false;

    void ensure(i64 El, i64 m) {
        if ((i64)eids.size() < El) {
            // madvise must land BEFORE first touch (resize's zero-fill
            // faults the pages): reserve → advise → resize, so the
            // fill faults 2 MB pages directly. The walk's
            // random-access arrays are the TLB-critical set.
            auto prep = [El](auto &v) {
                v.reserve(El);
                advise_huge(v.data(),
                            (size_t)El * sizeof(*v.data()));
                v.resize(El);
            };
            prep(eids);
            prep(tmp);
            prep(ls);
            prep(rs);
            prep(ladj);
            prep(radj);
            prep(used);
            prep(lpart);
            prep(rpart);
            prep(seg_of);
            prep(side_a);
            prep(pairs);
            prep(meta);
        }
        if ((i64)lptr.size() < m + 1) {
            lptr.resize(m + 1); rptr.resize(m + 1);
            lcur.resize(m); rcur.resize(m);
            pend_clean = false;  // fresh elements are uninitialized
        }
    }
};

// 2-color the subset eids[lo..hi) of an even-regular bipartite multigraph
// so every vertex's incident edges split evenly; stable-partition side-A
// first and return its size. i_src: per-edge left vertex; right vertex =
// eid >> 7.
//
// Pairing formulation: pair each vertex's incident edges (two involutions
// lpart/rpart on the subset). Alternating the two pairings yields cycles
// of even length (links alternate between two involutions), and a proper
// 2-coloring along each cycle halves every vertex's degree. Traversal is
// orbit-walking of succ = rpart∘lpart — two dependent loads per step —
// interleaved across K walkers for memory-level parallelism. Walkers may
// land on the same cycle with arbitrary phase; each collision records a
// parity constraint between the two segments, and a final union pass
// flips whole segments to satisfy all constraints (consistent because a
// global proper 2-coloring exists; verified, with a cursor-walk fallback
// if the check ever failed).
static void euler_split_cursor(const i32 *ls, const i32 *rs,
                               ColorScratch &S, i64 k, i64 m);

// CLOS_SPLIT_DEBUG=1: per-phase nanosecond accumulators across every
// euler_split call (all threads), printed by clos_plan — the evidence
// for where plan wall-clock actually goes (r5: the adjacency/pairing
// build vs the orbit walk).
struct SplitPhaseNanos {
    std::atomic<i64> build{0}, walk{0}, finish{0};
};
static SplitPhaseNanos g_split_nanos;

static inline i64 _now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

static void build_adjacency(const i32 *ls, const i32 *rs,
                            ColorScratch &S, i64 k, i64 m) {
    // counting-sort CSR build (lptr/rptr/ladj/radj) — the cursor
    // walk's structure; the large-split path no longer needs it
    i64 *lptr = S.lptr.data();
    i64 *rptr = S.rptr.data();
    std::fill(lptr, lptr + m + 1, 0);
    std::fill(rptr, rptr + m + 1, 0);
    for (i64 j = 0; j < k; ++j) {
        lptr[ls[j] + 1]++;
        rptr[rs[j] + 1]++;
    }
    for (i64 v = 0; v < m; ++v) {
        lptr[v + 1] += lptr[v];
        rptr[v + 1] += rptr[v];
    }
    i32 *lcur = S.lcur.data();
    i32 *rcur = S.rcur.data();
    for (i64 v = 0; v < m; ++v) {
        lcur[v] = (i32)lptr[v];
        rcur[v] = (i32)rptr[v];
    }
    i32 *ladj = S.ladj.data();
    i32 *radj = S.radj.data();
    for (i64 j = 0; j < k; ++j) {
        ladj[lcur[ls[j]]++] = (i32)j;
        radj[rcur[rs[j]]++] = (i32)j;
    }
}

static i64 euler_split(const i32 *i_src, ColorScratch &S, i64 lo, i64 hi,
                       i64 m) {
    const bool dbg = std::getenv("CLOS_SPLIT_DEBUG") != nullptr;
    i64 t0 = dbg ? _now_ns() : 0;
    i64 k = hi - lo;
    i32 *e = S.eids.data() + lo;
    i32 *ls = S.ls.data();
    i32 *rs = S.rs.data();
    u8 *side_a = S.side_a.data();   // pre-flip color: member=1, lpart=0

    {
    // FUSED pairing build (r5): pair each vertex's incident edges by
    // ARRIVAL order in one streaming pass — any perfect per-vertex
    // matching yields the even alternating cycles the halving needs,
    // so the counting-sort CSR (histogram + prefix + two scatter
    // passes into E-sized ladj/radj, ~4 random accesses per edge) is
    // dead weight on this path. pend[v] holds the unmatched edge at
    // vertex v (degrees are even, so none remain). pairs[j] packs
    // (lpart, rpart) in ONE 8-byte word (r4: one line feeds both
    // involutions in the walk).
    u64 *pairs = S.pairs.data();
    i32 *pendL = S.lcur.data();  // m-sized scratch, free on this path
    i32 *pendR = S.rcur.data();
    if (!S.pend_clean) {
        std::fill(pendL, pendL + S.lcur.size(), -1);
        std::fill(pendR, pendR + S.rcur.size(), -1);
        S.pend_clean = true;
    }
    for (i64 j = 0; j < k; ++j) {
        i32 eid = e[j];
        i32 v = i_src[eid];
        i32 w = eid >> 7;
        i32 &pl = pendL[v];
        if (pl < 0) {
            pl = (i32)j;
        } else {
            pairs[pl] = (pairs[pl] & ~(u64)0xffffffffu) | (u32)j;
            pairs[j] = (pairs[j] & ~(u64)0xffffffffu) | (u32)pl;
            pl = -1;
        }
        i32 &pr = pendR[w];
        if (pr < 0) {
            pr = (i32)j;
        } else {
            pairs[pr] = (pairs[pr] & 0xffffffffu) | ((u64)(u32)j << 32);
            pairs[j] = (pairs[j] & 0xffffffffu) | ((u64)(u32)pr << 32);
            pr = -1;
        }
    }
    auto lpart_of = [&](i64 j) -> i32 { return (i32)(u32)pairs[j]; };
    auto rpart_of = [&](i64 j) -> i32 { return (i32)(pairs[j] >> 32); };
    if (dbg) {
        g_split_nanos.build.fetch_add(_now_ns() - t0);
        t0 = _now_ns();
    }

    if (k < (1 << 16)) {
        // cache-resident splits: one sequential walker colors each
        // alternating cycle end to end — no collisions, so none of the
        // interleaved path's segment/constraint bookkeeping (r5; the
        // r4 small path built a full counting-sort CSR + cursor walk)
        u8 *used = S.used.data();
        std::fill(used, used + k, (u8)0);
        for (i64 s0 = 0; s0 < k; ++s0) {
            if (used[s0]) continue;
            i32 cur = (i32)s0;
            used[s0] = 1;
            side_a[s0] = 1;
            for (;;) {
                i32 p = lpart_of(cur);
                used[p] = 1;
                side_a[p] = 0;
                i32 nxt = rpart_of(p);
                if (nxt == (i32)s0) break;
                used[nxt] = 1;
                side_a[nxt] = 1;
                cur = nxt;
            }
        }
        if (dbg) g_split_nanos.walk.fetch_add(_now_ns() - t0);
        goto partition;
    }

    // per-edge walk state fused into one word: seg<<2 | colored<<1 |
    // side — the three former arrays (used/seg_of/side_a) cost three
    // independent misses per claimed edge; meta costs one.
    u32 *meta = S.meta.data();
    std::memset(meta, 0, (size_t)k * sizeof(u32));
    auto is_colored = [&](i64 j) -> bool { return meta[j] & 2u; };

    // segments + parity constraints between them
    struct Seg { i32 start; i32 members; i32 lparts; };
    struct Con { i32 a, b; u8 parity; };  // flip[a] ^ flip[b] == parity
    std::vector<Seg> segs;
    std::vector<Con> cons;

    const int K = 32;  // MLP depth: each step chains ~2 misses, so 32
                       // walkers keep ~16 loads in flight
    struct Walker { i32 cur; i32 start; i32 seg; i32 members; i32 lparts;
                    bool active; };
    Walker ws[K];
    for (int w = 0; w < K; ++w) ws[w].active = false;
    i64 scan = 0;
    int n_active = 0;

    auto finish = [&](Walker &w) {
        segs[w.seg].members = w.members;
        segs[w.seg].lparts = w.lparts;
        w.active = false;
    };
    auto launch = [&](Walker &w) -> bool {
        while (scan < k && is_colored(scan)) ++scan;
        if (scan >= k) return false;
        w.cur = (i32)scan;
        w.start = (i32)scan;
        w.seg = (i32)segs.size();
        segs.push_back({w.start, 1, 0});
        // color the start as a member immediately so no other walker can
        // traverse onto it half-claimed
        meta[w.cur] = ((u32)w.seg << 2) | 2u | 1u;  // colored, side=1
        // the start's BACKWARD rpart link is the one link no traversal
        // will check when its partner was claimed first — record its
        // alternation constraint here (duplicates are consistent)
        i32 back = rpart_of(w.start);
        if (is_colored(back))
            cons.push_back({w.seg, (i32)(meta[back] >> 2),
                            (u8)(meta[back] & 1u)});
        w.members = 1;
        w.lparts = 0;
        w.active = true;
        ++scan;
        return true;
    };
    for (int w = 0; w < K; ++w) {
        if (launch(ws[w])) ++n_active;
        else break;
    }

    while (n_active > 0) {
        for (int wi = 0; wi < K; ++wi) {
            Walker &w = ws[wi];
            if (!w.active) continue;
            // one step: claim cur's lpart, then the next member
            i32 p = lpart_of(w.cur);
            u32 mp = meta[p];
            if (mp & 2u) {
                // seam on the lpart link: final(p) must be != member(1)
                cons.push_back({w.seg, (i32)(mp >> 2), (u8)(mp & 1u)});
                finish(w);
                if (!launch(w)) --n_active;
                continue;
            }
            meta[p] = ((u32)w.seg << 2) | 2u;  // colored, side=0
            ++w.lparts;
            i32 nxt = rpart_of(p);
            if (nxt == w.start) {     // own cycle closed, consistent
                finish(w);
                if (!launch(w)) --n_active;
                continue;
            }
            u32 mn = meta[nxt];
            if (mn & 2u) {
                // seam on the rpart link: final(nxt) must be != lpart(0)
                cons.push_back({w.seg, (i32)(mn >> 2),
                                (u8)((mn & 1u) ^ 1u)});
                finish(w);
                if (!launch(w)) --n_active;
                continue;
            }
            meta[nxt] = ((u32)w.seg << 2) | 2u | 1u;  // colored, side=1
            ++w.members;
            __builtin_prefetch(&pairs[nxt]);
            w.cur = nxt;
        }
    }

    if (dbg) {
        g_split_nanos.walk.fetch_add(_now_ns() - t0);
        t0 = _now_ns();
    }
    // solve segment flips: BFS over the constraint graph with parity
    // (flat CSR adjacency — per-segment std::vectors were allocation
    // churn at 32-walker segment counts)
    i64 ns = (i64)segs.size();
    i64 nc = (i64)cons.size();
    bool ok = true;
    for (const Con &c : cons)
        if (c.a < 0 || c.a >= ns || c.b < 0 || c.b >= ns) {
            ok = false;  // should be impossible; defensive
            break;
        }
    std::vector<i32> cptr(ns + 1, 0), cadj;
    std::vector<u8> cpar;
    std::vector<int8_t> flip(ns, -1);
    if (ok) {
        for (const Con &c : cons) {
            cptr[c.a + 1]++;
            cptr[c.b + 1]++;
        }
        for (i64 s = 0; s < ns; ++s) cptr[s + 1] += cptr[s];
        cadj.resize(2 * nc);
        cpar.resize(2 * nc);
        std::vector<i32> ccur(cptr.begin(), cptr.end() - 1);
        for (const Con &c : cons) {
            cadj[ccur[c.a]] = c.b;
            cpar[ccur[c.a]++] = c.parity;
            cadj[ccur[c.b]] = c.a;
            cpar[ccur[c.b]++] = c.parity;
        }
        std::vector<i32> queue;
        for (i64 s0 = 0; s0 < ns && ok; ++s0) {
            if (flip[s0] >= 0) continue;
            flip[s0] = 0;
            queue.clear();
            queue.push_back((i32)s0);
            while (!queue.empty() && ok) {
                i32 cur = queue.back();
                queue.pop_back();
                for (i32 p = cptr[cur]; p < cptr[cur + 1]; ++p) {
                    int8_t want = (int8_t)(flip[cur] ^ cpar[p]);
                    if (flip[cadj[p]] < 0) {
                        flip[cadj[p]] = want;
                        queue.push_back(cadj[p]);
                    } else if (flip[cadj[p]] != want) {
                        ok = false;  // impossible; fallback below
                        break;
                    }
                }
            }
        }
    }
    if (!ok) {
        // correctness fallback needs ls/rs and the CSR the fused path
        // skips; building them clobbers the lcur/rcur pend invariant
        for (i64 j = 0; j < k; ++j) {
            ls[j] = i_src[e[j]];
            rs[j] = e[j] >> 7;
        }
        build_adjacency(ls, rs, S, k, m);
        S.pend_clean = false;
        euler_split_cursor(ls, rs, S, k, m);   // recompute side_a exactly
    } else {
        // apply flips in ONE streaming pass: meta[j] already carries
        // (seg, side), so the final side is side ^ flip[seg] — the r4
        // code re-WALKED every flipped segment (2 random loads per
        // edge, a second walk's worth of DRAM misses) to do this
        for (i64 j = 0; j < k; ++j)
            side_a[j] = (u8)((meta[j] & 1u)
                             ^ (u8)flip[meta[j] >> 2]);
    }

    }

partition:
    // stable partition: side-A edges first
    {
    i32 *tmp = S.tmp.data();
    i64 na = 0;
    for (i64 j = 0; j < k; ++j)
        if (side_a[j]) tmp[na++] = e[j];
    i64 nb = na;
    for (i64 j = 0; j < k; ++j)
        if (!side_a[j]) tmp[nb++] = e[j];
    std::copy(tmp, tmp + k, e);
    if (dbg && k >= (1 << 16))
        g_split_nanos.finish.fetch_add(_now_ns() - t0);
    return na;
    }
}

// Original cursor-based Euler walk (sequential, no pairing) — retained
// as the correctness fallback for euler_split. ls/rs and the CSR in S
// are already built by the caller; only cursors need resetting. Writes
// side_a for the subset; the caller partitions.
static void euler_split_cursor(const i32 *ls, const i32 *rs,
                               ColorScratch &S, i64 k, i64 m) {
    const i64 *lptr = S.lptr.data();
    const i64 *rptr = S.rptr.data();
    i32 *lcur = S.lcur.data();
    i32 *rcur = S.rcur.data();
    const i32 *ladj = S.ladj.data();
    const i32 *radj = S.radj.data();
    for (i64 v = 0; v < m; ++v) {
        lcur[v] = (i32)lptr[v];
        rcur[v] = (i32)rptr[v];
    }
    u8 *used = S.used.data();
    u8 *side_a = S.side_a.data();
    std::memset(used, 0, k);

    for (i64 start = 0; start < k; ++start) {
        if (used[start]) continue;
        i32 v = ls[start];
        bool on_left = true;
        u8 parity = 1;
        for (;;) {
            i32 eid = -1;
            if (on_left) {
                while (lcur[v] < (i32)lptr[v + 1]) {
                    i32 cand = ladj[lcur[v]++];
                    if (!used[cand]) { eid = cand; break; }
                }
            } else {
                while (rcur[v] < (i32)rptr[v + 1]) {
                    i32 cand = radj[rcur[v]++];
                    if (!used[cand]) { eid = cand; break; }
                }
            }
            if (eid < 0) break;
            used[eid] = 1;
            side_a[eid] = parity;
            parity ^= 1;
            v = on_left ? rs[eid] : ls[eid];
            on_left = !on_left;
        }
    }

}

// Color the r-regular bipartite multigraph (r a power of two) with r
// colors; writes color[eid] for local edge ids 0..El.
static void color_edges(const i32 *i_src, i64 El, i64 m, i32 r,
                        ColorScratch &S, u8 *color) {
    S.ensure(El, m);
    for (i64 j = 0; j < El; ++j) S.eids[j] = (i32)j;
    struct Frame { i64 lo, hi; i32 d; u8 c0; };
    std::vector<Frame> stack;
    stack.push_back({0, El, r, 0});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        if (f.d == 1) {
            for (i64 j = f.lo; j < f.hi; ++j) color[S.eids[j]] = f.c0;
            continue;
        }
        i64 na = euler_split(i_src, S, f.lo, f.hi, m);
        stack.push_back({f.lo, f.lo + na, f.d / 2, f.c0});
        stack.push_back({f.lo + na, f.hi, f.d / 2, (u8)(f.c0 + f.d / 2)});
    }
}

struct PlanCtx {
    u8 *stages;            // (2*nlevels-1) arrays of E bytes each
    i64 E;
    const i32 *bits;
    i32 nlevels;
};

// per-walker scratch: the recursion below a fork point runs entirely in
// one of these, so independent sub-splits can run on separate threads
struct SubScratch {
    std::vector<std::vector<i32>> mid;    // per-level middle perms
    std::vector<i32> isrc;
    std::vector<u8> color;
    ColorScratch cscratch;

    void ensure(i64 El, i32 level, i32 nlevels) {
        if ((i64)isrc.size() < El) {
            isrc.resize(El);
            color.resize(El);
        }
        cscratch.ensure(El, El >> 7);
        if ((i64)mid.size() < (size_t)nlevels) mid.resize(nlevels);
        i64 sz = El;
        for (i32 l = level; l < nlevels - 1; ++l) {
            if ((i64)mid[l].size() < sz) mid[l].resize(sz);
            sz >>= 7;
        }
    }
};

static void plan_rec(PlanCtx &C, SubScratch &S, const i32 *perm_l, i64 El,
                     i64 slot_off, i32 level) {
    auto t_enter = std::chrono::steady_clock::now();  // level-0 debug only
    i32 nstages = 2 * C.nlevels - 1;
    if (level == C.nlevels - 1) {
        i32 r = 1 << C.bits[level];
        u8 *st = C.stages + (i64)level * C.E;
        for (i64 d = 0; d < El; ++d) {
            i64 sl = slot_off + d;
            st[sl] = (u8)(((sl & 127) & ~(i64)(r - 1)) + perm_l[d]);
        }
        return;
    }
    i64 ml = El >> 7;
    i32 *isrc = S.isrc.data();
    for (i64 d = 0; d < El; ++d) isrc[d] = perm_l[d] >> 7;
    u8 *color = S.color.data();
    color_edges(isrc, El, ml, 128, S.cscratch, color);

    u8 *st_in = C.stages + (i64)level * C.E;
    u8 *st_out = C.stages + (i64)(nstages - 1 - level) * C.E;
    i32 *mid = S.mid[level].data();
    for (i64 d = 0; d < El; ++d) {
        i64 i = isrc[d];
        i64 k = color[d];
        st_in[slot_off + i * 128 + k] = (u8)(perm_l[d] & 127);
        st_out[slot_off + d] = (u8)k;
        mid[k * ml + (d >> 7)] = (i32)i;
    }
    if (level == 0 && C.nlevels > 2) {
        // the 128 sub-splits are independent (disjoint slot ranges):
        // fan them out across hardware threads, each with its own
        // scratch. The level-0 coloring above is the serial fraction
        // (1/nlevels of total coloring work).
        // CLOS_PLAN_DEBUG=1: per-phase breakdown (serial level-0 vs
        // the parallelizable sub-splits) to stderr — the measured
        // fan-out evidence on affinity-capped 1-core hosts where the
        // thread pool cannot show wall-clock speedup.
        const bool plan_dbg = std::getenv("CLOS_PLAN_DEBUG") != nullptr;
        auto tsplit0 = std::chrono::steady_clock::now();
        unsigned nt = 0;
        if (const char *env = std::getenv("CLOS_PLAN_THREADS"))
            nt = (unsigned)std::atoi(env);
        if (!nt) {
#ifdef __linux__
            // the AFFINITY count, not hardware_concurrency: containers
            // often expose all host threads while pinning one core, and
            // the cache-hostile walk slows down when oversubscribed
            cpu_set_t set;
            if (sched_getaffinity(0, sizeof(set), &set) == 0)
                nt = (unsigned)CPU_COUNT(&set);
#endif
            if (!nt) nt = std::thread::hardware_concurrency();
        }
        if (nt > 16) nt = 16;
        if (nt > 1) {
            std::atomic<i64> next(0);
            auto worker = [&]() {
                SubScratch local;
                local.ensure(ml, 1, C.nlevels);
                for (;;) {
                    i64 k = next.fetch_add(1);
                    if (k >= 128) break;
                    plan_rec(C, local, mid + k * ml, ml,
                             slot_off + k * ml, 1);
                }
            };
            std::vector<std::thread> pool;
            for (unsigned t = 0; t < nt; ++t)
                pool.emplace_back(worker);
            for (auto &th : pool) th.join();
            if (plan_dbg) {
                double serial = std::chrono::duration<double>(
                    tsplit0 - t_enter).count();
                double par = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - tsplit0).count();
                std::fprintf(stderr,
                             "clos_plan E=%lld: serial level-0 %.2fs, "
                             "128 sub-splits %.2fs on %u thread(s)\n",
                             (long long)El, serial, par, nt);
            }
            return;
        }
        if (plan_dbg) {
            // serial path: per-split walltimes prove the independent-
            // split structure the pool exploits on multicore hosts
            double serial = std::chrono::duration<double>(
                tsplit0 - t_enter).count();
            double tmin = 1e30, tmax = 0, tsum = 0;
            for (i64 k = 0; k < 128; ++k) {
                auto k0 = std::chrono::steady_clock::now();
                plan_rec(C, S, mid + k * ml, ml, slot_off + k * ml, 1);
                double dk = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - k0).count();
                tsum += dk;
                if (dk < tmin) tmin = dk;
                if (dk > tmax) tmax = dk;
            }
            std::fprintf(stderr,
                         "clos_plan E=%lld: serial level-0 %.2fs; 128 "
                         "independent sub-splits %.2fs total "
                         "(min %.3fs max %.3fs per split -> ideal "
                         "16-thread tail %.2fs)\n",
                         (long long)El, serial, tsum, tmin, tmax,
                         tsum / 16 + tmax);
            return;
        }
    }
    for (i64 k = 0; k < 128; ++k)
        plan_rec(C, S, mid + k * ml, ml, slot_off + k * ml, level + 1);
}

}  // namespace clos_planner

extern "C" {

// Plan a Clos route for permutation perm (y[d] = x[perm[d]]).
// perm: int32[E], E = 1<<e a power of two >= 128; bits: per-level radix
// bits, interior levels must be 7, sum == e. stages_out:
// uint8[(2*nlevels-1)*E]. Returns 0 ok, 1 not a permutation, 2 bad bits.
int clos_plan(const int32_t *perm, int64_t E, const int32_t *bits,
              int32_t nlevels, uint8_t *stages_out) {
    using namespace clos_planner;
    int e = 0;
    while (((i64)1 << e) < E) ++e;
    if (((i64)1 << e) != E || e < 7) return 2;
    i64 sum = 0;
    for (i32 l = 0; l < nlevels; ++l) {
        if (l < nlevels - 1 && bits[l] != 7) return 2;
        if (bits[l] < 1 || bits[l] > 7) return 2;
        sum += bits[l];
    }
    if (sum != e) return 2;

    {   // bijection check
        std::vector<u8> seen(E, 0);
        for (i64 d = 0; d < E; ++d) {
            i32 s = perm[d];
            if (s < 0 || s >= E || seen[s]) return 1;
            seen[s] = 1;
        }
    }

    PlanCtx C;
    C.stages = stages_out;
    C.E = E;
    C.bits = bits;
    C.nlevels = nlevels;
    SubScratch S;
    if (nlevels > 1) S.ensure(E, 0, nlevels);
    else S.mid.resize(1);
    plan_rec(C, S, perm, E, 0, 0);
    if (std::getenv("CLOS_SPLIT_DEBUG")) {
        std::fprintf(stderr,
                     "clos_split phases (large splits, all levels): "
                     "build %.2fs walk %.2fs finish %.2fs\n",
                     g_split_nanos.build.load() * 1e-9,
                     g_split_nanos.walk.load() * 1e-9,
                     g_split_nanos.finish.load() * 1e-9);
        g_split_nanos.build = 0;
        g_split_nanos.walk = 0;
        g_split_nanos.finish = 0;
    }
    return 0;
}

// Replay a finished plan on int32 data (y = route(x)) — the native
// twin of ops/clos.py apply_route_np, used for plan VALIDATION: the
// numpy replay (take_along_axis + swapaxes copies over every stage)
// is slow at scale; this fused gather+interleave version makes one
// pass per stage. x is modified
// in place; tmp must be E int32s of scratch. Returns 0, or 2 for a
// bad E/bits combination (same contract as clos_plan).
int clos_apply_route(const uint8_t *stages, int64_t E,
                     const int32_t *bits, int32_t nlevels,
                     int32_t *x, int32_t *tmp) {
    using namespace clos_planner;
    int e = 0;
    while (((i64)1 << e) < E) ++e;
    if (((i64)1 << e) != E || e < 7) return 2;
    i64 sum = 0;
    for (i32 l = 0; l < nlevels; ++l) {
        // same schedule contract as clos_plan: interior levels are
        // the 128-lane radix, the base level 1..7 bits — anything
        // else must error, not replay garbage
        if (l < nlevels - 1 && bits[l] != 7) return 2;
        if (bits[l] < 1 || bits[l] > 7) return 2;
        sum += bits[l];
    }
    if (sum != e) return 2;
    i32 nstages = 2 * nlevels - 1;
    i32 si = 0;
    i32 *x_orig = x;
    // forward levels: lane gather within 128-rows, then the (B, m,
    // 128) -> (B, 128, m) interleave, FUSED into one scatter pass
    for (i32 li = 0; li < nlevels - 1; ++li) {
        const u8 *st = stages + (i64)si * E;
        i64 m = E >> (7 * (li + 1));
        i64 nB = (i64)1 << (7 * li);
        for (i64 b = 0; b < nB; ++b) {
            const i32 *xb = x + b * m * 128;
            i32 *tb = tmp + b * m * 128;
            const u8 *sb = st + b * m * 128;
            for (i64 r = 0; r < m; ++r)
                for (i64 l = 0; l < 128; ++l)
                    tb[l * m + r] = xb[r * 128 + sb[r * 128 + l]];
        }
        std::swap(x, tmp);
        ++si;
    }
    {   // middle stage: plain within-row gather
        const u8 *st = stages + (i64)si * E;
        for (i64 r = 0; r < E >> 7; ++r)
            for (i64 l = 0; l < 128; ++l)
                tmp[r * 128 + l] = x[r * 128 + st[r * 128 + l]];
        std::swap(x, tmp);
        ++si;
    }
    // reverse levels: inverse interleave fused with the gather
    for (i32 li = nlevels - 2; li >= 0; --li) {
        const u8 *st = stages + (i64)si * E;
        i64 m = E >> (7 * (li + 1));
        i64 nB = (i64)1 << (7 * li);
        for (i64 b = 0; b < nB; ++b) {
            const i32 *xb = x + b * m * 128;
            i32 *tb = tmp + b * m * 128;
            const u8 *sb = st + b * m * 128;
            // in (B, 128, m) -> out (B, m, 128) then gather within rows
            for (i64 r = 0; r < m; ++r)
                for (i64 l = 0; l < 128; ++l)
                    tb[r * 128 + l] = xb[(i64)sb[r * 128 + l] * m + r];
        }
        std::swap(x, tmp);
        ++si;
    }
    // one pointer swap per stage: an odd stage count leaves the result
    // in the caller's scratch buffer — copy it home
    if (x != x_orig)
        std::memcpy(x_orig, x, (size_t)E * sizeof(i32));
    return (si == nstages) ? 0 : 2;
}

}  // extern "C"
