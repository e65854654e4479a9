// Single-threaded CPU HNSW baseline for the ">=10x the CPU reference's
// vectors/sec" build gate (BASELINE.json; VERDICT r4 missing #2 / next #4).
//
// No Rust toolchain exists in this image, so the reference's insert path
// (reference src/hnsw/mod.rs:990-1084 insert: greedy descent through the
// upper layers, ef_construction beam per layer, heuristic neighbor
// selection, bidirectional links with degree-capped pruning — the
// standard Malkov-Yashunin algorithm; selection heuristic per
// operations.rs:135-233) is re-implemented here in C++ as a MEMORY-
// RESIDENT, flat-array index in the hnswlib style: the point is a FAST,
// credible CPU number, so the measured build_ratio is a lower bound on
// the true gap to the reference (whose insert additionally pays MVCC +
// storage-page costs per row).
//
// Deliberately NOT a translation of the Rust: independent layout (flat
// level-0 links + per-node upper-level blocks, epoch-stamped visited
// set, array-heap beam) — only the published algorithm is shared.

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <algorithm>
#include <queue>
#include <vector>

namespace {

struct PQItem {
    float d;
    int32_t id;
};
struct CmpMin {  // nearest-first
    bool operator()(const PQItem& a, const PQItem& b) const { return a.d > b.d; }
};
struct CmpMax {  // farthest-first (result heap)
    bool operator()(const PQItem& a, const PQItem& b) const { return a.d < b.d; }
};

struct CpuHnsw {
    const float* x;
    int64_t n;
    int32_t dim;
    int32_t M, M0, efc;
    double mult;
    int32_t ep = -1;
    int32_t top = -1;
    // level-0 links: [n, M0+1] (count, neighbors...)
    std::vector<int32_t> links0;
    // upper links: per node, levels * (M+1) ints (count, neighbors...)
    std::vector<int32_t*> linksU;
    std::vector<int32_t> level;
    std::vector<uint32_t> visited;
    uint32_t epoch = 0;
    uint64_t rng;

    float dist(const float* a, const float* b) const {
        float s = 0.f;
        for (int32_t i = 0; i < dim; i++) {
            const float t = a[i] - b[i];
            s += t * t;
        }
        return s;
    }
    const float* vec(int32_t i) const { return x + (int64_t)i * dim; }
    int32_t* links(int32_t node, int32_t lvl) {
        if (lvl == 0) return links0.data() + (int64_t)node * (M0 + 1);
        return linksU[node] + (int64_t)(lvl - 1) * (M + 1);
    }

    uint64_t next_rand() {  // xorshift64*
        rng ^= rng >> 12;
        rng ^= rng << 25;
        rng ^= rng >> 27;
        return rng * 0x2545F4914F6CDD1DULL;
    }
    int32_t draw_level() {
        const double u =
            ((next_rand() >> 11) + 1) * (1.0 / 9007199254740993.0);
        return (int32_t)(-log(u) * mult);
    }

    // ef-beam search within one layer (reference search discipline:
    // candidate min-heap + result max-heap + visited set).
    void search_layer(const float* q, int32_t entry, float dentry,
                      int32_t ef, int32_t lvl,
                      std::vector<PQItem>& out) {
        if (++epoch == 0) {  // epoch wrap: clear stamps
            std::fill(visited.begin(), visited.end(), 0u);
            epoch = 1;
        }
        std::priority_queue<PQItem, std::vector<PQItem>, CmpMin> cand;
        std::priority_queue<PQItem, std::vector<PQItem>, CmpMax> res;
        visited[entry] = epoch;
        cand.push({dentry, entry});
        res.push({dentry, entry});
        while (!cand.empty()) {
            const PQItem c = cand.top();
            if (c.d > res.top().d && (int32_t)res.size() >= ef) break;
            cand.pop();
            const int32_t* lk = links(c.id, lvl);
            const int32_t cnt = lk[0];
            for (int32_t j = 1; j <= cnt; j++) {
                const int32_t t = lk[j];
                if (visited[t] == epoch) continue;
                visited[t] = epoch;
                const float d = dist(q, vec(t));
                if ((int32_t)res.size() < ef || d < res.top().d) {
                    cand.push({d, t});
                    res.push({d, t});
                    if ((int32_t)res.size() > ef) res.pop();
                }
            }
        }
        out.clear();
        while (!res.empty()) {
            out.push_back(res.top());
            res.pop();
        }
        std::reverse(out.begin(), out.end());  // ascending distance
    }

    // diversity heuristic (select_neighbors_heuristic): keep a candidate
    // only if it is closer to q than to every already-kept neighbor.
    void select(const std::vector<PQItem>& cand, int32_t m,
                std::vector<PQItem>& out) {
        out.clear();
        for (const PQItem& c : cand) {
            if ((int32_t)out.size() >= m) break;
            bool ok = true;
            for (const PQItem& s : out) {
                if (dist(vec(c.id), vec(s.id)) < c.d) {
                    ok = false;
                    break;
                }
            }
            if (ok) out.push_back(c);
        }
    }

    void connect(int32_t node, int32_t lvl,
                 const std::vector<PQItem>& sel,
                 std::vector<PQItem>& scratch,
                 std::vector<PQItem>& scratch2) {
        const int32_t cap = lvl == 0 ? M0 : M;
        int32_t* lk = links(node, lvl);
        lk[0] = (int32_t)sel.size();
        for (size_t j = 0; j < sel.size(); j++) lk[j + 1] = sel[j].id;
        // bidirectional: append node to each neighbor, prune on overflow
        for (const PQItem& s : sel) {
            int32_t* nl = links(s.id, lvl);
            if (nl[0] < cap) {
                nl[++nl[0]] = node;
                continue;
            }
            // re-select the neighbor's list with node as a candidate
            scratch.clear();
            scratch.push_back({s.d, node});
            const float* nv = vec(s.id);
            for (int32_t j = 1; j <= nl[0]; j++)
                scratch.push_back({dist(nv, vec(nl[j])), nl[j]});
            std::sort(scratch.begin(), scratch.end(),
                      [](const PQItem& a, const PQItem& b) {
                          return a.d < b.d;
                      });
            select(scratch, cap, scratch2);
            nl[0] = (int32_t)scratch2.size();
            for (size_t j = 0; j < scratch2.size(); j++)
                nl[j + 1] = scratch2[j].id;
        }
    }

    void insert(int32_t i) {
        const int32_t l = draw_level();
        level[i] = l;
        if (l > 0) {
            linksU[i] = (int32_t*)calloc((size_t)l * (M + 1), 4);
        }
        if (ep < 0) {
            ep = i;
            top = l;
            return;
        }
        const float* q = vec(i);
        int32_t cur = ep;
        float dcur = dist(q, vec(cur));
        // greedy descent through layers above l (ef = 1)
        for (int32_t lvl = top; lvl > l; lvl--) {
            bool moved = true;
            while (moved) {
                moved = false;
                const int32_t* lk = links(cur, lvl);
                for (int32_t j = 1; j <= lk[0]; j++) {
                    const float d = dist(q, vec(lk[j]));
                    if (d < dcur) {
                        dcur = d;
                        cur = lk[j];
                        moved = true;
                    }
                }
            }
        }
        // beam + heuristic connect from min(top, l) down to 0
        std::vector<PQItem> cand, sel, scratch, scratch2;
        for (int32_t lvl = std::min(top, l); lvl >= 0; lvl--) {
            search_layer(q, cur, dcur, efc, lvl, cand);
            select(cand, lvl == 0 ? M0 : M, sel);
            connect(i, lvl, sel, scratch, scratch2);
            if (!cand.empty()) {
                cur = cand[0].id;
                dcur = cand[0].d;
            }
        }
        if (l > top) {
            top = l;
            ep = i;
        }
    }

    void knn(const float* q, int32_t ef, int32_t k, int32_t* out) {
        std::vector<PQItem> res;
        int32_t cur = ep;
        float dcur = dist(q, vec(cur));
        for (int32_t lvl = top; lvl > 0; lvl--) {
            bool moved = true;
            while (moved) {
                moved = false;
                const int32_t* lk = links(cur, lvl);
                for (int32_t j = 1; j <= lk[0]; j++) {
                    const float d = dist(q, vec(lk[j]));
                    if (d < dcur) {
                        dcur = d;
                        cur = lk[j];
                        moved = true;
                    }
                }
            }
        }
        search_layer(q, cur, dcur, ef > k ? ef : k, 0, res);
        for (int32_t j = 0; j < k; j++)
            out[j] = j < (int32_t)res.size() ? res[j].id : -1;
    }
};

}  // namespace

// Build an n-vector index single-threaded, then answer nq queries
// (ef_search) into out_ids [nq, k]. Returns the BUILD seconds only
// (queries excluded), or -1 on allocation failure.
extern "C" double turdb_hnsw_cpu_build_search(
    const float* x, int64_t n, int32_t dim, int32_t M, int32_t efc,
    uint64_t seed, const float* q, int64_t nq, int32_t k,
    int32_t ef_search, int32_t* out_ids) {
    CpuHnsw h;
    h.x = x;
    h.n = n;
    h.dim = dim;
    h.M = M;
    h.M0 = 2 * M;
    h.efc = efc;
    h.mult = 1.0 / log((double)M);
    h.rng = seed ? seed : 0x9E3779B97F4A7C15ULL;
    h.links0.assign((size_t)n * (h.M0 + 1), 0);
    h.linksU.assign((size_t)n, nullptr);
    h.level.assign((size_t)n, 0);
    h.visited.assign((size_t)n, 0u);

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int64_t i = 0; i < n; i++) h.insert((int32_t)i);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    const double secs =
        (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);

    for (int64_t i = 0; i < nq; i++)
        h.knn(q + i * dim, ef_search, k, out_ids + i * k);
    for (int64_t i = 0; i < n; i++) free(h.linksU[i]);
    return secs;
}
