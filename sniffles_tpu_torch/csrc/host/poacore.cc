// poacore: partial-order alignment (POA) consensus.
//
// A genuine graph-based POA replacing the earlier star-alignment
// work-alike for the local-assembly rescue path (reference dependency:
// pyspoa/SPOA, used at reference local_asm.py:17,287-291). Sequences
// are aligned one by one against a growing DAG whose nodes are bases
// and whose edge weights count supporting sequences; mismatches become
// aligned-node groups (parallel branches), and the consensus is the
// heaviest path through the graph.
//
// The sequence-to-graph DP is banded around the topological diagonal:
// all inputs to the rescue path are windows cut from reads covering the
// same locus, so the graph backbone is near-linear and a diagonal band
// of width O(slack + |V| - m) contains the optimal local alignment.
// This keeps the DP O(V * band) instead of O(V * m).
//
// Exposed C API (ctypes, io/native.py):
//   poacore_consensus(seqs, lens, n, match, mismatch, gap_open,
//                     gap_extend, min_coverage, out, out_cap) -> len
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <map>
#include <queue>
#include <vector>

namespace {

struct Node {
    uint8_t base;
    int32_t weight;                 // #sequences aligned through this node
    int32_t pos;                    // approximate backbone position (bands the DP)
    std::vector<int32_t> out;       // successor node ids
    std::vector<int32_t> in;        // predecessor node ids
    std::vector<int32_t> aligned;   // mismatch variants at the same column
};

struct Graph {
    std::vector<Node> nodes;
    std::map<std::pair<int32_t, int32_t>, int32_t> edge_w;

    int32_t add_node(uint8_t base, int32_t pos) {
        nodes.push_back(Node{base, 1, pos, {}, {}, {}});
        return static_cast<int32_t>(nodes.size()) - 1;
    }

    void add_edge(int32_t u, int32_t v) {
        auto key = std::make_pair(u, v);
        auto it = edge_w.find(key);
        if (it == edge_w.end()) {
            edge_w.emplace(key, 1);
            nodes[u].out.push_back(v);
            nodes[v].in.push_back(u);
        } else {
            it->second += 1;
        }
    }

    // Kahn topological order.
    std::vector<int32_t> topo() const {
        std::vector<int32_t> indeg(nodes.size(), 0);
        for (size_t v = 0; v < nodes.size(); v++) indeg[v] = (int32_t)nodes[v].in.size();
        std::vector<int32_t> order;
        order.reserve(nodes.size());
        std::queue<int32_t> q;
        for (size_t v = 0; v < nodes.size(); v++)
            if (indeg[v] == 0) q.push((int32_t)v);
        while (!q.empty()) {
            int32_t u = q.front(); q.pop();
            order.push_back(u);
            for (int32_t v : nodes[u].out)
                if (--indeg[v] == 0) q.push(v);
        }
        return order;  // size < nodes.size() would mean a cycle (never built)
    }
};

constexpr int32_t NEG = INT32_MIN / 4;

// Banded local (Smith-Waterman) alignment of seq against the graph.
// Returns traceback as pairs (node_id, seq_pos); node_id == -1 for a
// seq char not aligned to any node; seq positions not present in any
// pair are unaligned (prefix/suffix/deleted-over).
struct AlnStep { int32_t node; int32_t spos; };

bool align_to_graph(const Graph& g, const std::vector<int32_t>& order,
                    const uint8_t* s, int32_t m,
                    int32_t match, int32_t mismatch,
                    int32_t gap_open, int32_t gap_extend,
                    int32_t slack, std::vector<AlnStep>* out_steps) {
    const int32_t V = (int32_t)order.size();
    if (V == 0 || m == 0) return false;

    // topo rank per node (for the band and predecessor lookups)
    std::vector<int32_t> rank(g.nodes.size());
    for (int32_t i = 0; i < V; i++) rank[order[i]] = i;

    int32_t max_pos = 0;
    for (const auto& nd : g.nodes) max_pos = std::max(max_pos, nd.pos);
    const int32_t band = std::max<int32_t>(slack, std::abs(max_pos + 1 - m) + slack);
    // row window per topo rank i, centered on the node's approximate
    // backbone position: j in [lo[i], hi[i]]
    std::vector<int32_t> lo(V + 1), hi(V + 1), base_idx(V + 2, 0);
    for (int32_t i = 0; i <= V; i++) {
        int64_t center = (i == 0) ? 0 : g.nodes[order[i - 1]].pos;
        lo[i] = std::max<int32_t>(0, (int32_t)center - band);
        hi[i] = std::min<int32_t>(m, (int32_t)center + band);
        base_idx[i + 1] = base_idx[i] + (hi[i] - lo[i] + 1);
    }
    const int64_t cells = base_idx[V + 1];

    std::vector<int32_t> M(cells, NEG), E(cells, NEG), F(cells, NEG);
    std::vector<int32_t> Mpred(cells, -1), Fpred(cells, -1);
    // state the M/E/F value came from: 0=M,1=E,2=F (for traceback)
    std::vector<uint8_t> Mfrom(cells, 0), Ffrom(cells, 0);

    auto idx = [&](int32_t i, int32_t j) -> int64_t {  // valid iff in band
        return base_idx[i] + (j - lo[i]);
    };
    auto in_band = [&](int32_t i, int32_t j) -> bool {
        return i >= 0 && i <= V && j >= lo[i] && j <= hi[i];
    };

    // row 0 = virtual start (before any node): local alignment, all 0
    for (int32_t j = lo[0]; j <= hi[0]; j++) {
        M[idx(0, j)] = 0; E[idx(0, j)] = NEG; F[idx(0, j)] = NEG;
    }

    int32_t best = 0, best_i = -1, best_j = -1;

    for (int32_t i = 1; i <= V; i++) {
        const int32_t v = order[i - 1];
        const Node& nd = g.nodes[v];
        // predecessor rows: rank(p)+1 for p in in-edges, plus the virtual
        // start row 0 (local alignment can begin anywhere)
        std::vector<int32_t> prows;
        prows.reserve(nd.in.size() + 1);
        for (int32_t p : nd.in) prows.push_back(rank[p] + 1);
        prows.push_back(0);

        for (int32_t j = lo[i]; j <= hi[i]; j++) {
            const int64_t c = idx(i, j);
            // --- M: node v aligned to s[j-1] ---
            if (j >= 1) {
                const int32_t sub = (nd.base == s[j - 1]) ? match : mismatch;
                int32_t bestv = NEG; int32_t bestp = -1; uint8_t bestf = 0;
                for (int32_t pi : prows) {
                    if (!in_band(pi, j - 1)) continue;
                    const int64_t pc = idx(pi, j - 1);
                    if (M[pc] > bestv) { bestv = M[pc]; bestp = pi; bestf = 0; }
                    if (E[pc] > bestv) { bestv = E[pc]; bestp = pi; bestf = 1; }
                    if (F[pc] > bestv) { bestv = F[pc]; bestp = pi; bestf = 2; }
                }
                if (bestv > NEG / 2) {
                    int32_t val = bestv + sub;
                    if (val > 0) {
                        M[c] = val; Mpred[c] = bestp; Mfrom[c] = bestf;
                        if (val > best) { best = val; best_i = i; best_j = j; }
                    }
                }
            }
            // --- E: gap in graph (s[j-1] consumed after node v) ---
            if (j >= 1 && in_band(i, j - 1)) {
                const int64_t pc = idx(i, j - 1);
                int32_t open_v = (M[pc] > NEG / 2) ? M[pc] + gap_open + gap_extend : NEG;
                int32_t ext = (E[pc] > NEG / 2) ? E[pc] + gap_extend : NEG;
                E[c] = std::max(open_v, ext);
            }
            // --- F: gap in sequence (node v skipped) ---
            {
                int32_t bestv = NEG; int32_t bestp = -1; uint8_t bestf = 0;
                for (int32_t pi : prows) {
                    if (pi == 0) continue;  // can't open a deletion from start
                    if (!in_band(pi, j)) continue;
                    const int64_t pc = idx(pi, j);
                    int32_t open_v = (M[pc] > NEG / 2) ? M[pc] + gap_open + gap_extend : NEG;
                    int32_t ext = (F[pc] > NEG / 2) ? F[pc] + gap_extend : NEG;
                    if (open_v > bestv) { bestv = open_v; bestp = pi; bestf = 0; }
                    if (ext > bestv) { bestv = ext; bestp = pi; bestf = 2; }
                }
                if (bestv > NEG / 2) { F[c] = bestv; Fpred[c] = bestp; Ffrom[c] = bestf; }
            }
        }
    }

    out_steps->clear();
    if (best_i < 0) return false;

    // traceback from (best_i, best_j) in state M until score drops to 0
    int32_t ci = best_i, cj = best_j; uint8_t state = 0;
    while (ci > 0 || cj > 0) {
        const int64_t c = idx(ci, cj);
        if (state == 0) {
            if (!in_band(ci, cj) || M[c] <= 0 || Mpred[c] < 0) break;
            out_steps->push_back({order[ci - 1], cj - 1});
            uint8_t f = Mfrom[c]; int32_t pi = Mpred[c];
            ci = pi; cj = cj - 1; state = f;
            if (ci == 0) break;  // reached virtual start
        } else if (state == 1) {
            out_steps->push_back({-1, cj - 1});   // seq char, no node
            const int64_t pc = idx(ci, cj - 1);
            state = (E[c] == ((M[pc] > NEG / 2) ? M[pc] + gap_open + gap_extend : NEG))
                        ? 0 : 1;
            cj = cj - 1;
        } else {
            if (Fpred[c] < 0) break;
            uint8_t f = Ffrom[c]; int32_t pi = Fpred[c];
            // deletion: node skipped, nothing emitted
            ci = pi; state = f;
        }
        if (state == 0 && in_band(ci, cj) && M[idx(ci, cj)] <= 0) break;
    }
    std::reverse(out_steps->begin(), out_steps->end());
    return !out_steps->empty();
}

// Fuse an aligned sequence into the graph.
void add_alignment(Graph* g, const std::vector<AlnStep>& steps,
                   const uint8_t* s, int32_t m) {
    int32_t first_spos = m, last_spos = -1;
    for (const auto& st : steps) {
        first_spos = std::min(first_spos, st.spos);
        last_spos = std::max(last_spos, st.spos);
    }
    if (last_spos < 0) return;

    std::vector<int32_t> path;          // node per consumed seq char, in order
    path.reserve(m);

    // seq-pos -> backbone-pos offset from the first aligned pair, so new
    // nodes land near their true column for the banded DP
    int32_t anchor_node = -1, anchor_spos = 0;
    for (const auto& st : steps)
        if (st.node >= 0) { anchor_node = st.node; anchor_spos = st.spos; break; }
    const int32_t pos_shift = (anchor_node >= 0)
        ? g->nodes[anchor_node].pos - anchor_spos : 0;
    auto est_pos = [&](int32_t spos) {
        return std::max<int32_t>(0, spos + pos_shift);
    };

    auto new_chain = [&](int32_t from, int32_t to) {  // seq positions [from, to)
        for (int32_t j = from; j < to; j++)
            path.push_back(g->add_node(s[j], est_pos(j)));
    };

    new_chain(0, first_spos);            // unaligned prefix
    for (const auto& st : steps) {
        if (st.node < 0) {               // insertion vs graph: new node
            path.push_back(g->add_node(s[st.spos], est_pos(st.spos)));
            continue;
        }
        Node& nd = g->nodes[st.node];
        if (nd.base == s[st.spos]) {     // match: reuse
            nd.weight += 1;
            path.push_back(st.node);
        } else {                         // mismatch: aligned-group variant
            int32_t hit = -1;
            for (int32_t a : nd.aligned)
                if (g->nodes[a].base == s[st.spos]) { hit = a; break; }
            if (hit >= 0) {
                g->nodes[hit].weight += 1;
                path.push_back(hit);
            } else {
                int32_t w = g->add_node(s[st.spos], nd.pos);
                // join the aligned group
                std::vector<int32_t> group = nd.aligned;
                group.push_back(st.node);
                g->nodes[w].aligned = group;
                for (int32_t x : group) g->nodes[x].aligned.push_back(w);
                path.push_back(w);
            }
        }
    }
    new_chain(last_spos + 1, m);         // unaligned suffix

    for (size_t k = 1; k < path.size(); k++)
        g->add_edge(path[k - 1], path[k]);
}

// Heaviest-bundle consensus: per-node best incoming edge DP over the
// topological order, then walk back from the best-scoring node and trim
// the path to its longest run of nodes with weight >= min_coverage.
std::vector<uint8_t> consensus(const Graph& g, int32_t min_coverage) {
    const auto order = g.topo();
    const int32_t n = (int32_t)g.nodes.size();
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> pred(n, -1);
    int32_t best_node = -1; int64_t best_score = -1;
    for (int32_t u : order) {
        for (int32_t v : g.nodes[u].out) {
            const int32_t w = g.edge_w.at({u, v});
            // prefer heavier edges; break ties toward heavier tails
            const int64_t cand = score[u] + (int64_t)w * 65536 + g.nodes[u].weight;
            if (cand > score[v]) { score[v] = cand; pred[v] = u; }
        }
        const int64_t total = score[u] + g.nodes[u].weight;
        if (total > best_score) { best_score = total; best_node = u; }
    }
    std::vector<int32_t> path;
    for (int32_t v = best_node; v >= 0; v = pred[v]) path.push_back(v);
    std::reverse(path.begin(), path.end());

    // SPOA-style min_coverage: trim the consensus ENDS where fewer than
    // min_coverage sequences align to the column (ragged read-window
    // overhangs). Interior low-coverage columns — e.g. a polymorphic
    // insertion carried by a minority of reads on the heaviest path —
    // are kept. Column coverage counts the node plus its aligned-group
    // variants.
    auto column_cov = [&](int32_t v) {
        int64_t cov = g.nodes[v].weight;
        for (int32_t a : g.nodes[v].aligned) cov += g.nodes[a].weight;
        return cov;
    };
    int32_t first = 0, last = (int32_t)path.size() - 1;
    while (first <= last && column_cov(path[first]) < min_coverage) first++;
    while (last >= first && column_cov(path[last]) < min_coverage) last--;
    if (first > last) { first = 0; last = (int32_t)path.size() - 1; }

    std::vector<uint8_t> out;
    out.reserve(last - first + 1);
    for (int32_t i = first; i <= last; i++)
        out.push_back(g.nodes[path[i]].base);
    return out;
}

}  // namespace

extern "C" {

// Returns consensus length (>= 0), or -1 on failure. seqs is the
// concatenation of n sequences with lengths lens[i].
int64_t poacore_consensus(const uint8_t* seqs, const int64_t* lens, int64_t n,
                          int32_t match, int32_t mismatch,
                          int32_t gap_open, int32_t gap_extend,
                          int32_t min_coverage, int32_t band_slack,
                          uint8_t* out, int64_t out_cap) {
    if (n <= 0) return -1;
    const uint8_t* p = seqs;
    if (n == 1) {
        if (lens[0] > out_cap) return -1;
        std::memcpy(out, p, (size_t)lens[0]);
        return lens[0];
    }

    Graph g;
    // seed with the first sequence as a chain
    {
        int32_t prev = -1;
        for (int64_t j = 0; j < lens[0]; j++) {
            int32_t v = g.add_node(p[j], (int32_t)j);
            if (prev >= 0) g.add_edge(prev, v);
            prev = v;
        }
        p += lens[0];
    }

    std::vector<AlnStep> steps;
    const bool dbg = getenv("POACORE_DEBUG") != nullptr;
    for (int64_t i = 1; i < n; i++) {
        const auto order = g.topo();
        if ((int64_t)order.size() != (int64_t)g.nodes.size()) return -1;  // cycle guard
        if (align_to_graph(g, order, p, (int32_t)lens[i], match, mismatch,
                           gap_open, gap_extend, band_slack, &steps)) {
            add_alignment(&g, steps, p, (int32_t)lens[i]);
        }
        if (dbg)
            fprintf(stderr, "poacore: read %lld len=%lld steps=%zu V=%zu\n",
                    (long long)i, (long long)lens[i], steps.size(), g.nodes.size());
        p += lens[i];
    }

    const auto cons = consensus(g, min_coverage);
    if ((int64_t)cons.size() > out_cap) return -1;
    std::memcpy(out, cons.data(), cons.size());
    return (int64_t)cons.size();
}

}  // extern "C"
