// Heaviest strictly-monotone chain of AMAP's aligned pairs: the weighted LIS
// of core/amap.filter_pairs_to_ordered, run on the host.
//
// The pairs come sorted by (x, y) with their weights as doubles, their x and
// their y ranks in [0, m).  A Fenwick tree of prefix maxima over the y ranks
// gives each pair the heaviest chain ending at a strictly smaller y; a pair's
// own entry goes into the tree only once x has strictly increased past it, so
// every link is strictly smaller in x and in y.  Comparisons are strict and
// ties keep the first maximum met, as in the Python version this replaces, so
// the chain is the same pair for pair.

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Writes the chain's positions in the sorted order, ascending, to chain_out
// (room for n) and returns its length (0 only when n is 0).
int64_t amap_chain(int64_t n, const double* w, const int64_t* x, const int64_t* yr,
                   int64_t m, int64_t* chain_out) {
    if (n <= 0) return 0;
    const double neg_inf = -std::numeric_limits<double>::infinity();
    std::vector<double> tree_val(m + 1, neg_inf);
    std::vector<int64_t> tree_idx(m + 1, -1);
    std::vector<double> best(n);
    std::vector<int64_t> back(n);
    int64_t i = 0;
    while (i < n) {
        int64_t j = i;
        for (; j < n && x[j] == x[i]; ++j) {
            double v = neg_inf;
            int64_t bi = -1;
            for (int64_t k = yr[j]; k > 0; k -= k & -k) {   // max over y ranks < yr[j]
                if (tree_val[k] > v) {
                    v = tree_val[k];
                    bi = tree_idx[k];
                }
            }
            back[j] = v > 0 ? bi : -1;
            best[j] = (v > 0 ? v : 0.0) + w[j];
        }
        for (int64_t k = i; k < j; ++k) {
            for (int64_t t = yr[k] + 1; t <= m; t += t & -t) {
                if (best[k] > tree_val[t]) {
                    tree_val[t] = best[k];
                    tree_idx[t] = k;
                }
            }
        }
        i = j;
    }
    int64_t end = 0;
    for (int64_t k = 1; k < n; ++k)
        if (best[k] > best[end]) end = k;
    int64_t len = 0;
    for (int64_t k = end; k >= 0; k = back[k]) ++len;
    int64_t pos = len;
    for (int64_t k = end; k >= 0; k = back[k]) chain_out[--pos] = k;
    return len;
}

}  // extern "C"
