// Hierarchical Dirichlet Process core: CRF Gibbs sampling over a factor tree
// with a Normal-Inverse-Gamma base distribution.
//
// TPU-native reimplementation of the reference's native HDP engine
// (impl/hdp.c, impl/hdp_math_utils.c — see SURVEY §2.1): the sequential CRF
// chain stays on the host in native code (the tree mutations cannot be
// usefully jitted), while density *queries* are exported as grid tables the
// TPU engine gathers from.  Algorithms reproduced (independent implementation):
//   - factor tree (BASE/MIDDLE/DATA_PT) with cascading creation/destruction
//   - NIG posterior add/remove updates and predictive likelihoods
//   - per-DP Gibbs sweeps with CRF sampling (linear-domain for data points,
//     log-domain for middle factors), recursive new-factor creation
//   - posterior-predictive accumulation on a fixed sampling grid with
//     hierarchical stick weights, averaged over samples
//   - gamma hyperparameter resampling (Escobar & West auxiliary scheme)
//   - natural cubic spline fit (knot slopes) + linear-extrapolating interp
//
// Exposed through a small C API consumed via ctypes (no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <random>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr double KPI = 3.14159265358979323846;

enum FactorType : int8_t { BASE = 0, MIDDLE = 1, DATA_PT = 2 };

struct DP;

struct Factor {
    FactorType type;
    Factor* parent = nullptr;
    std::unordered_set<Factor*> children;
    DP* dp = nullptr;       // null for DATA_PT
    double data = 0.0;      // DATA_PT value
    // BASE: posterior NIG params (mu, nu, two_alpha, beta) + cached log term
    double nig[5] = {0, 0, 0, 0, 0};
};

struct DP {
    int64_t id = -1;
    DP* parent = nullptr;
    std::vector<DP*> children;
    int64_t depth = 0;
    bool observed = false;
    std::unordered_set<Factor*> factors;
    int64_t num_factor_children = 0;
    double base_factor_wt = 0.0;
    std::vector<double> post_pred;
    std::vector<double> spline_slopes;
    // stats cached by unassign_from_parent for reassignment likelihoods
    double cached_mean = 0.0, cached_ssd = 0.0;
    int64_t cached_size = 0;
};

struct HDP {
    std::vector<DP> dps;
    DP* base_dp = nullptr;
    int64_t depth = 1;
    std::vector<double> gamma, gamma_alpha, gamma_beta, w_aux;
    std::vector<uint8_t> s_aux;
    bool sample_gamma = false;
    double mu = 0, nu = 0, two_alpha = 0, beta = 0;
    std::vector<double> grid;
    std::vector<double> data;
    std::vector<int64_t> data_dp;
    int64_t samples_taken = 0;
    bool splines_done = false;
    std::mt19937_64 rng;
    // per-sweep snapshot diagnostics (snapshot_joint_log_density /
    // snapshot_num_factors, hdp.c:2285-2478), recorded when enabled
    bool record_snapshots = false;
    std::vector<double> snapshot_density;
    std::vector<int64_t> snapshot_factors;

    double& dp_gamma(DP* dp) { return gamma[dp->depth]; }

    // log-gamma / log-nu memos over the integer customer-count offsets
    // (the reference's hdp_math_utils.c:120-273 memoization): nu and
    // two_alpha both advance from their priors by the same integer k, so
    // lgamma(0.5*(two_alpha0+k)) and log(nu0+k) are precomputed per k.
    std::vector<double> lg_memo, ln_memo;

    void grow_memos(size_t k) {
        size_t old = lg_memo.size();
        size_t want = std::max(k + 1, old * 2 + 64);
        lg_memo.resize(want);
        ln_memo.resize(want);
        for (size_t i = old; i < want; i++) {
            lg_memo[i] = lgamma(0.5 * (two_alpha + (double)i));
            ln_memo[i] = std::log(nu + (double)i);
        }
    }
};

double log_post_term(double nu_post, double two_alpha_post, double beta_post) {
    return lgamma(0.5 * two_alpha_post)
           - 0.5 * (std::log(nu_post) + two_alpha_post * std::log(beta_post));
}

inline double log_post_term_m(HDP* h, double nu_post, double two_alpha_post,
                              double beta_post) {
    double kf = nu_post - h->nu;
    int64_t k = (int64_t)(kf + 0.5);
    // NEVER grows the memo here: this runs inside OpenMP parallel regions
    // (sample_from_data_pt / sample_from_middle / unobserved_factor_likelihood)
    // and a concurrent resize would invalidate storage other threads read.
    // The memos are pre-grown serially (hdp_gibbs) to cover every reachable
    // offset; anything beyond falls back to the exact unmemoized form.
    if (k >= 0 && std::fabs(kf - (double)k) < 1e-6
        && (size_t)k < h->lg_memo.size()) {
        return h->lg_memo[k]
               - 0.5 * (h->ln_memo[k] + two_alpha_post * std::log(beta_post));
    }
    return log_post_term(nu_post, two_alpha_post, beta_post);
}

void cache_base_params(Factor* f, double mu, double nu, double two_alpha,
                       double beta, double log_term) {
    f->nig[0] = mu; f->nig[1] = nu; f->nig[2] = two_alpha; f->nig[3] = beta;
    f->nig[4] = log_term;
}

Factor* new_base_factor(HDP* h) {
    Factor* f = new Factor();
    f->type = BASE;
    // the reference seeds the cached log term with 1.0 (hdp.c new_base_factor);
    // it is recomputed on first assignment
    cache_base_params(f, h->mu, h->nu, h->two_alpha, h->beta, 1.0);
    f->dp = h->base_dp;
    h->base_dp->factors.insert(f);
    return f;
}

Factor* new_middle_factor(DP* dp) {
    Factor* f = new Factor();
    f->type = MIDDLE;
    f->dp = dp;
    dp->factors.insert(f);
    return f;
}

Factor* new_data_pt_factor(double value) {
    Factor* f = new Factor();
    f->type = DATA_PT;
    f->data = value;
    return f;
}

Factor* get_base_factor(Factor* f) {
    while (f->type != BASE) f = f->parent;
    return f;
}

void factor_sum(Factor* f, double* sum, int64_t* n) {
    if (f->type == DATA_PT) {
        *sum += f->data;
        (*n)++;
        return;
    }
    for (Factor* c : f->children) factor_sum(c, sum, n);
}

void factor_ssd(Factor* f, double mean, double* ssd) {
    if (f->type == DATA_PT) {
        double d = f->data - mean;
        *ssd += d * d;
        return;
    }
    for (Factor* c : f->children) factor_ssd(c, mean, ssd);
}

void get_factor_stats(Factor* f, double* mean, double* ssd, int64_t* n) {
    *mean = 0.0; *ssd = 0.0; *n = 0;
    factor_sum(f, mean, n);
    *mean /= (double)*n;
    factor_ssd(f, *mean, ssd);
}

void add_update_base_params(HDP* h, Factor* f, double mean, double ssd, double n) {
    double mu_prev = f->nig[0], nu_prev = f->nig[1];
    double two_alpha_prev = f->nig[2], beta_prev = f->nig[3];
    double nu_post = nu_prev + n;
    double mu_post = (mu_prev * nu_prev + mean * n) / nu_post;
    double two_alpha_post = two_alpha_prev + n;
    double mean_dev = mean - mu_prev;
    double sq_mean_dev = nu_prev * n * mean_dev * mean_dev / nu_post;
    double beta_post = beta_prev + 0.5 * (ssd + sq_mean_dev);
    cache_base_params(f, mu_post, nu_post, two_alpha_post, beta_post,
                      log_post_term_m(h, nu_post, two_alpha_post, beta_post));
}

void remove_update_base_params(HDP* h, Factor* f, double mean, double ssd, double n) {
    double mu_post = f->nig[0], nu_post = f->nig[1];
    double two_alpha_post = f->nig[2], beta_post = f->nig[3];
    double nu_prev = nu_post - n;
    double mu_prev = (mu_post * nu_post - mean * n) / nu_prev;
    double two_alpha_prev = two_alpha_post - n;
    double mean_dev = mean - mu_prev;
    double sq_mean_dev = nu_prev * n * mean_dev * mean_dev / nu_post;
    double beta_prev = beta_post - 0.5 * (ssd + sq_mean_dev);
    cache_base_params(f, mu_prev, nu_prev, two_alpha_prev, beta_prev,
                      log_post_term_m(h, nu_prev, two_alpha_prev, beta_prev));
}

void destroy_factor(HDP* h, Factor* f) {
    if (!f->children.empty()) {
        std::fprintf(stderr, "hdp_core: destroying factor with children\n");
        std::abort();
    }
    Factor* parent = f->parent;
    if (parent != nullptr) {
        parent->children.erase(f);
        parent->dp->num_factor_children--;
        if (parent->children.empty()) destroy_factor(h, parent);
    }
    if (f->dp != nullptr) f->dp->factors.erase(f);
    delete f;
}

void unassign_from_parent(HDP* h, Factor* f) {
    Factor* parent = f->parent;
    Factor* base_f = get_base_factor(parent);
    DP* base_dp = base_f->dp;

    parent->children.erase(f);
    f->parent = nullptr;
    parent->dp->num_factor_children--;
    if (parent->children.empty()) destroy_factor(h, parent);

    double mean, ssd;
    int64_t n;
    get_factor_stats(f, &mean, &ssd, &n);

    // the cascade may have destroyed the base factor
    if (base_dp->factors.count(base_f)) {
        remove_update_base_params(h, base_f, mean, ssd, (double)n);
    }
    if (f->dp != nullptr) {
        f->dp->cached_mean = mean;
        f->dp->cached_size = n;
        f->dp->cached_ssd = ssd;
    }
}

void assign_to_parent(HDP* h, Factor* f, Factor* parent, bool update_params) {
    f->parent = parent;
    parent->children.insert(f);
    parent->dp->num_factor_children++;
    if (!update_params) return;
    Factor* base_f = get_base_factor(parent);
    if (f->type == DATA_PT) {
        add_update_base_params(h, base_f, f->data, 0.0, 1.0);
    } else {
        DP* dp = f->dp;
        add_update_base_params(h, base_f, dp->cached_mean, dp->cached_ssd,
                               (double)dp->cached_size);
    }
}

double data_pt_parent_likelihood(HDP* h, Factor* data_f, Factor* parent) {
    Factor* base_f = get_base_factor(parent);
    double mu_d = base_f->nig[0], nu_d = base_f->nig[1];
    double two_alpha_d = base_f->nig[2], beta_d = base_f->nig[3];
    double nu_n = nu_d + 1.0;
    double mean_dev = data_f->data - mu_d;
    double sq_mean_dev = nu_d * mean_dev * mean_dev / nu_n;
    double two_alpha_n = two_alpha_d + 1.0;
    double beta_n = beta_d + 0.5 * sq_mean_dev;
    double log_numer = log_post_term_m(h, nu_n, two_alpha_n, beta_n);
    return (1.0 / std::sqrt(2.0 * KPI)) * std::exp(log_numer - base_f->nig[4]);
}

double factor_parent_joint_ll(HDP* h, Factor* f, Factor* parent) {
    Factor* base_f = get_base_factor(parent);
    DP* dp = f->dp;
    double n = (double)dp->cached_size;
    double mean = dp->cached_mean;
    double ssd = dp->cached_ssd;
    double mu_d = base_f->nig[0], nu_d = base_f->nig[1];
    double two_alpha_d = base_f->nig[2], beta_d = base_f->nig[3];
    double nu_n = nu_d + n;
    double two_alpha_n = two_alpha_d + n;
    double mean_dev = mean - mu_d;
    double sq_mean_dev = nu_d * n * mean_dev * mean_dev / nu_n;
    double beta_n = beta_d + 0.5 * (ssd + sq_mean_dev);
    return -0.5 * n * std::log(2.0 * KPI)
           + log_post_term_m(h, nu_n, two_alpha_n, beta_n) - base_f->nig[4];
}

double prior_likelihood(HDP* h, Factor* f) {
    double dev = f->data - h->mu;
    double alpha_term = std::exp(lgamma(0.5 * (h->two_alpha + 1.0))
                                 - lgamma(0.5 * h->two_alpha));
    double nu_term = h->nu / (2.0 * (h->nu + 1.0) * h->beta);
    double beta_term = std::pow(1.0 + nu_term * dev * dev,
                                -0.5 * (h->two_alpha + 1.0));
    return alpha_term * std::sqrt(nu_term / KPI) * beta_term;
}

double prior_joint_ll(HDP* h, Factor* f) {
    DP* dp = f->dp;
    double n = (double)dp->cached_size;
    double mean = dp->cached_mean;
    double ssd = dp->cached_ssd;
    double mean_dev = mean - h->mu;
    double sq_mean_dev = h->nu * n * mean_dev * mean_dev / (h->nu + n);
    double log_alpha_term = lgamma(0.5 * (h->two_alpha + n)) - lgamma(0.5 * h->two_alpha);
    double log_nu_term = 0.5 * (std::log(h->nu) - std::log(h->nu + n));
    double log_pi_term = 0.5 * n * std::log(2.0 * KPI);
    double log_beta_1 = h->two_alpha * std::log(h->beta);
    double log_beta_2 = (h->two_alpha + n) * std::log(h->beta + 0.5 * (ssd + sq_mean_dev));
    return log_alpha_term + log_nu_term - log_pi_term + 0.5 * (log_beta_1 - log_beta_2);
}

double add_logs(double a, double b) {
    if (a == -INFINITY) return b;
    if (b == -INFINITY) return a;
    double hi = a > b ? a : b;
    return hi + std::log1p(std::exp(-(std::fabs(a - b))));
}

double unobserved_factor_likelihood(HDP* h, Factor* f, DP* dp) {
    DP* parent_dp = dp->parent;
    if (parent_dp == nullptr) return prior_likelihood(h, f);
    double parent_gamma = h->dp_gamma(parent_dp);
    double likelihood = 0.0;
    if (parent_dp->factors.size() > 256) {
        std::vector<Factor*> pool(parent_dp->factors.begin(),
                                  parent_dp->factors.end());
        #pragma omp parallel for schedule(static) reduction(+:likelihood)
        for (size_t i = 0; i < pool.size(); i++) {
            likelihood += pool[i]->children.size()
                          * data_pt_parent_likelihood(h, f, pool[i]);
        }
    } else {
        for (Factor* pf : parent_dp->factors) {
            likelihood += pf->children.size() * data_pt_parent_likelihood(h, f, pf);
        }
    }
    likelihood += parent_gamma * unobserved_factor_likelihood(h, f, parent_dp);
    likelihood /= parent_gamma + (double)parent_dp->num_factor_children;
    return likelihood;
}

double unobserved_factor_joint_ll(HDP* h, Factor* f, DP* dp) {
    DP* parent_dp = dp->parent;
    if (parent_dp == nullptr) return prior_joint_ll(h, f);
    double parent_gamma = h->dp_gamma(parent_dp);
    double ll = -INFINITY;
    for (Factor* pf : parent_dp->factors) {
        ll = add_logs(ll, std::log((double)pf->children.size())
                          + factor_parent_joint_ll(h, f, pf));
    }
    ll = add_logs(ll, std::log(parent_gamma) + unobserved_factor_joint_ll(h, f, parent_dp));
    ll -= std::log(parent_gamma + (double)parent_dp->num_factor_children);
    return ll;
}

double rand_uniform(HDP* h, double hi) {
    return std::uniform_real_distribution<double>(0.0, hi)(h->rng);
}

Factor* sample_factor(HDP* h, Factor* f, DP* dp);

Factor* sample_from_data_pt(HDP* h, Factor* f, DP* dp) {
    // thread-local scratch: 100k+ data points per sweep each built two
    // fresh vectors here; the cdf is fully consumed (lower_bound) before
    // any recursion, so reuse across recursion levels is safe
    static thread_local std::vector<Factor*> pool;
    static thread_local std::vector<double> cdf;
    pool.assign(dp->factors.begin(), dp->factors.end());
    size_t n = pool.size();
    cdf.resize(n + 1);
    // parallel likelihood evaluation over the factor pool (the reference's
    // OpenMP region, hdp.c:1805-1816); the per-factor term is pure, the
    // prefix sum stays sequential.  NOTE: local references — a thread_local
    // named inside the omp region would resolve to each WORKER's own
    // (empty) instance.
    std::vector<Factor*>& pl = pool;
    std::vector<double>& cd = cdf;
    #pragma omp parallel for schedule(static) if (n > 256)
    for (size_t i = 0; i < n; i++) {
        cd[i] = pl[i]->children.size() * data_pt_parent_likelihood(h, f, pl[i]);
    }
    double cumul = 0.0;
    for (size_t i = 0; i < n; i++) {
        cumul += cdf[i];
        cdf[i] = cumul;
    }
    cumul += h->dp_gamma(dp) * unobserved_factor_likelihood(h, f, dp);
    cdf[n] = cumul;
    double r = rand_uniform(h, cumul);
    size_t choice = std::lower_bound(cdf.begin(), cdf.end(), r) - cdf.begin();
    if (choice >= n) {
        DP* parent_dp = dp->parent;
        if (parent_dp == nullptr) return new_base_factor(h);
        Factor* nf = new_middle_factor(dp);
        Factor* np = sample_from_data_pt(h, f, parent_dp);
        assign_to_parent(h, nf, np, false);
        return nf;
    }
    return pool[choice];
}

Factor* sample_from_middle(HDP* h, Factor* f, DP* dp) {
    static thread_local std::vector<Factor*> pool;
    static thread_local std::vector<double> logp;
    static thread_local std::vector<double> cdf;
    pool.assign(dp->factors.begin(), dp->factors.end());
    size_t n = pool.size();
    logp.resize(n + 1);
    std::vector<Factor*>& pl = pool;
    std::vector<double>& lp = logp;
    #pragma omp parallel for schedule(static) if (n > 256)
    for (size_t i = 0; i < n; i++) {
        lp[i] = std::log((double)pl[i]->children.size())
                  + factor_parent_joint_ll(h, f, pl[i]);
    }
    logp[n] = std::log(h->dp_gamma(dp)) + unobserved_factor_joint_ll(h, f, dp);
    double mx = -INFINITY;
    for (size_t i = 0; i <= n; i++) mx = std::max(mx, logp[i]);
    cdf.resize(n + 1);
    double cumul = 0.0;
    for (size_t i = 0; i <= n; i++) {
        cumul += std::exp(logp[i] - mx);
        cdf[i] = cumul;
    }
    double r = rand_uniform(h, cumul);
    size_t choice = std::lower_bound(cdf.begin(), cdf.end(), r) - cdf.begin();
    if (choice >= n) {
        DP* parent_dp = dp->parent;
        if (parent_dp == nullptr) return new_base_factor(h);
        Factor* nf = new_middle_factor(dp);
        Factor* np = sample_from_middle(h, f, parent_dp);
        assign_to_parent(h, nf, np, false);
        return nf;
    }
    return pool[choice];
}

Factor* sample_factor(HDP* h, Factor* f, DP* dp) {
    return f->type == DATA_PT ? sample_from_data_pt(h, f, dp)
                              : sample_from_middle(h, f, dp);
}

void gibbs_factor_iteration(HDP* h, Factor* f) {
    DP* parent_dp = f->parent->dp;
    unassign_from_parent(h, f);
    Factor* new_parent = sample_factor(h, f, parent_dp);
    assign_to_parent(h, f, new_parent, true);
}

// ---- distribution sampling -------------------------------------------------

void cache_prior_contribution(HDP* h, DP* dp, double parent_prior_prod) {
    if (!dp->observed) return;
    double g = h->dp_gamma(dp);
    double prior_prod = (g / (g + (double)dp->num_factor_children)) * parent_prior_prod;
    dp->base_factor_wt += prior_prod;
    for (DP* c : dp->children) cache_prior_contribution(h, c, prior_prod);
}

void cache_base_factor_weight(HDP* h, Factor* f) {
    DP* dp = f->dp;
    double g = h->dp_gamma(dp);
    double wt = ((double)f->children.size()) / (g + (double)dp->num_factor_children);
    dp->base_factor_wt += wt;
    if (!dp->children.empty()) {
        for (Factor* cf : f->children) cache_base_factor_weight(h, cf);
        for (DP* cd : dp->children) cache_prior_contribution(h, cd, wt);
    }
}

void push_factor_distr(DP* dp, const double* distr, int64_t length) {
    double wt = dp->base_factor_wt;
    for (int64_t i = 0; i < length; i++) dp->post_pred[i] += wt * distr[i];
    dp->base_factor_wt = 0.0;
    for (DP* c : dp->children) {
        if (c->observed) push_factor_distr(c, distr, length);
    }
}

void evaluate_posterior_predictive(Factor* base_f, const std::vector<double>& x,
                                   double* pdf) {
    double mu_d = base_f->nig[0], nu_d = base_f->nig[1];
    double two_alpha_d = base_f->nig[2], beta_d = base_f->nig[3];
    double log_denom = base_f->nig[4];
    double nu_n = nu_d + 1.0;
    double two_alpha_n = two_alpha_d + 1.0;
    double nu_ratio = nu_d / nu_n;
    double pi_factor = 1.0 / std::sqrt(2.0 * KPI);
    for (size_t i = 0; i < x.size(); i++) {
        double dev = x[i] - mu_d;
        double beta_n = beta_d + 0.5 * nu_ratio * dev * dev;
        pdf[i] = pi_factor * std::exp(log_post_term(nu_n, two_alpha_n, beta_n) - log_denom);
    }
}

void evaluate_prior_predictive(HDP* h, const std::vector<double>& x, double* pdf) {
    double nu_factor = h->nu / (2.0 * (h->nu + 1.0) * h->beta);
    double alpha_term = std::exp(lgamma(0.5 * (h->two_alpha + 1.0))
                                 - lgamma(0.5 * h->two_alpha));
    double constant_term = alpha_term * std::sqrt(nu_factor / KPI);
    double alpha_power = -0.5 * (h->two_alpha + 1.0);
    for (size_t i = 0; i < x.size(); i++) {
        double dev = x[i] - h->mu;
        pdf[i] = constant_term * std::pow(1.0 + nu_factor * dev * dev, alpha_power);
    }
}

void take_distr_sample(HDP* h) {
    int64_t length = (int64_t)h->grid.size();
    std::vector<double> pdf(length);
    // snapshot the base factor set (weights don't mutate it)
    std::vector<Factor*> base_factors(h->base_dp->factors.begin(),
                                      h->base_dp->factors.end());
    for (Factor* bf : base_factors) {
        cache_base_factor_weight(h, bf);
        evaluate_posterior_predictive(bf, h->grid, pdf.data());
        push_factor_distr(h->base_dp, pdf.data(), length);
    }
    cache_prior_contribution(h, h->base_dp, 1.0);
    evaluate_prior_predictive(h, h->grid, pdf.data());
    push_factor_distr(h->base_dp, pdf.data(), length);
    h->samples_taken++;
}

// ---- Gibbs driver ----------------------------------------------------------

void sample_dp_factors(HDP* h, DP* dp, int64_t* iter, int64_t burn_in,
                       int64_t thinning, int64_t* samples, int64_t num_samples) {
    if (!dp->observed) return;
    std::vector<Factor*> sampling;
    sampling.reserve(dp->num_factor_children);
    for (Factor* f : dp->factors)
        for (Factor* c : f->children) sampling.push_back(c);
    for (Factor* f : sampling) {
        gibbs_factor_iteration(h, f);
        (*iter)++;
        if (*iter % thinning == 0 && *iter > burn_in) {
            take_distr_sample(h);
            (*samples)++;
            if (*samples >= num_samples) break;
        }
    }
}

double sample_gamma_dist(HDP* h, double shape, double rate) {
    return std::gamma_distribution<double>(shape, 1.0 / rate)(h->rng);
}

double sample_beta_dist(HDP* h, double a, double b) {
    double x = std::gamma_distribution<double>(a, 1.0)(h->rng);
    double y = std::gamma_distribution<double>(b, 1.0)(h->rng);
    return x / (x + y);
}

void sample_gamma_params(HDP* h, int64_t* iter, int64_t burn_in, int64_t thinning,
                         int64_t* samples, int64_t num_samples) {
    // auxiliary variables (Escobar & West 1995)
    for (auto& dp : h->dps) {
        if (!dp.observed) continue;
        h->w_aux[dp.id] = sample_beta_dist(h, h->gamma[dp.depth] + 1.0,
                                           (double)dp.num_factor_children);
        double nc = (double)dp.num_factor_children;
        h->s_aux[dp.id] = std::bernoulli_distribution(
            nc / (nc + h->gamma[dp.depth]))(h->rng) ? 1 : 0;
    }
    std::vector<int64_t> num_depth_fctrs(h->depth, 0), sum_s(h->depth, 0);
    std::vector<double> sum_log_w(h->depth, 0.0);
    for (auto& dp : h->dps) {
        if (!dp.observed) continue;
        num_depth_fctrs[dp.depth] += (int64_t)dp.factors.size();
        sum_log_w[dp.depth] += std::log(h->w_aux[dp.id]);
        if (h->s_aux[dp.id]) sum_s[dp.depth]++;
    }
    for (int64_t depth = 0; depth < h->depth; depth++) {
        if (depth == 0) {
            double a_post = h->gamma_alpha[0] + (double)num_depth_fctrs[0];
            double b_post = h->gamma_beta[0] - sum_log_w[0];
            double nc = (double)h->base_dp->num_factor_children;
            double frac = (a_post - 1.0) / (nc * b_post);
            double wt = frac / (1.0 + frac);
            h->gamma[0] = wt * sample_gamma_dist(h, a_post, b_post)
                          + (1 - wt) * sample_gamma_dist(h, a_post - 1.0, b_post);
        } else {
            double a_post = h->gamma_alpha[depth]
                            + (double)(num_depth_fctrs[depth] - sum_s[depth]);
            double b_post = h->gamma_beta[depth] - sum_log_w[depth];
            h->gamma[depth] = sample_gamma_dist(h, a_post, b_post);
        }
        (*iter)++;
        if (*iter % thinning == 0 && *iter > burn_in) {
            take_distr_sample(h);
            (*samples)++;
            if (*samples >= num_samples) break;
        }
    }
}

// natural cubic spline knot slopes: Thomas algorithm on the tridiagonal system
// (spline_knot_slopes, hdp_math_utils.c:402-442)
std::vector<double> spline_knot_slopes(const std::vector<double>& x,
                                       const std::vector<double>& y) {
    int64_t n = (int64_t)x.size();
    std::vector<double> k(n), cprime(n), dprime(n);
    // rows: [center right; left center right; ...; left center]
    double right0 = 1.0 / (x[1] - x[0]);
    double center0 = 2.0 * right0;
    double rhs0 = 3.0 * (y[1] - y[0]) * right0 * right0;
    cprime[0] = right0 / center0;
    dprime[0] = rhs0 / center0;
    for (int64_t i = 1; i < n - 1; i++) {
        double left = 1.0 / (x[i] - x[i - 1]);
        double right = 1.0 / (x[i + 1] - x[i]);
        double center = 2.0 * (left + right);
        double rhs = 3.0 * ((y[i] - y[i - 1]) * left * left
                            + (y[i + 1] - y[i]) * right * right);
        double m = center - left * cprime[i - 1];
        cprime[i] = right / m;
        dprime[i] = (rhs - left * dprime[i - 1]) / m;
    }
    double leftN = 1.0 / (x[n - 1] - x[n - 2]);
    double centerN = 2.0 * leftN;
    double rhsN = 3.0 * (y[n - 1] - y[n - 2]) * leftN * leftN;
    double mN = centerN - leftN * cprime[n - 2];
    k[n - 1] = (rhsN - leftN * dprime[n - 2]) / mN;
    for (int64_t i = n - 2; i >= 0; i--) {
        k[i] = dprime[i] - cprime[i] * k[i + 1];
    }
    return k;
}

double grid_spline_interp(double q, const std::vector<double>& x,
                          const std::vector<double>& y,
                          const std::vector<double>& slope) {
    int64_t n = (int64_t)x.size();
    if (q <= x[0]) return y[0] - slope[0] * (x[0] - q);
    if (q >= x[n - 1]) return y[n - 1] + slope[n - 1] * (q - x[n - 1]);
    double dx = x[1] - x[0];
    int64_t il = (int64_t)((q - x[0]) / dx);
    int64_t ir = il + 1;
    double dy = y[ir] - y[il];
    double a = slope[il] * dx - dy;
    double b = dy - slope[ir] * dx;
    double tl = (q - x[il]) / dx;
    double tr = 1.0 - tl;
    return tr * y[il] + tl * y[ir] + tl * tr * (a * tr + b * tl);
}

void init_factors(HDP* h) {
    // one middle-factor chain per observed DP with all its data attached
    // (init_factors, hdp.c:1467-1534)
    Factor* root = new_base_factor(h);
    // data point factors per leaf dp
    std::vector<std::vector<Factor*>> data_fctrs(h->dps.size());
    for (size_t i = 0; i < h->data.size(); i++) {
        data_fctrs[h->data_dp[i]].push_back(new_data_pt_factor(h->data[i]));
    }
    // recursive chain construction
    struct Builder {
        HDP* h;
        std::vector<std::vector<Factor*>>& dfs;
        void build(DP* dp, Factor* parent_f) {
            if (!dp->observed) return;
            Factor* f = new_middle_factor(dp);
            f->parent = parent_f;
            parent_f->children.insert(f);
            parent_f->dp->num_factor_children++;
            if (dp->children.empty()) {
                for (Factor* df : dfs[dp->id]) {
                    df->parent = f;
                    f->children.insert(df);
                    dp->num_factor_children++;
                }
            } else {
                for (DP* c : dp->children) build(c, f);
            }
        }
    } builder{h, data_fctrs};
    for (DP* c : h->base_dp->children) builder.build(c, root);
    double mean, ssd;
    int64_t n;
    get_factor_stats(root, &mean, &ssd, &n);
    add_update_base_params(h, root, mean, ssd, (double)n);
}

// ---- snapshot diagnostics (hdp.c:2285-2478) --------------------------------

double snapshot_joint_log_density_internal(HDP* h, Factor* f) {
    if (f->type == DATA_PT) {
        return std::log(data_pt_parent_likelihood(h, f, f->parent));
    }
    double ld = 0.0;
    for (Factor* c : f->children) ld += snapshot_joint_log_density_internal(h, c);
    return ld;
}

double snapshot_joint_log_density(HDP* h) {
    double ld = 0.0;
    for (Factor* bf : h->base_dp->factors) {
        ld += snapshot_joint_log_density_internal(h, bf);
    }
    return ld;
}

int64_t total_factor_count(HDP* h) {
    int64_t n = 0;
    for (auto& dp : h->dps) n += (int64_t)dp.factors.size();
    return n;
}

void take_snapshot(HDP* h) {
    h->snapshot_density.push_back(snapshot_joint_log_density(h));
    h->snapshot_factors.push_back(total_factor_count(h));
}

// ---- full chain serialization (factor tree + data + RNG) --------------------
//
// The reference serializes structure, data AND the live factor tree so Gibbs
// resumes in place (hdp.c:2825-3278).  Same content here, own format: the
// factor tree is flattened to (dp_id, parent_factor_index) rows; base-factor
// NIG caches are recomputed on load from the attached data (they are pure
// functions of it), and the mt19937_64 stream state is stored verbatim so a
// deserialized chain continues from the identical RNG position.

bool serialize_chain(HDP* h, std::FILE* fh) {
    std::fprintf(fh, "hdpchain\t1\n");
    std::fprintf(fh, "%lld\t%lld\t%d\t%lld\t%d\t%d\n",
                 (long long)h->dps.size(), (long long)h->depth,
                 h->sample_gamma ? 1 : 0, (long long)h->samples_taken,
                 h->splines_done ? 1 : 0, h->record_snapshots ? 1 : 0);
    std::fprintf(fh, "%.17g\t%.17g\t%.17g\t%.17g\n", h->mu, h->nu,
                 h->two_alpha, h->beta);
    std::fprintf(fh, "%.17g\t%.17g\t%lld\n", h->grid.front(), h->grid.back(),
                 (long long)h->grid.size());
    for (auto& dp : h->dps) {
        std::fprintf(fh, "%lld%c", dp.parent ? (long long)dp.parent->id : -1LL,
                     &dp == &h->dps.back() ? '\n' : '\t');
    }
    for (int64_t d = 0; d < h->depth; d++) {
        std::fprintf(fh, "%.17g%c", h->gamma[d], d == h->depth - 1 ? '\n' : '\t');
    }
    if (h->sample_gamma) {
        for (int64_t d = 0; d < h->depth; d++) {
            std::fprintf(fh, "%.17g\t%.17g%c", h->gamma_alpha[d], h->gamma_beta[d],
                         d == h->depth - 1 ? '\n' : '\t');
        }
    }
    // data
    std::fprintf(fh, "%lld\n", (long long)h->data.size());
    for (size_t i = 0; i < h->data.size(); i++) {
        std::fprintf(fh, "%.17g\t%lld\n", h->data[i], (long long)h->data_dp[i]);
    }
    // factor tree: global indices per (dp, factor)
    std::unordered_map<Factor*, int64_t> idx;
    for (auto& dp : h->dps) {
        for (Factor* f : dp.factors) {
            int64_t i = (int64_t)idx.size();
            idx[f] = i;
        }
    }
    std::fprintf(fh, "%lld\n", (long long)idx.size());
    for (auto& dp : h->dps) {
        for (Factor* f : dp.factors) {
            std::fprintf(fh, "%lld\t%lld\t%lld\n", (long long)idx[f],
                         (long long)dp.id,
                         f->parent ? (long long)idx[f->parent] : -1LL);
        }
    }
    // data-point attachments: recover per-data-point parent by walking the
    // leaf DP pools; data points are matched to input order via a per-leaf
    // queue of (value, parent) pairs.  To keep this exact, record parent for
    // every DATA_PT child of every factor along with its value, then match
    // greedily per leaf dp in input order (values may repeat; any matching
    // is valid because equal-valued data points are exchangeable).
    {
        std::unordered_map<int64_t, std::vector<std::pair<double, int64_t>>> leaf_pts;
        for (auto& dp : h->dps) {
            for (Factor* f : dp.factors) {
                for (Factor* c : f->children) {
                    if (c->type == DATA_PT) {
                        leaf_pts[dp.id].push_back({c->data, idx[f]});
                    }
                }
            }
        }
        for (size_t i = 0; i < h->data.size(); i++) {
            auto& v = leaf_pts[h->data_dp[i]];
            int64_t parent = -1;
            for (size_t j = 0; j < v.size(); j++) {
                if (v[j].first == h->data[i]) {
                    parent = v[j].second;
                    v.erase(v.begin() + j);
                    break;
                }
            }
            if (parent < 0) {
                std::fprintf(stderr, "hdp_core: serialize: unattached data pt\n");
                return false;
            }
            std::fprintf(fh, "%lld%c", (long long)parent,
                         i + 1 == h->data.size() ? '\n' : '\t');
        }
    }
    // posterior-predictive accumulators for observed dps
    int64_t n_obs = 0;
    for (auto& dp : h->dps) n_obs += dp.observed ? 1 : 0;
    std::fprintf(fh, "%lld\n", (long long)n_obs);
    for (auto& dp : h->dps) {
        if (!dp.observed) continue;
        std::fprintf(fh, "%lld", (long long)dp.id);
        for (double v : dp.post_pred) std::fprintf(fh, "\t%.17g", v);
        std::fprintf(fh, "\n");
    }
    // snapshots
    std::fprintf(fh, "%lld\n", (long long)h->snapshot_density.size());
    for (size_t i = 0; i < h->snapshot_density.size(); i++) {
        std::fprintf(fh, "%.17g\t%lld\n", h->snapshot_density[i],
                     (long long)h->snapshot_factors[i]);
    }
    // RNG stream state
    std::ostringstream ss;
    ss << h->rng;
    std::fprintf(fh, "%s\n", ss.str().c_str());
    return true;
}

HDP* hdp_create_internal(int64_t num_dps, const int64_t* parent_ids, int64_t depth,
                         const double* gamma, const double* gamma_alpha,
                         const double* gamma_beta, int sample_gamma,
                         double mu, double nu, double two_alpha, double beta,
                         double grid_start, double grid_stop, int64_t grid_length,
                         uint64_t seed);

HDP* deserialize_chain(std::FILE* fh) {
    char tag[32];
    int version;
    if (std::fscanf(fh, "%31s %d", tag, &version) != 2
        || std::strcmp(tag, "hdpchain") != 0 || version != 1) {
        std::fprintf(stderr, "hdp_core: bad chain header\n");
        return nullptr;
    }
    long long num_dps, depth, samples_taken;
    int sample_gamma, splines_done, record_snapshots;
    if (std::fscanf(fh, "%lld %lld %d %lld %d %d", &num_dps, &depth,
                    &sample_gamma, &samples_taken, &splines_done,
                    &record_snapshots) != 6) return nullptr;
    double mu, nu, two_alpha, beta, g0, g1;
    long long glen;
    if (std::fscanf(fh, "%lf %lf %lf %lf", &mu, &nu, &two_alpha, &beta) != 4)
        return nullptr;
    if (std::fscanf(fh, "%lf %lf %lld", &g0, &g1, &glen) != 3) return nullptr;
    std::vector<int64_t> parents(num_dps);
    for (auto& p : parents) { long long v; std::fscanf(fh, "%lld", &v); p = v; }
    std::vector<double> gamma(depth), galpha(depth, 0.0), gbeta(depth, 0.0);
    for (auto& g : gamma) std::fscanf(fh, "%lf", &g);
    if (sample_gamma) {
        for (int64_t d = 0; d < depth; d++) {
            std::fscanf(fh, "%lf %lf", &galpha[d], &gbeta[d]);
        }
    }
    HDP* h = hdp_create_internal(num_dps, parents.data(), depth, gamma.data(),
                                 galpha.data(), gbeta.data(), sample_gamma,
                                 mu, nu, two_alpha, beta, g0, g1, glen, 0);
    // hdp_create_internal resets gamma to the prior mean when sample_gamma;
    // restore the serialized live values
    h->gamma = gamma;
    h->samples_taken = samples_taken;
    h->splines_done = splines_done != 0;
    h->record_snapshots = record_snapshots != 0;
    // data (mark observed, but do NOT init factors — the tree is serialized)
    long long n_data;
    std::fscanf(fh, "%lld", &n_data);
    h->data.resize(n_data);
    h->data_dp.resize(n_data);
    for (long long i = 0; i < n_data; i++) {
        long long dpid;
        std::fscanf(fh, "%lf %lld", &h->data[i], &dpid);
        h->data_dp[i] = dpid;
        DP* dp = &h->dps[dpid];
        while (dp != nullptr && !dp->observed) {
            dp->observed = true;
            dp = dp->parent;
        }
    }
    // factor tree
    long long n_factors;
    std::fscanf(fh, "%lld", &n_factors);
    std::vector<Factor*> factors(n_factors, nullptr);
    std::vector<long long> fdp(n_factors), fparent(n_factors);
    for (long long i = 0; i < n_factors; i++) {
        long long fi, dpid, pi;
        std::fscanf(fh, "%lld %lld %lld", &fi, &dpid, &pi);
        Factor* f = new Factor();
        f->dp = &h->dps[dpid];
        f->type = (pi < 0) ? BASE : MIDDLE;
        if (f->type == BASE) {
            cache_base_params(f, h->mu, h->nu, h->two_alpha, h->beta, 1.0);
        }
        h->dps[dpid].factors.insert(f);
        factors[fi] = f;
        fdp[fi] = dpid;
        fparent[fi] = pi;
    }
    for (long long i = 0; i < n_factors; i++) {
        if (fparent[i] < 0) continue;
        Factor* f = factors[i];
        Factor* p = factors[fparent[i]];
        f->parent = p;
        p->children.insert(f);
        p->dp->num_factor_children++;
    }
    for (long long i = 0; i < n_data; i++) {
        long long pi;
        std::fscanf(fh, "%lld", &pi);
        Factor* df = new_data_pt_factor(h->data[i]);
        Factor* p = factors[pi];
        df->parent = p;
        p->children.insert(df);
        p->dp->num_factor_children++;
    }
    // recompute base-factor NIG caches from the attached data
    for (Factor* bf : h->base_dp->factors) {
        double mean, ssd;
        int64_t n;
        get_factor_stats(bf, &mean, &ssd, &n);
        add_update_base_params(h, bf, mean, ssd, (double)n);
    }
    // posterior-predictive accumulators
    long long n_obs;
    std::fscanf(fh, "%lld", &n_obs);
    for (long long i = 0; i < n_obs; i++) {
        long long dpid;
        std::fscanf(fh, "%lld", &dpid);
        DP* dp = &h->dps[dpid];
        dp->observed = true;
        for (auto& v : dp->post_pred) std::fscanf(fh, "%lf", &v);
        if (h->splines_done) {
            dp->spline_slopes = spline_knot_slopes(h->grid, dp->post_pred);
        }
    }
    // snapshots
    long long n_snap;
    std::fscanf(fh, "%lld", &n_snap);
    h->snapshot_density.resize(n_snap);
    h->snapshot_factors.resize(n_snap);
    for (long long i = 0; i < n_snap; i++) {
        long long nf;
        std::fscanf(fh, "%lf %lld", &h->snapshot_density[i], &nf);
        h->snapshot_factors[i] = nf;
    }
    // RNG stream state (rest of the file)
    std::string state, line;
    {
        char buf[65536];
        std::string all;
        while (std::fgets(buf, sizeof buf, fh)) all += buf;
        std::istringstream ss(all);
        ss >> h->rng;
    }
    return h;
}

}  // namespace

namespace {

HDP* hdp_create_internal(int64_t num_dps, const int64_t* parent_ids, int64_t depth,
                         const double* gamma, const double* gamma_alpha,
                         const double* gamma_beta, int sample_gamma,
                         double mu, double nu, double two_alpha, double beta,
                         double grid_start, double grid_stop, int64_t grid_length,
                         uint64_t seed) {
    HDP* h = new HDP();
    h->dps.resize(num_dps);
    for (int64_t i = 0; i < num_dps; i++) {
        h->dps[i].id = i;
    }
    for (int64_t i = 0; i < num_dps; i++) {
        if (parent_ids[i] < 0) {
            h->base_dp = &h->dps[i];
        } else {
            h->dps[i].parent = &h->dps[parent_ids[i]];
            h->dps[parent_ids[i]].children.push_back(&h->dps[i]);
        }
    }
    // depths
    struct { void operator()(DP* dp, int64_t d) {
        dp->depth = d;
        for (DP* c : dp->children) (*this)(c, d + 1);
    } } set_depth;
    set_depth(h->base_dp, 0);
    h->depth = depth;
    h->gamma.assign(gamma, gamma + depth);
    if (sample_gamma) {
        h->gamma_alpha.assign(gamma_alpha, gamma_alpha + depth);
        h->gamma_beta.assign(gamma_beta, gamma_beta + depth);
        h->sample_gamma = true;
        for (int64_t d = 0; d < depth; d++) {
            h->gamma[d] = h->gamma_alpha[d] / h->gamma_beta[d];
        }
    }
    h->w_aux.assign(num_dps, 1.0);
    h->s_aux.assign(num_dps, 0);
    h->mu = mu; h->nu = nu; h->two_alpha = two_alpha; h->beta = beta;
    h->grid.resize(grid_length);
    double step = (grid_stop - grid_start) / (double)(grid_length - 1);
    for (int64_t i = 0; i < grid_length; i++) h->grid[i] = grid_start + step * i;
    for (auto& dp : h->dps) dp.post_pred.assign(grid_length, 0.0);
    h->rng.seed(seed);
    return h;
}

}  // namespace

extern "C" {

void* hdp_create(int64_t num_dps, const int64_t* parent_ids, int64_t depth,
                 const double* gamma, const double* gamma_alpha,
                 const double* gamma_beta, int sample_gamma,
                 double mu, double nu, double two_alpha, double beta,
                 double grid_start, double grid_stop, int64_t grid_length,
                 uint64_t seed) {
    return hdp_create_internal(num_dps, parent_ids, depth, gamma, gamma_alpha,
                               gamma_beta, sample_gamma, mu, nu, two_alpha,
                               beta, grid_start, grid_stop, grid_length, seed);
}

void hdp_set_data(void* hv, const double* data, const int64_t* dp_ids, int64_t n) {
    HDP* h = (HDP*)hv;
    h->data.assign(data, data + n);
    h->data_dp.assign(dp_ids, dp_ids + n);
    // mark observed: dps with data and their ancestors
    for (int64_t i = 0; i < n; i++) {
        DP* dp = &h->dps[dp_ids[i]];
        while (dp != nullptr && !dp->observed) {
            dp->observed = true;
            dp = dp->parent;
        }
    }
    init_factors(h);
}

void hdp_gibbs(void* hv, int64_t num_samples, int64_t burn_in, int64_t thinning,
               int verbose) {
    HDP* h = (HDP*)hv;
    // Pre-grow the lgamma/log memos serially before any parallel region.
    // nu advances from the prior by at most the number of data points that
    // can sit under one factor, i.e. the total data count.
    h->grow_memos(h->data.size() + 64);
    int64_t iter = 0, samples = 0, sweep = 0;
    std::vector<DP*> order;
    for (auto& dp : h->dps) order.push_back(&dp);
    while (samples < num_samples) {
        std::shuffle(order.begin(), order.end(), h->rng);
        for (DP* dp : order) {
            sample_dp_factors(h, dp, &iter, burn_in, thinning, &samples, num_samples);
            if (samples >= num_samples) break;
        }
        if (h->sample_gamma && samples < num_samples) {
            sample_gamma_params(h, &iter, burn_in, thinning, &samples, num_samples);
        }
        sweep++;
        if (h->record_snapshots) {
            take_snapshot(h);
        }
        if (verbose) {
            std::fprintf(stderr, "hdp_core: sweep %lld iter %lld samples %lld/%lld\n",
                         (long long)sweep, (long long)iter, (long long)samples,
                         (long long)num_samples);
        }
    }
}

void hdp_reset_data(void* hv) {
    /* reset_hdp_data (hdp.c:1603-1661): destroy the factor tree, clear data
     * and accumulators, reset gammas to the prior mean when sampled — the
     * per-update flow used by hdpHmm loading (continuousHmm.c:886-887). */
    HDP* h = (HDP*)hv;
    for (auto& dp : h->dps) {
        for (Factor* f : dp.factors) {
            std::vector<Factor*> data_children;
            for (Factor* c : f->children) {
                if (c->type == DATA_PT) data_children.push_back(c);
            }
            for (Factor* c : data_children) delete c;
            f->children.clear();
            delete f;
        }
        dp.factors.clear();
        dp.num_factor_children = 0;
        dp.observed = false;
        dp.base_factor_wt = 0.0;
        std::fill(dp.post_pred.begin(), dp.post_pred.end(), 0.0);
        dp.spline_slopes.clear();
    }
    h->data.clear();
    h->data_dp.clear();
    h->samples_taken = 0;
    h->splines_done = false;
    h->snapshot_density.clear();
    h->snapshot_factors.clear();
    if (h->sample_gamma) {
        for (int64_t d = 0; d < h->depth; d++) {
            h->gamma[d] = h->gamma_alpha[d] / h->gamma_beta[d];
        }
        std::fill(h->w_aux.begin(), h->w_aux.end(), 1.0);
        std::fill(h->s_aux.begin(), h->s_aux.end(), 0);
    }
}

void hdp_enable_snapshots(void* hv, int enable) {
    ((HDP*)hv)->record_snapshots = enable != 0;
}

int64_t hdp_snapshot_count(void* hv) {
    return (int64_t)((HDP*)hv)->snapshot_density.size();
}

void hdp_get_snapshots(void* hv, double* density, int64_t* factors) {
    HDP* h = (HDP*)hv;
    for (size_t i = 0; i < h->snapshot_density.size(); i++) {
        density[i] = h->snapshot_density[i];
        factors[i] = h->snapshot_factors[i];
    }
}

double hdp_joint_log_density(void* hv) {
    return snapshot_joint_log_density((HDP*)hv);
}

void hdp_factor_counts(void* hv, int64_t* out) {
    HDP* h = (HDP*)hv;
    for (size_t i = 0; i < h->dps.size(); i++) {
        out[i] = (int64_t)h->dps[i].factors.size();
    }
}

int hdp_serialize_chain(void* hv, const char* path) {
    std::FILE* fh = std::fopen(path, "w");
    if (fh == nullptr) return 0;
    bool ok = serialize_chain((HDP*)hv, fh);
    std::fclose(fh);
    return ok ? 1 : 0;
}

void* hdp_deserialize_chain(const char* path) {
    std::FILE* fh = std::fopen(path, "r");
    if (fh == nullptr) return nullptr;
    HDP* h = deserialize_chain(fh);
    std::fclose(fh);
    return h;
}

void hdp_finalize_distrs(void* hv) {
    HDP* h = (HDP*)hv;
    double inv = 1.0 / (double)h->samples_taken;
    for (auto& dp : h->dps) {
        if (!dp.observed) continue;
        for (auto& v : dp.post_pred) v *= inv;
        dp.spline_slopes = spline_knot_slopes(h->grid, dp.post_pred);
    }
    h->splines_done = true;
}

void hdp_densities(void* hv, int64_t dp_id, const double* xs, double* out,
                   int64_t n) {
    HDP* h = (HDP*)hv;
    DP* dp = &h->dps[dp_id];
    while (!dp->observed && dp->parent != nullptr) dp = dp->parent;
    for (int64_t i = 0; i < n; i++) {
        double v = grid_spline_interp(xs[i], h->grid, dp->post_pred, dp->spline_slopes);
        out[i] = v > 0.0 ? v : 0.0;
    }
}

void hdp_get_post_pred(void* hv, int64_t dp_id, double* out) {
    HDP* h = (HDP*)hv;
    std::memcpy(out, h->dps[dp_id].post_pred.data(),
                sizeof(double) * h->grid.size());
}

void hdp_set_post_pred(void* hv, int64_t dp_id, const double* distr) {
    // deserialization path: install a finalized distribution directly
    HDP* h = (HDP*)hv;
    DP* dp = &h->dps[dp_id];
    dp->post_pred.assign(distr, distr + h->grid.size());
    dp->observed = true;
    DP* anc = dp->parent;
    while (anc != nullptr && !anc->observed) { anc->observed = true; anc = anc->parent; }
    dp->spline_slopes = spline_knot_slopes(h->grid, dp->post_pred);
    h->splines_done = true;
    h->samples_taken = h->samples_taken > 0 ? h->samples_taken : 1;
}

int hdp_is_observed(void* hv, int64_t dp_id) {
    return ((HDP*)hv)->dps[dp_id].observed ? 1 : 0;
}

double hdp_get_gamma(void* hv, int64_t depth) {
    return ((HDP*)hv)->gamma[depth];
}

int64_t hdp_samples_taken(void* hv) { return ((HDP*)hv)->samples_taken; }

void hdp_destroy(void* hv) {
    HDP* h = (HDP*)hv;
    // free factor trees
    for (auto& dp : h->dps) {
        for (Factor* f : dp.factors) {
            for (Factor* c : f->children) {
                if (c->type == DATA_PT) delete c;
            }
            delete f;
        }
    }
    delete h;
}

}  // extern "C"
