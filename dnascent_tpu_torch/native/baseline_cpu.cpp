// baseline_cpu — scalar C++ implementation of the detect hot path, used by
// bench.py to measure an honest CPU denominator for the headline benchmark.
//
// The reference binary (MBoemo/DNAscent v4.1.1) cannot be built in this
// environment (its vendored submodules are empty), so bench.py brackets the
// 48-thread CPU reference point between two measured implementations of the
// same per-read hot path (event detection -> quantile scaling -> adaptive
// banded alignment -> Theil-Sen -> windowed Viterbi):
//
//   * the numpy parity oracles (ops/reference.py)  — slower than real C++;
//   * this file, clean -O3 scalar C++               — at least as fast as the
//     reference's C++ (which allocates per window and recomputes log(sigma)
//     per DP cell; here emission constants are hoisted per read).
//
// The math re-expresses the package's numpy oracles (ops/reference.py, with
// citations into the reference there); the control structure is original.
// This file is benchmark-only: the production path never calls it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// from dnascent_native.cpp (same shared object)
extern "C" int64_t event_detect_single(const double*, int64_t, int64_t,
                                       int64_t, float, float, float, double*,
                                       int64_t*, int64_t*, int64_t, int64_t*);

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr double kLogInvSqrt2Pi = -0.9189385332046727;  // ln(1/sqrt(2*pi))

// quantileMedians + least squares -> (shift, scale)
// (oracle: ops/reference.py estimate_scaling_quantiles)
void quantile_scaling(const std::vector<double>& events,
                      const std::vector<double>& model_means,
                      int64_t n_quantiles, double* shift, double* scale) {
    auto qmed = [n_quantiles](std::vector<double> v) {
        std::sort(v.begin(), v.end());
        std::vector<double> out(n_quantiles);
        int64_t n = (int64_t)v.size() / n_quantiles;
        for (int64_t i = 0; i < n_quantiles; ++i)
            out[i] = v[(i * n + (i + 1) * n) / 2];
        return out;
    };
    std::vector<double> sq = qmed(events), mq = qmed(model_means);
    double sx = 0, sx2 = 0, sy = 0, sxy = 0;
    for (int64_t i = 0; i < n_quantiles; ++i) {
        sx += mq[i]; sx2 += mq[i] * mq[i];
        sy += sq[i]; sxy += mq[i] * sq[i];
    }
    double n = (double)n_quantiles;
    double slope = (n * sxy - sx * sy) / (n * sx2 - sx * sx);
    *shift = (sy - slope * sx) / n;
    *scale = slope;
}

struct BandedOut {
    std::vector<std::pair<int64_t, int64_t>> pairs;  // (event, kmer) ascending
    std::vector<double> cleaned_signals;             // backtrace order
    std::vector<int64_t> cleaned_ranks;
    double avg_log_emission = -INFINITY;
    bool spanned = false;
    int64_t max_gap = 0;
    bool qc_pass = false;
};

// adaptive banded DP + backtrace
// (oracle: ops/reference.py adaptive_banded_align)
void banded_align(const std::vector<double>& event_means,
                  const int64_t* rq, int64_t n_kmers,
                  const int64_t* rr, int64_t n_ref_kmers,
                  const int64_t* q2r,  // len n_kmers, -1 = unmapped
                  const double* model,  // (n_model, 2)
                  double shift, double scale,
                  int64_t bandwidth, double eps_skip, double p_trim,
                  double min_avg_log_emission, int64_t max_gap_threshold,
                  int64_t min_cleaned_events, BandedOut* out) {
    const int64_t n_events = (int64_t)event_means.size();
    const int64_t half = bandwidth / 2;
    const double events_per_kmer = (double)n_events / (double)n_kmers;
    const double p_stay = 1.0 - 1.0 / (events_per_kmer + 1.0);
    const float lp_skip = (float)std::log(eps_skip);
    const float lp_stay = (float)std::log(p_stay);
    const float lp_step =
        (float)std::log(1.0 - std::exp((double)lp_skip) - std::exp((double)lp_stay));
    const float lp_trim = (float)std::log(p_trim);

    const int64_t n_bands = n_events + n_kmers + 2;
    std::vector<float> bands((size_t)n_bands * bandwidth, kNegInf);
    std::vector<uint8_t> trace((size_t)n_bands * bandwidth, 0);
    std::vector<int64_t> bll_e(n_bands), bll_k(n_bands);

    // emission terms hoisted per query kmer
    std::vector<float> mu(n_kmers), inv_sigma(n_kmers), lp_const(n_kmers);
    for (int64_t i = 0; i < n_kmers; ++i) {
        double m = model[2 * rq[i]], s = model[2 * rq[i] + 1];
        mu[i] = (float)m;
        inv_sigma[i] = (float)(1.0 / s);
        lp_const[i] = (float)(kLogInvSqrt2Pi - std::log(s));
    }
    std::vector<float> scaled(n_events);
    for (int64_t i = 0; i < n_events; ++i)
        scaled[i] = (float)((event_means[i] - shift) / scale);

    enum { FROM_D = 0, FROM_U = 1, FROM_L = 2 };
    bll_e[0] = half - 1; bll_k[0] = -1 - half;
    bll_e[1] = bll_e[0] + 1; bll_k[1] = bll_k[0];
    bands[0 * bandwidth + (-1 - bll_k[0])] = 0.0f;
    {
        int64_t off = bll_e[1];  // band_event_to_offset(1, 0)
        bands[1 * bandwidth + off] = lp_trim;
        trace[1 * bandwidth + off] = FROM_U;
    }

    for (int64_t bi = 2; bi < n_bands; ++bi) {
        float* row = &bands[(size_t)bi * bandwidth];
        const float* prev1 = &bands[(size_t)(bi - 1) * bandwidth];
        const float* prev2 = &bands[(size_t)(bi - 2) * bandwidth];
        float ll = prev1[0], ur = prev1[bandwidth - 1];
        bool right;
        if (ll == kNegInf && ur == kNegInf) right = (bi % 2) == 1;
        else right = ll < ur;  // Suzuki's rule
        bll_e[bi] = bll_e[bi - 1] + (right ? 0 : 1);
        bll_k[bi] = bll_k[bi - 1] + (right ? 1 : 0);
        const int64_t e0 = bll_e[bi], k0 = bll_k[bi];

        int64_t trim_offset = -1 - k0;
        if (trim_offset >= 0 && trim_offset < bandwidth) {
            int64_t event_idx = e0 - trim_offset;
            if (event_idx >= 0 && event_idx < n_events) {
                row[trim_offset] = lp_trim * (float)(event_idx + 1);
                trace[(size_t)bi * bandwidth + trim_offset] = FROM_U;
            } else {
                row[trim_offset] = kNegInf;
            }
        }

        int64_t min_offset = std::max<int64_t>(
            std::max(0 - k0, e0 - (n_events - 1)), 0);
        int64_t max_offset = std::min<int64_t>(
            std::min(n_kmers - k0, e0 + 1), bandwidth);
        if (min_offset >= max_offset) continue;

        const int64_t e_p1 = bll_e[bi - 1], k_p1 = bll_k[bi - 1];
        const int64_t k_p2 = bll_k[bi - 2];
        for (int64_t o = min_offset; o < max_offset; ++o) {
            const int64_t event_idx = e0 - o;
            const int64_t kmer_idx = k0 + o;
            const int64_t o_up = e_p1 - (event_idx - 1);
            const int64_t o_left = (kmer_idx - 1) - k_p1;
            const int64_t o_diag = (kmer_idx - 1) - k_p2;
            const float up =
                (o_up >= 0 && o_up < bandwidth) ? prev1[o_up] : kNegInf;
            const float left =
                (o_left >= 0 && o_left < bandwidth) ? prev1[o_left] : kNegInf;
            const float diag =
                (o_diag >= 0 && o_diag < bandwidth) ? prev2[o_diag] : kNegInf;
            const float a = (scaled[event_idx] - mu[kmer_idx]) * inv_sigma[kmer_idx];
            const float lp_em = lp_const[kmer_idx] - 0.5f * a * a;
            const float sd = diag + lp_step + lp_em;
            const float su = up + lp_stay + lp_em;
            const float sl = left + lp_skip;
            // tie-breaks mirror the oracle: U beats D, L beats both
            float m = sd; uint8_t f = FROM_D;
            if (su >= m) { m = su; f = FROM_U; }
            if (sl >= m) { m = sl; f = FROM_L; }
            row[o] = m;
            trace[(size_t)bi * bandwidth + o] = f;
        }
    }

    // backtrace
    float max_score = kNegInf;
    int64_t curr_event = 0, curr_kmer = n_kmers - 1;
    for (int64_t event_idx = 0; event_idx < n_events; ++event_idx) {
        int64_t band_idx = (event_idx + 1) + (curr_kmer + 1);
        int64_t offset = bll_e[band_idx] - event_idx;
        if (offset >= 0 && offset < bandwidth) {
            float s = bands[(size_t)band_idx * bandwidth + offset] +
                      (float)(n_events - event_idx) * lp_trim;
            if (s > max_score) { max_score = s; curr_event = event_idx; }
        }
    }

    double sum_emission = 0.0;
    int64_t n_aligned = 0, curr_gap = 0, max_gap = 0;
    std::vector<double> sig_buffer;
    while (curr_kmer >= 0 && curr_event >= 0) {
        out->pairs.emplace_back(curr_event, curr_kmer);
        const float a = (scaled[curr_event] - mu[curr_kmer]) * inv_sigma[curr_kmer];
        sum_emission += (double)(lp_const[curr_kmer] - 0.5f * a * a);
        ++n_aligned;
        int64_t band_idx = (curr_event + 1) + (curr_kmer + 1);
        int64_t offset = bll_e[band_idx] - curr_event;
        uint8_t frm = trace[(size_t)band_idx * bandwidth + offset];
        if (frm == FROM_D) {
            sig_buffer.push_back(event_means[curr_event]);
            int64_t pos_on_ref = q2r[curr_kmer];
            if (pos_on_ref >= 0 && pos_on_ref < n_ref_kmers) {
                out->cleaned_ranks.push_back(rr[pos_on_ref]);
                double s = 0;
                for (double v : sig_buffer) s += v;
                out->cleaned_signals.push_back(s / (double)sig_buffer.size());
            }
            sig_buffer.clear();
            --curr_kmer; --curr_event; curr_gap = 0;
        } else if (frm == FROM_U) {
            sig_buffer.push_back(event_means[curr_event]);
            --curr_event; curr_gap = 0;
        } else {
            --curr_kmer; ++curr_gap;
            max_gap = std::max(max_gap, curr_gap);
        }
    }
    std::reverse(out->pairs.begin(), out->pairs.end());
    out->avg_log_emission =
        n_aligned ? sum_emission / (double)n_aligned : -INFINITY;
    out->spanned = !out->pairs.empty() && out->pairs.front().second == 0 &&
                   out->pairs.back().second == n_kmers - 1;
    out->max_gap = max_gap;
    out->qc_pass = out->avg_log_emission >= min_avg_log_emission &&
                   out->spanned && max_gap <= max_gap_threshold &&
                   (int64_t)out->cleaned_signals.size() >= min_cleaned_events;
}

// Theil-Sen refinement (oracle: ops/reference.py estimate_scaling_theilsen)
void theilsen(const std::vector<double>& signals,
              const std::vector<double>& model_means, double* shift,
              double* scale, int64_t max_points, int64_t trim) {
    const int64_t n_mm = (int64_t)model_means.size();
    if (n_mm < max_points) return;  // unchanged (minLength = maxPoints)
    int64_t effective = (int64_t)signals.size() - 2 * trim;
    int64_t skip = effective > max_points ? effective / max_points : 1;
    int64_t num = effective > max_points ? max_points : effective;
    std::vector<double> x(num), y(num);
    for (int64_t i = 0; i < num; ++i) {
        int64_t j = trim + skip * i;
        x[i] = (signals[j] - *shift) / *scale;
        y[i] = model_means[j];
    }
    std::vector<double> slopes;
    slopes.reserve((size_t)num * (num - 1) / 2);
    for (int64_t i = 0; i < num; ++i)
        for (int64_t j = i + 1; j < num; ++j) {
            double dx = x[i] - x[j];
            slopes.push_back((y[i] - y[j]) / dx);  // inf/nan kept, like numpy
        }
    // median = element at len/2 of the ascending sort (NaNs sort last under
    // this comparator, matching np.sort's NaN-at-end ordering)
    auto nth = [](std::vector<double>& v, size_t k) {
        std::nth_element(v.begin(), v.begin() + k, v.end(),
                         [](double a, double b) {
                             if (std::isnan(a)) return false;
                             if (std::isnan(b)) return true;
                             return a < b;
                         });
        return v[k];
    };
    double m = nth(slopes, slopes.size() / 2);
    std::vector<double> inter(num);
    for (int64_t i = 0; i < num; ++i) inter[i] = y[i] - m * x[i];
    double b = nth(inter, inter.size() / 2);
    if (m == 0.0) { *shift = -1.0; *scale = -1.0; return; }
    *shift = *shift + (-b / m) * *scale;
    *scale = *scale * (1.0 / m);
}

// 3-state-per-kmer windowed Viterbi with full backtrace
// (oracle: ops/reference.py builtin_viterbi)
struct ViterbiScratch {
    std::vector<double> I_prev, M_prev, D_prev, I_curr, M_curr, D_curr, em;
    std::vector<int32_t> btS, btT;  // (3n, T+1)
};

double viterbi_window(const double* obs_raw, int64_t T, const int64_t* ranks,
                      int64_t n, const double* model, double shift,
                      double scale, double events_per_base,
                      const double* hmm,  // eD2D,eD2M,eI2M,eM2D,iM2I,iI2I
                      ViterbiScratch* s) {
    const double eD2D = std::log(hmm[0]), eD2M = std::log(hmm[1]);
    const double eI2M = std::log(hmm[2]), eM2D = std::log(hmm[3]);
    const double iM2I = std::log(hmm[4]), iI2I = std::log(hmm[5]);
    const double iM2M = std::log(1.0 - 1.0 / events_per_base);
    const double eM2M =
        std::log(1.0 - hmm[3] - hmm[4] - (1.0 - 1.0 / events_per_base));
    auto lgadd = [](double a, double b) {
        if (a == -INFINITY) return b;
        if (b == -INFINITY) return a;
        double hi = std::max(a, b);
        return hi + std::log1p(std::exp(std::min(a, b) - hi));
    };
    const double eM2MorD = lgadd(eM2M, eM2D);
    const double eOrIM2M = lgadd(eM2M, iM2M);

    std::vector<double> mu(n), sg(n), lc(n);
    for (int64_t i = 0; i < n; ++i) {
        mu[i] = model[2 * ranks[i]];
        sg[i] = model[2 * ranks[i] + 1];
        lc[i] = -0.5 * std::log(2.0 * M_PI * sg[i] * sg[i]);
    }
    const int64_t D_off = 0, M_off = n, I_off = 2 * n;
    s->I_prev.assign(n, -INFINITY);
    s->M_prev.assign(n, -INFINITY);
    s->D_prev.assign(n, -INFINITY);
    s->I_curr.resize(n); s->M_curr.resize(n); s->D_curr.resize(n);
    s->em.resize(n);
    s->btS.assign((size_t)3 * n * (T + 1), -2);
    s->btT.assign((size_t)3 * n * (T + 1), 0);
    auto BS = [&](int64_t st, int64_t t) -> int32_t& {
        return s->btS[(size_t)st * (T + 1) + t];
    };
    auto BT = [&](int64_t st, int64_t t) -> int32_t& {
        return s->btT[(size_t)st * (T + 1) + t];
    };

    double start_prev = 0.0;
    s->D_prev[0] = start_prev + eM2D;
    BS(D_off, 0) = -1;
    for (int64_t i = 1; i < n; ++i) {
        s->D_prev[i] = s->D_prev[i - 1] + eD2D;
        BS(D_off + i, 0) = (int32_t)(D_off + i - 1);
    }

    for (int64_t t = 0; t < T; ++t) {
        for (int64_t i = 0; i < n; ++i) {
            double z = ((obs_raw[t] - shift) / scale - mu[i]) / sg[i];
            s->em[i] = lc[i] - 0.5 * z * z;
        }
        // base 1 insertion: candidates I0+iI2I, M0+iM2I, start+iM2I
        {
            double c0 = s->I_prev[0] + iI2I, c1 = s->M_prev[0] + iM2I,
                   c2 = start_prev + iM2I;
            double m = c0; int a = 0;
            if (c1 > m) { m = c1; a = 1; }
            if (c2 > m) { m = c2; a = 2; }
            s->I_curr[0] = m;
            BS(I_off, t + 1) =
                (a == 0) ? (int32_t)I_off : (a == 1) ? (int32_t)M_off : -1;
            BT(I_off, t + 1) = (int32_t)t;
        }
        // base 1 match
        {
            double c0 = s->M_prev[0] + iM2M + s->em[0],
                   c1 = start_prev + eOrIM2M + s->em[0];
            s->M_curr[0] = std::max(c0, c1);
            BS(M_off, t + 1) = (c0 >= c1) ? (int32_t)M_off : -1;
            BT(M_off, t + 1) = (int32_t)t;
        }
        s->D_curr[0] = -INFINITY;
        BS(D_off, t + 1) = -1;
        BT(D_off, t + 1) = (int32_t)(t + 1);

        for (int64_t i = 1; i < n; ++i) {
            // insertion: I-before-M tie-break
            double ci0 = s->I_prev[i] + iI2I, ci1 = s->M_prev[i] + iM2I;
            if (ci0 >= ci1) {
                s->I_curr[i] = ci0; BS(I_off + i, t + 1) = (int32_t)(I_off + i);
            } else {
                s->I_curr[i] = ci1; BS(I_off + i, t + 1) = (int32_t)(M_off + i);
            }
            BT(I_off + i, t + 1) = (int32_t)t;
            // match: candidate order I, M-ext, M-int, D (first-wins)
            double e = s->em[i];
            double cm[4] = {s->I_prev[i - 1] + eI2M + e,
                            s->M_prev[i - 1] + eM2M + e,
                            s->M_prev[i] + iM2M + e,
                            s->D_prev[i - 1] + eD2M + e};
            int32_t pv[4] = {(int32_t)(I_off + i - 1), (int32_t)(M_off + i - 1),
                             (int32_t)(M_off + i), (int32_t)(D_off + i - 1)};
            double m = cm[0]; int a = 0;
            for (int j = 1; j < 4; ++j)
                if (cm[j] > m) { m = cm[j]; a = j; }
            s->M_curr[i] = m;
            BS(M_off + i, t + 1) = pv[a];
            BT(M_off + i, t + 1) = (int32_t)t;
        }
        // deletions: sequential within the timestep
        for (int64_t i = 1; i < n; ++i) {
            double c0 = s->M_curr[i - 1] + eM2D, c1 = s->D_curr[i - 1] + eD2D;
            if (c0 >= c1) {
                s->D_curr[i] = c0; BS(D_off + i, t + 1) = (int32_t)(M_off + i - 1);
            } else {
                s->D_curr[i] = c1; BS(D_off + i, t + 1) = (int32_t)(D_off + i - 1);
            }
            BT(D_off + i, t + 1) = (int32_t)(t + 1);
        }
        std::swap(s->I_prev, s->I_curr);
        std::swap(s->M_prev, s->M_curr);
        std::swap(s->D_prev, s->D_curr);
        start_prev = -INFINITY;
    }

    double c0 = s->D_prev[n - 1], c1 = s->M_prev[n - 1] + eM2MorD,
           c2 = s->I_prev[n - 1] + eI2M;
    double score = c0; int64_t tb = D_off + n - 1;
    if (c1 > score) { score = c1; tb = M_off + n - 1; }
    if (c2 > score) { score = c2; tb = I_off + n - 1; }
    // full backtrace walk (the reference materialises the path; keep the
    // cost honest even though the baseline only consumes the score)
    int64_t tb_t = T;
    volatile int64_t path_len = 0;
    while (tb != -1) {
        int64_t nb = BS(tb, tb_t);
        tb_t = BT(tb, tb_t);
        tb = nb;
        ++path_len;
    }
    (void)path_len;
    return score;
}

}  // namespace

extern "C" {

// Full per-read hot path.  Returns the sum of window Viterbi scores (a
// checksum so the work cannot be elided), or NaN when the read fails the
// banded QC gates — mirroring the detect pipeline's failure handling.
double baseline_detect_read(
    const double* raw, int64_t n_raw,
    const int64_t* rq, int64_t n_q,        // query kmer ranks
    const int64_t* rr, int64_t n_r,        // reference kmer ranks
    const int64_t* q2r,                    // len n_q, -1 = unmapped
    const double* model, int64_t n_model,  // (n_model, 2) mean/stdv rows
    // event detection params
    int64_t w1, int64_t w2, double t1, double t2, double peak_height,
    // scaling params
    int64_t n_quantiles, int64_t ts_max_points, int64_t ts_trim,
    // banded params
    int64_t bandwidth, double eps_skip, double p_trim,
    double min_avg_log_emission, int64_t max_gap_threshold,
    int64_t min_cleaned_events,
    // hmm transitions: eD2D,eD2M,eI2M,eM2D,iM2I,iI2I (probabilities)
    const double* hmm,
    // window geometry
    int64_t window_len, int64_t kmer_len) {
    (void)n_model;
    // 1. event detection + merge
    std::vector<double> ev_mean(n_raw + 1);
    std::vector<int64_t> ev_start(n_raw + 1), ev_end(n_raw + 1);
    int64_t et_n = 0;
    int64_t m = event_detect_single(raw, n_raw, w1, w2, (float)t1, (float)t2,
                                    (float)peak_height, ev_mean.data(),
                                    ev_start.data(), ev_end.data(), n_raw + 1,
                                    &et_n);
    ev_mean.resize(m);
    if (m < 2) return NAN;

    // 2. quantile scaling against reference-rank model means
    std::vector<double> mm(n_r);
    for (int64_t i = 0; i < n_r; ++i)
        mm[i] = model[2 * (rr[i] < 0 ? 0 : rr[i])];
    double shift, scale;
    quantile_scaling(ev_mean, mm, n_quantiles, &shift, &scale);

    // 3. adaptive banded alignment (query ranks clamped like the pipeline)
    std::vector<int64_t> rq_c(rq, rq + n_q), rr_c(rr, rr + n_r);
    for (auto& v : rq_c) if (v < 0) v = 0;
    for (auto& v : rr_c) if (v < 0) v = 0;
    BandedOut br;
    banded_align(ev_mean, rq_c.data(), n_q, rr_c.data(), n_r, q2r, model,
                 shift, scale, bandwidth, eps_skip, p_trim,
                 min_avg_log_emission, max_gap_threshold, min_cleaned_events,
                 &br);
    if (!br.qc_pass) return NAN;

    // 4. Theil-Sen refinement on the cleaned signal
    std::vector<double> mm_clean(br.cleaned_ranks.size());
    for (size_t i = 0; i < br.cleaned_ranks.size(); ++i)
        mm_clean[i] = model[2 * br.cleaned_ranks[i]];
    double sh2 = shift, sc2 = scale;
    theilsen(br.cleaned_signals, mm_clean, &sh2, &sc2, ts_max_points, ts_trim);
    if (sh2 == -1.0) { sh2 = shift; sc2 = scale; }

    // 5. windowed Viterbi over the read (fast-mode geometry, identical to
    //    bench.py's oracle loop: independent windows advancing by their
    //    kmer span, observations = banded-assigned event means)
    const double epb =
        std::max(1.01, (double)et_n / std::max<int64_t>(1, n_q));
    const int64_t ns = window_len - kmer_len + 1;
    ViterbiScratch scratch;
    double checksum = 0.0;
    // pairs are ascending in both coords; binary search on the kmer column
    auto lower = [&](int64_t key) {
        size_t lo = 0, hi = br.pairs.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (br.pairs[mid].second < key) lo = mid + 1; else hi = mid;
        }
        return lo;
    };
    for (int64_t i = 0; i + ns <= n_r; i += ns) {
        size_t lo = lower(i), hi = lower(i + ns);
        if (hi <= lo) continue;
        int64_t e_lo = br.pairs[lo].first;
        int64_t e_hi =
            br.pairs[std::min(hi, br.pairs.size() - 1)].first;
        int64_t T = e_hi - e_lo + 1;
        if (T <= 1) continue;
        checksum += viterbi_window(&ev_mean[e_lo], T, &rr_c[i], ns, model,
                                   sh2, sc2, epb, hmm, &scratch);
    }
    return checksum;
}

}  // extern "C"
