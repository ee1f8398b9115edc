// dnascent_native — host-side C++ of the PyTorch port.
//
// A copy of the entries of dnascent_tpu/native/dnascent_native.cpp that the
// port calls: the scrappie event-detection FSM (prep), the decode of the
// backtrace chase's packed move stream (prep), and the fast-mode eventalign
// window chain and window post-processing (eventalign).  These are cheap but
// sequential host steps; they run with the GIL released through ctypes.
//
// Plain C ABI, loaded through ctypes by native/__init__.py, which builds it
// with g++ at first use.  Algorithm citations refer to the reference
// (MBoemo/DNAscent v4.1.1).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Event detection (mirrors src/scrappie/event_detection.c)
// ---------------------------------------------------------------------------

// t-stat with two windows + short/long peak FSM + event merge as done by
// normaliseEvents (event_handling.cpp:544-575).  Outputs the *merged* events:
// first event carries mean 0.0 and the final raw event is dropped, mirroring
// the reference's lag quirk.
//
// Returns number of merged events written (<= max_out).  raw_n is the signal
// length; outputs: mean (f64), raw_start/raw_end (i64, inclusive).
// et_n_out receives the raw event count (for eventsPerBase).
int64_t event_detect_single(const double* raw, int64_t raw_n,
                            int64_t w1, int64_t w2,
                            float thresh1, float thresh2, float peak_height,
                            double* out_mean, int64_t* out_start,
                            int64_t* out_end, int64_t max_out,
                            int64_t* et_n_out) {
    if (raw_n <= 0) { *et_n_out = 0; return 0; }
    std::vector<double> sums(raw_n + 1), sumsqs(raw_n + 1);
    sums[0] = 0.0; sumsqs[0] = 0.0;
    for (int64_t i = 0; i < raw_n; ++i) {
        sums[i + 1] = sums[i] + raw[i];
        sumsqs[i + 1] = sumsqs[i] + raw[i] * raw[i];
    }

    auto tstat = [&](int64_t w, std::vector<float>& out) {
        out.assign(raw_n, 0.0f);
        if (raw_n < 2 * w || w < 2) return;
        const float eta = FLT_MIN;
        const float wf = (float)w;
        for (int64_t i = w; i <= raw_n - w; ++i) {
            double sum1 = sums[i], sumsq1 = sumsqs[i];
            if (i > w) { sum1 -= sums[i - w]; sumsq1 -= sumsqs[i - w]; }
            float sum2 = (float)(sums[i + w] - sums[i]);
            float sumsq2 = (float)(sumsqs[i + w] - sumsqs[i]);
            float mean1 = sum1 / wf, mean2 = sum2 / wf;
            float cv = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2;
            cv = std::max(cv, eta);
            out[i] = std::fabs(mean2 - mean1) / std::sqrt(cv / wf);
        }
    };
    std::vector<float> t1, t2;
    tstat(w1, t1);
    tstat(w2, t2);

    // short/long peak detector (event_detection.c:122-198)
    struct Det {
        const float* sig; float threshold; int64_t window;
        int64_t masked_to; int64_t peak_pos; float peak_value; bool valid;
    };
    Det det[2] = {
        {t1.data(), thresh1, w1, 0, -1, FLT_MAX, false},
        {t2.data(), thresh2, w2, 0, -1, FLT_MAX, false},
    };
    std::vector<int64_t> peaks;
    peaks.reserve(raw_n / 4);
    for (int64_t i = 0; i < raw_n; ++i) {
        for (int k = 0; k < 2; ++k) {
            Det& d = det[k];
            if (d.masked_to >= i) continue;
            float cur = d.sig[i];
            if (d.peak_pos == -1) {
                if (cur < d.peak_value) d.peak_value = cur;
                else if (cur - d.peak_value > peak_height) {
                    d.peak_value = cur; d.peak_pos = i;
                }
            } else {
                if (cur > d.peak_value) { d.peak_value = cur; d.peak_pos = i; }
                if (k == 0 && d.peak_value > d.threshold) {
                    det[1].masked_to = d.peak_pos + d.window;
                    det[1].peak_pos = -1; det[1].peak_value = FLT_MAX;
                    det[1].valid = false;
                }
                if (d.peak_value - cur > peak_height && d.peak_value > d.threshold)
                    d.valid = true;
                if (d.valid && (i - d.peak_pos) > d.window / 2) {
                    peaks.push_back(d.peak_pos);
                    d.peak_pos = -1; d.peak_value = cur; d.valid = false;
                }
            }
        }
    }

    // create_events (event_detection.c:234-266)
    std::vector<int64_t> bounds;
    bounds.reserve(peaks.size() + 2);
    bounds.push_back(0);
    for (int64_t p : peaks) if (p > 0 && p < raw_n) bounds.push_back(p);
    bounds.push_back(raw_n);
    int64_t et_n = (int64_t)bounds.size() - 1;
    *et_n_out = et_n;

    // merged events (event_handling.cpp:550-575): faithful lag quirk
    int64_t n_out = 0;
    int64_t raw_start = 0;
    double mean = 0.0;
    for (int64_t i = 0; i < et_n; ++i) {
        int64_t s = bounds[i], e = bounds[i + 1];
        double m = (sums[e] - sums[s]) / (double)(e - s);
        // float cast as in create_event (event_detection.c:226)
        float mf = (float)m;
        if (mf > 0.0f) {
            if (i > 0) {
                if (n_out >= max_out) break;
                out_mean[n_out] = mean;
                out_start[n_out] = raw_start;
                out_end[n_out] = std::min(s - 1, raw_n - 1);
                ++n_out;
                mean = (double)mf;
                raw_start = s;
            }
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Fast-mode eventalign post-processing
// ---------------------------------------------------------------------------

// Walk every window's Viterbi path of one read and emit the per-reference-
// position aligned rows plus the CNN's flat u8 signal stream — the native
// twin of pipeline/eventalign._process_read_windows_batched (reference
// semantics: alignment.cpp:654-740).  Runs with the GIL released via ctypes,
// so pipeline threads overlap for real on a 2-core host.
//
// codes: concatenated per-window path codes (kind | delta<<2, forward
// order); positions are recovered by suffix-anchoring the delta sum at
// ns-1.  Segments group consecutive M steps at the same position (stay
// chains); nsig counts every sample of the segment while sig_flat keeps the
// first `rawdepth`.  Returns the number of positions written.
int64_t process_read_windows(
    const uint8_t* codes, const int64_t* steps_per, const int64_t* ns_per,
    const int64_t* g_ev, const int64_t* ev_start,
    const int64_t* ri_arr, const int64_t* rc_arr, const int64_t* indel_arr,
    int64_t n_windows, int64_t is_reverse, int64_t k,
    const int64_t* ev_raw_start, const int64_t* ev_raw_end,
    const double* raw, double shift, double scale,
    const int64_t* ref_to_query, const int64_t* core_rank,
    const int64_t* res_rank, const int8_t* ref_codes,
    float quant_lo, float quant_scale, int64_t rawdepth,
    int64_t* coord, int64_t* kmer_start, int64_t* query_idx, int64_t* ref_idx,
    int64_t* core, int64_t* res, int64_t* nsig, uint8_t* centerT,
    int64_t* indel_out,
    uint8_t* sig_flat, int64_t* sig_flat_len,
    float* scaled_stream, int64_t max_samples, int64_t* seg_start,
    int64_t* n_samples_out) {
    int64_t P = 0, fl = 0, samp = 0;
    int64_t code_off = 0;
    const int64_t half_k = k / 2;
    for (int64_t w = 0; w < n_windows; ++w) {
        const int64_t S = steps_per[w];
        const int64_t ns = ns_per[w];
        const uint8_t* c = codes + code_off;
        int64_t total = 0;
        for (int64_t t = 0; t < S; ++t) total += (c[t] >> 2) & 1;
        int64_t csum = 0;
        int64_t ev_local = -1;
        int64_t prev_pos = INT64_MIN;
        for (int64_t t = 0; t < S; ++t) {
            const uint8_t kind = c[t] & 3;
            csum += (c[t] >> 2) & 1;
            if (kind != 0) ++ev_local;       // non-D advances the event cursor
            if (kind != 1) continue;         // only M steps emit positions
            const int64_t pos = ns - 1 - (total - csum);
            const int64_t ev = g_ev[ev_start[w] + ev_local];
            const int64_t rs = ev_raw_start[ev];
            const int64_t cnt = ev_raw_end[ev] - rs + 1;
            if (pos != prev_pos) {
                const int64_t ksv = ri_arr[w] + pos;
                coord[P] = is_reverse ? rc_arr[w] - pos - 1 : rc_arr[w] + pos;
                kmer_start[P] = ksv;
                ref_idx[P] = ksv + half_k;
                query_idx[P] = ref_to_query[ksv + half_k];
                core[P] = core_rank[ksv];
                res[P] = res_rank[ksv];
                centerT[P] = ref_codes[ksv + half_k] == 1 ? 1 : 0;
                indel_out[P] = indel_arr[w];
                nsig[P] = 0;
                seg_start[P] = samp;
                ++P;
                prev_pos = pos;
            }
            for (int64_t i = 0; i < cnt && samp < max_samples; ++i) {
                const float v = (float)((raw[rs + i] - shift) / scale);
                scaled_stream[samp++] = v;
                if (nsig[P - 1] + i < rawdepth) {
                    float q = nearbyintf((v - quant_lo) * quant_scale) + 1.0f;
                    q = q < 1.0f ? 1.0f : (q > 255.0f ? 255.0f : q);
                    sig_flat[fl++] = (uint8_t)q;
                }
            }
            nsig[P - 1] += cnt;
        }
        code_off += S;
    }
    *sig_flat_len = fl;
    *n_samples_out = samp;
    return P;
}

// ---------------------------------------------------------------------------
// Fast-mode window chain (twin of the scalar loop in
// pipeline/eventalign._build_window_set; window rules from
// alignment.cpp:555-650 with the full-span advance departure)
// ---------------------------------------------------------------------------

// All lookup tables are precomputed vectorised on the host; this walks the
// inherently sequential chain of window starts.  Returns the window count.
int64_t window_chain(const int64_t* undef_cum, const int64_t* bp_pos,
                     int64_t n_bp, const int64_t* next_bp,
                     const int64_t* j_at, const int64_t* guard_cum,
                     int64_t ref_len, int64_t k, int64_t total_wl,
                     int64_t* ri_out, int64_t* wl_out, int64_t* j0_out,
                     int64_t* j1_out) {
    const int64_t n_kmer_max = ref_len - k + 1;
    int64_t n = 0;
    int64_t ri = 0;
    while (ri < n_kmer_max) {
        int64_t bases_to_end = ref_len - ri;
        int64_t wl = bases_to_end < total_wl ? bases_to_end : total_wl;
        if (2 * bases_to_end > 3 * total_wl) {
            // here wl == total_wl; int(1.5*wl) == (3*wl)/2 for wl >= 0
            int64_t snip_len = (3 * wl) / 2;
            if (undef_cum[ri + snip_len] - undef_cum[ri]) {
                ri += wl;
                continue;
            }
            int64_t limit = (3 * wl) / 2 - k - 1;
            int64_t bi = next_bp[ri + wl];
            if (bi < n_bp && bp_pos[bi] < ri + limit)
                wl = bp_pos[bi] - ri + k;
        }
        if (undef_cum[ri + wl] - undef_cum[ri]) {
            ri += wl;
            continue;
        }
        int64_t j0 = j_at[ri];
        int64_t j1 = j_at[ri + wl - k + 1];
        if (j1 <= j0 || guard_cum[j1] - guard_cum[j0] < 2) {
            ri += wl;
            continue;
        }
        ri_out[n] = ri;
        wl_out[n] = wl;
        j0_out[n] = j0;
        j1_out[n] = j1;
        ++n;
        ri += wl - k + 1;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Packed-move backtrace decode (twin of ops/banded.decode_moves_host)
// ---------------------------------------------------------------------------

// Decodes one read's packed 2-bit move stream (column `col` of the
// (rows, B)-shaped device download) into event-alignment pairs, QC
// statistics and the Theil-Sen cleaned signals — the same outputs as
// decode_moves_host (event_handling.cpp:318-443 semantics).  Moves arrive in
// backward order (path end first); pairs_out is reversed to ascending order
// before returning.  Returns the number of pairs.
//
// stats_out: [avg_log_emission, spanned, max_gap, n_pairs, n_cleaned]
int64_t decode_moves(const uint8_t* packed, int64_t rows, int64_t B,
                     int64_t col, int64_t best_event, int64_t n_kmers,
                     const double* event_means, const float* scaled_events,
                     const float* mu, const float* inv_sigma,
                     const float* lp_const, const int64_t* query_to_ref,
                     const int64_t* kmer_ranks_ref, int64_t n_ref_kmers,
                     int64_t* pairs_out, int64_t max_pairs,
                     double* cleaned_signal_out, int64_t* cleaned_rank_out,
                     double* stats_out) {
    const int MOVE_D = 0, MOVE_U = 1, MOVE_L = 2, MOVE_PAD = 3;
    int64_t e = best_event, k = n_kmers - 1;
    int64_t n_pairs = 0, n_cleaned = 0;
    double sum_emission = 0.0;
    int64_t curr_gap = 0, max_gap = 0;
    // cleaned-segment accumulator: D/U event means since the last D
    double seg_sum = 0.0;
    int64_t seg_count = 0;
    for (int64_t r = 0; r < rows; ++r) {
        uint8_t byte = packed[r * B + col];
        for (int j = 0; j < 4; ++j) {
            int move = (byte >> (2 * j)) & 3;
            // PAD is a gap, not a terminator: the Pallas chase emits a
            // band-ordered stream with PADs at bands a read skipped
            // (diagonal move) or had not reached; skipping preserves the
            // walk order (bands decrease monotonically), and the scan
            // chase's tail-only PADs behave identically under a skip
            if (move == MOVE_PAD) continue;
            if (e < 0 || k < 0) goto done;
            if (n_pairs < max_pairs) {
                pairs_out[2 * n_pairs] = e;
                pairs_out[2 * n_pairs + 1] = k;
            }
            ++n_pairs;
            float a = (scaled_events[e] - mu[k]) * inv_sigma[k];
            sum_emission += (double)(lp_const[k] - 0.5f * a * a);
            if (move == MOVE_D) {
                seg_sum += event_means[e];
                ++seg_count;
                int64_t por = query_to_ref[k];
                if (por >= 0 && por < n_ref_kmers) {
                    cleaned_signal_out[n_cleaned] =
                        seg_sum / (double)(seg_count > 0 ? seg_count : 1);
                    cleaned_rank_out[n_cleaned] = kmer_ranks_ref[por];
                    ++n_cleaned;
                }
                seg_sum = 0.0;
                seg_count = 0;
                --e;
                --k;
                curr_gap = 0;
            } else if (move == MOVE_U) {
                seg_sum += event_means[e];
                ++seg_count;
                --e;
                curr_gap = 0;
            } else {  // MOVE_L
                --k;
                ++curr_gap;
                if (curr_gap > max_gap) max_gap = curr_gap;
            }
        }
    }
done:
    int64_t m = std::min(n_pairs, max_pairs);
    for (int64_t i = 0; i < m / 2; ++i) {
        std::swap(pairs_out[2 * i], pairs_out[2 * (m - 1 - i)]);
        std::swap(pairs_out[2 * i + 1], pairs_out[2 * (m - 1 - i) + 1]);
    }
    bool spanned = false;
    if (m > 0)
        spanned = (pairs_out[1] == 0)
                  && (pairs_out[2 * (m - 1) + 1] == n_kmers - 1);
    stats_out[0] =
        n_pairs ? sum_emission / (double)n_pairs : -INFINITY;
    stats_out[1] = spanned ? 1.0 : 0.0;
    stats_out[2] = (double)max_gap;
    stats_out[3] = (double)n_pairs;
    stats_out[4] = (double)n_cleaned;
    return m;
}

}  // extern "C"
