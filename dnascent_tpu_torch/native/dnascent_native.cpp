// dnascent_native — host-side C++ of the PyTorch port.
//
// The port's copies of entries of dnascent_tpu/native/dnascent_native.cpp,
// and its own: the scrappie event-detection FSM (prep), the decode of the
// backtrace chase's packed move stream (prep), prep's batch entries (k-mer
// ranks and quantile scaling a batch, a fill group's padded rows, a fill
// group's move decode, QC and Theil-Sen subsample), eventalign's batch entry
// (every read's state arrays and fast-mode window chain in one call) and
// window post-processing, the libstdc++-exact RNG streams of seeBreaks'
// parity mode, and the eventalign table's row formatter (align, trainCNN).
// These are cheap but sequential host steps; they run with the GIL released
// through ctypes.
//
// Plain C ABI, loaded through ctypes by native/__init__.py, which builds it
// with g++ at first use.  Algorithm citations refer to the reference
// (MBoemo/DNAscent v4.1.1).

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <random>
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
// Eventalign's batch entry: every read's state arrays and fast-mode window
// set in one call (the twin of the JAX package's eventalign._build_state and
// _build_window_set, read by read; window rules from alignment.cpp:555-650
// with the full-span advance departure)
// ---------------------------------------------------------------------------

// The chain of one read's window starts, inherently sequential: each advance
// depends on the previous window's length.  undef_cum is the prefix count of
// undefined bases, bp_pos the breakpoint positions (ascending), pair_q the
// query k-mer index of each pair (ascending), guard_cum the prefix count of
// pairs whose event passes the mean guard.  The numpy path's lookup tables
// j_at (first pair with query >= r2q[i]) and next_bp (first breakpoint >= i)
// are binary searches here, made only where the chain looks.  Returns the
// window count, or -4 when a reference index falls outside ref_to_query.
static int64_t window_chain(const int64_t* undef_cum,
                            const std::vector<int64_t>& bp_pos,
                            const std::vector<int64_t>& pair_q,
                            const int64_t* r2q, int64_t n_r2q,
                            const int64_t* guard_cum, int64_t ref_len,
                            int64_t k, int64_t total_wl, int64_t* ri_out,
                            int64_t* wl_out, int64_t* j0_out,
                            int64_t* j1_out) {
    auto j_at = [&](int64_t i) -> int64_t {
        return std::lower_bound(pair_q.begin(), pair_q.end(), r2q[i])
               - pair_q.begin();
    };
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
            auto bi = std::lower_bound(bp_pos.begin(), bp_pos.end(), ri + wl);
            if (bi != bp_pos.end() && *bi < ri + limit)
                wl = *bi - ri + k;
        }
        if (undef_cum[ri + wl] - undef_cum[ri]) {
            ri += wl;
            continue;
        }
        if (ri + wl - k + 1 >= n_r2q) return -4;
        int64_t j0 = j_at(ri);
        int64_t j1 = j_at(ri + wl - k + 1);
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

// meta: one row of META_COLS a read, [reference length, k-mer ranks,
// pairs, events, ref_to_query length, ref_start, ref_end, is_reverse].
// Inputs concatenated in read order: seq (the reference bytes), kmer_ranks
// (-1 for an undefined k-mer), pairs ((event id in the read, query k-mer
// index) rows, ascending), event_mean, r2q; pore_mean is the pore model's
// mean a k-mer rank.  Outputs, concatenated in read order at the offsets
// written to offs_out ((n_reads + 1) rows of [reference, k-mer, rank,
// window, guarded event]):
//   codes (A=0 T=1 G=2 C=3, -1 otherwise) and defined, a byte a base;
//   core and res, the CNN's indices, a k-mer (max(0, ref_len - k + 1));
//   mean_ref, the model mean of each k-mer rank (undefined -> rank 0);
//   with with_windows, ri, ns, g0, g1 (clipped to g0 + t_cap), ref_coord and
//   indel a window, and gev, the read's guarded event ids, for every read
//   with a window (a read with none gets neither).
// Returns the window count, or -1 for k < 9, -2 for a k-mer rank outside
// the pore table, -3 for a pair's event id outside its read's events, -4
// for a reference index outside its read's ref_to_query.
int64_t eventalign_batch(
    const uint8_t* seq, const int64_t* meta, int64_t n_reads,
    const int64_t* kmer_ranks, const int64_t* pairs, const double* event_mean,
    const int64_t* r2q, const double* pore_mean, int64_t n_model, int64_t k,
    int64_t total_wl, double dmin, double dmax, int64_t t_cap,
    int64_t with_windows,
    int8_t* codes_out, uint8_t* defined_out, int64_t* core_out,
    int64_t* res_out, double* mean_out, int64_t* ri_out, int64_t* ns_out,
    int64_t* g0_out, int64_t* g1_out, int64_t* rc_out, int64_t* indel_out,
    int64_t* gev_out, int64_t* offs_out) {
    const int META_COLS = 8;
    if (k < 9) return -1;
    static const auto code_of = [] {
        std::array<int8_t, 256> t{};
        t.fill(-1);
        t['A'] = t['a'] = 0; t['T'] = t['t'] = 1;
        t['G'] = t['g'] = 2; t['C'] = t['c'] = 3;
        return t;
    }();
    int64_t ref_o = 0, kmer_o = 0, rank_o = 0, win_o = 0, gev_o = 0;
    int64_t pair_o = 0, ev_o = 0, r2q_o = 0;
    std::vector<int64_t> undef_cum, guard_cum, bp_pos, pair_q;
    std::vector<int64_t> wl_w, j0_w, j1_w;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t* m = meta + r * META_COLS;
        const int64_t ref_len = m[0], n_rank = m[1], n_pairs = m[2];
        const int64_t n_ev = m[3], n_r2q = m[4];
        const int64_t ref_start = m[5], ref_end = m[6], is_reverse = m[7];
        int64_t* offs = offs_out + r * 5;
        offs[0] = ref_o; offs[1] = kmer_o; offs[2] = rank_o;
        offs[3] = win_o; offs[4] = gev_o;

        int8_t* codes = codes_out + ref_o;
        for (int64_t i = 0; i < ref_len; ++i) {
            codes[i] = code_of[seq[ref_o + i]];
            defined_out[ref_o + i] = codes[i] >= 0;
        }
        // the CNN's core (k-mer digits 2..6) and residual (0, 1, 7, 8)
        // indices, +1, with undefined bases read as A
        const int64_t n_kmer = ref_len - k + 1 > 0 ? ref_len - k + 1 : 0;
        for (int64_t i = 0; i < n_kmer; ++i) {
            int64_t s[9];
            for (int j = 0; j < 9; ++j)
                s[j] = codes[i + j] < 0 ? 0 : codes[i + j];
            core_out[kmer_o + i] =
                (((s[2] * 4 + s[3]) * 4 + s[4]) * 4 + s[5]) * 4 + s[6] + 1;
            res_out[kmer_o + i] =
                ((s[0] * 4 + s[1]) * 4 + s[7]) * 4 + s[8] + 1;
        }
        const double* mean = mean_out + rank_o;
        for (int64_t i = 0; i < n_rank; ++i) {
            int64_t rk = kmer_ranks[rank_o + i];
            if (rk < 0) rk = 0;
            if (rk >= n_model) return -2;
            mean_out[rank_o + i] = pore_mean[rk];
        }

        if (with_windows && n_kmer > 0) {
            undef_cum.assign(ref_len + 1, 0);
            for (int64_t i = 0; i < ref_len; ++i)
                undef_cum[i + 1] = undef_cum[i] + (codes[i] < 0);
            // breakpoints: model-mean gaps to both neighbours above 0.75
            bp_pos.clear();
            for (int64_t i = 1; i + 1 < n_rank; ++i)
                if (std::fabs(mean[i + 1] - mean[i]) > 0.75
                        && std::fabs(mean[i] - mean[i - 1]) > 0.75)
                    bp_pos.push_back(i);
            // the event-mean guard over the pairs; the guarded ids are the
            // read's event stream, kept only if the read has a window
            const int64_t* pr = pairs + 2 * pair_o;
            guard_cum.assign(n_pairs + 1, 0);
            pair_q.resize(n_pairs);
            int64_t n_guard = 0;
            for (int64_t j = 0; j < n_pairs; ++j) {
                const int64_t e = pr[2 * j];
                if (e < 0 || e >= n_ev) return -3;
                const double em = event_mean[ev_o + e];
                if (em > dmin && em < dmax) gev_out[gev_o + n_guard++] = e;
                guard_cum[j + 1] = n_guard;
                pair_q[j] = pr[2 * j + 1];
            }
            const int64_t* q = r2q + r2q_o;
            const int64_t cap = n_kmer + 1;
            wl_w.resize(cap); j0_w.resize(cap); j1_w.resize(cap);
            const int64_t n_win = window_chain(
                undef_cum.data(), bp_pos, pair_q, q, n_r2q, guard_cum.data(),
                ref_len, k, total_wl, ri_out + win_o, wl_w.data(),
                j0_w.data(), j1_w.data());
            if (n_win < 0) return n_win;
            for (int64_t w = 0; w < n_win; ++w) {
                const int64_t ri = ri_out[win_o + w];
                const int64_t ns = wl_w[w] - k + 1;
                const int64_t g0 = guard_cum[j0_w[w]];
                const int64_t g1 = guard_cum[j1_w[w]];
                ns_out[win_o + w] = ns;
                g0_out[win_o + w] = g0;
                g1_out[win_o + w] = g1 < g0 + t_cap ? g1 : g0 + t_cap;
                indel_out[win_o + w] = (q[ri + ns] - q[ri]) - ns;
                rc_out[win_o + w] = is_reverse ? ref_end - ri - k / 2
                                               : ref_start + ri + k / 2;
            }
            win_o += n_win;
            if (n_win) gev_o += n_guard;
        }
        ref_o += ref_len;
        kmer_o += n_kmer;
        rank_o += n_rank;
        pair_o += n_pairs;
        ev_o += n_ev;
        r2q_o += n_r2q;
    }
    int64_t* offs = offs_out + n_reads * 5;
    offs[0] = ref_o; offs[1] = kmer_o; offs[2] = rank_o;
    offs[3] = win_o; offs[4] = gev_o;
    return win_o;
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
//
// Never inlined: prep_decode_group runs this same code a read, so the
// compiler cannot contract its arithmetic differently there.
__attribute__((noinline))
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

// ---------------------------------------------------------------------------
// Prep's batch entries: every read's k-mer ranks and quantile scaling in one
// call a batch, a fill group's padded rows, and a fill group's move decode,
// banded QC and Theil-Sen subsample in one call after the chase's readback
// ---------------------------------------------------------------------------

// A product rounded on its own.  Under -march=native g++ contracts a * b + c
// into one fma, where numpy rounds the product first; a call it may not
// inline keeps the two roundings.
static __attribute__((noinline)) double mul_rounded(double a, double b) {
    return a * b;
}

// numpy's pairwise sum of a contiguous f64 array (pairwise_sum in numpy's
// loops_utils.h): eight running partial sums combined as
// ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the tail left to right; blocks
// above 128 split in halves of a multiple of 8.
static double numpy_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        double res = ((r[0] + r[1]) + (r[2] + r[3]))
                     + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return numpy_sum(a, n2) + numpy_sum(a + n2, n - n2);
}

// Reused buffers of quantile_medians.
struct SelectScratch {
    std::vector<uint16_t> bucket;
    std::vector<int32_t> count, count2;
    std::vector<int16_t> slot;
    std::vector<int64_t> want, slot_of;
    std::vector<std::vector<double>> cand;
};

// quantileMedians (event_handling.cpp:451-475): sorted(v)[(i*n + (i+1)*n)/2]
// with n = len / nq, for i < nq, as numpy's sort orders v.  A selection, not
// a sort: a histogram of 4096 equal buckets between the least and the
// greatest value (the bucket is monotone in the value, so the buckets lie in
// sorted order) finds each statistic's bucket and its rank there, and
// nth_element picks it among that bucket's values alone.  Where the buckets
// cannot be formed (a NaN, an infinity, a range that overflows or is zero),
// nth_element runs over all of v, NaN last as numpy sorts it.  v is
// reordered.
static void quantile_medians(std::vector<double>& v, int64_t nq, double* out,
                             SelectScratch& sc) {
    const int64_t len = (int64_t)v.size(), n = len / nq;
    const auto rank = [n](int64_t i) { return (i * n + (i + 1) * n) / 2; };
    // four running extremes keep the loop off one dependency chain
    double lo4[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    double hi4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    int64_t n_nan = 0, i = 0;
    for (; i + 4 <= len; i += 4)
        for (int j = 0; j < 4; ++j) {
            const double x = v[i + j];
            n_nan += x != x;
            lo4[j] = x < lo4[j] ? x : lo4[j];
            hi4[j] = x > hi4[j] ? x : hi4[j];
        }
    for (; i < len; ++i) {
        const double x = v[i];
        n_nan += x != x;
        lo4[0] = x < lo4[0] ? x : lo4[0];
        hi4[0] = x > hi4[0] ? x : hi4[0];
    }
    const double lo = std::min(std::min(lo4[0], lo4[1]),
                               std::min(lo4[2], lo4[3]));
    const double hi = std::max(std::max(hi4[0], hi4[1]),
                               std::max(hi4[2], hi4[3]));
    const int64_t NB = 4096;
    const double per = (double)NB / (hi - lo);
    if (n_nan || !std::isfinite(hi - lo) || !std::isfinite(per)) {
        const auto nan_last = [](double a, double b) {
            return a < b || (std::isnan(b) && !std::isnan(a));
        };
        auto rest = v.begin();
        for (int64_t q = 0; q < nq; ++q) {
            auto nth = v.begin() + rank(q);
            if (nth >= rest) {
                std::nth_element(rest, nth, v.end(), nan_last);
                rest = nth + 1;
            }
            out[q] = *nth;
        }
        return;
    }
    std::vector<uint16_t>& bk = sc.bucket;
    bk.resize(len);
    for (int64_t j = 0; j < len; ++j) {
        const double f = (v[j] - lo) * per;
        bk[j] = (uint16_t)(f < NB - 1 ? (int64_t)f : NB - 1);
    }
    // two counts, so that neighbouring values do not wait on one counter
    sc.count.assign(NB + 1, 0);
    sc.count2.assign(NB + 1, 0);
    int64_t j = 0;
    for (; j + 2 <= len; j += 2) {
        ++sc.count[bk[j] + 1];
        ++sc.count2[bk[j + 1] + 1];
    }
    if (j < len) ++sc.count[bk[j] + 1];
    std::vector<int32_t>& starts = sc.count;
    for (int64_t b = 0; b < NB; ++b)
        starts[b + 1] += starts[b] + sc.count2[b + 1];
    // the statistics' buckets, each gathered once
    sc.slot.assign(NB, -1);
    sc.want.clear();
    sc.slot_of.resize(nq);
    for (int64_t q = 0, b = 0; q < nq; ++q) {
        while (starts[b + 1] <= rank(q)) ++b;
        if (sc.slot[b] < 0) {
            sc.slot[b] = (int16_t)sc.want.size();
            sc.want.push_back(b);
        }
        sc.slot_of[q] = sc.slot[b];
    }
    if (sc.cand.size() < sc.want.size()) sc.cand.resize(sc.want.size());
    for (size_t w = 0; w < sc.want.size(); ++w) {
        sc.cand[w].clear();
        sc.cand[w].reserve(starts[sc.want[w] + 1] - starts[sc.want[w]]);
    }
    for (int64_t k = 0; k < len; ++k) {
        const int16_t w = sc.slot[bk[k]];
        if (w >= 0) sc.cand[w].push_back(v[k]);
    }
    for (int64_t q = 0; q < nq; ++q) {
        const int64_t w = sc.slot_of[q];
        std::vector<double>& c = sc.cand[w];
        auto nth = c.begin() + (rank(q) - starts[sc.want[w]]);
        std::nth_element(c.begin(), nth, c.end());
        out[q] = *nth;
    }
}

// The ranks of every k-mer of s (base-4, A=0 T=1 G=2 C=3, either case), -1
// for a k-mer with a base outside ACGT: utils/seqtools.kmer_ranks.  Returns
// the count, max(0, len - k + 1).
static int64_t kmer_ranks_of(const uint8_t* s, int64_t len, int64_t k,
                             int64_t* out) {
    static const auto code_of = [] {
        std::array<int8_t, 256> t{};
        t.fill(-1);
        t['A'] = t['a'] = 0; t['T'] = t['t'] = 1;
        t['G'] = t['g'] = 2; t['C'] = t['c'] = 3;
        return t;
    }();
    const int64_t mask = (int64_t(1) << (2 * k)) - 1;
    int64_t rank = 0, last_bad = -1 - k;
    for (int64_t i = 0; i < len; ++i) {
        int64_t c = code_of[s[i]];
        if (c < 0) {
            last_bad = i;
            c = 0;
        }
        rank = ((rank << 2) | c) & mask;
        if (i >= k - 1) out[i - k + 1] = i - last_bad < k ? -1 : rank;
    }
    return len - k + 1 > 0 ? len - k + 1 : 0;
}

// meta: one row a read of [basecall length, reference length, events].
// Inputs concatenated in read order: query (the basecalls' bytes), ref (the
// references' bytes), event_mean; pore_mean is the pore model's mean a
// k-mer rank, as f64.  Outputs: rq and rr, each read's query and reference
// k-mer ranks, concatenated in read order; too_few, 1 for a read with fewer
// than two events, query k-mers or reference k-mers (it gets no scaling);
// shift and scale, the others' quantile scaling (event_handling.cpp:510-541,
// undefined reference k-mers read as rank 0, data_IO.cpp:131), as
// ops/scaling.estimate_scaling_quantiles computes it, bit for bit.  Returns 0,
// -1 for k outside 1..31 or nq < 1, -2 for a rank outside the pore table.
int64_t prep_scale_batch(const uint8_t* query, const uint8_t* ref,
                         const int64_t* meta, int64_t n_reads,
                         const double* event_mean, const double* pore_mean,
                         int64_t n_model, int64_t k, int64_t nq,
                         int64_t* rq_out, int64_t* rr_out, uint8_t* too_few,
                         double* shift_out, double* scale_out) {
    if (k < 1 || k > 31 || nq < 1) return -1;
    int64_t q_o = 0, r_o = 0, ev_o = 0, rq_o = 0, rr_o = 0;
    std::vector<double> ev, mm, sq(nq), mq(nq), xx(nq), xy(nq);
    SelectScratch sc;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t lq = meta[3 * r], lr = meta[3 * r + 1];
        const int64_t ne = meta[3 * r + 2];
        int64_t* rq = rq_out + rq_o;
        int64_t* rr = rr_out + rr_o;
        const int64_t nkq = kmer_ranks_of(query + q_o, lq, k, rq);
        const int64_t nkr = kmer_ranks_of(ref + r_o, lr, k, rr);
        too_few[r] = ne < 2 || nkq < 2 || nkr < 2;
        if (!too_few[r]) {
            ev.assign(event_mean + ev_o, event_mean + ev_o + ne);
            mm.resize(nkr);
            for (int64_t i = 0; i < nkr; ++i) {
                const int64_t rk = rr[i] < 0 ? 0 : rr[i];
                if (rk >= n_model) return -2;
                mm[i] = pore_mean[rk];
            }
            quantile_medians(ev, nq, sq.data(), sc);
            quantile_medians(mm, nq, mq.data(), sc);
            // linear_regression(mq, sq) (event_handling.cpp:478-507)
            for (int64_t i = 0; i < nq; ++i) {
                xx[i] = mul_rounded(mq[i], mq[i]);
                xy[i] = mul_rounded(mq[i], sq[i]);
            }
            const double sum_x = numpy_sum(mq.data(), nq);
            const double sum_x2 = numpy_sum(xx.data(), nq);
            const double sum_y = numpy_sum(sq.data(), nq);
            const double sum_xy = numpy_sum(xy.data(), nq);
            const double dn = (double)nq;
            const double slope =
                (mul_rounded(dn, sum_xy) - mul_rounded(sum_x, sum_y))
                / (mul_rounded(dn, sum_x2) - mul_rounded(sum_x, sum_x));
            shift_out[r] = (sum_y - mul_rounded(slope, sum_x)) / dn;
            scale_out[r] = slope;
        } else {
            shift_out[r] = 0.0;
            scale_out[r] = 1.0;
        }
        q_o += lq;
        r_o += lr;
        ev_o += ne;
        rq_o += nkq;
        rr_o += nkr;
    }
    return 0;
}

// The padded rows of one fill launch over its n reads: event_mean and rq
// are their events and query k-mer ranks concatenated in read order, offs
// their (n + 1, 2) starts of [events, query k-mer ranks], shift and scale
// theirs.  Writes scaled
// (B, E) f32, (mean - shift) / scale and 0 past each read's events; where
// non-null, ranks (B, K), the query ranks with undefined k-mers read as 0
// and -1 past each read's k-mers, and gathered (B, K) f32, table at those
// ranks and pad past them; n_ev and n_km (B,) i32.  Rows from n to B are
// padding.  Returns 0, or -2 for a rank outside the table.
int64_t prep_fill_rows(const double* event_mean, const int64_t* rq,
                       const int64_t* offs, int64_t n,
                       const double* shift, const double* scale, int64_t B,
                       int64_t E, int64_t K, const float* table,
                       int64_t n_table, float pad, float* scaled,
                       int64_t* ranks, float* gathered, int32_t* n_ev,
                       int32_t* n_km) {
    for (int64_t b = 0; b < B; ++b) {
        int64_t ne = 0, nk = 0;
        const double* ev = nullptr;
        const int64_t* q = nullptr;
        if (b < n) {
            const int64_t* o = offs + 2 * b;
            ev = event_mean + o[0];
            ne = o[2] - o[0];
            q = rq + o[1];
            nk = o[3] - o[1];
        }
        float* s = scaled + b * E;
        for (int64_t j = 0; j < ne; ++j)
            s[j] = (float)((ev[j] - shift[b]) / scale[b]);
        std::fill(s + ne, s + E, 0.0f);
        for (int64_t j = 0; j < K; ++j) {
            const int64_t rk = j < nk ? (q[j] < 0 ? 0 : q[j]) : -1;
            if (ranks) ranks[b * K + j] = rk;
            if (gathered) {
                if (rk >= n_table) return -2;
                gathered[b * K + j] = rk < 0 ? pad : table[rk];
            }
        }
        n_ev[b] = (int32_t)ne;
        n_km[b] = (int32_t)nk;
    }
    return 0;
}

// One fill group after the chase's readback: for each of its n reads
// (event_mean, rq, rr and q2r concatenated in read order, offs their
// (n + 1, 4) starts of [events, query k-mer ranks, reference k-mer ranks,
// query_to_ref]), the read's emission coefficients gathered from the
// per-k-mer tables (t_lpc -inf for an undefined k-mer), the decode_moves of
// its column of packed (rows_p, B) with the fill's scaled row (scaled, row
// stride E), and the banded QC (event_handling.cpp; the four tests of
// pipeline/prep.py).  Writes the pairs concatenated at pair_offs (n + 1),
// passed (n), and for a passing read its Theil-Sen stride subsample
// (ops/scaling.theilsen_pregather) into row b of sig and mms (max_points
// wide, zero beforehand), npts and passth.  Returns 0, -1 when the pairs
// overflow pairs_cap, -2 for a rank outside the tables.
int64_t prep_decode_group(
    const uint8_t* packed, int64_t rows_p, int64_t B, const int32_t* best_e,
    int64_t n, const int64_t* offs,
    const double* event_mean, const int64_t* rq, const int64_t* rr,
    const int64_t* q2r, const float* scaled, int64_t E, const float* t_mu,
    const float* t_inv, const float* t_lpc, int64_t n_model,
    double min_avg_emission, int64_t max_gap_threshold,
    int64_t min_cleaned_events, int64_t max_points, int64_t trim,
    int64_t* pairs_out, int64_t pairs_cap,
    int64_t* pair_offs, uint8_t* passed, float* sig, float* mms,
    int32_t* npts, uint8_t* passth) {
    std::vector<float> mu, inv, lpc;
    std::vector<int64_t> q2r_k, cr(rows_p * 4 + 1);
    std::vector<double> cs(rows_p * 4 + 1);
    double stats[5];
    int64_t off = 0;
    pair_offs[0] = 0;
    for (int64_t b = 0; b < n; ++b) {
        const int64_t* o = offs + 4 * b;
        const int64_t nk = o[5] - o[1], nr = o[6] - o[2];
        const int64_t nq2r = o[7] - o[3];
        mu.resize(nk); inv.resize(nk); lpc.resize(nk); q2r_k.resize(nk);
        for (int64_t j = 0; j < nk; ++j) {
            const int64_t rk = rq[o[1] + j], s = rk < 0 ? 0 : rk;
            if (s >= n_model) return -2;
            mu[j] = t_mu[s];
            inv[j] = t_inv[s];
            lpc[j] = rk < 0 ? -INFINITY : t_lpc[s];
            q2r_k[j] = j < nq2r ? q2r[o[3] + j] : -1;
        }
        const int64_t m = decode_moves(
            packed, rows_p, B, b, best_e[b], nk, event_mean + o[0],
            scaled + b * E, mu.data(), inv.data(), lpc.data(), q2r_k.data(),
            rr + o[2], nr, pairs_out + 2 * off, pairs_cap - off, cs.data(),
            cr.data(), stats);
        if (m != (int64_t)stats[3]) return -1;
        off += m;
        pair_offs[b + 1] = off;
        const int64_t n_cleaned = (int64_t)stats[4];
        passed[b] = stats[0] >= min_avg_emission && stats[1] != 0.0
                    && (int64_t)stats[2] <= max_gap_threshold
                    && n_cleaned >= min_cleaned_events;
        if (!passed[b]) continue;
        // idx = trim + skip * j, clipped (event_handling.cpp:63-65)
        const int64_t eff = n_cleaned - 2 * trim;
        const int64_t skip = eff > max_points ? eff / max_points : 1;
        const int64_t num = eff < max_points ? eff : max_points;
        if (n_cleaned > 0 && num > 0) {
            for (int64_t j = 0; j < max_points; ++j) {
                int64_t idx = trim + skip * j;
                idx = idx < 0 ? 0 : (idx > n_cleaned - 1 ? n_cleaned - 1 : idx);
                const int64_t rk = cr[idx] < 0 ? 0 : cr[idx];
                if (rk >= n_model) return -2;
                sig[b * max_points + j] = (float)cs[idx];
                mms[b * max_points + j] = t_mu[rk];
            }
        }
        npts[b] = (int32_t)(num > 0 ? num : 0);
        passth[b] = n_cleaned < max_points;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// libstdc++-exact RNG streams for seeBreaks parity (seeBreaks.cpp:430-502)
// ---------------------------------------------------------------------------

// Simulation bootstrap: for each of bs_iterations, draw nForks
// (read, trackLength, start) triples and count run-offs
// (seeBreaks.cpp:430-474).  Uses std::mt19937 + std::uniform_int_distribution
// so results are bit-identical to the reference under libstdc++.
void seebreaks_simulation(const int64_t* v5, const int64_t* v3, int64_t n_reads,
                          const int64_t* fork_len, int64_t n_lens,
                          int64_t n_forks, int64_t bs_iterations, uint32_t seed,
                          int64_t fs_boundary, int64_t read_end_tolerance,
                          double* out_run_off_props) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < bs_iterations; ++i) {
        int64_t run_off = 0;
        for (int64_t j = 0; j < n_forks; ++j) {
            std::uniform_int_distribution<> read_dist(0, (int)(n_reads - 1));
            int64_t ri = read_dist(gen);
            int64_t r5 = v5[ri], r3 = v3[ri];
            std::uniform_int_distribution<> track_dist(0, (int)(n_lens - 1));
            int64_t random_len = fork_len[track_dist(gen)];
            std::uniform_int_distribution<> start_dist((int)(r5 + fs_boundary),
                                                       (int)(r3 - fs_boundary));
            int64_t start = start_dist(gen);
            if (r3 - read_end_tolerance - start < random_len) ++run_off;
        }
        out_run_off_props[i] = (double)run_off / (double)n_forks;
    }
}

// Observation bootstrap (seeBreaks.cpp:476-502).
void seebreaks_observation(const uint8_t* run_off, int64_t n, uint32_t seed,
                           int64_t bs_iterations, double* out_props) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < bs_iterations; ++i) {
        int64_t obs = 0, no_obs = 0;
        for (int64_t j = 0; j < n; ++j) {
            std::uniform_int_distribution<> dist(0, (int)(n - 1));
            int64_t ri = dist(gen);
            if (run_off[ri]) ++obs; else ++no_obs;
        }
        out_props[i] = (double)obs / (double)(obs + no_obs);
    }
}

// Difference distribution (seeBreaks.cpp:592-599): normal draws with the
// seeded generator.
void seebreaks_difference(double obs_mean, double obs_std, double sim_mean,
                          double sim_std, int64_t n, uint32_t seed,
                          double* out_diff) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < n; ++i) {
        std::normal_distribution<double> obs_d(obs_mean, obs_std);
        std::normal_distribution<double> sim_d(sim_mean, sim_std);
        double a = obs_d(gen);
        double b = sim_d(gen);
        out_diff[i] = a - b;
    }
}

// ---------------------------------------------------------------------------
// Eventalign table rows (alignment.cpp:701-733)
// ---------------------------------------------------------------------------

// One row per raw sample: refCoord, kmerRef, scaledSample, kmerStrand,
// modelMean, and for rows with has_call[r] the EdU and BrdU calls of
// trainCNN's table.  Insertion rows print N^k for the strand column and a
// literal 0 model mean.  Row arrays arrive pre-exploded (one entry per
// output row); this routine slices and reverse-complements the k-mers from
// the reference bytes and formats.  Returns the bytes written, or -1 when a
// row does not fit in what is left of ``out`` (nothing is cut silently),
// -2 for k >= 63, -3 for a k-mer start outside the sequence, -4 for a
// formatting error.
long long format_eventalign_rows(
    const long long* coords, const long long* kstarts,
    const unsigned char* is_ins, const double* values, const double* mmeans,
    const unsigned char* has_call, const double* edu, const double* brdu,
    long long n_rows, const char* seq, long long seq_len, long long k,
    long long is_reverse, char* out, long long out_cap) {
    static const auto comp = [] {
        std::array<char, 256> t{};
        for (int i = 0; i < 256; ++i) t[i] = 'N';
        t['A'] = 'T'; t['C'] = 'G'; t['G'] = 'C'; t['T'] = 'A';
        t['a'] = 't'; t['c'] = 'g'; t['g'] = 'c'; t['t'] = 'a';
        return t;
    }();
    long long w = 0;
    char kmer_ref[64], kmer_strand[64];
    if (k >= 63) return -2;
    for (long long r = 0; r < n_rows; ++r) {
        long long ks = kstarts[r];
        if (ks < 0 || ks + k > seq_len) return -3;
        for (long long j = 0; j < k; ++j) kmer_strand[j] = seq[ks + j];
        kmer_strand[k] = 0;
        if (is_reverse) {
            for (long long j = 0; j < k; ++j)
                kmer_ref[j] = comp[(unsigned char)kmer_strand[k - 1 - j]];
        } else {
            for (long long j = 0; j < k; ++j) kmer_ref[j] = kmer_strand[j];
        }
        kmer_ref[k] = 0;
        long long left = out_cap - w;
        int n;
        if (is_ins[r]) {
            for (long long j = 0; j < k; ++j) kmer_strand[j] = 'N';
            n = snprintf(out + w, left, "%lld\t%s\t%.6f\t%s\t0\n", coords[r],
                         kmer_ref, values[r], kmer_strand);
        } else if (has_call[r]) {
            n = snprintf(out + w, left, "%lld\t%s\t%.6f\t%s\t%.6f\t%.6f\t%.6f\n",
                         coords[r], kmer_ref, values[r], kmer_strand,
                         mmeans[r], edu[r], brdu[r]);
        } else {
            n = snprintf(out + w, left, "%lld\t%s\t%.6f\t%s\t%.6f\n",
                         coords[r], kmer_ref, values[r], kmer_strand,
                         mmeans[r]);
        }
        if (n < 0) return -4;
        // snprintf returns the length it wanted: at or past what is left
        // (the terminating NUL included) the row was cut
        if (n >= left) return -1;
        w += n;
    }
    return w;
}

}  // extern "C"
