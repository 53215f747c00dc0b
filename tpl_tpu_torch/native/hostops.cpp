// Host-side sequential routines of tpl_tpu_torch (the port's own copy of
// tpl_tpu/native/hostops.cpp; tpl_tpu_torch/native/__init__.py builds and
// binds it).
//
// These are the marching/recursive loops that are inherently sequential and
// live on the host orchestration path (the device path is the CUDA kernels
// of csrc/), each the twin of a numpy function of the port, which stays as
// its oracle:
//  - equidistant polyline resampling via circle-segment intersection
//    (behavioral twin of library/src/utils.cpp:410-560 in the reference)
//  - jerk/acc-limited velocity profile integration
//    (library/tpl/planning/utils.py:6-65)
//  - slope-limited evasive corridor ramp profiles
//    (library/tpl/planning/path_vel_decomp/path_optim.py:11-55)
//
// Built as a plain C ABI shared object, loaded via ctypes (no pybind11).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Returns number of samples written, or -1 on failure.
// out must hold steps * 5 doubles: x, y, alpha, prev_idx, next_idx.
int64_t tpl_resample(const double* pts_in, int64_t n_in,
                     double sampling_dist, int64_t steps,
                     int64_t start_index, int32_t closed,
                     double* out) {
    if (n_in == 0 || steps == 0) return 0;

    // drop consecutive duplicates
    std::vector<double> px(n_in), py(n_in);
    int64_t n = 0;
    for (int64_t i = 0; i < n_in; ++i) {
        double x = pts_in[2 * i], y = pts_in[2 * i + 1];
        if (n == 0 || x != px[n - 1] || y != py[n - 1]) {
            px[n] = x; py[n] = y; ++n;
        }
    }

    if (n == 1) {
        out[0] = px[0]; out[1] = py[0];
        out[2] = 0.0; out[3] = 0.0; out[4] = 0.0;
        return 1;
    }

    if (closed) {
        start_index = ((start_index % n) + n) % n;
    } else {
        start_index = std::max<int64_t>(0, std::min(start_index, n - 1));
    }

    out[0] = px[start_index];
    out[1] = py[start_index];
    out[2] = 0.0;
    out[3] = (double)start_index;
    out[4] = closed ? (double)((start_index + 1) % n)
                    : (double)std::min(start_index + 1, n - 1);

    const double r2 = sampling_dist * sampling_dist;
    int64_t i = start_index;
    int64_t count = 1;

    while (count < steps) {
        bool progressed = false;
        for (int64_t k = 0; k < n; ++k) {
            int64_t prev_idx = i + k;
            int64_t next_idx = i + k + 1;
            if (closed) {
                prev_idx = ((prev_idx % n) + n) % n;
                next_idx = ((next_idx % n) + n) % n;
            } else {
                prev_idx = std::max<int64_t>(0, std::min(prev_idx, n - 2));
                next_idx = std::max<int64_t>(0, std::min(next_idx, n - 1));
            }

            const double p0x = px[prev_idx], p0y = py[prev_idx];
            const double p1x = px[next_idx], p1y = py[next_idx];
            const double vx = p1x - p0x, vy = p1y - p0y;
            const double ls = vx * vx + vy * vy;
            const double l = std::sqrt(ls);

            const double cx = out[(count - 1) * 5];
            const double cy = out[(count - 1) * 5 + 1];

            const double D = (p0x - cx) * (p1y - cy) - (p1x - cx) * (p0y - cy);
            const double disc = r2 * ls - D * D;
            if (disc < 0) return -1;

            const double sq = std::sqrt(disc);
            const double sign_y = (vy < 0.0) ? -1.0 : 1.0;
            const double x_part0 = D * vy;
            const double y_part0 = -D * vx;
            const double x_part1 = sign_y * vx * sq;
            const double y_part1 = std::fabs(vy) * sq;

            double pax = (x_part0 + x_part1) / ls + cx;
            double pay = (y_part0 + y_part1) / ls + cy;
            const double pbx = (x_part0 - x_part1) / ls + cx;
            const double pby = (y_part0 - y_part1) / ls + cy;

            double qa = ((vx / l) * (pax - p0x) + (vy / l) * (pay - p0y)) / l;
            const double qb =
                ((vx / l) * (pbx - p0x) + (vy / l) * (pby - p0y)) / l;
            if (qa < qb) { qa = qb; pax = pbx; pay = pby; }

            const double tol = 1e-8;
            if ((!closed && next_idx == n - 1)
                    || (qa > -tol && qa - 1.0 < tol)) {
                i = prev_idx;
                out[count * 5] = pax;
                out[count * 5 + 1] = pay;
                out[count * 5 + 2] = qa;
                out[count * 5 + 3] = (double)prev_idx;
                out[count * 5 + 4] = (double)next_idx;
                ++count;
                progressed = true;
                break;
            }
        }
        if (!progressed) return -1;
    }
    return count;
}

// Jerk/acc-limited velocity profile over space.
// lim_v_in: n entries; out: n*2 doubles (v, a). has_v0/has_a0 gate v0/a0.
void tpl_rampify_profile(double v0, double a0, int32_t has_v0,
                         int32_t has_a0, const double* lim_v_in, int64_t n,
                         double a_min, double a_max, double j_min,
                         double j_max, double v_min, double step,
                         double* out) {
    std::vector<double> lim_v(n);
    for (int64_t i = 0; i < n; ++i)
        lim_v[i] = std::max(lim_v_in[i], v_min);

    std::memset(out, 0, sizeof(double) * n * 2);

    // backward pass
    double current_v = lim_v[n - 1];
    double current_a = 0.0;
    for (int64_t t = n - 1; t > 0; --t) {
        out[t * 2] = current_v;
        out[t * 2 + 1] = current_a;
        double lim_a = std::max(
            a_min, (current_v - lim_v[t - 1]) / step * current_v);
        if (lim_a < 0.0) {
            current_a = std::max(current_a + j_min / current_v * step, lim_a);
        } else {
            current_a = 0.0;
            current_v = lim_v[t];
        }
        current_v += std::min(-current_a / current_v * step,
                              lim_v[t - 1] - current_v);
    }

    // forward pass
    if (has_v0) {
        current_v = std::max(v0, v_min);
        out[0] = current_v;
    } else {
        out[0] = current_v;
    }
    if (has_a0) {
        current_a = a0;
        out[1] = a0;
    } else {
        current_a = -current_a;
        out[1] = current_a;
    }

    double lim_a = 0.0;
    for (int64_t t = 0; t < n; ++t) {
        if (t < n - 1) {
            lim_a = std::min(a_max,
                             (out[(t + 1) * 2] - current_v) / step * current_v);
        }
        if (lim_a > 0.0) {
            current_a = std::min(current_a + j_max / current_v * step, lim_a);
        } else {
            current_a = 0.0;
            current_v = out[t * 2];
        }
        double next_v = current_v + std::min(current_a / current_v * step,
                                             lim_v[t] - current_v);
        current_v = std::min(out[t * 2], next_v);
        out[t * 2] = current_v;
        out[t * 2 + 1] = current_a;
    }
}

// Slope-limited evasive corridor ramp (forward + backward pass max).
// path_v: target velocities path[:, 5], n entries; lower/upper: n entries.
void tpl_rampify_corridor(double step, int64_t horizon, double sharpness,
                          double proj_distance, const double* path_v,
                          int64_t n, double gap, const double* lower,
                          const double* upper, double* out) {
    std::vector<double> fwd(n, -10.0), bwd(n, -10.0);

    for (int pass_nr = 0; pass_nr < 2; ++pass_nr) {
        double* pd = pass_nr == 0 ? fwd.data() : bwd.data();
        double d = pass_nr == 0 ? lower[0] : lower[horizon - 1];

        const int64_t begin = pass_nr == 0 ? 0 : horizon - 1;
        const int64_t end = pass_nr == 0 ? horizon : -1;
        const int64_t stepi = pass_nr == 0 ? 1 : -1;

        for (int64_t i = begin; i != end; i += stepi) {
            d = std::max(lower[i], d);
            pd[i] = d;

            double v = std::max(path_v[i], 1e-8);
            double slope = -(sharpness / (v * v));

            if (pass_nr == 0) {
                for (int64_t k = i; k < horizon; ++k) {
                    double denom = (double)std::max<int64_t>(
                        1, std::llabs(k - i)) * step;
                    slope = std::min(slope, (upper[k] - gap - d) / denom);
                }
            } else {
                for (int64_t k = i; k >= 0; --k) {
                    double denom = (double)std::max<int64_t>(
                        1, std::llabs(k - i)) * step;
                    slope = std::min(slope, (upper[k] - gap - d) / denom);
                }
                slope = std::min(slope, (proj_distance - d)
                                 / std::max<double>(1, (double)i * step));
            }

            d += step * slope;
        }
    }

    for (int64_t i = 0; i < n; ++i)
        out[i] = std::max(fwd[i], bwd[i]);
}

// Project m positions onto an n-vertex polyline.
// Behavioral twin of tpl_tpu_torch/ops/geometry.py _project_core (which mirrors
// library/src/utils.cpp:257-404 in the reference).
// out holds m * 12 doubles per row:
//   [start, end, alpha, index, point_x, point_y, distance, arc_len,
//    angle, tangent_x, tangent_y, in_bounds]
void tpl_project(const double* pts, int64_t n,
                 const double* pos, int64_t m,
                 int32_t closed, double* out) {
    if (n < 2 || m == 0) return;
    const int64_t n_seg = closed ? n : n - 1;

    // per-segment precompute shared across queries
    std::vector<double> vx(n_seg), vy(n_seg), vv(n_seg), arc0(n_seg);
    double acc = 0.0;
    for (int64_t s = 0; s < n_seg; ++s) {
        const int64_t a = s, b = closed ? (s + 1) % n : s + 1;
        vx[s] = pts[2 * b] - pts[2 * a];
        vy[s] = pts[2 * b + 1] - pts[2 * a + 1];
        const double d2 = vx[s] * vx[s] + vy[s] * vy[s];
        vv[s] = std::max(d2, 1e-300);
        arc0[s] = acc;
        acc += std::sqrt(d2);
    }

    for (int64_t i = 0; i < m; ++i) {
        const double qx = pos[2 * i], qy = pos[2 * i + 1];
        int64_t best = 0;
        double best_d2 = 1e300, best_q = 0.0, best_qc = 0.0;
        double best_fx = 0.0, best_fy = 0.0;
        for (int64_t s = 0; s < n_seg; ++s) {
            const int64_t a = s;
            const double pvx = qx - pts[2 * a];
            const double pvy = qy - pts[2 * a + 1];
            const double q = (pvx * vx[s] + pvy * vy[s]) / vv[s];
            const double qc = q < 0.0 ? 0.0 : (q > 1.0 ? 1.0 : q);
            const double fx = pts[2 * a] + vx[s] * qc;
            const double fy = pts[2 * a + 1] + vy[s] * qc;
            const double dx = qx - fx, dy = qy - fy;
            const double d2 = dx * dx + dy * dy;
            if (d2 < best_d2) {
                best_d2 = d2; best = s; best_q = q; best_qc = qc;
                best_fx = fx; best_fy = fy;
            }
        }

        bool in_bounds;
        if (closed) {
            in_bounds = !(best_q < 0.0 || best_q > 1.0);
        } else {
            in_bounds = !((best == 0 && best_q < 0.0)
                          || (best == n_seg - 1 && best_q > 1.0));
        }

        const int64_t i_ref = best + 1;
        int64_t idx_start, idx_end, idx_next;
        if (closed) {
            idx_start = ((i_ref - 1) % n + n) % n;
            idx_end = i_ref % n;
            idx_next = (i_ref + 1) % n;
        } else {
            idx_start = std::max<int64_t>(0, i_ref - 1);
            idx_end = i_ref;
            idx_next = std::min(n - 1, i_ref + 1);
        }
        const double alpha = best_qc;
        const int64_t index = alpha < 0.5 ? idx_start : idx_end;

        const double adx = best_fx - pts[2 * best];
        const double ady = best_fy - pts[2 * best + 1];
        const double arc_len = arc0[best] + std::sqrt(adx * adx + ady * ady);

        // interpolated tangent (utils.cpp:376-390)
        double svx = pts[2 * idx_end] - pts[2 * idx_start];
        double svy = pts[2 * idx_end + 1] - pts[2 * idx_start + 1];
        const double svn = std::max(std::sqrt(svx * svx + svy * svy), 1e-300);
        svx /= svn; svy /= svn;
        double tx = svx, ty = svy;
        if (index < n - 2) {
            double nvx = pts[2 * idx_next] - pts[2 * idx_end];
            double nvy = pts[2 * idx_next + 1] - pts[2 * idx_end + 1];
            const double nvn = std::max(std::sqrt(nvx * nvx + nvy * nvy),
                                        1e-300);
            nvx /= nvn; nvy /= nvn;
            tx = alpha * nvx + (1.0 - alpha) * svx;
            ty = alpha * nvy + (1.0 - alpha) * svy;
        }
        const double angle = std::atan2(ty, tx);

        // signed distance, positive = left of path (utils.cpp:392-404)
        double dist = std::sqrt(best_d2);
        double ox = best_fx - qx, oy = best_fy - qy;
        const double on = std::sqrt(ox * ox + oy * oy);
        const double oinv = 1.0 / std::max(on, 1e-300);
        ox *= oinv; oy *= oinv;
        // ortho_rot = (-oy, ox); sign_neg when dot(seg_v, ortho_rot) <= 0
        if (svx * -oy + svy * ox <= 0.0) dist = -dist;
        if (on < 1e-12) dist = 0.0;

        double* o = out + 12 * i;
        o[0] = (double)idx_start; o[1] = (double)idx_end;
        o[2] = alpha; o[3] = (double)index;
        o[4] = best_fx; o[5] = best_fy;
        o[6] = dist; o[7] = arc_len; o[8] = angle;
        o[9] = tx; o[10] = ty;
        o[11] = in_bounds ? 1.0 : 0.0;
    }
}

}  // extern "C"
