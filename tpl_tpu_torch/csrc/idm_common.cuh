// What the IDM sampling planner's two kernels share (idm_rollout.cu,
// idm_evaluate.cu): the order of the packed parameters, the state fields, the
// object sizes they take, the lookups on an object's time row and the
// bounding-box test that lets both skip a polyline projection exactly.
//
// The parameter order is written once, in IDM_PARAMS: it makes the enum both
// kernels index and the comma-separated key list that each library exports
// (idm_rollout_param_keys, idm_evaluate_param_keys), which the wrapper
// compares with idm_kernel.py PP_KEYS before the first launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace idm {

constexpr int MAX_OBJ = 16, MAX_PRED = 16, MAX_HULL = 16;
constexpr unsigned FULL = 0xffffffffu;
// ref line channels: x, y, heading, k, v_max, d_left, d_right
constexpr int REF_CH = 7;

// the packed parameters, in the order of idm_kernel.py PP_KEYS
#define IDM_PARAMS(X)                                                      \
  X(DT, dt) X(DEAD_TIME, dead_time) X(D_SAFE_LAT, d_safe_lat)              \
  X(D_SAFE_LAT_PATH, d_safe_lat_path) X(D_COMF_LAT, d_comf_lat)            \
  X(K_STANLEY, k_stanley) X(V_OFFSET_STANLEY, v_offset_stanley)            \
  X(STEER_ANGLE_MAX, steer_angle_max) X(STEER_RATE_MAX, steer_rate_max)    \
  X(T_VEL_LOOKAHEAD, t_vel_lookahead) X(D_SAFE_MIN, d_safe_min)            \
  X(T_HEADWAY_DESIRED, t_headway_desired) X(A_BREAK_COMF, a_break_comf)    \
  X(IDM_EXP_DCC, idm_exp_dcc) X(IDM_EXP_ACC, idm_exp_acc)                  \
  X(K_P_S, k_p_s) X(K_P_V, k_p_v) X(A_MAX, a_max) X(A_MIN, a_min)          \
  X(J_MAX, j_max) X(J_MIN, j_min) X(WIDTH_VEH, width_veh)                  \
  X(LENGTH_VEH, length_veh) X(RADIUS_VEH, radius_veh)                      \
  X(DIST_FRONT_VEH, dist_front_veh) X(DIST_BACK_VEH, dist_back_veh)        \
  X(WHEEL_BASE, wheel_base) X(L_TRG, l_trg) X(W_L, w_l) X(W_A, w_a)        \
  X(W_LAT_DIST, w_lat_dist)

#define IDM_PARAM_ENUM(name, key) name,
enum Pp { IDM_PARAMS(IDM_PARAM_ENUM) N_PP };
#undef IDM_PARAM_ENUM

#define IDM_PARAM_KEY(name, key) #key ","
// "dt,dead_time,...,w_lat_dist,"
constexpr char PARAM_KEYS[] = IDM_PARAMS(IDM_PARAM_KEY);
#undef IDM_PARAM_KEY

// ref state fields: t, x, y, heading, v, a, s, l, d_right, d_left
enum { R_T, R_X, R_Y, R_H, R_V, R_A, R_S, R_L, R_DR, R_DL, N_R };
// vehicle state fields: t, x, y, heading, steer, v, a, s, l
enum { V_T, V_X, V_Y, V_H, V_ST, V_V, V_A, V_S, V_L, N_V };

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// bracket of t on object o's sorted time row (P,): index and weight
__device__ __forceinline__ void bracket(const float* ts, int P, float t,
                                        int& i, float& a) {
  int n = 0;
  for (int p = 0; p < P; ++p) n += ts[p] <= t ? 1 : 0;
  i = n - 1 < 0 ? 0 : (n - 1 > P - 2 ? P - 2 : n - 1);
  a = clampf((t - ts[i]) / fmaxf(ts[i + 1] - ts[i], 1e-9f), 0.0f, 1.0f);
}

__device__ __forceinline__ float lerp2(float v0, float v1, float a) {
  return v0 * (1.0f - a) + v1 * a;
}

// Skipping projections exactly.  A projection onto a segment (a, b) takes
// the foot point f = a + (b - a) * qc, qc in [0, 1], and the squared
// distance d2 = (p - f).(p - f), all in float32 with round-to-nearest (u =
// 2^-24 the unit roundoff) and no contraction.  The computed foot's x lies
// within 5.1 M u of the segment's x interval, M the largest coordinate
// magnitude of the vertices: fl(b - a) = (b - a)(1 + e1), fl(.. * qc) adds
// e2, fl(a + ..) adds e3, so |fx - f*x| <= 2M (2u + u^2) + M (1 + 3u) u.  A
// box of vertices grown by M 2^-20 = 16 M u on every side (box_grow; the
// rounding of lo - d moves it by at most (M + d) u) therefore holds every
// computed foot point of its segments.  If D2 is the exact squared distance
// of p to the grown box, every segment's computed d2 >= D2 (1 - u)^4 (each
// |p - f| is at least the box distance; four roundings), and the float
// value lb = box_d2(box, p) <= D2 (1 + u)^4.  So where fl(lb (1 - 2^-20)) >
// x, every segment's d2 > x strictly: (1 + u)^5 (1 - 16 u) < (1 - u)^4.  lb
// counts only above 1e-30 (box_key), which keeps every square above the
// subnormal range; a NaN point gives lb = 0 (fmaxf drops the NaN), a key of
// 0, and skips nothing.
constexpr float BOX_REL = 9.5367431640625e-07f;       // 2^-20
constexpr float KEY_SCALE = 1.0f - BOX_REL;           // exact in float32

__device__ __forceinline__ void box_grow(float& xlo, float& xhi, float& ylo,
                                         float& yhi) {
  const float m = fmaxf(fmaxf(fabsf(xlo), fabsf(xhi)),
                        fmaxf(fabsf(ylo), fabsf(yhi)));
  const float d = m * BOX_REL;
  xlo = xlo - d;
  xhi = xhi + d;
  ylo = ylo - d;
  yhi = yhi + d;
}

// the skip key of point (px, py) against a grown box (xlo, xhi, ylo, yhi):
// every segment inside has d2 > x wherever box_key > x
__device__ __forceinline__ float box_key(const float* b, float px, float py) {
  const float dx = fmaxf(fmaxf(b[0] - px, px - b[1]), 0.0f);
  const float dy = fmaxf(fmaxf(b[2] - py, py - b[3]), 0.0f);
  const float lb = dx * dx + dy * dy;
  return lb > 1e-30f ? lb * KEY_SCALE : 0.0f;
}

}  // namespace idm
