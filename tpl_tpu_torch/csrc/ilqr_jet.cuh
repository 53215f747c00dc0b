// The second-order forward-mode number of the iLQR kernels and the math a
// problem's functions are written in: value, gradient and packed Hessian
// over the N variables (x, u) of one step, the functions of the sympy front
// end's printer (tpl_tpu_torch/optim/genopt.py) on it, and the table
// lookups of tpl_tpu_torch/ops/interp.py with the derivatives torch
// autograd gives them.
//
// Every function takes a plain real (float or double) or a Jet and returns
// the same kind, so that one problem struct, a template over its argument
// type S, evaluates a rollout step on reals and a derivative block on Jets.
// A lookup's query may depend on the state (the tracking MPC's s_r): its
// slope is the table's between the clamped indices, as autograd gives
// through the plain version's index-and-clamp formulas, and it has no
// second derivative in the query.
//
// Shared by csrc/ilqr_rstp.cu and csrc/ilqr_generic_body.cuh.

#ifndef TPL_TPU_TORCH_ILQR_JET_CUH_
#define TPL_TPU_TORCH_ILQR_JET_CUH_

#include <cuda_runtime.h>
#include <math.h>

namespace ilqr_jet {

// ---------------------------------------------------------------------
// scalar math, float and double

__device__ __forceinline__ float fsin(float a) { return sinf(a); }
__device__ __forceinline__ float fcos(float a) { return cosf(a); }
__device__ __forceinline__ float fatan(float a) { return atanf(a); }
__device__ __forceinline__ float ffloor(float a) { return floorf(a); }
__device__ __forceinline__ float fceil(float a) { return ceilf(a); }
__device__ __forceinline__ double fsin(double a) { return sin(a); }
__device__ __forceinline__ double fcos(double a) { return cos(a); }
__device__ __forceinline__ double fatan(double a) { return atan(a); }
__device__ __forceinline__ double ffloor(double a) { return floor(a); }
__device__ __forceinline__ double fceil(double a) { return ceil(a); }

// torch.clamp: NaN passes through
template <typename R>
__device__ __forceinline__ R clampr(R x, R lo, R hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------
// second-order forward-mode number over the N variables (x, u)

template <typename R, int N>
struct Jet {
  static constexpr int NH = N * (N + 1) / 2;   // packed upper triangle
  R v;
  R g[N];
  R h[NH];

  Jet() = default;
  __device__ explicit Jet(R c) : v(c) {
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = R(0);
#pragma unroll
    for (int i = 0; i < NH; ++i) h[i] = R(0);
  }
};

template <int N>
__device__ __forceinline__ int hidx(int i, int j) {  // i <= j
  return i * N - (i * (i - 1)) / 2 + (j - i);
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> jvar(R c, int k) {
  Jet<R, N> r(c);
  r.g[k] = R(1);
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator+(const Jet<R, N>& a,
                                               const Jet<R, N>& b) {
  Jet<R, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = a.h[i] + b.h[i];
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator-(const Jet<R, N>& a,
                                               const Jet<R, N>& b) {
  Jet<R, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = a.h[i] - b.h[i];
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator+(const Jet<R, N>& a, R b) {
  Jet<R, N> r = a;
  r.v = a.v + b;
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator+(R b, const Jet<R, N>& a) {
  Jet<R, N> r = a;
  r.v = b + a.v;
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator-(const Jet<R, N>& a, R b) {
  Jet<R, N> r = a;
  r.v = a.v - b;
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator-(R b, const Jet<R, N>& a) {
  Jet<R, N> r;
  r.v = b - a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = -a.h[i];
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator-(const Jet<R, N>& a) {
  Jet<R, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = -a.h[i];
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator*(const Jet<R, N>& a, R b) {
  Jet<R, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * b;
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = a.h[i] * b;
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator*(R b, const Jet<R, N>& a) {
  Jet<R, N> r;
  r.v = b * a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = b * a.g[i];
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = b * a.h[i];
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator*(const Jet<R, N>& a,
                                               const Jet<R, N>& b) {
  Jet<R, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = hidx<N>(i, j);
      r.h[k] = a.v * b.h[k] + b.v * a.h[k] + a.g[i] * b.g[j]
               + a.g[j] * b.g[i];
    }
  return r;
}

// q = a / b: a = q b, so q' = (a' - q b') / b and
// q'' = (a'' - q' b'^T - b' q'^T - q b'') / b
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator/(const Jet<R, N>& a,
                                               const Jet<R, N>& b) {
  Jet<R, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = (a.g[i] - r.v * b.g[i]) / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = hidx<N>(i, j);
      r.h[k] = (a.h[k] - r.g[i] * b.g[j] - r.g[j] * b.g[i] - r.v * b.h[k])
               / b.v;
    }
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator/(R a, const Jet<R, N>& b) {
  return Jet<R, N>(a) / b;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> operator/(const Jet<R, N>& a, R b) {
  Jet<R, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / b;
#pragma unroll
  for (int i = 0; i < Jet<R, N>::NH; ++i) r.h[i] = a.h[i] / b;
  return r;
}

// f(a) with f(a.v) = f0, f'(a.v) = f1, f''(a.v) = f2
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> chain(const Jet<R, N>& a, R f0, R f1,
                                           R f2) {
  Jet<R, N> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = hidx<N>(i, j);
      r.h[k] = f1 * a.h[k] + f2 * a.g[i] * a.g[j];
    }
  return r;
}

// f(a, b) with f = f0 and its first (fa, fb) and second (faa, fab, fbb)
// partial derivatives at (a.v, b.v)
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> chain2(const Jet<R, N>& a,
                                            const Jet<R, N>& b, R f0, R fa,
                                            R fb, R faa, R fab, R fbb) {
  Jet<R, N> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = fa * a.g[i] + fb * b.g[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = hidx<N>(i, j);
      r.h[k] = fa * a.h[k] + fb * b.h[k] + faa * a.g[i] * a.g[j]
               + fab * (a.g[i] * b.g[j] + b.g[i] * a.g[j])
               + fbb * b.g[i] * b.g[j];
    }
  return r;
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> fcos(const Jet<R, N>& a) {
  const R s = fsin(a.v), c = fcos(a.v);
  return chain(a, c, -s, -c);
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> fatan(const Jet<R, N>& a) {
  const R d = R(1) + a.v * a.v;
  return chain(a, fatan(a.v), R(1) / d, R(-2) * a.v / (d * d));
}

template <typename R>
__device__ __forceinline__ R val(R a) { return a; }
template <typename R, int N>
__device__ __forceinline__ R val(const Jet<R, N>& a) { return a.v; }
template <class S>
__device__ __forceinline__ S sq(const S& a) { return a * a; }

// ---------------------------------------------------------------------
// table lookups at a query that depends on the step alone
// (tpl_tpu_torch/ops/interp.py)

template <typename R>
struct Lookup {
  int i0, i1;
  R a;
};

// lerp / lerp_multi at (s - 0) / step: clamped floor / ceil indices and
// alpha (a NaN query reads row 0; its alpha stays NaN)
template <typename R>
__device__ __forceinline__ Lookup<R> lerp_at(R s, R step, int n) {
  const R q = s / step;
  const R qs = isnan(q) ? R(0) : q;
  const R f0 = clampr(ffloor(qs), R(0), R(n - 1));
  const R f1 = clampr(fceil(qs), R(0), R(n - 1));
  Lookup<R> r;
  r.i0 = (int)f0;
  r.i1 = (int)f1;
  r.a = clampr(q - f0, R(0), R(1));
  return r;
}

template <typename R>
__device__ __forceinline__ R lerp_row(const Lookup<R>& lk, const R* tab) {
  return tab[lk.i0] + lk.a * (tab[lk.i1] - tab[lk.i0]);
}

// box_interp: the row below s / step, clamped
template <typename R>
__device__ __forceinline__ R box_row(R s, R step, int n, const R* tab) {
  R q = s / step;
  q = isnan(q) ? R(0) : q;
  return tab[(int)clampr(ffloor(q), R(0), R(n - 1))];
}

// ---------------------------------------------------------------------
// the functions of the sympy front end's printer, on reals and on Jets

#define ILQR_JET_REAL(name, ff, fd)                                       \
  __device__ __forceinline__ float name(float a) { return ff(a); }        \
  __device__ __forceinline__ double name(double a) { return fd(a); }

ILQR_JET_REAL(j_sin, sinf, sin)
ILQR_JET_REAL(j_cos, cosf, cos)
ILQR_JET_REAL(j_tan, tanf, tan)
ILQR_JET_REAL(j_asin, asinf, asin)
ILQR_JET_REAL(j_acos, acosf, acos)
ILQR_JET_REAL(j_atan, atanf, atan)
ILQR_JET_REAL(j_sinh, sinhf, sinh)
ILQR_JET_REAL(j_cosh, coshf, cosh)
ILQR_JET_REAL(j_tanh, tanhf, tanh)
ILQR_JET_REAL(j_exp, expf, exp)
ILQR_JET_REAL(j_log, logf, log)
ILQR_JET_REAL(j_sqrt, sqrtf, sqrt)
ILQR_JET_REAL(j_abs, fabsf, fabs)
ILQR_JET_REAL(j_erf, erff, erf)
ILQR_JET_REAL(j_log1p, log1pf, log1p)
ILQR_JET_REAL(j_expm1, expm1f, expm1)
#undef ILQR_JET_REAL

__device__ __forceinline__ float j_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double j_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float j_powr(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ double j_powr(double a, double b) {
  return pow(a, b);
}

// torch.sign: -1, 0 or 1 (0 for a NaN)
template <typename R>
__device__ __forceinline__ R j_sign(R a) {
  return a > R(0) ? R(1) : (a < R(0) ? R(-1) : R(0));
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_sin(const Jet<R, N>& a) {
  const R s = j_sin(a.v), c = j_cos(a.v);
  return chain(a, s, c, -s);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_cos(const Jet<R, N>& a) {
  const R s = j_sin(a.v), c = j_cos(a.v);
  return chain(a, c, -s, -c);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_tan(const Jet<R, N>& a) {
  const R t = j_tan(a.v), d = R(1) + t * t;
  return chain(a, t, d, R(2) * t * d);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_asin(const Jet<R, N>& a) {
  const R r = R(1) / j_sqrt(R(1) - a.v * a.v);
  return chain(a, j_asin(a.v), r, a.v * r * r * r);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_acos(const Jet<R, N>& a) {
  const R r = R(1) / j_sqrt(R(1) - a.v * a.v);
  return chain(a, j_acos(a.v), -r, -(a.v * r * r * r));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_atan(const Jet<R, N>& a) {
  const R d = R(1) + a.v * a.v;
  return chain(a, j_atan(a.v), R(1) / d, R(-2) * a.v / (d * d));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_sinh(const Jet<R, N>& a) {
  const R s = j_sinh(a.v), c = j_cosh(a.v);
  return chain(a, s, c, s);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_cosh(const Jet<R, N>& a) {
  const R s = j_sinh(a.v), c = j_cosh(a.v);
  return chain(a, c, s, c);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_tanh(const Jet<R, N>& a) {
  const R t = j_tanh(a.v), d = R(1) - t * t;
  return chain(a, t, d, R(-2) * t * d);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_exp(const Jet<R, N>& a) {
  const R e = j_exp(a.v);
  return chain(a, e, e, e);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_log(const Jet<R, N>& a) {
  const R r = R(1) / a.v;
  return chain(a, j_log(a.v), r, -(r * r));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_sqrt(const Jet<R, N>& a) {
  const R s = j_sqrt(a.v);
  return chain(a, s, R(0.5) / s, R(-0.25) / (s * a.v));
}
// autograd's slope of |a| is sign(a): 0 at 0
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_abs(const Jet<R, N>& a) {
  return chain(a, j_abs(a.v), j_sign(a.v), R(0));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_sign(const Jet<R, N>& a) {
  return Jet<R, N>(j_sign(a.v));
}

template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_erf(const Jet<R, N>& a) {
  const R d = R(1.1283791670955126) * j_exp(-(a.v * a.v));   // 2/sqrt(pi)
  return chain(a, j_erf(a.v), d, R(-2) * a.v * d);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_log1p(const Jet<R, N>& a) {
  const R r = R(1) / (R(1) + a.v);
  return chain(a, j_log1p(a.v), r, -(r * r));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_expm1(const Jet<R, N>& a) {
  const R e = j_exp(a.v);
  return chain(a, j_expm1(a.v), e, e);
}

// torch.sigmoid: y = 1 / (1 + exp(-a)); autograd's slope y (1 - y), its
// second derivative y (1 - y) (1 - 2 y)
template <typename R>
__device__ __forceinline__ R j_sigmoid(R a) {
  return R(1) / (R(1) + j_exp(-a));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_sigmoid(const Jet<R, N>& a) {
  const R y = j_sigmoid(a.v), d = (R(1) - y) * y;
  return chain(a, y, d, d * (R(1) - R(2) * y));
}

// torch.nn.functional.softplus(a, beta, threshold): a where a beta >
// threshold, else log1p(exp(a beta)) / beta; autograd's slope there z / (z
// + 1), z = exp(a beta), and its second derivative beta z / (z + 1)^2
template <typename R>
__device__ __forceinline__ R j_softplus(R a, R beta, R threshold) {
  return a * beta > threshold ? a : j_log1p(j_exp(a * beta)) / beta;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_softplus(const Jet<R, N>& a, R beta,
                                                R threshold) {
  if (a.v * beta > threshold) return a;
  const R z = j_exp(a.v * beta), d = z + R(1);
  return chain(a, j_log1p(z) / beta, z / d, beta * z / (d * d));
}

// torch.relu: a NaN passes; autograd's slope 1 where the result is > 0,
// else 0
template <typename R>
__device__ __forceinline__ R j_relu(R a) {
  return a != a ? a : (a > R(0) ? a : R(0));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_relu(const Jet<R, N>& a) {
  return a.v > R(0) ? a : Jet<R, N>(j_relu(a.v));
}

// a^n for an integer n, as torch's pow(tensor, scalar) forms it: squares
// and cubes by products, -1 and -2 by a reciprocal
template <typename R>
__device__ __forceinline__ R j_ipow(R a, int n) {
  switch (n) {
    case 0: return R(1);
    case 1: return a;
    case 2: return a * a;
    case 3: return a * a * a;
    case -1: return R(1) / a;
    case -2: return R(1) / (a * a);
    default: return j_powr(a, R(n));
  }
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_ipow(const Jet<R, N>& a, int n) {
  if (n == 0) return Jet<R, N>(R(1));
  return chain(a, j_ipow(a.v, n), R(n) * j_ipow(a.v, n - 1),
               R(n) * R(n - 1) * j_ipow(a.v, n - 2));
}

// a^b for a real b
template <typename R>
__device__ __forceinline__ R j_pow(R a, R b) { return j_powr(a, b); }
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_pow(const Jet<R, N>& a, R b) {
  return chain(a, j_powr(a.v, b), b * j_powr(a.v, b - R(1)),
               b * (b - R(1)) * j_powr(a.v, b - R(2)));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_pow(const Jet<R, N>& a,
                                           const Jet<R, N>& b) {
  const R p = j_powr(a.v, b.v), l = j_log(a.v);
  const R pa = b.v * j_powr(a.v, b.v - R(1));
  return chain2(a, b, p, pa, p * l, b.v * (b.v - R(1)) * j_powr(a.v,
                b.v - R(2)), j_powr(a.v, b.v - R(1)) * (R(1) + b.v * l),
                p * l * l);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_pow(R a, const Jet<R, N>& b) {
  return j_pow(Jet<R, N>(a), b);
}

// atan2(y, x): d/dy = x / r2, d/dx = -y / r2
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_atan2(const Jet<R, N>& y,
                                             const Jet<R, N>& x) {
  const R r2 = x.v * x.v + y.v * y.v, q = R(1) / (r2 * r2);
  return chain2(y, x, j_atan2(y.v, x.v), x.v / r2, -y.v / r2,
                R(-2) * x.v * y.v * q, (y.v * y.v - x.v * x.v) * q,
                R(2) * x.v * y.v * q);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_atan2(const Jet<R, N>& y, R x) {
  return j_atan2(y, Jet<R, N>(x));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_atan2(R y, const Jet<R, N>& x) {
  return j_atan2(Jet<R, N>(y), x);
}

// torch.hypot(a, b) = sqrt(a^2 + b^2): autograd's slopes a / r, b / r (NaN
// at the origin, as autograd's)
__device__ __forceinline__ float j_hypot(float a, float b) {
  return hypotf(a, b);
}
__device__ __forceinline__ double j_hypot(double a, double b) {
  return hypot(a, b);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_hypot(const Jet<R, N>& a,
                                             const Jet<R, N>& b) {
  const R r = j_hypot(a.v, b.v), r3 = r * r * r;
  return chain2(a, b, r, a.v / r, b.v / r, b.v * b.v / r3,
                -(a.v * b.v) / r3, a.v * a.v / r3);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_hypot(const Jet<R, N>& a, R b) {
  return j_hypot(a, Jet<R, N>(b));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_hypot(R a, const Jet<R, N>& b) {
  return j_hypot(Jet<R, N>(a), b);
}

// torch.maximum / torch.minimum: a NaN operand wins; at a tie autograd
// splits the slope between the two
template <typename R>
__device__ __forceinline__ R j_max(R a, R b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename R>
__device__ __forceinline__ R j_min(R a, R b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_max(const Jet<R, N>& a,
                                           const Jet<R, N>& b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  Jet<R, N> r = (a + b) * R(0.5);
  r.v = j_max(a.v, b.v);
  return r;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_min(const Jet<R, N>& a,
                                           const Jet<R, N>& b) {
  if (a.v < b.v) return a;
  if (a.v > b.v) return b;
  Jet<R, N> r = (a + b) * R(0.5);
  r.v = j_min(a.v, b.v);
  return r;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_max(const Jet<R, N>& a, R b) {
  return j_max(a, Jet<R, N>(b));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_max(R a, const Jet<R, N>& b) {
  return j_max(Jet<R, N>(a), b);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_min(const Jet<R, N>& a, R b) {
  return j_min(a, Jet<R, N>(b));
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_min(R a, const Jet<R, N>& b) {
  return j_min(Jet<R, N>(a), b);
}

// the reductions of K values of one type (the printer lifts each to the
// function's S): torch.amax / amin (a NaN wins; autograd shares the slope
// evenly among the values equal to the result) and the 2-norm
// torch.linalg.vector_norm (autograd's slope x / r, and 0 where r is 0:
// its backward masks the division there; its second derivative there is
// autograd's NaN, its double backward dividing by 0, for the variables
// the values depend on)
template <typename R>
__device__ __forceinline__ R reduce_ext(const R* v, int k, bool most) {
  R m = v[0];
  for (int i = 1; i < k; ++i) m = most ? j_max(m, v[i]) : j_min(m, v[i]);
  return m;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> reduce_ext(const Jet<R, N>* v, int k,
                                                bool most) {
  R m = v[0].v;
  for (int i = 1; i < k; ++i)
    m = most ? j_max(m, v[i].v) : j_min(m, v[i].v);
  Jet<R, N> r(R(0));
  int ties = 0;
  for (int i = 0; i < k; ++i)
    if (v[i].v == m) {
      r = r + v[i];
      ++ties;
    }
  if (ties > 1) r = r * (R(1) / R(ties));
  r.v = m;
  return r;
}
template <class T, class... Ts>
__device__ __forceinline__ T j_amax(const T& a, const Ts&... rest) {
  const T v[] = {a, rest...};
  return reduce_ext(v, 1 + (int)sizeof...(rest), true);
}
template <class T, class... Ts>
__device__ __forceinline__ T j_amin(const T& a, const Ts&... rest) {
  const T v[] = {a, rest...};
  return reduce_ext(v, 1 + (int)sizeof...(rest), false);
}

template <typename R>
__device__ __forceinline__ R norm2_of(const R* v, int k) {
  R s = R(0);
  for (int i = 0; i < k; ++i) s = s + v[i] * v[i];
  return j_sqrt(s);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> norm2_of(const Jet<R, N>* v, int k) {
  R s = R(0);
  for (int i = 0; i < k; ++i) s = s + v[i].v * v[i].v;
  Jet<R, N> out(j_sqrt(s));
  const R r = out.v;
  if (r == R(0)) {
    bool dep[N];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      dep[p] = false;
      for (int i = 0; i < k; ++i) dep[p] = dep[p] || v[i].g[p] != R(0);
    }
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = p; q < N; ++q)
        out.h[hidx<N>(p, q)] = dep[p] && dep[q] ? R(NAN) : R(0);
    return out;
  }
  // d r = sum x_i d x_i / r;  d2 r = (sum (x_i d2 x_i + d x_i d x_i^T)
  //                                   - d r d r^T) / r
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int p = 0; p < N; ++p) out.g[p] += v[i].v * v[i].g[p];
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = p; q < N; ++q) {
        const int h = hidx<N>(p, q);
        out.h[h] += v[i].v * v[i].h[h] + v[i].g[p] * v[i].g[q];
      }
  }
#pragma unroll
  for (int p = 0; p < N; ++p) out.g[p] /= r;
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int q = p; q < N; ++q) {
      const int h = hidx<N>(p, q);
      out.h[h] = (out.h[h] - out.g[p] * out.g[q]) / r;
    }
  return out;
}
template <class T, class... Ts>
__device__ __forceinline__ T j_norm2(const T& a, const Ts&... rest) {
  const T v[] = {a, rest...};
  return norm2_of(v, 1 + (int)sizeof...(rest));
}

// Piecewise / torch.where: the taken branch, with its derivatives
template <typename R>
__device__ __forceinline__ R j_select(bool c, R a, R b) {
  return c ? a : b;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_select(bool c, const Jet<R, N>& a,
                                              const Jet<R, N>& b) {
  return c ? a : b;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_select(bool c, const Jet<R, N>& a,
                                              R b) {
  return c ? a : Jet<R, N>(b);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_select(bool c, R a,
                                              const Jet<R, N>& b) {
  return c ? Jet<R, N>(a) : b;
}

// torch.clamp(a, lo, hi) of reals lo <= hi: the slope passes where lo <= a
// <= hi (autograd's mask) and is 0 where clamped or NaN
template <typename R>
__device__ __forceinline__ R j_clamp(R a, R lo, R hi) {
  return clampr(a, lo, hi);
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> j_clamp(const Jet<R, N>& a, R lo, R hi) {
  if (a.v >= lo && a.v <= hi) return a;
  return Jet<R, N>(clampr(a.v, lo, hi));
}

// torch.remainder(a, m) (floored, as jnp.mod): slope 1 in a
template <typename R>
__device__ __forceinline__ R pymod(R a, R m) {
  R r = fmod(a, m);
  if (r != R(0) && ((m < R(0)) != (r < R(0)))) r += m;
  return r;
}
template <typename R, int N>
__device__ __forceinline__ Jet<R, N> pymod(const Jet<R, N>& a, R m) {
  Jet<R, N> r = a;
  r.v = pymod(a.v, m);
  return r;
}

// ---------------------------------------------------------------------
// table lookups at a query that may depend on the state

constexpr double PI = 3.14159265358979323846;

// a 1-D table of the problem's params (an ArraySymbol of the front end, at
// its capacity)
template <typename R>
struct Tab {
  const R* p;
  int n;
};

// the clamped floor and ceil of fractional index q (ops/interp.py
// _indices_t; a NaN query reads row 0)
template <typename R>
__device__ __forceinline__ void indices(R q, int n, R* f0, R* f1) {
  const R qs = isnan(q) ? R(0) : q;
  *f0 = clampr(ffloor(qs), R(0), R(n - 1));
  *f1 = clampr(fceil(qs), R(0), R(n - 1));
}

// lerp(x0, dx, x, arr): arr[i0] + a (arr[i1] - arr[i0]), a = clamp(q - i0,
// 0, 1) carrying q's derivatives where it is not clamped
template <class X0, class DX, class X, typename R>
__device__ __forceinline__ auto j_lerp(const X0& x0, const DX& dx,
                                       const X& x, Tab<R> t) {
  const auto q = (x - x0) / dx;
  R f0, f1;
  indices(val(q), t.n, &f0, &f1);
  const auto a = j_clamp(q - f0, R(0), R(1));
  const R v0 = t.p[(int)f0], v1 = t.p[(int)f1];
  return v0 + a * (v1 - v0);
}

// lerp_angle: the query clamped to the table, the short angular distance
template <class X0, class DX, class X, typename R>
__device__ __forceinline__ auto j_lerp_angle(const X0& x0, const DX& dx,
                                             const X& x, Tab<R> t) {
  const auto q = j_clamp((x - x0) / dx, R(0), R(t.n - 1));
  R f0, f1;
  indices(val(q), t.n, &f0, &f1);
  const auto a = j_clamp(q - f0, R(0), R(1));
  const R v0 = t.p[(int)f0], v1 = t.p[(int)f1];
  const R d = pymod((v1 - v0) + R(PI), R(2) * R(PI)) - R(PI);
  return v0 + d * a;
}

// box_interp(dx, x, arr): the row below x / dx, clamped; no slope
template <class DX, class X, typename R>
__device__ __forceinline__ R j_box_interp(const DX& dx, const X& x,
                                          Tab<R> t) {
  R q = val(x) / val(dx);
  q = isnan(q) ? R(0) : q;
  return t.p[(int)clampr(ffloor(q), R(0), R(t.n - 1))];
}

// get_array_value(arr, i): arr[clamp(long(i), 0, n - 1)]; no slope
template <class I, typename R>
__device__ __forceinline__ R j_get_array_value(Tab<R> t, const I& i) {
  const R v = val(i);
  const int k = v != v ? 0 : (v <= R(0) ? 0 : (v >= R(t.n - 1)
                                                   ? t.n - 1 : (int)v));
  return t.p[k];
}

// a table read at index i as jnp reads x[i] (the tracer's indexing of a
// table or a captured tensor): a negative index counts from the end once,
// then the index is clamped to the table; no slope
template <class I, typename R>
__device__ __forceinline__ R j_take(Tab<R> t, const I& i) {
  const R v = val(i);
  return j_get_array_value(t, v < R(0) ? v + R(t.n) : v);
}

// lerp_wrap(length, dx, x, xs, arr): periodic linear interpolation over a
// table whose first sample sits at xs[0] (genopt.py _lerp_wrap)
template <class L, class DX, class X, typename R>
__device__ __forceinline__ auto j_lerp_wrap(const L& length, const DX& dx,
                                            const X& x, Tab<R> xs, Tab<R> t) {
  const int n = t.n;
  const R first = xs.p[0];
  const R lv = val(length), dv = val(dx);
  const R last = first + R(n - 1) * dv;
  const R gap = lv - (last - first);
  const auto xw = pymod(x - first, lv) + first;
  const auto q = (xw - first) / dv;
  const R fl = ffloor(val(q));
  const int lo = fl != fl ? 0 : (fl < R(0) ? 0 : (fl > R(n - 1) ? n - 1
                                                              : (int)fl));
  const int hi = lo + 1 < n - 1 ? lo + 1 : n - 1;
  const auto a_in = q - R(lo);
  const auto v_in = (R(1) - a_in) * t.p[lo] + a_in * t.p[hi];
  const auto a_gap = gap > R(0) ? (xw - last) / gap : (xw - last) * R(0);
  const auto v_gap = (R(1) - a_gap) * t.p[n - 1] + a_gap * t.p[0];
  return j_select(val(xw) >= last && gap > R(0), v_gap, v_in);
}

// a 2-D table, rows along y, columns along x (ops/interp.py blerp)
template <typename R>
struct Tab2 {
  const R* p;
  int rows, cols;
};

template <class X0, class Y0, class DX, class DY, class X, class Y,
          typename R>
__device__ __forceinline__ auto j_blerp(const X0& x0, const Y0& y0,
                                        const DX& dx, const DY& dy,
                                        const X& x, const Y& y, Tab2<R> t) {
  const auto qx = (x - x0) / dx;
  const auto qy = (y - y0) / dy;
  R xs, xe, ys, ye;
  indices(val(qx), t.cols, &xs, &xe);
  indices(val(qy), t.rows, &ys, &ye);
  const auto xa = j_clamp(qx - xs, R(0), R(1));
  const auto ya = j_clamp(qy - ys, R(0), R(1));
  const R* p = t.p;
  const int c = t.cols;
  const R a00 = p[(int)ys * c + (int)xs], a10 = p[(int)ye * c + (int)xs];
  const R a01 = p[(int)ys * c + (int)xe], a11 = p[(int)ye * c + (int)xe];
  const auto p0 = (R(1) - ya) * a00 + ya * a10;
  const auto p1 = (R(1) - ya) * a01 + ya * a11;
  return (R(1) - xa) * p0 + xa * p1;
}

}  // namespace ilqr_jet

#endif  // TPL_TPU_TORCH_ILQR_JET_CUH_
