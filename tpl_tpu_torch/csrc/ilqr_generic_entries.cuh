// The C entries of a source that instantiates csrc/ilqr_generic_body.cuh:
// it defines ILQR_GENERIC_PROBLEMS(X) as X(id, Struct) for each of its
// problem structs (templates over the real type in namespace ilqr_generic)
// and includes this header once.  ILQR_GENERIC_F32_ONLY /
// ILQR_GENERIC_F64_ONLY leave the other real type out (the generated
// sources of the sympy front end are built for the solver's one dtype);
// the launch then answers a missing one with cudaErrorInvalidValue.

#ifndef TPL_TPU_TORCH_ILQR_GENERIC_ENTRIES_CUH_
#define TPL_TPU_TORCH_ILQR_GENERIC_ENTRIES_CUH_

#include "ilqr_generic_body.cuh"

// ILQR_GENERIC_IF_F32(missing, expression): the expression, or `missing`
// where the source leaves float32 out (and so for float64)
#if defined(ILQR_GENERIC_F64_ONLY)
#define ILQR_GENERIC_IF_F32(missing, ...) (missing)
#else
#define ILQR_GENERIC_IF_F32(missing, ...) (__VA_ARGS__)
#endif
#if defined(ILQR_GENERIC_F32_ONLY)
#define ILQR_GENERIC_IF_F64(missing, ...) (missing)
#else
#define ILQR_GENERIC_IF_F64(missing, ...) (__VA_ARGS__)
#endif

// the words of shared memory (which = 0) and of global workspace a block
// (which = 1) of problem `problem` in float64 (f64) or float32 at H, n_ref
// when a block may use smem_limit bytes of shared memory
extern "C" size_t ilqr_generic_split(int problem, int f64, int H, int n_ref,
                                     size_t smem_limit, int which) {
  using namespace ilqr_generic;
#define X(ID, S)                                                          \
  if (problem == ID)                                                      \
    return f64 ? ILQR_GENERIC_IF_F64((size_t)0,                           \
                     split_words<S<double>, double>(H, n_ref, smem_limit, \
                                                    which))               \
               : ILQR_GENERIC_IF_F32((size_t)0, split_words<S<float>,     \
                     float>(H, n_ref, smem_limit, which));
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  return 0;
}

// the resident geometry's slot at cap words of shared memory: its words of
// shared memory (which = 0) and of workspace (which = 1); which = 2: the
// words of the shared part a block holds once
extern "C" size_t ilqr_generic_slot_split(int problem, int f64, int H,
                                          int n_ref, size_t cap, int which) {
  using namespace ilqr_generic;
  size_t n_sm = 0, n_ws = 0;
#define X(ID, S)                                                           \
  if (problem == ID) {                                                     \
    if (f64) {                                                             \
      ILQR_GENERIC_IF_F64(0, (which == 2                                   \
          ? (n_sm = Solve<S<double>, double>::shared_len(H, n_ref))        \
          : (Solve<S<double>, double>::slot_words(H, cap, &n_sm, &n_ws),   \
             (size_t)0)));                                                 \
    } else {                                                               \
      ILQR_GENERIC_IF_F32(0, (which == 2                                   \
          ? (n_sm = Solve<S<float>, float>::shared_len(H, n_ref))          \
          : (Solve<S<float>, float>::slot_words(H, cap, &n_sm, &n_ws),     \
             (size_t)0)));                                                 \
    }                                                                      \
  }
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  return which == 1 ? n_ws : n_sm;
}

#ifdef __CUDACC__
// One launch of B instances (block geometry: block b solving row b;
// resident: warps walking the rows); prof (int64, N_PHASE words) selects
// the profiling instantiation; consts: the struct's constant tables (null
// where it has none).  Returns the CUDA error code.
extern "C" int ilqr_generic_update_consts(int problem, int f64,
                                          int integrator, const void* shared,
                                          const void* rows, void* out,
                                          void* ws, long long* prof, int B,
                                          int H, int n_ref, int T, int max_it,
                                          int max_lg, size_t smem_limit,
                                          void* stream, const void* consts) {
  using namespace ilqr_generic;
#define X(ID, S)                                                            \
  if (problem == ID)                                                        \
    return f64 ? ILQR_GENERIC_IF_F64((int)cudaErrorInvalidValue,           \
                     launch<S<double>, double>(                            \
                     integrator, shared, rows, out, ws, prof, B, H, n_ref, \
                     T, max_it, max_lg, smem_limit, stream, consts))       \
               : ILQR_GENERIC_IF_F32((int)cudaErrorInvalidValue,           \
                     launch<S<float>, float>(                              \
                     integrator, shared, rows, out, ws, prof, B, H, n_ref, \
                     T, max_it, max_lg, smem_limit, stream, consts));
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// the geometry a launch of B instances takes (ilqr_generic::Geometry, 8
// int64 words into out: resident, slots, blocks, blocks an SM, shared
// bytes a block, shared words of a block's or a slot's arrays, workspace
// words a block or slot, blocks or slots in all); prof: the profiling
// instantiation's.  Returns the CUDA error code.
extern "C" int ilqr_generic_geometry(int problem, int f64, int prof, int B,
                                     int H, int n_ref, size_t smem_limit,
                                     long long* out) {
  using namespace ilqr_generic;
  Geometry g{};
  int err = (int)cudaErrorInvalidValue;
#define X(ID, S)                                                          \
  if (problem == ID)                                                      \
    err = f64 ? ILQR_GENERIC_IF_F64((int)cudaErrorInvalidValue,           \
                    launch_geometry<S<double>, double>(prof != 0, B, H,   \
                                                       n_ref, smem_limit, \
                                                       &g))               \
              : ILQR_GENERIC_IF_F32((int)cudaErrorInvalidValue,           \
                    launch_geometry<S<float>, float>(prof != 0, B, H,     \
                                                     n_ref, smem_limit,   \
                                                     &g));
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  const long long v[8] = {g.resident, g.slots, g.blocks, g.per_sm, g.smem,
                          g.cap, g.unit_ws, g.units};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return err;
}

// registers, local (spill) bytes and static shared bytes of a kernel of
// the source (resident: the resident geometry's; prof: the profiling
// instantiation) into out[0..2]
extern "C" int ilqr_generic_attributes(int problem, int f64, int resident,
                                       int prof, long long* out) {
  using namespace ilqr_generic;
#define X(ID, S)                                                          \
  if (problem == ID)                                                      \
    return f64 ? ILQR_GENERIC_IF_F64((int)cudaErrorInvalidValue,          \
                     attributes<S<double>, double>(resident != 0,         \
                                                   prof != 0, out))       \
               : ILQR_GENERIC_IF_F32((int)cudaErrorInvalidValue,          \
                     attributes<S<float>, float>(resident != 0,           \
                                                 prof != 0, out));
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// loads every kernel of the source onto the current device and raises
// their shared-memory limits, so that the first launch pays for neither
extern "C" int ilqr_generic_prepare() {
  using namespace ilqr_generic;
  int err = 0;
#define X(ID, S)                                                   \
  if (err == 0) err = ILQR_GENERIC_IF_F32(0, prepare<S<float>, float>()); \
  if (err == 0) err = ILQR_GENERIC_IF_F64(0, prepare<S<double>, double>());
  ILQR_GENERIC_PROBLEMS(X)
#undef X
  return err;
}
#endif  // __CUDACC__

#undef ILQR_GENERIC_IF_F32
#undef ILQR_GENERIC_IF_F64

#endif  // TPL_TPU_TORCH_ILQR_GENERIC_ENTRIES_CUH_
