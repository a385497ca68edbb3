// mhe_tick — the C interface of the MHE replay kernels (csrc/mhe_body.cuh).
//
// Four kernels share one body: the shared camera clock or a clock per lane
// (PI), unconstrained or box-constrained (CON), each for float and double —
// eight instantiations of a body that takes nvcc tens of seconds each. So
// this file is compiled once per instantiation, with
//   -DDEM_MHE_UNIT=<symbol> -DDEM_MHE_REAL=float|double -DDEM_MHE_CON=0|1
//   -DDEM_MHE_PI=0|1
// (kernels/_build.py starts all of them at once, one nvcc process each), and
// once more without DEM_MHE_UNIT for the one entry point below, which picks
// the unit by variant and element type. All of them link into one
// shared library.

#ifdef DEM_MHE_UNIT
#include "mhe_body.cuh"

extern "C" int DEM_MHE_UNIT(void* const* ptrs, const double* consts,
                            void* const* box_ptrs, const int* ints,
                            const double* reals, int N, int B, int Tn, int t0,
                            int block, void* stream) {
  return dem::mhe_launch<DEM_MHE_REAL, 9, 12, 4, DEM_MHE_CON != 0, DEM_MHE_PI != 0>(
      ptrs, consts, box_ptrs, ints, reals, N, B, Tn, t0, block, stream);
}

#else

#define DEM_MHE_UNIT_DECL(sym)                                                \
  extern "C" int sym(void* const* ptrs, const double* consts,                 \
                     void* const* box_ptrs, const int* ints,                  \
                     const double* reals, int N, int B, int Tn, int t0,       \
                     int block, void* stream);
DEM_MHE_UNIT_DECL(dem_mhe_unit_f32)
DEM_MHE_UNIT_DECL(dem_mhe_unit_f64)
DEM_MHE_UNIT_DECL(dem_mhe_unit_box_f32)
DEM_MHE_UNIT_DECL(dem_mhe_unit_box_f64)
DEM_MHE_UNIT_DECL(dem_mhe_unit_pi_f32)
DEM_MHE_UNIT_DECL(dem_mhe_unit_pi_f64)
DEM_MHE_UNIT_DECL(dem_mhe_unit_pi_box_f32)
DEM_MHE_UNIT_DECL(dem_mhe_unit_pi_box_f64)

namespace {
constexpr int MHE_NPTRS = 34;                 // MhePtrs
constexpr int MHE_BOX_NPTRS = MHE_NPTRS + 11; // MhePtrs, then MheBox

// only Go1 is instantiated: s=9, m=12, L=4, leg_odom_type 0
bool go1(int S, int M, int L, int lot, int N) {
  return S == 9 && M == 12 && L == 4 && lot == 0 && N >= 2;
}
}  // namespace

// The entry point returns cudaGetLastError() of the launch, or -1 for a
// shape this build does not instantiate. con and pi pick the unit: the
// box-constrained tick (con), a camera clock per lane (pi). ptrs: the 34
// pointers of MhePtrs in declaration order (mhe_launch lists them); a
// constrained tick takes the 11 of MheBox after them and the ADMM settings in
// ints/reals (unread otherwise). A per-lane-clock tick takes the same
// operands with (Tn,B) VO metadata and a (4,B)/(1,B) Bezier schedule.
extern "C" int dem_mhe_tick(int is_double, int con, int pi, int S, int M, int L,
                            int lot, void* const* ptrs, int nptrs,
                            const double* consts, const int* ints,
                            const double* reals, int N, int B, int Tn, int t0,
                            int block, void* stream) {
  using Unit = int (*)(void* const*, const double*, void* const*, const int*,
                       const double*, int, int, int, int, int, void*);
  // [pi][con][is_double]
  static const Unit units[2][2][2] = {
      {{dem_mhe_unit_f32, dem_mhe_unit_f64},
       {dem_mhe_unit_box_f32, dem_mhe_unit_box_f64}},
      {{dem_mhe_unit_pi_f32, dem_mhe_unit_pi_f64},
       {dem_mhe_unit_pi_box_f32, dem_mhe_unit_pi_box_f64}}};
  if (!go1(S, M, L, lot, N) || nptrs != (con ? MHE_BOX_NPTRS : MHE_NPTRS))
    return -1;
  return units[pi != 0][con != 0][is_double != 0](
      ptrs, consts, con ? ptrs + MHE_NPTRS : nullptr, ints, reals, N, B, Tn, t0,
      block, stream);
}

#endif
