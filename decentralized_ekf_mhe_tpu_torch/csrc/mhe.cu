// mhe_tick — the C interface of the MHE replay kernels (csrc/mhe_body.cuh).
//
// Six kernels share one body: the shared camera clock or a clock per lane
// (PI), unconstrained or box-constrained (CON), the Cholesky tail (CHOL,
// unconstrained, on either clock), each for float and double, and each with
// the stage ablation (ABL, 1..5; constrained 1..4; with the Cholesky tail
// 1..3, the stages before the tail) — instantiations of a body that takes
// nvcc tens of seconds each, a minute for a constrained one — and each model
// shape is one more set of them. So this file is compiled once per
// instantiation, with
//   -DDEM_MHE_SHAPE=<tag> -DDEM_MHE_S=<s> -DDEM_MHE_M=<m> -DDEM_MHE_L=<L>
//   -DDEM_MHE_LOT=<leg_odom_type>
//   -DDEM_MHE_UNIT=<symbol> -DDEM_MHE_REAL=float|double -DDEM_MHE_CON=0|1
//   -DDEM_MHE_PI=0|1 [-DDEM_MHE_CHOL=1] [-DDEM_MHE_ABL=1..5]
// (kernels/_build.py starts all of them at once, one nvcc process each).
// The units of one shape are grouped into shared libraries by variant: the
// shared clock (libmhe_<tag>.so: unconstrained and constrained), the clock per
// lane (libmhe_<tag>_pi.so), the Cholesky tail (libmhe_<tag>_chol.so, on
// either clock), and the stage ablation of each: libmhe_<tag>_abl_<type>.so
// (the Gauss-Jordan tick on the shared clock), _abl_pi_<type>.so (on a clock
// per lane), _abl_chol_<type>.so (the Cholesky tick on either clock) and
// _abl_box_<type>.so (the constrained tick on either clock), <type> f32 or
// f64, each built at its first use. Each
// library has this file once more, without DEM_MHE_UNIT, for the one entry
// point below, which declares every unit of its shape weak: a unit the
// library does not link is null there.
//
// A build with -DDEM_MHE_ONLY_BOX_F64 compiles the float64 constrained units
// alone (the others come out empty): the build without FMA contraction that
// chip_smoke.py's fma_witness compares needs no other.

#ifndef DEM_MHE_CHOL
#define DEM_MHE_CHOL 0
#endif
#ifndef DEM_MHE_ABL
#define DEM_MHE_ABL 0
#endif
#define DEM_CAT2(a, b) a##b
#define DEM_CAT(a, b) DEM_CAT2(a, b)
#define DEM_MHE_IS_F64_double 1
#define DEM_MHE_IS_F64_float 0

#ifdef DEM_MHE_UNIT
#if !defined(DEM_MHE_ONLY_BOX_F64) || (DEM_MHE_CON && DEM_CAT(DEM_MHE_IS_F64_, DEM_MHE_REAL))
#include "mhe_body.cuh"

extern "C" int DEM_MHE_UNIT(void* const* ptrs, const double* consts,
                            void* const* box_ptrs, const int* ints,
                            const double* reals, int N, int B, int Tn, int t0,
                            int block, void* stream) {
  return dem::mhe_launch<DEM_MHE_REAL, DEM_MHE_S, DEM_MHE_M, DEM_MHE_L, DEM_MHE_LOT,
                         DEM_MHE_CON != 0, DEM_MHE_PI != 0, DEM_MHE_CHOL != 0, DEM_MHE_ABL>(
      ptrs, consts, box_ptrs, ints, reals, N, B, Tn, t0, block, stream);
}
#if DEM_MHE_CON && !DEM_MHE_ABL
// the constrained unit's launch geometry (mhe_box_geometry)
extern "C" int DEM_CAT(DEM_MHE_UNIT, _geometry)(int N, int block, int* out) {
  return dem::mhe_box_geometry<DEM_MHE_REAL, DEM_MHE_S, DEM_MHE_M, DEM_MHE_L, DEM_MHE_LOT,
                               DEM_MHE_PI != 0>(N, block, out);
}
#elif !DEM_MHE_ABL
// the unconstrained unit's (either tail): that of its group launch
// (mhe_tick_geometry)
extern "C" int DEM_CAT(DEM_MHE_UNIT, _geometry)(int N, int block, int* out) {
  (void)N;
  return dem::mhe_tick_geometry<DEM_MHE_REAL, DEM_MHE_S, DEM_MHE_M, DEM_MHE_L, DEM_MHE_LOT,
                                DEM_MHE_PI != 0, DEM_MHE_CHOL != 0>(block, out);
}
#endif
#endif

#else

// dem_mhe_unit_<shape><suffix>, the symbol _build._mhe_units gives a unit
#define DEM_UNIT(suffix) DEM_CAT(DEM_CAT(dem_mhe_unit_, DEM_MHE_SHAPE), suffix)
#define DEM_MHE_UNIT_DECL(suffix)                                             \
  extern "C" __attribute__((weak)) int DEM_UNIT(suffix)(                      \
      void* const* ptrs, const double* consts, void* const* box_ptrs,         \
      const int* ints, const double* reals, int N, int B, int Tn, int t0,     \
      int block, void* stream);
DEM_MHE_UNIT_DECL(_f32)
DEM_MHE_UNIT_DECL(_f64)
DEM_MHE_UNIT_DECL(_box_f32)
DEM_MHE_UNIT_DECL(_box_f64)
DEM_MHE_UNIT_DECL(_pi_f32)
DEM_MHE_UNIT_DECL(_pi_f64)
DEM_MHE_UNIT_DECL(_pi_box_f32)
DEM_MHE_UNIT_DECL(_pi_box_f64)
DEM_MHE_UNIT_DECL(_chol_f32)
DEM_MHE_UNIT_DECL(_chol_f64)
DEM_MHE_UNIT_DECL(_pi_chol_f32)
DEM_MHE_UNIT_DECL(_pi_chol_f64)
// the stage ablation of variant v (symbol prefix: "", _pi, _chol, _pi_chol,
// _box, _pi_box), stage k, either type
#define DEM_MHE_ABL_DECL(v, k) DEM_MHE_UNIT_DECL(v##_abl##k##_f32) DEM_MHE_UNIT_DECL(v##_abl##k##_f64)
#define DEM_MHE_ABL_DECLS(v) \
  DEM_MHE_ABL_DECL(v, 1) DEM_MHE_ABL_DECL(v, 2) DEM_MHE_ABL_DECL(v, 3) \
  DEM_MHE_ABL_DECL(v, 4) DEM_MHE_ABL_DECL(v, 5)
DEM_MHE_ABL_DECLS()
DEM_MHE_ABL_DECLS(_pi)
DEM_MHE_ABL_DECLS(_chol)
DEM_MHE_ABL_DECLS(_pi_chol)
DEM_MHE_ABL_DECLS(_box)
DEM_MHE_ABL_DECLS(_pi_box)
#define DEM_MHE_GEOMETRY_DECL(suffix) \
  extern "C" __attribute__((weak)) int DEM_UNIT(suffix)(int N, int block, int* out);
DEM_MHE_GEOMETRY_DECL(_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_f64_geometry)
DEM_MHE_GEOMETRY_DECL(_box_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_box_f64_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_f64_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_box_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_box_f64_geometry)
DEM_MHE_GEOMETRY_DECL(_chol_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_chol_f64_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_chol_f32_geometry)
DEM_MHE_GEOMETRY_DECL(_pi_chol_f64_geometry)

namespace {
constexpr int MHE_NPTRS = 34;                 // MhePtrs
constexpr int MHE_BOX_NPTRS = MHE_NPTRS + 8;  // MhePtrs, then MheBox
}  // namespace

// The entry point returns cudaGetLastError() of the launch, or -1 for a
// shape or variant this library does not link. con, pi, chol and ablate pick
// the unit: the box-constrained tick (con), a camera clock per lane (pi), the
// Cholesky tail (chol; only unconstrained), the tick with stage ablate
// skipped (1 ingest, 2 marg, 3 build, 4 assembly, 5 solve; constrained 1..4,
// with the Cholesky tail 1..3; 0 none). ptrs: the 34
// pointers of MhePtrs in declaration order (mhe_launch lists them); a
// constrained tick takes the 8 of MheBox after them and the ADMM settings in
// ints/reals (unread otherwise). A per-lane-clock tick takes the same
// operands with (Tn,B) VO metadata and a (4,B)/(1,B) Bezier schedule.
extern "C" int dem_mhe_tick(int is_double, int con, int pi, int chol, int ablate, int S,
                            int M, int L, int lot, void* const* ptrs, int nptrs,
                            const double* consts, const int* ints,
                            const double* reals, int N, int B, int Tn, int t0,
                            int block, void* stream) {
  using Unit = int (*)(void* const*, const double*, void* const*, const int*,
                       const double*, int, int, int, int, int, void*);
  // [pi][con][is_double]; a unit this library does not link is null
  static const Unit units[2][2][2] = {
      {{DEM_UNIT(_f32), DEM_UNIT(_f64)}, {DEM_UNIT(_box_f32), DEM_UNIT(_box_f64)}},
      {{DEM_UNIT(_pi_f32), DEM_UNIT(_pi_f64)},
       {DEM_UNIT(_pi_box_f32), DEM_UNIT(_pi_box_f64)}}};
  // [pi][is_double]
  static const Unit chol_units[2][2] = {{DEM_UNIT(_chol_f32), DEM_UNIT(_chol_f64)},
                                        {DEM_UNIT(_pi_chol_f32), DEM_UNIT(_pi_chol_f64)}};
  // the ablated units: [variant][pi][stage - 1][is_double], variant 0 the
  // Gauss-Jordan tick, 1 the Cholesky one (stages 1..3), 2 the constrained
  // one (stages 1..4); null where no unit exists
#define DEM_ABL_STAGE(v, k) {DEM_UNIT(v##_abl##k##_f32), DEM_UNIT(v##_abl##k##_f64)}
#define DEM_ABL_STAGES(v) \
  {DEM_ABL_STAGE(v, 1), DEM_ABL_STAGE(v, 2), DEM_ABL_STAGE(v, 3), DEM_ABL_STAGE(v, 4), \
   DEM_ABL_STAGE(v, 5)}
  static const Unit abl_units[3][2][5][2] = {
      {DEM_ABL_STAGES(), DEM_ABL_STAGES(_pi)},
      {DEM_ABL_STAGES(_chol), DEM_ABL_STAGES(_pi_chol)},
      {DEM_ABL_STAGES(_box), DEM_ABL_STAGES(_pi_box)}};
  const int last_stage = con ? 4 : chol ? 3 : 5;
  const bool shape = S == DEM_MHE_S && M == DEM_MHE_M && L == DEM_MHE_L &&
                     lot == DEM_MHE_LOT && N >= 2;
  const Unit unit =
      ablate ? ((ablate >= 1 && ablate <= last_stage && !(con && chol))
                    ? abl_units[con ? 2 : chol ? 1 : 0][pi != 0][ablate - 1][is_double != 0]
                    : nullptr)
      : !chol ? units[pi != 0][con != 0][is_double != 0]
      : !con  ? chol_units[pi != 0][is_double != 0] : nullptr;
  if (!shape || !unit || nptrs != (con ? MHE_BOX_NPTRS : MHE_NPTRS)) return -1;
  return unit(ptrs, consts, con ? ptrs + MHE_NPTRS : nullptr, ints, reals, N, B,
              Tn, t0, block, stream);
}

// The launch geometry of a tick — the constrained one (con) or the
// unconstrained one with the Gauss-Jordan or (chol) the Cholesky tail, each
// on a group of threads per instance — of this shape and clock (pi) at
// N slots and `block` threads per block: out[0..6] as mhe_box_geometry and
// mhe_tick_geometry fill them (instances and threads per block, dynamic
// shared bytes, blocks resident per SM, registers and local bytes per thread,
// U in shared memory). Returns 0, the CUDA error of a shape the card refuses,
// or -1 for a shape, type or variant this library does not link.
extern "C" int dem_mhe_geometry(int is_double, int con, int pi, int chol, int S, int M, int L,
                                int lot, int N, int block, int* out) {
  using Geometry = int (*)(int, int, int*);
  // [pi][con][is_double]
  static const Geometry geometry[2][2][2] = {
      {{DEM_UNIT(_f32_geometry), DEM_UNIT(_f64_geometry)},
       {DEM_UNIT(_box_f32_geometry), DEM_UNIT(_box_f64_geometry)}},
      {{DEM_UNIT(_pi_f32_geometry), DEM_UNIT(_pi_f64_geometry)},
       {DEM_UNIT(_pi_box_f32_geometry), DEM_UNIT(_pi_box_f64_geometry)}}};
  // [pi][is_double]
  static const Geometry chol_geometry[2][2] = {
      {DEM_UNIT(_chol_f32_geometry), DEM_UNIT(_chol_f64_geometry)},
      {DEM_UNIT(_pi_chol_f32_geometry), DEM_UNIT(_pi_chol_f64_geometry)}};
  const Geometry g = !chol ? geometry[pi != 0][con != 0][is_double != 0]
                     : !con ? chol_geometry[pi != 0][is_double != 0] : nullptr;
  if (S != DEM_MHE_S || M != DEM_MHE_M || L != DEM_MHE_L || lot != DEM_MHE_LOT || N < 2 || !g)
    return -1;
  return g(N, block, out);
}

#endif
