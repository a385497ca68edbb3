// admm_solve — one whole box-ADMM solve per launch, one thread per instance.
//
// Replaces the TPU kernel pallas/admm_kernel.py::_make_kernel (reached through
// solve_box_lanes -> _solve_padded). The body is admm_box_solve of admm.cuh;
// this file only binds the operands: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B),
// per-lane bounds lb/ub (s,B), z and y (N,s,B; warm start in, final iterate
// out), x (N,s,B) out, iters (B,) out, and the scratch the caller allocates
// (Sinv (N,s,s,B), ys (N,s,B)). The warm-up mask and the final residuals stay
// in the wrapper (kernels/admm_kernel.py), as in the TPU version.
//
// Bound on this card: operations (a factorization chain per rho-epoch, four
// s x s matrix-vector products per slot and iteration, a second chain for the
// polish; kernels/_work.py), in practice the serial chain of one instance with
// B/32 warps in flight. The ragged edge (B not a multiple of the block) is
// masked here; there is no padding.
//
// The state size is a template parameter: s=9 (Go1, PogoX) and s=15 (Cassie).
// This file is compiled once per size (-DDEM_ADMM_S=<s>, both element types)
// into a library of its own, libadmm_s<s>.so (kernels/_build.py), built at
// the first solve of that size.
#include "admm.cuh"

namespace dem {

template <typename T, int S>
__global__ void admm_kernel(AdmmPtrs<T> w, const T* lb, const T* ub, int* iters,
                            AdmmSettings<T> a, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T lo[S], hi[S];
  load<S>(lo, lb, 0, B, b);
  load<S>(hi, ub, 0, B, b);
  iters[b] = admm_box_solve<T, S>(w, a, lo, hi, 0, N, B, b);
}

// ptrs: D, U, r, lb, ub, x, z, y, iters, Sinv scratch, ys scratch.
template <typename T, int S>
int admm_launch(void* const* ptrs, const int* ints, const double* reals, int N,
                int B, int block, void* stream) {
  AdmmPtrs<T> w;
  w.D = (const T*)ptrs[0];
  w.U = (const T*)ptrs[1];
  w.r = (const T*)ptrs[2];
  w.x = (T*)ptrs[5];
  w.z = (T*)ptrs[6];
  w.y = (T*)ptrs[7];
  w.Sinv = (T*)ptrs[9];
  w.ys = (T*)ptrs[10];
  const int grid = (B + block - 1) / block;
  admm_kernel<T, S><<<grid, block, 0, (cudaStream_t)stream>>>(
      w, (const T*)ptrs[3], (const T*)ptrs[4], (int*)ptrs[8],
      admm_settings<T>(ints, reals), N, B);
  return (int)cudaGetLastError();
}

}  // namespace dem

constexpr int ADMM_NPTRS = 11;

// C interface: returns cudaGetLastError() of the launch, or -1 for a state
// size this library does not instantiate.
extern "C" int dem_admm_solve(int is_double, int S, void* const* ptrs, int nptrs,
                              const int* ints, const double* reals, int N, int B,
                              int block, void* stream) {
  if (S != DEM_ADMM_S || nptrs != ADMM_NPTRS || N < 1) return -1;
  if (is_double)
    return dem::admm_launch<double, DEM_ADMM_S>(ptrs, ints, reals, N, B, block, stream);
  return dem::admm_launch<float, DEM_ADMM_S>(ptrs, ints, reals, N, B, block, stream);
}
