// admm_solve — one whole box-ADMM solve per launch, a group of BOX_G = 16
// threads per instance.
//
// Replaces the TPU kernel pallas/admm_kernel.py::_make_kernel (reached through
// solve_box_lanes -> _solve_padded). The body is admm_solve_group of
// admm_group.cuh, the constrained tick's window solve (admm_box_solve_group)
// with zbase 0: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B), per-lane bounds lb/ub
// (s,B), z and y (N,s,B; warm start in, final iterate out), x (N,s,B) out,
// iters (B,) out. The warm-up mask and the final residuals stay in the wrapper
// (kernels/admm_kernel.py), as in the TPU version.
//
// Bound on this card: operations (a factorization chain per rho-epoch, four
// s x s matrix-vector products per slot and iteration, a second chain for the
// polish; kernels/_work.py), in practice the serial chain of one instance.
// On one thread per instance (this kernel's earlier design) that chain was s^2
// dependent multiply-adds per product, with the chain and the iterates
// re-read from global scratch every iteration, and B=1024 filled 32 warps.
// On the group, lane i owns row i of every block: a product is s dependent
// multiply-adds, the chain, the iterates and (at s=9) U stay in shared memory
// for the whole solve (BoxLayout, box_u_shared), and B=1024 is 512 warps.
// The ragged edge (B not a multiple of the block's instances) is masked here;
// there is no padding.
//
// The state size is a template parameter: s=9 (Go1, PogoX) and s=15 (Cassie).
// This file is compiled once per size (-DDEM_ADMM_S=<s>, both element types)
// into a library of its own, libadmm_s<s>.so (kernels/_build.py), built at
// the first solve of that size.
#include "admm_group.cuh"

namespace dem {

template <typename T, int S>
__global__ void admm_kernel(const T* D, const T* U, const T* r, const T* lb, const T* ub,
                            T* x, T* z, T* y, int* iters, AdmmSettings<T> a, int N, int B) {
  const int b = blockIdx.x * (blockDim.x / BOX_G) + box_slot();
  if (b >= B) return;
  admm_solve_group<T, S>(D, U, r, lb, ub, x, z, y, iters, a, N, B, b);
}

// ptrs: D, U, r, lb, ub, x, z, y, iters. `block` threads per block, a
// multiple of BOX_G; box_shared_bytes of dynamic shared memory. Returns the
// error of a launch the card refuses (box_launch_shape), else
// cudaGetLastError().
template <typename T, int S>
int admm_launch(void* const* ptrs, const int* ints, const double* reals, int N, int B,
                int block, void* stream) {
  const auto kern = &admm_kernel<T, S>;
  size_t shmem = 0;
  const int err = box_launch_shape(kern, box_shared_bytes<T, S>(N, block), block, &shmem);
  if (err) return err;
  const int ipb = block / BOX_G;
  kern<<<(B + ipb - 1) / ipb, block, shmem, (cudaStream_t)stream>>>(
      (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2], (const T*)ptrs[3],
      (const T*)ptrs[4], (T*)ptrs[5], (T*)ptrs[6], (T*)ptrs[7], (int*)ptrs[8],
      admm_settings<T>(ints, reals), N, B);
  return (int)cudaGetLastError();
}

}  // namespace dem

constexpr int ADMM_NPTRS = 9;

// C interface: returns the launch's CUDA error (0 if none), or -1 for a state
// size this library does not instantiate.
extern "C" int dem_admm_solve(int is_double, int S, void* const* ptrs, int nptrs,
                              const int* ints, const double* reals, int N, int B,
                              int block, void* stream) {
  if (S != DEM_ADMM_S || nptrs != ADMM_NPTRS || N < 1) return -1;
  if (is_double)
    return dem::admm_launch<double, DEM_ADMM_S>(ptrs, ints, reals, N, B, block, stream);
  return dem::admm_launch<float, DEM_ADMM_S>(ptrs, ints, reals, N, B, block, stream);
}

// The launch geometry at N slots and `block` threads per block as the card
// reports it: out[0..6] = instances and threads per block, dynamic shared
// bytes, blocks resident per SM, registers and local bytes per thread, U in
// shared memory (group_geometry). Returns 0, the CUDA error of a shape the
// card refuses, or -1 for a state size this library does not instantiate.
extern "C" int dem_admm_geometry(int is_double, int S, int N, int block, int* out) {
  if (S != DEM_ADMM_S || N < 1) return -1;
  out[6] = dem::box_u_shared<DEM_ADMM_S>() ? 1 : 0;
  if (is_double)
    return dem::group_geometry(&dem::admm_kernel<double, DEM_ADMM_S>,
                               dem::box_shared_bytes<double, DEM_ADMM_S>(N, block), block, out);
  return dem::group_geometry(&dem::admm_kernel<float, DEM_ADMM_S>,
                             dem::box_shared_bytes<float, DEM_ADMM_S>(N, block), block, out);
}
