// tridiag_solve — batched SPD block-tridiagonal solve, a group of
// group_size<S>() threads per instance (16 below s=16, a warp from s=16), in
// either layout of the operands.
//
// Replaces the TPU kernel pallas/tridiag_kernel.py::_kernel, reached through
// solve_lanes (the lanes layout: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B), x
// (N,s,B), the system masked by the caller) and through the standard-layout
// route solve_batched (D (K,B,s,s), U (K-1,B,s,s), r (K,B,s), read in place
// through their strides, the (K,B) warm-up mask
// applied in the kernel as it loads, x (K,B,s)). The body is
// tridiag_solve_group of tridiag.cuh; the layout is its policy (TriLanes,
// TriStd), so one sweep serves both.
//
// Bound on this card: bytes (about 5k floating-point operations per slot
// against 2 s^2 + 2 s values moved is ~7 operations per float32 byte, below the
// card's ~20), and in practice the serial dependency chain of one instance.
// On one thread per instance (this kernel's earlier design) every product of
// that chain was s^2 dependent multiply-adds and B=1024 filled 32 warps; the
// standard route also masked the system and moved B to the minor axis and
// back in PyTorch around the launch, three passes over the operands and one
// over x. On the group, lane i owns row i of every block (s dependent
// multiply-adds per product, row-parallel Gauss-Jordan), B=1024 is 512 warps,
// and the standard route reads its layout and its mask itself. The
// factorization chain sits in shared memory (at s=15 in float64 that keeps 5
// instances per SM, so B=1024 takes a second wave; the chain in global
// scratch instead was 1.4x faster there but slower everywhere else, PERF.md
// §6, and a second path was not worth that one case). The ragged edge (B not a multiple of the
// block's instances) is masked here; there is no padding.
//
// The state size is a template parameter: s=9 (Go1, PogoX), s=15 (Cassie)
// and s=21 (Go1 with its foot positions as states, a warp per instance). This
// file is compiled once per size (-DDEM_TRIDIAG_S=<s>, both
// element types) into a library of its own, libtridiag_s<s>.so
// (kernels/_build.py), built at the first solve of that size.
#include "tridiag.cuh"

namespace dem {

template <typename T, int S>
__global__ void tridiag_kernel(const T* D, const T* U, const T* r, T* x, int N, int B) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  tridiag_solve_group<T, S>(TriLanes<T, S>{D, U, r, x, B, b}, N);
}

template <typename T, int S>
__global__ void tridiag_std_kernel(const T* D, const T* U, const T* r, const bool* valid,
                                   TriStrides st, T* x, int N, int B) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  tridiag_solve_group<T, S>(TriStd<T, S>{D, U, r, valid, x, st, B, b}, N);
}

// the launch geometry (out[0..5] of group_geometry) or the launch itself
template <typename T, int S>
int tridiag_run(bool std_layout, const void* D, const void* U, const void* r,
                const void* valid, const TriStrides& st, void* x, int N, int B, int block,
                void* stream, int* geometry) {
  constexpr int G = group_size<S>();
  const size_t bytes = tri_shared_bytes<T, S>(N, block);
  const int ipb = block / G;
  size_t shmem = 0;
  if (std_layout) {
    const auto kern = &tridiag_std_kernel<T, S>;
    if (geometry) return group_geometry<G>(kern, bytes, block, geometry);
    const int err = box_launch_shape<G>(kern, bytes, block, &shmem);
    if (err) return err;
    kern<<<(B + ipb - 1) / ipb, block, shmem, (cudaStream_t)stream>>>(
        (const T*)D, (const T*)U, (const T*)r, (const bool*)valid, st, (T*)x, N, B);
  } else {
    const auto kern = &tridiag_kernel<T, S>;
    if (geometry) return group_geometry<G>(kern, bytes, block, geometry);
    const int err = box_launch_shape<G>(kern, bytes, block, &shmem);
    if (err) return err;
    kern<<<(B + ipb - 1) / ipb, block, shmem, (cudaStream_t)stream>>>(
        (const T*)D, (const T*)U, (const T*)r, (T*)x, N, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace dem

// C interface. std_layout 0: the lanes layout (valid and strides unused); 1:
// the standard layout with the (K,B) bool mask `valid` (null: every slot
// live) and `strides`, the thirteen of TriStrides in order (D's four, U's
// four, r's three, valid's two). `block` threads per block, a multiple of
// group_size<S>(). Returns the error of a launch the card refuses, else
// cudaGetLastError(); -1 for a state size this library does not instantiate.
extern "C" int dem_tridiag_solve(int is_double, int S, int std_layout, const void* D,
                                 const void* U, const void* r, const void* valid,
                                 const long long* strides, void* x, int N, int B, int block,
                                 void* stream) {
  if (S != DEM_TRIDIAG_S || N < 1) return -1;
  dem::TriStrides st{};
  if (std_layout) {
    long long* dst[] = {st.d, st.u, st.r, st.v};
    const int axes[] = {4, 4, 3, 2};
    for (int a = 0, k = 0; a < 4; ++a)
      for (int i = 0; i < axes[a]; ++i) dst[a][i] = strides[k++];
  }
  if (is_double)
    return dem::tridiag_run<double, DEM_TRIDIAG_S>(std_layout != 0, D, U, r, valid, st, x, N, B,
                                                   block, stream, nullptr);
  return dem::tridiag_run<float, DEM_TRIDIAG_S>(std_layout != 0, D, U, r, valid, st, x, N, B,
                                                block, stream, nullptr);
}

// The launch geometry as the card reports it: out[0..5] = instances and
// threads per block, dynamic shared bytes, blocks resident per SM, registers
// and local bytes per thread (group_geometry).
extern "C" int dem_tridiag_geometry(int is_double, int S, int std_layout, int N, int block,
                                    int* out) {
  if (S != DEM_TRIDIAG_S || N < 1) return -1;
  const dem::TriStrides st{};
  if (is_double)
    return dem::tridiag_run<double, DEM_TRIDIAG_S>(std_layout != 0, nullptr, nullptr, nullptr,
                                                   nullptr, st, nullptr, N, 0, block, nullptr,
                                                   out);
  return dem::tridiag_run<float, DEM_TRIDIAG_S>(std_layout != 0, nullptr, nullptr, nullptr,
                                                nullptr, st, nullptr, N, 0, block, nullptr, out);
}
