// ekf_stage — the whole 500 Hz orientation-EKF stage, a group of 4 threads
// per instance (body: ekf_group_body of ekf.cuh).
//
// Replaces the TPU kernel pallas/ekf_kernel.py::_make_kernel (reached through
// replay -> _chunk_call). Time is a loop inside the kernel: one launch covers
// all the ticks handed to it, the carried-in state is read from its own
// tensors and the state carried out written to fresh ones, so a log split
// over two launches equals one launch. The TPU kernel kept state and rings
// resident in VMEM and chunked time through its grid; here the ring sits in
// the block's shared memory for the whole launch and the input stream comes
// through shared memory chunk by chunk, double buffered (ekf.cuh).
//
// Bound on this card: operations (about 1k floating-point operations per
// substep, kernels/_work.py, against 6 streamed inputs), in practice the
// serial chain of one instance: thousands of dependent filter steps. The
// group shortens each step's chain (4 lanes share its 4 x 4 algebra by rows
// and its quotients by entries) and spreads B=1024 over the card.
#include "ekf.cuh"

namespace dem {

template <typename T>
__global__ void ekf_kernel(EkfPtrs<T> p, EkfConsts<T> c, EkfDims d) {
  ekf_group_body<T>(p, c, d, blockIdx.x, threadIdx.x);
}

// the launch geometry (out[0..6]: instances and threads per block, dynamic
// shared bytes, blocks resident per SM, registers and local bytes per thread,
// ticks per chunk) or the launch itself
template <typename T>
int ekf_run(void* const* ptrs, const double* consts, int quirk_W, int Tn, int S, int R, int B,
            int t0, int pl, int ticks_per_chunk, int block, void* stream, int* geometry) {
  if (block < 32 || block > 1024 || block % 32 || S < 1 || R < 1 || ticks_per_chunk < 1)
    return -1;
  const EkfDims d =
      ekf_dims(Tn, S, R, B, t0, pl, block / EKF_G, (int)sizeof(T), ticks_per_chunk);
  const size_t bytes = d.bytes((int)sizeof(T));
  const auto kern = &ekf_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (geometry) {
    int per_sm = 0;
    cudaFuncAttributes fa;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, bytes);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    geometry[0] = d.ipb; geometry[1] = block; geometry[2] = (int)bytes;
    geometry[3] = per_sm; geometry[4] = fa.numRegs; geometry[5] = (int)fa.localSizeBytes;
    geometry[6] = d.CT;
    return 0;
  }
  EkfPtrs<T> p;
  p.gyro = (const T*)ptrs[0];
  p.accel = (const T*)ptrs[1];
  p.valid = (const int*)ptrs[2];
  p.vo_active = (const int*)ptrs[3];
  p.vo_sb = (const int*)ptrs[4];
  p.vo_q = (const T*)ptrs[5];
  p.q_in = (const T*)ptrs[6];
  p.P_in = (const T*)ptrs[7];
  p.gh_in = (const T*)ptrs[8];
  p.ah_in = (const T*)ptrs[9];
  p.qh_in = (const T*)ptrs[10];
  p.Ph_in = (const T*)ptrs[11];
  p.q_out = (T*)ptrs[12];
  p.P_out = (T*)ptrs[13];
  p.gh_out = (T*)ptrs[14];
  p.ah_out = (T*)ptrs[15];
  p.qh_out = (T*)ptrs[16];
  p.Ph_out = (T*)ptrs[17];
  p.q_seq = (T*)ptrs[18];
  EkfConsts<T> c;
  int k = 0;
  c.dt = (T)consts[k++];
  for (int i = 0; i < 9; ++i) c.C_gyro[i] = (T)consts[k++];
  for (int i = 0; i < 9; ++i) c.C_accel[i] = (T)consts[k++];
  for (int i = 0; i < 16; ++i) c.C_vo[i] = (T)consts[k++];
  for (int i = 0; i < 3; ++i) c.gravity[i] = (T)consts[k++];
  c.g2 = (T)consts[k++];
  c.quirk_W = quirk_W;
  const int grid = (B + d.ipb - 1) / d.ipb;
  kern<<<grid, block, bytes, (cudaStream_t)stream>>>(p, c, d);
  return (int)cudaGetLastError();
}

}  // namespace dem

// C interface. ptrs: the 19 pointers of EkfPtrs in declaration order;
// consts (double): dt, C_gyro[9], C_accel[9], C_vo[16], gravity[3], g2;
// ticks_per_chunk: ticks of the input stream staged at a time; block: threads
// per block, a multiple of 32 (4 per instance). Returns -1 for a block, S, R
// or chunk it does not take, the error of a launch the card refuses, else
// cudaGetLastError().
extern "C" int dem_ekf_stage(int is_double, void* const* ptrs, const double* consts, int quirk_W,
                             int Tn, int S, int R, int B, int t0, int per_lane_vo_q,
                             int ticks_per_chunk, int block, void* stream) {
  if (is_double)
    return dem::ekf_run<double>(ptrs, consts, quirk_W, Tn, S, R, B, t0, per_lane_vo_q,
                                ticks_per_chunk, block, stream, nullptr);
  return dem::ekf_run<float>(ptrs, consts, quirk_W, Tn, S, R, B, t0, per_lane_vo_q,
                             ticks_per_chunk, block, stream, nullptr);
}

// The launch geometry as the card reports it: out[0..6] (ekf_run).
extern "C" int dem_ekf_geometry(int is_double, int S, int R, int per_lane_vo_q,
                                int ticks_per_chunk, int block, int* out) {
  if (is_double)
    return dem::ekf_run<double>(nullptr, nullptr, 0, 0, S, R, 0, 0, per_lane_vo_q,
                                ticks_per_chunk, block, nullptr, out);
  return dem::ekf_run<float>(nullptr, nullptr, 0, 0, S, R, 0, 0, per_lane_vo_q, ticks_per_chunk,
                             block, nullptr, out);
}
