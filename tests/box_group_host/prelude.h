// Host emulation of the few CUDA constructs that csrc/admm.cuh,
// csrc/admm_group.cuh and csrc/ekf.cuh use: one instance's group of 16 lanes
// runs as 16 std::threads, __syncwarp is a std::barrier of 16, and
// __shfl_xor_sync goes through a slot per lane between two barriers. The EKF
// harness runs a whole block as threads: its barrier spans the block, for
// __syncwarp and __syncthreads alike, and __shfl_sync goes through a slot per
// thread of the block behind one barrier.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
using std::sqrt;
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx;
inline std::barrier<>* g_bar = nullptr;
inline void __syncwarp(unsigned) { g_bar->arrive_and_wait(); }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline double g_slots[16];
template <typename T>
T __shfl_xor_sync(unsigned, T v, int o, int) {
  const int l = threadIdx.x % 16;
  g_slots[l] = (double)v;
  g_bar->arrive_and_wait();
  T r = (T)g_slots[l ^ o];
  g_bar->arrive_and_wait();
  return r;
}
// two slot arrays used in turn: a thread writes one only after the barrier
// of the shuffle before, which every thread passes after its last read of it
inline double g_lane[2][1024];
inline thread_local int g_turn = 0;
template <typename T>
T __shfl_sync(unsigned, T v, int src, int width) {
  const int t = threadIdx.x;
  double* slot = g_lane[g_turn ^= 1];
  slot[t] = (double)v;
  g_bar->arrive_and_wait();
  return (T)slot[t / width * width + src % width];
}
