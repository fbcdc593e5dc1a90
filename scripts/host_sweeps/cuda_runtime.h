// Host stand-in for the CUDA runtime: enough of it to compile pair_sweep.cu
// with g++ and run its kernels on the CPU (one std::thread per CUDA thread
// for kernels with barriers).
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
using std::fmaxf;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct alignas(16) float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local cudaError_t host_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() { auto e = host_last_error; host_last_error = cudaSuccess; return e; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == cudaSuccess ? "no error" : "host error"; }
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return cudaSuccess; }

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
struct HostBlock {
  std::barrier<> bar;
  std::atomic<int> flag{0};
  std::vector<float4> dyn;
  std::vector<float4> stat;
  explicit HostBlock(int n, size_t smem) : bar(n), dyn(smem / 16 + 1), stat(4096) {}
};
inline thread_local HostBlock* host_block = nullptr;
#define host_dyn_smem (host_block->dyn.data())
#define host_static_smem (host_block->stat.data())
inline void host_sync() { host_block->bar.arrive_and_wait(); }
inline int host_sync_or(int v) {
  host_block->bar.arrive_and_wait();
  if (v) host_block->flag.store(1);
  host_block->bar.arrive_and_wait();
  const int r = host_block->flag.load();
  host_block->bar.arrive_and_wait();
  if (threadIdx.x == 0 && threadIdx.y == 0) host_block->flag.store(0);
  return r;
}

template <class K, class... A>
void host_launch(bool threaded, K kernel, dim3 grid, dim3 block, size_t smem,
                 cudaStream_t, A... args) {
  const int nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        HostBlock hb(nt, smem);
        auto body = [&](unsigned tx, unsigned ty, unsigned tz) {
          threadIdx = {tx, ty, tz};
          blockIdx = {bx, by, bz};
          blockDim = block;
          gridDim = grid;
          host_block = &hb;
          kernel(args...);
        };
        if (!threaded) {
          for (unsigned tz = 0; tz < block.z; ++tz)
            for (unsigned ty = 0; ty < block.y; ++ty)
              for (unsigned tx = 0; tx < block.x; ++tx) body(tx, ty, tz);
          continue;
        }
        std::vector<std::thread> ts;
        ts.reserve(nt);
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx)
              ts.emplace_back(body, tx, ty, tz);
        for (auto& t : ts) t.join();
      }
}
