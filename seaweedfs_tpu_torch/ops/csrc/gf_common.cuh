// Shared by gf_transpose.cu and gf_swar.cu: the launch parameters (with
// the coefficient table inside them), the mapping of warps to 1 KiB
// blocks of a shard row, and the persistent launch with its occupancy
// query. Both kernels compute y[b,o,s] = XOR_d c[o,d] * x[b,d,s] over
// GF(2^8) on (B, n_in, S) bytes, S a multiple of 16.
//
// The table travels in the kernel's parameter block: the launch function
// copies it from host memory into `Args`, and CUDA copies `Args` at
// launch. So no table lives in device memory, and none can be freed while
// a launch on another stream still reads it. A block expands the table
// into shared memory once, in each kernel's own format.
//
// Work split. A warp task is one 1 KiB block of one batch row: lane l owns
// the 16-byte vectors l and l + 32 of that block (chunks A and B; each warp
// load is 512 contiguous bytes) in every input and output shard. A lane
// whose vector lies past the row's end loads zeros and stores nothing, so
// S needs only be a multiple of 16. The grid is persistent: as many blocks
// as fit on the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
// warp striding over the tasks. Every lane loads the next shard's two
// vectors (or the next task's first) before it works on the current ones.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace gf {

constexpr int MAXO = 8;           // outputs per launch, at most
constexpr int THREADS = 128;      // 4 warps per block
constexpr int WARPS = THREADS / 32;
constexpr int TABLE_BYTES = 4032; // (n_out, n_in, 8) bytes; ops/rs_cuda.py

struct Args {
  const uint4* x;    // (batch, n_in, vecs) 16-byte vectors
  uint4* y;          // output shard 0 of this launch in (batch, y_shards, vecs)
  int vecs;          // 16-byte vectors per shard row
  int batch, n_in, y_shards;
  uint8_t table[TABLE_BYTES];
};
static_assert(sizeof(Args) <= 4096, "kernel parameters are limited to 4 KB");

using Kernel = void (*)(Args);

// Where a lane's two vectors of a task lie.
struct Slot {
  const uint4* x;  // chunk A of input shard 0
  int b, v;        // batch row; vector index of chunk A in the row
};

__device__ __forceinline__ Slot slot(const Args& a, int task, int blks,
                                     int lane) {
  const int b = task / blks;
  const int v = ((task - b * blks) << 6) + lane;
  return {a.x + (long long)b * a.n_in * a.vecs + v, b, v};
}

__device__ __forceinline__ void load2(const Args& a, const Slot& s,
                                      const uint4* p, uint4& va, uint4& vb) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  va = s.v < a.vecs ? __ldg(p) : zero;
  vb = s.v + 32 < a.vecs ? __ldg(p + 32) : zero;
}

// Store output shard o's two vectors of a task.
__device__ __forceinline__ void store2(const Args& a, const Slot& s, int o,
                                       const uint32_t w[8]) {
  uint4* p = a.y + ((long long)s.b * a.y_shards + o) * a.vecs + s.v;
  if (s.v < a.vecs) p[0] = make_uint4(w[0], w[1], w[2], w[3]);
  if (s.v + 32 < a.vecs) p[32] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Blocks of `kern` that fit on one SM with `smem` bytes of dynamic shared
// memory (opting in above the default 48 KB).
inline cudaError_t occupancy(Kernel kern, size_t smem, int* per_sm) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, (const void*)kern, THREADS, smem);
}

// Validate, fill Args (table from host memory) and launch a persistent
// grid on `stream`. Returns cudaGetLastError() after the launch.
inline int launch(Kernel kern, size_t smem, const void* x, void* y,
                  const void* table, int batch, int n_in, int n_out,
                  int y_shards, long long s_bytes, void* stream) {
  if (n_out < 1 || n_out > MAXO || n_in < 1 || batch < 0 || s_bytes < 0 ||
      s_bytes % 16 || s_bytes / 16 > INT_MAX - 64 ||
      (long long)n_out * n_in * 8 > TABLE_BYTES)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const uint4*)x;
  a.y = (uint4*)y;
  a.vecs = (int)(s_bytes / 16);
  a.batch = batch;
  a.n_in = n_in;
  a.y_shards = y_shards;
  memcpy(a.table, table, (size_t)n_out * n_in * 8);
  const long long n_tasks = (long long)batch * ((a.vecs + 63) / 64);
  if (n_tasks == 0) return 0;
  if (n_tasks > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = occupancy(kern, smem, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (n_tasks + WARPS - 1) / WARPS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  kern<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks per SM for the library's occupancy export, or -(CUDA error).
inline int blocks_per_sm(Kernel kern, size_t smem) {
  int per_sm = 0;
  const cudaError_t e = occupancy(kern, smem, &per_sm);
  return e == cudaSuccess ? per_sm : -(int)e;
}

}  // namespace gf
