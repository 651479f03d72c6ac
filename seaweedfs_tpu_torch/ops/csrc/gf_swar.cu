// SWAR kernel: y[b,o,s] = XOR_d c[o,d] * x[b,d,s] over GF(2^8), word by
// word, with no transpose.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py _make_swar_kernel
// (reached through apply_gf_matrix_swar_words), which extracts bit plane
// (d, j) of a word as (x_d >> j) & 0x01010101, runs the XOR network on those
// quarter-density planes and shifts output bit i back in with acc << i.
//
// Design. Multiplication by c is linear over GF(2), so
//   c * x = XOR_j bit_j(x) * (c * 2^j).
// For a 32-bit word holding 4 bytes, ((x >> j) & 0x01010101) has bit j of
// each byte at the bottom of that byte, and an integer multiply by the
// byte (c * 2^j) spreads it to the whole byte without carries between
// bytes. Each lane owns 32 bytes (two 16-byte vectors, gf_common.cuh) of
// every shard at one position. Per input shard it makes the 8 planes of
// its 8 words (a shift and an AND each, shared by every output), and per
// output and pair of bits it does two multiplies and one 3-input XOR:
// acc ^= p_j * (c * 2^j) ^ p_j+1 * (c * 2^j+1). The output count NO (1-8)
// is a template parameter, so no work is done for rows that do not
// exist; wider matrices take one launch per 8 rows.
//
// The matrix is data: the launch's table (in its parameter block) holds
// table[(o*n_in + d)*8 + j] = c[o,d] * 2^j in GF(2^8). A block expands it
// once into shared memory as 32-bit words, word ((d*NO + o)*8 + j), read as
// warp-uniform 8-byte broadcasts with no byte extraction; one build serves
// every survivor set.
//
// What bounds it on an H100. Memory: (n_in + n_out) * B * S bytes over
// 3.35 TB/s. Work per 32-byte position and input shard: 64 * n_out
// multiplies, 32 * n_out 3-input XORs, and 120 shifts and ANDs shared by
// every output. As built for sm_90a with 4 outputs (ops/sass_report.py),
// the shard loop is 602 instructions: 287 IMAD, 196 LOP3, 58 SHF, 8 LDS;
// its 12 predicated ones are the ragged-edge loads and branches, and no
// instruction is spent on absent outputs. 96 registers, no spills; 5 blocks
// of 128 threads per SM. The multiplies fill the 64-lane multiply pipe
// and the logic ops the 64-lane integer pipe about equally, so the
// instruction rate (one per cycle per scheduler), at about 600 per warp
// and shard, sets its pace: on an H100
// 80GB HBM3 at 700 W (chip_smoke.py), 0.193 ms per (25, 10, 1 MiB)
// RS(10,4) parity call, 57% of its memory bound.

#include "gf_common.cuh"

namespace {

constexpr uint32_t LO = 0x01010101u;

template <int NO>
__global__ void __launch_bounds__(gf::THREADS, NO <= 4 ? 5 : 3)
gf_swar_kernel(const __grid_constant__ gf::Args a) {
  extern __shared__ uint2 s_coef[];
  const int n_in = a.n_in;
  uint32_t* words = reinterpret_cast<uint32_t*>(s_coef);
  for (int t = threadIdx.x; t < NO * n_in * 8; t += gf::THREADS) {
    const int od = t >> 3, d = od / NO, o = od - d * NO;
    words[t] = a.table[(o * n_in + d) * 8 + (t & 7)];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int vecs = a.vecs;
  const int blks = (vecs + 63) >> 6;
  const int n_tasks = blks * a.batch;
  const int nwarps = gridDim.x * gf::WARPS;
  int task = (blockIdx.x * gf::THREADS + threadIdx.x) >> 5;
  if (task >= n_tasks) return;
  gf::Slot cur = gf::slot(a, task, blks, lane);
  uint4 na, nb;
  gf::load2(a, cur, cur.x, na, nb);
  for (;;) {
    const int next = task + nwarps;
    gf::Slot nxt = cur;
    uint32_t acc[NO][8];
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[o][k] = 0u;
    const uint4* xp = cur.x;
    for (int d = 0; d < n_in; ++d) {
      const uint32_t w[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
      if (d + 1 < n_in) {
        xp += vecs;
        gf::load2(a, cur, xp, na, nb);
      } else if (next < n_tasks) {
        nxt = gf::slot(a, next, blks, lane);
        gf::load2(a, nxt, nxt.x, na, nb);
      }
      const uint2* c = s_coef + d * NO * 4;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t pa[8], pb[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          pa[k] = (w[k] >> (2 * jp)) & LO;
          pb[k] = (w[k] >> (2 * jp + 1)) & LO;
        }
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const uint2 cc = c[o * 4 + jp];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[o][k] ^= (pa[k] * cc.x) ^ (pb[k] * cc.y);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) gf::store2(a, cur, o, acc[o]);
    if (next >= n_tasks) break;
    task = next;
    cur = nxt;
  }
}

const gf::Kernel KERNELS[gf::MAXO] = {
    gf_swar_kernel<1>, gf_swar_kernel<2>, gf_swar_kernel<3>,
    gf_swar_kernel<4>, gf_swar_kernel<5>, gf_swar_kernel<6>,
    gf_swar_kernel<7>, gf_swar_kernel<8>};

size_t smem_bytes(int n_out, int n_in) { return (size_t)n_out * n_in * 32; }

}  // namespace

// x: (B, n_in, S) bytes; y: output shard 0 of this launch inside a
// (B, y_shards, S) buffer; table: HOST pointer to (n_out, n_in, 8) bytes
// c * 2^j, n_out * n_in * 8 <= 4032. S % 16 == 0, 1 <= n_out <= 8, x and
// y 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int gf_swar_launch(const void* x, void* y, const void* table,
                              int batch, int n_in, int n_out, int y_shards,
                              long long s_bytes, void* stream) {
  if (n_out < 1 || n_out > gf::MAXO) return (int)cudaErrorInvalidValue;
  return gf::launch(KERNELS[n_out - 1], smem_bytes(n_out, n_in), x, y, table,
                    batch, n_in, n_out, y_shards, s_bytes, stream);
}

// Blocks per SM of the instance for n_out outputs and n_in inputs, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; -(CUDA error) on failure.
extern "C" int gf_swar_blocks_per_sm(int n_out, int n_in) {
  if (n_out < 1 || n_out > gf::MAXO || n_in < 1)
    return -(int)cudaErrorInvalidValue;
  return gf::blocks_per_sm(KERNELS[n_out - 1], smem_bytes(n_out, n_in));
}
