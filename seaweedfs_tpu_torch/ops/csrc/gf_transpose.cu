// Transpose kernel: y[b,o,s] = XOR_d c[o,d] * x[b,d,s] over GF(2^8), on
// bit planes made in registers.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py _make_kernel
// (reached through apply_gf_matrix_words): a 32x32 bit transpose of each
// group of 32 words, the GF(2) XOR network over the 8*n_in bit planes,
// and a transpose back.
//
// Design. Each lane owns 32 bytes of every shard at one position (two
// 16-byte vectors, gf_common.cuh) and bit-transposes them in registers:
// three swap-move rounds (shift and bit-select) turn its 8 words into 8
// planes, plane j holding bit j of all 32 bytes. No shuffles and no
// staging buffer. The matrix is then applied by the method of four
// Russians: the lane writes the 16 XOR combinations of planes 0-3 and the
// 16 of planes 4-7 into its own column of shared memory (22 XORs, 30
// stores), and output bit plane i of output o takes two lookups, at the
// low and high nibble of its matrix row byte, and one 3-input XOR. All
// lanes look up the same entries at once, so the row's two offsets are
// warp-uniform (read as 16-bit pairs, four rows per 16-byte broadcast)
// and the lookups are free of bank conflicts (lane l's column is bank l).
// The shard loop is outermost: 8*NO accumulators are live. The output
// count NO (1-8) is a template parameter, so no work is done for rows
// that do not exist; wider matrices take one launch per 8 rows.
//
// The matrix is data: the launch's table (in its parameter block) holds
// the expanded GF(2) matrix as bytes, table[(o*n_in + d)*8 + i] bit j =
// bit (8o+i, 8d+j) (ops/bitslice.expand_gf2). A block turns it once into
// the byte offsets of the two entries each row byte selects, so one build
// serves every survivor set.
//
// What bounds it on an H100. Memory: (n_in + n_out) * B * S bytes over
// 3.35 TB/s. Work per 32-byte position and input shard, for n_out
// outputs: 48 transpose instructions, 22 XORs and 30 stores to build the
// tables, then 16 * n_out lookups and 8 * n_out XORs, where a dense
// evaluation of the expanded matrix takes 64 * n_out masked ANDs on the
// 64-lane integer pipe (built and timed first, that design took 0.215 ms
// per slab call named below, ops/kernel_bench.py). As built for sm_90a
// with 4 outputs (ops/sass_report.py), the shard loop is
// 413 instructions: 138 LOP3, 76 IMAD, 72 LDS, 34 LEA, 30 STS, 15 SHF;
// its 12 predicated ones are the ragged-edge loads and branches, and no
// instruction is spent on absent outputs. 80 registers, 8 bytes spilled once
// per task outside that loop; 6 blocks of 128 threads per SM. By those
// counts the integer pipe, shared memory and the instruction rate (one
// per cycle per scheduler) each need about 410 cycles per warp and shard, so no single one sets the pace; an L2
// prefetch two shards ahead changed nothing, so memory latency does not
// either. On an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.157 ms per
// (25, 10, 1 MiB) RS(10,4) parity call, 70% of its memory bound.

#include "gf_common.cuh"

namespace {

// Swap address bit k of the word index with bit k of the bit-in-byte
// index: `lo` has word-bit k = 0, `hi` has it = 1; M marks the bit
// positions whose bit k of the bit-in-byte index is 0.
template <int S, uint32_t M>
__device__ __forceinline__ void swap_move(uint32_t& lo, uint32_t& hi) {
  const uint32_t l = (lo & M) | ((hi << S) & ~M);
  hi = ((lo >> S) & M) | (hi & ~M);
  lo = l;
}

// 8x8 bit transposes of the 4 byte lanes across 8 words: afterwards bit
// (8*b + r) of w[j] is what bit (8*b + j) of w[r] was. An involution.
__device__ __forceinline__ void transpose8(uint32_t w[8]) {
#pragma unroll
  for (int r = 0; r < 8; r += 2) swap_move<1, 0x55555555u>(w[r], w[r + 1]);
  swap_move<2, 0x33333333u>(w[0], w[2]);
  swap_move<2, 0x33333333u>(w[1], w[3]);
  swap_move<2, 0x33333333u>(w[4], w[6]);
  swap_move<2, 0x33333333u>(w[5], w[7]);
#pragma unroll
  for (int r = 0; r < 4; ++r) swap_move<4, 0x0F0F0F0Fu>(w[r], w[r + 4]);
}

constexpr int T = gf::THREADS;
constexpr int TAB_WORDS = 32 * T;  // two 16-entry XOR tables per lane

template <int NO>
__global__ void __launch_bounds__(gf::THREADS, NO <= 4 ? 6 : 3)
gf_transpose_kernel(const __grid_constant__ gf::Args a) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* offs = tab + TAB_WORDS;
  const int n_in = a.n_in;
  // word (d*NO + o)*8 + i: the byte offsets, from a lane's column, of the
  // entries row (o, d, i) selects: its low nibble's in table 0 (low half)
  // and its high nibble's in table 1 (high half)
  for (int t = threadIdx.x; t < NO * n_in * 8; t += gf::THREADS) {
    const int od = t >> 3, d = od / NO, o = od - d * NO;
    const uint32_t row = a.table[(o * n_in + d) * 8 + (t & 7)];
    offs[t] = (row & 15u) * T * 4 | (16u + (row >> 4)) * T * 4 << 16;
  }
  uint32_t* mine = tab + threadIdx.x;       // entry e at mine[e * T]
  mine[0] = 0u;
  mine[16 * T] = 0u;
  __syncthreads();
  const char* base = reinterpret_cast<const char*>(mine);

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
      for (int i = 0; i < 8; ++i) acc[o][i] = 0u;
    const uint4* xp = cur.x;
    for (int d = 0; d < n_in; ++d) {
      uint32_t p[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
      if (d + 1 < n_in) {
        xp += vecs;
        gf::load2(a, cur, xp, na, nb);
      } else if (next < n_tasks) {
        nxt = gf::slot(a, next, blks, lane);
        gf::load2(a, nxt, nxt.x, na, nb);
      }
      transpose8(p);
      // table h, entry e: the XOR of planes 4h + j for the set bits j of e
      // (entry 0 stays 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* e = mine + h * 16 * T;
        const uint32_t q0 = p[4 * h], q1 = p[4 * h + 1], q2 = p[4 * h + 2],
                       q3 = p[4 * h + 3];
        const uint32_t x01 = q0 ^ q1, x23 = q2 ^ q3;
        e[1 * T] = q0;         e[2 * T] = q1;         e[3 * T] = x01;
        e[4 * T] = q2;         e[5 * T] = q2 ^ q0;    e[6 * T] = q2 ^ q1;
        e[7 * T] = q2 ^ x01;   e[8 * T] = q3;         e[9 * T] = q3 ^ q0;
        e[10 * T] = q3 ^ q1;   e[11 * T] = q3 ^ x01;  e[12 * T] = x23;
        e[13 * T] = x23 ^ q0;  e[14 * T] = x23 ^ q1;  e[15 * T] = x23 ^ x01;
      }
      const uint4* off = reinterpret_cast<const uint4*>(offs) + d * NO * 2;
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint4 q = off[o * 2 + k];
          const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[o][4 * k + r] ^=
                *reinterpret_cast<const uint32_t*>(base + (w[r] & 0xFFFFu)) ^
                *reinterpret_cast<const uint32_t*>(base + (w[r] >> 16));
        }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      transpose8(acc[o]);
      gf::store2(a, cur, o, acc[o]);
    }
    if (next >= n_tasks) break;
    task = next;
    cur = nxt;
  }
}

const gf::Kernel KERNELS[gf::MAXO] = {
    gf_transpose_kernel<1>, gf_transpose_kernel<2>, gf_transpose_kernel<3>,
    gf_transpose_kernel<4>, gf_transpose_kernel<5>, gf_transpose_kernel<6>,
    gf_transpose_kernel<7>, gf_transpose_kernel<8>};

size_t smem_bytes(int n_out, int n_in) {
  return TAB_WORDS * 4 + (size_t)n_out * n_in * 32;
}

}  // namespace

// x: (B, n_in, S) bytes; y: output shard 0 of this launch inside a
// (B, y_shards, S) buffer; table: HOST pointer to (n_out, n_in, 8) row
// bytes, n_out * n_in * 8 <= 4032. S % 16 == 0, 1 <= n_out <= 8, x and y
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int gf_transpose_launch(const void* x, void* y, const void* table,
                                   int batch, int n_in, int n_out,
                                   int y_shards, long long s_bytes,
                                   void* stream) {
  if (n_out < 1 || n_out > gf::MAXO) return (int)cudaErrorInvalidValue;
  return gf::launch(KERNELS[n_out - 1], smem_bytes(n_out, n_in), x, y, table,
                    batch, n_in, n_out, y_shards, s_bytes, stream);
}

// Blocks per SM of the instance for n_out outputs and n_in inputs, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; -(CUDA error) on failure.
extern "C" int gf_transpose_blocks_per_sm(int n_out, int n_in) {
  if (n_out < 1 || n_out > gf::MAXO || n_in < 1)
    return -(int)cudaErrorInvalidValue;
  return gf::blocks_per_sm(KERNELS[n_out - 1], smem_bytes(n_out, n_in));
}
