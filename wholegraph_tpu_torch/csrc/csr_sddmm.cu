// Kernel H: CSR SDDMM over a destination-sorted CSR,
//   out[e] = sum_j a[dst_e, j] * b[clamp(col[e]), j]   for every edge e,
// where dst_e is the row whose [row_ptr[d], row_ptr[d+1]) holds e. a and b
// are f32 or bf16 (the same dtype) and may have a row stride; the dot is
// accumulated in f32 and out is f32.
//
// Replaces the TPU's `_sddmm_window_kernel` (wholegraph_tpu/ops/spmm_pallas.py:
// 771, through `sddmm_window`), which selected both endpoint rows of every
// edge out of VMEM tiles with int8 byte-plane one-hot matmuls on the MXU.
// In the port H also computes the attention gradient dw = <ct[dst], x[col]>
// of a weighted SpMM (GAT), which the JAX package sent to the XLA
// `sddmm_chunked` (spmm_pallas.py:652-668). Exact on any CSR: no window.
//
// Bound: bytes. a and b are read (each row once, at best), col and row_ptr
// once, out (4 bytes an edge) written once; 2 * E * D operations are far
// below the card's rate. The per-edge reads of b rows hit L2 on a
// locality-ordered CSR, and a[d] is read once per row, not per edge.
//
// Design: a group of G lanes per destination row (G as in kernel G); the
// group holds its slice of a[d] in registers (NCH vectors of VEC elements a
// lane), and for each edge of the row reads b[col_e], takes the partial dot
// and reduces it across the group with xor shuffles. Lane j of the group
// keeps the result of the j-th edge of each batch of G edges, so the batch
// is stored with one coalesced write. A row wider than one pass (G * NCH *
// VEC columns) takes more passes, each adding to the edge's value (the same
// lane writes it every time: no atomics, deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, int NCH>
__global__ void csr_sddmm_kernel(const int32_t* __restrict__ row_ptr,
                                 const int32_t* __restrict__ col,
                                 const T* __restrict__ a, int64_t lda,
                                 const T* __restrict__ b, int64_t ldb,
                                 int64_t n_src, float* __restrict__ out,
                                 int64_t n_rows, int64_t n_vec, int group) {
  const int lane = threadIdx.x & 31;
  const int g_lane = lane & (group - 1);
  const int g_base = lane & ~(group - 1);
  const unsigned g_mask =
      group == 32 ? 0xffffffffu : (((1u << group) - 1u) << g_base);
  const int64_t per_warp = 32 / group;
  const int64_t first =
      ((int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * per_warp +
      lane / group;
  const int64_t stride = ((int64_t(gridDim.x) * blockDim.x) >> 5) * per_warp;
  const int64_t per_pass = int64_t(group) * NCH;
  for (int64_t r = first; r < n_rows; r += stride) {
    const int32_t e0 = row_ptr[r], e1 = row_ptr[r + 1];
    if (e0 >= e1) continue;
    for (int64_t v0 = 0; v0 < n_vec; v0 += per_pass) {
      float ar[NCH][VEC];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int64_t v = v0 + int64_t(k) * group + g_lane;
        if (v < n_vec) {
          const Pack<T, VEC> p =
              *reinterpret_cast<const Pack<T, VEC>*>(a + r * lda + v * VEC);
#pragma unroll
          for (int i = 0; i < VEC; ++i) ar[k][i] = to_f32(p.v[i]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) ar[k][i] = 0.0f;
        }
      }
      for (int32_t eb = e0; eb < e1; eb += group) {
        int32_t c = 0;
        if (eb + g_lane < e1) {
          int64_t id = col[eb + g_lane];
          c = int32_t(id < 0 ? 0 : (id >= n_src ? n_src - 1 : id));
        }
        const int cnt = e1 - eb < group ? e1 - eb : group;
        float mine = 0.0f;
        for (int j = 0; j < cnt; ++j) {
          const int32_t cj = __shfl_sync(g_mask, c, g_base + j);
          const T* br = b + int64_t(cj) * ldb;
          float p = 0.0f;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const int64_t v = v0 + int64_t(k) * group + g_lane;
            if (v < n_vec) {
              const Pack<T, VEC> q =
                  *reinterpret_cast<const Pack<T, VEC>*>(br + v * VEC);
#pragma unroll
              for (int i = 0; i < VEC; ++i) p += ar[k][i] * to_f32(q.v[i]);
            }
          }
          for (int off = group >> 1; off > 0; off >>= 1)
            p += __shfl_xor_sync(g_mask, p, off);
          if (g_lane == j) mine = p;
        }
        if (g_lane < cnt)
          out[eb + g_lane] = v0 == 0 ? mine : out[eb + g_lane] + mine;
      }
    }
  }
}

template <typename T, int VEC, int NCH>
void launch(const void* row_ptr, const void* col, const void* a, int64_t lda,
            const void* b, int64_t ldb, int64_t n_src, void* out,
            int64_t n_rows, int64_t n_vec, int group, cudaStream_t stream) {
  const int threads = 256;
  const int64_t rows_per_block = (threads / 32) * (32 / group);
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  csr_sddmm_kernel<T, VEC, NCH><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col),
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb, n_src,
      static_cast<float*>(out), n_rows, n_vec, group);
}

template <typename T, int VEC>
void launch_nch(int nch, const void* row_ptr, const void* col, const void* a,
                int64_t lda, const void* b, int64_t ldb, int64_t n_src,
                void* out, int64_t n_rows, int64_t n_vec, int group,
                cudaStream_t s) {
  if (nch == 1)
    launch<T, VEC, 1>(row_ptr, col, a, lda, b, ldb, n_src, out, n_rows, n_vec,
                      group, s);
  else if (nch == 2)
    launch<T, VEC, 2>(row_ptr, col, a, lda, b, ldb, n_src, out, n_rows, n_vec,
                      group, s);
  else
    launch<T, VEC, 4>(row_ptr, col, a, lda, b, ldb, n_src, out, n_rows, n_vec,
                      group, s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (a and b alike). vec: elements per load; it
// divides D and both row strides, and the wrapper checked the pointers.
// lda, ldb: row strides in elements. out: [E] f32.
extern "C" int wg_csr_sddmm(const void* row_ptr, const void* col,
                            const void* a, int64_t lda, const void* b,
                            int64_t ldb, int64_t n_src, void* out,
                            int64_t n_rows, int64_t D, int dtype, int vec,
                            void* stream) {
  if (n_rows <= 0 || D <= 0 || n_src <= 0 || vec <= 0 || D % vec ||
      lda % vec || ldb % vec)
    return int(cudaErrorInvalidValue);
  const int64_t n_vec = D / vec;
  int group = 1;
  while (group < 32 && group < n_vec) group *= 2;
  const int64_t chunks = (n_vec + group - 1) / group;
  const int nch = chunks <= 1 ? 1 : (chunks <= 2 ? 2 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_H(T, V)                                                          \
  launch_nch<T, V>(nch, row_ptr, col, a, lda, b, ldb, n_src, out, n_rows, \
                   n_vec, group, s)
  if (dtype == 0 && vec == 4) WG_H(float, 4);
  else if (dtype == 0 && vec == 2) WG_H(float, 2);
  else if (dtype == 0 && vec == 1) WG_H(float, 1);
  else if (dtype == 1 && vec == 8) WG_H(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 4) WG_H(__nv_bfloat16, 4);
  else if (dtype == 1 && vec == 2) WG_H(__nv_bfloat16, 2);
  else if (dtype == 1 && vec == 1) WG_H(__nv_bfloat16, 1);
  else return int(cudaErrorInvalidValue);
#undef WG_H
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
