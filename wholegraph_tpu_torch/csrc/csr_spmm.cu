// Kernel G: CSR SpMM over a destination-sorted CSR,
//   out[d] = sum_{e = row_ptr[d]}^{row_ptr[d+1]-1} w_e * x[clamp(col[e])]
// with w_e = 1 when no weights are given, accumulated in f32; the mean
// divides by max(deg_d, 1), the edge count and never the weight sum. An
// empty row gives zeros. x and out are f32 or bf16 (out takes x's dtype)
// and may have a row stride (one GAT head, featv[:, h, :], runs as is).
//
// Replaces the TPU's `_spmm_window_kernel` (wholegraph_tpu/ops/spmm_pallas.py:
// 201, through `spmm_window`), which built a [T, W] adjacency tile per dst
// tile from int8 one-hots on the MXU and multiplied it into a window slab of
// x DMA'd into VMEM. On Hopper no plan is needed: a lane group walks its
// row's edges and reads each source row directly, so the kernel is exact on
// any CSR (the TPU kernel zeroed edges outside its window). The same kernel
// runs the backward dx on the transposed CSR (the TPU left that to XLA's
// segment path).
//
// Bound: bytes. x is read (each distinct source row once, at best), out
// written once, col and row_ptr read once; 2 * E * D f32 operations are far
// below the card's rate. The E per-edge row reads (E * D * itemsize, 21 GB
// at the bench shape) hit L2 when the CSR is locality-ordered: a run of
// consecutive destinations reads a narrow span of source rows.
//
// Design: a group of G lanes per destination row (G = 32, or the power of
// two that covers the row's vectors when D is narrow, so a 64-wide f32 GAT
// head takes half a warp); lanes across D in vectors of VEC elements (16
// bytes when D, the strides and the pointers allow), NCH vectors per lane
// held in registers, so one pass over the edges covers G * NCH * VEC
// columns. Each lane loads one edge's column and weight and the group
// broadcasts them with shuffles. No atomics: the sum is deterministic. A
// grid-stride loop over rows; any degree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, int NCH>
__global__ void csr_spmm_kernel(const int32_t* __restrict__ row_ptr,
                                const int32_t* __restrict__ col,
                                const float* __restrict__ w,
                                const T* __restrict__ x, int64_t ldx,
                                int64_t n_src, T* __restrict__ out,
                                int64_t ldo, int64_t n_rows, int64_t n_vec,
                                int group, int mean) {
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
    const int deg = e1 - e0;
    const float denom = float(deg > 1 ? deg : 1);
    for (int64_t v0 = 0; v0 < n_vec; v0 += per_pass) {
      float acc[NCH][VEC];
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
      for (int32_t eb = e0; eb < e1; eb += group) {
        int32_t c = 0;
        float wt = 1.0f;
        if (eb + g_lane < e1) {
          int64_t id = col[eb + g_lane];
          c = int32_t(id < 0 ? 0 : (id >= n_src ? n_src - 1 : id));
          if (w) wt = w[eb + g_lane];
        }
        const int cnt = e1 - eb < group ? e1 - eb : group;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const int32_t cj = __shfl_sync(g_mask, c, g_base + j);
          const float wj = __shfl_sync(g_mask, wt, g_base + j);
          const T* xr = x + int64_t(cj) * ldx;
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const int64_t v = v0 + int64_t(k) * group + g_lane;
            if (v < n_vec) {
              const Pack<T, VEC> p =
                  *reinterpret_cast<const Pack<T, VEC>*>(xr + v * VEC);
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[k][i] += wj * to_f32(p.v[i]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int64_t v = v0 + int64_t(k) * group + g_lane;
        if (v < n_vec) {
          Pack<T, VEC> o;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            o.v[i] = from_f32<T>(mean ? acc[k][i] / denom : acc[k][i]);
          *reinterpret_cast<Pack<T, VEC>*>(out + r * ldo + v * VEC) = o;
        }
      }
    }
  }
}

template <typename T, int VEC, int NCH>
void launch(const void* row_ptr, const void* col, const void* w, const void* x,
            int64_t ldx, int64_t n_src, void* out, int64_t ldo, int64_t n_rows,
            int64_t n_vec, int group, int mean, cudaStream_t stream) {
  const int threads = 256;
  const int64_t rows_per_block = (threads / 32) * (32 / group);
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 32) blocks = 132 * 32;
  csr_spmm_kernel<T, VEC, NCH><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(w), static_cast<const T*>(x), ldx, n_src,
      static_cast<T*>(out), ldo, n_rows, n_vec, group, mean);
}

template <typename T, int VEC>
void launch_nch(int nch, const void* row_ptr, const void* col, const void* w,
                const void* x, int64_t ldx, int64_t n_src, void* out,
                int64_t ldo, int64_t n_rows, int64_t n_vec, int group,
                int mean, cudaStream_t s) {
  if (nch == 1)
    launch<T, VEC, 1>(row_ptr, col, w, x, ldx, n_src, out, ldo, n_rows, n_vec,
                      group, mean, s);
  else if (nch == 2)
    launch<T, VEC, 2>(row_ptr, col, w, x, ldx, n_src, out, ldo, n_rows, n_vec,
                      group, mean, s);
  else
    launch<T, VEC, 4>(row_ptr, col, w, x, ldx, n_src, out, ldo, n_rows, n_vec,
                      group, mean, s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. vec: elements per load (16 bytes' worth or
// fewer; it divides D and both row strides, and the wrapper checked the
// pointers). w may be null. ldx, ldo: row strides in elements.
extern "C" int wg_csr_spmm(const void* row_ptr, const void* col, const void* w,
                           const void* x, int64_t ldx, int64_t n_src,
                           void* out, int64_t ldo, int64_t n_rows, int64_t D,
                           int mean, int dtype, int vec, void* stream) {
  if (n_rows <= 0 || D <= 0 || n_src <= 0 || vec <= 0 || D % vec ||
      ldx % vec || ldo % vec)
    return int(cudaErrorInvalidValue);
  const int64_t n_vec = D / vec;
  int group = 1;
  while (group < 32 && group < n_vec) group *= 2;
  const int64_t chunks = (n_vec + group - 1) / group;
  const int nch = chunks <= 1 ? 1 : (chunks <= 2 ? 2 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_G(T, V)                                                        \
  launch_nch<T, V>(nch, row_ptr, col, w, x, ldx, n_src, out, ldo, n_rows, \
                   n_vec, group, mean, s)
  if (dtype == 0 && vec == 4) WG_G(float, 4);
  else if (dtype == 0 && vec == 2) WG_G(float, 2);
  else if (dtype == 0 && vec == 1) WG_G(float, 1);
  else if (dtype == 1 && vec == 8) WG_G(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 4) WG_G(__nv_bfloat16, 4);
  else if (dtype == 1 && vec == 2) WG_G(__nv_bfloat16, 2);
  else if (dtype == 1 && vec == 1) WG_G(__nv_bfloat16, 1);
  else return int(cudaErrorInvalidValue);
#undef WG_G
  return int(cudaGetLastError());
}

extern "C" const char* wg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
