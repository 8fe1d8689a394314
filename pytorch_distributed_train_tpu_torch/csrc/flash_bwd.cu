// FlashAttention-2 backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels pytorch_distributed_train_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (both reached through `_bwd` ->
// `pl.pallas_call`). With P = exp(S*scale - lse) recomputed from the forward's
// row logsumexp and delta = rowsum(dO * O) (computed by the caller, as the
// TPU package computes it outside its kernels):
//   dV_j = sum_i P_ij^T dO_i               dP_ij = dO_i V_j^T
//   dS_ij = P_ij * (dP_ij - delta_i)
//   dQ_i = scale * sum_j dS_ij K_j         dK_j = scale * sum_i dS_ij^T Q_i
// Causal masking, a sliding window, native GQA (query head h reads KV head
// h / (H / Hkv); dK/dV sum over the H / Hkv query heads of the group) and
// ragged S. A row whose lse is NEG_INF (every key masked) gets P = 0.
//
// What bounds it on an H100 SXM: the dQ kernel does three matrix products
// over the kept (query, key) pairs (S, dP, dQ: 6*B*H*D*pairs FLOPs), the
// dK/dV kernel four (S, dP, dV, dK: 8*B*H*D*pairs), against 989 TFLOP/s of
// bf16 tensor-core rate; the bytes each must move (Q, K, V, dO, lse, delta
// in; dQ or dK and dV out) are two orders of magnitude below that at the
// training shape (B 2, S 4096, H 32, D 128), so both are compute-bound: the
// tensor cores have to do the products and no (S, S) matrix may reach
// device memory.
//
// What this design does about it:
// - dQ: one block per (b, head, BM-row query tile). Each warp owns 16 query
//   rows; a loop inside the block walks the key tiles the mask keeps (the
//   TPU's sequential grid axis). S and dP stay in shared memory per warp,
//   dS goes to the tensor cores as bf16, the fp32 dQ accumulator lives in
//   shared memory and is written once.
// - dK/dV: one block per (b, KV head, BN-row key tile). Each warp owns 16
//   key rows and computes the transposed products (K Q^T, V dO^T), so P^T
//   and dS^T are rows it owns; a loop walks the rep query heads of the GQA
//   group and the query tiles that see this key tile, accumulating dK and dV
//   in fp32 shared memory. No atomics: one block owns each output tile, so
//   the result is deterministic (the TPU kernel's `rep` grid axis).
// - bf16 inputs run every product through WMMA (16x16x16 bf16 -> fp32);
//   P and dS are rounded to bf16 for the second products (the TPU kernel
//   keeps them fp32; the difference is within the bf16 tolerance). fp32
//   inputs take the same structure on the CUDA cores in fp32, with rows
//   padded by one element so shared-memory reads do not collide in banks.
// - Tiles wholly outside the causal triangle or the window band are never
//   visited; edge tiles and the ragged last tile are masked element by
//   element. Padded Q/K/V/dO rows are zero-filled, so 0 * garbage can never
//   turn into NaN.
// - Inputs are read as (B, S, H, D) through the strides given: no transpose
//   copies. The head dimension must be contiguous and every row 16-byte
//   aligned (the wrapper checks).
// Later work (not here): wgmma, TMA loads into a ring of stages, register
// accumulators and warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t round_up(size_t x) { return (x + 127) / 128 * 128; }

// Copy `rows` rows of D elements (row stride `stride` elements in global
// memory) into shared memory with pitch LD; rows at or beyond `valid` are
// zero-filled. VEC: 16-byte loads (rows must be 16-byte aligned).
template <typename T, int D, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int rows,
                                          int valid) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int CPR = D * sizeof(T) / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * CPR; i += NT) {
      const int r = i / CPR, c = i % CPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
      *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, d = i % D;
      dst[r * LD + d] = r < valid ? src[r * stride + d] : from_f<T>(0.f);
    }
  }
}

// Load `rows` entries of a (B*H, S) fp32 row vector; entries past `valid`
// read 0 (their rows are masked anyway).
template <int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int rows, int valid) {
  for (int i = threadIdx.x; i < rows; i += NT) dst[i] = i < valid ? src[i] : 0.f;
}

__device__ __forceinline__ bool kept(int qpos, int kpos, int S, int causal, int window) {
  bool keep = qpos < S && kpos < S;
  if (causal) keep = keep && qpos >= kpos;
  if (window > 0) keep = keep && (qpos - kpos) < window;
  return keep;
}

// P for one (query, key) pair; a fully masked row (lse = NEG_INF) gives 0.
__device__ __forceinline__ float prob(float s, float lse, bool keep, float scale) {
  const float lse_safe = lse <= NEG_INF / 2 ? 0.f : lse;
  return keep ? __expf(s * scale - lse_safe) : 0.f;
}

// ------------------------------------------------------------------ dQ
//   TC: tensor-core (WMMA) products, bf16 only. Rows of the query tile are
//   split over NW warps; TC needs 16 rows per warp.
template <typename T, int D, int BM, int BN, bool TC>
struct DqCfg {
  static constexpr int NW = 4;
  static constexpr int NT = NW * 32;
  static constexpr int RPW = BM / NW;
  static_assert(!TC || RPW == 16, "tensor-core path: 16 query rows per warp");
  static constexpr int LD = D + (TC ? 8 : 1);   // Q/K/V/dO row pitch (elements)
  static constexpr int LDS = BN;                // fp32 S and dP
  static constexpr int LDP = TC ? BN + 8 : BN;  // dS
  static constexpr int LDO = D + 4;             // fp32 dQ accumulator
  using TP = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_DO = OFF_Q + round_up(sizeof(T) * BM * LD);
  static constexpr size_t OFF_K = OFF_DO + round_up(sizeof(T) * BM * LD);
  static constexpr size_t OFF_V = OFF_K + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_S = OFF_V + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_DP = OFF_S + (TC ? round_up(sizeof(float) * BM * LDS) : 0);
  static constexpr size_t OFF_DS = OFF_DP + (TC ? round_up(sizeof(float) * BM * LDS) : 0);
  static constexpr size_t OFF_ACC = OFF_DS + round_up(sizeof(TP) * BM * LDP);
  static constexpr size_t OFF_LSE = OFF_ACC + round_up(sizeof(float) * BM * LDO);
  static constexpr size_t OFF_DEL = OFF_LSE + round_up(sizeof(float) * BM);
  static constexpr size_t SMEM = OFF_DEL + round_up(sizeof(float) * BM);
  static_assert(SMEM <= SMEM_LIMIT, "dQ tile does not fit in shared memory");
};

// Strides: element strides (batch, seq, head) of q, k, v, do, dq in order.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

template <typename T, int D, int BM, int BN, bool TC>
__global__ void __launch_bounds__(DqCfg<T, D, BM, BN, TC>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int Hkv,
                    Strides st, int causal, int window, float scale) {
  using C = DqCfg<T, D, BM, BN, TC>;
  using TP = typename C::TP;
  constexpr int NT = C::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* dOs = reinterpret_cast<T*>(smem + C::OFF_DO);
  T* Ks = reinterpret_cast<T*>(smem + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + C::OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + C::OFF_S);
  float* dPs = reinterpret_cast<float*>(smem + C::OFF_DP);
  TP* dSs = reinterpret_cast<TP*>(smem + C::OFF_DS);
  float* Acc = reinterpret_cast<float*>(smem + C::OFF_ACC);
  float* Ls = reinterpret_cast<float*>(smem + C::OFF_LSE);
  float* Dl = reinterpret_cast<float*>(smem + C::OFF_DEL);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);

  load_tile<T, D, C::LD, NT>(Qs, q + b * st.q[0] + h * st.q[2] + (long long)q0 * st.q[1],
                             st.q[1], BM, S - q0);
  load_tile<T, D, C::LD, NT>(dOs, dout + b * st.o[0] + h * st.o[2] + (long long)q0 * st.o[1],
                             st.o[1], BM, S - q0);
  load_vec<NT>(Ls, lse + (long long)bh * S + q0, BM, S - q0);
  load_vec<NT>(Dl, delta + (long long)bh * S + q0, BM, S - q0);
  for (int i = threadIdx.x; i < BM * C::LDO; i += NT) Acc[i] = 0.f;

  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];

  // Key tiles that intersect this query tile's causal triangle and band.
  int kv_lo = 0, kv_hi = S;
  if (causal) kv_hi = min(S, q0 + BM);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BN) * BN;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, C::LD, NT>(Ks, kb + (long long)k0 * st.k[1], st.k[1], BN, S - k0);
    load_tile<T, D, C::LD, NT>(Vs, vb + (long long)k0 * st.v[1], st.v[1], BN, S - k0);
    __syncthreads();

    if constexpr (TC) {
      const __nv_bfloat16* Qb = reinterpret_cast<const __nv_bfloat16*>(Qs);
      const __nv_bfloat16* dOb = reinterpret_cast<const __nv_bfloat16*>(dOs);
      const __nv_bfloat16* Kb = reinterpret_cast<const __nv_bfloat16*>(Ks);
      const __nv_bfloat16* Vb = reinterpret_cast<const __nv_bfloat16*>(Vs);
      const int r0 = warp * 16;
      // ---- S = Q K^T and dP = dO V^T for this warp's 16 rows
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, p_acc;
        wmma::fill_fragment(s_acc, 0.f);
        wmma::fill_fragment(p_acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, Qb + r0 * C::LD + kk * 16, C::LD);
          wmma::load_matrix_sync(bm, Kb + (j * 16) * C::LD + kk * 16, C::LD);
          wmma::mma_sync(s_acc, a, bm, s_acc);
          wmma::load_matrix_sync(a, dOb + r0 * C::LD + kk * 16, C::LD);
          wmma::load_matrix_sync(bm, Vb + (j * 16) * C::LD + kk * 16, C::LD);
          wmma::mma_sync(p_acc, a, bm, p_acc);
        }
        wmma::store_matrix_sync(Ss + r0 * C::LDS + j * 16, s_acc, C::LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dPs + r0 * C::LDS + j * 16, p_acc, C::LDS, wmma::mem_row_major);
      }
      __syncwarp();
      // ---- dS = P (dP - delta) for this warp's rows, rounded to bf16
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr;
        const float l = Ls[r], dl = Dl[r];
        for (int c = lane; c < BN; c += 32) {
          const float p = prob(Ss[r * C::LDS + c], l, kept(q0 + r, k0 + c, S, causal, window),
                               scale);
          dSs[r * C::LDP + c] = from_f<TP>(p * (dPs[r * C::LDS + c] - dl));
        }
      }
      __syncwarp();
      // ---- dQ += dS K for this warp's rows
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* aptr = Acc + r0 * C::LDO + j * 16;
        wmma::load_matrix_sync(acc, aptr, C::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(dSs) + r0 * C::LDP +
                                        kk * 16, C::LDP);
          wmma::load_matrix_sync(bm, Kb + (kk * 16) * C::LD + j * 16, C::LD);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(aptr, acc, C::LDO, wmma::mem_row_major);
      }
      __syncwarp();
    } else {
      // CUDA cores, fp32: S, dP and dS per (row, key) in registers.
      for (int rr = 0; rr < C::RPW; ++rr) {
        const int r = warp * C::RPW + rr;
        const float l = Ls[r], dl = Dl[r];
        for (int c = lane; c < BN; c += 32) {
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            s += to_f(Qs[r * C::LD + d]) * to_f(Ks[c * C::LD + d]);
            dp += to_f(dOs[r * C::LD + d]) * to_f(Vs[c * C::LD + d]);
          }
          const float p = prob(s, l, kept(q0 + r, k0 + c, S, causal, window), scale);
          dSs[r * C::LDP + c] = p * (dp - dl);
        }
      }
      __syncwarp();
      for (int rr = 0; rr < C::RPW; ++rr) {
        const int r = warp * C::RPW + rr;
        for (int d = lane; d < D; d += 32) {
          float acc = Acc[r * C::LDO + d];
#pragma unroll 8
          for (int c = 0; c < BN; ++c) acc += to_f(dSs[r * C::LDP + c]) * to_f(Ks[c * C::LD + d]);
          Acc[r * C::LDO + d] = acc;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- scale and write the tile once
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r;
    if (qpos < S)
      dq[b * st.g[0] + h * st.g[2] + (long long)qpos * st.g[1] + d] =
          from_f<T>(Acc[r * C::LDO + d] * scale);
  }
}

// --------------------------------------------------------------- dK / dV
// Rows of the key tile are split over NW warps (16 per warp on the
// tensor-core path, so a BN-row tile has BN / 16 warps).
template <typename T, int D, int BM, int BN, bool TC>
struct DkvCfg {
  static constexpr int NW = TC ? BN / 16 : 4;
  static constexpr int NT = NW * 32;
  static constexpr int RPW = BN / NW;
  static constexpr int LD = D + (TC ? 8 : 1);
  static constexpr int LDS = BM;                // fp32 S^T and dP^T
  static constexpr int LDP = TC ? BM + 8 : BM;  // P^T and dS^T
  static constexpr int LDO = D + 4;             // fp32 dK and dV accumulators
  using TP = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr size_t OFF_K = 0;
  static constexpr size_t OFF_V = OFF_K + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_Q = OFF_V + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_DO = OFF_Q + round_up(sizeof(T) * BM * LD);
  static constexpr size_t OFF_S = OFF_DO + round_up(sizeof(T) * BM * LD);
  static constexpr size_t OFF_DP = OFF_S + (TC ? round_up(sizeof(float) * BN * LDS) : 0);
  static constexpr size_t OFF_P = OFF_DP + (TC ? round_up(sizeof(float) * BN * LDS) : 0);
  static constexpr size_t OFF_DS = OFF_P + round_up(sizeof(TP) * BN * LDP);
  static constexpr size_t OFF_DK = OFF_DS + round_up(sizeof(TP) * BN * LDP);
  static constexpr size_t OFF_DV = OFF_DK + round_up(sizeof(float) * BN * LDO);
  static constexpr size_t OFF_LSE = OFF_DV + round_up(sizeof(float) * BN * LDO);
  static constexpr size_t OFF_DEL = OFF_LSE + round_up(sizeof(float) * BM);
  static constexpr size_t SMEM = OFF_DEL + round_up(sizeof(float) * BM);
  static_assert(SMEM <= SMEM_LIMIT, "dK/dV tile does not fit in shared memory");
};

// Strides here: q, k, v, do, then dk and dv share the layout of k/v
// (st.g = dk, st2 = dv).
template <typename T, int D, int BM, int BN, bool TC>
__global__ void __launch_bounds__(DkvCfg<T, D, BM, BN, TC>::NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int Hkv, Strides st, long long dv_sb, long long dv_ss,
                     long long dv_sh, int causal, int window, float scale) {
  using C = DkvCfg<T, D, BM, BN, TC>;
  using TP = typename C::TP;
  constexpr int NT = C::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + C::OFF_V);
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* dOs = reinterpret_cast<T*>(smem + C::OFF_DO);
  float* St = reinterpret_cast<float*>(smem + C::OFF_S);
  float* dPt = reinterpret_cast<float*>(smem + C::OFF_DP);
  TP* Pt = reinterpret_cast<TP*>(smem + C::OFF_P);
  TP* dSt = reinterpret_cast<TP*>(smem + C::OFF_DS);
  float* dKs = reinterpret_cast<float*>(smem + C::OFF_DK);
  float* dVs = reinterpret_cast<float*>(smem + C::OFF_DV);
  float* Ls = reinterpret_cast<float*>(smem + C::OFF_LSE);
  float* Dl = reinterpret_cast<float*>(smem + C::OFF_DEL);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BN;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;

  load_tile<T, D, C::LD, NT>(Ks, k + b * st.k[0] + hk * st.k[2] + (long long)k0 * st.k[1],
                             st.k[1], BN, S - k0);
  load_tile<T, D, C::LD, NT>(Vs, v + b * st.v[0] + hk * st.v[2] + (long long)k0 * st.v[1],
                             st.v[1], BN, S - k0);
  for (int i = threadIdx.x; i < BN * C::LDO; i += NT) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  // Query tiles that see this key tile.
  int q_lo = 0, q_hi = S;
  if (causal) q_lo = (k0 / BM) * BM;
  if (window > 0) q_hi = min(S, k0 + BN - 1 + window);

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qh = q + b * st.q[0] + h * st.q[2];
    const T* oh = dout + b * st.o[0] + h * st.o[2];
    const float* lh = lse + ((long long)b * H + h) * S;
    const float* dh = delta + ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += BM) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<T, D, C::LD, NT>(Qs, qh + (long long)q0 * st.q[1], st.q[1], BM, S - q0);
      load_tile<T, D, C::LD, NT>(dOs, oh + (long long)q0 * st.o[1], st.o[1], BM, S - q0);
      load_vec<NT>(Ls, lh + q0, BM, S - q0);
      load_vec<NT>(Dl, dh + q0, BM, S - q0);
      __syncthreads();

      if constexpr (TC) {
        const __nv_bfloat16* Qb = reinterpret_cast<const __nv_bfloat16*>(Qs);
        const __nv_bfloat16* dOb = reinterpret_cast<const __nv_bfloat16*>(dOs);
        const __nv_bfloat16* Kb = reinterpret_cast<const __nv_bfloat16*>(Ks);
        const __nv_bfloat16* Vb = reinterpret_cast<const __nv_bfloat16*>(Vs);
        const int r0 = warp * 16;
        // ---- S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
#pragma unroll
        for (int j = 0; j < BM / 16; ++j) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, p_acc;
          wmma::fill_fragment(s_acc, 0.f);
          wmma::fill_fragment(p_acc, 0.f);
          for (int kk = 0; kk < D / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
            wmma::load_matrix_sync(a, Kb + r0 * C::LD + kk * 16, C::LD);
            wmma::load_matrix_sync(bm, Qb + (j * 16) * C::LD + kk * 16, C::LD);
            wmma::mma_sync(s_acc, a, bm, s_acc);
            wmma::load_matrix_sync(a, Vb + r0 * C::LD + kk * 16, C::LD);
            wmma::load_matrix_sync(bm, dOb + (j * 16) * C::LD + kk * 16, C::LD);
            wmma::mma_sync(p_acc, a, bm, p_acc);
          }
          wmma::store_matrix_sync(St + r0 * C::LDS + j * 16, s_acc, C::LDS, wmma::mem_row_major);
          wmma::store_matrix_sync(dPt + r0 * C::LDS + j * 16, p_acc, C::LDS,
                                  wmma::mem_row_major);
        }
        __syncwarp();
        // ---- P^T and dS^T = P^T (dP^T - delta) for this warp's key rows
        for (int rr = 0; rr < 16; ++rr) {
          const int kr = r0 + rr;
          for (int c = lane; c < BM; c += 32) {
            const float p = prob(St[kr * C::LDS + c], Ls[c],
                                 kept(q0 + c, k0 + kr, S, causal, window), scale);
            Pt[kr * C::LDP + c] = from_f<TP>(p);
            dSt[kr * C::LDP + c] = from_f<TP>(p * (dPt[kr * C::LDS + c] - Dl[c]));
          }
        }
        __syncwarp();
        // ---- dV += P^T dO and dK += dS^T Q for this warp's key rows
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> v_acc, k_acc;
          float* vptr = dVs + r0 * C::LDO + j * 16;
          float* kptr = dKs + r0 * C::LDO + j * 16;
          wmma::load_matrix_sync(v_acc, vptr, C::LDO, wmma::mem_row_major);
          wmma::load_matrix_sync(k_acc, kptr, C::LDO, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BM / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
            wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(Pt) + r0 * C::LDP +
                                          kk * 16, C::LDP);
            wmma::load_matrix_sync(bm, dOb + (kk * 16) * C::LD + j * 16, C::LD);
            wmma::mma_sync(v_acc, a, bm, v_acc);
            wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(dSt) + r0 * C::LDP +
                                          kk * 16, C::LDP);
            wmma::load_matrix_sync(bm, Qb + (kk * 16) * C::LD + j * 16, C::LD);
            wmma::mma_sync(k_acc, a, bm, k_acc);
          }
          wmma::store_matrix_sync(vptr, v_acc, C::LDO, wmma::mem_row_major);
          wmma::store_matrix_sync(kptr, k_acc, C::LDO, wmma::mem_row_major);
        }
        __syncwarp();
      } else {
        for (int rr = 0; rr < C::RPW; ++rr) {
          const int kr = warp * C::RPW + rr;
          for (int c = lane; c < BM; c += 32) {
            float s = 0.f, dp = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
              s += to_f(Ks[kr * C::LD + d]) * to_f(Qs[c * C::LD + d]);
              dp += to_f(Vs[kr * C::LD + d]) * to_f(dOs[c * C::LD + d]);
            }
            const float p = prob(s, Ls[c], kept(q0 + c, k0 + kr, S, causal, window), scale);
            Pt[kr * C::LDP + c] = p;
            dSt[kr * C::LDP + c] = p * (dp - Dl[c]);
          }
        }
        __syncwarp();
        // dV and dK in two passes: one accumulator and two loads in
        // flight per step keep the fp32 path free of register spills
        for (int rr = 0; rr < C::RPW; ++rr) {
          const int kr = warp * C::RPW + rr;
          for (int d = lane; d < D; d += 32) {
            float acc = dVs[kr * C::LDO + d];
#pragma unroll 4
            for (int c = 0; c < BM; ++c) acc += to_f(Pt[kr * C::LDP + c]) * to_f(dOs[c * C::LD + d]);
            dVs[kr * C::LDO + d] = acc;
            acc = dKs[kr * C::LDO + d];
#pragma unroll 4
            for (int c = 0; c < BM; ++c) acc += to_f(dSt[kr * C::LDP + c]) * to_f(Qs[c * C::LD + d]);
            dKs[kr * C::LDO + d] = acc;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- write the tile once: dK scaled, dV as is
  for (int i = threadIdx.x; i < BN * D; i += NT) {
    const int kr = i / D, d = i % D;
    const int kpos = k0 + kr;
    if (kpos < S) {
      dk[b * st.g[0] + hk * st.g[2] + (long long)kpos * st.g[1] + d] =
          from_f<T>(dKs[kr * C::LDO + d] * scale);
      dv[b * dv_sb + hk * dv_sh + (long long)kpos * dv_ss + d] = from_f<T>(dVs[kr * C::LDO + d]);
    }
  }
}

// ------------------------------------------------------------- launches
Strides make_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
    st.g[i] = s[12 + i];
  }
  return st;
}

template <typename T, int D, int BM, int BN, bool TC>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int S, int H, int Hkv, const long long* s,
              int causal, int window, float scale, cudaStream_t stream) {
  using C = DqCfg<T, D, BM, BN, TC>;
  auto kern = flash_bwd_dq_kernel<T, D, BM, BN, TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, H, Hkv, make_strides(s),
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BM, int BN, bool TC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int S, int H, int Hkv,
               const long long* s, int causal, int window, float scale, cudaStream_t stream) {
  using C = DkvCfg<T, D, BM, BN, TC>;
  auto kern = flash_bwd_dkv_kernel<T, D, BM, BN, TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BN - 1) / BN, B * Hkv);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      Hkv, make_strides(s), s[15], s[16], s[17], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.
//   dtype: 0 = float32, 1 = bfloat16
//   strides: element strides (batch, seq, head) of q, k, v, dout, then the
//            output(s): dq (dq entry); dk then dv (dkv entry); the head_dim
//            stride must be 1
//   lse, delta: (B, H, S) float32
// Each returns its launch's cudaError_t (0 = success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int B, int S, int H,
                            int Hkv, int D, const long long* strides, int causal, int window,
                            float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, D_, BM, BN, TC) \
  launch_dq<T, D_, BM, BN, TC>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, strides, causal, \
                               window, scale, s)
  if (dtype == 1) {
    switch (D) {
      case 64: return DQ(__nv_bfloat16, 64, 64, 64, true);
      case 128: return DQ(__nv_bfloat16, 128, 64, 64, true);
      case 256: return DQ(__nv_bfloat16, 256, 64, 32, true);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 64: return DQ(float, 64, 32, 32, false);
      case 128: return DQ(float, 128, 32, 32, false);
      case 256: return DQ(float, 256, 32, 32, false);
    }
  }
#undef DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int B,
                             int S, int H, int Hkv, int D, const long long* strides, int causal,
                             int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, D_, BM, BN, TC) \
  launch_dkv<T, D_, BM, BN, TC>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, strides, \
                                causal, window, scale, s)
  if (dtype == 1) {
    switch (D) {
      case 64: return DKV(__nv_bfloat16, 64, 64, 64, true);
      case 128: return DKV(__nv_bfloat16, 128, 64, 64, true);
      case 256: return DKV(__nv_bfloat16, 256, 64, 32, true);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 64: return DKV(float, 64, 32, 32, false);
      case 128: return DKV(float, 128, 32, 32, false);
      case 256: return DKV(float, 256, 32, 32, false);
    }
  }
#undef DKV
  return (int)cudaErrorInvalidValue;
}
