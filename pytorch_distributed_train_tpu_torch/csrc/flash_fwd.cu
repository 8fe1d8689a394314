// FlashAttention-2 forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel pytorch_distributed_train_tpu/ops/flash_attention.py
// `_fwd_kernel` (reached through `_fwd` -> `pl.pallas_call`): attention over
// (B, S, H, D) with an online softmax in fp32 (running max and sum), causal
// masking, a sliding window, native GQA (query head h reads KV head
// h / (H / Hkv)), O in the input dtype and the row logsumexp (lse) in fp32.
// A row whose every key is masked gets O = 0 and lse = NEG_INF (-1e30), the
// TPU kernel's convention.
//
// What bounds it on an H100 SXM: a causal forward does 4*B*H*S^2*D/2 FLOPs
// (two matrix products over the lower triangle) against 989 TFLOP/s of bf16
// tensor-core rate, and must move the bytes of Q, K, V and O once against
// 3.35 TB/s. At the Llama-2 7B prefill shapes (H 32, D 128, S 512..2048)
// the FLOPs dominate by two orders of magnitude, so the kernel is
// compute-bound: the tensor cores have to do the products and the (S, S)
// score matrix must never reach device memory.
//
// What this design does about it:
// - One block of 4 warps owns a tile of BM query rows of one (batch, head);
//   a loop inside the block walks the KV tiles (the TPU's sequential grid
//   axis). Scores, probabilities and the fp32 accumulator stay in shared
//   memory; only O and lse are written.
// - bf16 inputs run both products on the tensor cores through WMMA
//   (16x16x16 bf16 -> fp32). Each warp owns 16 query rows, keeps its Q
//   fragments in registers for the whole KV loop, and only the K/V tiles
//   are shared between warps. P is rounded to bf16 for the P.V product
//   (the TPU kernel keeps P in fp32; the difference is within the bf16
//   tolerance the tests hold it to).
// - fp32 inputs take the same structure with the products on the CUDA cores
//   in fp32 (rows padded by one element so the shared-memory reads do not
//   collide in banks).
// - Causal and window tiles that lie wholly outside the band are never
//   visited (the loop bounds); the diagonal and band-edge tiles, and the
//   ragged last tile of a sequence that is not a multiple of the tile, are
//   masked element by element. Padded K/V rows are zero-filled so they add
//   nothing to P.V.
// - The kernel reads (B, S, H, D) directly through the strides it is given:
//   no transpose to (B*H, S, D) in device memory.
// Later work (not here): wgmma, TMA loads into a ring of stages, warp
// specialisation, and registers in place of shared memory for the
// accumulator.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t round_up(size_t x) { return (x + 127) / 128 * 128; }

// Tile geometry and shared-memory layout of one instantiation.
//   TC: tensor-core (WMMA) products, bf16 only.
template <typename T, int D, int BM, int BN, bool TC>
struct Cfg {
  static constexpr int RPW = BM / NWARPS;       // query rows per warp
  static constexpr int LD = D + (TC ? 8 : 1);   // Q/K/V row pitch (elements)
  static constexpr int LDS = BN;                // fp32 scores
  static constexpr int LDP = TC ? BN + 8 : BN;  // probabilities
  static constexpr int LDO = D + 4;             // fp32 accumulator
  using TP = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_K = OFF_Q + round_up(sizeof(T) * BM * LD);
  static constexpr size_t OFF_V = OFF_K + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_S = OFF_V + round_up(sizeof(T) * BN * LD);
  static constexpr size_t OFF_P = OFF_S + round_up(sizeof(float) * BM * LDS);
  static constexpr size_t OFF_O = OFF_P + round_up(sizeof(TP) * BM * LDP);
  static constexpr size_t OFF_M = OFF_O + round_up(sizeof(float) * BM * LDO);
  static constexpr size_t OFF_L = OFF_M + round_up(sizeof(float) * BM);
  static constexpr size_t SMEM = OFF_L + round_up(sizeof(float) * BM);
};

// Copy `rows` rows of D elements (row stride `stride` elements in global
// memory) into shared memory with pitch LD; rows at or beyond `valid` are
// zero-filled.
template <typename T, int D, int LD, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int rows, int valid) {
  if constexpr (VEC) {
    constexpr int CPR = D * sizeof(T) / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c * (16 / sizeof(T)));
      *reinterpret_cast<uint4*>(dst + r * LD + c * (16 / sizeof(T))) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      dst[r * LD + d] = r < valid ? src[r * stride + d] : from_f<T>(0.f);
    }
  }
}

template <typename T, int D, int BM, int BN, bool TC>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int Hkv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 int causal, int window, float scale) {
  using C = Cfg<T, D, BM, BN, TC>;
  using TP = typename C::TP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* Ks = reinterpret_cast<T*>(smem + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + C::OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + C::OFF_S);
  TP* Ps = reinterpret_cast<TP*>(smem + C::OFF_P);
  float* Os = reinterpret_cast<float*>(smem + C::OFF_O);
  float* Ms = reinterpret_cast<float*>(smem + C::OFF_M);
  float* Ls = reinterpret_cast<float*>(smem + C::OFF_L);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);

  const T* qb = q + b * q_sb + h * q_sh + (long long)q0 * q_ss;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  load_tile<T, D, C::LD, TC>(Qs, qb, q_ss, BM, S - q0);
  for (int i = threadIdx.x; i < BM * C::LDO; i += NTHREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.f;
  }
  __syncthreads();

  // Q fragments stay in registers for the whole KV loop (tensor-core path).
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[TC ? D / 16 : 1];
  if constexpr (TC) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], reinterpret_cast<const __nv_bfloat16*>(Qs) +
                                         (warp * 16) * C::LD + kk * 16, C::LD);
  }

  // KV tiles that intersect this query tile's causal triangle and window band.
  int kv_lo = 0, kv_hi = S;
  if (causal) kv_hi = min(S, q0 + BM);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BN) * BN;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, C::LD, TC>(Ks, kb + (long long)k0 * k_ss, k_ss, BN, S - k0);
    load_tile<T, D, C::LD, TC>(Vs, vb + (long long)k0 * v_ss, v_ss, BN, S - k0);
    __syncthreads();

    // ---- S = Q K^T for this warp's rows
    if constexpr (TC) {
      const __nv_bfloat16* Kb = reinterpret_cast<const __nv_bfloat16*>(Ks);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Kb + (j * 16) * C::LD + kk * 16, C::LD);
          wmma::mma_sync(acc, qf[kk], kf, acc);
        }
        wmma::store_matrix_sync(Ss + (warp * 16) * C::LDS + j * 16, acc, C::LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < C::RPW; ++rr) {
        const int r = warp * C::RPW + rr;
        for (int c = lane; c < BN; c += 32) {
          float acc = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) acc += to_f(Qs[r * C::LD + d]) * to_f(Ks[c * C::LD + d]);
          Ss[r * C::LDS + c] = acc;
        }
      }
    }
    __syncwarp();

    // ---- online softmax over this warp's rows; rescale the accumulator
    for (int rr = 0; rr < C::RPW; ++rr) {
      const int r = warp * C::RPW + rr;
      const int qpos = q0 + r;
      float s[BN / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int c = lane + 32 * i;
        const int kpos = k0 + c;
        bool keep = kpos < S;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && (qpos - kpos) < window;
        s[i] = keep ? Ss[r * C::LDS + c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      // every key masked so far: subtract 0 so the masked p stay 0
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = __expf(m_prev - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const float p = __expf(s[i] - m_safe);
        psum += p;
        Ps[r * C::LDP + lane + 32 * i] = from_f<TP>(p);
      }
      psum = warp_sum(psum);
      for (int d = lane; d < D; d += 32) Os[r * C::LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = alpha * Ls[r] + psum;
      }
    }
    __syncwarp();

    // ---- O += P V for this warp's rows
    if constexpr (TC) {
      const __nv_bfloat16* Vb = reinterpret_cast<const __nv_bfloat16*>(Vs);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BN / 16];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wmma::load_matrix_sync(pf[kk], Ps + (warp * 16) * C::LDP + kk * 16, C::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* optr = Os + (warp * 16) * C::LDO + j * 16;
        wmma::load_matrix_sync(acc, optr, C::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vb + (kk * 16) * C::LD + j * 16, C::LD);
          wmma::mma_sync(acc, pf[kk], vf, acc);
        }
        wmma::store_matrix_sync(optr, acc, C::LDO, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < C::RPW; ++rr) {
        const int r = warp * C::RPW + rr;
        for (int d = lane; d < D; d += 32) {
          float acc = Os[r * C::LDO + d];
#pragma unroll 8
          for (int c = 0; c < BN; ++c) acc += to_f(Ps[r * C::LDP + c]) * to_f(Vs[c * C::LD + d]);
          Os[r * C::LDO + d] = acc;
        }
      }
    }
  }
  __syncwarp();

  // ---- normalise and write this warp's rows
  for (int rr = 0; rr < C::RPW; ++rr) {
    const int r = warp * C::RPW + rr;
    const int qpos = q0 + r;
    if (qpos >= S) break;
    const float l = Ls[r];
    const float l_safe = l == 0.f ? 1.f : l;  // fully-masked rows -> zeros
    const float inv = 1.f / l_safe;
    T* orow = o + b * o_sb + h * o_sh + (long long)qpos * o_ss;
    for (int d = lane; d < D; d += 32) orow[d] = from_f<T>(Os[r * C::LDO + d] * inv);
    if (lane == 0) lse[(long long)bh * S + qpos] = Ms[r] + logf(l_safe);
  }
}

template <typename T, int D, int BM, int BN, bool TC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hkv, const long long* st, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<T, D, BM, BN, TC>;
  auto kern = flash_fwd_kernel<T, D, BM, BN, TC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, NTHREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool TC, int BM, int BN>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int S, int H, int Hkv, const long long* st, int causal, int window,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64, BM, BN, TC>(q, k, v, o, lse, B, S, H, Hkv, st, causal, window, scale, stream);
    case 128:
      return launch<T, 128, BM, BN, TC>(q, k, v, o, lse, B, S, H, Hkv, st, causal, window, scale, stream);
    case 256:
      return launch<T, 256, BM, BN, TC>(q, k, v, o, lse, B, S, H, Hkv, st, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.
//   dtype: 0 = float32, 1 = bfloat16
//   strides: 12 element strides (batch, seq, head) for q, k, v, o in order;
//            the head_dim stride must be 1
//   lse: (B, H, S) float32
// Returns the launch's cudaError_t (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int S, int H, int Hkv, int D, const long long* strides,
                         int causal, int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, true, 64, 64>(D, q, k, v, o, lse, B, S, H, Hkv, strides,
                                                   causal, window, scale, s);
  if (dtype == 0)
    return dispatch_d<float, false, 32, 32>(D, q, k, v, o, lse, B, S, H, Hkv, strides, causal,
                                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}
