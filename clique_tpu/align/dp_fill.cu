// Global full-band 3-plane affine DP fill for Hopper, called from JAX
// through the XLA FFI (align/cuda_fill.py builds and registers it).
//
// It computes exactly what the XLA anti-diagonal scan in align/batch.py
// computes for a global, full-band fill with the reference tie order:
// the same per-cell formulas in the same f32 operations (built with
// -fmad=false, so no product is fused into an add), the same traceback
// bytes and the same corner scores.
//
// Layout: one block per alignment, one thread per DP row x (the reference
// axis, n1 <= 1024). The sequential anti-diagonal dimension is a loop
// inside the block. Each thread keeps its row's carries in registers:
//   (pm, pp1, pp2)    its own cell on diagonal d-1,
//   (s2m, s2p1, s2p2) row x-1 on diagonal d-2 (last step's neighbour).
// Row x-1 on diagonal d-1 comes through a double-buffered shared-memory
// exchange with one block barrier per diagonal. The read is staged in
// shared memory once and indexed directly by y-1 = d-x-1.
//
// Output: the traceback as packed int32 words [ceil(D/4), B, n1] (word w
// holds diagonals 4w..4w+3, diagonal d at bit 8*(d%4); diagonals >= D are
// padded with the fresh-cell byte, as the scan pads them), and the corner
// cell's three plane values [B, 3]. Only the words leave the chip; the
// score planes never touch device memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kDiag = 0;
constexpr int kUp = 1;
constexpr int kLeft = 2;
constexpr uint32_t kTbFresh = kUp | (kUp << 2) | (kUp << 4);
constexpr int kMaxRows = 1024;

// three_way_max_and_direction: up on strict >, then left on strict >, else
// diag (ties go to diag).
__device__ __forceinline__ float three_way(float up, float left, float diag,
                                           uint32_t* dir) {
  const bool up_wins = (up > left) && (up > diag);
  const bool left_wins = !(up > left) && (left > diag);
  *dir = up_wins ? kUp : (left_wins ? kLeft : kDiag);
  return up_wins ? up : (left_wins ? left : diag);
}

__global__ void dp_fill_kernel(const uint8_t* __restrict__ refs, int ref_rows,
                               int ref_w, const uint8_t* __restrict__ reads,
                               int read_w, const int32_t* __restrict__ ref_lens,
                               const int32_t* __restrict__ read_lens,
                               const float* __restrict__ params, int n1,
                               int n2, int special_mode, int batch,
                               int32_t* __restrict__ words,
                               float* __restrict__ corner) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x;
  float* exch = reinterpret_cast<float*>(smem);  // [2 parity][3 planes][T]
  uint8_t* read_s = smem + 6 * T * sizeof(float);

  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int D = n1 + n2 - 1;

  const float m_s = params[0], mm_s = params[1], sp_s = params[2];
  const float go = params[3], ge = params[4], fgm = params[5];
  const float neg = params[6];

  const int l1 = ref_lens[b];
  const int l2 = read_lens[b];
  const uint8_t* read = reads + static_cast<size_t>(b) * read_w;
  for (int i = x; i < read_w; i += T) read_s[i] = read[i];
  // a one-row reference is shared by the whole batch
  const uint8_t* ref =
      refs + static_cast<size_t>(ref_rows == 1 ? 0 : b) * ref_w;
  const int rx = (x >= 1 && x - 1 < ref_w) ? ref[x - 1] : 0;
  const float yb = (go + static_cast<float>(x) * ge) * fgm;

  float* odd = exch + 3 * T;  // read on diagonal 0: the zero carries
  odd[x] = 0.0f;
  odd[T + x] = 0.0f;
  odd[2 * T + x] = 0.0f;
  if (x == 0) {
    corner[b * 3 + 0] = 0.0f;
    corner[b * 3 + 1] = 0.0f;
    corner[b * 3 + 2] = 0.0f;
  }
  __syncthreads();

  float pm = 0.0f, pp1 = 0.0f, pp2 = 0.0f;
  float s2m = 0.0f, s2p1 = 0.0f, s2p2 = 0.0f;
  uint32_t word = 0;
  int32_t* out = words + static_cast<size_t>(b) * n1 + x;
  const size_t word_stride = static_cast<size_t>(batch) * n1;

  for (int d = 0; d < D; ++d) {
    const float* prev = exch + ((d + 1) & 1) * 3 * T;
    float sm = 0.0f, sp1 = 0.0f, sp2 = 0.0f;  // row x-1, diagonal d-1
    if (x > 0) {
      sm = prev[x - 1];
      sp1 = prev[T + x - 1];
      sp2 = prev[2 * T + x - 1];
    }
    const int y = d - x;
    const int ry = (y >= 1 && y - 1 < read_w) ? read_s[y - 1] : 0;

    bool special;
    if (special_mode == 1) {
      special = rx == 78;  // ref_n_only
    } else if (special_mode == 2) {
      special = false;  // none
    } else {
      special = rx == 78 || ry == 78 || rx < 58 || ry < 58;
    }
    const float ms = special ? sp_s : (rx == ry ? m_s : mm_s);

    const float gm = (x == l1 || y == l2) ? fgm : 1.0f;
    const float x1 = go + ge * gm;
    const float lge = ge * gm;

    uint32_t m_dir, d_dir, i_dir;
    const float m_val = three_way(s2p1 + ms, s2p2 + ms, s2m + ms, &m_dir);
    const float d_val = three_way(sp1 + lge, sp2 + x1, sm + x1, &d_dir);
    const float i_val = three_way(pp1 + x1, pp2 + lge, pm + x1, &i_dir);

    const bool interior = x >= 1 && x <= l1 && y >= 1 && y <= l2;
    const bool x_border = x == 0 && y >= 1 && y <= l2;
    const bool y_border = y == 0 && x >= 1 && x <= l1;
    const bool origin = x == 0 && y == 0;
    const float xb = (go + static_cast<float>(y) * ge) * fgm;

    const float m_out =
        interior ? m_val
                 : (origin ? 0.0f : ((x_border || y_border) ? neg : 0.0f));
    const float p1_out =
        interior ? d_val
                 : (x_border ? xb
                             : (y_border ? yb : (origin ? neg : 0.0f)));
    const float p2_out =
        interior ? i_val
                 : (x_border ? xb
                             : (y_border ? yb : (origin ? neg : 0.0f)));

    const uint32_t tb =
        interior ? (m_dir | (d_dir << 2) | (i_dir << 4)) : kTbFresh;
    word |= tb << (8 * (d & 3));
    if ((d & 3) == 3) {
      if (x < n1) out[(d >> 2) * word_stride] = static_cast<int32_t>(word);
      word = 0;
    }
    if (d == l1 + l2 && x == l1) {
      corner[b * 3 + 0] = m_out;
      corner[b * 3 + 1] = p1_out;
      corner[b * 3 + 2] = p2_out;
    }

    float* cur = exch + (d & 1) * 3 * T;
    cur[x] = m_out;
    cur[T + x] = p1_out;
    cur[2 * T + x] = p2_out;
    s2m = sm;
    s2p1 = sp1;
    s2p2 = sp2;
    pm = m_out;
    pp1 = p1_out;
    pp2 = p2_out;
    __syncthreads();
  }
  if ((D & 3) != 0) {
    for (int k = D & 3; k < 4; ++k) word |= kTbFresh << (8 * k);
    if (x < n1) out[(D >> 2) * word_stride] = static_cast<int32_t>(word);
  }
}

ffi::Error DpFillImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> refs,
                      ffi::Buffer<ffi::U8> reads,
                      ffi::Buffer<ffi::S32> ref_lens,
                      ffi::Buffer<ffi::S32> read_lens,
                      ffi::Buffer<ffi::F32> params,
                      ffi::ResultBuffer<ffi::S32> words,
                      ffi::ResultBuffer<ffi::F32> corner, int64_t n1,
                      int64_t n2, int32_t special_mode) {
  const auto rdims = refs.dimensions();
  const auto ddims = reads.dimensions();
  if (rdims.size() != 2 || ddims.size() != 2) {
    return ffi::Error::InvalidArgument("refs and reads must be rank 2");
  }
  const int64_t batch = ddims[0];
  const int64_t ref_rows = rdims[0];
  if (ref_rows != 1 && ref_rows != batch) {
    return ffi::Error::InvalidArgument("refs must have 1 or B rows");
  }
  if (n1 < 1 || n1 > kMaxRows || n2 < 1) {
    return ffi::Error::InvalidArgument("n1 must be in [1, 1024]");
  }
  if (params.element_count() < 7) {
    return ffi::Error::InvalidArgument("params needs 7 values");
  }
  const int threads = static_cast<int>((n1 + 31) / 32 * 32);
  const size_t shmem =
      6 * threads * sizeof(float) + static_cast<size_t>(ddims[1]);
  if (shmem > 48 * 1024) {
    return ffi::Error::InvalidArgument("read row too wide for the fill");
  }
  if (batch == 0) return ffi::Error::Success();
  dp_fill_kernel<<<static_cast<unsigned>(batch), threads, shmem, stream>>>(
      refs.typed_data(), static_cast<int>(ref_rows),
      static_cast<int>(rdims[1]), reads.typed_data(),
      static_cast<int>(ddims[1]), ref_lens.typed_data(),
      read_lens.typed_data(), params.typed_data(), static_cast<int>(n1),
      static_cast<int>(n2), special_mode, static_cast<int>(batch),
      words->typed_data(), corner->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CliqueDpFill, DpFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // refs
                                  .Arg<ffi::Buffer<ffi::U8>>()   // reads
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref_lens
                                  .Arg<ffi::Buffer<ffi::S32>>()  // read_lens
                                  .Arg<ffi::Buffer<ffi::F32>>()  // params
                                  .Ret<ffi::Buffer<ffi::S32>>()  // words
                                  .Ret<ffi::Buffer<ffi::F32>>()  // corner
                                  .Attr<int64_t>("n1")
                                  .Attr<int64_t>("n2")
                                  .Attr<int32_t>("special_mode"));
