// Halo exchange kernels for Hopper (sm_90a): the rows a shard of a device
// mesh needs from its neighbours (parallel/cuda_halo.py). One launch per
// receiving shard, on its device and stream: it PULLS its neighbours'
// rows through peer pointers (plain pointers where the shards share a
// card), so the receiver's stream waits on one event per source and
// nothing writes into memory that another stream still reads. Elements
// are copied as raw bytes: any type of 1, 2 or 4 bytes.
//
// halo_slab replaces chaq_sdfgen_tpu/parallel/pallas_halo.py:_halo_kernel
//   (_slab_exchange): shard i receives the last `rows` rows of each image
//   of block i - 1 as its up halo and the first `rows` rows of block i + 1
//   as its down halo. The TPU kernel sends over a periodic ring and its
//   caller masks the wrapped edges (_rdma_halo_fwd_impl, :171-172); here a
//   missing neighbour (a null source) reads `fill`, folding that mask into
//   the kernel.
//
// halo_ring_shift replaces pallas_halo.py:_ring_shift_kernel
//   (_block_shift_pair): the hop for halos taller than a shard. Shard i
//   receives all of block i - 1 on the up chain and all of block i + 1 on
//   the down chain; the ring is periodic and the caller masks.
//
// Bound: bytes, each halo row read once and written once. One 4096-wide
// uint8 EXACT exchange at band 66 moves ~0.5 MB per shard, under 1 us at
// 3.35 TB/s, so a launch's latency sets the time. Design: one grid-stride
// loop over both outputs; 16-byte words where every row and pointer allows
// it, bytes otherwise. Fill: the element's bytes repeated to a 32-bit
// word, so that any element size of 1, 2 or 4 bytes tiles it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

template <typename V>
__device__ __forceinline__ V fill_unit(uint32_t word, long long col);

template <>
__device__ __forceinline__ uint4 fill_unit<uint4>(uint32_t word, long long) {
  return make_uint4(word, word, word, word);
}

template <>
__device__ __forceinline__ uint8_t fill_unit<uint8_t>(uint32_t word, long long col) {
  return (uint8_t)(word >> (8 * (col & 3)));  // byte col of a row whose start is element-aligned
}

// dst_a/dst_b: (n_img, rows, upr) units; image i row r of dst_a is image i
// row off_a + r of src_a, (n_img, src_rows, upr) units; likewise b. A null
// source reads the fill.
template <typename V>
__device__ __forceinline__ void pull_pair(const V* src_a, const V* src_b, V* dst_a, V* dst_b,
                                          long long n_img, int rows, int src_rows, int off_a,
                                          int off_b, long long upr, uint32_t fill) {
  const long long per_side = n_img * rows * upr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < 2 * per_side;
       u += stride) {
    const bool b = u >= per_side;
    const long long v = b ? u - per_side : u;
    const long long img = v / (rows * upr);
    const long long rem = v - img * rows * upr;
    const long long r = rem / upr;
    const long long c = rem - r * upr;
    const V* src = b ? src_b : src_a;
    const long long s = (img * src_rows + (b ? off_b : off_a) + r) * upr + c;
    (b ? dst_b : dst_a)[v] = src != nullptr ? src[s] : fill_unit<V>(fill, c);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_slab_kernel(const V* src_up, const V* src_dn, V* up, V* dn, long long n_img, int rows,
                 int src_rows, long long upr, uint32_t fill) {
  pull_pair(src_up, src_dn, up, dn, n_img, rows, src_rows, src_rows - rows, 0, upr, fill);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_ring_shift_kernel(const V* src_up, const V* src_dn, V* up, V* dn, long long n_img,
                       int rows, long long upr) {
  pull_pair(src_up, src_dn, up, dn, n_img, rows, rows, 0, 0, upr, 0u);
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

unsigned grid_for(long long units) {
  const long long blocks = (2 * units + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each launches on the given
// stream (the receiving shard's), does not synchronise, and returns
// cudaGetLastError(). Rows are row_bytes bytes; n_img images per block.

// up: (n_img, rows) rows from the last `rows` rows of src_up's (n_img,
// src_rows) images; dn: from the first `rows` of src_dn's. A null source
// is a neighbour beyond the image: its output reads fill_word.
extern "C" int chaq_halo_slab(const void* src_up, const void* src_dn, void* up, void* dn,
                              long long n_img, int rows, int src_rows, long long row_bytes,
                              unsigned fill_word, void* stream) {
  if (n_img < 1 || rows < 1 || rows > src_rows || row_bytes < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned16(src_up) && aligned16(src_dn) && aligned16(up) &&
      aligned16(dn)) {
    const long long upr = row_bytes / 16;
    halo_slab_kernel<uint4><<<grid_for(n_img * rows * upr), kThreads, 0, s>>>(
        (const uint4*)src_up, (const uint4*)src_dn, (uint4*)up, (uint4*)dn, n_img, rows,
        src_rows, upr, fill_word);
  } else {
    halo_slab_kernel<uint8_t><<<grid_for(n_img * rows * row_bytes), kThreads, 0, s>>>(
        (const uint8_t*)src_up, (const uint8_t*)src_dn, (uint8_t*)up, (uint8_t*)dn, n_img, rows,
        src_rows, row_bytes, fill_word);
  }
  return (int)cudaGetLastError();
}

// up <- all of src_up, dn <- all of src_dn: (n_img, rows) rows each.
extern "C" int chaq_halo_ring_shift(const void* src_up, const void* src_dn, void* up, void* dn,
                                    long long n_img, int rows, long long row_bytes,
                                    void* stream) {
  if (n_img < 1 || rows < 1 || row_bytes < 1 || src_up == nullptr || src_dn == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned16(src_up) && aligned16(src_dn) && aligned16(up) &&
      aligned16(dn)) {
    const long long upr = row_bytes / 16;
    halo_ring_shift_kernel<uint4><<<grid_for(n_img * rows * upr), kThreads, 0, s>>>(
        (const uint4*)src_up, (const uint4*)src_dn, (uint4*)up, (uint4*)dn, n_img, rows, upr);
  } else {
    halo_ring_shift_kernel<uint8_t><<<grid_for(n_img * rows * row_bytes), kThreads, 0, s>>>(
        (const uint8_t*)src_up, (const uint8_t*)src_dn, (uint8_t*)up, (uint8_t*)dn, n_img, rows,
        row_bytes);
  }
  return (int)cudaGetLastError();
}

// Let `device` read `peer`'s memory. Returns 0 when it can (already or
// now), -1 when the pair has no peer access, else the CUDA error. The
// current device is restored.
extern "C" int chaq_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, device, peer);
  if (rc != cudaSuccess) return (int)rc;
  if (!can) return -1;
  int prev = 0;
  rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaSetDevice(device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceEnablePeerAccess(peer, 0);
    if (rc == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the "already enabled" error, which is not sticky
      rc = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)rc;
}
