// Halo exchange kernel for Hopper (sm_90a): the rows a shard of a device
// mesh needs from its neighbours (parallel/cuda_halo.py). One kernel,
// halo_copy_jobs, walks a table of copy jobs passed by value in its
// parameters; a job is one run of rows, in every image of a block, from a
// source (or the fill) into a destination. Two launchers name the two TPU
// kernels it replaces:
//
// chaq_halo_slab replaces chaq_sdfgen_tpu/parallel/pallas_halo.py:
//   _halo_kernel (:34, _slab_exchange): shard i receives the last `band`
//   rows of each image of block i - 1 as its up halo and the first `band`
//   rows of block i + 1 as its down halo. The TPU kernel sends over a
//   periodic ring and its caller masks the wrapped edges
//   (_rdma_halo_fwd_impl, :171-172); here a job with a null source reads
//   the fill, folding that mask into the table. The same launcher writes
//   the halo'd frames [up | block | down] when the table also holds each
//   shard's centre rows.
// chaq_halo_ring_shift replaces pallas_halo.py:_ring_shift_kernel (:96,
//   _block_shift_pair): one hop of the ring for halos taller than a
//   shard, each shard receiving its neighbour's block on each chain.
//
// Bound: neither bytes nor operations but the launch and the host. One
// 4-shard exchange of 4096-wide uint8 blocks at band 66 moves ~3.8 MB
// (~1.1 us at 3.35 TB/s; 2.5-3.2 us of device time traced), while the
// host spends 48-128 us on it; one launch per receiving shard had cost
// ~63 us of host time per launch and ~251 us per exchange (chip_smoke.py's
// host split on an H100 80GB HBM3 at 700 W, PERF.md rows 20-21).
// Design: the TPU's ring is its topology; on Hopper every shard of a card,
// and every card of a host with peer access, is a pointer one kernel can
// read, so the unit of work is the exchange, not the shard. One launch per exchange and receiving device: blockIdx.y is
// the job and blockIdx.x strides over its images, rows and 16-byte words
// (bytes where a row or a pointer of the launch does not allow 16). The
// table (up to kMaxJobs jobs of 40 bytes) rides in the kernel's
// parameters, within CUDA's classic 4 KB, so a launch needs no allocation
// and no host-to-device copy. The fill is the element's bytes repeated to
// a 32-bit word, so that any element size of 1, 2 or 4 bytes tiles it.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr int kMaxJobs = 64;  // parallel/cuda_halo.py MAX_JOBS

// One run of rows: image m's rows src_row0 .. src_row0 + rows of a source
// whose images are src_rows rows apart, into rows dst_row0 .. of a
// destination whose images are dst_rows rows apart. Row offsets may
// reach past the first image: a job can address the k-th block of a
// stack allocated as one tensor. parallel/cuda_halo.py packs it as
// "<QQiiiiiI".
struct HaloJob {
  const void* src;  // null: the rows read fill_word
  void* dst;
  int src_row0, src_rows;
  int dst_row0, dst_rows;
  int rows;
  unsigned fill_word;
};
static_assert(sizeof(HaloJob) == 40, "HaloJob is packed as <QQiiiiiI on the host");

struct HaloJobs {
  HaloJob job[kMaxJobs];
};
static_assert(sizeof(HaloJobs) + 16 <= 4096, "the job table must fit CUDA's 4 KB of kernel parameters");

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

// n_img images per job; upr units (V) per row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_copy_jobs(const __grid_constant__ HaloJobs table, long long n_img, long long upr) {
  const HaloJob& j = table.job[blockIdx.y];
  const long long per_img = (long long)j.rows * upr;
  const long long total = n_img * per_img;
  const V* src = (const V*)j.src;
  V* dst = (V*)j.dst;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < total; u += stride) {
    const long long img = u / per_img;
    const long long rem = u - img * per_img;
    const long long r = rem / upr;
    const long long c = rem - r * upr;
    const long long d = (img * j.dst_rows + j.dst_row0 + r) * upr + c;
    dst[d] = src != nullptr ? src[(img * j.src_rows + j.src_row0 + r) * upr + c] : fill_unit<V>(j.fill_word, c);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool valid(const HaloJob& j) {
  return j.dst != nullptr && j.rows >= 0 && j.dst_rows >= 1 && j.dst_row0 >= 0 &&
         (j.src == nullptr || (j.src_rows >= 1 && j.src_row0 >= 0));
}

int launch_jobs(const HaloJob* jobs, int n_jobs, long long n_img, long long row_bytes, void* stream) {
  if (jobs == nullptr || n_jobs < 0 || n_img < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_jobs; ++i) {
    if (!valid(jobs[i])) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  for (int first = 0; first < n_jobs; first += kMaxJobs) {
    const int count = n_jobs - first < kMaxJobs ? n_jobs - first : kMaxJobs;
    HaloJobs table{};
    std::memcpy(table.job, jobs + first, count * sizeof(HaloJob));
    bool vec = row_bytes % 16 == 0;
    long long rows = 0;
    for (int i = 0; i < count; ++i) {
      const HaloJob& j = table.job[i];
      vec = vec && aligned16(j.dst) && (j.src == nullptr || aligned16(j.src));
      rows = j.rows > rows ? j.rows : rows;
    }
    const long long upr = vec ? row_bytes / 16 : row_bytes;
    const long long needed = (n_img * rows * upr + kThreads - 1) / kThreads;
    const long long cap = kMaxBlocks / count > 0 ? kMaxBlocks / count : 1;
    const dim3 grid((unsigned)(needed < 1 ? 1 : (needed < cap ? needed : cap)), (unsigned)count);
    if (vec) {
      halo_copy_jobs<uint4><<<grid, kThreads, 0, s>>>(table, n_img, upr);
    } else {
      halo_copy_jobs<uint8_t><<<grid, kThreads, 0, s>>>(table, n_img, upr);
    }
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

}  // namespace

// Launchers: plain C entry points for ctypes. Each copies the host array
// of n_jobs jobs into the kernel's parameters and launches on the given
// stream (the receiving device's), ceil(n_jobs / kMaxJobs) launches in
// order; it does not synchronise and returns cudaGetLastError(). Every job
// shares n_img images of row_bytes-byte rows. Jobs of one launch must not
// write what another job of it reads.

// The slabs, or the halo'd frames, of one exchange (pallas_halo._halo_kernel).
extern "C" int chaq_halo_slab(const void* jobs, int n_jobs, long long n_img, long long row_bytes,
                              void* stream) {
  return launch_jobs((const HaloJob*)jobs, n_jobs, n_img, row_bytes, stream);
}

// One hop of the ring (pallas_halo._ring_shift_kernel).
extern "C" int chaq_halo_ring_shift(const void* jobs, int n_jobs, long long n_img, long long row_bytes,
                                    void* stream) {
  return launch_jobs((const HaloJob*)jobs, n_jobs, n_img, row_bytes, stream);
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
