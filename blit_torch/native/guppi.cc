// Threaded GUPPI RAW block reader — the C++ rebuild of Blio.jl's native-side
// role (SURVEY.md §2.3: "GUPPI RAW block reader ... for the GB/s host→device
// feed").  Python's single-threaded read path caps well below NVMe/pagecache
// bandwidth; this reader fans pread() calls across threads so a voltage
// block lands in the destination buffer at storage speed.
//
// Exposed C ABI (ctypes-consumed by blit_torch/io/native.py):
//   blit_guppi_pread(path, offset, size, out, nthreads) -> 0 | errno-like <0

#include <fcntl.h>
#include <unistd.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One worker: pread [off, off+len) into dst.
int pread_range(int fd, uint8_t* dst, uint64_t off, uint64_t len) {
  while (len > 0) {
    ssize_t r = ::pread(fd, dst, len, (off_t)off);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return -EIO;  // unexpected EOF
    dst += r;
    off += (uint64_t)r;
    len -= (uint64_t)r;
  }
  return 0;
}

}  // namespace

extern "C" {

// Strided per-channel read: GUPPI blocks are channel-major on disk
// ([chan][ntime][pol][2]), and the streaming pipeline appends each block at
// a time offset inside a persistent (chan, cap, pol, 2) ring buffer — so
// the destination rows are contiguous but strided per channel.  Reading
// channel c's bytes [offset + c*src_stride, +chan_bytes) straight into
// out + c*dst_stride lands the block in the ring with ZERO intermediate
// copies (the drop-overlap trim and time-skip fall out of chan_bytes /
// offset arithmetic).  Channels fan out round-robin across threads.
int blit_guppi_pread2(const char* path, uint64_t offset, uint64_t nchan,
                      uint64_t chan_bytes, uint64_t src_stride,
                      uint64_t dst_stride, void* out, int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  if (nthreads < 1) nthreads = 1;
  const uint64_t kMinPerThread = 4ull << 20;
  uint64_t total = nchan * chan_bytes;
  uint64_t want = (total + kMinPerThread - 1) / kMinPerThread;
  if ((uint64_t)nthreads > want) nthreads = (int)want;
  if ((uint64_t)nthreads > nchan) nthreads = (int)nchan;
  if (nthreads <= 1) {
    int rc = 0;
    for (uint64_t c = 0; c < nchan && rc == 0; c++) {
      rc = pread_range(fd, (uint8_t*)out + c * dst_stride,
                       offset + c * src_stride, chan_bytes);
    }
    ::close(fd);
    return rc;
  }
  std::vector<std::thread> threads;
  std::vector<int> rcs(nthreads, 0);
  for (int t = 0; t < nthreads; t++) {
    threads.emplace_back([=, &rcs] {
      for (uint64_t c = (uint64_t)t; c < nchan; c += (uint64_t)nthreads) {
        int rc = pread_range(fd, (uint8_t*)out + c * dst_stride,
                             offset + c * src_stride, chan_bytes);
        if (rc) {
          rcs[t] = rc;
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  ::close(fd);
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}

int blit_guppi_pread(const char* path, uint64_t offset, uint64_t size,
                     void* out, int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  if (nthreads < 1) nthreads = 1;
  // Don't spawn threads for small reads (syscall + join overhead).
  const uint64_t kMinPerThread = 4ull << 20;
  uint64_t want = (size + kMinPerThread - 1) / kMinPerThread;
  if ((uint64_t)nthreads > want) nthreads = (int)want;
  if (nthreads <= 1) {
    int rc = pread_range(fd, (uint8_t*)out, offset, size);
    ::close(fd);
    return rc;
  }
  std::vector<std::thread> threads;
  std::vector<int> rcs(nthreads, 0);
  uint64_t chunk = size / nthreads;
  for (int t = 0; t < nthreads; t++) {
    uint64_t off = offset + (uint64_t)t * chunk;
    uint64_t len = (t == nthreads - 1) ? size - (uint64_t)t * chunk : chunk;
    uint8_t* dst = (uint8_t*)out + (uint64_t)t * chunk;
    threads.emplace_back([fd, dst, off, len, t, &rcs] {
      rcs[t] = pread_range(fd, dst, off, len);
    });
  }
  for (auto& th : threads) th.join();
  ::close(fd);
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}

}  // extern "C"
