// host_dma.cu — how the card assembles a chunk from host memory:
// page-locking a recorder's RAM block in place, and copying channel rows
// from it (or from a pinned chunk slot) into the device chunk.
//
// Replaces no TPU kernel.  blit's live feed copies every block into a host
// chunk slot; on the card that copy (one numpy slice a block, on each
// bank's producer thread, 3-4.5 GB/s a thread) paced the whole reduction.
// A recorder's RAM ring is a fixed set of buffers, so a block can be
// page-locked once (cudaHostRegister) and its rows copied by the copy
// engine straight into their place in the device chunk, as rawspec's
// rawspec_copy_blocks_to_gpu does with cudaMemcpy2DAsync.
//
// No kernel is launched: every function is a CUDA runtime call on the
// caller's stream.  What bounds the copy is the host link; a row of a
// 128 MiB GBT block is 2 MiB, wide enough for the copy engine's full rate.
// A block's rows are channels: (nchan, ntime, npol, 2) int8, so sample t of
// channel c lies at c*spitch + t*sample_bytes.
//
// Every function returns the cudaError_t as an int (0: success); the
// Python wrapper (blit_torch/hostmem.py) raises on anything else.

#include <cuda_runtime.h>
#include <stddef.h>

extern "C" {

// Page-locks [ptr, ptr+nbytes) for every context.  A failure leaves the
// runtime's last error cleared: the caller keeps the block on its copy path.
int blit_host_register(void* ptr, size_t nbytes) {
  cudaError_t err = cudaHostRegister(ptr, nbytes, cudaHostRegisterPortable);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

int blit_host_unregister(void* ptr) {
  cudaError_t err = cudaHostUnregister(ptr);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// *pinned = 1 when ptr lies in page-locked host memory (cudaHostAlloc'd or
// registered), else 0.
int blit_host_is_pinned(const void* ptr, int* pinned) {
  cudaPointerAttributes a;
  cudaError_t err = cudaPointerGetAttributes(&a, ptr);
  if (err == cudaErrorInvalidValue) {  // memory the runtime has never seen
    cudaGetLastError();
    *pinned = 0;
    return 0;
  }
  if (err != cudaSuccess) return (int)err;
  *pinned = a.type == cudaMemoryTypeHost ? 1 : 0;
  return 0;
}

// height rows of width bytes, from src (row pitch spitch) to dst (row pitch
// dpitch), host to device or device to device, on stream.
int blit_copy_rows(void* dst, size_t dpitch, const void* src, size_t spitch,
                   size_t width, size_t height, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpy2DAsync(dst, dpitch, src, spitch, width, height,
                                cudaMemcpyDefault,
                                static_cast<cudaStream_t>(stream));
}

// height rows of width zero bytes at dst (row pitch dpitch), on stream.
int blit_zero_rows(void* dst, size_t dpitch, size_t width, size_t height,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset2DAsync(dst, dpitch, 0, width, height,
                                static_cast<cudaStream_t>(stream));
}

const char* blit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
