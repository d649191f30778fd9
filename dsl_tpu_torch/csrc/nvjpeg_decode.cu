// JPEG decode on the card with nvJPEG, behind a plain C interface (ctypes).
//
// Counterpart of the host decode ``cv2.imread(path, cv2.IMREAD_COLOR)`` in
// ``dsl_tpu/data/pipelines/loading.py::LoadImageFromFile`` and
// ``dsl_tpu/train/semi.py::_prep``. It is a library call, not the port of a
// TPU kernel: the JAX package decodes on the host.
//
// The wrapper (``dsl_tpu_torch/data/image_io.py``) reads the header with
// ``dsl_jpeg_info``, allocates the output with the caching allocator and
// calls ``dsl_jpeg_decode`` on PyTorch's current stream:
//   - three components: ``NVJPEG_OUTPUT_BGRI`` into (H, W, 3) uint8, pitch 3W;
//   - one component (grayscale): ``NVJPEG_OUTPUT_Y`` into (H, W) uint8; the
//     wrapper widens it to three equal channels, as OpenCV does.
// One nvJPEG handle per device, and per (device, stream) a ring of kSlots
// decode states, each with an event, made at first use and kept for the
// life of the process. A decode state holds the decode's staging buffers:
// nvjpegDecode fills its pinned buffer on the host and enqueues the copy
// out of it, so a second decode with the same state, issued before the
// stream has run the first one's copy (the stream may be queued behind a
// train step), overwrites the first image's data. Measured on the card: the
// refresh right after a step, eight decodes into one state, gave head
// outputs 39% away from the same refresh on an idle stream. So each decode
// takes the ring's next state, first waits on the host for that state's
// event (recorded after its previous decode), and records it again after
// enqueueing. The host blocks only when kSlots decodes of one stream are in
// flight. A mutex serialises the calls.
//
// Return codes: 0 on success, an nvjpegStatus_t (> 0) from nvJPEG, or
// -cudaError_t (< 0) from the runtime.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kSlots = 8;

struct Slot {
  nvjpegJpegState_t state = nullptr;
  cudaEvent_t done = nullptr;   // recorded after the slot's last decode
};

struct Ring {
  Slot slots[kSlots];
  int next = 0;
};

std::mutex g_mutex;
std::map<int, nvjpegHandle_t> g_handles;
std::map<std::pair<int, uintptr_t>, Ring> g_rings;

// The current device's handle, made at first use. Called under g_mutex.
int current_handle(int* device, nvjpegHandle_t* out) {
  cudaError_t cerr = cudaGetDevice(device);
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  auto it = g_handles.find(*device);
  if (it == g_handles.end()) {
    nvjpegHandle_t handle = nullptr;
    nvjpegStatus_t st = nvjpegCreateSimple(&handle);
    if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
    it = g_handles.emplace(*device, handle).first;
  }
  *out = it->second;
  return 0;
}

// The next slot of (current device, stream)'s ring, its state made at
// first use and free: its previous decode has run on the device.
int next_slot(cudaStream_t stream, nvjpegHandle_t* handle, Slot** out) {
  int device = 0;
  int err = current_handle(&device, handle);
  if (err != 0) return err;
  Ring& ring = g_rings[std::make_pair(device, reinterpret_cast<uintptr_t>(stream))];
  Slot& slot = ring.slots[ring.next];
  ring.next = (ring.next + 1) % kSlots;
  if (slot.state == nullptr) {
    nvjpegStatus_t st = nvjpegJpegStateCreate(*handle, &slot.state);
    if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
    cudaError_t cerr = cudaEventCreateWithFlags(&slot.done,
                                                cudaEventDisableTiming);
    if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  } else {
    cudaError_t cerr = cudaEventSynchronize(slot.done);
    if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  }
  *out = &slot;
  return 0;
}

}  // namespace

extern "C" {

// Width, height, number of components and chroma subsampling
// (nvjpegChromaSubsampling_t) of a JPEG bitstream.
int dsl_jpeg_info(const unsigned char* data, size_t length, int* width,
                  int* height, int* components, int* subsampling) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  int err = current_handle(&device, &handle);
  if (err != 0) return err;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css;
  nvjpegStatus_t st = nvjpegGetImageInfo(handle, data, length, components,
                                         &css, widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  *width = widths[0];
  *height = heights[0];
  *subsampling = static_cast<int>(css);
  return 0;
}

// Decode into ``out`` on ``stream``: (height, width, 3) BGR interleaved when
// ``gray`` is 0, (height, width) luma when it is 1; ``width`` sets the pitch.
int dsl_jpeg_decode(const unsigned char* data, size_t length,
                    unsigned char* out, int width, int gray, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  nvjpegHandle_t handle = nullptr;
  Slot* slot = nullptr;
  int err = next_slot(cuda_stream, &handle, &slot);
  if (err != 0) return err;
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = out;
  image.pitch[0] = static_cast<unsigned int>(gray ? width : 3 * width);
  nvjpegStatus_t st = nvjpegDecode(
      handle, slot->state, data, length,
      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &image, cuda_stream);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  cudaError_t cerr = cudaEventRecord(slot->done, cuda_stream);
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return -static_cast<int>(cerr);
  return 0;
}

}  // extern "C"
