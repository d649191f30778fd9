"""Read an image file into a (H, W, 3) uint8 BGR tensor on a device.

Counterpart of ``cv2.imread(path, cv2.IMREAD_COLOR)`` in
``dsl_tpu/data/pipelines/loading.py::LoadImageFromFile``. Two routes, chosen
by the device and by nothing else:

- CUDA: the file's bytes go to nvJPEG (``csrc/nvjpeg_decode.cu``, built at
  first use), which decodes on the current stream into a tensor the caching
  allocator owns. JPEG only: another format raises and names it. nvJPEG
  applies no EXIF orientation, where OpenCV does; it rounds its IDCT and
  upsamples chroma its own way, so pixels part from OpenCV's by a few levels
  (``chip_smoke.py`` measures it on the card).
- CPU: ``cv2.imread`` with ``IMREAD_COLOR``, imported here, as the JAX
  package reads. A grayscale file gives three equal channels on both
  routes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from dsl_tpu_torch.ops import build

# leading bytes of formats a reader may hand us, for the error message
_MAGIC = ((b"\x89PNG", "PNG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"RIFF", "WebP/RIFF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
_JPEG = b"\xff\xd8\xff"


def _format_of(data: bytes) -> str:
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return f"an unknown format (first bytes {data[:4]!r})"


def read_image(path, device: str | torch.device = "cuda") -> torch.Tensor:
    """An image file -> (H, W, 3) uint8 BGR on ``device``."""
    device = torch.device(device)
    path = os.fspath(path)
    if device.type == "cpu":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        return torch.from_numpy(img)
    if device.type != "cuda":
        raise ValueError(f"read_image: no route for device {device}")
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), device, path)


def decode_jpeg(data: bytes, device: torch.device, name: str = "<bytes>"
                ) -> torch.Tensor:
    """nvJPEG decode of a JPEG bitstream on ``device``'s current stream."""
    if not data.startswith(_JPEG):
        raise ValueError(f"{name}: {_format_of(data)} is not JPEG; the CUDA "
                         f"route decodes JPEG only")
    lib = _library()
    buf = np.frombuffer(data, np.uint8)
    width, height = ctypes.c_int(), ctypes.c_int()
    comps, css = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.dsl_jpeg_info(buf.ctypes.data, buf.size, ctypes.byref(width),
                                ctypes.byref(height), ctypes.byref(comps),
                                ctypes.byref(css))
        if err != 0:
            raise RuntimeError(f"{name}: nvjpegGetImageInfo failed ({err})")
        h, w, c = height.value, width.value, comps.value
        if c not in (1, 3):
            raise ValueError(f"{name}: a JPEG of {c} components; the CUDA "
                             f"route takes 1 (gray) or 3 (YCbCr)")
        gray = c == 1
        out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dsl_jpeg_decode(buf.ctypes.data, buf.size, out.data_ptr(),
                                  w, int(gray), stream)
    if err != 0:
        raise RuntimeError(f"{name}: nvJPEG decode of {w}x{h} failed ({err})")
    decode_jpeg.decodes += 1
    return out[..., None].expand(h, w, 3).contiguous() if gray else out


decode_jpeg.decodes = 0


def _library() -> ctypes.CDLL:
    lib = build.load("nvjpeg_decode")
    if not getattr(lib, "_dsl_typed", False):
        ptr, size, intp = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
        lib.dsl_jpeg_info.argtypes = [ptr, size, intp, intp, intp, intp]
        lib.dsl_jpeg_info.restype = ctypes.c_int
        lib.dsl_jpeg_decode.argtypes = [ptr, size, ptr, ctypes.c_int,
                                        ctypes.c_int, ptr]
        lib.dsl_jpeg_decode.restype = ctypes.c_int
        lib._dsl_typed = True
    return lib
