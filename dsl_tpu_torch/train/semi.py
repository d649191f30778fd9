"""Dynamic pseudo-label refresh: teacher predict -> label store update.

Counterpart of ``dsl_tpu/train/semi.py::PseudoLabelRefresher``, with the
same arguments and schedule:

- iteration mode refreshes the unlabeled images the loader consumes
  ``preload`` iterations ahead (``refresh_per_iter`` images per event, one by
  default, as the reference); its first event refreshes the whole unlabeled
  set; ``first_score_thre`` applies to the first refresh and
  ``first_ignore`` to the first fused one, both taken at dispatch;
- epoch mode refreshes the whole set after each epoch; both modes then
  recompute ``adathres.json``;
- ``eval_flip`` predicts the flipped image too and merges in the store's
  per-class NMS.

A refresh first drops the files ``cv2.imread`` could not read (missing,
empty, or a JPEG header cut short: ``image_io.readable``), as the JAX
package drops them before it cuts the list into chunks; their label files
stay as they were. It reads each remaining file onto the device (nvJPEG on
the card), resizes it to ``img_scale`` there, pads it into
``select_canvas``'s canvas, pads the chunk to ``refresh_batch`` rows by
repeating the last, normalizes on the device and runs
``detector_predict`` (NMS through the CUDA kernel) with the teacher's
parameters.

On the card :meth:`dispatch_refresh` runs all of it on a side CUDA stream
that first waits on an event recorded on the current stream, so the next
train step can overlap it. The teacher's parameters are a snapshot: the
dict the state holds at dispatch (``ema_update`` makes new tensors; the
student's parameters, which SGD updates in place, are cloned). The closure
it returns holds that snapshot and the detector's buffers until
``complete()``, which waits on the side stream's event; results reach the
host by copies into pinned memory enqueued on the side stream, so
``complete()`` never waits on the train step. The JAX package's worker
thread and jitted weight copy answer JAX's buffer donation and a remote
link, and have no counterpart here.

Data parallelism (``group``, a process group of ``W`` ranks): every rank
cuts each refresh list into the single process's chunks of
``refresh_batch`` (after the same ``readable`` filter), and chunk ``c``
(counted over the epoch, so ranks take turns when an event refreshes one
chunk) is predicted, NMS'd and written by rank ``c mod W`` alone, on its
side stream; each chunk keeps the single process's canvas and padding (a
split by image would change GroupNorm's statistics over the padded
canvas), so the union of the ranks' files is a one-process refresh from
the same teacher. ``adathres.json`` is computed by rank 0 between two
barriers, after every rank's files are written.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
import torch.distributed as dist

from dsl_tpu_torch.data.formatting import select_canvas
from dsl_tpu_torch.data.image_io import readable
from dsl_tpu_torch.data.pipelines.transforms import read_resized
from dsl_tpu_torch.models.detectors.single_stage import detector_predict
from dsl_tpu_torch.parallel.dist import barrier
from dsl_tpu_torch.train.label_store import LabelStore, compute_adathres
from dsl_tpu_torch.utils.device import resolve_device, to_device


class PseudoLabelRefresher:
    def __init__(self, detector, store: LabelStore, image_root: str,
                 image_infos: list[dict], test_cfg: dict | None = None,
                 canvas_hw=(800, 1344), img_scale=(1333, 800),
                 img_norm=dict(mean=(123.675, 116.28, 103.53),
                               std=(58.395, 57.12, 57.375), to_rgb=True),
                 infer_score_thre: float = 0.1, iou: float = 0.6,
                 fuse_history: bool = False, first_fuse: bool = False,
                 first_score_thre: float = 0.1, use_ema: bool = True,
                 eval_flip: bool = False, mode: str = "iteration",
                 interval: int = 1, start_point: int = 8, preload: int = 6,
                 refresh_batch: int = 8, compute_dtype=None,
                 refresh_per_iter: int | None = 1,
                 device: str | torch.device = "cuda", group=None):
        self.detector = detector
        self.store = store
        self.image_root = image_root
        self.image_infos = list(image_infos)
        self.test_cfg = test_cfg
        self.canvas_hw = tuple(canvas_hw)
        self.img_scale = tuple(img_scale)
        self.img_norm = img_norm
        self.infer_score_thre = infer_score_thre
        self.iou = iou
        self.fuse_history = fuse_history
        self.first_fuse = first_fuse
        self.first_score_thre = first_score_thre
        self.use_ema = use_ema
        self.eval_flip = eval_flip
        self.mode = mode
        self.interval = interval
        self.start_point = start_point
        self.preload = preload
        self.refresh_batch = refresh_batch
        self.compute_dtype = compute_dtype
        # images refreshed per iteration-mode event; None = as many as an
        # iteration consumes
        self.refresh_per_iter = refresh_per_iter
        self.device = resolve_device(device)
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        # chunks cut so far in this epoch: chunk c goes to rank c mod world
        self._chunks, self._epoch = 0, None
        # compressed bytes handed to the decoder
        self.uploaded_bytes = 0
        self._first_done = False
        self._iter_fuse_done = False
        # the reference's first_ignore: while fuse_history, the first
        # refresh writes only new detections
        self._first_ignore = not first_fuse
        self._stream = None
        self._mean = torch.tensor(img_norm["mean"], dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(img_norm["std"], dtype=torch.float32,
                                 device=self.device)

    # -- one chunk on the device ------------------------------------------
    def _load(self, filename: str):
        """(resized uint8 image, img_shape [nh, nw], scale_factor) on the
        device."""
        path = osp.join(self.image_root, filename)
        self.uploaded_bytes += osp.getsize(path)
        return read_resized(path, self.img_scale, self.device)

    def _canvas(self, imgs: list[torch.Tensor], canvas_hw) -> torch.Tensor:
        """(B, H, W, 3) uint8: each image top-left on a zero canvas, BGR->RGB
        where the normalization asks for it."""
        ch, cw = canvas_hw
        out = torch.zeros((len(imgs), ch, cw, 3), dtype=torch.uint8,
                          device=self.device)
        for i, img in enumerate(imgs):
            nh, nw = min(img.shape[0], ch), min(img.shape[1], cw)
            content = img.flip(-1) if self.img_norm.get("to_rgb", True) else img
            out[i, :nh, :nw] = content[:nh, :nw]
        return out

    def _predict_chunk(self, params: dict, chunk: list) -> list:
        """Predict one chunk of (name, img, shape, sf); returns
        [(variant, dets, labels, valid)] on the device."""
        bs = self.refresh_batch
        canvas_hw = select_canvas([c[1].shape[:2] for c in chunk],
                                  self.canvas_hw)
        variants = [[c[1] for c in chunk]]
        if self.eval_flip:
            # flip the resized content before padding, as the JAX package
            variants.append([c[1].flip(1) for c in chunk])
        pad = [chunk[-1]] * (bs - len(chunk)) if len(chunk) < bs else []
        shapes, sfs = (to_device(torch.tensor([c[i] for c in chunk + pad],
                                              dtype=torch.float32), self.device)
                       for i in (2, 3))
        out = []
        for vi, imgs in enumerate(variants):
            u8 = self._canvas(imgs + imgs[-1:] * len(pad), canvas_hw)
            images = ((u8.float() - self._mean) / self._std).permute(0, 3, 1, 2)
            out.append((vi, *detector_predict(
                self.detector, images.contiguous(), img_shapes=shapes,
                scale_factors=sfs, test_cfg=self.test_cfg,
                compute_dtype=self.compute_dtype, device=self.device,
                params=params)))
        return out

    def _predict_all(self, params: dict, filenames: list[str]) -> list:
        """This rank's chunks of ``filenames``: [(names, [(variant, dets,
        labels, valid)])], results copied to the host (pinned,
        asynchronously on the card), for the files :func:`readable`
        passes. Each chunk's images are read onto the device just before its
        predict and dropped after it, so the device holds one chunk of
        images however many files there are."""
        pending = []
        cuda = self.device.type == "cuda"
        filenames = [n for n in filenames
                     if readable(osp.join(self.image_root, n), self.device)]
        chunks = [filenames[i:i + self.refresh_batch]
                  for i in range(0, len(filenames), self.refresh_batch)]
        first, self._chunks = self._chunks, self._chunks + len(chunks)
        for c, names in enumerate(chunks):
            if (first + c) % self.world != self.rank:
                continue
            chunk = [(name, *self._load(name)) for name in names]
            results = []
            for vi, *tensors in self._predict_chunk(params, chunk):
                host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                    h.copy_(t, non_blocking=cuda)
                    host.append(h)
                results.append((vi, *host))
            del chunk
            pending.append((names, results))
        return pending

    # -- dispatch / complete -----------------------------------------------
    def dispatch_refresh(self, state, filenames: list[str]):
        """Start the teacher's predict on ``filenames``; returns a zero-arg
        ``complete()`` that waits for it and writes the store. Thresholds and
        fuse flags are taken now, so a later ``complete()`` writes what a
        synchronous refresh would have."""
        if self.use_ema:
            params = state.teacher_params
        else:
            params = {k: p.detach().clone()
                      for k, p in state.student.named_parameters()}
        fuse = self.fuse_history
        first_ignore = self._first_ignore
        score_thre = (self.first_score_thre if not self._first_done
                      else self.infer_score_thre)
        self._first_done = True
        if self.fuse_history and self._first_ignore:
            self._first_ignore = False

        done = None
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                pending = self._predict_all(params, list(filenames))
                done = torch.cuda.Event()
                done.record(self._stream)
        else:
            pending = self._predict_all(params, list(filenames))

        def complete():
            if done is not None:
                done.synchronize()
            complete.holds = None      # the side stream is done with them
            for names, results in pending:
                self._write_results(names, results, score_thre, fuse,
                                    first_ignore)

        # what the side stream reads but did not allocate stays referenced
        # until then
        complete.holds = (params, dict(self.detector.named_buffers()))
        return complete

    def _write_results(self, names, results, score_thre, fuse, first_ignore):
        all_dets = [[] for _ in names]
        all_labels = [[] for _ in names]
        for vi, dets, labels, valid in results:
            dets, labels, valid = dets.numpy(), labels.numpy(), valid.numpy()
            for bi, name in enumerate(names):
                d = dets[bi][valid[bi]].astype(np.float32)
                lab = labels[bi][valid[bi]]
                if vi == 1:  # boxes of the flipped image back to the original
                    ow = next(x for x in self.image_infos
                              if x["filename"] == name)["width"]
                    d = d.copy()
                    d[:, [0, 2]] = ow - d[:, [2, 0]]
                all_dets[bi].append(d)
                all_labels[bi].append(lab)
        for bi, name in enumerate(names):
            d = np.concatenate(all_dets[bi])
            lab = np.concatenate(all_labels[bi])
            self.store.update(name, d[:, :4], d[:, 4], lab,
                              infer_score_thre=score_thre, iou=self.iou,
                              fuse=fuse, first_ignore=first_ignore)

    def refresh_images(self, state, filenames: list[str]):
        """Synchronous refresh: dispatch, then complete."""
        self.dispatch_refresh(state, filenames)()

    # -- scheduling --------------------------------------------------------
    def dispatch_after_train_iter(self, state, epoch: int,
                                  upcoming: list[str], iter_in_epoch: int,
                                  consumed_per_iter: int):
        """Iteration mode: dispatch the refresh of the images consumed
        ``preload`` iterations ahead; returns ``complete()`` or None."""
        self._count_chunks_from(epoch)
        if self.mode != "iteration" or epoch + 1 < self.start_point:
            return None
        if self.interval <= 0 or (iter_in_epoch + 1) % self.interval != 0:
            return None
        if not self._iter_fuse_done:
            self._iter_fuse_done = True
            return self.dispatch_refresh(
                state, [i["filename"] for i in self.image_infos])
        n_ref = (consumed_per_iter if self.refresh_per_iter is None
                 else self.refresh_per_iter)
        pos = self.preload * consumed_per_iter + iter_in_epoch * n_ref
        names = upcoming[pos: pos + n_ref]
        if not names:
            return None
        return self.dispatch_refresh(state, names)

    def after_train_epoch(self, state, epoch: int, adathres_file: str | None,
                          adathres_settings: dict | None = None):
        """Epoch mode: full refresh; both modes: recompute adathres (on
        rank 0, once every rank's files are written)."""
        self._count_chunks_from(epoch)
        if self.mode == "epoch" and epoch + 1 >= self.start_point:
            self.refresh_images(
                state, [i["filename"] for i in self.image_infos])
        if adathres_file and epoch + 1 >= self.start_point:
            barrier()
            if self.rank == 0:
                compute_adathres(
                    self.store, [i["filename"] for i in self.image_infos],
                    adathres_file, **(adathres_settings or {}))
            barrier()

    def _count_chunks_from(self, epoch: int):
        """Restart the chunk count at an epoch's first event."""
        if epoch != self._epoch:
            self._chunks, self._epoch = 0, epoch
