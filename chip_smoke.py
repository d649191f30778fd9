#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dsl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a non-zero exit):

1. device: CUDA is required; the card's name and power limit are printed as
   ``nvidia-smi`` reports them.
2. build: every source of ``csrc/`` (the NMS kernel, the nvJPEG decode
   shim and the PNG row unfilter, host C++) is compiled with ``nvcc`` for
   sm_90a, one ``nvcc`` each, all started together.
3. kernels vs plain versions: ``nms_keep`` against ``nms_keep_reference``
   on the card, bit-identical keeps on every edge case of
   ``dsl_tpu_torch.ops.nms_cases`` and on its card-only ``timing_cases()``
   (up to B=1, N=30000).
4. main path at full width: the flagship FCOS-RLA-R50 from
   ``configs/fcos_semi/RLA_r50_fcos_semi_dsl.py`` with seeded numpy weights
   through the weight bridge, built by ``init_detector``; with every kernel
   count at 0, ``detector_predict`` on B=8 at 800x1344 in f32 and in bf16
   and one ``inference_detector`` request; then the counts are read. The
   dets must be finite and (8, 100, 5) with detections in every image, at
   least 2000 candidates per image must clear score_thr (so NMS runs at its
   full N = 2000), each predict must launch the NMS kernel once, and the
   keeps of the real NMS inputs must equal the plain version's. The f32 head
   outputs must agree with a CPU run of the same model on a small input.
5. timing: predict ms (median, min and max of ``PREDICT_TIMED``) and img/s in f32 and
   bf16, one ``torch.profiler`` trace of each for the device's idle share
   and its largest kernels. Then the NMS kernel on four inputs (the
   recorded f32 predict input at B=8, the recorded request input at B=1,
   and the dense and sparse timing cases at B=8): the device time of each
   of its two passes from one ``torch.profiler`` trace over 100 calls, the
   wrapper's time by CUDA events over 100 calls (host work included), the
   plain version's time and the bound. The kernels line reports the
   predict input: ``ms`` is the two passes' device time per call.

6. train path at full width: the flagship's training entry point
   (``build_detector``, ``frozen_backbone_mask``,
   ``build_optimizer_from_cfg`` with the config's optimizer blocks,
   ``create_train_state``, ``make_train_step``) on one seeded batch of 2
   labeled and 2 unlabeled images at 800x1344 plus the half-res copy of the
   last one (the si pair), B=5. With every kernel count at 0: 3 warm-up and
   ``TRAIN_STEPS`` timed steps in f32, the same from the same seeded state in bf16, then
   one ``make_eval_step(use_teacher=True)`` on the batch's images; then the
   counts are read. Losses and ``grad_norm`` must be finite, ``step``
   ``TRAIN_WARMUP + TRAIN_STEPS``,
   the frozen parameters bit-identical to their start, the teacher after
   the first step equal to ``ema_update`` of its start and the student;
   cuDNN held to its deterministic algorithms (as ``train_detector``
   holds it), a second f32 run from the same seeded state must repeat the
   first bit for bit (every step's losses, every parameter after the last
   step);
   the first bf16 step's losses and ``grad_norm`` (si-soft aside) must part
   from the first f32 step's by more than 1e-5 and at most 2e-2 relative
   (bf16 ran, and near f32); the steps must launch the NMS kernel 0 times
   and the eval step once, and the eval step's keeps (B=5, N=2000) must
   equal the plain version's. Then
   one f32 step of the same model on a small batch (a labeled image and its
   half-res copy, 128x192) on the card and on the CPU: losses within 1e-4
   and ``grad_norm`` within 1e-3 relative, the updated parameters within
   the banded check (per parameter 5% of its update, floor 1e-5; all of
   them 1e-3 in relative L2).
7. train timing, f32 and bf16: step ms (median, min and max of the 20
   timed steps, each ending in a synchronize), img/s over the 4 real
   images, peak device memory, one ``torch.profiler`` trace of a step
   (device busy, idle share, the 10 largest kernels) and a split of one
   step by CUDA events into forward, targets + loss, backward, clip + SGD
   and EMA; then what determinism costs: ``DET_COST_STEPS``-step medians with
   ``cudnn.deterministic`` on and off, in turns.

8. decode: nvJPEG (``data/image_io.read_image`` on the card) on each JPEG
   fixture of ``tests/torch_port_data/`` against its committed OpenCV
   decode, within ``DECODE_*``, and its time per image; copies of the
   colour fixtures tagged here with EXIF orientations 3, 6 and 8 (both
   byte orders) against the committed decode turned as OpenCV turns it
   (shape equal, within ``DECODE_*``); the probe ``image_io.readable``
   refuses a copy cut inside its header, an empty file and a missing path
   and passes the fixtures, and its host time per file over
   ``PROBE_FILES`` names linked to the fixtures, split into the header's
   read and walk and ``nvjpegGetImageInfo``. JPEGs cut inside their
   entropy-coded data (the committed cuts of a colour fixture and of one
   with restart markers, which nvJPEG takes only as the completed stream)
   decode on the card to OpenCV's gray fill from OpenCV's first gray row
   (``tests/torch_port_data/cut_fill_rows.json``), their rows above the
   band the data ends in equal to nvJPEG's decode of the whole file, with
   the host scan's time per file. The committed cuts of the progressive
   fixture (one in its DC scan, one in a later scan) reach nvJPEG as the
   baseline transcode of libjpeg's coefficients with its interblock
   smoothing (``data/jpeg_coef.py``): its sha256 is the committed one (the
   CPU tests hold OpenCV's decode of it equal to OpenCV's decode of the
   cut file), nothing is filled, and the card's decode is within
   ``DECODE_*`` of OpenCV's (committed 4x4 sums); the host transcode's
   time per file. Then ``resize_linear_u8`` on the card against
   the CPU, bit for bit, on the fixtures at the train scales of the
   flagship and the baseline, with its time per image beside the bilinear
   resize it replaced.
9. strong augmentations at full size: the four fixtures (their committed
   OpenCV decodes, on the card) resized by the flagship's ``Resize`` to
   its two scales, with seeded boxes. ``PatchShuffle``,
   ``RandomAugmentBBox_Fast(aug_type='affine')``,
   ``RandomAugmentBBox(aug_type='strong')`` and ``UBAug`` each run on the
   card and on the CPU from the same seeds: images bit-identical, boxes
   equal. Per transform: median ms per image over ``STRONG_TIMED`` (host clock to a
   synchronize), kernels per image (one ``torch.profiler`` trace), and host
   syncs per image (``torch.cuda.set_sync_debug_mode``); any sync fails.
10. semi loop at full width: ``train_detector`` on the flagship config as
   written (its own train pipelines with ``PatchShuffle``,
   ``RandomAugmentBBox_Fast``, ``UBAug``, and its ``evaluation``), only
   its schedule and data paths overridden (``OVERRIDES``: 2 epochs, the
   refresh from epoch 1; ``preload`` 6, ``refresh_batch`` 8 as written),
   over a synthetic semicoco directory of copies of the fixtures (8
   labeled, 16 unlabeled, 12 val images with COCO GT), with seeded
   weights, B=5 per step; the unlabeled list also names a JPEG cut inside
   its header, with an empty label file. With every kernel count at 0
   before it, read after: losses finite; NMS launched once per refresh
   chunk and per evaluation batch, never in a train step; evaluation
   after each epoch on the teacher's parameters, ``bbox_mAP`` finite in
   [0, 1] in ``train.log.json``; every readable unlabeled label file
   rewritten and the cut file's unchanged; a full refresh over the
   unlabeled set and the cut file skips it before cutting the list into
   chunks (one NMS launch per chunk of readable files) and leaves its
   label file as it was;
   ``adathres.json`` written; the second epoch's dataset read the
   rewritten files; ``resume_from`` the epoch-1 checkpoint restores the
   state bit for bit. Then, on the trained state: one chunk refreshed on
   the side stream while a train step runs writes the labels of a
   synchronous refresh from the same teacher snapshot (same tags and
   counts, boxes within 1 px), whose NMS keeps equal the plain version's;
   the torch-level host syncs of a dispatch; refresh img/s at B=8; the
   peak device memory of a refresh of the whole unlabeled set within one
   image of a one-chunk refresh's; the loader's time per batch with the
   flagship's pipelines (host clock to a synchronize, median); the semi
   iteration (step + complete + dispatch) with a batch from the loader
   each iteration, with one fixed batch, and the bare step on it; one
   profiler trace of a semi iteration.
11. evaluation: with the counts at 0, ``single_device_test`` over the val
   set at full width in f32 on the teacher's parameters (NMS once per
   batch of 8), its detections equal to ``detector_predict`` called
   directly on the same batches (boxes 1e-3 relative, scores 1e-4), img/s
   (host clock to a synchronize, median of 3); the val GT fed back as
   detections scores ``bbox_mAP`` 1.0 exactly.
12. weights: with the counts at 0, the flagship saved by ``save_weights``
   and served by ``init_detector(checkpoint=)``, the semi run's
   ``epoch_2.pth`` served (its EMA teacher, against ``detector_predict``
   with the checkpoint's ``teacher_params``), and an mmdet-layout ``.pth``
   of the seeded weights (``state_dict`` with ``module.`` prefixes and a
   ``meta``) loaded by ``load_from``'s loader to exactly its tensors and
   served: each predict at B=8, 800x1344 bit-identical to the in-memory
   model's, NMS once per predict.
13. DSL's first step: ``python -m dsl_tpu_torch.tools.train`` on
   ``configs/fcos_semi/r50_caffe_mslonger_tricks_0.Xdata.py`` (caffe
   ResNet-50 FCOS at full width, 800x1344, no unlabeled set) in a
   subprocess, overriding the schedule (``BASELINE_EPOCHS`` epochs,
   evaluation after each,
   a log line per step), the data paths (a synthetic semicoco directory of
   8 labeled, 8 unlabeled and 12 val images) and the weights (a seeded
   caffe ResNet-50 as the ``pretrained`` file in mmdet's layout, a seeded
   neck and head as ``load_from``): losses finite, the student's
   ``bbox_mAP`` finite in [0, 1] after each epoch, NMS once per evaluation
   batch; the test CLI's ``--format-only --ema`` (:func:`run_test_cli`)
   on the unlabeled split (NMS once per batch) writes the bbox json (the
   EMA teacher's: 8 steps from seeded weights leave the student's scores
   under ``score_thr``);
   ``tools/generate_unlabel_annos_coco.py`` turns it into label files;
   the port's ``SemiCOCODataset`` reads each one's boxes. The subprocess
   reports its NMS launches. Then the baseline's step on its own
   loader's batch, timed in this process (median of ``BASELINE_TIMED``), its img/s and
   the phase's wall time.
14. DSL's VOC workflow at full width (``configs/fcos_semi/voc/
   RLA_r50_fcos_semi_voc.py``, 20 classes), the NMS count at 0 before each
   step and read after it: ``make_voc_dir`` writes a VOC2007 directory (8
   trainval, 12 test copies of the fixtures), the JAX-free
   ``tools/voc_convert2_semivoc_json.py`` makes DSL's labeled store of it,
   16 unlabeled copies get empty label files; the test CLI's
   ``--format-only`` with the seeded weights on the unlabeled
   ``SemiVOCDataset`` (NMS once per batch) and
   ``tools/generate_unlabel_annos_voc.py`` write a label file with scores
   for every unlabeled image; ``train_detector`` on the VOC config as
   written (its pipelines, ``evaluation``, ``preload``), overrides
   ``VOC_OVERRIDES`` and the data paths (its val and test blocks name no
   pipeline, so they get the config's ``test_pipeline``): losses finite,
   NMS once per refresh chunk and per evaluation batch, never in a step,
   ``Voc2CocoDataset`` evaluating the teacher after each epoch (bbox mAP
   printed) and the iteration's time; the test CLI on the epoch-2
   checkpoint's teacher with ``--eval mAP`` on a ``VOCDataset`` under
   ``VOC2007/`` (11-point AP) and ``--eval bbox`` on ``Voc2CocoDataset``;
   ``tta_test`` (NMS once per batch and pass, keeps equal to the plain
   version's) and ``tta_test_dense`` (no NMS kernel: its merge is host
   numpy, as in the JAX package) on the teacher at ``TTA_SCALES`` with
   flip; one image mirrored then resized on the card bit-identical to the
   CPU, its predict card vs CPU banded (the top 20 detections paired,
   boxes within 0.5 px, scores within 1e-3); img/s of a plain and a
   flipped ``single_device_test`` and of both TTA paths.
15. data parallelism across processes: phase 13's train CLI again under
   ``python -m torch.distributed.run --standalone --nproc_per_node=1``
   with ``--launcher pytorch`` (NCCL, one rank): its last checkpoint
   bit-identical to phase 13's, and the test CLI under the same launcher
   printing phase 13's ``bbox_mAP``. Then, in one spawn of the ranks
   (``phase_dist_ranks``): one flagship step at full width and RLA depth
   [1, 1, 1, 1] (``DIST_WIDTH``) over
   ``DIST_RANKS`` gloo ranks sharing the card (NCCL refuses two ranks on
   one card), each on its shard of a seeded global batch (2 labeled, 2
   unlabeled, the half-res copy, 800x1344), against one process stepping
   the global batch (B=10) in this process, freed before the ranks start:
   losses and ``grad_norm`` within ``DIST_STEP_REL``, updates banded as
   phase 6, both ranks' parameters and teachers bit-identical; the step's
   ms per rank, gloo-staged (not a measure of NCCL). The flagship's semi
   loop (``train_detector``, phase 10's data and overrides, 1 epoch) over
   the gloo ranks, then a refresh of every unlabeled image and an
   evaluation of the teacher split over them: one model on both ranks,
   every readable label file rewritten, the last refresh's files each
   written once by the rank the chunk stride names and paired with one
   process's refresh from the same teacher (tags and counts, boxes 1 px,
   scores 1e-3), the split evaluation's detections paired with one
   process's the same way and its metrics equal; the ranks' NMS launches
   counted in each process and summed.
16. PNG and DSL's remaining surface, the NMS count at 0 before each
   part and read after it: each committed PNG fixture and a PNG copy of
   each JPEG fixture read on the card route (the host C unfilter of
   ``csrc/png_unfilter.cpp``, one pinned upload, the colour rules on the
   card) equal to the CPU route, the C unfilter equal to the numpy
   version, decode ms per PNG (median of ``PNG_TIMED``) beside its host
   part. ``FCOSMultiHead`` at full width (the flagship's RLA-ResNet-50
   and ``MH_HEADS`` FPN + FCOS head pairs, seeded): ``multi_head_predict``
   at B=8 (dets finite, the NMS keeps of its three launches equal to the
   plain version's, head outputs card vs CPU within 1e-3, img/s), then
   ``MH_TRAIN_STEPS`` of ``multi_head_loss``, backward and ``MMCVAdamW``
   at B=5 on phase 6's batch (losses finite, both heads' keys, step ms),
   one step card vs CPU (losses, ``grad_norm``, gradients banded; the
   AdamW update from equal gradients within ``MH_ADAM_REL``). The 15 new
   transforms (``NEW_TRANSFORMS``) at the flagship's scales, as phase 9
   measures the strong augmentations. ``train_detector`` on the flagship
   at RLA depth ``CFG_LAYERS`` for 1 epoch with AdamW, ``ZeroIgnore`` and
   an ``AutoAugment`` of geometric policies in the train pipelines, the
   labeled set in a ``RepeatDataset``, on phase 10's data half of which
   are PNG copies and one PNG without its IEND chunk: losses finite, NMS
   once per refresh chunk and evaluation batch, never in a step, the
   teacher's ``bbox_mAP`` in [0, 1], every readable label file rewritten;
   a synchronous refresh over the mixed list skips the cut PNG and keeps
   the plain version's NMS keeps; then an SGD run under
   ``momentum_config`` whose momentum at each update equals
   ``MOMENTUM_EXPECTED`` (the JAX package's schedule).
17. the anchor-based detectors at full width (ResNet-50 pytorch style,
   FPN 256, 800x1344), the NMS count at 0 before each part and read after
   it: Faster R-CNN (``configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py``)
   and RetinaNet (``configs/retinanet/retinanet_r50_fpn_1x_coco.py``) with
   seeded weights (the classifiers shaped so that the RoI head's NMS sees
   2000 candidates over ``score_thr``; ``phase_anchor_predict`` says how),
   built by ``init_detector``: ``detector_predict`` at B=8, Faster R-CNN
   in f32 and RetinaNet in f32 and bf16: dets finite (8, 100, 5) with
   detections in every image, 2 NMS launches per Faster R-CNN predict (the
   RPN's at N = 4819, the RoI head's at N = 2000) and 1 per RetinaNet
   predict, every recorded input's keeps equal to the plain version's,
   head outputs card vs CPU within 1e-3, img/s; the NMS kernel timed on the
   three inputs as in phase 5 (the kernels line's ``paths``). Then the
   train entry point on each at B=2 (f32, cuDNN deterministic): losses
   finite with every key, 1 NMS launch per Faster R-CNN step and 0 per
   RetinaNet step, step ms (median of ``ANCHOR_STEPS`` after ``ANCHOR_WARMUP``
   warm-ups); RoIAlign
   forward and backward ms at the step's shapes beside their bound; one
   step card vs CPU at 2x128x192 (losses 1e-4, ``grad_norm`` 1e-3,
   updates banded); two Faster R-CNN runs of 4 steps bit-identical. Then
   ``train_detector`` on ``configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py``
   over phase 14's VOC2007 directory for one epoch and the test CLI's
   ``--eval mAP``: losses finite, ``mAP`` in [0, 1], 1 NMS launch per step
   and 2 per predicted batch.
18. SSD, the standalone RPN, Fast R-CNN and the Faster R-CNN variants at
   full width, the NMS count at 0 before each part and read after it.
   SSD300 on VOC (``configs/pascal_voc/ssd300_voc0712.py``: SSD-VGG16,
   8096 anchors at 300x300, as the JAX package's floor-mode pools give
   them) with seeded weights, built by ``init_detector``:
   ``detector_predict`` at B=8 in f32, dets finite (8, 200, 5) (the
   config's ``max_per_img``) with detections in every image, 1 NMS launch
   at N = 2000 whose keeps equal the plain version's, head outputs card vs
   CPU within 1e-3 at 1x300x300, img/s; SSD512 predicts once. One SGD step
   at the config's B=2 card vs CPU (losses 1e-4, ``grad_norm`` 1e-3,
   updates banded as phase 6) and step ms; ``train_detector`` for one
   epoch of phase 14's VOC2007 trainval split through SSD's float train
   pipeline (``PhotoMetricDistortion`` -> ``Expand`` ->
   ``MinIoURandomCrop`` -> ``Resize(keep_ratio=False)`` on the float image
   -> ``RandomFlip`` -> ``Normalize``, the repo's SSD-300 protocol in
   ``configs/_base_/datasets/wider_face.py``), then the test CLI's
   ``--eval mAP`` in [0, 1]; the float resize card vs CPU bit for bit on
   the fixture decodes. The standalone RPN (``configs/rpn/
   rpn_r50_fpn_1x_coco.py``): proposals at B=8 on 800x1344 (1 launch at N
   = 4819), ``eval_recalls`` of them against seeded GT in [0, 1], and its
   loss with ``allowed_border`` 0 in one step. Fast R-CNN
   (``configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py``) on those
   proposals through ``LoadProposals``: dets finite, 1 launch at N = 2000.
   The ResNeXt-101 64x4d, gn+ws, GIoU and caffe DC5 Faster R-CNN configs:
   one predict at B=8 (2 launches, keeps equal) and one step at B=2 each,
   finite. Predict ms and img/s and step ms for each path; the NMS kernel
   timed on the SSD, RPN and Fast R-CNN inputs (the kernels line's
   ``paths``).
19. Mask R-CNN and the C4 pair at full width, the NMS count at 0 before
   each part and read after it. ``configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py``
   uncut (ResNet-50, FPN 256, RPN, ``Shared2FCBBoxHead`` 1024,
   ``FCNMaskHead`` 4x256, 28x28 logits, 80 classes) with seeded weights:
   ``mask_rcnn_predict`` at B=8, 800x1344, f32: 2 NMS launches (N = 4819
   and 2000) whose keeps equal the plain version's, dets finite (8, 100, 5)
   with detections in every image, the (8, 100, 28, 28) probabilities in
   [0, 1], the median of ``P18_TIMED`` predicts, the paste and RLE of one image's
   masks (ms per image), the mask head's logits card vs CPU within 1e-3.
   The train entry point at B=2 on seeded polygons' ``gt_mask_crops``
   (cuDNN deterministic): ``loss_mask`` finite, 1 NMS launch per step, the
   median of ``P18_STEPS`` steps after a warm-up; one step card vs CPU at 2x128x192
   (losses 1e-4, ``grad_norm`` 1e-3, updates banded); two runs of 3 steps
   bit-identical. The train pipeline of
   ``mask_rcnn_r50_caffe_fpn_mstrain_1x_coco.py`` (masks loaded, six
   scales, flip, pad, 112x112 crops) card vs CPU bit for bit on 16 seeds
   over a synthetic COCO instance set (polygons, RLE, crowd RLE, none);
   that config through ``train_detector`` for one epoch (4 steps) with
   ``bbox`` and ``segm`` evaluation and the test CLI's ``--eval bbox
   segm``: ``bbox_mAP`` and ``segm_mAP`` in [0, 1], 1 NMS launch per step
   and 2 per predicted batch; the val GT fed back with its masks scores
   ``segm_mAP`` 1.0; ``tta_test`` then ``tta_test_masks`` on the val images
   (masks the images' size, keeps equal). ``FasterRCNNC4`` and
   ``MaskRCNNC4`` on their caffe C4 configs: a counted predict at B=2 (N =
   1000 and 2000) and timed steps at B=2 (``loss_mask`` for the mask one).
   The NMS kernel timed on the Mask R-CNN's RoI input (the kernels line's
   ``paths``).
20. Cascade R-CNN, Cascade Mask R-CNN and Mask Scoring R-CNN at full
   width, the NMS count at 0 before each part and read after it, through
   ``phase_variants``: ``configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py``,
   ``cascade_mask_rcnn_r50_fpn_1x_coco.py`` (three class-agnostic
   ``Shared2FCBBoxHead`` stages, the mask head shared over them) and
   ``configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py`` (Mask R-CNN and a
   ``MaskIoUHead``) uncut with seeded weights (every stage's classifier
   seeded as phase 17's, so the RoI NMS sees its full N): one counted
   predict at B=8, 800x1344, f32 (2 NMS launches, N = 4819 and 2000, keeps
   equal to the plain version's, dets finite (8, 100, 5) with detections in
   every image; the cascades give boxes only, as in the JAX package, Mask
   Scoring R-CNN also its (8, 100, 28, 28) probabilities in [0, 1]), the
   median of ``P18_TIMED`` predicts and img/s, then one more predict's peak memory and
   its ``torch.profiler`` trace, with RoIAlign's share of the kernels'
   time and the idle share (``roi_align_share``: retaken where the trace
   lost records); each stage's outputs card vs CPU within 1e-3
   (``cascade_probe``); the train entry point at B=2 on seeded polygons'
   crops (cuDNN deterministic): every stage's ``loss_cls``, ``loss_bbox``
   and ``loss_mask`` and Mask Scoring's ``loss_mask_iou`` finite, 1 NMS
   launch per step, the median of ``P18_STEPS`` steps after a warm-up, their peak
   memory and one more step's trace as the predict's; for the two with
   masks one step card vs CPU at 2x128x192 (as phase 17 bands it, both
   legs on one leg's mask targets, every target pixel that differs
   between the legs a tie of their RoIs' rounding) and two runs of 3
   steps bit-identical. Then
   ``cascade_mask_rcnn_r50_fpn_mstrain_3x_coco.py`` (its pipeline loads
   masks) through ``train_detector`` for one epoch of phase 19's COCO
   instance set and the test CLI's ``--eval bbox``: ``bbox_mAP`` in
   [0, 1], 1 NMS launch per step and 2 per predicted batch. The NMS kernel
   timed on the cascade's RoI input (``cascade_b8`` in the kernels line's
   ``paths``).
21. HTC, SCNet and DetectoRS at full width, the NMS count at 0 before
   each part and read after it, through ``phase_variants``:
   ``configs/htc/htc_r50_fpn_1x_coco.py`` (three ``HTCMaskHead``s with the
   mask information flow, the ``FusedSemanticHead``),
   ``configs/scnet/scnet_r50_fpn_1x_coco.py`` (class-specific stage heads,
   the semantic, global-context and feature-relay heads) and
   ``configs/detectors/detectors_htc_r50_1x_coco.py`` (HTC on two SAC
   ResNet-50s and the RFP neck) uncut with seeded weights (every stage's
   classifier seeded as phase 17's): one counted predict at B=8, 800x1344,
   f32 (2 NMS launches, N = 4819 and 2000, keeps equal to the plain
   version's, dets finite (8, 100, 5) with detections in every image, the
   (8, 100, 28, 28) mask probabilities in [0, 1]), the median of ``HTC_TIMED`` (3)
   predicts, one more predict's peak memory and trace (RoIAlign's share,
   the semantic RoIAligns counted in it, and the idle share); the levels
   (after the RFP neck), the semantic and global-context heads, each
   stage's box head and each mask head card vs CPU within 1e-3
   (``htc_probe``); steps at B=2 on seeded polygons' crops (cuDNN
   deterministic): every loss finite (``loss_semantic_seg``, the stages'
   ``loss_mask``, ``loss_glbctx``), 1 NMS launch per step, the median of ``HTC_STEPS`` (2)
   after a warm-up, the peak memory and a traced step; for HTC one step
   card vs CPU at 2x128x192 (both legs on one leg's mask targets) and two
   runs of 3 steps bit-identical. Then HTC through ``train_detector`` with
   ``configs/_base_/datasets/coco_instance_semantic.py``'s train pipeline
   (masks, ``with_seg``, ``SegRescale``) for one epoch of phase 19's COCO
   instance set and the test CLI's ``--eval bbox``: ``bbox_mAP`` in
   [0, 1]. The NMS kernel timed on HTC's RoI input (``htc_b8``).
22. PointRend, YOLACT and the Seesaw normed-mask Mask R-CNN at full width,
   the NMS count at 0 before each part and read after it. Through
   ``phase_variants``: ``configs/point_rend/point_rend_r50_caffe_fpn_
   mstrain_1x_coco.py`` (80 classes; the coarse head's 7x7 logits, two
   subdivision steps of 196 points) and ``configs/seesaw_loss/
   mask_rcnn_r50_fpn_random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py``
   (1203 classes as configured, the classifier's C + 2 logits seeded so
   that the split activation leaves the RoI NMS its full N) uncut with
   seeded weights: one counted predict each at B=8, 800x1344, f32 (2 NMS
   launches, N = 4819 and 2000, keeps equal to the plain version's, dets
   finite (8, 100, 5) with detections in every image, (8, 100, 28, 28)
   probabilities in [0, 1]), the median of ``P22_TIMED`` predicts; card vs
   CPU within 1e-3 (``slice15_probe``): the levels and the RPN, the box
   head, the mask head, PointRend's point head and one subdivision step
   (integer coarse logits, whose upsample is exact on both, so both pick
   the same cells), the Seesaw head's split-activation scores; steps at
   B=2 on seeded polygons' crops (cuDNN deterministic): every loss finite
   (``loss_point``, ``loss_cls_objectness``), 1 NMS launch per step; one
   step card vs CPU at 2x128x192 each (both legs on one leg's mask
   targets and the host's sampler and point draws), and for PointRend two
   runs of 3 steps bit-identical. The Seesaw config then trains one epoch
   through ``train_detector`` on phase 19's COCO instance set in place of
   LVIS (``coco_instance.py``'s pipeline): its ``SeesawCounter`` ends at
   one plus the valid GT labels it was fed. YOLACT
   (``configs/yolact/yolact_r50_1x8_coco.py``, uncut, 80 classes;
   ``phase_yolact``): predict at B=8, 800x1344 with no NMS launch (fast
   NMS), dets finite (8, 100, 5) with detections in every image, the
   (8, 100, 56, 56) crops in [0, 1], timed; ``fast_nms`` on the recorded
   input card vs CPU, equal on the valid rows; the head, protonet and segm
   outputs card vs CPU within 1e-3; a step at B=2 (``loss_cls``,
   ``loss_bbox``, ``loss_mask``, ``loss_segm`` finite, no NMS), one step
   card vs CPU banded as phase 6; then ``train_detector`` for one epoch
   through ``coco_instance.py``'s pipeline with ``bbox`` and ``segm``
   evaluation and the test CLI's ``--eval bbox segm``: ``bbox_mAP`` and
   ``segm_mAP`` in [0, 1]. The NMS kernel timed on PointRend's and the
   Seesaw head's RoI inputs (``point_rend_b8``, ``seesaw_b8``).
23. The remaining backbones at full width, uncut, seeded, the NMS count at
   0 before each part and read after it. Through ``phase_variants``
   (``SLICE16_CONFIGS``): HRNetV2p-W32 Faster R-CNN (the RPN's NMS at N =
   4756: HRFPN's P6 pools P2 at 16), RegNetX-3.2GF Mask R-CNN, ResNeSt-50
   and Res2Net-50 Faster R-CNN: one counted predict each at B=8, 800x1344
   (2 NMS launches, keeps equal, dets finite (8, 100, 5) with detections
   in every image, the Mask R-CNN's probabilities in [0, 1]), the median of
   ``P23_TIMED`` predicts and one step after a warm-up at B=2 (losses
   finite, 1 NMS launch per step), each with its peak memory; card vs CPU
   within 1e-3 at 1x128x192 (``slice16_probe``): the backbone's levels
   (HRNet's four branches), the neck's levels and the RPN, the box head,
   the mask head; for HRNet one step card vs CPU at 2x128x192 banded as
   phase 6 and two runs of 3 steps bit-identical. FCOS HRNetV2p-W18
   (``phase_hrnet_fcos``) and SSD on MobileNetV2 (``phase_ssd_mobilenet``):
   a counted predict (1 launch at N = 2000), timed, the levels and head
   outputs card vs CPU, a step (no NMS), each with its peak memory; FCOS
   then through ``train_detector`` for one epoch of phase 19's COCO set
   with ``bbox`` evaluation and the test CLI's ``--eval bbox``
   (``bbox_mAP`` in [0, 1], NMS once per evaluation batch). Whether the
   backward of RegNet's grouped and MobileNetV2's depthwise 3x3s repeats
   under cuDNN's deterministic algorithms is read and logged
   (``conv_backward_repeats``). The NMS kernel timed on HRNet's RoI input
   and FCOS-HRNet's (``hrnet_rcnn_b8``, ``hrnet_fcos_b8``).
24. Deformable convolution and VarifocalNet at full width, uncut, seeded,
   the NMS count at 0 before each part and read after it. VFNet R50 with
   DCNv2 in c3-c5 and the star convs (``VFNET_CONFIG``, through
   ``_single_stage_checks``): a counted predict at B=8, 800x1344 (1 NMS
   launch at N = 2000, keeps equal, dets finite with detections in every
   image), the median of ``P24_TIMED`` predicts and of ``P24_STEPS`` steps
   at B=2 after a warm-up (losses finite, no NMS), each with its peak
   memory; the levels and head outputs card vs CPU within 1e-3 at
   1x128x192; one ``torch.profiler`` trace of a predict giving the share
   of kernel time in ``deform_conv2d`` (:func:`deform_conv_share`); two
   runs of ``P24_DET_STEPS`` f32 steps from one seed bit-identical in every
   loss and parameter (cuDNN deterministic). Through ``phase_variants``
   (``DCN_RCNN_CONFIGS``): Faster R-CNN R50 with modulated DCN in c3-c5 at
   4 offset groups and with the modulated deformable RoI pooling pack:
   counted predicts (2 launches), timed, a step, each with its peak
   memory; card vs CPU within 1e-3 at 1x128x192 (``slice16_probe``), and
   the pack's deformable RoI extraction on 64 seeded RoIs of the small
   levels card vs CPU (``slice17_probe``). FCOS R50 caffe with DCN in c3-c5
   and DCNv2 on its towers' last conv (``FCOS_DCN_CONFIG``): a counted
   predict at B=8, timed. The NMS kernel timed on VFNet's input and the
   group-4 DCN Faster R-CNN's RoI input (``vfnet_b8``, ``dcn_rcnn_b8``).
25. The ResNet plugins and the other necks at full width, uncut, seeded,
   the NMS count at 0 before each part and read after it. Through
   ``phase_variants`` (``PLUGIN_NECK_CONFIGS``, 800x1344): Mask R-CNN R50
   with GCNet's ContextBlock in c3-c5, Faster R-CNN R50 with
   GeneralizedAttention ``'1111'`` in c4-c5, PAFPN, FPN_CARAFE and Libra's
   ``[FPN, BFP]`` with Balanced L1 (its steps with ``RandomSampler``:
   ``CombinedSampler`` raises, :func:`random_sampler`): counted predicts at
   B=8 (2 launches, keeps equal), the median of ``P25_TIMED``, a step at
   B=2 after a warm-up, each with its peak memory; card vs CPU within 1e-3
   at 1x128x192 (``slice16_probe``); one ``torch.profiler`` trace of the
   attention detector's predict for GeneralizedAttention's share of the
   kernels' time, and two runs of ``P25_DET_STEPS`` steps of the CARAFE
   one bit-identical (``plugin_neck_probe``). FPG Faster R-CNN
   (``FPG_CONFIG``) the same at 640x640 (the RPN's N = 4300). Through
   ``_single_stage_checks`` (``phase_plugin_neck_single``): RetinaNet on
   NAS-FPN with RetinaSepBNHead at 640x640, Libra RetinaNet and NAS-FCOS
   at 800x1344 (1 launch per predict; a step for the first two; NAS-FCOS's
   predict traced for its 20 deformable convs' share). The NMS
   kernel timed on FPG's RPN input and NAS-FPN RetinaNet's
   (``fpg_rcnn_b8``, ``nas_retina_b8``).

Each phase logs its wall time (``[phase N] ... s``). The test CLI runs
in this process (:func:`run_test_cli`), but under a launcher (phase 15);
the train CLI runs as a process (phases 13 and 15), as a user launches
it. The traces are read from the profiler's raw records
(:func:`trace_events`), not from ``prof.events()``, whose event tree
costs seconds of host time for a traced step; ``python -m
dsl_tpu_torch.tools.smoke_profile`` times the smoke function by function.

f32 runs with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False): cuDNN convolutions would
otherwise round their inputs to TF32.

The last lines are the kernels JSON line and the
``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import typing
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "fcos_semi" / "RLA_r50_fcos_semi_dsl.py"
DEVICE = "cuda"
BATCH = 8
CANVAS = (800, 1344)          # Resize(1333, 800) + pad to 32, the serving canvas
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12   # f32 outside the tensor cores, H100 SXM data sheet
IOU_OPS = 14                  # f32 ops per IoU test: 4 min/max, 2 sub, 2 clamp,
                              # mul, add, sub, floor, div, compare
AREA_OPS = 5
NMS_PASSES = {"mask": "nms_mask_kernel", "scan": "nms_scan_kernel"}
NMS_TRACE_REPS = 100          # nms_keep calls in one profiler trace
NMS_TRACE_TRIES = 3           # traces taken before a lossy one fails the run
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
DET_COST_STEPS = 2            # steps timed per turn for the cost of determinism
PREDICT_TIMED = 5             # flagship predicts timed per dtype (phase 5)
# the flagship's LR steps at epochs 20 and 26: with any real epoch length
# the smoke's steps stay in the warm-up
TRAIN_STEPS_PER_EPOCH = 1000
TRAIN_SEED = 0
SPLIT = ("forward", "loss", "backward", "optimizer", "ema")
# what torch's sync debug mode says at a synchronizing call (setting the
# mode also warns that it is a prototype "that does not yet detect all
# synchronizing operations", which is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 2) -> list[float]:
    """Wall time of each of reps calls of fn(), each ending in a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class TraceEvent(typing.NamedTuple):
    """One record of a torch.profiler trace (:func:`trace_events`)."""
    name: str
    device_type: object       # torch.autograd.DeviceType
    start: float              # µs, the host's clock
    end: float
    id: int                   # correlation id: a launch's equals its kernel's
    linked: int               # the op a kernel or launch belongs to (0: an op)
    thread: int


def trace_events(prof) -> list[TraceEvent]:
    """The records of a finished torch.profiler trace, read from the
    profiler's kineto results. ``prof.events()`` would build a
    ``FunctionEvent`` per record and their tree first: about 65 µs of host
    time a record, seconds for a traced step's 10^5 records."""
    return [TraceEvent(e.name(), e.device_type(), e.start_ns() / 1e3,
                       e.end_ns() / 1e3, e.correlation_id(),
                       e.linked_correlation_id(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def range_kernel_us(events, ranges) -> list[float]:
    """Device µs of the kernels each of ``ranges`` (``record_function``
    ranges among ``events``, :func:`trace_events`) launched, as torch's
    event tree counts a range's ``device_time_total``: a kernel belongs to
    the op that launched it (its ``linked``), and to a range where that op
    ran inside it on the range's thread."""
    from torch.autograd import DeviceType

    ops = {e.id: e for e in events
           if e.device_type == DeviceType.CPU and not e.linked}
    out = [0.0] * len(ranges)
    for k in events:
        op = ops.get(k.linked) if k.device_type == DeviceType.CUDA else None
        if op is None:
            continue
        for i, r in enumerate(ranges):
            if (op.thread == r.thread and r.start <= op.start
                    and op.end <= r.end):
                out[i] += k.end - k.start
    return out


def device_busy(fn) -> tuple[float, float, int, list] | None:
    """One torch.profiler trace of fn(): the union of device kernel time,
    the traced window (first event to last), the number of kernels and the
    ten kernels that take the most time, or None where the profiler saw no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return events_busy(trace_events(prof))


def events_busy(events) -> tuple[float, float, int, list] | None:
    """:func:`device_busy` of a trace's events (:func:`trace_events`)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start, e.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    window = max(e.end for e in events) - min(e.start for e in events)
    per_name: dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.end - e.start
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return busy / 1e3, window / 1e3, len(spans), top


def device_ops(fn) -> tuple[int, int] | None:
    """Kernels, and memory copies and sets, the device ran in one
    torch.profiler trace of fn(); None where it saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in trace_events(prof)
             if e.device_type == DeviceType.CUDA]
    if not names:
        return None
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return len(names) - copies, copies


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s); nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name, smi


def phase_build():
    import dsl_tpu_torch
    from dsl_tpu_torch.ops import build

    # the port must come from this checkout, not from an installed copy
    found = Path(dsl_tpu_torch.__file__).resolve().parent.parent
    if found != ROOT:
        raise RuntimeError(f"dsl_tpu_torch was imported from {found}, not "
                           f"from this checkout ({ROOT})")
    t0 = time.perf_counter()
    paths = build.build_all(verbose=True)
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")


def phase_kernel_cases():
    """Every edge case and every card-only case: the kernel's keeps equal
    the plain version's."""
    import torch

    from dsl_tpu_torch.ops import nms_cases
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    worst = 0
    for name, boxes, valid, thr in (nms_cases.cases() + [nms_cases.tiny_boxes()]
                                    + nms_cases.timing_cases()):
        b = torch.from_numpy(boxes).to(DEVICE)
        v = torch.from_numpy(valid).to(DEVICE)
        got = nms_keep(b, v, thr)
        want = nms_keep_reference(b, v, thr)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        worst = max(worst, diff)
        if not torch.equal(got, want):
            raise AssertionError(
                f"nms_keep != nms_keep_reference on {name}: "
                f"{int((got != want).sum())} of {got.numel()} keeps differ")
        log(f"[kernel] {name}: B={b.shape[0]} N={b.shape[1]} thr={thr} "
            f"kept {int(got.sum())} — bit-identical")
    return worst


@contextlib.contextmanager
def recording_nms():
    """Record the inputs and keeps of every nms_keep call the predict path
    makes (the real wrapper still runs and counts)."""
    import dsl_tpu_torch.core.nms as core_nms

    real = core_nms.nms_keep
    calls = []

    def record(boxes, valid, thr):
        keep = real(boxes, valid, thr)
        calls.append((boxes.clone(), valid.clone(), thr, keep.clone()))
        return keep

    core_nms.nms_keep = record
    try:
        yield calls
    finally:
        core_nms.nms_keep = real


# repr(model config) -> the future of its seeded weights; the later phases'
# are filled on one host thread (``prefetch_seeded_variables``) while the
# card runs the phases before them
_SEEDED: dict = {}
_SEEDED_LOCK = threading.Lock()
_STATE_DICTS: dict = {}


def _lowest_priority():
    """The fill thread yields the host's cores to the phases' own host
    work (this thread's nice value: Linux schedules threads as tasks)."""
    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)


_PREFETCH = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, initializer=_lowest_priority)


def _filled(model: dict) -> dict:
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.utils.jax_bridge import state_dict_to_flax
    from dsl_tpu_torch.utils.random_weights import fill_variables

    return fill_variables(state_dict_to_flax(empty_detector(model).state_dict()))


def seeded_variables(cfg) -> dict:
    """Seeded numpy weights in the flax layout for the config's detector
    (filled once per model config: the workflows reuse their variant's; a
    caller does not write them). A fill the host thread has not started is
    cancelled and made here; one it is running is waited for."""
    key = repr(cfg.model)
    with _SEEDED_LOCK:
        fut = _SEEDED.get(key)
        here = fut is None or fut.cancel()
        if here:
            fut = _SEEDED[key] = concurrent.futures.Future()
    if here:
        fut.set_result(_filled(dict(cfg.model)))
    return fut.result()


def prefetch_seeded_variables(paths):
    """Queue the seeded weights of the configs at ``paths`` for the host
    thread, in order: a numpy fill of up to 133 M parameters each, which
    would otherwise hold the card idle when its phase starts."""
    from dsl_tpu_torch.config import Config

    for path in paths:
        cfg = Config.fromfile(str(path))
        key = repr(cfg.model)
        with _SEEDED_LOCK:
            if key not in _SEEDED:
                _SEEDED[key] = _PREFETCH.submit(_filled, dict(cfg.model))


def seeded_state_dict(variables: dict) -> dict:
    """``flax_to_state_dict`` of a weights tree, made once per tree and
    kept with it (loading copies it, so the steps' entry points share
    it)."""
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict

    if id(variables) not in _STATE_DICTS:
        _STATE_DICTS[id(variables)] = (variables, flax_to_state_dict(variables))
    return _STATE_DICTS[id(variables)][1]


def phase_main_path(cfg, variables):
    import numpy as np
    import torch

    from dsl_tpu_torch.apis import inference_detector, init_detector
    from dsl_tpu_torch.models import detector_predict, fcos_get_bboxes
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.utils.precision import outputs_to_f32

    bundle = init_detector(cfg, variables=variables, device=DEVICE)
    det = bundle.detector
    n_params = sum(p.numel() for p in det.parameters())
    log(f"[main] {CONFIG.relative_to(ROOT)}: {type(det).__name__}, "
        f"{n_params / 1e6:.2f} M parameters, B={BATCH} at {CANVAS[0]}x{CANVAS[1]}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    request = np.random.RandomState(0).randint(0, 256, (480, 640, 3), np.uint8)
    tc = dict(cfg.model.test_cfg)

    # -- the main path, counted --------------------------------------------
    nms_keep.launches = 0
    with recording_nms() as calls:
        out32 = detector_predict(det, images, device=DEVICE)
        torch.cuda.synchronize()
        launches_f32 = nms_keep.launches
        out16 = detector_predict(det, images, compute_dtype=torch.bfloat16,
                                 device=DEVICE)
        torch.cuda.synchronize()
        launches_bf16 = nms_keep.launches - launches_f32
        result = inference_detector(bundle, request)
        torch.cuda.synchronize()
    launches = {"nms_keep": nms_keep.launches}
    log(f"[main] launches: {launches} (f32 predict {launches_f32}, bf16 "
        f"predict {launches_bf16}, one request {launches['nms_keep'] - launches_f32 - launches_bf16})")
    if launches_f32 != 1 or launches_bf16 != 1 or launches["nms_keep"] != 3:
        raise AssertionError(f"NMS kernel launches {launches}: expected one "
                             f"per predict")

    for tag, (dets, labels, valid) in (("f32", out32), ("bf16", out16)):
        if tuple(dets.shape) != (BATCH, tc["max_per_img"], 5):
            raise AssertionError(f"{tag} dets shape {tuple(dets.shape)}")
        if not bool(torch.isfinite(dets).all()):
            raise AssertionError(f"{tag} dets are not finite")
        per_img = valid.sum(1).tolist()
        if min(per_img) == 0:
            raise AssertionError(f"{tag}: an image has no detection: {per_img}")
        log(f"[main] {tag}: dets {tuple(dets.shape)} finite, valid per image "
            f"{per_img}, labels seen {sorted(set(labels[valid].tolist()))[:10]}")
    if len(result) != cfg.model.bbox_head.num_classes:
        raise AssertionError(f"inference_detector gave {len(result)} classes")
    log(f"[main] inference_detector: {sum(len(r) for r in result)} boxes "
        f"over {sum(1 for r in result if len(r))} classes")

    # NMS at full N: enough candidates clear score_thr in every image
    with torch.no_grad():
        heads = outputs_to_f32(det(images))
        _, scores, _ = fcos_get_bboxes(det.bbox_head, *heads, with_nms=False)
    cands = (scores > tc["score_thr"]).flatten(1).sum(1).tolist()
    log(f"[main] candidates over score_thr per image: {cands}")
    if min(cands) < 2000:
        raise AssertionError(f"fewer than 2000 candidates: {cands}")

    # the kernel's keeps on the real NMS inputs equal the plain version's
    worst = 0
    for boxes, valid, thr, keep in calls:
        want = nms_keep_reference(boxes, valid, thr)
        torch.cuda.synchronize()
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
        if tuple(boxes.shape) not in ((BATCH, 2000, 4), (1, 2000, 4)):
            raise AssertionError(f"NMS input shape {tuple(boxes.shape)}")
        if not torch.equal(keep, want):
            raise AssertionError(f"predict NMS keeps differ from the plain "
                                 f"version at {tuple(boxes.shape)}")
        log(f"[main] NMS input {tuple(boxes.shape)}: {int(valid.sum())} valid, "
            f"{int(keep.sum())} kept — bit-identical to the plain version")

    # f32 head outputs agree with a CPU run of the same model, small input
    small = images[:1, :, :128, :192]
    with torch.no_grad():
        gpu = outputs_to_f32(det(small))
        cpu_det = copy.deepcopy(det).cpu()
        cpu = cpu_det(small.cpu())
    worst_rel = 0.0
    for g_lvls, c_lvls in zip(gpu, cpu):
        for g, c in zip(g_lvls, c_lvls):
            rel = float((g.cpu() - c).abs().max() / c.abs().max().clamp_min(1.0))
            worst_rel = max(worst_rel, rel)
    log(f"[main] f32 head outputs, card vs CPU at 1x128x192: worst |diff| / "
        f"max|ref| = {worst_rel:.3e}")
    if worst_rel > 1e-3:
        raise AssertionError(f"card and CPU disagree: {worst_rel}")

    return bundle, images, launches, worst, calls


def kernel_bound_ms(boxes, valid, keep) -> tuple[float, str]:
    """Least time for greedy NMS on these inputs: inputs read once and keep
    written once over the memory rate, against the IoU tests this data
    needs (each kept box against every later valid box) over the f32 rate."""
    b, n = valid.shape
    bytes_moved = boxes.numel() * 4 + valid.numel() + keep.numel()
    later_valid = valid.flip(1).cumsum(1).flip(1) - valid.long()
    pairs = int((later_valid * keep).sum())
    ops = IOU_OPS * pairs + AREA_OPS * int(valid.sum())
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOP_PER_S * 1e3
    log(f"[bound] nms_keep B={b} N={n}: {bytes_moved} bytes, {pairs} IoU "
        f"tests = {ops} ops -> {t_bytes * 1e3:.3f} us by bytes, "
        f"{t_ops * 1e3:.3f} us by ops")
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_timing(bundle, images, smi: str):
    import torch
    from torch.func import functional_call

    from dsl_tpu_torch.models import detector_predict, fcos_get_bboxes
    from dsl_tpu_torch.utils.precision import outputs_to_f32, to_compute

    det = bundle.detector
    tc = dict(bundle.cfg.model.test_cfg)
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        def predict():
            return detector_predict(det, images, compute_dtype=dtype,
                                    device=DEVICE)

        torch.cuda.reset_peak_memory_stats()
        times = sorted(host_ms(predict, reps=PREDICT_TIMED))
        ms = times[len(times) // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[time] predict {tag} B={BATCH} {CANVAS[0]}x{CANVAS[1]}: median "
            f"{ms:.2f} ms/batch (min {times[0]:.2f}, max {times[-1]:.2f}, "
            f"{PREDICT_TIMED} reps), {BATCH / ms * 1e3:.1f} img/s, peak memory "
            f"{peak:.2f} GiB  ({smi})")
        traced = device_busy(predict)
        if traced is None:
            log(f"[trace] predict {tag}: device idle share not measured "
                f"(the profiler saw no device event)")
            continue
        busy, window, n_kernels, top = traced
        log(f"[trace] predict {tag}: {n_kernels} kernels, device busy "
            f"{busy:.2f} ms of a {window:.2f} ms window, idle share "
            f"{1 - busy / window:.3f}  ({smi})")
        for kname, us in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  {kname[:100]}")
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        variables, x = to_compute(det, images, dtype)
        with torch.no_grad():
            fwd = cuda_ms(lambda: functional_call(det, variables, (x,)), reps=5)
            heads = outputs_to_f32(functional_call(det, variables, (x,)))
        post = cuda_ms(lambda: fcos_get_bboxes(
            det.bbox_head, *heads, nms_pre=tc["nms_pre"],
            score_thr=tc["score_thr"],
            iou_threshold=tc["nms"]["iou_threshold"],
            max_per_img=tc["max_per_img"]), reps=10)
        log(f"[time] {tag} split: forward {fwd:.2f} ms, decode + NMS "
            f"{post:.2f} ms (device time)  ({smi})")


def nms_pass_ms(boxes, valid, thr) -> dict[str, float]:
    """Device time per call of each pass of nms_keep, from a torch.profiler
    trace over NMS_TRACE_REPS calls: the mean device duration of the pass's
    kernel, by name. The trace may drop records (seen on the card): one that
    kept fewer than half of the calls of a pass is taken again, up to
    NMS_TRACE_TRIES traces, and then fails the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dsl_tpu_torch.ops.nms import nms_keep

    for _ in range(5):
        nms_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    for _ in range(NMS_TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(NMS_TRACE_REPS):
                nms_keep(boxes, valid, thr)
            torch.cuda.synchronize()
        total = {p: 0.0 for p in NMS_PASSES}
        count = {p: 0 for p in NMS_PASSES}
        for e in trace_events(prof):
            if e.device_type != DeviceType.CUDA:
                continue
            for p, kname in NMS_PASSES.items():
                if kname in e.name:
                    total[p] += e.end - e.start
                    count[p] += 1
        if max(count.values()) > NMS_TRACE_REPS:
            raise AssertionError(f"profiler saw {count} NMS pass kernels over "
                                 f"{NMS_TRACE_REPS} calls")
        if min(count.values()) < NMS_TRACE_REPS:
            log(f"[trace] nms_keep: the profiler kept {count} of "
                f"{NMS_TRACE_REPS} records")
        if 2 * min(count.values()) >= NMS_TRACE_REPS:
            return {p: total[p] / count[p] / 1e3 for p in NMS_PASSES}
    raise AssertionError(f"{NMS_TRACE_TRIES} profiler traces each kept fewer "
                         f"than half of {NMS_TRACE_REPS} NMS calls")


def phase_nms_timing(calls, smi: str) -> dict:
    """The NMS kernel on its four timing inputs: the recorded f32 predict
    input (B=8) and request input (B=1) of the main path, and the dense and
    sparse cases of nms_cases.timing_cases(). Per input: each pass's device
    time and their sum per call (profiler), the wrapper's time (CUDA events
    around 100 calls of nms_keep, host work included), the plain version's
    time and the bound."""
    import torch

    from dsl_tpu_torch.ops import nms_cases

    predict = next(c for c in calls if c[0].shape[0] == BATCH)
    request = next(c for c in calls if c[0].shape[0] == 1)
    inputs = [("predict_b8", *predict[:3]), ("request_b1", *request[:3])]
    for name, boxes, valid, thr in nms_cases.timing_cases():
        if name in ("dense_b8", "sparse_b8"):
            inputs.append((name, torch.from_numpy(boxes).to(DEVICE),
                           torch.from_numpy(valid).to(DEVICE), thr))
    return {name: nms_input_timing(name, boxes, valid, thr, smi)
            for name, boxes, valid, thr in inputs}


def nms_input_timing(name: str, boxes, valid, thr, smi: str) -> dict:
    """The NMS kernel on one input: each pass's device time and their sum
    per call (profiler), the wrapper's time (CUDA events around 100 calls
    of nms_keep, host work included), the plain version's time and the
    bound."""
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    keep = nms_keep_reference(boxes, valid, thr)
    passes = nms_pass_ms(boxes, valid, thr)
    device = sum(passes.values())
    wrapper = cuda_ms(lambda: nms_keep(boxes, valid, thr), reps=100, warmup=5)
    plain = cuda_ms(lambda: nms_keep_reference(boxes, valid, thr), reps=5)
    bound, bound_by = kernel_bound_ms(boxes, valid, keep)
    split = ", ".join(f"{p} {ms:.4f}" for p, ms in passes.items())
    log(f"[time] nms_keep {name} B={boxes.shape[0]} N={boxes.shape[1]} "
        f"kept {int(keep.sum())}: device {device:.4f} ms ({split}), "
        f"wrapper {wrapper:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bound:.6f} ms ({bound_by}), {device / bound:.1f}x the bound"
        f"  ({smi})")
    return dict(ms=device, wrapper_ms=wrapper, plain_ms=plain,
                bound_ms=bound, bound_by=bound_by, kept=int(keep.sum()),
                **passes)


def train_batch(cfg, seed: int, canvas, n_labeled: int, n_unlabeled: int,
                side, device):
    """The seeded semi batch (see ``random_batch.semi_batch``): 1-20 GT
    boxes per image (K=100), no ignore box on a labeled image and 0-10 on an
    unlabeled one (Ki=60), the unlabeled images weighted by the head's
    ``loss_weight``, plus the half-res copy of the last image."""
    import numpy as np

    from dsl_tpu_torch.utils.random_batch import semi_batch, to_torch

    rng = np.random.RandomState(seed)
    n = n_labeled + n_unlabeled
    batch = semi_batch(
        seed, canvas, n_gt=list(rng.randint(1, 21, n)),
        n_ignore=[0] * n_labeled + list(rng.randint(0, 11, n_unlabeled)),
        n_labeled=n_labeled, side=side,
        unlabeled_weight=cfg.model.bbox_head.loss_weight)
    return to_torch(batch, device)


def train_entry(cfg, variables, dtype, device):
    """The training entry point: detector with the seeded weights, frozen
    mask, the config's optimizer, train state and step."""
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.train import (
        build_optimizer_from_cfg, create_train_state, frozen_backbone_mask,
        make_train_step)

    det = empty_detector(dict(cfg.model))
    det.load_state_dict(seeded_state_dict(variables))
    frozen = frozen_backbone_mask(
        det, dict(cfg.model.backbone).get("frozen_stages", -1))
    tx, _ = build_optimizer_from_cfg(
        dict(cfg.optimizer), dict(cfg.optimizer_config), dict(cfg.lr_config),
        steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    # train_detector's defaults where the config has no ema_config
    ema = dict(cfg.get("ema_config") or {})
    state = create_train_state(det, tx, ema_ratio=ema.get("ratio", 0.99),
                               device=device)
    step = make_train_step(det, tx, ema_interval=ema.get("interval", 1),
                           ema_start_iter=ema.get("start_point", 1),
                           compute_dtype=dtype, frozen_mask=frozen,
                           device=device)
    return state, step


def phase_train(cfg, variables, smi: str):
    """The train path, counted: ``TRAIN_WARMUP + TRAIN_STEPS`` steps in f32 and in bf16 from the
    same seeded state, then one teacher eval step, whose NMS keeps are held
    against the plain version. Returns the launch counts, the largest keep
    error and, per precision, the state, its step and the batch for the
    timing."""
    import torch

    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.train import ema_update, make_eval_step

    batch = train_batch(cfg, TRAIN_SEED, CANVAS, 2, 2, (16, 600), DEVICE)
    log(f"[train] B={batch['images'].shape[0]} at {CANVAS[0]}x{CANVAS[1]} "
        f"(2 labeled, 2 unlabeled, 1 half-res copy): valid GT per image "
        f"{batch['gt_valid'].sum(1).tolist()}, ignore "
        f"{batch['ignore_valid'].sum(1).tolist()}, source weights "
        f"{batch['source_weight'].tolist()}")
    runs, firsts, trajectories = {}, {}, {}
    nms_keep.launches = 0
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16),
                       ("f32 again", None)):
        state, step = train_entry(cfg, variables, dtype, DEVICE)
        det = state.student
        frozen = {n: p.detach().clone() for n, p in det.named_parameters()
                  if not p.requires_grad}
        torch.cuda.reset_peak_memory_stats()
        teacher0 = state.teacher_params
        metrics = [step(state, batch)]
        want = ema_update(teacher0, dict(det.named_parameters()),
                          state.ema_ratio)
        for n, t in state.teacher_params.items():
            rel = float((t - want[n]).abs().max()
                        / want[n].abs().max().clamp_min(1e-12))
            if rel > 1e-6:
                raise AssertionError(f"{tag}: teacher {n} is not the EMA of "
                                     f"its start and the student ({rel})")
        metrics += [step(state, batch) for _ in range(TRAIN_WARMUP - 1)]
        torch.cuda.synchronize()
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(step(state, batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        keys = {"loss", "loss_cls", "loss_bbox", "loss_centerness",
                "loss_sisoft", "grad_norm"}
        for i, m in enumerate(metrics):
            if set(m) != keys:
                raise AssertionError(f"{tag} step {i}: metrics {sorted(m)}")
            bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
            if bad:
                raise AssertionError(f"{tag} step {i}: not finite: {bad}")
        if state.step != TRAIN_WARMUP + TRAIN_STEPS:
            raise AssertionError(f"{tag}: step {state.step}")
        for n, p in det.named_parameters():
            if n in frozen and not torch.equal(p, frozen[n]):
                raise AssertionError(f"{tag}: frozen {n} moved")
        first, last = metrics[0], metrics[-1]
        log(f"[train] {tag}: step {state.step}; {len(frozen)} frozen "
            f"parameters bit-identical; teacher = ema_update after step 1")
        for name, m in (("first", first), ("last", last)):
            log(f"[train] {tag} {name} step: " + ", ".join(
                f"{k} {float(v):.5f}" for k, v in sorted(m.items())))
        times.sort()
        ms = times[len(times) // 2]
        log(f"[time] train step {tag} B=5 {CANVAS[0]}x{CANVAS[1]}: median "
            f"{ms:.2f} ms (min {times[0]:.2f}, max {times[-1]:.2f}, "
            f"{TRAIN_STEPS} steps), {4 / ms * 1e3:.2f} img/s (4 real "
            f"images), peak memory {peak:.2f} GiB  ({smi})")
        trajectories[tag] = (
            [{k: float(v) for k, v in m.items()} for m in metrics],
            {n: p.detach().clone() for n, p in det.named_parameters()})
        if tag == "f32 again":
            del state, step, det
            break
        runs[tag] = (state, step)
        firsts[tag] = first
    check_deterministic(*trajectories["f32"], *trajectories["f32 again"])
    del trajectories
    # bf16 ran: its first step parts from f32's (same state and batch) by
    # more than f32 rounding, and stays within the parity tests' bf16 limit.
    # si-soft is left out: before soft_warm_up it is a tiny mean square of
    # differences of near-equal logits, and bf16 moves it by tens of percent
    rel = {k: float((firsts["bf16"][k] - v).abs() / v.abs().clamp_min(1e-12))
           for k, v in firsts["f32"].items() if k != "loss_sisoft"}
    log("[train] first step, bf16 vs f32: relative differences " + ", ".join(
        f"{k} {v:.2e}" for k, v in sorted(rel.items())))
    if max(rel.values()) <= 1e-5 or max(rel.values()) > 2e-2:
        raise AssertionError(f"bf16 vs f32 first step: {rel} (expected the "
                             f"largest in (1e-5, 2e-2])")
    train_launches = nms_keep.launches
    teacher_eval = make_eval_step(runs["bf16"][0].student,
                                  test_cfg=dict(cfg.model.test_cfg),
                                  use_teacher=True, device=DEVICE)
    n_img = batch["images"].shape[0]
    with recording_nms() as calls:
        dets, labels, valid = teacher_eval(runs["bf16"][0], batch["images"])
        torch.cuda.synchronize()
    eval_launches = nms_keep.launches - train_launches
    log(f"[train] launches: nms_keep {train_launches} in the train steps, "
        f"{eval_launches} in the eval step")
    if train_launches != 0 or eval_launches != 1:
        raise AssertionError(f"NMS launches: {train_launches} in the steps, "
                             f"{eval_launches} in the eval step")
    if (tuple(dets.shape) != (n_img, cfg.model.test_cfg.max_per_img, 5)
            or not bool(torch.isfinite(dets).all())):
        raise AssertionError(f"teacher eval dets {tuple(dets.shape)}")
    log(f"[train] teacher eval: dets {tuple(dets.shape)} finite, valid per "
        f"image {valid.sum(1).tolist()}")
    worst = 0
    for boxes, cand_valid, thr, keep in calls:
        if tuple(boxes.shape) != (n_img, 2000, 4):
            raise AssertionError(f"teacher eval NMS input {tuple(boxes.shape)}")
        want = nms_keep_reference(boxes, cand_valid, thr)
        torch.cuda.synchronize()
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError(f"teacher eval NMS keeps differ from the "
                                 f"plain version at {tuple(boxes.shape)}")
        log(f"[train] teacher eval NMS input {tuple(boxes.shape)}: "
            f"{int(cand_valid.sum())} valid, {int(keep.sum())} kept — "
            f"bit-identical to the plain version")
    return {"nms_keep": nms_keep.launches}, worst, runs, batch


def check_deterministic(metrics_a, params_a, metrics_b, params_b):
    """Two f32 runs from one seeded state: every step's losses and
    ``grad_norm``, and every parameter after the last step, bit-identical;
    else the spread is printed and the run fails."""
    import torch

    steps = [i for i, (a, b) in enumerate(zip(metrics_a, metrics_b)) if a != b]
    params = [n for n in params_a if not torch.equal(params_a[n], params_b[n])]
    if steps or params:
        spread = max(abs(metrics_a[-1][k] - metrics_b[-1][k])
                     for k in metrics_a[-1])
        raise AssertionError(
            f"two f32 runs from one seed differ: at steps {steps[:5]} (of "
            f"{len(metrics_a)}), last-step metrics up to {spread:.6g} apart, "
            f"{len(params)} parameters differ after the last step")
    log(f"[train] determinism: two f32 runs of {len(metrics_a)} steps from "
        f"one seeded state: losses and grad_norm bit-identical at every "
        f"step, all {len(params_a)} parameters bit-identical after step "
        f"{len(metrics_a)} (cudnn.deterministic, no autotuning)")


def phase_train_timing(runs, batch, smi: str):
    """Per precision: one profiler trace of a step, and a step split by
    CUDA events recorded where the step enqueues each part."""
    import torch

    for tag, (state, step) in runs.items():
        traced = device_busy(lambda: step(state, batch))
        if traced is None:
            log(f"[trace] train step {tag}: device idle share not measured "
                f"(the profiler saw no device event)")
        else:
            busy, window, n_kernels, top = traced
            log(f"[trace] train step {tag}: {n_kernels} kernels, device busy "
                f"{busy:.2f} ms of a {window:.2f} ms window, idle share "
                f"{1 - busy / window:.3f}  ({smi})")
            for kname, us in top:
                log(f"[trace]   {us / 1e3:8.3f} ms  {kname[:100]}")
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        torch.cuda.synchronize()
        mark("start")
        step(state, batch, mark=mark)
        torch.cuda.synchronize()
        names = ("start",) + SPLIT
        parts = {b: events[a].elapsed_time(events[b])
                 for a, b in zip(names, names[1:])}
        log(f"[time] train step {tag} split (CUDA events): " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items())
            + f" ms; sum {sum(parts.values()):.2f} ms  ({smi})")
        # what determinism costs: the same step with cuDNN free to pick its
        # (nondeterministic) algorithms, in turns with the deterministic one
        medians = {}
        for flag in (False, True, False, True):
            torch.backends.cudnn.deterministic = flag
            times = sorted(host_ms(lambda: step(state, batch),
                                   reps=DET_COST_STEPS))
            medians.setdefault(flag, []).append(times[len(times) // 2])
        log(f"[time] train step {tag}, cost of determinism (median of "
            f"{DET_COST_STEPS} steps, in turns): cudnn.deterministic "
            f"{medians[True][0]:.2f} / {medians[True][1]:.2f} ms, free "
            f"{medians[False][0]:.2f} / {medians[False][1]:.2f} ms  ({smi})")


def banded_max_ratio(got: dict, want: dict, init: dict) -> tuple[float, float]:
    """The banded check of the parity tests on two updated state dicts:
    the worst per-parameter |got - want| / max(0.05 * scale, 1e-5), scale
    the larger update, and the relative L2 error of all updates."""
    import torch

    worst, num, den = 0.0, 0.0, 0.0
    for n, w in want.items():
        dw = (w - init[n]).double()
        dg = (got[n] - init[n]).double()
        scale = float(torch.maximum(dw.abs().max(), dg.abs().max()))
        worst = max(worst, float((dg - dw).abs().max()) / max(0.05 * scale, 1e-5))
        num += float(((dg - dw) ** 2).sum())
        den += float((dw ** 2).sum())
    return worst, (num / den) ** 0.5


def phase_train_card_vs_cpu(cfg, variables):
    """One f32 step of the flagship on a labeled image and its half-res
    copy at 128x192, on the card and on the CPU."""
    import torch

    results = {}
    for device in (DEVICE, "cpu"):
        state, step = train_entry(cfg, variables, None, device)
        init = {n: p.detach().cpu().clone()
                for n, p in state.student.named_parameters()}
        metrics = step(state, train_batch(cfg, TRAIN_SEED + 1, (128, 192), 1,
                                          0, (8, 100), device))
        results[device] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in state.student.named_parameters()})
    (m_card, p_card), (m_cpu, p_cpu) = results[DEVICE], results["cpu"]
    for k, v in m_cpu.items():
        rel = abs(m_card[k] - v) / max(abs(v), 1e-12)
        if rel > (1e-3 if k == "grad_norm" else 1e-4):
            raise AssertionError(f"card vs CPU {k}: {m_card[k]} vs {v}")
    worst, l2 = banded_max_ratio(p_card, p_cpu, init)
    log(f"[train] card vs CPU, one f32 step at 2x128x192: " + ", ".join(
        f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}" for k in sorted(m_cpu))
        + f"; updates: worst banded ratio {worst:.3f} (limit 1), relative "
        f"L2 {l2:.2e} (limit 1e-3)")
    if worst > 1 or l2 > 1e-3:
        raise AssertionError(f"card vs CPU updates: banded ratio {worst}, "
                             f"L2 {l2}")


# -- the semi-supervised loop (phases 8, 10) --------------------------------

SEMI_LABELED, SEMI_UNLABELED, SEMI_VAL = 8, 16, 12  # copies of the fixtures
SEMI_EPOCHS, SEMI_START = 2, 1
# the flagship config's only overrides in the semi phase: its schedule
OVERRIDES = {"runner.max_epochs": SEMI_EPOCHS,
             "data.unlabel_pred.start_point": SEMI_START}
SEMI_TIMED_ITERS = 5
EXIF_ORIENTATIONS = (3, 6, 8)
SEMI_UNREADABLE = "unlabeled_header_cut.jpg"
# nvJPEG against OpenCV's decodes of the fixtures: libjpeg-turbo's "fancy"
# chroma upsampling and IDCT part from nvJPEG's at colour edges (measured
# on the card: a mean of 0.7-0.9 levels, 0.6-1.5% of values off by more
# than 4, at most 29; grayscale at most 1)
DECODE_MEAN_LEVELS, DECODE_SHARE_OVER_4, DECODE_MAX_LEVELS = 1.5, 0.03, 48


def tests_on_path():
    """Make the test helpers importable (``torch_port_make_fixtures`` and
    ``torch_port_util``, which import JAX only inside the functions that
    build the JAX side)."""
    sys.path.insert(0, str(ROOT / "tests"))


def fixtures():
    """(name, path, height, width) of the committed JPEG fixtures, and
    their committed OpenCV decodes."""
    from torch_port_make_fixtures import FIXTURES, OUT, load_decodes

    return ([(n, OUT / f"{n}.jpg", h, w) for n, (h, w, _) in FIXTURES.items()],
            load_decodes())


def decode_stats(got, want) -> tuple[float, float, int]:
    """Mean |diff| in levels, share of values off by more than 4, max."""
    d = (got.int() - want.int()).abs()
    return (float(d.float().mean()), float((d > 4).float().mean()),
            int(d.max()))


def phase_decode(smi: str) -> dict:
    """nvJPEG on each fixture against the committed cv2 decode, and its time
    per image (host clock around each decode, ending in a synchronize)."""
    import torch

    from dsl_tpu_torch.data.image_io import decode_jpeg, read_image

    files, decodes = fixtures()
    out = {}
    for name, path, h, w in files:
        got = read_image(path, DEVICE)
        torch.cuda.synchronize()
        want = torch.from_numpy(decodes[name]).to(DEVICE)
        if tuple(got.shape) != (h, w, 3) or got.dtype != torch.uint8:
            raise AssertionError(f"decode of {name}: {tuple(got.shape)} {got.dtype}")
        mean, over4, worst = decode_stats(got, want)
        data = path.read_bytes()
        times = sorted(host_ms(lambda: decode_jpeg(data, torch.device(DEVICE)),
                               reps=DECODE_TIMED))
        ms = times[len(times) // 2]
        log(f"[decode] nvJPEG {name} ({len(data)} bytes, {w}x{h}): vs cv2 "
            f"mean |diff| {mean:.3f} levels, {over4 * 100:.2f}% off by more "
            f"than 4, max {worst}; {ms:.3f} ms per image (median of {DECODE_TIMED}, min "
            f"{times[0]:.3f})  ({smi})")
        if (mean > DECODE_MEAN_LEVELS or over4 > DECODE_SHARE_OVER_4
                or worst > DECODE_MAX_LEVELS):
            raise AssertionError(f"nvJPEG decode of {name} is outside the "
                                 f"tolerance: {mean}, {over4}, {worst}")
        out[name] = ms
    phase_exif_and_probe(files, decodes)
    phase_cut_jpeg(smi)
    phase_probe_timing(files, smi)
    return out


PROBE_FILES, PROBE_INFO_CALLS = 2500, 500
DECODE_TIMED = 10             # nvJPEG decodes timed per fixture


def phase_probe_timing(files, smi: str):
    """The refresher's probe over a long list, as it runs before the first
    chunk: ``PROBE_FILES`` names hard-linked to the fixtures (each read from
    the page cache), probed one after another on the host; then where the
    time goes: the header's read and marker walk over the same names, and
    ``nvjpegGetImageInfo`` on ``PROBE_INFO_CALLS`` of those prefixes and on
    as many whole files (host clock)."""
    import torch

    from dsl_tpu_torch.data import image_io

    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix="_smoke_probe_", dir=ROOT) as tmp:
        names = []
        for i in range(PROBE_FILES):
            name = os.path.join(tmp, f"{i:06d}.jpg")
            os.link(files[i % len(files)][1], name)
            names.append(name)
        image_io.readable(names[0], DEVICE)
        t0 = time.perf_counter()
        passed = sum(image_io.readable(n, DEVICE) for n in names)
        seconds = time.perf_counter() - t0
        prefixes = []
        t0 = time.perf_counter()
        for n in names:
            with open(n, "rb") as f:
                data = f.read(image_io.PROBE_FIRST_READ)
            image_io.jpeg_header_end(data)
            prefixes.append(data)
        walk = time.perf_counter() - t0
    if passed != PROBE_FILES:
        raise AssertionError(f"probe: {passed} of {PROBE_FILES} passed")
    wholes = [path.read_bytes() for _, path, _, _ in files]
    info = {}
    for label, bufs in (("prefix", prefixes),
                        ("whole file", wholes * PROBE_INFO_CALLS)):
        t0 = time.perf_counter()
        for data in bufs[:PROBE_INFO_CALLS]:
            image_io.jpeg_info(data, dev)
        info[label] = (time.perf_counter() - t0) / PROBE_INFO_CALLS * 1e6
    log(f"[decode] probe over {PROBE_FILES} files: {seconds:.3f} s, "
        f"{seconds / PROBE_FILES * 1e6:.1f} us per file; of which the "
        f"header's read and walk {walk / PROBE_FILES * 1e6:.1f} us, "
        f"nvjpegGetImageInfo {info['prefix']:.1f} us on a "
        f"{image_io.PROBE_FIRST_READ}-byte prefix ({info['whole file']:.1f} "
        f"us on a whole fixture) (host clock, files in the page cache)  "
        f"({smi})")


def phase_exif_and_probe(files, decodes):
    """EXIF-tagged copies of the colour fixtures, written here, decode on
    the card to the committed OpenCV decode turned as OpenCV turns it; the
    probe refuses files cut in the header, empty and missing, and passes
    the fixtures."""
    import torch

    from dsl_tpu_torch.data.image_io import read_image, readable
    from torch_port_make_fixtures import FIXTURES
    from torch_port_util import (exif_segment, orient_like_cv2,
                                 unreadable_files, with_exif)

    with tempfile.TemporaryDirectory(prefix="_smoke_decode_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        for name, path, h, w in files:
            if FIXTURES[name][2]:          # grayscale
                continue
            for orientation in EXIF_ORIENTATIONS:
                for order in ("II", "MM"):
                    tagged = tmp / f"{name}_{orientation}_{order}.jpg"
                    tagged.write_bytes(with_exif(
                        path.read_bytes(), exif_segment(orientation, order)))
                    got = read_image(tagged, DEVICE)
                    want = torch.from_numpy(orient_like_cv2(
                        decodes[name], orientation)).to(DEVICE)
                    if got.shape != want.shape:
                        raise AssertionError(
                            f"EXIF {orientation} ({order}) on {name}: "
                            f"{tuple(got.shape)}, OpenCV gives "
                            f"{tuple(want.shape)}")
                    mean, over4, worst = decode_stats(got, want)
                    if (mean > DECODE_MEAN_LEVELS or over4 > DECODE_SHARE_OVER_4
                            or worst > DECODE_MAX_LEVELS):
                        raise AssertionError(
                            f"EXIF {orientation} ({order}) on {name}: "
                            f"{mean}, {over4}, {worst}")
            log(f"[decode] {name} tagged with EXIF orientations "
                f"{EXIF_ORIENTATIONS} (both byte orders): nvJPEG + the "
                f"orientation on the card give OpenCV's shape "
                f"{tuple(orient_like_cv2(decodes[name], 6).shape)} for 6 "
                f"and 8, within the decode tolerance of the turned decode")
        bad = unreadable_files(tmp, files[0][1].read_bytes())
        taken = [n for n, p in bad.items() if readable(p, DEVICE)]
        refused = [n for _, p, _, _ in files if not readable(p, DEVICE)]
        if taken or refused:
            raise AssertionError(f"probe: passed {taken}, refused {refused}")
        log(f"[decode] probe on the card: refuses {sorted(bad)} (cut inside "
            f"its header at 600 bytes, empty, SOI and garbage, missing), "
            f"passes all {len(files)} fixtures")


def phase_cut_jpeg(smi: str):
    """JPEGs cut inside their entropy-coded data (the committed cuts of a
    colour fixture and of the restart-marker fixture): the probe passes
    them, the card route decodes them (nvJPEG refuses the restart file cut
    as it is and takes the completed stream), the rows from OpenCV's first
    gray row (committed, and the host scan's) are 128 exactly, and the rows
    above the band the data ends in are nvJPEG's decode of the whole file.
    The host scan's time per file. Then the progressive cuts
    (:func:`phase_progressive_cut`)."""
    import torch

    from dsl_tpu_torch.data import jpeg_scan
    from dsl_tpu_torch.data.image_io import decode_jpeg, read_image, readable
    from torch_port_make_fixtures import OUT, RESTART

    dev = torch.device(DEVICE)
    committed = json.loads((OUT / "cut_fill_rows.json").read_text())
    with tempfile.TemporaryDirectory(prefix="_smoke_cut_", dir=ROOT) as tmp:
        path = Path(tmp) / "cut.jpg"
        for name in ("coco_640x480", RESTART):
            data = (OUT / f"{name}.jpg").read_bytes()
            whole = decode_jpeg(data, dev)
            for cut, gray in committed[name]:
                path.write_bytes(data[:cut])
                got = read_image(path, DEVICE)
                k = jpeg_scan.truncated_imcu_row(data[:cut])
                rows = max(0, 16 * k - 1)
                if not (readable(path, DEVICE)
                        and jpeg_scan.cut_fill_row(data[:cut]) == gray
                        and got.shape == whole.shape
                        and bool((got[gray:] == 128).all())
                        and torch.equal(got[:rows], whole[:rows])):
                    raise AssertionError(f"{name} cut at {cut} bytes: the "
                                         f"card's decode is not OpenCV's fill")
                times = sorted(host_ms(lambda: jpeg_scan.for_decoder(
                    data[:cut]), reps=5, warmup=1))
                log(f"[decode] {name} cut at {cut} of {len(data)} bytes: the "
                    f"data ends in iMCU row {k}; rows {gray}-"
                    f"{got.shape[0] - 1} = 128 as OpenCV fills them, rows "
                    f"0-{rows - 1} = nvJPEG's whole-file decode; host scan "
                    f"{times[2]:.2f} ms (median of 5)  ({smi})")
        phase_progressive_cut(path, smi)


def phase_progressive_cut(path: Path, smi: str):
    """The progressive fixture at its committed cuts (in the DC scan, in a
    later scan): ``for_decoder`` hands nvJPEG the committed baseline
    transcode (its sha256; the CPU tests hold OpenCV's decode of it equal
    to OpenCV's decode of the cut file), fills nothing, and the card's
    decode is within the decode tolerance of OpenCV's (the committed 4x4
    sums); the host transcode's time per file."""
    import hashlib

    import numpy as np

    from dsl_tpu_torch.data import jpeg_coef, jpeg_scan
    from dsl_tpu_torch.data.image_io import read_image, readable
    from torch_port_make_fixtures import OUT, PROGRESSIVE, block_sums

    data = (OUT / f"{PROGRESSIVE}.jpg").read_bytes()
    with np.load(OUT / "progressive_cut_means.npz") as committed_sums:
        sums = dict(committed_sums)
    for cut, sha in json.loads((OUT / "progressive_cuts.json").read_text()):
        stream, fill = jpeg_scan.for_decoder(data[:cut])
        if fill is not None or hashlib.sha256(stream).hexdigest() != sha:
            raise AssertionError(f"{PROGRESSIVE} cut at {cut}: the transcode is "
                                 f"not the committed one")
        path.write_bytes(data[:cut])
        got = read_image(path, DEVICE)
        d = np.abs(block_sums(got.cpu().numpy()).astype(np.int64)
                   - sums[f"cut_{cut}"]) / 16.0
        mean, over4, worst = float(d.mean()), float((d > 4).mean()), float(d.max())
        times = sorted(host_ms(lambda: jpeg_coef.transcode(data[:cut]), reps=5,
                               warmup=1))
        log(f"[decode] {PROGRESSIVE} cut at {cut} of {len(data)} bytes: the "
            f"baseline transcode ({len(stream)} bytes, sha256 committed) on "
            f"nvJPEG vs OpenCV's decode of the cut file, 4x4 means: mean "
            f"|diff| {mean:.3f} levels, {over4 * 100:.2f}% off by more than "
            f"4, max {worst:.2f}; host transcode {times[2]:.1f} ms (median of "
            f"5, min {times[0]:.1f})  ({smi})")
        if (not readable(path, DEVICE) or mean > DECODE_MEAN_LEVELS
                or over4 > DECODE_SHARE_OVER_4 or worst > DECODE_MAX_LEVELS):
            raise AssertionError(f"{PROGRESSIVE} cut at {cut}: {mean}, "
                                 f"{over4}, {worst}")


RESIZE_SCALES = ((1333, 640), (1333, 800))   # the train scales of both configs
RESIZE_TIMED = 20


def phase_resize(smi: str):
    """``resize_linear_u8`` on the card against the CPU (which the CPU
    tests hold to ``cv2.resize``) on the fixtures at the flagship's and the
    baseline's scales, bit for bit; its time per image beside the bilinear
    ``F.interpolate`` the port used before (rounded to uint8)."""
    import torch
    import torch.nn.functional as F

    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
    from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size

    def bilinear(img, nh, nw):
        x = img.permute(2, 0, 1)[None].float()
        out = F.interpolate(x, size=(nh, nw), mode="bilinear",
                            align_corners=False)[0].permute(1, 2, 0)
        return out.round().clamp(0, 255).to(torch.uint8).contiguous()

    files, decodes = fixtures()
    for scale in RESIZE_SCALES:
        ms, old_ms = [], []
        for name, _, h, w in files:
            host = torch.from_numpy(decodes[name])
            card = host.to(DEVICE)
            nh, nw = keep_ratio_size(h, w, scale)
            got = resize_linear_u8(card, nh, nw)
            want = resize_linear_u8(host, nh, nw)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"resize_linear_u8 of {name} to "
                                     f"{nh}x{nw}: card != CPU")
            for fn, acc in ((resize_linear_u8, ms), (bilinear, old_ms)):
                times = sorted(host_ms(lambda: fn(card, nh, nw),
                                       reps=RESIZE_TIMED))
                acc.append(times[len(times) // 2])
        log(f"[resize] resize_linear_u8 to scale {scale} ({len(files)} "
            f"fixtures, 853-1199 x 640-800): card = CPU bit for bit; ms per "
            f"image (median of {RESIZE_TIMED}) "
            + ", ".join(f"{m:.3f}" for m in ms) + "; the bilinear before it "
            + ", ".join(f"{m:.3f}" for m in old_ms) + f"  ({smi})")


def semi_config_for(tmp: Path) -> tuple[dict, dict]:
    """The flagship config with ``OVERRIDES`` on a synthetic semicoco
    directory (with a val set) in tmp."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.utils import synthetic_data

    files, _ = fixtures()
    paths = synthetic_data.make_semicoco_dir(
        tmp / "data", [(str(p), h, w) for _, p, h, w in files],
        SEMI_LABELED, SEMI_UNLABELED, n_val=SEMI_VAL)
    add_unreadable_unlabeled(paths, files[0][1])
    cfg = copy.deepcopy(Config.fromfile(str(CONFIG))._cfg_dict)
    for key, value in OVERRIDES.items():
        *parents, leaf = key.split(".")
        node = cfg
        for k in parents:
            node = node[k]
        node[leaf] = value
    return synthetic_data.semi_config(cfg, paths), paths


def add_unreadable_unlabeled(paths: dict, source: Path,
                             name: str = SEMI_UNREADABLE,
                             data: bytes | None = None):
    """A JPEG cut inside its header (``name``, the first 600 bytes of
    ``source``; or the bytes ``data``) in the unlabeled image directory and
    list, with the empty label file a bootstrap that found nothing in it
    writes. Its empty label keeps it out of the training set
    (``SemiCOCODataset`` drops an image without boxes, as the JAX package
    does, whose loader would raise on the file too); a refresh over it must
    skip it."""
    import json as _json

    if data is None:
        data = source.read_bytes()[:600]
    (Path(paths["images"]) / name).write_bytes(data)
    with open(paths["unlabeled"], encoding="utf-8") as f:
        listing = _json.load(f)
    listing["images"].append(dict(
        id=max(i["id"] for i in listing["images"]) + 1,
        file_name=name, width=640, height=480))
    with open(paths["unlabeled"], "w", encoding="utf-8") as f:
        _json.dump(listing, f)
    with open(Path(paths["unlabel_store"]) / f"{name}.json", "w",
              encoding="utf-8") as f:
        _json.dump(dict(imageName=f"full/{name}", targetNum=0,
                        rects=[], tags=[], masks=[]), f)


@contextlib.contextmanager
def counting_semi_loop():
    """Record, while the semi loop runs, the NMS launches of every train
    step, of every refresh chunk and of every evaluation (with the
    parameters each evaluation batch predicted with, and the state's
    teacher dict then), which label files the datasets read after each step
    count, and a host copy of the state at each checkpoint (the wrappers
    call the real code)."""
    import dsl_tpu_torch.apis.test as test_api
    import dsl_tpu_torch.apis.train as api
    import dsl_tpu_torch.train.runner as runner_mod
    from dsl_tpu_torch.data.datasets.semicoco import SemiCOCODataset
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.train.semi import PseudoLabelRefresher

    rec = dict(step_launches=[], chunk_launches=[], chunk_sizes=[], reads=[],
               saved={}, evals=[])
    real_make, real_chunk = api.make_train_step, PseudoLabelRefresher._predict_chunk
    real_read, real_save = SemiCOCODataset._read_store, runner_mod.save_checkpoint
    real_eval, real_predict = runner_mod.SemiRunner.evaluate, test_api.detector_predict
    eval_params = []

    def make_train_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def counted(state, batch, mark=None):
            before = nms_keep.launches
            metrics = step(state, batch, mark)
            rec["step_launches"].append(nms_keep.launches - before)
            return metrics

        return counted

    def predict_chunk(self, params, chunk):
        before = nms_keep.launches
        out = real_chunk(self, params, chunk)
        rec["chunk_launches"].append(nms_keep.launches - before)
        rec["chunk_sizes"].append(len(chunk))
        return out

    def read_store(self, filename):
        data = real_read(self, filename)
        rec["reads"].append((len(rec["step_launches"]), self.ann_path,
                             filename, "scores" in data))
        return data

    def save_checkpoint(path, state, meta=None):
        real_save(path, state, meta)
        rec["saved"][meta["epoch"]] = state_snapshot(state)

    def evaluate(self):
        before = nms_keep.launches
        eval_params.clear()
        metrics = real_eval(self)
        rec["evals"].append(dict(
            epoch=self.epoch + 1, launches=nms_keep.launches - before,
            batches=len(eval_params), metrics=metrics,
            on_teacher=bool(eval_params) and all(
                p is self.state.teacher_params for p in eval_params)))
        return metrics

    def eval_predict(*args, **kwargs):
        eval_params.append(kwargs.get("params"))
        return real_predict(*args, **kwargs)

    api.make_train_step = make_train_step
    PseudoLabelRefresher._predict_chunk = predict_chunk
    SemiCOCODataset._read_store = read_store
    runner_mod.save_checkpoint = save_checkpoint
    runner_mod.SemiRunner.evaluate = evaluate
    test_api.detector_predict = eval_predict
    try:
        yield rec
    finally:
        api.make_train_step = real_make
        PseudoLabelRefresher._predict_chunk = real_chunk
        SemiCOCODataset._read_store = real_read
        runner_mod.save_checkpoint = real_save
        runner_mod.SemiRunner.evaluate = real_eval
        test_api.detector_predict = real_predict


def state_snapshot(state) -> dict:
    """Every tensor and counter of a TrainState, on the host."""
    import torch

    opt = state.optimizer
    return dict(
        student={k: v.detach().cpu().clone()
                 for k, v in state.student.state_dict().items()},
        teacher={k: v.cpu().clone() for k, v in state.teacher_params.items()},
        momentum=[opt.state[p]["momentum_buffer"].cpu().clone()
                  if "momentum_buffer" in opt.state.get(p, {}) else None
                  for g in opt.param_groups for p in g["params"]],
        counters=(state.step, state.opt_count, float(state.ema_ratio),
                  state.ema_initialized))


def snapshots_equal(a: dict, b: dict) -> list[str]:
    import torch

    bad = [k for k in a["student"] if not torch.equal(a["student"][k],
                                                       b["student"][k])]
    bad += [k for k in a["teacher"] if not torch.equal(a["teacher"][k],
                                                       b["teacher"][k])]
    bad += [f"momentum {i}" for i, (x, y) in enumerate(zip(a["momentum"],
                                                           b["momentum"]))
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y))]
    if a["counters"] != b["counters"]:
        bad.append(f"counters {a['counters']} vs {b['counters']}")
    return bad


def phase_semi(variables, smi: str, tmp: Path):
    """The semi loop through ``train_detector`` at full width, with every
    kernel count at 0 before it and read after; its checks."""
    import json as _json

    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data.image_io import decode_jpeg
    from dsl_tpu_torch.ops.nms import nms_keep
    from torch_port_util import tree_of

    cfg, paths = semi_config_for(tmp)
    unl_store = Path(paths["unlabel_store"])
    before = tree_of(unl_store)
    pipes = {k: [t["type"] for t in cfg["data"][k]["pipeline"]]
             for k in ("train", "unlabel_train")}
    log(f"[semi] {CONFIG.relative_to(ROOT)} as written, overrides: "
        + ", ".join(f"{k} = {v}" for k, v in OVERRIDES.items())
        + "; data paths -> a synthetic semicoco directory")
    log(f"[semi] train pipeline {pipes['train']}; unlabel_train pipeline "
        f"{pipes['unlabel_train']}; evaluation {cfg['evaluation']}; "
        f"preload {cfg['data']['unlabel_pred']['preload']}, refresh_batch 8; "
        f"{SEMI_LABELED} labeled, {SEMI_UNLABELED} unlabeled and {SEMI_VAL} "
        f"val images (copies of the JPEG fixtures), full width, canvas "
        f"{CANVAS[0]}x{CANVAS[1]}, B=5 per step")
    nms_keep.launches = 0
    decode_jpeg.decodes = 0
    t0 = time.perf_counter()
    with counting_semi_loop() as rec:
        runner = train_detector(Config(cfg), str(tmp / "work"), seed=0,
                                device=DEVICE, variables=variables)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nms_keep.launches
    iters = len(runner.data_loader)
    eval_launches = sum(e["launches"] for e in rec["evals"])
    log(f"[semi] train_detector: {SEMI_EPOCHS} epochs of {iters} iterations in "
        f"{wall:.1f} s (set-up, first refresh and evaluations included); "
        f"{decode_jpeg.decodes} nvJPEG decodes; NMS launches {launches}: "
        f"{sum(rec['step_launches'])} in {len(rec['step_launches'])} train "
        f"steps, {sum(rec['chunk_launches'])} in {len(rec['chunk_launches'])} "
        f"refresh chunks of {rec['chunk_sizes']} images, {eval_launches} in "
        f"{len(rec['evals'])} evaluations of {SEMI_VAL} images")

    # losses finite, every step counted
    hist = runner.log_buffer.history
    if len(rec["step_launches"]) != SEMI_EPOCHS * iters:
        raise AssertionError(f"{len(rec['step_launches'])} steps")
    bad = [k for k, v in hist.items() if k.startswith("loss") or k == "grad_norm"
           if not all(bool(torch.isfinite(torch.as_tensor(x))) for x in v)]
    if bad:
        raise AssertionError(f"semi loop: not finite: {bad}")
    log("[semi] losses finite over all steps; last step: " + ", ".join(
        f"{k} {float(v[-1]):.4f}" for k, v in hist.items()
        if k.startswith("loss") or k == "grad_norm"))
    # NMS: once per refresh chunk and per evaluation batch, never in a
    # train step
    n_batches = -(-SEMI_VAL // BATCH_SIZE)
    if (any(rec["step_launches"]) or not rec["chunk_launches"]
            or any(n != 1 for n in rec["chunk_launches"])
            or any(e["launches"] != n_batches or e["batches"] != n_batches
                   for e in rec["evals"])
            or launches != len(rec["chunk_launches"]) + eval_launches):
        raise AssertionError(f"NMS launches: steps {rec['step_launches']}, "
                             f"chunks {rec['chunk_launches']}, evaluations "
                             f"{rec['evals']}, total {launches}")
    # evaluation after each epoch, on the teacher, mAP in train.log.json
    logged = [_json.loads(x) for x in (tmp / "work" / "train.log.json")
              .read_text().splitlines() if '"mode": "val"' in x]
    if ([e["epoch"] for e in rec["evals"]] != list(range(1, SEMI_EPOCHS + 1))
            or not all(e["on_teacher"] for e in rec["evals"])
            or [v["epoch"] for v in logged] != list(range(1, SEMI_EPOCHS + 1))
            or not all(0.0 <= v["bbox_mAP"] <= 1.0 for v in logged)):
        raise AssertionError(f"evaluation: {rec['evals']}; logged {logged}")
    for v in logged:
        log(f"[semi] evaluation after epoch {v['epoch']} on the teacher's "
            f"parameters ({n_batches} batches, one NMS launch each): "
            + ", ".join(f"{k} {v[k]}" for k in v if k.startswith("bbox")))
    # every unlabeled label file rewritten by the refresher, adathres written
    after = tree_of(unl_store)
    bad_label = f"{SEMI_UNREADABLE}.json"
    stale = [n for n in before if n != bad_label and (
        after[n] == before[n] or "scores" not in _json.loads(after[n]))]
    if stale or after[bad_label] != before[bad_label]:
        raise AssertionError(f"label files not rewritten: {stale}; the "
                             f"unreadable file's changed: "
                             f"{after[bad_label] != before[bad_label]}")
    with open(paths["adathres"], encoding="utf-8") as f:
        ada = _json.load(f)
    if not ada.get("thres"):
        raise AssertionError(f"adathres.json: {ada}")
    boxes = sum(_json.loads(v)["targetNum"] for v in after.values())
    log(f"[semi] all {len(after) - 1} readable unlabeled label files "
        f"rewritten ({boxes} boxes), {SEMI_UNREADABLE}'s (listed, cut inside "
        f"its header, label empty) unchanged; adathres.json: "
        f"{len(ada['thres'])} classes, thresholds "
        f"{sorted(round(v, 4) for v in ada['thres'].values())[:4]}...")
    # the second epoch's unlabeled dataset read the refreshed files
    late = [r for r in rec["reads"] if r[0] >= iters
            and r[1] == paths["unlabel_store"]]
    if not late or not all(r[3] for r in late):
        raise AssertionError(f"epoch 2 read {len(late)} unlabeled label "
                             f"files, {sum(r[3] for r in late)} refreshed")
    log(f"[semi] epoch 2 read {len(late)} unlabeled label files, all of them "
        f"written by the refresher")
    # resume from the epoch-1 checkpoint restores the state bit for bit
    cfg_resume = dict(cfg, runner=dict(cfg["runner"], max_epochs=1))
    resumed = train_detector(Config(cfg_resume), str(tmp / "resume"),
                             resume_from=str(tmp / "work" / "epoch_1.pth"),
                             seed=0, device=DEVICE, variables=variables)
    bad = snapshots_equal(rec["saved"][1], state_snapshot(resumed.state))
    if bad:
        raise AssertionError(f"resume differs in {len(bad)}: {bad[:3]}")
    log(f"[semi] resume_from epoch_1.pth: student, teacher, momentum, step "
        f"{resumed.state.step}, opt_count, ema_ratio, ema_initialized "
        f"bit-identical to the state saved")
    del resumed
    launches += refresh_skips_unreadable(runner, tmp, before)
    return runner, launches, cfg


def refresh_skips_unreadable(runner, tmp: Path, before: dict) -> int:
    """A full refresh of the unlabeled set and the unreadable file, into a
    copy of the store as it was before training: the file is dropped before
    the list is cut into chunks (one NMS launch per chunk of the readable
    files), its label file stays as it was, every other one is rewritten.
    Returns the NMS launches."""
    import json as _json
    import shutil

    import torch

    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.train.label_store import LabelStore
    from torch_port_util import tree_of

    ref = runner.refresher
    root = tmp / "store_skip"
    root.mkdir()
    for name, data in before.items():
        (root / name).write_bytes(data)
    skip = copy.copy(ref)
    skip.store = LabelStore(str(root), ref.store.id2cat, ref.store.cat2id)
    names = [i["filename"] for i in ref.image_infos]
    names.insert(len(names) // 2, SEMI_UNREADABLE)
    start = nms_keep.launches
    skip.refresh_images(runner.state, names)
    torch.cuda.synchronize()
    launches = nms_keep.launches - start
    after = tree_of(root)
    bad_label = f"{SEMI_UNREADABLE}.json"
    chunks = -(-(len(names) - 1) // ref.refresh_batch)
    stale = [n for n in after if n != bad_label
             and "scores" not in _json.loads(after[n])]
    if launches != chunks or stale or after[bad_label] != before[bad_label]:
        raise AssertionError(f"refresh over an unreadable file: {launches} "
                             f"NMS launches for {chunks} chunks, not "
                             f"rewritten {stale}")
    log(f"[semi] a full refresh of {len(names)} files, {SEMI_UNREADABLE} "
        f"among them: skipped before chunking ({chunks} chunks of "
        f"{ref.refresh_batch}, {launches} NMS launches), its label file "
        f"unchanged, the other {len(after) - 1} rewritten")
    shutil.rmtree(root)
    return launches


@contextlib.contextmanager
def recording_heads():
    """Record the head outputs each predict decodes (clones, on the stream
    that made them)."""
    import dsl_tpu_torch.models.detectors.single_stage as single_stage

    real = single_stage.fcos_get_bboxes
    outs = []

    def record(head, *heads, **kwargs):
        outs.append([t.clone() for lvl in heads for t in lvl])
        return real(head, *heads, **kwargs)

    single_stage.fcos_get_bboxes = record
    try:
        yield outs
    finally:
        single_stage.fcos_get_bboxes = real


def heads_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(
        torch.equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca, cb))


def heads_rel_diff(a, b) -> float:
    """max |a - b| / max |b| over recorded head outputs."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} predicts recorded")
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-12))
               for ca, cb in zip(a, b) for x, y in zip(ca, cb))


def refresh_store_pairs(a: Path, b: Path, names) -> tuple[int, int, float]:
    """Each file of ``names`` in store a against store b, paired by
    ``torch_port_util.pair_labels`` (tag, 1 px, 1e-3 in score): (boxes in
    a, boxes left unpaired, largest difference of a pair)."""
    import json as _json

    from torch_port_util import pair_labels

    n, unpaired, worst = 0, 0, 0.0
    for name in names:
        x = _json.loads((a / f"{name}.json").read_text())
        y = _json.loads((b / f"{name}.json").read_text())
        u, w = pair_labels(x, y)
        n, unpaired, worst = n + x["targetNum"], unpaired + u, max(worst, w)
    return n, unpaired, worst


def phase_semi_overlap_and_timing(runner, smi: str, tmp: Path):
    """On the trained state: one chunk refreshed on the side stream while a
    train step runs, against a synchronous refresh from the same teacher
    snapshot; then refresh img/s, the semi iteration against the bare step
    on one batch, and one profiler trace of an iteration."""
    import copy as _copy
    import shutil
    import types

    import torch

    from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size
    from dsl_tpu_torch.ops.nms import nms_keep_reference
    from dsl_tpu_torch.train.label_store import LabelStore
    from torch_port_util import tree_of

    ref = runner.refresher
    state, step = runner.state, runner.train_step
    batch = next(iter(runner.data_loader))
    batch.pop("meta")
    names = [i["filename"] for i in ref.image_infos[:ref.refresh_batch]]

    def refresher_into(dirname):
        root = tmp / dirname
        shutil.copytree(ref.store.root, root)
        r = _copy.copy(ref)
        r.store = LabelStore(str(root), ref.store.id2cat, ref.store.cat2id)
        return r, root

    overlapped, root_a = refresher_into("store_overlapped")
    synchronous, root_b = refresher_into("store_synchronous")
    again, root_c = refresher_into("store_synchronous_again")
    snapshot = types.SimpleNamespace(teacher_params=state.teacher_params,
                                     student=state.student)
    torch.cuda.synchronize()
    with recording_heads() as heads_o:
        complete = overlapped.dispatch_refresh(state, names)
        step(state, batch)
        complete()
    with recording_heads() as heads_1, recording_nms() as calls:
        synchronous.refresh_images(snapshot, names)
    with recording_heads() as heads_2:
        again.refresh_images(snapshot, names)
    torch.cuda.synchronize()
    # a race would show in the head outputs; where the forward is
    # deterministic (two synchronous refreshes bit-identical), the
    # overlapped one must be bit-identical too, down to the label files
    exact = heads_equal(heads_1, heads_2)
    diff = heads_rel_diff(heads_o, heads_1)
    same_files = tree_of(root_a) == tree_of(root_b)
    log(f"[semi] one chunk ({len(names)} images) refreshed on the side stream "
        f"during a train step vs a synchronous refresh from the same teacher "
        f"snapshot: head outputs max |diff| / max |ref| {diff:.3e}, label files "
        f"{'identical' if same_files else 'differ'}; two synchronous refreshes "
        f"{'bit-identical' if exact else 'differ'} (max |diff| / max |ref| "
        f"{heads_rel_diff(heads_2, heads_1):.3e})")
    n, unpaired, worst = refresh_store_pairs(root_a, root_b, names)
    n2, unpaired2, _ = refresh_store_pairs(root_c, root_b, names)
    log(f"[semi] label files paired by tag, 1 px and 1e-3 in score: "
        f"overlapped vs synchronous {unpaired} of {n} boxes unpaired (pairs "
        f"within {worst} px); synchronous vs synchronous {unpaired2} of {n2}")
    if exact and not (diff == 0 and same_files):
        raise AssertionError("the overlapped refresh differs from a "
                             "deterministic synchronous refresh")
    if diff > 1e-4:
        raise AssertionError(f"overlapped refresh head outputs {diff}")
    keep_err = 0
    for boxes, valid, thr, keep in calls:
        want = nms_keep_reference(boxes, valid, thr)
        torch.cuda.synchronize()
        keep_err = max(keep_err, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError(f"refresh NMS keeps differ from the plain "
                                 f"version at {tuple(boxes.shape)}")
        log(f"[semi] refresh NMS input {tuple(boxes.shape)}: {int(valid.sum())} "
            f"valid, {int(keep.sum())} kept — bit-identical to the plain version")

    # host syncs inside a dispatch (torch's sync debug mode)
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            done = synchronous.dispatch_refresh(snapshot, names[:1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        done()
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if SYNC_WARNING in str(w.message)]
    log(f"[semi] torch-level synchronizing calls in one refresh dispatch "
        f"(sync debug mode): {len(syncs)} {syncs}")

    # refresh img/s at refresh_batch
    def refresh():
        synchronous.refresh_images(snapshot, names)

    times = sorted(host_ms(refresh, reps=5, warmup=1))
    ms = times[len(times) // 2]
    log(f"[time] refresh of {len(names)} images (decode, resize, predict f32 "
        f"at B={ref.refresh_batch}, NMS, store write): median {ms:.2f} ms "
        f"(min {times[0]:.2f}, max {times[-1]:.2f}, 5 reps), "
        f"{len(names) / ms * 1e3:.1f} img/s  ({smi})")

    # a refresh of the whole set reads one chunk of images at a time: its
    # peak device memory is one chunk's within less than one image
    every = [i["filename"] for i in ref.image_infos]
    one_image = min(3 * h * w for h, w in (
        keep_ratio_size(i["height"], i["width"], ref.img_scale)
        for i in ref.image_infos))
    peaks = {}
    for n in (len(names), len(every)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        synchronous.refresh_images(snapshot, every[:n])
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base
    log("[semi] peak device memory of a refresh above its start: "
        + ", ".join(f"{n} images {v / 2**20:.2f} MiB" for n, v in peaks.items())
        + f"; one resized image {one_image / 2**20:.2f} MiB")
    if peaks[len(every)] - peaks[len(names)] >= one_image:
        raise AssertionError(f"a refresh of {len(every)} images holds more "
                             f"than one chunk on the device: {peaks}")

    # the semi iteration (step + complete + dispatch) against the bare step
    upcoming = [i["filename"] for i in ref.image_infos] * 2
    pending = [None]

    def iteration(it):
        step(state, batch)
        if pending[0] is not None:
            pending[0]()
        pending[0] = ref.dispatch_after_train_iter(
            state, SEMI_START, upcoming, it % SEMI_UNLABELED, 2)

    def run(fn, n):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        for it in range(n):
            fn(it)
            marks.append(time.perf_counter())
        if pending[0] is not None:
            pending[0]()
            pending[0] = None
        torch.cuda.synchronize()
        total = (time.perf_counter() - marks[0]) * 1e3
        per = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
        return per[len(per) // 2], total / n

    # the loader with the flagship's pipelines: decode, Resize,
    # PatchShuffle, RandomFlip, RandomAugmentBBox_Fast, UBAug, Normalize,
    # Pad and the batch, on the main stream
    def batches():
        epoch = 0
        while True:
            runner.data_loader.set_epoch(epoch)
            for b in runner.data_loader:
                b.pop("meta")
                yield b
            epoch += 1

    stream = batches()
    loader_ms = sorted(host_ms(lambda: next(stream), reps=SEMI_TIMED_ITERS))
    log(f"[time] loader, one batch of 2 labeled + 2 unlabeled images and the "
        f"half-res copy through the flagship's pipelines (host clock to a "
        f"synchronize): median {loader_ms[len(loader_ms) // 2]:.2f} ms (min "
        f"{loader_ms[0]:.2f}, max {loader_ms[-1]:.2f}, {SEMI_TIMED_ITERS} "
        f"batches)  ({smi})")

    def loader_iteration(it):
        step(state, next(stream))
        if pending[0] is not None:
            pending[0]()
        pending[0] = ref.dispatch_after_train_iter(
            state, SEMI_START, upcoming, it % SEMI_UNLABELED, 2)

    for _ in range(2):
        iteration(0)
    semi_med, semi_mean = run(iteration, SEMI_TIMED_ITERS)
    real_med, real_mean = run(loader_iteration, SEMI_TIMED_ITERS)
    bare_med, bare_mean = run(lambda it: step(state, batch), SEMI_TIMED_ITERS)
    log(f"[time] semi iteration (step + complete + dispatch of one image's "
        f"refresh at B={ref.refresh_batch}), f32: with a fixed batch median "
        f"{semi_med:.2f} ms, mean {semi_mean:.2f} ms; with the loader's next "
        f"batch each iteration median {real_med:.2f} ms, mean "
        f"{real_mean:.2f} ms; over {SEMI_TIMED_ITERS}; bare step on the fixed "
        f"batch: median {bare_med:.2f} ms, mean {bare_mean:.2f} ms; ratio "
        f"{semi_mean / bare_mean:.3f}  ({smi})")
    traced = device_busy(lambda: (iteration(0), pending[0]()))
    pending[0] = None
    if traced is None:
        log("[trace] semi iteration: device idle share not measured (the "
            "profiler saw no device event)")
    else:
        busy, window, n_kernels, top = traced
        log(f"[trace] semi iteration: {n_kernels} kernels, device busy "
            f"{busy:.2f} ms of a {window:.2f} ms window, idle share "
            f"{1 - busy / window:.3f}  ({smi})")
        for kname, us in top[:5]:
            log(f"[trace]   {us / 1e3:8.3f} ms  {kname[:100]}")
    return keep_err

# -- strong augmentations (phase 9) and evaluation (phase 11) -----------------

STRONG_RUNS = 16              # seeded runs of each transform, card vs CPU
STRONG_TIMED = 10             # images timed per transform
STRONG_TRANSFORMS = (         # as the flagship config writes them
    dict(type="PatchShuffle", ratio=0.5, ranges=[0.0, 1.0],
         mode=["flip", "flop"]),
    dict(type="RandomAugmentBBox_Fast", aug_type="affine"),
    dict(type="RandomAugmentBBox", aug_type="strong"),
    dict(type="UBAug"),
)


def strong_aug_inputs() -> list[dict]:
    """The fixtures' committed decodes on the card, resized by the
    flagship's ``Resize`` to each of its two scales, with 4 seeded GT boxes
    (labels 0-3) and 2 ignore boxes: the results as ``PatchShuffle`` gets
    them."""
    import numpy as np
    import torch

    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
    from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size

    files, decodes = fixtures()
    out = []
    for scale in ((1333, 640), (1333, 800)):
        for i, (name, _, h, w) in enumerate(files):
            nh, nw = keep_ratio_size(h, w, scale)
            img = resize_linear_u8(torch.from_numpy(decodes[name]).to(DEVICE),
                                   nh, nw)
            rng = np.random.RandomState(i)
            x1, y1 = rng.uniform(0, nw * 0.7, 6), rng.uniform(0, nh * 0.7, 6)
            boxes = np.stack([x1, y1, x1 + rng.uniform(8, nw * 0.3, 6),
                              y1 + rng.uniform(8, nh * 0.3, 6)], 1)
            boxes = boxes.astype(np.float32)
            out.append(dict(img=img, gt_bboxes=boxes[:4],
                            gt_bboxes_ignore=boxes[4:], gt_labels=np.arange(4),
                            img_fields=["img"],
                            bbox_fields=["gt_bboxes", "gt_bboxes_ignore"]))
    torch.cuda.synchronize()
    return out


def _fresh(results: dict, device=None) -> dict:
    """A copy of ``results`` (host arrays and lists copied, the image shared
    or copied to ``device``)."""
    import numpy as np

    out = {k: (v.copy() if isinstance(v, (np.ndarray, list)) else v)
           for k, v in results.items()}
    if device is not None:
        out["img"] = results["img"].to(device)
    return out


def phase_strong_aug(smi: str) -> dict:
    """Each strong augmentation on the card and on the CPU from the same
    seeds (bit-identical images, equal boxes), then its time, kernels and
    host syncs per image on the card."""
    from dsl_tpu_torch.registry import PIPELINES, build_from_cfg

    inputs = strong_aug_inputs()
    sizes = sorted({tuple(r["img"].shape[:2]) for r in inputs})
    log(f"[strong] inputs: the {len(inputs) // 2} fixtures at the flagship's "
        f"Resize scales (1333, 640) and (1333, 800): {sizes}")
    out = {}
    for cfg in STRONG_TRANSFORMS:
        t = build_from_cfg(dict(cfg), PIPELINES)
        out[cfg["type"] + ("_" + cfg["aug_type"] if "aug_type" in cfg else "")] = (
            transform_on_card(t, cfg, inputs, "[strong]", smi))
    return out


def transform_on_card(t, cfg: dict, inputs: list, tag: str, smi: str):
    """A transform on the card and on the CPU from ``STRONG_RUNS`` seeds
    (bit-identical images, equal boxes and labels, a ``None`` from both
    alike), then its time (median of ``STRONG_TIMED`` images, each to a
    synchronize), kernels from one trace and host syncs per image (torch's
    sync debug mode); fails on a difference or a sync. Returns (ms,
    kernels, syncs per image)."""
    import random
    import warnings

    import numpy as np
    import torch

    label = ", ".join(f"{k}={v}" for k, v in cfg.items() if k != "type")
    label = f"{cfg['type']}({label})"
    moved = 0
    for seed in range(STRONG_RUNS):
        src = inputs[seed % len(inputs)]
        card = t(_fresh(src), np.random.RandomState(seed),
                 random.Random(seed))
        cpu = t(_fresh(src, "cpu"), np.random.RandomState(seed),
                random.Random(seed))
        if (card is None) != (cpu is None):
            raise AssertionError(f"{label}, seed {seed}: None on one side")
        if card is None:
            continue
        got = card["img"].cpu()
        if got.shape != cpu["img"].shape or not torch.equal(got, cpu["img"]):
            diff = (got.double() - cpu["img"].double()).abs() if (
                got.shape == cpu["img"].shape) else None
            raise AssertionError(
                f"{label}, seed {seed}: card and CPU images differ"
                + (f" in {int((diff > 0).sum())} values, max {float(diff.max())}"
                   if diff is not None else f": {tuple(got.shape)} vs "
                   f"{tuple(cpu['img'].shape)}"))
        for key in ("gt_bboxes", "gt_bboxes_ignore", "gt_labels"):
            if not np.array_equal(card[key], cpu[key]):
                raise AssertionError(f"{label}, seed {seed}: {key} differ")
        moved += got.shape != src["img"].shape or not torch.equal(
            got, src["img"].cpu())

    def one(i, t=t):
        t(_fresh(inputs[i % len(inputs)]), np.random.RandomState(1000 + i),
          random.Random(1000 + i))

    times = []
    for i in range(STRONG_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(STRONG_TIMED):
                one(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if SYNC_WARNING in str(w.message)]
    traced = device_ops(lambda: [one(i) for i in range(STRONG_TIMED)])
    kernels = copies = None
    if traced is not None:
        kernels, copies = (n / STRONG_TIMED for n in traced)
    log(f"{tag} {label}: card = CPU bit for bit on {STRONG_RUNS} seeded "
        f"runs ({moved} changed the image), boxes and labels equal; "
        f"{times[len(times) // 2]:.3f} ms per image (median of "
        f"{STRONG_TIMED}, min {times[0]:.3f}, max {times[-1]:.3f}); "
        + (f"{kernels:.1f} kernels and {copies:.2f} copies or sets per "
           f"image" if kernels is not None
           else "kernels not measured (the profiler saw no device event)")
        + f"; {len(syncs) / STRONG_TIMED:.2f} host syncs per image  ({smi})")
    if syncs:
        raise AssertionError(f"{label}: host syncs {syncs[:5]}")
    return times[len(times) // 2], kernels, len(syncs) / STRONG_TIMED


def phase_eval(runner, cfg: dict, smi: str) -> tuple[int, float]:
    """``single_device_test`` over the val set on the teacher, counted; its
    detections against ``detector_predict`` on the same batches; its
    img/s; the GT as detections."""
    import random

    import numpy as np
    import torch

    import dsl_tpu_torch.apis.test as test_api
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.apis.train import build_dataset
    from dsl_tpu_torch.data.pipelines import test_pipeline_params
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    val = build_dataset({**cfg["data"]["val"], "test_mode": True}, DEVICE,
                        np.random.RandomState(0), random.Random(0))
    tp = test_pipeline_params(cfg["data"]["val"]["pipeline"])
    det, params = runner.refresher.detector, runner.state.teacher_params
    args = dict(test_cfg=dict(cfg["model"]["test_cfg"]), canvas_hw=CANVAS,
                img_scale=tp["img_scale"], img_norm=tp["img_norm"],
                device=DEVICE)
    calls = []
    real = test_api.detector_predict

    def record(detector, images, **kwargs):
        out = real(detector, images, **kwargs)
        calls.append((images.clone(), kwargs, [t.clone() for t in out]))
        return out

    nms_keep.launches = 0
    test_api.detector_predict = record
    with recording_nms() as nms_calls:
        metrics, results = test_api.single_device_test(
            det, params, val, return_results=True, **args)
        torch.cuda.synchronize()
    test_api.detector_predict = real
    launches = nms_keep.launches
    n_batches = -(-len(val) // BATCH_SIZE)
    if launches != n_batches or len(calls) != n_batches or len(results) != len(val):
        raise AssertionError(f"evaluation: {launches} NMS launches, "
                             f"{len(calls)} predicts, {len(results)} results "
                             f"for {len(val)} images")
    keep_err = 0
    for boxes, valid, thr, keep in nms_calls:
        want = nms_keep_reference(boxes, valid, thr)
        keep_err = max(keep_err, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError("evaluation NMS keeps differ from the plain "
                                 "version")
    # the same batches through detector_predict directly
    worst_box, worst_score, n_dets, row = 0.0, 0.0, 0, 0
    for images, kwargs, _ in calls:
        dets, labels, valid = (t.cpu().numpy() for t in detector_predict(
            det, images, **kwargs))
        for bi in range(len(dets)):
            got_d, got_l = results[row]
            m = valid[bi]
            if not (np.array_equal(got_l, labels[bi][m])
                    and got_d.shape == dets[bi][m].shape
                    and np.isfinite(got_d).all()):
                raise AssertionError(f"evaluation image {row}: detections "
                                     f"differ from detector_predict's")
            want = dets[bi][m]
            scale = np.maximum(np.abs(want[:, :4]), 1.0)
            worst_box = max(worst_box, float((np.abs(got_d[:, :4] - want[:, :4])
                                              / scale).max(initial=0)))
            worst_score = max(worst_score, float(np.abs(
                got_d[:, 4] - want[:, 4]).max(initial=0)))
            n_dets += len(want)
            row += 1
    if worst_box > 1e-3 or worst_score > 1e-4:
        raise AssertionError(f"evaluation vs detector_predict: boxes "
                             f"{worst_box}, scores {worst_score}")
    if not all(np.isfinite(v) and -1 <= v <= 1 for v in metrics.values()):
        raise AssertionError(f"evaluation metrics {metrics}")
    log(f"[eval] single_device_test over {len(val)} val images at full width, "
        f"f32, on the teacher: {n_batches} batches, NMS launches {launches} "
        f"(keeps = the plain version's); {n_dets} detections, equal to "
        f"detector_predict's on the same batches (boxes within "
        f"{worst_box:.2e} relative, scores {worst_score:.2e}); {metrics}")
    # the GT fed back as detections
    gt = []
    for i in range(len(val)):
        ann = val.get_ann_info(i)
        gt.append((np.concatenate([ann["bboxes"], np.ones(
            (len(ann["bboxes"]), 1), np.float32)], 1), ann["labels"]))
    gt_metrics = val.evaluate(gt, verbose=False)
    if gt_metrics["bbox_mAP"] != 1.0:
        raise AssertionError(f"the GT as detections: {gt_metrics}")
    log(f"[eval] the val GT fed back as detections: bbox_mAP "
        f"{gt_metrics['bbox_mAP']}, bbox_mAP_50 {gt_metrics['bbox_mAP_50']}")
    times = sorted(host_ms(lambda: test_api.single_device_test(
        det, params, val, evaluate=False, **args), reps=3, warmup=1))
    ms = times[1]
    log(f"[time] single_device_test (nvJPEG, resize, canvas, f32 predict at "
        f"B<={BATCH_SIZE}, NMS, host copies) over {len(val)} images: median "
        f"{ms:.2f} ms of 3, {len(val) / ms * 1e3:.1f} img/s  ({smi})")
    return launches, keep_err


# -- weights in, and DSL's first step (phases 12, 13) ------------------------

def predict_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_weights(cfg, variables, runner, semi_cfg: dict, tmp: Path,
                  smi: str) -> int:
    """With the counts at 0: the flagship saved by ``save_weights`` and
    served by ``init_detector(checkpoint=)``; the semi run's epoch-2
    checkpoint served as its EMA teacher; an mmdet-layout ``.pth`` of the
    seeded weights loaded by ``load_from``'s loader and served. Each
    predict at B=8 bit-identical to the in-memory model's. Returns the
    NMS launches."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import build_detector, detector_predict
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.checkpoint import save_weights
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict
    from dsl_tpu_torch.utils.torch_import import load_torch_detector

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    nms_keep.launches = 0
    memory = init_detector(cfg, variables=variables, device=DEVICE).detector
    want = detector_predict(memory, images, device=DEVICE)
    path = tmp / "flagship_weights.pth"
    save_weights(str(path), memory)
    served = init_detector(cfg, checkpoint=str(path), device=DEVICE).detector
    if not predict_equal(detector_predict(served, images, device=DEVICE),
                         want):
        raise AssertionError("a weights file served: dets differ")
    log(f"[weights] save_weights -> init_detector(checkpoint=): dets at "
        f"B={BATCH} bit-identical to the in-memory model's "
        f"({path.stat().st_size / 2**20:.1f} MiB)")
    del served

    ckpt_path = tmp / "work" / "epoch_2.pth"
    ckpt = torch.load(ckpt_path, map_location=DEVICE, weights_only=True)
    teacher = detector_predict(runner.state.student, images, device=DEVICE,
                               params=ckpt["teacher_params"])
    served = init_detector(Config(semi_cfg), checkpoint=str(ckpt_path),
                           device=DEVICE).detector
    if not predict_equal(detector_predict(served, images, device=DEVICE),
                         teacher):
        raise AssertionError("the epoch-2 checkpoint served: dets differ "
                             "from detector_predict with its teacher")
    log(f"[weights] init_detector on the semi run's epoch_2.pth serves its EMA "
        f"teacher: dets at B={BATCH} bit-identical to detector_predict with "
        f"the checkpoint's teacher_params")
    del served, ckpt

    sd = flax_to_state_dict(variables)
    mmdet = tmp / "flagship_mmdet.pth"
    torch.save({"meta": {"epoch": 28}, "state_dict": {
        f"module.{k}": v for k, v in sd.items()}}, mmdet)
    det = build_detector(dict(cfg.model))
    det.init_weights(torch.Generator().manual_seed(1))
    missing, unexpected = load_torch_detector(str(mmdet), det)
    bad = [k for k, v in det.state_dict().items() if not torch.equal(v, sd[k])]
    if missing or unexpected or bad:
        raise AssertionError(f"mmdet .pth as load_from: missing {missing[:3]}, "
                             f"unexpected {unexpected[:3]}, differ {bad[:3]}")
    served = init_detector(cfg, checkpoint=str(mmdet), device=DEVICE).detector
    if not predict_equal(detector_predict(served, images, device=DEVICE),
                         want):
        raise AssertionError("an mmdet .pth served: dets differ")
    torch.cuda.synchronize()
    launches = nms_keep.launches
    if launches != 5:
        raise AssertionError(f"weights phase: {launches} NMS launches for 5 "
                             f"predicts")
    log(f"[weights] an mmdet-layout .pth of the seeded weights (state_dict "
        f"with module. prefixes, meta): load_from's loader sets all "
        f"{len(sd)} tensors to the file's; served, dets bit-identical; NMS "
        f"launches {launches} (one per predict)  ({smi})")
    return launches


BASELINE_CONFIG = (ROOT / "configs" / "fcos_semi"
                   / "r50_caffe_mslonger_tricks_0.Xdata.py")
BASELINE_LABELED, BASELINE_UNLABELED, BASELINE_VAL = 8, 8, 12
BASELINE_EPOCHS = 1
BASELINE_TIMED = 5


def run_module(module: str, args: list[str], timeout: int = 600,
               tag: str = "baseline", launcher: list[str] | None = None
               ) -> tuple[int, list[str]]:
    """``python -m module args`` in a subprocess (``runpy`` with
    ``run_name='__main__'``, as ``-m`` runs it), or under ``launcher``
    (``torch.distributed.run``'s arguments: the module then runs in the
    process it starts), its last lines printed here; returns the NMS
    launches it made and its output's lines."""
    code = ("import runpy, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from dsl_tpu_torch.ops.nms import nms_keep\n"
            f"sys.argv = {[module, *args]!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
            "print('NMS_LAUNCHES', nms_keep.launches)\n")
    with tempfile.TemporaryDirectory(prefix="_smoke_launch_", dir=ROOT) as tmp:
        if launcher is None:
            command = [sys.executable, "-c", code]
        else:
            script = Path(tmp) / "run.py"
            script.write_text(code)
            command = [sys.executable, "-m", "torch.distributed.run", *launcher,
                       str(script)]
        proc = subprocess.run(command, cwd=ROOT, text=True,
                              capture_output=True, timeout=timeout)
    for line in proc.stdout.splitlines()[-6:]:
        log(f"[{tag}]   | {line[:160]}")
    if proc.returncode != 0:
        raise RuntimeError(f"python -m {module} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return (int(proc.stdout.split("NMS_LAUNCHES")[-1].split()[0]),
            proc.stdout.splitlines())


def run_test_cli(args: list[str], tag: str) -> tuple[int, list[str]]:
    """The test CLI (``dsl_tpu_torch.tools.test.main``) on ``args`` and
    ``--device DEVICE`` in this process, its last lines printed here;
    returns the NMS launches it made and its output's lines, as
    :func:`run_module` does without a process start."""
    import io

    import torch

    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.tools import test as test_cli

    before = nms_keep.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_cli.main([*args, "--device", DEVICE])
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    for line in lines[-6:]:
        log(f"[{tag}]   | {line[:160]}")
    return nms_keep.launches - before, lines


def phase_baseline(tmp: Path, smi: str) -> tuple[int, dict]:
    """DSL's first step at full width: the baseline config trained by the
    train CLI for ``BASELINE_EPOCHS`` epochs (student evaluated after each), its unlabeled
    split's detections written by the test CLI with ``--format-only``,
    turned into label files by ``tools/generate_unlabel_annos_coco.py``,
    read by the port's ``SemiCOCODataset``; then the baseline's step timed
    in this process. Returns the NMS launches and what phase 15 reruns
    under a launcher (the CLI's options, its work dir, the last
    evaluation's ``bbox_mAP``, its step ms)."""
    import json as _json
    import random

    import numpy as np
    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.apis.train import build_dataset, deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.utils import synthetic_data
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
    from dsl_tpu_torch.utils.random_weights import fill_variables
    from torch_port_util import usable_boxes

    t_phase = time.perf_counter()
    files, _ = fixtures()
    paths = synthetic_data.make_semicoco_dir(
        tmp / "baseline_data", [(str(p), h, w) for _, p, h, w in files],
        BASELINE_LABELED, BASELINE_UNLABELED, n_val=BASELINE_VAL)
    cfg = Config.fromfile(str(BASELINE_CONFIG))
    # seeded weights: the caffe ResNet-50 as the pretrained backbone file
    # (mmdet's layout), the neck and head (classes that score) as load_from
    sd = flax_to_state_dict(fill_variables(state_dict_to_flax(
        empty_detector(dict(cfg.model)).state_dict())))
    pretrained, load_from = tmp / "r50_caffe_seeded.pth", tmp / "neck_head.pth"
    torch.save({k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}, pretrained)
    torch.save({"state_dict": {k: v for k, v in sd.items()
                               if not k.startswith("backbone.")}}, load_from)
    data = {"data.train.ann_file": paths["labeled"],
            "data.train.ann_path": paths["label_store"],
            "data.train.labelmapper": paths["category_info"],
            "data.train.img_prefix": paths["images"],
            "data.val.ann_file": paths["val"],
            "data.val.img_prefix": paths["val_images"],
            "data.test.ann_file": paths["val"],
            "data.test.img_prefix": paths["val_images"]}
    overrides = {"runner.max_epochs": BASELINE_EPOCHS, "evaluation.interval": 1,
                 "log_config.interval": 1,
                 "model.backbone.pretrained": str(pretrained),
                 "load_from": str(load_from)}
    options = [f"{k}={v}" for k, v in {**overrides, **data}.items()]
    log(f"[baseline] {os.path.relpath(BASELINE_CONFIG, ROOT)}: caffe ResNet-50 "
        f"FCOS at full width, overrides " + ", ".join(
            f"{k} = {v}" for k, v in overrides.items()) + f", data paths -> "
        f"a synthetic semicoco directory ({BASELINE_LABELED} labeled, "
        f"{BASELINE_UNLABELED} unlabeled, {BASELINE_VAL} val)")

    work = tmp / "baseline_work"
    t0 = time.perf_counter()
    train_launches, _ = run_module("dsl_tpu_torch.tools.train", [
        str(BASELINE_CONFIG), "--work-dir", str(work), "--device", DEVICE,
        "--cfg-options", *options])
    train_s = time.perf_counter() - t0
    lines = [_json.loads(x) for x in (work / "train.log.json").read_text()
             .splitlines()]
    train = [x for x in lines if x["mode"] == "train"]
    val = [x for x in lines if x["mode"] == "val"]
    iters = BASELINE_LABELED // 2
    n_batches = -(-BASELINE_VAL // BATCH_SIZE)
    if (len(train) != BASELINE_EPOCHS * iters
            or not all(np.isfinite(x["loss"]) for x in train)
            or [v["epoch"] for v in val] != list(range(1, BASELINE_EPOCHS + 1))
            or not all(np.isfinite(v["bbox_mAP"]) and 0 <= v["bbox_mAP"] <= 1
                       for v in val)
            or train_launches != BASELINE_EPOCHS * n_batches):
        raise AssertionError(f"baseline training: {len(train)} logged "
                             f"steps, evaluations {val}, NMS launches "
                             f"{train_launches}")
    log(f"[baseline] python -m dsl_tpu_torch.tools.train: {BASELINE_EPOCHS} "
        f"epochs of {iters} iterations in {train_s:.1f} s (process start and "
        f"set-up included); losses finite, last {train[-1]['loss']:.4f}; "
        f"the student evaluated after each epoch: " + "; ".join(
            f"epoch {v['epoch']} bbox_mAP {v['bbox_mAP']}" for v in val)
        + f"; NMS launches {train_launches} ({n_batches} per evaluation)")

    # the EMA teacher (--ema): 8 steps from seeded weights leave the
    # student's scores under score_thr, the teacher keeps the seeded head
    out = tmp / "unlabeled.bbox.json"
    t0 = time.perf_counter()
    test_launches, _ = run_test_cli([
        str(BASELINE_CONFIG), str(work / f"epoch_{BASELINE_EPOCHS}.pth"),
        "--format-only", "--ema", "--out", str(out), "--cfg-options", *options,
        f"data.test.ann_file={paths['unlabeled']}",
        f"data.test.img_prefix={paths['images']}"], tag="baseline")
    test_s = time.perf_counter() - t0
    dets = _json.loads(out.read_text())
    want_batches = -(-BASELINE_UNLABELED // BATCH_SIZE)
    if not dets or test_launches != want_batches:
        raise AssertionError(f"--format-only: {len(dets)} detections, "
                             f"{test_launches} NMS launches")
    log(f"[baseline] the test CLI --format-only --ema on the "
        f"{BASELINE_UNLABELED} unlabeled images: {len(dets)} detections in "
        f"{out.name} ({test_s:.1f} s); NMS launches {test_launches} (one per "
        f"batch of {BATCH_SIZE})")

    store = tmp / "bootstrap_labels"
    proc = subprocess.run(
        [sys.executable, "tools/generate_unlabel_annos_coco.py", "--det-file",
         str(out), "--cat-info", paths["category_info"], "--unlabeled-list",
         paths["unlabeled"], "--out-dir", str(store)],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    log(f"[baseline] tools/generate_unlabel_annos_coco.py: "
        f"{proc.stdout.strip()}")
    ds = build_dataset(dict(
        type="SemiCOCODataset", ann_file=paths["unlabeled"],
        ann_path=str(store), labelmapper=paths["category_info"],
        img_prefix=paths["images"],
        pipeline=[dict(type="LoadImageFromFile"),
                  dict(type="LoadAnnotations", with_bbox=True)]),
        DEVICE, np.random.RandomState(0), random.Random(0))
    counts = []
    for i in range(len(ds)):
        info = ds.data_infos[i]
        label = _json.loads((store / f"{info['filename']}.json").read_text())
        got = len(ds[i]["gt_bboxes"])
        want = len(usable_boxes(label["rects"], info["height"],
                                info["width"]))
        if got != want or not got:
            raise AssertionError(f"SemiCOCODataset read {got} boxes of the "
                                 f"file's {want} usable ones")
        counts.append((got, label["targetNum"]))
    if not counts:
        raise AssertionError("SemiCOCODataset kept no pseudo-labelled image")
    log(f"[baseline] the port's SemiCOCODataset reads the pseudo-labels: "
        f"{len(ds)} images, (boxes read, boxes in the file) {counts} (it "
        f"drops a box under 1 px or outside the image, as the JAX package)")

    # the baseline's step on its own loader's batch, in this process
    cfg.merge_from_dict({**data, "runner.max_epochs": 0,
                         "model.backbone.pretrained": str(pretrained),
                         "load_from": str(load_from)})
    runner = train_detector(cfg, str(tmp / "baseline_step"), device=DEVICE)
    batch = next(iter(runner.data_loader))
    batch.pop("meta", None)
    n_img = batch["images"].shape[0]
    with deterministic_cudnn():              # as the runner steps
        times = sorted(host_ms(
            lambda: runner.train_step(runner.state, batch),
            reps=BASELINE_TIMED, warmup=3))
    ms = times[len(times) // 2]
    log(f"[time] baseline train step f32 B={n_img} at "
        f"{tuple(batch['images'].shape[2:])}: median {ms:.2f} ms (min "
        f"{times[0]:.2f}, max {times[-1]:.2f}, {BASELINE_TIMED} steps), "
        f"{n_img / ms * 1e3:.2f} img/s; phase 13 wall "
        f"{time.perf_counter() - t_phase:.1f} s  ({smi})")
    return train_launches + test_launches, dict(
        options=options, work=work, mAP=val[-1]["bbox_mAP"], step_ms=ms,
        iter_times=[x["time"] for x in train])


# -- DSL's VOC protocol and test-time augmentation (phase 14) ----------------

VOC_CONFIG = ROOT / "configs" / "fcos_semi" / "voc" / "RLA_r50_fcos_semi_voc.py"
VOC_TRAINVAL, VOC_TEST, VOC_UNLABELED = 8, 12, 16
# the VOC config's only overrides besides its data paths: its schedule
VOC_OVERRIDES = {"runner.max_epochs": 2, "data.unlabel_pred.start_point": 1}
TTA_SCALES = ((1333, 800),)


def voc_cli_options(pipeline, **data) -> list[str]:
    """``--cfg-options`` that point ``data.test`` at a dataset (the VOC
    config's test block names no pipeline: it gets the config's own)."""
    return [f"data.test.{k}={v}" for k, v in data.items()] + [
        f"data.test.pipeline={pipeline!r}"]


def dets_banded(got, want, top: int = 20) -> tuple[int, float, float]:
    """The ``top`` highest-scoring detections of ``got`` (dets, labels) each
    paired with one of ``want``'s of its label, boxes within 0.5 px and
    scores within 1e-3; returns (pairs, worst box, worst score)."""
    import numpy as np

    gd, gl = got
    wd, wl = want
    free = list(range(len(wd)))
    worst_box = worst_score = 0.0
    order = np.argsort(-gd[:, 4], kind="stable")[:top]
    for i in order:
        match = [j for j in free if wl[j] == gl[i]
                 and np.abs(wd[j, :4] - gd[i, :4]).max() <= 0.5
                 and abs(wd[j, 4] - gd[i, 4]) <= 1e-3]
        if not match:
            raise AssertionError(f"card detection {gd[i]} (label {gl[i]}) "
                                 f"has no CPU counterpart")
        free.remove(match[0])
        worst_box = max(worst_box, float(np.abs(wd[match[0], :4] - gd[i, :4]).max()))
        worst_score = max(worst_score, float(abs(wd[match[0], 4] - gd[i, 4])))
    return len(order), worst_box, worst_score


def phase_voc(tmp: Path, smi: str) -> tuple[int, int]:
    """DSL's VOC workflow at full width (20 classes): a synthetic VOC2007
    directory, the converter, the pseudo-labels from the test CLI's
    ``--format-only`` on the unlabeled ``SemiVOCDataset`` and
    ``tools/generate_unlabel_annos_voc.py``, two epochs of
    ``train_detector`` on the VOC config with ``Voc2CocoDataset``
    evaluation, VOC 11-point mAP and COCO mAP through the test CLI, then
    ``tta_test`` and ``tta_test_dense`` on the teacher. The NMS count is
    set to 0 before each step and read after it. Returns the NMS launches
    and the worst keep difference from the plain version."""
    import random

    import numpy as np
    import torch

    import dsl_tpu_torch.apis.test as test_api
    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE, normalize_pad
    from dsl_tpu_torch.apis.train import build_dataset
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data.image_io import read_image
    from dsl_tpu_torch.data.pipelines import test_pipeline_params
    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_u8
    from dsl_tpu_torch.data.pipelines.transforms import keep_ratio_size
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.utils import synthetic_data
    from dsl_tpu_torch.utils.checkpoint import save_weights
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict
    from torch_port_util import tree_of

    t_phase = time.perf_counter()
    files, _ = fixtures()
    sources = [(str(p), h, w) for _, p, h, w in files]
    root = tmp / "semivoc"
    launches = 0

    # 1. data: VOC2007 -> the converter -> DSL's layout, plus the unlabeled
    voc = synthetic_data.make_voc_dir(root, sources, VOC_TRAINVAL, VOC_TEST)
    proc = subprocess.run(
        [sys.executable, "tools/voc_convert2_semivoc_json.py", "--voc-root",
         voc["voc_root"], "--split", voc["trainval"], "--output", str(root)],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    paths = synthetic_data.make_semivoc_unlabeled(root, sources, VOC_UNLABELED,
                                                  initial_labels=False)
    cfg = synthetic_data.voc_semi_config(
        Config.fromfile(str(VOC_CONFIG)).to_dict(), paths)
    for key, value in VOC_OVERRIDES.items():
        *parents, leaf = key.split(".")
        node = cfg
        for k in parents:
            node = node[k]
        node[leaf] = value
    log(f"[voc] {os.path.relpath(VOC_CONFIG, ROOT)}: overrides "
        + ", ".join(f"{k} = {v}" for k, v in VOC_OVERRIDES.items())
        + f", data paths; a synthetic VOC2007 directory ({VOC_TRAINVAL} "
        f"trainval, {VOC_TEST} test images, copies of the fixtures); "
        f"tools/voc_convert2_semivoc_json.py: {proc.stdout.strip()}; "
        f"{VOC_UNLABELED} unlabeled copies with empty label files")

    # 2. pseudo-labels: --format-only on the unlabeled SemiVOCDataset
    variables = seeded_variables(Config(cfg))
    seeded = empty_detector(dict(Config(cfg).model))
    seeded.load_state_dict(flax_to_state_dict(variables))
    weights = tmp / "voc_seeded.pth"
    save_weights(str(weights), seeded)
    del seeded
    out = tmp / "unlabeled_voc.bbox.json"
    fmt_launches, _ = run_test_cli([
        str(VOC_CONFIG), str(weights), "--format-only", "--out", str(out),
        "--cfg-options", *voc_cli_options(
            cfg["test_pipeline"], type="SemiVOCDataset",
            ann_file=paths["unlabeled"], ann_path=paths["unlabel_store"],
            labelmapper=paths["category_info"],
            img_prefix=paths["unlabel_images"])], tag="voc")
    n_unl_batches = -(-VOC_UNLABELED // BATCH_SIZE)
    dets = json.loads(out.read_text())
    proc = subprocess.run(
        [sys.executable, "tools/generate_unlabel_annos_voc.py", "--det-file",
         str(out), "--image-list", paths["unlabeled"], "--out-dir",
         paths["unlabel_store"]], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True)
    store = tree_of(paths["unlabel_store"])
    names = Path(paths["unlabeled"]).read_text().split()
    labels = {n: json.loads(store[f"{n}.json"]) for n in names}
    if (fmt_launches != n_unl_batches or not dets
            or sorted(store) != sorted(f"{n}.json" for n in names)
            or not all("scores" in v and v["targetNum"] for v in labels.values())
            or {d["image_id"] for d in dets} != set(range(VOC_UNLABELED))):
        raise AssertionError(f"pseudo-labels: {fmt_launches} NMS launches, "
                             f"{len(dets)} detections, store {sorted(store)[:3]}")
    launches += fmt_launches
    log(f"[voc] the test CLI --format-only on the "
        f"unlabeled SemiVOCDataset: {len(dets)} detections (image ids 0-"
        f"{VOC_UNLABELED - 1}, the list's), NMS launches {fmt_launches} (one "
        f"per batch); tools/generate_unlabel_annos_voc.py: "
        f"{proc.stdout.strip()}; every unlabeled image named, "
        f"{sum(v['targetNum'] for v in labels.values())} boxes")

    # 3. the semi loop on the VOC config
    nms_keep.launches = 0
    t0 = time.perf_counter()
    with counting_semi_loop() as rec:
        runner = train_detector(Config(cfg), str(tmp / "voc_work"), seed=0,
                                device=DEVICE, variables=variables)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    semi_launches = nms_keep.launches
    iters = len(runner.data_loader)
    epochs = VOC_OVERRIDES["runner.max_epochs"]
    n_val_batches = -(-VOC_TEST // BATCH_SIZE)
    hist = runner.log_buffer.history
    logged = [json.loads(x) for x in (tmp / "voc_work" / "train.log.json")
              .read_text().splitlines() if '"mode": "val"' in x]
    if (len(rec["step_launches"]) != epochs * iters or any(rec["step_launches"])
            or any(n != 1 for n in rec["chunk_launches"])
            or not rec["chunk_launches"]
            or [e["epoch"] for e in rec["evals"]] != list(range(1, epochs + 1))
            or any(e["launches"] != n_val_batches or not e["on_teacher"]
                   for e in rec["evals"])
            or semi_launches != len(rec["chunk_launches"]) + epochs * n_val_batches
            or not all(np.isfinite(float(x)) for k, v in hist.items()
                       if k.startswith("loss") for x in v)
            or [v["epoch"] for v in logged] != list(range(1, epochs + 1))
            or not all(0.0 <= v["bbox_mAP"] <= 1.0 for v in logged)):
        raise AssertionError(f"VOC semi loop: steps {rec['step_launches']}, "
                             f"chunks {rec['chunk_launches']}, evaluations "
                             f"{rec['evals']}, logged {logged}")
    refreshed = tree_of(paths["unlabel_store"])
    tags = {t for v in refreshed.values() for t in json.loads(v)["tags"]}
    it_ms = sorted(hist["time"][iters:])
    launches += semi_launches
    log(f"[voc] train_detector on the VOC config: {epochs} epochs of {iters} "
        f"iterations (SemiVOCDataset labeled and unlabeled, B=5) in "
        f"{wall:.1f} s; NMS launches {semi_launches}: "
        f"{len(rec['chunk_launches'])} refresh chunks of {rec['chunk_sizes']} "
        f"images, {epochs * n_val_batches} in {epochs} evaluations, 0 in "
        f"{len(rec['step_launches'])} train steps; losses finite, last "
        f"{float(hist['loss'][-1]):.4f}; refreshed tags {sorted(tags)[:6]}...")
    for v in logged:
        log(f"[voc] Voc2CocoDataset evaluation of the teacher after epoch "
            f"{v['epoch']}: " + ", ".join(f"{k} {v[k]}" for k in v
                                          if k.startswith("bbox")))
    log(f"[time] VOC semi iteration, epoch 2 (the runner's host clock per "
        f"iteration, loader and refresh included): median "
        f"{it_ms[len(it_ms) // 2] * 1e3:.2f} ms, min {it_ms[0] * 1e3:.2f}, "
        f"max {it_ms[-1] * 1e3:.2f}  ({smi})")

    # 4. VOC mAP (11 points: the prefix names VOC2007) and COCO mAP, CLI
    ckpt = str(tmp / "voc_work" / f"epoch_{epochs}.pth")
    metrics = {}
    for metric, kind in (("mAP", "VOCDataset"), ("bbox", "Voc2CocoDataset")):
        n, lines = run_test_cli([
            str(VOC_CONFIG), ckpt, "--ema", "--eval", metric,
            "--cfg-options", *voc_cli_options(
                cfg["test_pipeline"], type=kind, ann_file=voc["test"],
                img_prefix=voc["voc_root"])], tag="voc")
        metrics[metric] = json.loads(next(x for x in lines if x.startswith("{")))
        if n != n_val_batches:
            raise AssertionError(f"--eval {metric}: {n} NMS launches")
        launches += n
    if (set(metrics["mAP"]) != {"mAP", "AP50"}
            or not 0 <= metrics["mAP"]["mAP"] <= 1
            or not 0 <= metrics["bbox"]["bbox_mAP"] <= 1):
        raise AssertionError(f"CLI metrics {metrics}")
    log(f"[voc] the test CLI --ema --eval mAP on a "
        f"VOCDataset under VOC2007/ (11-point AP): {metrics['mAP']}; --eval "
        f"bbox on Voc2CocoDataset: {metrics['bbox']}; NMS launches "
        f"{n_val_batches} each")

    # 5. test-time augmentation on the teacher
    val = build_dataset({**cfg["data"]["val"], "test_mode": True}, DEVICE,
                        np.random.RandomState(0), random.Random(0))
    tp = test_pipeline_params(cfg["data"]["val"]["pipeline"])
    det, params = runner.refresher.detector, runner.state.teacher_params
    args = dict(test_cfg=dict(cfg["model"]["test_cfg"]), canvas_hw=CANVAS,
                img_norm=tp["img_norm"], img_scales=TTA_SCALES, flip=True,
                device=DEVICE)
    passes = 2 * len(TTA_SCALES)
    counts, tta_metrics, keep_err = {}, {}, 0
    for name in ("tta_test", "tta_test_dense"):
        nms_keep.launches = 0
        with recording_nms() as calls:
            tta_metrics[name] = getattr(test_api, name)(det, params, val, **args)
            torch.cuda.synchronize()
        counts[name] = nms_keep.launches
        for boxes, valid, thr, keep in calls:
            want = nms_keep_reference(boxes, valid, thr)
            keep_err = max(keep_err, int((keep.int() - want.int()).abs().max()))
            if not torch.equal(keep, want):
                raise AssertionError(f"{name}: NMS keeps differ from the "
                                     f"plain version")
    if counts != {"tta_test": passes * n_val_batches, "tta_test_dense": 0}:
        raise AssertionError(f"TTA NMS launches {counts}")
    launches += counts["tta_test"]
    log(f"[voc] tta_test and tta_test_dense on the teacher over {VOC_TEST} "
        f"images, scales {TTA_SCALES}, flip: NMS launches {counts} (one per "
        f"batch and pass; the dense merge is host numpy), keeps = the plain "
        f"version's; tta_test {tta_metrics['tta_test']}; tta_test_dense "
        f"{tta_metrics['tta_test_dense']}")

    # one image's flipped predict, card against the CPU
    path = test_api._path(val, 0)
    img = read_image(path, DEVICE)
    nh, nw = keep_ratio_size(*img.shape[:2], TTA_SCALES[0])
    flipped = resize_linear_u8(img.flip(1), nh, nw)
    if not torch.equal(flipped.cpu(), resize_linear_u8(img.cpu().flip(1), nh, nw)):
        raise AssertionError("flip-then-resize: the card differs from the CPU")
    shapes = torch.tensor([[nh, nw]], dtype=torch.float32)
    sfs = torch.tensor([[nw / img.shape[1], nh / img.shape[0]] * 2])
    canvas = normalize_pad([flipped], CANVAS, tp["img_norm"])
    card = [t[0].cpu().numpy() for t in detector_predict(
        det, canvas, img_shapes=shapes.to(DEVICE), scale_factors=sfs.to(DEVICE),
        test_cfg=args["test_cfg"], device=DEVICE, params=params)]
    cpu_det = copy.deepcopy(det).cpu()
    cpu = [t[0].numpy() for t in detector_predict(
        cpu_det, canvas.cpu(), img_shapes=shapes, scale_factors=sfs,
        test_cfg=args["test_cfg"], device="cpu",
        params={k: v.cpu() for k, v in params.items()})]
    pairs, worst_box, worst_score = dets_banded(
        (card[0][card[2]], card[1][card[2]]), (cpu[0][cpu[2]], cpu[1][cpu[2]]))
    log(f"[voc] one image flipped then resized on the card: bit-identical "
        f"to the CPU's; its predict on the teacher, card vs CPU: the top "
        f"{pairs} detections paired (boxes within {worst_box:.2e} px, scores "
        f"{worst_score:.2e}; bands 0.5 px, 1e-3)")

    for name, fn in (("single_device_test", None),
                     ("single_device_test(flip=True)", None),
                     ("tta_test", test_api.tta_test),
                     ("tta_test_dense", test_api.tta_test_dense)):
        if fn is None:
            flip = "flip" in name
            times = host_ms(lambda: test_api.single_device_test(
                det, params, val, test_cfg=args["test_cfg"], canvas_hw=CANVAS,
                img_scale=TTA_SCALES[0], img_norm=tp["img_norm"],
                evaluate=False, flip=flip, device=DEVICE), reps=1, warmup=1)
        else:
            times = host_ms(lambda: fn(det, params, val, evaluate=False, **args),
                            reps=1, warmup=0)
        log(f"[time] {name} over {VOC_TEST} images at {TTA_SCALES[0]}: "
            f"{times[0]:.1f} ms, {VOC_TEST / times[0] * 1e3:.1f} img/s  ({smi})")
    log(f"[voc] phase 14 wall {time.perf_counter() - t_phase:.1f} s")
    return launches, keep_err


# -- data parallelism across processes (phase 15) -----------------------------

DIST_RANKS = 2                # gloo ranks sharing the one card
DIST_WIDTH = "full_d1"        # the flagship at full width, RLA depth [1, 1, 1, 1]
DIST_TIMED = 3                # timed steps per rank after two warm-ups
DIST_THREADS = 4              # CPU threads per rank
# two ranks against one process on the global batch: losses and grad_norm
# (f32 sums over 10 images against two sums of 5)
DIST_STEP_REL = 1e-5


def _tree_diff(x, y, path: str = "") -> list[str]:
    """Where two checkpoint trees differ: keys, counters, tensors bit for
    bit (dtype, shape and values)."""
    import torch

    if isinstance(x, dict):
        if not isinstance(y, dict) or set(x) != set(y):
            return [f"{path} (keys)"]
        return [d for k in x for d in _tree_diff(x[k], y[k], f"{path}.{k}")]
    if isinstance(x, (list, tuple)):
        if not isinstance(y, (list, tuple)) or len(x) != len(y):
            return [f"{path} (length)"]
        return [d for i, (a, b) in enumerate(zip(x, y))
                for d in _tree_diff(a, b, f"{path}[{i}]")]
    if torch.is_tensor(x):
        same = (torch.is_tensor(y) and x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x, y))
        return [] if same else [path]
    return [] if x == y else [path]


def detection_pairs(got: list, want: list) -> tuple[int, int, float]:
    """Per-image detections ``(dets (N, 5), labels)`` of one run against
    another's, paired by ``torch_port_util.pair_labels`` (label, 1 px, 1e-3
    in score): (detections in ``got``, unpaired, largest box difference of
    a pair)."""
    from torch_port_util import pair_labels

    def as_file(dets, labels):
        return dict(targetNum=len(dets), rects=dets[:, :4].tolist(),
                    tags=labels.tolist(), scores=dets[:, 4].tolist())

    n, unpaired, worst = 0, 0, 0.0
    for (gd, gl), (wd, wl) in zip(got, want, strict=True):
        u, w = pair_labels(as_file(gd, gl), as_file(wd, wl))
        n, unpaired, worst = n + len(gd), unpaired + u, max(worst, w)
    return n, unpaired, worst


def phase_dist_nccl(tmp: Path, smi: str, baseline: dict) -> int:
    """Phase 13's train CLI again under ``torch.distributed.run`` with one
    rank (NCCL, ``--launcher pytorch``): its last checkpoint bit-identical
    to phase 13's; the test CLI under the same launcher on that checkpoint
    prints phase 13's last ``bbox_mAP``. Returns the NMS launches."""
    import torch

    launcher = ["--standalone", "--nproc_per_node=1"]
    work = tmp / "baseline_work_nccl"
    name = f"epoch_{BASELINE_EPOCHS}.pth"
    t0 = time.perf_counter()
    train_launches, _ = run_module("dsl_tpu_torch.tools.train", [
        str(BASELINE_CONFIG), "--work-dir", str(work), "--device", DEVICE,
        "--launcher", "pytorch", "--cfg-options", *baseline["options"]],
        tag="dist", launcher=launcher)
    train_s = time.perf_counter() - t0
    diff = _tree_diff(*(torch.load(w / name, map_location="cpu",
                                   weights_only=True)
                        for w in (baseline["work"], work)))
    if diff:
        raise AssertionError(f"W=1 under torch.distributed.run: {name} differs "
                             f"from --launcher none's at {diff[:5]}")
    test_launches, lines = run_module("dsl_tpu_torch.tools.test", [
        str(BASELINE_CONFIG), str(work / name), "--eval", "bbox", "--device",
        DEVICE, "--launcher", "pytorch", "--cfg-options", *baseline["options"]],
        tag="dist", launcher=launcher)
    printed = json.loads(next(x for x in reversed(lines) if x.startswith("{")))
    if printed["bbox_mAP"] != round(float(baseline["mAP"]), 4):
        raise AssertionError(f"the test CLI under the launcher: bbox_mAP "
                             f"{printed['bbox_mAP']}, phase 13 logged "
                             f"{baseline['mAP']}")
    lines = [json.loads(x) for x in (work / "train.log.json").read_text()
             .splitlines()]
    nccl = sorted(x["time"] for x in lines if x["mode"] == "train")
    plain = sorted(baseline["iter_times"])
    log(f"[dist] python -m torch.distributed.run --standalone "
        f"--nproc_per_node=1 -m dsl_tpu_torch.tools.train (NCCL, "
        f"--launcher pytorch), phase 13's config and overrides: {name} "
        f"bit-identical to --launcher none's (every tensor and counter), "
        f"{train_s:.1f} s; the test CLI under the launcher prints bbox_mAP "
        f"{printed['bbox_mAP']} = phase 13's; iteration ms by the runner's "
        f"host clock, median: {nccl[len(nccl) // 2] * 1e3:.2f} under the "
        f"launcher, {plain[len(plain) // 2] * 1e3:.2f} without (phase 13's "
        f"log; the step in process {baseline['step_ms']:.2f} ms); NMS launches "
        f"{train_launches} + {test_launches}  ({smi})")
    return train_launches + test_launches


def phase_dist_ranks(tmp: Path, smi: str) -> int:
    """The runs on ``DIST_RANKS`` gloo ranks sharing the card, in one spawn
    of the ranks (one process start each): :func:`dist_step_check`'s step,
    then :func:`dist_semi_check`'s semi loop. The one-process step on the
    global batch runs first, in this process, its memory freed before the
    ranks start. Returns the ranks' NMS launches."""
    import torch

    import torch_port_dist_worker as W
    from torch_port_util import tree_of

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = W.reference_step(DIST_WIDTH, DIST_RANKS, CANVAS, DEVICE)
    torch.cuda.empty_cache()              # its memory freed for the ranks
    ref_s = time.perf_counter() - t0
    root = tmp / "dist_semi"
    root.mkdir()
    cfg, paths = semi_config_for(root)
    cfg["runner"]["max_epochs"] = 1
    cfg["log_config"]["interval"] = 1
    (root / "cfg.json").write_text(json.dumps(cfg))
    before = tree_of(Path(paths["unlabel_store"]))
    t0 = time.perf_counter()
    res = W.collect(W.spawn(DIST_RANKS, root, DEVICE, [
        ("step", dict(width=DIST_WIDTH, canvas=CANVAS, timed=DIST_TIMED)),
        ("train", dict(cfg=str(root / "cfg.json"), work_dir=str(root / "work"),
                       refresh_after=True))], threads=DIST_THREADS),
        DIST_RANKS, root)
    wall = time.perf_counter() - t0
    log(f"[dist] the ranks' step and semi loop in one spawn: {wall:.1f} s "
        f"with process start")
    dist_step_check([r["step"] for r in res], want, ref_s, smi)
    return dist_semi_check([r["train"] for r in res], cfg, paths, before,
                           root, smi)


def dist_step_check(steps: list, want: dict, ref_s: float, smi: str):
    """One flagship step at full width and RLA depth [1, 1, 1, 1] over
    ``DIST_RANKS`` gloo ranks on the card, each on its shard (2 labeled + 2
    unlabeled + the half-res copy at 800x1344) of the seeded global batch,
    against one process stepping the global batch (B=10, ``want``): losses
    and ``grad_norm`` within ``DIST_STEP_REL``, the updates banded as phase
    6 bands them, both ranks' parameters and teachers bit-identical; then
    each rank's step ms (gloo stages the all-reduce through the host: not a
    measure of NCCL)."""
    if (any(s["params_sha"] != steps[0]["params_sha"]
            or s["teacher_sha"] != steps[0]["teacher_sha"]
            or s["metrics"] != steps[0]["metrics"] for s in steps)):
        raise AssertionError("the ranks' states or losses differ")
    got = steps[0]["metrics"]
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-12)
           for k, v in want["metrics"].items()}
    worst, l2 = banded_max_ratio(steps[0]["after"], want["after"], want["before"])
    log(f"[dist] one flagship step ({DIST_WIDTH}), {DIST_RANKS} gloo ranks on the card (B=5 "
        f"each: 2 labeled, 2 unlabeled, the half-res copy, {CANVAS[0]}x"
        f"{CANVAS[1]}) vs one "
        f"process on the global batch (B=10, {ref_s:.1f} s): "
        + ", ".join(f"{k} {got[k]:.6f}/{want['metrics'][k]:.6f}"
                    for k in sorted(got))
        + f"; worst relative {max(rel.values()):.2e} (limit {DIST_STEP_REL}); "
        f"updates: worst banded ratio {worst:.3f} (limit 1), relative L2 "
        f"{l2:.2e} (limit 1e-3); both ranks' parameters and teachers "
        f"bit-identical")
    log(f"[time] the same step per rank, gloo-staged all-reduce (through the "
        f"host; not a measure of NCCL): median of {DIST_TIMED} "
        + ", ".join(f"rank {r} {s['step_ms']:.2f} ms" for r, s in enumerate(steps))
        + f"  ({smi})")
    if max(rel.values()) > DIST_STEP_REL or worst > 1 or l2 > 1e-3:
        raise AssertionError(f"two ranks vs one process: {rel}, {worst}, {l2}")


def dist_semi_check(res: list, cfg: dict, paths: dict, before: dict,
                    root: Path, smi: str) -> int:
    """The flagship's semi loop (``train_detector``, ``cfg``: phase 10's
    data and overrides, 1 epoch) over ``DIST_RANKS`` gloo ranks on the
    card, then one refresh of every unlabeled image from the final teacher
    on both ranks (``res``): both ranks end with one model; every readable
    unlabeled label file is rewritten (the cut one is not, ``before`` the
    store as it was), and in the last refresh each once, by the rank the
    chunk stride names; those files equal a one-process refresh from the
    same teacher (``epoch_1.pth``'s; tags and counts, boxes 1 px, scores
    1e-3); the teacher's evaluation split by batch over the ranks gives one
    process's detections (paired the same way: each process picks its own
    cuDNN algorithms) and metrics. Returns the ranks' NMS launches
    (summed)."""
    import shutil

    import torch_port_dist_worker as W
    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from torch_port_util import tree_of

    store = Path(paths["unlabel_store"])
    work = root / "work"
    if any(r["student_sha"] != res[0]["student_sha"] or r["step"] != res[0]["step"]
           for r in res):
        raise AssertionError("the ranks end with different models")
    after = tree_of(store)
    cut = f"{SEMI_UNREADABLE}.json"
    names = [n[:-len(".json")] for n in sorted(before) if n != cut]
    if after[cut] != before[cut] or any(after[f"{n}.json"] == before[f"{n}.json"]
                                        for n in names):
        raise AssertionError("the unlabeled label files were not all rewritten")
    with open(paths["unlabeled"], encoding="utf-8") as f:
        listed = [i["file_name"] for i in json.load(f)["images"]
                  if i["file_name"] != SEMI_UNREADABLE]
    chunks = [listed[i:i + 8] for i in range(0, len(listed), 8)]
    for r, got in enumerate(res):
        want = [n for c, chunk in enumerate(chunks)
                if (got["first_chunk"] + c) % DIST_RANKS == r for n in chunk]
        if got["written"] != want:
            raise AssertionError(f"rank {r} wrote {got['written']}, the stride "
                                 f"names {want}")

    # one process from the same teacher: its refresh into a copy of the
    # store, and its evaluation
    one = root / "one_store"
    shutil.copytree(store, one)
    one_cfg = copy.deepcopy(cfg)
    one_cfg["data"]["unlabel_pred"]["anno_root_path"] = str(one)
    one_cfg["runner"]["max_epochs"] = 0
    runner = train_detector(Config(one_cfg), str(root / "one_work"),
                            resume_from=str(work / "epoch_1.pth"), device=DEVICE)
    runner.refresher._first_done = True      # the ranks' refresh was not the first
    with deterministic_cudnn():
        runner.refresher.refresh_images(runner.state, listed)
        metrics, results = W.evaluate_teacher(Config(one_cfg), runner, DEVICE,
                                              None)
    n, unpaired, diff = refresh_store_pairs(store, one, listed)
    ranks_metrics, ranks_results = res[0]["evaluation"]
    n_dets, dets_unpaired, dets_diff = detection_pairs(ranks_results, results)
    logged = [json.loads(x) for x in (work / "train.log.json").read_text()
              .splitlines()]
    val = [x for x in logged if x["mode"] == "val"]
    iters = sorted(x["time"] for x in logged if x["mode"] == "train")
    launches = sum(r["nms_launches"] for r in res)
    log(f"[dist] train_detector on the flagship over {DIST_RANKS} gloo ranks "
        f"on the card, 1 epoch of {len(iters)} iterations (B=5 per rank: "
        f"each rank's shard of the global batch): one model on both ranks "
        f"(step {res[0]['step']}); every "
        f"readable unlabeled label file rewritten, the cut one kept; the last "
        f"refresh's files each written once, chunk c by rank c mod "
        f"{DIST_RANKS} (" + "; ".join(f"rank {r}: {len(x['written'])} files"
                                      for r, x in enumerate(res))
        + f"); against one process from the same teacher: {n} boxes, "
        f"{unpaired} unpaired, largest paired difference {diff:.2e}; the "
        f"evaluation during training: bbox_mAP {val[-1]['bbox_mAP']}; the "
        f"teacher's evaluation split by batch against one process's: "
        f"{n_dets} detections, {dets_unpaired} unpaired, largest paired "
        f"difference {dets_diff:.2e} (each process picks its own cuDNN "
        f"algorithms), bbox_mAP {ranks_metrics['bbox_mAP']} vs "
        f"{metrics['bbox_mAP']}; NMS launches per rank "
        f"{[r['nms_launches'] for r in res]}, {launches} in all")
    log(f"[time] the semi iteration over {DIST_RANKS} gloo ranks, gloo-staged "
        f"(through the host; not a measure of NCCL), the runner's host clock: "
        f"median {iters[len(iters) // 2] * 1e3:.2f} ms  ({smi})")
    if unpaired or dets_unpaired or ranks_metrics != metrics:
        raise AssertionError(f"two ranks vs one process: {unpaired} unpaired "
                             f"label boxes, {dets_unpaired} unpaired "
                             f"detections, metrics {ranks_metrics} vs {metrics}")
    n_val_batches = -(-SEMI_VAL // BATCH_SIZE)
    if launches < len(chunks) + 2 * n_val_batches or not all(
            r["nms_launches"] for r in res):
        raise AssertionError(f"NMS launches per rank {[r['nms_launches'] for r in res]}")
    return launches


# -- PNG, the multi-head detector, the new transforms and the config paths
#    (phase 16) ----------------------------------------------------

PNG_TIMED = 10                # decodes timed per PNG fixture
MH_HEADS = 2                  # (neck, head) pairs of the co-training model
MH_TIMED, MH_WARMUP = 5, 2    # multi-head predicts timed after warm-ups
MH_TRAIN_STEPS = 3            # multi-head AdamW steps at B=5
MH_OPTIMIZER = dict(type="AdamW", lr=1e-4, weight_decay=0.05)
MH_ADAM_REL = 1e-6            # AdamW from equal gradients, card vs CPU
CFG_LAYERS = [1, 1, 1, 1]     # the config-path runs' RLA depth (of [3,4,6,3])
CFG_OPTIMIZER = dict(type="AdamW", lr=1e-4, weight_decay=0.05)
GEOMETRIC_POLICIES = [
    [dict(type="Shear", level=4, prob=0.6)],
    [dict(type="Rotate", level=3, prob=0.6)],
    [dict(type="Translate", level=3, prob=0.6, img_fill_val=(104, 116, 124))],
]
NEW_TRANSFORMS = (            # ZeroIgnore, the extra and the geometric ones
    dict(type="ZeroIgnore", ratio=0.5),
    dict(type="RandomCrop", crop_size=(600, 800)),
    dict(type="MinIoURandomCrop"),
    dict(type="Expand", mean=(123.675, 116.28, 103.53), ratio_range=(1, 4),
         prob=0.5),
    dict(type="PhotoMetricDistortion"),
    dict(type="CutOut", n_holes=(1, 5), cutout_ratio=[(0.05, 0.05), (0.1, 0.1)]),
    dict(type="RandomShift", shift_ratio=0.5, max_shift_px=32),
    dict(type="AutoAugment", policies=GEOMETRIC_POLICIES + [
        [dict(type="ColorTransform", level=6, prob=0.8),
         dict(type="EqualizeTransform", prob=0.5)]]),
    dict(type="Shear", level=5, prob=1.0),
    dict(type="Rotate", level=5, prob=1.0),
    dict(type="Translate", level=5, prob=1.0),
    dict(type="ColorTransform", level=3, prob=1.0),
    dict(type="EqualizeTransform", prob=1.0),
    dict(type="BrightnessTransform", level=7, prob=1.0),
    dict(type="ContrastTransform", level=8, prob=1.0),
)
# momentum_config of the SGD config-path run: mmcv's cyclic momentum over
# its 8 updates (1 epoch of 8 iterations) from the flagship's momentum 0.9;
# MOMENTUM_EXPECTED is the JAX package's build_momentum_schedule at updates
# 0-7, computed there (tests/test_torch_port_optim.py holds the two equal)
MOMENTUM_CONFIG = dict(policy="cyclic", target_ratio=(0.85 / 0.95, 1.0),
                       step_ratio_up=0.4, anneal_strategy="cos")
MOMENTUM_BASE, MOMENTUM_ITERS = 0.9, 8
MOMENTUM_EXPECTED = (0.8999999761581421, 0.8789480328559875, 0.8345044255256653,
                     0.8061733245849609, 0.8116092681884766, 0.8345044851303101,
                     0.8648914098739624, 0.8902114629745483)
MOMENTUM_REL = 1e-6           # JAX's f32 schedule against the port's f64
PNG_CUT = "unlabeled_no_iend.png"


def png_copies(tmp: Path) -> list[tuple[str, int, int]]:
    """PNG copies of the JPEG fixtures' committed decodes (RGB 8-bit, the
    filters cycled), written with the standard library into ``tmp``: (path,
    height, width)."""
    from torch_port_make_fixtures import encode_png

    files, decodes = fixtures()
    out = []
    for name, _, h, w in files:
        path = tmp / f"{name}.png"
        path.write_bytes(encode_png(decodes[name][..., ::-1], 2, 8))
        out.append((str(path), h, w))
    return out


def phase_png(tmp: Path, smi: str) -> dict:
    """Each committed PNG fixture on the card route equal to the CPU route
    (which the CPU tests hold to ``cv2.imread``), the host C unfilter equal
    to the numpy version on each, and the decode's time per PNG (median of
    ``PNG_TIMED``, the host part alone beside it)."""
    import numpy as np
    import torch

    from dsl_tpu_torch.data import png
    from dsl_tpu_torch.data.image_io import read_image, readable
    from torch_port_make_fixtures import OUT, PNG_FIXTURES

    paths = [OUT / f"{n}.png" for n in PNG_FIXTURES]
    paths += [Path(p) for p, _, _ in png_copies(tmp)]
    out = {}
    for path in paths:
        data = path.read_bytes()
        image = png.parse(data)
        if not np.array_equal(png.unfilter_host(image),
                              png.unfilter_reference(image)):
            raise AssertionError(f"{path.name}: the C unfilter differs from "
                                 f"the numpy version")
        got = read_image(path, DEVICE)
        if got.device.type != torch.device(DEVICE).type or not readable(path, DEVICE):
            raise AssertionError(f"{path.name}: not read on {DEVICE}")
        if not torch.equal(got.cpu(), read_image(path, "cpu")):
            raise AssertionError(f"{path.name}: card and CPU routes differ")
        whole = sorted(host_ms(lambda: png.decode(data, DEVICE), PNG_TIMED))
        host = []
        for _ in range(PNG_TIMED):
            t0 = time.perf_counter()
            png.unfilter_host(png.parse(data))
            host.append((time.perf_counter() - t0) * 1e3)
        host.sort()
        out[path.name] = (whole[PNG_TIMED // 2], host[PNG_TIMED // 2])
        log(f"[png] {path.name} ({len(data)} bytes, {image.width}x"
            f"{image.height}, colour type {image.color_type}, depth "
            f"{image.bit_depth}, {'Adam7' if len(image.passes) > 1 else 'plain'}): "
            f"card = CPU route, C unfilter = numpy; decode "
            f"{whole[PNG_TIMED // 2]:.3f} ms (median of {PNG_TIMED}, min "
            f"{whole[0]:.3f}), of which host (parse, inflate, unfilter) "
            f"{host[PNG_TIMED // 2]:.3f} ms  ({smi})")
    return out


def multi_head_cfg(cfg) -> dict:
    """The flagship's model as DSL's co-training detector: its backbone,
    ``MH_HEADS`` copies of its neck and head."""
    model = copy.deepcopy(dict(cfg.model))
    return dict(type="FCOSMultiHead", backbone=model["backbone"],
                necks=[model["neck"]] * MH_HEADS,
                bbox_heads=[model["bbox_head"]] * MH_HEADS,
                test_cfg=model["test_cfg"])


def phase_multihead(cfg, smi: str) -> tuple[int, int]:
    """The co-training detector at full width: ``multi_head_predict`` at
    B=8 (NMS keeps of each launch, 2 heads and the merge, equal to the
    plain version's; head outputs card vs CPU; img/s), then
    ``MH_TRAIN_STEPS`` of ``multi_head_loss``, backward and ``MMCVAdamW``
    at B=5, one step card vs CPU. Returns (NMS launches, worst keep
    error)."""
    import numpy as np
    import torch

    from dsl_tpu_torch.models.detectors.multi_head import (
        multi_head_loss, multi_head_predict)
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.train import build_optimizer_from_cfg
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
    from dsl_tpu_torch.utils.precision import outputs_to_f32
    from dsl_tpu_torch.utils.random_weights import fill_variables

    mh = multi_head_cfg(cfg)
    det = empty_detector(copy.deepcopy(mh))
    variables = fill_variables(state_dict_to_flax(det.state_dict()))
    det.load_state_dict(flax_to_state_dict(variables))
    det.eval().to(DEVICE)
    n_params = sum(p.numel() for p in det.parameters())
    log(f"[multihead] FCOSMultiHead: the flagship's RLA-ResNet-50 and "
        f"{MH_HEADS} x (FPN 256, 4-conv GN FCOS head 256, 80 classes), "
        f"{n_params / 1e6:.2f} M parameters, seeded; B={BATCH} at "
        f"{CANVAS[0]}x{CANVAS[1]}, f32")
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    nms_keep.launches = 0
    with recording_nms() as calls:
        dets, labels, valid = multi_head_predict(det, images, device=DEVICE)
        torch.cuda.synchronize()
    launches = nms_keep.launches
    tc = mh["test_cfg"]
    if launches != MH_HEADS + 1 or len(calls) != MH_HEADS + 1:
        raise AssertionError(f"multi-head predict: {launches} NMS launches")
    if (tuple(dets.shape) != (BATCH, tc["max_per_img"], 5)
            or not bool(torch.isfinite(dets).all())):
        raise AssertionError(f"multi-head dets {tuple(dets.shape)} not finite")
    worst = 0
    for boxes, vmask, thr, keep in calls:
        want = nms_keep_reference(boxes, vmask, thr)
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError(f"multi-head NMS keeps differ from the plain "
                                 f"version at {tuple(boxes.shape)}")
    launches = nms_keep.launches
    log(f"[multihead] multi_head_predict: dets {tuple(dets.shape)} finite, "
        f"valid per image {valid.sum(1).tolist()}; {launches} NMS launches "
        f"(inputs {[tuple(c[0].shape) for c in calls]}), keeps bit-identical "
        f"to the plain version")
    small = images[:1, :, :128, :192]
    with torch.no_grad():
        gpu = outputs_to_f32(det(small))
        cpu = copy.deepcopy(det).cpu()(small.cpu())
    worst_rel = max(
        float((g.cpu() - c).abs().max() / c.abs().max().clamp_min(1.0))
        for g_head, c_head in zip(gpu, cpu)
        for g_kind, c_kind in zip(g_head, c_head)
        for g, c in zip(g_kind, c_kind))
    log(f"[multihead] head outputs of both heads, card vs CPU at 1x128x192: "
        f"worst |diff| / max|ref| = {worst_rel:.3e} (limit 1e-3)")
    if worst_rel > 1e-3:
        raise AssertionError(f"multi-head card and CPU disagree: {worst_rel}")
    times = sorted(host_ms(lambda: multi_head_predict(det, images, device=DEVICE),
                           MH_TIMED, warmup=MH_WARMUP))
    ms = times[MH_TIMED // 2]
    log(f"[multihead] predict B={BATCH}: {ms:.2f} ms (median of {MH_TIMED} "
        f"after {MH_WARMUP} warm-ups, min {times[0]:.2f}), "
        f"{BATCH / ms * 1e3:.1f} img/s  ({smi})")
    del images, dets
    torch.cuda.empty_cache()

    # training: loss, backward, AdamW, composed here (no train step of its own)
    det.train()
    tx, _ = build_optimizer_from_cfg(MH_OPTIMIZER, dict(cfg.optimizer_config),
                                     dict(cfg.lr_config),
                                     steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    opt = tx.init(det)
    batch = train_batch(cfg, TRAIN_SEED, CANVAS, 2, 2, (16, 600), DEVICE)
    nms_keep.launches = 0
    step_ms, logged = [], []
    for count in range(MH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, log_vars = multi_head_loss(det, batch, cur_iter=count)
        loss.backward()
        norm = tx.update(opt, count)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logged.append({**{k: float(v) for k, v in log_vars.items()},
                       "grad_norm": float(norm)})
    if nms_keep.launches:
        raise AssertionError(f"{nms_keep.launches} NMS launches in training")
    keys = set(logged[-1])
    want_keys = {"loss_cls", "loss_cls_h1", "loss_bbox", "loss_bbox_h1",
                 "loss_centerness", "loss_centerness_h1"}
    bad = [k for r in logged for k, v in r.items() if not np.isfinite(v)]
    if bad or not want_keys <= keys:
        raise AssertionError(f"multi-head losses: not finite {bad}, keys {keys}")
    log(f"[multihead] {MH_TRAIN_STEPS} steps of multi_head_loss + backward + "
        f"MMCVAdamW ({MH_OPTIMIZER}) at B=5, {CANVAS[0]}x{CANVAS[1]}: losses "
        f"finite, both heads' keys; last step " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(logged[-1].items()))
        + f"; step {step_ms[-1]:.1f} ms (steps {[round(t, 1) for t in step_ms]})"
        f"  ({smi})")
    del det, opt, batch
    torch.cuda.empty_cache()
    multihead_card_vs_cpu(cfg, mh, variables)
    return launches, worst


def multihead_card_vs_cpu(cfg, mh: dict, variables):
    """One multi-head AdamW step at 128x192, full width, card vs CPU: the
    losses within 1e-4 and ``grad_norm`` within 1e-3 relative, the
    gradients banded as phase 6 bands its updates; then the AdamW update
    from the CPU's gradients on both devices, every parameter within
    ``MH_ADAM_REL`` of its largest magnitude (Adam divides by the
    gradient's own scale, so its first update is about lr times the
    gradient's sign, which two devices' roundings can flip where a
    gradient is near zero: the update itself is held on equal inputs)."""
    import torch

    from dsl_tpu_torch.models.detectors.multi_head import multi_head_loss
    from dsl_tpu_torch.models.detectors.single_stage import empty_detector
    from dsl_tpu_torch.train import build_optimizer_from_cfg
    from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict

    res = {}
    for device in (DEVICE, "cpu"):
        det = empty_detector(copy.deepcopy(mh))
        det.load_state_dict(flax_to_state_dict(variables))
        det.to(device).train()
        batch = train_batch(cfg, TRAIN_SEED + 1, (128, 192), 1, 0, (8, 100),
                            device)
        loss, log_vars = multi_head_loss(det, batch)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in det.named_parameters() if p.requires_grad}
        norm = float(torch.stack([g.double().square().sum()
                                  for g in grads.values()]).sum().sqrt())
        res[device] = ({k: float(v) for k, v in log_vars.items()}, norm, grads)
    (m_card, n_card, g_card), (m_cpu, n_cpu, g_cpu) = res[DEVICE], res["cpu"]
    for k, v in m_cpu.items():
        if abs(m_card[k] - v) / max(abs(v), 1e-12) > 1e-4:
            raise AssertionError(f"multi-head card vs CPU {k}: {m_card[k]} vs {v}")
    if abs(n_card - n_cpu) / n_cpu > 1e-3:
        raise AssertionError(f"multi-head grad_norm {n_card} vs {n_cpu}")
    zeros = {n: torch.zeros_like(g) for n, g in g_cpu.items()}
    worst, l2 = banded_max_ratio(g_card, g_cpu, zeros)
    if worst > 1 or l2 > 1e-3:
        raise AssertionError(f"multi-head gradients card vs CPU: banded "
                             f"{worst}, L2 {l2}")
    tx, _ = build_optimizer_from_cfg(MH_OPTIMIZER, dict(cfg.optimizer_config),
                                     dict(cfg.lr_config),
                                     steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    after = {}
    for device in (DEVICE, "cpu"):
        det = empty_detector(copy.deepcopy(mh))
        det.load_state_dict(flax_to_state_dict(variables))
        det.to(device)
        opt = tx.init(det)
        for n, p in det.named_parameters():
            if p.requires_grad:
                p.grad = g_cpu[n].to(device)
        tx.update(opt, 0)
        after[device] = {n: p.detach().cpu() for n, p in det.named_parameters()}
    adam_rel = max(float((after[DEVICE][n] - w).abs().max()
                         / w.abs().max().clamp_min(1e-12))
                   for n, w in after["cpu"].items())
    log(f"[multihead] card vs CPU, one step at 1x128x192: " + ", ".join(
        f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}" for k in sorted(m_cpu))
        + f", grad_norm {n_card:.6f}/{n_cpu:.6f}; gradients: worst banded "
        f"ratio {worst:.3f} (limit 1), relative L2 {l2:.2e} (limit 1e-3); "
        f"AdamW from equal gradients: worst |diff| / max|param| "
        f"{adam_rel:.2e} (limit {MH_ADAM_REL:g})")
    if adam_rel > MH_ADAM_REL:
        raise AssertionError(f"AdamW card vs CPU: {adam_rel}")


def phase_new_transforms(smi: str) -> dict:
    """The 15 transforms of ``NEW_TRANSFORMS`` on the card and on the CPU
    (as phase 9 the strong augmentations): bit-identical images, equal
    boxes, time, kernels and host syncs per image."""
    from dsl_tpu_torch.registry import PIPELINES, build_from_cfg

    inputs = strong_aug_inputs()
    for r in inputs:
        # GT boxes in the left part, ignore boxes in the right, so that
        # ZeroIgnore finds ignore boxes that overlap no GT box
        w = r["img"].shape[1]
        r["gt_bboxes"][:, 0::2] *= 0.45
        r["gt_bboxes_ignore"][:, 0::2] = 0.55 * w + 0.45 * r[
            "gt_bboxes_ignore"][:, 0::2]
        r["img_shape"] = tuple(r["img"].shape)
    out = {}
    for cfg in NEW_TRANSFORMS:
        t = build_from_cfg(copy.deepcopy(cfg), PIPELINES)
        out[cfg["type"]] = transform_on_card(t, cfg, inputs, "[transforms]", smi)
    return out


def config_path_cfg(tmp: Path, sources: list, optimizer: dict,
                    momentum: dict | None) -> tuple[dict, dict]:
    """The flagship on a synthetic semicoco directory of ``sources`` (JPEG
    fixtures and their PNG copies) with the newly ported config paths: RLA
    depth ``CFG_LAYERS``, 1 epoch, ``optimizer`` (and ``momentum_config``),
    ``ZeroIgnore`` and an ``AutoAugment`` of ``GEOMETRIC_POLICIES`` in the
    train pipelines, the labeled set in a ``RepeatDataset``; and a PNG
    without its IEND chunk in the unlabeled list (empty label, as phase 10's
    cut JPEG)."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.utils import synthetic_data

    paths = synthetic_data.make_semicoco_dir(
        tmp / "data", sources, SEMI_LABELED, SEMI_UNLABELED, n_val=SEMI_VAL)
    add_unreadable_unlabeled(paths, Path(sources[-1][0]), name=PNG_CUT,
                             data=Path(sources[-1][0]).read_bytes()[:-12])
    cfg = copy.deepcopy(Config.fromfile(str(CONFIG))._cfg_dict)
    cfg["model"]["backbone"]["layers"] = list(CFG_LAYERS)
    cfg["runner"]["max_epochs"] = 1
    cfg["data"]["unlabel_pred"]["start_point"] = 1
    cfg["optimizer"] = dict(optimizer)
    if momentum:
        cfg["momentum_config"] = dict(momentum)
    cfg = synthetic_data.semi_config(cfg, paths)
    data = cfg["data"]
    auto = dict(type="AutoAugment", policies=GEOMETRIC_POLICIES)
    for key, extra in (("train", [auto]),
                       ("unlabel_train", [dict(type="ZeroIgnore", ratio=0.5),
                                          auto])):
        pipe = data[key]["pipeline"]
        at = [t["type"] for t in pipe].index("RandomFlip") + 1
        data[key]["pipeline"] = pipe[:at] + copy.deepcopy(extra) + pipe[at:]
    data["train"] = dict(type="RepeatDataset", times=2, dataset=data["train"])
    return cfg, paths


def phase_config_paths(tmp: Path, smi: str) -> tuple[int, int]:
    """``train_detector`` through the newly ported config paths on JPEG and
    PNG files, then a refresh over the mixed unlabeled list and the cut
    PNG, then one SGD run under ``momentum_config``. Returns (NMS launches,
    worst keep error)."""
    import json as _json

    import numpy as np
    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from torch_port_util import tree_of

    files, _ = fixtures()
    sources = [(str(p), h, w) for _, p, h, w in files] + png_copies(tmp)
    cfg, paths = config_path_cfg(tmp / "adamw", sources, CFG_OPTIMIZER, None)
    unl_store = Path(paths["unlabel_store"])
    before = tree_of(unl_store)
    log(f"[config] the flagship at RLA depth {CFG_LAYERS}, 1 epoch, "
        f"optimizer {CFG_OPTIMIZER}, ZeroIgnore and AutoAugment("
        f"{[p[0]['type'] for p in GEOMETRIC_POLICIES]}) in the train "
        f"pipelines, the labeled set in RepeatDataset(times=2); "
        f"{SEMI_LABELED} labeled, {SEMI_UNLABELED} unlabeled (+ "
        f"{PNG_CUT}) and {SEMI_VAL} val images, half JPEG fixtures, half "
        f"their PNG copies")
    nms_keep.launches = 0
    with counting_semi_loop() as rec:
        runner = train_detector(Config(cfg), str(tmp / "adamw" / "work"),
                                seed=0, device=DEVICE)
        torch.cuda.synchronize()
    launches = nms_keep.launches
    if type(runner.state.optimizer).__name__ != "AdamWState":
        raise AssertionError(f"optimizer {type(runner.state.optimizer)}")
    hist = runner.log_buffer.history
    bad = [k for k, v in hist.items() if k.startswith("loss") or k == "grad_norm"
           if not all(bool(np.isfinite(float(x))) for x in v)]
    n_batches = -(-SEMI_VAL // BATCH_SIZE)
    eval_launches = sum(e["launches"] for e in rec["evals"])
    logged = [_json.loads(x) for x in (tmp / "adamw" / "work" / "train.log.json")
              .read_text().splitlines() if '"mode": "val"' in x]
    if (bad or any(rec["step_launches"]) or not rec["chunk_launches"]
            or any(n != 1 for n in rec["chunk_launches"])
            or any(e["launches"] != n_batches for e in rec["evals"])
            or launches != len(rec["chunk_launches"]) + eval_launches
            or not rec["evals"] or not all(e["on_teacher"] for e in rec["evals"])
            or len(logged) != 1 or not 0.0 <= logged[0]["bbox_mAP"] <= 1.0):
        raise AssertionError(f"config paths: not finite {bad}; NMS steps "
                             f"{rec['step_launches']}, chunks "
                             f"{rec['chunk_launches']}, evaluations "
                             f"{rec['evals']}; logged {logged}")
    after = tree_of(unl_store)
    stale = [n for n in before if n != f"{PNG_CUT}.json" and (
        after[n] == before[n] or "scores" not in _json.loads(after[n]))]
    if stale or after[f"{PNG_CUT}.json"] != before[f"{PNG_CUT}.json"]:
        raise AssertionError(f"label files not rewritten: {stale}")
    log(f"[config] train_detector: {len(rec['step_launches'])} steps, losses "
        f"finite (last " + ", ".join(f"{k} {float(v[-1]):.4f}"
                                     for k, v in hist.items()
                                     if k.startswith("loss")) + "); NMS "
        f"{launches}: 0 in steps, {len(rec['chunk_launches'])} in refresh "
        f"chunks, {eval_launches} in the teacher's evaluation ({n_batches} "
        f"batches); bbox_mAP {logged[0]['bbox_mAP']}; every readable "
        f"unlabeled label file rewritten ({len(after) - 1}, PNG and JPEG), "
        f"{PNG_CUT}'s unchanged")
    worst = png_refresh(runner, tmp / "adamw", before)
    launches += png_refresh.launches
    del runner
    torch.cuda.empty_cache()

    cfg, _ = config_path_cfg(tmp / "momentum", sources,
                             dict(type="SGD", lr=0.01, momentum=MOMENTUM_BASE,
                                  weight_decay=1e-4), MOMENTUM_CONFIG)
    cfg.pop("evaluation")
    cfg["data"]["unlabel_pred"]["start_point"] = 2      # no refresh
    seen = []
    import dsl_tpu_torch.train.optim as optim_mod

    real_update = optim_mod.MMCVSGD.update

    def update(self, optimizer, count):
        norm = real_update(self, optimizer, count)
        seen.append(optimizer.param_groups[0]["momentum"])
        return norm

    optim_mod.MMCVSGD.update = update
    try:
        train_detector(Config(cfg), str(tmp / "momentum" / "work"), seed=0,
                       device=DEVICE)
    finally:
        optim_mod.MMCVSGD.update = real_update
    rel = (max(abs(a - b) / b for a, b in zip(seen, MOMENTUM_EXPECTED))
           if len(seen) == len(MOMENTUM_EXPECTED) else float("inf"))
    log(f"[config] SGD with momentum_config {MOMENTUM_CONFIG}: momentum at "
        f"updates 0-{len(seen) - 1} {[round(m, 6) for m in seen]}; the JAX "
        f"schedule's {[round(m, 6) for m in MOMENTUM_EXPECTED]}: worst "
        f"relative {rel:.2e} (limit {MOMENTUM_REL:g})")
    if rel > MOMENTUM_REL:
        raise AssertionError(f"momentum schedule: {seen}")
    return launches, worst


def png_refresh(runner, tmp: Path, before: dict) -> int:
    """A synchronous refresh of every unlabeled image (JPEG and PNG) and
    the cut PNG into a copy of the store as it was before training: the cut
    file is dropped before chunking, its label file stays, every other is
    rewritten, and each chunk's NMS keeps equal the plain version's. Sets
    ``png_refresh.launches``; returns the worst keep error."""
    import json as _json

    import torch

    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.train.label_store import LabelStore
    from torch_port_util import tree_of

    ref = runner.refresher
    root = tmp / "store_png"
    root.mkdir()
    for name, data in before.items():
        (root / name).write_bytes(data)
    skip = copy.copy(ref)
    skip.store = LabelStore(str(root), ref.store.id2cat, ref.store.cat2id)
    names = [i["filename"] for i in ref.image_infos]
    names.insert(len(names) // 2, PNG_CUT)
    start = nms_keep.launches
    with recording_nms() as calls:
        skip.refresh_images(runner.state, names)
        torch.cuda.synchronize()
    png_refresh.launches = nms_keep.launches - start
    worst = 0
    for boxes, vmask, thr, keep in calls:
        want = nms_keep_reference(boxes, vmask, thr)
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
    after = tree_of(root)
    chunks = -(-(len(names) - 1) // ref.refresh_batch)
    stale = [n for n in after if n != f"{PNG_CUT}.json"
             and "scores" not in _json.loads(after[n])]
    if (png_refresh.launches != chunks or worst or stale
            or after[f"{PNG_CUT}.json"] != before[f"{PNG_CUT}.json"]):
        raise AssertionError(f"PNG refresh: {png_refresh.launches} NMS launches "
                             f"for {chunks} chunks, keep error {worst}, not "
                             f"rewritten {stale}")
    pngs = sum(n.endswith(".png") for n in names) - 1
    log(f"[png] a synchronous refresh of {len(names)} files ({pngs} PNG, "
        f"{len(names) - 1 - pngs} JPEG, and {PNG_CUT}, which lacks its IEND "
        f"chunk): the cut file skipped before chunking, its label file "
        f"unchanged, the other {len(after) - 1} rewritten; {chunks} chunks, "
        f"{png_refresh.launches} NMS launches, keeps bit-identical to the "
        f"plain version")
    return worst


png_refresh.launches = 0

# -- the anchor-based detectors (phase 17) ----------------------------------

FASTER_RCNN_CONFIG = ROOT / "configs" / "faster_rcnn" / "faster_rcnn_r50_fpn_1x_coco.py"
RETINANET_CONFIG = ROOT / "configs" / "retinanet" / "retinanet_r50_fpn_1x_coco.py"
FASTER_RCNN_VOC_CONFIG = (ROOT / "configs" / "pascal_voc"
                          / "faster_rcnn_r50_fpn_1x_voc0712.py")
RPN_NMS_N = 4819              # 1000 candidates from each of P2-P5, 819 from P6
RPN_NMS_N_640 = 4300          # at 640x640: 1000 from each of P2-P5, 10x10x3 from P6
HRFPN_RPN_NMS_N = 4756        # HRFPN's P6 pools P2 at 16: 12x21 x 3 anchors
ROI_NMS_N = 2000              # multiclass_nms's pre_nms_top
ANCHOR_TIMED = 3              # predicts timed per detector and dtype
ANCHOR_TRAIN_B = 2            # the configs' samples_per_gpu
ANCHOR_WARMUP, ANCHOR_STEPS = 2, 5    # train steps: warm-ups, then timed
ANCHOR_DET_STEPS = 4          # Faster R-CNN steps per determinism run
ANCHOR_SMALL = (128, 192)     # the card-vs-CPU inputs
ROI_TIMED = 10                # RoIAlign forward / backward calls timed
VOC17_EPOCHS = 1


def _flat_tensors(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat_tensors(x)]
    return [tree]


def card_vs_cpu_outputs(det, inputs, cpu_det=None, **kw) -> float:
    """The worst |card - CPU| / max(max |CPU|, 1) over every tensor of
    ``det(inputs, **kw)``, the CPU run on ``cpu_det`` (a copy of the
    detector on the CPU, made here where not given; tensor keywords, and a
    list of tensors as ``inputs``, copied to the CPU too)."""
    import torch

    cpu_kw = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    cpu_in = ([x.cpu() for x in inputs] if isinstance(inputs, (list, tuple))
              else inputs.cpu())
    if cpu_det is None:
        cpu_det = copy.deepcopy(det).cpu()
    with torch.no_grad():
        gpu = _flat_tensors(det(inputs, **kw))
        cpu = _flat_tensors(cpu_det(cpu_in, **cpu_kw))
    return max(float((g.float().cpu() - c).abs().max()
                     / c.abs().max().clamp_min(1.0)) for g, c in zip(gpu, cpu))


def phase_anchor_predict(smi: str):
    """Faster R-CNN and RetinaNet R50-FPN predict at full width, counted.

    Each from its COCO config, with seeded numpy weights through the weight
    bridge (``random_weights.fill_variables``: the RoI head's ``fc_cls``
    with 8 live classes at logits in [1, 2], the background at 0 and the
    rest at -8, so each proposal puts about 1/9 on each live class, above
    ``score_thr`` 0.05; RetinaNet's ``retina_cls`` with 8 live classes as
    FCOS's classifier; the regressors small, so boxes stay near their
    anchors and proposals; ``score_thr`` is the config's), built by
    ``init_detector``. With the NMS count at 0, ``detector_predict`` on
    B=8 at 800x1344: Faster R-CNN in f32, RetinaNet in f32 and bf16. Dets
    finite (8, 100, 5) with detections in every image; exactly 2 NMS
    launches per Faster R-CNN predict (the RPN's at N = 4819, the RoI
    head's at N = 2000) and 1 per RetinaNet predict (N = 2000); every
    recorded input's keeps equal the plain version's; each image's RoI
    NMS input holds 2000 candidates over ``score_thr`` (so it runs at its
    full N); head outputs (the FPN levels, the RPN's and the RoI head's on
    seeded RoI features; RetinaNet's) card vs CPU within 1e-3 of the
    largest magnitude at 1x128x192; predict ms (median of ``ANCHOR_TIMED``) and img/s.
    Returns the launches, the worst keep difference, and the recorded
    (path, B, N, launches) and NMS inputs per path."""
    import numpy as np
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    launches, worst, paths, inputs = 0, 0, [], {}
    plan = ((FASTER_RCNN_CONFIG, (None,), ("rpn", "rcnn")),
            (RETINANET_CONFIG, (None, torch.bfloat16), ("retina",)))
    for path, dtypes, names in plan:
        cfg = Config.fromfile(str(path))
        tc = dict(cfg.model.test_cfg)
        max_per_img = dict(tc.get("rcnn", tc))["max_per_img"]
        bundle = init_detector(cfg, variables=seeded_variables(cfg),
                               device=DEVICE)
        det = bundle.detector
        kind = type(det).__name__
        log(f"[anchor] {path.relative_to(ROOT)}: {kind}, "
            f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M "
            f"parameters, B={BATCH} at {CANVAS[0]}x{CANVAS[1]}")
        for dtype in dtypes:
            tag = f"{kind} {'bf16' if dtype else 'f32'}"
            nms_keep.launches = 0
            with recording_nms() as calls:
                dets, labels, valid = detector_predict(
                    det, images, compute_dtype=dtype, device=DEVICE)
                torch.cuda.synchronize()
            n = nms_keep.launches
            launches += n
            want_n = [RPN_NMS_N, ROI_NMS_N] if kind == "FasterRCNN" else [ROI_NMS_N]
            got_shapes = [tuple(c[0].shape[:2]) for c in calls]
            if n != len(want_n) or got_shapes != [(BATCH, k) for k in want_n]:
                raise AssertionError(f"{tag}: {n} NMS launches at {got_shapes}, "
                                     f"expected one each at N = {want_n}")
            if tuple(dets.shape) != (BATCH, max_per_img, 5):
                raise AssertionError(f"{tag}: dets {tuple(dets.shape)}")
            if not bool(torch.isfinite(dets).all()):
                raise AssertionError(f"{tag}: dets are not finite")
            per_img = valid.sum(1).tolist()
            if min(per_img) == 0:
                raise AssertionError(f"{tag}: an image has no detection: {per_img}")
            for name, (boxes, v, thr, keep) in zip(names, calls):
                want = nms_keep_reference(boxes, v, thr)
                torch.cuda.synchronize()
                worst = max(worst, int((keep.int() - want.int()).abs().max()))
                if not torch.equal(keep, want):
                    raise AssertionError(f"{tag} {name} NMS keeps differ from "
                                         f"the plain version")
                log(f"[anchor] {tag} {name} NMS input {tuple(boxes.shape)} "
                    f"thr {thr}: {int(v.sum())} valid, {int(keep.sum())} kept "
                    f"— bit-identical to the plain version")
                if dtype is None:
                    inputs[name] = (boxes, v, thr)
                    paths.append(dict(path=name, B=BATCH, N=int(boxes.shape[1]),
                                      launches=1))
            roi_valid = calls[-1][1].sum(1).tolist()
            if min(roi_valid) < ROI_NMS_N:
                raise AssertionError(f"{tag}: fewer than {ROI_NMS_N} candidates "
                                     f"over score_thr: {roi_valid}")
            log(f"[anchor] {tag}: dets {tuple(dets.shape)} finite, valid per "
                f"image {per_img}, labels seen "
                f"{sorted(set(labels[valid].tolist()))[:10]}, NMS launches {n}")

            def predict():
                return detector_predict(det, images, compute_dtype=dtype,
                                        device=DEVICE)

            torch.cuda.reset_peak_memory_stats()
            times = sorted(host_ms(predict, reps=ANCHOR_TIMED))
            ms = times[len(times) // 2]
            log(f"[time] {tag} predict B={BATCH} {CANVAS[0]}x{CANVAS[1]}: median "
                f"{ms:.2f} ms/batch (min {times[0]:.2f}, max {times[-1]:.2f}, "
                f"{ANCHOR_TIMED} reps), {BATCH / ms * 1e3:.1f} img/s, peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                f"  ({smi})")
        small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
        rel = card_vs_cpu_outputs(det, small)
        if kind == "FasterRCNN":
            head = det.bbox_head
            rf = torch.from_numpy(np.random.RandomState(17).randn(
                64, head.in_channels, head.roi_size, head.roi_size).astype(
                    np.float32)).to(DEVICE)
            rel = max(rel, card_vs_cpu_outputs(det, rf, stage="roi"))
        log(f"[anchor] {kind} f32 head outputs, card vs CPU at "
            f"1x{ANCHOR_SMALL[0]}x{ANCHOR_SMALL[1]}: worst |diff| / max|ref| = "
            f"{rel:.3e}")
        if rel > 1e-3:
            raise AssertionError(f"{kind}: card and CPU disagree: {rel}")
        del bundle, det
        torch.cuda.empty_cache()
    return launches, worst, paths, inputs


def anchor_batch(seed: int, canvas, b: int, num_classes: int, device):
    """A seeded batch of ``b`` labeled images with 1-20 GT boxes each (K=100,
    sides 16-600 px, integer corners), ``img_shapes`` the canvas."""
    import numpy as np

    from dsl_tpu_torch.utils.random_batch import semi_batch, to_torch

    rng = np.random.RandomState(seed)
    side = (16, 600) if canvas[0] >= 600 else (8, 100)
    raw = semi_batch(seed, canvas, n_gt=list(rng.randint(1, 21, b)),
                     n_ignore=[0] * b, n_labeled=b, side=side,
                     num_classes=num_classes)
    out = {k: raw[k][:b] for k in ("images", "gt_bboxes", "gt_labels",
                                   "gt_valid")}
    out["img_shapes"] = np.tile(np.asarray(canvas, np.float32), (b, 1))
    return to_torch(out, device)


@contextlib.contextmanager
def host_sampler_draws():
    """The two-stage samplers' draws (PointRend's point draws too) made on
    the CPU and moved to the device, so that a step on the card and one on
    the CPU sample alike."""
    from dsl_tpu_torch.models.detectors import two_stage

    real = two_stage.sampler_draws

    def on_host(cur_iter, b, a, n, device, **kw):
        draws = real(cur_iter, b, a, n, "cpu", **kw)
        return {key: (v.to(device) if hasattr(v, "to")
                      else tuple(x.to(device) for x in v))
                for key, v in draws.items()}

    two_stage.sampler_draws = on_host
    try:
        yield
    finally:
        two_stage.sampler_draws = real


def roi_align_timing(state, batch, smi: str) -> dict:
    """RoIAlign forward and backward at the Faster R-CNN step's shapes: the
    RoIs a step samples (2 x 512) from P2-P5 of the batch, timed by CUDA
    events (the backward on a kept graph), beside the bound: the bytes
    the function must move (forward: each feature row its samples touch,
    read once, and the output written once; backward: the output gradient
    read once and the whole table's gradient written once) over the card's
    memory rate, against its multiply-adds over the f32 rate."""
    import torch

    from dsl_tpu_torch.models.detectors import two_stage
    from dsl_tpu_torch.models.dense_heads.rpn_head import rpn_proposals
    from dsl_tpu_torch.models.roi_heads import standard_roi_head as roi
    from dsl_tpu_torch.ops.roi_align import roi_align_rows, sample_taps

    det = state.student
    head = det.bbox_head
    with torch.no_grad():
        feats, (scores, deltas) = det(batch["images"])
        props, _, pvalid = rpn_proposals(
            det.rpn_head, scores, deltas, img_shapes=batch["img_shapes"],
            nms_pre=two_stage.TRAIN_PROPOSALS,
            num_proposals=two_stage.TRAIN_PROPOSALS)
        draws = two_stage.sampler_draws(
            0, ANCHOR_TRAIN_B, sum(s[0].numel() for s in scores),
            two_stage.TRAIN_PROPOSALS + batch["gt_bboxes"].shape[1], DEVICE)
        samples = roi.sample_batch_rois(props, pvalid, batch, draws["rcnn"][0],
                                        head.num_classes,
                                        **two_stage.parse_rcnn_train_cfg(None))
    rois = roi.flat_rois(samples["rois"])
    valid = samples["valid"].reshape(-1)
    levels = [f.detach().clone().requires_grad_(True)
              for f in feats[:len(det.strides)]]
    table, base, height, width, scale = roi.level_table(levels, rois,
                                                        det.strides)
    args = (rois[:, 1:5], base, height, width, scale)

    def forward():
        return roi_align_rows(table, *args, valid)

    fwd = cuda_ms(lambda: forward(), reps=ROI_TIMED)
    out = forward()
    cot = torch.randn_like(out)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, table, cot,
                                              retain_graph=True),
                  reps=ROI_TIMED)
    idx, _ = sample_taps(*args)
    n, c = out.shape[0], out.shape[-1]
    touched = int(torch.unique(idx[:, valid]).numel())
    out_bytes = out.numel() * 4
    fwd_bytes = touched * c * 4 + out_bytes
    bwd_bytes = out_bytes + table.numel() * 4
    macs = idx.shape[0] * out.numel()          # one multiply-add per tap
    result = {}
    for tag, ms, nbytes in (("forward", fwd, fwd_bytes),
                            ("backward", bwd, bwd_bytes)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2 * macs / H100_F32_FLOP_PER_S * 1e3
        bound, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
        result[tag] = dict(ms=ms, bound_ms=bound, bound_by=by)
        log(f"[time] RoIAlign {tag} at the step's shapes ({n} RoIs, "
            f"{int(valid.sum())} valid, C={c}, 7x7, 2x2 samples; table "
            f"{table.shape[0]} rows, {touched} touched): {ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {nbytes} bytes, {2 * macs} ops), "
            f"{ms / bound:.1f}x the bound  ({smi})")
    return result


def anchor_step_runs(cfg, variables, batch, steps: int):
    """``steps`` f32 steps of the train entry point from the seeded state:
    each step's metrics (floats), each step's ms (host clock to a
    synchronize), the state and the step."""
    import torch

    state, step = train_entry(cfg, variables, None, DEVICE)
    metrics, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, times, state, step


def phase_anchor_train(smi: str):
    """Faster R-CNN and RetinaNet train steps at full width, f32, cuDNN
    deterministic (the caller holds it). The train entry point
    (``train_entry``: the config's SGD, clip and schedule) on a seeded batch
    of the configs' B=2 at 800x1344; with the NMS count at 0,
    ``ANCHOR_WARMUP`` + ``ANCHOR_STEPS`` steps: losses finite with every
    loss key, 1 NMS launch per Faster R-CNN step (its training proposals)
    and 0 per RetinaNet step; step ms (median of the timed ones), img/s,
    peak memory; then RoIAlign forward and backward at the step's shapes
    (:func:`roi_align_timing`); one step card vs CPU on a 2x128x192 batch
    (losses within 1e-4, ``grad_norm`` within 1e-3, updates banded as in
    phase 6; the samplers' draws made on the host for both); and two
    Faster R-CNN runs of ``ANCHOR_DET_STEPS`` steps from one seeded state,
    bit-identical (every loss, every parameter). Returns the NMS launches
    and the RoIAlign times."""
    import numpy as np
    import torch

    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep

    launches, roi_times = 0, None
    keys = {"FasterRCNN": {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                           "loss_bbox", "acc", "loss", "grad_norm"},
            "RetinaNet": {"loss_cls", "loss_bbox", "loss", "grad_norm"}}
    for path in (FASTER_RCNN_CONFIG, RETINANET_CONFIG):
        cfg = Config.fromfile(str(path))
        variables = seeded_variables(cfg)
        nc = cfg.model.bbox_head.num_classes
        batch = anchor_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc, DEVICE)
        torch.cuda.reset_peak_memory_stats()
        nms_keep.launches = 0
        metrics, times, state, _ = anchor_step_runs(
            cfg, variables, batch, ANCHOR_WARMUP + ANCHOR_STEPS)
        n = nms_keep.launches
        launches += n
        kind = type(state.student).__name__
        per_step = 1 if kind == "FasterRCNN" else 0
        if n != per_step * len(metrics):
            raise AssertionError(f"{kind} steps: {n} NMS launches over "
                                 f"{len(metrics)} steps, expected {per_step} each")
        for i, m in enumerate(metrics):
            if set(m) != keys[kind] or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{kind} step {i}: {m}")
        timed = sorted(times[ANCHOR_WARMUP:])
        ms = timed[len(timed) // 2]
        log(f"[train] {kind} f32 B={ANCHOR_TRAIN_B} {CANVAS[0]}x{CANVAS[1]}: "
            f"first step " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       sorted(metrics[0].items()))
            + f"; last " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     sorted(metrics[-1].items()))
            + f"; NMS launches {n}")
        log(f"[time] {kind} train step f32 B={ANCHOR_TRAIN_B}: median {ms:.2f} "
            f"ms (min {timed[0]:.2f}, max {timed[-1]:.2f}, {ANCHOR_STEPS} after "
            f"{ANCHOR_WARMUP} warm-ups), {ANCHOR_TRAIN_B / ms * 1e3:.2f} img/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            f"  ({smi})")
        if kind == "FasterRCNN":
            roi_times = roi_align_timing(state, batch, smi)
        del state
        torch.cuda.empty_cache()

        # one step, card vs CPU, on a small batch with the same draws
        results = {}
        with host_sampler_draws():
            for device in (DEVICE, "cpu"):
                st, step = train_entry(cfg, variables, None, device)
                init = {k: p.detach().cpu().clone()
                        for k, p in st.student.named_parameters()}
                m = step(st, anchor_batch(TRAIN_SEED + 1, ANCHOR_SMALL,
                                          ANCHOR_TRAIN_B, nc, device))
                results[device] = ({k: float(v) for k, v in m.items()},
                                   {k: p.detach().cpu() for k, p in
                                    st.student.named_parameters()})
        (m_card, p_card), (m_cpu, p_cpu) = results[DEVICE], results["cpu"]
        for k, v in m_cpu.items():
            rel = abs(m_card[k] - v) / max(abs(v), 1e-12)
            if rel > (1e-3 if k == "grad_norm" else 1e-4):
                raise AssertionError(f"{kind} card vs CPU {k}: {m_card[k]} vs {v}")
        worst, l2 = banded_max_ratio(p_card, p_cpu, init)
        log(f"[train] {kind} card vs CPU, one f32 step at {ANCHOR_TRAIN_B}x"
            f"{ANCHOR_SMALL[0]}x{ANCHOR_SMALL[1]}: " + ", ".join(
                f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}" for k in sorted(m_cpu))
            + f"; updates: worst banded ratio {worst:.3f} (limit 1), relative "
            f"L2 {l2:.2e} (limit 1e-3)")
        if worst > 1 or l2 > 1e-3:
            raise AssertionError(f"{kind} card vs CPU updates: banded ratio "
                                 f"{worst}, L2 {l2}")
        if kind == "FasterRCNN":
            nms_keep.launches = 0
            runs = []
            for _ in range(2):
                m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                            ANCHOR_DET_STEPS)
                runs += [m, {k: p.detach().clone() for k, p in
                             st.student.named_parameters()}]
                del st
            launches += nms_keep.launches
            check_deterministic(*runs)
            del runs
        torch.cuda.empty_cache()
    return launches, roi_times


def voc_dir(tmp: Path) -> dict:
    """Phase 14's synthetic VOC2007 directory (made again, from the same
    seed, where phase 14 has not run in this process)."""
    from dsl_tpu_torch.utils import synthetic_data

    voc = tmp / "semivoc" / "VOC2007"
    main = voc / "ImageSets" / "Main"
    if not (main / "test.txt").exists():
        files, _ = fixtures()
        return synthetic_data.make_voc_dir(
            tmp / "semivoc", [(str(p), h, w) for _, p, h, w in files],
            VOC_TRAINVAL, VOC_TEST)
    return dict(voc_root=str(voc), images=str(voc / "JPEGImages"),
                trainval=str(main / "trainval.txt"), test=str(main / "test.txt"))


def phase_anchor_voc(tmp: Path, smi: str) -> int:
    """The VOC workflow with Faster R-CNN at full width: ``train_detector``
    on ``configs/pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py`` (its data
    blocks name no pipeline: ``voc_detector_config`` gives them the
    config's train and test pipelines and phase 14's VOC2007 directory),
    ``VOC17_EPOCHS`` epoch of its trainval split at B=2 with seeded
    weights, and the evaluation after it on the test split; then the test
    CLI on the checkpoint with ``--eval mAP`` (:func:`run_test_cli`). The NMS
    count is at 0 before each and read after: 1 launch per step (its
    training proposals) and 2 per predicted batch. Losses finite, ``mAP``
    in [0, 1]. Returns the NMS launches."""
    import math

    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.synthetic_data import voc_detector_config

    t0 = time.perf_counter()
    voc = voc_dir(tmp)
    cfg = voc_detector_config(
        Config.fromfile(str(FASTER_RCNN_VOC_CONFIG)).to_dict(), voc)
    cfg["runner"]["max_epochs"] = VOC17_EPOCHS
    cfg["log_config"] = dict(interval=1)
    work = tmp / "voc17"
    cfg_path = tmp / "faster_rcnn_voc17.py"
    Config(cfg).dump(str(cfg_path))
    n_test = len(Path(voc["test"]).read_text().split())
    batches = math.ceil(n_test / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(cfg), str(work), device=DEVICE,
                   variables=seeded_variables(Config(cfg)))
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    if not steps or not all(math.isfinite(x["loss"]) for x in steps):
        raise AssertionError(f"VOC Faster R-CNN losses: {steps}")
    if len(val) != VOC17_EPOCHS or not 0.0 <= val[-1]["mAP"] <= 1.0:
        raise AssertionError(f"VOC Faster R-CNN evaluation: {val}")
    if launches != len(steps) + 2 * batches * VOC17_EPOCHS:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per step and 2 per evaluation batch")
    log(f"[voc17] {FASTER_RCNN_VOC_CONFIG.relative_to(ROOT)}: "
        f"{len(steps)} steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in ("loss_rpn_cls", "loss_rpn_bbox",
                                                "loss_cls", "loss_bbox", "loss"))
        + f"), VOC mAP after the epoch {val[-1]['mAP']:.4f}, NMS launches "
        f"{launches}")
    child, out = run_test_cli([str(cfg_path),
                               str(work / f"epoch_{VOC17_EPOCHS}.pth"),
                               "--eval", "mAP"], tag="voc17")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if not 0.0 <= metrics["mAP"] <= 1.0 or child != 2 * batches:
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[voc17] test CLI --eval mAP: {metrics}, NMS launches {child}; "
        f"phase part {time.perf_counter() - t0:.1f} s")
    return launches + child


SSD_VOC_CONFIG = ROOT / "configs" / "pascal_voc" / "ssd300_voc0712.py"
SSD512_VOC_CONFIG = ROOT / "configs" / "pascal_voc" / "ssd512_voc0712.py"
SSD_DATA_CONFIG = ROOT / "configs" / "_base_" / "datasets" / "wider_face.py"
RPN_CONFIG = ROOT / "configs" / "rpn" / "rpn_r50_fpn_1x_coco.py"
FAST_RCNN_CONFIG = ROOT / "configs" / "fast_rcnn" / "fast_rcnn_r50_fpn_1x_coco.py"
VARIANT_CONFIGS = tuple(ROOT / "configs" / p for p in (
    "faster_rcnn/faster_rcnn_x101_64x4d_fpn_1x_coco.py",
    "gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py"))
SSD_CANVAS = (300, 300)
SSD_NMS_N = 2000              # multiclass_nms's pre_nms_top
ONE_LEVEL_RPN_NMS_N = 1000    # one level (DC5, C4): its nms_pre
P18_TIMED = 3                 # predicts timed per path (median)
P18_STEPS = 1                 # steps timed per path, after one warm-up
SSD_EPOCHS = 1
# the standalone RPN configs' train_cfg (mmdet's rpn_r50_fpn.py); the
# repo's file inherits Faster R-CNN's model, which sets none
RPN_TRAIN_CFG = dict(rpn=dict(allowed_border=0))


def predict_counted(tag: str, fn, want_n: list, shape: tuple):
    """``fn()`` (a predict) with the NMS count at 0 and every input
    recorded: the launches must be one per entry of ``want_n`` at (B, N),
    the dets finite of ``shape`` with a detection in every image, each
    recorded input's keeps equal to the plain version's. Returns (dets,
    valid, the recorded calls, the worst keep difference)."""
    import torch

    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    nms_keep.launches = 0
    with recording_nms() as calls:
        dets, _, valid = fn()
        torch.cuda.synchronize()
    got = [tuple(c[0].shape[:2]) for c in calls]
    if nms_keep.launches != len(want_n) or got != [(shape[0], n) for n in want_n]:
        raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches at {got}, "
                             f"expected one each at N = {want_n}")
    if tuple(dets.shape) != shape or not bool(torch.isfinite(dets).all()):
        raise AssertionError(f"{tag}: dets {tuple(dets.shape)}, finite "
                             f"{bool(torch.isfinite(dets).all())}")
    per_img = valid.sum(1).tolist()
    if min(per_img) == 0:
        raise AssertionError(f"{tag}: an image has no detection: {per_img}")
    worst = 0
    for boxes, v, thr, keep in calls:
        want = nms_keep_reference(boxes, v, thr)
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError(f"{tag}: NMS keeps differ from the plain "
                                 f"version at {tuple(boxes.shape)}")
    log(f"[p18] {tag}: dets {tuple(dets.shape)} finite, valid per image "
        f"{per_img}, NMS launches {len(calls)} at {got}, keeps bit-identical "
        f"to the plain version")
    return dets, valid, calls, worst


def time_predict(tag: str, fn, b: int, smi: str, trace: bool = False,
                 reps: int = P18_TIMED, peak: bool = False) -> float:
    """Median ms of ``reps`` calls of ``fn`` (host clock to a
    synchronize), logged with img/s. With ``trace`` or ``peak``, one more
    call's peak memory is logged too, and with ``trace`` its
    :func:`roi_align_share`."""
    import torch

    times = sorted(host_ms(fn, reps=reps))
    ms = times[len(times) // 2]
    log(f"[time] {tag} predict B={b}: median {ms:.2f} ms/batch (min "
        f"{times[0]:.2f}, max {times[-1]:.2f}, {reps} reps), "
        f"{b / ms * 1e3:.1f} img/s  ({smi})")
    if trace or peak:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        log(f"[time] {tag} predict B={b}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({smi})")
    if trace:
        roi_align_share(f"{tag} predict B={b}", fn, smi)
    return ms


def time_steps(tag: str, cfg, variables, batch, smi: str,
               trace: bool = False, timed: int = P18_STEPS,
               peak: bool = False) -> tuple[dict, int]:
    """One warm-up and ``timed`` f32 steps of the train entry
    point from the seeded weights: losses finite; the median step ms
    logged. With ``trace`` or ``peak``, the peak memory over those steps
    is logged too, and with ``trace`` the :func:`roi_align_share` of
    further steps. Returns the last timed step's metrics and the number of
    steps taken."""
    import math

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times, state, step = anchor_step_runs(cfg, variables, batch,
                                                   1 + timed)
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag} step: {m}")
    after = sorted(times[1:])
    ms = after[len(after) // 2]
    b = batch["images"].shape[0]
    log(f"[time] {tag} train step f32 B={b}: median {ms:.2f} ms (min "
        f"{after[0]:.2f}, max {after[-1]:.2f}, {timed} after a warm-up), "
        f"{b / ms * 1e3:.2f} img/s; last step " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(metrics[-1].items()))
        + f"  ({smi})")
    steps = len(metrics)
    if trace or peak:
        log(f"[time] {tag} train step f32 B={b}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  ({smi})")
    if trace:
        steps += roi_align_share(f"{tag} train step B={b}",
                                 lambda: step(state, batch), smi)["calls"]
    del state, step
    return metrics[-1], steps


def step_card_vs_cpu(tag: str, cfg, variables, canvas, b: int, nc: int,
                     make_batch=None):
    """One f32 step of the train entry point on a seeded batch
    (``make_batch(device)``, else :func:`anchor_batch`), on the card and on
    the CPU (the samplers' draws made on the host): losses within 1e-4,
    ``grad_norm`` within 1e-3 relative, updates banded as in phase 6."""
    make_batch = make_batch or (lambda device: anchor_batch(
        TRAIN_SEED + 1, canvas, b, nc, device))
    results = {}
    with host_sampler_draws():
        for device in (DEVICE, "cpu"):
            st, step = train_entry(cfg, variables, None, device)
            init = {k: p.detach().cpu().clone()
                    for k, p in st.student.named_parameters()}
            m = step(st, make_batch(device))
            results[device] = ({k: float(v) for k, v in m.items()},
                               {k: p.detach().cpu() for k, p in
                                st.student.named_parameters()})
    (m_card, p_card), (m_cpu, p_cpu) = results[DEVICE], results["cpu"]
    for k, v in m_cpu.items():
        rel = abs(m_card[k] - v) / max(abs(v), 1e-12)
        if rel > (1e-3 if k == "grad_norm" else 1e-4):
            raise AssertionError(f"{tag} card vs CPU {k}: {m_card[k]} vs {v}")
    worst, l2 = banded_max_ratio(p_card, p_cpu, init)
    log(f"[p18] {tag} card vs CPU, one f32 step at {b}x{canvas[0]}x"
        f"{canvas[1]}: " + ", ".join(f"{k} {m_card[k]:.6f}/{m_cpu[k]:.6f}"
                                     for k in sorted(m_cpu))
        + f"; updates: worst banded ratio {worst:.3f} (limit 1), relative "
        f"L2 {l2:.2e} (limit 1e-3)")
    if worst > 1 or l2 > 1e-3:
        raise AssertionError(f"{tag} card vs CPU updates: banded ratio "
                             f"{worst}, L2 {l2}")


def phase_ssd(tmp: Path, smi: str):
    """SSD300 and SSD512 on VOC (the docstring's phase 18, first part).
    Returns the NMS launches, the worst keep difference and the recorded
    (path, input) of the B=8 predict."""
    import numpy as np
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data.pipelines.image_ops import resize_linear_f32
    from dsl_tpu_torch.models import detector_predict

    launches, worst = 0, 0
    cfg = Config.fromfile(str(SSD_VOC_CONFIG))
    variables = seeded_variables(cfg)
    bundle = init_detector(cfg, variables=variables, device=DEVICE)
    det = bundle.detector
    nc = cfg.model.bbox_head.num_classes
    max_per_img = cfg.model.test_cfg.max_per_img
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    images = torch.randn((BATCH, 3, *SSD_CANVAS), generator=gen, device=DEVICE)
    shapes = torch.tensor([SSD_CANVAS] * BATCH, dtype=torch.float32,
                          device=DEVICE)
    levels = [tuple(c.shape[1:3]) for c in det(images[:1])[0]]
    n_anchors = sum(h * w * det.bbox_head.anchors.num_base_anchors_level(i)
                    for i, (h, w) in enumerate(levels))
    log(f"[p18] {SSD_VOC_CONFIG.relative_to(ROOT)}: SSD, "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters, "
        f"levels {levels}, {n_anchors} anchors, B={BATCH} at "
        f"{SSD_CANVAS[0]}x{SSD_CANVAS[1]}")

    def predict():
        return detector_predict(det, images, img_shapes=shapes, device=DEVICE)

    _, _, calls, w = predict_counted("SSD300 f32", predict, [SSD_NMS_N],
                                     (BATCH, max_per_img, 5))
    launches, worst = launches + 1, max(worst, w)
    ssd_input = calls[0][:3]
    ms = time_predict("SSD300 f32", predict, BATCH, smi)
    rel = card_vs_cpu_outputs(det, images[:1])
    log(f"[p18] SSD300 f32 head outputs, card vs CPU at 1x300x300: worst "
        f"|diff| / max|ref| = {rel:.3e}")
    if rel > 1e-3:
        raise AssertionError(f"SSD300: card and CPU disagree: {rel}")
    del bundle, det
    torch.cuda.empty_cache()

    cfg512 = Config.fromfile(str(SSD512_VOC_CONFIG))
    det512 = init_detector(cfg512, variables=seeded_variables(cfg512),
                           device=DEVICE).detector
    im512 = torch.randn((BATCH, 3, 512, 512), generator=gen, device=DEVICE)
    _, _, _, w = predict_counted(
        "SSD512 f32", lambda: detector_predict(det512, im512, device=DEVICE),
        [SSD_NMS_N], (BATCH, cfg512.model.test_cfg.max_per_img, 5))
    launches, worst = launches + 1, max(worst, w)
    del det512, im512
    torch.cuda.empty_cache()

    with deterministic_cudnn():
        b = cfg.data.samples_per_gpu
        step_card_vs_cpu("SSD300", cfg, variables, SSD_CANVAS, b, nc)
        from dsl_tpu_torch.ops.nms import nms_keep

        nms_keep.launches = 0
        time_steps("SSD300", cfg, variables,
                   anchor_batch(TRAIN_SEED, SSD_CANVAS, b, nc, DEVICE), smi)
        if nms_keep.launches:
            raise AssertionError(f"SSD steps launched NMS {nms_keep.launches} "
                                 f"times")
        torch.cuda.empty_cache()
        launches += phase_ssd_voc(tmp, cfg, variables)

    # the float resize, card vs CPU, bit for bit
    files, _ = fixtures()
    for _, path, h, w_ in files[:2]:
        from dsl_tpu_torch.data.image_io import read_image

        img = read_image(str(path), DEVICE).float()
        for dst in ((300, 300), (512, 512), (h * 3 // 2, w_ // 3)):
            got = resize_linear_f32(img, *dst)
            want = resize_linear_f32(img.cpu(), *dst)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"float resize {path.name} -> {dst}: card "
                                     f"and CPU differ")
    resize_ms = cuda_ms(lambda: resize_linear_f32(img, 300, 300), reps=20)
    log(f"[p18] float resize card vs CPU bit-identical on 2 decodes x 3 "
        f"sizes; {tuple(img.shape)} -> 300x300: {resize_ms:.4f} ms  ({smi})")
    return launches, worst, [dict(path="ssd", B=BATCH, N=SSD_NMS_N,
                                  launches=1, predict_ms=ms)], {"ssd": ssd_input}


def phase_ssd_voc(tmp: Path, cfg, variables) -> int:
    """``train_detector`` on the SSD300 VOC config for ``SSD_EPOCHS`` over
    phase 14's VOC2007 directory through SSD's float train pipeline, then
    the test CLI's ``--eval mAP``; the NMS launches: none per step, one per
    predicted batch."""
    import math

    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.synthetic_data import (
        ssd_pipeline, voc_detector_config)

    t0 = time.perf_counter()
    voc = voc_dir(tmp)
    data = Config.fromfile(str(SSD_DATA_CONFIG))
    raw = cfg.to_dict()
    raw["train_pipeline"] = ssd_pipeline(data.get("train_pipeline"))
    raw["test_pipeline"] = ([dict(type="LoadImageFromFile")]
                            + copy.deepcopy(data.get("test_pipeline")))
    raw["canvas_hw"] = list(SSD_CANVAS)
    raw = voc_detector_config(raw, voc)
    raw["runner"]["max_epochs"] = SSD_EPOCHS
    raw["evaluation"] = dict(interval=1, metric="mAP")
    raw["log_config"] = dict(interval=1)
    work = tmp / "ssd18"
    cfg_path = tmp / "ssd300_voc18.py"
    Config(raw).dump(str(cfg_path))
    n_test = len(Path(voc["test"]).read_text().split())
    batches = math.ceil(n_test / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE, variables=variables)
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    if not steps or not all(math.isfinite(x["loss"]) for x in steps):
        raise AssertionError(f"VOC SSD losses: {steps}")
    if len(val) != SSD_EPOCHS or not 0.0 <= val[-1]["mAP"] <= 1.0:
        raise AssertionError(f"VOC SSD evaluation: {val}")
    if launches != batches * SSD_EPOCHS:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per evaluation batch")
    log(f"[p18] SSD300 train_detector on VOC through the float pipeline: "
        f"{len(steps)} steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in ("loss_cls", "loss_bbox",
                                                "loss"))
        + f"), VOC mAP {val[-1]['mAP']:.4f}, NMS launches {launches}")
    child, out = run_test_cli([str(cfg_path),
                               str(work / f"epoch_{SSD_EPOCHS}.pth"),
                               "--eval", "mAP"], tag="ssd18")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if not 0.0 <= metrics["mAP"] <= 1.0 or child != batches:
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[p18] SSD300 test CLI --eval mAP: {metrics}, NMS launches {child}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches + child


def phase_rpn_fast(smi: str):
    """The standalone RPN and Fast R-CNN on its proposals (the docstring's
    phase 18). Returns the NMS launches, the worst keep difference and the
    recorded (path, input) pairs."""
    import numpy as np
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.core.eval.mean_ap import eval_recalls
    from dsl_tpu_torch.data.pipelines import Compose
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.models.detectors.two_stage import fast_rcnn_predict
    from dsl_tpu_torch.ops.nms import nms_keep

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    shapes = torch.tensor([CANVAS] * BATCH, dtype=torch.float32, device=DEVICE)
    cfg = Config.fromfile(str(RPN_CONFIG))
    cfg.model["train_cfg"] = copy.deepcopy(RPN_TRAIN_CFG)
    variables = seeded_variables(cfg)
    det = init_detector(cfg, variables=variables, device=DEVICE).detector
    log(f"[p18] {RPN_CONFIG.relative_to(ROOT)}: RPN, "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters")

    def rpn_predict():
        return detector_predict(det, images, img_shapes=shapes, device=DEVICE)

    props, pvalid, calls, worst = predict_counted(
        "RPN f32", rpn_predict, [RPN_NMS_N], (BATCH, 1000, 5))
    inputs = {"rpn_only": calls[0][:3]}
    rpn_ms = time_predict("RPN f32", rpn_predict, BATCH, smi)
    gt = anchor_batch(TRAIN_SEED + 3, CANVAS, BATCH, 80, "cpu")
    gts = [gt["gt_bboxes"][i][gt["gt_valid"][i]].numpy() for i in range(BATCH)]
    props_np = [props[i][pvalid[i]].cpu().numpy() for i in range(BATCH)]
    recalls = eval_recalls(gts, props_np, proposal_nums=(100, 300, 1000),
                           iou_thrs=(0.5,))
    if not (np.isfinite(recalls).all() and (recalls >= 0).all()
            and (recalls <= 1).all()):
        raise AssertionError(f"RPN recalls: {recalls}")
    log(f"[p18] RPN eval_recalls at IoU 0.5 over {sum(len(g) for g in gts)} "
        f"seeded GT boxes, top 100/300/1000: {recalls[:, 0].tolist()}")
    with deterministic_cudnn():
        nms_keep.launches = 0
        m, _ = time_steps("RPN (allowed_border 0)", cfg, variables,
                          anchor_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, 80,
                                       DEVICE), smi)
        if nms_keep.launches or set(m) != {"loss_rpn_cls", "loss_rpn_bbox",
                                           "loss", "grad_norm"}:
            raise AssertionError(f"RPN steps: {m}, {nms_keep.launches} NMS")
    del det
    torch.cuda.empty_cache()

    fcfg = Config.fromfile(str(FAST_RCNN_CONFIG))
    fast = init_detector(fcfg, variables=seeded_variables(fcfg),
                         device=DEVICE).detector
    # the proposals through LoadProposals, as a Fast R-CNN test pipeline
    # reads them, then padded to a batch
    load = Compose([dict(type="LoadProposals", num_max_proposals=1000)])
    rows = [load(dict(proposals=props_np[i]), np.random.RandomState(0))[
        "proposals"] for i in range(BATCH)]
    p_max = max(len(r) for r in rows)
    fprops = torch.zeros((BATCH, p_max, 4), device=DEVICE)
    fvalid = torch.zeros((BATCH, p_max), dtype=torch.bool, device=DEVICE)
    for i, r in enumerate(rows):
        fprops[i, :len(r)] = torch.from_numpy(r).to(DEVICE)
        fvalid[i, :len(r)] = True

    def fast_predict():
        return fast_rcnn_predict(fast, images, fprops, fvalid,
                                 img_shapes=shapes)

    _, _, calls, w = predict_counted(
        "Fast R-CNN f32", fast_predict, [ROI_NMS_N],
        (BATCH, fcfg.model.test_cfg.rcnn.max_per_img, 5))
    inputs["fast_rcnn"] = calls[0][:3]
    fast_ms = time_predict("Fast R-CNN f32", fast_predict, BATCH, smi)
    del fast
    torch.cuda.empty_cache()
    paths = [dict(path="rpn_only", B=BATCH, N=RPN_NMS_N, launches=1,
                  predict_ms=rpn_ms),
             dict(path="fast_rcnn", B=BATCH, N=ROI_NMS_N, launches=1,
                  predict_ms=fast_ms)]
    return 2, max(worst, w), paths, inputs


def expected_loss_keys(det) -> set:
    """The loss keys a two-stage detector's step gives on a batch with
    masks: the RPN's, the RoI head's (each cascade stage's, ``s{i}.``),
    ``loss_mask`` where there is a mask head (per stage in a cascade but
    SCNet, whose one mask head runs after the stages), ``loss_mask_iou``
    where there is a mask IoU head, ``loss_semantic_seg`` where there is a
    semantic head (HTC, SCNet), SCNet's ``loss_glbctx``, ``loss_point``
    where there is a point head (PointRend) and ``loss_cls_objectness``
    per SeesawLoss head."""
    roi = ["loss_cls", "loss_bbox"]
    scnet = getattr(det, "glbctx_head", None) is not None
    keys = {"loss_rpn_cls", "loss_rpn_bbox"}
    if getattr(det, "mask_head", None) is not None:
        if scnet:
            keys |= {"loss_mask", "loss_glbctx"}
        else:
            roi.append("loss_mask")
    heads = getattr(det, "bbox_heads", None)
    keys |= ({f"s{i}.{k}" for i in range(len(heads)) for k in roi}
             if heads is not None else set(roi))
    if getattr(det, "mask_iou_head", None) is not None:
        keys.add("loss_mask_iou")
    if getattr(det, "semantic_head", None) is not None:
        keys.add("loss_semantic_seg")
    if getattr(det, "point_head", None) is not None:
        keys.add("loss_point")
    for i, head in enumerate(heads if heads is not None else [det.bbox_head]):
        if getattr(head, "seesaw", False):
            keys.add("loss_cls_objectness" if heads is None
                     else f"s{i}.loss_cls_objectness")
    return keys


def phase_variants(smi: str, configs=VARIANT_CONFIGS, b: int = BATCH,
                   seed: int = 20, phase: str = "p18", probe=None,
                   trace: bool = False, timed: int = P18_TIMED,
                   steps: int = P18_STEPS, peak: bool = False,
                   canvas=None, prepare=None):
    """Two-stage variants (``VARIANT_CONFIGS`` by default), uncut, seeded:
    one counted predict at B=``b`` (2 NMS launches: the RPN's at N =
    ``RPN_NMS_N``, or ``ONE_LEVEL_RPN_NMS_N`` on one level, the RoI head's
    at N = ``ROI_NMS_N``; keeps equal; a two-stage detector with a mask
    head predicts through ``mask_rcnn_predict``, its probabilities in
    [0, 1], a cascade its boxes, HTC and SCNet also their probabilities),
    timed (the median of ``timed``), then ``steps`` timed steps after a
    warm-up at B=2 (on a :func:`mask_batch` where
    there is a mask head; every key of :func:`expected_loss_keys`, finite;
    1 NMS launch per step). With ``trace``, the timed predict and steps
    also log their peak memory and :func:`roi_align_share`, with ``peak``
    their peak memory alone.
    ``probe(tag, cfg, variables, det, images)``, where given, runs after
    the timed predict and returns the NMS launches it made. Returns the NMS
    launches, the worst keep difference, and per config its path entry
    (tag, B, N, launches, predict ms) and its recorded RoI NMS input."""
    import numpy as np
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.models.detectors.cascade_rcnn import roi_bbox_head_cfg
    from dsl_tpu_torch.models.detectors.two_stage import (
        TwoStageDetector, mask_rcnn_predict)
    from dsl_tpu_torch.ops.nms import nms_keep

    canvas = canvas or CANVAS
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    images = torch.randn((b, 3, *canvas), generator=gen, device=DEVICE)
    launches, worst, paths, inputs = 0, 0, [], {}
    for path in configs:
        cfg = Config.fromfile(str(path))
        variables = seeded_variables(cfg)
        det = init_detector(cfg, variables=variables, device=DEVICE).detector
        tag = path.stem
        masks = (isinstance(det, TwoStageDetector)
                 and det.mask_head is not None)
        log(f"[{phase}] {path.relative_to(ROOT)}: {type(det).__name__}, "
            f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M "
            f"parameters")
        rpn_n = (ONE_LEVEL_RPN_NMS_N if len(det.rpn_head.strides) == 1
                 else HRFPN_RPN_NMS_N if type(det.neck).__name__ == "HRFPN"
                 else RPN_NMS_N if tuple(canvas) == tuple(CANVAS)
                 else RPN_NMS_N_640)

        def predict():
            out = (mask_rcnn_predict(det, images) if masks else
                   detector_predict(det, images, device=DEVICE))
            if len(out) == 3:
                return out
            # PointRend's two subdivision steps make its 7x7 logits 28x28
            refined = getattr(det, "point_head", None) is not None
            if (out[3].shape[:2] != out[0].shape[:2]
                    or (refined and tuple(out[3].shape[2:]) != (28, 28))
                    or not bool(((out[3] >= 0) & (out[3] <= 1)).all())):
                raise AssertionError(f"{tag}: mask probabilities "
                                     f"{tuple(out[3].shape)}")
            return out[:3]

        _, _, calls, w = predict_counted(
            tag, predict, [rpn_n, ROI_NMS_N],
            (b, cfg.model.test_cfg.rcnn.max_per_img, 5))
        launches, worst = launches + 2, max(worst, w)
        inputs[tag] = calls[1][:3]
        inputs[f"{tag}_rpn"] = calls[0][:3]
        paths.append(dict(path=tag, B=b, N=ROI_NMS_N, launches=2,
                          predict_ms=time_predict(tag, predict, b, smi,
                                                  trace=trace, reps=timed,
                                                  peak=peak)))
        if probe is not None:
            launches += probe(tag, cfg, variables, det, images)
        with_masks = getattr(det, "mask_head", None) is not None
        want_keys = expected_loss_keys(det)
        del det
        torch.cuda.empty_cache()
        batch = (mask_batch if with_masks else anchor_batch)(
            TRAIN_SEED, canvas, ANCHOR_TRAIN_B,
            roi_bbox_head_cfg(cfg.model)["num_classes"], DEVICE)
        with deterministic_cudnn():
            nms_keep.launches = 0
            m, taken = time_steps(tag, prepare(cfg) if prepare else cfg,
                                  variables, batch, smi, trace=trace,
                                  timed=steps, peak=peak)
            if not want_keys <= set(m) or not all(
                    np.isfinite(m[k]) for k in want_keys):
                raise AssertionError(f"{tag} step: {m}, expected the keys "
                                     f"{sorted(want_keys)}")
            if nms_keep.launches != taken:
                raise AssertionError(f"{tag} steps: {nms_keep.launches} NMS "
                                     f"launches, expected 1 per step")
            launches += nms_keep.launches
        del batch
        torch.cuda.empty_cache()
    return launches, worst, paths, inputs


MASK_RCNN_CONFIG = ROOT / "configs" / "mask_rcnn" / "mask_rcnn_r50_fpn_1x_coco.py"
MASK_MSTRAIN_CONFIG = (ROOT / "configs" / "mask_rcnn"
                       / "mask_rcnn_r50_caffe_fpn_mstrain_1x_coco.py")
C4_CONFIGS = (ROOT / "configs" / "faster_rcnn" / "faster_rcnn_r50_caffe_c4_1x_coco.py",
              ROOT / "configs" / "mask_rcnn" / "mask_rcnn_r50_caffe_c4_1x_coco.py")
C4_B = 2                      # the C4 predicts' batch
MASK_TRAIN_IMAGES = 8         # one epoch of 4 steps at the config's B=2
MASK_VAL_IMAGES = 4
MASK_PIPE_SEEDS = 16          # the mask pipeline card vs CPU
MASK_PASTE_REPS = 3           # pastes timed (median)


def mask_batch(seed: int, canvas, b: int, num_classes: int, device):
    """:func:`anchor_batch` with instance masks: a seeded star-shaped
    polygon in each GT box, rasterised at the canvas on ``device``, then
    the batch's ``gt_mask_crops`` and ``gt_mask_areas`` as the data layer
    makes them (``formatting.mask_crops``)."""
    import numpy as np
    import torch

    from dsl_tpu_torch.core.masks import BitmapMasks, rasterize_polygons
    from dsl_tpu_torch.data.formatting import mask_crops

    batch = anchor_batch(seed, canvas, b, num_classes, device)
    rng = np.random.RandomState(seed)
    gtb = batch["gt_bboxes"].cpu().numpy()
    valid = batch["gt_valid"].cpu().numpy()
    crops, areas = [], []
    for i in range(b):
        masks = []
        for x1, y1, x2, y2 in gtb[i][valid[i]]:
            n = 10
            ang = (np.arange(n) + rng.uniform(0, 0.8, n)) * (2 * np.pi / n)
            rad = rng.uniform(0.5, 1.0, n)
            pts = np.stack([(x1 + x2) / 2 + (x2 - x1) / 2 * rad * np.cos(ang),
                            (y1 + y2) / 2 + (y2 - y1) / 2 * rad * np.sin(ang)],
                           1)
            masks.append(rasterize_polygons([pts.reshape(-1)], *canvas,
                                            device))
        out = mask_crops(BitmapMasks(masks, *canvas, device), gtb[i],
                         gtb.shape[1], torch.device(device))
        crops.append(out["gt_mask_crops"])
        areas.append(out["gt_mask_areas"])
    batch["gt_mask_crops"] = torch.stack(crops)
    batch["gt_mask_areas"] = torch.stack(areas)
    return batch


def coco_instance(tmp: Path) -> dict:
    """The synthetic COCO instance set of phase 19 (the JPEG fixtures'
    copies; polygons, RLE, crowd RLE, instances without a segmentation)."""
    from dsl_tpu_torch.utils.synthetic_data import make_coco_instance_dir

    files, _ = fixtures()
    return make_coco_instance_dir(
        tmp / "coco19", [(str(p), h, w) for _, p, h, w in files],
        MASK_TRAIN_IMAGES, MASK_VAL_IMAGES, seed=19)


def _mask_dataset(coco: dict, split: str, device, pipeline=()):
    import numpy as np
    import random

    from dsl_tpu_torch.registry import DATASETS, build_from_cfg

    return build_from_cfg(dict(
        type="CocoDataset", ann_file=coco[split],
        img_prefix=coco[f"{split}_images"], pipeline=list(pipeline),
        test_mode=True, device=device, rng=np.random.RandomState(0),
        pyrng=random.Random(0)), DATASETS)


def phase_mask_predict(smi: str):
    """Mask R-CNN R50-FPN (``MASK_RCNN_CONFIG``, uncut, seeded weights)
    predict at B=8, 800x1344, f32: counted (2 NMS launches, keeps equal to
    the plain version's, dets finite with detections in every image), the
    28x28 probabilities finite in [0, 1], the median of ``P18_TIMED``
    predicts, the paste and RLE of one image's masks (ms per image), the
    mask head's logits card vs CPU within 1e-3. Returns
    the NMS launches of the counted predict, the worst keep difference,
    the path entry and the recorded RoI NMS input."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.apis.test import pasted_rles
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models.detectors.two_stage import mask_rcnn_predict
    from dsl_tpu_torch.models.roi_heads.mask_head import paste_masks

    cfg = Config.fromfile(str(MASK_RCNN_CONFIG))
    det = init_detector(cfg, variables=seeded_variables(cfg),
                        device=DEVICE).detector
    log(f"[p19] {MASK_RCNN_CONFIG.relative_to(ROOT)}: "
        f"{type(det).__name__}, "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters, "
        f"B={BATCH} at {CANVAS[0]}x{CANVAS[1]}")
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    shapes = torch.tensor([CANVAS] * BATCH, dtype=torch.float32, device=DEVICE)
    out = {}

    def predict():
        out["all"] = mask_rcnn_predict(det, images, img_shapes=shapes)
        return out["all"][:3]

    dets, valid, calls, worst = predict_counted(
        "Mask R-CNN f32", predict, [RPN_NMS_N, ROI_NMS_N],
        (BATCH, cfg.model.test_cfg.rcnn.max_per_img, 5))
    probs = out["all"][3]
    if (tuple(probs.shape) != (BATCH, 100, 28, 28)
            or not bool(((probs >= 0) & (probs <= 1)).all())):
        raise AssertionError(f"mask probabilities {tuple(probs.shape)}")
    ms = time_predict("Mask R-CNN f32", predict, BATCH, smi)
    keep = valid[0]
    dets0 = dets[0][keep].cpu().numpy()
    info = dict(height=CANVAS[0], width=CANVAS[1])
    times = sorted(host_ms(lambda: pasted_rles(probs[0][keep], dets0, info),
                           reps=MASK_PASTE_REPS))
    paste = sorted(host_ms(lambda: paste_masks(
        probs[0][keep], dets0, *CANVAS), reps=MASK_PASTE_REPS))
    pasted = paste_masks(probs[0][keep], dets0, *CANVAS)
    copy_ms = sorted(host_ms(lambda: pasted.cpu(), reps=MASK_PASTE_REPS))
    rles = pasted_rles(probs[0][keep], dets0, info)
    if len(rles) != int(keep.sum()) or any(
            r["size"] != list(CANVAS) for r in rles):
        raise AssertionError("pasted masks are not the image's size")
    med = lambda x: x[len(x) // 2]  # noqa: E731
    log(f"[time] Mask R-CNN paste + RLE of one image's {len(rles)} masks at "
        f"{CANVAS[0]}x{CANVAS[1]}: median {med(times):.2f} ms (min "
        f"{times[0]:.2f}, {MASK_PASTE_REPS} reps); of which the paste on the "
        f"card {med(paste):.2f} ms, the copy out {med(copy_ms):.2f} ms, the "
        f"host RLE the rest  ({smi})")
    roi = torch.randn((16, det.mask_head.in_channels, 14, 14), generator=gen,
                      device=DEVICE)
    rel = card_vs_cpu_outputs(det, roi, stage="mask")
    log(f"[p19] mask head logits card vs CPU on 16 RoIs: worst |diff| / "
        f"max|ref| = {rel:.3e}")
    if rel > 1e-3:
        raise AssertionError(f"mask head: card and CPU disagree: {rel}")
    del det, out, probs, pasted
    torch.cuda.empty_cache()
    return 2, worst, dict(path="mask_rcnn", B=BATCH, N=ROI_NMS_N, launches=2,
                          predict_ms=ms), calls[1][:3]


def phase_mask_train(smi: str) -> int:
    """The Mask R-CNN train entry point at the config's B=2, 800x1344, f32,
    cuDNN deterministic (the caller holds it), on a batch with
    ``gt_mask_crops`` of seeded polygons: ``loss_mask`` finite beside every
    Faster R-CNN loss, 1 NMS launch per step, the median of ``P18_STEPS``
    steps after a warm-up; one step card vs CPU at 2x128x192 (losses 1e-4,
    ``grad_norm`` 1e-3, updates banded; 1 NMS launch, the card's); two runs
    of 3 steps from one seeded state bit-identical. Returns the NMS
    launches, each part's counted from 0."""
    import numpy as np

    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep

    cfg = Config.fromfile(str(MASK_RCNN_CONFIG))
    variables = seeded_variables(cfg)
    nc = cfg.model.bbox_head.num_classes
    batch = mask_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc, DEVICE)
    nms_keep.launches = 0
    m, _ = time_steps("Mask R-CNN", cfg, variables, batch, smi)
    if "loss_mask" not in m or not np.isfinite(m["loss_mask"]):
        raise AssertionError(f"Mask R-CNN step: {m}")
    if nms_keep.launches != 1 + P18_STEPS:
        raise AssertionError(f"Mask R-CNN steps: {nms_keep.launches} NMS "
                             f"launches, expected 1 per step")
    launches = nms_keep.launches
    small = mask_batch(TRAIN_SEED + 1, ANCHOR_SMALL, ANCHOR_TRAIN_B, nc, "cpu")
    nms_keep.launches = 0
    step_card_vs_cpu("Mask R-CNN", cfg, variables, ANCHOR_SMALL,
                     ANCHOR_TRAIN_B, nc, make_batch=lambda device: {
                         k: v.to(device) if hasattr(v, "to") else v
                         for k, v in small.items()})
    # the card step's RPN; the CPU step takes the plain version
    if nms_keep.launches != 1:
        raise AssertionError(f"Mask R-CNN card vs CPU step: "
                             f"{nms_keep.launches} NMS launches, expected 1")
    launches += nms_keep.launches
    nms_keep.launches = 0
    runs = []
    for _ in range(2):
        m, _, st, _ = anchor_step_runs(cfg, variables, batch, P18_STEPS)
        runs += [m, {k: p.detach().clone() for k, p in
                     st.student.named_parameters()}]
        del st
    launches += nms_keep.launches
    check_deterministic(*runs)
    return launches


def phase_mask_pipeline(coco: dict, smi: str):
    """``MASK_MSTRAIN_CONFIG``'s train pipeline (masks loaded, ``Resize`` of
    six scales, ``RandomFlip``, ``Pad``) on the COCO instance set, on the
    card and on the CPU with one seed each, ``MASK_PIPE_SEEDS`` seeds:
    masks, boxes, ``gt_mask_crops`` and ``gt_mask_areas`` equal bit for bit
    (the CPU is held to OpenCV and the JAX package by the CPU tests); ms
    per sample on the card, decode included."""
    import numpy as np
    import torch

    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.data.formatting import (
        DEFAULT_CANVAS, format_sample, select_canvas)
    from dsl_tpu_torch.data.pipelines import Compose

    pipeline = Config.fromfile(str(MASK_MSTRAIN_CONFIG)).data.train.pipeline
    sets = {d: _mask_dataset(coco, "train", d) for d in (DEVICE, "cpu")}
    card_ms = []
    for seed in range(MASK_PIPE_SEEDS):
        got = {}
        for device, ds in sets.items():
            i = seed % len(ds)
            results = dict(img_info=dict(ds.data_infos[i]),
                           ann_info=ds.get_ann_info(i),
                           img_prefix=ds.img_prefix, bbox_fields=[],
                           mask_fields=[], device=device)
            t0 = time.perf_counter()
            r = Compose(copy.deepcopy(list(pipeline)))(
                results, np.random.RandomState(seed))
            f = format_sample(r, canvas_hw=select_canvas(
                [r["img"].shape[:2]], DEFAULT_CANVAS))
            if device == DEVICE:
                torch.cuda.synchronize()
                card_ms.append((time.perf_counter() - t0) * 1e3)
            got[device] = (r, f)
        # the images differ by the decoders (nvJPEG and OpenCV, phase 8);
        # the masks' path reads only the annotations and the draws
        (rc, fc), (rh, fh) = got[DEVICE], got["cpu"]
        for what, a, b in (
                ("masks", rc["gt_masks"].masks, rh["gt_masks"].masks),
                ("crops", fc["gt_mask_crops"], fh["gt_mask_crops"]),
                ("areas", fc["gt_mask_areas"], fh["gt_mask_areas"])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"mask pipeline seed {seed}: {what} "
                                     f"differ card vs CPU")
        if not np.array_equal(rc["gt_bboxes"], rh["gt_bboxes"]):
            raise AssertionError(f"mask pipeline seed {seed}: boxes differ")
    card_ms.sort()
    log(f"[p19] mask train pipeline card vs CPU bit-identical on "
        f"{MASK_PIPE_SEEDS} seeds (masks, boxes, 112x112 crops, areas); "
        f"card ms per sample median {card_ms[len(card_ms) // 2]:.2f} "
        f"(min {card_ms[0]:.2f}, max {card_ms[-1]:.2f})  ({smi})")


def phase_mask_workflow(tmp: Path, coco: dict, smi: str) -> tuple[int, int]:
    """``train_detector`` on ``MASK_MSTRAIN_CONFIG`` (masks through its
    pipeline) for one epoch of the COCO instance set (4 steps at B=2),
    its evaluation with ``bbox`` and ``segm``, then the test CLI's ``--eval
    bbox segm`` (:func:`run_test_cli`); the val GT fed back as detections, masks
    included, scores ``segm_mAP`` 1.0; ``tta_test`` then ``tta_test_masks``
    on the val images: masks the images' size, keeps equal to the plain
    version's. Returns the NMS launches and the worst keep difference."""
    import math

    import numpy as np
    import torch

    from dsl_tpu_torch.apis import init_detector, train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE, tta_test, tta_test_masks
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.core.masks import encode_rle, rasterize_polygons
    from dsl_tpu_torch.ops.nms import nms_keep, nms_keep_reference
    from dsl_tpu_torch.utils.synthetic_data import coco_instance_config

    t0 = time.perf_counter()
    raw = coco_instance_config(
        Config.fromfile(str(MASK_MSTRAIN_CONFIG)).to_dict(), coco)
    raw["runner"]["max_epochs"] = 1
    raw["log_config"] = dict(interval=1)
    raw["evaluation"] = dict(interval=1, metric=["bbox", "segm"])
    work = tmp / "mask19"
    cfg_path = tmp / "mask19.py"
    Config(raw).dump(str(cfg_path))
    variables = seeded_variables(Config(raw))
    batches = math.ceil(MASK_VAL_IMAGES / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE, variables=variables)
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    if not steps or not all(math.isfinite(x["loss_mask"]) for x in steps):
        raise AssertionError(f"Mask R-CNN train_detector losses: {steps}")
    if (len(val) != 1 or not 0.0 <= val[-1]["bbox_mAP"] <= 1.0
            or not 0.0 <= val[-1]["segm_mAP"] <= 1.0):
        raise AssertionError(f"Mask R-CNN evaluation: {val}")
    if launches != len(steps) + 2 * batches:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per step and 2 per evaluation batch")
    log(f"[p19] {MASK_MSTRAIN_CONFIG.relative_to(ROOT)} train_detector: "
        f"{len(steps)} steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in ("loss_cls", "loss_bbox",
                                                "loss_mask", "loss"))
        + f"), bbox_mAP {val[-1]['bbox_mAP']:.4f}, segm_mAP "
        f"{val[-1]['segm_mAP']:.4f}, NMS launches {launches}")
    child, out = run_test_cli([str(cfg_path), str(work / "epoch_1.pth"),
                               "--eval", "bbox", "segm"], tag="mask19")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if (not 0.0 <= metrics["bbox_mAP"] <= 1.0
            or not 0.0 <= metrics["segm_mAP"] <= 1.0 or child != 2 * batches):
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[p19] test CLI --eval bbox segm: bbox_mAP {metrics['bbox_mAP']}, "
        f"segm_mAP {metrics['segm_mAP']}, NMS launches {child}")
    launches += child

    # the val GT fed back as detections, masks included
    test_pipeline = Config(raw).data.test.pipeline
    ds = _mask_dataset(coco, "val", DEVICE, test_pipeline)
    gt = json.loads(Path(coco["val"]).read_text())
    results = []
    for info in ds.data_infos:
        anns = [a for a in gt["annotations"]
                if a["image_id"] == info["id"] and not a["iscrowd"]]
        dets = np.asarray([[a["bbox"][0], a["bbox"][1],
                            a["bbox"][0] + a["bbox"][2],
                            a["bbox"][1] + a["bbox"][3], 1.0] for a in anns],
                          np.float32)
        labels = np.asarray([ds.cat2label[a["category_id"]] for a in anns])
        rles = [a["segmentation"] if isinstance(a["segmentation"], dict)
                else encode_rle(rasterize_polygons(
                    a["segmentation"], info["height"], info["width"]).numpy())
                for a in anns]
        results.append((dets, labels, rles))
    fed = ds.evaluate(results, metric=["bbox", "segm"], verbose=False)
    if fed["segm_mAP"] != 1.0 or fed["bbox_mAP"] != 1.0:
        raise AssertionError(f"the val GT fed back: {fed}")
    log(f"[p19] the val GT fed back as detections, masks included: "
        f"bbox_mAP {fed['bbox_mAP']}, segm_mAP {fed['segm_mAP']}")

    # test-time augmentation, boxes then masks
    det = init_detector(Config(raw), variables=variables, device=DEVICE).detector
    worst = 0
    t1 = time.perf_counter()
    with recording_nms() as calls:
        merged = tta_test(det, None, ds, img_scales=TTA_SCALES, flip=True,
                          evaluate=False, device=DEVICE)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    masks = tta_test_masks(det, None, ds, merged, img_scales=TTA_SCALES,
                           flip=True, device=DEVICE)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for boxes, v, thr, keep in calls:
        want = nms_keep_reference(boxes, v, thr)
        worst = max(worst, int((keep.int() - want.int()).abs().max()))
        if not torch.equal(keep, want):
            raise AssertionError("tta_test: NMS keeps differ from the plain "
                                 "version")
    for info, (d, _, rles), (md, _) in zip(ds.data_infos, masks, merged):
        if len(rles) != min(len(md), 100) or any(
                r["size"] != [info["height"], info["width"]] for r in rles):
            raise AssertionError("tta_test_masks: masks not the images' size")
    launches += len(calls)
    n = len(ds)
    log(f"[time] tta_test then tta_test_masks on {n} images at "
        f"{TTA_SCALES}, flip: {n / (t2 - t1):.1f} / {n / (t3 - t2):.1f} img/s, "
        f"{sum(len(m[2]) for m in masks)} masks the images' size, "
        f"{len(calls)} NMS launches, keeps equal to the plain version's  "
        f"({smi})")
    log(f"[p19] workflow part {time.perf_counter() - t0:.1f} s")
    del det
    torch.cuda.empty_cache()
    return launches, worst


CASCADE_CONFIGS = tuple(ROOT / "configs" / p for p in (
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py",
    "cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py",
    "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py"))
CASCADE_MSTRAIN_CONFIG = (ROOT / "configs" / "cascade_rcnn"
                          / "cascade_mask_rcnn_r50_fpn_mstrain_3x_coco.py")
ROI_RANGE = "roi_align"       # the profiler range around RoIAlign's calls
DCN_RANGE = "deform_conv2d"   # the profiler range around deform_conv2d's calls
TRACED_RANGE = "traced"       # the profiler range around the traced call
TRACE_LOST = 0.01             # share of launches a trace may lack records of
CASCADE_DET_STEPS = 3         # steps per determinism run


@contextlib.contextmanager
def roi_align_ranges():
    """Every RoIAlign forward (``ops.roi_align.roi_align_rows``, as the RoI
    heads, the refinement and the mask targets call it) and its backward
    in a ``record_function`` range named ``ROI_RANGE``, for a trace."""
    import torch

    from dsl_tpu_torch.models.roi_heads import standard_roi_head
    from dsl_tpu_torch.ops import roi_align

    real_rows = roi_align.roi_align_rows
    real_bwd = roi_align._GatherRows.backward

    def rows(*args, **kw):
        with torch.profiler.record_function(ROI_RANGE):
            return real_rows(*args, **kw)

    def backward(ctx, grad):
        with torch.profiler.record_function(ROI_RANGE):
            return real_bwd(ctx, grad)

    roi_align.roi_align_rows = standard_roi_head.roi_align_rows = rows
    roi_align._GatherRows.backward = staticmethod(backward)
    try:
        yield
    finally:
        roi_align.roi_align_rows = standard_roi_head.roi_align_rows = real_rows
        roi_align._GatherRows.backward = staticmethod(real_bwd)


@contextlib.contextmanager
def deform_conv_ranges():
    """Every ``ops.deform_conv.deform_conv2d`` forward (the DCN backbones'
    and heads' convs, VFNet's star convs) in a ``record_function`` range
    named ``DCN_RANGE``, for a predict's trace."""
    import torch

    from dsl_tpu_torch.ops import deform_conv

    real = deform_conv.deform_conv2d

    def wrapped(*args, **kw):
        with torch.profiler.record_function(DCN_RANGE):
            return real(*args, **kw)

    deform_conv.deform_conv2d = wrapped
    try:
        yield
    finally:
        deform_conv.deform_conv2d = real


def deform_conv_share(tag: str, fn, smi: str) -> dict:
    """:func:`roi_align_share` of ``fn()`` for deformable convolution:
    its forward's device ms and share of the kernels' time."""
    return roi_align_share(tag, fn, smi, scope=deform_conv_ranges,
                           range_name=DCN_RANGE, what="deform_conv2d")


def roi_align_share(tag: str, fn, smi: str, scope=roi_align_ranges,
                    range_name: str = ROI_RANGE,
                    what: str = "RoIAlign") -> dict:
    """One torch.profiler trace of ``fn()`` under ``scope`` (by default
    :func:`roi_align_ranges`; its ranges named ``range_name``, ``what`` in
    the log):
    RoIAlign's device ms (the kernels its ranges launched), every kernel's
    device ms, RoIAlign's share of them and the device's idle share of the
    traced window (the call's range, first event to last), logged. A
    trace's first launches can lack their kernel records (seen on the card:
    1 to 3 early in a run, 56 late in the smoke, every trace alike), so
    ``fn()`` runs once in the trace before the call's range and is left
    out. The trace may drop records (seen on the card): one where more
    than ``TRACE_LOST`` of the call's launches have no kernel record
    (matched by correlation id), where one in a RoIAlign range has none or
    where a RoIAlign range has no kernel is taken again, up to
    ``NMS_TRACE_TRIES`` traces, and then fails the run; the launches
    without a record are logged. Returns those numbers and ``calls``, the
    calls of ``fn`` made."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for tries in range(1, NMS_TRACE_TRIES + 1):
        with scope(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function(TRACED_RANGE):
                fn()
                torch.cuda.synchronize()
        every = trace_events(prof)
        t0 = next(e.start for e in every
                  if e.name == TRACED_RANGE and e.device_type == DeviceType.CPU)
        # the warm-up call's runtime calls; their kernels are told apart by
        # correlation id, not by time (the device's clock, mapped onto the
        # host's, can put the call's first kernels a little before t0)
        before = {e.id for e in every if e.device_type == DeviceType.CPU
                  and e.name.startswith("cu") and e.start < t0}
        ran = {e.id for e in every if e.device_type == DeviceType.CUDA}
        # the trace mirrors each range on the device's timeline: not a kernel
        events = [e for e in every if e.name != TRACED_RANGE and (
            e.id not in before and e.name != range_name
            if e.device_type == DeviceType.CUDA else e.start >= t0)]
        launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                           and "LaunchKernel" in e.name),
                          key=lambda e: e.start)
        ranges = [e for e in events
                  if e.name == range_name and e.device_type == DeviceType.CPU]
        range_us = range_kernel_us(events, ranges)
        ops = {e.id: e for e in events
               if e.device_type == DeviceType.CPU and not e.linked}
        where = [(i, e.name, getattr(ops.get(e.linked), "name", None))
                 for i, e in enumerate(launches) if e.id not in ran]
        in_roi = sum(r.start <= launches[i].start <= r.end
                     for i, _, _ in where for r in ranges)
        empty = sum(us == 0 for us in range_us)
        if (len(where) <= TRACE_LOST * len(launches) and not in_roi
                and not empty and ranges):
            break
        log(f"[trace] {tag}: the profiler lost the records of {len(where)} "
            f"of {len(launches)} kernel launches ({in_roi} in {what}; "
            f"launch index, call, op: {where[:2]} to {where[-1:]}); {empty} "
            f"of {len(ranges)} {what} ranges without a kernel")
    else:
        raise AssertionError(f"{tag}: {NMS_TRACE_TRIES} profiler traces each "
                             f"lost records")
    busy = events_busy(events)
    kernel_ms = sum(e.end - e.start for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    roi_ms = sum(range_us) / 1e3
    idle = 1.0 - busy[0] / busy[1]
    log(f"[trace] {tag}: {len(ranges)} {what} ranges, {what} "
        f"{roi_ms:.3f} ms, {roi_ms / kernel_ms:.4f} of the kernels' time; "
        f"kernels {kernel_ms:.3f} ms ({busy[2]} kernels, {len(launches)} "
        f"launches, {len(where)} without a record: {where[:3]}), busy {busy[0]:.3f} of {busy[1]:.3f} ms, idle "
        f"share {idle:.4f}; trace {tries} of {NMS_TRACE_TRIES}  ({smi})")
    return dict(roi_ms=roi_ms, kernel_ms=kernel_ms, idle=idle,
                calls=2 * tries)


@contextlib.contextmanager
def shared_mask_targets():
    """One leg's mask targets handed to the other leg of a step card vs
    CPU (``two_stage.mask_targets_from_crops``), keyed by the call's
    samples (batch index and assigned GT): each leg's RoIs come from its
    own RPN decode, 2.5e-4 px apart at 2x128x192, and a target pixel whose
    value lies that near 0.5 flips, which moves ``loss_mask`` past 1e-4
    (20 of 26656 pixels for Mask Scoring R-CNN on an H100). Every flip
    must be such a tie, else the run fails: the leg's own RoIAlign value
    within ``2 d m / s + 1e-6`` of 0.5, where ``d`` is the largest
    coordinate difference of that RoI between the legs and ``m / s`` the
    crop pixels per input pixel (``s`` the GT box's shorter side): a
    bilinear sample of a crop in [0, 1] moves by at most its shift along x
    plus its shift along y. The legs run on two devices (the card's first):
    a key seen again on the first leg's device is that leg's next call (an
    HTC step calls once per stage), and the second leg's calls of a key
    take the first leg's in order. Yields the flips of each handed-over
    call."""
    import torch

    from dsl_tpu_torch.models.detectors import two_stage
    from dsl_tpu_torch.models.roi_heads import mask_head

    real, real_align = two_stage.mask_targets_from_crops, mask_head.roi_align
    first, used, flips = {}, {}, []

    def shared(mask_crops, gt_bboxes, rois, batch_idx, assigned_gt, **kw):
        sampled = []

        def align(*args, **akw):
            sampled.append(real_align(*args, **akw)[:, 0])
            return sampled[-1][:, None]

        mask_head.roi_align = align
        try:
            own = real(mask_crops, gt_bboxes, rois, batch_idx, assigned_gt,
                       **kw)
        finally:
            mask_head.roi_align = real_align
        key = (batch_idx.cpu().numpy().tobytes(),
               assigned_gt.cpu().numpy().tobytes())
        seen = first.setdefault(key, [])
        if not seen or seen[0][2] == rois.device.type:
            # the first leg's call (HTC's stages may repeat a key in a leg)
            seen.append((own.cpu(), rois.cpu(), rois.device.type))
            return own
        want, want_rois, _ = seen[used.get(key, 0)]
        used[key] = used.get(key, 0) + 1
        flip = own.cpu() != want
        flips.append(int(flip.sum()))
        if flips[-1]:
            b, k, m, _ = mask_crops.shape
            gt = gt_bboxes.reshape(b * k, 4)[
                batch_idx * k + assigned_gt.clamp(0, k - 1)].cpu()
            side = torch.minimum(gt[:, 2] - gt[:, 0],
                                 gt[:, 3] - gt[:, 1]).clamp_min(1.0)
            d = (rois.cpu() - want_rois).abs().amax(1)
            tie = (2 * d * m / side + 1e-6)[:, None, None].expand_as(flip)
            gap = (sampled[0].cpu() - 0.5).abs()
            if not bool((gap[flip] <= tie[flip]).all()):
                raise AssertionError(
                    f"{flips[-1]} mask target pixels flip between the legs, "
                    f"not all ties: worst |value - 0.5| "
                    f"{float(gap[flip].max()):.3e} against "
                    f"{float(tie[flip].min()):.3e}")
        return want.to(own.device)

    two_stage.mask_targets_from_crops = shared
    try:
        yield flips
    finally:
        two_stage.mask_targets_from_crops = real


def cascade_probe(smi: str):
    """:func:`phase_variants`' probe for phase 20: on the predict's
    detector, its stages' outputs card vs CPU within 1e-3 of the largest
    magnitude (the levels and the RPN at 1x128x192, each stage's head on
    64 seeded RoIs, the mask head's and the mask IoU head's on 16); where
    there is a mask head, the train entry point at B=2 (cuDNN
    deterministic): one step card vs CPU at 2x128x192 (losses 1e-4,
    ``grad_norm`` 1e-3, updates banded; both legs on one leg's mask
    targets, every flip a tie, :func:`shared_mask_targets`) and two runs of
    ``CASCADE_DET_STEPS`` steps bit-identical. The NMS count is read after
    them: 1 per step (the card's, in the card vs CPU step)."""
    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.models.detectors.cascade_rcnn import (
            roi_bbox_head_cfg)
        from dsl_tpu_torch.ops.nms import nms_keep

        gen = torch.Generator(device=DEVICE).manual_seed(24)
        small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
        on_cpu = copy.deepcopy(det).cpu()
        rel = {"levels and RPN": card_vs_cpu_outputs(det, small, on_cpu)}
        cascade = hasattr(det, "bbox_heads")
        for i, head in enumerate(det.bbox_heads if cascade else [det.bbox_head]):
            rf = torch.randn((64, head.in_channels, head.roi_size,
                              head.roi_size), generator=gen, device=DEVICE)
            rel[f"bbox head {i}"] = card_vs_cpu_outputs(
                det, rf, on_cpu, stage="roi",
                **(dict(head=i) if cascade else {}))
        mh = det.mask_head
        if mh is not None:
            mf = torch.randn((16, mh.in_channels, mh.roi_size, mh.roi_size),
                             generator=gen, device=DEVICE)
            rel["mask head"] = card_vs_cpu_outputs(det, mf, on_cpu,
                                                   stage="mask")
            if getattr(det, "mask_iou_head", None) is not None:
                probs = torch.rand((16, 2 * mh.roi_size, 2 * mh.roi_size),
                                   generator=gen, device=DEVICE)
                rel["mask IoU head"] = card_vs_cpu_outputs(
                    det, mf, on_cpu, stage="mask_iou", mask_pred=probs)
        del on_cpu
        log(f"[p20] {tag} outputs card vs CPU, worst |diff| / max|ref|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
        if mh is None:
            return 0
        nc = roi_bbox_head_cfg(cfg.model)["num_classes"]
        small_batch = mask_batch(TRAIN_SEED + 1, ANCHOR_SMALL, ANCHOR_TRAIN_B,
                                 nc, "cpu")
        batch = mask_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc, DEVICE)
        with deterministic_cudnn():
            nms_keep.launches = 0
            with shared_mask_targets() as flips:
                step_card_vs_cpu(tag, cfg, variables, ANCHOR_SMALL,
                                 ANCHOR_TRAIN_B, nc, make_batch=lambda device: {
                                     k: v.to(device) if hasattr(v, "to") else v
                                     for k, v in small_batch.items()})
            log(f"[p20] {tag} card vs CPU step: the CPU's own mask targets "
                f"differ from the card's in {flips} pixels per call, each a "
                f"tie of its RoIs' rounding; both legs trained on the card's")
            runs = []
            for _ in range(2):
                m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                               CASCADE_DET_STEPS)
                runs += [m, {k: p.detach().clone() for k, p in
                             st.student.named_parameters()}]
                del st
            check_deterministic(*runs)
        if nms_keep.launches != 1 + 2 * CASCADE_DET_STEPS:
            raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches in "
                                 f"the card vs CPU step and two runs of "
                                 f"{CASCADE_DET_STEPS} steps, expected "
                                 f"{1 + 2 * CASCADE_DET_STEPS}")
        del batch
        torch.cuda.empty_cache()
        return nms_keep.launches

    return probe


def phase_cascade_workflow(tmp: Path, coco: dict, smi: str) -> int:
    """``train_detector`` on ``CASCADE_MSTRAIN_CONFIG`` (its pipeline loads
    masks) for one epoch of phase 19's COCO instance set with ``bbox``
    evaluation, then the test CLI's ``--eval bbox`` (:func:`run_test_cli`): every
    stage's losses finite, ``bbox_mAP`` in [0, 1], 1 NMS launch per step
    and 2 per predicted batch. Returns the NMS launches."""
    import math

    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.synthetic_data import coco_instance_config

    t0 = time.perf_counter()
    raw = coco_instance_config(
        Config.fromfile(str(CASCADE_MSTRAIN_CONFIG)).to_dict(), coco)
    raw["runner"]["max_epochs"] = 1
    raw["log_config"] = dict(interval=1)
    raw["evaluation"] = dict(interval=1, metric="bbox")
    work = tmp / "cascade20"
    cfg_path = tmp / "cascade20.py"
    Config(raw).dump(str(cfg_path))
    batches = math.ceil(MASK_VAL_IMAGES / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE,
                   variables=seeded_variables(Config(raw)))
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    keys = [f"s{i}.{k}" for i in range(3)
            for k in ("loss_cls", "loss_bbox", "loss_mask")]
    if not steps or not all(math.isfinite(x[k]) for x in steps for k in keys):
        raise AssertionError(f"Cascade Mask R-CNN train_detector losses: "
                             f"{steps}")
    if len(val) != 1 or not 0.0 <= val[-1]["bbox_mAP"] <= 1.0:
        raise AssertionError(f"Cascade Mask R-CNN evaluation: {val}")
    if launches != len(steps) + 2 * batches:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per step and 2 per evaluation batch")
    log(f"[p20] {CASCADE_MSTRAIN_CONFIG.relative_to(ROOT)} train_detector: "
        f"{len(steps)} steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in keys + ["loss"])
        + f"), bbox_mAP {val[-1]['bbox_mAP']:.4f}, NMS launches {launches}")
    child, out = run_test_cli([str(cfg_path), str(work / "epoch_1.pth"),
                               "--eval", "bbox"], tag="cascade20")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if not 0.0 <= metrics["bbox_mAP"] <= 1.0 or child != 2 * batches:
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[p20] test CLI --eval bbox: bbox_mAP {metrics['bbox_mAP']}, NMS "
        f"launches {child}; workflow {time.perf_counter() - t0:.1f} s")
    return launches + child


HTC_CONFIGS = tuple(ROOT / "configs" / p for p in (
    "htc/htc_r50_fpn_1x_coco.py",
    "scnet/scnet_r50_fpn_1x_coco.py",
    "detectors/detectors_htc_r50_1x_coco.py"))
# HTC's and SCNet's data: the COCO instance set with the semantic map
# (``with_seg``, ``SegRescale``); htc_r50_fpn_1x_coco.py inherits the
# box-only COCO pipeline, on which HTC's semantic target (made from the GT
# masks) has nothing to read in either package
SEMANTIC_DATA_CONFIG = (ROOT / "configs" / "_base_" / "datasets"
                        / "coco_instance_semantic.py")
HTC_TIMED, HTC_STEPS = 3, 1   # phase 21's predicts and steps timed (median)


def _random_levels(det, small, gen):
    """Seeded random levels of the shapes ``det`` gives ``small``."""
    import torch

    with torch.no_grad():
        shapes = [tuple(f.shape) for f in det(small)[0]]
    return [torch.randn(sh, generator=gen, device=DEVICE) for sh in shapes]


def htc_probe(smi: str):
    """:func:`phase_variants`' probe for phase 21: on the predict's
    detector, card vs CPU within 1e-3 of the largest magnitude: the levels
    (after the RFP neck for DetectoRS) and the RPN at 1x128x192, the
    semantic head and SCNet's global-context head on seeded levels of those
    shapes, each stage's box head on 64 seeded RoIs (an SCNet head with its
    shared features), each HTC mask head on 16 (with the previous head's
    features), SCNet's mask head and relay head; for HTC (the first config)
    the train entry point at B=2 (cuDNN deterministic): one step card vs
    CPU at 2x128x192 (losses 1e-4, ``grad_norm`` 1e-3, updates banded; both
    legs on one leg's mask targets, :func:`shared_mask_targets`) and two
    runs of ``CASCADE_DET_STEPS`` steps bit-identical. Returns the NMS
    launches: 1 per step (the card's, in the card vs CPU step)."""
    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.models.detectors.cascade_rcnn import (
            SCNet, roi_bbox_head_cfg)
        from dsl_tpu_torch.ops.nms import nms_keep

        gen = torch.Generator(device=DEVICE).manual_seed(25)
        small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
        on_cpu = copy.deepcopy(det).cpu()
        rel = {"levels and RPN": card_vs_cpu_outputs(det, small, on_cpu)}
        levels = _random_levels(det, small, gen)
        rel["semantic head"] = card_vs_cpu_outputs(det, levels, on_cpu,
                                                   stage="semantic")
        scnet = isinstance(det, SCNet)
        if scnet:
            rel["global-context head"] = card_vs_cpu_outputs(
                det, levels, on_cpu, stage="glbctx")
        for i, head in enumerate(det.bbox_heads):
            rf = torch.randn((64, head.in_channels, head.roi_size,
                              head.roi_size), generator=gen, device=DEVICE)
            rel[f"bbox head {i}"] = card_vs_cpu_outputs(
                det, rf, on_cpu, stage="roi", head=i, shared=scnet)
        if scnet:
            mh = det.mask_head
            mf = torch.randn((16, mh.in_channels, mh.roi_size, mh.roi_size),
                             generator=gen, device=DEVICE)
            rel["mask head"] = card_vs_cpu_outputs(det, mf, on_cpu,
                                                   stage="mask")
            fc = torch.randn((16, det.relay_head.in_channels), generator=gen,
                             device=DEVICE)
            rel["relay head"] = card_vs_cpu_outputs(det, fc, on_cpu,
                                                    stage="relay")
        else:
            for j, mh in enumerate(det.mask_heads):
                mf = torch.randn((16, mh.in_channels, mh.roi_size,
                                  mh.roi_size), generator=gen, device=DEVICE)
                res = (None if j == 0 else torch.randn(
                    (16, mh.conv_out_channels, mh.roi_size, mh.roi_size),
                    generator=gen, device=DEVICE))
                rel[f"mask head {j}"] = card_vs_cpu_outputs(
                    det, mf, on_cpu, stage="htc_mask", head=j, res_feat=res)
        del on_cpu
        log(f"[p21] {tag} outputs card vs CPU, worst |diff| / max|ref|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
        if cfg.model.get("type") != "HTC":
            return 0
        nc = roi_bbox_head_cfg(cfg.model)["num_classes"]
        small_batch = mask_batch(TRAIN_SEED + 1, ANCHOR_SMALL, ANCHOR_TRAIN_B,
                                 nc, "cpu")
        batch = mask_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc, DEVICE)
        with deterministic_cudnn():
            nms_keep.launches = 0
            with shared_mask_targets() as flips:
                step_card_vs_cpu(tag, cfg, variables, ANCHOR_SMALL,
                                 ANCHOR_TRAIN_B, nc, make_batch=lambda device: {
                                     k: v.to(device) if hasattr(v, "to") else v
                                     for k, v in small_batch.items()})
            log(f"[p21] {tag} card vs CPU step: the CPU's own mask targets "
                f"differ from the card's in {flips} pixels per call, each a "
                f"tie of its RoIs' rounding; both legs trained on the card's")
            runs = []
            for _ in range(2):
                m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                               CASCADE_DET_STEPS)
                runs += [m, {k: p.detach().clone() for k, p in
                             st.student.named_parameters()}]
                del st
            check_deterministic(*runs)
        if nms_keep.launches != 1 + 2 * CASCADE_DET_STEPS:
            raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches in "
                                 f"the card vs CPU step and two runs of "
                                 f"{CASCADE_DET_STEPS} steps, expected "
                                 f"{1 + 2 * CASCADE_DET_STEPS}")
        del batch
        torch.cuda.empty_cache()
        return nms_keep.launches

    return probe


def phase_htc_workflow(tmp: Path, coco: dict, smi: str) -> int:
    """``train_detector`` on ``HTC_CONFIGS[0]`` with the train pipeline of
    ``SEMANTIC_DATA_CONFIG`` (masks and the semantic map loaded,
    ``SegRescale``) for one epoch of phase 19's COCO instance set with
    ``bbox`` evaluation, then the test CLI's ``--eval bbox``
    (:func:`run_test_cli`): every stage's losses and ``loss_semantic_seg`` finite,
    ``bbox_mAP`` in [0, 1], 1 NMS launch per step and 2 per predicted
    batch. Returns the NMS launches."""
    import math

    import torch

    from dsl_tpu_torch.apis import train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.synthetic_data import coco_instance_config

    t0 = time.perf_counter()
    raw = coco_instance_config(Config.fromfile(str(HTC_CONFIGS[0])).to_dict(),
                               coco)
    raw["data"]["train"]["pipeline"] = copy.deepcopy(
        Config.fromfile(str(SEMANTIC_DATA_CONFIG)).train_pipeline)
    raw["runner"]["max_epochs"] = 1
    raw["log_config"] = dict(interval=1)
    raw["evaluation"] = dict(interval=1, metric="bbox")
    work = tmp / "htc21"
    cfg_path = tmp / "htc21.py"
    Config(raw).dump(str(cfg_path))
    batches = math.ceil(MASK_VAL_IMAGES / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE,
                   variables=seeded_variables(Config(raw)))
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    keys = [f"s{i}.{k}" for i in range(3)
            for k in ("loss_cls", "loss_bbox", "loss_mask")]
    keys.append("loss_semantic_seg")
    if not steps or not all(math.isfinite(x[k]) for x in steps for k in keys):
        raise AssertionError(f"HTC train_detector losses: {steps}")
    if len(val) != 1 or not 0.0 <= val[-1]["bbox_mAP"] <= 1.0:
        raise AssertionError(f"HTC evaluation: {val}")
    if launches != len(steps) + 2 * batches:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per step and 2 per evaluation batch")
    log(f"[p21] {HTC_CONFIGS[0].relative_to(ROOT)} train_detector through "
        f"{SEMANTIC_DATA_CONFIG.relative_to(ROOT)}'s pipeline: {len(steps)} "
        f"steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in keys + ["loss"])
        + f"), bbox_mAP {val[-1]['bbox_mAP']:.4f}, NMS launches {launches}")
    child, out = run_test_cli([str(cfg_path), str(work / "epoch_1.pth"),
                               "--eval", "bbox"], tag="htc21")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if not 0.0 <= metrics["bbox_mAP"] <= 1.0 or child != 2 * batches:
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[p21] test CLI --eval bbox: bbox_mAP {metrics['bbox_mAP']}, NMS "
        f"launches {child}; workflow {time.perf_counter() - t0:.1f} s")
    return launches + child


POINT_REND_CONFIG = (ROOT / "configs" / "point_rend"
                     / "point_rend_r50_caffe_fpn_mstrain_1x_coco.py")
SEESAW_CONFIG = (ROOT / "configs" / "seesaw_loss" / "mask_rcnn_r50_fpn_random_"
                 "seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py")
YOLACT_CONFIG = ROOT / "configs" / "yolact" / "yolact_r50_1x8_coco.py"
# the instance pipeline that loads masks (YOLACT's config inherits the
# box-only one; the Seesaw config's LVIS train set names none)
INSTANCE_DATA_CONFIG = (ROOT / "configs" / "_base_" / "datasets"
                        / "coco_instance.py")
P22_TIMED, P22_STEPS = 3, 1   # phase 22's predicts and steps timed (median)
P22_DET_STEPS = 3             # PointRend's steps per determinism run


def _rel_diff(got, want) -> float:
    """|card - CPU| / max(max |CPU|, 1), the card's tensor copied out."""
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max().clamp_min(1.0))


def slice15_probe(smi: str):
    """:func:`phase_variants`' probe for phase 22's two-stage detectors:
    card vs CPU within 1e-3 of the largest magnitude: the levels and the
    RPN at 1x128x192, the box head on 64 seeded RoIs, the mask head on 16;
    PointRend's point head on 16 x 196 seeded points and one subdivision
    step on 2 x 8 detections (integer coarse logits: their 2x upsample is
    exact on both devices, so both pick the same cells); the Seesaw head's
    split-activation scores on 64 seeded logit rows. Then the train entry
    point at B=2 (cuDNN deterministic): one step card vs CPU at 2x128x192
    (losses 1e-4, ``grad_norm`` 1e-3, updates banded; both legs on one
    leg's mask targets and the host's draws, the point draws included),
    and for PointRend two runs of ``P22_DET_STEPS`` steps bit-identical.
    Returns the NMS launches: 1 per step."""
    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.models.roi_heads import point_rend as pr
        from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
            split_scores)
        from dsl_tpu_torch.ops.nms import nms_keep

        gen = torch.Generator(device=DEVICE).manual_seed(26)
        small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
        on_cpu = copy.deepcopy(det).cpu()
        rel = {"levels and RPN": card_vs_cpu_outputs(det, small, on_cpu)}
        head, mh, ph = det.bbox_head, det.mask_head, det.point_head
        rf = torch.randn((64, head.in_channels, head.roi_size, head.roi_size),
                         generator=gen, device=DEVICE)
        rel["bbox head"] = card_vs_cpu_outputs(det, rf, on_cpu, stage="roi")
        mf = torch.randn((16, mh.in_channels, mh.roi_size, mh.roi_size),
                         generator=gen, device=DEVICE)
        rel["mask head"] = card_vs_cpu_outputs(det, mf, on_cpu, stage="mask")
        if ph is not None:
            nc = ph.num_classes
            fine = torch.randn((16, 196, ph.in_channels), generator=gen,
                               device=DEVICE)
            coarse = torch.randn((16, 196, nc), generator=gen, device=DEVICE)
            rel["point head"] = card_vs_cpu_outputs(det, fine, on_cpu,
                                                    stage="point", coarse=coarse)
            with torch.no_grad():
                p2 = det(small)[0][0]
            logits = torch.randint(-3, 4, (1, 8, nc, 7, 7), generator=gen,
                                   device=DEVICE).float()
            boxes = torch.rand((1, 8, 4), generator=gen, device=DEVICE) * 60
            boxes[..., 2:] += boxes[..., :2] + 8
            labels = torch.randint(0, nc, (1, 8), generator=gen, device=DEVICE)
            out = {}
            for d, dev in ((det, DEVICE), (on_cpu, "cpu")):
                with torch.no_grad():
                    out[dev] = pr.point_rend_refine(
                        logits.to(dev), p2.to(dev), boxes.to(dev),
                        labels.to(dev),
                        lambda f, c, d=d: d(f, stage="point", coarse=c),
                        subdivision_steps=1)
            rel["subdivision step"] = _rel_diff(out[DEVICE], out["cpu"])
        if head.seesaw:
            rows = torch.randn((64, head.num_classes + 2), generator=gen,
                               device=DEVICE) * 3
            rel["split activation"] = _rel_diff(
                split_scores(head, rows), split_scores(on_cpu.bbox_head,
                                                       rows.cpu()))
        del on_cpu
        log(f"[p22] {tag} outputs card vs CPU, worst |diff| / max|ref|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
        nc = head.num_classes
        small_batch = mask_batch(TRAIN_SEED + 1, ANCHOR_SMALL, ANCHOR_TRAIN_B,
                                 nc, "cpu")
        runs_det = P22_DET_STEPS if ph is not None else 0
        with deterministic_cudnn():
            nms_keep.launches = 0
            with shared_mask_targets() as flips:
                step_card_vs_cpu(tag, cfg, variables, ANCHOR_SMALL,
                                 ANCHOR_TRAIN_B, nc, make_batch=lambda device: {
                                     k: v.to(device) if hasattr(v, "to") else v
                                     for k, v in small_batch.items()})
            log(f"[p22] {tag} card vs CPU step: the CPU's own mask targets "
                f"differ from the card's in {flips} pixels per call, each a "
                f"tie of its RoIs' rounding; both legs trained on the card's")
            if runs_det:
                batch = mask_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc,
                                   DEVICE)
                runs = []
                for _ in range(2):
                    m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                                   runs_det)
                    runs += [m, {k: p.detach().clone() for k, p in
                                 st.student.named_parameters()}]
                    del st
                check_deterministic(*runs)
                del batch
        if nms_keep.launches != 1 + 2 * runs_det:
            raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches in "
                                 f"the card vs CPU step and the determinism "
                                 f"runs, expected {1 + 2 * runs_det}")
        torch.cuda.empty_cache()
        return nms_keep.launches

    return probe


def _instance_cfg(path: Path, coco: dict) -> dict:
    """A config on phase 19's COCO instance set, its train pipeline
    ``INSTANCE_DATA_CONFIG``'s (masks loaded), one epoch, logs every step."""
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.utils.synthetic_data import coco_instance_config

    raw = coco_instance_config(Config.fromfile(str(path)).to_dict(), coco)
    raw["data"]["train"]["pipeline"] = copy.deepcopy(
        Config.fromfile(str(INSTANCE_DATA_CONFIG)).train_pipeline)
    raw["runner"] = dict(raw.get("runner") or {}, max_epochs=1)
    raw["log_config"] = dict(interval=1)
    return raw


def phase_seesaw_workflow(tmp: Path, coco: dict) -> int:
    """``train_detector`` on ``SEESAW_CONFIG`` for one epoch of phase 19's
    COCO instance set in place of LVIS (the model as configured, 1203
    classes; no evaluation): ``loss_cls_objectness`` finite, 1 NMS launch
    per step, and its ``SeesawCounter`` at one plus the valid GT labels it
    was fed, class by class. Returns the NMS launches."""
    import math

    import torch

    from dsl_tpu_torch.apis import train as train_api
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep

    t0 = time.perf_counter()
    raw = _instance_cfg(SEESAW_CONFIG, coco)
    raw["evaluation"] = {}
    fed, wrappers = [], []
    real = train_api.with_seesaw_counts

    def recording(step, nc, device):
        wrapped = real(step, nc, device)

        def inner(state, batch, **kw):
            fed.append(batch["gt_labels"][batch["gt_valid"]].clone())
            return wrapped(state, batch, **kw)

        wrappers.append(wrapped)
        return inner

    train_api.with_seesaw_counts = recording
    nms_keep.launches = 0
    try:
        train_api.train_detector(Config(raw), str(tmp / "seesaw22"),
                                 device=DEVICE,
                                 variables=seeded_variables(Config(raw)))
    finally:
        train_api.with_seesaw_counts = real
    torch.cuda.synchronize()
    launches = nms_keep.launches
    labels = torch.cat(fed).long()
    counts = wrappers[0].counter.counts
    want = torch.ones_like(counts).index_add_(
        0, labels.to(counts.device), torch.ones_like(labels, dtype=counts.dtype))
    if not torch.equal(counts, want):
        raise AssertionError(f"SeesawCounter {counts.sum()} after "
                             f"{len(labels)} labels: not one plus the labels")
    lines = [json.loads(x) for x in
             (tmp / "seesaw22" / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    if not steps or not all(math.isfinite(x["loss_cls_objectness"])
                            for x in steps):
        raise AssertionError(f"Seesaw train_detector losses: {steps}")
    if launches != len(steps):
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per step")
    log(f"[p22] {SEESAW_CONFIG.relative_to(ROOT)} train_detector on the COCO "
        f"instance set: {len(steps)} steps, last loss_cls "
        f"{steps[-1]['loss_cls']:.4f}, loss_cls_objectness "
        f"{steps[-1]['loss_cls_objectness']:.4f}; SeesawCounter = 1 + the "
        f"{len(labels)} valid GT labels fed ({int((counts > 1).sum())} "
        f"classes seen), NMS launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_yolact(tmp: Path, coco: dict, smi: str) -> float:
    """YOLACT R-50 (``YOLACT_CONFIG``, uncut, seeded weights): the predict
    at B=8, 800x1344, f32 with the NMS count at 0 (fast NMS: no launch),
    its checks and time; ``fast_nms`` on the predict's recorded input card
    vs CPU (equal on the valid rows); the head, protonet and segm outputs
    card vs CPU at 1x128x192 within 1e-3; the steps at B=2 (cuDNN
    deterministic; no NMS launch) and one step card vs CPU; then
    ``train_detector`` for one epoch through ``INSTANCE_DATA_CONFIG``'s
    pipeline with ``bbox`` and ``segm`` evaluation and the test CLI's
    ``--eval bbox segm``: ``bbox_mAP`` and ``segm_mAP`` in [0, 1]. Returns
    the predict's median ms."""
    import math

    import torch

    from dsl_tpu_torch.apis import init_detector, train_detector
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.core import nms as core_nms
    from dsl_tpu_torch.models.dense_heads import yolact_head
    from dsl_tpu_torch.ops.nms import nms_keep

    cfg = Config.fromfile(str(YOLACT_CONFIG))
    variables = seeded_variables(cfg)
    det = init_detector(cfg, variables=variables, device=DEVICE).detector
    tag = YOLACT_CONFIG.stem
    log(f"[p22] {YOLACT_CONFIG.relative_to(ROOT)}: YOLACT, "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters")
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    recorded = []
    real_fast = yolact_head.fast_nms

    def recording(*args, **kw):
        recorded.append((args, kw))
        return real_fast(*args, **kw)

    yolact_head.fast_nms = recording
    nms_keep.launches = 0
    try:
        dets, labels, valid, crops = yolact_head.yolact_full_predict(det,
                                                                     images)
        torch.cuda.synchronize()
    finally:
        yolact_head.fast_nms = real_fast
    per_img = valid.sum(1).tolist()
    if (nms_keep.launches != 0 or tuple(dets.shape) != (BATCH, 100, 5)
            or not bool(torch.isfinite(dets).all()) or min(per_img) == 0
            or tuple(crops.shape) != (BATCH, 100, 56, 56)
            or not bool(((crops >= 0) & (crops <= 1)).all())):
        raise AssertionError(f"{tag} predict: {nms_keep.launches} NMS "
                             f"launches, dets {tuple(dets.shape)}, valid per "
                             f"image {per_img}, crops {tuple(crops.shape)}")
    (boxes, scores), kw = recorded[0]
    on_cpu = core_nms.fast_nms(boxes.cpu(), scores.cpu(), **kw)
    for g, w in zip(core_nms.fast_nms(boxes, scores, **kw), on_cpu):
        g = g.cpu()
        if not torch.equal(g[on_cpu[3]], w[on_cpu[3]]):
            raise AssertionError(f"{tag}: fast_nms on the card differs from "
                                 f"the CPU's on the valid rows")
    log(f"[p22] {tag} predict B={BATCH}: dets {tuple(dets.shape)} finite, "
        f"valid per image {per_img}, crops {tuple(crops.shape)} in [0, 1], "
        f"0 NMS launches; fast_nms on {tuple(scores.shape)} card = CPU on the "
        f"{int(on_cpu[3].sum())} valid rows")
    ms = time_predict(tag, lambda: yolact_head.yolact_full_predict(det, images),
                      BATCH, smi, reps=P22_TIMED, peak=True)
    small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
    rel = card_vs_cpu_outputs(det, small)
    log(f"[p22] {tag} head, protonet and segm outputs card vs CPU at "
        f"1x{ANCHOR_SMALL[0]}x{ANCHOR_SMALL[1]}: worst |diff| / max|ref| = "
        f"{rel:.3e}")
    if rel > 1e-3:
        raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
    del det, images, recorded
    torch.cuda.empty_cache()
    nc = cfg.model.bbox_head.num_classes
    batch = mask_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc, DEVICE)
    small_batch = mask_batch(TRAIN_SEED + 1, ANCHOR_SMALL, ANCHOR_TRAIN_B, nc,
                             "cpu")
    with deterministic_cudnn():
        nms_keep.launches = 0
        m, _ = time_steps(tag, cfg, variables, batch, smi, timed=P22_STEPS,
                          peak=True)
        keys = ("loss_cls", "loss_bbox", "loss_mask", "loss_segm")
        if not all(math.isfinite(m[k]) for k in keys) or nms_keep.launches:
            raise AssertionError(f"{tag} step: {m}, {nms_keep.launches} NMS "
                                 f"launches")
        step_card_vs_cpu(tag, cfg, variables, ANCHOR_SMALL, ANCHOR_TRAIN_B,
                         nc, make_batch=lambda device: {
                             k: v.to(device) if hasattr(v, "to") else v
                             for k, v in small_batch.items()})
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    raw = _instance_cfg(YOLACT_CONFIG, coco)
    raw["evaluation"] = dict(interval=1, metric=["bbox", "segm"])
    work = tmp / "yolact22"
    cfg_path = tmp / "yolact22.py"
    Config(raw).dump(str(cfg_path))
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE,
                   variables=seeded_variables(Config(raw)))
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    if not steps or not all(math.isfinite(x[k]) for x in steps for k in keys):
        raise AssertionError(f"YOLACT train_detector losses: {steps}")
    if len(val) != 1 or not all(0.0 <= val[-1][k] <= 1.0
                                for k in ("bbox_mAP", "segm_mAP")):
        raise AssertionError(f"YOLACT evaluation: {val}")
    child, out = run_test_cli([str(cfg_path), str(work / "epoch_1.pth"),
                               "--eval", "bbox", "segm"], tag="yolact22")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if (not all(0.0 <= metrics[k] <= 1.0 for k in ("bbox_mAP", "segm_mAP"))
            or nms_keep.launches or child):
        raise AssertionError(f"YOLACT workflow: {metrics}, NMS launches "
                             f"{nms_keep.launches}")
    log(f"[p22] {YOLACT_CONFIG.relative_to(ROOT)} train_detector through "
        f"{INSTANCE_DATA_CONFIG.relative_to(ROOT)}'s pipeline: {len(steps)} "
        f"steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in keys)
        + f"), bbox_mAP {val[-1]['bbox_mAP']:.4f}, segm_mAP "
        f"{val[-1]['segm_mAP']:.4f}; test CLI --eval bbox segm: bbox_mAP "
        f"{metrics['bbox_mAP']}, segm_mAP {metrics['segm_mAP']}; 0 NMS "
        f"launches; workflow {time.perf_counter() - t0:.1f} s")
    return ms


HRNET_CONFIG = (ROOT / "configs" / "hrnet"
                / "faster_rcnn_hrnetv2p_w32_1x_coco.py")
HRNET_FCOS_CONFIG = (ROOT / "configs" / "hrnet"
                     / "fcos_hrnetv2p_w18_gn-head_4x4_1x_coco.py")
SLICE16_CONFIGS = (HRNET_CONFIG, *(ROOT / "configs" / p for p in (
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py",
    "resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py",
    "res2net/faster_rcnn_r2_50_fpn_coco.py")))
SSD_MOBILENET_CONFIG = ROOT / "configs" / "ssd" / "ssd_mobilenetv2_coco.py"
P23_TIMED, P23_STEPS = 3, 1   # phase 23's predicts and steps timed (median)
P23_DET_STEPS = 3             # HRNet's steps per determinism run
# (name, channels, groups, input H, W, stride) of the grouped and depthwise
# 3x3 convolutions of a B=2 step at 800x1344: RegNetX-3.2GF's first and
# second block of each stage, MobileNetV2's depthwise convs
GROUPED_CONVS = (
    ("regnet layer1.0", 96, 2, 400, 672, 2), ("regnet layer1.1", 96, 2, 200, 336, 1),
    ("regnet layer2.0", 192, 4, 200, 336, 2), ("regnet layer2.1", 192, 4, 100, 168, 1),
    ("regnet layer3.0", 432, 9, 100, 168, 2), ("regnet layer3.1", 432, 9, 50, 84, 1),
    ("regnet layer4.0", 1008, 21, 50, 84, 2), ("regnet layer4.1", 1008, 21, 25, 42, 1),
    ("mobilenet layer1.0", 32, 32, 400, 672, 1), ("mobilenet layer2.0", 96, 96, 400, 672, 2),
    ("mobilenet layer2.1", 144, 144, 200, 336, 1), ("mobilenet layer3.0", 144, 144, 200, 336, 2),
    ("mobilenet layer3.1", 192, 192, 100, 168, 1), ("mobilenet layer4.0", 192, 192, 100, 168, 2),
    ("mobilenet layer4.1", 384, 384, 50, 84, 1), ("mobilenet layer6.0", 576, 576, 50, 84, 2),
    ("mobilenet layer6.1", 960, 960, 25, 42, 1))


def slice16_probe(smi: str, phase: str = "p23"):
    """:func:`phase_variants`' probe for phase 23's two-stage detectors:
    card vs CPU within 1e-3 of the largest magnitude at 1x128x192: the
    backbone's levels (HRNet's four branches), the neck's levels and the
    RPN, the box head on 64 seeded RoIs, the mask head on 16 where there is
    one. For HRNet (``HRNET_CONFIG``) then the train entry point at B=2
    (cuDNN deterministic): one step card vs CPU at 2x128x192 (losses 1e-4,
    ``grad_norm`` 1e-3, updates banded; the host's draws) and two runs of
    ``P23_DET_STEPS`` steps at 800x1344 bit-identical. Returns the NMS
    launches: 1 per step."""
    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.ops.nms import nms_keep

        gen = torch.Generator(device=DEVICE).manual_seed(27)
        small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
        on_cpu = copy.deepcopy(det).cpu()
        rel = {"backbone": card_vs_cpu_outputs(det.backbone, small,
                                               on_cpu.backbone),
               "levels and RPN": card_vs_cpu_outputs(det, small, on_cpu)}
        head, mh = det.bbox_head, det.mask_head
        rf = torch.randn((64, head.in_channels, head.roi_size, head.roi_size),
                         generator=gen, device=DEVICE)
        rel["bbox head"] = card_vs_cpu_outputs(det, rf, on_cpu, stage="roi")
        if mh is not None:
            mf = torch.randn((16, mh.in_channels, mh.roi_size, mh.roi_size),
                             generator=gen, device=DEVICE)
            rel["mask head"] = card_vs_cpu_outputs(det, mf, on_cpu,
                                                   stage="mask")
        del on_cpu
        log(f"[{phase}] {tag} outputs card vs CPU at 1x{ANCHOR_SMALL[0]}x"
            f"{ANCHOR_SMALL[1]}, worst |diff| / max|ref|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
        if tag != HRNET_CONFIG.stem:
            return 0
        nc = head.num_classes
        with deterministic_cudnn():
            nms_keep.launches = 0
            step_card_vs_cpu(tag, cfg, variables, ANCHOR_SMALL,
                             ANCHOR_TRAIN_B, nc)
            batch = anchor_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B, nc,
                                 DEVICE)
            runs = []
            for _ in range(2):
                m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                               P23_DET_STEPS)
                runs += [m, {k: p.detach().clone() for k, p in
                             st.student.named_parameters()}]
                del st
            check_deterministic(*runs)
            log(f"[p23] {tag}: two runs of {P23_DET_STEPS} steps at "
                f"{ANCHOR_TRAIN_B}x{CANVAS[0]}x{CANVAS[1]} bit-identical "
                f"(the fuse's nearest resize and HRFPN's bilinear are matrix "
                f"products)")
            del batch
        if nms_keep.launches != 1 + 2 * P23_DET_STEPS:
            raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches in "
                                 f"the card vs CPU step and the determinism "
                                 f"runs, expected {1 + 2 * P23_DET_STEPS}")
        torch.cuda.empty_cache()
        return nms_keep.launches

    return probe


def _single_stage_checks(tag: str, cfg, det, images, smi: str,
                         want_n: int, timed: int = P23_TIMED,
                         steps: int = P23_STEPS, phase: str = "p23",
                         canvas=None, train: bool = True
                         ) -> tuple[int, dict, tuple]:
    """A single-stage detector of phase 23 or 24 (uncut, seeded): one
    counted predict at B=8 (1 NMS launch at N = ``want_n``, keeps equal,
    dets finite with detections in every image), the median of ``timed``
    with its peak memory; the backbone's levels, the neck's and the head
    outputs card vs CPU within 1e-3 of the largest magnitude at 1x128x192;
    ``steps`` steps at B=2 after a warm-up (cuDNN deterministic; losses
    finite, no NMS), timed with their peak memory, on ``canvas`` (the
    images' size, ``CANVAS`` by default), unless ``train`` is False.
    Returns (the worst keep difference, the path entry, the recorded NMS
    input)."""
    import torch

    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.ops.nms import nms_keep

    log(f"[{phase}] {tag}: {type(det).__name__} "
        f"({type(det.backbone).__name__}, {type(det.neck).__name__}), "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters")

    def predict():
        return detector_predict(det, images, device=DEVICE)

    _, _, calls, worst = predict_counted(
        tag, predict, [want_n], (BATCH, cfg.model.test_cfg.max_per_img, 5))
    ms = time_predict(tag, predict, BATCH, smi, reps=timed, peak=True)
    small = images[:1, :, :ANCHOR_SMALL[0], :ANCHOR_SMALL[1]]
    on_cpu = copy.deepcopy(det).cpu()
    rel = {"backbone": card_vs_cpu_outputs(det.backbone, small,
                                           on_cpu.backbone),
           "neck": card_vs_cpu_outputs(
               lambda x: det.neck(det.backbone(x)), small,
               lambda x: on_cpu.neck(on_cpu.backbone(x))),
           "head outputs": card_vs_cpu_outputs(det, small, on_cpu)}
    del on_cpu
    log(f"[{phase}] {tag} outputs card vs CPU at 1x{ANCHOR_SMALL[0]}x"
        f"{ANCHOR_SMALL[1]}, worst |diff| / max|ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"{tag}: card and CPU disagree: {rel}")
    if train:
        variables = seeded_variables(cfg)
        batch = anchor_batch(TRAIN_SEED, canvas or CANVAS, ANCHOR_TRAIN_B,
                             cfg.model.bbox_head.num_classes, DEVICE)
        with deterministic_cudnn():
            nms_keep.launches = 0
            time_steps(tag, cfg, variables, batch, smi, timed=steps,
                       peak=True)
            if nms_keep.launches:
                raise AssertionError(f"{tag} steps: {nms_keep.launches} NMS "
                                     f"launches, expected none")
        del batch
    torch.cuda.empty_cache()
    return worst, dict(B=BATCH, N=want_n, launches=1, predict_ms=ms), \
        calls[0][:3]


def phase_hrnet_fcos(tmp: Path, coco: dict, smi: str):
    """FCOS HRNetV2p-W18 (``HRNET_FCOS_CONFIG``, uncut, seeded): the
    :func:`_single_stage_checks` (1 NMS launch per predict at N =
    ``ROI_NMS_N``), then ``train_detector`` for one epoch of phase 19's COCO
    set with ``bbox`` evaluation and the test CLI's ``--eval bbox``
    (:func:`run_test_cli`): losses finite, ``bbox_mAP`` in [0, 1], NMS once
    per evaluation batch and none in a step. Returns (NMS launches, the
    worst keep difference, the path entry, the recorded NMS input)."""
    import math

    import torch

    from dsl_tpu_torch.apis import init_detector, train_detector
    from dsl_tpu_torch.apis.test import BATCH_SIZE
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.ops.nms import nms_keep
    from dsl_tpu_torch.utils.synthetic_data import coco_instance_config

    cfg = Config.fromfile(str(HRNET_FCOS_CONFIG))
    det = init_detector(cfg, variables=seeded_variables(cfg),
                        device=DEVICE).detector
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    worst, path, nms_input = _single_stage_checks(
        HRNET_FCOS_CONFIG.stem, cfg, det, images, smi, ROI_NMS_N)
    del det, images
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    raw = coco_instance_config(cfg.to_dict(), coco)
    raw["runner"] = dict(raw.get("runner") or {}, max_epochs=1)
    raw["log_config"] = dict(interval=1)
    raw["evaluation"] = dict(interval=1, metric="bbox")
    work = tmp / "hrnet_fcos23"
    cfg_path = tmp / "hrnet_fcos23.py"
    Config(raw).dump(str(cfg_path))
    batches = math.ceil(MASK_VAL_IMAGES / BATCH_SIZE)
    nms_keep.launches = 0
    train_detector(Config(raw), str(work), device=DEVICE,
                   variables=seeded_variables(Config(raw)))
    torch.cuda.synchronize()
    launches = nms_keep.launches
    lines = [json.loads(x) for x in
             (work / "train.log.json").read_text().splitlines()]
    steps = [x for x in lines if x.get("mode") == "train"]
    val = [x for x in lines if x.get("mode") == "val"]
    keys = sorted(k for k in steps[-1] if k.startswith("loss")) if steps else []
    if not steps or not all(math.isfinite(x[k]) for x in steps for k in keys):
        raise AssertionError(f"FCOS-HRNet train_detector losses: {steps}")
    if len(val) != 1 or not 0.0 <= val[-1]["bbox_mAP"] <= 1.0:
        raise AssertionError(f"FCOS-HRNet evaluation: {val}")
    if launches != batches:
        raise AssertionError(f"train_detector made {launches} NMS launches, "
                             f"expected 1 per evaluation batch ({batches}) "
                             f"and none in a step")
    log(f"[p23] {HRNET_FCOS_CONFIG.relative_to(ROOT)} train_detector: "
        f"{len(steps)} steps, losses finite (last " + ", ".join(
            f"{k} {steps[-1][k]:.4f}" for k in keys)
        + f"), bbox_mAP {val[-1]['bbox_mAP']:.4f}, NMS launches {launches}")
    child, out = run_test_cli([str(cfg_path), str(work / "epoch_1.pth"),
                               "--eval", "bbox"], tag="hrnet_fcos23")
    metrics = json.loads(next(x for x in reversed(out) if x.startswith("{")))
    if not 0.0 <= metrics["bbox_mAP"] <= 1.0 or child != batches:
        raise AssertionError(f"test CLI: {metrics}, {child} NMS launches")
    log(f"[p23] test CLI --eval bbox: bbox_mAP {metrics['bbox_mAP']}, NMS "
        f"launches {child}; workflow {time.perf_counter() - t0:.1f} s")
    return 1 + launches + child, worst, path, nms_input


def phase_ssd_mobilenet(smi: str) -> tuple[int, int]:
    """SSD on MobileNetV2 (``SSD_MOBILENET_CONFIG``: an FPN, five levels at
    strides 4-64, uncut, seeded): the :func:`_single_stage_checks` (1 NMS
    launch per predict at N = ``SSD_NMS_N``). Returns (NMS launches, the
    worst keep difference)."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config

    cfg = Config.fromfile(str(SSD_MOBILENET_CONFIG))
    det = init_detector(cfg, variables=seeded_variables(cfg),
                        device=DEVICE).detector
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    worst = _single_stage_checks(SSD_MOBILENET_CONFIG.stem, cfg, det, images,
                                 smi, SSD_NMS_N)[0]
    del det, images
    torch.cuda.empty_cache()
    return 1, worst


def conv_backward_repeats(smi: str):
    """Whether the backward of the grouped and depthwise 3x3 convolutions
    of slice 16 (``GROUPED_CONVS``: RegNetX-3.2GF's, MobileNetV2's, at a
    B=2 step's shapes at 800x1344) repeats bit for bit under cuDNN's
    deterministic algorithms, as ``train_detector`` runs: the input's and
    the weight's gradients of two backward passes of one seeded forward
    compared. Logged, not asserted: the step's determinism is checked
    where the card gives it (HRNet, phase 23; the f32 flagship, phase 6)."""
    import torch
    import torch.nn.functional as F

    from dsl_tpu_torch.apis.train import deterministic_cudnn

    gen = torch.Generator(device=DEVICE).manual_seed(30)
    results = []
    with deterministic_cudnn():
        for name, c, groups, h, w, stride in GROUPED_CONVS:
            x = torch.randn((ANCHOR_TRAIN_B, c, h, w), generator=gen,
                            device=DEVICE)
            wt = torch.randn((c, c // groups, 3, 3), generator=gen,
                             device=DEVICE) * (9 * c // groups) ** -0.5
            grads = []
            for _ in range(2):
                xi, wi = x.clone().requires_grad_(), wt.clone().requires_grad_()
                out = F.conv2d(xi, wi, None, stride, 1, 1, groups)
                g = torch.randn(out.shape, generator=torch.Generator(
                    device=DEVICE).manual_seed(31), device=DEVICE)
                out.backward(g)
                grads.append((xi.grad, wi.grad))
            same = (torch.equal(grads[0][0], grads[1][0]),
                    torch.equal(grads[0][1], grads[1][1]))
            results.append((name, *same))
            del x, wt, grads
    torch.cuda.empty_cache()
    log("[p23] grouped / depthwise conv backward under cuDNN deterministic, "
        "two passes bit-identical (input grad, weight grad): " + ", ".join(
            f"{n} {a}/{b}" for n, a, b in results) + f"  ({smi})")


VFNET_CONFIG = (ROOT / "configs" / "vfnet"
                / "vfnet_r50_fpn_mdconv_c3-c5_mstrain_2x_coco.py")
DCN_RCNN_CONFIGS = tuple(ROOT / "configs" / "dcn" / p for p in (
    "faster_rcnn_r50_fpn_mdconv_c3-c5_group4_1x_coco.py",
    "faster_rcnn_r50_fpn_mdpool_1x_coco.py"))
FCOS_DCN_CONFIG = (ROOT / "configs" / "fcos" / "fcos_center-normbbox-"
                   "centeronreg-giou_r50_caffe_fpn_gn-head_dcn_1x_coco.py")
P24_TIMED, P24_STEPS = 3, 3   # phase 24's predicts and steps timed (median)
P24_DET_STEPS = 2             # VFNet's steps per determinism run


def slice17_probe(smi: str):
    """:func:`slice16_probe` for phase 24's two-stage detectors, then, for
    the one with a deformable RoI pooling pack, its RoI extraction card vs
    CPU within 1e-3 on 64 seeded RoIs of seeded levels at 128x192 (the
    pack's offsets and mask, the deformable re-pool). Returns the NMS
    launches (none)."""
    base = slice16_probe(smi, phase="p24")

    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.models.roi_heads.standard_roi_head import (
            extract_roi_feats)

        launches = base(tag, cfg, variables, det, images)
        if det.roi_pool_pack is None:
            return launches
        gen = torch.Generator(device=DEVICE).manual_seed(31)
        levels = [torch.randn((1, det.bbox_head.in_channels,
                               ANCHOR_SMALL[0] // s,
                               ANCHOR_SMALL[1] // s), generator=gen,
                              device=DEVICE) for s in det.strides]
        xy = torch.rand((64, 2), generator=gen, device=DEVICE) * 150 - 10
        wh = torch.exp(torch.rand((64, 2), generator=gen, device=DEVICE) * 5)
        rois = torch.cat([torch.zeros((64, 1), device=DEVICE), xy, xy + wh], 1)
        valid = torch.ones((64,), dtype=torch.bool, device=DEVICE)
        on_cpu = copy.deepcopy(det).cpu()

        def extract(d, fs, r, v):
            return extract_roi_feats(fs, r, v, d.strides, 7, True,
                                     (lambda rf: d(rf, stage="pack"),
                                      d.roi_pool_pack))

        with torch.no_grad():
            got = extract(det, levels, rois, valid)
            want = extract(on_cpu, [f.cpu() for f in levels], rois.cpu(),
                           valid.cpu())
        diff = float((got.cpu() - want).abs().max()
                     / want.abs().max().clamp_min(1.0))
        log(f"[p24] {tag} deformable RoI extraction card vs CPU on 64 RoIs, "
            f"worst |diff| / max|ref| {diff:.3e}")
        if diff > 1e-3:
            raise AssertionError(f"{tag}: the deformable RoI extraction "
                                 f"differs card vs CPU: {diff}")
        return launches

    return probe


def phase_vfnet(smi: str):
    """VFNet R50 with DCNv2 in c3-c5 (``VFNET_CONFIG``, uncut, seeded):
    the :func:`_single_stage_checks` (1 NMS launch per predict at N =
    ``ROI_NMS_N``, ``P24_TIMED`` predicts and ``P24_STEPS`` steps timed),
    a trace of a predict for deformable convolution's share
    (:func:`deform_conv_share`), then two runs of ``P24_DET_STEPS`` f32
    steps from one seed at B=2 bit-identical (cuDNN deterministic).
    Returns (NMS launches, the worst keep difference, the path entry, the
    recorded NMS input)."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.apis.train import deterministic_cudnn
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import detector_predict
    from dsl_tpu_torch.ops.nms import nms_keep

    cfg = Config.fromfile(str(VFNET_CONFIG))
    variables = seeded_variables(cfg)
    det = init_detector(cfg, variables=variables, device=DEVICE).detector
    gen = torch.Generator(device=DEVICE).manual_seed(32)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    tag = VFNET_CONFIG.stem
    worst, path, nms_input = _single_stage_checks(
        tag, cfg, det, images, smi, ROI_NMS_N, timed=P24_TIMED,
        steps=P24_STEPS, phase="p24")
    share = deform_conv_share(f"{tag} predict B={BATCH}",
                              lambda: detector_predict(det, images,
                                                       device=DEVICE), smi)
    path.update(dcn_share=share["roi_ms"] / share["kernel_ms"])
    del det, images
    torch.cuda.empty_cache()
    batch = anchor_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B,
                         cfg.model.bbox_head.num_classes, DEVICE)
    with deterministic_cudnn():
        nms_keep.launches = 0
        runs = []
        for _ in range(2):
            m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                           P24_DET_STEPS)
            runs += [m, {k: p.detach().clone() for k, p in
                         st.student.named_parameters()}]
            del st
        check_deterministic(*runs)
        if nms_keep.launches:
            raise AssertionError(f"{tag} steps: {nms_keep.launches} NMS "
                                 f"launches, expected none")
    log(f"[p24] {tag}: two runs of {P24_DET_STEPS} steps at "
        f"{ANCHOR_TRAIN_B}x{CANVAS[0]}x{CANVAS[1]} bit-identical (the "
        f"deformable gathers' backward a sorted index_put_)")
    del batch, runs
    torch.cuda.empty_cache()
    return 1, worst, path, nms_input


def phase_fcos_dcn(smi: str) -> tuple[int, int]:
    """FCOS R50 caffe with DCN in c3-c5 and DCNv2 on its towers' last conv
    (``FCOS_DCN_CONFIG``, uncut, seeded): one counted predict at B=8 (1
    NMS launch at N = ``ROI_NMS_N``, keeps equal, dets finite with
    detections in every image), the median of ``P24_TIMED``. Returns (NMS
    launches, the worst keep difference)."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import detector_predict

    cfg = Config.fromfile(str(FCOS_DCN_CONFIG))
    det = init_detector(cfg, variables=seeded_variables(cfg),
                        device=DEVICE).detector
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    images = torch.randn((BATCH, 3, *CANVAS), generator=gen, device=DEVICE)
    tag = FCOS_DCN_CONFIG.stem
    log(f"[p24] {tag}: {type(det).__name__}, "
        f"{sum(p.numel() for p in det.parameters()) / 1e6:.2f} M parameters")

    def predict():
        return detector_predict(det, images, device=DEVICE)

    _, _, _, worst = predict_counted(
        tag, predict, [ROI_NMS_N], (BATCH, cfg.model.test_cfg.max_per_img, 5))
    time_predict(tag, predict, BATCH, smi, reps=P24_TIMED, peak=True)
    del det, images
    torch.cuda.empty_cache()
    return 1, worst


GCB_CONFIG = (ROOT / "configs" / "gcnet"
              / "mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py")
ATTENTION_CONFIG = (ROOT / "configs" / "empirical_attention"
                    / "faster_rcnn_r50_fpn_attention_1111_1x_coco.py")
CARAFE_CONFIG = ROOT / "configs" / "carafe" / "faster_rcnn_r50_fpn_carafe_1x_coco.py"
LIBRA_CONFIG = (ROOT / "configs" / "libra_rcnn"
                / "libra_faster_rcnn_r50_fpn_1x_coco.py")
PLUGIN_NECK_CONFIGS = (GCB_CONFIG, ATTENTION_CONFIG,
                   ROOT / "configs" / "pafpn" / "faster_rcnn_r50_pafpn_1x_coco.py",
                   CARAFE_CONFIG, LIBRA_CONFIG)
FPG_CONFIG = ROOT / "configs" / "fpg" / "faster_rcnn_r50_fpg_crop640_50e_coco.py"
NAS_RETINA_CONFIG = (ROOT / "configs" / "nas_fpn"
                     / "retinanet_r50_fpn_crop640_50e_coco.py")
PLUGIN_NECK_SINGLE = (
    (NAS_RETINA_CONFIG, "nas_retina", True),
    (ROOT / "configs" / "libra_rcnn" / "libra_retinanet_r50_fpn_1x_coco.py",
     "libra_retina", True),
    (ROOT / "configs" / "nas_fcos"
     / "nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py", "nas_fcos",
     False))
CROP_CANVAS = (640, 640)      # NAS-FPN's and FPG's crops (an odd P5 raises)
P25_TIMED, P25_STEPS = 3, 1   # phase 25's predicts and steps timed (median)
P25_DET_STEPS = 2             # CARAFE's steps per determinism run
ATTENTION_RANGE = "generalized_attention"


def random_sampler(cfg):
    """``cfg`` with Libra's ``CombinedSampler`` replaced by the random
    sampler (it raises in the port's training; the JAX package trains it
    as the random sampler); another config as it is."""
    from dsl_tpu_torch.config import Config

    rcnn = (cfg.model.get("train_cfg") or {}).get("rcnn") or {}
    if (rcnn.get("sampler") or {}).get("type") != "CombinedSampler":
        return cfg
    d = cfg.to_dict()
    d["model"]["train_cfg"]["rcnn"]["sampler"] = dict(
        type="RandomSampler", num=512, pos_fraction=0.25,
        add_gt_as_proposals=True)
    return Config(d)


@contextlib.contextmanager
def attention_ranges():
    """Every ``GeneralizedAttention`` forward in a ``record_function`` range
    named ``ATTENTION_RANGE``, for a predict's trace."""
    import torch

    from dsl_tpu_torch.models.layers import GeneralizedAttention

    real = GeneralizedAttention.forward

    def wrapped(self, x):
        with torch.profiler.record_function(ATTENTION_RANGE):
            return real(self, x)

    GeneralizedAttention.forward = wrapped
    try:
        yield
    finally:
        GeneralizedAttention.forward = real


def plugin_neck_probe(smi: str):
    """:func:`slice16_probe` for phase 25's two-stage detectors, then for
    the attention one (``ATTENTION_CONFIG``) one trace of a predict for
    GeneralizedAttention's share of the kernels' time
    (:func:`roi_align_share` over :func:`attention_ranges`), and for the
    CARAFE one (``CARAFE_CONFIG``) two f32 runs of ``P25_DET_STEPS`` steps
    from one seed at B=2 that must be bit-identical in every loss and
    parameter (cuDNN deterministic). Returns the NMS launches (1 per
    step)."""
    base = slice16_probe(smi, phase="p25")

    def probe(tag, cfg, variables, det, images) -> int:
        import torch

        from dsl_tpu_torch.apis.train import deterministic_cudnn
        from dsl_tpu_torch.models import detector_predict
        from dsl_tpu_torch.ops.nms import nms_keep

        launches = base(tag, cfg, variables, det, images)
        if tag == ATTENTION_CONFIG.stem:
            roi_align_share(
                f"{tag} predict B={images.shape[0]}",
                lambda: detector_predict(det, images, device=DEVICE), smi,
                scope=attention_ranges, range_name=ATTENTION_RANGE,
                what="GeneralizedAttention")
        if tag != CARAFE_CONFIG.stem:
            return launches
        batch = anchor_batch(TRAIN_SEED, CANVAS, ANCHOR_TRAIN_B,
                             det.bbox_head.num_classes, DEVICE)
        with deterministic_cudnn():
            nms_keep.launches = 0
            runs = []
            for _ in range(2):
                m, _, st, _ = anchor_step_runs(cfg, variables, batch,
                                               P25_DET_STEPS)
                runs += [m, {k: p.detach().clone() for k, p in
                             st.student.named_parameters()}]
                del st
            check_deterministic(*runs)
        if nms_keep.launches != 2 * P25_DET_STEPS:
            raise AssertionError(f"{tag}: {nms_keep.launches} NMS launches in "
                                 f"the determinism runs, expected "
                                 f"{2 * P25_DET_STEPS}")
        log(f"[p25] {tag}: two runs of {P25_DET_STEPS} steps at "
            f"{ANCHOR_TRAIN_B}x{CANVAS[0]}x{CANVAS[1]} bit-identical (CARAFE's "
            f"taps are slices, its kernels a pixel shuffle)")
        del batch, runs
        torch.cuda.empty_cache()
        return launches + nms_keep.launches

    return probe


def phase_plugin_neck_single(smi: str):
    """Phase 25's single-stage detectors (``PLUGIN_NECK_SINGLE``, uncut,
    seeded): RetinaNet on NAS-FPN with RetinaSepBNHead at 640x640, Libra
    RetinaNet (BFP ``conv``, Balanced L1) and NAS-FCOS at 800x1344, each
    through :func:`_single_stage_checks` (1 NMS launch per predict at N =
    ``ROI_NMS_N``, ``P25_TIMED`` predicts timed, card vs CPU at 1x128x192,
    ``P25_STEPS`` steps for the first two; for NAS-FCOS, whose towers hold
    20 deformable convs, a trace of a predict for their share,
    :func:`deform_conv_share`). Returns (NMS launches, the worst keep
    difference, {label: (path entry, recorded NMS input)})."""
    import torch

    from dsl_tpu_torch.apis import init_detector
    from dsl_tpu_torch.config import Config
    from dsl_tpu_torch.models import detector_predict

    launches, worst, out = 0, 0, {}
    for path, label, train in PLUGIN_NECK_SINGLE:
        cfg = Config.fromfile(str(path))
        det = init_detector(cfg, variables=seeded_variables(cfg),
                            device=DEVICE).detector
        canvas = CROP_CANVAS if path == NAS_RETINA_CONFIG else CANVAS
        gen = torch.Generator(device=DEVICE).manual_seed(35)
        images = torch.randn((BATCH, 3, *canvas), generator=gen,
                             device=DEVICE)
        w, entry, nms_input = _single_stage_checks(
            path.stem, cfg, det, images, smi, ROI_NMS_N, timed=P25_TIMED,
            steps=P25_STEPS, phase="p25", canvas=canvas, train=train)
        if label == "nas_fcos":
            deform_conv_share(
                f"{path.stem} predict B={BATCH}",
                lambda: detector_predict(det, images, device=DEVICE), smi)
        launches, worst = launches + 1, max(worst, w)
        out[label] = (entry, nms_input)
        del det, images
        torch.cuda.empty_cache()
    return launches, worst, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    tests_on_path()
    name, smi = phase_device()
    log(f"[phase 1] {time.perf_counter() - t_start:.1f} s")
    t = time.perf_counter()
    phase_build()
    log(f"[phase 2] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    case_err = phase_kernel_cases()
    log(f"[phase 3] {time.perf_counter() - t:.1f} s")
    from dsl_tpu_torch.config import Config

    from dsl_tpu_torch.apis.train import deterministic_cudnn

    t = time.perf_counter()
    cfg = Config.fromfile(str(CONFIG))
    variables = seeded_variables(cfg)
    # the models of phases 17-25, in the order they run
    prefetch_seeded_variables((
        FASTER_RCNN_CONFIG, RETINANET_CONFIG, FASTER_RCNN_VOC_CONFIG,
        SSD_VOC_CONFIG, RPN_CONFIG, FAST_RCNN_CONFIG, *VARIANT_CONFIGS,
        MASK_RCNN_CONFIG, MASK_MSTRAIN_CONFIG, *C4_CONFIGS, *CASCADE_CONFIGS,
        CASCADE_MSTRAIN_CONFIG, *HTC_CONFIGS, POINT_REND_CONFIG,
        SEESAW_CONFIG, YOLACT_CONFIG, *SLICE16_CONFIGS, HRNET_FCOS_CONFIG,
        SSD_MOBILENET_CONFIG, VFNET_CONFIG, *DCN_RCNN_CONFIGS,
        FCOS_DCN_CONFIG, *PLUGIN_NECK_CONFIGS, FPG_CONFIG,
        *(p for p, _, _ in PLUGIN_NECK_SINGLE)))
    bundle, images, launches, path_err, calls = phase_main_path(cfg, variables)
    log(f"[phase 4] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_timing(bundle, images, smi)
    nms_times = phase_nms_timing(calls, smi)["predict_b8"]
    del bundle, images, calls
    torch.cuda.empty_cache()
    log(f"[phase 5] {time.perf_counter() - t:.1f} s")
    # as train_detector runs its steps: cuDNN's deterministic algorithms,
    # no autotuning (phase 7 also times the step without them)
    with deterministic_cudnn():
        t = time.perf_counter()
        train_launches, train_err, runs, batch = phase_train(cfg, variables,
                                                             smi)
        launches["nms_keep"] += train_launches["nms_keep"]
        t6 = time.perf_counter() - t
        t = time.perf_counter()
        phase_train_timing(runs, batch, smi)
        del runs
        torch.cuda.empty_cache()
        log(f"[phase 7] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_train_card_vs_cpu(cfg, variables)
        log(f"[phase 6] {t6 + time.perf_counter() - t:.1f} s (the runs "
            f"{t6:.1f}, card vs CPU {time.perf_counter() - t:.1f})")
    t = time.perf_counter()
    phase_decode(smi)
    phase_resize(smi)
    log(f"[phase 8] {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_strong_aug(smi)
    log(f"[phase 9] {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory(prefix="_semi_smoke_", dir=ROOT) as tmp:
        t = time.perf_counter()
        runner, semi_launches, semi_cfg = phase_semi(variables, smi, Path(tmp))
        with deterministic_cudnn():          # as train_detector iterates
            semi_err = phase_semi_overlap_and_timing(runner, smi, Path(tmp))
        log(f"[phase 10] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        eval_launches, eval_err = phase_eval(runner, semi_cfg, smi)
        log(f"[phase 11] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        weights_launches = phase_weights(cfg, variables, runner, semi_cfg,
                                         Path(tmp), smi)
        del runner
        torch.cuda.empty_cache()
        log(f"[phase 12] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        baseline_launches, baseline = phase_baseline(Path(tmp), smi)
        log(f"[phase 13] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        voc_launches, voc_err = phase_voc(Path(tmp), smi)
        log(f"[phase 14] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        dist_launches = phase_dist_nccl(Path(tmp), smi, baseline)
        dist_launches += phase_dist_ranks(Path(tmp), smi)
        log(f"[phase 15] {time.perf_counter() - t:.1f} s")
        t16 = time.perf_counter()
        phase_png(Path(tmp), smi)
        mh_launches, mh_err = phase_multihead(cfg, smi)
        phase_new_transforms(smi)
        cfg_launches, cfg_err = phase_config_paths(Path(tmp), smi)
        log(f"[phase 16] {time.perf_counter() - t16:.1f} s")
        t17 = time.perf_counter()
        anchor_launches, anchor_err, anchor_paths, anchor_inputs = (
            phase_anchor_predict(smi))
        for entry in anchor_paths:
            entry.update(nms_input_timing(f"{entry['path']}_b{entry['B']}",
                                          *anchor_inputs[entry["path"]], smi))
        del anchor_inputs
        with deterministic_cudnn():          # as train_detector steps
            train17_launches, _ = phase_anchor_train(smi)
        voc17_launches = phase_anchor_voc(Path(tmp), smi)
        log(f"[phase 17] {time.perf_counter() - t17:.1f} s")
        t18 = time.perf_counter()
        ssd_launches, ssd_err, p18_paths, p18_inputs = phase_ssd(Path(tmp), smi)
        rpn_launches, rpn_err, rpn_paths, rpn_inputs = phase_rpn_fast(smi)
        variant_launches, variant_err, _, _ = phase_variants(smi)
        p18_paths += rpn_paths
        p18_inputs.update(rpn_inputs)
        for entry in p18_paths:
            entry.update(nms_input_timing(f"{entry['path']}_b{entry['B']}",
                                          *p18_inputs[entry["path"]], smi))
        del p18_inputs, rpn_inputs
        log(f"[phase 18] {time.perf_counter() - t18:.1f} s")
        t19 = time.perf_counter()
        mask_launches, mask_err, mask_path, mask_input = phase_mask_predict(
            smi)
        with deterministic_cudnn():          # as train_detector steps
            mask_launches += phase_mask_train(smi)
        coco = coco_instance(Path(tmp))
        phase_mask_pipeline(coco, smi)
        flow_launches, flow_err = phase_mask_workflow(Path(tmp), coco, smi)
        c4_launches, c4_err, _, _ = phase_variants(smi, C4_CONFIGS, C4_B,
                                                   seed=22, phase="p19")
        mask_launches += flow_launches + c4_launches
        mask_path.update(nms_input_timing("mask_rcnn_b8", *mask_input, smi))
        p18_paths.append(mask_path)
        del mask_input
        log(f"[phase 19] {time.perf_counter() - t19:.1f} s")
        t20 = time.perf_counter()
        cascade_launches, cascade_err, cascade_paths, cascade_inputs = (
            phase_variants(smi, CASCADE_CONFIGS, BATCH, seed=23, phase="p20",
                           probe=cascade_probe(smi), trace=True))
        cascade_launches += phase_cascade_workflow(Path(tmp), coco, smi)
        cascade_path = dict(cascade_paths[0], path="cascade")
        cascade_path.update(nms_input_timing(
            "cascade_b8", *cascade_inputs[CASCADE_CONFIGS[0].stem], smi))
        p18_paths.append(cascade_path)
        del cascade_inputs
        log(f"[phase 20] {time.perf_counter() - t20:.1f} s")
        t21 = time.perf_counter()
        htc_launches, htc_err, htc_paths, htc_inputs = phase_variants(
            smi, HTC_CONFIGS, BATCH, seed=24, phase="p21",
            probe=htc_probe(smi), trace=True, timed=HTC_TIMED,
            steps=HTC_STEPS)
        htc_launches += phase_htc_workflow(Path(tmp), coco, smi)
        htc_path = dict(htc_paths[0], path="htc")
        htc_path.update(nms_input_timing(
            "htc_b8", *htc_inputs[HTC_CONFIGS[0].stem], smi))
        p18_paths.append(htc_path)
        del htc_inputs
        log(f"[phase 21] {time.perf_counter() - t21:.1f} s")
        t22 = time.perf_counter()
        slice_launches, slice_err, slice_paths, slice_inputs = phase_variants(
            smi, (POINT_REND_CONFIG, SEESAW_CONFIG), BATCH, seed=26,
            phase="p22", probe=slice15_probe(smi), timed=P22_TIMED,
            steps=P22_STEPS, peak=True)
        slice_launches += phase_seesaw_workflow(Path(tmp), coco)
        for entry, path, label in zip(slice_paths,
                                      (POINT_REND_CONFIG, SEESAW_CONFIG),
                                      ("point_rend", "seesaw")):
            # the seeded classifiers leave the RoI NMS its full N
            roi_valid = slice_inputs[path.stem][1].sum(1).tolist()
            if min(roi_valid) < ROI_NMS_N:
                raise AssertionError(f"{label}: fewer than {ROI_NMS_N} RoI "
                                     f"NMS candidates over score_thr: "
                                     f"{roi_valid}")
            entry = dict(entry, path=label)
            entry.update(nms_input_timing(f"{label}_b8",
                                          *slice_inputs[path.stem], smi))
            p18_paths.append(entry)
        del slice_inputs
        phase_yolact(Path(tmp), coco, smi)
        log(f"[phase 22] {time.perf_counter() - t22:.1f} s")
        t23 = time.perf_counter()
        s16_launches, s16_err, s16_paths, s16_inputs = phase_variants(
            smi, SLICE16_CONFIGS, BATCH, seed=27, phase="p23",
            probe=slice16_probe(smi), timed=P23_TIMED, steps=P23_STEPS,
            peak=True)
        entry = dict(s16_paths[0], path="hrnet_rcnn")
        entry.update(nms_input_timing("hrnet_rcnn_b8",
                                      *s16_inputs[HRNET_CONFIG.stem], smi))
        p18_paths.append(entry)
        del s16_inputs
        fcos_launches, fcos_err, fcos_path, fcos_input = phase_hrnet_fcos(
            Path(tmp), coco, smi)
        fcos_path.update(path="hrnet_fcos",
                         **nms_input_timing("hrnet_fcos_b8", *fcos_input, smi))
        p18_paths.append(fcos_path)
        del fcos_input
        ssd23_launches, ssd23_err = phase_ssd_mobilenet(smi)
        s16_launches += fcos_launches + ssd23_launches
        s16_err = max(s16_err, fcos_err, ssd23_err)
        conv_backward_repeats(smi)
        log(f"[phase 23] {time.perf_counter() - t23:.1f} s")
        t24 = time.perf_counter()
        vf_launches, vf_err, vf_path, vf_input = phase_vfnet(smi)
        vf_path.update(path="vfnet",
                       **nms_input_timing("vfnet_b8", *vf_input, smi))
        p18_paths.append(vf_path)
        del vf_input
        dcn_launches, dcn_err, dcn_paths, dcn_inputs = phase_variants(
            smi, DCN_RCNN_CONFIGS, BATCH, seed=34, phase="p24",
            probe=slice17_probe(smi), timed=P24_TIMED, steps=P23_STEPS,
            peak=True)
        entry = dict(dcn_paths[0], path="dcn_rcnn")
        entry.update(nms_input_timing(
            "dcn_rcnn_b8", *dcn_inputs[DCN_RCNN_CONFIGS[0].stem], smi))
        p18_paths.append(entry)
        del dcn_inputs
        fd_launches, fd_err = phase_fcos_dcn(smi)
        s17_launches = vf_launches + dcn_launches + fd_launches
        s17_err = max(vf_err, dcn_err, fd_err)
        log(f"[phase 24] {time.perf_counter() - t24:.1f} s")
        t25 = time.perf_counter()
        probe25 = plugin_neck_probe(smi)
        p25_launches, p25_err, _, _ = phase_variants(
            smi, PLUGIN_NECK_CONFIGS, BATCH, seed=36, phase="p25",
            probe=probe25, timed=P25_TIMED, steps=P25_STEPS, peak=True,
            prepare=random_sampler)
        fpg_launches, fpg_err, fpg_paths, fpg_inputs = phase_variants(
            smi, (FPG_CONFIG,), BATCH, seed=37, phase="p25",
            probe=slice16_probe(smi, phase="p25"), timed=P25_TIMED,
            steps=P25_STEPS, peak=True, canvas=CROP_CANVAS)
        entry = dict(fpg_paths[0], path="fpg_rcnn", N=RPN_NMS_N_640)
        entry.update(nms_input_timing(
            "fpg_rcnn_b8", *fpg_inputs[f"{FPG_CONFIG.stem}_rpn"], smi))
        p18_paths.append(entry)
        del fpg_inputs
        ss_launches, ss_err, ss_out = phase_plugin_neck_single(smi)
        entry, nms_input = ss_out["nas_retina"]
        entry.update(path="nas_retina",
                     **nms_input_timing("nas_retina_b8", *nms_input, smi))
        p18_paths.append(entry)
        del ss_out
        p25_launches += fpg_launches + ss_launches
        p25_err = max(p25_err, fpg_err, ss_err)
        log(f"[phase 25] {time.perf_counter() - t25:.1f} s")
    launches["nms_keep"] += (semi_launches + eval_launches + weights_launches
                             + baseline_launches + voc_launches + dist_launches
                             + mh_launches + cfg_launches + anchor_launches
                             + train17_launches + voc17_launches
                             + ssd_launches + rpn_launches + variant_launches
                             + mask_launches + cascade_launches
                             + htc_launches + slice_launches + s16_launches
                             + s17_launches + p25_launches)
    kernels = [dict(
        name="nms_keep", route="cuda",
        source="dsl_tpu_torch/csrc/nms_kernel.cu",
        replaces="dsl_tpu/ops/nms_pallas.py:34",
        launches=launches["nms_keep"],
        max_abs_err=float(max(case_err, path_err, train_err, semi_err,
                              eval_err, voc_err, mh_err, cfg_err, anchor_err,
                              ssd_err, rpn_err, variant_err, mask_err,
                              flow_err, c4_err, cascade_err, htc_err,
                              slice_err, s16_err, s17_err, p25_err)),
        ms=nms_times["ms"], plain_ms=nms_times["plain_ms"],
        bound_ms=nms_times["bound_ms"], bound_by=nms_times["bound_by"],
        library_ms=None,
        # the other detectors' inputs (phases 17-25), each timed alike
        paths=[{k: v for k, v in e.items() if k in (
            "path", "B", "N", "kept", "launches", "ms", "plain_ms",
            "bound_ms", "bound_by")} for e in anchor_paths + p18_paths])]
    _PREFETCH.shutdown(cancel_futures=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
