#!/usr/bin/env python3
"""Drive tpucv_torch's paths once on one NVIDIA GPU: the yolo8_det serving
path, the bench entry point's inference program, the four measurement
probes, the YOLOv8 training step, the YOLOv8 trainer, predict, evaluate
and in-training mAP on the trainer's checkpoint, YOLOv8-seg and
YOLOv8-pose through their trainers, predict and evaluate, int8
post-training quantization of all three (parity, bench, serve, predict,
evaluate), YOLOv7-l through its forward, decode, trainer, predict,
serve, evaluate, in-training mAP and int8 path, SSD300 and
CenterNet-DLA34 through the same paths, DeepLabV3+-ResNet101 through
its forward, trainer, predict, evaluate, int8 path and bench line, and
ViT-S/16 and YOLOv8n-cls through their forwards, trainers, train steps,
predict and top-1 / top-5 evaluate; then the export layer (torch.export
and torch.compile of the serving program, int8 included), data
parallelism (world size 1 over NCCL through the trainer, two ranks over
gloo on the card, a ZeRO-1 checkpoint resumed in one process), the bench
at YOLOv8 s/m/l/x and the shipped YOLOv7-x and SSD512; then the mesh's
model axis (channel-sharded YOLOv8x training), batch-sharded inference
and spatial partitioning on two gloo ranks, and the legacy YOLOv3
through its forward, loss, trainer, predict and evaluate; then the rest
of the zoo (VGG16-BN, MobileNetV2, UNet, CPM and the twenty blocks),
the YOLO-style batched_non_max_suppression through nms_keep,
convert_model and utils/profile.py.

    python3 chip_smoke.py

Phases, each printing one JSON line (its "t_s": the seconds since the
script started); any failure exits non-zero:

1. card     the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    builds every CUDA source of the port (one nvcc each, in
            parallel) and prints the build time and ptxas report.
3. kernel   the NMS kernels against their plain PyTorch versions on the
            cases of tpucv_torch/ops/nms_cases.py: those of
            tests/test_pallas_nms.py, the 60/120-deep chains, the 32-box
            block edges and class-offset sets at B=128, K=512/1024, IoU
            0.5/0.7: keep masks must be identical, the build's mask words
            (overlap_words) bit-equal to overlap_words_reference, and the
            walk alone over them must give the same keep mask.
4. serve    YOLOv8n, nc=80, 640 input, bf16 autocast, random weights from
            torch.Generator seed 0 with the class biases zeroed and the
            class kernels scaled by CLS_GAIN. First the f32 forward on the
            card is held against the CPU's. Then a server (make_server,
            batch 8) answers 16 concurrent raw-RGB requests; launch counts
            are zeroed just before the requests and read just after. The
            served images go through _batched_detections again, once with
            each NMS call's candidates recorded and held kernel against
            plain (identical keep masks and mask words), once through the
            plain version: boxes, scores and classes equal to the kernel
            route's, classes equal to the server's. A batch of 8 is then
            timed stage by stage.
5. bench    the bench.py:main program as tpucv_torch.bench runs it: B=128
            uint8 480x640, letterbox_static, forward, decode_boxes
            (pre_nms_topk=512), timed with CUDA events, device-resident and
            with the H2D copy; the kernels' and the plain version's times
            at the main path's shapes, the build and the walk timed apart,
            and the least time the card could take. Then scan_time:
            nms_scan at YOLOv7's B=32, K=4,096, max_det 100 (one launch,
            equal to its plain scan), timed in turns beside the plain
            scan's eager loop.
6. probe_bw python -m tpucv_torch.probes.probe_bw's main at full size
            (add_one's count zeroed just before, read just after); then
            add_one on the 1,638,400x128 bf16 array in its six views, bit
            for bit against x + 1, timed against it and its bound, with
            the launch (threads, CTAs, index width) the library reports.
7. probe_conv  the main of probe_conv, probe_conv_parts and probe_conv_v2
            at full size (conv3x3's count zeroed before each, read after);
            then conv3x3 at the six shapes in both modes, and the five
            timing-only variants at 64ch 320^2 B32, each against its plain
            definition (no element further than 2^-7 of its largest
            value) and the full conv against F.conv2d (relerr <= 2e-2),
            timed against the plain version, F.conv2d and the bound.
8. train_parity  the port's train step on the card against the same step
            on the CPU (YOLOv8n, B=2, 128², M=4, f32, TF32 off, a GT over
            the lowest-index anchors): TAL fg mask and GT rows bit-equal,
            loss and components within 1e-4 relative, BatchNorm statistics
            and parameters after one step within the CPU tests' bounds.
9. train    the train step at full width as tpucv_torch.bench runs it
            (YOLOv8n, B=128, 640², M=32, bf16 autocast, channels_last,
            Adam 1e-3, EMA 0.9999): 3 warm-up and 10 timed steps (CUDA
            events), img/s, the last loss and num_fg (finite), peak
            memory, one step split into forward / loss / backward /
            optimizer + EMA (median of 5, a sync after each stage), and
            the compute bound (3 x the forward's convolution FLOPs over
            the dense bf16 rate) as a share of the step (mfu).
10. augment  augment_batch at B=16, 640², M=100 on the card against the
            same call on the CPU, f32: the gather's source indices equal,
            pixels within AUG_PIXEL_TOL, boxes within 1e-5; ms (bf16 out).
11. trainer  Yolo8Trainer on yolo8_det's config as shipped (640², B=16,
            M=100, device_aug, mosaic 0.5, num_workers 0, bf16) for 40
            steps, 10 epochs of the synthetic set: evaluate_loop, the
            periodic and the final save. Steps, finite losses, images/s
            and the wait in next(loader) over steps 8-39 (host clock), the
            step on a device-resident batch (CUDA events) and its kernel
            time (torch.profiler), augment ms, the busy share, checkpoint
            save / load ms and bytes, peak memory, the host's CPUs; then
            the loader alone at 0 and 4 workers (host images/s, ms to each
            epoch's first batch), over the trainer's set and a set of 256.
12. ckpt_serve  the final checkpoint through CheckPoint.load_pure into a
            fresh serving model (weights bit-equal to the trained ones),
            one batch of 8 images through _batched_detections (nms_keep's
            count zeroed just before, read just after), detections held
            against the plain-NMS route as in serve_vs_plain.
13. predict  the final checkpoint with the class branch sharpened as in
            serve (sharpened.ckpt), through python -m tpucv_torch.predict's
            main on 4 JPEGs and a PNG (conf 0.25, K <= 1024): nms_keep's
            count zeroed just before, read just after; drawn files exist;
            detections equal to the same run through nms_keep's plain
            version; ms an image split into decode, letterbox, device and
            draw.
14. evaluate  a COCO-layout root written by the script (64 640x480 JPEGs,
            one PNG, one crowd GT) through python -m tpucv_torch.evaluate's
            main with sharpened.ckpt (B=32, conf 0.001: K = 4096, the
            sequential scan, no kernel): the 12 stats, images/s; the native
            COCOeval must build, and on the CLI's eval_results.json equals
            the numpy engine within 1e-12; then the CLI again with
            recorders around its own stages: ms a batch (full batches of
            32 apart from the last of 1) split into canvas fill, H2D +
            letterbox + forward + top-k, the scan and D2H + records, and
            COCOeval's ms; every batch's scan equal to the CPU's from the
            candidates the CLI gave it; the decode engine (native or cv2)
            and the host loader's rate over the JPEGs with each.
15. eval_map  trainer.evaluate_map on the run's final state, its
            parameters (class branch sharpened) handed over as the EMA
            (16 synthetic val images, B=16, conf 0.01: K = 1024): nms_keep's
            count, detections equal to the plain route's, the trained
            weights unchanged, ms a call.
16. resume   a new trainer resumes from the epoch-9 checkpoint: step 40
            and weights and Adam's state bit-equal to the file after
            loading, then 4 more steps with a finite loss.
17. seg_pose_parity  yolo8_seg's and yolo8_pose's forward on the card
            against the CPU (f32, TF32 off, 640, B=2: within 1e-3 of the
            largest value), then one train step each (B=2, 128², f32):
            TAL fg mask and GT rows bit-equal, loss terms within 1e-4
            relative.
18. seg_trainer / pose_trainer  python -m tpucv_torch.train's main at each
            shipped config (640², B=16, M=48 / 32, bf16, synthetic data)
            for 8 steps, 2 epochs, through evaluate_loop and the saves
            (their intervals set to 2): losses finite with mask_loss or
            kpt_loss / kobj_loss, images/s over steps 4-7, the step on a
            device-resident batch (events) and its kernels (profiler),
            peak memory.
19. seg_predict / pose_predict  python -m tpucv_torch.predict's main on
            the serve images (4 JPEGs, a PNG) with each final checkpoint's
            class branch sharpened (conf 0.25, K <= 1024): nms_keep's
            count zeroed just before, read just after; detections, masks
            and keypoints equal to the same run through nms_keep's plain
            version; drawn files exist; ms an image split into decode,
            letterbox, device, masks or keypoints, and draw.
20. seg_evaluate  python -m tpucv_torch.evaluate --model yolo8_seg on a
            COCO root written here (each GT box also a polygon; B=32, conf
            0.001: the scan), then evaluate_mask_ap over it: 12 bbox and
            12 mask stats, finite, the mask AP's ms by stage.
21. pose_evaluate  the evaluate CLI on the synthetic pose index (B=16,
            conf 0.001: the scan): box and OKS stats.
22. pose_eval_map  trainer.evaluate_map on the pose run (16 images, B=16,
            conf 0.01: K = 1024): nms_keep's count, detections equal to
            the plain route's, ms a call.
23. int8_parity  yolo8_det, yolo8_seg and yolo8_pose as shipped (640,
            bf16, seed-0 weights) quantized by quantize_variables on 8 of
            the serve images (B=2), one batch of 2 through each int8
            model: every quantized conv's int32 accumulators, card route
            (im2col + torch._int_mm) against the plain route (float64
            F.conv2d) on the card, bit-equal; count_quantized and the convs
            whose GEMM needed padding (pose's six 51-wide ones among them).
24. int8_bench  the bench entry's int8 program (bench.bench_int8, B=128
            480x640, calibrated on the first resident batch; nms_keep's
            count, one a call), then bf16 and int8 timed in turns (bf16,
            int8, int8, bf16), then probes.int8_conv_parts: quantize,
            im2col, _int_mm and dequant of the largest convs against
            F.conv2d bf16.
25. int8_serve  serve.build --int8 --calib (the serve images as JPEGs,
            sharpened.ckpt, batch 8): 16 requests, nms_keep's count; the
            share of the float model's detections matched by an int8 one
            of the same class at IoU >= 0.5, at least INT8_MATCH_MIN; the
            raw maps of a batch against the float model's: cosine at
            least INT8_COS_MIN, best class agreeing at INT8_CLASS_AGREE_MIN
            of the live anchors.
26. int8_predict  the predict CLI --int8 on the predict phase's 5 images:
            nms_keep's count (5), drawn files, the same matched share and
            each image's raw maps, gated as in int8_serve.
27. int8_evaluate  the evaluate CLI --int8 on the evaluate phase's COCO
            root (K = 4096, the scan): its 12 stats finite, beside the
            float run's; no accuracy gate (random weights).
28. yolo7_parity  yolo7 as shipped (YOLOv7-l, nc 20, 640), seed-0 weights:
            the f32 forward (B=2) on the card against the CPU, the box rows
            and the objectness and class rows of each map apart, each
            within YOLO7_FWD_REL of its largest value (TF32's reading
            reported beside it); yolov7_loss on the CPU's maps (100 GT
            rows, some padded), card against CPU: num_match equal, terms
            within 1e-4 relative. The later phases sharpen the head's
            objectness and class rows by YOLO7_GAIN.
29. yolo7_decode  decode_yolov7 on the card against the CPU on the same
            bf16 maps: 8 serve images at 640 (K = 4096, the scan) and two
            at 128² (K = 1,008: nms_keep, counted): keep sets, classes
            and scores equal, boxes within 1e-3 px.
30. yolo7_trainer  python -m tpucv_torch.train --model yolo7's main as
            shipped (640², B=16, M=100, bf16, device augmentation, mosaic,
            synthetic data) for 8 steps, 2 epochs, as seg_trainer: losses,
            images/s over steps 4-7, the step's events and kernel times,
            peak memory.
31. yolo7_predict  the predict CLI on the serve images with the trained
            weights sharpened (conf 0.5, K = 4096: the scan, nms_keep's
            count 0): drawn files; ms an image by stage, the scan (synced
            at both edges) inside the device's.
32. yolo7_serve  16 requests through make_server (B=8, the scan), as
            serve: statuses, detections, nms_keep's count 0, /stats.
33. yolo7_evaluate  the evaluate CLI --model yolo7 on a VOC root written
            here (65 640x480 JPEGs; B=32, conf 0.001: the scan): VOC mAP
            and its COCO cross-summary, images/s, then the stage split of
            _recorded_evaluate and every batch's scan against the CPU's.
34. yolo7_eval_map  trainer.evaluate_map on the yolo7 run with the
            sharpened weights as its EMA (16 images, B=16, the scan).
35. yolo7_int8  int8_parity's check for yolo7 (card accumulators bit-equal
            to the plain route's for every quantized conv; RepConv and the
            heads stay float), then yolo7_int8_predict: the predict CLI
            --int8 on yolo7_predict's 5 images (the scan), and the int8
            raw maps against the float ones (cosine >= 0.99).
36. ssd_parity  ssd as shipped (SSD300-VGG16-BN, nc 21, 300), seed-0
            weights: the f32 forward (B=2) on the card against the CPU, loc
            and conf each within SSD_FWD_REL of its largest value; from the
            CPU's outputs and 100 GT rows an image, the targets (cls and pos
            bit-equal, loc within 1e-5) and the loss (num_pos equal, terms
            within 1e-5 relative), card against CPU. The later phases
            sharpen the conf heads by CLS_GAIN (every score 0 or 1).
37. ssd_decode  decode_ssd on 8 serve images at 300 (K = 1,024): nms_keep
            launched once, its detections equal to the plain route's on the
            card and the CPU's; the SSD class-offset cases (B = 1, 8, 32).
38. ssd_trainer  python -m tpucv_torch.train --model ssd's main as shipped
            (300², B=16, M=100, bf16, device augmentation, mosaic, synthetic
            data) for 8 steps, as seg_trainer.
39. ssd_predict  the predict CLI on the serve images with the trained
            weights sharpened (conf 0.7, K = 1,024: nms_keep, one launch an
            image), equal to the plain route; ms an image by stage.
40. ssd_serve  16 requests through make_server (B=8, nms_keep), as serve,
            then ssd_serve_vs_plain as serve's check: keep masks of every
            served batch kernel against plain, detections equal.
41. ssd_evaluate  the evaluate CLI --model ssd on a VOC root written here
            (65 JPEGs; B=32, conf 0.001, K = 1,024: nms_keep once a batch),
            the stage split, every batch's NMS against the CPU's, and
            nms_keep at B=32, K=1,024 timed against its plain version and
            its bound.
42. ssd_eval_map  trainer.evaluate_map on the ssd run with the sharpened
            weights as its EMA (16 images, B=16, nms_keep), equal to the
            plain route.
43. ssd_int8  int8_parity's check for ssd (14 quantized convs, card
            accumulators bit-equal to the plain route's), then
            ssd_int8_predict: the predict CLI --int8 on ssd_predict's 5
            images, and the int8 outputs against the float ones (cosine
            >= INT8_COS_MIN_SSD).
44. centernet_parity  centernet as shipped (CenterNet-DLA34, nc 20, 384,
            head 256), seed-0 weights: the f32 forward (B=2) on the card
            against the CPU, the heatmap, offset and size channels each
            within CENTERNET_FWD_REL of its largest value; its work an
            image counted by hooks (GFLOPs, conv outputs; the transposed
            convs apart); from the CPU's outputs and 30 GT rows an image,
            the targets (ind, mask, wh, reg equal, heatmap within 1e-6)
            and the loss terms (within 1e-5 relative), card against CPU;
            the bf16 channels_last forward at B=16 and the six DepthwiseUp
            transposed convs' share of it. The later phases sharpen the
            heatmap head (heatmap.2) by CLS_GAIN (every score 0 or 1).
45. centernet_decode  decode_centernet on 8 serve images at 384 (K =
            100, the DIoU scan, nms_keep's count 0): valid, classes,
            scores and the scan's keep indices equal to the CPU's decode
            of the card's maps, boxes within 1e-3 px; the decode's and the
            scan's ms, synced.
46. centernet_trainer  python -m tpucv_torch.train --model centernet's
            main as shipped (384², B=16, M=30, bf16, device augmentation,
            mosaic, synthetic data) for 8 steps, as seg_trainer.
47. centernet_predict  the predict CLI on the serve images with the
            trained weights sharpened (conf 0.1, K = 100: the DIoU scan,
            nms_keep's count 0); ms an image by stage, the scan inside the
            device's.
48. centernet_serve  16 requests through make_server (B=8, the scan), as
            serve, then centernet_serve_vs_direct: the served detections
            equal to _batched_detections' on the same images.
49. centernet_evaluate  the evaluate CLI --model centernet on a VOC root
            written here (65 JPEGs; B=32, conf 0.001, K = 100: the scan),
            the stage split with the scan's share, every batch's scan and
            decode against the CPU's from the same maps.
50. centernet_eval_map  trainer.evaluate_map on the centernet run with
            the sharpened weights as its EMA (16 images, B=16, the scan).
51. centernet_int8  int8_parity's check for centernet (53 quantized
            convs, card accumulators bit-equal to the plain route's), then
            centernet_int8_predict: the predict CLI --int8 on
            centernet_predict's 5 images, and the int8 outputs against
            the float ones (cosine >= INT8_COS_MIN_CENTERNET).
52. deeplab_parity  deeplabv3plus as shipped (DeepLabV3+-ResNet101, OS
            16, nc 21, 513², focal loss), seed-0 weights: the f32 forward
            (B=2) on the card against the CPU, the logits within
            DEEPLAB_FWD_REL of their largest value; its conv GFLOPs an
            image (hooks); the focal loss (a tenth of the labels 255)
            within 1e-5 relative and the confusion matrix equal, card
            against CPU; the bf16 forward at B=16 and ASPP's three dilated
            3x3 convs alone (cuDNN) against their bound and undilated.
53. deeplab_trainer  python -m tpucv_torch.train --model deeplabv3plus's
            main as shipped (513², B=16, bf16, synthetic data: 2 batches an
            epoch) for 8 steps, 4 epochs, as seg_trainer (saves at epochs
            1 and 3); then deeplab_step: probes/train_step.py's measure at
            B=16 (step and kernel ms, the host's ms from an idle device,
            launches): device- or host-bound.
54. deeplab_predict  the predict CLI on the serve images with the final
            weights (no NMS: nms_keep's count 0): class maps and overlays;
            ms an image by stage (decode, resize, device, colour + blend +
            write).
55. deeplab_evaluate  the evaluate CLI on a VOC segmentation root
            written here (65 JPEGs, colour PNGs with 255 boundaries; B=32):
            mIoU, images/s of the CLI and its loop, the card's histogram
            equal to the CPU's over the recorded class maps, every pixel
            counted or ignored; then the CLI with --int8.
56. deeplab_eval  the trainer's evaluate_loop: val_mIoU and val_acc.
57. deeplab_int8  quantize_variables on 8 images: 111 convs, card
            accumulators bit-equal to the plain route's (5 dilated), the
            int8 logits within DEEPLAB_INT8_REL of the float ones, cosine
            and class agreement; the predict CLI --int8 on 5 images.
58. deeplab_bench  python -m tpucv_torch.bench --model deeplabv3plus's line
            (inference B=32, training B=16).
59. cls_parity  vit_cls (ViT-S/16) and yolo8_cls (YOLOv8n-cls) as shipped
            (224², nc 10), seed-0 weights: the f32 logits (B=2) card
            against CPU within CLS_FWD_REL of their largest value, the
            label-smoothed loss within 1e-5 relative, FLOPs an image
            (torch.utils.flop_counter), the bf16 forward at B=64.
60. vit_trainer / yolo8_cls_trainer  python -m tpucv_torch.train's main as
            shipped (224², B=16, bf16, synthetic data: 4 batches an epoch)
            for 8 steps, as seg_trainer: loss and acc, val_acc.
61. cls_step  probes/train_step.py's measure for both at B=16: step and
            kernel ms, the host's ms from an idle device, launches.
62. cls_trained / cls_predict  each final checkpoint trained on for 48
            steps at a constant Adam 1e-4 (the shipped warmup keeps the
            rate near 1e-6, and an all-but-untrained model ranks near-ties);
            the predict CLI on the serve images with it (bf16): top-k
            labels; the same CLI in f32 on the card and the CPU:
            probabilities within CLS_PROB_ATOL, the printed top-3 equal on
            every image whose ranking cannot reorder; --int8 refused; ms an
            image by stage (decode, resize, device, top-k).
63. cls_evaluate  the evaluate CLI on a folder-per-class root written here
            (80 224² JPEGs, 10 classes; B=64): top-1 / top-5, images/s of
            the CLI and its loop; in f32 card against CPU, every
            probability within CLS_PROB_ATOL and each image's hits equal
            where its ranking is clear of ties; --int8 refused.
64. cls_eval  each trainer's evaluate_loop: val_loss and val_acc.
65. export  YOLOv8n's serving program (bench.inference_program, B=8 serve
            images at 640, bf16, K = 512: nms_keep) through
            deploy.export_serialized -> load_serialized, here and in a
            fresh process that imports tpucv_torch.ops alone, bit-equal to
            eager; deploy.aot_compile of the f32 program (inductor) within
            EXPORT_BOX_PX / EXPORT_SCORE_TOL of eager f32 with the same
            valid set and classes, another batch refused; nms_keep once a
            call through each form; ms a batch of each beside eager, and
            of the f32 pair the device's ms with the host ahead; the int8
            model's exported served forward (bf16 autocast: raw maps) and
            every quantized conv's int32 accumulators bit-equal to the
            eager card route.
66. ddp     world size 1 over NCCL through yolo8_det's trainer (3 steps,
            with and without ZeRO) bit-equal to the trainer without a
            process group; two ranks spawned over gloo on the card for
            DDP_FAMILIES (global batch DDP_BATCH, f32, 3 steps, with and
            without ZeRO) within the DDP_* bounds of one process's steps;
            the ZeRO run's checkpoint resumed in one process bit-equal;
            step ms of the two ranks against one process.
67. bench_scale  python -m tpucv_torch.bench --scale s|m|l|x's lines
            (nms_keep 21 times each), then nms_keep at B = 64, 32, 16,
            K = 512 against its plain version and bound (kernel_time).
68. yolo7x_* / ssd512_*  the shipped YOLOv7-x (640) and SSD512: f32
            parity card against CPU (B=2, the family's parity phase), one
            B=16 bf16 train step (ms, peak memory), and the bench line
            through bench.bench_family at the family's batches.
69. model_axis  two ranks spawned over gloo on the card as a (1, 2) mesh
            (data 1, model 2): yolo8_det at scale x, full width, 320²,
            global B=2, f32, TF32 off, Adam 1e-3, EMA 0.9999, 2 steps,
            every kernel of 65,536 elements or more sharded over the model
            axis (shard_model); against one process's steps within the
            DDP_* bounds; each rank's parameter bytes against one
            process's; step ms; the checkpoint saved under (1, 2) resumed
            in one process bit-equal to the ranks' whole state (weights,
            EMA, Adam's moments, step).
70. sharded_infer  the same two ranks as a (2, 1) mesh: YOLOv8n's serving
            program (make_infer_fn, 640², f32, TF32 off, the class branch
            sharpened, K <= 1024: nms_keep) on B=8 raw images through
            parallel.mesh.sharded_infer, 4 rows a rank; valid and classes
            equal to one process's, scores and boxes within
            tests/test_parallel.py:362-365's tolerances; nms_keep's count
            zeroed before and read after each call: once a rank a call.
71. spatial  the same two ranks as a (1, 2) mesh, the height split over
            the model axis: tpucv's spatial test net (B=4, 32², flax SAME
            padding) and YOLOv8n's backbone, neck and head in train mode
            (enable_spatial, 640², B=2, f32), the outputs gathered; the
            loss, outputs and gradients (summed over the ranks) against
            one process's: the loss within 1e-5 relative, outputs within
            SPATIAL_REL, the net's gradients within SPATIAL_REL and
            YOLOv8n's within twice the share (of each tensor's largest)
            by which one process's f32 gradients part from its float64
            ones.
72. yolo3_parity  the legacy YOLOv3 (Darknet-53, nc 80, 416²,
            unregistered: Yolo3Config / Yolo3Algorithm), seed-0 weights:
            the f32 forward (B=2) card against CPU within YOLO3_FWD_REL
            of each map's largest value; make_yolov3_targets on the card
            equal to the CPU's (the log-size entries within 1e-6
            relative) and yolov3_loss's terms within 1e-4 relative, on
            the CPU's maps with 100 GT rows an image.
73. yolo3_trainer  Yolo3Trainer as shipped (416², B=16, M=100, bf16,
            device augmentation, mosaic 0.5, synthetic data) for 4 steps
            with evaluate_loop and the saves: finite losses; then the
            B=16 bf16 step on a device-resident batch: ms (CUDA events),
            kernel ms and launches (torch.profiler), peak memory.
74. yolo3_predict / yolo3_evaluate  the trained weights with the
            objectness and class rows sharpened: DetectionAlgorithm.predict
            on the serve images (conf 0.5, K = 4096: the scan) and
            evaluate_on_coco on a COCO root written here (64 JPEGs, a PNG;
            B=32, conf 0.001, K = 4096); nms_keep's count 0 on both.
75. zoo_parity  VGG16-BN, MobileNetV2 (width 1, nc 1000), UNet (nc 21)
            and CPM (18 keypoints, 19 limbs, 6 stages), full width,
            seed-0 weights, f32 (TF32 off), B=2 at 64² (UNet also at
            46², which 16 does not divide): card against CPU in eval and
            train mode, outputs and BN running statistics within ZOO_REL;
            then the twenty blocks of nn/blocks.py at narrow widths the
            same way.
76. zoo_forward  in a fresh process (the profiler misses kernels late
            in this one), each network bf16, channels_last, eval:
            VGG16-BN and MobileNetV2 224² B=64, UNet 512² B=8, CPM 368²
            B=16: ms a batch (CUDA events), kernel ms and launches
            (torch.profiler), peak memory above the weights and input,
            GFLOP an image (FlopCounterMode) and the share of the dense
            bf16 peak.
77. zoo_nms  batched_non_max_suppression on nms_cases.yolo_pred_case
            (B=8, A=8,400, nc=80), card against the CPU's plain route
            (valid, boxes and scores bit-equal, classes where valid): at
            pre_nms_topk 1,024 one nms_keep launch for the batch, class-
            aware and agnostic, the keep mask held against its plain
            version and timed (kernel_time zoo_nms_B8_K1024); at 2,048
            the scan, none; an Ensemble of two YOLOv8n (seeds 0 and 1,
            sharpened) on 8 serve images, A = 16,800, one launch.
78. convert_model  python -m tpucv_torch.convert_model on the trainer
            phase's checkpoint: pure weights equal to the bundle's,
            served by the predict CLI (nms_keep 5 for 5 images); with
            --int8 (16 synthetic images): the quantized conv count, the
            predict and evaluate CLIs loading the file and running its
            int8 convs (COCO root of 65 images, K = 4096: the scan).
79. profile  utils/profile.py: Profile around UNet's bf16 B=8 512²
            forward without and with fence (the unfenced span the
            shorter), .t the sum of the spans; in a fresh process, trace
            around batched_non_max_suppression (B=8, K=1,024, one
            launch): its trace.json names nms_build_kernel and
            nms_walk_kernel.

The line before the last holds {"kernels": [...]} (nms_keep, with its
launches on every path that runs it, the int8, YOLOv7, SSD, CenterNet,
DeepLab, classification and zoo ones included (CenterNet's, the DIoU scan,
and DeepLab's and the classifiers', no NMS, all 0), nms_scan (its time
at YOLOv7's shape beside the plain scan's; the phases at K = 4,096 and
CenterNet's count its launches, one a call), add_one, conv3x3);
the last line is
{"ok": true, "device": {...}}. The whole output is also written to
chiprun_out/chip_smoke.log. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # non-tensor f32, H100 SXM data sheet
IOU_OPS = 14       # min, max, sub, clamp per axis (8), mul, add, sub, add,
AREA_OPS = 5       # div, compare; area: two sub, two clamp, one mul
CLS_GAIN = 3000.0  # the init's class logits are ~1e-4: scores would all
                   # round to 0.5 in bf16; scaled up they spread
YOLO7_GAIN = 1e6   # YOLOv7-l's init head logits are ~1e-5 (its activations
                   # shrink through ~100 identity BatchNorms and SiLUs)
YOLO7_FWD_REL = 1e-4   # YOLOv7-l's f32 maps, card against CPU, each channel
                       # group against its largest value
SSD_FWD_REL = 1e-4     # SSD300's f32 loc and conf, card against CPU, each
                       # against its largest value
CENTERNET_FWD_REL = 1e-4   # CenterNet's f32 heatmap, offset and size
                           # channels, card against CPU, each against its
                           # largest value
CENTERNET_QUANTIZED = 53   # every DLA / IDAUp conv + BN but the stem, the
                           # two dead projects included, and 3 head convs
DEEPLAB_FWD_REL = 1e-4     # DeepLabV3+'s f32 logits, card against CPU,
                           # against their largest value
DEEPLAB_QUANTIZED = 111    # every ResNet-101 / ASPP / decoder conv + BN but
                           # the 3-channel stem
DEEPLAB_INT8_REL = 0.15    # tests/test_quant.py's bar for DeepLab's int8
                           # logits against the float ones
CLS_FWD_REL = 1e-4         # ViT-S/16's and YOLOv8n-cls's f32 logits, card
                           # against CPU, against their largest value
CLS_PROB_ATOL = 1e-5       # f32 softmax probabilities, card against CPU
DIOU_SCAN = frozenset({"centernet"})   # families whose NMS is the DIoU
                                       # scan at every K: never nms_keep
ROOT = Path(__file__).resolve().parent
EXPORT_BOX_PX = 1e-3        # aot_compile's f32 program against eager f32
EXPORT_SCORE_TOL = 1e-5     # (inductor fuses f32 arithmetic in another order)
DDP_FAMILIES = ("yolo8_det", "ssd")   # the headline, and SSD300: BN-heavy,
#                                       its loss's normalisers span the batch
DDP_BATCH = 4               # the two-rank runs' global batch (2 a rank)
DDP_STEPS = 3
# Two gloo ranks against one process on the global batch (f32, TF32 off):
# the first step differs only by the order of the sums (measured: loss
# 2.8e-7 relative, BN statistics 1.2e-7); from the second on, Adam moves
# elements whose gradient is rounding noise by up to lr either way, so the
# runs part as f32 parts them (measured after three steps: losses 1.3e-2
# relative, BN statistics 3.8e-2 of each tensor's largest, weights a
# median of 4.4e-5 apart; NVIDIA H100 80GB HBM3, 700.00 W)
DDP_LOSS_REL = (1e-5, 5e-2)  # the first step's loss, the later steps'
DDP_STAT1_ATOL = 1e-6       # BN running statistics after the first step
DDP_STAT_REL = 0.1          # ... after DDP_STEPS, of each tensor's largest
DDP_PARAM_MEDIAN = 2e-4     # median |two ranks - one process| of the weights
SIMOTA_TIE_REL = 1e-6       # slate costs this close (relative) are a tie:
#                             ~9 f32 ulps; the card's log and sigmoid part
#                             from the CPU's by an ulp or two
VARIANT_BATCH = 16          # the variants' shipped training batch
MESH_WORLD = 2              # the mesh phases' gloo ranks on the one card
MODEL_AXIS_SCALE = "x"      # the widest YOLOv8: the most sharded kernels
MODEL_AXIS_SIZE = 320       # its input (full width, a reduced input)
MODEL_AXIS_BATCH = 2
MODEL_AXIS_STEPS = 2
SHARDED_INFER_BATCH = 8
ZOO_REL = 1e-4              # the zoo's f32 outputs and BN statistics,
                            # card against CPU, of each one's largest value
ZOO = {"vgg16_bn": (64, (64, 224)),    # name: f32 parity size, bf16 (B, S)
       "mobilenet_v2": (64, (64, 224)),
       "unet": (46, (8, 512)),          # 46: a size 16 does not divide
       "cpm": (64, (16, 368))}
SPATIAL_SIZE = 640          # YOLOv8n's input under the height split
SPATIAL_REL = 2e-4          # tpucv's spatial bound (tests/test_parallel.py
#                             :326-329), outputs and gradients against one
#                             process, relative and absolute
SPATIAL_GRAD_CEIL = 1e-2    # the most YOLOv8n's spatial gradient bound may
#                             be: twice the largest share by which one
#                             process's f32 gradients part from float64
#                             (4.8e-3, on the CPU)
YOLO3_FWD_REL = 1e-4        # YOLOv3's f32 maps, card against CPU, of each
#                             map's largest value
YOLO3_GAIN = 20.0           # YOLOv3's objectness and class logits scaled
#                             so that scores spread past conf 0.5
AUG_PIXEL_TOL = 1e-5   # augment_batch, card against CPU, f32 values in [0, 1]
TRAIN_STEPS = 40       # 10 epochs of the synthetic set's 4 batches of 16
STEADY_FROM = 8        # the trainer's window: steps 8-39 (epochs 2-9)
# the evaluate loop's stages a batch, as _recorded_evaluate splits them
INT8_MATCH_MIN = 0.5   # int8 serve / predict: float detections matched
INT8_COS_MIN = 0.999   # int8 raw maps against float: tpucv's cosine bar
INT8_CLASS_AGREE_MIN = 0.95   # and the best class at the live anchors
INT8_COS_MIN_SSD = 0.99       # SSD300: 14 quantized VGG convs
INT8_COS_MIN_CENTERNET = 0.99  # CenterNet-DLA34: 53 quantized convs
INT8_COS_MIN_YOLO7 = 0.99     # YOLOv7-l: 85 quantized convs in a chain
                              # (tpucv's own YOLOv7 bar is a max relative
                              # error under 0.1; its seed-0 maps at 640 on
                              # the CPU: 0.066-0.099, cosine 0.9958-0.9970)
LOOP_STAGES = ("fill_canvases", "h2d_letterbox_forward_topk", "scan",
               "d2h_records")


def nms_on_kernel(name: str, K: int) -> bool:
    """Whether a family's NMS at K candidates runs through nms_keep."""
    return name not in DIOU_SCAN and K <= 1024


T0 = time.perf_counter()    # the script's start, for the phases' "t_s"


def emit(obj) -> None:
    """One JSON line; a phase's carries ``t_s``, the seconds since the
    script started, when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


class Tee:
    """Standard output, copied line for line into a log file."""

    def __init__(self, stream, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.stream, self.log = stream, open(path, "w")

    def write(self, text):
        self.log.write(text)
        return self.stream.write(text)

    def flush(self):
        self.log.flush()
        self.stream.flush()


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Recorder:
    """Takes the trainer's TensorBoard slot: keeps each logged scalar."""

    def __init__(self):
        self.rows = {}

    def add_scalar(self, key, value, step):
        self.rows.setdefault(key, {})[step] = float(value)


class TimedLoader:
    """A loader that records, for each batch, the host time spent in
    ``next()`` and the moment the batch was handed over."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []
        self.handed = []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                self.waits.append(t1 - t0)
                self.handed.append(t1)
                yield batch
        finally:
            it.close()


def sharpen_(model) -> None:
    """Zero the class branch's biases and scale its last kernels by
    CLS_GAIN, in place, so scores spread and the NMS has work."""
    import torch

    with torch.no_grad():
        for head in model.model[22].cv3:
            head[-1].bias.zero_()
            head[-1].weight.mul_(CLS_GAIN)


def sharpen_yolo7_(model) -> None:
    """Zero the objectness and class rows' biases of YOLOv7's three head
    convs and scale their kernels by YOLO7_GAIN, in place: scores go to 0
    or 1 and the NMS has work."""
    import torch

    with torch.no_grad():
        for i in (3, 4, 5):
            head = getattr(model, f"yolo_head_P{i}")
            per_anchor = 5 + model.nc
            head.weight.view(model.na, per_anchor, -1)[:, 4:] *= YOLO7_GAIN
            head.bias.view(model.na, per_anchor)[:, 4:] = 0.0


def sharpen_ssd_(model) -> None:
    """Zero SSD's conf heads' biases and scale their kernels by CLS_GAIN, in
    place: each prior's softmax goes to 1 on one class (the background
    included) and 0 on the rest, so every score is 0 or 1."""
    import torch

    with torch.no_grad():
        for conf in model.confs:
            conf.bias.zero_()
            conf.weight.mul_(CLS_GAIN)


def sharpen_centernet_(model) -> None:
    """Zero the bias of CenterNet's heatmap 1x1 conv (``heatmap.2``) and
    scale its kernel by CLS_GAIN, in place: every score goes to 0 or 1, and
    the top K, its ties, take the lowest flat indices."""
    import torch

    with torch.no_grad():
        conv = model.backbone.heatmap[2]
        conv.bias.zero_()
        conv.weight.mul_(CLS_GAIN)


def yolo7_int8_outputs(algo, f_maps, q_maps):
    """YOLOv7's float and int8 raw maps by level, and each anchor's class
    scores (objectness x class, after the sigmoid), for
    phase_family_int8_predict."""
    na, no = algo.anchors.shape[1], 5 + algo.nc
    groups, scores = {}, []
    for i, (f, q) in enumerate(zip(f_maps, q_maps)):
        groups[f"P{i + 3}"] = (f, q)
        fs, qs = (t.float().reshape(*t.shape[:3], na, no).sigmoid()
                  for t in (f, q))
        scores.append((fs[..., 4:5] * fs[..., 5:], qs[..., 4:5] * qs[..., 5:]))
    return groups, scores


def simota_ties(cpu, card):
    """Where two devices' simOTA assignments (``simota_assign``: matched,
    GT row, slate costs, slate anchors) part. For each GT whose anchors
    differ: the anchors one device alone gives it, and their slate costs
    on the CPU. It is a tie when there are two or more and their costs lie
    within SIMOTA_TIE_REL of each other; any other difference is listed
    under ``not_ties``."""
    (m0, g0, cost, cand), (m1, g1) = cpu, card[:2]
    differ = (m0 != m1) | (m0 & (g0 != g1))
    ties, not_ties = [], []
    for b in range(cost.shape[0]):
        gts = (set(g0[b][differ[b] & m0[b]].tolist())
               | set(g1[b][differ[b] & m1[b]].tolist()))
        for m in sorted(gts):
            moved = sorted(
                set((m0[b] & (g0[b] == m)).nonzero().flatten().tolist())
                ^ set((m1[b] & (g1[b] == m)).nonzero().flatten().tolist()))
            costs = [float(cost[b, m][cand[b, m] == a].min()) for a in moved]
            tie = (len(moved) >= 2 and max(costs) - min(costs)
                   <= SIMOTA_TIE_REL * max(abs(c) for c in costs))
            (ties if tie else not_ties).append(
                {"image": b, "gt": m, "anchors": moved, "cpu_costs": costs})
    return {"differing_anchors": int(differ.sum()), "ties": ties,
            "not_ties": not_ties}


def ssd_int8_outputs(algo, f_out, q_out):
    """SSD's float and int8 loc and conf apart, and each prior's class
    scores (the softmax, the background dropped), for
    phase_family_int8_predict."""
    groups = dict(zip(("loc", "conf"), zip(f_out, q_out)))
    return groups, [tuple(t[1].float().softmax(-1)[..., 1:]
                          for t in (f_out, q_out))]


def centernet_int8_outputs(algo, f_out, q_out):
    """CenterNet's float and int8 heatmap logits, offsets and sizes apart,
    and each cell's class scores (the heatmap's sigmoid), for
    phase_family_int8_predict."""
    C = algo.nc
    groups = {k: (f_out[..., sl], q_out[..., sl]) for k, sl in (
        ("hm", slice(0, C)), ("reg", slice(C, C + 2)),
        ("wh", slice(C + 2, C + 4)))}
    return groups, [tuple(t[..., :C].float().sigmoid()
                          for t in (f_out, q_out))]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class StageRecorder:
    """Records (label, start, end) on the host clock around callables,
    the device synchronised before each end: ``wrap`` puts the recording
    in place of a module's or a class's attribute until ``restore``,
    ``wrapped`` returns a recording copy of one callable."""

    def __init__(self, sync):
        self.sync = sync
        self.events = []
        self._undo = []

    def wrapped(self, fn, label):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.sync()
            self.events.append((label, t0, time.perf_counter()))
            return out
        return run

    def wrap(self, owner, name, label):
        own = name in vars(owner)
        fn = getattr(owner, name)
        self._undo.append((owner, name, fn if own else None))
        setattr(owner, name, self.wrapped(fn, label))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        self._undo.clear()


def flat_outputs(out):
    """The tensors of a head's output, nested tuples flattened in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def family_dataset(name, cfg, n, seed):
    """The synthetic set a seg or pose trainer falls back to, ``n`` images
    at the config's size, and its collate."""
    from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex
    from tpucv_torch.data.instance_seg_dataset import (InstanceSegDataset,
                                                       instance_seg_collate)
    from tpucv_torch.data.pose_dataset import (PoseDataset,
                                               SyntheticPoseIndex,
                                               pose_collate)

    s, m = cfg.dataset.input_size, cfg.dataset.max_num_boxes
    if name == "yolo8_seg":
        return {"ds": InstanceSegDataset(SyntheticDetectionIndex(
            n, s, cfg.num_classes, seed=seed), s, m),
            "collate": instance_seg_collate}
    nk = cfg.arch.kpt_shape[0]
    return {"ds": PoseDataset(SyntheticPoseIndex(n, s, nk, seed=seed), s, m,
                              nk=nk), "collate": pose_collate}


def write_coco_root(root: Path, n: int) -> int:
    """A COCO-layout root (``val2017/``, ``annotations/instances_val2017
    .json``): ``n`` 640x480 JPEGs and one PNG cut from
    SyntheticDetectionIndex's 640x640 images, their boxes as GTs, the first
    one a crowd GT, each box also its 4-point ``segmentation`` (read only
    by an index with ``keep_polys``). Returns the image count."""
    import cv2

    from tpucv_torch.configs.dataset_cfg import COCO80_TO_COCO91, COCO_CLASSES
    from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex

    src = SyntheticDetectionIndex(n + 1, 640, 80, seed=2)
    (root / "val2017").mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(n + 1):
        img, boxes, labels = src[i]
        name = f"{i + 1:012d}{'.png' if i == n else '.jpg'}"
        check(cv2.imwrite(str(root / "val2017" / name),
                          cv2.cvtColor(img[:480], cv2.COLOR_RGB2BGR)),
              f"could not write {name}")
        images.append({"id": i + 1, "file_name": name, "height": 480,
                       "width": 640})
        for b, lab in zip(boxes.tolist(), labels.tolist()):
            x1, y1, x2, y2 = b[0], b[1], b[2], min(b[3], 480.0)
            if y2 - y1 < 2:
                continue
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": COCO80_TO_COCO91[lab],
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1),
                         "iscrowd": int(not anns),
                         "segmentation": [[x1, y1, x2, y1, x2, y2, x1, y2]]})
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": COCO_CLASSES[k]}
            for k, c in enumerate(COCO80_TO_COCO91)]}, f)
    return n + 1


def write_voc_root(root: Path, n: int) -> int:
    """A VOC devkit (``JPEGImages/``, ``Annotations/``,
    ``ImageSets/Main/val.txt``): ``n`` 640x480 JPEGs cut from
    SyntheticDetectionIndex's 640x640 images (20 classes), their boxes as
    objects, every fifth one ``difficult``. Returns the image count."""
    import xml.etree.ElementTree as ET

    import cv2

    from tpucv_torch.configs.dataset_cfg import VOC_CLASSES
    from tpucv_torch.data.detection_dataset import SyntheticDetectionIndex

    src = SyntheticDetectionIndex(n, 640, 20, seed=5)
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ids, k = [], 0
    for i in range(n):
        img, boxes, labels = src[i]
        img_id = f"{i:06d}"
        ids.append(img_id)
        check(cv2.imwrite(str(root / "JPEGImages" / f"{img_id}.jpg"),
                          cv2.cvtColor(img[:480], cv2.COLOR_RGB2BGR)),
              f"could not write {img_id}.jpg")
        ann = ET.Element("annotation")
        for b, lab in zip(boxes.tolist(), labels.tolist()):
            y2 = min(b[3], 479.0)
            if y2 - b[1] < 2:
                continue
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = VOC_CLASSES[lab]
            ET.SubElement(obj, "difficult").text = str(int(k % 5 == 4))
            k += 1
            bb = ET.SubElement(obj, "bndbox")
            for key, v in zip(("xmin", "ymin", "xmax", "ymax"),
                              (b[0], b[1], b[2], y2)):
                ET.SubElement(bb, key).text = str(v)
        ET.ElementTree(ann).write(root / "Annotations" / f"{img_id}.xml")
    (root / "ImageSets" / "Main" / "val.txt").write_text(
        "\n".join(ids) + "\n")
    return n


def write_voc_seg_root(root: Path, n: int):
    """A VOC segmentation root (``JPEGImages/``, ``SegmentationClass/``,
    ``ImageSets/Segmentation/val.txt``): ``n`` 640x480 JPEGs cut from
    SyntheticSegIndex's 640x640 images (21 classes), their masks as colour
    PNGs in VOC's palette with each object's edge drawn in VOC's boundary
    colour (224, 224, 192), which reads as 255, ignored. Returns (the image
    count, the boundary pixels written)."""
    import cv2

    from tpucv_torch.data.segmentation_dataset import (VOC_COLORMAP,
                                                       SyntheticSegIndex)

    src = SyntheticSegIndex(n, 640, 21, seed=5)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (root / d).mkdir(parents=True, exist_ok=True)
    palette = np.asarray(VOC_COLORMAP, np.uint8)
    ids, edges = [], 0
    for i in range(n):
        img, mask = src[i]
        img, mask = img[:480], mask[:480]
        img_id = f"{i:06d}"
        ids.append(img_id)
        rgb = palette[mask]
        edge = np.zeros(mask.shape, bool)
        edge[1:] |= mask[1:] != mask[:-1]
        edge[:, 1:] |= mask[:, 1:] != mask[:, :-1]
        rgb[edge] = (224, 224, 192)
        edges += int(edge.sum())
        check(cv2.imwrite(str(root / "JPEGImages" / f"{img_id}.jpg"),
                          cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
              and cv2.imwrite(str(root / "SegmentationClass" /
                                  f"{img_id}.png"),
                              cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)),
              f"could not write {img_id}")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(
        "\n".join(ids) + "\n")
    return n, edges


# the trainer phases' families: the arch field, input size and M as
# shipped, the terms each logs, the term evaluate_loop must report, the
# phase's name and how the run's final weights are sharpened for predict
# and evaluate
TRAINED = {
    "yolo8_seg": dict(arch=("model_type", "n"), size=640, M=48,
                      terms=("loss", "box_loss", "cls_loss", "dfl_loss",
                             "mask_loss"), val="val_mask_loss",
                      phase="seg_trainer", sharpen=sharpen_,
                      desc="YOLOv8n, 640, B=16, M=48, bf16, no device "
                           "augmentation, synthetic data"),
    "yolo8_pose": dict(arch=("model_type", "n"), size=640, M=32,
                       terms=("loss", "box_loss", "cls_loss", "dfl_loss",
                              "kpt_loss", "kobj_loss"), val="val_kpt_loss",
                       phase="pose_trainer", sharpen=sharpen_,
                       desc="YOLOv8n, 640, B=16, M=32, bf16, no device "
                            "augmentation, synthetic data"),
    "yolo7": dict(arch=("phi", "l"), size=640, M=100,
                  terms=("loss", "box_loss", "obj_loss", "cls_loss"),
                  val="val_obj_loss", phase="yolo7_trainer",
                  sharpen=sharpen_yolo7_,
                  desc="YOLOv7-l, nc 20, 640, B=16, M=100, bf16, device "
                       "augmentation, mosaic 0.5, synthetic data"),
    "ssd": dict(arch=("backbone", "vgg16"), size=300, M=100,
                terms=("loss", "loc_loss", "conf_loss", "num_pos"),
                val="val_conf_loss", phase="ssd_trainer",
                sharpen=sharpen_ssd_,
                desc="SSD300-VGG16-BN, nc 21, 300, B=16, M=100, bf16, "
                     "device augmentation, mosaic 0.5, synthetic data"),
    "centernet": dict(arch=("backbone", "dla34"), size=384, M=30,
                      terms=("loss", "hm_loss", "wh_loss", "off_loss"),
                      val="val_hm_loss", phase="centernet_trainer",
                      sharpen=sharpen_centernet_,
                      desc="CenterNet-DLA34, nc 20, 384, B=16, M=30, bf16, "
                           "device augmentation, mosaic 0.5, synthetic "
                           "data"),
    "deeplabv3plus": dict(arch=("backbone", "resnet101"), size=513, M=0,
                          terms=("loss", "focal_loss"), val="val_mIoU",
                          phase="deeplab_trainer", sharpen=None,
                          desc="DeepLabV3+-ResNet101, OS 16, nc 21, 513² "
                               "crops, B=16, bf16, focal loss, host scale "
                               "jitter / crop / flip, synthetic data (32 "
                               "images: 2 batches an epoch)"),
    "vit_cls": dict(arch=("dim", 384), size=224, M=0, terms=("loss", "acc"),
                    val="val_acc", phase="vit_trainer", sharpen=None,
                    desc="ViT-S/16 (dim 384, depth 12, heads 6), nc 10, "
                         "224², B=16, bf16, label smoothing 0.1, host crop "
                         "and flip, synthetic data (64 images)"),
    "yolo8_cls": dict(arch=("model_type", "n"), size=224, M=0,
                      terms=("loss", "acc"), val="val_acc",
                      phase="yolo8_cls_trainer", sharpen=None,
                      desc="YOLOv8n-cls (layers 0-8, Classify 1280), nc 10, "
                           "224², B=16, bf16, label smoothing 0.1, host "
                           "crop and flip, synthetic data (64 images)"),
}
CLASSIFIERS = ("vit_cls", "yolo8_cls")


# ---------------------------------------------------------------- phases --

class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.mismatches = 0
        self.word_mismatches = 0
        self.max_abs_err = 0.0
        self.shapes = []          # kernel timings at the main path's shapes

    def sync(self):
        self.torch.cuda.synchronize()

    def compare_keep(self, sb, ss, thr, tag):
        """Kernels vs plain keep mask on the same CUDA tensors; the build's
        words bit for bit against their plain twin, and the walk alone over
        them."""
        from tpucv_torch.ops.cuda_nms import (nms_keep, nms_keep_reference,
                                              overlap_words,
                                              overlap_words_reference,
                                              walk_words)

        torch = self.torch
        keep = nms_keep(sb, ss, thr)
        self.sync()
        ref = nms_keep_reference(sb, ss, thr)
        words = overlap_words(sb, thr)
        self.sync()
        bad_words = int((words != overlap_words_reference(sb, thr)).sum())
        self.word_mismatches += bad_words
        check(bad_words == 0, f"{tag}: the build's mask and its plain twin "
                              f"differ in {bad_words} words")
        walked = walk_words(words, ss)
        self.sync()
        check(torch.equal(walked, ref), f"{tag}: the walk alone differs from "
                                        f"the plain keep mask")
        bad = int((keep != ref).sum())
        err = float((keep.float() - ref.float()).abs().max()) \
            if keep.numel() else 0.0
        self.mismatches += bad
        self.max_abs_err = max(self.max_abs_err, err)
        check(bad == 0, f"{tag}: kernel and plain keep masks differ in "
                        f"{bad} places")
        return keep

    def phase_kernel(self):
        from tpucv_torch.ops.nms_cases import chain_keep, kernel_cases

        torch = self.torch
        rows = {}
        for name, ((boxes, scores), thr) in kernel_cases().items():
            order = np.argsort(-scores, axis=-1, kind="stable")
            sb = torch.from_numpy(np.take_along_axis(
                boxes, order[..., None], 1)).to(self.dev)
            ss = torch.from_numpy(np.take_along_axis(scores, order, 1)) \
                .to(self.dev)
            keep = self.compare_keep(sb, ss, thr, name)
            if name.startswith("chain"):
                got = torch.nonzero(keep[0]).flatten().tolist()
                check(got == chain_keep(name),
                      f"{name}: greedy keeps every second box, got {got}")
            rows[name] = int(keep.sum())
        emit({"phase": "kernel", "cases": len(rows), "kept": rows,
              "mismatches": self.mismatches,
              "word_mismatches": self.word_mismatches,
              "max_abs_err": self.max_abs_err})

    def serving_setup(self):
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        check(cfg.arch.model_type == "n" and cfg.dataset.input_size == 640
              and cfg.num_classes == 80 and cfg.train.mixed_precision,
              "yolo8_det config is not YOLOv8n/640/nc80/bf16")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables(seed=0)
        sharpen_(model)
        return algo, model

    def phase_forward_f32(self, model):
        """The f32 forward on the card (TF32 off) against the same weights
        on the CPU, on a small input."""
        import copy

        torch = self.torch
        x = torch.from_numpy(np.random.default_rng(3).random(
            (2, 128, 128, 3), dtype=np.float32))
        with torch.inference_mode():
            gpu = model(x.to(self.dev))
            cpu = copy.deepcopy(model).cpu().to(
                memory_format=torch.contiguous_format)(x)
        rel = max(float((g.float().cpu() - c).abs().max() / c.abs().max())
                  for g, c in zip(gpu, cpu))
        check(all(torch.isfinite(g).all() for g in gpu), "non-finite maps")
        check(rel < 1e-3, f"f32 forward on the card differs from the CPU by "
                          f"{rel} of the largest value")
        emit({"phase": "forward_f32", "shapes": [list(g.shape) for g in gpu],
              "max_rel_err_vs_cpu": rel})

    def _images(self, n):
        rng = np.random.default_rng(0)
        sizes = [(480, 640), (427, 640), (300, 500)]
        imgs = []
        for k in range(n):
            h, w = sizes[k % len(sizes)]
            yy, xx = np.mgrid[0:h, 0:w]
            base = np.stack([xx * 255 // w, yy * 255 // h,
                             (xx + yy) * 255 // (h + w)], -1)
            noise = rng.integers(-40, 41, (h, w, 3))
            imgs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        return imgs

    def phase_serve(self, algo, model, model_name="yolo8_det",
                    phase="serve", scan=False):
        """16 concurrent raw-RGB requests through make_server (batch 8);
        nms_keep's and nms_scan's counts zeroed just before, read just
        after: nms_keep launches on a path with K <= 1024, none where
        ``scan`` (K = 4096, or CenterNet's DIoU), and there one nms_scan
        launch a served batch."""
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan
        from tpucv_torch.serving import make_server

        imgs = self._images(16)
        t0 = time.perf_counter()
        server = make_server(algo, model, host="127.0.0.1", port=0,
                             batch_size=8, model_name=model_name)
        warm_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        results = [None] * len(imgs)
        try:
            port = server.server_address[1]

            def post(k):
                h, w = imgs[k].shape[:2]
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict",
                    data=imgs[k].tobytes(),
                    headers={"Content-Type": "application/x-raw-rgb",
                             "X-Height": str(h), "X-Width": str(w)})
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        results[k] = (r.status, json.loads(r.read()))
                except Exception as e:  # noqa: BLE001 - reported below
                    results[k] = (getattr(e, "code", -1), str(e))

            posters = [threading.Thread(target=post, args=(k,))
                       for k in range(len(imgs))]
            nms_keep.launches = 0            # just before the main path
            nms_scan.launches = 0
            t0 = time.perf_counter()
            for p in posters:
                p.start()
            for p in posters:
                p.join(timeout=600)
            wall = time.perf_counter() - t0
            launches = nms_keep.launches     # just after
            scan_launches = nms_scan.launches
            check(not any(p.is_alive() for p in posters), "requests hung")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                        timeout=60) as r:
                stats = json.loads(r.read())
        finally:
            server.shutdown()
            server.batcher.stop()
            server.server_close()
            thread.join(timeout=30)
        statuses = [r[0] for r in results]
        check(all(s == 200 for s in statuses), f"statuses {statuses}: "
              f"{[r[1] for r in results if r[0] != 200][:2]}")
        n_dets = [len(r[1]["detections"]) for r in results]
        check(max(n_dets) > 0, "no request got a detection")
        check(launches == 0 if scan else launches > 0,
              f"{phase}: nms_keep launched {launches} times while serving")
        check(scan_launches == (stats["batches"] if scan else 0),
              f"{phase}: nms_scan launched {scan_launches} times for "
              f"{stats['batches']} batches")
        emit({"phase": phase, "requests": len(imgs), "statuses_ok": True,
              "detections": n_dets, "nms_launches": launches,
              "nms_scan_launches": scan_launches,
              "warmup_s": warm_s, "wall_s": wall, "stats": stats})
        return imgs, results, launches

    def phase_serve_vs_plain(self, algo, model, imgs, results,
                             phase="serve_vs_plain"):
        """The served images again through ``_batched_detections`` (B=8,
        conf 0.25, as the server calls it), twice: with every nms_keep call
        recorded, each batch's candidates then held kernel against plain
        (``compare_keep``: keep masks and mask words); and with nms_keep's
        plain version in its place: every image's boxes, scores and classes
        equal to the kernel route's, and its classes equal to the server's.
        Returns the first batch's candidates and its IoU threshold."""
        from tpucv_torch.ops import cuda_nms

        kernel, cands = cuda_nms.nms_keep, []

        def recorded(sb, ss, thr):
            cands.append((sb, ss, thr))
            self._swap_nms_keep(kernel)      # it counts under its own name
            try:
                return kernel(sb, ss, thr)
            finally:
                self._swap_nms_keep(recorded)

        index = [(im,) for im in imgs]
        runs = []
        for fn in (recorded, cuda_nms.nms_keep_reference):
            self._swap_nms_keep(fn)
            try:
                runs.append(list(algo._batched_detections(
                    model, index, 8, 0.25)))
            finally:
                self._swap_nms_keep(kernel)
        check(len(cands) == -(-len(imgs) // 8),
              f"{phase}: {len(cands)} NMS calls for {len(imgs)} images")
        for k, (sb, ss, thr) in enumerate(cands):
            self.compare_keep(sb, ss, thr, f"{phase} batch {k}")
        got, plain = runs
        check(len(got) == len(plain) == len(imgs), f"{phase}: {len(got)} "
                                                   f"images")
        for a, b in zip(got, plain):
            check(a[0] == b[0] and all(
                np.array_equal(x, y) for x, y in zip(a[1:], b[1:])),
                f"{phase} image {a[0]}: detections through nms_keep differ "
                f"from the plain route's")
            served = sorted(d["class_id"]
                            for d in results[a[0]][1]["detections"])
            check(served == sorted(a[3].tolist()),
                  f"{phase} image {a[0]}: served classes {served} != "
                  f"{sorted(a[3].tolist())}")
        valid_cands = [n for _, ss, _ in cands
                       for n in (ss > 0).sum(1).tolist()]
        kept = [len(a[3]) for a in got]
        check(all(v > 0 for v in valid_cands), "no valid candidates")
        check(any(k < v for k, v in zip(kept, valid_cands)),
              "NMS suppressed nothing")
        emit({"phase": phase, "K": cands[0][1].shape[1],
              "valid_candidates": valid_cands, "kept": kept,
              "identical": True})
        return cands[0][:2], cands[0][2]

    def phase_breakdown(self, algo, model, imgs, reps=5):
        """Where a served batch of 8 spends its time, on the host clock with
        a device sync after each stage (median of ``reps``), beside one
        whole ``_batched_detections`` batch without HTTP. The fill and the
        upload are the algorithm's staged batch: ``fill_canvases`` is its
        ``tpucv.detect.fill`` span, ``h2d`` the rest of it to a sync."""
        from tpucv_torch.algorithms.yolov8 import yolo_decode_args
        from tpucv_torch.decode.yolov8 import decode_boxes
        from tpucv_torch.ops.preprocess import (letterbox_images,
                                                normalize_images)
        from tpucv_torch.utils import profile

        torch = self.torch
        kw = yolo_decode_args(algo.cfg, algo.nc, None)
        index = [(im,) for im in imgs[:8]]
        stages = {}

        def lap(name, t0):
            self.sync()
            t1 = time.perf_counter()
            stages.setdefault(name, []).append((t1 - t0) * 1e3)
            return t1

        for _ in range(reps):
            with torch.inference_mode():
                t = time.perf_counter()
                with algo._staged_batch(index, range(8), 8) as (
                        canv, hw, geom, hs, _, _):
                    (fill_ns,) = profile.recent("tpucv.detect.fill", 1)
                    stages.setdefault("fill_canvases", []).append(
                        fill_ns / 1e6)
                    t = lap("h2d", t + fill_ns / 1e9)
                    lb, _, _ = letterbox_images(canv, hw, algo.input_size,
                                                geom=geom, scale=hs)
                    t = lap("letterbox", t)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    raw = model(normalize_images(lb, algo.dtype))
                t = lap("normalize_forward", t)
                out = decode_boxes(raw, **kw)
                t = lap("decode_nms", t)
                [o.cpu().numpy() for o in out]
                lap("d2h", t)
                t = time.perf_counter()
            list(algo._batched_detections(model, index, 8, 0.25))
            lap("direct_batch_total", t)
        med = {k: float(np.median(v)) for k, v in stages.items()}
        emit({"phase": "breakdown", "batch": 8, "reps": reps, "median_ms": med,
              "runs_ms": stages})

    def phase_bench(self, model):
        """The bench entry point's inference program
        (``tpucv_torch.bench.bench_inference``) on the served model; then
        the forward of its first batch again, for the NMS's candidate
        sets at K=512 and 1024."""
        from tpucv_torch import bench
        from tpucv_torch.decode.yolov8 import topk_candidates
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        shapes = bench.FULL
        nms_keep.launches = 0
        res = bench.bench_inference(model, self.dev, shapes)
        nms_launches = nms_keep.launches
        calls = 3 + (1 + shapes.infer_iters) + (1 + shapes.h2d_iters)
        check(nms_launches == calls, "bench skipped NMS")
        out = res.pop("outputs")
        check(all(torch.isfinite(o.float()).all() for o in out),
              "non-finite bench output")
        fwd, _ = bench.inference_program(model, shapes.size, amp=True)
        with torch.inference_mode():
            raw = fwd(bench.raw_batches(shapes, 1)[0].to(self.dev))
            c512 = topk_candidates(raw, pre_nms_topk=512,
                                   conf_threshold=0.25)
            c1024 = topk_candidates(raw, pre_nms_topk=1024,
                                    conf_threshold=0.25)
        emit({"phase": "bench", "batch": shapes.batch,
              "iters": shapes.infer_iters, "nms_launches": nms_launches,
              **res,
              "detections_mean": float(out[3].sum(1).float().mean())})
        offs = [((c[0] + c[2][..., None].float() * 7680.0).contiguous(),
                 c[1]) for c in (c512, c1024)]
        return offs, 0.7

    def phase_train_parity(self):
        """The port's train step on the card against the same step on the
        CPU: YOLOv8n (nc=80) from torch.Generator seed 0, B=2, 128², M=4,
        f32 with TF32 off. GT row 0 is a strip 5 px tall along the top:
        every anchor inside it has CIoU <= 0 with the init's large
        predictions, so its top-10 are zero-metric ties, and lowest-index
        order selects anchors 0-9 (``torch.topk``'s order would not). The
        TAL assignment (fg mask and GT rows) of the first forward must be
        bit-equal, the step's loss and components within 1e-4 relative,
        and after it the BatchNorm statistics within 1e-5 and the
        parameters as the CPU tests bound them: within 2.1 * lr, all but
        0.1% of elements within 1e-5."""
        import copy

        from tpucv_torch import bench
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.losses.yolov8 import yolov8_loss
        from tpucv_torch.train.state import (TrainState, forward,
                                             make_train_step)

        torch = self.torch
        cpu = torch.device("cpu")
        B, S, M, lr = 2, 128, 4, 1e-3
        model = bench.yolo8n(cpu)
        batch = bench.synthetic_batch(B, S, M, cpu, S * 0.9, torch.float32,
                                      seed=1)
        xy = batch["gt_bboxes"][..., :2]
        batch["gt_bboxes"][..., 2:] = xy + (batch["gt_bboxes"][..., 2:] -
                                            xy).abs() + 4.0
        batch["gt_bboxes"][:, 0] = torch.tensor([0.0, 0.0, float(S), 5.0])
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        loss_fn = algo_cls(cfg, device=cpu).build_loss()
        runs = []
        for dev in (cpu, self.dev):
            m = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                raw = forward(copy.deepcopy(m).train(), b["images"], False)
                _, _, aux = yolov8_loss(raw, b["gt_labels"], b["gt_bboxes"],
                                        b["gt_mask"], return_aux=True)
            state = TrainState.create(m, lr, use_ema=True)
            step = make_train_step(loss_fn, device=dev, ema_decay=0.9999,
                                   mixed_precision=False)
            state, sm = step(state, b)
            runs.append({
                "fg": aux["fg"].cpu(), "gt_idx": aux["gt_idx"].cpu(),
                "step": {k: float(v) for k, v in sm.items()},
                "sd": {k: v.detach().cpu().double() for k, v in
                       state.model.state_dict().items()}})
        c, g = runs
        check(torch.equal(c["fg"], g["fg"]), "TAL fg masks differ between "
                                             "the card and the CPU")
        check(torch.equal(c["gt_idx"], g["gt_idx"]),
              "TAL GT rows differ between the card and the CPU")
        check(bool(c["fg"][:, :10].all()),
              "the top strip's zero-metric ties were not anchors 0-9")
        rel = {}
        for k, v in c["step"].items():
            rel[k] = abs(g["step"][k] - v) / max(abs(v), 1e-12)
            check(rel[k] <= 1e-4, f"{k}: card {g['step'][k]} against CPU {v}")
        bn = max(float((g["sd"][k] - c["sd"][k]).abs().max())
                 for k in c["sd"] if "running" in k)
        check(bn <= 1e-5, f"BatchNorm statistics differ by {bn}")
        diffs = torch.cat([(g["sd"][k] - c["sd"][k]).abs().flatten()
                           for k in c["sd"] if "running" not in k
                           and "num_batches" not in k])
        pmax, frac = float(diffs.max()), float((diffs > 1e-5).double().mean())
        check(pmax <= 2.1 * lr and frac <= 1e-3,
              f"parameters differ by up to {pmax}, {frac} of them > 1e-5")
        emit({"phase": "train_parity", "B": B, "S": S, "M": M,
              "fg": int(c["fg"].sum()), "fg_bit_equal": True,
              "gt_idx_bit_equal": True,
              "tie_selected": "anchors 0-9 of each image",
              "loss_cpu": c["step"]["loss"], "loss_card": g["step"]["loss"],
              "max_rel_err": max(rel.values()), "rel_err": rel,
              "bn_max_abs_err": bn, "param_max_abs_err": pmax,
              "param_frac_over_1e-5": frac})

    def phase_train(self):
        """The bench entry point's train step at full width
        (``tpucv_torch.bench.bench_train``): YOLOv8n, B=128, 640², M=32,
        bf16 autocast, channels_last, Adam 1e-3, EMA 0.9999; 3 warm-up
        and 10 timed steps, then one step split into its stages."""
        import dataclasses

        from tpucv_torch import bench

        shapes = dataclasses.replace(bench.FULL, train_iters=10)
        res = bench.bench_train(self.dev, shapes)
        emit({"phase": "train", "batch": shapes.train_batch,
              "size": shapes.size, "max_boxes": shapes.max_boxes,
              "warmup": shapes.train_warmup, "iters": shapes.train_iters,
              **res, "nvidia_smi": nvidia_smi()})
        return res

    # ------------------------------------------------- the trainer (PR 8)
    def _aug_inputs(self, B, S, M, seed=7):
        """A uint8 batch, boxes and the trainer's host-drawn parameters."""
        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (B, S, S, 3), np.uint8)
        xy = rng.random((B, M, 2)) * S * 0.7
        boxes = np.concatenate([xy, xy + rng.random((B, M, 2)) * S * 0.3],
                               -1).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, B).astype(np.float32)
        shift = (rng.random((B, 2)).astype(np.float32)
                 * np.maximum(S * (1.0 - scale), 0.0)[:, None])
        flip = rng.random(B) < 0.5
        hsv = (1.0 + (rng.random((B, 3)) * 2 - 1)
               * np.array([0.1, 0.7, 0.4])).astype(np.float32)
        return images, boxes, (scale, shift.astype(np.float32), flip, hsv)

    def phase_augment(self, B=16, S=640, M=100):
        """augment_batch at the trainer's shape (B=16, 640², M=100) on the
        card against the same call on the CPU, f32: the gather's source
        indices equal, pixels within AUG_PIXEL_TOL, boxes within 1e-5;
        then timed (CUDA events) with the trainer's bf16 output."""
        from tpucv_torch.ops.augment import (AffineParams, augment_batch,
                                             source_indices)
        from tpucv_torch.probes.common import timed

        torch = self.torch
        images, boxes, params = self._aug_inputs(B, S, M)
        cpu = AffineParams(*(torch.from_numpy(a) for a in params))
        card = AffineParams(*(t.to(self.dev) for t in cpu))
        for a, b in zip(source_indices(cpu, S), source_indices(card, S)):
            check(torch.equal(a, b.cpu()), "augment_batch: the gather's "
                                           "source indices differ")
        img_c, box_c = torch.from_numpy(images), torch.from_numpy(boxes)
        img_g, box_g = img_c.to(self.dev), box_c.to(self.dev)
        out_c, ob_c = augment_batch(img_c, box_c, cpu, dtype=torch.float32)
        out_g, ob_g = augment_batch(img_g, box_g, card, dtype=torch.float32)
        err = float((out_g.cpu() - out_c).abs().max())
        share = float((out_g.cpu() != out_c).double().mean())
        box_err = float((ob_g.cpu() - ob_c).abs().max())
        check(err <= AUG_PIXEL_TOL, f"augment_batch: pixels differ by {err}")
        check(box_err <= 1e-5, f"augment_batch: boxes differ by {box_err}")
        ms = timed(lambda: augment_batch(img_g, box_g, card), 20, self.dev)
        row = {"B": B, "S": S, "M": M, "indices_equal": True,
               "max_abs_err": err, "tolerance": AUG_PIXEL_TOL,
               "share_differing": share, "box_max_abs_err": box_err,
               "ms_bf16": ms}
        emit({"phase": "augment", **row})
        return row

    def phase_trainer(self, aug):
        """Yolo8Trainer on yolo8_det's config as shipped (640², B=16,
        M=100, device_aug, mosaic 0.5, num_workers 0, bf16) for
        TRAIN_STEPS steps: 4 steps an epoch on the synthetic set, so epoch
        9 ends the run through evaluate_loop, the periodic save and the
        final save. The loop's wait in next(loader) and its pace are read
        on the host clock over steps STEADY_FROM..39; the step alone is
        then timed on a device-resident batch (CUDA events) and its kernels
        summed by torch.profiler; checkpoint saves timed; the loader timed
        alone at 0 and 4 workers."""
        import os
        import shutil
        import statistics

        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.data.loader import Loader
        from tpucv_torch.probes.common import timed

        torch = self.torch
        cfg, _, cls = export_from_registry("yolo8_det")
        t, d = cfg.train, cfg.dataset
        check(d.input_size == 640 and t.batch_size == 16
              and d.max_num_boxes == 100 and t.device_aug
              and t.mosaic_prob == 0.5 and d.num_workers == 0
              and t.mixed_precision and cfg.arch.model_type == "n",
              "yolo8_det's config is not 640/B16/M100/device_aug/mosaic "
              "0.5/0 workers/bf16 YOLOv8n")
        out = ROOT / "saves" / "chip_smoke"
        shutil.rmtree(out, ignore_errors=True)
        t.save_path = str(out / "saves")
        cfg.log.root = str(out / "log")
        cfg.log.tensorboard_dir = str(out / "runs")

        t0 = time.perf_counter()
        trainer = cls(cfg, device=self.dev)
        build_s = time.perf_counter() - t0
        check(len(trainer.train_loader) == 4, "the synthetic set is not 4 "
                                              "batches of 16")
        rec = Recorder()
        trainer.tb = rec
        feed = TimedLoader(trainer.train_loader)
        trainer.train_loader = feed
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.train(max_steps=TRAIN_STEPS)
        self.sync()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = state.step
        check(steps == TRAIN_STEPS, f"took {steps} steps")
        final_sd = {k: v.detach().cpu().clone()
                    for k, v in state.model.state_dict().items()}
        check(all(torch.isfinite(v).all() for v in final_sd.values()),
              "non-finite weights after training")
        losses = rec.rows["train/loss"]
        check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
        val = trainer.last_eval
        check(np.isfinite(val["val_loss"]), "non-finite val loss")
        saves = sorted(os.listdir(t.save_path))
        check(saves == ["yolo8_det_coco_epoch-9.ckpt",
                        "yolo8_det_coco_final.ckpt"], f"saved {saves}")
        final_path = trainer._ckpt_path(t.epochs - 1, final=True)

        # the loop over the steady window, on the host clock
        h, w = feed.handed, feed.waits
        n_win = TRAIN_STEPS - 1 - STEADY_FROM
        step_wall_ms = (h[TRAIN_STEPS - 1] - h[STEADY_FROM]) / n_win * 1e3
        waits_ms = [x * 1e3 for x in w[STEADY_FROM:TRAIN_STEPS]]

        # the step alone on a device-resident batch
        step = trainer.build_train_step()
        host = next(iter(feed.loader))
        batch = trainer.device_batch(host, train=True)
        for _ in range(3):
            state, _m = step(state, batch)
        step_ms = timed(lambda: step(state, batch), 10, self.dev)
        prof_ms = self._kernel_ms_a_step(step, state, batch, 5)
        device_ms = prof_ms if prof_ms is not None else step_ms

        ckpt = str(out / "timing.ckpt")
        save_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            CheckPoint.save(state, ckpt)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        CheckPoint.load(ckpt, state)
        self.sync()
        load_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = os.path.getsize(final_path)

        loaders = {"train_set": self._loader_rates(feed.loader.ds, 2),
                   "set_of_256": self._loader_rates(
                       self._detection_set(256, cfg), 1)}

        row = {
            "config": "yolo8_det as shipped: YOLOv8n, 640, B=16, M=100, "
                      "device_aug, mosaic 0.5, num_workers 0, bf16",
            "steps": steps, "epochs_run": 10, "build_s": build_s,
            "train_s": train_s, "loss_logged": losses,
            "val": val, "saves": saves,
            "window_steps": [STEADY_FROM, TRAIN_STEPS - 1],
            "step_wall_ms": step_wall_ms,
            "img_per_s": 16 / step_wall_ms * 1e3,
            "loader_wait_ms_mean": float(np.mean(waits_ms)),
            "loader_wait_ms_median": statistics.median(waits_ms),
            "loader_wait_ms_by_step": waits_ms,
            "step_ms_device_resident": step_ms,
            "step_kernel_ms_profiler": prof_ms,
            "augment_ms": aug["ms_bf16"],
            "busy_share": (device_ms + aug["ms_bf16"]) / step_wall_ms,
            "busy_share_from": "profiler kernel sum" if prof_ms is not None
                               else "CUDA events, device-resident step",
            "ckpt_save_ms": save_ms, "ckpt_load_ms": load_ms,
            "ckpt_bytes": ckpt_bytes, "peak_mem_bytes": peak,
            "loader_alone": loaders,
            "host_cpus": len(os.sched_getaffinity(0)),
            "nvidia_smi": nvidia_smi()}
        emit({"phase": "trainer", **row})
        return {"cls": cls, "cfg": cfg, "final_path": final_path,
                "final_sd": final_sd, "trainer": trainer}

    @staticmethod
    def _detection_set(n, cfg):
        """A synthetic training set of ``n`` images built as the trainer
        builds its own (trainer/data_helpers.py)."""
        from tpucv_torch.data.detection_dataset import (
            DetectionDataset, SyntheticDetectionIndex)

        s, t = cfg.dataset.input_size, cfg.train
        return DetectionDataset(
            SyntheticDetectionIndex(n, s, cfg.num_classes, seed=0), s,
            cfg.dataset.max_num_boxes, train=True,
            mosaic_prob=t.mosaic_prob, special_aug_ratio=t.special_aug_ratio,
            epochs=t.epochs, device_aug=t.device_aug)

    @staticmethod
    def _loader_rates(ds, epochs):
        """Host images/s of the loader alone at 0 and 4 workers over
        ``epochs`` epochs of ``ds`` in batches of 16, with the ms to each
        epoch's first batch (the forked engine starts its workers there)."""
        from tpucv_torch.data.loader import Loader

        out = {}
        for nw in (0, 4):
            ld = Loader(ds, 16, shuffle=True, num_workers=nw)
            n, first = 0, []
            t0 = time.perf_counter()
            for epoch in range(1, epochs + 1):
                ld.set_epoch(epoch)
                te = time.perf_counter()
                for k, b in enumerate(ld):
                    if k == 0:
                        first.append((time.perf_counter() - te) * 1e3)
                    n += b["images"].shape[0]
            out[nw] = {"img_per_s": n / (time.perf_counter() - t0),
                       "images": n, "first_batch_ms": first}
        return out

    def _kernel_ms_a_step(self, step, state, batch, n):
        """Device kernel time a step, summed by torch.profiler over ``n``
        steps; None when the profiler records no device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(state, batch)
            self.sync()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / n / 1e3 if us > 0 else None

    # ------------------------------------------------ YOLOv8-seg and -pose
    def phase_seg_pose_parity(self):
        """Both families on the card against the CPU: the forward (f32,
        TF32 off, 640, B=2, random weights from torch.Generator seed 0;
        every output within 1e-3 of its largest value), then one train
        step each (B=2, 128², f32, the family's own synthetic batch): the
        TAL fg mask and GT rows of the first forward bit-equal, the loss
        and each term within 1e-4 relative."""
        import copy

        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.losses.yolov8 import yolov8_loss
        from tpucv_torch.train.state import (TrainState, forward,
                                             make_train_step)

        torch = self.torch
        cpu = torch.device("cpu")
        row = {}
        for name in ("yolo8_seg", "yolo8_pose"):
            cfg, algo_cls, trainer_cls = export_from_registry(name)
            algo = algo_cls(cfg, device=cpu)
            model = algo.build_model().reset_parameters(
                torch.Generator().manual_seed(0)).eval()
            x = torch.from_numpy(np.random.default_rng(3).random(
                (2, 640, 640, 3), dtype=np.float32))
            with torch.inference_mode():
                ref = flat_outputs(model(x))
                got = flat_outputs(copy.deepcopy(model).to(
                    self.dev, memory_format=torch.channels_last)(
                        x.to(self.dev)))
            rel = max(float((g.cpu() - c).abs().max() / c.abs().max())
                      for g, c in zip(got, ref))
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{name}: non-finite outputs on the card")
            check(rel < 1e-3, f"{name}: the f32 forward on the card differs "
                              f"from the CPU by {rel} of the largest value")

            cfg.dataset.input_size, cfg.train.batch_size = 128, 2
            ds = family_dataset(name, cfg, n=2, seed=3)
            batch = {k: torch.from_numpy(v) for k, v in
                     ds["collate"]([ds["ds"][0], ds["ds"][1]]).items()}
            batch["images"] = batch["images"].float() / 255.0
            loss_fn = algo.build_loss()
            runs = []
            for dev in (cpu, self.dev):
                m = copy.deepcopy(model).to(
                    dev, memory_format=torch.channels_last)
                b = {k: v.to(dev) for k, v in batch.items()}
                with torch.no_grad():
                    raw = forward(copy.deepcopy(m).train(), b["images"],
                                  False)
                    _, _, aux = yolov8_loss(
                        raw[0], b["gt_labels"], b["gt_bboxes"], b["gt_mask"],
                        nc=algo.nc, return_aux=True)
                state = TrainState.create(m, 1e-3, use_ema=True)
                step = make_train_step(
                    loss_fn, device=dev, ema_decay=0.9999,
                    loss_batch_scaled=trainer_cls.LOSS_BATCH_SCALED,
                    mixed_precision=False)
                _, sm = step(state, b)
                runs.append({"fg": aux["fg"].cpu(),
                             "gt_idx": aux["gt_idx"].cpu(),
                             "step": {k: float(v) for k, v in sm.items()}})
            c, g = runs
            check(torch.equal(c["fg"], g["fg"])
                  and torch.equal(c["gt_idx"], g["gt_idx"]),
                  f"{name}: the TAL assignment differs between card and CPU")
            terms = {k: abs(g["step"][k] - v) / max(abs(v), 1e-12)
                     for k, v in c["step"].items()}
            check(max(terms.values()) <= 1e-4,
                  f"{name}: loss terms card {g['step']} against CPU "
                  f"{c['step']}")
            row[name] = {"forward_max_rel_err": rel,
                         "fg": int(c["fg"].sum()), "tal_bit_equal": True,
                         "loss_cpu": c["step"], "loss_card": g["step"],
                         "loss_max_rel_err": max(terms.values())}
        emit({"phase": "seg_pose_parity", **row})

    def phase_family_trainer(self, name, steps=8, window=(4, 7)):
        """``python -m tpucv_torch.train --model <name>``'s main at the
        shipped config (640², SSD's 300², DeepLab's 513², B=16, bf16, the
        synthetic fallback: 4 batches an epoch, DeepLab's 2) for ``steps``
        steps, 2 epochs (DeepLab's 4), with evaluate_loop and the saves
        every second epoch (the intervals set to 2 for the smoke). The losses, all finite; images/s
        over the ``window`` steps (host clock); the step on a
        device-resident batch (CUDA events) and its kernel time (profiler);
        peak memory."""
        import os

        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.probes.common import timed
        from tpucv_torch.train import __main__ as cli

        torch = self.torch
        out = ROOT / "saves" / "chip_smoke" / name
        fam = TRAINED[name]
        seen = {}

        def registry(model_name):
            cfg, algo, cls = export_from_registry(model_name)
            t, d = cfg.train, cfg.dataset
            field, value = fam["arch"]
            check(d.input_size == fam["size"] and t.batch_size == 16
                  and t.mixed_precision
                  and getattr(cfg.arch, field) == value
                  and d.max_num_boxes == fam["M"],
                  f"{model_name}'s config is not as shipped")
            t.save_path, cfg.log.root = str(out / "saves"), str(out / "log")
            cfg.log.tensorboard_on = False
            cfg.log.print_interval = 1
            t.eval_interval = t.save_interval = 2

            class Recorded(cls):
                def _setup_logging(self):
                    super()._setup_logging()
                    self.tb = seen["rec"] = Recorder()
                    self.train_loader = seen["feed"] = TimedLoader(
                        self.train_loader)
                    seen["trainer"] = self

            return cfg, algo, Recorded

        was = cli.export_from_registry
        cli.export_from_registry = registry
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state = cli.main(["--model", name, "--max-steps", str(steps)])
        finally:
            cli.export_from_registry = was
        self.sync()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        trainer, rec, feed = seen["trainer"], seen["rec"], seen["feed"]
        check(state.step == steps, f"{name}: took {state.step} steps")
        losses = {k: rec.rows[f"train/{k}"] for k in fam["terms"]}
        check(all(np.isfinite(v) for r in losses.values() for v in r.values())
              and len(losses["loss"]) == steps, f"{name}: non-finite losses")
        val = trainer.last_eval
        check(all(np.isfinite(v) for v in val.values()) and
              fam["val"] in val, f"{name}: evaluate_loop gave {val}")
        saves = sorted(os.listdir(out / "saves"))
        ds = trainer.cfg.dataset.name
        epochs = -(-steps // len(feed))
        want = sorted([f"{name}_{ds}_epoch-{e}.ckpt" for e in range(epochs)
                       if e % 2 == 1 or e == epochs - 1]
                      + [f"{name}_{ds}_final.ckpt"])
        check(saves == want, f"{name}: saved {saves}, not {want}")
        a, b = window
        step_wall_ms = (feed.handed[b] - feed.handed[a]) / (b - a) * 1e3

        step = trainer.build_train_step()
        batch = trainer.device_batch(next(iter(feed.loader)), train=True)
        step_ms = timed(lambda: step(state, batch), 10, self.dev)
        prof_ms = self._kernel_ms_a_step(step, state, batch, 5)
        emit({"phase": fam["phase"],
              "config": f"{name} as shipped: {fam['desc']}",
              "steps": steps, "epochs_run": epochs, "train_s": train_s,
              "loss_logged": losses, "val": val, "saves": saves,
              "window_steps": list(window), "step_wall_ms": step_wall_ms,
              "img_per_s": 16 / step_wall_ms * 1e3,
              "step_ms_device_resident": step_ms,
              "step_kernel_ms_profiler": prof_ms, "peak_mem_bytes": peak,
              "nvidia_smi": nvidia_smi()})
        return {"trainer": trainer,
                "final_path": trainer._ckpt_path(trainer.cfg.train.epochs - 1,
                                                 final=True)}

    def family_sharpened(self, name, run):
        """The run's final weights with the class branch sharpened (as
        ``sharpened_ckpt``; YOLOv7's objectness and class rows), saved with
        save_pure beside them."""
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint

        cfg, algo_cls, _ = export_from_registry(name)
        model = algo_cls(cfg, device=self.dev).init_variables(seed=1)
        model.load_state_dict(CheckPoint.load_pure(run["final_path"]))
        TRAINED[name]["sharpen"](model)
        return CheckPoint.save_pure(
            model, str(ROOT / "saves" / "chip_smoke" / name /
                       "sharpened.ckpt"))

    def phase_family_predict(self, name, ckpt, imgs, reps=5):
        """``python -m tpucv_torch.predict``'s main on the smoke's 4 JPEGs
        and a PNG with the sharpened checkpoint (conf 0.25, K <= 1024; SSD:
        conf 0.7, K = 1,024): nms_keep's count zeroed just before, read just
        after; the drawn files exist; detections, masks and keypoints equal
        to the same run through nms_keep's plain version; then ms an image
        split into decode, letterbox, device (H2D, forward, decode, NMS),
        masks or keypoints (D2H, the masks' product, crop, upsample and
        overlay, or the keypoints' mapping and dots; none for SSD) and draw
        (median of ``reps``)."""
        import cv2

        from tpucv_torch import predict as cli
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference

        family = name.split("_")[-1]                 # seg, pose, ssd
        extra = {"seg": "masks", "pose": "keypoints"}.get(family)
        tag = f"_{family}@" if extra else "@"        # the drawn file's name
        out = ROOT / "saves" / "chip_smoke" / name / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        argv = ["--model", name, "--ckpt", ckpt, "--src", *srcs]
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        got = cli.main([*argv, "--dst", str(out / "drawn")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        check(launches == len(srcs), f"{name}: nms_keep launched {launches} "
                                     f"times for {len(srcs)} images")
        for src, r in zip(srcs, got):
            check(r["saved"] and Path(r["saved"]).is_file()
                  and Path(r["saved"]).name.startswith(Path(src).stem + tag),
                  f"{src}: no drawn file ({r['saved']})")
        was = self._swap_nms_keep(nms_keep_reference)
        try:
            plain = cli.main([*argv, "--dst", str(out / "plain")])
        finally:
            self._swap_nms_keep(was)
        keys = ("classes", "boxes", "scores") + ((extra,) if extra else ())
        for src, a, b in zip(srcs, got, plain):
            for key in keys:
                check(np.array_equal(a[key], b[key]),
                      f"{src}: {key} through nms_keep differ from the plain "
                      f"route's")
        n_dets = [len(r["classes"]) for r in got]
        check(min(n_dets) > 0, f"{name}: an image got no detection: {n_dets}")
        check(not extra or all(r[extra].shape[0] == n for r, n in
                               zip(got, n_dets)),
              f"{name}: {extra} do not match the detections")

        cfg, algo_cls, _ = export_from_registry(name)
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        infer = algo.make_predict_infer_fn()
        mod = sys.modules[type(algo).predict.__module__]
        rec = StageRecorder(self.sync)
        for attr, label in (("read_image", "decode"),
                            ("letter_box", "letterbox"),
                            ("show_detection_results", "draw")):
            rec.wrap(mod, attr, label)
        laps = {k: [] for k in ("decode", "letterbox", "device", extra,
                                "draw") if k}
        try:
            timed_infer = rec.wrapped(infer, "device")
            for _ in range(reps):
                for src in srcs:
                    rec.events.clear()
                    algo.predict(model, src, infer_fn=timed_infer,
                                 save_dir=str(out / "timed"))
                    ev = {k: (a, z) for k, a, z in rec.events}
                    for k in ("decode", "letterbox", "device", "draw"):
                        laps[k].append((ev[k][1] - ev[k][0]) * 1e3)
                    if extra:
                        laps[extra].append((ev["draw"][0] - ev["device"][1])
                                           * 1e3)
        finally:
            rec.restore()
        med = {k: float(np.median(v)) for k, v in laps.items()}
        emit({"phase": f"{family}_predict", "images": len(srcs),
              "nms_launches": launches, "detections": n_dets,
              "plain_route_equal": True, "cli_wall_s": wall,
              "ms_per_image": med, "ms_per_image_total": sum(med.values()),
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_seg_evaluate(self, ckpt, batch=32):
        """``python -m tpucv_torch.evaluate --model yolo8_seg``'s main on a
        COCO-layout root written here (64 640x480 JPEGs and a PNG, each GT
        box also a 4-point polygon; B=32, conf 0.001: K = 4096, the scan),
        bbox stats; then ``evaluate_mask_ap`` over the same root with its
        polygons (B=8, conf 0.001), the 12 mask stats finite, with ms of
        each stage: the host letterbox and GT rasterising, the device
        (forward, decode, scan), the masks (product, crop, upsample,
        threshold, D2H) and the mask COCOeval. nms_keep's count is read
        over both and must be 0; nms_scan's (the scan) above 0."""
        import os

        from tpucv_torch import evaluate as cli
        from tpucv_torch.algorithms import yolov8_seg as seg_mod
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.data.coco import COCOIndex
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        base = ROOT / "saves" / "chip_smoke" / "yolo8_seg" / "evaluate"
        root = base / "coco"
        n_img = write_coco_root(root, 64)
        env_was, cwd = os.environ.get("TPUCV_COCO_ROOT"), os.getcwd()
        os.environ["TPUCV_COCO_ROOT"] = str(root)
        os.chdir(base)
        nms_keep.launches = nms_scan.launches = 0    # just before the paths
        try:
            t0 = time.perf_counter()
            box_stats = cli.main(["--model", "yolo8_seg", "--dataset", "coco",
                                  "--ckpt", ckpt, "--batch-size", str(batch)])
            cli_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_COCO_ROOT")
            else:
                os.environ["TPUCV_COCO_ROOT"] = env_was
        check(len(box_stats) == 12 and all(np.isfinite(v) for v in
                                           box_stats.values()),
              f"bbox stats {box_stats}")

        cfg, algo_cls, _ = export_from_registry("yolo8_seg")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        index = COCOIndex(str(root / "annotations" / "instances_val2017.json"),
                          str(root / "val2017"), keep_polys=True)
        check(index.polygons(0, 0) is not None, "no polygons in the index")
        rec = StageRecorder(self.sync)
        rec.wrap(seg_mod, "letter_box", "letterbox")
        rec.wrap(seg_mod.YOLOv8Seg, "_masks", "masks")
        rec.wrap(seg_mod.COCOMaskAP, "accumulate", "cocoeval")
        make_infer = algo.make_seg_infer_fn
        algo.make_seg_infer_fn = lambda conf=None: rec.wrapped(
            make_infer(conf), "device")
        try:
            t0 = time.perf_counter()
            mask_stats = algo.evaluate_mask_ap(model, index, verbose=False)
            mask_s = time.perf_counter() - t0
        finally:
            rec.restore()
            del algo.make_seg_infer_fn
        launches = nms_keep.launches         # just after
        scan_launches = nms_scan.launches
        check(launches == 0, f"nms_keep launched {launches} times at K=4096")
        check(scan_launches > 0, "seg_evaluate launched no nms_scan")
        check(len(mask_stats) == 12 and all(np.isfinite(v) for v in
                                            mask_stats.values()),
              f"mask stats {mask_stats}")
        ms = {}
        for k, a, z in rec.events:
            ms[k] = ms.get(k, 0.0) + (z - a) * 1e3
        emit({"phase": "seg_evaluate", "images": n_img,
              "bbox_stats": box_stats, "evaluate_cli_s": cli_s,
              "evaluate_cli_img_per_s": n_img / cli_s,
              "mask_stats": mask_stats, "mask_ap_s": mask_s,
              "mask_ap_ms_by_stage": ms,
              "mask_ap_ms_other": mask_s * 1e3 - sum(ms.values()),
              "nms_launches": launches, "nms_scan_launches": scan_launches,
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_pose_evaluate(self, ckpt, run, batch=16, reps=3):
        """``python -m tpucv_torch.evaluate --model yolo8_pose``'s main on
        the synthetic pose index (no person_keypoints on the machine; B=16,
        conf 0.001: K = 4096, the scan): box and OKS stats, nms_keep's
        count 0. Then ``trainer.evaluate_map`` on the pose run's final
        state with the sharpened weights handed over as its EMA (16
        synthetic val images, B=16, conf 0.01: K = 1024): nms_keep's count
        zeroed just before, read just after, the detections equal to the
        same call through nms_keep's plain version, ms a call."""
        import os
        import types

        from tpucv_torch import evaluate as cli
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference
        from tpucv_torch.ops.cuda_scan import nms_scan

        base = ROOT / "saves" / "chip_smoke" / "yolo8_pose" / "evaluate"
        base.mkdir(parents=True, exist_ok=True)
        cwd = os.getcwd()
        os.chdir(base)
        nms_keep.launches = nms_scan.launches = 0    # just before the path
        try:
            t0 = time.perf_counter()
            stats = cli.main(["--model", "yolo8_pose", "--ckpt", ckpt,
                              "--batch-size", str(batch)])
            cli_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        eval_launches = nms_keep.launches    # just after
        scan_launches = nms_scan.launches
        check(eval_launches == 0, f"nms_keep launched {eval_launches} times "
                                  f"at K=4096")
        check(scan_launches > 0, "pose_evaluate launched no nms_scan")
        check(len(stats) == 22 and all(np.isfinite(v) for v in
                                       stats.values()), f"pose stats {stats}")
        emit({"phase": "pose_evaluate", "images": 16, "stats": stats,
              "cli_s": cli_s, "img_per_s": 16 / cli_s,
              "nms_launches": eval_launches,
              "nms_scan_launches": scan_launches, "nvidia_smi": nvidia_smi()})

        trainer = run["trainer"]
        state = trainer.state
        sharp = CheckPoint.load_pure(ckpt)
        ema = {n: sharp[n].to(self.dev) for n in state.params}
        view = types.SimpleNamespace(model=state.model, ema=ema)
        algo = trainer.algorithm
        harness = algo._batched_pose_detections
        seen = []

        def recorded(*args, **kw):
            for item in harness(*args, **kw):
                seen.append(item)
                yield item

        algo._batched_pose_detections = recorded
        try:
            nms_keep.launches = 0            # just before the path
            t0 = time.perf_counter()
            res = trainer.evaluate_map(view)
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = nms_keep.launches     # just after
            got, seen[:] = list(seen), []
            was = self._swap_nms_keep(nms_keep_reference)
            try:
                res_plain = trainer.evaluate_map(view)
            finally:
                self._swap_nms_keep(was)
            plain, seen[:] = list(seen), []
            call_ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                trainer.evaluate_map(view)
                call_ms.append((time.perf_counter() - t0) * 1e3)
                seen[:] = []
        finally:
            del algo._batched_pose_detections
        check(launches == 1, f"evaluate_map launched nms_keep {launches} "
                             f"times for one batch of 16")
        check(len(got) == len(plain) == len(trainer.val_index),
              f"{len(got)} images scored")
        for a, b in zip(got, plain):
            check(a[0] == b[0] and all(np.array_equal(x, y) for x, y in
                                       zip(a[1:], b[1:])),
                  f"image {a[0]}: detections through nms_keep differ from "
                  f"the plain route's")
        check(res == res_plain and all(np.isfinite(v) for v in res.values()),
              f"evaluate_map {res} against the plain route's {res_plain}")
        emit({"phase": "pose_eval_map", "images": len(got), "result": res,
              "detections": sum(len(a[1]) for a in got),
              "nms_launches": launches, "plain_route_equal": True,
              "first_call_ms": first_ms,
              "ms_per_call_median": float(np.median(call_ms)),
              "nvidia_smi": nvidia_smi()})
        return eval_launches, launches

    def phase_resume(self, run):
        """A new trainer resumes from the epoch-9 checkpoint
        (resume_training, last_epoch=9): after loading, the step counter is
        TRAIN_STEPS and the weights and Adam's state equal the file's bit
        for bit; then 4 more steps (epoch 10) with a finite loss."""
        from tpucv_torch.ckpt.checkpoint import CheckPoint

        torch = self.torch
        cfg = run["cfg"]
        cfg.train.resume_training = True
        cfg.train.last_epoch = 9
        trainer = run["cls"](cfg, device=self.dev)
        rec = Recorder()
        trainer.tb = rec
        path = trainer._ckpt_path(9)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        CheckPoint.load(path, trainer.state)
        check(trainer.state.step == TRAIN_STEPS,
              f"resumed at step {trainer.state.step}")
        sd = trainer.state.model.state_dict()
        check(all(torch.equal(sd[k].cpu(), raw["model"][k]) for k in sd),
              "weights after loading differ from the file")
        check(all(torch.equal(sd[k].cpu(), run["final_sd"][k]) for k in sd),
              "the epoch-9 file differs from the run's last weights")
        opt = trainer.state.optimizer.state_dict()["state"]
        check(all(torch.equal(v.cpu(), raw["optimizer"]["state"][i][k])
                  for i, s in opt.items() for k, v in s.items()),
              "Adam's state after loading differs from the file")
        state = trainer.train(max_steps=TRAIN_STEPS + 4)
        check(state.step == TRAIN_STEPS + 4, f"ended at step {state.step}")
        loss = rec.rows["train/loss"]
        check(list(loss) == [TRAIN_STEPS + 1] and np.isfinite(
            loss[TRAIN_STEPS + 1]), f"resumed run logged {loss}")
        emit({"phase": "resume", "from": path, "step_after_load":
              TRAIN_STEPS, "bit_equal": True, "steps": state.step,
              "loss": loss})

    def phase_ckpt_serve(self, run, imgs):
        """The final checkpoint through CheckPoint.load_pure into a fresh
        serving model on the card (bit-equal to the trained weights), one
        batch of 8 of the smoke's images through _batched_detections, so
        through nms_keep, and the detections held against the plain-NMS
        route as serve_vs_plain holds them. 40 warm-up steps (lr <= 4.1e-5)
        leave the init's class scores near 1e-4, under any confidence
        gate, so after loading the class branch is scaled as in serve."""
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables(seed=1)
        model.load_state_dict(CheckPoint.load_pure(run["final_path"]))
        sd = model.state_dict()
        check(all(torch.equal(sd[k].cpu(), run["final_sd"][k]) for k in sd),
              "served weights differ from the trained ones")
        sharpen_(model)
        index = [(im,) for im in imgs[:8]]
        nms_keep.launches = 0                # just before the path
        dets = list(algo._batched_detections(model, index, 8,
                                             cfg.decode.conf_threshold))
        launches = nms_keep.launches         # just after
        check(launches > 0, "nms_keep was not launched")
        results = [(200, {"detections": [{"class_id": int(c)}
                                         for c in classes]})
                   for _, _, _, classes in sorted(dets, key=lambda d: d[0])]
        n_dets = [len(r[1]["detections"]) for r in results]
        check(max(n_dets) > 0, "no detections")
        self.phase_serve_vs_plain(algo, model, imgs[:8], results,
                                  phase="ckpt_serve_vs_plain")
        emit({"phase": "ckpt_serve", "ckpt": run["final_path"],
              "weights_bit_equal": True, "nms_launches": launches,
              "detections": n_dets})
        return launches

    # ---------------------------------------------- predict and evaluate
    def sharpened_ckpt(self, run):
        """The run's final checkpoint with the class branch sharpened as in
        serve (40 warm-up steps leave every class score near 1e-4, under
        all three confidence gates), written beside it with save_pure."""
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint

        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        model = algo_cls(cfg, device=self.dev).init_variables(seed=1)
        model.load_state_dict(CheckPoint.load_pure(run["final_path"]))
        sharpen_(model)
        return CheckPoint.save_pure(
            model, str(ROOT / "saves" / "chip_smoke" / "sharpened.ckpt"))

    @staticmethod
    def _swap_nms_keep(fn):
        """Put ``fn`` where the decode calls nms_keep; returns what was
        there."""
        from tpucv_torch.ops import cuda_nms

        was, cuda_nms.nms_keep = cuda_nms.nms_keep, fn
        return was

    def phase_predict(self, ckpt, imgs, reps=5):
        """python -m tpucv_torch.predict's main on 4 JPEGs and 1 PNG with
        the sharpened checkpoint (nms_keep's count zeroed just before, read
        just after; conf 0.25, so K <= 1024); the drawn files exist; the
        same run with nms_keep's plain version in its place gives the same
        detections; then each image's time split into decode (read_image),
        letterbox (host), device (H2D, forward, decode, NMS, D2H) and draw
        (median of ``reps``)."""
        import cv2

        from tpucv_torch import predict as cli
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference
        from tpucv_torch.utils.image_process import (letter_box, read_image,
                                                     reverse_letter_box)
        from tpucv_torch.utils.visualize import show_detection_results

        torch = self.torch
        out = ROOT / "saves" / "chip_smoke" / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        argv = ["--model", "yolo8_det", "--ckpt", ckpt, "--src", *srcs]
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        got = cli.main([*argv, "--dst", str(out / "drawn")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        check(launches == len(srcs), f"nms_keep launched {launches} times "
                                     f"for {len(srcs)} images")
        for src, r in zip(srcs, got):
            stem = Path(src).stem
            check(r["saved"] and Path(r["saved"]).is_file()
                  and Path(r["saved"]).name.startswith(stem + "@"),
                  f"{src}: no drawn file ({r['saved']})")
        was = self._swap_nms_keep(nms_keep_reference)
        try:
            plain = cli.main([*argv, "--dst", str(out / "plain")])
        finally:
            self._swap_nms_keep(was)
        for src, a, b in zip(srcs, got, plain):
            for key in ("classes", "boxes", "scores"):
                check(np.array_equal(a[key], b[key]),
                      f"{src}: {key} through nms_keep differ from the plain "
                      f"route's")
        n_dets = [len(r["classes"]) for r in got]
        check(min(n_dets) > 0, f"an image got no detection: {n_dets}")

        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        infer = algo.make_infer_fn()
        s = algo.input_size
        laps = {k: [] for k in ("decode", "letterbox", "device", "draw")}
        for _ in range(reps):
            for src in srcs:
                t0 = time.perf_counter()
                img = read_image(src)
                t1 = time.perf_counter()
                canvas, scale, pad = letter_box(img, (s, s))
                t2 = time.perf_counter()
                b, sc, c, v = (t.cpu().numpy() for t in infer(
                    model, torch.from_numpy(canvas[None]).to(self.dev)))
                t3 = time.perf_counter()
                boxes = reverse_letter_box(b[0][v[0]], scale, pad,
                                           img.shape[:2])
                show_detection_results(img, boxes, sc[0][v[0]], c[0][v[0]],
                                       algo.class_names, str(out / "timed"),
                                       Path(src).stem)
                t4 = time.perf_counter()
                for k, (a, z) in zip(laps, ((t0, t1), (t1, t2), (t2, t3),
                                            (t3, t4))):
                    laps[k].append((z - a) * 1e3)
        med = {k: float(np.median(v)) for k, v in laps.items()}
        row = {"images": len(srcs), "nms_launches": launches,
               "detections": n_dets, "plain_route_equal": True,
               "cli_wall_s": wall, "ms_per_image": med,
               "ms_per_image_total": sum(med.values()),
               "nvidia_smi": nvidia_smi()}
        emit({"phase": "predict", **row})
        return launches

    def phase_evaluate(self, ckpt, batch=32):
        """python -m tpucv_torch.evaluate's main (B=32, conf 0.001: K =
        4096, the sequential scan) on a COCO-layout root written here (64
        640x480 JPEGs and one PNG from SyntheticDetectionIndex, one crowd
        GT), with the sharpened checkpoint; the native COCOeval must build,
        and on the CLI's eval_results.json its stats and precision arrays
        equal the numpy engine's within 1e-12. Then the CLI once more with
        recorders around its own stages (``_recorded_evaluate``), every
        batch's scan held against the scan on the CPU from the candidates
        the CLI gave it, and the host loader's rate over the JPEGs with the
        native decode and with cv2."""
        import os

        from tpucv_torch import evaluate as cli
        from tpucv_torch.algorithms.base import DetectionAlgorithm
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.data.coco import COCOIndex
        from tpucv_torch.metrics.coco_map import COCOMeanAP
        from tpucv_torch.native import imagepipe, load
        from tpucv_torch.ops import nms as nms_mod
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        base = ROOT / "saves" / "chip_smoke" / "evaluate"
        root = base / "coco"
        n_img = write_coco_root(root, 64)
        check(load("cocoeval") is not None,
              "the native COCOeval library did not build")
        engine = "native" if imagepipe.available() else "cv2"
        argv = ["--model", "yolo8_det", "--dataset", "coco", "--ckpt", ckpt,
                "--batch-size", str(batch)]
        env_was, cwd = os.environ.get("TPUCV_COCO_ROOT"), os.getcwd()
        os.environ["TPUCV_COCO_ROOT"] = str(root)
        os.chdir(base)
        try:
            nms_keep.launches = nms_scan.launches = 0
            t0 = time.perf_counter()
            stats = cli.main(argv)
            self.sync()
            wall = time.perf_counter() - t0
            launches = nms_keep.launches
            scan_launches = nms_scan.launches
            with open(base / "result" / "eval_results.json") as f:
                dts = json.load(f)
            stages, scans, rec_stats = self._recorded_evaluate(
                cli, argv, DetectionAlgorithm,
                (nms_mod, "dispatch_batched_nms"), COCOMeanAP)
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_COCO_ROOT")
            else:
                os.environ["TPUCV_COCO_ROOT"] = env_was
        check(len(stats) == 12 and all(np.isfinite(v) for v in
                                       stats.values()), f"stats {stats}")
        check(rec_stats == stats, "the recorded run's stats differ")
        check(scan_launches == -(-n_img // batch),
              f"evaluate: nms_scan launched {scan_launches} times for "
              f"{n_img} images in batches of {batch}")

        index = COCOIndex(str(root / "annotations" /
                              "instances_val2017.json"), str(root / "val2017"))
        gts = [r for i in range(len(index)) for r in index.eval_gt_records(i)]
        check(sum(r["iscrowd"] for r in gts) == 1, "not one crowd GT")
        t0 = time.perf_counter()
        nat = COCOMeanAP(gts, dts, index.cat_ids).accumulate(use_native=True)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = COCOMeanAP(gts, dts, index.cat_ids).accumulate(use_native=False)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        arr_err = max(float(np.abs(nat.precision - ref.precision).max()),
                      float(np.abs(nat.recall - ref.recall).max()))
        nat_stats, ref_stats = nat.summarize(), ref.summarize()
        stat_err = max(abs(nat_stats[k] - ref_stats[k]) for k in ref_stats)
        check(arr_err <= 1e-12 and stat_err <= 1e-12,
              f"native COCOeval differs from numpy by {arr_err} / {stat_err}")
        check(all(nat_stats[k] == stats[k] for k in stats),
              "the CLI's stats are not the native engine's")

        kept, loop_ms, per_full_batch = self._scans_equal_cpu(
            scans, stages, n_img, batch, nms_mod.dispatch_batched_nms)
        cfg = export_from_registry("yolo8_det")[0]
        loader = self._jpeg_loader_rates(index, cfg)
        row = {"images": n_img, "batch": batch, "K": 4096,
               "decode_engine": engine, "stats": stats,
               "cli_wall_s": wall, "img_per_s_cli": n_img / wall,
               "nms_keep_launches": launches,
               "nms_scan_launches": scan_launches,
               "kept_per_image": [min(kept), float(np.mean(kept)), max(kept)],
               "recorded_loop_img_per_s": n_img / loop_ms * 1e3,
               "ms_per_full_batch": per_full_batch, "ms_by_batch": stages,
               "scan_share_of_loop": sum(stages["scan"]) / loop_ms,
               "scan_equals_cpu_batches": len(scans),
               "cocoeval_native_ms": native_ms, "cocoeval_numpy_ms": numpy_ms,
               "cocoeval_max_abs_err": arr_err,
               "cocoeval_stat_max_abs_err": stat_err,
               "detections": len(dts), "loader_jpeg": loader,
               "nvidia_smi": nvidia_smi()}
        emit({"phase": "evaluate", **row})
        return launches, stats

    def _recorded_evaluate(self, cli, argv, algo_cls, scan, coco_cls):
        """The evaluate CLI's main once more, with recorders put around its
        own functions and taken away after: each batch's canvas fill
        (wall), H2D + letterbox + forward + top-k (from the fill's end to
        the scan's start), the scan (``scan``: (owner, attribute) of the
        NMS call, synced at both edges), D2H and the host's records (to the
        next batch's fill, or to the loop's end), then COCOeval's
        accumulate. Returns (stages: each of LOOP_STAGES -> [ms a batch],
        "images" -> [images a batch], "cocoeval" -> ms; the scans' (args,
        keywords, outputs); the stats)."""
        sync = self.sync
        fill, harness = algo_cls._fill_canvases, algo_cls._batched_detections
        owner, attr = scan
        dispatch, accumulate = getattr(owner, attr), coco_cls.accumulate
        marks, scans, stages = [], [], {"images": []}

        def fill_rec(obj, index, idxs, *a, **kw):
            t0 = time.perf_counter()
            out = fill(obj, index, idxs, *a, **kw)
            stages["images"].append(len(idxs))
            marks.append({"fill": (t0, time.perf_counter())})
            return out

        def dispatch_rec(*args, **kw):
            sync()
            t0 = time.perf_counter()
            idx, valid = dispatch(*args, **kw)
            sync()
            marks[-1]["scan"] = (t0, time.perf_counter())
            scans.append((args, kw, idx, valid))
            return idx, valid

        def harness_rec(*a, **kw):
            yield from harness(*a, **kw)
            marks.append({"fill": (time.perf_counter(), None)})

        def accumulate_rec(obj, *a, **kw):
            t0 = time.perf_counter()
            out = accumulate(obj, *a, **kw)
            stages["cocoeval"] = (time.perf_counter() - t0) * 1e3
            return out

        algo_cls._fill_canvases = fill_rec
        algo_cls._batched_detections = harness_rec
        setattr(owner, attr, dispatch_rec)
        coco_cls.accumulate = accumulate_rec
        try:
            stats = cli.main(argv)
        finally:
            algo_cls._fill_canvases = fill
            algo_cls._batched_detections = harness
            setattr(owner, attr, dispatch)
            coco_cls.accumulate = accumulate
        for k in LOOP_STAGES:
            stages[k] = []
        for m, nxt in zip(marks, marks[1:]):
            (f0, f1), (s0, s1) = m["fill"], m["scan"]
            for k, (a, z) in zip(LOOP_STAGES, ((f0, f1), (f1, s0), (s0, s1),
                                               (s1, nxt["fill"][0]))):
                stages[k].append((z - a) * 1e3)
        return stages, scans, stats

    def _scans_equal_cpu(self, scans, stages, n_img, batch, dispatch,
                         K=4096):
        """Every batch the evaluate CLI scanned (``_recorded_evaluate``),
        with ``K`` candidates (4096: the scan; SSD's 1,024: nms_keep;
        CenterNet's 100: the DIoU scan) and more live ones than ``max_det``
        (all K where K is ``max_det``), held against ``dispatch`` on the
        CPU from the same candidates (at K <= 1,024 the kernel's plain
        version): idx and valid equal. Returns (detections kept an image,
        the loop's ms, the mean ms of each stage over the full batches)."""
        torch = self.torch
        check(len(scans) == len(stages["images"]) == -(-n_img // batch),
              f"{len(scans)} scans for batches of {stages['images']}")
        kept = []
        for k, (args, kw, idx, valid) in enumerate(scans):
            off, scores, thr, max_det = args
            check(scores.shape[1] == K and int(
                (scores > 0).sum(1).min()) > min(max_det, K - 1),
                  f"batch {k}: the scan had little work: K "
                  f"{scores.shape[1]}, {int((scores > 0).sum())} valid")
            c_idx, c_valid = dispatch(off.cpu(), scores.cpu(), thr, max_det,
                                      **kw)
            check(torch.equal(idx.cpu(), c_idx)
                  and torch.equal(valid.cpu(), c_valid),
                  f"batch {k}: the scan on the card differs from the scan "
                  f"on the CPU")
            kept += valid.sum(1).tolist()
        loop_ms = sum(sum(stages[k]) for k in LOOP_STAGES)
        full = [j for j, n in enumerate(stages["images"]) if n == batch]
        check(len(full) == n_img // batch, f"batches {stages['images']}")
        per_full_batch = {k: float(np.mean([stages[k][j] for j in full]))
                          for k in LOOP_STAGES}
        return kept, loop_ms, per_full_batch

    def _jpeg_loader_rates(self, index, cfg, epochs=2):
        """The trainer's host feed (one thread, as yolo8_det ships) over the
        evaluate phase's JPEGs: images/s with the native decode and with
        cv2 (the native library's one-time check turned off)."""
        from tpucv_torch.data.detection_dataset import DetectionDataset
        from tpucv_torch.data.loader import Loader
        from tpucv_torch.native import imagepipe

        t = cfg.train
        ds = DetectionDataset(
            index, cfg.dataset.input_size, cfg.dataset.max_num_boxes,
            train=True, mosaic_prob=t.mosaic_prob,
            special_aug_ratio=t.special_aug_ratio, epochs=t.epochs,
            device_aug=t.device_aug)
        out = {}
        was = imagepipe._PARITY.get("ok")
        for engine in ("native", "cv2", "native again"):
            imagepipe._PARITY["ok"] = engine != "cv2" and bool(was)
            ld = Loader(ds, 16, shuffle=True, num_workers=0)
            n, t0 = 0, time.perf_counter()
            for epoch in range(epochs):
                ld.set_epoch(epoch)
                for b in ld:
                    n += b["images"].shape[0]
            out[engine] = {"img_per_s": n / (time.perf_counter() - t0),
                           "images": n}
        imagepipe._PARITY["ok"] = was
        out["native_available"] = bool(was)
        return out

    def phase_eval_map(self, run, reps=3):
        """trainer.evaluate_map on the run's final state (the final
        checkpoint loaded back into it; synthetic val index of 16 images at
        B=16, conf 0.01, so K = 1024: the VOC engine and the COCO
        cross-summary). yolo8_det ships without an EMA, so the state is
        handed over with its parameters, class branch sharpened, as its
        EMA: evaluate_map scores them in a copy of the model with the live
        BatchNorm statistics. nms_keep's count zeroed just before the call,
        read just after; the detections equal those of the same call with
        nms_keep's plain version in its place; the trained weights
        unchanged; ms a call (median of ``reps``)."""
        import types

        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference

        torch = self.torch
        trainer = run["trainer"]
        state = trainer.state
        CheckPoint.load(run["final_path"], state)
        live = {k: v.detach().clone() for k, v in
                state.model.state_dict().items()}
        check(all(torch.equal(live[k].cpu(), run["final_sd"][k])
                  for k in live), "the state is not the run's final state")
        ema = {n: p.detach().clone() for n, p in state.params.items()}
        for lv in range(3):
            ema[f"model.22.cv3.{lv}.2.bias"].zero_()
            ema[f"model.22.cv3.{lv}.2.weight"].mul_(CLS_GAIN)
        view = types.SimpleNamespace(model=state.model, ema=ema)
        harness = trainer.algorithm._batched_detections
        seen = []

        def recorded(*args, **kw):
            for item in harness(*args, **kw):
                seen.append(item)
                yield item

        trainer.algorithm._batched_detections = recorded
        try:
            nms_keep.launches = 0            # just before the path
            t0 = time.perf_counter()
            res = trainer.evaluate_map(view)
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = nms_keep.launches     # just after
            got, seen[:] = list(seen), []
            was = self._swap_nms_keep(nms_keep_reference)
            try:
                res_plain = trainer.evaluate_map(view)
            finally:
                self._swap_nms_keep(was)
            plain, seen[:] = list(seen), []
        finally:
            trainer.algorithm._batched_detections = harness
        check(launches > 0, "evaluate_map did not launch nms_keep")
        check(len(got) == len(plain) == len(trainer.val_index),
              f"{len(got)} images scored")
        for a, b in zip(got, plain):
            check(a[0] == b[0] and all(np.array_equal(x, y) for x, y in
                                       zip(a[1:], b[1:])),
                  f"image {a[0]}: detections through nms_keep differ from "
                  f"the plain route's")
        check(res == res_plain, f"{res} != {res_plain}")
        check(sum(len(a[3]) for a in got) > 0, "no detection")
        check(all(torch.equal(v, live[k]) for k, v in
                  state.model.state_dict().items()),
              "evaluate_map changed the trained model")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            trainer.evaluate_map(view)
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"images": len(got), "batch": trainer.cfg.train.batch_size,
               "K": 1024, "result": res, "nms_launches": launches,
               "detections": [len(a[3]) for a in got],
               "plain_route_equal": True, "first_call_ms": first_ms,
               "ms_per_call": float(np.median(times)), "ms_runs": times,
               "nvidia_smi": nvidia_smi()}
        emit({"phase": "eval_map", **row})
        return launches

    # ------------------------------------------------------------ int8 --
    def letterboxed(self, algo, imgs):
        """The images through the algorithm's staged batch, letterboxed on
        the card as ``_batched_detections`` does: uint8 (B, S, S, 3)."""
        from tpucv_torch.ops.preprocess import letterbox_images

        with algo._staged_batch([(im,) for im in imgs], range(len(imgs)),
                                len(imgs)) as (canv, hw, geom, hs, _, _):
            lb, _, _ = letterbox_images(canv, hw, algo.input_size,
                                        geom=geom, scale=hs)
        return lb

    def phase_int8_parity(self, imgs, names=("yolo8_det", "yolo8_seg",
                                             "yolo8_pose"),
                          phase="int8_parity"):
        """The ``names`` families as shipped (yolo8_det, yolo8_seg and
        yolo8_pose: YOLOv8n; yolo7: YOLOv7-l; 640, bf16 autocast, random
        weights from seed 0), each quantized by its
        algorithm's ``quantize_variables`` on 8 of the smoke's images (B=2),
        then one batch of 2 through the int8 model with every quantized
        conv's input captured: for each conv, the card route's int32
        accumulators (im2col + ``torch._int_mm``) bit-equal to the plain
        route's (float64 ``F.conv2d``) on the card. Counts the convs whose
        GEMM needed M, K or N padding; pose's six 51-wide keypoint convs
        must be among them."""
        from tpucv_torch import quant
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ops import int8_conv
        from tpucv_torch.ops.preprocess import normalize_images

        torch = self.torch
        index = [(im,) for im in imgs[:8]]
        rows = {}
        for name in names:
            cfg, algo_cls, _ = export_from_registry(name)
            algo = algo_cls(cfg, device=self.dev)
            model = algo.init_variables(seed=0)
            t0 = time.perf_counter()
            q = algo.quantize_variables(model, index, n_images=8,
                                        batch_size=2)
            self.sync()
            calib_s = time.perf_counter() - t0
            check(quant.count_quantized(model) == 0,
                  f"{name}: quantize_variables changed the float model")
            seen = []
            hooks = [m.register_forward_pre_hook(
                lambda mod, inp, n=n: seen.append((n, mod, inp[0])))
                for n, m in quant.hooked(q) if m.qweight is not None]
            lb = self.letterboxed(algo, imgs[:2])
            try:
                with torch.inference_mode(), \
                        torch.autocast("cuda", dtype=torch.bfloat16):
                    out = flat_outputs(q(normalize_images(lb, algo.dtype)))
            finally:
                for h in hooks:
                    h.remove()
            check(all(torch.isfinite(o.float()).all() for o in out),
                  f"{name}: non-finite int8 outputs")
            n_q = quant.count_quantized(q)
            check(len(seen) == n_q, f"{name}: {len(seen)} of {n_q} "
                                    f"quantized convs ran")
            padded, peak = [], 0
            with torch.inference_mode():
                for n, m, x in seen:
                    c = m.conv
                    geom = (c.kernel_size, c.stride, c.padding, c.dilation,
                            c.groups)
                    xq = quant.quantize_activation(x, m.xscale)
                    card = int8_conv.conv_gemm(xq, m.qweight, *geom)
                    plain = int8_conv.conv_plain(xq, m.qweight, *geom)
                    self.sync()
                    bad = int((card != plain).sum())
                    check(bad == 0, f"{name} {n}: {bad} int32 accumulators "
                                    f"of the card route differ from the "
                                    f"plain route's")
                    peak = max(peak, int(plain.abs().max()))
                    M = card.shape[0] * card.shape[2] * card.shape[3]
                    K, N = m.qweight.shape[1], m.qweight.shape[0]
                    if int8_conv.gemm_dims(M, K, N) != (M, K, N):
                        padded.append([n, M, K, N])
            if name == "yolo8_pose":
                wide = [p for p in padded if p[3] == 51]
                check(len(wide) == 6, f"pose: 51-wide convs padded {wide}")
            if name == "ssd":
                check(n_q == 14, f"ssd: {n_q} quantized convs, not 14")
            if name == "centernet":
                check(n_q == CENTERNET_QUANTIZED, f"centernet: {n_q} "
                      f"quantized convs, not {CENTERNET_QUANTIZED}")
            rows[name] = {"count_quantized": n_q, "convs_compared": len(seen),
                          "accumulators_bit_equal": True,
                          "max_abs_accumulator": peak,
                          "padded_convs": len(padded), "padded": padded,
                          "size": algo.input_size, "calibrate_s": calib_s}
            del model, q, seen
        emit({"phase": phase, "batch": 2, **rows})

    def phase_int8_bench(self, model):
        """The bench entry point's int8 program (``bench.bench_int8``: PTQ
        calibrated on the first resident B=128 batch, then the same
        letterbox + forward + decode + NMS as ``value``) with nms_keep's
        count (one a call); then the bf16 and int8 programs timed in turns
        (bf16, int8, int8, bf16) on the same resident batches; then the
        stages of the largest convs (``probes.int8_conv_parts``) against
        F.conv2d bf16 at the same shapes."""
        import itertools

        from tpucv_torch import bench
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes import int8_conv_parts
        from tpucv_torch.probes.common import timed

        torch = self.torch
        shapes = bench.FULL
        nms_keep.launches = 0                # just before the path
        res = bench.bench_int8(model, self.dev, shapes)
        launches = nms_keep.launches         # just after
        calls = 3 + 1 + shapes.infer_iters
        check(launches == calls, f"int8 bench: nms_keep launched "
                                 f"{launches} times in {calls} calls")

        resident = [h.to(self.dev) for h in bench.raw_batches(shapes)]
        qmodel = bench.quantize_int8(model, resident[0], shapes.size, True)
        programs = {k: bench.inference_program(m, shapes.size, True)[1]
                    for k, m in (("bf16", model), ("int8", qmodel))}
        turns = {"bf16": [], "int8": []}
        with torch.inference_mode():
            outs = {k: p(resident[0]) for k, p in programs.items()}
            for k in ("bf16", "int8", "int8", "bf16"):
                n = itertools.count()
                turns[k].append(timed(
                    lambda p=programs[k]: p(resident[next(n) % 4]),
                    shapes.infer_iters, self.dev))
        for k, o in outs.items():
            check(all(torch.isfinite(t.float()).all() for t in o),
                  f"{k} bench outputs not finite")
        ms = {k: min(v) for k, v in turns.items()}
        split = int8_conv_parts.main([])
        check(all(r["accumulators_equal"] for r in split),
              "a split shape's routes differ")
        emit({"phase": "int8_bench", "batch": shapes.batch,
              "iters": shapes.infer_iters, "nms_launches": launches,
              **res, "turns_ms": turns,
              "value_img_per_sec": shapes.batch * 1e3 / ms["bf16"],
              "int8_img_per_sec_turns": shapes.batch * 1e3 / ms["int8"],
              "int8_over_bf16_ms": ms["int8"] / ms["bf16"],
              "detections_mean": {k: float(o[3].sum(1).float().mean())
                                  for k, o in outs.items()},
              "conv_split": split, "nvidia_smi": nvidia_smi()})
        return launches

    def raw_closeness(self, algo, fmodel, qmodel, images_u8):
        """The float and int8 models' raw maps on the same uint8 NHWC batch
        (normalized and run as the infer fn does): per level max |int8 -
        float| / max |float| and the cosine (at least INT8_COS_MIN, tpucv's
        bar), and, at the anchors whose float best-class score passes the
        config's confidence, the share whose best class the int8 maps agree
        on (at least INT8_CLASS_AGREE_MIN); and how many anchors score
        exactly 1 (the sharpened class branch saturates the sigmoid, and
        the top-k takes the lowest indices among such ties)."""
        torch = self.torch
        from tpucv_torch.ops.preprocess import normalize_images

        conf = algo.cfg.decode.conf_threshold
        nb = 4 * algo.cfg.arch.reg_max
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            x = normalize_images(images_u8.to(self.dev), algo.dtype)
            pairs = list(zip(fmodel(x), qmodel(x)))
        rel, cos, agree, n, tied = [], [], 0, 0, 0
        for f, q in pairs:
            f, q = f.float(), q.float()
            rel.append(float((q - f).abs().max() / f.abs().max()))
            cos.append(float((f * q).sum() / (f.norm() * q.norm())))
            fc, qc = f[..., nb:], q[..., nb:]
            best = fc.max(-1).values.sigmoid()
            live = best > conf
            n += int(live.sum())
            tied += int((best == 1.0).sum())
            agree += int((fc.argmax(-1) == qc.argmax(-1))[live].sum())
        out = {"max_rel_err": rel, "cosine": cos,
               "class_agree_share": agree / max(n, 1), "anchors": n,
               "anchors_scored_1": tied}
        check(min(cos) >= INT8_COS_MIN and out["class_agree_share"]
              >= INT8_CLASS_AGREE_MIN, f"int8 raw maps part from the "
                                       f"float ones: {out}")
        return out

    @staticmethod
    def matched_share(ref, got, iou=0.5, same_class=True):
        """Share of the ``ref`` detections (boxes xyxy, classes) that a
        ``got`` detection (of the same class, unless ``same_class`` is
        False) overlaps at IoU >= ``iou``."""
        n = hit = 0
        for (rb, rc), (gb, gc) in zip(ref, got):
            rb, gb = np.asarray(rb, np.float64), np.asarray(gb, np.float64)
            n += len(rb)
            if not len(rb) or not len(gb):
                continue
            lt = np.maximum(rb[:, None, :2], gb[None, :, :2])
            rbb = np.minimum(rb[:, None, 2:], gb[None, :, 2:])
            inter = np.clip(rbb - lt, 0, None).prod(-1)
            area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])  # noqa
            u = area(rb)[:, None] + area(gb)[None, :] - inter
            ok = inter / np.maximum(u, 1e-9) >= iou
            if same_class:
                ok &= np.asarray(rc)[:, None] == np.asarray(gc)[None, :]
            hit += int(ok.any(1).sum())
        return hit / max(n, 1)

    def phase_int8_serve(self, ckpt, imgs):
        """python -m tpucv_torch.serve's ``build`` with ``--int8 --calib``
        (the smoke's images written as JPEGs, the sharpened checkpoint,
        batch 8): 16 raw-RGB requests through the int8 server, nms_keep's
        count zeroed just before, read just after; its detections against
        the float model's on the same images (``_batched_detections``, the
        server's path): the share of float detections matched at IoU >=
        0.5 by an int8 detection of the same class, gated at
        INT8_MATCH_MIN; the first batch's raw maps against the float
        model's (``raw_closeness``)."""
        import cv2

        from tpucv_torch import quant
        from tpucv_torch import serve as cli
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep

        calib = ROOT / "saves" / "chip_smoke" / "calib"
        calib.mkdir(parents=True, exist_ok=True)
        for k, img in enumerate(imgs):
            check(cv2.imwrite(str(calib / f"{k:02d}.jpg"),
                              cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  "could not write a calibration image")
        t0 = time.perf_counter()
        server = cli.build(["--model", "yolo8_det", "--ckpt", ckpt,
                            "--host", "127.0.0.1", "--port", "0",
                            "--batch", "8", "--int8", "--calib", str(calib)])
        build_s = time.perf_counter() - t0
        n_q = quant.count_quantized(server.batcher.model)
        results = [None] * len(imgs)
        try:
            def post(k):
                results[k] = server.batcher.submit(imgs[k])

            posters = [threading.Thread(target=post, args=(k,))
                       for k in range(len(imgs))]
            nms_keep.launches = 0            # just before the path
            t0 = time.perf_counter()
            for p in posters:
                p.start()
            for p in posters:
                p.join(timeout=600)
            wall = time.perf_counter() - t0
            launches = nms_keep.launches     # just after
            check(not any(p.is_alive() for p in posters), "requests hung")
        finally:
            server.batcher.stop()
            server.server_close()
        check(all("detections" in r for r in results),
              f"failed requests: {[r for r in results if 'error' in r][:2]}")
        check(launches > 0, "int8 serving launched no nms_keep")
        got = [([d["box"] for d in r["detections"]],
                [d["class_id"] for d in r["detections"]]) for r in results]

        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        ref = [None] * len(imgs)
        for i, b, _, c in algo._batched_detections(
                model, [(im,) for im in imgs], 8, cfg.decode.conf_threshold):
            ref[i] = (b, c)
        share = self.matched_share(ref, got)
        check(share >= INT8_MATCH_MIN, f"int8 serving matched {share} of "
                                       f"the float detections")
        lb = self.letterboxed(algo, imgs[:8])
        emit({"phase": "int8_serve", "requests": len(imgs), "batch": 8,
              "count_quantized": n_q, "nms_launches": launches,
              "build_s": build_s, "wall_s": wall,
              "detections_int8": [len(g[0]) for g in got],
              "detections_float": [len(r[0]) for r in ref],
              "float_matched_share": share,
              "float_matched_share_any_class": self.matched_share(
                  ref, got, same_class=False),
              "raw_maps_first_batch": self.raw_closeness(
                  algo, model, server.batcher.model, lb),
              "stats": server.batcher.snapshot()})
        return launches

    def phase_int8_predict(self, ckpt):
        """python -m tpucv_torch.predict's main with ``--int8`` on the
        predict phase's 4 JPEGs and a PNG (calibrated on them, B=5; conf
        0.25, K <= 1024), nms_keep's count zeroed just before, read just
        after; drawn files exist; the share of the float run's detections
        matched as in int8_serve, and each image's raw maps against the
        float model's (``raw_closeness``)."""
        from tpucv_torch import predict as cli
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.utils.image_process import letter_box, read_image

        out = ROOT / "saves" / "chip_smoke" / "predict"
        srcs = sorted(str(p) for p in out.glob("img*.*"))
        check(len(srcs) == 5, f"predict's images: {srcs}")
        argv = ["--model", "yolo8_det", "--ckpt", ckpt, "--src", *srcs]
        ref = cli.main([*argv, "--dst", str(out / "float")])
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        got = cli.main([*argv, "--int8", "--dst", str(out / "int8")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        check(launches == len(srcs), f"nms_keep launched {launches} times "
                                     f"for {len(srcs)} images")
        check(all(r["saved"] and Path(r["saved"]).is_file() for r in got),
              "an int8 image was not drawn")
        pairs = ([(r["boxes"], r["classes"]) for r in ref],
                 [(r["boxes"], r["classes"]) for r in got])
        share = self.matched_share(*pairs)
        check(share >= INT8_MATCH_MIN, f"int8 predict matched {share} of "
                                       f"the float detections")
        # the CLI's int8 model again (calibrated on the same images, B=5),
        # for its raw maps beside the float ones on each image
        cfg, algo_cls, _ = export_from_registry("yolo8_det")
        algo = algo_cls(cfg, device=self.dev)
        fmodel = algo.init_variables()
        fmodel.load_state_dict(CheckPoint.load_pure(ckpt))
        qmodel = algo.quantize_variables(fmodel, [(p,) for p in srcs],
                                         n_images=len(srcs),
                                         batch_size=len(srcs))
        s_ = algo.input_size
        raw = [self.raw_closeness(algo, fmodel, qmodel, self.torch.from_numpy(
            letter_box(read_image(p), (s_, s_))[0][None])) for p in srcs]
        emit({"phase": "int8_predict", "images": len(srcs),
              "nms_launches": launches, "cli_wall_s": wall,
              "detections_int8": [len(r["classes"]) for r in got],
              "detections_float": [len(r["classes"]) for r in ref],
              "float_matched_share": share,
              "float_matched_share_any_class": self.matched_share(
                  *pairs, same_class=False),
              "raw_maps_by_image": raw})
        return launches

    def phase_int8_evaluate(self, ckpt, float_stats, batch=32):
        """python -m tpucv_torch.evaluate's main with ``--int8`` on the
        evaluate phase's COCO root (calibrated on its first 32 images; B=32,
        conf 0.001: K = 4096, the scan): it runs to its end and its 12
        stats are finite; printed beside the float run's. No accuracy
        gate: the weights are random."""
        import os

        from tpucv_torch import evaluate as cli
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        base = ROOT / "saves" / "chip_smoke" / "evaluate"
        env_was, cwd = os.environ.get("TPUCV_COCO_ROOT"), os.getcwd()
        os.environ["TPUCV_COCO_ROOT"] = str(base / "coco")
        os.chdir(base)
        try:
            nms_keep.launches = nms_scan.launches = 0
            t0 = time.perf_counter()
            stats = cli.main(["--model", "yolo8_det", "--dataset", "coco",
                              "--ckpt", ckpt, "--batch-size", str(batch),
                              "--int8"])
            self.sync()
            wall = time.perf_counter() - t0
            launches = nms_keep.launches
            scan_launches = nms_scan.launches
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_COCO_ROOT")
            else:
                os.environ["TPUCV_COCO_ROOT"] = env_was
        check(len(stats) == 12 and all(np.isfinite(v) for v in
                                       stats.values()), f"stats {stats}")
        check(scan_launches > 0, "int8_evaluate launched no nms_scan")
        emit({"phase": "int8_evaluate", "batch": batch, "K": 4096,
              "stats_int8": stats, "stats_float": float_stats,
              "cli_wall_s": wall, "nms_keep_launches": launches,
              "nms_scan_launches": scan_launches})
        return launches

    # ---------------------------------------------------------- YOLOv7 --
    def yolo7_setup(self):
        """yolo7 as shipped: YOLOv7-l, nc 20, 640, bf16, decode at conf 0.5,
        IoU 0.3, max_det 100, K 4096; the algorithm on the card and its
        seed-0 model."""
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry("yolo7")
        d = cfg.decode
        check(cfg.arch.phi == "l" and cfg.dataset.input_size == 640
              and cfg.num_classes == 20 and cfg.train.mixed_precision
              and (d.conf_threshold, d.iou_threshold, d.max_det,
                   d.pre_nms_topk) == (0.5, 0.3, 100, 4096),
              "yolo7 config is not as shipped")
        algo = algo_cls(cfg, device=self.dev)
        return algo, algo.init_variables(seed=0)

    def phase_yolo7_parity(self, algo, model, phase="yolo7_parity"):
        """The f32 forward (TF32 off) of the seed-0 YOLOv7-l at 640, B=2,
        unsharpened, on the card against the CPU: in each map the box rows
        and the objectness and class rows apart, each within
        YOLO7_FWD_REL of its largest value; the same forward with TF32 on,
        reported beside it. Then ``yolov7_loss`` on the CPU's maps, on
        both devices, with 100 GT rows an image (some padded, some off the
        anchors' ratios): num_match equal; simOTA's assignment
        (``simota_assign``) equal but where a GT's slate holds a tie: the
        anchors it takes on one device and not the other costing, on the
        CPU, within SIMOTA_TIE_REL of each other (an equal cost's order
        then rests on an ulp of the card's log); and each term within
        1e-4 relative, the card's taken on the CPU's assignment. The terms
        of each device's own assignment are reported beside them."""
        import copy

        from tpucv_torch.losses.yolov7 import simota_assign, yolov7_loss

        torch = self.torch
        cpu = torch.device("cpu")
        x = torch.from_numpy(np.random.default_rng(3).random(
            (2, 640, 640, 3), dtype=np.float32))
        backends = (torch.backends.cudnn, torch.backends.cuda.matmul)

        def group_errs(got, ref):
            out = {}
            for i, (g, c) in enumerate(zip(got, ref)):
                g = g.float().cpu().unflatten(-1, (model.na, -1))
                c = c.unflatten(-1, (model.na, -1))
                for grp, sl in (("box", slice(0, 4)),
                                ("obj_cls", slice(4, None))):
                    cg = c[..., sl]
                    out[f"P{i + 3}_{grp}"] = float(
                        (g[..., sl] - cg).abs().max() / cg.abs().max())
            return out

        with torch.inference_mode():
            got = model(x.to(self.dev))
            raw = copy.deepcopy(model).to(cpu).to(
                memory_format=torch.contiguous_format)(x)
            for b in backends:
                b.allow_tf32 = True
            try:
                tf32 = model(x.to(self.dev))
            finally:
                for b in backends:
                    b.allow_tf32 = False
        rel, rel_tf32 = group_errs(got, raw), group_errs(tf32, raw)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "yolo7: non-finite maps on the card")
        rng = np.random.default_rng(4)
        cxy = rng.uniform(20, 620, (2, 100, 2))
        wh = rng.uniform(8, 400, (2, 100, 2))
        gt = {"gt_bboxes": torch.from_numpy(np.concatenate(
                  [cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)),
              "gt_labels": torch.from_numpy(rng.integers(0, 20, (2, 100))),
              "gt_mask": torch.from_numpy(rng.random((2, 100)) < 0.3)}
        box_g, obj_g, cls_g = algo.cfg.loss_gains()
        kw = dict(anchors=algo.anchors, strides=algo.strides, nc=algo.nc)

        def loss(dev, assignment=None):
            with torch.inference_mode():
                total, parts = yolov7_loss(
                    [r.to(dev) for r in raw],
                    *(gt[k].to(dev) for k in ("gt_bboxes", "gt_labels",
                                              "gt_mask")),
                    box_gain=box_g, obj_gain=obj_g, cls_gain=cls_g,
                    layer_balance=algo.cfg.loss.layer_balance,
                    assignment=assignment, **kw)
            return {"loss": float(total),
                    **{k: float(v) for k, v in parts.items()}}

        with torch.inference_mode():
            a_cpu, a_card = (
                [t.cpu() for t in simota_assign(
                    [r.to(dev) for r in raw],
                    *(gt[k].to(dev) for k in ("gt_bboxes", "gt_labels",
                                              "gt_mask")), **kw)]
                for dev in (cpu, self.dev))
        ties = simota_ties(a_cpu, a_card)
        c, g = loss(cpu), loss(self.dev)
        g_on_cpu = loss(self.dev, [t.to(self.dev) for t in a_cpu[:2]])
        terms = {k: abs(g_on_cpu[k] - v) / max(abs(v), 1e-12)
                 for k, v in c.items()}
        emit({"phase": phase, "shapes": [list(t.shape) for t in got],
              "forward_max_rel_err": max(rel.values()),
              "forward_rel_err_by_group": rel,
              "forward_tf32_max_rel_err": max(rel_tf32.values()),
              "forward_tf32_rel_err_by_group": rel_tf32,
              "loss_cpu": c, "loss_card_on_cpu_assignment": g_on_cpu,
              "loss_max_rel_err": max(terms.values()),
              "assignment": ties, "loss_card_own_assignment": g})
        check(max(rel.values()) < YOLO7_FWD_REL,
              f"yolo7: the f32 forward on the card differs from the CPU: "
              f"{rel} of each group's largest value")
        check(c["num_match"] == g["num_match"] > 0,
              f"yolo7: num_match card {g['num_match']} against CPU "
              f"{c['num_match']}")
        check(not ties["not_ties"],
              f"yolo7: simOTA parts card from CPU where no costs tie: "
              f"{ties['not_ties']}")
        check(max(terms.values()) <= 1e-4,
              f"yolo7: loss card {g_on_cpu} against CPU {c}, one "
              f"assignment")

    def phase_yolo7_decode(self, algo, model, imgs):
        """``decode_yolov7`` on the card against the CPU on the same raw
        maps of the sharpened model (bf16 autocast, as served): the serve
        images letterboxed to 640 (B=8, K = 4096: the scan) and the first
        two at 128² (K = 1,008: nms_keep on the card, its plain version on
        the CPU; nms_keep's count zeroed just before, read just after):
        valid, classes and scores equal, boxes within 1e-3 px."""
        from tpucv_torch.decode.yolov7 import decode_yolov7
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.preprocess import normalize_images

        torch = self.torch
        d = algo.cfg.decode
        kw = dict(anchors=algo.anchors, strides=algo.strides, nc=algo.nc,
                  conf_threshold=d.conf_threshold,
                  iou_threshold=d.iou_threshold, max_det=d.max_det,
                  pre_nms_topk=d.pre_nms_topk)
        lb = self.letterboxed(algo, imgs[:8])
        small = torch.nn.functional.interpolate(
            lb[:2].permute(0, 3, 1, 2).float(), size=(128, 128),
            mode="area").round().to(torch.uint8).permute(0, 2, 3, 1)
        row = {}
        for tag, x in (("640_K4096_scan", lb), ("128_K1008_nms_keep", small)):
            with torch.inference_mode(), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                raw = model(normalize_images(x.contiguous(), algo.dtype))
            A = sum(r.shape[1] * r.shape[2] * 3 for r in raw)
            nms_keep.launches = 0            # just before the path
            with torch.inference_mode():
                got = decode_yolov7(raw, **kw)
                self.sync()
            launches = nms_keep.launches     # just after
            with torch.inference_mode():
                ref = decode_yolov7([r.cpu() for r in raw], **kw)
            got = [t.cpu() for t in got]
            check(launches == (1 if A <= 1024 else 0),
                  f"yolo7 decode {tag}: nms_keep launched {launches} times")
            check(torch.equal(got[3], ref[3]) and torch.equal(
                got[2][got[3]], ref[2][ref[3]]) and torch.equal(got[1], ref[1]),
                  f"yolo7 decode {tag}: the card's keep set differs from "
                  f"the CPU's")
            err = float((got[0] - ref[0]).abs().max())
            check(err <= 1e-3, f"yolo7 decode {tag}: boxes differ by {err}")
            n = got[3].sum(1).tolist()
            check(min(n) > 0, f"yolo7 decode {tag}: no detections {n}")
            row[tag] = {"B": x.shape[0], "anchors": A,
                        "K": min(A, d.pre_nms_topk), "kept": n,
                        "nms_launches": launches, "box_max_abs_err": err}
        emit({"phase": "yolo7_decode", **row, "keep_sets_equal": True})
        return row["128_K1008_nms_keep"]["nms_launches"]

    def phase_scan_predict(self, name, ckpt, imgs, K, scan, reps=3):
        """``python -m tpucv_torch.predict --model <name>``'s main on the
        serve images (4 JPEGs, a PNG) with the trained run's final weights
        sharpened (yolo7: conf 0.5, K = 4096, the scan; centernet: conf
        0.1, K = 100, the DIoU scan; nms_keep's count zeroed just before,
        read just after, 0; nms_scan's, one launch an image); drawn files
        exist; then ms an image split into decode, letterbox, device (H2D,
        forward, decode, NMS, D2H) with the scan inside it (``scan``: its
        (owner, attribute), synced at both edges), and draw (median of
        ``reps``)."""
        import cv2

        from tpucv_torch import predict as cli
        from tpucv_torch.algorithms import base as base_mod
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        out = ROOT / "saves" / "chip_smoke" / name / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        argv = ["--model", name, "--ckpt", ckpt, "--src", *srcs]
        nms_keep.launches = nms_scan.launches = 0    # just before the path
        t0 = time.perf_counter()
        got = cli.main([*argv, "--dst", str(out / "drawn")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        scan_launches = nms_scan.launches
        check(launches == 0, f"{name} predict: nms_keep launched {launches} "
                             f"times at K={K}")
        check(scan_launches == len(srcs), f"{name} predict: nms_scan "
              f"launched {scan_launches} times for {len(srcs)} images")
        for src, r in zip(srcs, got):
            check(r["saved"] and Path(r["saved"]).is_file(),
                  f"{src}: no drawn file ({r['saved']})")
        n_dets = [len(r["classes"]) for r in got]
        check(min(n_dets) > 0, f"{name}: an image got no detection: {n_dets}")

        cfg, algo_cls, _ = export_from_registry(name)
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        infer = algo.make_predict_infer_fn()
        rec = StageRecorder(self.sync)
        for attr, label in (("read_image", "decode"),
                            ("letter_box", "letterbox"),
                            ("show_detection_results", "draw")):
            rec.wrap(base_mod, attr, label)
        owner, attr = scan
        timed_scan = rec.wrapped(getattr(owner, attr), "scan")

        def synced_scan(*a, **kw):           # the forward's queue drained
            self.sync()
            return timed_scan(*a, **kw)

        rec._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, synced_scan)
        laps = {k: [] for k in ("decode", "letterbox", "device", "draw",
                                "scan")}
        try:
            timed_infer = rec.wrapped(infer, "device")
            for _ in range(reps):
                for src in srcs:
                    rec.events.clear()
                    algo.predict(model, src, infer_fn=timed_infer,
                                 save_dir=str(out / "timed"))
                    ev = {k: (a, z) for k, a, z in rec.events}
                    for k in laps:
                        laps[k].append((ev[k][1] - ev[k][0]) * 1e3)
        finally:
            rec.restore()
        med = {k: float(np.median(v)) for k, v in laps.items()}
        emit({"phase": f"{name}_predict", "images": len(srcs), "K": K,
              "nms_launches": launches, "nms_scan_launches": scan_launches,
              "detections": n_dets,
              "cli_wall_s": wall, "ms_per_image": med,
              "ms_per_image_total": sum(v for k, v in med.items()
                                        if k != "scan"),
              "scan_share_of_device": med["scan"] / med["device"],
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_family_evaluate(self, name, ckpt, K, batch=32, scan=None,
                              decode=None):
        """``python -m tpucv_torch.evaluate --model <name>``'s main on a VOC
        root written here (65 640x480 JPEGs, some objects difficult) with
        the sharpened checkpoint (B=32, conf 0.001; yolo7 at K = 4096: the
        scan, nms_keep's count 0; ssd at K = 1,024: nms_keep, one launch a
        batch): the VOC mAP and its COCO cross-summary, images/s. Then the
        CLI once more with recorders around its own stages
        (``_recorded_evaluate``): ms a full batch split into canvas fill,
        H2D + letterbox + forward + top-k, the NMS (synced at both edges)
        and D2H + records, the COCO cross-summary's COCOeval; every batch's
        NMS equal to the CPU's from the candidates the CLI gave it (at K <=
        1,024 the kernel's plain version). At K <= 1,024, nms_keep on the
        first batch's candidates is then timed against its plain version
        and its bound (``time_kernel``). ``scan``, (owner, attribute) of the
        family's NMS call (default ``ops/nms.py:dispatch_batched_nms``;
        centernet's DIoU scan: ``decode/centernet.py:nms``, K = 100, never
        the kernel). ``decode``, (owner, attribute) of the family's decode
        as its infer fn reads it: when given, every batch's detections of
        the recorded run are held against that decode on the CPU from the
        same raw maps (valid, classes and scores equal, boxes within 1e-3
        px)."""
        import os

        from tpucv_torch import evaluate as cli
        from tpucv_torch.algorithms.base import DetectionAlgorithm
        from tpucv_torch.metrics.coco_map import COCOMeanAP
        from tpucv_torch.ops import nms as nms_mod
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        scan = scan or (nms_mod, "dispatch_batched_nms")
        base = ROOT / "saves" / "chip_smoke" / name / "evaluate"
        root = base / "voc"
        n_img = write_voc_root(root, 65)
        argv = ["--model", name, "--ckpt", ckpt, "--batch-size", str(batch)]
        env_was, cwd = os.environ.get("TPUCV_VOC_ROOT"), os.getcwd()
        os.environ["TPUCV_VOC_ROOT"] = str(root)
        os.chdir(base)
        try:
            nms_keep.launches = nms_scan.launches = 0    # just before
            t0 = time.perf_counter()
            res = cli.main(argv)
            self.sync()
            wall = time.perf_counter() - t0
            launches = nms_keep.launches     # just after
            scan_launches = nms_scan.launches
            decoded = []
            if decode is not None:
                owner, attr = decode
                dec = getattr(owner, attr)

                def dec_rec(raw, **kw):
                    out = dec(raw, **kw)
                    decoded.append((raw, kw, out))
                    return out
                setattr(owner, attr, dec_rec)
            try:
                stages, scans, rec_res = self._recorded_evaluate(
                    cli, argv, DetectionAlgorithm, scan, COCOMeanAP)
            finally:
                if decode is not None:
                    setattr(owner, attr, dec)
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_VOC_ROOT")
            else:
                os.environ["TPUCV_VOC_ROOT"] = env_was
        on_kernel = nms_on_kernel(name, K)
        n_batches = -(-n_img // batch)
        check(launches == (n_batches if on_kernel else 0),
              f"{name} evaluate: nms_keep launched {launches} times for "
              f"{n_batches} batches at K={K}")
        check(scan_launches == (0 if on_kernel else n_batches),
              f"{name} evaluate: nms_scan launched {scan_launches} times for "
              f"{n_batches} batches at K={K}")
        check(np.isfinite(res["mAP"]) and len(res["coco"]) == 12
              and all(np.isfinite(v) for v in res["coco"].values()),
              f"{name} evaluate: {res['mAP']}, {res['coco']}")
        check(rec_res["mAP"] == res["mAP"], "the recorded run's mAP differs")
        kept, loop_ms, per_full_batch = self._scans_equal_cpu(
            scans, stages, n_img, batch, getattr(*scan), K=K)
        box_err = 0.0
        if decode is not None:
            check(len(decoded) == n_batches, f"{name} evaluate: "
                  f"{len(decoded)} decodes for {n_batches} batches")
            for k, (raw, kw, out) in enumerate(decoded):
                ref = dec(raw.cpu(), **kw)
                got = [t.cpu() for t in out]
                eq = self.torch.equal
                check(eq(got[3], ref[3]) and eq(got[2][got[3]], ref[2][ref[3]])
                      and eq(got[1], ref[1]),
                      f"{name} evaluate batch {k}: the card's detections "
                      f"differ from the CPU's decode of the same maps")
                box_err = max(box_err, float(
                    (got[0][got[3]] - ref[0][ref[3]]).abs().max()))
            check(box_err <= 1e-3, f"{name} evaluate: boxes {box_err} px "
                                   f"from the CPU's")
        timed = {}
        if on_kernel:
            off, scores, thr = scans[0][0][:3]
            row = self.time_kernel(off, scores, thr,
                                   f"{name}_evaluate_B{batch}_K{K}")
            timed[f"nms_keep_B{batch}_K{K}"] = {k: row[k] for k in (
                "ms", "build_ms", "walk_ms", "plain_ms", "bound_ms",
                "bound_by", "valid", "kept")}
        nms = "nms_keep" if on_kernel else "scan"

        def named(stage_map):
            return {nms if k == "scan" else k: v for k, v in stage_map.items()}

        emit({"phase": f"{name}_evaluate", "images": n_img, "batch": batch,
              "K": K, "nms": nms, "mAP": res["mAP"], "coco": res["coco"],
              "cli_wall_s": wall, "img_per_s_cli": n_img / wall,
              "nms_keep_launches": launches,
              "nms_scan_launches": scan_launches,
              "kept_per_image": [min(kept), float(np.mean(kept)), max(kept)],
              "recorded_loop_img_per_s": n_img / loop_ms * 1e3,
              "ms_per_full_batch": named(per_full_batch),
              "ms_by_batch": named(stages),
              "nms_share_of_loop": sum(stages["scan"]) / loop_ms,
              "nms_share_of_full_batch": per_full_batch["scan"] / sum(
                  per_full_batch[k] for k in LOOP_STAGES),
              "nms_equals_cpu_batches": len(scans), **timed,
              **({"decode_equals_cpu_batches": len(decoded),
                  "decode_box_max_abs_err_vs_cpu": box_err} if decoded
                 else {}),
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_family_eval_map(self, run, ckpt, phase, K, reps=3):
        """``trainer.evaluate_map`` on a family's run (yolo7, ssd, centernet)
        with the sharpened weights handed over as its EMA (16 synthetic val
        images, B=16, conf 0.01). yolo7 at 640: K = 4096, the scan, and
        centernet: K = 100, the DIoU scan, nms_keep's count 0; ssd: K =
        1,024, nms_keep's count (zeroed just before the call, read just
        after) above 0 and the detections equal to the same call through
        nms_keep's plain version. The VOC mAP@0.5, the trained
        weights unchanged, ms a call (median of ``reps``)."""
        import types

        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference

        torch = self.torch
        trainer = run["trainer"]
        state = trainer.state
        on_kernel = nms_on_kernel(trainer.cfg.model_name, K)
        sharp = CheckPoint.load_pure(ckpt)
        view = types.SimpleNamespace(
            model=state.model,
            ema={n: sharp[n].to(self.dev) for n in state.params})
        live = {k: v.detach().clone() for k, v in
                state.model.state_dict().items()}
        harness = trainer.algorithm._batched_detections
        seen = []

        def recorded(*args, **kw):
            for item in harness(*args, **kw):
                seen.append(item)
                yield item

        trainer.algorithm._batched_detections = recorded
        try:
            nms_keep.launches = 0            # just before the path
            t0 = time.perf_counter()
            res = trainer.evaluate_map(view)
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = nms_keep.launches     # just after
            got, seen[:] = list(seen), []
            if on_kernel:
                was = self._swap_nms_keep(nms_keep_reference)
                try:
                    res_plain = trainer.evaluate_map(view)
                finally:
                    self._swap_nms_keep(was)
                check(res == res_plain, f"{phase}: {res} != {res_plain}")
                for a, b in zip(got, seen):
                    check(a[0] == b[0] and all(
                        np.array_equal(x, y) for x, y in zip(a[1:], b[1:])),
                        f"{phase} image {a[0]}: detections through nms_keep "
                        f"differ from the plain route's")
                check(len(seen) == len(got), f"{phase}: {len(seen)} images")
        finally:
            trainer.algorithm._batched_detections = harness
        check(launches > 0 if on_kernel else launches == 0,
              f"{phase}: nms_keep launched {launches} times at K={K}")
        check(set(res) == {"map50"} and np.isfinite(res["map50"]),
              f"{phase} gave {res}")
        check(sum(len(a[3]) for a in got) > 0, f"{phase}: no detection")
        check(all(torch.equal(v, live[k]) for k, v in
                  state.model.state_dict().items()),
              "evaluate_map changed the trained model")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            trainer.evaluate_map(view)
            times.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": phase, "images": len(trainer.val_index),
              "batch": trainer.cfg.train.batch_size, "K": K,
              "result": res, "nms_launches": launches,
              "plain_route_equal": on_kernel,
              "first_call_ms": first_ms,
              "ms_per_call": float(np.median(times)), "ms_runs": times})
        return launches

    def phase_family_int8_predict(self, name, ckpt, K, outputs, cos_min):
        """``python -m tpucv_torch.predict --model <name> --int8`` on the
        family's predict phase's 5 images (calibrated on them), beside the
        float run: drawn files, finite detections, nms_keep's count (one an
        image at K <= 1,024; 0 at yolo7's K = 4096, the scan); the share of
        the float run's detections matched (as int8_predict, reported, not
        gated: with the head sharpened an anchor scores 1 or 0 by the sign
        of a logit near 0, and the top-k takes the lowest indices among the
        1s, so the kept set follows every flipped sign). Then the outputs of
        the CLI's int8 model (calibrated again on the same images) against
        the float model's on each image, grouped by the family's
        ``outputs`` (yolo7_int8_outputs, ssd_int8_outputs): each group's
        max relative error and cosine (at least ``cos_min``), the share of
        the float run's live anchors (best class score > conf) live in int8
        too and the best class agreeing on them."""
        from tpucv_torch import predict as cli
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.preprocess import normalize_images
        from tpucv_torch.utils.image_process import letter_box, read_image

        torch = self.torch
        out = ROOT / "saves" / "chip_smoke" / name / "predict"
        srcs = sorted(str(p) for p in out.glob("img*.*"))
        check(len(srcs) == 5, f"{name} predict's images: {srcs}")
        argv = ["--model", name, "--ckpt", ckpt, "--src", *srcs]
        ref = cli.main([*argv, "--dst", str(out / "float")])
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        got = cli.main([*argv, "--int8", "--dst", str(out / "int8")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        check(launches == (len(srcs) if nms_on_kernel(name, K) else 0),
              f"{name} int8 predict: nms_keep launched {launches} times for "
              f"{len(srcs)} images at K={K}")
        check(all(r["saved"] and Path(r["saved"]).is_file() for r in got),
              f"a {name} int8 image was not drawn")
        check(all(np.isfinite(r["boxes"]).all() for r in got)
              and sum(len(r["classes"]) for r in got) > 0,
              f"{name} int8 predict: no finite detections")
        pairs = ([(r["boxes"], r["classes"]) for r in ref],
                 [(r["boxes"], r["classes"]) for r in got])
        cfg, algo_cls, _ = export_from_registry(name)
        algo = algo_cls(cfg, device=self.dev)
        fmodel = algo.init_variables()
        fmodel.load_state_dict(CheckPoint.load_pure(ckpt))
        qmodel = algo.quantize_variables(fmodel, [(p,) for p in srcs],
                                         n_images=len(srcs),
                                         batch_size=len(srcs))
        s_, conf = algo.input_size, cfg.decode.conf_threshold
        errs, live_f, live_both, agree = {}, 0, 0, 0
        for p in srcs:
            x = torch.from_numpy(letter_box(read_image(p), (s_, s_))[0][None])
            with torch.inference_mode(), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                x = normalize_images(x.to(self.dev), algo.dtype)
                groups, scores = outputs(algo, fmodel(x), qmodel(x))
            for key, (f, q) in groups.items():
                f, q = f.float(), q.float()
                errs.setdefault(key, []).append(
                    (float((q - f).abs().max() / f.abs().max()),
                     float((f * q).sum() / (f.norm() * q.norm()))))
            for fs, qs in scores:
                lf, lq = fs.amax(-1) > conf, qs.amax(-1) > conf
                live_f += int(lf.sum())
                live_both += int((lf & lq).sum())
                agree += int((fs.argmax(-1) == qs.argmax(-1))[lf].sum())
        raw = {k: {"max_rel_err": max(r for r, _ in v),
                   "cosine_min": min(c for _, c in v)}
               for k, v in errs.items()}
        cos = min(v["cosine_min"] for v in raw.values())
        raw.update(float_live_anchors=live_f,
                   live_in_int8_share=live_both / max(live_f, 1),
                   class_agree_share=agree / max(live_f, 1))
        check(cos >= cos_min,
              f"{name} int8 outputs part from the float ones: {raw}")
        emit({"phase": f"{name}_int8_predict", "images": len(srcs),
              "raw_maps": raw, "cosine_min": cos,
              "nms_launches": launches, "cli_wall_s": wall,
              "detections_int8": [len(r["classes"]) for r in got],
              "detections_float": [len(r["classes"]) for r in ref],
              "float_matched_share": self.matched_share(*pairs),
              "float_matched_share_any_class": self.matched_share(
                  *pairs, same_class=False)})
        return launches

    # ------------------------------------------------------------- SSD --
    def ssd_setup(self):
        """ssd as shipped: SSD300-VGG16-BN, nc 21 (20 VOC classes and the
        background), 300, bf16, decode at conf 0.7, IoU 0.5, max_det 100,
        K 1,024; the algorithm on the card and its seed-0 model."""
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry("ssd")
        d = cfg.decode
        check(cfg.arch.input_size == cfg.dataset.input_size == 300
              and cfg.num_classes == 21 and cfg.train.mixed_precision
              and cfg.loss.alpha == 0.5
              and (d.conf_threshold, d.iou_threshold, d.max_det,
                   d.pre_nms_topk) == (0.7, 0.5, 100, 1024),
              "ssd config is not as shipped")
        algo = algo_cls(cfg, device=self.dev)
        return algo, algo.init_variables(seed=0)

    def phase_ssd_parity(self, algo, model, phase="ssd_parity"):
        """The f32 forward (TF32 off) of the seed-0 SSD (300, or 512 for the
        ssd512 variant; coordinates scaled with the size) at B=2 on the card
        against the CPU, loc and conf apart, each within SSD_FWD_REL of its
        own largest value; the forward's conv FLOPs and output elements an
        image, counted by hooks on the CPU's run. Then, from the CPU's outputs and 100 GT rows an
        image (some padded), the targets (``assign_ssd_targets``) card
        against CPU: cls and pos bit-equal, loc within 1e-5 of its largest
        value; and the loss (``build_loss``): num_pos equal, each term
        within 1e-5 relative."""
        import copy

        from tpucv_torch.targets.ssd import assign_ssd_targets

        torch = self.torch
        cpu = torch.device("cpu")
        S = algo.input_size
        k = S / 300
        x = torch.from_numpy(np.random.default_rng(3).random(
            (2, S, S, 3), dtype=np.float32))
        work = [0, 0]                  # multiply-adds, output elements

        def count(mod, _, out):
            work[0] += out.numel() * mod.weight[0].numel()
            work[1] += out.numel()

        with torch.inference_mode():
            got = [t.cpu() for t in model(x.to(self.dev))]
            on_cpu = copy.deepcopy(model).to(cpu).to(
                memory_format=torch.contiguous_format)
            hooks = [m.register_forward_hook(count) for m in
                     on_cpu.modules() if isinstance(m, torch.nn.Conv2d)]
            raw = on_cpu(x)
            for h in hooks:
                h.remove()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "ssd: non-finite outputs on the card")
        rel = {k: float((g - c).abs().max() / c.abs().max())
               for k, g, c in zip(("loc", "conf"), got, raw)}
        rng = np.random.default_rng(4)
        cxy = rng.uniform(10 * k, 290 * k, (2, 100, 2))
        wh = rng.uniform(6 * k, 250 * k, (2, 100, 2))
        gt = {"gt_bboxes": torch.from_numpy(np.clip(np.concatenate(
                  [cxy - wh / 2, cxy + wh / 2], -1), 0, S).astype(
                  np.float32)),
              "gt_labels": torch.from_numpy(rng.integers(0, 20, (2, 100))),
              "gt_mask": torch.from_numpy(rng.random((2, 100)) < 0.3)}
        targets, runs = [], []
        for dev, a in ((cpu, type(algo)(algo.cfg, device=cpu)),
                       (self.dev, algo)):
            g = {k: v.to(dev) for k, v in gt.items()}
            with torch.inference_mode():
                targets.append([t.cpu() for t in assign_ssd_targets(
                    g["gt_bboxes"] / float(S), g["gt_labels"], g["gt_mask"],
                    a.priors)])
                total, parts = a.build_loss()([r.to(dev) for r in raw], g)
            runs.append({"loss": float(total),
                         **{k: float(v) for k, v in parts.items()}})
        (cl, cc, cp), (gl, gc, gp) = targets
        loc_err = float((gl - cl).abs().max() / cl.abs().max())
        c, g = runs
        terms = {k: abs(g[k] - v) / max(abs(v), 1e-12) for k, v in c.items()}
        emit({"phase": phase, "shapes": [list(t.shape) for t in got],
              "forward_gflops_per_image": 2 * work[0] / x.shape[0] / 1e9,
              "conv_outputs_per_image": work[1] // x.shape[0],
              "forward_rel_err": rel, "targets_cls_pos_equal":
                  bool(torch.equal(cc, gc) and torch.equal(cp, gp)),
              "targets_positives": int(cp.sum()),
              "targets_loc_rel_err": loc_err,
              "targets_loc_bit_equal": bool(torch.equal(cl, gl)),
              "loss_cpu": c, "loss_card": g,
              "loss_max_rel_err": max(terms.values())})
        check(max(rel.values()) < SSD_FWD_REL,
              f"ssd: the f32 forward on the card differs from the CPU: {rel}")
        check(torch.equal(cc, gc) and torch.equal(cp, gp) and int(cp.sum()),
              "ssd: the targets' cls / pos on the card differ from the CPU's")
        check(loc_err <= 1e-5, f"ssd: target loc card against CPU {loc_err}")
        check(c["num_pos"] == g["num_pos"] > 0,
              f"ssd: num_pos card {g['num_pos']} against CPU {c['num_pos']}")
        check(max(terms.values()) <= 1e-5, f"ssd: loss card {g} against "
                                           f"CPU {c}")

    def phase_ssd_decode(self, algo, model, imgs):
        """``decode_ssd`` on the sharpened model's bf16 outputs for 8 serve
        images letterboxed to 300 (K = 1,024): nms_keep's count zeroed just
        before, read just after (one launch); the same decode with
        nms_keep's plain version in its place on the card, and on the CPU
        from the same outputs: valid, classes and scores equal, boxes
        equal on the card and within 1e-3 px on the CPU. Then the SSD cases
        of ops/nms_cases.py (K = 1,024 at B = 1, 8, 32, class offsets up to
        19 x 7680 px): keep masks and mask words, kernel against plain."""
        from tpucv_torch.decode.ssd import decode_ssd
        from tpucv_torch.ops.cuda_nms import nms_keep, nms_keep_reference
        from tpucv_torch.ops.nms_cases import ssd_cases
        from tpucv_torch.ops.preprocess import normalize_images

        torch = self.torch
        d, a = algo.cfg.decode, algo.cfg.arch
        kw = dict(input_size=a.input_size, conf_threshold=d.conf_threshold,
                  iou_threshold=d.iou_threshold, max_det=d.max_det,
                  pre_nms_topk=d.pre_nms_topk, variances=a.variances)
        lb = self.letterboxed(algo, imgs[:8])
        with torch.inference_mode():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                raw = model(normalize_images(lb, algo.dtype))
            nms_keep.launches = 0            # just before the path
            got = decode_ssd(*raw, algo.priors, **kw)
            self.sync()
            launches = nms_keep.launches     # just after
            was = self._swap_nms_keep(nms_keep_reference)
            try:
                plain = decode_ssd(*raw, algo.priors, **kw)
            finally:
                self._swap_nms_keep(was)
            ref = decode_ssd(*(r.cpu() for r in raw), algo.priors.cpu(), **kw)
        check(launches == 1, f"ssd decode: nms_keep launched {launches} "
                             f"times for one batch")
        check(all(torch.equal(g, p) for g, p in zip(got, plain)),
              "ssd decode: nms_keep's detections differ from the plain "
              "route's on the card")
        got = [t.cpu() for t in got]
        check(torch.equal(got[3], ref[3]) and torch.equal(
            got[2][got[3]], ref[2][ref[3]]) and torch.equal(got[1], ref[1]),
              "ssd decode: the card's keep set differs from the CPU's")
        err = float((got[0] - ref[0]).abs().max())
        check(err <= 1e-3, f"ssd decode: boxes differ by {err}")
        n = got[3].sum(1).tolist()
        check(min(n) > 0, f"ssd decode: no detections {n}")
        cases = {}
        for name, ((b, sc), thr) in ssd_cases().items():
            keep = self.compare_keep(torch.from_numpy(b).to(self.dev),
                                     torch.from_numpy(sc).to(self.dev), thr,
                                     name)
            cases[name] = int(keep.sum())
        emit({"phase": "ssd_decode", "B": 8, "anchors": algo.priors.shape[0],
              "K": d.pre_nms_topk, "kept": n, "nms_launches": launches,
              "plain_route_equal": True, "cpu_equal": True,
              "box_max_abs_err_vs_cpu": err, "offset_cases_kept": cases,
              "mismatches": self.mismatches,
              "word_mismatches": self.word_mismatches})
        return launches

    # ------------------------------------------------------- CenterNet --
    def centernet_setup(self):
        """centernet as shipped: CenterNet-DLA34, nc 20, 384, head 256,
        downsample 4, bf16, decode K 100, conf 0.1, DIoU NMS at IoU 0.5;
        the algorithm on the card and its seed-0 model."""
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry("centernet")
        d, a = cfg.decode, cfg.arch
        check(cfg.dataset.input_size == a.input_size == 384
              and (a.backbone, a.downsample, a.head_channels) == (
                  "dla34", 4, 256)
              and cfg.num_classes == 20 and cfg.train.mixed_precision
              and cfg.dataset.max_num_boxes == 30
              and (d.K, d.conf_threshold, d.use_diou_nms,
                   d.iou_threshold) == (100, 0.1, True, 0.5),
              "centernet config is not as shipped")
        algo = algo_cls(cfg, device=self.dev)
        return algo, algo.init_variables(seed=0)

    def phase_centernet_parity(self, algo, model, B_time=16, reps=10):
        """The f32 forward (TF32 off) of the seed-0 CenterNet at B=2, 384²,
        card against CPU: the heatmap, offset and size channels apart, each
        within CENTERNET_FWD_REL of its own largest |value|; the forward's
        work an image counted by hooks on the CPU's run (convs and the
        depthwise transposed convs apart). From the CPU's outputs and 30 GT
        rows an image (some padded), the targets card against CPU (ind,
        mask, wh and reg equal, the heatmap within 1e-6) and the loss terms
        within 1e-5 relative. Then the bf16 ``channels_last`` forward at
        B=``B_time`` timed (CUDA events), and the six DepthwiseUp transposed
        convs (all at factor 2) alone on the inputs that forward gave them:
        their share of it."""
        import copy

        from tpucv_torch.models.centernet import DepthwiseUp
        from tpucv_torch.probes.common import timed
        from tpucv_torch.targets.centernet import build_centernet_targets

        torch = self.torch
        cpu = torch.device("cpu")
        C = algo.nc
        B, S = 2, algo.input_size
        x = torch.from_numpy(np.random.default_rng(3).random(
            (B, S, S, 3), dtype=np.float32))
        work = {"conv": [0, 0], "up": [0, 0]}   # multiply-adds, outputs

        def count(mod, inp, out):
            per = mod.weight[0].numel()
            kind = "up" if isinstance(mod, torch.nn.ConvTranspose2d) \
                else "conv"
            src = inp[0] if kind == "up" else out
            work[kind][0] += src.numel() * per
            work[kind][1] += out.numel()

        with torch.inference_mode():
            got = model(x.to(self.dev)).cpu()
            on_cpu = copy.deepcopy(model).to(cpu).to(
                memory_format=torch.contiguous_format)
            hooks = [m.register_forward_hook(count) for m in on_cpu.modules()
                     if isinstance(m, (torch.nn.Conv2d,
                                       torch.nn.ConvTranspose2d))]
            raw = on_cpu(x)
            for h in hooks:
                h.remove()
        check(bool(torch.isfinite(got).all()),
              "centernet: non-finite outputs on the card")
        parts = {"hm": slice(0, C), "reg": slice(C, C + 2),
                 "wh": slice(C + 2, C + 4)}
        rel = {k: float((got[..., sl] - raw[..., sl]).abs().max()
                        / raw[..., sl].abs().max()) for k, sl in parts.items()}
        rng = np.random.default_rng(4)
        cxy = rng.uniform(10, S - 10, (B, 30, 2))
        wh = rng.uniform(4, S * 0.8, (B, 30, 2))
        gt = {"gt_bboxes": torch.from_numpy(np.clip(np.concatenate(
                  [cxy - wh / 2, cxy + wh / 2], -1), 0, S).astype(
                  np.float32)),
              "gt_labels": torch.from_numpy(rng.integers(0, C, (B, 30))),
              "gt_mask": torch.from_numpy(rng.random((B, 30)) < 0.7)}
        targets, runs = [], []
        for dev, a in ((cpu, type(algo)(algo.cfg, device=cpu)),
                       (self.dev, algo)):
            g = {k: v.to(dev) for k, v in gt.items()}
            with torch.inference_mode():
                targets.append([t.cpu() for t in build_centernet_targets(
                    g["gt_bboxes"], g["gt_labels"], g["gt_mask"], C,
                    a.out_hw, a.down)])
                total, terms = a.build_loss()(raw.to(dev), g)
            runs.append({"loss": float(total),
                         **{k: float(v) for k, v in terms.items()}})
        (ch, *c_rest), (gh, *g_rest) = targets
        hm_err = float((gh - ch).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(c_rest, g_rest))
        c, g = runs
        loss_rel = {k: abs(g[k] - v) / max(abs(v), 1e-12)
                    for k, v in c.items()}

        # the bf16 channels_last forward, and the transposed convs' share
        xb = torch.from_numpy(np.random.default_rng(5).random(
            (B_time, S, S, 3), dtype=np.float32)).to(self.dev)
        ups = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: ups.append((mod, inp[0])))
            for m in model.modules() if isinstance(m, DepthwiseUp)]
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            try:
                model(xb)
            finally:
                for h in hooks:
                    h.remove()
            fwd_ms = timed(lambda: model(xb), reps, self.dev)
            up_ms = timed(lambda: [m(t) for m, t in ups], reps, self.dev)
            fwd_ms2 = timed(lambda: model(xb), reps, self.dev)
        fwd = min(fwd_ms, fwd_ms2)
        emit({"phase": "centernet_parity", "shape": list(got.shape),
              "forward_gflops_per_image": 2 * (work["conv"][0] +
                                               work["up"][0]) / B / 1e9,
              "conv_gflops_per_image": 2 * work["conv"][0] / B / 1e9,
              "depthwise_up_gflops_per_image": 2 * work["up"][0] / B / 1e9,
              "conv_outputs_per_image": work["conv"][1] // B,
              "up_outputs_per_image": work["up"][1] // B,
              "forward_rel_err": rel, "targets_ind_mask_wh_reg_equal": same,
              "targets_heatmap_max_abs_err": hm_err,
              "targets_positives": int(c_rest[3].sum()),
              "loss_cpu": c, "loss_card": g,
              "loss_max_rel_err": max(loss_rel.values()),
              "bf16_forward_B": B_time, "bf16_forward_ms": fwd,
              "bf16_forward_ms_runs": [fwd_ms, fwd_ms2],
              "depthwise_up_ms": up_ms, "depthwise_up_launches": len(ups),
              "depthwise_up_share_of_forward": up_ms / fwd})
        check(max(rel.values()) < CENTERNET_FWD_REL,
              f"centernet: the f32 forward on the card differs from the "
              f"CPU: {rel}")
        check(same and int(c_rest[3].sum()) > 0,
              "centernet: the targets' ind / mask / wh / reg on the card "
              "differ from the CPU's")
        check(hm_err <= 1e-6, f"centernet: target heatmap card against CPU "
                              f"{hm_err}")
        check(max(loss_rel.values()) <= 1e-5,
              f"centernet: loss card {g} against CPU {c}")
        check(len(ups) == 6, f"centernet: {len(ups)} DepthwiseUp ran")

    def phase_centernet_decode(self, algo, model, imgs, reps=5):
        """``decode_centernet`` on the sharpened model's bf16 outputs for 8
        serve images letterboxed to 384 (K = 100, conf 0.1, DIoU NMS by the
        scan): nms_keep's count zeroed just before, read just after (0), and
        nms_scan's (1); the same decode on the CPU from the same maps:
        valid, classes, scores and the scan's keep indices equal, boxes
        within 1e-3 px. Then the decode's and the scan's ms on the card,
        each synced at both edges (median of ``reps``)."""
        from tpucv_torch.decode import centernet as cdec
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan
        from tpucv_torch.ops.preprocess import normalize_images

        torch = self.torch
        d = algo.cfg.decode
        kw = dict(num_classes=algo.nc, downsample=algo.down, K=d.K,
                  conf_threshold=d.conf_threshold,
                  use_diou_nms=d.use_diou_nms, iou_threshold=d.iou_threshold)
        lb = self.letterboxed(algo, imgs[:8])
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            raw = model(normalize_images(lb, algo.dtype))
        nms, scans = cdec.nms, []

        def recorded(*a, **k):
            out = nms(*a, **k)
            scans.append((a, k, out))
            return out

        cdec.nms = recorded
        try:
            with torch.inference_mode():
                nms_keep.launches = nms_scan.launches = 0    # just before
                got = cdec.decode_centernet(raw, **kw)
                self.sync()
                launches = nms_keep.launches     # just after
                scan_launches = nms_scan.launches
                ref = cdec.decode_centernet(raw.cpu(), **kw)
        finally:
            cdec.nms = nms
        check(launches == 0, f"centernet decode: nms_keep launched "
                             f"{launches} times")
        check(scan_launches == 1, f"centernet decode: nms_scan launched "
                                  f"{scan_launches} times")
        got = [t.cpu() for t in got]
        (args, k, (g_idx, g_valid)), (_, _, (c_idx, c_valid)) = scans
        check(torch.equal(got[3], ref[3]) and torch.equal(
            got[2][got[3]], ref[2][ref[3]]) and torch.equal(got[1], ref[1])
              and torch.equal(g_idx.cpu(), c_idx)
              and torch.equal(g_valid.cpu(), c_valid),
              "centernet decode: the card's keep set differs from the CPU's")
        err = float((got[0][got[3]] - ref[0][ref[3]]).abs().max())
        check(err <= 1e-3, f"centernet decode: boxes differ by {err}")
        n = got[3].sum(1).tolist()
        check(min(n) > 0, f"centernet decode: no detections {n}")
        live = int((args[1] > 0).sum(1).min())

        def synced_ms(fn):
            laps = []
            with torch.inference_mode():
                for _ in range(reps + 1):
                    self.sync()
                    t0 = time.perf_counter()
                    fn()
                    self.sync()
                    laps.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(laps[1:]))

        decode_ms = synced_ms(lambda: cdec.decode_centernet(raw, **kw))
        scan_ms = synced_ms(lambda: nms(*args, **k))
        emit({"phase": "centernet_decode", "B": 8, "map": list(raw.shape),
              "K": d.K, "kept": n, "scan_live_candidates_min": live,
              "nms_launches": launches, "nms_scan_launches": scan_launches,
              "cpu_equal": True,
              "box_max_abs_err_vs_cpu": err, "decode_ms": decode_ms,
              "scan_ms": scan_ms, "scan_share_of_decode": scan_ms / decode_ms,
              "nvidia_smi": nvidia_smi()})
        return launches

    # ------------------------------------------------------- DeepLabV3+ --
    def deeplab_setup(self):
        """deeplabv3plus as shipped: DeepLabV3+-ResNet101, output stride
        16, nc 21, 513² crops, focal loss (alpha 0.25, gamma 2, ignore
        255), Adam 7e-4 with 1,000 warmup steps, B=16, bf16; the algorithm
        on the card and its seed-0 model."""
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry("deeplabv3plus")
        a, l, o, t = cfg.arch, cfg.loss, cfg.optimizer, cfg.train
        check((a.backbone, a.output_stride, a.crop_size, cfg.num_classes)
              == ("resnet101", 16, 513, 21)
              and (l.name, l.alpha, l.gamma, l.ignore_index)
              == ("focal", 0.25, 2.0, 255)
              and (o.lr, o.warmup_iters, o.milestones) == (7e-4, 1000,
                                                           (60, 80))
              and t.batch_size == 16 and t.mixed_precision,
              "deeplabv3plus config is not as shipped")
        algo = algo_cls(cfg, device=self.dev)
        return algo, algo.init_variables(seed=0)

    def phase_deeplab_parity(self, algo, model, B_time=16, reps=5):
        """The f32 forward (TF32 off) of the seed-0 DeepLab at B=2, 513²,
        card against CPU: the logits within DEEPLAB_FWD_REL of their largest
        |value|; its convolutions' work an image counted by hooks
        (``bench.conv_flops``). From the CPU's logits and labels drawn with
        a tenth of the pixels ignored: the focal loss card against CPU
        within 1e-5 relative, and the confusion matrix of the CPU's argmax
        card against CPU, equal. Then in bf16 (channels_last, autocast) at
        B=16: the forward's ms, and each of ASPP's three dilated 3x3 convs
        alone (cuDNN through F.conv2d on its captured input) against its
        bound and against the same conv undilated."""
        import copy

        import torch.nn.functional as F

        from tpucv_torch.bench import conv_flops
        from tpucv_torch.metrics.seg_metrics import confusion_matrix
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import (H100_BF16_FLOPS,
                                               H100_HBM_BYTES_PER_S, timed)

        torch = self.torch
        cpu = torch.device("cpu")
        S, nc = algo.cfg.arch.crop_size, algo.nc
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.normal(0, 1, (2, S, S, 3)).astype(
            np.float32))
        nms_keep.launches = 0
        cpu_model = copy.deepcopy(model).to(
            cpu, memory_format=torch.contiguous_format)
        with torch.inference_mode():
            ref = cpu_model(x)
            got = model(x.to(self.dev)).cpu()
        del cpu_model
        check(bool(torch.isfinite(got).all()), "deeplab: non-finite logits")
        rel = float((got - ref).abs().max() / ref.abs().max())
        check(rel <= DEEPLAB_FWD_REL, f"deeplab: the f32 forward on the card "
                                      f"differs from the CPU by {rel}")
        flops = conv_flops(model, S, self.dev)
        labels = rng.integers(0, nc, (2, S, S)).astype(np.int32)
        labels[rng.random((2, S, S)) < 0.1] = 255
        labels = torch.from_numpy(labels)
        loss_fn = algo.build_loss()
        lc = float(loss_fn(ref, {"labels": labels})[0])
        lg = float(loss_fn(ref.to(self.dev), {"labels": labels.to(
            self.dev)})[0])
        check(abs(lg - lc) <= 1e-5 * abs(lc),
              f"deeplab: focal loss card {lg} against CPU {lc}")
        pred = ref.argmax(1).to(torch.int32)
        hc = confusion_matrix(pred, labels, nc)
        hg = confusion_matrix(pred.to(self.dev), labels.to(self.dev),
                              nc).cpu()
        check(torch.equal(hc, hg), "deeplab: the confusion matrix on the "
                                   "card differs from the CPU's")

        xb = torch.rand((B_time, S, S, 3), device=self.dev)
        aspp = model.classifier.aspp.convs
        seen = {}
        hooks = [aspp[i][0].register_forward_pre_hook(
            lambda mod, inp, i=i: seen.setdefault(i, inp[0]))
            for i in (1, 2, 3)]
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            model(xb)
            for h in hooks:
                h.remove()
            fwd_ms = timed(lambda: model(xb), reps, self.dev)
            dilated = {}
            for i in (1, 2, 3):
                c, xi = aspp[i][0], seen[i]
                w = c.weight.to(torch.bfloat16)
                y = F.conv2d(xi, w, None, 1, c.padding, c.dilation)
                ms = timed(lambda: F.conv2d(xi, w, None, 1, c.padding,
                                            c.dilation), 4 * reps, self.dev)
                ms1 = timed(lambda: F.conv2d(xi, w, None, 1, 1, 1),
                            4 * reps, self.dev)
                ops = 2 * w.numel() * y.shape[0] * y.shape[2] * y.shape[3]
                nbytes = 2 * (xi.numel() + w.numel() + y.numel())
                t_ops = ops / H100_BF16_FLOPS * 1e3
                t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
                dilated[f"rate_{c.dilation[0]}"] = {
                    "shape": list(xi.shape), "ms": ms,
                    "ms_undilated": ms1, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes", "tflops": ops / ms / 1e9,
                    "share_of_bound": max(t_ops, t_bytes) / ms}
        launches = nms_keep.launches
        check(launches == 0, f"deeplab_parity: nms_keep launched {launches}")
        emit({"phase": "deeplab_parity", "size": S, "batch": 2,
              "forward_max_rel_err": rel,
              "conv_gflops_per_image": flops / 1e9,
              "focal_loss_cpu": lc, "focal_loss_card": lg,
              "histogram_equal": True, "histogram_pixels": int(hc.sum()),
              "bf16_forward_ms_B16": fwd_ms,
              "bf16_forward_img_per_s": B_time / fwd_ms * 1e3,
              "bf16_forward_tflops": flops * B_time / fwd_ms / 1e9,
              "aspp_dilated_convs_B16": dilated,
              "nms_keep_launches": launches, "nvidia_smi": nvidia_smi()})
        return launches

    def phase_deeplab_step(self, n=3):
        """Whether DeepLab's train step is device- or host-bound
        (``probes.train_step.measure`` at the shipped B=16, 513², bf16, on
        a device-resident batch): the step's ms (CUDA events), its
        kernels' ms (profiler), the host's ms to launch one step from an
        idle device, its launches, syncs and copies; device-bound when
        the kernels fill 90% of the step."""
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes import train_step

        nms_keep.launches = 0
        row = train_step.measure("deeplabv3plus", self.dev, 16, None, n)
        launches = nms_keep.launches
        busy = (row["kernel_ms"] or 0.0) / row["step_ms"]
        emit({"phase": "deeplab_step", **row, "busy_share": busy,
              "bound": "device" if busy >= 0.9 else "host",
              "host_share_from_idle": row["host_ms_from_idle"]
              / row["step_ms"], "nms_keep_launches": launches,
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_deeplab_predict(self, ckpt, imgs, reps=3):
        """``python -m tpucv_torch.predict --model deeplabv3plus``'s main on
        the serve images (4 JPEGs, a PNG) with the trainer's final weights
        (nms_keep's count zeroed just before, read just after: 0, no NMS):
        drawn files, class maps of 513², overlays of each image's size;
        then ms an image by stage (median of ``reps``): decode, the host
        resize to 513², the device (H2D, forward, argmax) and the colour
        map, nearest resize back, blend and JPEG write."""
        import cv2

        from tpucv_torch import predict as cli
        from tpucv_torch.algorithms import segmentation_2d as seg_mod
        from tpucv_torch.builder import export_from_registry
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep

        name = "deeplabv3plus"
        out = ROOT / "saves" / "chip_smoke" / name / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        got = cli.main(["--model", name, "--ckpt", ckpt, "--src", *srcs,
                        "--dst", str(out / "drawn")])
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        check(launches == 0, f"deeplab predict: nms_keep launched {launches}")
        for src, r, img in zip(srcs, got, imgs):
            check(r["saved"] and Path(r["saved"]).is_file()
                  and r["class_map"].shape == (513, 513)
                  and r["overlay"].shape == img.shape,
                  f"{src}: {r['saved']}, {r['class_map'].shape}")

        cfg, algo_cls, _ = export_from_registry(name)
        algo = algo_cls(cfg, device=self.dev)
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        rec = StageRecorder(self.sync)
        rec.wrap(seg_mod, "read_image", "decode")
        rec.wrap(seg_mod.DeeplabV3PlusA, "_resized", "resize")
        infer = rec.wrapped(algo.make_predict_infer_fn(), "device")
        laps = {k: [] for k in ("decode", "resize", "device",
                                "colour_blend_write")}
        try:
            for _ in range(reps):
                for src in srcs:
                    rec.events.clear()
                    t0 = time.perf_counter()
                    algo.predict(model, src, infer_fn=infer,
                                 save_dir=str(out / "timed"))
                    total = (time.perf_counter() - t0) * 1e3
                    ev = {k: (z - a) * 1e3 for k, a, z in rec.events}
                    for k in ("decode", "resize", "device"):
                        laps[k].append(ev[k])
                    laps["colour_blend_write"].append(
                        total - sum(ev.values()))
        finally:
            rec.restore()
        med = {k: float(np.median(v)) for k, v in laps.items()}
        emit({"phase": "deeplab_predict", "images": len(srcs),
              "nms_keep_launches": launches, "cli_wall_s": wall,
              "classes_per_image": [int(len(np.unique(r["class_map"])))
                                    for r in got],
              "ms_per_image": med, "ms_per_image_total": sum(med.values()),
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_deeplab_evaluate(self, ckpt, batch=32):
        """``python -m tpucv_torch.evaluate --model deeplabv3plus``'s main
        on a VOC segmentation root written here (65 640x480 JPEGs, colour
        PNGs whose objects are bordered in VOC's 255 boundary colour) with
        the trainer's final weights, B=32 (nms_keep's count 0): mIoU and
        accuracies, images/s of the CLI and of its evaluation loop alone;
        every batch's class map and labels recorded at
        ``SegmentationMetrics.update`` (a copy to the host a batch, inside
        the CLI's time), and the histogram the card accumulated equal to
        the one the CPU makes from them. Then the CLI again with
        ``--int8`` (calibrated on the first 8 images)."""
        import os

        from tpucv_torch import evaluate as cli
        from tpucv_torch.algorithms import segmentation_2d as seg_mod
        from tpucv_torch.metrics import seg_metrics
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        base = ROOT / "saves" / "chip_smoke" / "deeplabv3plus" / "evaluate"
        root = base / "voc"
        n_img, ignored = write_voc_seg_root(root, 65)
        argv = ["--model", "deeplabv3plus", "--ckpt", ckpt, "--batch-size",
                str(batch)]
        recorded, hists = [], []
        real_update = seg_metrics.SegmentationMetrics.update

        def update(metrics, pred, label):
            recorded.append((pred.cpu(), label.cpu()))
            real_update(metrics, pred, label)
            hists.append(metrics.hist.copy())

        rec = StageRecorder(self.sync)
        env_was, cwd = os.environ.get("TPUCV_VOC_ROOT"), os.getcwd()
        os.environ["TPUCV_VOC_ROOT"] = str(root)
        os.chdir(base)
        try:
            seg_metrics.SegmentationMetrics.update = update
            rec.wrap(seg_mod.DeeplabV3PlusA, "evaluate_on_voc", "loop")
            try:
                nms_keep.launches = 0        # just before the path
                t0 = time.perf_counter()
                res = cli.main(argv)
                self.sync()
                wall = time.perf_counter() - t0
                launches = nms_keep.launches     # just after
            finally:
                rec.restore()
                seg_metrics.SegmentationMetrics.update = real_update
            nms_keep.launches = 0
            t0 = time.perf_counter()
            res_q = cli.main([*argv, "--int8"])
            self.sync()
            wall_q = time.perf_counter() - t0
            launches += nms_keep.launches
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_VOC_ROOT")
            else:
                os.environ["TPUCV_VOC_ROOT"] = env_was
        check(launches == 0, f"deeplab evaluate: nms_keep launched {launches}")
        keys = ("overall_acc", "mean_acc", "freq_weighted_acc", "mIoU")
        check(all(np.isfinite(r[k]) for r in (res, res_q) for k in keys),
              f"deeplab evaluate: {res}, int8 {res_q}")
        check(len(recorded) == -(-n_img // batch),
              f"{len(recorded)} recorded batches")
        cpu_hist = sum(seg_metrics.confusion_matrix(p, l, 21)
                       for p, l in recorded).double().numpy()
        check(np.array_equal(hists[-1], cpu_hist),
              "deeplab evaluate: the card's histogram differs from the "
              "CPU's over the same class maps")
        n_ignored = sum(int((l == 255).sum()) for _, l in recorded)
        check(n_ignored > 0 and cpu_hist.sum() + n_ignored
              == n_img * 513 * 513, "deeplab evaluate: ignored pixels "
                                    f"{n_ignored}, counted {cpu_hist.sum()}")
        loop_s = rec.events[0][2] - rec.events[0][1]
        emit({"phase": "deeplab_evaluate", "images": n_img, "batch": batch,
              **{k: res[k] for k in keys},
              "int8": {k: res_q[k] for k in keys},
              "cli_wall_s": wall, "img_per_s_cli": n_img / wall,
              "img_per_s_loop": n_img / loop_s,
              "int8_cli_wall_s": wall_q, "int8_img_per_s_cli": n_img / wall_q,
              "histogram_equals_cpu": True,
              "pixels_counted": int(cpu_hist.sum()),
              "pixels_ignored": n_ignored,
              "boundary_pixels_written": ignored,
              "nms_keep_launches": launches, "nvidia_smi": nvidia_smi()})
        return launches

    def phase_deeplab_eval(self, run, reps=2):
        """The trainer's ``evaluate_loop`` on the run's state (its 8 steps
        and the trainer phase's 16 timing steps; 8 synthetic val images,
        B=16): val_mIoU and val_acc finite, ms a call."""
        from tpucv_torch.ops.cuda_nms import nms_keep

        trainer = run["trainer"]
        nms_keep.launches = 0
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            val = trainer.evaluate_loop(trainer.state)
            self.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = nms_keep.launches
        check(sorted(val) == ["val_acc", "val_mIoU"]
              and all(np.isfinite(v) for v in val.values())
              and launches == 0, f"deeplab evaluate_loop: {val}, "
                                 f"{launches} nms_keep launches")
        emit({"phase": "deeplab_eval", **val, "ms": float(np.median(ms)),
              "images": len(trainer.val_loader.ds),
              "nms_keep_launches": launches})
        return launches

    def phase_deeplab_int8(self, algo, ckpt, imgs):
        """The trainer's final weights quantized by ``quantize_variables``
        on 8 of the smoke's images (B=2): DEEPLAB_QUANTIZED convs, the
        float model left float; one batch of 2 (resized to 513² as predict
        does) through the int8 model with every quantized conv's input
        captured: the card route's int32 accumulators (im2col +
        ``torch._int_mm``) bit-equal to the plain route's, the dilated 3x3s
        and the pool branch's 1x1 on a 1x1 map among them. The int8
        logits against the float model's: max relative error within
        tpucv's bar (DEEPLAB_INT8_REL), cosine and the share of pixels
        whose class agrees. Then the predict CLI with ``--int8`` on
        deeplab_predict's 5 images: drawn files."""
        from tpucv_torch import predict as cli
        from tpucv_torch import quant
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops import int8_conv
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.preprocess import (imagenet_normalize,
                                                normalize_images)

        torch = self.torch
        nms_keep.launches = 0
        model = algo.init_variables()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        t0 = time.perf_counter()
        q = algo.quantize_variables(model, [(im,) for im in imgs[:8]],
                                    n_images=8, batch_size=2)
        self.sync()
        calib_s = time.perf_counter() - t0
        n_q = quant.count_quantized(q)
        check(n_q == DEEPLAB_QUANTIZED and quant.count_quantized(model) == 0,
              f"deeplab: {n_q} quantized convs, not {DEEPLAB_QUANTIZED}")
        u8 = torch.from_numpy(np.stack([algo._resized(im)
                                        for im in imgs[:2]])).to(self.dev)
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, inp, n=n: seen.append((n, mod, inp[0])))
            for n, m in quant.hooked(q) if m.qweight is not None]
        try:
            with torch.inference_mode(), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                x = imagenet_normalize(normalize_images(u8, algo.dtype))
                qy = q(x)
        finally:
            for h in hooks:
                h.remove()
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            fy = model(x)
        check(len(seen) == n_q, f"deeplab: {len(seen)} of {n_q} quantized "
                                f"convs ran")
        dilated, peak = 0, 0
        with torch.inference_mode():
            for n, m, xi in seen:
                c = m.conv
                geom = (c.kernel_size, c.stride, c.padding, c.dilation,
                        c.groups)
                xq = quant.quantize_activation(xi, m.xscale)
                card = int8_conv.conv_gemm(xq, m.qweight, *geom)
                plain = int8_conv.conv_plain(xq, m.qweight, *geom)
                self.sync()
                bad = int((card != plain).sum())
                check(bad == 0, f"deeplab {n}: {bad} int32 accumulators of "
                                f"the card route differ from the plain one")
                peak = max(peak, int(plain.abs().max()))
                dilated += c.dilation[0] > 1
        check(dilated == 5, f"deeplab: {dilated} dilated quantized convs")
        fy, qy = fy.float(), qy.float()
        rel = float((qy - fy).abs().max() / fy.abs().max())
        cos = float((fy * qy).sum() / (fy.norm() * qy.norm()))
        agree = float((fy.argmax(1) == qy.argmax(1)).float().mean())
        check(rel <= DEEPLAB_INT8_REL, f"deeplab int8 logits {rel} of the "
                                       f"largest from the float ones")
        out = ROOT / "saves" / "chip_smoke" / "deeplabv3plus" / "predict"
        srcs = sorted(str(p) for p in out.glob("img*.*"))
        got = cli.main(["--model", "deeplabv3plus", "--ckpt", ckpt, "--int8",
                        "--src", *srcs, "--dst", str(out / "int8")])
        check(len(got) == 5 and all(r["saved"] and Path(r["saved"]).is_file()
                                    for r in got),
              "a deeplab int8 image was not drawn")
        launches = nms_keep.launches
        check(launches == 0, f"deeplab int8: nms_keep launched {launches}")
        emit({"phase": "deeplab_int8", "count_quantized": n_q,
              "convs_compared": len(seen), "accumulators_bit_equal": True,
              "dilated_convs": dilated, "max_abs_accumulator": peak,
              "calibrate_s": calib_s, "logits_max_rel_err": rel,
              "logits_cosine": cos, "class_agree_share": agree,
              "predict_int8_images": len(got), "nms_keep_launches": launches})
        return launches

    def phase_deeplab_bench(self):
        """``python -m tpucv_torch.bench --model deeplabv3plus``'s main:
        tpucv's ``bench_family`` line (inference B=32, training B=16, at
        513², bf16), finite, with nms_keep's count (0)."""
        from tpucv_torch import bench
        from tpucv_torch.ops.cuda_nms import nms_keep

        nms_keep.launches = 0
        line = bench.main(["--model", "deeplabv3plus"])
        launches = nms_keep.launches
        check(line["metric"] ==
              "deeplabv3plus_513_e2e_images_per_sec_per_chip"
              and (line["infer_batch"], line["train_batch"]) == (32, 16)
              and all(np.isfinite(line[k]) for k in (
                  "value", "train_img_per_sec", "train_step_ms")),
              f"deeplab bench: {line}")
        check(launches == 0, f"deeplab bench: nms_keep launched {launches}")
        emit({"phase": "deeplab_bench", "line": line,
              "nms_keep_launches": launches})
        return launches

    # ------------------------------------------------ ViT and YOLOv8-cls
    def cls_setup(self, name, mixed_precision=True):
        """``vit_cls`` / ``yolo8_cls`` as shipped (ViT-S/16: patch 16, dim
        384, depth 12, heads 6; YOLOv8n-cls; nc 10, 224², label smoothing
        0.1, B=16, bf16): the config, checked, and its algorithm class;
        ``mixed_precision`` False turns the config to f32."""
        from tpucv_torch.builder import export_from_registry

        cfg, algo_cls, _ = export_from_registry(name)
        a = cfg.arch
        arch = ((a.patch, a.dim, a.depth, a.heads) == (16, 384, 12, 6)
                if name == "vit_cls" else a.model_type == "n")
        check(arch and cfg.dataset.input_size == 224
              and cfg.num_classes == 10 and cfg.loss.label_smoothing == 0.1
              and cfg.train.batch_size == 16 and cfg.train.mixed_precision,
              f"{name}'s config is not as shipped")
        cfg.train.mixed_precision = mixed_precision
        return cfg, algo_cls

    def phase_cls_parity(self, B_time=64, reps=10):
        """Each family's seed-0 model at 224², f32 (TF32 off), B=2: the
        logits card against CPU within CLS_FWD_REL of their largest
        |value|, the label-smoothed loss (labels from a seed) within 1e-5
        relative and ``acc`` equal; its FLOPs an image
        (``torch.utils.flop_counter``); then the bf16 forward (autocast,
        channels_last) at B=64, timed with CUDA events, and its longest
        kernels (profiler). nms_keep's count 0."""
        import copy

        from torch.utils.flop_counter import FlopCounterMode

        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import H100_BF16_FLOPS, timed

        torch = self.torch
        cpu = torch.device("cpu")
        nms_keep.launches = 0
        row = {}
        for name in CLASSIFIERS:
            cfg, algo_cls = self.cls_setup(name)
            algo = algo_cls(cfg, device=self.dev)
            model = algo.init_variables(seed=0)
            rng = np.random.default_rng(3)
            x = torch.from_numpy(rng.random((2, 224, 224, 3), np.float32))
            labels = torch.from_numpy(
                rng.integers(0, algo.nc, 2).astype(np.int32))
            cpu_model = copy.deepcopy(model).to(
                cpu, memory_format=torch.contiguous_format)
            with torch.inference_mode():
                ref = cpu_model(x)
                got = model(x.to(self.dev)).cpu()
            del cpu_model
            check(bool(torch.isfinite(got).all()) and got.shape == (2, 10),
                  f"{name}: logits {got.shape}, finite "
                  f"{bool(torch.isfinite(got).all())}")
            rel = float((got - ref).abs().max() / ref.abs().max())
            check(rel <= CLS_FWD_REL, f"{name}: the f32 forward on the card "
                                      f"differs from the CPU by {rel}")
            loss_fn = algo.build_loss()
            lc, mc = loss_fn(ref, {"labels": labels})
            lg, mg = loss_fn(ref.to(self.dev), {"labels": labels.to(self.dev)})
            lc, lg = float(lc), float(lg)
            check(abs(lg - lc) <= 1e-5 * abs(lc)
                  and float(mg["acc"]) == float(mc["acc"]),
                  f"{name}: loss card {lg} against CPU {lc}")
            with FlopCounterMode(display=False) as fc, \
                    torch.inference_mode():
                model(x[:1].to(self.dev))
            flops = fc.get_total_flops()
            xb = torch.rand((B_time, 224, 224, 3), device=self.dev)
            with torch.inference_mode(), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                fwd_ms = timed(lambda: model(xb), reps, self.dev)
                top = self._kernels_by_time(lambda: model(xb), 3)
            row[name] = {
                "forward_max_rel_err": rel,
                "max_abs_logit": float(ref.abs().max()),
                "loss_cpu": lc, "loss_card": lg,
                "gflops_per_image": flops / 1e9,
                f"bf16_forward_ms_B{B_time}": fwd_ms,
                "bf16_forward_img_per_s": B_time / fwd_ms * 1e3,
                "bf16_forward_tflops": flops * B_time / fwd_ms / 1e9,
                "share_of_bf16_peak": flops * B_time / fwd_ms * 1e3
                / H100_BF16_FLOPS,
                "bf16_forward_top_kernels_ms": top}
        launches = nms_keep.launches
        check(launches == 0, f"cls_parity: nms_keep launched {launches}")
        emit({"phase": "cls_parity", "size": 224, "batch": 2, **row,
              "nms_keep_launches": launches, "nvidia_smi": nvidia_smi()})
        return launches

    def phase_cls_step(self, n=3):
        """``probes.train_step.measure`` for both families at the shipped
        B=16, 224², bf16, on a device-resident batch: step and kernel ms,
        the host's ms to issue one step from an idle device, launches;
        device-bound when the kernels fill 90% of the step."""
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes import train_step

        nms_keep.launches = 0
        row = {}
        for name in CLASSIFIERS:
            r = train_step.measure(name, self.dev, 16, None, n)
            busy = (r["kernel_ms"] or 0.0) / r["step_ms"]
            row[name] = {**r, "busy_share": busy,
                         "bound": "device" if busy >= 0.9 else "host",
                         "host_share_from_idle": r["host_ms_from_idle"]
                         / r["step_ms"]}
        launches = nms_keep.launches
        check(launches == 0, f"cls_step: nms_keep launched {launches}")
        emit({"phase": "cls_step", **row, "nms_keep_launches": launches,
              "nvidia_smi": nvidia_smi()})
        return launches

    def _kernels_by_time(self, fn, n, top=8):
        """The device's time a call by kernel name (torch.profiler over
        ``n`` calls), the ``top`` longest, names cut to 90 characters, and
        the sum of all under "all"; {} when no device time is recorded."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            self.sync()
        rows = sorted(((e.key[:90], e.self_device_time_total / n / 1e3)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        if not rows:
            return {}
        return {**dict(rows[:top]), "all": sum(ms for _, ms in rows)}

    def _cls_cli(self, cli, name, mixed_precision, argv):
        """The CLI's main with ``name``'s config as shipped, or in f32."""
        was = cli.export_from_registry

        def registry(model_name):
            cfg, algo_cls = self.cls_setup(model_name, mixed_precision)
            return cfg, algo_cls, None

        cli.export_from_registry = registry
        try:
            return cli.main(["--model", name, *argv])
        finally:
            cli.export_from_registry = was

    def _cls_f32_runs(self, cli, name, argv):
        """The CLI's main in f32 on the card and on the CPU, every
        probability row its infer fn returns recorded: (results by device,
        card rows, CPU rows, their largest difference)."""
        from tpucv_torch.algorithms import classification as cls_mod

        real = cls_mod.VitClassification.make_infer_fn
        sink, out = [], {}

        def recording(algo, *a, **kw):
            infer = real(algo, *a, **kw)

            def run(model, u8):
                p = infer(model, u8)
                sink[-1].append(p.cpu().numpy())
                return p
            return run

        cls_mod.VitClassification.make_infer_fn = recording
        try:
            for dev in ("cuda", "cpu"):
                sink.append([])
                out[dev] = self._cls_cli(cli, name, False,
                                         [*argv, "--device", dev])
        finally:
            cls_mod.VitClassification.make_infer_fn = real
        pg, pc = (np.concatenate(r) for r in sink)
        err = float(np.abs(pg - pc).max())
        check(err <= CLS_PROB_ATOL, f"{name}: f32 probabilities card against "
                                    f"CPU {err}")
        return out, pg, pc, err

    @staticmethod
    def _clear_rows(pc, pg, ranks):
        """Rows whose ranks 0..``ranks`` must order alike in both engines:
        with every log-probability within ``d`` of the other engine's
        (``d`` the largest difference), two classes whose CPU
        log-probabilities are more than 2 ``d`` apart keep their order.
        Returns (the rows, ``d``)."""
        lc, lg = (np.log(np.maximum(p, np.float32(1e-38))) for p in (pc, pg))
        d = float(np.abs(lc - lg).max())
        top = -np.sort(-lc, -1)[:, :ranks + 1]
        return (-np.diff(top, axis=-1)).min(-1) > 2 * d, d

    def cls_trained(self, runs, steps=48, lr=1e-4):
        """Each run's final weights trained on for ``steps`` steps (12
        epochs) at a constant Adam ``lr`` on its trainer's synthetic set,
        as shipped otherwise (bf16, B=16): the shipped warmup holds the
        rate near 1e-6 for 1,000 steps, so after the trainer's 8 the output
        hardly depends on the image and predict and evaluate would rank
        near-ties. Saved as ``trained.ckpt`` beside the run; the loss and
        acc of the first and last epochs."""
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.train.state import TrainState, make_train_step

        ckpts, row = {}, {}
        for name in CLASSIFIERS:
            trainer = runs[name]["trainer"]
            cfg, algo_cls = self.cls_setup(name)
            algo = algo_cls(cfg, device=self.dev)
            model = algo.init_variables()
            model.load_state_dict(CheckPoint.load_pure(
                runs[name]["final_path"]))
            state = TrainState.create(model, lr)
            step = make_train_step(algo.build_loss(), device=self.dev,
                                   mixed_precision=True)
            logged, epoch = [], 0
            t0 = time.perf_counter()
            while state.step < steps:
                trainer.train_loader.set_epoch(100 + epoch)
                epoch += 1
                for batch in trainer.train_loader:
                    state, m = step(state, trainer.device_batch(batch, True))
                    logged.append(trainer._read_metrics(m))
                    if state.step >= steps:
                        break
            self.sync()
            n = len(trainer.train_loader)
            first, last = ({k: float(np.mean([r[k] for r in part]))
                            for k in ("loss", "acc")}
                           for part in (logged[:n], logged[-n:]))
            check(all(np.isfinite(v) for r in logged for v in r.values()),
                  f"{name}: non-finite loss in the extra steps")
            ckpts[name] = CheckPoint.save_pure(
                state.model, str(Path(runs[name]["final_path"]).parent /
                                 "trained.ckpt"))
            row[name] = {"steps": steps, "lr": lr, "epochs": epoch,
                         "seconds": time.perf_counter() - t0,
                         "first_epoch": first, "last_epoch": last}
        emit({"phase": "cls_trained", **row})
        return ckpts

    def phase_cls_predict(self, ckpts, imgs, reps=3):
        """``python -m tpucv_torch.predict``'s main on the serve images (4
        JPEGs, a PNG) with each ``cls_trained`` checkpoint, as shipped (bf16;
        nms_keep's count zeroed just before, read just after: 0); the same
        CLI in f32 on the card and on the CPU: every probability within
        CLS_PROB_ATOL, the printed top-3 labels equal on every image whose
        ranks 0-3 cannot reorder (``_clear_rows``; at least 3 of 5); the
        shipped top-1 against the CPU's f32; ``--int8`` refused. Then ms
        an image by stage (median of ``reps``): decode, the host resize to
        224², the device (H2D, forward, softmax, D2H) and the top-k."""
        import cv2

        from tpucv_torch import predict as cli
        from tpucv_torch.algorithms import classification as cls_mod
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep

        out = ROOT / "saves" / "chip_smoke" / "cls" / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        row, total_launches = {}, 0
        for name in CLASSIFIERS:
            ckpt = ckpts[name]
            nms_keep.launches = 0                # just before the path
            t0 = time.perf_counter()
            got = self._cls_cli(cli, name, True,
                                ["--ckpt", ckpt, "--src", *srcs])
            wall = time.perf_counter() - t0
            launches = nms_keep.launches         # just after
            total_launches += launches
            check(launches == 0 and len(got) == 5
                  and all(len(r["labels"]) == 5 and r["boxes"].shape ==
                          (0, 4) for r in got),
                  f"{name} predict: {launches} nms_keep launches, "
                  f"{[r['labels'] for r in got]}")
            f32, pg, pc, err = self._cls_f32_runs(
                cli, name, ["--ckpt", ckpt, "--src", *srcs])
            clear, d = self._clear_rows(pc, pg, 3)
            check(clear.sum() >= 3, f"{name}: {int(clear.sum())} of 5 "
                                    f"images clear of near-ties")
            for j in np.flatnonzero(clear):
                g, c = f32["cuda"][j]["labels"][:3], f32["cpu"][j]["labels"][:3]
                check(g == c, f"{name}: printed labels card {g} CPU {c}")
            top1_agree = float(np.mean([a["labels"][0] == c["labels"][0]
                                        for a, c in zip(got, f32["cpu"])]))
            try:
                self._cls_cli(cli, name, True, ["--int8", "--src", srcs[0]])
                check(False, f"{name}: predict --int8 was not refused")
            except SystemExit as e:
                check("not supported" in str(e), f"{name}: {e}")

            cfg, algo_cls = self.cls_setup(name)
            algo = algo_cls(cfg, device=self.dev)
            model = algo.init_variables()
            model.load_state_dict(CheckPoint.load_pure(ckpt))
            rec = StageRecorder(self.sync)
            rec.wrap(cls_mod, "read_image", "decode")
            rec.wrap(cls_mod.VitClassification, "_resized", "resize")
            infer = rec.wrapped(algo.make_predict_infer_fn(), "device")
            laps = {k: [] for k in ("decode", "resize", "device", "topk")}
            try:
                for _ in range(reps):
                    for src in srcs:
                        rec.events.clear()
                        t0 = time.perf_counter()
                        algo.predict(model, src, infer_fn=infer)
                        total = (time.perf_counter() - t0) * 1e3
                        ev = {k: (z - a) * 1e3 for k, a, z in rec.events}
                        for k in ("decode", "resize", "device"):
                            laps[k].append(ev[k])
                        laps["topk"].append(total - sum(ev.values()))
            finally:
                rec.restore()
            med = {k: float(np.median(v)) for k, v in laps.items()}
            row[name] = {"cli_wall_s": wall,
                         "labels": [r["labels"][:3] for r in got],
                         "f32_prob_max_abs_err": err,
                         "f32_logprob_max_abs_err": d,
                         "f32_images_compared": int(clear.sum()),
                         "top1_bf16_agrees_cpu_f32": top1_agree,
                         "ms_per_image": med,
                         "ms_per_image_total": sum(med.values())}
        emit({"phase": "cls_predict", "images": len(srcs), **row,
              "int8_refused": True, "nms_keep_launches": total_launches,
              "nvidia_smi": nvidia_smi()})
        return total_launches

    def phase_cls_evaluate(self, ckpts, batch=64, n_img=80):
        """``python -m tpucv_torch.evaluate``'s main on a folder-per-class
        root written here (``val/c{k}/``: 80 224² JPEGs of
        ``SyntheticClsIndex``, 8 a class, nc 10) with each ``cls_trained``
        checkpoint, B=64 (a full batch and a zero-filled one): top-1 / top-5
        as shipped (bf16), images/s of the CLI and of its loop alone
        (nms_keep's count 0); the same CLI in f32 on the card and on the
        CPU, every probability recorded: within CLS_PROB_ATOL, each image's
        top-1 / top-5 hit equal wherever its ranks 0-5 cannot reorder
        (``_clear_rows``; at least half the images), and the two CLIs'
        top-1 / top-5 equal when every image is; ``--int8`` refused."""
        import os

        import cv2

        from tpucv_torch import evaluate as cli
        from tpucv_torch.algorithms import classification as cls_mod
        from tpucv_torch.data.classification_dataset import SyntheticClsIndex
        from tpucv_torch.ops.cuda_nms import nms_keep

        base = ROOT / "saves" / "chip_smoke" / "cls" / "evaluate"
        src = SyntheticClsIndex(n_img, 224, 10, seed=3)
        for i in range(n_img):
            img, k = src[i]
            d = base / "root" / "val" / f"c{k}"
            d.mkdir(parents=True, exist_ok=True)
            check(cv2.imwrite(str(d / f"{i:03d}.jpg"),
                              cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write image {i}")
        env_was, cwd = os.environ.get("TPUCV_CLS_ROOT"), os.getcwd()
        os.environ["TPUCV_CLS_ROOT"] = str(base / "root")
        os.chdir(base)
        row, total_launches = {}, 0
        try:
            for name in CLASSIFIERS:
                argv = ["--ckpt", ckpts[name], "--batch-size", str(batch)]
                rec = StageRecorder(self.sync)
                rec.wrap(cls_mod.VitClassification, "evaluate", "loop")
                try:
                    nms_keep.launches = 0        # just before the path
                    t0 = time.perf_counter()
                    res = self._cls_cli(cli, name, True, argv)
                    self.sync()
                    wall = time.perf_counter() - t0
                    launches = nms_keep.launches     # just after
                finally:
                    rec.restore()
                total_launches += launches
                loop_s = rec.events[0][2] - rec.events[0][1]
                f32, pg, pc, err = self._cls_f32_runs(cli, name, argv)
                pg, pc = pg[:n_img], pc[:n_img]
                labels = np.array([src[i][1] for i in range(n_img)])
                order_g = np.argsort(-pg, -1)
                order_c = np.argsort(-pc, -1)
                clear, d = self._clear_rows(pc, pg, 5)
                check(clear.mean() >= 0.5, f"{name}: {int(clear.sum())} of "
                                           f"{n_img} images clear of ties")
                for j in np.flatnonzero(clear):
                    check(order_g[j, 0] == order_c[j, 0] and
                          (labels[j] in order_g[j, :5]) ==
                          (labels[j] in order_c[j, :5]),
                          f"{name}: image {j}'s top-1 / top-5 differ, card "
                          f"against CPU")
                if clear.all():
                    check(f32["cuda"] == f32["cpu"],
                          f"{name}: top-1 / top-5 card {f32['cuda']} CPU "
                          f"{f32['cpu']}")
                try:
                    self._cls_cli(cli, name, True, [*argv, "--int8"])
                    check(False, f"{name}: evaluate --int8 was not refused")
                except SystemExit as e:
                    check("not supported" in str(e), f"{name}: {e}")
                check(launches == 0 and all(
                    0 <= r[k] <= 1 for r in (res, *f32.values())
                    for k in ("top1", "top5")),
                      f"{name} evaluate: {res}, {launches} launches")
                row[name] = {"top1": res["top1"], "top5": res["top5"],
                             "f32_card": f32["cuda"], "f32_cpu": f32["cpu"],
                             "f32_prob_max_abs_err": err,
                             "f32_logprob_max_abs_err": d,
                             "images_clear_of_ties": int(clear.sum()),
                             "cli_wall_s": wall,
                             "img_per_s_cli": n_img / wall,
                             "img_per_s_loop": n_img / loop_s}
        finally:
            os.chdir(cwd)
            if env_was is None:
                os.environ.pop("TPUCV_CLS_ROOT")
            else:
                os.environ["TPUCV_CLS_ROOT"] = env_was
        emit({"phase": "cls_evaluate", "images": n_img, "batch": batch,
              **row, "int8_refused": True,
              "nms_keep_launches": total_launches,
              "nvidia_smi": nvidia_smi()})
        return total_launches

    def phase_cls_eval(self, runs, reps=2):
        """Each trainer's ``evaluate_loop`` on its run's state (16 synthetic
        val images, B=16): val_loss and val_acc finite, ms a call."""
        from tpucv_torch.ops.cuda_nms import nms_keep

        nms_keep.launches = 0
        row = {}
        for name in CLASSIFIERS:
            trainer = runs[name]["trainer"]
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                val = trainer.evaluate_loop(trainer.state)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            check(sorted(val) == ["val_acc", "val_loss"]
                  and all(np.isfinite(v) for v in val.values()),
                  f"{name} evaluate_loop: {val}")
            row[name] = {**val, "ms": float(np.median(ms)),
                         "images": len(trainer.val_loader.ds)}
        launches = nms_keep.launches
        check(launches == 0, f"cls_eval: nms_keep launched {launches}")
        emit({"phase": "cls_eval", **row, "nms_keep_launches": launches})
        return launches

    def phase_serve_vs_direct(self, algo, model, imgs, results, phase):
        """The served images again through ``_batched_detections`` (B=8,
        conf 0.25, as the server calls it), outside the server: each image's
        classes equal to the server's, its boxes (in the same order) within
        1e-2 px of them."""
        index = [(im,) for im in imgs]
        direct = list(algo._batched_detections(model, index, 8, 0.25))
        check(len(direct) == len(imgs), f"{phase}: {len(direct)} images")
        box_err, n = 0.0, []
        for i, boxes, _, classes in direct:
            served = results[i][1]["detections"]
            check([d["class_id"] for d in served] == classes.tolist(),
                  f"{phase} image {i}: served classes differ from a direct "
                  f"infer's")
            if len(served):
                box_err = max(box_err, float(np.abs(
                    np.array([d["box"] for d in served]) - boxes).max()))
            n.append(len(served))
        check(box_err <= 1e-2, f"{phase}: served boxes {box_err} px from a "
                               f"direct infer's")
        emit({"phase": phase, "images": len(imgs), "detections": n,
              "classes_equal": True, "box_max_abs_err": box_err})

    # ------------------------------------- export, data parallelism, variants
    def phase_export(self, algo, model, imgs):
        """The export layer (``tpucv_torch.deploy``) on YOLOv8n's serving
        program (``bench.inference_program``: ``letterbox_static``,
        normalize, the forward under bf16 autocast, ``decode_boxes`` at
        ``pre_nms_topk`` 512) over 8 serve images letterboxed to 640 (K =
        512: nms_keep). ``export_serialized`` -> ``load_serialized`` here,
        and the artifact in a fresh process that imports
        ``tpucv_torch.ops`` alone: each output bit-equal to the eager
        program's. ``aot_compile`` of the same program in f32 (inductor
        fuses f32 arithmetic in another order, so not bit for bit): valid
        set and classes equal to the eager f32 program's, boxes within
        EXPORT_BOX_PX, scores within EXPORT_SCORE_TOL; another batch size
        refused. nms_keep's count zeroed just before each form's checked
        call, read just after: one a call. ms a batch of each form beside
        the eager one's, in turns, and of the f32 pair the device's ms with
        the host queued ahead (``timed_queued``): host-bound or not. Then
        int8: the model quantized on the 8 images (quantize_variables), its
        served forward (bf16 autocast) exported: the raw maps bit-equal to
        the eager int8 forward's; and every quantized conv's
        int32 accumulators through one exported program bit-equal to the
        eager card route's and the plain route's (float64 F.conv2d)."""
        from tpucv_torch import bench, deploy
        from tpucv_torch.ops import cuda_nms
        from tpucv_torch.probes.common import timed, timed_queued

        torch = self.torch
        nms = cuda_nms.nms_keep
        x = self.letterboxed(algo, imgs[:8])
        size = algo.input_size

        def counted(fn, *args):
            nms.launches = 0
            with torch.inference_mode():
                out = fn(*args)
            self.sync()
            return out, nms.launches

        _, program = bench.inference_program(model, size, amp=True)
        eager, n_eager = counted(program, x)
        check(int(eager[3].sum()) > 0, "export: the eager program kept "
                                       "no detection")
        t0 = time.perf_counter()
        data = deploy.export_serialized(program, x)
        export_s = time.perf_counter() - t0
        loaded = deploy.load_serialized(data)
        got, n_loaded = counted(loaded, x)
        check(n_eager == n_loaded == 1,
              f"export: nms_keep launched {n_eager} (eager) and {n_loaded} "
              f"(loaded) times a call, not once")
        check(all(torch.equal(a, b) for a, b in zip(eager, got)),
              "export: the loaded program's detections differ from eager")
        text = deploy.export_stablehlo(program, x)
        check("tpucv.nms_keep" in text, "export: no tpucv.nms_keep node")

        fresh = self.fresh_process_outputs(data, x)
        check(fresh["launches"] == 1,
              f"export: the fresh process launched nms_keep "
              f"{fresh['launches']} times")
        check(all(torch.equal(a, b.to(self.dev))
                  for a, b in zip(eager, fresh["outputs"])),
              "export: the fresh process's detections differ from eager")

        _, program32 = bench.inference_program(model, size, amp=False)
        eager32, _ = counted(program32, x)
        t0 = time.perf_counter()
        compiled = deploy.aot_compile(program32, x)
        compile_s = time.perf_counter() - t0
        got32, n_compiled = counted(compiled, x)
        check(n_compiled == 1, f"aot_compile: nms_keep launched "
                               f"{n_compiled} times a call")
        eb, es, ec, ev = eager32
        cb, cs, cc, cv = got32
        box_err = float((cb - eb)[ev].abs().max()) if ev.any() else 0.0
        score_err = float((cs - es)[ev].abs().max()) if ev.any() else 0.0
        check(torch.equal(ev, cv) and torch.equal(ec[ev], cc[cv])
              and int(ev.sum()) > 0,
              "aot_compile: valid set or classes differ from eager f32")
        check(box_err <= EXPORT_BOX_PX and score_err <= EXPORT_SCORE_TOL,
              f"aot_compile: boxes {box_err} px, scores {score_err} from "
              f"eager f32")
        try:
            compiled(x[:4])
            locked = False
        except TypeError:
            locked = True
        check(locked, "aot_compile: a call at another batch size ran")

        def turns(a, b, n=20):
            with torch.inference_mode():
                a1, b1 = timed(a, n, self.dev), timed(b, n, self.dev)
                b2, a2 = timed(b, n, self.dev), timed(a, n, self.dev)
            return [a1, a2], [b1, b2]

        eager_ms, loaded_ms = turns(lambda: program(x), lambda: loaded(x))
        eager32_ms, compiled_ms = turns(lambda: program32(x),
                                        lambda: compiled(x))
        # the device's time with the host ahead of it, and dynamo's graphs
        with torch.inference_mode():
            device_ms = {"eager_f32": timed_queued(lambda: program32(x), 20,
                                                   self.dev),
                         "aot_compile_f32": timed_queued(lambda: compiled(x),
                                                         20, self.dev)}
        graphs = dict(torch._dynamo.utils.counters["stats"])
        del compiled
        torch._dynamo.reset()
        int8 = self.export_int8(algo, model, imgs, x[:2])
        row = {"phase": "export", "batch": x.shape[0], "size": size,
               "K": 512, "detections": int(ev.sum()),
               "export_s": export_s, "artifact_bytes": len(data),
               "compile_s": compile_s,
               "launches": {"eager": n_eager, "loaded": n_loaded,
                            "fresh_process": fresh["launches"],
                            "aot_compile": n_compiled},
               "loaded_bit_equal": True, "fresh_process_bit_equal": True,
               "fresh_process_modules": fresh["modules"],
               "aot_compile_box_max_abs_err_px": box_err,
               "aot_compile_score_max_abs_err": score_err,
               "ms_per_batch": {"eager_bf16": min(eager_ms),
                                "loaded_bf16": min(loaded_ms),
                                "eager_f32": min(eager32_ms),
                                "aot_compile_f32": min(compiled_ms)},
               "ms_runs": {"eager_bf16": eager_ms, "loaded_bf16": loaded_ms,
                           "eager_f32": eager32_ms,
                           "aot_compile_f32": compiled_ms},
               "device_ms_host_ahead": device_ms, "dynamo_stats": graphs,
               "int8": int8}
        emit(row)
        return row

    def fresh_process_outputs(self, data, x):
        """The artifact run by a new Python process that imports
        ``tpucv_torch.ops`` (the operator's registration) and nothing
        that builds a model: its outputs, nms_keep's count there, and the
        port's modules it had imported."""
        torch = self.torch
        d = ROOT / "saves" / "chip_smoke" / "export"
        d.mkdir(parents=True, exist_ok=True)
        (d / "program.pt2").write_bytes(data)
        torch.save(x.cpu(), d / "x.pt")
        code = (
            "import json, sys, torch\n"
            "import tpucv_torch.ops\n"
            "from tpucv_torch.ops import cuda_nms\n"
            "d = sys.argv[1]\n"
            "program = torch.export.load(d + '/program.pt2').module()\n"
            "x = torch.load(d + '/x.pt').cuda()\n"
            "with torch.inference_mode():\n"
            "    out = program(x)\n"
            "torch.cuda.synchronize()\n"
            "torch.save([o.cpu() for o in out], d + '/out.pt')\n"
            "print(json.dumps({'launches': cuda_nms.nms_keep.launches,\n"
            "                  'modules': sorted(m for m in sys.modules\n"
            "                                    if m.startswith('tpucv'))}))\n")
        r = subprocess.run([sys.executable, "-c", code, str(d)], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"export: the fresh process failed: "
                                 f"{r.stderr[-2000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        check(not any(m.startswith(("tpucv_torch.models", "tpucv_torch.nn",
                                    "tpucv_torch.algorithms")) or
                      m == "tpucv" or m.startswith("tpucv.")
                      for m in res["modules"]),
              f"export: the fresh process imported {res['modules']}")
        res["outputs"] = torch.load(d / "out.pt")
        return res

    def export_int8(self, algo, model, imgs, x):
        """The int8 model through ``export_serialized``: its served forward
        (bf16 autocast) reloaded, its raw maps bit-equal to the eager int8
        forward's; and every quantized conv's int32 accumulators at its
        served inputs, through one exported program, bit-equal to eager
        (both the card route) and to the plain route."""
        from tpucv_torch import bench, deploy, quant
        from tpucv_torch.ops import int8_conv

        torch = self.torch
        q = algo.quantize_variables(model, [(im,) for im in imgs[:8]],
                                    n_images=8, batch_size=2)
        served, _ = bench.inference_program(q, algo.input_size, amp=True)
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, inp: seen.append((mod, inp[0].detach())))
            for _, m in quant.hooked(q) if m.qweight is not None]
        try:
            with torch.no_grad():
                served(x)
        finally:
            for h in hooks:
                h.remove()
        with torch.no_grad():
            maps = served(x)
        loaded = deploy.load_serialized(deploy.export_serialized(served, x))
        with torch.no_grad():
            got = loaded(x)
        self.sync()
        check(all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                  for a, b in zip(maps, got)),
              "export int8: the loaded bf16 raw maps differ from eager")

        def geom(m):
            c = m.conv
            return (c.kernel_size, c.stride, c.padding, c.dilation, c.groups)

        class Accumulators(torch.nn.Module):
            def __init__(self, mods):
                super().__init__()
                self.mods = torch.nn.ModuleList(mods)

            def forward(self, *xs):
                return tuple(int8_conv.int8_conv(
                    quant.quantize_activation(xi, m.xscale), m.qweight,
                    *geom(m)) for m, xi in zip(self.mods, xs))

        acc = Accumulators([m for m, _ in seen])
        xs = [xi for _, xi in seen]
        with torch.no_grad():
            eager = acc(*xs)
            plain = [int8_conv.conv_plain(
                quant.quantize_activation(xi, m.xscale), m.qweight,
                *geom(m)) for m, xi in seen]
            exported = deploy.load_serialized(
                deploy.export_serialized(acc, *xs))(*xs)
        self.sync()
        bad = sum(int((e != g).sum()) + int((p != g).sum())
                  for e, p, g in zip(eager, plain, exported))
        check(bad == 0, f"export int8: {bad} int32 accumulators of the "
                        f"exported program differ")
        n_q = quant.count_quantized(q)
        check(len(seen) == n_q, f"export int8: {len(seen)} of {n_q} convs")
        return {"count_quantized": n_q, "bf16_maps_bit_equal": True,
                "accumulators_bit_equal": True, "convs_compared": len(seen),
                "accumulator_inputs": "bf16 autocast", "batch": x.shape[0]}

    def phase_ddp(self):
        """Data parallelism on the one card. World size 1 over NCCL through
        the trainer: yolo8_det as shipped, 3 steps, with and without ZeRO,
        bit-equal to the trainer without a process group (weights, BN
        statistics, EMA, Adam's state). Then two ranks spawned over gloo
        on the one card (NCCL refuses two ranks on one GPU), each feeding
        its rows of a global batch of DDP_BATCH (DDP_FAMILIES at their
        shipped sizes, f32, TF32 off, Adam 1e-3, EMA 0.9999), with and
        without ZeRO, 3 steps, against one process's steps on the global
        batch: losses, BN statistics (after the first step and the last)
        and parameters within the DDP_* bounds; the two ranks equal. The ZeRO run of yolo8_det saves a
        checkpoint, which resumes in one process bit-equal to the ranks'
        state (weights, EMA, both ranks' moments, step).
        Step ms of each, host clock with a sync: gloo stages every
        collective through the host, so the two-rank step is slower."""
        import torch.distributed as dist
        import torch.multiprocessing as mp

        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.train.state import TrainState

        torch = self.torch
        out = {"phase": "ddp", "families": list(DDP_FAMILIES),
               "global_batch": DDP_BATCH, "steps": DDP_STEPS}
        runs = {}
        for tag in ("plain", "nccl", "nccl_zero"):
            if tag != "plain":
                dist.init_process_group(
                    "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                    world_size=1, rank=0)
            try:
                runs[tag] = ddp_trainer_run(self.dev, tag)
            finally:
                if tag != "plain":
                    dist.destroy_process_group()
        for tag in ("nccl", "nccl_zero"):
            diff = [k for k, v in runs["plain"].items()
                    if not torch.equal(v, runs[tag][k])]
            check(not diff, f"ddp: the W=1 {tag} trainer differs from the "
                            f"plain one in {diff[:5]}")
        out["world1_nccl_trainer_bit_equal"] = True

        d = ROOT / "saves" / "chip_smoke" / "ddp"
        d.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        port = free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=ddp_rank, args=(r, 2, port, str(d)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"ddp: the ranks exited with {codes}")
        out["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        for name in DDP_FAMILIES:
            ref = ddp_run(name, self.dev)
            fam = {"one_process_step_ms": ref["step_ms"]}
            for zero in (False, True):
                a, b = (r[name][zero] for r in ranks)
                check(all(torch.equal(v, b["sd"][k])
                          for k, v in a["sd"].items()),
                      f"ddp {name} zero={zero}: the ranks' weights differ")
                fam[f"zero={zero}"] = ddp_compare(name, a, ref)
                fam[f"zero={zero}"]["two_rank_step_ms"] = a["step_ms"]
            out[name] = fam
        # the W=2 ZeRO bundle in one process
        ckpt = d / "zero.ckpt"
        zero_runs = [r["yolo8_det"][True] for r in ranks]
        state = TrainState.create(ddp_model("yolo8_det", self.dev, seed=1),
                                  1e-3, use_ema=True)
        CheckPoint.load(str(ckpt), state)
        check(state.step == DDP_STEPS, f"ddp: resumed at {state.step}")
        check(all(torch.equal(v.cpu(), zero_runs[0]["sd"][k])
                  for k, v in state.model.state_dict().items()),
              "ddp: the ZeRO bundle's weights differ from the ranks'")
        check(all(torch.equal(state.ema[k].cpu(), v)
                  for k, v in zero_runs[0]["ema"].items()),
              "ddp: the ZeRO bundle's EMA differs from the ranks'")
        held = {**zero_runs[0]["moments"], **zero_runs[1]["moments"]}
        names = {id(p): n for n, p in state.params.items()}
        loaded = {names[id(p)]: s for p, s in state.optimizer.state.items()}
        check(held.keys() == loaded.keys() and all(
            torch.equal(loaded[n][k].cpu(), v)
            for n, m in held.items() for k, v in m.items()),
            "ddp: the ZeRO bundle's moments differ from the ranks'")
        out["zero_checkpoint_bit_equal"] = True
        out["zero_moment_bytes_by_rank"] = [r["yolo8_det"][True][
            "moment_bytes"] for r in ranks]
        emit(out)
        return out

    def phase_scales(self, offs, thr):
        """``python -m tpucv_torch.bench --scale s|m|l|x``'s main, each with
        nms_keep's count zeroed just before and read just after (the
        program's NMS at K = 512: one a call, warm-up included); then
        nms_keep at the scales' inference batches (64, 32, 16) and K = 512
        on the first rows of the bench program's candidates, against its
        plain version and its bound."""
        from tpucv_torch import bench
        from tpucv_torch.ops.cuda_nms import nms_keep

        lines = {}
        for s in sorted(bench.SCALE_BATCHES, key="smlx".index):
            nms_keep.launches = 0
            line = bench.main(["--scale", s])
            n = nms_keep.launches
            check(n == bench.SCALE_ITERS[0] + 1,
                  f"bench --scale {s}: nms_keep launched {n} times")
            check(np.isfinite(line["value"]) and
                  np.isfinite(line["train_step_ms"]),
                  f"bench --scale {s}: {line}")
            lines[s] = {**line, "nms_launches": n}
        emit({"phase": "bench_scale", "lines": lines})
        sb, ss = offs
        for B in sorted({b for b, _ in bench.SCALE_BATCHES.values()},
                        reverse=True):
            self.time_kernel(sb[:B].contiguous(), ss[:B].contiguous(), thr,
                             f"scale_B{B}_K512")
        return {f"bench_scale_{s} (K=512)": v["nms_launches"]
                for s, v in lines.items()}

    def variant_setup(self, name):
        """A shipped variant (``bench.VARIANTS``: YOLOv7-x, SSD512) as its
        family's algorithm on the card, and its seed-0 model."""
        from tpucv_torch import bench

        family, cfg, algo_cls = bench.configured(name)
        algo = algo_cls(cfg, device=self.dev)
        return family, algo, algo.init_variables(seed=0)

    def phase_variant(self, name):
        """A shipped variant never run on the card before: its f32 parity
        (the family's parity phase, B=2, card against CPU), one train step
        at the shipped batch (B=16, bf16 autocast, Adam 1e-3, EMA 0.9999,
        bench's family batch: 3 warm-up, 5 timed), and its
        ``bench.bench_family`` line at the family's batches, nms_keep's
        count zeroed just before, read just after."""
        from tpucv_torch import bench
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import timed
        from tpucv_torch.train.state import TrainState, make_train_step

        torch = self.torch
        family, algo, model = self.variant_setup(name)
        if family == "yolo7":
            self.phase_yolo7_parity(algo, model, phase=f"{name}_parity")
        else:
            self.phase_ssd_parity(algo, model, phase=f"{name}_parity")
        S = algo.cfg.dataset.input_size
        state = TrainState.create(model, 1e-3, use_ema=True)
        step = make_train_step(algo.build_loss(), device=self.dev,
                               ema_decay=0.9999, mixed_precision=True)
        batch = bench.family_batch(family, algo.cfg, VARIANT_BATCH, S,
                                   self.dev, torch.bfloat16)
        last = {}

        def one():
            nonlocal state, last
            state, last = step(state, batch)

        one()
        one()
        torch.cuda.reset_peak_memory_stats(self.dev)
        ms = timed(one, 5, self.dev)
        metrics = {k: float(v) for k, v in last.items()}
        check(all(np.isfinite(v) for v in metrics.values()),
              f"{name}: non-finite step metrics {metrics}")
        emit({"phase": f"{name}_step", "batch": VARIANT_BATCH, "size": S,
              "step_ms": ms, "img_per_s": VARIANT_BATCH * 1e3 / ms,
              "metrics": metrics,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(self.dev)})
        del state, step, model, batch
        nms_keep.launches = 0
        line = bench.bench_family(name, self.dev)
        n = nms_keep.launches
        check(line["metric"] == f"{name}_{S}_e2e_images_per_sec_per_chip"
              and np.isfinite(line["value"]), f"{name}: bench line {line}")
        emit({"phase": f"{name}_bench", **line, "nms_launches": n})
        return n

    def phase_mesh(self):
        """The mesh's model axis, batch-sharded inference and spatial
        partitioning (phases model_axis, sharded_infer, spatial): two
        ranks spawned over gloo on the one card (``mesh_rank``; NCCL
        refuses two ranks on one GPU), then each case's one-process run
        here and the comparisons. Returns nms_keep's launches on each
        rank in each of the three, read in the ranks."""
        import torch.multiprocessing as mp

        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import timed
        from tpucv_torch.train.state import TrainState

        torch = self.torch
        d = ROOT / "saves" / "chip_smoke" / "mesh"
        d.mkdir(parents=True, exist_ok=True)
        # a FileStore in a fresh directory: a file left by an earlier run
        # would hold that run's addresses
        init = "file://" + str(Path(tempfile.mkdtemp(dir=d)) / "store")
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_WORLD, init, str(d)))
                 for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * MESH_WORLD, f"mesh: the ranks exited with "
                                         f"{codes}")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(MESH_WORLD)]

        # the model axis
        launches = {k: [r[k]["nms_launches"] for r in ranks]
                    for k in ("model_axis", "spatial")}
        for k, v in launches.items():
            check(v == [0] * MESH_WORLD, f"{k}: nms_keep launched {v} times "
                                         f"(a rank)")
        ref = model_axis_run(self.dev)
        got = [r["model_axis"] for r in ranks]
        for k in ("sd", "ema"):
            check(all(torch.equal(v, got[1][k][name])
                      for name, v in got[0][k].items()),
                  f"model_axis: the ranks' whole {k} differ")
        res = ddp_compare("yolo8_det", got[0], ref, phase="model_axis",
                          steps=MODEL_AXIS_STEPS)
        state = TrainState.create(ddp_model(
            "yolo8_det", self.dev, seed=1, scale=MODEL_AXIS_SCALE), 1e-3,
            use_ema=True)
        CheckPoint.load(str(d / "model_axis.ckpt"), state)
        names = {id(p): n for n, p in state.params.items()}
        loaded = {names[id(p)]: st for p, st in state.optimizer.state.items()}
        check(state.step == MODEL_AXIS_STEPS and all(
            torch.equal(v.cpu(), got[0]["sd"][k])
            for k, v in state.model.state_dict().items()) and all(
            torch.equal(v.cpu(), got[0]["ema"][k])
            for k, v in state.ema.items()) and all(
            torch.equal(loaded[n][k].cpu(), v)
            for n, m in got[0]["moments"].items() for k, v in m.items()),
            "model_axis: the (1, 2) checkpoint does not resume in one "
            "process bit-equal to the ranks' state")
        del state
        emit({"phase": "model_axis", "mesh": [1, MESH_WORLD],
              "config": f"yolo8_det scale {MODEL_AXIS_SCALE}, "
                        f"{MODEL_AXIS_SIZE}², global B={MODEL_AXIS_BATCH}, "
                        f"f32, TF32 off, Adam 1e-3, EMA 0.9999",
              "steps": MODEL_AXIS_STEPS,
              "sharded_kernels": got[0]["sharded_kernels"],
              "param_bytes_by_rank": [g["param_bytes"] for g in got],
              "param_bytes_one_process": ref["param_bytes"],
              "two_rank_step_ms": [g["step_ms"] for g in got],
              "one_process_step_ms": ref["step_ms"], **res,
              "checkpoint_resumes_in_one_process_bit_equal": True,
              "nms_launches_by_rank": launches["model_axis"],
              "ranks_s": ranks_s, "nvidia_smi": nvidia_smi()})

        # batch-sharded inference
        algo, model, imgs = sharded_infer_setup(self.dev)
        with torch.inference_mode():
            one = [t.cpu() for t in algo.make_infer_fn()(model, imgs)]
        one_ms = timed(lambda: algo.make_infer_fn()(model, imgs), 5,
                       self.dev)
        b_r, s_r, c_r, v_r = one
        score_err = box_err = 0.0
        for r in ranks:
            b_o, s_o, c_o, v_o = r["sharded_infer"]["out"]
            check(torch.equal(v_r, v_o) and torch.equal(c_r[v_r], c_o[v_o]),
                  "sharded_infer: valid or classes differ from one process")
            check(bool(torch.allclose(s_o[v_o], s_r[v_r], rtol=1e-5,
                                      atol=1e-6)) and
                  bool(torch.allclose(b_o[v_o], b_r[v_r], rtol=1e-4,
                                      atol=1e-3)),
                  "sharded_infer: scores or boxes differ from one process")
            score_err = max(score_err, float(
                (s_o[v_o] - s_r[v_r]).abs().max()))
            box_err = max(box_err, float((b_o[v_o] - b_r[v_r]).abs().max()))
        infer_launches = [r["sharded_infer"]["nms_launches"] for r in ranks]
        check(infer_launches == [1] * MESH_WORLD,
              f"sharded_infer: nms_keep launched {infer_launches} times "
              f"(a rank) in one call")
        emit({"phase": "sharded_infer", "mesh": [MESH_WORLD, 1],
              "batch": SHARDED_INFER_BATCH, "rows_a_rank":
                  SHARDED_INFER_BATCH // MESH_WORLD,
              "valid": int(v_r.sum()), "score_max_abs_err": score_err,
              "box_max_abs_err": box_err,
              "nms_launches_by_rank": infer_launches,
              "ms_by_rank": [r["sharded_infer"]["ms"] for r in ranks],
              "one_process_ms": one_ms, "nvidia_smi": nvidia_smi()})

        # spatial partitioning: tpucv's net to tpucv's bound; YOLOv8n's
        # gradients, which train-mode BatchNorm makes ill-conditioned, to
        # twice the share by which one process's own f32 gradients part
        # from its float64 ones (as GRAD_SHARE holds data parallelism)
        ref = spatial_case(self.dev)
        ref64 = spatial_case(self.dev, dtype=torch.float64)
        row = {"phase": "spatial", "mesh": [1, MESH_WORLD]}
        for part in ("net", "yolo8n"):
            r, r64 = ref[part], ref64[part]
            one_share = grad_share(r["grads"], r64["grads"])
            row[f"{part}_one_process_f32_grad_share_vs_f64"] = one_share
            for k, rank in enumerate(ranks):
                g = rank["spatial"][part]
                loss_rel = abs(g["loss"] - r["loss"]) / abs(r["loss"])
                out_x = max_excess(g["out"], r["out"], SPATIAL_REL)
                share = grad_share(g["grads"], r64["grads"])
                if part == "net":
                    grad_ok = max_excess(g["grads"], r["grads"],
                                         SPATIAL_REL) <= 0
                else:
                    grad_ok = share <= min(max(2 * one_share, SPATIAL_REL),
                                           SPATIAL_GRAD_CEIL)
                stat_x = (max_excess(list(g["stats"].values()),
                                     list(r["stats"].values()), 1e-5)
                          if "stats" in r else 0.0)
                check(loss_rel < 1e-5 and out_x <= 0 and grad_ok and
                      stat_x <= 0, f"spatial {part} rank {k}: loss "
                      f"{loss_rel}, outputs {out_x}, gradient share "
                      f"{share} (one process {one_share}), BN statistics "
                      f"{stat_x} beyond the bounds")
                row[f"{part}_rank{k}"] = {
                    "loss_rel_err": loss_rel,
                    "out_max_abs_err": max(float((a - b).abs().max())
                                           for a, b in zip(g["out"],
                                                           r["out"])),
                    "grad_max_abs_err": max(float((a - b).abs().max())
                                            for a, b in zip(g["grads"],
                                                            r["grads"])),
                    "grad_share_vs_f64": share}
        emit({**row, "size": SPATIAL_SIZE,
              "nms_launches_by_rank": launches["spatial"],
              "nvidia_smi": nvidia_smi()})
        return {**launches, "sharded_infer": infer_launches}

    # ------------------------------------------------------ YOLOv3 (legacy)
    def yolo3_setup(self, mixed_precision=True):
        """The unregistered YOLOv3 as shipped (Yolo3Config: Darknet-53,
        COCO nc 80, 416²) on the card and its seed-0 model."""
        from tpucv_torch.configs.model_cfgs import Yolo3Config
        from tpucv_torch.trainer.yolov3_train import Yolo3Algorithm

        cfg = Yolo3Config()
        cfg.train.mixed_precision = mixed_precision
        algo = Yolo3Algorithm(cfg, device=self.dev)
        return algo, algo.init_variables(seed=0)

    def phase_yolo3_parity(self):
        """The f32 forward (TF32 off) of the seed-0 YOLOv3 at 416, B=2, on
        the card against the CPU, each map within YOLO3_FWD_REL of its
        largest value; then make_yolov3_targets and yolov3_loss on the
        CPU's maps, 100 GT rows an image (some padded), on both devices:
        the targets equal but for the log-size entries (1e-6 relative:
        the card's log parts from the CPU's by an ulp), the loss terms
        within 1e-4 relative."""
        import copy

        from tpucv_torch.losses.yolov3 import make_yolov3_targets, yolov3_loss

        torch = self.torch
        cpu = torch.device("cpu")
        algo, model = self.yolo3_setup(mixed_precision=False)
        x = torch.from_numpy(np.random.default_rng(3).random(
            (2, 416, 416, 3), dtype=np.float32))
        with torch.inference_mode():
            got = model(x.to(self.dev))
            raw = copy.deepcopy(model).to(cpu).to(
                memory_format=torch.contiguous_format)(x)
        rel = [float((g.cpu() - c).abs().max() / c.abs().max())
               for g, c in zip(got, raw)]
        rng = np.random.default_rng(4)
        cxy = rng.uniform(20, 396, (2, 100, 2))
        wh = rng.uniform(8, 300, (2, 100, 2))
        gt = {"gt_bboxes": torch.from_numpy(np.concatenate(
                  [cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)),
              "gt_labels": torch.from_numpy(rng.integers(0, 80, (2, 100))),
              "gt_mask": torch.from_numpy(rng.random((2, 100)) < 0.3)}
        args = (algo.anchors, algo.anchor_mask, algo.strides)

        def on(dev):
            g = [gt[k].to(dev) for k in ("gt_bboxes", "gt_labels",
                                         "gt_mask")]
            with torch.inference_mode():
                t = make_yolov3_targets(*g, *args,
                                        [r.shape[1:3] for r in raw], algo.nc)
                total, parts = yolov3_loss([r.to(dev) for r in raw], *g,
                                           *args, algo.nc)
            return ([v.cpu() for v in t],
                    {"loss": float(total),
                     **{k: float(v) for k, v in parts.items()}})

        (t_c, l_c), (t_g, l_g) = on(cpu), on(self.dev)
        other = [0, 1, *range(4, 5 + algo.nc)]
        targets_equal = all(torch.equal(a[..., other], b[..., other])
                            for a, b in zip(t_g, t_c))
        wh_rel = max(float(((a[..., 2:4] - b[..., 2:4]).abs()
                            / b[..., 2:4].abs().clamp(min=1e-6)).max())
                     for a, b in zip(t_g, t_c))
        terms = {k: abs(l_g[k] - v) / max(abs(v), 1e-12)
                 for k, v in l_c.items()}
        emit({"phase": "yolo3_parity", "shapes": [list(t.shape) for t in got],
              "forward_rel_err_by_map": rel,
              "positives": int(sum(float(t[..., 4].sum()) for t in t_c)),
              "targets_equal_but_log_size": targets_equal,
              "targets_log_size_max_rel_err": wh_rel,
              "loss_cpu": l_c, "loss_card": l_g,
              "loss_max_rel_err": max(terms.values())})
        check(max(rel) < YOLO3_FWD_REL,
              f"yolo3: the f32 forward on the card differs from the CPU: "
              f"{rel} of each map's largest value")
        check(targets_equal and wh_rel <= 1e-6,
              f"yolo3: the card's targets differ from the CPU's "
              f"({targets_equal}, log sizes {wh_rel})")
        check(max(terms.values()) <= 1e-4,
              f"yolo3: loss card {l_g} against CPU {l_c}")

    def phase_yolo3_trainer(self, steps=4):
        """Yolo3Trainer as shipped (416², B=16, M=100, bf16, device
        augmentation, mosaic 0.5, synthetic data) for ``steps`` steps,
        evaluate_loop and the saves at the epoch's end; then the step on a
        device-resident batch (probes.train_step's synthetic batch): ms
        (CUDA events), kernel ms and launches (torch.profiler), peak
        memory. Returns the final checkpoint's path and nms_keep's launches
        over the path."""
        from tpucv_torch.configs.model_cfgs import Yolo3Config
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import timed
        from tpucv_torch.probes.train_step import _host_waits, synthetic_batch
        from tpucv_torch.trainer.yolov3_train import Yolo3Trainer

        torch = self.torch
        cfg = Yolo3Config()
        t, dset = cfg.train, cfg.dataset
        check(dset.input_size == 416 and t.batch_size == 16 and
              t.mixed_precision and dset.max_num_boxes == 100,
              "yolov3's config is not as shipped")
        out = ROOT / "saves" / "chip_smoke" / "yolov3"
        t.save_path, cfg.log.root = str(out / "saves"), str(out / "log")
        cfg.log.tensorboard_on = False
        cfg.log.print_interval = 1
        t.eval_interval = t.save_interval = 1
        nms_keep.launches = 0                # just before the path
        t0 = time.perf_counter()
        trainer = Yolo3Trainer(cfg, device=self.dev)
        trainer.tb = rec = Recorder()
        state = trainer.train(max_steps=steps)
        self.sync()
        train_s = time.perf_counter() - t0
        terms = ("loss", "xy_loss", "wh_loss", "obj_loss", "cls_loss")
        losses = {k: rec.rows[f"train/{k}"] for k in terms}
        check(state.step == steps and all(
            np.isfinite(v) for r in losses.values() for v in r.values()),
            f"yolo3 trainer: {state.step} steps, losses {losses}")
        val = trainer.last_eval
        check(all(np.isfinite(v) for v in val.values()) and
              "val_obj_loss" in val, f"yolo3 trainer: evaluate_loop {val}")
        step = trainer.build_train_step()
        batch = synthetic_batch(16, 416, 100, self.dev, torch.bfloat16)
        torch.cuda.reset_peak_memory_stats(self.dev)
        step_ms = timed(lambda: step(state, batch), 10, self.dev)
        peak = torch.cuda.max_memory_allocated(self.dev)
        prof = _host_waits(step, state, batch, 3, self.dev)
        launches = nms_keep.launches
        check(launches == 0, f"yolo3 trainer: nms_keep launched {launches}")
        emit({"phase": "yolo3_trainer",
              "config": "YOLOv3 (Darknet-53) as shipped: COCO nc 80, 416², "
                        "B=16, M=100, bf16, device augmentation, mosaic "
                        "0.5, synthetic data",
              "steps": steps, "train_s": train_s, "loss_logged": losses,
              "val": val, "step_ms_device_resident": step_ms,
              "step_kernel_ms_profiler": prof["kernel_ms"],
              "launches_a_step": prof["launches_a_step"],
              "syncs_a_step": prof["syncs_a_step"],
              "busy_share": (prof["kernel_ms"] or 0.0) / step_ms,
              "peak_mem_bytes": peak, "nms_keep_launches": launches,
              "nvidia_smi": nvidia_smi()})
        return trainer._ckpt_path(cfg.train.epochs - 1, final=True), launches

    def yolo3_sharpened(self, ckpt):
        """The algorithm as shipped (bf16) and the checkpoint's weights with
        the objectness and class rows of the three output convs scaled by
        YOLO3_GAIN and their biases zeroed: scores spread and the NMS has
        work."""
        from tpucv_torch.ckpt.checkpoint import CheckPoint

        torch = self.torch
        algo, model = self.yolo3_setup()
        model.load_state_dict(CheckPoint.load_pure(ckpt))
        per_anchor = 5 + model.nc
        with torch.no_grad():
            for name in ("y5_out", "y4_out", "y3_out"):
                head = getattr(model, name)
                head.weight.view(model.na, per_anchor, -1)[:, 4:] *= \
                    YOLO3_GAIN
                head.bias.view(model.na, per_anchor)[:, 4:] = 0.0
        return algo, model

    def phase_yolo3_predict(self, algo, model, imgs, reps=2):
        """DetectionAlgorithm.predict on the serve images (4 JPEGs, a PNG;
        conf 0.5, K = 4096: the scan), nms_keep's and nms_scan's counts
        zeroed just before and read just after (0, and one an image);
        detections and drawn files; ms an image (median)."""
        import cv2

        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        out = ROOT / "saves" / "chip_smoke" / "yolov3" / "predict"
        out.mkdir(parents=True, exist_ok=True)
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(out / f"img{k}{'.png' if k == 4 else '.jpg'}"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        infer = algo.make_infer_fn()
        nms_keep.launches = nms_scan.launches = 0    # just before the path
        got = [algo.predict(model, src, infer_fn=infer,
                            save_dir=str(out / "drawn")) for src in srcs]
        launches = nms_keep.launches         # just after
        scan_launches = nms_scan.launches
        ms = []
        for _ in range(reps):
            for src in srcs:
                self.sync()
                t0 = time.perf_counter()
                algo.predict(model, src, infer_fn=infer, save_dir=None)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        n_dets = [len(r["classes"]) for r in got]
        check(launches == 0, f"yolo3 predict: nms_keep launched {launches} "
                             f"times at K=4096")
        check(scan_launches == len(srcs), f"yolo3 predict: nms_scan launched "
              f"{scan_launches} times for {len(srcs)} images")
        check(sum(n_dets) > 0 and all(r["saved"] and Path(r["saved"])
                                      .is_file() for r in got),
              f"yolo3 predict: detections {n_dets}, drawn files "
              f"{[r['saved'] for r in got]}")
        emit({"phase": "yolo3_predict", "images": len(srcs), "K": 4096,
              "nms_launches": launches, "nms_scan_launches": scan_launches,
              "detections": n_dets,
              "ms_per_image_median": float(np.median(ms)),
              "nvidia_smi": nvidia_smi()})
        return launches

    def phase_yolo3_evaluate(self, algo, model, batch=32):
        """evaluate_on_coco on a COCO-layout root written here (64 640x480
        JPEGs and a PNG from SyntheticDetectionIndex, one crowd GT; B=32,
        conf 0.001, K = 4096: the scan): the 12 stats, images/s, nms_keep's
        count 0 and nms_scan's one a batch."""
        from tpucv_torch.data.coco import COCOIndex
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.cuda_scan import nms_scan

        base = ROOT / "saves" / "chip_smoke" / "yolov3" / "evaluate"
        root = base / "coco"
        n_img = write_coco_root(root, 64)
        index = COCOIndex(str(root / "annotations" / "instances_val2017.json"),
                          str(root / "val2017"))
        nms_keep.launches = nms_scan.launches = 0    # just before the path
        t0 = time.perf_counter()
        stats = algo.evaluate_on_coco(model, index, batch_size=batch,
                                      conf_threshold=0.001,
                                      result_dir=str(base), verbose=False)
        self.sync()
        wall = time.perf_counter() - t0
        launches = nms_keep.launches         # just after
        scan_launches = nms_scan.launches
        check(launches == 0, f"yolo3 evaluate: nms_keep launched {launches}")
        check(scan_launches == -(-n_img // batch), f"yolo3 evaluate: nms_scan "
              f"launched {scan_launches} times for {n_img} images")
        check(len(stats) == 12 and all(np.isfinite(v)
                                       for v in stats.values()),
              f"yolo3 evaluate: {stats}")
        emit({"phase": "yolo3_evaluate", "images": n_img, "batch": batch,
              "K": 4096, "nms": "scan", "stats": stats,
              "img_per_s": n_img / wall, "nms_keep_launches": launches,
              "nms_scan_launches": scan_launches, "nvidia_smi": nvidia_smi()})
        return launches

    # ------------------------------------------------- the rest of the zoo
    def zoo_network(self, name, seed=0):
        """One of the zoo's networks (ZOO) at full width with seed-0
        weights, on the CPU."""
        from tpucv_torch.models import extras, openpose

        model = {"vgg16_bn": lambda: extras.VGG(16),
                 "mobilenet_v2": lambda: extras.MobileNetV2(1000, 1.0),
                 "unet": lambda: extras.UNet(21),
                 "cpm": lambda: openpose.CPM(18, 19, 6)}[name]()
        return model.reset_parameters(
            self.torch.Generator().manual_seed(seed))

    def zoo_blocks(self):
        """The twenty blocks at narrow widths, torch's default init drawn
        after ``manual_seed(0)``: (name, block, NCHW input shape)."""
        from tpucv_torch.nn import blocks as tb

        self.torch.manual_seed(0)
        return [
            ("DWConv", tb.DWConv(8, 16, 3, 2), (2, 8, 16, 16)),
            ("C1", tb.C1(8, 16, 2), (2, 8, 16, 16)),
            ("C2", tb.C2(8, 16, 2), (2, 8, 16, 16)),
            ("C3", tb.C3(8, 16, 2), (2, 8, 16, 16)),
            ("C3x", tb.C3x(8, 16, 2), (2, 8, 16, 16)),
            ("SPP", tb.SPP(16, 16), (2, 16, 16, 16)),
            ("Focus", tb.Focus(4, 16, 3), (2, 4, 16, 16)),
            ("GhostConv", tb.GhostConv(8, 16, 3, 2), (2, 8, 16, 16)),
            ("GhostBottleneck", tb.GhostBottleneck(8, 16, 3, 2),
             (2, 8, 16, 16)),
            ("ChannelAttention", tb.ChannelAttention(8), (2, 8, 16, 16)),
            ("SpatialAttention", tb.SpatialAttention(7), (2, 8, 16, 16)),
            ("CBAM", tb.CBAM(8, 7), (2, 8, 16, 16)),
            ("ConvTransposeBnAct", tb.ConvTransposeBnAct(8, 12, 3, 2),
             (2, 8, 8, 8)),
            ("TransformerLayer", tb.TransformerLayer(16, 4), (2, 10, 16)),
            ("TransformerBlock", tb.TransformerBlock(8, 16, 4, 2),
             (2, 8, 8, 8)),
            ("BottleneckCSP", tb.BottleneckCSP(8, 16, 2), (2, 8, 16, 16)),
            ("C3TR", tb.C3TR(8, 16, 1), (2, 8, 8, 8)),
            ("C3Ghost", tb.C3Ghost(8, 16, 2), (2, 8, 16, 16)),
            ("DWConvTranspose2d", tb.DWConvTranspose2d(8, 12, 3, 2, 1, 1),
             (2, 8, 6, 5)),
            ("Ensemble", tb.Ensemble([tb.Focus(4, 6), tb.Focus(4, 6)]),
             (2, 4, 8, 8)),
        ]

    def _card_vs_cpu(self, model, x, train):
        """``model`` (on the CPU) and a copy on the card (channels_last for
        4-D inputs) in ``train`` mode on ``x``: each output's largest
        difference over its largest |value|, and afterwards each running
        variance's over its largest value and each running mean's over
        the largest running standard deviation of its BatchNorm (a mean
        that is 0 but for rounding has no scale of its own)."""
        import copy

        torch = self.torch
        if isinstance(model, torch.nn.Module):
            model.train(train)
            card = copy.deepcopy(model).to(self.dev)
            if x.dim() == 4:
                card = card.to(memory_format=torch.channels_last)
        else:                                        # an Ensemble
            for m in model.members:
                m.train(train)
            card = type(model)([copy.deepcopy(m).to(self.dev)
                                for m in model.members])
        with torch.no_grad():
            ref, got = model(x), card(x.to(self.dev))
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        out = [float((g.float().cpu() - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref)]
        check(all(bool(torch.isfinite(g).all()) and g.shape == r.shape
                  for g, r in zip(got, ref)), "non-finite or misshapen")
        stats = 0.0
        if train and isinstance(model, torch.nn.Module):
            csd, sd = card.state_dict(), model.state_dict()
            for k, v in sd.items():
                if k.endswith(("running_mean", "running_var")):
                    var = sd[k.replace("running_mean", "running_var")]
                    scale = var.max() if k.endswith("var") else \
                        var.max().sqrt()
                    stats = max(stats, float((csd[k].cpu() - v).abs().max()
                                             / scale))
        return max(out), stats

    def phase_zoo_parity(self):
        """VGG16-BN, MobileNetV2 (width 1, nc 1000), UNet (nc 21) and CPM
        (18 keypoints, 19 limbs, 6 stages), full width, seed-0 weights, f32
        (TF32 off), B=2 at 64² (UNet at 46², which 16 does not divide, and
        at 64²): the card against the CPU in eval and train mode, every
        output and every running statistic within ZOO_REL of its largest
        |value|; then the twenty blocks at narrow widths the same way.
        nms_keep's count 0."""
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        nms_keep.launches = 0                # just before the path
        rows = {}
        models = {name: self.zoo_network(name) for name in ZOO}
        cases = [(name, models[name], s) for name, (s, _) in ZOO.items()]
        cases.append(("unet_64", models["unet"], 64))
        for name, model, s in cases:
            x = torch.from_numpy(np.random.default_rng(3).normal(
                0, 1, (2, 3, s, s)).astype(np.float32))
            for train in (False, True):
                rows[f"{name}_{'train' if train else 'eval'}"] = \
                    self._card_vs_cpu(model, x, train)
        for name, block, shape in self.zoo_blocks():
            x = torch.from_numpy(np.random.default_rng(4).normal(
                0, 1, shape).astype(np.float32))
            for train in (False, True):
                rows[f"{name}_{'train' if train else 'eval'}"] = \
                    self._card_vs_cpu(block, x, train)
        launches = nms_keep.launches         # just after
        worst = max(max(v) for v in rows.values())
        emit({"phase": "zoo_parity", "cases": len(rows),
              "max_rel_err_output_and_stats": rows, "worst": worst,
              "nms_keep_launches": launches, "nvidia_smi": nvidia_smi()})
        check(worst <= ZOO_REL, f"zoo_parity: the card parts from the CPU "
                                f"by {worst} of the largest value")
        check(launches == 0, f"zoo_parity: nms_keep launched {launches}")
        return launches

    def in_fresh_process(self, method, *args):
        """``Smoke.<method>(*args)`` run by a new Python process (from the
        repository's root) and its JSON result: the profiler's CUDA
        records, taken late in this long process, miss kernels (a whole
        run of this script on an NVIDIA H100 80GB HBM3 at 700 W read 1.92
        ms of kernels for a 7.8 ms forward there, and an NMS trace
        without the NMS kernels), and the card's peak memory there holds
        the earlier phases' tensors."""
        code = ("import json, sys, torch\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "import chip_smoke\n"
                "out = getattr(chip_smoke.Smoke(torch), sys.argv[2])("
                "*json.loads(sys.argv[3]))\n"
                "print(json.dumps(out))\n")
        r = subprocess.run([sys.executable, "-c", code, str(ROOT), method,
                            json.dumps(args)], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        check(r.returncode == 0, f"{method}: the fresh process failed: "
                                 f"{r.stderr[-2000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    def zoo_forward_rows(self, reps=10):
        """Each network as it would serve (bf16 autocast, channels_last,
        eval mode; ZOO's sizes): ms a batch (CUDA events, after a warm-up
        call), the kernels' ms and launches a call (torch.profiler), peak
        memory, GFLOP an image (FlopCounterMode, from the ops' shapes)
        and the share of the dense bf16 peak that the batch's FLOPs over
        its ms reach; nms_keep's count over them."""
        from torch.profiler import ProfilerActivity, profile
        from torch.utils.flop_counter import FlopCounterMode

        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.probes.common import H100_BF16_FLOPS, timed

        torch = self.torch
        nms_keep.launches = 0                # just before the path
        rows = {}
        for name, (_, (B, S)) in ZOO.items():
            model = self.zoo_network(name).to(
                self.dev, memory_format=torch.channels_last).eval()
            x = torch.rand((B, 3, S, S), device=self.dev).to(
                memory_format=torch.channels_last)
            with torch.inference_mode(), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                with FlopCounterMode(display=False) as fc:
                    model(x[:1])
                self.sync()
                base = torch.cuda.memory_allocated(self.dev)
                torch.cuda.reset_peak_memory_stats(self.dev)
                ms = timed(lambda: model(x), reps, self.dev)
                peak = torch.cuda.max_memory_allocated(self.dev) - base
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = model(x)
                    self.sync()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            kernel_ms = sum(e.device_time_total for e in events
                            if e.device_time_total > 0) / 1e3
            out = out if isinstance(out, tuple) else (out,)
            check(all(bool(torch.isfinite(o).all()) for o in out),
                  f"zoo_forward {name}: non-finite output")
            gflop = fc.get_total_flops() / 1e9
            rows[name] = {"B": B, "S": S, "ms_per_batch": ms,
                          "img_per_s": B / ms * 1e3,
                          "kernel_ms": kernel_ms or None,
                          "kernel_launches": len(events),
                          "peak_mem_gib_above_weights_and_input":
                              peak / 2 ** 30,
                          "gflop_per_image": gflop,
                          "bf16_peak_share": gflop * 1e9 * B
                          / (ms / 1e3) / H100_BF16_FLOPS,
                          "out_shapes": [list(o.shape) for o in out]}
            del model, x, out
            torch.cuda.empty_cache()
        return {"networks": rows, "nms_keep_launches": nms_keep.launches}

    def phase_zoo_forward(self, reps=10):
        """zoo_forward_rows in a fresh process (in_fresh_process): VGG16-BN
        and MobileNetV2 at 224² B=64, UNet at 512² B=8, CPM at 368² B=16,
        bf16; outputs finite, nms_keep's count 0."""
        r = self.in_fresh_process("zoo_forward_rows", reps)
        emit({"phase": "zoo_forward", "process": "fresh", **r,
              "nvidia_smi": nvidia_smi()})
        check(r["nms_keep_launches"] == 0,
              f"zoo_forward: nms_keep launched {r['nms_keep_launches']}")
        return r["nms_keep_launches"]

    def _recorded_dispatch(self, fn):
        """``fn()`` with ``ops.nms.dispatch_batched_nms`` recording its
        inputs; returns (fn's result, [(off_boxes, scores, iou)])."""
        from tpucv_torch.ops import nms as nms_mod

        seen, real = [], nms_mod.dispatch_batched_nms

        def recording(off, scores, iou, max_det):
            seen.append((off, scores, iou))
            return real(off, scores, iou, max_det)

        nms_mod.dispatch_batched_nms = recording
        try:
            return fn(), seen
        finally:
            nms_mod.dispatch_batched_nms = real

    def _nms_equal_cpu(self, pred, topk, tag, agnostic=False):
        """batched_non_max_suppression on ``pred`` on the card (nms_keep's
        count zeroed just before, read just after) and on the CPU's plain
        route: valid and boxes, scores equal bit for bit, classes where
        valid. Returns (launches, the card's candidates, kept)."""
        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.nms import batched_non_max_suppression

        torch = self.torch
        pred_c = pred.cpu()

        def run():
            out = batched_non_max_suppression(pred, 0.25, 0.45, 300, topk,
                                              agnostic)
            self.sync()
            return out

        nms_keep.launches = 0                # just before the path
        got, seen = self._recorded_dispatch(run)
        launches = nms_keep.launches         # just after
        ref = batched_non_max_suppression(pred_c, 0.25, 0.45, 300, topk,
                                          agnostic)
        valid = ref[3]
        check(torch.equal(got[3].cpu(), valid) and bool(valid.any()),
              f"{tag}: the valid slots differ from the CPU's")
        for name, g, r in (("boxes", got[0], ref[0]),
                           ("scores", got[1], ref[1])):
            check(torch.equal(g.cpu(), r), f"{tag}: {name} differ from the "
                                           f"CPU's plain route")
        check(torch.equal(got[2].cpu()[valid], ref[2][valid]),
              f"{tag}: classes differ from the CPU's")
        return launches, seen, int(valid.sum())

    def phase_zoo_nms(self, algo, imgs, B=8, A=8400, nc=80):
        """batched_non_max_suppression (YOLO-style: best class, gate 0.25,
        top-k, xywh -> xyxy, class offsets, greedy keep at IoU 0.45,
        max_det 300) on ``nms_cases.yolo_pred_case`` at B=8, A=8,400,
        nc=80 (clustered boxes, tied scores and classes), card against the
        CPU's plain route: at pre_nms_topk 1,024 nms_keep launches once for
        the batch (its keep mask then held against its plain version on
        the recorded candidates, and timed), class-aware and agnostic; at
        2,048 the scan, no launch. Then an Ensemble of two YOLOv8n (seeds 0
        and 1, class branch sharpened), each member its forward (bf16
        autocast) and decode (raw_to_pred), on 8 letterboxed serve images:
        A = 16,800, one launch, equal to the CPU's plain route."""
        from tpucv_torch.decode.yolov8 import raw_to_pred
        from tpucv_torch.nn.blocks import Ensemble
        from tpucv_torch.ops.nms_cases import yolo_pred_case
        from tpucv_torch.ops.preprocess import normalize_images

        torch = self.torch
        pred = torch.from_numpy(yolo_pred_case(0, B, A, nc)).to(self.dev)
        launches, row = {}, {}
        for tag, topk, agnostic in (("K1024", 1024, False),
                                    ("K1024_agnostic", 1024, True),
                                    ("K2048_scan", 2048, False)):
            n, seen, kept = self._nms_equal_cpu(pred, topk, f"zoo_nms {tag}",
                                                agnostic)
            launches[tag] = n
            row[tag] = {"K": topk, "kept": kept, "nms_keep_launches": n}
            check(n == (1 if topk <= 1024 else 0),
                  f"zoo_nms {tag}: nms_keep launched {n} times")
            check(len(seen) == 1, f"zoo_nms {tag}: {len(seen)} dispatches "
                                  f"for one batch")
            if tag == "K1024":
                off, scores, thr = seen[0]
                kt = self.time_kernel(off.contiguous(), scores, thr,
                                      "zoo_nms_B8_K1024")
            elif topk <= 1024:
                off, scores, thr = seen[0]
                self.compare_keep(off.contiguous(), scores, thr,
                                  f"zoo_nms {tag}")
        with torch.inference_mode():
            members = []
            for seed in (0, 1):
                m = algo.init_variables(seed=seed)
                sharpen_(m)
                members.append(lambda x, m=m: raw_to_pred(m(x), algo.nc))
            ens = Ensemble(members)
            x = normalize_images(self.letterboxed(algo, imgs[:8]),
                                 torch.float32)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                epred = ens(x).float()
        check(epred.shape == (8, 16800, 4 + algo.nc),
              f"zoo_nms ensemble: {tuple(epred.shape)}")
        n, _, kept = self._nms_equal_cpu(epred, 1024, "zoo_nms ensemble")
        check(n == 1, f"zoo_nms ensemble: nms_keep launched {n} times")
        launches["ensemble"] = n
        row["ensemble"] = {"A": 16800, "K": 1024, "kept": kept,
                           "nms_keep_launches": n}
        emit({"phase": "zoo_nms", "B": B, "A": A, "nc": nc, "cases": row,
              "nms_keep_ms_B8_K1024": kt["ms"],
              "plain_ms_B8_K1024": kt["plain_ms"],
              "bound_ms_B8_K1024": kt["bound_ms"],
              "equal_to_cpu_plain_route": True, "nvidia_smi": nvidia_smi()})
        return launches

    def phase_convert_model(self, run, imgs):
        """python -m tpucv_torch.convert_model on the trainer phase's
        checkpoint: extract_from_checkpoint's pure weights equal to the
        bundle's model weights, served by the predict CLI (5 images, conf
        0.25: nms_keep once an image); then --int8 (calibrated on the 16
        synthetic images, seed 7): the quantized conv count, and the
        predict CLI and the evaluate CLI (the COCO root of 64 JPEGs and a
        PNG, B=32, conf 0.001: the scan) loading it and running its int8
        convs (quant.quantized_conv called), 12 finite stats."""
        import os

        import cv2

        from tpucv_torch import convert_model as cm
        from tpucv_torch import evaluate as eval_cli
        from tpucv_torch import predict as predict_cli
        from tpucv_torch import quant
        from tpucv_torch.ckpt.checkpoint import CheckPoint
        from tpucv_torch.ops.cuda_nms import nms_keep

        torch = self.torch
        base = ROOT / "saves" / "chip_smoke" / "convert_model"
        base.mkdir(parents=True, exist_ok=True)
        bundle = run["final_path"]
        pure = str(base / "pure.ckpt")
        t0 = time.perf_counter()
        cm.main(["--model", "yolo8_det", "--src", bundle, "--dst", pure])
        extract_s = time.perf_counter() - t0
        want = CheckPoint.load_pure(bundle)
        got = CheckPoint.load_pure(pure)
        check(got.keys() == want.keys()
              and all(torch.equal(got[k], want[k]) for k in want),
              "convert_model: the pure weights differ from the bundle's")
        srcs = []
        for k, img in enumerate(imgs[:5]):
            srcs.append(str(base / f"img{k}.jpg"))
            check(cv2.imwrite(srcs[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR)),
                  f"could not write {srcs[-1]}")
        nms_keep.launches = 0                # just before the path
        res = predict_cli.main(["--model", "yolo8_det", "--ckpt", pure,
                                "--src", *srcs, "--dst", str(base / "drawn")])
        predict_launches = nms_keep.launches  # just after
        check(len(res) == 5 and all(r["saved"] for r in res),
              "convert_model: predict drew no file")
        check(predict_launches == 5, f"convert_model predict: nms_keep "
                                     f"launched {predict_launches}")

        q = str(base / "int8.ckpt")
        t0 = time.perf_counter()
        cm.main(["--model", "yolo8_det", "--src", bundle, "--dst", q,
                 "--int8"])
        int8_s = time.perf_counter() - t0
        n_int8 = sum(k.endswith(".qweight") for k in CheckPoint.load_pure(q))
        check(n_int8 > 0, "convert_model --int8 quantized no conv")
        calls, real = [], quant.quantized_conv
        quant.quantized_conv = lambda *a: calls.append(1) or real(*a)
        try:
            nms_keep.launches = 0            # just before the path
            res = predict_cli.main(["--model", "yolo8_det", "--ckpt", q,
                                    "--src", *srcs,
                                    "--dst", str(base / "drawn_int8")])
            int8_predict_launches = nms_keep.launches
            predict_calls = len(calls)
            root = base / "coco"
            n_img = write_coco_root(root, 64)
            env_was, cwd = os.environ.get("TPUCV_COCO_ROOT"), os.getcwd()
            os.environ["TPUCV_COCO_ROOT"] = str(root)
            os.chdir(base)
            try:
                nms_keep.launches = 0        # just before the path
                stats = eval_cli.main(["--model", "yolo8_det", "--dataset",
                                       "coco", "--ckpt", q, "--batch-size",
                                       "32"])
                int8_eval_launches = nms_keep.launches
            finally:
                os.chdir(cwd)
                if env_was is None:
                    os.environ.pop("TPUCV_COCO_ROOT")
                else:
                    os.environ["TPUCV_COCO_ROOT"] = env_was
        finally:
            quant.quantized_conv = real
        check(predict_calls > 0 and len(calls) > predict_calls,
              f"convert_model: the int8 file ran {predict_calls} / "
              f"{len(calls)} int8 convs in predict / evaluate")
        check(len(stats) == 12 and all(np.isfinite(v)
                                       for v in stats.values()),
              f"convert_model evaluate: {stats}")
        # the evaluate CLI's K (conf 0.001) is every anchor, at most 4096:
        # the kernel's only where the input has at most 1,024 anchors
        S = cm.export_from_registry("yolo8_det")[0].dataset.input_size
        anchors = sum((S // st) ** 2 for st in (8, 16, 32))
        eval_want = -(-n_img // 32) if anchors <= 1024 else 0
        check(int8_predict_launches == 5
              and int8_eval_launches == eval_want,
              f"convert_model int8: nms_keep {int8_predict_launches}, "
              f"{int8_eval_launches} (want 5, {eval_want})")
        emit({"phase": "convert_model", "bundle": bundle,
              "pure_equal_to_bundle": True, "extract_s": extract_s,
              "predict_images": len(srcs),
              "predict_nms_keep_launches": predict_launches,
              "int8_convs": n_int8, "int8_convert_s": int8_s,
              "int8_predict_int8_conv_calls": predict_calls,
              "int8_predict_nms_keep_launches": int8_predict_launches,
              "int8_evaluate_images": n_img, "int8_evaluate_stats": stats,
              "int8_evaluate_nms_keep_launches": int8_eval_launches,
              "nvidia_smi": nvidia_smi()})
        return {"predict": predict_launches,
                "int8_predict": int8_predict_launches,
                "int8_evaluate": int8_eval_launches}

    def trace_nms(self, log_dir):
        """batched_non_max_suppression at B=8 K=1,024 (one nms_keep launch)
        under utils/profile.py's ``trace`` into ``log_dir``: nms_keep's
        count over the traced call, the names in trace.json that are the
        NMS kernels, and the file's bytes."""
        from pathlib import Path

        from tpucv_torch.ops.cuda_nms import nms_keep
        from tpucv_torch.ops.nms import batched_non_max_suppression
        from tpucv_torch.ops.nms_cases import yolo_pred_case
        from tpucv_torch.utils.profile import trace

        torch = self.torch
        pred = torch.from_numpy(yolo_pred_case(1, 8, 8400, 80)).to(self.dev)
        batched_non_max_suppression(pred, 0.25, 0.45, 300, 1024)
        self.sync()
        nms_keep.launches = 0                # just before the path
        with trace(log_dir):
            batched_non_max_suppression(pred, 0.25, 0.45, 300, 1024)
            self.sync()
        launches = nms_keep.launches         # just after
        path = Path(log_dir) / "trace.json"
        names = {e.get("name", "") for e in
                 json.loads(path.read_text())["traceEvents"]}
        return {"launches": launches, "bytes": path.stat().st_size,
                "kernels": sorted(n for n in names
                                  if "nms_" in n and "kernel" in n)}

    def phase_profile(self, reps=5):
        """utils/profile.py on the card: ``Profile`` around UNet's bf16
        forward at 512² B=8 without and with ``fence`` on its output (the
        unfenced span ends when the launches are queued, so it must be the
        shorter; medians of ``reps``), ``.t`` the sum of the spans; then
        trace_nms in a fresh process (in_fresh_process): one nms_keep
        launch, and its trace.json names both NMS kernels."""
        from tpucv_torch.utils.profile import Profile

        torch = self.torch
        B, S = ZOO["unet"][1]
        model = self.zoo_network("unet").to(
            self.dev, memory_format=torch.channels_last).eval()
        x = torch.rand((B, 3, S, S), device=self.dev).to(
            memory_format=torch.channels_last)
        spans = {"unfenced": [], "fenced": []}
        p = Profile()
        with torch.inference_mode(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
            self.sync()
            for _ in range(reps):
                for tag in spans:
                    with p:
                        y = model(x)
                        if tag == "fenced":
                            p.fence(y)
                    spans[tag].append(p.dt * 1e3)
                    self.sync()
        med = {k: float(np.median(v)) for k, v in spans.items()}
        total = sum(sum(v) for v in spans.values()) / 1e3
        check(abs(p.t - total) <= 1e-9 * max(total, 1.0) + 1e-12,
              f"profile: .t {p.t} is not the spans' sum {total}")
        check(med["unfenced"] < med["fenced"],
              f"profile: unfenced {med['unfenced']} ms not under fenced "
              f"{med['fenced']} ms")
        del model, x, y
        torch.cuda.empty_cache()
        tr = self.in_fresh_process(
            "trace_nms", str(ROOT / "saves" / "chip_smoke" / "trace"))
        check(tr["launches"] == 1, f"profile: nms_keep launched "
                                   f"{tr['launches']}")
        check(any("build" in n for n in tr["kernels"])
              and any("walk" in n for n in tr["kernels"]),
              f"profile: the trace names {tr['kernels']}, not both NMS "
              f"kernels")
        emit({"phase": "profile", f"unet_bf16_B{B}_{S}_ms": med,
              "fenced_over_unfenced": med["fenced"] / med["unfenced"],
              "profile_t_s": p.t, "trace_process": "fresh",
              "trace_nms_kernels": tr["kernels"], "trace_bytes": tr["bytes"],
              "nms_keep_launches": tr["launches"],
              "nvidia_smi": nvidia_smi()})
        return tr["launches"]

    def bound(self, sb, ss, keep, thr):
        """Least time for the greedy keep mask on these inputs: bytes (boxes
        and scores read once, the mask written once) over HBM bandwidth,
        and the f32 operations this data needs over the f32 peak: each
        valid box is tested against the kept boxes above it, up to the
        first one that suppresses it."""
        torch = self.torch
        B, K = ss.shape
        nbytes = B * K * (16 + 4 + 1)
        x1, y1, x2, y2 = sb.unbind(-1)
        area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        ix = (torch.minimum(x2[:, :, None], x2[:, None]) -
              torch.maximum(x1[:, :, None], x1[:, None])).clamp(min=0)
        iy = (torch.minimum(y2[:, :, None], y2[:, None]) -
              torch.maximum(y1[:, :, None], y1[:, None])).clamp(min=0)
        inter = ix * iy
        iou = inter / (area[:, :, None] + area[:, None] - inter + 1e-7)
        lower = torch.ones(K, K, dtype=torch.bool, device=sb.device).tril(-1)
        cand = lower & keep[:, None, :]               # kept j above i
        tested = cand.cumsum(-1)
        hit = cand & (iou > thr)
        first = hit.float().argmax(-1, keepdim=True)
        n_tests = torch.where(hit.any(-1), tested.gather(-1, first)[..., 0],
                              tested[..., -1])
        valid = ss > 0
        pairs = int((n_tests * valid).sum())
        ops = pairs * IOU_OPS + int(valid.sum()) * AREA_OPS
        t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_FLOPS * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations", pairs)

    def time_kernel(self, sb, ss, thr, tag):
        from tpucv_torch.ops.cuda_nms import (nms_keep, nms_keep_reference,
                                              library_plan, timing_launchers)
        from tpucv_torch.probes.common import timed_queued

        torch = self.torch

        def timed(fn, iters):
            return timed_queued(fn, iters, self.dev)

        keep = self.compare_keep(sb, ss, thr, tag)
        build, walk = timing_launchers(sb, ss, thr)
        build()
        check(torch.equal(walk(), keep), f"{tag}: the split launches differ")
        # in turns, on one card: plain, kernel, build, walk, and back
        p1 = timed(lambda: nms_keep_reference(sb, ss, thr), 3)
        k1 = timed(lambda: nms_keep(sb, ss, thr), 50)
        b1 = timed(build, 50)
        w1 = timed(walk, 50)
        w2 = timed(walk, 50)
        b2 = timed(build, 50)
        k2 = timed(lambda: nms_keep(sb, ss, thr), 50)
        p2 = timed(lambda: nms_keep_reference(sb, ss, thr), 3)
        bound_ms, bound_by, pairs = self.bound(sb, ss, keep, thr)
        B, K = ss.shape
        plan = library_plan(B, K)        # what the built library launches
        row = {"tag": tag, "B": B, "K": K, "ms": min(k1, k2),
               "ms_runs": [k1, k2], "build_ms": min(b1, b2),
               "build_ms_runs": [b1, b2], "walk_ms": min(w1, w2),
               "walk_ms_runs": [w1, w2], "plain_ms": min(p1, p2),
               "plain_ms_runs": [p1, p2], "bound_ms": bound_ms,
               "bound_by": bound_by, "iou_pairs_needed": pairs,
               "build_ctas": plan.build_grid[0] * plan.build_grid[1],
               "walk_ctas": plan.walk_ctas,
               "scratch_bytes": plan.scratch_bytes,
               "valid": int((ss > 0).sum()), "kept": int(keep.sum())}
        self.shapes.append(row)
        emit({"phase": "kernel_time", **row})
        return row

    def time_scan(self, tag="yolo7_B32_K4096"):
        """``nms_scan`` at YOLOv7's decode shape (``nms_cases.scan_cases``:
        B=32, K=4,096, max_det 100, IoU 0.3): one launch, idx and valid
        equal to the plain scan's on the same CUDA tensors; then, in turns
        (plain, kernel, kernel, plain), the kernel over 50 queued launches
        and the plain scan's eager loop (~20 launches a round, host-paced),
        beside the least time its bytes and IoUs would take (the kernel is
        bound by its rounds' latency, which neither counts)."""
        from tpucv_torch.ops.cuda_scan import (library_plan, nms_scan,
                                               nms_scan_reference)
        from tpucv_torch.ops.nms_cases import scan_cases
        from tpucv_torch.probes.common import timed_queued

        torch = self.torch
        (boxes, scores), thr, max_det, diou = scan_cases()[tag]
        b = torch.from_numpy(boxes).to(self.dev)
        s = torch.from_numpy(scores).to(self.dev)
        nms_scan.launches = 0
        idx, valid = nms_scan(b, s, thr, max_det, diou)
        self.sync()
        launches = nms_scan.launches
        check(launches == 1, f"{tag}: nms_scan launched {launches} times")
        ref = nms_scan_reference(b, s, thr, max_det, diou)
        check(torch.equal(idx, ref[0]) and torch.equal(valid, ref[1]),
              f"{tag}: the scan kernel differs from the plain scan")

        def plain():
            return nms_scan_reference(b, s, thr, max_det, diou)

        def kernel():
            return nms_scan(b, s, thr, max_det, diou)

        p1 = timed_queued(plain, 3, self.dev)
        k1 = timed_queued(kernel, 50, self.dev)
        k2 = timed_queued(kernel, 50, self.dev)
        p2 = timed_queued(plain, 3, self.dev)
        B, K = s.shape
        kept = int(valid.sum())
        t_bytes = (B * K * (16 + 4) + B * max_det * 5) / \
            H100_HBM_BYTES_PER_S * 1e3
        t_ops = kept * K * IOU_OPS / H100_FP32_FLOPS * 1e3
        row = {"tag": tag, "B": B, "K": K, "max_det": max_det, "iou": thr,
               "diou": diou, "launches": launches, "ms": min(k1, k2),
               "ms_runs": [k1, k2], "us_per_round": min(k1, k2) * 1e3 /
               max(int(valid.sum(1).max()), 1),
               "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "plan": library_plan(B, K)._asdict(),
               "valid": int((s > 0).sum()), "kept": kept}
        emit({"phase": "scan_time", **row})
        return row


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_trainer_run(dev, tag):
    """yolo8_det's trainer as shipped for DDP_STEPS steps (``nccl_zero``:
    with ``train.zero_opt``), writing under saves/chip_smoke/ddp_<tag>:
    its final weights, EMA and Adam state, on the CPU."""
    import torch

    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.ckpt.checkpoint import replicated_optimizer_state

    cfg, _, cls = export_from_registry("yolo8_det")
    root = ROOT / "saves" / "chip_smoke" / f"ddp_{tag}"
    cfg.train.save_path = str(root / "saves")
    cfg.log.root = str(root / "log")
    cfg.log.tensorboard_on = False
    cfg.train.zero_opt = tag == "nccl_zero"
    trainer = cls(cfg, device=dev)
    state = trainer.train(max_steps=DDP_STEPS)
    out = {f"model.{k}": v.cpu() for k, v in
           state.model.state_dict().items()}
    out.update({f"ema.{k}": v.cpu() for k, v in (state.ema or {}).items()})
    opt = replicated_optimizer_state(state.optimizer)
    for i, s in opt["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v).cpu()
                    for k, v in s.items()})
    return out


def ddp_model(name, dev, seed=0, scale=None):
    from tpucv_torch.builder import export_from_registry

    cfg, algo_cls, _ = export_from_registry(name)
    cfg.train.mixed_precision = False
    if scale is not None:
        cfg.arch.model_type = scale
    return algo_cls(cfg, device=dev).init_variables(seed=seed)


def ddp_run(name, dev, mesh=None, zero=False, ckpt=None):
    """DDP_STEPS f32 steps of family ``name`` (seed-0 weights, Adam 1e-3,
    EMA 0.9999) on bench's family batch of DDP_BATCH at the shipped size,
    or on this rank's rows of it under ``mesh``: every step's metrics and
    host-clock ms (synced), the final weights, EMA and the moments this
    rank holds, on the CPU; ``ckpt``: the state saved there at the end."""
    import torch

    from tpucv_torch import bench
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.ckpt.checkpoint import CheckPoint
    from tpucv_torch.parallel import mesh as pmesh
    from tpucv_torch.train.state import TrainState, make_train_step

    cfg, algo_cls, _ = export_from_registry(name)
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device=dev)
    S = cfg.dataset.input_size
    batch = bench.family_batch(name, cfg, DDP_BATCH, S, dev, torch.float32)
    if mesh is not None:
        rows = torch.from_numpy(mesh.rows(DDP_BATCH)).to(dev)
        batch = {k: v[rows] for k, v in batch.items()}
    state = TrainState.create(algo.init_variables(seed=0), 1e-3,
                              use_ema=True, zero_opt=zero)
    step = make_train_step(algo.build_loss(), device=dev, ema_decay=0.9999,
                           mixed_precision=False, mesh=mesh)
    metrics, ms = [], []
    for _ in range(DDP_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == 1:
            stats1 = {k: v.cpu().clone() for k, v in
                      state.model.state_dict().items() if "running" in k}
    if ckpt is not None:
        CheckPoint.save(state, ckpt)
    opt = state.optimizer
    inner = opt.optim if pmesh.is_zero(opt) else opt
    names = {id(p): n for n, p in state.params.items()}
    return {"metrics": metrics, "step_ms": ms, "stats1": stats1,
            "sd": {k: v.detach().cpu() for k, v in
                   state.model.state_dict().items()},
            "ema": {k: v.cpu() for k, v in state.ema.items()},
            "moments": {names[id(p)]: {k: v.cpu() for k, v in s.items()}
                        for p, s in inner.state.items()},
            "moment_bytes": pmesh.moment_bytes(opt)}


def ddp_rank(rank, world, port, out_dir):
    """One of ``world`` ranks over gloo on cuda:0: ``ddp_run`` of each of
    DDP_FAMILIES with and without ZeRO (yolo8_det's ZeRO run saves
    ``zero.ckpt``), written to ``out_dir/rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from tpucv_torch.parallel import multihost
    from tpucv_torch.parallel.mesh import DataMesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                         backend="gloo")
    try:
        mesh = DataMesh.current()
        out = {name: {zero: ddp_run(
            name, dev, mesh, zero,
            str(Path(out_dir) / "zero.ckpt")
            if (name, zero) == ("yolo8_det", True) else None)
            for zero in (False, True)} for name in DDP_FAMILIES}
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def ddp_compare(name, got, ref, phase="ddp", steps=DDP_STEPS):
    """A two-rank run of ``steps`` steps against one process's on the
    global batch, held to the DDP_* bounds; the measured differences."""
    count = "num_fg" if name == "yolo8_det" else "num_pos"
    g0, r0 = got["metrics"][0], ref["metrics"][0]
    check(g0[count] == r0[count],
          f"{phase} {name}: {count} {g0[count]} against {r0[count]}")
    loss_rel = [abs(g["loss"] - r["loss"]) / abs(r["loss"])
                for g, r in zip(got["metrics"], ref["metrics"])]
    stats = list(ref["stats1"])
    stat1_err = max(float((got["stats1"][k] - ref["stats1"][k]).abs().max())
                    for k in stats)
    stat_rel = max(float((got["sd"][k] - ref["sd"][k]).abs().max() /
                         ref["sd"][k].abs().max()) for k in stats)
    diffs = torch_cat_abs(got["sd"], ref["sd"], [
        k for k, v in ref["sd"].items()
        if k not in stats and v.is_floating_point()])
    res = {"loss_rel_err_by_step": loss_rel,
           "bn_stats_step1_max_abs_err": stat1_err,
           "bn_stats_final_max_rel_err": stat_rel,
           "param_max_abs_err": float(diffs.max()),
           "param_median_abs_err": float(diffs.median())}
    check(loss_rel[0] <= DDP_LOSS_REL[0] and
          max(loss_rel[1:]) <= DDP_LOSS_REL[1],
          f"{phase} {name}: losses {loss_rel} relative from one process")
    check(stat1_err <= DDP_STAT1_ATOL and stat_rel <= DDP_STAT_REL,
          f"{phase} {name}: BN statistics {res} from one process")
    check(res["param_max_abs_err"] <= 2 * steps * 1.05 * 1e-3 and
          res["param_median_abs_err"] <= DDP_PARAM_MEDIAN,
          f"{phase} {name}: parameters {res} from one process")
    return res


# ------------------------------------------------- the mesh's model axis --
def model_axis_run(dev, mesh=None, ckpt=None):
    """MODEL_AXIS_STEPS f32 steps of yolo8_det at scale MODEL_AXIS_SCALE
    and MODEL_AXIS_SIZE² (seed-0 weights, Adam 1e-3, EMA 0.9999) on bench's
    family batch of MODEL_AXIS_BATCH, or on this rank's rows of it with
    the large kernels sharded over ``mesh``'s model axis: every step's
    metrics and synced host-clock ms, the BN statistics after the first
    step, the whole weights, EMA and Adam moments after the last (on the
    CPU), the parameter bytes this process holds and the count of sharded
    kernels; ``ckpt``: the state saved there (collective)."""
    import torch

    from tpucv_torch import bench
    from tpucv_torch.builder import export_from_registry
    from tpucv_torch.ckpt.checkpoint import CheckPoint
    from tpucv_torch.parallel import mesh as pmesh
    from tpucv_torch.train.state import TrainState, make_train_step

    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    cfg.arch.model_type = MODEL_AXIS_SCALE
    cfg.dataset.input_size = S = MODEL_AXIS_SIZE
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device=dev)
    model = algo.init_variables(seed=0)
    batch = bench.family_batch("yolo8_det", cfg, MODEL_AXIS_BATCH, S, dev,
                               torch.float32)
    if mesh is not None:
        pmesh.shard_model(model, mesh)
        rows = torch.from_numpy(mesh.rows(MODEL_AXIS_BATCH)).to(dev)
        batch = {k: v[rows] for k, v in batch.items()}
    state = TrainState.create(model, 1e-3, use_ema=True, mesh=mesh)
    step = make_train_step(algo.build_loss(), device=dev, ema_decay=0.9999,
                           mixed_precision=False, mesh=mesh)
    metrics, ms = [], []
    for _ in range(MODEL_AXIS_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == 1:
            stats1 = {k: v.cpu().clone() for k, v in
                      state.model.state_dict().items() if "running" in k}
    if ckpt is not None:
        CheckPoint.save(state, ckpt)
    shards = pmesh.model_shards(model)

    def whole(name, t):
        return (shards[name].whole(t) if name in shards else t).cpu()

    names = {id(p): n for n, p in state.params.items()}
    return {"metrics": metrics, "step_ms": ms, "stats1": stats1,
            "sd": {k: v.detach().cpu() for k, v in pmesh.whole_tensors(
                state.model.state_dict(), shards).items()},
            "ema": {k: whole(k, v) for k, v in state.ema.items()},
            "moments": {names[id(p)]: {k: whole(names[id(p)], v)
                                       for k, v in st.items()
                                       if k in ("exp_avg", "exp_avg_sq")}
                        for p, st in state.optimizer.state.items()},
            "param_bytes": pmesh.param_bytes(model),
            "sharded_kernels": len(shards)}


def sharded_infer_setup(dev):
    """YOLOv8n's serving algorithm in f32, its seed-0 model with the class
    branch sharpened (``sharpen_``) and SHARDED_INFER_BATCH raw 640x640
    images drawn from a seed."""
    import torch

    from tpucv_torch.builder import export_from_registry

    cfg, algo_cls, _ = export_from_registry("yolo8_det")
    cfg.train.mixed_precision = False
    algo = algo_cls(cfg, device=dev)
    model = algo.init_variables(seed=0)
    sharpen_(model)
    imgs = np.random.default_rng(5).integers(
        0, 256, (SHARDED_INFER_BATCH, 640, 640, 3), dtype=np.uint8)
    return algo, model, torch.from_numpy(imgs).to(dev)


def sharded_infer_rank(dev, mesh):
    """``parallel.mesh.sharded_infer`` of the serving program over
    ``mesh``'s data axis: the global outputs, nms_keep's launches in the
    one call (zeroed just before, read just after) and ms a call."""
    from tpucv_torch.ops.cuda_nms import nms_keep
    from tpucv_torch.parallel.mesh import sharded_infer
    from tpucv_torch.probes.common import timed

    algo, model, imgs = sharded_infer_setup(dev)
    infer = algo.make_infer_fn()
    nms_keep.launches = 0
    out = sharded_infer(infer, model, imgs, mesh)
    launches = nms_keep.launches
    ms = timed(lambda: sharded_infer(infer, model, imgs, mesh), 5, dev)
    return {"out": [t.cpu() for t in out], "nms_launches": launches,
            "ms": ms}


def spatial_net(params, x, split):
    """tpucv's spatial test net (``tests/test_parallel.py:302-310``) on
    NHWC ``x``: 3x3 stride-2 SAME conv to 8, ReLU, 3x3 stride-2 SAME conv
    to 16, 2x2 average pool, 3x3 SAME conv to 16, flax's padding."""
    from tpucv_torch.parallel import spatial as sp

    x = x.permute(0, 3, 1, 2)
    H = x.shape[2] * (split.n if split is not None else 1)
    W = x.shape[3]
    (w0, b0), (w1, b1), (w2, b2) = params
    x = sp.conv2d(x, w0, b0, 2, sp.same_padding(H, 3, 2),
                  sp.same_padding(W, 3, 2), split).relu()
    H, W = H // 2, W // 2
    x = sp.conv2d(x, w1, b1, 2, sp.same_padding(H, 3, 2),
                  sp.same_padding(W, 3, 2), split)
    x = sp.avg_pool2d(x, 2, 2, split)
    H, W = H // 4, W // 4
    x = sp.conv2d(x, w2, b2, 1, sp.same_padding(H, 3, 1),
                  sp.same_padding(W, 3, 1), split)
    return x.permute(0, 2, 3, 1)


def spatial_case(dev, mesh=None, dtype=None):
    """tpucv's spatial net (B=4, 32², weights from a seed) and YOLOv8n in
    train mode (640², B=2, seed-0 weights, f32 or ``dtype``), each on
    this rank's rows of the batch and of the height over ``mesh`` (None:
    one process on all), the outputs gathered and the gradients summed
    over the ranks: loss, outputs, gradients and (YOLOv8n) BN statistics,
    on the CPU."""
    import math

    import torch

    from tpucv_torch.models.yolov8 import Yolo8
    from tpucv_torch.parallel import mesh as pmesh
    from tpucv_torch.parallel import spatial as sp

    split = None if mesh is None else sp.HeightSplit.of(mesh)
    rng = np.random.default_rng(11)

    dtype = dtype or torch.float32

    def run(forward, params, x, loss_fn):
        x = torch.from_numpy(x).to(dev, dtype)
        if mesh is not None:
            rows = torch.from_numpy(mesh.rows(x.shape[0])).to(dev)
            x = sp.split_height(x[rows], split, 1)
        out = forward(x)
        if mesh is not None:
            out = pmesh.gather_rows(sp.gather_height(out, split, 1), mesh)
        loss = loss_fn(out)
        loss.backward()
        if mesh is not None:
            pmesh.all_reduce_grads(params)
        outs = out if isinstance(out, tuple) else (out,)
        return {"loss": float(loss), "out": [o.detach().cpu() for o in outs],
                "grads": [p.grad.cpu() for p in params]}

    g = torch.Generator().manual_seed(7)
    params = []
    for o, i in ((8, 3), (16, 8), (16, 16)):
        params.append((
            (torch.randn(o, i, 3, 3, generator=g) / math.sqrt(9 * i))
            .to(dev, dtype).requires_grad_(),
            (torch.randn(o, generator=g) * 0.1).to(dev, dtype)
            .requires_grad_()))
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    net = run(lambda v: spatial_net(params, v, split),
              [t for pair in params for t in pair], x,
              lambda o: o.square().sum())
    model = Yolo8("n", nc=80).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev, dtype).train()
    if mesh is not None:
        sp.enable_spatial(model, mesh)
    x = rng.random((2, SPATIAL_SIZE, SPATIAL_SIZE, 3), dtype=np.float32)
    yolo = run(model, [p for p in model.parameters() if p.requires_grad], x,
               lambda out: sum(o.square().mean() for o in out))
    yolo["stats"] = {k: v.cpu() for k, v in model.state_dict().items()
                     if "running" in k}
    return {"net": net, "yolo8n": yolo}


def mesh_rank(rank, world, init, out_dir):
    """One of ``world`` gloo ranks on cuda:0 (TF32 off): ``model_axis_run``
    on a (1, 2) mesh (saving ``model_axis.ckpt``), ``sharded_infer_rank``
    on (2, 1) and ``spatial_case`` on (1, 2), each with nms_keep's launches
    on this rank (zeroed just before, read just after), written to
    ``out_dir/rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from tpucv_torch.ops.cuda_nms import nms_keep
    from tpucv_torch.parallel import multihost
    from tpucv_torch.parallel.mesh import DataMesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(init, world, rank, backend="gloo")
    try:
        m12 = DataMesh.current(MESH_WORLD)
        m21 = DataMesh.current(1)
        nms_keep.launches = 0                # just before the path
        axis = model_axis_run(dev, m12, str(Path(out_dir) /
                                            "model_axis.ckpt"))
        axis["nms_launches"] = nms_keep.launches     # just after
        infer = sharded_infer_rank(dev, m21)
        nms_keep.launches = 0                # just before the path
        spatial = spatial_case(dev, m12)
        spatial["nms_launches"] = nms_keep.launches  # just after
        out = {"model_axis": axis, "sharded_infer": infer,
               "spatial": spatial}
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def grad_share(got, ref):
    """The largest |got - ref| over a tensor's largest |ref|, over paired
    tensors (``ref`` float64)."""
    return max(float((g.double() - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def max_excess(got, ref, rel):
    """The largest |got - ref| beyond ``rel * (1 + |ref|)``, elementwise
    (<= 0 when every element is within), over paired tensors."""
    return max(float(((g.float() - r.float()).abs()
                      - rel * (1 + r.float().abs())).max())
               for g, r in zip(got, ref))


def torch_cat_abs(a, b, keys):
    import torch

    return torch.cat([(a[k] - b[k]).abs().flatten() for k in keys])


def in_turns(plain, kernel, dev, n_plain, n_kernel):
    """Plain, kernel, kernel, plain on one card; the lower of each pair."""
    from tpucv_torch.probes.common import timed

    p1 = timed(plain, n_plain, dev)
    k1 = timed(kernel, n_kernel, dev)
    k2 = timed(kernel, n_kernel, dev)
    p2 = timed(plain, n_plain, dev)
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2]}


def phase_probe_bw(torch) -> dict:
    """probe_bw's main path, then add_one bit for bit against x + 1 in the
    six views of the probe's array, timed against it and its bound."""
    from tpucv_torch.ops.stream import (add_one, add_one_reference,
                                        library_plan)
    from tpucv_torch.probes import probe_bw
    from tpucv_torch.probes.common import stream_bound_ms, timed

    dev = torch.device("cuda")
    add_one.launches = 0                 # just before the main path
    probe_rows = probe_bw.main([])
    launches = add_one.launches          # just after
    check(launches > 0, "probe_bw did not launch add_one")
    emit({"phase": "probe_bw_main", "add_one_launches": launches,
          "rows": probe_rows})

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((probe_bw.TOT, 128), generator=g, device=dev) \
        .to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()
    bound_ms = stream_bound_ms(nbytes)
    rows = []
    for r, c, bh in probe_bw.views(probe_bw.TOT):
        xx = x.view(r, c)
        bad = probe_bw.mismatches(xx)
        check(bad == 0, f"add_one ({r}x{c}): {bad} elements differ from x + 1")
        row = {"view": [r, c], "tpu_bh": bh, "mismatches": bad,
               **in_turns(lambda: add_one_reference(xx), lambda: add_one(xx),
                          dev, 50, 50),
               "library_ms": timed(lambda: torch.add(xx, 1), 50, dev),
               "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes}
        row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        row["library_gb_per_s"] = nbytes / (row["library_ms"] * 1e-3) / 1e9
        rows.append(row)
    plan = library_plan(x.numel())       # what the built library launches
    chosen = {"threads": plan.threads, "ctas": plan.grid,
              "index_bits": plan.index_bits}
    emit({"phase": "probe_bw", **chosen, "views": rows})
    main_row = rows[0]
    return {"name": "add_one", "route": "cuda",
            "source": "tpucv_torch/csrc/stream.cu",
            "replaces": "scripts/probe_pallas_bw.py:86 ident_kernel "
                        "(pallas_call :94)",
            "launches": launches, "mismatches": 0, "max_abs_err": 0.0,
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            "gb_per_s": main_row["gb_per_s"], **chosen, "shapes": rows}


# the five timing-only decompositions: (the script's name, variant), halo
# mode, the scripts' bhp=1280 (8 rows at 64ch 320^2)
TIMING_VARIANTS = [("parts nohalo", "nohalo"), ("parts noshift", "noshift"),
                   ("parts gemm1", "gemm1"), ("v2 fullnomask", "nomask"),
                   ("v2 slab2nomask", "nomask")]


def phase_probe_conv(torch) -> dict:
    """The three conv probes' main paths, then conv3x3 against its plain
    definitions at the probes' shapes, timed against them, F.conv2d and
    the bound."""
    from tpucv_torch.ops.conv3x3 import (MODES, _ctas_on_card, conv3x3,
                                         conv3x3_reference, plan)
    from tpucv_torch.probes import probe_conv, probe_conv_parts, probe_conv_v2
    from tpucv_torch.probes.common import (compare, conv_bound, conv_inputs,
                                           library_conv, tile_rows_of, timed)

    dev = torch.device("cuda")
    launches = {}
    for mod in (probe_conv, probe_conv_parts, probe_conv_v2):
        name = mod.__name__.rsplit(".", 1)[-1]
        conv3x3.launches = 0             # just before the main path
        probe_rows = mod.main([])
        launches[name] = conv3x3.launches    # just after
        check(launches[name] > 0, f"{name} did not launch conv3x3")
        emit({"phase": f"{name}_main", "conv3x3_launches": launches[name],
              "rows": probe_rows})

    rows = []

    def check_and_time(tag, x, w, plain, mode, variant, tile, lib=None):
        got = conv3x3(x, w, mode=mode, variant=variant, tile_rows=tile)
        bad, err, scale = compare(got, plain)
        check(bad == 0, f"conv3x3 {tag} {mode} {variant}: {bad} elements "
                        f"off the plain version (max {err} at max {scale})")
        B, S, _, C = x.shape
        bound_ms, bound_by = conv_bound(B, S, C)
        p = plan(S, C)
        row = {"tag": tag, "B": B, "S": S, "C": C, "mode": mode,
               "variant": variant, "tile_rows": tile, "mismatches": bad,
               "max_abs_err": err, "max_abs_plain": scale,
               "smem_bytes": p.smem_bytes, "ring_rows": p.ring_rows,
               "col_tile": p.col_tile, "warps": p.warps,
               "products": "wgmma" if p.wgmma else "mma.sync",
               "ctas_per_sm": _ctas_on_card(C, dev.index or 0)[1],
               "bound_ms": bound_ms,
               "bound_by": bound_by,
               **in_turns(lambda: conv3x3_reference(x, w, variant, tile),
                          lambda: conv3x3(x, w, mode=mode, variant=variant,
                                          tile_rows=tile), dev, 2, 20)}
        if lib is not None:
            _, lerr, lscale = compare(got, lib)
            row["relerr_vs_library"] = lerr / lscale
            check(lerr / lscale <= probe_conv.LIBRARY_RELERR,
                  f"conv3x3 {tag} {mode}: relerr {lerr / lscale} against "
                  f"F.conv2d")
            row["library_ms"] = timed(lambda: library_conv(x, w), 20, dev)
        rows.append(row)
        emit({"phase": "probe_conv", **row})
        return row

    for tag, B, S, C, bhp in probe_conv.SHAPES:
        x, w = conv_inputs(B, S, C, dev, seed=1)
        plain, lib = conv3x3_reference(x, w), library_conv(x, w)
        for mode in MODES:
            tile = tile_rows_of(bhp, C, S) if mode == "halo" else None
            row = check_and_time(tag, x, w, plain, mode, "full", tile, lib)
        del plain, lib
    main_row = row                       # probe 64ch 320^2 B32, rolling
    B, S, C = probe_conv_parts.B, probe_conv_parts.S, probe_conv_parts.C
    x, w = conv_inputs(B, S, C, dev, seed=1)
    tile = tile_rows_of(1280, C, S)
    for tag, variant in TIMING_VARIANTS:
        check_and_time(tag, x, w, conv3x3_reference(x, w, variant, tile),
                       "halo", variant, tile)
    return {"name": "conv3x3", "route": "cuda",
            "source": "tpucv_torch/csrc/conv3x3.cu",
            "replaces": "scripts/probe_pallas_conv_parts.py:54 "
                        "make(BHP, mode).kernel (pallas_call :96); "
                        "scripts/probe_pallas_conv_v2.py:69 "
                        "make_roll(BHP).kernel (pallas_call :108) and :134 "
                        "make(BHP, mode).kernel (pallas_call :203); "
                        "scripts/probe_pallas_conv.py:81 "
                        "build_packed_conv(B, S, C, BHP).kernel "
                        "(pallas_call :122)",
            "launches": sum(launches.values()), "launches_by_probe": launches,
            "mismatches": sum(r["mismatches"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "main_shape":
                f"{main_row['tag']} {main_row['mode']}", "shapes": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # the port: absent when this file is copied out of the repository
    from tpucv_torch import _build
    from tpucv_torch.algorithms import centernet as cn_algo_mod
    from tpucv_torch.ckpt.checkpoint import CheckPoint
    from tpucv_torch.decode import centernet as cn_decode
    from tpucv_torch.ops import nms as nms_mod
    from tpucv_torch.ops.cuda_nms import nms_keep

    # the whole output, beside the end that a caller may keep
    sys.stdout = Tee(sys.stdout,
                     Path(__file__).resolve().parent / "chiprun_out" /
                     "chip_smoke.log")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = _build.build(["nms", "nms_scan", "stream", "conv3x3"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": [_build.lib_path(k).name for k in logs],
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "ptxas info" in ln or "spill" in ln]})

    smoke = Smoke(torch)
    smoke.phase_kernel()
    algo, model = smoke.serving_setup()
    smoke.phase_forward_f32(model)
    imgs, results, launches = smoke.phase_serve(algo, model)
    (serve_off, serve_scores), thr = smoke.phase_serve_vs_plain(
        algo, model, imgs, results)
    smoke.phase_breakdown(algo, model, imgs)
    bench_offs, bench_thr = smoke.phase_bench(model)

    main_row = smoke.time_kernel(serve_off, serve_scores, thr,
                                 "serve_B8_K1024")
    smoke.time_kernel(*bench_offs[0], bench_thr, "bench_B128_K512")
    smoke.time_kernel(*bench_offs[1], bench_thr, "bench_B128_K1024")
    scan_row = smoke.time_scan()

    bw = phase_probe_bw(torch)
    conv = phase_probe_conv(torch)
    smoke.phase_train_parity()
    smoke.phase_train()
    aug = smoke.phase_augment()
    run = smoke.phase_trainer(aug)
    ckpt_launches = smoke.phase_ckpt_serve(run, imgs)
    sharp = smoke.sharpened_ckpt(run)
    predict_launches = smoke.phase_predict(sharp, imgs)
    evaluate_launches, float_stats = smoke.phase_evaluate(sharp)
    eval_map_launches = smoke.phase_eval_map(run)
    smoke.phase_resume(run)       # its final save replaces the run's
    smoke.phase_seg_pose_parity()
    fam = {}
    for name in ("yolo8_seg", "yolo8_pose"):
        fam_run = smoke.phase_family_trainer(name)
        sharp_ckpt = smoke.family_sharpened(name, fam_run)
        fam[name] = (fam_run, sharp_ckpt,
                     smoke.phase_family_predict(name, sharp_ckpt, imgs))
    seg_eval_launches = smoke.phase_seg_evaluate(fam["yolo8_seg"][1])
    pose_eval_launches, pose_map_launches = smoke.phase_pose_evaluate(
        fam["yolo8_pose"][1], fam["yolo8_pose"][0])
    smoke.phase_int8_parity(imgs)
    int8_bench_launches = smoke.phase_int8_bench(model)
    int8_serve_launches = smoke.phase_int8_serve(sharp, imgs)
    int8_predict_launches = smoke.phase_int8_predict(sharp)
    int8_eval_launches = smoke.phase_int8_evaluate(sharp, float_stats)

    y7_algo, y7_model = smoke.yolo7_setup()
    smoke.phase_yolo7_parity(y7_algo, y7_model)
    sharpen_yolo7_(y7_model)
    y7_decode_launches = smoke.phase_yolo7_decode(y7_algo, y7_model, imgs)
    y7_run = smoke.phase_family_trainer("yolo7")
    y7_sharp = smoke.family_sharpened("yolo7", y7_run)
    y7_predict_launches = smoke.phase_scan_predict(
        "yolo7", y7_sharp, imgs, 4096, (nms_mod, "dispatch_batched_nms"))
    y7_model.load_state_dict(CheckPoint.load_pure(y7_sharp))
    _, _, y7_serve_launches = smoke.phase_serve(
        y7_algo, y7_model, model_name="yolo7", phase="yolo7_serve", scan=True)
    y7_eval_launches = smoke.phase_family_evaluate("yolo7", y7_sharp, K=4096)
    y7_map_launches = smoke.phase_family_eval_map(
        y7_run, y7_sharp, "yolo7_eval_map", K=4096)
    smoke.phase_int8_parity(imgs, names=("yolo7",), phase="yolo7_int8")
    y7_int8_launches = smoke.phase_family_int8_predict(
        "yolo7", y7_sharp, 4096, yolo7_int8_outputs, INT8_COS_MIN_YOLO7)

    ssd_algo, ssd_model = smoke.ssd_setup()
    smoke.phase_ssd_parity(ssd_algo, ssd_model)
    sharpen_ssd_(ssd_model)
    ssd_decode_launches = smoke.phase_ssd_decode(ssd_algo, ssd_model, imgs)
    ssd_run = smoke.phase_family_trainer("ssd")
    ssd_sharp = smoke.family_sharpened("ssd", ssd_run)
    ssd_predict_launches = smoke.phase_family_predict("ssd", ssd_sharp, imgs)
    ssd_model.load_state_dict(CheckPoint.load_pure(ssd_sharp))
    ssd_imgs, ssd_results, ssd_serve_launches = smoke.phase_serve(
        ssd_algo, ssd_model, model_name="ssd", phase="ssd_serve")
    smoke.phase_serve_vs_plain(ssd_algo, ssd_model, ssd_imgs, ssd_results,
                               phase="ssd_serve_vs_plain")
    ssd_eval_launches = smoke.phase_family_evaluate("ssd", ssd_sharp, K=1024)
    ssd_map_launches = smoke.phase_family_eval_map(
        ssd_run, ssd_sharp, "ssd_eval_map", K=1024)
    smoke.phase_int8_parity(imgs, names=("ssd",), phase="ssd_int8")
    ssd_int8_launches = smoke.phase_family_int8_predict(
        "ssd", ssd_sharp, 1024, ssd_int8_outputs, INT8_COS_MIN_SSD)

    cn_algo, cn_model = smoke.centernet_setup()
    smoke.phase_centernet_parity(cn_algo, cn_model)
    sharpen_centernet_(cn_model)
    cn_decode_launches = smoke.phase_centernet_decode(cn_algo, cn_model, imgs)
    cn_run = smoke.phase_family_trainer("centernet")
    cn_sharp = smoke.family_sharpened("centernet", cn_run)
    cn_scan = (cn_decode, "nms")
    cn_predict_launches = smoke.phase_scan_predict(
        "centernet", cn_sharp, imgs, cn_algo.cfg.decode.K, cn_scan)
    cn_model.load_state_dict(CheckPoint.load_pure(cn_sharp))
    cn_imgs, cn_results, cn_serve_launches = smoke.phase_serve(
        cn_algo, cn_model, model_name="centernet", phase="centernet_serve",
        scan=True)
    smoke.phase_serve_vs_direct(cn_algo, cn_model, cn_imgs, cn_results,
                                "centernet_serve_vs_direct")
    cn_eval_launches = smoke.phase_family_evaluate(
        "centernet", cn_sharp, K=100, scan=cn_scan,
        decode=(cn_algo_mod, "decode_centernet"))
    cn_map_launches = smoke.phase_family_eval_map(
        cn_run, cn_sharp, "centernet_eval_map", K=100)
    smoke.phase_int8_parity(imgs, names=("centernet",),
                            phase="centernet_int8")
    cn_int8_launches = smoke.phase_family_int8_predict(
        "centernet", cn_sharp, 100, centernet_int8_outputs,
        INT8_COS_MIN_CENTERNET)

    dl_algo, dl_model = smoke.deeplab_setup()
    dl = {"deeplab_parity (B=2 and 16)": smoke.phase_deeplab_parity(
        dl_algo, dl_model)}
    del dl_model
    nms_keep.launches = 0                    # just before the path
    dl_run = smoke.phase_family_trainer("deeplabv3plus")
    dl["deeplab_trainer"] = nms_keep.launches
    check(dl["deeplab_trainer"] == 0, "the deeplab trainer launched nms_keep")
    dl["deeplab_step (B=16)"] = smoke.phase_deeplab_step()
    dl_ckpt = dl_run["final_path"]
    dl["deeplab_predict"] = smoke.phase_deeplab_predict(dl_ckpt, imgs)
    dl["deeplab_evaluate (B=32, and --int8)"] = smoke.phase_deeplab_evaluate(
        dl_ckpt)
    dl["deeplab_eval (evaluate_loop)"] = smoke.phase_deeplab_eval(dl_run)
    dl["deeplab_int8"] = smoke.phase_deeplab_int8(dl_algo, dl_ckpt, imgs)
    dl["deeplab_bench"] = smoke.phase_deeplab_bench()

    cls = {"cls_parity (B=2 and 64)": smoke.phase_cls_parity()}
    cls_runs = {}
    for name in CLASSIFIERS:
        nms_keep.launches = 0                # just before the path
        cls_runs[name] = smoke.phase_family_trainer(name)
        cls[TRAINED[name]["phase"]] = nms_keep.launches
        check(cls[TRAINED[name]["phase"]] == 0,
              f"the {name} trainer launched nms_keep")
    cls["cls_step (B=16)"] = smoke.phase_cls_step()
    nms_keep.launches = 0
    cls_ckpts = smoke.cls_trained(cls_runs)
    cls["cls_trained"] = nms_keep.launches
    cls["cls_predict"] = smoke.phase_cls_predict(cls_ckpts, imgs)
    cls["cls_evaluate (B=64)"] = smoke.phase_cls_evaluate(cls_ckpts)
    cls["cls_eval (evaluate_loop)"] = smoke.phase_cls_eval(cls_runs)

    export = smoke.phase_export(algo, model, imgs)
    nms_keep.launches = 0                    # just before the path
    smoke.phase_ddp()
    ddp_launches = nms_keep.launches
    check(ddp_launches == 0, "the ddp phase launched nms_keep")
    scale_launches = smoke.phase_scales(bench_offs[0], bench_thr)
    y7x_launches = smoke.phase_variant("yolo7x")
    ssd512_launches = smoke.phase_variant("ssd512")
    mesh_launches = smoke.phase_mesh()
    smoke.phase_yolo3_parity()
    y3_ckpt, y3_train_launches = smoke.phase_yolo3_trainer()
    y3_algo, y3_model = smoke.yolo3_sharpened(y3_ckpt)
    y3_predict_launches = smoke.phase_yolo3_predict(y3_algo, y3_model, imgs)
    y3_eval_launches = smoke.phase_yolo3_evaluate(y3_algo, y3_model)
    t_zoo = time.perf_counter()
    zoo_parity_launches = smoke.phase_zoo_parity()
    zoo_forward_launches = smoke.phase_zoo_forward()
    zoo_nms_launches = smoke.phase_zoo_nms(algo, imgs)
    convert_launches = smoke.phase_convert_model(run, imgs)
    profile_launches = smoke.phase_profile()
    emit({"phase": "zoo_phases", "seconds": time.perf_counter() - t_zoo})
    shutil.rmtree(ROOT / "saves" / "chip_smoke", ignore_errors=True)

    emit({"phase": "total", "seconds": time.perf_counter() - T0})
    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "nms_keep", "route": "cuda",
        "source": "tpucv_torch/csrc/nms.cu",
        "replaces": "tpucv/ops/pallas_nms.py:28 _nms_kernel",
        "launches": launches,
        "launches_by_path": {"serve": launches, "ckpt_serve": ckpt_launches,
                             "predict": predict_launches,
                             "evaluate (K=4096: the scan)": evaluate_launches,
                             "eval_map": eval_map_launches,
                             "seg_predict": fam["yolo8_seg"][2],
                             "pose_predict": fam["yolo8_pose"][2],
                             "pose_eval_map": pose_map_launches,
                             "seg_evaluate (K=4096: the scan)":
                                 seg_eval_launches,
                             "pose_evaluate (K=4096: the scan)":
                                 pose_eval_launches,
                             "int8_bench": int8_bench_launches,
                             "int8_serve": int8_serve_launches,
                             "int8_predict": int8_predict_launches,
                             "int8_evaluate (K=4096: the scan)":
                                 int8_eval_launches,
                             "yolo7_decode at 128² (K=1008)":
                                 y7_decode_launches,
                             "yolo7_predict (K=4096: the scan)":
                                 y7_predict_launches,
                             "yolo7_serve (K=4096: the scan)":
                                 y7_serve_launches,
                             "yolo7_evaluate (K=4096: the scan)":
                                 y7_eval_launches,
                             "yolo7_eval_map (K=4096: the scan)":
                                 y7_map_launches,
                             "yolo7_int8_predict (K=4096: the scan)":
                                 y7_int8_launches,
                             "ssd_decode (B=8, K=1024)": ssd_decode_launches,
                             "ssd_predict (B=1, K=1024)":
                                 ssd_predict_launches,
                             "ssd_serve (B=8, K=1024)": ssd_serve_launches,
                             "ssd_evaluate (B=32, K=1024)": ssd_eval_launches,
                             "ssd_eval_map (B=16, K=1024)": ssd_map_launches,
                             "ssd_int8_predict (B=1, K=1024)":
                                 ssd_int8_launches,
                             "centernet_decode (DIoU: the scan)":
                                 cn_decode_launches,
                             "centernet_predict (DIoU: the scan)":
                                 cn_predict_launches,
                             "centernet_serve (DIoU: the scan)":
                                 cn_serve_launches,
                             "centernet_evaluate (DIoU: the scan)":
                                 cn_eval_launches,
                             "centernet_eval_map (DIoU: the scan)":
                                 cn_map_launches,
                             "centernet_int8_predict (DIoU: the scan)":
                                 cn_int8_launches,
                             **{f"{k}: no NMS": v for k, v in dl.items()},
                             **{f"{k}: no NMS": v for k, v in cls.items()},
                             **{f"export {k} (B=8, K=512)": v for k, v in
                                export["launches"].items()},
                             "ddp: no NMS": ddp_launches,
                             **scale_launches,
                             "yolo7x_bench (K=4096: the scan)": y7x_launches,
                             "ssd512_bench (B=64, K=1024)": ssd512_launches,
                             **{f"{k} (2 ranks): no NMS, a rank": v
                                for k, v in mesh_launches.items()
                                if k != "sharded_infer"},
                             "sharded_infer (B=8 over 2 ranks, K<=1024): "
                             "a rank in one call":
                                 mesh_launches["sharded_infer"],
                             "yolo3_trainer: no NMS": y3_train_launches,
                             "yolo3_predict (K=4096: the scan)":
                                 y3_predict_launches,
                             "yolo3_evaluate (K=4096: the scan)":
                                 y3_eval_launches,
                             "zoo_parity: no NMS": zoo_parity_launches,
                             "zoo_forward: no NMS": zoo_forward_launches,
                             "zoo_nms batched_non_max_suppression (B=8, "
                             "K=1024)": zoo_nms_launches["K1024"],
                             "zoo_nms agnostic (B=8, K=1024)":
                                 zoo_nms_launches["K1024_agnostic"],
                             "zoo_nms (B=8, K=2048: the scan)":
                                 zoo_nms_launches["K2048_scan"],
                             "zoo_nms Ensemble of two YOLOv8n (B=8, "
                             "K=1024)": zoo_nms_launches["ensemble"],
                             "convert_model predict (5 images)":
                                 convert_launches["predict"],
                             "convert_model --int8 predict (5 images)":
                                 convert_launches["int8_predict"],
                             "convert_model --int8 evaluate (K=4096: the "
                             "scan)": convert_launches["int8_evaluate"],
                             "profile trace (B=8, K=1024)":
                                 profile_launches},
        "mismatches": smoke.mismatches,
        "word_mismatches": smoke.word_mismatches,
        "max_abs_err": smoke.max_abs_err,
        "ms": main_row["ms"], "build_ms": main_row["build_ms"],
        "walk_ms": main_row["walk_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "shapes": smoke.shapes}, {
        "name": "nms_scan", "route": "cuda",
        "source": "tpucv_torch/csrc/nms_scan.cu",
        "replaces": "none: tpucv/ops/nms.py:30, tpucv's XLA scan",
        **{k: scan_row[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "us_per_round", "plan")},
        "library_ms": None}, bw, conv]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
