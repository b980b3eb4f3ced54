"""Smoke run of the PyTorch/CUDA port (pyopenvino_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line),
with the wall time of each printed:

  1. environment: the card's name and power limit as nvidia-smi reports
     them, CUDA, Triton and device count;
  2. build: every CUDA source of the port compiled from the checkout (one
     nvcc per source, all started together), the native host library
     (native/preprocess.cpp) by g++ beside them, and the Triton kernel's
     first compile;
  2b. preparation: the POT IR built (the port's ResNet-18 quantized by
     its tools/pot_quantize.py on 4 samples on the host, written and read
     back), and the KERNELS networks of SSD, EfficientNet-B0,
     googlenet_shapes, ShuffleNet-v2 and resnet18_pot compiled in the three
     modes (INT8-FULL calibrated on the host, resnet18_pot without samples);
  2c. the same for U-Net, ViT-tiny, MoE-MLP, lstm-tiny, yolo-tiny, ocr-ti
     and yolo-v2 (the port's shipped IRs of
     tools/gen_{unet,vit,moe,lstm,yolo,ocr}.py, weights replayed from seed 0,
     MoE-MLP's 2024, yolo-tiny's and yolo-v2's 20260820), INT8-FULL
     calibrated on 4 seeded inputs on the host: their fused_gemm,
     conv2d_direct and softmax_rows launches, read from the compiled graphs,
     join the shapes of phases 3 and 5a (a network that answers infer_batch
     one example at a time, MoE-MLP, ocr-ti and yolo-v2, at M per image and
     B launches a batch-B forward);
  2d. the nine recipes of models/op_graphs.py (the six of the 75 op types
     no family uses, lstm_stream's variable state, the two_stage and
     single_shot detector heads) built at full width with the port's
     GraphBuilder from seed 0, written by the port's writer into a
     temporary directory, read back through IECore.read_network and
     compiled on KERNELS in the three modes (INT8-FULL calibrated on 4
     seeded samples): their fused_gemm and conv2d_direct launches join
     phase 3's shapes (gather_scatter, whose bag indices are one example's,
     layout, whose SpaceToBatch merges the batch with its block, and
     two_stage, whose rois' batch column is reshaped to (300,), answer
     infer_batch one example at a time);
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at every shape the main paths give it at batch 1 and 64 (SSD's,
     EfficientNet-B0's, googlenet_shapes', ShuffleNet-v2's and
     resnet18_pot's read from their compiled networks: among them #1ii at
     the SE convs' M = 1 and 64 with K and N of 4 to 48, and conv2d_direct
     at googlenet_shapes' 5×5 convs with Ci = 4, 6, 8, 12 and 3×3 convs
     with Ci = 16 … 48), ShuffleNet-v2's Split halves as A (a channel
     half of a channels_last tensor, row stride C) for #1, #1w and #1ii
     plus ragged shapes and the tensor-core loops' edges (split-K, A rows
     not 16-byte aligned, ragged N, odd lda) and F32_WGMMA_EDGES:
     fused_gemm with a float32 B (max relative error <= 1e-4: three TF32
     terms) and with an int8 B (<= 2e-5: two TF32 terms of A), each as
     routed and forced onto each loop that takes the launch
     (kernels/gemm.py's f32_route: f32_wgmma.cuh's TF32 wgmma loop, and
     f32_mma.cuh's), two calls bit-identical for both,
     conv2d_fused against F.conv2d, softmax_rows (max absolute error
     <= 1e-6); the int8 × int8 fused_gemm, conv2d_direct (ResNet-18's
     shapes, Ci = 3, 4, 12, 16, 48, asymmetric pads, M not a multiple of
     128, split K at batch 1) and conv2d_fused on int8 codes (max absolute
     difference 0: exact int32 sums, the same epilogue);
     conv2d_direct on float32 (kernel 3f, max relative error <= 1e-4, two
     calls bit-identical) at ResNet-18's stride-1 3×3 shapes (K up to 4608)
     and ragged ones, with a float32 and with an int8 weight; dw_pw_fused
     (kernel 4, max code difference 0) at SSD's stride-1 depthwise →
     pointwise pairs, read from the IR, at the four published
     SSD-MobileNet-v1 pairs and at ragged C, Co and M and the largest C,
     int8 and float32 out, with both tile heights; the bfloat16 variants
     (fused_gemm with a bf16 or int8 B on the loop kernels/gemm.py's
     bf16_route picks, within one bfloat16 step of the plain version or,
     where a sum cancels, the float32 sums' bound ``gemm_floor``, two calls
     bit-identical; the int8 x int8 fused_gemm and conv2d_direct with a
     bfloat16 output, exact; softmax_rows in bf16) at ResNet-18's and
     MobileNet-v2's shapes at batch 1, 64 and ResNet-18's at 512, at the
     shapes the five other networks' compiled graphs give them at batch 1
     and 64, and the edges; conv2d_direct on bfloat16 x (kernel 3f-bf16, a
     bfloat16 and an int8 weight, within one bfloat16 step or
     ``conv_floor``, two calls bit-identical) at 3f's shapes and
     WGMMA_BF16_DIRECT_EDGES, as routed and forced onto each loop that
     takes the conv (kernels/conv_direct.py's direct_bf16_route:
     i8_wgmma.cuh's loop on bf16 operands, and bf16_mma.cuh's); dw_pw_fused
     with a bfloat16 output (kernel 4-bf16, exact) at #4's shapes, both
     tile heights; conv2d_direct on int8 codes (#3 and #3-bf16) as
     routed and forced onto each loop that takes the conv
     (kernels/conv_direct.py's direct_route: i8_wgmma.cuh's wgmma loop,
     split K where the forced loop has a small grid, and i8_mma.cuh's),
     exact and the same bits on a second call, at R's shapes, the
     loader's edges and WGMMA_DIRECT_EDGES; the int8 x int8 fused_gemm
     (#1ii, #1ii-bf16) likewise as routed and forced onto each loop that
     takes it (kernels/gemm.py's i8_route: i8_wgmma.cuh's wgmma loop with
     its tiled loader, and i8_mma.cuh's) at every shape above and
     I8_WGMMA_EDGES; ResNet-18's INT8-FULL launches (#1ii, #3, softmax_rows
     and their bf16 variants) also at every serving bucket of phase 4g;
  4. the main paths: ResNet-18 and MobileNet-v2 at full width (224×224,
     1000 classes, weights synthesized from seed 0), each FP32, INT8
     weight-only and INT8-FULL (calibrated on 4 seeded images through
     ``set_calibration``); SSD-MobileNet-v1 (assets/trained/ssd_shapes_ms,
     trained weights, 300×300, seeded images of shapes drawn by
     models/shapes.py, tools/accuracy.py's settings) in the same three
     modes; EfficientNet-B0 at full width (224×224, 1000 classes, weights
     from models/efficientnet_b0.py, seed 0) and googlenet_shapes
     (assets/trained, GoogLeNet-v1's graph narrowed 4×, trained weights, bias
     correction under INT8-FULL and 8 calibration images, tools/accuracy.py's
     setting), ShuffleNet-v2 1.0× at full width (224×224, 1000 classes,
     weights from models/shufflenet_v2.py, seed 0; INT8-FULL on 4 images)
     and resnet18_pot (models/pot.py; FP32 emulates its FakeQuantize nodes,
     INT8W folds its weight ones, INT8-FULL takes every activation scale
     from the IR and no samples, and launches what ResNet-18 INT8-FULL
     does), all on seeded uniform images in [0, 255), in the same three
     modes.  Each goes through IECore.read_network → load_network("GPU")
     → kernel_type "pallas", five batch-1 requests and one infer_batch at
     64, with every launch counter set to 0 just before the path and read
     just after it, and the outputs held against the TORCH backend (TF32
     off) on the same card; INT8-FULL is held against TORCH with
     ``int8_dataflow=False``, which quantizes where KERNELS does, and its
     agreement with the default TORCH (int8 storage between ops) and each
     INT8 mode's top-1 agreement with FP32 are printed (resnet18_pot's also
     with the unquantized ResNet-18); a path that emulates FakeQuantize is
     held against TORCH with KERNELS' FakeQuantize outputs forced in, each
     code TORCH rounds the other way one step off and its input within
     FLIP_DIST of the midpoint, at most FLIP_RATE of the codes
     (``forced_reference``; the unforced logits, as far off as a run with
     no FakeQuantize at all, are printed); SSD's record tables
     are held to TORCH's (INT8-FULL exactly), and its mAP at IoU 0.5
     against the drawn boxes is printed; then ResNet-18 and MobileNet-v2
     again in the three modes with compute_dtype="bfloat16", and the
     headline, bench.py's configuration: ResNet-18 behind PrePostProcessor
     set_element_type("u8") (its input on the card as torch.uint8),
     INT8-FULL, bfloat16, five requests and infer_batch at 512; each held
     against TORCH in bfloat16 (INT8-FULL: int8_dataflow=False, exactly
     equal; FP32 and INT8W: no farther than TORCH's own bfloat16 logits
     from its float32 ones), every launch counted, top-1 against FP32
     printed; then SSD, EfficientNet-B0, googlenet_shapes, ShuffleNet-v2
     and resnet18_pot in the three modes with compute_dtype="bfloat16"
     (five requests and infer_batch at 64 each, the launches of their
     compiled graphs in the bf16 variants), each held against TORCH in
     bfloat16 as above (resnet18_pot FP32 and INT8W with KERNELS'
     FakeQuantize outputs forced in; SSD's record tables: INT8-FULL equal,
     FP32 and INT8W no farther apart than TORCH's own bfloat16 tables lie
     from its float32 ones, by ``record_match``);
  4d. U-Net, ViT-tiny, MoE-MLP, lstm-tiny (a (1, 32, 40) feature input,
     two LSTMSequence layers of 64, a 30-class head), yolo-tiny (160×160,
     seven conv/PReLU blocks, RegionYolo), ocr-ti (a (1, 24, 32) feature
     strip, a forward and a reverse TensorIterator over an LSTMCell of 48,
     a 27-class per-frame head) and yolo-v2 (yolo-tiny's trunk, the
     ReorgYolo passthrough, RegionYolo, the decode and NonMaxSuppression on
     the device) at their generators' widths, each
     FP32, INT8 weight-only and INT8-FULL in float32 and then in bfloat16,
     on seeded uniform inputs in [0, 255): five requests and one
     infer_batch at 64 through IECore.read_network → load_network("GPU") →
     kernel_type "pallas", every counter zeroed before the path and read
     after it; the output (U-Net's (B, 8, 128, 128) probability map, the
     classifiers' (B, 100) and (B, 30), ocr-ti's (B, 27, 24) per-frame
     posteriors) finite and summing to 1 over axis 1,
     yolo-tiny's (B, 1125) region blob finite with its logistic channels in
     [0, 1] and its class probabilities summing to 1, each held against
     TORCH on the card (float32: logits, yolo-tiny's its head's output,
     within LOGIT_RTOL, INT8-FULL with int8_dataflow=False exactly; outputs
     within E2E_RTOL; bfloat16: INT8-FULL logits equal, FP32 and INT8W no
     farther than TORCH's own bf16 from its float32 in the mean, and in the
     largest difference than that or one bf16 step); U-Net's per-pixel,
     ocr-ti's per-frame argmax and the classifiers' top-1 agreement with
     FP32 printed, and yolo-tiny's decoded detections
     (metrics.decode_region_yolo) against FP32's: their count, the top
     detection's class and the largest difference of its box; yolo-v2's
     (B, 48, 7) record tables as SSD's in float32 (the same records and
     classes in the same order, values within RECORD_ATOL, INT8-FULL
     equal), in bfloat16 INT8-FULL equal and FP32 and INT8W with the same
     classes on as many inputs as TORCH's own bf16 tables against its
     float32 ones and no farther apart in the mean (``record_dists``), pad
     rows [-1, -1, -1, 0, 0, 0, 0] after the records, records on the
     seeded inputs; fails unless the families launch fused_gemm and
     conv2d_direct, yolo-tiny and yolo-v2 conv2d_direct, ocr-ti and yolo-v2
     fused_gemm and lstm-tiny softmax_rows;
  4e. the op-type recipes through IECore.read_network → load_network("GPU")
     → kernel_type "pallas": FP32, INT8 weight-only and INT8-FULL, in
     float32 and then in bfloat16, two batch-1 requests and infer_batch at
     64, every counter zeroed before the path and read after it against the
     compiled graph's launches (fused_gemm and its variants on each
     recipe's root: a 1×1 conv 128 → 128 at 28×28, a MatMul 128 → 128 on
     gathered rows, ResNet-18's FC and ViT-tiny's q, k and v); every output
     held against TORCH on the card (``recipe_gate``: float32 within
     E2E_RTOL and E2E_ATOL of its largest value and 1e-4 of its largest
     value in the largest difference, INT8-FULL with
     int8_dataflow=False equal; bfloat16 no farther from TORCH's than
     TORCH's own bfloat16 lies from its float32 in the mean, INT8-FULL
     equal; integer and bool outputs equal; TopK's indices behind the FC as
     the share of equal rows), and TORCH's FP32 float32 answers to the
     requests against the port's numpy interpreter (the ref_computes):
     float outputs within 1e-4, integer and bool outputs equal;
  4f. the state and detector recipes the same way, in the same six
     configurations: lstm_stream (lstm-tiny after LowLatency2, 8 frames a
     call, four variables) over 8 chunks, query_state after the fourth,
     reset_state and the first two again (the same answers), a
     VariableState set before a third (the answer moves), 64 streams
     reshaped into the IR (IENetwork.reshape) for 4 chunks in lockstep
     against 2 streams run alone, infer_batch refused, and TORCH FP32's
     calls against the numpy interpreter's; two_stage (RPN, Proposal,
     ROIAlign, a C4 box head, 2 requests and infer_batch at TWO_STAGE_ROWS)
     and single_shot (SSD300's heads, PriorBox, DetectionOutput, 2 requests
     and infer_batch at 64), their rois and records as yolo-v2's (float32:
     the same kept rois and classes within RECORD_ATOL, rows matched to
     TORCH's where near-tied scores trade them, every other output by
     recipe_gate; INT8-FULL equal but the softmax_rows outputs; bfloat16 by
     record_dists against TORCH's own bf16-vs-f32 distance); the Proposal
     forward's wall time at B = 1;
  4g. serving: ResNet-18 at full width, INT8-FULL KERNELS in float32 and
     bench.py's headline (u8 through PrePostProcessor, INT8-FULL, bfloat16),
     each through Core().compile_model(..., "GPU", Config(batch_buckets=
     SERVE_BUCKETS)) and AsyncInferQueue(jobs=SERVE_JOBS) with
     SERVE_REQUESTS seeded requests, every counter zeroed before the server
     starts (its warmup runs each bucket once) and read after the queue
     drains, against (buckets + batches) forwards; every served answer held
     against the same network's direct infer by phase 4's classifier gate
     (the logits read back from the probabilities), the requests counted and
     coalesced (fewer batches than requests), the bit-equal answers, the
     server's summary (p50/p99, batches, padded slots) and requests/s
     through the queue beside infer_batch's images/s at the largest bucket
     printed; then lstm_stream (KERNELS FP32) through two InferRequests
     stepped in turn from two threads, four chunks each, each request's
     outputs and query_state against its stream run alone by recipe_gate,
     and reset_state on one request leaving the other's state as it was;
  4h. the runtime extras: phase 4g's two networks exported
     (CompiledModel.export_model) and imported (Core.import_model) with no
     pass and no calibration, five requests and infer_batch at 64 through
     each imported network bit-equal to the exporter's; ResNet-18
     INT8-FULL KERNELS float32 compiled twice through two Cores with one
     CACHE_DIR, the cold and the cached time to the first answer printed,
     the cached one with no prepare_model and no calibration and the same
     bits; verify_against_interpreter on ResNet-18 FP32 KERNELS at B = 1;
     get_perf_counts and profile on the INT8-FULL network at B = 1, every
     Convolution and MatMul EXECUTED on the kernel its route names, the
     node rows and the unattributed time within 1 % of the profiler's
     device total, EfficientNet-B0 INT8-FULL's batch-1 latency before and
     after them (``profile_after_cost``); every launch counted against the
     forwards each step runs;
  4i. the native host path: ResNet-18's IR written again with every float
     Const declared f16 (ir/writer.py with_f16_consts) and read back, its
     fp16 Consts decoded by native.fp16_to_fp32, each bit-equal to its
     float32 weight rounded through fp16, R FP32 KERNELS on it against
     TORCH on it by phase 4's classifier gate; STREAM_BATCHES seeded
     batches of STREAM_BATCH 480×640×3 frames through native.AsyncLoader
     (u8_out, depth 4) from a producer thread into the headline's
     infer_batch, each blob and answer bit-equal to the synchronous
     pipeline's (preprocess_batch, then infer_batch), and the same with
     float32 blobs into R INT8-FULL KERNELS float32; SERVER_STREAM batches
     of SERVER_STREAM_BATCH frames from the loader into an InferenceServer
     over R INT8-FULL float32 (phase 4g's buckets), a submit a row, each
     answer against direct infer by phase 4g's gate; cost_analysis and
     memory_analysis of both networks, the output bytes equal to what
     infer returns, temp beside the growth of max_memory_allocated over one
     B = 1 forward; preprocess_batch's images/s (u8, float32), the
     synchronous and the streamed pipelines' images/s and the fp16 decode
     rate against numpy's astype printed; every launch counted against the
     forwards each step runs;
  4k. the pipeline (parallel/pipeline.py) on logical shards of the card
     (devices [cuda:n] * k): the headline's IR through compile_pipelined
     with its config and calibration at B = BATCH on PP2, PP4 and PP2×DP2,
     each bit-equal to the unsharded network, its cut nodes printed; R FP32
     TORCH on PP2 within rtol 1e-4 / atol 1e-5; ssd_shapes_ms INT8-FULL
     KERNELS on PP2, its record tables bit-equal; the server over the
     PP2×DP2 headline, buckets (1, 2, 4, 8) rounded to (2, 4, 8), every
     answer bit-equal to direct infer; each mesh's launches predicted as the
     unsharded forward's × n_micro × data and its ms a batch (the median
     of MESH_TIMED) beside the unsharded network's;
  4l. multi-process groups (parallel/distributed.py): ONE pair of worker
     processes (tools/mp_worker.py), each a rank of a gloo group owning
     [cuda:n] * 2, the four positions process-major; each reads the
     headline's IR, config and calibration images from a reference file,
     arrives at the headline's scales (checked) and loads phase 2's kernel
     libraries (checked): the headline at B = BATCH on DP4 and DP2×TP2,
     each rank's rows bit-equal to the unsharded network's, on PP4 across
     the ranks (the cut tensors through host memory, the outputs
     broadcast), both ranks' full outputs bit-equal, MoE-MLP's EP (model = 2
     inside a rank, data across) by the probability gate; each rank's
     launches against the prediction (mesh_per_forward a local block, the
     rank's PP4 stages × n_micro) and into the kernels line; its ms a batch
     beside the unsharded network's and 4j's and 4k's one-thread times; the
     hand-offs' bytes; here, the DP2×TP2 headline exported and imported onto
     [cuda:n] * 4, bit-equal at B = 1 and BATCH.  Then a data row across the
     two ranks, each owning 2 of its 4 positions and feeding the row's rows:
     the headline at B = BATCH on TP4 (data = 1, model = 4) and SP4 (data =
     1, spatial = 4), batch-1 infer on TP4, and the DP2×TP2 artifact
     imported onto TP4 at B = 1 and BATCH, each rank's full outputs
     bit-equal to the unsharded network's; MoE-MLP's EP on model = 4 (2
     experts a shard) by the probability gate; each rank's launches
     against mesh_per_forward for the positions it owns, its ms a batch
     beside the one-thread TP4 and SP4 meshes ([cuda:n] * 4 in this
     process), the bytes and host seconds of its all-gathers and halo
     hand-offs, and the seconds the row jobs add.  Two processes share the
     one card (two CUDA contexts, time-sliced): no NVLink, NCCL or second
     card is measured;
  5. times: per kernel variant and shape the kernel, plain-version and
     library-call times (CUDA events), the roofline bound (for the float32-A
     fused_gemm variants and kernel 3f the card's floor for a
     float32-accurate product, three bf16 passes, with their own TF32
     routes' floors, three passes for a float32 B and two for an int8 B,
     and float32 FFMA's beside it), and their sums over one forward; #1's
     and #1w's rows with the route and both loops' times, f32_wgmma.cuh's
     and f32_mma.cuh's; the int8 × int8 stems'
     unaligned rows (byte path) against 16-byte aligned ones and against
     the copy that would pad them; the dw_pw
     microbenchmark (fused against the unfused pair at the published
     shapes, batch 256); the bfloat16 variants' kernel, plain-version and
     library times (cuBLAS's bf16 addmm, torch._int_mm, cuDNN's bf16 conv,
     torch.softmax) with bounds at the bf16 or int8 peak and 2-byte
     activations, at R's and M's shapes and, at batch 64, the five other
     networks' (fused_gemm's bf16 variants at batch 1 too, each row with
     the route and both loops' times, bf16_wgmma.cuh's and bf16_mma.cuh's;
     #3's and #3-bf16's rows the same with i8_wgmma.cuh's and i8_mma.cuh's,
     #3's with cuDNN's bf16 conv on the codes beside its float32 one;
     #1ii's and #1ii-bf16's rows the same); kernels 3f-bf16
     (against cuDNN's bf16 conv with bias; each row with the route, both
     loops' times, i8_wgmma.cuh's on bf16 operands and bf16_mma.cuh's, each
     with its weight matrix cached, and the plan and the bytes its TMA
     loads bring, beside an L2-resident copy's rate (``l2_copy``)) and
     4-bf16 (against the grouped conv, torch._int_mm and the epilogue to
     bf16) "if routed", as 3f and #4; the u8 and float32 input copies at
     512 (``ingress``);
     INT8-FULL's time to the first answer, resnet18_pot
     without samples against ResNet-18 calibrated on 4 images; for every
     (model, quant, backend) latency, throughput, peak device memory and
     resident weight bytes, the medians of E2E_REQUESTS requests and
     E2E_BATCHES timed batches in each of three runs, KERNELS, TORCH,
     KERNELS (MoE-MLP's, ocr-ti's and yolo-v2's paths, one example at a
     time, with LIGHT_E2E's repetitions: one KERNELS and one TORCH run of
     10 requests and 1 timed batch);
  6. one JSON line {"kernels": [...]}, then the card's name and power limit,
     then the last line {"ok": true, "device": {...}}.

Needs one CUDA card and the CUDA toolkit (nvcc) and Triton; it exits
non-zero without a result on a machine without a card.
"""

import collections
import concurrent.futures
import contextlib
import functools
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, TF32,
# bf16 and int8 on the tensor cores (dense), and device memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# max |kernel - plain| / max |plain|: the float32 kernel's three TF32 terms
# against full float32 (tests/test_torch_port_gemm_tc.py shows one TF32
# term fails it)
GEMM_RTOL = 1e-4
# the int8-B kernel: two TF32 terms of A carry 22 of its 24 bits
# (tests/test_torch_port_gemm_tc.py shows one term fails this gate)
I8W_RTOL = 2e-5
SOFTMAX_ATOL = 1e-6  # max |kernel - plain|
# a FakeQuantize code that KERNELS and TORCH round differently: TORCH's
# input within this fraction of max |input| of the rounding midpoint (the
# float32 kernels' gate against their plain versions, GEMM_RTOL)
FLIP_DIST = 1e-4
# and at most this share of a run's FakeQuantize outputs: resnet18_pot
# flips 1.2e-6 of them on the card (KERNELS vs TORCH) and up to 5.5e-6 on
# the CPU (the port vs the JAX package's XLA backend,
# tests/test_torch_port_pot.py); a wrong range or level count flips most
FLIP_RATE = 2e-5
# the same in bfloat16 compute, where the two routes' FakeQuantize inputs
# differ by bfloat16 roundings (INT8 weight-only TORCH multiplies bf16
# dequantized weights, KERNELS scales the float32 sum of the codes): a
# differing output's inputs within FLIP_DIST_BF16 of max |input| of each
# other, at most FLIP_RATE_BF16 of the outputs differing; on the CPU the
# port's KERNELS and TORCH read up to 8.8e-3 of max |input| and 2.4e-3 of
# the outputs (resnet18_pot INT8W, 3 images; FP32 0), on an H100 7.5e-3
# and 2.4e-3; a wrong range or level count moves most outputs
FLIP_DIST_BF16 = 3e-2
FLIP_RATE_BF16 = 1e-2
# bfloat16 compute: a bf16 kernel's result within one bfloat16 step of its
# plain version's at each element (the two sum in float32 in different
# orders, then round once), or, where the sum cancels to a value whose
# step is smaller than the float32 sums' own error, within that error's
# bound (gemm_floor): the tensor cores align each mma's 16 products and its
# accumulator to the largest and cut the rest toward zero, up to 17 steps
# of the largest a mma, about 2·K·2^-24·Σ|a·b| over K, and the plain
# version's float32 sums err by up to K·2^-24·Σ|a·b|, so 4·K·2^-24·Σ|a·b|
# (on an H100 the cut shows as values 3e-5 past a bfloat16 tie rounded the
# other way); the CPU tests, two IEEE float32 sums, hold 2^-16 of the
# output's largest; softmax_rows in bf16 the latter
BF16_ULPS, BF16_FLOOR = 1.0, 2.0 ** -16
# ResNet-18 at bench.py's batch (the headline: u8 ingress, INT8-FULL, bf16)
HEADLINE_BATCH = 512
E2E_RTOL, E2E_ATOL = 1e-3, 1e-5      # probabilities, KERNELS vs TORCH
# max |Δlogit| / max |logit|, KERNELS vs TORCH: float32 sums in another
# order (FP32, INT8 weight-only); exact int32 sums and the same unfused
# epilogue on both routes (INT8-FULL), so no difference at all
LOGIT_RTOL = {"none": 1e-4, "int8w": 1e-4, "int8": 0.0}
REQUESTS, BATCH, CALIBRATION = 5, 64, 4
# phase 4e: batch-1 requests a recipe, and the float gate against TORCH
# and against the numpy interpreter (max |Δ| / max |reference|), the
# families' row of PERF.md §2
RECIPE_REQUESTS, RECIPE_RTOL = 2, 1e-4
# phase 4f: two_stage's infer_batch rows.  Its batch runs one forward an
# example, each a host-issued Proposal sweep of a few device operations a
# candidate (phase 4f prints its time), and at 64 rows the phases would pass
# the 650 s that ROADMAP.md's "Chip time" allows
TWO_STAGE_ROWS = 16
# phase 4g: the server's batch buckets (Config.batch_buckets' default; phase
# 3 checks R's INT8-FULL kernels at each), the queue's jobs and its requests
SERVE_BUCKETS, SERVE_JOBS, SERVE_REQUESTS = (1, 2, 4, 8, 16, 32), 32, 256
# phase 4i: STREAM_BATCHES batches of STREAM_BATCH seeded camera frames
# (FRAME_HW, 3 channels) through the AsyncLoader into infer_batch, and
# SERVER_STREAM batches of SERVER_STREAM_BATCH frames into the server, one
# row a submit
STREAM_BATCHES, STREAM_BATCH, FRAME_HW = 8, 64, (480, 640)
SERVER_STREAM, SERVER_STREAM_BATCH = 4, 8
# phase 4j: timed infer_batch calls a mesh (the median), MoE-MLP's rows
# (one forward an example)
MESH_TIMED, MESH_MOE_ROWS = 3, 4

# phase 5a: eager calls per call of a timed device replay, for the host's
# issue rate (``eager_ms``)
EAGER_CALLS = 2
# phase 5c: timed batch-1 requests and infer_batch calls of each run (the
# median of each), three runs a path (KERNELS, TORCH, KERNELS): the phases
# stay under 700 s on a host that runs the host-bound paths at half speed
E2E_REQUESTS, E2E_BATCHES = 10, 3
# phase 5c on MoE-MLP's, ocr-ti's and yolo-v2's paths, which answer a batch
# one example at a time (the batch's warm-up is the requests')
LIGHT_E2E = {"requests": 10, "batches": 1, "warm_batch": False}
# SSD records of KERNELS against TORCH (FP32, INT8 weight-only): the same
# count and classes in the same order, confidences and corners within this
RECORD_ATOL = 1e-4
SSD_PATHS = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "trained",
                               f"ssd_shapes_ms.{ext}") for ext in ("xml", "bin"))
SSD_INPUT, SSD_OUTPUT = "image_tensor", "detection_boxes:0"
# tools/accuracy.py's settings for ssd_shapes_ms: the small heads stay
# float, bias correction under INT8-FULL, max-abs (percentile 100) scales
SSD_QUANT_MIN_ELEMS, SSD_CALIBRATION = 4096, 8
# googlenet_shapes (GoogLeNet-v1's graph narrowed 4x, trained weights) and
# tools/accuracy.py's INT8-FULL setting for it: bias correction
GOOGLENET_PATHS = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                                     "trained", f"googlenet_shapes.{ext}")
                        for ext in ("xml", "bin"))
GOOGLENET_CALIBRATION = 8


def log(*args):
    print(*args, flush=True)


def eager_ms(torch, fn, iters):
    """Milliseconds per call of ``fn`` issued eagerly from Python, from CUDA
    events around ``iters`` calls after warm-up.  For a short kernel this is
    the host's issue rate (wrapper checks, ctypes, launch), not the
    kernel's duration."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed between two CUDA events, so the host's
    issue cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def gemm_bytes(m, k, n, int8):
    """Bytes a fused_gemm launch of the main path must move: A, B (int8 or
    f32), the bias (and the int8 variant's scale) read once, C written once."""
    if int8:
        return 4.0 * m * k + k * n + 4.0 * m * n + 8.0 * n
    return 4.0 * (m * k + k * n + n + m * n)


def i8_bytes(m, k, n):
    """Bytes of an int8 × int8 launch: A and B int8, scale and bias float32
    read once, the float32 output written once."""
    return m * k + k * n + 8.0 * n + 4.0 * m * n


def direct_bytes(b, h, w, ci, co, kh, kw):
    """Bytes of a stride-1 conv2d_direct launch (same-size output): the
    int8 NHWC input read once (not its kh·kw-fold implicit patch matrix),
    the (kh·kw·Ci, Co) int8 weight, scale and bias float32, the float32
    output written once."""
    return b * h * w * ci + kh * kw * ci * co + 8.0 * co + 4.0 * b * h * w * co


def resnet18_gemms(b):
    """(M, K, N, launches per forward) of ResNet-18's fused_gemm launches at
    batch b: the three 1×1/s2 projection shortcuts, then the 512 → 1000 FC."""
    return [(784 * b, 64, 128, 1), (196 * b, 128, 256, 1), (49 * b, 256, 512, 1),
            (b, 512, 1000, 1)]


def mobilenet_v2_gemms(b):
    """(M, K, N, launches per forward) of MobileNet-v2's fused_gemm launches
    at batch b: its 15 1×1 convs with co >= 128 and ci >= 64 (expand at
    14×14 and 7×7, project at 7×7, the 320 → 1280 head), then the
    1280 → 1000 FC."""
    return [(196 * b, 64, 384, 4), (196 * b, 96, 576, 3), (49 * b, 576, 160, 1),
            (49 * b, 160, 960, 3), (49 * b, 960, 160, 2), (49 * b, 960, 320, 1),
            (49 * b, 320, 1280, 1), (b, 1280, 1000, 1)]


GEMMS = {"resnet18": resnet18_gemms, "mobilenet_v2": mobilenet_v2_gemms}

# INT8-FULL, (M per image, K, N, launches per forward) of the int8 × int8
# fused_gemm launches.  ResNet-18: the 7×7/s2 stem's patches, the three
# 3×3/s2 convs' patches, the three 1×1/s2 shortcuts, the classifier.
# MobileNet-v2: the 3×3/s2 stem's patches, its 34 1×1 convs, the classifier.
I8I8_GEMMS = {
    "resnet18": [(12544, 147, 64, 1), (784, 576, 128, 1), (196, 1152, 256, 1),
                 (49, 2304, 512, 1), (784, 64, 128, 1), (196, 128, 256, 1),
                 (49, 256, 512, 1), (1, 512, 1000, 1)],
    "mobilenet_v2": [(12544, 27, 32, 1), (12544, 32, 16, 1), (12544, 16, 96, 1),
                     (3136, 96, 24, 1), (3136, 24, 144, 2), (3136, 144, 24, 1),
                     (784, 144, 32, 1), (784, 32, 192, 3), (784, 192, 32, 2),
                     (196, 192, 64, 1), (196, 64, 384, 4), (196, 384, 64, 3),
                     (196, 384, 96, 1), (196, 96, 576, 3), (196, 576, 96, 2),
                     (49, 576, 160, 1), (49, 160, 960, 3), (49, 960, 160, 2),
                     (49, 960, 320, 1), (49, 320, 1280, 1), (1, 1280, 1000, 1)],
}


def i8i8_gemms(model, b):
    """(M, K, N, launches per forward) of ``model``'s INT8-FULL fused_gemm
    launches at batch b."""
    return [(m * b, k, n, c) for m, k, n, c in I8I8_GEMMS[model]]


# The tensor-core loops' edges, (M, K, N, lda): split-K (M = 1, 49, 64 at
# K = 512, 1280, 2304), A rows not 16-byte aligned (K = 27, 147, an odd
# lda), K not a multiple of 32, ragged N (24, 30, 129) and N = 16
TC_EDGES = [(1, 1280, 1000, 1280), (49, 2304, 512, 2304), (64, 1280, 1000, 1280),
            (64, 2304, 512, 2304), (1, 2304, 512, 2304), (2 * 12544, 27, 32, 27),
            (12544, 147, 64, 147), (65, 96, 130, 97), (300, 64, 24, 64),
            (300, 70, 30, 70), (2 * 12544, 32, 16, 32), (1, 512, 1000, 512),
            (49, 512, 512, 512), (64, 512, 1000, 512), (49, 1280, 1000, 1280),
            (37, 77, 129, 77)]

# fused_gemm's int8 × int8 edges for the wgmma loop (csrc/i8_wgmma.cuh),
# (M, K, N, lda): M, N and K tails (K = 80, 144: a last k step partly past
# K; N = 200, 1000: a ragged last band), lda > K, split K at small M, N =
# 64 and K = 16, 32 and 48 (one k step narrower than a stage)
I8_WGMMA_EDGES = [(1000, 96, 128, 112), (333, 160, 200, 176), (777, 80, 1000, 80),
                  (300, 144, 136, 144), (129, 48, 64, 48), (784, 2304, 512, 2304),
                  (2000, 16, 96, 32), (4099, 32, 192, 48), (6400, 256, 64, 256)]

# fused_gemm's float32-A edges for the wgmma loop (csrc/f32_wgmma.cuh),
# (M, K, N, lda): K past a whole k step (77, 300: TMA's zeros) with lda > K,
# M and N tails (a 72-column last band at N = 200, N = 1008), N = 64, K
# below one step, split K at small M
F32_WGMMA_EDGES = [(1000, 77, 200, 80), (333, 160, 64, 164), (129, 24, 128, 24),
                   (4099, 96, 192, 96), (777, 300, 1008, 304), (100, 1280, 256, 1280)]

# ResNet-18's conv2d_direct launches under INT8-FULL, (H = W, Ci = Co,
# launches per forward): its stride-1 3×3 convs, pads 1.
RESNET18_DIRECT = [(56, 64, 4), (28, 128, 3), (14, 256, 3), (7, 512, 3)]

# conv2d_direct's int8 edges besides ResNet-18's shapes, (N, H, W, Ci, Co,
# kh, kw, pads): the loader's byte path (Ci = 3, 6), its 4-byte path
# (Ci = 4, 12, 8, 132) and 16-byte path (Ci = 16, 48, 64), asymmetric pads,
# 5×5 and 1×3 kernels, Co not a multiple of 64, M not a multiple of 128
DIRECT_I8_EDGES = [(3, 9, 11, 3, 70, 3, 3, ((0, 2), (1, 0))),
                   (2, 15, 13, 4, 33, 3, 3, ((1, 0), (0, 2))),
                   (2, 10, 10, 12, 64, 3, 3, ((1, 1), (1, 1))),
                   (1, 12, 12, 16, 40, 5, 5, ((2, 2), (2, 2))),
                   (5, 7, 7, 48, 100, 3, 3, ((1, 1), (1, 1))),
                   (2, 13, 12, 8, 33, 5, 5, ((2, 2), (2, 2))),
                   (2, 10, 10, 6, 40, 1, 3, ((0, 0), (1, 1))),
                   (5, 7, 7, 132, 100, 3, 3, ((1, 1), (1, 1))),
                   (3, 11, 9, 64, 130, 3, 3, ((0, 1), (2, 0)))]

# conv2d_direct's edges for the wgmma loop (csrc/i8_wgmma.cuh), forced and
# routed, (N, H, W, Ci, Co, kh, kw, pads): asymmetric pads and M not a
# multiple of 128 on 64-channel slices, a 5×5 kernel on 32-channel slices
# with a ragged band (Co = 192), a 1×3 kernel, Co = 136 (a second band of 8
# columns), Ci = 32; each too small to fill the card, so the forced loop
# splits K
WGMMA_DIRECT_EDGES = [(3, 11, 9, 64, 128, 3, 3, ((0, 1), (2, 0))),
                      (2, 13, 12, 96, 192, 5, 5, ((2, 2), (2, 2))),
                      (5, 7, 7, 192, 128, 1, 3, ((0, 0), (1, 1))),
                      (3, 10, 10, 64, 136, 3, 3, ((1, 1), (1, 1))),
                      (4, 14, 14, 32, 64, 3, 3, ((1, 1), (1, 1)))]

# kernel 3f-bf16's edges for the wgmma loop (csrc/i8_wgmma.cuh on bf16
# operands), forced and routed, (N, H, W, Ci, Co, kh, kw, pads): asymmetric
# pads and M not a multiple of 128 on 64-channel slices, a 5×5 kernel on
# 32-channel slices (Ci = 96) with a ragged band (Co = 192), a 1×3 kernel on
# 16-channel slices (Ci = 48), Co = 136 (a second band of 8 columns), Ci = 16
# (four taps a stage) and Ci = 32; each too small to fill the card, so the
# forced loop splits K where K holds 4 stages
WGMMA_BF16_DIRECT_EDGES = [(3, 11, 9, 64, 128, 3, 3, ((0, 1), (2, 0))),
                           (2, 13, 12, 96, 192, 5, 5, ((2, 2), (2, 2))),
                           (5, 7, 7, 48, 128, 1, 3, ((0, 0), (1, 1))),
                           (3, 10, 10, 64, 136, 3, 3, ((1, 1), (1, 1))),
                           (4, 14, 14, 16, 64, 3, 3, ((1, 1), (1, 1))),
                           (2, 8, 8, 32, 64, 3, 3, ((1, 1), (1, 1)))]

# kernel 3f's check shapes besides ResNet-18's: tests/test_pallas.py's
# TestDirectConv (Ci = 3, 5×5), then ragged K with asymmetric pads
DIRECT_F32_RAGGED = [(2, 14, 14, 8, 16, 3, 3, ((1, 1), (1, 1))),
                     (1, 9, 9, 3, 5, 3, 3, ((0, 0), (0, 0))),
                     (2, 8, 8, 16, 32, 5, 5, ((2, 2), (2, 2))),
                     (3, 9, 11, 7, 70, 3, 3, ((0, 2), (1, 0)))]

COUNTERS = ("fused_gemm", "fused_gemm_i8w", "fused_gemm_i8i8", "conv2d_direct",
            "conv2d_direct_f32", "dw_pw_fused", "softmax_rows",
            "fused_gemm_bf16", "fused_gemm_bf16_i8w", "fused_gemm_i8i8_bf16",
            "conv2d_direct_bf16", "softmax_rows_bf16", "conv2d_direct_float_bf16",
            "dw_pw_fused_bf16")
# a kernel's bfloat16 variant on a compute_dtype="bfloat16" path
BF16_VARIANT = {"fused_gemm": "fused_gemm_bf16", "fused_gemm_i8w": "fused_gemm_bf16_i8w",
                "fused_gemm_i8i8": "fused_gemm_i8i8_bf16", "conv2d_direct": "conv2d_direct_bf16",
                "softmax_rows": "softmax_rows_bf16"}


def per_forward(model, quant):
    """Expected launches of each kernel in one forward of a main path."""
    counts = dict.fromkeys(COUNTERS, 0)
    counts["softmax_rows"] = 1
    if quant == "int8":
        counts["fused_gemm_i8i8"] = sum(c for *_, c in i8i8_gemms(model, 1))
        if model == "resnet18":
            counts["conv2d_direct"] = sum(c for *_, c in RESNET18_DIRECT)
    else:
        name = "fused_gemm_i8w" if quant == "int8w" else "fused_gemm"
        counts[name] = sum(c for *_, c in GEMMS[model](1))
    return counts


def record_dists(a, b):
    """Two (..., K, 7) record tables, image by image, as detections rather
    than rows (bfloat16 rounds confidences to 8 bits, and records of tied
    confidence trade rows): (images whose records hold the same classes,
    each as often, [for each record of ``a`` with a record of its class in
    ``b``: the largest difference of confidence or box corner to the
    nearest such record])."""
    from pyopenvino_tpu_torch.metrics import parse_detection_records

    agree, dists = 0, []
    for x, y in zip(a.reshape(-1, a.shape[-2], 7), b.reshape(-1, b.shape[-2], 7)):
        dx, dy = parse_detection_records(x), parse_detection_records(y)
        agree += sorted(d[0] for d in dx) == sorted(d[0] for d in dy)
        for cls, conf, box in dx:
            near = [max(abs(conf - c2), *(abs(u - v) for u, v in zip(box, b2)))
                    for k, c2, b2 in dy if k == cls]
            if near:
                dists.append(min(near))
    return agree, dists


def record_match(a, b):
    """(images whose records hold the same classes, the largest of
    ``record_dists``)."""
    agree, dists = record_dists(a, b)
    return agree, max(dists, default=0.0)


def decode_yolo(blob):
    """yolo-tiny's detections in one (1, 1125) region blob, at the
    generator's anchors and the demo threshold 0.25."""
    from pyopenvino_tpu_torch.metrics import decode_region_yolo
    from pyopenvino_tpu_torch.models import yolo_tiny

    return decode_region_yolo(blob, (yolo_tiny.GRID, yolo_tiny.GRID), yolo_tiny.ANCHORS,
                              yolo_tiny.CLASSES, conf_threshold=0.25)


def region_blob_ok(blob, tol, what):
    """A yolo-tiny region blob's invariants, which stand in for the
    classifiers' sum to 1: x, y and the objectness in [0, 1] (the
    logistic), each anchor cell's class probabilities summing to 1 within
    ``tol`` (the softmax)."""
    from pyopenvino_tpu_torch.models import yolo_tiny

    block = 4 + 1 + yolo_tiny.CLASSES
    t = blob.reshape(len(blob), len(yolo_tiny.ANCHORS), block, yolo_tiny.GRID, yolo_tiny.GRID)
    logistic = t[:, :, [0, 1, 4]]
    sums = t[:, :, 5:].sum(axis=2)
    if logistic.min() < 0 or logistic.max() > 1 or np.abs(sums - 1).max() > tol:
        raise AssertionError(f"{what}: not a region blob (logistic {logistic.min()}.."
                             f"{logistic.max()}, class sums {sums.min()}..{sums.max()})")


def detections_vs(dets, ref, ref_name):
    """yolo-tiny's detections against ``ref``'s, image by image, as text:
    the counts, the share of images whose top detection has ``ref``'s class,
    the largest coordinate difference of those top boxes."""
    both = [(d[0], r[0]) for d, r in zip(dets, ref) if d and r]
    same = [(d, r) for d, r in both if d[0] == r[0]]
    box = max((float(np.abs(np.subtract(d[2], r[2])).max()) for d, r in same), default=0.0)
    return (f"detections {sum(map(len, dets))} ({ref_name}: {sum(map(len, ref))}) in "
            f"{len(dets)} images; top detection's class equal to {ref_name}'s on "
            f"{len(same)} of {len(both)}, its box within {box:.3e}")


def in_bf16(each):
    """Launches per forward of a float32 path's kernels (per_forward,
    compiled_per_forward) as the same path's in bfloat16: every kernel in
    its bfloat16 variant."""
    counts = dict.fromkeys(COUNTERS, 0)
    for name, c in each.items():
        if c:
            counts[BF16_VARIANT[name]] = c
    return counts


def per_forward_bf16(model, quant):
    """per_forward with every kernel in its bfloat16 variant."""
    return in_bf16(per_forward(model, quant))


def gemm_floor(torch, a, b, scale=None):
    """The bound on a bf16 GEMM kernel's and its plain version's float32
    sums of act((a @ b) * scale) apart: 4·K·2^-24·(|a| @ |b|)·|scale|, per
    output element."""
    floor = (a.float().abs() @ b.float().abs()) * (4 * a.shape[1] * 2.0 ** -24)
    return floor if scale is None else floor * scale.float().abs()


def conv_floor(torch, x, w, scale=None, pads=((0, 0), (0, 0))):
    """gemm_floor of a stride-1 conv2d_direct on NHWC x and an OIHW w: the
    bound 4·K·2^-24·Σ|x·w|·|scale| on its kernel's and its plain version's
    float32 sums apart, per output element (NHWC)."""
    (pt, pb), (pl, pr) = pads
    xa = torch.nn.functional.pad(x.float().abs().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    k = w.shape[1] * w.shape[2] * w.shape[3]
    floor = torch.nn.functional.conv2d(xa, w.float().abs()).permute(0, 2, 3, 1)
    floor = floor * (4 * k * 2.0 ** -24)
    return floor if scale is None else floor * scale.float().abs()


def bf16_ulp(torch, x):
    """One bfloat16 step at each element's magnitude, 2^(e-8) for a value
    m·2^e with m in [0.5, 1) (frexp: exact at powers of two, where a
    log2 on the card may fall short of the integer)."""
    _, e = torch.frexp(x.double().abs().clamp_min(2.0 ** -126))
    return torch.exp2(e.double() - 8)


def bf16_steps(torch, got, want, floor=None):
    """(worst |got - want| over its limit, max |got - want|, share
    bit-equal): the limit is BF16_ULPS bfloat16 steps of each element of
    ``want`` or ``floor`` (per element; by default BF16_FLOOR of the
    largest magnitude), whichever is larger."""
    g, w = got.double(), want.double()
    ulp = bf16_ulp(torch, w)
    if floor is None:
        limit = torch.clamp(BF16_ULPS * ulp, min=BF16_FLOOR * w.abs().max().item())
    else:
        limit = torch.maximum(BF16_ULPS * ulp, floor.double())
    diff = (g - w).abs()
    return ((diff / limit).max().item(), diff.max().item(),
            (got == want).double().mean().item())


def direct_f32_bytes(b, h, w, ci, co, kh, kw, w_bytes=4):
    """Bytes of a stride-1 float32 conv2d_direct launch (same-size output):
    the input read once, the weight (4 or 1 bytes a value), the bias (and an
    int8 weight's scale), the output written once."""
    return (4.0 * (b * h * w * ci + co + b * h * w * co) + w_bytes * kh * kw * ci * co
            + (4.0 * co if w_bytes == 1 else 0.0))


def conv_launches(compiled, quant):
    """(kernel, M per image, K, N) of every Convolution of a compiled
    network that launches a kernel on KERNELS, by ops/conv.py's
    ``kernel_route``: under INT8-FULL a conv runs int8 × int8 where its
    weight is int8 and it has an activation scale.  M counts every row of a
    batch-1 forward: a conv after ROIAlign (two_stage's box head) has one
    image a roi.  GroupConvolution has no kernel."""
    from pyopenvino_tpu_torch.ir.attrs import get_int_tuple
    from pyopenvino_tpu_torch.ops.conv import kernel_route
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    model = compiled.model
    analysis = infer_shapes(model)
    out = []
    for node in model.find_by_type("Convolution"):
        w_src = model.in_edges[node.id][1][0]
        co, ci, kh, kw = analysis.shape(w_src, model.nodes[w_src].out_port)
        quantized = w_src in compiled._quantized
        route = kernel_route(
            (co, ci, kh, kw), get_int_tuple(node.attrs, "strides", (1, 1)),
            get_int_tuple(node.attrs, "dilations", (1, 1)),
            quant == "int8" and quantized and node.id in compiled.act_scales, quantized)
        if route is not None:
            n, _, oh, ow = analysis.shape(node.id, node.out_port)
            out.append((route, n * oh * ow, ci * kh * kw, co))
    return out


def direct_convs(compiled, quant):
    """(H, W, Ci, Co, kh, kw, pads, launches per forward) of the
    Convolutions of a compiled network that conv2d_direct runs on KERNELS
    (stride-1 spatial convs under INT8-FULL, ``kernel_route``)."""
    from pyopenvino_tpu_torch.ir.attrs import get_int_tuple
    from pyopenvino_tpu_torch.ops.conv import kernel_route
    from pyopenvino_tpu_torch.ops.padding import conv_padding
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    model = compiled.model
    analysis = infer_shapes(model)
    convs = collections.Counter()
    for node in model.find_by_type("Convolution"):
        w_src = model.in_edges[node.id][1][0]
        co, ci, kh, kw = analysis.shape(w_src, model.nodes[w_src].out_port)
        quantized = w_src in compiled._quantized
        if kernel_route((co, ci, kh, kw), get_int_tuple(node.attrs, "strides", (1, 1)),
                        get_int_tuple(node.attrs, "dilations", (1, 1)),
                        quant == "int8" and quantized and node.id in compiled.act_scales,
                        quantized) != "conv2d_direct":
            continue
        _, _, h, w = analysis.shape(*model.in_edges[node.id][0])
        pads = conv_padding(node.attrs, (h, w), (kh, kw)).pads
        convs[(h, w, ci, co, kh, kw, pads)] += 1
    return [key + (count,) for key, count in sorted(convs.items())]


def matmul_launches(compiled, quant):
    """(kernel, M per image, K, N) of every MatMul of a compiled network
    that launches fused_gemm on KERNELS (a 2-D weight, ops/matmul.py):
    int8 × int8 under INT8-FULL where the weight is int8 and the MatMul has
    an activation scale, the int8-B variant for any other int8 weight."""
    from pyopenvino_tpu_torch.ir.attrs import get_bool
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes

    model = compiled.model
    analysis = infer_shapes(model)
    out = []
    for node in model.find_by_type("MatMul"):
        (a_src, a_port), (w_src, w_port) = model.in_edges[node.id][0], model.in_edges[node.id][1]
        w_shape = analysis.shape(w_src, w_port)
        if len(w_shape) != 2 or w_src not in compiled._runtime_consts:
            continue
        a_shape = analysis.shape(a_src, a_port)
        ta, tb = get_bool(node.attrs, "transpose_a"), get_bool(node.attrs, "transpose_b")
        k, n = w_shape[::-1] if tb else w_shape
        m = int(np.prod(a_shape[:-2])) * (a_shape[-1] if ta else a_shape[-2])
        quantized = w_src in compiled._quantized
        route = ("fused_gemm_i8i8" if quant == "int8" and quantized and node.id in compiled.act_scales
                 else "fused_gemm_i8w" if quantized else "fused_gemm")
        out.append((route, m, k, n))
    return out


def gemm_table(launches):
    """{kernel: [(M per image, K, N, launches per forward)]} of conv_launches."""
    table = {}
    for (route, *shape), count in sorted(collections.Counter(launches).items()):
        table.setdefault(route, []).append((*shape, count))
    return table


def launch_table(compiled, quant):
    """gemm_table of a compiled network's routed Convolutions and MatMuls:
    the fused_gemm and conv2d_direct launches of one forward."""
    return gemm_table(conv_launches(compiled, quant) + matmul_launches(compiled, quant))


def launch_counts():
    """{kernel: its wrapper's launch counter}, named as in COUNTERS."""
    from pyopenvino_tpu_torch.kernels import launch_counts as counts

    return counts()


def compiled_per_forward(compiled, quant, softmax):
    """Expected launches of each kernel in one forward of a compiled network
    on KERNELS: one per routed Convolution and MatMul, and ``softmax``
    softmax_rows launches (SSD ends in Sigmoid, the classifiers in one 2-D
    SoftMax)."""
    counts = dict.fromkeys(COUNTERS, 0)
    for route, *_ in conv_launches(compiled, quant) + matmul_launches(compiled, quant):
        counts[route] += 1
    counts["softmax_rows"] = softmax
    return counts


def mesh_per_forward(compiled, quant, softmax, tp=1, sp=1, owned=None):
    """compiled_per_forward for one forward of a mesh row
    (pyopenvino_tpu_torch/parallel/mesh.py), predicted from the compiled
    graph's shapes: with ``tp`` > 1 a routed Convolution or MatMul whose
    output channels the model axis divides runs ``tp`` times, each on its
    slice and by its slice's route (TP); with ``sp`` > 1 a routed
    Convolution with at least ``sp`` output rows runs once a row block
    (SP); ``softmax`` softmax_rows launches run once, on the gathered
    rows.  ``owned``: on a row across processes, the model indices (TP) or
    row blocks (SP) of the row that one process owns, which are all it
    runs of a sharded node; the rest it runs once, as every owner does."""
    owned = owned or max(tp, sp)
    from pyopenvino_tpu_torch.ir.attrs import get_bool, get_int_tuple
    from pyopenvino_tpu_torch.ops.conv import kernel_route

    model, analysis = compiled.model, compiled.analysis
    counts = dict.fromkeys(COUNTERS, 0)
    counts["softmax_rows"] = softmax
    for node in model:
        if node.op_type not in ("Convolution", "MatMul"):
            continue
        w_src = model.in_edges[node.id][1][0]
        w_shape = analysis.shape(w_src, model.nodes[w_src].out_port)
        quantized = w_src in compiled._quantized
        int8 = quant == "int8" and quantized and node.id in compiled.act_scales
        if node.op_type == "Convolution":
            co, ci, kh, kw = w_shape
            split = tp > 1 and co > 1 and co % tp == 0
            route = kernel_route((co // tp if split else co, ci, kh, kw),
                                 get_int_tuple(node.attrs, "strides", (1, 1)),
                                 get_int_tuple(node.attrs, "dilations", (1, 1)), int8, quantized)
            rows = analysis.shape(node.id, node.out_port)[2]
            shards = owned if split or (sp > 1 and rows >= sp) else 1
        else:
            if len(w_shape) != 2 or w_src not in compiled._runtime_consts:
                continue
            n = w_shape[0] if get_bool(node.attrs, "transpose_b") else w_shape[1]
            shards = owned if tp > 1 and n > 1 and n % tp == 0 else 1
            route = ("fused_gemm_i8i8" if int8 else "fused_gemm_i8w" if quantized
                     else "fused_gemm")
        if route is not None:
            counts[route] += shards
    return counts


def softmax_rows_of(compiled):
    """N of every SoftMax of a compiled network that runs softmax_rows on
    KERNELS: a 2-D input over its last axis (ops/elementwise.py)."""
    model = compiled.model
    out = []
    for node in model.find_by_type("SoftMax"):
        shape = compiled.analysis.shape(*model.in_edges[node.id][0])
        if len(shape) == 2 and int(node.attrs.get("axis", 1)) in (1, -1):
            out.append(shape[1])
    return out


def ssd_dw_pw_pairs(model):
    """(H, W, C, Co, count) of every stride-1 3×3 depthwise conv whose
    output (through its bias Add and activation) feeds one 1×1 stride-1
    Convolution: the pairs dw_pw_fused computes."""
    from pyopenvino_tpu_torch.ir.attrs import get_int_tuple
    from pyopenvino_tpu_torch.passes.shape_infer import infer_shapes
    from pyopenvino_tpu_torch.passes.util import single_consumer

    analysis = infer_shapes(model)
    pairs = {}
    for node in model.find_by_type("GroupConvolution"):
        w_src = model.in_edges[node.id][1][0]
        g, co_g, ci_g, kh, kw = analysis.shape(w_src, model.nodes[w_src].out_port)
        if ((co_g, ci_g, kh, kw) != (1, 1, 3, 3)
                or get_int_tuple(node.attrs, "strides", (1, 1)) != (1, 1)):
            continue
        nxt = single_consumer(model, node.id)
        while nxt is not None and nxt[0].op_type in ("Add", "Clamp", "ReLU"):
            nxt = single_consumer(model, nxt[0].id)
        if nxt is None or nxt[0].op_type != "Convolution" or nxt[1] != 0:
            continue
        pw_src = model.in_edges[nxt[0].id][1][0]
        co, ci, pkh, pkw = analysis.shape(pw_src, model.nodes[pw_src].out_port)
        if (pkh, pkw) != (1, 1) or get_int_tuple(nxt[0].attrs, "strides", (1, 1)) != (1, 1):
            continue
        _, c, h, w = analysis.shape(*model.in_edges[node.id][0])
        pairs[(h, w, c, co)] = pairs.get((h, w, c, co), 0) + 1
    return [key + (count,) for key, count in pairs.items()]


def int_mm_operands(torch, a, b):
    """torch._int_mm's operands for a (M, K) @ (K, N) int8 product: it takes
    M > 16 and K, N multiples of 8, so a shape outside that is zero-padded
    (M to 32, K and N up to a multiple of 8); B is passed column-major.
    Returns (a, b, the padded (M, K, N) or None)."""
    m, k = a.shape
    n = b.shape[1]
    mp = 32 if m <= 16 else m
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp, np_) != (m, k, n):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return a.contiguous(), b.t().contiguous().t(), (
        None if (mp, kp, np_) == (m, k, n) else {"M": mp, "K": kp, "N": np_})


@contextlib.contextmanager
def recorded_fake_quantize(record):
    """Within the block every FakeQuantize of the port puts its data input
    into ``record[its name]`` (the input forced_fake_quantize needs in
    bfloat16)."""
    from pyopenvino_tpu_torch.ops import extended

    own_emit = extended.FakeQuantize.emit

    def emit(op, ctx, node, inputs):
        record[node.name] = inputs[0].arr
        return own_emit(op, ctx, node, inputs)

    extended.FakeQuantize.emit = emit
    try:
        yield
    finally:
        extended.FakeQuantize.emit = own_emit


@contextlib.contextmanager
def forced_fake_quantize(forced, stats, forced_inputs=None):
    """Within the block every FakeQuantize of the port emits ``forced[its
    name]`` (another run's output of it) instead of its own, after holding
    its own output to it: where the codes differ they differ by one output
    step, the input lies within FLIP_DIST · max |input| of the midpoint
    between them, and at the end at most FLIP_RATE of all outputs differ.
    In bfloat16 every step of the op rounds to bfloat16, so its levels are
    not evenly spaced and its midpoints are not where float32 puts them:
    there, where the outputs differ, the two runs' inputs
    (``forced_inputs``, the other run's) lie within FLIP_DIST_BF16 · max
    |input| of each other, and at most FLIP_RATE_BF16 of the outputs
    differ.  Adds "flips", "elements", "worst_midpoint_dist" and, in
    bfloat16, "worst_input_gap" to ``stats``."""
    import torch

    from pyopenvino_tpu_torch.ops import extended
    from pyopenvino_tpu_torch.ops.spec import TValue

    own_emit = extended.FakeQuantize.emit
    counts = collections.Counter()
    rate = [FLIP_RATE]

    def emit(op, ctx, node, inputs):
        own = own_emit(op, ctx, node, inputs)[node.out_port].arr
        other = forced[node.name].to(own.device)
        if other.stride() != own.stride():
            other = torch.empty_like(own).copy_(other)
        counts["elements"] += own.numel()
        diff = own != other
        if own.dtype == torch.bfloat16:
            rate[0] = FLIP_RATE_BF16
            if diff.any():
                x_own = torch.broadcast_to(inputs[0].arr, own.shape).float()
                x_other = forced_inputs[node.name].to(own.device).float()
                gap = ((x_own - x_other).abs()[diff].max().item()
                       / max(x_own.abs().max().item(), 1e-30))
                if gap > FLIP_DIST_BF16:
                    raise AssertionError(
                        f"FakeQuantize {node.name}: an output differs where the inputs lie "
                        f"{gap:.3e} of max |x| apart (limit {FLIP_DIST_BF16})")
                counts["flips"] += int(diff.sum())
                counts["worst_input_gap"] = max(counts["worst_input_gap"], gap)
            return {node.out_port: TValue(other)}
        if diff.any():
            x_in, il, ih, ol, oh = (torch.broadcast_to(inputs[i].arr, own.shape).double()
                                    for i in range(5))
            steps = op._levels(node) - 1
            step = (oh - ol) / steps
            k_own, k_other = (((v.double() - ol) / step).round() for v in (own, other))
            if not ((k_own - k_other)[diff].abs() == 1).all():
                raise AssertionError(f"FakeQuantize {node.name}: the codes differ by other "
                                     f"than one step")
            a = steps / (ih - il)
            codes = (torch.clip(x_in, il, ih) - il) * a
            dist = ((codes - codes.floor() - 0.5).abs() / a)[diff].max().item()
            worst = dist / max(inputs[0].arr.abs().max().item(), 1e-30)
            if worst > FLIP_DIST:
                raise AssertionError(
                    f"FakeQuantize {node.name}: a code differs where the input lies "
                    f"{worst:.3e} of max |x| from the midpoint (limit {FLIP_DIST})")
            counts["flips"] += int(diff.sum())
            counts["worst_midpoint_dist"] = max(counts["worst_midpoint_dist"], worst)
        return {node.out_port: TValue(other)}

    extended.FakeQuantize.emit = emit
    try:
        yield
    finally:
        extended.FakeQuantize.emit = own_emit
    if counts["flips"] > rate[0] * counts["elements"]:
        raise AssertionError(f"FakeQuantize: {counts['flips']} of {counts['elements']} codes "
                             f"differ (limit {rate[0]} of them)")
    stats.update(flips=stats.get("flips", 0) + counts["flips"],
                 elements=stats.get("elements", 0) + counts["elements"],
                 worst_midpoint_dist=max(stats.get("worst_midpoint_dist", 0.0),
                                         counts["worst_midpoint_dist"]))
    if "worst_input_gap" in counts:
        stats["worst_input_gap"] = max(stats.get("worst_input_gap", 0.0),
                                       counts["worst_input_gap"])


@contextlib.contextmanager
def no_fake_quantize():
    """Within the block every FakeQuantize of the port passes its input on:
    a run without the emulation, which a gate on the emulation must fail."""
    from pyopenvino_tpu_torch.ops import extended

    own_emit = extended.FakeQuantize.emit
    extended.FakeQuantize.emit = lambda op, ctx, node, inputs: {node.out_port: inputs[0]}
    try:
        yield
    finally:
        extended.FakeQuantize.emit = own_emit


def forced_reference(compiled, ref_compiled, x, capture=()):
    """TORCH's answer on ``x`` with every FakeQuantize output forced to the
    one KERNELS computes (``compiled`` on the same ``x``), for a path that
    emulates FakeQuantize: a last-bit difference of a kernel moves an input
    across a rounding midpoint now and then, and the flipped code then
    moves everything after it, so KERNELS is held against TORCH between the
    FakeQuantizes, each code TORCH rounds the other way held to
    ``forced_fake_quantize``'s limits.  Returns (host outputs, host
    captures of ``capture``, {"flips", "elements", "worst_midpoint_dist"})."""
    def plan(net):
        return (net.model, net.analysis) if x.shape[0] == 1 else net._batched_plan(x.shape[0])

    names = [n.name for n in compiled.model.find_by_type("FakeQuantize")]
    forced_inputs = {}
    with recorded_fake_quantize(forced_inputs):
        _, forced, _ = compiled._run(*plan(compiled), {"data": x}, names)
    stats = {}
    with forced_fake_quantize(forced, stats, forced_inputs):
        out, captured, _ = ref_compiled._run(*plan(ref_compiled), {"data": x}, capture)
    return ref_compiled._to_host(out), ref_compiled._to_host(captured), stats


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 2

    from pyopenvino_tpu_torch import IECore
    from pyopenvino_tpu_torch.config import Config, QuantMode
    from pyopenvino_tpu_torch.kernels import build
    from pyopenvino_tpu_torch.kernels.conv import (
        conv2d_fused, conv_weight_matrix, conv_weight_matrix_nk, gemm_rows,
    )
    from pyopenvino_tpu_torch.kernels.conv_direct import (
        conv2d_direct, conv2d_direct_plain, direct_bf16_plan, direct_bf16_route, direct_plan,
        direct_route, direct_takes,
    )
    from pyopenvino_tpu_torch.kernels.dw_pw import TILE_ROWS as DW_PW_TILE_ROWS
    from pyopenvino_tpu_torch.kernels.dw_pw import _max_channels as dw_pw_max_channels
    from pyopenvino_tpu_torch.kernels.dw_pw import co_split as dw_pw_co_split
    from pyopenvino_tpu_torch.kernels.dw_pw import dw_pw_fused, dw_pw_fused_plain, pick_tile_rows
    from pyopenvino_tpu_torch import PrePostProcessor
    from pyopenvino_tpu_torch.kernels import reset_launch_counts
    from pyopenvino_tpu_torch.kernels.gemm import (
        PLANS, bf16_route, conv2d_int32, epilogue, f32_plan, f32_route, f32_takes, fused_gemm,
        fused_gemm_plain, i8_plan, i8_route, i8_takes, split_k, wgmma_aligned, wgmma_plan,
    )
    from pyopenvino_tpu_torch.kernels.softmax import softmax_rows, softmax_rows_plain
    from pyopenvino_tpu_torch.metrics import mean_average_precision, parse_detection_records
    from pyopenvino_tpu_torch.models.efficientnet_b0 import efficientnet_b0_paths
    from pyopenvino_tpu_torch.models.lstm_tiny import lstm_tiny_paths
    from pyopenvino_tpu_torch.models.pot import CALIBRATION_SAMPLES as POT_CALIBRATION
    from pyopenvino_tpu_torch.models.pot import pot_ir_paths
    from pyopenvino_tpu_torch.models.pot import resnet18_pot_paths
    from pyopenvino_tpu_torch.models.shapes import shapes_det300
    from pyopenvino_tpu_torch.models.shufflenet_v2 import shufflenet_v2_paths
    from pyopenvino_tpu_torch.ir.builder import GraphBuilder
    from pyopenvino_tpu_torch.ir.writer import write_ir_model
    from pyopenvino_tpu_torch.models import op_graphs
    from pyopenvino_tpu_torch.models.moe_mlp import moe_mlp_paths
    from pyopenvino_tpu_torch.models.ocr_ti import ocr_ti_paths
    from pyopenvino_tpu_torch.models.synth import mobilenet_v2_paths, resnet18_paths
    from pyopenvino_tpu_torch.models.unet import unet_paths
    from pyopenvino_tpu_torch.models.vit_tiny import vit_tiny_paths
    from pyopenvino_tpu_torch.models.yolo_tiny import yolo_tiny_paths
    from pyopenvino_tpu_torch.models.yolo_v2 import RECORDS as YOLO_V2_RECORDS
    from pyopenvino_tpu_torch.models.yolo_v2 import yolo_v2_paths
    from pyopenvino_tpu_torch.tools import microbench_dw_pw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    phase_t0 = time.perf_counter()
    phases_s = 0.0

    def phase_done(name):
        nonlocal phase_t0, phases_s
        now = time.perf_counter()
        log(f"phase {name}: {now - phase_t0:.2f} s")
        phases_s += now - phase_t0
        phase_t0 = now

    # -- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import triton

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
        f"{triton.__version__} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    phase_done("1 environment")

    ie = IECore()

    # -- 2. build ------------------------------------------------------------
    from pyopenvino_tpu_torch import native

    def build_native():
        t_native = time.perf_counter()
        path = native.build()
        return path, time.perf_counter() - t_native

    t0 = time.perf_counter()
    native_build = concurrent.futures.ThreadPoolExecutor(1)
    native_built = native_build.submit(build_native)  # g++ beside the nvcc processes
    logs = build.build_all()
    log(f"build: nvcc {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    native_path, native_s = native_built.result()
    native_build.shutdown()
    if not native.available():
        raise AssertionError(f"native host library {native_path} does not load")
    log(f"build: g++ {native_s:.2f} s for native/preprocess.cpp -> {native_path.name} "
        f"({native_path.stat().st_size} bytes, flags {' '.join(native.CXX_FLAGS)})")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")
    t0 = time.perf_counter()
    softmax_rows(torch.zeros((1, 1000), device=dev))
    torch.cuda.synchronize()
    log(f"build: triton softmax_rows first launch {time.perf_counter() - t0:.2f} s")
    phase_done("2 build")

    counters = launch_counts

    reset_counters = reset_launch_counts

    # SSD's three KERNELS executables, prepared once before the checks
    # (INT8-FULL calibrated on the host): their Convolutions give the GEMM
    # shapes that phase 3 checks and phase 5a times, and phase 4 drives them
    ssd_net = ie.read_network(*SSD_PATHS)
    ssd_req_x, ssd_req_gt = shapes_det300(REQUESTS, seed=11)
    ssd_batch_x, ssd_batch_gt = shapes_det300(BATCH, seed=12)
    ssd_cal_x, _ = shapes_det300(SSD_CALIBRATION, seed=13)
    ssd_requests = [ssd_req_x[i:i + 1] for i in range(REQUESTS)]
    ssd_calibration = [{SSD_INPUT: ssd_cal_x[i:i + 1]} for i in range(SSD_CALIBRATION)]
    ssd_gt = dict(enumerate(ssd_req_gt + ssd_batch_gt))

    def ssd_loaded(quant, kernel_type, **config):
        exe = ie.load_network(ssd_net, "GPU", config=Config(
            quant=quant, quant_min_elems=SSD_QUANT_MIN_ELEMS,
            bias_correction=quant == QuantMode.INT8_FULL, **config))
        exe.kernel_type = kernel_type
        if quant == QuantMode.INT8_FULL:
            exe.set_calibration(ssd_calibration)
        return exe

    # {model: {kernel: [(M per image, K, N, launches per forward)]}} of the
    # networks read from their compiled graphs (SSD, EfficientNet-B0,
    # googlenet_shapes), and {model: direct_convs} of those that run
    # conv2d_direct
    net_gemms, net_direct = {"ssd_shapes_ms": {}}, {}
    ssd_exes, ssd_gemms = {}, net_gemms["ssd_shapes_ms"]
    for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        t0 = time.perf_counter()
        ssd_exes[quant] = ssd_loaded(quant, "pallas")
        compiled = ssd_exes[quant].compiled()
        log(f"ssd_shapes_ms {quant.value}: prepared and compiled in "
            f"{time.perf_counter() - t0:.2f} s" + (
                f" (calibration and bias correction on {SSD_CALIBRATION} images)"
                if quant == QuantMode.INT8_FULL else ""))
        for route, shapes in gemm_table(conv_launches(compiled, quant.value)).items():
            log(f"ssd_shapes_ms {quant.value} {route} (M per image, K, N, launches "
                f"per forward): {shapes}")
            if route not in ("fused_gemm", "fused_gemm_i8w", "fused_gemm_i8i8"):
                raise AssertionError(f"SSD routes a conv to {route}: phases 3 and 5a "
                                     f"hold only fused_gemm's variants at SSD's shapes")
            ssd_gemms.setdefault(route, shapes)

    # EfficientNet-B0 (full width, weights from models/efficientnet_b0.py,
    # seed 0) and googlenet_shapes (trained weights): their three KERNELS
    # executables, INT8-FULL calibrated on the host (googlenet_shapes with
    # bias correction, its tools/accuracy.py setting).  Inputs are seeded
    # uniform images in [0, 255), the range both IRs take (EfficientNet-B0
    # folds the 1/255 input scale into its stem); googlenet_shapes' labelled
    # images are drawn with OpenCV, so its labelled accuracy is a CPU test.
    img_rng = np.random.default_rng(21)
    images = {"requests": [img_rng.uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)
                           for _ in range(REQUESTS)],
              "batch": img_rng.uniform(0, 255, (BATCH, 3, 224, 224)).astype(np.float32),
              "calibration": [img_rng.uniform(0, 255, (1, 3, 224, 224)).astype(np.float32)
                              for _ in range(GOOGLENET_CALIBRATION)]}
    # the POT IR: the port's ResNet-18 (seed-0 weights) quantized by the
    # port's tools/pot_quantize.py on 4 samples (numpy interpreter on the
    # host), written by ir/writer.py and read back as a user's POT IR
    pot_built = not os.path.exists(pot_ir_paths(0)[0])
    t0 = time.perf_counter()
    pot_paths = resnet18_pot_paths(seed=0)
    log(f"resnet18_pot: POT IR {'quantized and written' if pot_built else 'found'} in "
        f"{time.perf_counter() - t0:.2f} s ({POT_CALIBRATION} calibration samples)")
    # {model: (network, calibration images under INT8-FULL (0: none, the
    # scales come from the IR), further INT8-FULL Config fields)}
    more_nets = {"efficientnet_b0": (ie.read_network(*efficientnet_b0_paths(seed=0)),
                                     CALIBRATION, {}),
                 "googlenet_shapes": (ie.read_network(*GOOGLENET_PATHS), GOOGLENET_CALIBRATION,
                                      {"bias_correction": True}),
                 "shufflenet_v2": (ie.read_network(*shufflenet_v2_paths(seed=0)),
                                   CALIBRATION, {}),
                 "resnet18_pot": (ie.read_network(*pot_paths), 0, {})}

    def more_loaded(model, quant, kernel_type, **config):
        net, n_cal, int8full_config = more_nets[model]
        if quant == QuantMode.INT8_FULL:
            config = {**int8full_config, **config}
        exe = ie.load_network(net, "GPU", config=Config(quant=quant, **config))
        exe.kernel_type = kernel_type
        if quant == QuantMode.INT8_FULL and n_cal:
            exe.set_calibration([{"data": x} for x in images["calibration"][:n_cal]])
        return exe

    more_exes = {}
    for model in more_nets:
        net_gemms[model] = {}
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            t0 = time.perf_counter()
            exe = more_exes[model, quant] = more_loaded(model, quant, "pallas")
            compiled = exe.compiled()
            n_cal = more_nets[model][1]
            log(f"{model} {quant.value}: prepared and compiled in "
                f"{time.perf_counter() - t0:.2f} s" + (
                    "" if quant != QuantMode.INT8_FULL
                    else f" (calibration on {n_cal} images)" if n_cal
                    else f" (no calibration: {len(compiled.act_scales)} activation scales "
                         f"from the IR's FakeQuantize nodes)"))
            for route, shapes in launch_table(compiled, quant.value).items():
                log(f"{model} {quant.value} {route} (M per image, K, N, launches per "
                    f"forward): {shapes}")
                net_gemms[model].setdefault(route, shapes)
            direct = direct_convs(compiled, quant.value)
            if direct:
                log(f"{model} {quant.value} conv2d_direct (H, W, Ci, Co, kh, kw, pads, "
                    f"launches per forward): {direct}")
                net_direct[model] = direct
    phase_done("2b SSD, EfficientNet-B0, googlenet_shapes, ShuffleNet-v2 and resnet18_pot "
               "prepared")

    # U-Net, ViT-tiny, MoE-MLP, lstm-tiny, yolo-tiny, ocr-ti and yolo-v2 at
    # their generators' widths (weights from the port's replays: seed 0,
    # MoE-MLP its generator's 2024, yolo-tiny and yolo-v2 their 20260820):
    # their three KERNELS executables, INT8-FULL calibrated on CALIBRATION
    # seeded inputs on the host (ocr-ti's TensorIterators by the numpy
    # interpreter); inputs uniform in [0, 255) (each stem folds the 1/255
    # input scale; lstm-tiny's (1, 32, 40) and ocr-ti's (1, 24, 32) feature
    # matrices, as tools/accuracy.py feeds them).  A graph that cannot carry
    # the batch in N (MoE-MLP's gate Reshape, ocr-ti's batch-1 bodies,
    # yolo-v2's decode Reshape) answers infer_batch one example at a time
    # (CompiledNetwork._batched_plan), so its batch-64 forward is 64
    # batch-1 forwards: ``per_example``.
    family_nets = {model: ie.read_network(*paths()) for model, paths in (
        ("unet", unet_paths), ("vit_tiny", vit_tiny_paths), ("moe_mlp", moe_mlp_paths),
        ("lstm_tiny", lstm_tiny_paths), ("yolo_tiny", yolo_tiny_paths),
        ("ocr_ti", ocr_ti_paths), ("yolo_v2", yolo_v2_paths))}
    fam_rng = np.random.default_rng(41)
    family_images = {}
    for model, net in family_nets.items():
        param = net.model.parameters[0]
        shape = param.outputs[param.out_port].shape
        family_images[model] = {
            "input": param.name,
            "requests": [fam_rng.uniform(0, 255, shape).astype(np.float32)
                         for _ in range(REQUESTS)],
            "batch": fam_rng.uniform(0, 255, (BATCH, *shape[1:])).astype(np.float32),
            "calibration": [fam_rng.uniform(0, 255, shape).astype(np.float32)
                            for _ in range(CALIBRATION)]}

    def family_loaded(model, quant, kernel_type, **config):
        exe = ie.load_network(family_nets[model], "GPU", config=Config(quant=quant, **config))
        exe.kernel_type = kernel_type
        if quant == QuantMode.INT8_FULL:
            in_name = family_images[model]["input"]
            exe.set_calibration([{in_name: x} for x in family_images[model]["calibration"]])
        return exe

    family_exes, per_example = {}, set()
    for model in family_nets:
        net_gemms[model] = {}
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            t0 = time.perf_counter()
            exe = family_exes[model, quant] = family_loaded(model, quant, "pallas")
            compiled = exe.compiled()
            log(f"{model} {quant.value}: prepared and compiled in "
                f"{time.perf_counter() - t0:.2f} s"
                + (f" (calibration on {CALIBRATION} images)"
                   if quant == QuantMode.INT8_FULL else ""))
            for route, shapes in launch_table(compiled, quant.value).items():
                log(f"{model} {quant.value} {route} (M per image, K, N, launches per "
                    f"forward): {shapes}")
                net_gemms[model].setdefault(route, shapes)
            direct = direct_convs(compiled, quant.value)
            if direct:
                log(f"{model} {quant.value} conv2d_direct (H, W, Ci, Co, kh, kw, pads, "
                    f"launches per forward): {direct}")
                net_direct[model] = direct
            if compiled._batched_plan(BATCH) is None:
                per_example.add(model)
    log(f"answer infer_batch one example at a time: {sorted(per_example)}")
    if not {"moe_mlp", "ocr_ti", "yolo_v2"} <= per_example:
        raise AssertionError(f"MoE-MLP, ocr-ti and yolo-v2 should answer infer_batch one "
                             f"example at a time; per_example is {sorted(per_example)}")
    # (model, N, launches per forward) of the families' 2-D SoftMax nodes:
    # softmax_rows' launches (U-Net's and ViT's attention softmaxes are rank
    # 4, yolo-tiny's class softmax a rank-5 view inside RegionYolo)
    family_softmax = sorted(
        (model, n, count) for model in family_nets
        for n, count in collections.Counter(softmax_rows_of(
            family_exes[model, QuantMode.NONE].compiled())).items())
    log(f"softmax_rows (model, N, launches per forward): {family_softmax}")

    def batch_rows(model, b):
        """(M multiplier, launches multiplier) of a batch-``b`` forward of a
        network's table rows (M per image): one launch at M·b, or b
        launches at M for a per-example network."""
        return (1, b) if model in per_example else (b, 1)

    phase_done("2c U-Net, ViT-tiny, MoE-MLP, lstm-tiny, yolo-tiny, ocr-ti and yolo-v2 prepared")

    # -- 2d. the op-type recipes (models/op_graphs.py) ------------------------
    # each recipe built at full width with the port's GraphBuilder from seed
    # 0, written by the port's writer into a directory of its own and read
    # back through IECore.read_network; its KERNELS networks compiled in the
    # three modes (INT8-FULL calibrated on CALIBRATION seeded inputs): their
    # fused_gemm launches join phase 3's shapes (not phase 5a's times)
    recipe_dir = tempfile.TemporaryDirectory(prefix="op_graphs_")
    recipe_nets, recipe_inputs, recipe_exes, recipe_gemms = {}, {}, {}, {}

    def recipe_loaded(name, quant, kernel_type, **config):
        exe = ie.load_network(recipe_nets[name], "GPU", config=Config(quant=quant, **config))
        exe.kernel_type = kernel_type
        if quant == QuantMode.INT8_FULL:
            exe.set_calibration(recipe_inputs[name]["calibration"])
        return exe

    for seed, name in enumerate(op_graphs.RECIPES):
        t0 = time.perf_counter()
        model, recipe = op_graphs.build(GraphBuilder, name, seed=0)
        xml = os.path.join(recipe_dir.name, f"{name}.xml")
        write_ir_model(model, xml)
        recipe_nets[name] = ie.read_network(xml)
        rec_rng = np.random.default_rng(40 + seed)
        recipe_inputs[name] = {
            "recipe": recipe,
            "requests": [recipe.inputs(rec_rng, 1) for _ in range(RECIPE_REQUESTS)],
            "batch": recipe.inputs(rec_rng, BATCH),
            "calibration": [recipe.inputs(rec_rng, 1) for _ in range(CALIBRATION)]}
        key = f"op_graphs {name}"
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            exe = recipe_exes[name, quant] = recipe_loaded(name, quant, "pallas")
            compiled = exe.compiled()
            for route, shapes in launch_table(compiled, quant.value).items():
                log(f"{key} {quant.value} {route} (M per image, K, N, launches per "
                    f"forward): {shapes}")
                recipe_gemms.setdefault(key, {}).setdefault(route, shapes)
            if not compiled.variables and compiled._batched_plan(BATCH) is None:
                per_example.add(key)
        if name == "lstm_stream":
            # phase 4f's stream: chunks in order, and 64 streams in lockstep
            recipe_inputs[name]["chunks"] = [recipe.inputs(rec_rng, 1) for _ in range(8)]
            recipe_inputs[name]["streams"] = [recipe.inputs(rec_rng, BATCH) for _ in range(4)]
        log(f"{key}: {len(model.nodes)} nodes ({', '.join(op_graphs.COVERS[name])}), "
            f"written, read back and compiled in {time.perf_counter() - t0:.2f} s")
    if {k for k in per_example if k.startswith("op_graphs")} != {
            "op_graphs gather_scatter", "op_graphs layout", "op_graphs two_stage"}:
        raise AssertionError(f"only gather_scatter (batch-1 bag indices), layout (SpaceToBatch "
                             f"merges the batch with its block) and two_stage (its rois' "
                             f"batch column reshaped to (300,)) should answer infer_batch one "
                             f"example at a time: {sorted(per_example)}")
    phase_done("2d op-type recipes prepared")

    # -- 3. kernel checks ----------------------------------------------------
    rng = np.random.default_rng(0)
    reset_counters()

    def rand(shape, lo=None, hi=None):
        arr = (rng.standard_normal(shape) if lo is None
               else rng.uniform(lo, hi, shape)).astype(np.float32)
        return torch.from_numpy(arr).to(dev)

    def rand_int8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    errs = dict.fromkeys(COUNTERS, 0.0)

    def check_gemm(name, a, b, scale, bias, act, what):
        """#1 or #1w as routed, then forced onto each loop that takes the
        launch (mma.sync always, wgmma where f32_takes), each within its
        gate of the plain version and the same bits on a second call."""
        m, k = a.shape
        n = b.shape[1]
        want = fused_gemm_plain(a, b, scale, bias, act)
        b_int8 = b.dtype == torch.int8
        lda = a.stride(0) if m > 1 else k
        # C's base: a fresh output of the caching allocator, 512-byte aligned
        route = f32_route(m, k, n, lda, a.data_ptr(), b.data_ptr(), 0, b_int8, sms)
        takes = f32_takes(k, n, lda, a.data_ptr(), b.data_ptr(), 0, b_int8)
        for loop in (None, "mma", *(["wgmma"] if takes else [])):
            got = fused_gemm(a, b, scale, bias, act, f32_loop=loop)
            torch.cuda.synchronize()
            plan = route if loop is None else f32_plan(m, k, n, b_int8, sms)
            tag = ("loop=mma" if loop == "mma" or (loop is None and route is None) else
                   f"loop=wgmma splits={plan.splits} band={int(plan.band)}")
            tag = f"{'routed ' if loop is None else ''}{tag}"
            abs_err = (got - want).abs().max().item()
            rel = abs_err / max(want.abs().max().item(), 1e-30)
            log(f"check {name} {what} {tag}: max_abs_err {abs_err:.3e} max_rel_err {rel:.3e}")
            if rel > (I8W_RTOL if name == "fused_gemm_i8w" else GEMM_RTOL):
                raise AssertionError(f"{name} disagrees at {what} {tag}: {rel}")
            if not torch.equal(got, fused_gemm(a, b, scale, bias, act, f32_loop=loop)):
                raise AssertionError(f"{name} gives other bits on a second call at {what} {tag}")
            errs[name] = max(errs[name], abs_err)

    def check_exact(name, got, want, what):
        """An int8 kernel against its plain version: exact int32 sums and
        the same epilogue, so no difference at all."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name} at {what}: shape {got.shape} != {want.shape}")
        abs_err = (got - want).abs().max().item()
        log(f"check {name} {what}: max_abs_err {abs_err:.3e}")
        if abs_err != 0:
            raise AssertionError(f"{name} differs from its plain version at {what}: {abs_err}")
        if name in errs:
            errs[name] = max(errs[name], abs_err)

    def check_i8_loops(name, a, w, scale, bias, act, out_dtype, what):
        """#1ii or #1ii-bf16 as routed, then forced onto each loop that
        takes the launch (mma.sync always, wgmma where i8_takes), each
        against the plain version exactly and the same bits on a second
        call."""
        m, k = a.shape
        n = w.shape[1]
        want = fused_gemm_plain(a, w, scale, bias, act, out_dtype).float()
        bf = out_dtype == torch.bfloat16
        lda = a.stride(0) if m > 1 else k
        # C's base: a fresh output of the caching allocator, 512-byte aligned
        route = i8_route(m, k, n, lda, a.data_ptr(), w.data_ptr(), 0, bf, sms)
        takes = i8_takes(k, n, lda, a.data_ptr(), w.data_ptr(), 0, bf)
        for loop in (None, "mma", *(["wgmma"] if takes else [])):
            got = fused_gemm(a, w, scale, bias, act, out_dtype=out_dtype, i8_loop=loop)
            if got.dtype != out_dtype:
                raise AssertionError(f"{name} wrote {got.dtype} at {what}")
            plan = route if loop is None else i8_plan(m, k, n, got.element_size(), sms)
            tag = ("loop=mma" if loop == "mma" or (loop is None and route is None) else
                   f"loop=wgmma bn={plan.bn} sl={plan.sl} splits={plan.splits}")
            check_exact(name, got.float(), want,
                        f"{what} {'routed ' if loop is None else ''}{tag}")
            if not torch.equal(got, fused_gemm(a, w, scale, bias, act, out_dtype=out_dtype,
                                               i8_loop=loop)):
                raise AssertionError(f"{name} gives other bits on a second call at {what} {tag}")

    def path_shapes(name, classifiers):
        """(M, K, N) of a fused_gemm variant's main-path launches at B = 1
        and 64: the classifiers' (their tables), then those read from the
        compiled networks (SSD, EfficientNet-B0, googlenet_shapes)."""
        return sorted({(m, k, n) for b in (1, BATCH) for model in classifiers
                       for m, k, n, _ in classifiers[model](b)}
                      | {(m * batch_rows(model, b)[0], k, n) for b in (1, BATCH)
                         for model, table in {**net_gemms, **recipe_gemms}.items()
                         for m, k, n, _ in table.get(name, [])})

    ragged = [(1000, 77, 130, True, True, ("relu", 0.0, 0.0)),
              (65, 33, 200, False, False, ("clamp", -0.5, 0.5)),
              (130, 70, 129, True, False, None), (3, 1, 5, False, True, None),
              (1, 77, 1000, True, True, None)]
    for m, k, n, use_scale, use_bias, act in (
            [(m, k, n, False, True, None) for m, k, n in path_shapes("fused_gemm", GEMMS)]
            + ragged):
        a, b = rand((m, k)), rand((k, n))
        scale = rand((n,), 0.5, 1.5) if use_scale else None
        bias = rand((n,)) if use_bias else None
        check_gemm("fused_gemm", a, b, scale, bias, act,
                   f"M={m} K={k} N={n} scale={use_scale} bias={use_bias} act={act}")
    for i, (m, k, n, lda) in enumerate(TC_EDGES + F32_WGMMA_EDGES):
        check_gemm("fused_gemm", rand((m, lda))[:, :k], rand((k, n)), None, rand((n,)),
                   (("relu", 0.0, 0.0), None)[i % 2],
                   f"M={m} K={k} N={n} lda={lda} (tensor-core edge)")
    # int8 B: every path shape with its scale and bias, then ragged K/N
    # (N % 4 != 0 takes the byte path) and a B that is not 4-byte aligned
    for m, k, n, use_bias, act in (
            [(m, k, n, True, None) for m, k, n in path_shapes("fused_gemm_i8w", GEMMS)]
            + [(1, 77, 1000, True, None), (64, 77, 1000, True, ("relu", 0.0, 0.0)),
               (130, 70, 129, False, None), (65, 33, 200, True, ("clamp", 0.0, 6.0)),
               (3, 1, 5, False, None)]):
        a, b = rand((m, k)), rand_int8((k, n))
        scale, bias = rand((n,), 0.001, 0.02), rand((n,)) if use_bias else None
        check_gemm("fused_gemm_i8w", a, b, scale, bias, act,
                   f"M={m} K={k} N={n} int8 bias={use_bias} act={act}")
    for i, (m, k, n, lda) in enumerate(TC_EDGES + F32_WGMMA_EDGES):
        check_gemm("fused_gemm_i8w", rand((m, lda))[:, :k], rand_int8((k, n)),
                   rand((n,), 0.001, 0.02), rand((n,)), (("relu", 0.0, 0.0), None)[i % 2],
                   f"M={m} K={k} N={n} lda={lda} int8 (tensor-core edge)")
    flat = rand_int8((96 * 1000 + 1,))
    b = flat[1:].view(96, 1000)
    check_gemm("fused_gemm_i8w", rand((37, 96)), b, rand((1000,), 0.001, 0.02),
               None, None, f"M=37 K=96 N=1000 int8 B at address % 4 == {b.data_ptr() % 4}")
    # strided rows (lda > K)
    big = rand((300, 96))
    check_gemm("fused_gemm", big[:, 7:77], rand((70, 129)), None, None,
               ("relu", 0, 0), "lda=96 K=70")
    check_gemm("fused_gemm_i8w", big[:, 7:77], rand_int8((70, 128)),
               rand((128,), 0.001, 0.02), None, None, "lda=96 K=70 int8")
    # ShuffleNet-v2's Split halves as A: a channel half of a channels_last
    # activation, a view with row stride C (kernels/conv.py gemm_rows); the
    # FP32 and INT8W paths hand stage 3's to #1 / #1w, and the int8 codes of
    # every stage's half (INT8-FULL quantizes a dense copy on the path) are
    # #1ii's strided edge
    def split_half(b, c, hw, codes):
        x = (rand_int8((b, hw, hw, c)) if codes else rand((b, hw, hw, c))).permute(0, 3, 1, 2)
        half = torch.split(x, c // 2, dim=1)[1].permute(0, 2, 3, 1)
        a = gemm_rows(half)
        if a.stride() != (c, 1) or a.data_ptr() != half.data_ptr():
            raise AssertionError(f"the Split half of C={c} is not a strided view: {a.stride()}")
        return a

    for b in (1, BATCH):
        a = split_half(b, 464, 7, False)
        what = f"Split half M={a.shape[0]} K=232 lda=464 offset={a.storage_offset()}"
        check_gemm("fused_gemm", a, rand((232, 232)), None, rand((232,)), ("relu", 0, 0), what)
        check_gemm("fused_gemm_i8w", a, rand_int8((232, 232)), rand((232,), 0.001, 0.02),
                   rand((232,)), ("relu", 0, 0), what + " int8")
        for c, hw in ((116, 28), (232, 14), (464, 7)):
            a = split_half(b, c, hw, True)
            w, scale, bias = rand_int8((c // 2, c // 2)).t(), rand((c // 2,), 1e-4, 1e-2), \
                rand((c // 2,))
            check_exact("fused_gemm_i8i8", fused_gemm(a, w, scale, bias, ("relu", 0, 0)),
                        fused_gemm_plain(a, w, scale, bias, ("relu", 0, 0)),
                        f"Split half M={a.shape[0]} K={c // 2} lda={c} "
                        f"offset={a.storage_offset()} (int8 codes)")
    # the conv wrapper at a shortcut's shape, against cuDNN, f32 and int8
    x = rand((BATCH, 56, 56, 64))
    w, cb = rand((128, 64, 1, 1)), rand((128,))
    wq, ws = rand_int8((128, 64, 1, 1)), rand((128,), 0.001, 0.02)
    for what, got, wref in (
            ("f32", conv2d_fused(x, w, bias=cb, strides=(2, 2)), w),
            ("int8", conv2d_fused(x, wq, scale=ws, bias=cb, strides=(2, 2)),
             wq.float() * ws.reshape(-1, 1, 1, 1))):
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), wref, cb, stride=2).permute(0, 2, 3, 1)
        rel = (got - want).abs().max().item() / want.abs().max().item()
        log(f"check conv2d_fused {what} 1x1/s2 x=(64,56,56,64) vs F.conv2d: "
            f"max_rel_err {rel:.3e}")
        if rel > GEMM_RTOL:
            raise AssertionError(f"conv2d_fused {what} disagrees with F.conv2d: {rel}")

    # int8 × int8: every INT8-FULL path shape at B = 1 and 64, then K % 4 != 0,
    # N odd, M = 1, lda > K, tiny shapes and the tensor-core loops' edges
    acts = (("relu", 0.0, 0.0), ("clamp", 0.0, 6.0), None)
    i8_shapes = path_shapes("fused_gemm_i8i8", {
        model: functools.partial(i8i8_gemms, model) for model in I8I8_GEMMS})
    # and ResNet-18's at every serving bucket (phase 4g)
    i8_shapes = sorted(set(i8_shapes) | {(m, k, n) for b in SERVE_BUCKETS
                                         for m, k, n, _ in i8i8_gemms("resnet18", b)})
    for i, (m, k, n, lda, use_bias) in enumerate(
            [(m, k, n, k, True) for m, k, n in i8_shapes]
            + [(65, 33, 131, 33, True), (1, 27, 32, 27, True), (37, 70, 129, 96, False),
               (130, 5, 7, 5, True), (3, 1, 1, 1, False)]
            + [(m, k, n, lda, True) for m, k, n, lda in TC_EDGES + I8_WGMMA_EDGES]):
        a = rand_int8((m, lda))[:, :k]
        b = rand_int8((n, k)).t()  # K-major, as the kernel takes it
        scale, bias = rand((n,), 1e-4, 1e-2), rand((n,)) if use_bias else None
        act = acts[i % 3]
        check_i8_loops("fused_gemm_i8i8", a, b, scale, bias, act, torch.float32,
                       f"M={m} K={k} N={n} lda={lda} bias={use_bias} act={act}")
    def check_direct_loops(name, x, wt, scale, bias, act, pads, out_dtype, what):
        """#3 or #3-bf16 as routed, then forced onto each loop that takes
        the conv (mma.sync always, wgmma where direct_takes), each against
        the plain version exactly and the same bits on a second call."""
        wmat = conv_weight_matrix_nk(wt).t()
        want = conv2d_direct_plain(x, wt, scale, bias, act, pads, out_dtype).float()
        n, h, w, ci = x.shape
        co, _, kh, kw = wt.shape
        m = n * (h + sum(pads[0]) - kh + 1) * (w + sum(pads[1]) - kw + 1)
        route = direct_route(n, h, w, ci, co, kh, kw, pads, x.data_ptr(), wmat.data_ptr(),
                             out_dtype, sms)
        loops = ["mma"] + (["wgmma"] if direct_takes(ci, co, kh, kw, pads, x.data_ptr(),
                                                      wmat.data_ptr(), out_dtype) else [])
        for loop in (None, *loops):
            got = conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat, out_dtype=out_dtype,
                                conv_loop=loop)
            if got.dtype != out_dtype:
                raise AssertionError(f"{name} wrote {got.dtype} at {what}")
            if loop == "wgmma":
                plan = direct_plan(m, kh * kw * ci, ci, co, got.element_size(), sms)
                tag = f"loop=wgmma splits={plan.splits}"
            elif loop == "mma" or route is None:
                tag = "loop=mma splits={}".format(
                    -(-kh * kw * ci // split_k(m, kh * kw * ci, co, PLANS["conv2d_direct"], sms)))
            else:
                tag = f"loop=wgmma splits={route.splits}"
            check_exact(name, got.float(), want, f"{what} {'routed ' if loop is None else ''}{tag}")
            if not torch.equal(got, conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat,
                                                  out_dtype=out_dtype, conv_loop=loop)):
                raise AssertionError(f"{name} gives other bits on a second call at {what} {tag}")

    # conv2d_direct: ResNet-18's four stride-1 3×3 shapes at B = 1 (split
    # K), at phase 4g's serving buckets and at 64, then the loader's edges
    # and the wgmma loop's, each with the K-major weight matrix the network
    # caches, on each loop
    for i, (n, h, w, ci, co, kh, kw, pads) in enumerate(
            [(b, hw, hw, c, c, 3, 3, ((1, 1), (1, 1)))
             for b in sorted({1, BATCH, *SERVE_BUCKETS}) for hw, c, _ in RESNET18_DIRECT]
            + [(b, *conv[:7]) for b in (1, BATCH) for convs in net_direct.values()
               for conv in convs] + DIRECT_I8_EDGES + WGMMA_DIRECT_EDGES):
        x, wt = rand_int8((n, h, w, ci)), rand_int8((co, ci, kh, kw))
        scale, bias, act = rand((co,), 1e-4, 1e-2), rand((co,)), acts[i % 3]
        check_direct_loops("conv2d_direct", x, wt, scale, bias, act, pads, torch.float32,
                           f"x=({n},{h},{w},{ci}) w=({co},{ci},{kh},{kw}) pads={pads} "
                           f"act={act}")
    # conv2d_fused on int8 codes at a 3×3/s2 shape (ResNet-18's layer2 entry)
    x, wt = rand_int8((BATCH, 56, 56, 64)), rand_int8((128, 64, 3, 3))
    scale, bias = rand((128,), 1e-4, 1e-2), rand((128,))
    acc = conv2d_int32(x.permute(0, 3, 1, 2), wt, (2, 2), (1, 1), ((1, 1), (1, 1)))
    check_exact("conv2d_fused int8", conv2d_fused(
        x, wt, scale=scale, bias=bias, act=("relu", 0.0, 0.0), strides=(2, 2),
        pads=((1, 1), (1, 1))), epilogue(acc.permute(0, 2, 3, 1).float(), scale, bias,
                                         ("relu", 0.0, 0.0)),
        "x=(64,56,56,64) w=(128,64,3,3) 3x3/s2 vs the exact conv")

    for m, n in [*((b, 1000) for b in sorted({BATCH, *SERVE_BUCKETS})), (1, 10), (BATCH, 10),
                 (7, 129), (3, 1), (5, 4097), (1, 100), (BATCH, 100), (1, 8)]:
        x = rand((m, n)) * 30
        got = softmax_rows(x)
        torch.cuda.synchronize()
        abs_err = (got - softmax_rows_plain(x)).abs().max().item()
        log(f"check softmax_rows M={m} N={n}: max_abs_err {abs_err:.3e}")
        if abs_err > SOFTMAX_ATOL:
            raise AssertionError(f"softmax_rows disagrees at {(m, n)}: {abs_err}")
        errs["softmax_rows"] = max(errs["softmax_rows"], abs_err)

    # kernel 3f: float32 conv2d_direct at ResNet-18's stride-1 3×3 shapes at
    # B = 1 and 64, then the ragged shapes, each with a float32 and with an
    # int8 weight (its scale multiplies the float32 sum)
    for i, (n, h, w, ci, co, kh, kw, pads) in enumerate(
            [(b, hw, hw, c, c, 3, 3, ((1, 1), (1, 1)))
             for b in (1, BATCH) for hw, c, _ in RESNET18_DIRECT] + DIRECT_F32_RAGGED):
        x, bias, act = rand((n, h, w, ci)), rand((co,)), (("relu", 0.0, 0.0), None)[i % 2]
        for wt, scale in ((rand((co, ci, kh, kw)), None),
                          (rand_int8((co, ci, kh, kw)), rand((co,), 1e-3, 1e-2))):
            what = (f"float32 x=({n},{h},{w},{ci}) w=({co},{ci},{kh},{kw}) {wt.dtype} "
                    f"pads={pads} act={act}")
            got = conv2d_direct(x, wt, scale, bias, act, pads)
            torch.cuda.synchronize()
            want = conv2d_direct_plain(x, wt, scale, bias, act, pads)
            abs_err = (got - want).abs().max().item()
            rel = abs_err / max(want.abs().max().item(), 1e-30)
            log(f"check conv2d_direct_f32 {what}: max_abs_err {abs_err:.3e} "
                f"max_rel_err {rel:.3e}")
            if got.shape != want.shape or rel > GEMM_RTOL:
                raise AssertionError(f"conv2d_direct_f32 disagrees at {what}: {rel}")
            if not torch.equal(got, conv2d_direct(x, wt, scale, bias, act, pads)):
                raise AssertionError(f"conv2d_direct_f32 gives other bits on a second call "
                                     f"at {what}")
            errs["conv2d_direct_f32"] = max(errs["conv2d_direct_f32"], abs_err)

    # kernel 4: dw_pw_fused at SSD's stride-1 pairs (from its IR) and the
    # published SSD-MobileNet-v1 pairs, B = 1 and 64, then C not a multiple
    # of 16 or 64, Co not a multiple of 64, M not a multiple of the tile and
    # C at the kernel's limit; int8 and float32 out, both tile heights
    ssd_pairs = ssd_dw_pw_pairs(ssd_net.model)
    log(f"ssd_shapes_ms stride-1 dw -> pw pairs (H, W, C, Co, count): {ssd_pairs}")
    relu6 = ("clamp", 0.0, 6.0)
    dw_pw_edges = [(1, 7, 9, 6, 16), (3, 5, 7, 20, 40), (2, 9, 9, 48, 100),
                   (1, 3, 5, min(dw_pw_max_channels(0, r) for r in DW_PW_TILE_ROWS), 72)]
    for b, h, w, c, co in (
            [(b, h, w, c, co) for b in (1, BATCH)
             for h, w, c, co, *_ in ssd_pairs + microbench_dw_pw.PUBLISHED] + dw_pw_edges):
        args = microbench_dw_pw.make_inputs(b, h, w, c, co, seed=h + c + b)
        for pw_act, s_out in ((relu6, 0.04), (None, None)):
            kw = dict(dw_act=relu6, pw_act=pw_act, s_mid=0.05, s_out=s_out)
            want = dw_pw_fused_plain(*args, **kw).double()
            for rows in DW_PW_TILE_ROWS:
                check_exact("dw_pw_fused", dw_pw_fused(*args, tile_rows=rows, **kw).double(),
                            want, f"B={b} {h}x{w}x{c}->{co} out={'int8' if s_out else 'float32'} "
                                  f"pw_act={pw_act} tile_rows={rows}")
    # bfloat16 compute: fused_gemm's bf16 variants (bf16 and int8 B) at every
    # ResNet-18 and MobileNet-v2 path shape at B = 1 and 64 and ResNet-18's
    # at the headline's 512, the tensor-core edges and ragged shapes, within
    # one bfloat16 step (bf16_steps), two calls bit-identical; the int8 x
    # int8 GEMM and conv2d_direct with a bfloat16 output at the same paths'
    # shapes and their edges, exact; softmax_rows in bfloat16
    bf16 = torch.bfloat16

    def check_bf16(name, got, want, what, floor=None):
        torch.cuda.synchronize()
        if got.dtype != bf16 or got.shape != want.shape:
            raise AssertionError(f"{name} at {what}: {got.dtype}{tuple(got.shape)}")
        worst, abs_err, equal = bf16_steps(torch, got, want, floor)
        log(f"check {name} {what}: max_abs_err {abs_err:.3e} worst/limit {worst:.3f} "
            f"bit-equal {equal:.5f}")
        if worst > 1.0:
            i = int(((got.double() - want.double()).abs() / bf16_ulp(torch, want)).argmax())
            log(f"  worst element {i}: got {got.flatten()[i].item()!r} want "
                f"{want.flatten()[i].item()!r}")
            raise AssertionError(f"{name} beyond one bfloat16 step at {what}: {worst}")
        errs[name] = max(errs[name], abs_err)

    def bf16_batches(model):
        return (1, BATCH, HEADLINE_BATCH) if model == "resnet18" else (1, BATCH)

    bf16_gemm_shapes = sorted({(m, k, n, k) for model, gemms in GEMMS.items()
                               for b in bf16_batches(model) for m, k, n, _ in gemms(b)})
    for i, (m, k, n, lda) in enumerate(
            bf16_gemm_shapes + TC_EDGES + [(1000, 77, 130, 77), (3, 1, 5, 1),
                                           (65, 33, 200, 33)]):
        a, bias, act = rand((m, lda))[:, :k].to(bf16), rand((n,)).to(bf16), acts[i % 3]
        for name, w, scale in (("fused_gemm_bf16", rand((k, n)).to(bf16), None),
                               ("fused_gemm_bf16_i8w", rand_int8((k, n)),
                                rand((n,), 0.001, 0.02).to(bf16))):
            got = fused_gemm(a, w, scale, bias, act)
            loop = ("wgmma" if bf16_route(m, k, n, lda, a.data_ptr(), w.data_ptr(),
                                          w.dtype == torch.int8, sms) else "mma")
            check_bf16(name, got, fused_gemm_plain(a, w, scale, bias, act),
                       f"M={m} K={k} N={n} lda={lda} act={act} loop={loop}",
                       gemm_floor(torch, a, w, scale))
            if not torch.equal(got, fused_gemm(a, w, scale, bias, act)):
                raise AssertionError(f"{name} gives other bits on a second call at {(m, k, n)}")
    for b in (1, BATCH):  # ShuffleNet-v2's Split half as a bf16 A, lda 464
        half = torch.split(rand((b, 7, 7, 464)).to(bf16).permute(0, 3, 1, 2), 232, dim=1)[1]
        a, w_half = gemm_rows(half.permute(0, 2, 3, 1)), rand((232, 232)).to(bf16)
        if a.stride() != (464, 1):
            raise AssertionError(f"the bf16 Split half is not a strided view: {a.stride()}")
        check_bf16("fused_gemm_bf16", fused_gemm(a, w_half), fused_gemm_plain(a, w_half),
                   f"Split half M={a.shape[0]} K=232 lda=464", gemm_floor(torch, a, w_half))
    i8_bf16_shapes = sorted({(m, k, n) for model in I8I8_GEMMS for b in bf16_batches(model)
                             for m, k, n, _ in i8i8_gemms(model, b)}
                            | {(m, k, n) for b in SERVE_BUCKETS
                               for m, k, n, _ in i8i8_gemms("resnet18", b)})
    for i, (m, k, n, lda) in enumerate([(m, k, n, k) for m, k, n in i8_bf16_shapes]
                                       + list(TC_EDGES) + I8_WGMMA_EDGES):
        a, w = rand_int8((m, lda))[:, :k], rand_int8((n, k)).t()
        scale, bias, act = rand((n,), 1e-4, 1e-2), rand((n,)).to(bf16), acts[i % 3]
        check_i8_loops("fused_gemm_i8i8_bf16", a, w, scale, bias, act, bf16,
                       f"M={m} K={k} N={n} lda={lda} act={act} bf16 out")
    for i, (n, h, w, ci, co, kh, kw, pads) in enumerate(
            [(b, hw, hw, c, c, 3, 3, ((1, 1), (1, 1)))
             for b in sorted({*bf16_batches("resnet18"), *SERVE_BUCKETS})
             for hw, c, _ in RESNET18_DIRECT]
            + DIRECT_I8_EDGES + WGMMA_DIRECT_EDGES):
        x, wt = rand_int8((n, h, w, ci)), rand_int8((co, ci, kh, kw))
        scale, bias, act = rand((co,), 1e-4, 1e-2), rand((co,)).to(bf16), acts[i % 3]
        check_direct_loops("conv2d_direct_bf16", x, wt, scale, bias, act, pads, bf16,
                           f"x=({n},{h},{w},{ci}) w=({co},{ci},{kh},{kw}) pads={pads} "
                           f"act={act} bf16 out")
    for m, n in [*((b, 1000) for b in sorted({BATCH, HEADLINE_BATCH, *SERVE_BUCKETS})),
                 (7, 129), (5, 4097), (1, 10), (BATCH, 10), (1, 100), (BATCH, 100), (1, 8)]:
        x = (rand((m, n)) * 30).to(bf16)
        check_bf16("softmax_rows_bf16", softmax_rows(x), softmax_rows_plain(x), f"M={m} N={n}")
    # the bf16 variants at the shapes SSD, EfficientNet-B0, googlenet_shapes,
    # ShuffleNet-v2 and resnet18_pot give them in bfloat16 (their compiled
    # networks' launches, B = 1 and 64): #1b, #1bw within one bfloat16 step,
    # #1ii and #3 with a bfloat16 output exact
    for i, (m, k, n) in enumerate(path_shapes("fused_gemm", {})):
        a, w, bias = rand((m, k)).to(bf16), rand((k, n)).to(bf16), rand((n,)).to(bf16)
        got = fused_gemm(a, w, None, bias, acts[i % 3])
        check_bf16("fused_gemm_bf16", got, fused_gemm_plain(a, w, None, bias, acts[i % 3]),
                   f"M={m} K={k} N={n} (a network's shape)", gemm_floor(torch, a, w))
        if not torch.equal(got, fused_gemm(a, w, None, bias, acts[i % 3])):
            raise AssertionError(f"fused_gemm_bf16 gives other bits on a second call at "
                                 f"{(m, k, n)}")
    for i, (m, k, n) in enumerate(path_shapes("fused_gemm_i8w", {})):
        a, w, bias = rand((m, k)).to(bf16), rand_int8((k, n)), rand((n,)).to(bf16)
        scale = rand((n,), 0.001, 0.02).to(bf16)
        got = fused_gemm(a, w, scale, bias, acts[i % 3])
        check_bf16("fused_gemm_bf16_i8w", got, fused_gemm_plain(a, w, scale, bias, acts[i % 3]),
                   f"M={m} K={k} N={n} (a network's shape)", gemm_floor(torch, a, w, scale))
        if not torch.equal(got, fused_gemm(a, w, scale, bias, acts[i % 3])):
            raise AssertionError(f"fused_gemm_bf16_i8w gives other bits on a second call at "
                                 f"{(m, k, n)}")
    for i, (m, k, n) in enumerate(path_shapes("fused_gemm_i8i8", {})):
        a, w = rand_int8((m, k)), rand_int8((n, k)).t()
        scale, bias = rand((n,), 1e-4, 1e-2), rand((n,)).to(bf16)
        check_exact("fused_gemm_i8i8_bf16",
                    fused_gemm(a, w, scale, bias, acts[i % 3], out_dtype=bf16).float(),
                    fused_gemm_plain(a, w, scale, bias, acts[i % 3], out_dtype=bf16).float(),
                    f"M={m} K={k} N={n} bf16 out (a network's shape)")
    for i, (n, h, w, ci, co, kh, kw, pads) in enumerate(
            [(b, *conv[:7]) for b in (1, BATCH) for convs in net_direct.values()
             for conv in convs]):
        x, wt = rand_int8((n, h, w, ci)), rand_int8((co, ci, kh, kw))
        scale, bias = rand((co,), 1e-4, 1e-2), rand((co,)).to(bf16)
        check_exact("conv2d_direct_bf16",
                    conv2d_direct(x, wt, scale, bias, acts[i % 3], pads,
                                  wmat=conv_weight_matrix_nk(wt).t(), out_dtype=bf16).float(),
                    conv2d_direct_plain(x, wt, scale, bias, acts[i % 3], pads, bf16).float(),
                    f"x=({n},{h},{w},{ci}) w=({co},{ci},{kh},{kw}) pads={pads} bf16 out "
                    f"(a network's shape)")
    # kernel 3f-bf16: conv2d_direct on bfloat16 x at 3f's check shapes and
    # the wgmma loop's bf16 edges, with a bfloat16 and an int8 weight (its
    # scale multiplies the sum), as routed (the weight matrix made by the
    # wrapper) and forced onto each loop that takes the conv (mma.sync
    # always, wgmma where direct_takes; each with the matrix it reads
    # cached), within one bfloat16 step of the plain version or, where a sum
    # cancels, the float32 sums' bound (conv_floor), the same bits twice
    for i, (n, h, w, ci, co, kh, kw, pads) in enumerate(
            [(b, hw, hw, c, c, 3, 3, ((1, 1), (1, 1)))
             for b in (1, BATCH) for hw, c, _ in RESNET18_DIRECT] + DIRECT_F32_RAGGED
            + WGMMA_BF16_DIRECT_EDGES):
        x, bias, act = rand((n, h, w, ci)).to(bf16), rand((co,)), acts[i % 3]
        m, k = n * (h + sum(pads[0]) - kh + 1) * (w + sum(pads[1]) - kw + 1), kh * kw * ci
        route = direct_bf16_route(n, h, w, ci, co, kh, kw, pads, x.data_ptr(), 0, sms)
        takes = direct_takes(ci, co, kh, kw, pads, x.data_ptr(), 0, bf16, 2)
        for wt, scale in ((rand((co, ci, kh, kw)).to(bf16), None),
                          (rand_int8((co, ci, kh, kw)), rand((co,), 1e-3, 1e-2))):
            want = conv2d_direct_plain(x, wt, scale, bias, act, pads)
            floor = conv_floor(torch, x, wt, scale, pads)
            mma_splits = -(-k // split_k(m, k, co, PLANS["conv2d_direct_bf16"], sms))
            wgmma_splits = direct_bf16_plan(m, k, ci, co, sms).splits if takes else None
            for loop in (None, "mma") + (("wgmma",) if takes else ()):
                wmat = (None if loop is None else conv_weight_matrix(wt) if loop == "mma"
                        else conv_weight_matrix_nk(wt).t())
                on = loop or ("wgmma" if route is not None else "mma")
                what = (f"bfloat16 x=({n},{h},{w},{ci}) w=({co},{ci},{kh},{kw}) {wt.dtype} "
                        f"pads={pads} act={act} {'routed ' if loop is None else ''}loop={on} "
                        f"splits={wgmma_splits if on == 'wgmma' else mma_splits}")
                got = conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat, conv_loop=loop)
                check_bf16("conv2d_direct_float_bf16", got, want, what, floor)
                if not torch.equal(got, conv2d_direct(x, wt, scale, bias, act, pads, wmat=wmat,
                                                      conv_loop=loop)):
                    raise AssertionError(f"conv2d_direct_float_bf16 gives other bits on a "
                                         f"second call at {what}")
    # kernel 4-bf16: dw_pw_fused with a bfloat16 output at #4's check shapes,
    # both tile heights, exact
    for b, h, w, c, co in (
            [(b, h, w, c, co) for b in (1, BATCH)
             for h, w, c, co, *_ in ssd_pairs + microbench_dw_pw.PUBLISHED] + dw_pw_edges):
        args = microbench_dw_pw.make_inputs(b, h, w, c, co, seed=h + c + b + 1)
        for pw_act in (relu6, None):
            kw = dict(dw_act=relu6, pw_act=pw_act, s_mid=0.05, out_dtype=bf16)
            want = dw_pw_fused_plain(*args, **kw).float()
            for rows in DW_PW_TILE_ROWS:
                got = dw_pw_fused(*args, tile_rows=rows, **kw)
                if got.dtype != bf16:
                    raise AssertionError(f"dw_pw_fused bf16 out wrote {got.dtype}")
                check_exact("dw_pw_fused_bf16", got.float(), want,
                            f"B={b} {h}x{w}x{c}->{co} out=bfloat16 pw_act={pw_act} "
                            f"tile_rows={rows}")
    check_launches = counters()
    log(f"phase 3 launches: {check_launches}")
    phase_done("3 kernel checks")

    # -- 4. the main paths ---------------------------------------------------
    # images normalized to [0, 1)
    requests = [rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
                for _ in range(REQUESTS)]
    batch = rng.uniform(0, 1, (BATCH, 3, 224, 224)).astype(np.float32)
    calibration = [{"data": rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)}
                   for _ in range(CALIBRATION)]
    networks = {}
    for model, paths in (("resnet18", resnet18_paths),
                         ("mobilenet_v2", mobilenet_v2_paths)):
        t0 = time.perf_counter()
        networks[model] = ie.read_network(*paths(seed=0))
        log(f"{model}: weights synthesized and read in {time.perf_counter() - t0:.2f} s")

    def top1(probs):
        return np.concatenate([p.argmax(axis=1) for p in probs])

    def loaded(net, quant, kernel_type, **config):
        exe = ie.load_network(net, "GPU", config=Config(quant=quant, **config))
        exe.kernel_type = kernel_type
        if quant == QuantMode.INT8_FULL:
            exe.set_calibration(calibration)
        return exe

    launches = dict.fromkeys(COUNTERS, 0)
    # {(model, quant): the TORCH float32 reference (int8_dataflow=False)}
    paths_run, fp32_answers, f32_refs = {}, {}, {}
    for model, quant in [(model, quant) for model in (*networks, *more_nets)
                         for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT,
                                       QuantMode.INT8_FULL)]:
        label = f"{model} {quant.value}"
        int8full = quant == QuantMode.INT8_FULL
        if model in networks:  # ResNet-18 and MobileNet-v2: inputs in [0, 1)
            net = networks[model]
            exe = loaded(net, quant, "pallas")
            make = functools.partial(loaded, net)
            reqs, rows = requests, batch
        else:
            net = more_nets[model][0]
            exe = more_exes[model, quant]
            make = functools.partial(more_loaded, model)
            reqs, rows = images["requests"], images["batch"]
        out = net.model.results[0].name
        classes = net.outputs[0]["shape"][-1]
        t0 = time.perf_counter()
        compiled = exe.compiled()  # weights onto the card; launches nothing
        if int8full and model in networks:
            log(f"{label}: calibrated on {CALIBRATION} images and compiled in "
                f"{time.perf_counter() - t0:.2f} s")
        # INT8-FULL: TORCH without int8 storage quantizes where KERNELS does
        ref = f32_refs[model, quant] = make(quant, "torch", int8_dataflow=False)
        matmul = next(n for n in net.model if n.op_type == "MatMul")
        logits_name = net.model.nodes[compiled._fusions[matmul.id].out_key[0]].name

        reset_counters()
        answers = [exe.infer({"data": r})[out] for r in reqs]
        batch_answer = exe.infer_batch({"data": rows})[out]
        got_launches = counters()
        log(f"{label} main path: {REQUESTS} requests + infer_batch({BATCH}); "
            f"launches {got_launches}")
        each = (per_forward(model, quant.value) if model in networks
                else compiled_per_forward(compiled, quant.value, 1))
        expected = {name: c * (REQUESTS + 1) for name, c in each.items()}
        if got_launches != expected:
            raise AssertionError(
                f"{label}: kernel launches {got_launches}, expected {expected} "
                f"({each} per forward)")
        for name in launches:
            launches[name] += got_launches[name]
        if model == "resnet18_pot" and int8full:
            # sample-free: every scale from the IR, the graph ResNet-18's
            if exe._calibration is not None or compiled.model.find_by_type("FakeQuantize"):
                raise AssertionError(f"{label}: calibrated, or FakeQuantize left in the graph")
            if each != per_forward("resnet18", "int8"):
                raise AssertionError(f"{label}: launches {each} per forward, ResNet-18 "
                                     f"INT8-FULL's are {per_forward('resnet18', 'int8')}")
            log(f"{label}: no calibration samples, {len(compiled.act_scales)} activation "
                f"scales from the IR, no FakeQuantize left; launches per forward those of "
                f"resnet18 int8")

        # a path that emulates FakeQuantize (resnet18_pot FP32 and INT8W) is
        # held against TORCH with KERNELS' FakeQuantize outputs forced in
        fq_path = bool(compiled.model.find_by_type("FakeQuantize"))
        flips = collections.Counter()

        def reference(x, capture=()):
            if not fq_path:
                if capture:
                    return ref.compiled().infer_with_capture({"data": x}, capture)
                return (ref.infer if x.shape[0] == 1 else ref.infer_batch)({"data": x}), {}
            res, captured, stats = forced_reference(compiled, ref.compiled(), x, capture)
            flips.update(flips=stats["flips"], elements=stats["elements"])
            flips["worst_midpoint_dist"] = max(flips["worst_midpoint_dist"],
                                               stats["worst_midpoint_dist"])
            return res, captured

        for i, r in enumerate(reqs):
            want = reference(r)[0][out]
            got = answers[i]
            if got.shape != (1, classes) or not np.isfinite(got).all():
                raise AssertionError(f"{label} request {i}: bad output {got.shape}")
            np.testing.assert_allclose(got, want, rtol=E2E_RTOL, atol=E2E_ATOL)
            if got.argmax() != want.argmax():
                raise AssertionError(
                    f"{label} request {i}: top-1 {got.argmax()} != {want.argmax()}")
        want_batch = reference(rows)[0][out]
        if batch_answer.shape != (BATCH, classes) or not np.isfinite(batch_answer).all():
            raise AssertionError(f"{label} infer_batch: bad output {batch_answer.shape}")
        np.testing.assert_allclose(batch_answer, want_batch, rtol=E2E_RTOL, atol=E2E_ATOL)
        if (batch_answer.argmax(1) != want_batch.argmax(1)).any():
            raise AssertionError(f"{label} infer_batch: top-1 differs from the TORCH backend")
        sums = batch_answer.sum(axis=1)
        if np.abs(sums - 1).max() > 1e-4:
            raise AssertionError(
                f"{label}: probabilities do not sum to 1: {sums.min()}..{sums.max()}")
        # the rows of one batch agree with the same images sent one at a time
        single = exe.infer({"data": rows[:1]})[out]
        np.testing.assert_allclose(single[0], batch_answer[0], rtol=E2E_RTOL, atol=E2E_ATOL)
        _, got_logits = compiled.infer_with_capture({"data": reqs[0]}, [logits_name])
        _, want_logits = reference(reqs[0], [logits_name])
        gl, wl = got_logits[logits_name], want_logits[logits_name]
        logit_err = np.abs(gl - wl).max() / np.abs(wl).max()
        prob_err = float(np.abs(batch_answer - want_batch).max())
        log(f"{label} KERNELS vs TORCH{' (FakeQuantize outputs forced)' if fq_path else ''}: "
            f"logits ({logits_name}) max_rel_err "
            f"{logit_err:.3e} (|logit| max {np.abs(wl).max():.3f}); probabilities "
            f"max_abs_err {prob_err:.3e}; top-1 identical on {REQUESTS + BATCH} "
            f"images (top-1 of request 0: {int(answers[0].argmax())})")
        if logit_err > LOGIT_RTOL[quant.value]:
            raise AssertionError(f"{label}: logits disagree: {logit_err}")
        if fq_path:
            _, free = ref.compiled().infer_with_capture({"data": reqs[0]}, [logits_name])
            with no_fake_quantize():
                _, bare = ref.compiled().infer_with_capture({"data": reqs[0]}, [logits_name])
            log(f"{label} FakeQuantize: {flips['flips']} of {flips['elements']} codes rounded "
                f"the other way by TORCH, each one step, its input at most "
                f"{flips['worst_midpoint_dist']:.3e} of max |x| from the midpoint (limits "
                f"{FLIP_DIST}, {FLIP_RATE} of the codes); unforced TORCH logits max_rel_err "
                f"{np.abs(gl - free[logits_name]).max() / np.abs(free[logits_name]).max():.3e}, "
                f"TORCH without FakeQuantize "
                f"{np.abs(gl - bare[logits_name]).max() / np.abs(bare[logits_name]).max():.3e}")
        mine = top1(answers + [batch_answer])
        if quant == QuantMode.NONE:
            fp32_answers[model] = mine
        else:
            log(f"{label}: top-1 equal to FP32 KERNELS"
                f"{' (its FakeQuantize emulation)' if model == 'resnet18_pot' else ''} on "
                f"{int((mine == fp32_answers[model]).sum())} of {len(mine)} images")
        if model == "resnet18_pot":
            if "resnet18_plain" not in fp32_answers:  # the unquantized IR, same images
                plain = loaded(networks["resnet18"], QuantMode.NONE, "pallas")
                plain_out = networks["resnet18"].model.results[0].name
                fp32_answers["resnet18_plain"] = top1(
                    [plain.infer({"data": r})[plain_out] for r in reqs]
                    + [plain.infer_batch({"data": rows})[plain_out]])
            log(f"{label}: top-1 equal to the unquantized resnet18 FP32 KERNELS on "
                f"{int((mine == fp32_answers['resnet18_plain']).sum())} of {len(mine)} images "
                f"(the same images, in [0, 255))")
        if int8full:
            # the default TORCH backend stores int8 between ops (the JAX
            # package's XLA dataflow): other quantization points, so only
            # its agreement is printed
            torch_default = make(quant, "torch")
            stored = torch_default.infer_batch({"data": rows})[out]
            _, stored_logits = torch_default.compiled().infer_with_capture(
                {"data": reqs[0]}, [logits_name])
            stored_err = (np.abs(gl - stored_logits[logits_name]).max()
                          / np.abs(stored_logits[logits_name]).max())
            log(f"{label} KERNELS vs default TORCH ({len(torch_default.compiled()._int8_edges)} "
                f"int8-stored edges): logits max_rel_err {stored_err:.3e}; probabilities "
                f"max_abs_err {np.abs(batch_answer - stored).max():.3e}; top-1 equal on "
                f"{int((batch_answer.argmax(1) == stored.argmax(1)).sum())} of {BATCH}")
            paths_run[label] = (exe, torch_default, "data", reqs, rows)
        else:
            paths_run[label] = (exe, ref, "data", reqs, rows)

    # SSD-MobileNet-v1 (ssd_shapes_ms, trained weights) on seeded images of
    # shapes with their boxes, in tools/accuracy.py's settings
    def detections(tables):
        """{image index: detections} over the requests, then the batch."""
        rows = [t[0] for t in tables[:-1]] + list(tables[-1])
        return {i: parse_detection_records(r) for i, r in enumerate(rows)}

    def records_gate(label, got, want, exact):
        """KERNELS' record table against TORCH's: equal (INT8-FULL), or the
        same records and classes in the same order, values within
        RECORD_ATOL.  Returns the largest difference."""
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: bad records {got.shape} vs {want.shape}")
        err = float(np.abs(got - want).max())
        if exact and err != 0:
            raise AssertionError(f"{label}: records differ from TORCH's by {err}")
        for g, w in zip(got.reshape(-1, got.shape[-2], 7), want.reshape(-1, want.shape[-2], 7)):
            dg, dw = parse_detection_records(g), parse_detection_records(w)
            if [d[0] for d in dg] != [d[0] for d in dw] or err > RECORD_ATOL:
                raise AssertionError(
                    f"{label}: records differ from TORCH's ({len(dg)} vs {len(dw)} records, "
                    f"max abs diff {err})")
        return err

    ssd_fp32 = None
    for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        label = f"ssd_shapes_ms {quant.value}"
        int8full = quant == QuantMode.INT8_FULL
        exe = ssd_exes[quant]
        compiled = exe.compiled()
        ref = f32_refs["ssd_shapes_ms", quant] = ssd_loaded(quant, "torch", int8_dataflow=False)
        expected_each = compiled_per_forward(compiled, quant.value, 0)

        reset_counters()
        answers = [exe.infer({SSD_INPUT: r})[SSD_OUTPUT] for r in ssd_requests]
        batch_answer = exe.infer_batch({SSD_INPUT: ssd_batch_x})[SSD_OUTPUT]
        got_launches = counters()
        log(f"{label} main path: {REQUESTS} requests + infer_batch({BATCH}); "
            f"launches {got_launches}")
        expected = {name: c * (REQUESTS + 1) for name, c in expected_each.items()}
        if got_launches != expected:
            raise AssertionError(f"{label}: kernel launches {got_launches}, expected "
                                 f"{expected} ({expected_each} per forward)")
        for name in launches:
            launches[name] += got_launches[name]

        err = 0.0
        for i, r in enumerate(ssd_requests):
            if answers[i].shape != (1, 1, 100, 7):
                raise AssertionError(f"{label} request {i}: shape {answers[i].shape}")
            err = max(err, records_gate(f"{label} request {i}", answers[i],
                                        ref.infer({SSD_INPUT: r})[SSD_OUTPUT], int8full))
        if batch_answer.shape != (BATCH, 1, 100, 7):
            raise AssertionError(f"{label} infer_batch: shape {batch_answer.shape}")
        err = max(err, records_gate(f"{label} infer_batch", batch_answer,
                                    ref.infer_batch({SSD_INPUT: ssd_batch_x})[SSD_OUTPUT],
                                    int8full))
        # a batch row against the same image sent alone (other conv shapes,
        # so float sums may differ in order)
        records_gate(f"{label} batch row 0 vs alone", batch_answer[:1],
                     exe.infer({SSD_INPUT: ssd_batch_x[:1]})[SSD_OUTPUT], False)
        dets = detections(answers + [batch_answer])
        n_records = sum(len(d) for d in dets.values())
        if n_records == 0:
            raise AssertionError(f"{label}: no detections on {len(dets)} images")
        mAP = mean_average_precision(ssd_gt, dets)
        log(f"{label} KERNELS vs TORCH{' (int8_dataflow=False)' if int8full else ''}: "
            f"records max abs diff {err:.3e} (limit {0.0 if int8full else RECORD_ATOL}); "
            f"{n_records} records on {len(dets)} images; mAP@0.5 against the drawn "
            f"boxes {mAP:.2f}")
        if ssd_fp32 is None:
            ssd_fp32 = dets
        else:
            same = sum(1 for i in dets
                       if [d[0] for d in dets[i]] == [d[0] for d in ssd_fp32[i]])
            log(f"{label}: the same classes in the same order as FP32 KERNELS on "
                f"{same} of {len(dets)} images")
        if int8full:
            torch_default = ssd_loaded(quant, "torch")
            stored = torch_default.infer_batch({SSD_INPUT: ssd_batch_x})[SSD_OUTPUT]
            same = sum(1 for g, w in zip(batch_answer, stored)
                       if [d[0] for d in parse_detection_records(g)]
                       == [d[0] for d in parse_detection_records(w)])
            log(f"{label} KERNELS vs default TORCH "
                f"({len(torch_default.compiled()._int8_edges)} int8-stored edges): records "
                f"max abs diff {np.abs(batch_answer - stored).max():.3e}; the same classes "
                f"on {same} of {BATCH} images")
            ref = torch_default
        paths_run[label] = (exe, ref, SSD_INPUT, ssd_requests, ssd_batch_x)

    def logits_of(target, x, logits_name, in_name="data"):
        return target.compiled().infer_with_capture({in_name: x}, [logits_name])[1][logits_name]

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def mean_rel(a, b):
        return float(np.abs(a - b).mean() / np.abs(b).mean())

    def bf16_path(label, model, quant, exe, ref, ref_f32, reqs, rows, fp32_top1,
                  ref_rows=True, each=None):
        """One bfloat16 main path: every counter set to 0, the requests and
        one infer_batch, the counters read against ``each`` per forward
        (default per_forward_bf16); outputs finite, rows summing to 1; the
        logits of request 0 against TORCH in bfloat16 (INT8-FULL:
        int8_dataflow=False, exactly equal; FP32 and INT8W: no farther than
        TORCH's own bfloat16 logits lie from TORCH's float32 ones, the
        size of a bfloat16 run's rounding, ``ref_f32``; a path that emulates
        FakeQuantize against TORCH with KERNELS' FakeQuantize outputs forced
        in, ``forced_reference``); top-1 against TORCH bf16 (on the requests
        alone when not ``ref_rows``: TORCH's int8 convs run in float64) and
        against FP32 KERNELS printed."""
        out = net_out[model]
        reset_counters()
        answers = [exe.infer({"data": r})[out] for r in reqs]
        batch_answer = exe.infer_batch({"data": rows})[out]
        got_launches = counters()
        log(f"{label} main path: {len(reqs)} requests + infer_batch({len(rows)}); "
            f"launches {got_launches}")
        each = each or per_forward_bf16(model, quant.value)
        expected = {name: c * (len(reqs) + 1) for name, c in each.items()}
        if got_launches != expected:
            raise AssertionError(f"{label}: kernel launches {got_launches}, expected {expected}")
        for name in launches:
            launches[name] += got_launches[name]
        mine = np.concatenate([a.argmax(1) for a in answers] + [batch_answer.argmax(1)])
        for a in answers + [batch_answer]:
            if a.dtype != np.float32 or not np.isfinite(a).all():
                raise AssertionError(f"{label}: output {a.dtype} not finite float32")
            if np.abs(a.sum(axis=1) - 1).max() > 1e-2:
                raise AssertionError(f"{label}: bf16 probabilities do not sum to 1")
        compiled = exe.compiled()
        matmul = next(n for n in compiled.model if n.op_type == "MatMul")
        logits_name = compiled.model.nodes[compiled._fusions[matmul.id].out_key[0]].name
        gl, wl = logits_of(exe, reqs[0], logits_name), logits_of(ref, reqs[0], logits_name)
        own = rel(wl, logits_of(ref_f32, reqs[0], logits_name))
        forced = ""
        if compiled.model.find_by_type("FakeQuantize"):
            _, captured, stats = forced_reference(compiled, ref.compiled(), reqs[0],
                                                  [logits_name])
            wl = captured[logits_name]
            forced = (f" with KERNELS' FakeQuantize outputs forced in: {stats['flips']} of "
                      f"{stats['elements']} outputs differ, the two runs' inputs there at most "
                      f"{stats.get('worst_input_gap', 0.0):.3e} of max |x| apart (limits "
                      f"{FLIP_DIST_BF16}, {FLIP_RATE_BF16} of the outputs)")
        err = rel(gl, wl)
        ref_top1 = np.concatenate([ref.infer({"data": r})[out].argmax(1) for r in reqs]
                                  + ([ref.infer_batch({"data": rows})[out].argmax(1)]
                                     if ref_rows else []))
        log(f"{label} KERNELS vs TORCH (bf16{', int8_dataflow=False' if quant == QuantMode.INT8_FULL else ''}{forced}): "
            f"logits max_rel_err {err:.3e} (TORCH bf16 vs TORCH f32 {own:.3e}); top-1 equal on "
            f"{int((mine[:len(ref_top1)] == ref_top1).sum())} of {len(ref_top1)}; top-1 equal "
            f"to FP32 KERNELS on "
            f"{int((mine == fp32_top1).sum())} of {len(mine)} images")
        if err > (0.0 if quant == QuantMode.INT8_FULL else own):
            raise AssertionError(f"{label}: bf16 logits {err} from TORCH's (limit "
                                 f"{0.0 if quant == QuantMode.INT8_FULL else own})")
        if compiled.weights[next(k for k, v in compiled.weights.items()
                                 if v.is_floating_point())].dtype != torch.bfloat16:
            raise AssertionError(f"{label}: float weights not in bfloat16")

    # bfloat16 compute: ResNet-18 and MobileNet-v2 in the three modes, on the
    # FP32 paths' images
    net_out = {model: networks[model].model.results[0].name for model in networks}
    for model in networks:
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            label = f"{model} {quant.value} bf16"
            exe = loaded(networks[model], quant, "pallas", compute_dtype="bfloat16")
            ref = loaded(networks[model], quant, "torch", compute_dtype="bfloat16",
                         int8_dataflow=False)
            ref_f32 = loaded(networks[model], quant, "torch", int8_dataflow=False)
            bf16_path(label, model, quant, exe, ref, ref_f32, requests, batch,
                      fp32_answers[model])
            paths_run[label] = (exe, ref, "data", requests, batch)

    # bfloat16 compute on EfficientNet-B0, googlenet_shapes, ShuffleNet-v2 and
    # resnet18_pot in the three modes, on their FP32 paths' images, each held
    # against TORCH in bfloat16 and against the FP32 path's TORCH reference
    # (float32) for the size of bfloat16's own rounding
    for model in more_nets:
        net_out[model] = more_nets[model][0].model.results[0].name
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            label = f"{model} {quant.value} bf16"
            exe = more_loaded(model, quant, "pallas", compute_dtype="bfloat16")
            ref = more_loaded(model, quant, "torch", compute_dtype="bfloat16",
                              int8_dataflow=False)
            bf16_path(label, model, quant, exe, ref, f32_refs[model, quant],
                      images["requests"], images["batch"], fp32_answers[model],
                      each=in_bf16(compiled_per_forward(exe.compiled(), quant.value, 1)))
            paths_run[label] = (exe, ref, "data", images["requests"], images["batch"])

    # SSD in bfloat16, the detector's form: the record tables of KERNELS
    # against TORCH in bfloat16 (INT8-FULL: int8_dataflow=False, equal;
    # FP32, INT8W: no farther apart than TORCH's own bfloat16 tables lie
    # from its float32 ones, in both the records' values and the images
    # whose classes agree, record_match), every launch counted, mAP printed
    for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
        label = f"ssd_shapes_ms {quant.value} bf16"
        int8full = quant == QuantMode.INT8_FULL
        exe = ssd_loaded(quant, "pallas", compute_dtype="bfloat16")
        ref = ssd_loaded(quant, "torch", compute_dtype="bfloat16", int8_dataflow=False)
        each = in_bf16(compiled_per_forward(exe.compiled(), quant.value, 0))
        reset_counters()
        answers = [exe.infer({SSD_INPUT: r})[SSD_OUTPUT] for r in ssd_requests]
        batch_answer = exe.infer_batch({SSD_INPUT: ssd_batch_x})[SSD_OUTPUT]
        got_launches = counters()
        log(f"{label} main path: {REQUESTS} requests + infer_batch({BATCH}); "
            f"launches {got_launches}")
        expected = {name: c * (REQUESTS + 1) for name, c in each.items()}
        if got_launches != expected:
            raise AssertionError(f"{label}: kernel launches {got_launches}, expected {expected}")
        for name in launches:
            launches[name] += got_launches[name]
        # every image's table, the requests then the batch, from KERNELS and
        # TORCH in bfloat16 and TORCH in float32
        tables = {}
        for name, target in (("kernels", None), ("torch", ref),
                             ("torch_f32", f32_refs["ssd_shapes_ms", quant])):
            tables[name] = (np.concatenate(answers + [batch_answer]) if target is None else
                            np.concatenate([target.infer({SSD_INPUT: r})[SSD_OUTPUT]
                                            for r in ssd_requests]
                                           + [target.infer_batch(
                                               {SSD_INPUT: ssd_batch_x})[SSD_OUTPUT]]))
        for name, t in tables.items():
            if t.shape != (REQUESTS + BATCH, 1, 100, 7) or t.dtype != np.float32 \
                    or not np.isfinite(t).all():
                raise AssertionError(f"{label} {name}: records {t.dtype} {t.shape}")

        got, want = tables["kernels"], tables["torch"]
        agree, err = record_match(got, want)
        own_agree, own = record_match(want, tables["torch_f32"])
        if int8full:
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: records differ from TORCH's (int8_dataflow="
                                     f"False) by {float(np.abs(got - want).max())}")
        elif err > own or agree < own_agree:
            raise AssertionError(
                f"{label}: records {err} apart, classes equal on {agree} images; TORCH bf16 "
                f"vs f32: {own} apart, {own_agree} images")
        dets = detections(answers + [batch_answer])
        n_records = sum(len(d) for d in dets.values())
        if n_records == 0:
            raise AssertionError(f"{label}: no detections on {len(dets)} images")
        same = sum(1 for i in dets if [d[0] for d in dets[i]] == [d[0] for d in ssd_fp32[i]])
        log(f"{label} KERNELS vs TORCH (bf16{', int8_dataflow=False' if int8full else ''}): "
            f"records {err:.3e} apart, the same classes on {agree} of {len(got)} images "
            f"(TORCH bf16 vs TORCH f32: {own:.3e}, {own_agree} images; record_match); "
            f"{n_records} records on {len(dets)} images; "
            f"mAP@0.5 against the drawn boxes {mean_average_precision(ssd_gt, dets):.2f}; the "
            f"same classes in the same order as FP32 KERNELS on {same} of {len(dets)} images")
        paths_run[label] = (exe, ref, SSD_INPUT, ssd_requests, ssd_batch_x)

    # the headline, bench.py's configuration: ResNet-18 behind
    # PrePostProcessor set_element_type("u8"), INT8-FULL, bfloat16 compute,
    # five batch-1 requests then infer_batch at HEADLINE_BATCH (compiled at
    # that batch, as bench.py's bake_batch), calibrated on CALIBRATION u8
    # images; raw u8 pixels in [0, 256)
    ppp = PrePostProcessor(ie.read_network(*resnet18_paths(seed=0)))
    ppp.input().tensor().set_element_type("u8")
    headline_net = ppp.build()
    u8_rng = np.random.default_rng(31)
    u8_requests = [u8_rng.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)
                   for _ in range(REQUESTS)]
    u8_batch = u8_rng.integers(0, 256, (HEADLINE_BATCH, 3, 224, 224), dtype=np.uint8)
    u8_calibration = [{"data": u8_rng.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)}
                      for _ in range(CALIBRATION)]

    def headline_loaded(kernel_type, **config):
        exe = ie.load_network(headline_net, "GPU", config=Config(
            quant=QuantMode.INT8_FULL, **{"compute_dtype": "bfloat16", **config}))
        exe.kernel_type = kernel_type
        exe.set_calibration(u8_calibration)
        return exe

    headline = headline_loaded("pallas")
    compiled = headline.compiled()
    param = compiled.model.parameters[0]
    ingress = compiled._input_tensor(u8_requests[0], param.outputs[param.out_port].shape,
                                     param.outputs[param.out_port].dtype)
    if ingress.dtype != torch.uint8 or ingress.device.type != "cuda":
        raise AssertionError(f"headline ingress is {ingress.dtype} on {ingress.device}")
    plain_fp32 = loaded(networks["resnet18"], QuantMode.NONE, "pallas")
    fp32_top1 = np.concatenate(
        [plain_fp32.infer({"data": r.astype(np.float32)})[net_out["resnet18"]].argmax(1)
         for r in u8_requests]
        + [plain_fp32.infer_batch({"data": u8_batch.astype(np.float32)})[
            net_out["resnet18"]].argmax(1)])
    headline_ref = headline_loaded("torch", int8_dataflow=False)
    bf16_path(f"resnet18 int8 bf16 u8 headline B={HEADLINE_BATCH}", "resnet18",
              QuantMode.INT8_FULL, headline, headline_ref,
              headline_loaded("torch", int8_dataflow=False, compute_dtype="float32"),
              u8_requests, u8_batch, fp32_top1, ref_rows=False)
    log(f"resnet18 headline: input on the device as {ingress.dtype} "
        f"({ingress.element_size()} byte a pixel), the graph's first ops "
        f"{[n.op_type for n in compiled.model if n.op_type not in ('Const', 'Parameter')][:2]}")
    phase_done("4 main paths")

    # -- 4d. U-Net, ViT-tiny, MoE-MLP, lstm-tiny and yolo-tiny ----------------
    # each in FP32, INT8 weight-only and INT8-FULL, in float32 and then in
    # bfloat16: five batch-1 requests and one infer_batch at BATCH through
    # IECore.read_network → load_network("GPU") → kernel_type "pallas",
    # every launch counter set to 0 just before the path and read just after
    # it against the launches of the compiled graph; the output (U-Net's
    # (B, 8, 128, 128) probability map, the classifiers' (B, 100) and
    # lstm-tiny's (B, 30)) finite and summing to 1 over axis 1, yolo-tiny's
    # (B, 1125) region blob finite with ``region_blob_ok``'s invariants,
    # and each held against the TORCH backend on the same card (INT8-FULL
    # with int8_dataflow=False): in float32 the logits (the input of the
    # last SoftMax, or of yolo-tiny's RegionYolo: its head's output) of
    # every request within LOGIT_RTOL of max |TORCH| (INT8-FULL exactly
    # equal) and every output within
    # E2E_RTOL / E2E_ATOL (softmax_rows against torch.softmax); in bfloat16
    # INT8-FULL logits exactly equal, FP32 and INT8W logits no farther from
    # TORCH bf16's than TORCH's own bf16 logits lie from its float32 ones
    # (below: in the mean, and at most one bf16 step beyond in the max); the
    # per-pixel argmax (U-Net), per-frame argmax (ocr-ti) or top-1
    # (ViT-tiny, MoE-MLP, lstm-tiny) agreement with FP32 KERNELS printed,
    # and yolo-tiny's detections (metrics.decode_region_yolo) against FP32
    # KERNELS': their count, the top detection's class, the largest
    # difference of its box.  ocr-ti's (B, 27, 24) per-frame posteriors sum
    # to 1 over the classes like the rest.  yolo-v2 answers a (48, 7)
    # record table an input, held like SSD's: ``yolo_v2_tables``
    def table_ok(label, table):
        """yolo-v2's record tables (n, RECORDS, 7): float32, finite, the
        valid rows first and every pad row exactly [-1, -1, -1, 0, 0, 0, 0]
        (the -1 of NonMaxSuppression's pad rows, the corners masked to 0).
        Returns the number of records."""
        if (table.shape[1:] != (YOLO_V2_RECORDS, 7) or table.dtype != np.float32
                or not np.isfinite(table).all()):
            raise AssertionError(f"{label}: bad records {table.dtype} {table.shape}")
        live = table[..., 0] >= 0
        pad = table[~live]
        if (np.diff(live.astype(np.int8), axis=-1) > 0).any() or not (
                (pad[:, :3] == -1).all() and (pad[:, 3:] == 0).all()):
            raise AssertionError(f"{label}: pad rows are not [-1, -1, -1, 0, 0, 0, 0] after "
                                 f"the records")
        return int(live.sum())

    def yolo_v2_tables(label, dtype, quant, exe, ref, in_name, reqs, rows, out, answers,
                       batch_answer, fp32_tables):
        """yolo-v2's gates: in float32 SSD's, KERNELS against TORCH request
        by request and the batch, the same records and classes in the same
        order, confidences and corners within RECORD_ATOL (INT8-FULL,
        int8_dataflow=False: equal); in bfloat16 INT8-FULL equal, FP32 and
        INT8W with the same classes on as many inputs as TORCH's own bf16
        tables have against its float32 ones and the records no farther
        apart in the mean (``record_dists``; the largest distance is
        printed: over ~1,600 records it is one record's, a box that bf16
        moved past the NMS threshold, 0.39 against TORCH's own 0.38 on an
        H100 80GB HBM3 at 700 W); ``table_ok`` on every table, and records
        on the seeded inputs.  Returns the tables (requests, then the
        batch)."""
        int8full = quant == QuantMode.INT8_FULL
        got = np.concatenate([a[None] for a in answers] + [batch_answer])
        want = np.concatenate([ref.infer({in_name: r})[out][None] for r in reqs]
                              + [ref.infer_batch({in_name: rows})[out]])
        n_records = table_ok(f"{label} KERNELS", got)
        table_ok(f"{label} TORCH", want)
        if n_records == 0:
            raise AssertionError(f"{label}: no records on {len(got)} inputs")
        if dtype == "float32":
            err = records_gate(label, got, want, int8full)
            gate = f"records max abs diff {err:.3e} (limit {0.0 if int8full else RECORD_ATOL})"
        else:
            f32 = np.concatenate([f32_refs["yolo_v2", quant].infer({in_name: r})[out][None]
                                  for r in reqs]
                                 + [f32_refs["yolo_v2", quant].infer_batch({in_name: rows})[out]])
            agree, dists = record_dists(got, want)
            own_agree, own = record_dists(want, f32)
            mean, own_mean = float(np.mean(dists)), float(np.mean(own))
            if int8full:
                if not np.array_equal(got, want):
                    raise AssertionError(f"{label}: records differ from TORCH's "
                                         f"(int8_dataflow=False) by "
                                         f"{float(np.abs(got - want).max())}")
            elif mean > own_mean or agree < own_agree:
                raise AssertionError(
                    f"{label}: records {mean} apart in the mean, classes equal on {agree} "
                    f"inputs; TORCH bf16 vs f32: {own_mean}, {own_agree} inputs")
            gate = (f"records {mean:.3e} apart in the mean, {max(dists):.3e} at most, the "
                    f"same classes on {agree} of {len(got)} inputs (TORCH bf16 vs TORCH "
                    f"f32: {own_mean:.3e}, {max(own):.3e}, {own_agree}; record_dists)")
        same = ("" if fp32_tables is None else
                f"; the same classes in the same order as FP32 KERNELS on "
                f"{sum(1 for g, f in zip(got, fp32_tables) if [d[0] for d in parse_detection_records(g)] == [d[0] for d in parse_detection_records(f)])}"
                f" of {len(got)} inputs")
        log(f"{label} KERNELS vs TORCH ({dtype}{', int8_dataflow=False' if int8full else ''}): "
            f"{gate}; {n_records} records on {len(got)} inputs{same}")
        return got

    family_launches = dict.fromkeys(COUNTERS, 0)
    light_e2e = set()  # paths phase 5c times with fewer repetitions
    model_launches = {model: collections.Counter() for model in family_nets}
    for model, net in family_nets.items():
        t_model = time.perf_counter()
        inputs = family_images[model]
        in_name, reqs, rows = inputs["input"], inputs["requests"], inputs["batch"]
        out = net.model.results[0].name
        head = net.model.nodes[net.model.in_edges[net.model.results[0].id][0][0]]
        logits_name = net.model.nodes[net.model.in_edges[head.id][0][0]].name
        forwards = REQUESTS + (BATCH if model in per_example else 1)
        fp32_top1 = fp32_dets = fp32_tables = None
        for dtype in ("float32", "bfloat16"):
            for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
                label = f"{model} {quant.value}{' bf16' if dtype == 'bfloat16' else ''}"
                int8full = quant == QuantMode.INT8_FULL
                exe = (family_exes[model, quant] if dtype == "float32" else
                       family_loaded(model, quant, "pallas", compute_dtype=dtype))
                compiled = exe.compiled()
                ref = family_loaded(model, quant, "torch", compute_dtype=dtype,
                                    int8_dataflow=False)
                each = compiled_per_forward(compiled, quant.value,
                                            len(softmax_rows_of(compiled)))
                if dtype == "bfloat16":
                    each = in_bf16(each)

                reset_counters()
                answers = [exe.infer({in_name: r})[out] for r in reqs]
                batch_answer = exe.infer_batch({in_name: rows})[out]
                got_launches = counters()
                log(f"{label} main path: {REQUESTS} requests + infer_batch({BATCH}) "
                    f"({forwards} forwards); launches {got_launches}")
                expected = {name: c * forwards for name, c in each.items()}
                if got_launches != expected:
                    raise AssertionError(f"{label}: kernel launches {got_launches}, expected "
                                         f"{expected} ({each} per forward)")
                for name in launches:
                    launches[name] += got_launches[name]
                    family_launches[name] += got_launches[name]
                model_launches[model].update(got_launches)

                if model == "yolo_v2":
                    tables = yolo_v2_tables(label, dtype, quant, exe, ref, in_name, reqs, rows,
                                            out, answers, batch_answer, fp32_tables)
                    if dtype == "float32":
                        f32_refs[model, quant] = ref
                        if fp32_tables is None:
                            fp32_tables = tables
                    if int8full:
                        torch_default = family_loaded(model, quant, "torch", compute_dtype=dtype)
                        stored = torch_default.infer_batch({in_name: rows})[out]
                        table_ok(f"{label} default TORCH", stored)
                        agree, err = record_match(tables[REQUESTS:], stored)
                        log(f"{label} KERNELS vs default TORCH "
                            f"({len(torch_default.compiled()._int8_edges)} int8-stored "
                            f"edges): records {err:.3e} apart, the same classes on {agree} of "
                            f"{BATCH} inputs")
                        ref = torch_default
                    paths_run[label] = (exe, ref, in_name, reqs, rows)
                    light_e2e.add(label)
                    continue

                shape = net.outputs[0]["shape"]
                wants = [ref.infer({in_name: r})[out] for r in reqs]
                want_batch = ref.infer_batch({in_name: rows})[out]
                for what, got, want, n in [(f"request {i}", a, w, 1)
                                           for i, (a, w) in enumerate(zip(answers, wants))] + [
                        ("infer_batch", batch_answer, want_batch, BATCH)]:
                    if (got.shape != (n, *shape[1:]) or got.dtype != np.float32
                            or not np.isfinite(got).all()):
                        raise AssertionError(f"{label} {what}: bad output {got.dtype} "
                                             f"{got.shape}")
                    tol, sums = (1e-4 if dtype == "float32" else 1e-2), got.sum(axis=1)
                    if head.op_type == "RegionYolo":
                        region_blob_ok(got, tol, f"{label} {what}")
                    elif np.abs(sums - 1).max() > tol:
                        raise AssertionError(f"{label} {what}: probabilities do not sum to 1: "
                                             f"{sums.min()}..{sums.max()}")
                    if dtype == "float32":
                        np.testing.assert_allclose(got, want, rtol=E2E_RTOL, atol=E2E_ATOL)
                # the logits of every request: float32 within LOGIT_RTOL
                # (INT8-FULL equal); bfloat16 INT8-FULL equal, FP32 and INT8W
                # no farther apart than TORCH bf16's from TORCH f32's in the
                # mean (mean_rel), and in the largest difference no farther
                # than that or one bfloat16 step of the largest logit: two
                # bf16 runs differ by whole bf16 steps, and ViT-tiny's own
                # bf16 error at its largest logit is under one step (on an
                # H100: 2.1e-3 against a step of 7.7e-3, PERF.md §6)
                err, own_err, limit = 0.0, None, 0.0
                for r in reqs:
                    gl = logits_of(exe, r, logits_name, in_name)
                    wl = logits_of(ref, r, logits_name, in_name)
                    top = float(np.abs(wl).max())
                    diff = float(np.abs(gl - wl).max())
                    if dtype == "float32":
                        lim = LOGIT_RTOL[quant.value] * top
                    else:
                        f32l = logits_of(f32_refs[model, quant], r, logits_name, in_name)
                        own_r = rel(wl, f32l)
                        own_err = own_r if own_err is None else min(own_err, own_r)
                        lim = 0.0 if int8full else max(float(np.abs(wl - f32l).max()),
                                                       2.0 ** (np.floor(np.log2(top)) - 7))
                        if mean_rel(gl, wl) > (0.0 if int8full else mean_rel(wl, f32l)):
                            raise AssertionError(
                                f"{label}: logits ({logits_name}) {mean_rel(gl, wl)} from "
                                f"TORCH's in the mean (TORCH bf16 vs f32 {mean_rel(wl, f32l)})")
                    if diff > lim:
                        raise AssertionError(f"{label}: logits ({logits_name}) {diff} from "
                                             f"TORCH's at most (limit {lim}, max |logit| {top})")
                    err, limit = max(err, diff / top), max(limit, lim / top)
                if dtype == "float32":
                    own = ""
                    f32_refs[model, quant] = ref
                else:
                    own = f" (TORCH bf16 vs TORCH f32 at least {own_err:.3e})"
                every = [*answers, *batch_answer[:, None]]  # the 69 answers, (1, ...) each
                if head.op_type == "RegionYolo":
                    dets = [decode_yolo(a) for a in every]
                    if fp32_dets is None:
                        fp32_dets = dets
                    agreement = detections_vs(dets, fp32_dets, "FP32 KERNELS")
                else:
                    top1 = np.concatenate([a.argmax(axis=1).reshape(-1) for a in every])
                    if fp32_top1 is None:
                        fp32_top1 = top1
                    kind = {4: "per-pixel argmax", 3: "per-frame argmax"}.get(len(shape), "top-1")
                    agreement = (f"{kind} equal "
                                 f"to FP32 KERNELS on {float((top1 == fp32_top1).mean()):.6f} "
                                 f"of {top1.size} ({REQUESTS + BATCH} inputs)")
                log(f"{label} KERNELS vs TORCH ({dtype}"
                    f"{', int8_dataflow=False' if int8full else ''}): logits ({logits_name}) "
                    f"of {REQUESTS} requests max_rel_err {err:.3e} (limit up to {limit:.3e})"
                    f"{own}; outputs max_abs_err "
                    f"{float(np.abs(batch_answer - want_batch).max()):.3e}; {agreement}")
                if int8full:
                    torch_default = family_loaded(model, quant, "torch", compute_dtype=dtype)
                    stored = torch_default.infer_batch({in_name: rows})[out]
                    same = (detections_vs([decode_yolo(a) for a in stored[:, None]],
                                          dets[REQUESTS:], "KERNELS")
                            if head.op_type == "RegionYolo" else
                            f"argmax equal on "
                            f"{float((batch_answer.argmax(1) == stored.argmax(1)).mean()):.6f}")
                    log(f"{label} KERNELS vs default TORCH "
                        f"({len(torch_default.compiled()._int8_edges)} int8-stored edges): "
                        f"outputs max_abs_err {float(np.abs(batch_answer - stored).max()):.3e}; "
                        f"{same}")
                    ref = torch_default
                paths_run[label] = (exe, ref, in_name, reqs, rows)
                if model in per_example:
                    light_e2e.add(label)
        log(f"4d {model}: {time.perf_counter() - t_model:.2f} s, launches "
            f"{dict(model_launches[model])}")
    log(f"phase 4d launches: {family_launches}")
    if not (sum(family_launches[k] for k in COUNTERS if k.startswith("fused_gemm"))
            and sum(family_launches[k] for k in COUNTERS if k.startswith("conv2d_direct"))):
        raise AssertionError("phase 4d's families launched no fused_gemm or no conv2d_direct")
    if not sum(n for k, n in model_launches["yolo_tiny"].items()
               if k.startswith("conv2d_direct")):
        raise AssertionError("yolo-tiny launched no conv2d_direct under INT8-FULL")
    if not sum(n for k, n in model_launches["lstm_tiny"].items() if k.startswith("softmax_rows")):
        raise AssertionError("lstm-tiny launched no softmax_rows")
    for model in ("ocr_ti", "yolo_v2"):
        if not sum(n for k, n in model_launches[model].items() if k.startswith("fused_gemm")):
            raise AssertionError(f"{model} launched no fused_gemm")
    if not sum(n for k, n in model_launches["yolo_v2"].items() if k.startswith("conv2d_direct")):
        raise AssertionError("yolo-v2 launched no conv2d_direct under INT8-FULL")
    phase_done("4d U-Net, ViT-tiny, MoE-MLP, lstm-tiny, yolo-tiny, ocr-ti and yolo-v2")

    # -- 4e. the op-type recipes through the public API ------------------------
    # each recipe's IR (phase 2d) through IECore.read_network →
    # load_network("GPU"): FP32, INT8W and INT8-FULL (calibrated on seeded
    # samples), in float32 and then in bfloat16, kernel_type "pallas";
    # RECIPE_REQUESTS batch-1 requests and infer_batch at 64 with every counter
    # set to 0 just before the path and read just after it against the
    # compiled graph's launches; every Result held against TORCH on the card
    # (INT8-FULL with int8_dataflow=False) by ``recipe_gate``, and TORCH's
    # FP32 float32 answers to the requests against the port's numpy
    # interpreter (the ref_computes): float outputs within 1e-4 of their
    # largest value, integer and bool outputs equal.  ``Recipe.loose`` names
    # the outputs a discontinuous op took from a kernel's (TopK's indices
    # behind the FC): their rows' agreement is printed
    def bf16_step(value):
        return 2.0 ** (np.floor(np.log2(max(value, 2.0 ** -126))) - 7)

    def recipe_gate(label, got, want, loose, exact=False, f32=None):
        """Every output of ``got`` (KERNELS) against ``want`` (TORCH):
        float32 within E2E_RTOL and E2E_ATOL of its largest value (the
        families' probabilities have a largest value near 1; a sum such as
        CumSum's crosses zero, where rtol alone holds its float32 error to
        the residue) and within RECIPE_RTOL of the largest value in the
        largest difference (``exact``: equal); in bfloat16 (``f32``: TORCH's float32
        answers F) no farther from TORCH's (T) than T lies from F in the
        mean; in the largest difference at most 2·max |T − F| and one
        bfloat16 step of the largest value: |K − T| <= |K − F| + |F − T|,
        and K's own bfloat16 error may reach T's, a step further where an
        output sums several rounded terms; INT8-FULL equal; integer and
        bool outputs equal; ``loose`` ones as the share of equal rows.
        Returns (worst float error, {loose output: agreement})."""
        worst, agreement = 0.0, {}
        for key, w in want.items():
            g = got[key]
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{label} {key}: {g.dtype}{g.shape} against TORCH's "
                                     f"{w.dtype}{w.shape}")
            if key in loose:
                rows = (g.reshape(g.shape[0], -1) == w.reshape(w.shape[0], -1)).all(axis=1)
                agreement[key] = float(rows.mean())
                continue
            if exact or not np.issubdtype(w.dtype, np.floating):
                if not np.array_equal(g, w):
                    raise AssertionError(f"{label} {key}: {int((g != w).sum())} of {w.size} "
                                         f"values differ from TORCH's")
                continue
            if not np.isfinite(g).all():
                raise AssertionError(f"{label} {key}: non-finite output")
            top = max(float(np.abs(w).max()), 1e-30)
            diff = np.abs(g - w)
            if f32 is None:
                np.testing.assert_allclose(g, w, rtol=E2E_RTOL, atol=E2E_ATOL * top,
                                           err_msg=f"{label} {key}")
                err = float(diff.max()) / top
                if err > RECIPE_RTOL:
                    raise AssertionError(f"{label} {key}: max_rel_err {err} > {RECIPE_RTOL}")
            else:
                own = np.abs(w - f32[key])
                limit = 2 * float(own.max()) + bf16_step(top)
                if diff.mean() > own.mean() or diff.max() > limit:
                    raise AssertionError(
                        f"{label} {key}: {diff.mean()} from TORCH's in the mean, "
                        f"{diff.max()} at most; TORCH bf16 vs f32 {own.mean()}, limit {limit}")
                err = float(diff.max()) / top
            worst = max(worst, err)
        return worst, agreement

    recipe_launches = dict.fromkeys(COUNTERS, 0)
    for name in op_graphs.RECIPES:
        if name in op_graphs.STATE_AND_DETECTION:
            continue  # phase 4f
        t_recipe = time.perf_counter()
        key = f"op_graphs {name}"
        inputs = recipe_inputs[name]
        loose = inputs["recipe"].loose
        reqs, rows = inputs["requests"], inputs["batch"]
        forwards = len(reqs) + (BATCH if key in per_example else 1)
        f32_answers = {}
        for dtype in ("float32", "bfloat16"):
            for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
                label = f"{key} {quant.value}{' bf16' if dtype == 'bfloat16' else ''}"
                int8full = quant == QuantMode.INT8_FULL
                exe = (recipe_exes[name, quant] if dtype == "float32" else
                       recipe_loaded(name, quant, "pallas", compute_dtype=dtype))
                compiled = exe.compiled()
                ref = recipe_loaded(name, quant, "torch", compute_dtype=dtype,
                                    int8_dataflow=False)
                each = compiled_per_forward(compiled, quant.value,
                                            len(softmax_rows_of(compiled)))
                if dtype == "bfloat16":
                    each = in_bf16(each)
                reset_counters()
                answers = [exe.infer(r) for r in reqs] + [exe.infer_batch(rows)]
                got_launches = counters()
                expected = {k: c * forwards for k, c in each.items()}
                if got_launches != expected:
                    raise AssertionError(f"{label}: kernel launches {got_launches}, expected "
                                         f"{expected} ({each} per forward)")
                if not sum(n for k, n in got_launches.items() if k.startswith("fused_gemm")):
                    raise AssertionError(f"{label}: no fused_gemm launch")
                for k in launches:
                    launches[k] += got_launches[k]
                    recipe_launches[k] += got_launches[k]
                wants = [ref.infer(r) for r in reqs] + [ref.infer_batch(rows)]
                if dtype == "float32":
                    f32_answers[quant] = wants
                worst, agreement = 0.0, collections.defaultdict(list)
                for i, (got, want) in enumerate(zip(answers, wants)):
                    err, agree = recipe_gate(
                        f"{label} {'infer_batch' if i == len(reqs) else f'request {i}'}",
                        got, want, loose, exact=int8full,
                        f32=None if dtype == "float32" else f32_answers[quant][i])
                    worst = max(worst, err)
                    for k, v in agree.items():
                        agreement[k].append(v)
                log(f"{label} KERNELS vs TORCH ({dtype}"
                    f"{', int8_dataflow=False' if int8full else ''}): {len(want)} outputs of "
                    f"{len(reqs)} requests and infer_batch({BATCH}) ({forwards} forwards), "
                    f"max_rel_err {worst:.3e}; launches {got_launches}"
                    + "".join(f"; {k} rows equal {min(v):.4f}" for k, v in agreement.items()))
                if dtype == "float32" and quant == QuantMode.NONE:
                    interp = recipe_loaded(name, quant, "numpy")
                    worst, agreement = 0.0, collections.defaultdict(list)
                    for i, (r, want) in enumerate(zip(reqs, wants)):
                        err, agree = recipe_gate(f"{label} request {i} (interpreter)",
                                                 interp.infer(r), want, loose)
                        worst = max(worst, err)
                        for k, v in agree.items():
                            agreement[k].append(v)
                    log(f"{label} the numpy interpreter vs TORCH (float32): {len(reqs)} "
                        f"requests, max_rel_err {worst:.3e}"
                        + "".join(f"; {k} rows equal {min(v):.4f}"
                                  for k, v in agreement.items()))
        log(f"4e {name}: {time.perf_counter() - t_recipe:.2f} s")
    log(f"phase 4e launches: {recipe_launches}")
    phase_done("4e op-type recipes")

    # -- 4f. variable state and the detector ops through the public API -----
    # the three recipes of op_graphs.STATE_AND_DETECTION (phase 2d's IRs)
    # through IECore.read_network → load_network("GPU"), FP32, INT8W and
    # INT8-FULL, float32 then bfloat16, kernel_type "pallas", every counter
    # zeroed just before the path and read just after it against the
    # compiled graph's launches, each answer held against TORCH on the card
    # (INT8-FULL with int8_dataflow=False: equal).  lstm_stream: 8 chunks in
    # order (query_state after the fourth against TORCH's), reset_state and
    # the first 2 again (the same answers), a VariableState set before the
    # third (the answer moves as TORCH's does), 64 streams reshaped into the
    # IR (IENetwork.reshape) for 4 chunks in lockstep against 2 of the
    # streams run alone, infer_batch refused, TORCH FP32's chunks against the
    # numpy interpreter's.  two_stage and single_shot: as phase 4e (2
    # requests and infer_batch at 64), their rois and records held as
    # yolo-v2's: float32 the same kept rois and classes within RECORD_ATOL
    # (two_stage's rows matched to TORCH's first, near-tied scores may trade
    # rows) and every other output by ``recipe_gate``, bfloat16 by
    # ``record_dists`` against TORCH's own bf16-vs-f32 distance
    from pyopenvino_tpu_torch import IENetwork
    from pyopenvino_tpu_torch.ops.proposal import _params as proposal_params
    from pyopenvino_tpu_torch.ops.proposal import proposal_torch

    ROI_OUTPUTS = ("rois", "roi_scores", "cls_score", "cls_prob", "bbox_pred")
    SOFTMAXED = ("probs", "cls_prob")  # softmax_rows' outputs on KERNELS

    def exact_gate(label, got, want, exact, f32=None):
        """recipe_gate, where under INT8-FULL (``exact``) the outputs of
        softmax_rows (SOFTMAXED) take the float gate against torch.softmax
        and the rest, their logits among them, must be equal."""
        parts = ([k for k in want if k not in SOFTMAXED], [k for k in want if k in SOFTMAXED])
        worst = 0.0
        for keys, eq in zip(parts, (exact, False)):
            if keys:
                pick = lambda d: None if d is None else {k: d[k] for k in keys}  # noqa: E731
                worst = max(worst, recipe_gate(label, pick(got), pick(want), (), exact=eq,
                                               f32=pick(f32))[0])
        return worst

    def roi_tables(out, post):
        """two_stage's answer as (n, post + 1, 7) record tables, n = 1 or the
        batch: each kept roi [image, the box head's class, its score, its
        corners / IMAGE] in the rois' order, then -1 rows (record_dists'
        form)."""
        rois = out["rois"].reshape(-1, post, 5)
        scores = out["roi_scores"].reshape(rois.shape[:2])
        cls = out["cls_prob"].reshape(rois.shape[0], post, -1).argmax(-1)
        tables = np.full((len(rois), post + 1, 7), -1.0, np.float32)
        for i in range(len(rois)):
            keep = scores[i] > 0
            tables[i, :int(keep.sum())] = np.column_stack(
                [rois[i, keep, 0], cls[i, keep], scores[i, keep],
                 rois[i, keep, 1:] / op_graphs.IMAGE])
        return tables

    def aligned_rois(label, got, want, post):
        """KERNELS' two_stage answer with its per-roi rows moved to TORCH's:
        each kept roi matched one to one to the TORCH roi nearest in every
        corner, within RECORD_ATOL of the image; the same kept count and
        padding.  Returns (the moved answer, rows that moved)."""
        g = got["rois"].reshape(-1, post, 5)
        w = want["rois"].reshape(-1, post, 5)
        gk = got["roi_scores"].reshape(g.shape[:2]) > 0
        wk = want["roi_scores"].reshape(w.shape[:2]) > 0
        perm = np.tile(np.arange(post), (len(g), 1))
        moved = 0
        for i in range(len(g)):
            k = int(wk[i].sum())
            if (gk[i] != wk[i]).any() or not wk[i, :k].all():
                raise AssertionError(f"{label}: {int(gk[i].sum())} kept rois against TORCH's {k}")
            d = np.abs(g[i, :k, None] - w[i, None, :k]).max(-1)
            j = d.argmin(1)
            if len(set(j.tolist())) != k or d[np.arange(k), j].max() > RECORD_ATOL * op_graphs.IMAGE:
                raise AssertionError(f"{label}: the kept rois differ from TORCH's (largest "
                                     f"distance to the nearest {d.min(1).max()})")
            perm[i, j] = np.arange(k)
            moved += int((j != np.arange(k)).sum())
        out = dict(got)
        for key in ROI_OUTPUTS:
            v = got[key].reshape(len(g), post, -1)
            out[key] = np.take_along_axis(v, perm[..., None], 1).reshape(got[key].shape)
        return out, moved

    def detector_gate(name, label, got, want, exact, f32=None, post=None):
        """two_stage's or single_shot's gates (the head of phase 4f).
        Returns (worst float error of recipe_gate, text)."""
        if exact:
            return exact_gate(label, got, want, True, f32), "equal (cls_prob by the float gate)"
        if name == "two_stage":
            tables = roi_tables(got, post), roi_tables(want, post)
            own = None if f32 is None else roi_tables(f32, post)
        else:
            tables = got["detections"], want["detections"]
            own = None if f32 is None else f32["detections"]
        agree, dists = record_dists(*tables)
        n_tables = len(tables[1].reshape(-1, tables[1].shape[-2], 7))
        records = sum(len(parse_detection_records(t))
                      for t in tables[1].reshape(-1, tables[1].shape[-2], 7))
        if not records:
            raise AssertionError(f"{label}: no records")
        if f32 is None:
            worst_rec = max(dists, default=0.0)
            if agree != n_tables or worst_rec > RECORD_ATOL or len(dists) != records:
                raise AssertionError(f"{label}: records differ from TORCH's (classes equal on "
                                     f"{agree} of {n_tables}, {len(dists)} of {records} matched, "
                                     f"largest distance {worst_rec})")
            moved = 0
            if name == "two_stage":
                got, moved = aligned_rois(label, got, want, post)
            else:  # the records above, the dense heads here
                got, want = ({k: v for k, v in d.items() if k != "detections"}
                             for d in (got, want))
            err = recipe_gate(label, got, want, ())[0]
            return err, (f"{records} records, the same classes on {n_tables} tables, within "
                         f"{worst_rec:.3e} (RECORD_ATOL {RECORD_ATOL}), {moved} rows traded")
        own_agree, own_d = record_dists(tables[1], own)
        mean, own_mean = float(np.mean(dists)), float(np.mean(own_d))
        if mean > own_mean or agree < own_agree:
            raise AssertionError(f"{label}: records {mean} apart in the mean, classes equal on "
                                 f"{agree} tables; TORCH bf16 vs f32: {own_mean}, {own_agree}")
        err = 0.0
        if name == "single_shot":  # the dense heads, as recipe_gate's bf16 gate
            dense = ("mbox_loc", "mbox_conf")
            err = recipe_gate(label, {k: got[k] for k in dense}, {k: want[k] for k in dense},
                              (), f32=f32)[0]
        return err, (f"{records} records, {mean:.3e} apart in the mean, {max(dists):.3e} at "
                     f"most, the same classes on {agree} of {n_tables} tables (TORCH bf16 vs "
                     f"f32: {own_mean:.3e}, {max(own_d, default=0.0):.3e}, {own_agree}; "
                     f"record_dists)")

    state_launches = dict.fromkeys(COUNTERS, 0)

    def count_path(label, got_launches, each, forwards):
        expected = {k: c * forwards for k, c in each.items()}
        if got_launches != expected:
            raise AssertionError(f"{label}: kernel launches {got_launches}, expected "
                                 f"{expected} ({each} per forward)")
        if not sum(n for k, n in got_launches.items() if k.startswith("fused_gemm")):
            raise AssertionError(f"{label}: no fused_gemm launch")
        for k in launches:
            launches[k] += got_launches[k]
            state_launches[k] += got_launches[k]

    # lstm_stream
    name = "lstm_stream"
    t_recipe = time.perf_counter()
    inputs = recipe_inputs[name]
    chunks, streams = inputs["chunks"], inputs["streams"]
    model = recipe_nets[name].model
    hidden = op_graphs.lstm_hidden(op_graphs.FULL_WIDTH)
    set_value = np.random.default_rng(44).uniform(-1, 1, (1, 1, hidden)).astype(np.float32)

    def stacked(answers):
        """A list of answers as one: each output concatenated on axis 0."""
        return {k: np.concatenate([a[k] for a in answers]) for k in answers[0]}

    def stream_sequence(e):
        """The stream's calls on one executable: (answers, state after the
        fourth chunk).  8 chunks, reset_state, the first 2 again, then
        lstm2_h set and the third chunk."""
        answers = [e.infer(c) for c in chunks[:4]]
        state4 = {v.name: v.state for v in e.query_state()}
        answers += [e.infer(c) for c in chunks[4:]]
        e.reset_state()
        answers += [e.infer(c) for c in chunks[:2]]
        (h2,) = [v for v in e.query_state() if v.name == "lstm2_h"]
        h2.state = set_value
        answers.append(e.infer(chunks[2]))
        return answers, state4

    f32_stream = {}
    for dtype in ("float32", "bfloat16"):
        for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
            label = f"op_graphs {name} {quant.value}{' bf16' if dtype == 'bfloat16' else ''}"
            int8full = quant == QuantMode.INT8_FULL
            exe = (recipe_exes[name, quant] if dtype == "float32" else
                   recipe_loaded(name, quant, "pallas", compute_dtype=dtype))
            compiled = exe.compiled()
            if sorted(compiled.variables) != sorted(op_graphs.LSTM_VARIABLES):
                raise AssertionError(f"{label}: variables {sorted(compiled.variables)}")
            ref = recipe_loaded(name, quant, "torch", compute_dtype=dtype, int8_dataflow=False)
            lock_net = IENetwork(model).reshape({"x": (BATCH, op_graphs.CHUNK,
                                                       op_graphs.LSTM_FEATURES)})
            lock = ie.load_network(lock_net, "GPU", config=Config(quant=quant,
                                                                   compute_dtype=dtype))
            lock.kernel_type = "pallas"
            if int8full:
                # the stream's calibration chunks in every row: the scales of
                # the stream alone (calibration_percentile 100: the largest)
                lock.set_calibration([{k: np.repeat(v, BATCH, axis=0) for k, v in c.items()}
                                      for c in inputs["calibration"]])
            each = compiled_per_forward(compiled, quant.value, len(softmax_rows_of(compiled)))
            lock_each = compiled_per_forward(lock.compiled(), quant.value,
                                             len(softmax_rows_of(lock.compiled())))
            if dtype == "bfloat16":
                each, lock_each = in_bf16(each), in_bf16(lock_each)
            wants, want_state = stream_sequence(ref)
            alone = (0, 37)
            reset_counters()
            answers, got_state = stream_sequence(exe)
            lock_answers = [lock.infer(x) for x in streams]
            alone_answers = {}
            for i in alone:
                exe.reset_state()
                alone_answers[i] = [exe.infer({k: v[i:i + 1] for k, v in x.items()})
                                    for x in streams]
            got_launches = counters()
            count_path(label, got_launches,
                       {k: each[k] * (len(answers) + len(alone) * len(streams))
                        + lock_each[k] * len(streams) for k in each}, 1)
            if int8full and not got_launches["fused_gemm_i8i8" + ("_bf16" if dtype ==
                                                                    "bfloat16" else "")]:
                raise AssertionError(f"{label}: the head ran no int8 x int8 fused_gemm")
            try:
                exe.infer_batch(streams[0])
            except NotImplementedError:
                pass
            else:
                raise AssertionError(f"{label}: infer_batch answered a stateful network")
            if dtype == "float32":
                f32_stream[quant] = (wants, want_state, alone_answers)
            f32 = f32_stream[quant] if dtype == "bfloat16" else None
            # every call's outputs at once: the bf16 gate's means over 330
            # values, not 30
            worst = exact_gate(f"{label} the calls", stacked(answers), stacked(wants), int8full,
                               None if f32 is None else stacked(f32[0]))
            err, _ = recipe_gate(f"{label} query_state after chunk 4", got_state, want_state, (),
                                 exact=int8full, f32=None if f32 is None else f32[1])
            for i in (0, 1):  # reset_state: the first chunks' answers again
                for k in answers[i]:
                    if not np.array_equal(answers[8 + i][k], answers[i][k]):
                        raise AssertionError(f"{label}: chunk {i} after reset_state answers "
                                             f"otherwise ({k})")
            moved = float(np.abs(answers[10]["logits"] - answers[2]["logits"]).max())
            if moved <= 1e-3 * float(np.abs(answers[2]["logits"]).max()):
                raise AssertionError(f"{label}: setting lstm2_h moved the answer by {moved}")
            rows = stacked([{k: v[i:i + 1] for k, v in lk.items()}
                            for i in alone for lk in lock_answers])
            lock_worst = recipe_gate(
                f"{label} lockstep rows {alone}", rows,
                stacked([a for i in alone for a in alone_answers[i]]), (),
                f32=None if f32 is None else stacked([a for i in alone for a in f32[2][i]]))[0]
            log(f"{label} KERNELS vs TORCH ({dtype}{', int8_dataflow=False' if int8full else ''})"
                f": {len(answers)} calls (8 chunks, reset_state and 2, lstm2_h set and 1), "
                f"max_rel_err {worst:.3e}; query_state after chunk 4 {err:.3e}; the answer "
                f"the set moved by {moved:.3e}; {BATCH} streams in lockstep for "
                f"{len(streams)} chunks against streams {alone} alone: max_rel_err "
                f"{lock_worst:.3e}; launches {got_launches}")
            if dtype == "float32" and quant == QuantMode.NONE:
                interp, _ = stream_sequence(recipe_loaded(name, quant, "numpy"))
                worst = recipe_gate(f"{label} the calls (interpreter)", stacked(interp),
                                    stacked(wants), ())[0]
                log(f"{label} the numpy interpreter vs TORCH (float32): {len(interp)} calls, "
                    f"max_rel_err {worst:.3e}")
    log(f"4f {name}: {time.perf_counter() - t_recipe:.2f} s")

    # two_stage and single_shot
    for name in ("two_stage", "single_shot"):
        t_recipe = time.perf_counter()
        key = f"op_graphs {name}"
        inputs = recipe_inputs[name]
        reqs, rows = inputs["requests"], inputs["batch"]
        if name == "two_stage":
            rows = {k: v[:TWO_STAGE_ROWS] for k, v in rows.items()}
        n_rows = len(next(iter(rows.values())))
        forwards = len(reqs) + (n_rows if key in per_example else 1)
        post = op_graphs.detector_sizes(op_graphs.FULL_WIDTH)[2]
        f32_answers = {}
        for dtype in ("float32", "bfloat16"):
            for quant in (QuantMode.NONE, QuantMode.INT8_WEIGHT, QuantMode.INT8_FULL):
                label = f"{key} {quant.value}{' bf16' if dtype == 'bfloat16' else ''}"
                int8full = quant == QuantMode.INT8_FULL
                exe = (recipe_exes[name, quant] if dtype == "float32" else
                       recipe_loaded(name, quant, "pallas", compute_dtype=dtype))
                compiled = exe.compiled()
                ref = recipe_loaded(name, quant, "torch", compute_dtype=dtype,
                                    int8_dataflow=False)
                each = compiled_per_forward(compiled, quant.value,
                                            len(softmax_rows_of(compiled)))
                if dtype == "bfloat16":
                    each = in_bf16(each)
                reset_counters()
                answers = [exe.infer(r) for r in reqs] + [exe.infer_batch(rows)]
                got_launches = counters()
                count_path(label, got_launches, each, forwards)
                if int8full and not (got_launches["conv2d_direct"]
                                     + got_launches["conv2d_direct_bf16"]):
                    raise AssertionError(f"{label}: no conv2d_direct launch")
                wants = [ref.infer(r) for r in reqs] + [ref.infer_batch(rows)]
                if dtype == "float32":
                    f32_answers[quant] = wants
                worst, texts = 0.0, []
                for i, (got, want) in enumerate(zip(answers, wants)):
                    err, text = detector_gate(
                        name, f"{label} {'infer_batch' if i == len(reqs) else f'request {i}'}",
                        got, want, int8full,
                        None if dtype == "float32" else f32_answers[quant][i], post)
                    worst = max(worst, err)
                    texts.append(text)
                log(f"{label} KERNELS vs TORCH ({dtype}"
                    f"{', int8_dataflow=False' if int8full else ''}): {len(reqs)} requests and "
                    f"infer_batch({n_rows}) ({forwards} forwards), max_rel_err {worst:.3e}; "
                    f"{'; '.join(texts)}; launches {got_launches}")
                if dtype == "float32" and quant == QuantMode.NONE:
                    interp = recipe_loaded(name, quant, "numpy")
                    texts, worst = [], 0.0
                    for i, (r, want) in enumerate(zip(reqs, wants)):
                        err, text = detector_gate(name, f"{label} request {i} (interpreter)",
                                                  interp.infer(r), want, False, None, post)
                        worst = max(worst, err)
                        texts.append(text)
                    log(f"{label} the numpy interpreter vs TORCH (float32): {len(reqs)} "
                        f"requests, max_rel_err {worst:.3e}; {'; '.join(texts)}")
        log(f"4f {name}: {time.perf_counter() - t_recipe:.2f} s")

    # Proposal alone at two_stage's shapes, B = 1: its forward's wall time
    # (the greedy sweep issues a few device operations a candidate)
    p_node = recipe_nets["two_stage"].model.find_by_type("Proposal")[0]
    p_args = (torch.rand(1, 18, 14, 14, device=dev), 0.1 * torch.randn(1, 36, 14, 14, device=dev),
              torch.tensor([224.0, 224.0, 1.0], device=dev), proposal_params(p_node))
    proposal_torch(*p_args)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proposal_torch(*p_args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"4f Proposal forward at B = 1 (1,764 anchors, 300 rois): median "
        f"{statistics.median(times):.2f} ms of 5 (wall, synchronized), device ops issued by "
        f"the host")
    log(f"phase 4f launches: {state_launches}")
    phase_done("4f variable state and the detector ops")

    # -- 4g. serving on the card: Core → compile_model → AsyncInferQueue --------
    # ResNet-18 at full width, INT8-FULL KERNELS in float32 and bench.py's
    # headline (u8 through PrePostProcessor, INT8-FULL, bfloat16), each
    # through Core().compile_model(..., "GPU", Config(batch_buckets=
    # SERVE_BUCKETS)) and AsyncInferQueue(jobs=SERVE_JOBS): SERVE_REQUESTS
    # seeded requests, a callback storing each answer under its userdata.
    # Every counter is zeroed before the server starts (its warmup runs each
    # bucket once) and read after the queue drains, against (buckets +
    # batches) forwards.  Each served answer is held against the same
    # network's direct infer of the same image by phase 4's classifier gate;
    # the served logits are read back from the probabilities (log p, up to
    # the row's shift, which a softmax does not see, over the classes whose
    # probability is not 0 in either answer).  Then lstm_stream
    # (phase 2d's IR, KERNELS FP32): two InferRequests stepped in turn from
    # two threads, four chunks each, against each stream run alone on a
    # request of its own by recipe_gate, outputs and query_state; reset_state
    # on one request leaves the other's state as it was.
    from pyopenvino_tpu_torch import AsyncInferQueue, Core
    from pyopenvino_tpu_torch.config import Backend

    core = Core()
    serve_rng = np.random.default_rng(51)
    serve_launches = dict.fromkeys(COUNTERS, 0)
    served_nets = []  # (label, CompiledModel, its requests) for phase 4h
    served = (
        ("resnet18 int8 served", core.read_model(*resnet18_paths(seed=0)), "float32",
         [serve_rng.uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
          for _ in range(SERVE_REQUESTS)], calibration),
        ("resnet18 int8 bf16 u8 headline served", headline_net, "bfloat16",
         [serve_rng.integers(0, 256, (1, 3, 224, 224), dtype=np.uint8)
          for _ in range(SERVE_REQUESTS)], u8_calibration))
    for label, model, dtype, reqs, samples in served:
        t_label = time.perf_counter()
        compiled_model = core.compile_model(model, "GPU", Config(
            backend=Backend.KERNELS, quant=QuantMode.INT8_FULL, compute_dtype=dtype,
            batch_buckets=SERVE_BUCKETS))
        exe = compiled_model._exe
        exe.set_calibration(samples)
        net = exe.compiled()  # calibrated and compiled; launches nothing
        if net.device.type != "cuda":
            raise AssertionError(f"{label}: compiled onto {net.device}")
        out = net.model.results[0].name
        matmul = next(n for n in net.model if n.op_type == "MatMul")
        logits_name = net.model.nodes[net._fusions[matmul.id].out_key[0]].name
        reset_counters()
        t0 = time.perf_counter()
        exe.requests  # the server starts, each bucket warmed once
        warm_s = time.perf_counter() - t0
        queue = AsyncInferQueue(compiled_model, jobs=SERVE_JOBS)
        answers = {}
        queue.set_callback(
            lambda request, userdata: answers.__setitem__(userdata, request.output_blobs[out]))
        t0 = time.perf_counter()
        for i, x in enumerate(reqs):
            queue.start_async({"data": x}, userdata=i)
        queue.wait_all()
        queue_s = time.perf_counter() - t0
        got_launches = counters()
        stats = exe._server.stats
        each = per_forward("resnet18", "int8")
        if dtype == "bfloat16":
            each = in_bf16(each)
        forwards = len(SERVE_BUCKETS) + stats.batches
        expected = {k: c * forwards for k, c in each.items()}
        if got_launches != expected:
            raise AssertionError(f"{label}: kernel launches {got_launches}, expected {expected} "
                                 f"({each} per forward, {forwards} forwards)")
        for k in launches:
            launches[k] += got_launches[k]
            serve_launches[k] += got_launches[k]
        if stats.requests != SERVE_REQUESTS or not stats.batches < SERVE_REQUESTS:
            raise AssertionError(f"{label}: {stats.summary()}: the requests did not coalesce")
        if sorted(answers) != list(range(SERVE_REQUESTS)):
            raise AssertionError(f"{label}: {len(answers)} answers for {SERVE_REQUESTS} requests")
        # the gate: each answer against the same network's direct infer
        equal, prob_err, logit_err = 0, 0.0, 0.0
        for i, x in enumerate(reqs):
            want, captured = net.infer_with_capture({"data": x}, [logits_name])
            got, want = answers[i], want[out]
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"{label} request {i}: served {got.shape}, direct "
                                     f"{want.shape}")
            np.testing.assert_allclose(got, want, rtol=E2E_RTOL, atol=E2E_ATOL,
                                       err_msg=f"{label} request {i}")
            if got.argmax() != want.argmax():
                raise AssertionError(f"{label} request {i}: top-1 {got.argmax()} served, "
                                     f"{want.argmax()} direct")
            pos = (got > 0) & (want > 0)  # a bf16 probability may round to 0
            shift = np.log(got[pos].astype(np.float64)) - np.log(want[pos].astype(np.float64))
            logit_err = max(logit_err, float(np.abs(shift - shift.mean()).max()
                                             / np.abs(captured[logits_name]).max()))
            prob_err = max(prob_err, float(np.abs(got - want).max()))
            equal += int(np.array_equal(got, want))
        if logit_err > 1e-4:
            raise AssertionError(f"{label}: served logits max_rel_err {logit_err}")
        rows = np.concatenate(reqs[:SERVE_BUCKETS[-1]])
        exe.infer_batch({"data": rows})
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            exe.infer_batch({"data": rows})
            times.append(time.perf_counter() - t0)
        exe.close()
        served_nets.append((label, compiled_model, reqs))
        log(f"{label}: {SERVE_REQUESTS} requests through AsyncInferQueue(jobs={SERVE_JOBS}) "
            f"against direct infer: probabilities max_abs_err {prob_err:.3e}, logits (log p, "
            f"up to the row's shift) max_rel_err {logit_err:.3e}, top-1 equal on all, "
            f"bit-equal {equal} of {SERVE_REQUESTS}; launches {got_launches} ({forwards} "
            f"forwards: {len(SERVE_BUCKETS)} warmup + {stats.batches} batches)")
        log(f"4g {label} " + json.dumps({
            **stats.summary(), "buckets": list(SERVE_BUCKETS), "jobs": SERVE_JOBS,
            "warmup_s": warm_s, "queue_s": queue_s, "req_per_s": SERVE_REQUESTS / queue_s,
            f"infer_batch_img_per_s_b{len(rows)}": len(rows) / statistics.median(times),
            "s": time.perf_counter() - t_label}))

    # lstm_stream: two requests from two threads in turn, against each alone
    t_label = time.perf_counter()
    name = "lstm_stream"
    compiled_model = core.compile_model(recipe_nets[name], "GPU", Config(backend=Backend.KERNELS))
    net = compiled_model._exe.compiled()
    chunks = recipe_inputs[name]["chunks"]
    streams = (chunks[:4], chunks[4:])

    def run_stream(request, stream):
        answers = [request.infer(c) for c in stream]
        return answers, {v.name: v.state for v in request.query_state()}

    alone = [run_stream(compiled_model.create_infer_request(), stream) for stream in streams]
    pair = [compiled_model.create_infer_request() for _ in streams]
    results, turn, done = [None, None], threading.Condition(), [0]

    def drive(i):
        answers = []
        for j, c in enumerate(streams[i]):
            with turn:  # in turn: request 0's chunk j, then request 1's
                turn.wait_for(lambda: done[0] == 2 * j + i)
                answers.append(pair[i].infer(c))
                done[0] += 1
                turn.notify_all()
        results[i] = answers, {v.name: v.state for v in pair[i].query_state()}

    reset_counters()
    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    got_launches = counters()
    if None in results:
        raise AssertionError(f"op_graphs {name} served: a request thread did not finish")
    each = compiled_per_forward(net, "none", len(softmax_rows_of(net)))
    expected = {k: c * sum(len(s) for s in streams) for k, c in each.items()}
    if got_launches != expected or not got_launches["fused_gemm"]:
        raise AssertionError(f"op_graphs {name} served: kernel launches {got_launches}, "
                             f"expected {expected}")
    for k in launches:
        launches[k] += got_launches[k]
        serve_launches[k] += got_launches[k]
    worst, equal = 0.0, 0
    for i, ((answers, state), (want_answers, want_state)) in enumerate(zip(results, alone)):
        for j, (got, want) in enumerate(zip(answers, want_answers)):
            worst = max(worst, recipe_gate(f"op_graphs {name} request {i} chunk {j}", got, want,
                                           ())[0])
            equal += all(np.array_equal(got[k], want[k]) for k in want)
        worst = max(worst, recipe_gate(f"op_graphs {name} request {i} query_state", state,
                                       want_state, ())[0])
    before = {v.name: v.state for v in pair[1].query_state()}
    pair[0].reset_state()
    after = {v.name: v.state for v in pair[1].query_state()}
    if any(not np.array_equal(after[k], v) for k, v in before.items()):
        raise AssertionError(f"op_graphs {name}: reset_state on one request moved the other's")
    recipe_gate(f"op_graphs {name} request 0 after reset_state",
                pair[0].infer(streams[0][0]), alone[0][0][0], ())
    log(f"op_graphs {name} served: 2 InferRequests stepped in turn from 2 threads, "
        f"{len(streams[0])} chunks each, against each stream alone: max_rel_err {worst:.3e} "
        f"(outputs and query_state), {equal} of {2 * len(streams[0])} answers bit-equal; "
        f"reset_state on request 0 left request 1's state as it was; launches {got_launches}; "
        f"{time.perf_counter() - t_label:.2f} s")
    log(f"phase 4g launches: {serve_launches}")
    recipe_dir.cleanup()
    phase_done("4g serving")

    # -- 4h. the runtime extras: export/import, CACHE_DIR, perf counts, verify --
    # Phase 4g's two calibrated networks (R INT8-FULL KERNELS float32 and the
    # u8 bf16 headline) exported (export_model) and imported (import_model)
    # with prepare_model and the calibration counted, REQUESTS requests and
    # infer_batch at BATCH through each imported network bit-equal to the
    # exporter's; R INT8-FULL float32 compiled twice through two Cores with
    # one CACHE_DIR (a temporary directory), each to its first answer, the
    # second with no pass and no calibration and the same bits;
    # verify_against_interpreter on R FP32 KERNELS at B = 1;
    # get_perf_counts on R INT8-FULL KERNELS at B = 1 (every Convolution and
    # MatMul EXECUTED on the kernel its route names) and its profile (the
    # node rows and the unattributed time within 1 % of the profiler's
    # device total), EfficientNet-B0 INT8-FULL's batch-1 latency timed
    # before and after them.  Every launch is counted against the forwards
    # each step runs.
    import pyopenvino_tpu_torch.passes.calibrate as calibrate_mod
    import pyopenvino_tpu_torch.runtime.compiler as compiler_mod
    from pyopenvino_tpu_torch.runtime.profiling import aggregate

    extras_launches = dict.fromkeys(COUNTERS, 0)
    passes_run = collections.Counter()

    def phase_counted(phase, phase_launches, label, each, forwards):
        """The counters against ``each`` launches a forward times
        ``forwards``; added to the kernels line's and the phase's counts."""
        got_launches = counters()
        expected = {k: c * forwards for k, c in each.items()}
        if got_launches != expected:
            raise AssertionError(f"{phase} {label}: kernel launches {got_launches}, expected "
                                 f"{expected} ({each} per forward, {forwards} forwards)")
        for k in launches:
            launches[k] += got_launches[k]
            phase_launches[k] += got_launches[k]
        return got_launches

    extras_counted = functools.partial(phase_counted, "4h", extras_launches)

    def counted(name, fn):
        def wrapper(*args, **kw):
            passes_run[name] += 1
            return fn(*args, **kw)
        return wrapper

    real_prepare, real_calibrate = compiler_mod.prepare_model, calibrate_mod.calibrate_activations
    compiler_mod.prepare_model = counted("prepare_model", real_prepare)
    calibrate_mod.calibrate_activations = counted("calibrate_activations", real_calibrate)
    extras_dir = tempfile.TemporaryDirectory(prefix="extras_")

    def bit_equal(label, got, want):
        if sorted(got) != sorted(want) or any(
                got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])
                for k in want):
            raise AssertionError(f"4h {label}: the imported network's answer is not the "
                                 f"exporter's")

    try:
        for label, compiled_model, reqs in served_nets:
            net = compiled_model._exe.compiled()
            path = os.path.join(extras_dir.name, label.replace(" ", "_") + ".ovpt")
            t0 = time.perf_counter()
            compiled_model.export_model(path)
            export_s = time.perf_counter() - t0
            passes_run.clear()
            t0 = time.perf_counter()
            imported = core.import_model(path, "GPU")
            import_s = time.perf_counter() - t0
            if passes_run or imported.network.device.type != "cuda":
                raise AssertionError(f"4h {label}: import ran {dict(passes_run)} or landed on "
                                     f"{imported.network.device}")
            if (sorted(imported.weights) != sorted(net.weights)
                    or imported.network._fusions != net._fusions
                    or imported.network._int8_edges != net._int8_edges):
                raise AssertionError(f"4h {label}: weight keys, fusions or int8 edges moved")
            rows = np.concatenate(reqs[:BATCH])
            reset_counters()
            got = [imported.infer({"data": x}) for x in reqs[:REQUESTS]]
            got_batch = imported.infer_batch({"data": rows})
            want = [net.infer({"data": x}) for x in reqs[:REQUESTS]]
            want_batch = net.infer_batch({"data": rows})
            each = per_forward("resnet18", "int8")
            if "bf16" in label:
                each = in_bf16(each)
            got_launches = extras_counted(f"{label} export/import", each, 2 * (REQUESTS + 1))
            for i, (g, w) in enumerate(zip(got, want)):
                bit_equal(f"{label} request {i}", g, w)
            bit_equal(f"{label} infer_batch({BATCH})", got_batch, want_batch)
            log(f"4h {label} export/import: artifact {os.path.getsize(path)} bytes, export "
                f"{export_s:.2f} s, import {import_s:.2f} s (no pass, no calibration); "
                f"{REQUESTS} requests and infer_batch({BATCH}) bit-equal to the exporter's; "
                f"launches {got_launches}")

        # CACHE_DIR: cold, then cached, each to its first answer
        cache_cfg = Config(backend=Backend.KERNELS, quant=QuantMode.INT8_FULL)
        cache_dir = os.path.join(extras_dir.name, "cache")
        first = {}
        reset_counters()
        for run in ("cold", "cached"):
            passes_run.clear()
            t0 = time.perf_counter()
            run_core = Core()
            run_core.set_property({"CACHE_DIR": cache_dir})
            compiled_model = run_core.compile_model(
                run_core.read_model(*resnet18_paths(seed=0)), "GPU", cache_cfg)
            compiled_model._exe.set_calibration(calibration)
            answer = compiled_model({"data": requests[0]})
            first[run] = (time.perf_counter() - t0, dict(passes_run), answer)
        extras_counted("CACHE_DIR", per_forward("resnet18", "int8"), 2)
        if first["cold"][1] != {"prepare_model": 1, "calibrate_activations": 1} or first[
                "cached"][1]:
            raise AssertionError(f"4h CACHE_DIR: passes run cold {first['cold'][1]}, cached "
                                 f"{first['cached'][1]}")
        bit_equal("CACHE_DIR cached answer", first["cached"][2], first["cold"][2])
        log(f"4h resnet18 int8 CACHE_DIR first answer: cold {first['cold'][0]:.3f} s "
            f"(parse, prepare_model, calibration on {CALIBRATION} images, compile, artifact "
            f"written), cached {first['cached'][0]:.3f} s (parse, import, no pass, no "
            f"calibration), the same bits; {smi}")

        # verify_against_interpreter on R FP32 KERNELS at B = 1
        fp32 = loaded(networks["resnet18"], QuantMode.NONE, "pallas").compiled()
        reset_counters()
        t0 = time.perf_counter()
        diffs = fp32.verify_against_interpreter({"data": requests[0]})
        extras_counted("verify_against_interpreter", per_forward("resnet18", "none"), 1)
        log(f"4h resnet18 none verify_against_interpreter: {len(diffs)} layers within rtol "
            f"1e-3 / atol 1e-4 of the numpy interpreter, max |diff| {max(diffs.values()):.3e} "
            f"({max(diffs, key=diffs.get)}), {time.perf_counter() - t0:.2f} s")

        # get_perf_counts and profile on R INT8-FULL KERNELS at B = 1, with
        # EfficientNet-B0 INT8-FULL KERNELS' batch-1 latency (the classifier
        # with the most launches a forward) timed before the two profiler
        # sessions and after them: what a session leaves on later launches
        e_exe = more_exes["efficientnet_b0", QuantMode.INT8_FULL]

        def e_latency_ms():
            e_exe.infer({"data": images["requests"][0]})
            runs = []
            for i in range(20):
                t0 = time.perf_counter()
                e_exe.infer({"data": images["requests"][i % REQUESTS]})
                runs.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(runs)

        latency_before = e_latency_ms()
        _, compiled_model, _ = served_nets[0]
        exe, net = compiled_model._exe, compiled_model._exe.compiled()
        routes = {node.id: route for node, route in zip(
            net.model.find_by_type("Convolution"), (r for r, *_ in conv_launches(net, "int8")))}
        if len(routes) != len(net.model.find_by_type("Convolution")):
            raise AssertionError("4h perf counts: a Convolution launches no kernel")
        reset_counters()
        prof_rows = net.profile({"data": requests[0]})
        device_total = net.last_profile_us
        counts = exe.get_perf_counts({"data": requests[0]})
        extras_counted("get_perf_counts", per_forward("resnet18", "int8"), 4)
        latency_after = e_latency_ms()
        attributed = sum(r["self_us"] for r in prof_rows if r["node"] is not None)
        unattributed = sum(r["self_us"] for r in prof_rows if r["node"] is None)
        if abs(attributed + unattributed - device_total) > 0.01 * device_total:
            raise AssertionError(f"4h profile: nodes {attributed} us + unattributed "
                                 f"{unattributed} us against the device's {device_total} us")
        for node in net.model:
            if node.op_type not in ("Convolution", "MatMul"):
                continue
            row = counts[node.name]
            want_kernel = routes.get(node.id, "fused_gemm_i8i8")
            if row["status"] != "EXECUTED" or row["exec_type"] != want_kernel:
                raise AssertionError(f"4h get_perf_counts {node.name}: {row}, its route "
                                     f"{want_kernel}")
        by_node = aggregate(prof_rows, by="node")
        log("4h resnet18 int8 get_perf_counts " + json.dumps({
            "executed": sum(r["status"] == "EXECUTED" for r in counts.values()),
            "not_run": sum(r["status"] == "NOT_RUN" for r in counts.values()),
            "exec_types": dict(collections.Counter(
                r["exec_type"][:40] for r in counts.values() if r["status"] == "EXECUTED")),
            "node_us": attributed, "unattributed_us": unattributed,
            "device_total_us": device_total,
            "by_category": {r["category"]: r["self_us"]
                            for r in aggregate(prof_rows, by="category")},
            "top_nodes": [(r["node"], r["self_us"], r["kernel"][:40]) for r in by_node[:6]],
            "card": smi}))
        log("4h profile_after_cost " + json.dumps({
            "model": "efficientnet_b0 int8 kernels", "requests": 20,
            "latency_b1_ms_median_before": latency_before,
            "latency_b1_ms_median_after": latency_after,
            "after_over_before": latency_after / latency_before,
            "between": "profile and get_perf_counts on resnet18 int8 kernels, "
                       "two torch.profiler sessions with CUDA activity", "card": smi}))
    finally:
        compiler_mod.prepare_model, calibrate_mod.calibrate_activations = (
            real_prepare, real_calibrate)
        Core().set_property({"CACHE_DIR": ""})
        extras_dir.cleanup()
    log(f"phase 4h launches: {extras_launches}")
    phase_done("4h runtime extras")

    # -- 4i. the native host path ---------------------------------------------
    # (a) ResNet-18's shipped IR written again with every float Const
    # declared f16 (ir/writer.py with_f16_consts) into a temporary
    # directory and read back through IECore.read_network, whose parser
    # decodes the fp16 Consts with native.fp16_to_fp32: each bit-equal to
    # its float32 weight rounded through fp16; R FP32 KERNELS on it against
    # R FP32 TORCH on it by phase 4's classifier gate, two requests.
    # (b) STREAM_BATCHES batches of STREAM_BATCH seeded 480x640x3 frames
    # through native.AsyncLoader (u8_out, depth 4) from a producer thread
    # into the headline's infer_batch, against the synchronous pipeline
    # (preprocess_batch, then infer_batch) on the same frames: the same
    # blobs and the same answers, bit for bit; the same with float32 blobs
    # (scale 1/255) into R INT8-FULL KERNELS float32.  (c) SERVER_STREAM
    # batches of SERVER_STREAM_BATCH frames from the loader into an
    # InferenceServer over R INT8-FULL float32 (phase 4g's buckets), a
    # submit a row, each answer against direct infer by phase 4g's gate.
    # (d) cost_analysis and memory_analysis of both networks, the output
    # bytes against infer's, temp against the allocator's growth over one
    # B = 1 forward.  Every launch counted against the forwards each step
    # runs; the rates printed with the card's name and power limit.
    from pyopenvino_tpu_torch.ir import read_ir_model
    from pyopenvino_tpu_torch.ir.writer import with_f16_consts, write_ir_model
    from pyopenvino_tpu_torch.serving import InferenceServer

    native_launches = dict.fromkeys(COUNTERS, 0)
    native_counted = functools.partial(phase_counted, "4i", native_launches)

    def median_s(fn, runs=3):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    # (a) the fp16 IR
    t_label = time.perf_counter()
    f32_model = read_ir_model(*resnet18_paths(seed=0))
    fp16_dir = tempfile.TemporaryDirectory(prefix="fp16_ir_")
    try:
        xml16 = os.path.join(fp16_dir.name, "resnet18_fp16.xml")
        write_ir_model(with_f16_consts(f32_model), xml16)
        bin_bytes = os.path.getsize(os.path.splitext(xml16)[0] + ".bin")
        t0 = time.perf_counter()
        net16 = ie.read_network(xml16, os.path.splitext(xml16)[0] + ".bin")
        parse_s = time.perf_counter() - t0
    finally:
        fp16_dir.cleanup()
    halves = []
    for node in f32_model.nodes.values():
        if node.op_type != "Const" or node.const.dtype != np.float32:
            continue
        want = node.const.astype(np.float16)
        got = net16.model.nodes[node.id].const
        if got.dtype != np.float32 or not np.array_equal(
                got.view(np.uint32), want.astype(np.float32).view(np.uint32)):
            raise AssertionError(f"4i fp16 IR: Const {node.name!r} is not its float32 weight "
                                 f"rounded through fp16")
        halves.append(want.reshape(-1))
    halves = np.concatenate(halves)
    if not np.isfinite(halves).all():
        raise AssertionError("4i fp16 IR: a weight overflows fp16")
    exe16 = loaded(net16, QuantMode.NONE, "pallas")
    ref16 = loaded(net16, QuantMode.NONE, "torch")
    net16_k, net16_t = exe16.compiled(), ref16.compiled()
    matmul = next(n for n in net16_k.model if n.op_type == "MatMul")
    logits16 = net16_k.model.nodes[net16_k._fusions[matmul.id].out_key[0]].name
    out16 = net16_k.model.results[0].name
    reset_counters()
    got16 = [net16_k.infer_with_capture({"data": r}, [logits16]) for r in requests[:2]]
    got_launches = native_counted("fp16 IR", per_forward("resnet18", "none"), 2)
    logit_err = prob_err = 0.0
    for i, (r, (got, cap)) in enumerate(zip(requests, got16)):
        want, want_cap = net16_t.infer_with_capture({"data": r}, [logits16])
        g, w = got[out16], want[out16]
        if g.shape != (1, 1000) or not np.isfinite(g).all():
            raise AssertionError(f"4i fp16 IR request {i}: bad output {g.shape}")
        np.testing.assert_allclose(g, w, rtol=E2E_RTOL, atol=E2E_ATOL)
        if g.argmax() != w.argmax():
            raise AssertionError(f"4i fp16 IR request {i}: top-1 {g.argmax()} != {w.argmax()}")
        wl = want_cap[logits16]
        logit_err = max(logit_err, float(np.abs(cap[logits16] - wl).max() / np.abs(wl).max()))
        prob_err = max(prob_err, float(np.abs(g - w).max()))
    if logit_err > LOGIT_RTOL["none"]:
        raise AssertionError(f"4i fp16 IR: logits max_rel_err {logit_err}")
    fp32_answer = loaded(networks["resnet18"], QuantMode.NONE, "torch").infer(
        {"data": requests[0]})[out16]
    decode_native = median_s(lambda: native.fp16_to_fp32(halves), 5)
    decode_numpy = median_s(lambda: halves.astype(np.float32), 5)
    log(f"4i resnet18 fp16 IR: {len(halves)} weights in {bin_bytes} bytes of .bin, parsed in "
        f"{parse_s:.2f} s, each Const its float32 weight rounded through fp16 bit for bit; "
        f"R FP32 KERNELS vs TORCH on it: logits max_rel_err {logit_err:.3e}, probabilities "
        f"max_abs_err {prob_err:.3e}, top-1 equal; TORCH's fp16-weight probabilities against "
        f"the float32 IR's max_abs_err "
        f"{float(np.abs(got16[0][0][out16] - fp32_answer).max()):.3e}; launches "
        f"{got_launches}; {time.perf_counter() - t_label:.2f} s")
    log("4i fp16_decode " + json.dumps({
        "values": int(halves.size), "native_s": decode_native, "numpy_astype_s": decode_numpy,
        "native_values_per_s": halves.size / decode_native,
        "numpy_values_per_s": halves.size / decode_numpy,
        "native_over_numpy": decode_numpy / decode_native, "threads": native._nthreads(),
        "card": smi}))

    # the frames: STREAM_BATCHES seeded batches of camera-sized images
    frame_rng = np.random.default_rng(71)
    frames = [frame_rng.integers(0, 256, (STREAM_BATCH, *FRAME_HW, 3), dtype=np.uint8)
              for _ in range(STREAM_BATCHES)]
    rates = {}
    for mode, kw in (("u8", {"u8_out": True}), ("f32", {"scale": np.full(3, 1 / 255,
                                                                          np.float32)})):
        secs = median_s(lambda: native.preprocess_batch(frames[0], (224, 224), **kw))
        rates[f"preprocess_{mode}_img_per_s"] = STREAM_BATCH / secs
    log("4i preprocess_batch " + json.dumps({
        "frames": [STREAM_BATCH, *FRAME_HW, 3], "out": [3, 224, 224],
        "threads": native._nthreads(), **rates, "card": smi}))

    # (b) the stream into the headline (u8) and into R INT8-FULL float32
    _, r_int8_model, _ = served_nets[0]
    r_int8 = r_int8_model._exe.compiled()
    hl = headline.compiled()
    streams = (("resnet18 int8 bf16 u8 headline", hl, {"u8_out": True}, in_bf16),
               ("resnet18 int8", r_int8, {"scale": np.full(3, 1 / 255, np.float32)},
                lambda each: each))
    for label, net, kw, variant in streams:
        out = net.model.results[0].name
        reset_counters()
        net.infer_batch({"data": native.preprocess_batch(frames[0], (224, 224), **kw)})
        t0 = time.perf_counter()
        sync_blobs, sync_answers = [], []
        for imgs in frames:
            sync_blobs.append(native.preprocess_batch(imgs, (224, 224), **kw))
            sync_answers.append(net.infer_batch({"data": sync_blobs[-1]})[out])
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        async_blobs, async_answers = [], []
        with native.AsyncLoader((*FRAME_HW, 3), (224, 224), depth=4, **kw) as loader:
            producer = threading.Thread(target=lambda: (
                [loader.submit(imgs) for imgs in frames], loader.close()))
            producer.start()
            for blob in loader:
                async_blobs.append(blob)
                async_answers.append(net.infer_batch({"data": blob})[out])
            producer.join()
        async_s = time.perf_counter() - t0
        got_launches = native_counted(f"{label} stream", variant(per_forward("resnet18", "int8")),
                                      1 + 2 * STREAM_BATCHES)
        if len(async_blobs) != STREAM_BATCHES:
            raise AssertionError(f"4i {label}: the loader handed back {len(async_blobs)} "
                                 f"batches of {STREAM_BATCHES}")
        for i in range(STREAM_BATCHES):
            if (async_blobs[i].dtype != sync_blobs[i].dtype
                    or not np.array_equal(async_blobs[i], sync_blobs[i])):
                raise AssertionError(f"4i {label} batch {i}: the loader's blob is not "
                                     f"preprocess_batch's")
            if (async_answers[i].shape != (STREAM_BATCH, 1000)
                    or not np.isfinite(async_answers[i]).all()
                    or not np.array_equal(async_answers[i], sync_answers[i])):
                raise AssertionError(f"4i {label} batch {i}: the streamed answer is not the "
                                     f"synchronous pipeline's")
        n_img = STREAM_BATCHES * STREAM_BATCH
        log(f"4i {label} stream: {STREAM_BATCHES} batches of {STREAM_BATCH} frames "
            f"{FRAME_HW[0]}x{FRAME_HW[1]}x3 through AsyncLoader({', '.join(kw)}, depth=4) into "
            f"infer_batch, blobs {async_blobs[0].dtype} and answers bit-equal to the "
            f"synchronous pipeline's; launches {got_launches}")
        log("4i stream " + json.dumps({
            "label": label, "images": n_img, "sync_img_per_s": n_img / sync_s,
            "async_img_per_s": n_img / async_s, "async_over_sync": sync_s / async_s,
            "loader_workers": native._default_workers(), "card": smi}))

    # (c) the loader into the server over R INT8-FULL float32
    t_label = time.perf_counter()
    out = r_int8.model.results[0].name
    matmul = next(n for n in r_int8.model if n.op_type == "MatMul")
    logits_name = r_int8.model.nodes[r_int8._fusions[matmul.id].out_key[0]].name
    server_frames = [f[:SERVER_STREAM_BATCH] for f in frames[:SERVER_STREAM]]
    reset_counters()
    rows, futs = [], []
    with native.AsyncLoader((*FRAME_HW, 3), (224, 224), scale=np.full(3, 1 / 255, np.float32),
                            depth=2) as loader:
        srv = InferenceServer(r_int8, buckets=SERVE_BUCKETS).start(warmup=True)
        try:
            producer = threading.Thread(target=lambda: (
                [loader.submit(imgs) for imgs in server_frames], loader.close()))
            producer.start()
            for blob in loader:
                for row in blob:
                    rows.append(row[None])
                    futs.append(srv.submit({"data": rows[-1]}))
            producer.join()
            answers = [f.result(timeout=300) for f in futs]
        finally:
            srv.stop()
    stats = srv.stats
    equal, prob_err, logit_err = 0, 0.0, 0.0
    for i, (x, got) in enumerate(zip(rows, answers)):
        want, captured = r_int8.infer_with_capture({"data": x}, [logits_name])
        got, want = got[out], want[out]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"4i server request {i}: served {got.shape}, direct {want.shape}")
        np.testing.assert_allclose(got, want, rtol=E2E_RTOL, atol=E2E_ATOL,
                                   err_msg=f"4i server request {i}")
        if got.argmax() != want.argmax():
            raise AssertionError(f"4i server request {i}: top-1 {got.argmax()} served, "
                                 f"{want.argmax()} direct")
        pos = (got > 0) & (want > 0)
        shift = np.log(got[pos].astype(np.float64)) - np.log(want[pos].astype(np.float64))
        logit_err = max(logit_err, float(np.abs(shift - shift.mean()).max()
                                         / np.abs(captured[logits_name]).max()))
        prob_err = max(prob_err, float(np.abs(got - want).max()))
        equal += int(np.array_equal(got, want))
    n_req = SERVER_STREAM * SERVER_STREAM_BATCH
    if len(answers) != n_req or stats.requests != n_req:
        raise AssertionError(f"4i server: {len(answers)} answers, {stats.requests} requests "
                             f"for {n_req} rows")
    if logit_err > 1e-4:
        raise AssertionError(f"4i server: served logits max_rel_err {logit_err}")
    forwards = len(SERVE_BUCKETS) + stats.batches + n_req
    got_launches = native_counted("server", per_forward("resnet18", "int8"), forwards)
    log(f"4i resnet18 int8 served from the loader: {n_req} rows of {SERVER_STREAM} batches "
        f"through InferenceServer(buckets={list(SERVE_BUCKETS)}) against direct infer: "
        f"probabilities max_abs_err {prob_err:.3e}, logits (log p, up to the row's shift) "
        f"max_rel_err {logit_err:.3e}, top-1 equal on all, bit-equal {equal} of {n_req}; "
        f"{stats.batches} batches; launches {got_launches} ({forwards} forwards: "
        f"{len(SERVE_BUCKETS)} warmup + {stats.batches} batches + {n_req} direct); "
        f"{time.perf_counter() - t_label:.2f} s")

    # (d) the analyses of both networks, each beside one B = 1 forward
    reset_counters()
    for label, net, x in (("resnet18 int8", r_int8, requests[0]),
                          ("resnet18 int8 bf16 u8 headline", hl, u8_requests[0])):
        cost, mem = net.cost_analysis(), net.memory_analysis()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        answer = net.infer({"data": x})
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - base
        returned = sum(a.nbytes for a in answer.values())
        if mem["output_size_in_bytes"] != returned:
            raise AssertionError(f"4i {label} memory_analysis: output "
                                 f"{mem['output_size_in_bytes']} bytes, infer returns {returned}")
        if not (cost["flops"] > 0 and mem["temp_size_in_bytes"] > 0
                and mem["generated_code_size_in_bytes"] > 0):
            raise AssertionError(f"4i {label}: analyses {cost} {mem}")
        log(f"4i analyses {label} " + json.dumps({
            "cost_analysis": cost, "memory_analysis": mem,
            "max_memory_allocated_growth_b1": growth, "card": smi}))
    r_each, hl_each = per_forward("resnet18", "int8"), in_bf16(per_forward("resnet18", "int8"))
    native_counted("analyses", {k: r_each[k] + hl_each[k] for k in COUNTERS}, 1)
    del frames, server_frames
    log(f"phase 4i launches: {native_launches}")
    phase_done("4i native host path")

    # -- 4j. parallelism: the device mesh in one process ----------------------
    # Logical shards of this one card (explicit devices [cuda:n] * k,
    # pyopenvino_tpu_torch/parallel/mesh.py): they check the sharding's
    # arithmetic and every kernel at its per-shard shapes, and time what the
    # bookkeeping costs on one card, not what k cards would give.  (a)
    # ResNet-18 at full width in bench.py's headline setup (u8 ingress,
    # INT8-FULL, bfloat16, KERNELS: the headline's prepared model and
    # calibration) at B = BATCH on DP4, DP2×TP2, DP2×SP2 and SP4, each
    # bit-equal to the unsharded network on the same rows.  (b) R FP32 on
    # TORCH on DP2×TP2 and DP2×SP2 within rtol 1e-4 / atol 1e-5 (the JAX
    # tests' bound).  (c) MoE-MLP FP32 KERNELS with EP over model = 2 (its
    # batch one example at a time, two batch-1 requests) against the
    # unsharded network by phase 4's probability gate.  (d) The server over
    # the DP4 network: its buckets rounded up to multiples of 4, REQUESTS
    # requests and one alone (padded to 4), bit-equal to direct infer.
    # Every mesh's launches predicted from the compiled graph's shapes
    # (mesh_per_forward) before its run and checked after it; each mesh's ms
    # a batch (MESH_TIMED infer_batch calls, the median) beside the unsharded
    # network's.
    from pyopenvino_tpu_torch.parallel.mesh import MeshConfig, build_mesh, shard_compiled
    from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork

    mesh_launches = dict.fromkeys(COUNTERS, 0)
    mesh_counted = functools.partial(phase_counted, "4j", mesh_launches)
    card = torch.device("cuda", torch.cuda.current_device())
    meshes = (("dp4", MeshConfig(data=4), {}),
              ("dp2_tp2", MeshConfig(data=2, model=2), {"tensor_parallel": True}),
              ("dp2_sp2", MeshConfig(data=2, spatial=2), {"spatial_parallel": True}),
              ("sp4", MeshConfig(spatial=4), {"spatial_parallel": True}))
    log(f"4j meshes: logical shards of one card, devices [{card}] * n; {smi}")

    def replica(net):
        """A network of ``net``'s prepared model and scales, its own weights."""
        return CompiledNetwork(net.model, net.config, device=card, quantized=net._quantized,
                               act_scales=net.act_scales, bias_corr=net._bias_corr)

    def on_mesh(net, cfg, **kw):
        size = cfg.data * cfg.model * cfg.spatial
        return shard_compiled(replica(net), build_mesh(cfg, [card] * size), **kw)

    def axes(cfg, kw):
        return (cfg.model if kw.get("tensor_parallel") else 1,
                cfg.spatial if kw.get("spatial_parallel") else 1)

    def batch_ms(net, rows):
        """One warm call, then the median of MESH_TIMED calls (host clock,
        numpy in and out)."""
        net.infer_batch(rows)
        times = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            net.infer_batch(rows)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # (a) the headline's meshes
    hl_rows = {"data": u8_batch[:BATCH]}
    hl_plain = replica(hl)
    hl_each = in_bf16(compiled_per_forward(hl_plain, "int8", 1))
    reset_counters()
    hl_want = hl_plain.infer_batch(hl_rows)
    plain_ms = batch_ms(hl_plain, hl_rows)
    mesh_counted("headline unsharded", hl_each, 2 + MESH_TIMED)
    mesh_nets, mesh_ms = {}, {"unsharded": plain_ms}
    for label, cfg, kw in meshes:
        t_label = time.perf_counter()
        net = mesh_nets[label] = on_mesh(hl, cfg, **kw)
        each = in_bf16(mesh_per_forward(net, "int8", 1, *axes(cfg, kw)))
        log(f"4j headline {label} predicted launches a forward {each} x {cfg.data} blocks")
        reset_counters()
        got = net.infer_batch(hl_rows)
        ms = mesh_ms[label] = batch_ms(net, hl_rows)
        got_launches = mesh_counted(f"headline {label}", each, cfg.data * (2 + MESH_TIMED))
        for k in hl_want:
            if got[k].dtype != hl_want[k].dtype or not np.array_equal(got[k], hl_want[k]):
                diff = np.abs(got[k].astype(np.float64) - hl_want[k].astype(np.float64))
                raise AssertionError(f"4j headline {label}: {k} is not the unsharded network's "
                                     f"bits: {int((diff > 0).sum())} elements differ, max "
                                     f"{diff.max():.3e}")
        log(f"4j headline {label} " + json.dumps({
            "mesh": dict(net.mesh.shape),
            "devices": sorted({str(d) for d in net.mesh.devices.flat}),
            "rows": BATCH, "bit_equal": True, "launches": got_launches,
            "ms_batch_median": ms, "ms_batch_unsharded": plain_ms, "over_unsharded": ms / plain_ms,
            "s": time.perf_counter() - t_label, "card": smi}))

    # (b) R FP32 on TORCH
    r_torch = loaded(networks["resnet18"], QuantMode.NONE, "torch").compiled()
    r_rows = {"data": batch}
    reset_counters()
    r_want = r_torch.infer_batch(r_rows)
    r_plain_ms = batch_ms(r_torch, r_rows)
    for label, cfg, kw in meshes[1:3]:
        net = on_mesh(r_torch, cfg, **kw)
        got = net.infer_batch(r_rows)
        ms = batch_ms(net, r_rows)
        for k in r_want:
            np.testing.assert_allclose(got[k], r_want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"4j resnet18 fp32 torch {label}")
        err = max(float(np.abs(got[k] - r_want[k]).max()) for k in r_want)
        log(f"4j resnet18 fp32 torch {label} " + json.dumps({
            "mesh": dict(net.mesh.shape), "rows": BATCH, "max_abs_err": err,
            "bit_equal": all(np.array_equal(got[k], r_want[k]) for k in r_want),
            "ms_batch_median": ms, "ms_batch_unsharded": r_plain_ms,
            "over_unsharded": ms / r_plain_ms, "card": smi}))
    mesh_counted("resnet18 fp32 torch", dict.fromkeys(COUNTERS, 0), 1)

    # (c) MoE-MLP's experts over model = 2
    moe = family_exes["moe_mlp", QuantMode.NONE].compiled()
    moe_in = family_images["moe_mlp"]["input"]
    moe_rows = {moe_in: family_images["moe_mlp"]["batch"][:MESH_MOE_ROWS]}
    moe_reqs = family_images["moe_mlp"]["requests"][:2]
    moe_softmax = sum(c for m, _, c in family_softmax if m == "moe_mlp")
    net = on_mesh(moe, MeshConfig(model=2), tensor_parallel=True)
    experts = [k for k, spec in net._w_specs.items()
               if net.weights[k].dim() == 3 and spec[:1] == ("model",)]
    if len(experts) != 4:
        raise AssertionError(f"4j moe_mlp EP: expert stacks sharded {experts}")
    each = mesh_per_forward(net, "none", moe_softmax, tp=2)
    reset_counters()
    moe_want = moe.infer_batch(moe_rows)
    want_reqs = [moe.infer({moe_in: x}) for x in moe_reqs]
    t0 = time.perf_counter()
    got = net.infer_batch(moe_rows)
    got_reqs = [net.infer({moe_in: x}) for x in moe_reqs]
    moe_ms = (time.perf_counter() - t0) * 1e3
    plain_each = compiled_per_forward(moe, "none", moe_softmax)
    got_launches = mesh_counted(
        "moe_mlp EP", {k: (plain_each[k] + each[k]) for k in COUNTERS}, MESH_MOE_ROWS + 2)
    err = 0.0
    for g, w in [(got, moe_want)] + list(zip(got_reqs, want_reqs)):
        for k in w:
            if g[k].shape != w[k].shape or not np.isfinite(g[k]).all():
                raise AssertionError(f"4j moe_mlp EP: {k} {g[k].shape} against {w[k].shape}")
            np.testing.assert_allclose(g[k], w[k], rtol=E2E_RTOL, atol=E2E_ATOL,
                                       err_msg="4j moe_mlp EP")
            if (g[k].argmax(-1) != w[k].argmax(-1)).any():
                raise AssertionError("4j moe_mlp EP: top-1 moved")
            err = max(err, float(np.abs(g[k] - w[k]).max()))
    log("4j moe_mlp fp32 kernels EP " + json.dumps({
        "mesh": dict(net.mesh.shape), "expert_stacks_sharded": len(experts),
        "rows": MESH_MOE_ROWS, "requests": len(moe_reqs), "max_abs_err": err,
        "predicted_a_forward": each, "launches": got_launches,
        "ms_rows_and_requests": moe_ms, "card": smi}))

    # (d) the server over the DP4 headline network
    dp4 = mesh_nets["dp4"]
    srv = InferenceServer(dp4, buckets=SERVE_BUCKETS)
    rounded = tuple(sorted({max(4, -(-b // 4) * 4) for b in SERVE_BUCKETS}))
    if srv.buckets != rounded:
        raise AssertionError(f"4j server buckets {srv.buckets}, expected {rounded}")
    reset_counters()
    srv.start(warmup=True)
    try:
        futs = [srv.submit({"data": x}) for x in u8_requests]
        answers = [f.result(timeout=300) for f in futs]
        alone = srv.infer({"data": u8_requests[0]})
    finally:
        srv.stop()
    stats = srv.stats
    direct = [dp4.infer({"data": x}) for x in u8_requests]
    got_launches = mesh_counted(
        "server over dp4", hl_each, 4 * (len(rounded) + stats.batches) + len(u8_requests))
    for i, (got, want) in enumerate(zip(answers + [alone], direct + direct[:1])):
        for k in want:
            if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
                raise AssertionError(f"4j server over dp4 request {i}: not direct infer's bits")
    if stats.requests != len(u8_requests) + 1 or stats.padded_slots < 3:
        raise AssertionError(f"4j server over dp4: {stats.summary()}")
    log("4j server over dp4 " + json.dumps({
        "buckets": list(srv.buckets), "requests": stats.requests, "batches": stats.batches,
        "padded_slots": stats.padded_slots, "bit_equal_to_direct_infer": len(answers) + 1,
        "launches": got_launches, "card": smi}))
    del mesh_nets, dp4, net
    log(f"phase 4j launches: {mesh_launches}")
    phase_done("4j parallelism")

    # -- 4k. the pipeline: stage cuts and GPipe microbatches ------------------
    # Logical shards of this one card again (parallel/pipeline.py): the
    # cuts, the stage sub-models, the schedule's bookkeeping and every
    # kernel at its per-microbatch shapes, timed for what the bookkeeping
    # costs on one card, not what k cards would give.  Each pipelined
    # network is built by compile_pipelined from the IR its unsharded
    # network was loaded from, with that network's config and calibration
    # samples (prepare_model runs on the whole graph, so the activation
    # scales are the unsharded network's, checked).  (a) The headline at B
    # = BATCH on PP2, PP4 and PP2×DP2, bit-equal to the unsharded network.
    # (b) R FP32 on TORCH, PP2, within rtol 1e-4 / atol 1e-5 (the JAX
    # tests' bound).  (c) ssd_shapes_ms INT8-FULL KERNELS on PP2 (the
    # folded ShapeOf → PriorBox chains copied into the stages, the last
    # stage's DetectionOutput baked at the microbatch): the record tables
    # bit-equal.  (d) The server over the PP2×DP2 headline: buckets (1, 2,
    # 4, 8) rounded to (2, 4, 8), REQUESTS requests and one alone (padded
    # to 2), bit-equal to direct infer.  The cuts split no fusion group, so
    # each batch launches the unsharded forward's kernels n_micro × data
    # times (_pick_n_micro): predicted before each run, checked after it.
    from pyopenvino_tpu_torch.parallel import build_pipeline_mesh, compile_pipelined

    pipe_launches = dict.fromkeys(COUNTERS, 0)
    pipe_counted = functools.partial(phase_counted, "4k", pipe_launches)
    log(f"4k pipelines: logical shards of one card, devices [{card}] * n; {smi}")

    def pipelined(ienet, net, stages, data=1, samples=None):
        """compile_pipelined of ``ienet``'s IR with ``net``'s config on
        stages × data logical shards of the card; its scales ``net``'s."""
        pp = compile_pipelined(ienet.model, build_pipeline_mesh(stages, data, [card] * (
            stages * data)), net.config, calibration_samples=samples)
        if pp.stages[0].act_scales != net.act_scales or sorted(pp.model.nodes) != sorted(
                net.model.nodes):
            raise AssertionError(f"4k {ienet.model.name}: the pipeline's prepared model or "
                                 f"scales are not the unsharded network's")
        return pp

    def cut_nodes(pp):
        return [{"node": pp.model.nodes[c.node_id].name,
                 "op": pp.model.nodes[c.node_id].op_type, "port": c.port,
                 "shape": list(pp.model.nodes[c.node_id].outputs[c.port].shape),
                 "dtype": str(pp.model.nodes[c.node_id].outputs[c.port].dtype)}
                for c in pp.cuts]

    def walks_of(pp, b):
        """Stage-network forwards of each stage a batch of b: n_micro × data."""
        return pp._pick_n_micro(b) * pp.data_ax

    def same_bits(label, got, want):
        for k in want:
            if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
                diff = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
                raise AssertionError(f"4k {label}: {k} is not the unsharded network's bits: "
                                     f"{int((diff > 0).sum())} elements differ, max "
                                     f"{diff.max():.3e}")

    # (a) the headline on three pipelines
    reset_counters()
    pipe_plain_ms = batch_ms(hl_plain, hl_rows)
    pipe_counted("headline unsharded", hl_each, 1 + MESH_TIMED)
    pipe_nets, pipe_ms = {}, {}
    for label, stages, data in (("pp2", 2, 1), ("pp4", 4, 1), ("pp2_dp2", 2, 2)):
        t_label = time.perf_counter()
        pp = pipe_nets[label] = pipelined(headline_net, hl, stages, data, u8_calibration)
        walks = walks_of(pp, BATCH)
        log(f"4k headline {label} cuts {json.dumps(cut_nodes(pp))}; predicted launches a "
            f"batch {hl_each} x {pp._pick_n_micro(BATCH)} microbatches x {data} data")
        reset_counters()
        got = pp.infer_batch(hl_rows)
        ms = pipe_ms[label] = batch_ms(pp, hl_rows)
        got_launches = pipe_counted(f"headline {label}", hl_each, walks * (2 + MESH_TIMED))
        same_bits(f"headline {label}", got, hl_want)
        log(f"4k headline {label} " + json.dumps({
            "mesh": dict(pp.mesh.shape), "devices": sorted({str(d) for d in pp.mesh.devices.flat}),
            "rows": BATCH, "n_micro": pp._pick_n_micro(BATCH), "bit_equal": True,
            "launches": got_launches, "ms_batch_median": ms, "ms_batch_unsharded": pipe_plain_ms,
            "over_unsharded": ms / pipe_plain_ms, "s": time.perf_counter() - t_label,
            "card": smi}))

    # (b) R FP32 on TORCH, PP2
    reset_counters()
    r_pp = pipelined(networks["resnet18"], r_torch, 2)
    got = r_pp.infer_batch(r_rows)
    ms = batch_ms(r_pp, r_rows)
    r_plain_ms = batch_ms(r_torch, r_rows)
    for k in r_want:
        np.testing.assert_allclose(got[k], r_want[k], rtol=1e-4, atol=1e-5,
                                   err_msg="4k resnet18 fp32 torch pp2")
    pipe_counted("resnet18 fp32 torch", dict.fromkeys(COUNTERS, 0), 1)
    log("4k resnet18 fp32 torch pp2 " + json.dumps({
        "mesh": dict(r_pp.mesh.shape), "cuts": cut_nodes(r_pp), "rows": BATCH,
        "max_abs_err": max(float(np.abs(got[k] - r_want[k]).max()) for k in r_want),
        "bit_equal": all(np.array_equal(got[k], r_want[k]) for k in r_want),
        "ms_batch_median": ms, "ms_batch_unsharded": r_plain_ms,
        "over_unsharded": ms / r_plain_ms, "card": smi}))

    # (c) ssd_shapes_ms INT8-FULL KERNELS, PP2
    ssd_c = ssd_exes[QuantMode.INT8_FULL].compiled()
    ssd_pp = pipelined(ssd_net, ssd_c, 2, samples=ssd_calibration)
    ssd_each = compiled_per_forward(ssd_c, "int8", 0)
    reset_counters()
    ssd_want = ssd_c.infer_batch({SSD_INPUT: ssd_batch_x})
    got = ssd_pp.infer_batch({SSD_INPUT: ssd_batch_x})
    got_launches = pipe_counted("ssd_shapes_ms int8 pp2", ssd_each,
                                1 + walks_of(ssd_pp, BATCH))
    same_bits("ssd_shapes_ms int8 pp2", got, ssd_want)
    records = sum(len(parse_detection_records(t)) for t in got[SSD_OUTPUT].reshape(
        -1, got[SSD_OUTPUT].shape[-2], 7))
    if not records:
        raise AssertionError("4k ssd_shapes_ms int8 pp2: no records")
    log("4k ssd_shapes_ms int8 kernels pp2 " + json.dumps({
        "mesh": dict(ssd_pp.mesh.shape), "cuts": cut_nodes(ssd_pp), "rows": BATCH,
        "n_micro": ssd_pp._pick_n_micro(BATCH), "records": records, "bit_equal": True,
        "shape_stand_ins": sum(n.name.startswith("__pp_shape_") for net in ssd_pp.stages
                               for n in net.model.nodes.values()),
        "launches": got_launches, "card": smi}))

    # (d) the server over the PP2×DP2 headline
    pp = pipe_nets["pp2_dp2"]
    sizes = []
    real_batch = pp.infer_batch
    pp.infer_batch = lambda inputs, n_micro=None: (
        sizes.append(len(next(iter(inputs.values())))), real_batch(inputs, n_micro))[1]
    srv = InferenceServer(pp, buckets=(1, 2, 4, 8))
    if srv.buckets != (2, 4, 8):
        raise AssertionError(f"4k server buckets {srv.buckets}, expected (2, 4, 8)")
    reset_counters()
    srv.start(warmup=True)
    try:
        futs = [srv.submit({"data": x}) for x in u8_requests]
        answers = [f.result(timeout=300) for f in futs]
        alone = srv.infer({"data": u8_requests[0]})
    finally:
        srv.stop()
        del pp.infer_batch
    stats = srv.stats
    direct = [hl.infer({"data": x}) for x in u8_requests]
    got_launches = pipe_counted("server over pp2_dp2", hl_each,
                                sum(walks_of(pp, b) for b in sizes) + len(u8_requests))
    for i, (got, want) in enumerate(zip(answers + [alone], direct + direct[:1])):
        for k in want:
            if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
                raise AssertionError(f"4k server over pp2_dp2 request {i}: not direct "
                                     f"infer's bits")
    if stats.requests != len(u8_requests) + 1 or stats.padded_slots < 1:
        raise AssertionError(f"4k server over pp2_dp2: {stats.summary()}")
    log("4k server over pp2_dp2 " + json.dumps({
        "buckets": list(srv.buckets), "requests": stats.requests, "batches": stats.batches,
        "batch_sizes": sizes, "padded_slots": stats.padded_slots,
        "bit_equal_to_direct_infer": len(answers) + 1, "launches": got_launches,
        "card": smi}))
    # what phase 4l predicts a rank of its PP4 launches: each stage's kernels
    # a microbatch block, and the microbatches of a batch
    pp4 = pipe_nets["pp4"]
    pp4_stage_each = [in_bf16(compiled_per_forward(net, "int8", len(softmax_rows_of(net))))
                      for net in pp4.stages]
    if {k: sum(e[k] for e in pp4_stage_each) for k in COUNTERS} != hl_each:
        raise AssertionError(f"4k pp4: the stages' launches {pp4_stage_each} do not sum to "
                             f"the unsharded forward's {hl_each}")
    pp4_n_micro = pp4._pick_n_micro(BATCH)
    del pipe_nets, pp, pp4, r_pp, ssd_pp, srv
    log(f"phase 4k launches: {pipe_launches}")
    phase_done("4k pipeline")

    # -- 4l. multi-process groups: two ranks on the card ----------------------
    # ONE pair of worker processes (pyopenvino_tpu_torch/tools/mp_worker.py),
    # each a rank of a gloo group (parallel/distributed.py) that owns two
    # logical shards of this card ([cuda:n] * 2): four positions laid out
    # process-major.  Each worker reads the headline's IR behind the u8
    # PrePostProcessor, its config and the calibration images from a
    # reference file written here, must arrive at the headline's activation
    # scales, and loads the kernel libraries phase 2 built.  (a) The headline
    # at B = BATCH, BATCH / 2 rows a rank, on DP4 (data = 4 across the ranks)
    # and DP2×TP2 (data = 2 across, model = 2 inside each): each rank's rows
    # bit-equal to the unsharded network's.  (b) The headline on PP4 (two
    # stages a rank, every cut tensor of stage 1 handed to rank 1 through
    # host memory, the outputs broadcast back): both ranks' full outputs
    # bit-equal.  (c) MoE-MLP FP32 KERNELS with EP on model = 2 inside each
    # rank and data across, by phase 4j's probability gate.  (d) Here: the
    # headline's DP2×TP2 network exported and imported onto [card] * 4,
    # bit-equal at B = 1 and BATCH.  Each worker counts its own launches;
    # they are checked against a prediction made before the spawn
    # (mesh_per_forward a local block; PP4: the rank's stages' kernels ×
    # n_micro) and added to the kernels line.  Each rank's ms a batch (the
    # median of MESH_TIMED) is printed beside the unsharded network's and
    # 4j's and 4k's one-thread times of the same mesh.  (e) A data row across
    # the ranks (parallel/mesh.py's Walk on the row's gloo group): the
    # headline on TP4 and SP4 at B = BATCH, batch-1 infer on TP4, (d)'s
    # artifact imported onto TP4 at B = 1 and BATCH, every rank's full
    # outputs bit-equal to the unsharded network's, and MoE-MLP's EP on
    # model = 4 by the probability gate; each rank's launches predicted for
    # the 2 positions it owns, its all-gathers' and halo hand-offs' bytes and
    # host seconds, its ms a batch beside the one-thread TP4 (timed here
    # after the spawn) and 4j's SP4.  The two processes
    # are two CUDA contexts that the card time-slices: the phase shows the
    # group, the layout and the hand-offs, not NVLink, NCCL or several cards.
    from pyopenvino_tpu_torch.runtime.export import import_compiled
    from pyopenvino_tpu_torch.tools.mp_worker import launch, write_reference

    group_launches = dict.fromkeys(COUNTERS, 0)
    nproc, hl_xml = 2, resnet18_paths(seed=0)[0]
    per_rank = BATCH // nproc
    moe_per_rank = MESH_MOE_ROWS // nproc
    calls = 1 + MESH_TIMED
    # (e) a data row across the ranks: each rank owns 2 of its 4 positions
    tp4_each = in_bf16(mesh_per_forward(hl_plain, "int8", 1, tp=4, owned=2))
    sp4_each = in_bf16(mesh_per_forward(hl_plain, "int8", 1, sp=4, owned=2))
    moe_ep4_each = mesh_per_forward(moe, "none", moe_softmax, tp=4, owned=2)
    predicted = {
        "dp": [{k: c * 2 * calls for k, c in in_bf16(
            mesh_per_forward(hl_plain, "int8", 1)).items()}] * nproc,
        "dp_tp": [{k: c * calls for k, c in in_bf16(
            mesh_per_forward(hl_plain, "int8", 1, tp=2)).items()}] * nproc,
        "pp": [{k: sum(pp4_stage_each[s][k] for s in (2 * r, 2 * r + 1)) * pp4_n_micro * calls
                for k in COUNTERS} for r in range(nproc)],
        "moe": [{k: c * moe_per_rank for k, c in mesh_per_forward(
            moe, "none", moe_softmax, tp=2).items()}] * nproc,
        "tp4": [{k: c * calls for k, c in tp4_each.items()}] * nproc,
        "sp4": [{k: c * calls for k, c in sp4_each.items()}] * nproc,
        "moe_ep4": [{k: c * MESH_MOE_ROWS for k, c in moe_ep4_each.items()}] * nproc,
        "tp4_b1": [{k: c * calls for k, c in tp4_each.items()}] * nproc,
        "import_tp4": [tp4_each] * nproc,
        "import_tp4_b1": [tp4_each] * nproc}
    cross = ("tp4", "sp4", "moe_ep4", "tp4_b1", "import_tp4", "import_tp4_b1")
    log(f"4l predicted launches a rank: {json.dumps(predicted)}; {smi}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4l_") as mp_dir:
        # the headline's first row through infer, the batch-1 jobs' reference
        reset_counters()
        hl_b1 = hl_plain.infer({"data": u8_batch[:1]})
        phase_counted("4l", group_launches, "headline batch-1 reference", hl_each, 1)
        hl_ref, moe_ref = (os.path.join(mp_dir, f"{n}.npz") for n in ("headline", "moe"))
        write_reference(hl_ref, hl_rows, hl_want, config=hl.config, calibration=u8_calibration,
                        u8=True, act_scales=hl.act_scales, gate="exact", b1_outputs=hl_b1)
        write_reference(moe_ref, moe_rows, moe_want, config=moe.config, gate="probability",
                        rtol=E2E_RTOL, atol=E2E_ATOL)
        # (d) the DP2×TP2 headline's sharded artifact, which the ranks import
        tp_net = on_mesh(hl, MeshConfig(data=2, model=2), tensor_parallel=True)
        art = os.path.join(mp_dir, "headline_dp2_tp2.ovpt")
        tp_net.export(art)
        jobs = [[hl_xml, str(per_rank), hl_ref, *flags, "--bench", str(MESH_TIMED)]
                for flags in ([], ["--tp"], ["--pipeline"])]
        jobs.append([moe_mlp_paths()[0], str(moe_per_rank), moe_ref, "--tp"])
        timed = ["--bench", str(MESH_TIMED)]
        jobs += [[hl_xml, str(BATCH), hl_ref, "--model", "4", *timed],
                 [hl_xml, str(BATCH), hl_ref, "--spatial", "4", *timed],
                 [moe_mlp_paths()[0], str(MESH_MOE_ROWS), moe_ref, "--model", "4"],
                 [hl_xml, str(BATCH), hl_ref, "--model", "4", "--b1", *timed],
                 [art, str(BATCH), hl_ref, "--model", "4"],
                 [art, str(BATCH), hl_ref, "--model", "4", "--b1"]]
        t_spawn = time.perf_counter()
        for attempt in range(3):
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            ranks = launch(nproc, f"localhost:{port}", jobs, "cuda",
                           max(1, (os.cpu_count() or 2) // nproc), 300)
            if not any("address already in use" in r["output"].lower() for r in ranks):
                break  # else the port went to another process: another one
        spawn_s = time.perf_counter() - t_spawn
        for pid, r in enumerate(ranks):
            if r["timed_out"] or r["rc"] != 0 or f"MP_OK {pid}" not in r["output"]:
                raise AssertionError(f"4l rank {pid}: rc {r['rc']}, timed out "
                                     f"{r['timed_out']}:\n{r['output'][-6000:]}")
            if not r["group"]["prebuilt"] or len(r["jobs"]) != len(jobs):
                raise AssertionError(f"4l rank {pid}: {r['group']}, {len(r['jobs'])} jobs")
            log(f"4l rank {pid} group " + json.dumps(r["group"]))

        # the one-thread TP4 mesh ([card] * 4 in this process), timed after
        # the ranks have left the card
        t_tp4 = time.perf_counter()
        tp4_net = on_mesh(hl, MeshConfig(model=4), tensor_parallel=True)
        reset_counters()
        got = tp4_net.infer_batch(hl_rows)
        tp4_ms = batch_ms(tp4_net, hl_rows)
        phase_counted("4l", group_launches, "headline tp4 one thread",
                      in_bf16(mesh_per_forward(hl_plain, "int8", 1, tp=4)), 2 + MESH_TIMED)
        if any(not np.array_equal(got[k], hl_want[k]) for k in hl_want):
            raise AssertionError("4l headline tp4 one thread: not the unsharded network's bits")
        tp4_one_thread_s = time.perf_counter() - t_tp4
        del tp4_net
        one_thread_ms = {"dp": mesh_ms["dp4"], "dp_tp": mesh_ms["dp2_tp2"], "pp": pipe_ms["pp4"],
                         "tp4": tp4_ms, "sp4": mesh_ms["sp4"]}
        kinds = ("dp", "dp_tp", "pp", "moe") + cross
        for i, kind in enumerate(kinds):
            for pid, r in enumerate(ranks):
                job = r["jobs"][i]
                if job["launches"] != predicted[kind][pid]:
                    raise AssertionError(f"4l {job['job']} rank {pid}: launches "
                                         f"{job['launches']}, predicted {predicted[kind][pid]}")
                for k in launches:
                    launches[k] += job["launches"][k]
                    group_launches[k] += job["launches"][k]
                if kind == "pp" and (job["handoffs"]["send" if pid == 0 else "recv"]["count"],
                                     job["handoffs"]["recv" if pid == 0 else "send"]["count"]
                                     ) != (pp4_n_micro, 0):
                    raise AssertionError(f"4l pp4 rank {pid}: hand-offs {job['handoffs']}")
                if kind in ("moe", "moe_ep4") and job["expert_stacks_sharded"] != 4:
                    raise AssertionError(f"4l moe_mlp EP rank {pid}: {job}")
                if kind not in ("moe", "moe_ep4") and not job["bit_equal"]:
                    raise AssertionError(f"4l {job['job']} rank {pid}: not bit-equal")
                if kind in cross:
                    crossed = job["exchanges_checked_call"]
                    way = "halo" if kind == "sp4" else "all_gather"
                    if job["owners"] != {"0": [0, 1]} or crossed.get(way, {}).get("count", 0) < 1:
                        raise AssertionError(f"4l {job['job']} rank {pid}: the row does not "
                                             f"span the ranks: {job['owners']}, {crossed}")
                log(f"4l {kind} rank {pid} " + json.dumps({
                    **{k: job[k] for k in ("job", "mesh", "rows", "gate", "bit_equal",
                                           "max_abs_err", "launches", "ms_batch_median",
                                           "ms_batches", "s")},
                    **({k: job[k] for k in ("handoffs", "handoffs_timed")}
                       if kind == "pp" else {}),
                    **({k: job[k] for k in ("owners", "lead", "exchanges_checked_call",
                                            "exchanges_timed") if k in job}
                       if kind in cross else {}),
                    **({"ms_batch_unsharded": plain_ms,
                        "ms_one_thread_same_mesh": one_thread_ms[kind],
                        "over_unsharded": job["ms_batch_median"] / plain_ms,
                        "over_one_thread": job["ms_batch_median"] / one_thread_ms[kind]}
                       if kind in one_thread_ms else {}),
                    "card": smi, "note": "two processes share one card"}))
        added = {kind: ranks[0]["jobs"][len(kinds) - len(cross) + i]["s"]
                 for i, kind in enumerate(cross)}
        log("4l rows across the ranks: seconds added " + json.dumps({
            "jobs_rank0": added, "one_thread_tp4": tp4_one_thread_s,
            "total": sum(added.values()) + tp4_one_thread_s}))

        # (d) the sharded artifact imported here onto [card] * 4
        imp = import_compiled(art, device=card, devices=[card] * 4)
        if dict(imp.mesh.shape) != dict(tp_net.mesh.shape) or imp.network._w_specs != \
                tp_net._w_specs:
            raise AssertionError(f"4l import: mesh {imp.mesh}, not the exporter's")
        each_tp = in_bf16(mesh_per_forward(hl_plain, "int8", 1, tp=2))
        one = {"data": u8_requests[0]}
        reset_counters()
        got_one, want_one = imp.infer(one), tp_net.infer(one)
        got_rows = imp.infer_batch(hl_rows)
        phase_counted("4l", group_launches, "sharded import", each_tp, 2 + 2)
        for label, got, want in (("B = 1", got_one, want_one),
                                 (f"B = {BATCH}", got_rows, hl_want)):
            for k in want:
                if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"4l sharded import {label}: {k} is not the "
                                         f"exporter's bits")
        log("4l sharded import " + json.dumps({
            "mesh": dict(imp.mesh.shape), "artifact_bytes": os.path.getsize(art),
            "sharded_weights": sum("model" in spec for spec in imp.network._w_specs.values()),
            "bit_equal_b1": True, "bit_equal_rows": BATCH, "card": smi}))
    del tp_net, imp
    log(f"4l spawn {spawn_s:.2f} s (two ranks: start, group, ten jobs, exit)")
    log(f"phase 4l launches: {group_launches}")
    phase_done("4l multi-process groups")

    # -- 5. times ------------------------------------------------------------
    # the timed operands are drawn on the card from a seed: their values do
    # not move a time, and host draws of the batch-64 operands (up to 10^8
    # values) took more of the phase than the timing
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rand(shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, device=dev)
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    per_shape = {name: [] for name in (*launches, "conv2d_direct_f32_i8w",
                                       "conv2d_direct_float_bf16_i8w")}

    def timings(kernel, plain, library, iters):
        return {"ms": device_ms(torch, kernel, iters),
                "plain_ms": device_ms(torch, plain, iters),
                "library_ms": device_ms(torch, library, iters),
                "eager_ms": eager_ms(torch, kernel, EAGER_CALLS * iters)}

    def add_row(name, row, log_name=None):
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        per_shape[name].append(row)
        log(f"time {log_name or name} " + json.dumps(row))

    def direct_loops(x, wt, scale, bias, pads, wmat, out_dtype, iters):
        """#3's or #3-bf16's two loops at one conv: the route's choice, each
        loop forced (wgmma_ms None where i8_wgmma.cuh does not take the
        conv), the wgmma loop's plan."""
        n, h, w, ci = x.shape
        co, _, kh, kw = wt.shape
        m = n * (h + sum(pads[0]) - kh + 1) * (w + sum(pads[1]) - kw + 1)
        takes = direct_takes(ci, co, kh, kw, pads, x.data_ptr(), wmat.data_ptr(), out_dtype)
        run = lambda loop: lambda: conv2d_direct(  # noqa: E731
            x, wt, scale, bias, None, pads, wmat=wmat, out_dtype=out_dtype, conv_loop=loop)
        plan = (direct_plan(m, kh * kw * ci, ci, co, 2 if out_dtype == bf16 else 4, sms)
                if takes else None)
        return {"route": "wgmma" if direct_route(n, h, w, ci, co, kh, kw, pads, x.data_ptr(),
                                                 wmat.data_ptr(), out_dtype, sms) else "mma",
                "wgmma_ms": device_ms(torch, run("wgmma"), iters) if takes else None,
                "mma_ms": device_ms(torch, run("mma"), iters),
                "mma_eager_ms": eager_ms(torch, run("mma"), EAGER_CALLS * iters),
                "wgmma_plan": plan._asdict() if plan else None}

    def float_bf16_loops(x, wt, scale, bias, pads, iters):
        """3f-bf16's two loops at one conv, each with the weight matrix it
        reads cached (the K-major one for the wgmma loop, the row-major one
        for the mma.sync loop): the route's choice and its call (``run``,
        for the row's ms), each loop forced (wgmma_ms None where the wgmma
        loop does not take the conv), the mma.sync loop's issue time, the
        wgmma loop's plan."""
        n, h, w, ci = x.shape
        co, _, kh, kw = wt.shape
        m = n * (h + sum(pads[0]) - kh + 1) * (w + sum(pads[1]) - kw + 1)
        wk, wr = conv_weight_matrix_nk(wt).t(), conv_weight_matrix(wt)
        takes = direct_takes(ci, co, kh, kw, pads, x.data_ptr(), wk.data_ptr(), bf16, 2)
        route = direct_bf16_route(n, h, w, ci, co, kh, kw, pads, x.data_ptr(), wk.data_ptr(),
                                  sms)
        run = lambda loop, wmat: lambda: conv2d_direct(  # noqa: E731
            x, wt, scale, bias, None, pads, wmat=wmat, conv_loop=loop)
        plan = direct_bf16_plan(m, kh * kw * ci, ci, co, sms) if takes else None
        # the bytes the wgmma loop's TMA loads bring into shared memory
        # (L2 hits but the first): each 128 x bn tile's groups of 128 bytes
        # of k, A's 128 rows and B's bn (an int8 weight's codes: half)
        loads = (None if plan is None else -(-m // 128) * -(-co // plan.bn)
                 * -(-2 * kh * kw * ci // 128)
                 * (128 + plan.bn * wt.element_size() // 2) * 128)
        return run(None, wk if route is not None else wr), {
            "wgmma_load_bytes": loads,
            "route": "wgmma" if route is not None else "mma",
            "wgmma_ms": device_ms(torch, run("wgmma", wk), iters) if takes else None,
            "mma_ms": device_ms(torch, run("mma", wr), iters),
            "mma_eager_ms": eager_ms(torch, run("mma", wr), EAGER_CALLS * iters),
            "wgmma_plan": plan._asdict() if plan else None,
            "mma_splits": -(-kh * kw * ci // split_k(m, kh * kw * ci, co,
                                                      PLANS["conv2d_direct_bf16"], sms))}

    def i8_loops(a, w, scale, bias, out_dtype, iters):
        """#1ii's or #1ii-bf16's two loops at one shape: the route's choice,
        each loop forced (wgmma_ms None where i8_wgmma.cuh does not take the
        launch), the wgmma loop's plan and, where the route takes that loop,
        the other plans' times (``i8_plan_ms``)."""
        m, k = a.shape
        n = w.shape[1]
        bf = out_dtype == bf16
        takes = i8_takes(k, n, k, a.data_ptr(), w.data_ptr(), 0, bf)
        routed = i8_route(m, k, n, k, a.data_ptr(), w.data_ptr(), 0, bf, sms) is not None
        run = lambda loop: lambda: fused_gemm(  # noqa: E731
            a, w, scale, bias, out_dtype=out_dtype, i8_loop=loop)
        plan = i8_plan(m, k, n, 2 if bf else 4, sms) if takes else None
        return {"route": "wgmma" if routed else "mma",
                "wgmma_ms": device_ms(torch, run("wgmma"), iters) if takes else None,
                "mma_ms": device_ms(torch, run("mma"), iters),
                "mma_eager_ms": eager_ms(torch, run("mma"), EAGER_CALLS * iters),
                "wgmma_plan": plan._asdict() if plan else None}

    def f32_loops(a, w, scale, bias, iters):
        """#1's or #1w's two loops at one shape: the route's choice, each
        loop forced (wgmma_ms None where f32_wgmma.cuh does not take the
        launch), the wgmma loop's plan and, where the route takes that loop,
        the other plans' times (``f32_plan_ms``)."""
        m, k = a.shape
        n = w.shape[1]
        b_int8 = w.dtype == torch.int8
        takes = f32_takes(k, n, k, a.data_ptr(), w.data_ptr(), 0, b_int8)
        routed = f32_route(m, k, n, k, a.data_ptr(), w.data_ptr(), 0, b_int8, sms) is not None
        run = lambda loop: lambda: fused_gemm(a, w, scale, bias, f32_loop=loop)  # noqa: E731
        plan = f32_plan(m, k, n, b_int8, sms) if takes else None
        return {"route": "wgmma" if routed else "mma",
                "wgmma_ms": device_ms(torch, run("wgmma"), iters) if takes else None,
                "mma_ms": device_ms(torch, run("mma"), iters),
                "mma_eager_ms": eager_ms(torch, run("mma"), EAGER_CALLS * iters),
                "wgmma_plan": plan._asdict() if plan else None}

    def time_gemm(name, model, b, m, k, n, count):
        """One fused_gemm variant at (M, K, N): kernel, plain version and
        library call, with its bound."""
        padded = None
        extra = {}
        if name == "fused_gemm_i8i8":
            a, w = rand_int8((m, k)), rand_int8((n, k)).t()
            scale, bias = rand((n,), 1e-4, 1e-2), rand((n,))
            a_lib, w_lib, padded = int_mm_operands(torch, a, w)
            library = lambda: torch._int_mm(a_lib, w_lib)  # noqa: E731
            bms, by = bound(2.0 * m * n * k, i8_bytes(m, k, n), PEAK_INT8_OPS)
        else:
            a, bias = rand((m, k)), rand((n,))
            if name == "fused_gemm":
                w, scale = rand((k, n)), None
            else:
                w, scale = rand_int8((k, n)), rand((n,), 0.001, 0.02)
            # no single PyTorch call takes f32 x int8: the yardstick is
            # addmm on the weight dequantized here, outside the timing
            w_lib = w if scale is None else w.float() * scale
            library = lambda: torch.addmm(bias, a, w_lib)  # noqa: E731
            # the card's floor for a float32-accurate product: three bf16
            # passes (an int8 code, and each bf16 third of a float32's 24
            # bits, is exact in bf16); the floors of the kernel's own route
            # (TF32 passes: three for a float32 B, two for an int8 B) and of
            # float32 FFMA beside it
            nbytes = gemm_bytes(m, k, n, name == "fused_gemm_i8w")
            passes = 2 if name == "fused_gemm_i8w" else 3
            extra["bound_ffma_ms"] = bound(2.0 * m * n * k, nbytes)[0]
            extra[f"bound_tf32x{passes}_ms"] = bound(
                passes * 2.0 * m * n * k, nbytes, PEAK_TF32_FLOPS)[0]
            bms, by = bound(3 * 2.0 * m * n * k, nbytes, PEAK_BF16_FLOPS)
        row = {"model": model, "batch": b, "M": m, "K": k, "N": n,
               **timings(lambda: fused_gemm(a, w, scale, bias),
                         lambda: fused_gemm_plain(a, w, scale, bias), library, 20)}
        if name == "fused_gemm_i8i8":
            row["library_padded_to"] = padded
            row.update(i8_loops(a, w, scale, bias, torch.float32, 20))
        else:
            row.update(f32_loops(a, w, scale, bias, 20))
        add_row(name, {**row, "bound_ms": bms, "bound_by": by, **extra,
                       "launches_per_forward": count})

    for b in (1, BATCH):
        for model, gemms in GEMMS.items():
            for m, k, n, count in gemms(b):
                for name in ("fused_gemm", "fused_gemm_i8w"):
                    time_gemm(name, model, b, m, k, n, count)
        for model in I8I8_GEMMS:
            for m, k, n, count in i8i8_gemms(model, b):
                time_gemm("fused_gemm_i8i8", model, b, m, k, n, count)
        for model, table in net_gemms.items():
            rows_m, rows_n = batch_rows(model, b)
            for name, shapes in table.items():
                if name == "conv2d_direct":
                    continue  # timed below, from net_direct
                for m, k, n, count in shapes:
                    time_gemm(name, model, b, m * rows_m, k, n, count * rows_n)
        for model, h, w, ci, co, kh, kw, pads, count in (
                [("resnet18", hw, hw, c, c, 3, 3, ((1, 1), (1, 1)), count)
                 for hw, c, count in RESNET18_DIRECT]
                + [(model, *conv) for model, convs in net_direct.items() for conv in convs]):
            (pt, pb), (pl, pr) = pads
            if (pt, pl) != (pb, pr) or (pt + pb, pl + pr) != (kh - 1, kw - 1):
                raise AssertionError(f"{model}: conv2d_direct at {pads} pads for a {kh}x{kw} "
                                     f"kernel: the timing assumes same-size outputs")
            x, wt = rand_int8((b, h, w, ci)), rand_int8((co, ci, kh, kw))
            scale, bias = rand((co,), 1e-4, 1e-2), rand((co,))
            wmat = conv_weight_matrix_nk(wt).t()  # cached by the network
            # no PyTorch call runs an int8 conv on CUDA: the yardstick is
            # cuDNN's float32 conv (TF32 off) on the codes converted here,
            # and beside it cuDNN's bf16 conv on them (exact products, a
            # float32 sum), which the float32 one flatters the kernel against
            xf = x.permute(0, 3, 1, 2).float()
            wf = wt.float().contiguous(memory_format=torch.channels_last)
            xb, wb = xf.to(bf16), wf.to(bf16)
            k = kh * kw * ci
            bms, by = bound(2.0 * b * h * w * co * k,
                            direct_bytes(b, h, w, ci, co, kh, kw), PEAK_INT8_OPS)
            add_row("conv2d_direct", {
                "model": model, "batch": b, "H": h, "W": w, "Ci": ci, "Co": co,
                "kernel": f"{kh}x{kw}", "splits": -(-k // split_k(
                    b * h * w, k, co, PLANS["conv2d_direct"], sms)), **timings(
                    lambda: conv2d_direct(x, wt, scale, bias, None, pads, wmat=wmat),
                    lambda: conv2d_direct_plain(x, wt, scale, bias, None, pads),
                    lambda: torch.nn.functional.conv2d(xf, wf, padding=(pt, pl)), 20),
                # with the wrapper building the K-major weight matrix on
                # each call, for a caller that caches none
                "ms_with_weight_copy": device_ms(
                    torch, lambda: conv2d_direct(x, wt, scale, bias, None, pads), 20),
                "library_bf16_ms": device_ms(torch, lambda: torch.nn.functional.conv2d(
                    xb, wb, padding=(pt, pl)), 20),
                **direct_loops(x, wt, scale, bias, pads, wmat, torch.float32, 20),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": count})
        for model, n in (*((m, 1000) for m in GEMMS), ("efficientnet_b0", 1000),
                         ("googlenet_shapes", 10), ("shufflenet_v2", 1000),
                         ("resnet18_pot", 1000)):
            x = rand((b, n)) * 30
            bms, by = bound(5.0 * b * n, 8.0 * b * n)
            add_row("softmax_rows", {
                "model": model, "batch": b, "M": b, "N": n, **timings(
                    lambda: softmax_rows(x), lambda: softmax_rows_plain(x),
                    lambda: torch.softmax(x, dim=1), 50),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": 1})
        for model, n, count in family_softmax:
            rows_m, rows_n = batch_rows(model, b)
            x = rand((rows_m, n)) * 30
            bms, by = bound(5.0 * rows_m * n, 8.0 * rows_m * n)
            add_row("softmax_rows", {
                "model": model, "batch": b, "M": rows_m, "N": n, **timings(
                    lambda: softmax_rows(x), lambda: softmax_rows_plain(x),
                    lambda: torch.softmax(x, dim=1), 50),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": count * rows_n})
        # kernel 3f at ResNet-18's stride-1 3×3 shapes (no path routes a
        # float conv through it: "if_routed" weighs a forward's sum), with a
        # float32 weight, then with an int8 one (rows of its own, logged as
        # conv2d_direct_f32_i8w, against F.conv2d on the weight dequantized
        # beforehand); the bound on #1's basis, three bf16 passes
        for hw, c, count in RESNET18_DIRECT:
            x, bias, pads = rand((b, hw, hw, c)), rand((c,)), ((1, 1), (1, 1))
            xf = x.permute(0, 3, 1, 2)
            ops = 2.0 * b * hw * hw * c * 9 * c
            for name, wt, scale, passes in (
                    ("conv2d_direct_f32", rand((c, c, 3, 3)), None, 3),
                    ("conv2d_direct_f32_i8w", rand_int8((c, c, 3, 3)),
                     rand((c,), 1e-3, 1e-2), 2)):
                w_lib = wt if scale is None else wt.float() * scale.reshape(-1, 1, 1, 1)
                nbytes = direct_f32_bytes(b, hw, hw, c, c, 3, 3, wt.element_size())
                splits = -(-9 * c // split_k(b * hw * hw, 9 * c, c,
                                             PLANS["conv2d_direct_f32"], sms))
                add_row(name, {
                    "model": "resnet18", "batch": b, "H": hw, "W": hw, "Ci": c, "Co": c,
                    "kernel": "3x3", "weight": str(wt.dtype), "splits": splits, **timings(
                        lambda: conv2d_direct(x, wt, scale, bias, None, pads),
                        lambda: conv2d_direct_plain(x, wt, scale, bias, None, pads),
                        lambda: torch.nn.functional.conv2d(xf, w_lib, bias, padding=1), 20),
                    "bound_ms": bound(3 * ops, nbytes, PEAK_BF16_FLOPS)[0],
                    "bound_by": bound(3 * ops, nbytes, PEAK_BF16_FLOPS)[1],
                    f"bound_tf32x{passes}_ms": bound(passes * ops, nbytes, PEAK_TF32_FLOPS)[0],
                    "bound_ffma_ms": bound(ops, nbytes)[0],
                    "launches_per_forward": 0, "if_routed": count}, name)
        # kernel 4 at SSD's pairs and the published ones, with the K-major
        # pointwise weight cached as a network would (the per-call copy and
        # the other tile height beside); the library pair is cuDNN's grouped
        # conv on the codes in float32, then torch._int_mm
        for h, w, c, co, count in ssd_pairs + [p + (0,) for p in microbench_dw_pw.PUBLISHED]:
            args = microbench_dw_pw.make_inputs(b, h, w, c, co, seed=1)
            kw = dict(dw_act=relu6, pw_act=relu6, s_mid=0.05, s_out=0.04)
            wmat = args[4].t().contiguous().t()
            xf = args[0].permute(0, 3, 1, 2).float()
            wdw_f = args[1].t().reshape(c, 1, 3, 3).float().contiguous()
            q_lib, w_lib, padded = int_mm_operands(
                torch, rand_int8((b * h * w, c)), args[4])
            bms, by = microbench_dw_pw.dw_pw_bound(b, h, w, c, co, 1)
            clocks = torch.zeros(2, dtype=torch.int64, device=dev)
            dw_pw_fused(*args, wmat=wmat, clocks=clocks, **kw)
            dw_clocks, pw_clocks = clocks.tolist()
            add_row("dw_pw_fused", {
                "model": "ssd_shapes_ms" if count else "published", "batch": b,
                "H": h, "W": w, "C": c, "Co": co, **timings(
                    lambda: dw_pw_fused(*args, wmat=wmat, **kw),
                    lambda: dw_pw_fused_plain(*args, **kw),
                    lambda: (torch.nn.functional.conv2d(xf, wdw_f, padding=1, groups=c),
                             torch._int_mm(q_lib, w_lib)), 10),
                **{f"ms_tile_rows_{rows}": device_ms(
                    torch, lambda: dw_pw_fused(*args, wmat=wmat, tile_rows=rows, **kw), 10)
                   for rows in DW_PW_TILE_ROWS},
                "ms_with_weight_copy": device_ms(torch, lambda: dw_pw_fused(*args, **kw), 10),
                "tile_rows": pick_tile_rows(b * h * w, c, 0),
                "co_split": dw_pw_co_split(b * h * w, co, pick_tile_rows(b * h * w, c, 0), 0),
                "depthwise_clock_share": dw_clocks / (dw_clocks + pw_clocks),
                "library_padded_to": padded, "bound_ms": bms, "bound_by": by,
                "launches_per_forward": 0, "if_routed": count})
    # the bfloat16 variants at ResNet-18's and MobileNet-v2's path shapes (B =
    # 1 and 64; ResNet-18's INT8-FULL ones also at the headline's 512), with
    # cuBLAS's bfloat16 addmm, torch._int_mm, cuDNN's bfloat16 conv and
    # torch.softmax as the library calls; bounds at the bf16 (989e12) or int8
    # (1979e12) tensor-core peak, with 2-byte activations in and out and the
    # float32 scale and bias the kernels read
    def time_bf16_gemm(name, model, b, m, k, n, count):
        """#1b or #1bw at (M, K, N): the routed call (ms), each loop forced
        (wgmma_ms, mma_ms), the plain version and cuBLAS's bf16 addmm on the
        weight dequantized beforehand, with the bound.  scale and bias are
        float32, what the kernels read (a bfloat16 one costs a cast launch
        per call, in the wrapper)."""
        a, bias = rand((m, k)).to(bf16), rand((n,))
        w, scale = ((rand((k, n)).to(bf16), None) if name == "fused_gemm_bf16" else
                    (rand_int8((k, n)), rand((n,), 0.001, 0.02)))
        w_lib, bias_lib = (w if scale is None else (w * scale).to(bf16)), bias.to(bf16)
        nbytes = (2.0 * m * k + w.element_size() * k * n + 2.0 * m * n
                  + (8.0 if scale is not None else 4.0) * n)
        bms, by = bound(2.0 * m * n * k, nbytes, PEAK_BF16_FLOPS)
        plan = (wgmma_plan(m, k, n, scale is not None, sms) if wgmma_aligned(
            k, n, k, a.data_ptr(), w.data_ptr(), scale is not None) else None)
        routed = bf16_route(m, k, n, k, a.data_ptr(), w.data_ptr(), scale is not None,
                            sms) is not None
        add_row(name, {
            "model": model, "batch": b, "M": m, "K": k, "N": n,
            **timings(lambda: fused_gemm(a, w, scale, bias),
                      lambda: fused_gemm_plain(a, w, scale, bias),
                      lambda: torch.addmm(bias_lib, a, w_lib), 20),
            "route": "wgmma" if routed else "mma",
            "wgmma_ms": (device_ms(torch, lambda: fused_gemm(a, w, scale, bias, bf16_loop="wgmma"),
                                   20) if plan else None),
            "mma_ms": device_ms(torch, lambda: fused_gemm(a, w, scale, bias, bf16_loop="mma"), 20),
            "mma_eager_ms": eager_ms(torch, lambda: fused_gemm(a, w, scale, bias,
                                                                bf16_loop="mma"),
                                     EAGER_CALLS * 20),
            "wgmma_plan": plan._asdict() if plan else None,
            "bound_ms": bms, "bound_by": by, "launches_per_forward": count})

    for model, gemms in GEMMS.items():
        for b in (1, BATCH):
            for m, k, n, count in gemms(b):
                for name in ("fused_gemm_bf16", "fused_gemm_bf16_i8w"):
                    time_bf16_gemm(name, model, b, m, k, n, count)
    for model in I8I8_GEMMS:
        for b in bf16_batches(model):
            for m, k, n, count in i8i8_gemms(model, b):
                a, w = rand_int8((m, k)), rand_int8((n, k)).t()
                scale, bias = rand((n,), 1e-4, 1e-2), rand((n,)).to(bf16)
                a_lib, w_lib, padded = int_mm_operands(torch, a, w)
                bms, by = bound(2.0 * m * n * k, m * k + k * n + 8.0 * n + 2.0 * m * n,
                                PEAK_INT8_OPS)
                add_row("fused_gemm_i8i8_bf16", {
                    "model": model, "batch": b, "M": m, "K": k, "N": n, **timings(
                        lambda: fused_gemm(a, w, scale, bias, out_dtype=bf16),
                        lambda: fused_gemm_plain(a, w, scale, bias, out_dtype=bf16),
                        lambda: torch._int_mm(a_lib, w_lib), 20 if b <= BATCH else 3),
                    **i8_loops(a, w, scale, bias, bf16, 20 if b <= BATCH else 3),
                    "library_padded_to": padded, "bound_ms": bms, "bound_by": by,
                    "launches_per_forward": count})
    for b in bf16_batches("resnet18"):
        for hw, c, count in RESNET18_DIRECT:
            x, wt, pads = rand_int8((b, hw, hw, c)), rand_int8((c, c, 3, 3)), ((1, 1), (1, 1))
            scale, bias = rand((c,), 1e-4, 1e-2), rand((c,)).to(bf16)
            wmat = conv_weight_matrix_nk(wt).t()
            xb = x.permute(0, 3, 1, 2).to(bf16)
            wb = wt.to(bf16).contiguous(memory_format=torch.channels_last)
            bms, by = bound(2.0 * b * hw * hw * c * 9 * c,
                            b * hw * hw * c + 9 * c * c + 8.0 * c + 2.0 * b * hw * hw * c,
                            PEAK_INT8_OPS)
            add_row("conv2d_direct_bf16", {
                "model": "resnet18", "batch": b, "H": hw, "W": hw, "Ci": c, "Co": c,
                "kernel": "3x3", **timings(
                    lambda: conv2d_direct(x, wt, scale, bias, None, pads, wmat=wmat,
                                          out_dtype=bf16),
                    lambda: conv2d_direct_plain(x, wt, scale, bias, None, pads, bf16),
                    lambda: torch.nn.functional.conv2d(xb, wb, padding=1),
                    20 if b <= BATCH else 3),
                **direct_loops(x, wt, scale, bias, pads, wmat, bf16, 20 if b <= BATCH else 3),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": count})
    for model in GEMMS:
        for b in bf16_batches(model):
            x = (rand((b, 1000)) * 30).to(bf16)
            bms, by = bound(5.0 * b * 1000, 4.0 * b * 1000)
            add_row("softmax_rows_bf16", {
                "model": model, "batch": b, "M": b, "N": 1000, **timings(
                    lambda: softmax_rows(x), lambda: softmax_rows_plain(x),
                    lambda: torch.softmax(x, dim=1), 50),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": 1})
    # the bf16 variants at the shapes of SSD, EfficientNet-B0,
    # googlenet_shapes, ShuffleNet-v2 and resnet18_pot (their compiled
    # networks' launches) at B = 64 (#1b and #1bw also at B = 1), with the
    # same library calls and bounds
    for model, table in net_gemms.items():
        for name, shapes in table.items():
            if name == "conv2d_direct":
                continue  # timed below, from net_direct
            rows_m, rows_n = batch_rows(model, BATCH)
            for m, k, n, count in shapes:
                m, count = m * rows_m, count * rows_n
                if name == "fused_gemm_i8i8":
                    a, w = rand_int8((m, k)), rand_int8((n, k)).t()
                    scale, bias = rand((n,), 1e-4, 1e-2), rand((n,)).to(bf16)
                    a_lib, w_lib, padded = int_mm_operands(torch, a, w)
                    bms, by = bound(2.0 * m * n * k, m * k + k * n + 8.0 * n + 2.0 * m * n,
                                    PEAK_INT8_OPS)
                    add_row("fused_gemm_i8i8_bf16", {
                        "model": model, "batch": BATCH, "M": m, "K": k, "N": n, **timings(
                            lambda: fused_gemm(a, w, scale, bias, out_dtype=bf16),
                            lambda: fused_gemm_plain(a, w, scale, bias, out_dtype=bf16),
                            lambda: torch._int_mm(a_lib, w_lib), 20),
                        **i8_loops(a, w, scale, bias, bf16, 20),
                        "library_padded_to": padded, "bound_ms": bms, "bound_by": by,
                        "launches_per_forward": count})
                    continue
                for b in (1, BATCH):  # #1b and #1bw at batch 1 too
                    time_bf16_gemm(BF16_VARIANT[name], model, b, m // rows_m * batch_rows(
                        model, b)[0], k, n, count // rows_n * batch_rows(model, b)[1])
    for model, convs in net_direct.items():
        for h, w, ci, co, kh, kw, pads, count in convs:
            x, wt = rand_int8((BATCH, h, w, ci)), rand_int8((co, ci, kh, kw))
            scale, bias = rand((co,), 1e-4, 1e-2), rand((co,)).to(bf16)
            wmat = conv_weight_matrix_nk(wt).t()
            xb = x.permute(0, 3, 1, 2).to(bf16)
            wb = wt.to(bf16).contiguous(memory_format=torch.channels_last)
            bms, by = bound(2.0 * BATCH * h * w * co * kh * kw * ci,
                            BATCH * h * w * ci + kh * kw * ci * co + 8.0 * co
                            + 2.0 * BATCH * h * w * co, PEAK_INT8_OPS)
            add_row("conv2d_direct_bf16", {
                "model": model, "batch": BATCH, "H": h, "W": w, "Ci": ci, "Co": co,
                "kernel": f"{kh}x{kw}", **timings(
                    lambda: conv2d_direct(x, wt, scale, bias, None, pads, wmat=wmat,
                                          out_dtype=bf16),
                    lambda: conv2d_direct_plain(x, wt, scale, bias, None, pads, bf16),
                    lambda: torch.nn.functional.conv2d(xb, wb, padding=(pads[0][0],
                                                                        pads[1][0])), 20),
                **direct_loops(x, wt, scale, bias, pads, wmat, bf16, 20),
                "bound_ms": bms, "bound_by": by, "launches_per_forward": count})
    for model, n, count in (("efficientnet_b0", 1000, 1), ("googlenet_shapes", 10, 1),
                            ("shufflenet_v2", 1000, 1), ("resnet18_pot", 1000, 1),
                            *family_softmax):
        rows_m, rows_n = batch_rows(model, BATCH)
        x = (rand((rows_m, n)) * 30).to(bf16)
        bms, by = bound(5.0 * rows_m * n, 4.0 * rows_m * n)
        add_row("softmax_rows_bf16", {
            "model": model, "batch": BATCH, "M": rows_m, "N": n, **timings(
                lambda: softmax_rows(x), lambda: softmax_rows_plain(x),
                lambda: torch.softmax(x, dim=1), 50),
            "bound_ms": bms, "bound_by": by, "launches_per_forward": count * rows_n})
    # kernel 3f-bf16 at ResNet-18's stride-1 3×3 shapes, "if_routed" as 3f:
    # a bfloat16 weight, then an int8 one (rows logged as
    # conv2d_direct_float_bf16_i8w, against cuDNN's bf16 conv on the weight
    # dequantized to bfloat16 beforehand); one bf16 pass, bound at 989e12
    # with 2-byte activations in and out.  Each row's ms is the routed call
    # with the weight matrix of its loop cached (as #3's rows), beside both
    # loops forced (float_bf16_loops)
    for b in (1, BATCH):
        for hw, c, count in RESNET18_DIRECT:
            x, bias, pads = rand((b, hw, hw, c)).to(bf16), rand((c,)), ((1, 1), (1, 1))
            xb = x.permute(0, 3, 1, 2)
            ops = 2.0 * b * hw * hw * c * 9 * c
            for name, wt, scale in (
                    ("conv2d_direct_float_bf16", rand((c, c, 3, 3)).to(bf16), None),
                    ("conv2d_direct_float_bf16_i8w", rand_int8((c, c, 3, 3)),
                     rand((c,), 1e-3, 1e-2))):
                w_lib = (wt if scale is None else
                         (wt.float() * scale.reshape(-1, 1, 1, 1)).to(bf16)).contiguous(
                             memory_format=torch.channels_last)
                b_lib = bias.to(bf16)
                nbytes = (2.0 * b * hw * hw * c * 2 + wt.element_size() * 9 * c * c
                          + (8.0 if scale is not None else 4.0) * c)
                bms, by = bound(ops, nbytes, PEAK_BF16_FLOPS)
                routed, loops_row = float_bf16_loops(x, wt, scale, bias, pads, 20)
                add_row(name, {
                    "model": "resnet18", "batch": b, "H": hw, "W": hw, "Ci": c, "Co": c,
                    "kernel": "3x3", "weight": str(wt.dtype),
                    **timings(routed,
                              lambda: conv2d_direct_plain(x, wt, scale, bias, None, pads),
                              lambda: torch.nn.functional.conv2d(xb, w_lib, b_lib, padding=1),
                              20),
                    "uncached_ms": device_ms(torch, lambda: conv2d_direct(
                        x, wt, scale, bias, None, pads), 20),
                    **loops_row, "bound_ms": bms, "bound_by": by, "launches_per_forward": 0,
                    "if_routed": count}, name)
    # kernel 4-bf16 at SSD's pairs and the published ones, as #4 (the K-major
    # pointwise weight cached); the library chain: cuDNN's grouped conv on
    # the codes in float32, torch._int_mm, then the epilogue to bfloat16
    for b in (1, BATCH):
        for h, w, c, co, count in ssd_pairs + [p + (0,) for p in microbench_dw_pw.PUBLISHED]:
            args = microbench_dw_pw.make_inputs(b, h, w, c, co, seed=2)
            kw = dict(dw_act=relu6, pw_act=None, s_mid=0.05, out_dtype=bf16)
            wmat = args[4].t().contiguous().t()
            xf = args[0].permute(0, 3, 1, 2).float()
            wdw_f = args[1].t().reshape(c, 1, 3, 3).float().contiguous()
            q_lib, w_lib, padded = int_mm_operands(torch, rand_int8((b * h * w, c)), args[4])
            pws, pwb = args[5], args[6]
            bms, by = microbench_dw_pw.dw_pw_bound(b, h, w, c, co, 2)
            add_row("dw_pw_fused_bf16", {
                "model": "ssd_shapes_ms" if count else "published", "batch": b,
                "H": h, "W": w, "C": c, "Co": co, **timings(
                    lambda: dw_pw_fused(*args, wmat=wmat, **kw),
                    lambda: dw_pw_fused_plain(*args, **kw),
                    lambda: (torch.nn.functional.conv2d(xf, wdw_f, padding=1, groups=c),
                             (torch._int_mm(q_lib, w_lib)[:, :co].float() * pws
                              + pwb).to(bf16)), 10),
                "tile_rows": pick_tile_rows(b * h * w, c, 0),
                "library_padded_to": padded, "bound_ms": bms, "bound_by": by,
                "launches_per_forward": 0, "if_routed": count})
    # the card's launch floor: one one-element PyTorch op per launch, in the
    # same CUDA-graph harness as the kernels' times
    one = torch.zeros(1, device=dev)
    launch_floor_ms = device_ms(torch, lambda: one.add_(1.0), 50)
    log(f"launch_floor {json.dumps({'ms': launch_floor_ms, 'op': 'add_ on 1 float32'})}")
    # the card's L2 rate as a copy sees it: 16 MiB copied within the 50 MB
    # L2 (read and written), in the same harness; the wgmma loops' tiles
    # re-read A and B from L2 (3f-bf16 rows' wgmma_load_bytes)
    l2_src = torch.zeros(4 << 20, device=dev)
    l2_dst = torch.empty_like(l2_src)
    l2_ms = device_ms(torch, lambda: l2_dst.copy_(l2_src), 50)
    log("l2_copy " + json.dumps({"ms": l2_ms, "bytes": 2 * l2_src.numel() * 4,
                                 "tb_per_s": 2 * l2_src.numel() * 4 / l2_ms / 1e9}))
    del l2_src, l2_dst
    # each kernel's sums over one forward of each model, by batch
    for name, rows in per_shape.items():
        sums = {}
        for r in rows:
            weight = r["launches_per_forward"] or r.get("if_routed", 0)
            total = sums.setdefault((r["model"], r["batch"]), collections.Counter())
            for key in ("ms", "plain_ms", "library_ms", "bound_ms", "mma_ms", "wgmma_ms"):
                if key in r:
                    # a shape the wgmma loop does not take counts its
                    # routed (mma.sync) time there
                    total[key] += (r[key] if r[key] is not None else r["ms"]) * weight
        for (model, b), total in sums.items():
            log(f"forward {name} {model} B={b} " + json.dumps(dict(total)))
    def byte_path(model, k, n):
        """An int8 × int8 stem at B = 64: rows that are not 4-byte aligned
        take the byte path; the same rows 16-byte aligned (lda padded, the
        same K) take cp.async; the pad copy is what aligning them upstream
        would cost."""
        m, kp = 12544 * BATCH, -(-k // 16) * 16
        tight, aligned = rand_int8((m, k)), rand_int8((m, kp))[:, :k]
        w, scale, bias = rand_int8((n, k)).t(), rand((n,), 1e-4, 1e-2), rand((n,))
        return {
            "model": model, "M": m, "K": k, "N": n, "lda_aligned": kp,
            "ms_byte_path": device_ms(torch, lambda: fused_gemm(tight, w, scale, bias), 20),
            "ms_aligned_rows": device_ms(torch, lambda: fused_gemm(aligned, w, scale, bias), 20),
            "ms_pad_copy": device_ms(
                torch, lambda: torch.nn.functional.pad(tight, (0, kp - k)), 20),
            "pad_copy_bound_ms": (m * k + m * kp) / PEAK_BYTES * 1e3}

    for model, k, n in (("resnet18", 147, 64), ("mobilenet_v2", 27, 32)):
        log("byte_path " + json.dumps(byte_path(model, k, n)))
    # ShuffleNet-v2's stage-3 Split half as #1's and #1w's A (a view, lda =
    # 464) against a dense A of the same shape, and the copy that a
    # .contiguous() of the half would add
    for b in (1, BATCH):
        a = split_half(b, 464, 7, False)
        dense = rand(tuple(a.shape))
        for name, w, scale in (("fused_gemm", rand((232, 232)), None),
                               ("fused_gemm_i8w", rand_int8((232, 232)),
                                rand((232,), 0.001, 0.02))):
            log("split_half " + json.dumps({
                "kernel": name, "model": "shufflenet_v2", "batch": b, "M": a.shape[0],
                "K": 232, "N": 232, "lda": 464,
                "ms_strided": device_ms(torch, lambda: fused_gemm(a, w, scale), 20),
                "ms_dense": device_ms(torch, lambda: fused_gemm(dense, w, scale), 20),
                "ms_copy": device_ms(torch, lambda: a.contiguous(), 20),
                "launches_per_forward": 3}))
    phase_done("5a kernel times")

    # the dw_pw microbenchmark: fused against the unfused pair, batch 256
    before = dw_pw_fused.launches
    for shape in microbench_dw_pw.PUBLISHED:
        log("microbench_dw_pw " + json.dumps(microbench_dw_pw.run(*shape, 256)))
    microbench_launches = dw_pw_fused.launches - before
    phase_done("5b dw_pw microbenchmark")

    def e2e(target, name, reqs, rows, requests=E2E_REQUESTS, batches=E2E_BATCHES,
            warm_batch=True):
        """Batch-1 latency over ``requests`` requests after one warm-up,
        inputs a second at len(rows) over ``batches`` timed infer_batch
        calls, after one warm-up call where ``warm_batch``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        target.infer({name: reqs[0]})
        lat = []
        for i in range(requests):
            t = time.perf_counter()
            target.infer({name: reqs[i % REQUESTS]})
            lat.append((time.perf_counter() - t) * 1e3)
        compiled = target.compiled()
        if warm_batch:
            target.infer_batch({name: rows})
        thr = []
        for _ in range(batches):
            t = time.perf_counter()
            target.infer_batch({name: rows})
            thr.append(time.perf_counter() - t)
        return {"latency_b1_ms_median": statistics.median(lat),
                "latency_b1_ms_p90": sorted(lat)[int(0.9 * len(lat)) - 1],
                f"img_per_s_b{len(rows)}": len(rows) / statistics.median(thr),
                "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "weight_bytes": sum(t.numel() * t.element_size()
                                    for t in compiled.weights.values()),
                "derived_weight_bytes": sum(t.numel() * t.element_size()
                                            for t in compiled._derived.values())}

    # time to the first answer under INT8-FULL, KERNELS: resnet18_pot with no
    # samples (its scales from the IR) against ResNet-18 calibrated on
    # CALIBRATION images (the numpy interpreter on the host), from
    # load_network to the first request's answer on the host
    for model, make_exe, x in (
            ("resnet18_pot", lambda: more_loaded("resnet18_pot", QuantMode.INT8_FULL, "pallas"),
             images["requests"][0]),
            ("resnet18", lambda: loaded(networks["resnet18"], QuantMode.INT8_FULL, "pallas"),
             requests[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = make_exe()
        first.infer({"data": x})
        log("first_answer " + json.dumps({
            "model": model, "quant": "int8", "backend": "kernels",
            "calibration_images": more_nets["resnet18_pot"][1] if model == "resnet18_pot"
            else CALIBRATION, "s": time.perf_counter() - t0}))
    # the input copy at the headline's batch: u8 (1 byte a pixel) against
    # float32 (4), device time between CUDA events around the pageable
    # host-to-device copy, median of 5
    def copy_ms(arr):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            torch.from_numpy(arr).to(dev)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        return statistics.median(runs)

    f32_batch = u8_batch.astype(np.float32)
    log("ingress " + json.dumps({
        "batch": HEADLINE_BATCH, "u8_ms": copy_ms(u8_batch), "f32_ms": copy_ms(f32_batch),
        "u8_bytes": u8_batch.nbytes, "f32_bytes": f32_batch.nbytes,
        "bound_u8_ms": u8_batch.nbytes / PEAK_BYTES * 1e3,
        "is": "CUDA events around torch.from_numpy(x).to('cuda'), pageable host memory"}))
    # the headline's end to end, KERNELS alone (TORCH's int8 convs run in
    # float64, no yardstick at this batch)
    for _ in range(2):
        log(f"e2e resnet18 int8 bf16 u8 headline kernels " + json.dumps(
            e2e(headline, "data", u8_requests, u8_batch)))
    # MoE-MLP's, ocr-ti's and yolo-v2's paths (per example, hundreds to
    # over a thousand device operations a forward) with LIGHT_E2E's
    # repetitions: kernels then torch, one run each
    for label, (exe, ref, *inputs) in paths_run.items():
        results, t_label = {}, time.perf_counter()
        light = label in light_e2e
        for name, target in ((("kernels", exe), ("torch", ref)) if light else
                             (("kernels", exe), ("torch", ref), ("kernels", exe))):
            results.setdefault(name, []).append(
                e2e(target, *inputs, **(LIGHT_E2E if light else {})))
        for name, runs in results.items():
            for r in runs:
                log(f"e2e {label} {name} " + json.dumps(r))
        log(f"5c {label}: {time.perf_counter() - t_label:.2f} s")
    phase_done("5c end-to-end times")
    log(f"phases: {phases_s:.2f} s in all (goal 600 s, limit 1200 s)")

    # -- 6. kernels line -----------------------------------------------------
    def entry(name, route, source, replaces, models, weight="launches_per_forward"):
        rows = [r for r in per_shape[name] if r["batch"] == BATCH]
        total = lambda key: sum(r[key] * r[weight] for r in rows)  # noqa: E731
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] * r[weight] for r in rows if r["bound_by"] == by)),
            "library_ms": total("library_ms"),
            "times_are": (f"sum over the launches of one batch-{BATCH} forward "
                          f"of each model ({', '.join(models)})"
                          + ("" if weight == "launches_per_forward" else
                             ", had it been routed through the kernel")),
            "check_launches": check_launches[name],
            "shapes": per_shape[name],
        }

    gemm_src = "pyopenvino_tpu_torch/csrc/fused_gemm.cu"
    gemm_tpu = "pyopenvino_tpu/kernels/gemm.py:141"
    def floors(name, passes, weight="launches_per_forward"):
        """A float32-A variant's bound basis and its other floors, summed
        over one batch-64 forward."""
        return {"bound_is": f"max(3 bf16 passes x 2MNK / 989e12, bytes / 3.35e12): the "
                            f"card's floor for a float32-accurate product; "
                            f"bound_tf32x{passes}_ms is that of the kernel's {passes}-pass "
                            f"TF32 route, bound_ffma_ms that of float32 FFMA",
                **{key: sum(r[key] * r[weight] for r in per_shape[name] if r["batch"] == BATCH)
                   for key in (f"bound_tf32x{passes}_ms", "bound_ffma_ms")}}

    def loops(name, source_loop, weight="launches_per_forward"):
        """A variant's two loops (#1, #1w: f32_wgmma.cuh and f32_mma.cuh;
        #1b, #1bw: bf16_wgmma.cuh and bf16_mma.cuh; #3, #3-bf16, #1ii,
        #1ii-bf16, 3f-bf16: i8_wgmma.cuh and i8_mma.cuh or bf16_mma.cuh):
        where the routed shapes went, each loop's sum over one batch-64
        forward (a shape the wgmma loop does not take counts its mma.sync
        time; 3f-bf16 "if routed"), and the batch-1 sums."""
        rows = per_shape[name]
        total = lambda key, b: sum(  # noqa: E731
            (r[key] if r[key] is not None else r["ms"]) * r[weight]
            for r in rows if r["batch"] == b)
        return {"source_loop": source_loop,
                "routes": dict(collections.Counter(
                    r["route"] for r in rows if r["batch"] == BATCH)),
                "wgmma_loop_ms": total("wgmma_ms", BATCH), "old_loop_ms": total("mma_ms", BATCH),
                "b1": {key: total(key, 1) for key in ("ms", "mma_ms", "library_ms", "bound_ms")}}

    bf16_loops = functools.partial(
        loops, source_loop="pyopenvino_tpu_torch/csrc/bf16_wgmma.cuh where "
                           "kernels/gemm.py::bf16_route sends a launch, else "
                           "pyopenvino_tpu_torch/csrc/bf16_mma.cuh")
    direct_loop_src = ("pyopenvino_tpu_torch/csrc/i8_wgmma.cuh where "
                       "kernels/conv_direct.py::direct_route sends a launch, else "
                       "pyopenvino_tpu_torch/csrc/i8_mma.cuh")
    i8_loop_src = ("pyopenvino_tpu_torch/csrc/i8_wgmma.cuh (TiledA) where "
                   "kernels/gemm.py::i8_route sends a launch, else "
                   "pyopenvino_tpu_torch/csrc/i8_mma.cuh")

    f32_loop_src = ("pyopenvino_tpu_torch/csrc/f32_wgmma.cuh where "
                    "kernels/gemm.py::f32_route sends a launch, else "
                    "pyopenvino_tpu_torch/csrc/f32_mma.cuh")
    float_bf16_loop_src = ("pyopenvino_tpu_torch/csrc/i8_wgmma.cuh on bf16 operands "
                           "(ConvABf16Im2col, ConvABf16Im2colI8w) where "
                           "kernels/conv_direct.py::direct_bf16_route sends a launch, else "
                           "pyopenvino_tpu_torch/csrc/bf16_mma.cuh")

    log(json.dumps({"kernels": [
        {**entry("fused_gemm", "cuda", gemm_src, gemm_tpu, [*GEMMS, *net_gemms]),
         "library_is": "torch.addmm (full float32, TF32 off)", **floors("fused_gemm", 3),
         **loops("fused_gemm", f32_loop_src)},
        {**entry("fused_gemm_i8w", "cuda", gemm_src, gemm_tpu, [*GEMMS, *net_gemms]),
         "library_is": "torch.addmm on the weight dequantized beforehand, outside "
                       "the timing: no single PyTorch call takes f32 x int8",
         **floors("fused_gemm_i8w", 2), **loops("fused_gemm_i8w", f32_loop_src)},
        {**entry("fused_gemm_i8i8", "cuda", gemm_src, gemm_tpu, [*I8I8_GEMMS, *net_gemms]),
         "library_is": "torch._int_mm (cuBLASLt int8, int32 out, no epilogue); "
                       "M <= 16 padded to 32, K and N to multiples of 8 where "
                       "a row says so", **loops("fused_gemm_i8i8", i8_loop_src)},
        {**entry("conv2d_direct", "cuda", "pyopenvino_tpu_torch/csrc/conv_direct.cu",
                 "pyopenvino_tpu/kernels/conv_direct.py:138", ["resnet18", *net_direct]),
         "library_is": "F.conv2d in float32 (TF32 off) on the codes converted "
                       "beforehand: no PyTorch call runs an int8 conv on CUDA",
         "library_bf16_ms": sum(r["library_bf16_ms"] * r["launches_per_forward"]
                                for r in per_shape["conv2d_direct"] if r["batch"] == BATCH),
         "library_bf16_is": "F.conv2d in bfloat16 (cuDNN) on the codes converted beforehand",
         **loops("conv2d_direct", direct_loop_src)},
        {**entry("conv2d_direct_f32", "cuda", "pyopenvino_tpu_torch/csrc/conv_direct.cu",
                 "pyopenvino_tpu/kernels/conv_direct.py:138", ["resnet18"], "if_routed"),
         "library_is": "F.conv2d in float32 with its bias (TF32 off)",
         "on_path": "no path routes a float conv through it, as in the JAX package",
         **floors("conv2d_direct_f32", 3, "if_routed"),
         "int8_weight": {
             key: sum(r[key] * r["if_routed"] for r in per_shape["conv2d_direct_f32_i8w"]
                      if r["batch"] == BATCH)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tf32x2_ms")}},
        {**entry("dw_pw_fused", "cuda", "pyopenvino_tpu_torch/csrc/dw_pw.cu",
                 "tools/dw_pw_kernel.py:173", ["ssd_shapes_ms"], "if_routed"),
         "library_is": "F.conv2d grouped, float32 on the codes converted beforehand, "
                       "then torch._int_mm (no epilogues)",
         "on_path": "off the serving paths, as in the JAX package",
         "microbench_launches": microbench_launches},
        {**entry("softmax_rows", "triton", "pyopenvino_tpu_torch/kernels/softmax.py",
                 "pyopenvino_tpu/kernels/softmax.py:44",
                 [*GEMMS, *more_nets, *sorted({m for m, *_ in family_softmax})]),
         "launch_floor_ms": launch_floor_ms,
         "launch_floor_is": "device time of a one-element torch add_ per launch, "
                            "in the same CUDA-graph harness"},
        {**entry("fused_gemm_bf16", "cuda", gemm_src, gemm_tpu, [*GEMMS, *net_gemms]),
         "library_is": "torch.addmm in bfloat16 (cuBLAS)", **bf16_loops("fused_gemm_bf16")},
        {**entry("fused_gemm_bf16_i8w", "cuda", gemm_src, gemm_tpu, [*GEMMS, *net_gemms]),
         "library_is": "torch.addmm in bfloat16 on the weight dequantized to bfloat16 "
                       "beforehand, outside the timing", **bf16_loops("fused_gemm_bf16_i8w")},
        {**entry("fused_gemm_i8i8_bf16", "cuda", gemm_src, gemm_tpu,
                 [*I8I8_GEMMS, *net_gemms]),
         "library_is": "torch._int_mm (cuBLASLt int8, int32 out, no epilogue)",
         **loops("fused_gemm_i8i8_bf16", i8_loop_src)},
        {**entry("conv2d_direct_bf16", "cuda", "pyopenvino_tpu_torch/csrc/conv_direct.cu",
                 "pyopenvino_tpu/kernels/conv_direct.py:138", ["resnet18", *net_direct]),
         "library_is": "F.conv2d in bfloat16 (cuDNN) on the codes converted beforehand",
         **loops("conv2d_direct_bf16", direct_loop_src)},
        {**entry("softmax_rows_bf16", "triton", "pyopenvino_tpu_torch/kernels/softmax.py",
                 "pyopenvino_tpu/kernels/softmax.py:44",
                 [*GEMMS, *more_nets, *sorted({m for m, *_ in family_softmax})]),
         "library_is": "torch.softmax in bfloat16"},
        {**entry("conv2d_direct_float_bf16", "cuda",
                 "pyopenvino_tpu_torch/csrc/conv_direct.cu",
                 "pyopenvino_tpu/kernels/conv_direct.py:138", ["resnet18"], "if_routed"),
         "library_is": "F.conv2d in bfloat16 with its bias (cuDNN)",
         "on_path": "no path routes a float conv through it, as in the JAX package",
         **loops("conv2d_direct_float_bf16", float_bf16_loop_src, "if_routed"),
         "int8_weight": {
             **{key: sum(r[key] * r["if_routed"]
                         for r in per_shape["conv2d_direct_float_bf16_i8w"]
                         if r["batch"] == BATCH)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
             **loops("conv2d_direct_float_bf16_i8w", float_bf16_loop_src, "if_routed")}},
        {**entry("dw_pw_fused_bf16", "cuda", "pyopenvino_tpu_torch/csrc/dw_pw.cu",
                 "tools/dw_pw_kernel.py:173", ["ssd_shapes_ms"], "if_routed"),
         "library_is": "F.conv2d grouped, float32 on the codes converted beforehand, "
                       "then torch._int_mm, then the pointwise epilogue to bfloat16",
         "on_path": "off the serving paths, as in the JAX package"},
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
